"""Parity of the port's RuvectorLayer (slot, einsum and K3 routes), the
single-node API and the 2-layer RuvectorNet against the JAX package, on
the CPU. The K3 route runs the kernel's plain version here; the JAX side
runs its Pallas kernel in interpret mode, as the JAX tests do.

Tolerances are the JAX tests' own: 2e-5 for f32 layer paths
(test_block_dense_fused.py), 1e-4 for the Pallas neighbor-mix route
(test_pallas.py), 2e-4 for the single-node API (test_ruvector_layer.py),
and 4e-2 max / 8e-3 mean for bf16 (test_block_dense_fused.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ruvector_tpu.graph import NeighborGraph as JNG
from ruvector_tpu.graph import build_knn_graph as jbuild_knn
from ruvector_tpu.models import RuvectorNetConfig as JNetCfg
from ruvector_tpu.models import ruvector_net_apply as jnet_apply
from ruvector_tpu.models import ruvector_net_init as jnet_init
from ruvector_tpu.nn.ruvector_layer import RuvectorLayerConfig as JCfg
from ruvector_tpu.nn.ruvector_layer import ruvector_layer_apply as jlayer
from ruvector_tpu.nn.ruvector_layer import ruvector_layer_apply_single as jsingle
from ruvector_tpu.nn.ruvector_layer import ruvector_layer_init as jinit
from ruvector_tpu.ops.pallas.neighbor_mix import fused_neighbor_mix as jmix
from ruvector_tpu_torch.convert import params_from_numpy
from ruvector_tpu_torch.graph import NeighborGraph, build_knn_graph
from ruvector_tpu_torch.models import (
    RuvectorNetConfig,
    ruvector_net_apply,
    ruvector_net_init,
)
from ruvector_tpu_torch.nn.ruvector_layer import (
    RuvectorLayerConfig,
    ruvector_layer_apply,
    ruvector_layer_apply_single,
)
from ruvector_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
from ruvector_tpu_torch.ops.kernels.neighbor_mix import fused_neighbor_mix, k3_body

F32_TOL = 2e-5
PALLAS_TOL = 1e-4
SINGLE_TOL = 2e-4
BF16_MAX, BF16_MEAN = 4e-2, 8e-3


def _params(jparams):
    return params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), "cpu")


def _compare(got, want, cdt="float32", tol=F32_TOL):
    got = got.float().numpy()
    want = np.asarray(want).astype(np.float32)
    assert np.all(np.isfinite(got))
    if cdt == "bfloat16":
        err = np.abs(got - want)
        assert err.max() < BF16_MAX and err.mean() < BF16_MEAN, (err.max(), err.mean())
    else:
        np.testing.assert_allclose(got, want, atol=tol, rtol=0)


def _slot_graph(n, m, seed):
    """Ragged lists with isolated nodes, partial degree and zero weights."""
    rng = np.random.default_rng(seed)
    lists, weights = [], []
    for i in range(n):
        deg = 0 if i % 9 == 4 else int(rng.integers(1, m + 1))
        lists.append(rng.choice(n, size=deg, replace=False).tolist())
        w = rng.random(deg).astype(np.float32)
        if i % 11 == 3:
            w[:] = 0.0                      # zero-weight row: uniform fallback
        elif deg:
            w[0] = 0.0                      # one real zero-weight edge
        weights.append(w.tolist())
    return (JNG.from_lists(lists, weights, max_degree=m),
            NeighborGraph.from_lists(lists, weights, max_degree=m, device="cpu"))


@pytest.mark.parametrize("cdt", ["float32", "bfloat16"])
@pytest.mark.parametrize("m", [8, 40])        # slot route (m <= 32), einsum route
def test_layer_routes(cdt, m):
    n, d = 90, 32
    jg, tg = _slot_graph(n, m, seed=m)
    jc = JCfg(d, d, heads=4, dropout=0.1, compute_dtype=cdt)
    jp = jinit(jax.random.key(0), jc)
    x = np.random.default_rng(1).normal(size=(n, d)).astype(np.float32)
    want = jlayer(jp, jc, jnp.asarray(x), jg)
    tc = RuvectorLayerConfig(d, d, heads=4, dropout=0.1, compute_dtype=cdt)
    _compare(ruvector_layer_apply(_params(jp), tc, torch.from_numpy(x), tg), want, cdt)


@pytest.mark.parametrize("heads", [2, 4])
def test_layer_use_pallas_route(heads):
    """K3 route: the plain version against the JAX Pallas interpret path."""
    n, d = 70, 32
    jg, tg = _slot_graph(n, 8, seed=heads)
    jc = JCfg(d, d, heads=heads, use_pallas=True)
    jp = jinit(jax.random.key(heads), jc)
    x = np.random.default_rng(2).normal(size=(n, d)).astype(np.float32)
    want = jlayer(jp, jc, jnp.asarray(x), jg)
    tc = RuvectorLayerConfig(d, d, heads=heads, use_pallas=True)
    _compare(ruvector_layer_apply(_params(jp), tc, torch.from_numpy(x), tg), want,
             tol=PALLAS_TOL)


@pytest.mark.parametrize("n, h, m, d", [(77, 4, 12, 32), (40, 8, 16, 128)])
def test_fused_neighbor_mix_plain_version(n, h, m, d):
    """K3's plain version against the Pallas kernel on raw inputs: N not a
    multiple of the JAX tile, an all-masked row, zero weights; also at the
    widths the card's streaming body reads (8 heads, 16 slots, D=128)."""
    rng = np.random.default_rng(3)
    u = rng.normal(size=(n, h, d)).astype(np.float32)
    bias = rng.normal(size=(n, h)).astype(np.float32)
    nbr = rng.normal(size=(n, m, d)).astype(np.float32)
    mask = (rng.random((n, m)) > 0.3).astype(np.float32)
    mask[5] = 0.0
    wnorm = rng.random((n, m)).astype(np.float32) * mask
    want = jmix(jnp.asarray(u), jnp.asarray(bias), jnp.asarray(nbr), jnp.asarray(mask),
                jnp.asarray(wnorm), heads=h, scale=0.3)
    got = fused_neighbor_mix(*(torch.from_numpy(a) for a in (u, bias, nbr, mask, wnorm)),
                             heads=h, scale=0.3)
    assert got.shape == (n, h + 1, d)
    _compare(got, want, tol=1e-5)


@pytest.mark.parametrize("heads, m, d, body", [
    (4, 16, 128, "streaming"), (1, 13, 96, "streaming"), (8, 1, 4, "streaming"),
    (16, 16, 128, "warp"), (4, 17, 128, "warp"), (4, 16, 132, "warp"), (4, 16, 98, "warp"),
])
def test_k3_body_follows_shape(heads, m, d, body):
    """K3's streaming body where a node's rows fit its registers (heads
    1-8, M <= 16, D % 4 == 0, D <= 128), the warp body elsewhere."""
    assert k3_body(heads, m, d) == body


@pytest.mark.parametrize("variant", ["drop_last_slot", "unknown"])
def test_k3_variants_run_on_the_card_only(variant):
    """K3's planted fault is a card-only instance: on CPU tensors the
    wrapper raises instead of taking the plain version, and counts no
    launch."""
    n, h, m, d = 9, 4, 16, 32
    args = [torch.ones(s) for s in ((n, h, d), (n, h), (n, m, d), (n, m), (n, m))]
    reset_launch_counts()
    with pytest.raises(ValueError):
        fused_neighbor_mix(*args, heads=h, scale=0.3, variant=variant)
    assert launch_counts()["fused_neighbor_mix"] == 0


@pytest.mark.parametrize("zero_weights", [False, True])
def test_layer_apply_single(zero_weights):
    jc = JCfg(12, 16, heads=4, dropout=0.1)
    jp = jinit(jax.random.key(0), jc)
    rng = np.random.default_rng(9)
    node = rng.normal(size=12).astype(np.float32)
    nbrs = rng.normal(size=(3, 12)).astype(np.float32)
    w = np.zeros(3, np.float32) if zero_weights else np.asarray([0.3, 0.5, 0.2], np.float32)
    want = jsingle(jp, jc, jnp.asarray(node), jnp.asarray(nbrs), jnp.asarray(w))
    tc = RuvectorLayerConfig(12, 16, heads=4, dropout=0.1)
    got = ruvector_layer_apply_single(_params(jp), tc, torch.from_numpy(node),
                                      torch.from_numpy(nbrs), torch.from_numpy(w))
    _compare(got, want, tol=SINGLE_TOL)


def test_ruvector_net_graft_width():
    """The __graft_entry__.py model: 2 layers, 256 nodes, d=128, k=16, 4 heads,
    each package building its own kNN graph from the same features."""
    x = np.random.default_rng(0).normal(size=(256, 128)).astype(np.float32)
    jc = JNetCfg(input_dim=128, hidden_dim=128, num_layers=2, heads=4)
    jp = jnet_init(jax.random.key(0), jc)
    want = jnet_apply(jp, jc, jnp.asarray(x), jbuild_knn(jnp.asarray(x), k=16))
    tc = RuvectorNetConfig(input_dim=128, hidden_dim=128, num_layers=2, heads=4)
    tg = build_knn_graph(x, k=16, device="cpu")
    tp = _params(jp)
    got = ruvector_net_apply(tp, tc, torch.from_numpy(x), tg)
    assert got.shape == (256, 128)
    _compare(got, want)
    # remat (activation checkpointing) changes nothing in the forward
    remat = ruvector_net_apply(tp, dataclasses.replace(tc, remat=True),
                               torch.from_numpy(x).requires_grad_(), tg)
    np.testing.assert_allclose(remat.detach().numpy(), got.numpy(), atol=0, rtol=0)


def test_ruvector_net_init_and_grad():
    tc = RuvectorNetConfig(input_dim=16, hidden_dim=16, num_layers=2, heads=2, remat=True)
    params = ruvector_net_init(0, tc, device="cpu")
    assert len(params) == 2 and params[0]["w_msg"]["kernel"].shape == (16, 16)
    for leaf in jax.tree_util.tree_leaves(params):
        leaf.requires_grad_(True)
    _, tg = _slot_graph(20, 4, seed=5)
    x = torch.randn(20, 16, generator=torch.Generator().manual_seed(1))
    ruvector_net_apply(params, tc, x, tg).square().sum().backward()
    grads = [leaf.grad for leaf in jax.tree_util.tree_leaves(params)]
    assert all(g is not None and torch.isfinite(g).all() for g in grads)
    assert any(float(g.abs().max()) > 0 for g in grads)
