"""Parity of the port's block-dense RuvectorLayer routes against the JAX
functions of the same name, on the CPU: the scan route, the K2 route
(use_pallas) and the K1 fused route, in f32 and bf16, with duplicate
slots (log_mult), a padded tail block with a halo, bf16 IO and
graph-grown leaf blocks. The port's K1/K2 routes run the kernels' plain
versions here; the JAX side runs its Pallas kernels in interpret mode.

Tolerances are the JAX tests' own (test_block_dense_fused.py): 2e-5 for
f32 layer paths, 4e-2 max and 8e-3 mean for bf16 compute or IO.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ruvector_tpu.graph import build_block_dense as jbuild
from ruvector_tpu.nn.block_dense_layer import fold_layer_params as jfold
from ruvector_tpu.nn.block_dense_layer import ruvector_layer_apply_block_dense as jscan
from ruvector_tpu.nn.block_dense_layer import (
    ruvector_layer_apply_block_dense_fused as jfused,
)
from ruvector_tpu.nn.ruvector_layer import RuvectorLayerConfig as JCfg
from ruvector_tpu.nn.ruvector_layer import ruvector_layer_init as jinit
from ruvector_tpu.ops.pallas.block_dense_attn import block_dense_attention as jattn
from ruvector_tpu.ops.pallas.block_dense_attn import block_dense_layer_fused as jkernel
from ruvector_tpu.parallel.ordering import graph_grow_blocks
from ruvector_tpu_torch.convert import params_from_numpy
from ruvector_tpu_torch.graph import build_block_dense
from ruvector_tpu_torch.nn.block_dense_layer import (
    fold_layer_params,
    ruvector_layer_apply_block_dense,
    ruvector_layer_apply_block_dense_fused,
)
from ruvector_tpu_torch.nn.ruvector_layer import RuvectorLayerConfig
from ruvector_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
from ruvector_tpu_torch.ops.kernels.block_dense_attn import (
    block_dense_attention,
    block_dense_layer_fused,
    k1_body,
    k2_body,
)

F32_TOL = 2e-5
BF16_MAX, BF16_MEAN = 4e-2, 8e-3


def _random_graph(n, m, seed, duplicate_slots=False, uniform=False):
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, n, (n, m)).astype(np.int32)
    mask = np.ones((n, m), np.float32)
    if uniform:
        ew = rng.uniform(0.1, 1.0, (n, m)).astype(np.float32)
        return idx, mask, ew
    if duplicate_slots:
        idx[1, 1:] = idx[1, 0]          # one neighbor listed m-1 times
    mask[7] = 0.0                       # degree-0 node
    mask[11, 2:] = 0.0                  # partial degree
    ew = rng.uniform(0.0, 1.0, (n, m)).astype(np.float32)
    ew[5, 0] = 0.0                      # real zero-weight edge
    return idx, mask, ew


def _setup(n, d, m, heads, seed, cdt="float32", block=1024, **graph_kw):
    idx, mask, ew = _random_graph(n, m, seed, **graph_kw)
    jc = JCfg(d, d, heads=heads, compute_dtype=cdt)
    jp = jinit(jax.random.key(seed), jc)
    x = np.random.default_rng(seed + 1).normal(size=(n, d)).astype(np.float32)
    jb = jbuild(idx, mask, ew, block=block, dtype=np.float32, device_fill=False)
    tb = build_block_dense(idx, mask, ew, block=block, device="cpu")
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    tc = RuvectorLayerConfig(d, d, heads=heads, compute_dtype=cdt)
    return (jp, jc, jb.pad_features(jnp.asarray(x)), jb), (tp, tc, tb.pad_features(
        torch.from_numpy(x)), tb)


def _compare(got, want, bf16=False):
    got = got.float().numpy()
    want = np.asarray(want).astype(np.float32)
    assert got.shape == want.shape and np.all(np.isfinite(got))
    if bf16:
        err = np.abs(got - want)
        assert err.max() < BF16_MAX and err.mean() < BF16_MEAN, (err.max(), err.mean())
    else:
        np.testing.assert_allclose(got, want, atol=F32_TOL, rtol=0)


@pytest.mark.parametrize("cdt", ["float32", "bfloat16"])
@pytest.mark.parametrize("heads", [4, 8])
def test_scan_route(heads, cdt):
    (jp, jc, jf, jb), (tp, tc, tf, tb) = _setup(300, 64, 8, heads, seed=0, cdt=cdt,
                                                block=128)
    _compare(ruvector_layer_apply_block_dense(tp, tc, tf, tb),
             jscan(jp, jc, jf, jb), bf16=cdt == "bfloat16")


@pytest.mark.parametrize("cdt", ["float32", "bfloat16"])
@pytest.mark.parametrize("heads", [4, 8])
def test_k2_route(heads, cdt):
    (jp, jc, jf, jb), (tp, tc, tf, tb) = _setup(400, 128, 8, heads, seed=9, cdt=cdt)
    _compare(ruvector_layer_apply_block_dense(tp, tc, tf, tb, use_pallas=True),
             jscan(jp, jc, jf, jb, use_pallas=True), bf16=cdt == "bfloat16")


@pytest.mark.parametrize("cdt", ["float32", "bfloat16"])
@pytest.mark.parametrize("heads", [4, 8])
def test_k1_fused_route(heads, cdt):
    (jp, jc, jf, jb), (tp, tc, tf, tb) = _setup(600, 128, 8, heads, seed=0, cdt=cdt)
    _compare(ruvector_layer_apply_block_dense_fused(tp, tc, tf, tb),
             jfused(jp, jc, jf, jb), bf16=cdt == "bfloat16")


@pytest.mark.parametrize("route", ["scan", "k2", "k1"])
def test_duplicate_slots_log_mult(route):
    (jp, jc, jf, jb), (tp, tc, tf, tb) = _setup(300, 64, 6, 4, seed=3,
                                                duplicate_slots=True)
    assert tb.log_mult is not None
    if route == "k1":
        got, want = ruvector_layer_apply_block_dense_fused(tp, tc, tf, tb), jfused(jp, jc, jf, jb)
    else:
        use = route == "k2"
        got = ruvector_layer_apply_block_dense(tp, tc, tf, tb, use_pallas=use)
        want = jscan(jp, jc, jf, jb, use_pallas=use)
    _compare(got, want)


@pytest.mark.parametrize("route", ["k2", "k1"])
def test_tail_block_with_halo(route):
    """n % block != 0: padded tail block whose halo starts at column B."""
    (jp, jc, jf, jb), (tp, tc, tf, tb) = _setup(600, 64, 12, 4, seed=7, block=256,
                                                uniform=True)
    assert tb.table > tb.block
    if route == "k1":
        got, want = ruvector_layer_apply_block_dense_fused(tp, tc, tf, tb), jfused(jp, jc, jf, jb)
    else:
        got = ruvector_layer_apply_block_dense(tp, tc, tf, tb, use_pallas=True)
        want = jscan(jp, jc, jf, jb, use_pallas=True)
    _compare(got, want)


def test_fused_bf16_io():
    (jp, jc, jf, jb), (tp, tc, tf, tb) = _setup(500, 128, 8, 4, seed=11)
    got = ruvector_layer_apply_block_dense_fused(tp, tc, tf, tb, io_dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    _compare(got, jfused(jp, jc, jf, jb, io_dtype=jnp.bfloat16), bf16=True)


def test_fused_graph_grown_leaves():
    """The bench's layout route: graph_grow_blocks + leaf_sizes blocks."""
    rng = np.random.default_rng(4)
    n, d, m = 257, 32, 6
    idx = np.stack([rng.choice(n, size=m, replace=False) for _ in range(n)]).astype(np.int32)
    mask = (rng.uniform(size=(n, m)) < 0.9).astype(np.float32)
    ew = rng.uniform(0.1, 1.0, size=(n, m)).astype(np.float32)
    perm, leaves = graph_grow_blocks(idx, mask, leaf_size=64)
    inv = np.empty(n, np.int64)
    inv[perm] = np.arange(n)
    idx_r = inv[idx[perm]].astype(np.int32)
    jb = jbuild(idx_r, mask[perm], ew[perm], leaf_sizes=leaves)
    tb = build_block_dense(idx_r, mask[perm], ew[perm], leaf_sizes=leaves, device="cpu")
    jc = JCfg(d, d, heads=4)
    jp = jinit(jax.random.key(0), jc)
    x = rng.normal(size=(n, d)).astype(np.float32)[perm]
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    tc = RuvectorLayerConfig(d, d, heads=4)
    want = jb.unpad(jfused(jp, jc, jb.pad_features(jnp.asarray(x)), jb))
    got = tb.unpad(ruvector_layer_apply_block_dense_fused(
        tp, tc, tb.pad_features(torch.from_numpy(x)), tb))
    _compare(got, want)


def test_fold_layer_params_matches():
    jc = JCfg(64, 64, heads=4)
    jp = jinit(jax.random.key(5), jc)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    want = jfold(jp, jc)
    got = fold_layer_params(tp, RuvectorLayerConfig(64, 64, heads=4))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=1e-6, rtol=0)


def _kernel_inputs(seed, cdt, with_lm):
    """Raw K1/K2 inputs: ragged B (not a multiple of any tile), T > 512,
    sparse wd with a degree-0 row and a 1e-7 edge, optional lm."""
    rng = np.random.default_rng(seed)
    nb, b, t, d, h = 2, 36, 640, 32, 4
    L = rng.normal(size=(nb, t, d)).astype(np.float32)
    wd = (rng.random((nb, b, t)) * (rng.random((nb, b, t)) < 0.03)).astype(np.float32)
    wd[0, 3] = 0.0
    wd[1, 2, 600] = 1e-7
    lm = np.log(rng.integers(1, 3, (nb, b, t))).astype(np.float32) if with_lm else None
    jdt = jnp.bfloat16 if cdt == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if cdt == "bfloat16" else torch.float32
    return rng, (nb, b, t, d, h), L, wd, lm, jdt, tdt


@pytest.mark.parametrize("with_lm", [False, True])
@pytest.mark.parametrize("cdt", ["float32", "bfloat16"])
def test_k2_plain_version_raw_inputs(cdt, with_lm):
    rng, (nb, b, t, d, h), L, wd, lm, jdt, tdt = _kernel_inputs(1, cdt, with_lm)
    u = rng.normal(size=(h, nb, b, d)).astype(np.float32) * 0.3
    sb = rng.normal(size=(h, nb, b)).astype(np.float32)
    want = jattn(jnp.asarray(L, jdt), jnp.asarray(u, jdt), jnp.asarray(sb), jnp.asarray(wd),
                 None if lm is None else jnp.asarray(lm), scale=0.25, tile=b)
    got = block_dense_attention(
        torch.from_numpy(L).to(tdt), torch.from_numpy(u).to(tdt), torch.from_numpy(sb),
        torch.from_numpy(wd), None if lm is None else torch.from_numpy(lm), scale=0.25)
    assert got.shape == (h + 1, nb, b, d)
    _compare(got, want, bf16=cdt == "bfloat16")


@pytest.mark.parametrize("with_lm", [False, True])
@pytest.mark.parametrize("cdt", ["float32", "bfloat16"])
def test_k1_plain_version_raw_inputs(cdt, with_lm):
    rng, (nb, b, t, d, h), L, wd, lm, jdt, tdt = _kernel_inputs(2, cdt, with_lm)
    msg = rng.normal(size=(nb, b, d)).astype(np.float32)
    jp = jinit(jax.random.key(2), JCfg(d, d, heads=h))
    folded = jfold(jp, JCfg(d, d, heads=h))
    want = jkernel(jnp.asarray(L, jdt), jnp.asarray(msg), jnp.asarray(wd), folded,
                   None if lm is None else jnp.asarray(lm), scale=0.25, dropout=0.1,
                   eps=1e-5, tile=b)
    tfolded = {k: torch.from_numpy(np.array(v)) for k, v in folded.items()}
    got = block_dense_layer_fused(
        torch.from_numpy(L).to(tdt), torch.from_numpy(msg), torch.from_numpy(wd), tfolded,
        None if lm is None else torch.from_numpy(lm), dropout=0.1, eps=1e-5)
    _compare(got, want, bf16=cdt == "bfloat16")


@pytest.mark.parametrize("d", [32, 128])
@pytest.mark.parametrize("cdt", ["float32", "bfloat16"])
def test_k1_plain_version_one_edge_rows(cdt, d):
    """One edge per row with wd = 1.0 and a table of bf16 values (the
    float32-grade control of the card's K1): p = 1, so the attention is
    exact in either compute type and the plain K1 meets JAX's K1 at the
    f32 tolerance."""
    rng = np.random.default_rng(6)
    nb, b, t, h = 2, 36, 128, 4
    wd = np.zeros((nb, b, t), np.float32)
    np.put_along_axis(wd, rng.integers(0, t, (nb, b, 1)), 1.0, axis=2)
    L = np.asarray(jnp.asarray(rng.normal(size=(nb, t, d)), jnp.bfloat16), np.float32)
    msg = rng.normal(size=(nb, b, d)).astype(np.float32)
    jdt = jnp.bfloat16 if cdt == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if cdt == "bfloat16" else torch.float32
    jp = jinit(jax.random.key(6), JCfg(d, d, heads=h))
    folded = jfold(jp, JCfg(d, d, heads=h))
    want = jkernel(jnp.asarray(L, jdt), jnp.asarray(msg), jnp.asarray(wd), folded, None,
                   scale=0.25, dropout=0.1, eps=1e-5, tile=b)
    tfolded = {k: torch.from_numpy(np.array(v)) for k, v in folded.items()}
    got = block_dense_layer_fused(torch.from_numpy(L).to(tdt), torch.from_numpy(msg),
                                  torch.from_numpy(wd), tfolded, dropout=0.1, eps=1e-5)
    _compare(got, want)


def test_k1_body_follows_compute_type():
    """bf16 compute runs K1's tensor-core body, float32 compute its
    CUDA-core body."""
    assert k1_body(torch.bfloat16) == "tensor_core"
    assert k1_body(torch.float32) == "cuda_core"


@pytest.mark.parametrize("variant", ["one_tf32", "no_head0", "unknown"])
def test_k1_variants_run_on_the_card_only(variant):
    """K1's planted faults are card-only instances: on CPU tensors the
    wrapper raises instead of taking the plain version, and counts no
    launch."""
    rng, (nb, b, t, d, h), L, wd, _, _, _ = _kernel_inputs(3, "bfloat16", False)
    jp = jinit(jax.random.key(3), JCfg(d, d, heads=h))
    tfolded = {k: torch.from_numpy(np.array(v))
               for k, v in jfold(jp, JCfg(d, d, heads=h)).items()}
    msg = torch.from_numpy(rng.normal(size=(nb, b, d)).astype(np.float32))
    reset_launch_counts()
    with pytest.raises(ValueError):
        block_dense_layer_fused(torch.from_numpy(L).to(torch.bfloat16), msg,
                                torch.from_numpy(wd), tfolded, dropout=0.1, eps=1e-5,
                                variant=variant)
    assert launch_counts()["block_dense_layer_fused"] == 0


def test_k2_body_follows_compute_type():
    """bf16 compute runs K2's tensor-core body, float32 compute its
    CUDA-core body."""
    assert k2_body(torch.bfloat16) == "tensor_core"
    assert k2_body(torch.float32) == "cuda_core"


@pytest.mark.parametrize("variant", ["no_rescale", "unknown"])
def test_k2_variants_run_on_the_card_only(variant):
    """K2's planted fault is a card-only instance: on CPU tensors the
    wrapper raises instead of taking the plain version, and counts no
    launch."""
    rng, (nb, b, t, d, h), L, wd, _, _, _ = _kernel_inputs(4, "bfloat16", False)
    u = torch.from_numpy(rng.normal(size=(h, nb, b, d)).astype(np.float32)).to(torch.bfloat16)
    sb = torch.from_numpy(rng.normal(size=(h, nb, b)).astype(np.float32))
    reset_launch_counts()
    with pytest.raises(ValueError):
        block_dense_attention(torch.from_numpy(L).to(torch.bfloat16), u, sb,
                              torch.from_numpy(wd), scale=0.25, variant=variant)
    assert launch_counts()["block_dense_attention"] == 0
