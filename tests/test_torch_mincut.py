"""Parity of the port's min-cut gate against the JAX package, on the CPU:
the batched plain gate (`mincut_gate_device`) and the plain version of
the K7 block gate (`mincut_gate_block_from_x_reference`, reached through
its wrapper with CPU tensors) against JAX K7 in interpret mode.

Tolerances are the JAX tests' own (test_mincut_gate_kernel.py,
test_gated_graph_transformer.py): packed words equal, cut cost within
1e-4 (1e-5 for the standalone gate), 2e-3 relative where a cut applies.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ruvector_tpu.attention.mincut_device import mincut_gate_device as jgate
from ruvector_tpu.graph_transformer.gated import _pooled_from_x as jpooled
from ruvector_tpu.graph_transformer.gated import pack_keep as jpack
from ruvector_tpu.nn.core import layer_norm_apply as jln
from ruvector_tpu.ops.pallas.mincut_gate_block import mincut_gate_block_from_x as jk7
from ruvector_tpu_torch.attention import mincut_gate_device
from ruvector_tpu_torch.graph_transformer import pack_keep, unpack_keep
from ruvector_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
from ruvector_tpu_torch.ops.kernels.mincut_gate_block import (
    isolated_sink,
    mincut_gate_block_from_x,
    two_hop_sink,
)

LAM, EPS = 0.5, 0.01


def _words(kp) -> np.ndarray:
    """Packed words as uint32, whatever the side's integer type."""
    a = np.asarray(kp.numpy() if isinstance(kp, torch.Tensor) else kp)
    return a.view(np.uint32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_mincut_gate_device_matches_jax(seed):
    rng = np.random.default_rng(seed)
    k, s = 5, 24
    lg = (rng.normal(size=(k, s, s)) * 0.5).astype(np.float32)
    lg[0, :, -1] = -1.0        # a sink reached by one weak edge: the cut applies
    lg[0, 3, -1] = 0.05
    lg[1] = -1.0               # no positive logit at all
    keep, cost = mincut_gate_device(torch.from_numpy(lg), LAM, EPS)
    for i in range(k):
        jk, jc = jgate(jnp.asarray(lg[i]), LAM, EPS)
        np.testing.assert_array_equal(keep[i].numpy(), np.asarray(jk))
        np.testing.assert_allclose(float(cost[i]), float(jc), atol=1e-5)
    single_keep, single_cost = mincut_gate_device(torch.from_numpy(lg[0]), LAM, EPS)
    np.testing.assert_array_equal(single_keep.numpy(), keep[0].numpy())
    assert float(single_cost) == float(cost[0]) and float(cost[0]) > 0


@pytest.mark.parametrize("b", [64, 50])
def test_pack_keep_matches_jax_words(b):
    rng = np.random.default_rng(b)
    keep = rng.uniform(size=(3, b, b)) > 0.4
    got = pack_keep(torch.from_numpy(keep))
    np.testing.assert_array_equal(_words(got), np.asarray(jpack(jnp.asarray(keep))))
    np.testing.assert_array_equal(unpack_keep(got, b).numpy(), keep)


def _k7(x, pad, A, **kw):
    reset_launch_counts()
    kp, stats = mincut_gate_block_from_x(torch.from_numpy(x), torch.from_numpy(pad),
                                         torch.from_numpy(A), lam=LAM, eps=EPS, **kw)
    assert launch_counts()["mincut_gate_block_from_x"] == 0   # CPU: plain version
    return kp, stats


def test_block_gate_random_partitions():
    """test_mincut_gate_kernel.py:31: K=4, B=64, D=32, random padding."""
    rng = np.random.default_rng(1)
    k, b, d = 4, 64, 32
    x = rng.normal(size=(k, b, d)).astype(np.float32)
    pad = (rng.uniform(size=(k, b)) > 0.05).astype(np.float32)
    A = (rng.normal(size=(d, d)) * 0.15).astype(np.float32)
    kp, stats = _k7(x, pad, A)
    jkp, jstats = jk7(jnp.asarray(x), jnp.asarray(pad), jnp.asarray(A), lam=LAM, eps=EPS)
    np.testing.assert_array_equal(_words(kp), np.asarray(jkp))
    np.testing.assert_allclose(stats[:, 0, 0].numpy(), np.asarray(jstats)[:, 0, 0], atol=1e-4)
    np.testing.assert_array_equal(stats[:, 2, 0].numpy(), np.asarray(jstats)[:, 2, 0])
    # the standalone gate on the same logits gives the same words
    ref, _ = jax.vmap(lambda m: jgate(m, LAM, EPS))(
        jpooled(jnp.asarray(x), jnp.asarray(pad), jnp.asarray(A)))
    np.testing.assert_array_equal(_words(kp), np.asarray(jpack(ref)))


def test_block_gate_applied_cut():
    """test_mincut_gate_kernel.py:45: a nearly isolated sink makes the
    flow fall under the threshold, so the cut applies with a real cost."""
    rng = np.random.default_rng(0)
    k, b, d = 3, 64, 32
    base = rng.normal(size=(k, 1, d)).astype(np.float32)
    x = (base + 0.3 * rng.normal(size=(k, b, d))).astype(np.float32)
    x[:, -1] = 0.006 * x[:, 0]
    pad = np.ones((k, b), np.float32)
    A = (np.eye(d) * 0.1).astype(np.float32)
    kp, stats = _k7(x, pad, A)
    jkp, jstats = jk7(jnp.asarray(x), jnp.asarray(pad), jnp.asarray(A), lam=LAM, eps=EPS)
    assert float(stats[:, 2, 0].min()) == 1.0 and float(stats[:, 0, 0].min()) > 0
    np.testing.assert_array_equal(_words(kp), np.asarray(jkp))
    np.testing.assert_allclose(stats[:, 0, 0].numpy(), np.asarray(jstats)[:, 0, 0], rtol=2e-3)
    np.testing.assert_allclose(stats[:, 1, 0].numpy(), np.asarray(jstats)[:, 1, 0], rtol=2e-3)


def test_isolated_sink_partitions_apply_their_cut():
    """The construction the card checks use to make K7 apply cuts: every
    partition applies one, with the JAX kernel's words and cost."""
    x = isolated_sink(torch.from_numpy(np.random.default_rng(5).normal(
        size=(3, 64, 128)).astype(np.float32)), 0.1, EPS)
    pad = np.ones((3, 64), np.float32)
    A = (np.eye(128) * 0.1).astype(np.float32)
    kp, stats = _k7(x.numpy(), pad, A)
    jkp, jstats = jk7(jnp.asarray(x.numpy()), jnp.asarray(pad), jnp.asarray(A), lam=LAM,
                      eps=EPS)
    assert stats[:, 2, 0].tolist() == [1.0, 1.0, 1.0]
    np.testing.assert_array_equal(_words(kp), np.asarray(jkp))
    np.testing.assert_allclose(stats[:, 0, 0].numpy(), np.asarray(jstats)[:, 0, 0], rtol=2e-3)


@pytest.mark.parametrize("bf16", [False, True])
def test_two_hop_sink_partitions_need_the_second_frontier(bf16, monkeypatch):
    """The construction the card checks use against a cut's reachability
    stopped early: every partition applies its cut, with JAX K7's words
    (LN1 folded in with unit gamma); s-reachability cut after its first
    frontier gives other words."""
    import ruvector_tpu_torch.attention.mincut_device as md

    k, b, d = 2, 64, 128
    x = two_hop_sink(k, b, d, 0.1, EPS).numpy()
    pad = np.ones((k, b), np.float32)
    A = (np.eye(d) * 0.1).astype(np.float32)
    ln = (torch.ones(d), torch.zeros(d))
    kp, stats = _k7(x, pad, A, ln=ln, compute_bf16=bf16)
    jkp, jstats = jk7(jnp.asarray(x), jnp.asarray(pad), jnp.asarray(A), lam=LAM, eps=EPS,
                      ln=(jnp.ones(d), jnp.zeros(d)), compute_bf16=bf16)
    assert stats[:, 2, 0].tolist() == [1.0, 1.0]
    np.testing.assert_array_equal(_words(kp), np.asarray(jkp))
    np.testing.assert_allclose(stats[:, 0, 0].numpy(), np.asarray(jstats)[:, 0, 0], rtol=2e-3)

    def one_frontier(r, s):
        reach = torch.zeros(r.shape[:2], dtype=torch.bool)
        reach[:, s] = True
        return reach | ((r > md._TINY) & reach[:, :, None]).any(dim=1)

    monkeypatch.setattr(md, "_reachable_from", one_frontier)
    bad, _ = _k7(x, pad, A, ln=ln, compute_bf16=bf16)
    assert not torch.equal(bad, kp)


@pytest.mark.parametrize("bf16", [False, True])
def test_block_gate_ln_folding(bf16):
    """test_mincut_gate_kernel.py:66: LN1 folded in, f32 and bf16 rounding
    of the normalized features; against JAX K7 and the XLA chain."""
    rng = np.random.default_rng(3)
    k, b, d = 3, 32, 32
    x = (rng.normal(size=(k, b, d)) * 2.0).astype(np.float32)
    pad = np.ones((k, b), np.float32)
    A = (rng.normal(size=(d, d)) * 0.1).astype(np.float32)
    gamma = rng.uniform(0.5, 1.5, d).astype(np.float32)
    beta = (rng.normal(size=d) * 0.1).astype(np.float32)
    kp, _ = _k7(x, pad, A, ln=(torch.from_numpy(gamma), torch.from_numpy(beta)),
                compute_bf16=bf16)
    jkp, _ = jk7(jnp.asarray(x), jnp.asarray(pad), jnp.asarray(A), lam=LAM, eps=EPS,
                 ln=(jnp.asarray(gamma), jnp.asarray(beta)), compute_bf16=bf16)
    np.testing.assert_array_equal(_words(kp), np.asarray(jkp))
    h = jln({"gamma": jnp.asarray(gamma), "beta": jnp.asarray(beta)}, jnp.asarray(x))
    if bf16:
        h = h.astype(jnp.bfloat16)
    ref, _ = jax.vmap(lambda m: jgate(m, LAM, EPS))(jpooled(h, jnp.asarray(pad),
                                                           jnp.asarray(A)))
    np.testing.assert_array_equal(_words(kp), np.asarray(jpack(ref)))
