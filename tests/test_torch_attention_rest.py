"""Parity of the rest of the port's attention family against the JAX
package, on the CPU (the anchors of tests/test_attention.py,
tests/test_attention_extra.py and tests/test_cgt.py): dual-space, mixed
curvature and the Lorentz cascade, coherence gating, the min-cut gate
(host Dinic, device gate, hysteresis, witness log), the coherence-gated
transformer (router, sparse masks, early exit, blocks), mixture of
experts and the SDK.

Inputs are made with numpy from a seed and handed to both packages;
JAX-initialised parameters cross over with params_from_numpy. f32 outputs
agree within 2e-5 of their scale; masks, lanes, layer counts and witness
hashes exactly. Hyperbolic inputs stay inside the Poincaré ball for the
parity checks: on its boundary 1 - ||u||^2 is float32 rounding noise in
either package, and the distance with it.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ruvector_tpu.attention import cgt as jcgt
from ruvector_tpu.attention import dual_space as jds
from ruvector_tpu.attention import mincut as jmc
from ruvector_tpu.attention import mincut_device as jmd
from ruvector_tpu.attention import mixed_curvature as jmix
from ruvector_tpu.attention import moe as jmoe
from ruvector_tpu.attention import pde as jpde
from ruvector_tpu.attention import sdk as jsdk
from ruvector_tpu.attention import topology as jtop
from ruvector_tpu.attention.base import get_attention as jget_attention
from ruvector_tpu.utils import witness as jwit
from ruvector_tpu_torch.attention import cgt as tcgt
from ruvector_tpu_torch.attention import dual_space as tds
from ruvector_tpu_torch.attention import get_attention, list_attention
from ruvector_tpu_torch.attention import mincut as tmc
from ruvector_tpu_torch.attention import mincut_device as tmd
from ruvector_tpu_torch.attention import mixed_curvature as tmix
from ruvector_tpu_torch.attention import moe as tmoe
from ruvector_tpu_torch.attention import pde as tpde
from ruvector_tpu_torch.attention import sdk as tsdk
from ruvector_tpu_torch.attention import topology as ttop
from ruvector_tpu_torch.attention.linear_attn import LinearAttentionConfig
from ruvector_tpu_torch.convert import params_from_numpy
from ruvector_tpu_torch.utils import witness as twit

F32_TOL = 2e-5


def rand(*shape, seed=0, scale=1.0):
    return (scale * np.random.default_rng(seed).normal(size=shape)).astype(np.float32)


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _p(jparams):
    return params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), "cpu")


def _close(got, want, tol=F32_TOL):
    """Within tol of want's scale (at least 1)."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want, atol=tol * max(1.0, float(np.abs(want).max())), rtol=0)


def _qkv(b, s, d, seed, scale=1.0, masked=False):
    q, k, v = (rand(b, d, seed=seed, scale=scale), rand(b, s, d, seed=seed + 1, scale=scale),
               rand(b, s, d, seed=seed + 2))
    mask = None
    if masked:
        mask = (np.random.default_rng(seed + 3).random((b, s)) > 0.3).astype(np.float32)
        mask[0] = 0.0           # a row with no key
    return q, k, v, mask


def _both(*arrays):
    return [_t(a) for a in arrays], [_j(a) for a in arrays]


# --- dual space -----------------------------------------------------------------

@pytest.mark.parametrize("weights", [(1.0, 0.0), (0.0, 1.0), (0.5, 0.5), (0.2, 0.7)])
@pytest.mark.parametrize("masked", [False, True])
def test_dual_space_matches_jax(weights, masked):
    q, k, v, mask = _qkv(3, 6, 16, seed=1, scale=0.1, masked=masked)
    targs, jargs = _both(q, k, v, mask)
    cfg = dict(dim=16, euclidean_weight=weights[0], hyperbolic_weight=weights[1],
               temperature=0.7)
    out = tds.dual_space_attention(*targs, cfg=tds.DualSpaceConfig(**cfg))
    _close(out, jds.dual_space_attention(*jargs, cfg=jds.DualSpaceConfig(**cfg)))


def test_dual_space_blend():
    """tests/test_attention_extra.py's case on the port: the two branches
    differ and the blend is finite."""
    q, k, v = rand(3, 16, seed=1, scale=0.3), rand(3, 6, 16, seed=2, scale=0.3), rand(3, 6, 16, seed=3)
    q, k, v = _t(q), _t(k), _t(v)
    euc = tds.dual_space_attention(q, k, v, cfg=tds.DualSpaceConfig(
        dim=16, euclidean_weight=1.0, hyperbolic_weight=0.0))
    hyp = tds.dual_space_attention(q, k, v, cfg=tds.DualSpaceConfig(
        dim=16, euclidean_weight=0.0, hyperbolic_weight=1.0))
    blend = tds.dual_space_attention(q, k, v, cfg=tds.DualSpaceConfig(dim=16))
    assert not np.allclose(euc.numpy(), hyp.numpy())
    assert np.all(np.isfinite(blend.numpy()))


def test_dual_space_learnable_weights_grad_matches_jax():
    jcfg = jds.DualSpaceConfig(dim=8, learn_weights=True)
    jparams = jds.dual_space_init(jax.random.key(0), jcfg)
    params = tds.dual_space_init(0, tds.DualSpaceConfig(dim=8, learn_weights=True), "cpu")
    np.testing.assert_array_equal(params["blend"].numpy(), np.asarray(jparams["blend"]))
    q, k, v = rand(2, 8, seed=4, scale=0.1), rand(2, 4, 8, seed=5, scale=0.1), rand(2, 4, 8, seed=6)
    jq, jk, jv = _j(q), _j(k), _j(v)
    jgrad = jax.grad(lambda p: jnp.sum(jds.dual_space_attention(
        jq, jk, jv, cfg=jcfg, params=p) ** 2))(jparams)
    blend = params["blend"].clone().requires_grad_(True)
    loss = torch.sum(tds.dual_space_attention(
        _t(q), _t(k), _t(v), cfg=tds.DualSpaceConfig(dim=8, learn_weights=True),
        params={"blend": blend}) ** 2)
    loss.backward()
    assert np.abs(blend.grad.numpy()).max() > 0
    _close(blend.grad, jgrad["blend"])


# --- mixed curvature, Lorentz, topology --------------------------------------------

@pytest.mark.parametrize("masked", [False, True])
def test_mixed_curvature_matches_jax(masked):
    q, k, v, mask = _qkv(2, 5, 24, seed=30, scale=0.2, masked=masked)
    targs, jargs = _both(q, k, v, mask)
    cfg = dict(dim=24, curvature_hyp=1.5, curvature_sph=0.5, temperature=0.8)
    out = tmix.mixed_curvature_attention(*targs, cfg=tmix.MixedCurvatureConfig(**cfg))
    assert out.shape == (2, 24)
    _close(out, jmix.mixed_curvature_attention(*jargs, cfg=jmix.MixedCurvatureConfig(**cfg)))
    # distance to self is ~0 (the anchor's 1e-2)
    d = tmix.mixed_curvature_distance(targs[0], targs[0], tmix.MixedCurvatureConfig(dim=24))
    np.testing.assert_allclose(d.numpy(), 0.0, atol=1e-2)
    k2 = k[:, ::-1].copy()
    _close(tmix.spherical_distance(targs[1], _t(k2), 2.0),
           jmix.spherical_distance(jargs[1], _j(k2), 2.0))


def test_lorentz_distance_matches_jax_and_is_a_metric():
    x = rand(3, 4, seed=33, scale=0.3)
    from ruvector_tpu.attention.hyperbolic import project_to_ball as jproj
    from ruvector_tpu_torch.attention.hyperbolic import project_to_ball as tproj

    xl = tmix.to_lorentz(tproj(_t(x)), 1.0)
    jxl = jmix.to_lorentz(jproj(_j(x)), 1.0)
    _close(xl, jxl)
    _close(tmix.lorentz_inner(xl[:, None], xl[None]), jmix.lorentz_inner(jxl[:, None], jxl[None]))
    d = lambda i, j: float(tmix.lorentz_distance(xl[i], xl[j]))  # noqa: E731
    assert abs(d(0, 1) - d(1, 0)) < 1e-4
    assert d(0, 0) < 1e-2
    assert d(0, 2) <= d(0, 1) + d(1, 2) + 1e-4
    _close(tmix.lorentz_distance(xl[:, None], xl[None], 0.5),
           jmix.lorentz_distance(jxl[:, None], jxl[None], 0.5))


@pytest.mark.parametrize("curvatures", [(0.5, 1.0, 2.0), (1.0,), (0.25, 4.0)])
@pytest.mark.parametrize("masked", [False, True])
def test_lorentz_cascade_matches_jax(curvatures, masked):
    q, k, v, mask = _qkv(2, 6, 8, seed=34, scale=0.1, masked=masked)
    targs, jargs = _both(q, k, v, mask)
    out = tmix.lorentz_cascade_attention(*targs, curvatures=curvatures, temperature=0.5)
    assert out.shape == (2, 8)
    _close(out, jmix.lorentz_cascade_attention(*jargs, curvatures=curvatures, temperature=0.5))


def _coherence_sets():
    rng = np.random.default_rng(37)
    base = rng.normal(size=8).astype(np.float32)
    coherent = (base + 0.05 * rng.normal(size=(1, 6, 8))).astype(np.float32)
    frag = np.concatenate([base + 0.05 * rng.normal(size=(3, 8)),
                           -base + 0.05 * rng.normal(size=(3, 8))])[None].astype(np.float32)
    return base, coherent, frag


def test_fiedler_value_matches_jax():
    """The 16-step power iteration from sin(1..S), on the coherent and
    fragmented sets of the anchor (coherent lambda_2 > fragmented) and a
    random masked batch."""
    _, coherent, frag = _coherence_sets()
    mask = np.ones((1, 6), np.float32)
    lam = {}
    for name, keys in (("coherent", coherent), ("frag", frag)):
        got = ttop.fiedler_value(tpde.graph_laplacian(_t(keys), _t(mask), True))
        want = jtop.fiedler_value(jpde.graph_laplacian(_j(keys), _j(mask), True))
        _close(got, want)
        lam[name] = float(got[0])
    assert lam["coherent"] > lam["frag"]
    _, k, _, m = _qkv(4, 10, 8, seed=40, masked=True)
    for iters in (1, 16, 40):
        _close(ttop.fiedler_value(tpde.graph_laplacian(_t(k), _t(m), True), iters),
               jtop.fiedler_value(jpde.graph_laplacian(_j(k), _j(m), True), iters))


def test_coherence_gating_matches_jax():
    base, coherent, frag = _coherence_sets()
    v = rand(1, 6, 8, seed=38)
    for keys in (frag, coherent):
        out, lam2 = ttop.coherence_gated_attention(_t(base[None]), _t(keys), _t(v),
                                                   cfg=ttop.TopologyConfig(dim=8))
        jout, jlam2 = jtop.coherence_gated_attention(_j(base[None]), _j(keys), _j(v),
                                                     cfg=jtop.TopologyConfig(dim=8))
        assert out.shape == (1, 8) and np.isfinite(float(lam2[0]))
        _close(out, jout)
        _close(lam2, jlam2)


@pytest.mark.parametrize("threshold", [0.0, 0.2, 2.0])
def test_coherence_gating_batch_matches_jax(threshold):
    """A masked batch at three coherence thresholds: none, some and every
    row fragmented (the affinity filter, and its empty-row fallback)."""
    q, k, v, mask = _qkv(5, 7, 8, seed=41, masked=True)
    cfg = dict(dim=8, coherence_threshold=threshold, affinity_threshold=0.1)
    out, lam2 = ttop.coherence_gated_attention(*_both(q, k, v, mask)[0],
                                               cfg=ttop.TopologyConfig(**cfg))
    jout, jlam2 = jtop.coherence_gated_attention(*_both(q, k, v, mask)[1],
                                                 cfg=jtop.TopologyConfig(**cfg))
    _close(out, jout)
    _close(lam2, jlam2)


# --- the min-cut gate ----------------------------------------------------------------

def test_mincut_gating_semantics_match_jax():
    """tests/test_attention.py's cases: all-negative logits gate everything;
    positive logits are kept."""
    for logits, s in ((np.full(4, -1.0), 2),
                      (np.asarray([1.0, 0.5, 0.0, 0.0, 1.0, 0.5, 0.0, 0.0, 1.0]), 3)):
        got = tmc.dynamic_min_cut(logits, s, 0.5, 2, 0.01)
        want = jmc.dynamic_min_cut(logits, s, 0.5, 2, 0.01)
        np.testing.assert_array_equal(got.keep_mask, want.keep_mask)
        assert (got.edges_kept, got.edges_total) == (want.edges_kept, want.edges_total)
    assert tmc.dynamic_min_cut(np.full(4, -1.0), 2, 0.5, 2, 0.01).edges_kept == 0


@pytest.mark.parametrize("seed", range(8))
def test_mincut_host_and_device_match_jax(seed):
    """The port's host Dinic and its device gate against the JAX host gate
    (tests/test_attention_extra.py's random graphs): masks bit-equal, cut
    costs within 1e-4 relative."""
    rng = np.random.default_rng(seed)
    s = int(rng.integers(4, 40))
    logits = rng.normal(size=(s, s)).astype(np.float32)
    lam = float(rng.uniform(0.2, 2.0))
    want = jmc.dynamic_min_cut(logits, s, lam, 2, 0.01)
    host = tmc.dynamic_min_cut(torch.from_numpy(logits), s, lam, 2, 0.01)
    keep, cost = tmd.mincut_gate_device(torch.from_numpy(logits), lam, 0.01)
    np.testing.assert_array_equal(host.keep_mask, want.keep_mask)
    np.testing.assert_array_equal(keep.numpy().reshape(-1), want.keep_mask)
    for c in (host.cut_cost, float(cost)):
        assert abs(c - want.cut_cost) <= 1e-4 * max(1.0, abs(want.cut_cost))


def test_mincut_cut_applied_at_gate_scale_matches_jax():
    """Two weakly coupled communities at S=100: the cut is applied."""
    rng = np.random.default_rng(0)
    s, half = 100, 50
    logits = np.full((s, s), -1.0, np.float32)
    for blk in (slice(0, half), slice(half, s)):
        logits[blk, blk] = rng.uniform(0.5, 2.0, (half, half)).astype(np.float32)
    for _ in range(6):
        logits[int(rng.integers(0, half)), int(rng.integers(half, s))] = 0.05
    want = jmc.dynamic_min_cut(logits, s, 0.5, 2, 0.01)
    host = tmc.dynamic_min_cut(logits, s, 0.5, 2, 0.01)
    keep, cost = tmd.mincut_gate_device(torch.from_numpy(logits), 0.5, 0.01)
    assert host.cut_cost > 0
    np.testing.assert_array_equal(host.keep_mask, want.keep_mask)
    np.testing.assert_array_equal(keep.numpy().reshape(-1), want.keep_mask)
    assert abs(float(cost) - want.cut_cost) <= 1e-4 * max(1.0, want.cut_cost)


@pytest.mark.parametrize("lam", [0.5, 4.0])
def test_attn_mincut_matches_jax(lam):
    q, k, v = rand(24, 16, seed=3), rand(24, 16, seed=4), rand(24, 8, seed=5)
    cfg = dict(lam=lam, tau=2, eps=0.01)
    out, gating = tmc.attn_mincut(_t(q), _t(k), _t(v), tmc.MincutGateConfig(**cfg))
    jout, jgating = jmc.attn_mincut(_j(q), _j(k), _j(v), jmc.MincutGateConfig(**cfg))
    np.testing.assert_array_equal(gating.keep_mask, jgating.keep_mask)
    assert gating.edges_total == 24 * 24
    _close(out, jout, tol=1e-5)
    _close(tmc.attn_softmax(_t(q), _t(k), _t(v)), jmc.attn_softmax(_j(q), _j(k), _j(v)), 1e-5)
    _close(tmc.compute_logits(_t(q), _t(k)), jmc.compute_logits(_j(q), _j(k)))


def test_attn_mincut_output_finite_and_gated():
    q, k, v = rand(4, 8, seed=24), rand(4, 8, seed=25), rand(4, 8, seed=26)
    out, gating = tmc.attn_mincut(_t(q), _t(k), _t(v), tmc.MincutGateConfig(lam=0.5, tau=2))
    assert out.shape == (4, 8) and np.all(np.isfinite(out.numpy()))
    assert gating.edges_total == 16
    base = tmc.attn_softmax(_t(q), _t(k), _t(v))
    if gating.edges_kept < gating.edges_total:
        assert not np.allclose(out.numpy(), base.numpy())


def test_attn_mincut_device_matches_jax():
    """attn_mincut_device and its batched form against JAX's (the batched
    one is jax.vmap of the single form there), and the registry's
    `mincut`, which runs the device route."""
    rng = np.random.default_rng(3)
    q, k = (rng.normal(size=(3, 24, 16)).astype(np.float32) for _ in range(2))
    v = rng.normal(size=(3, 24, 8)).astype(np.float32)
    out, keep, cut = tmd.attn_mincut_device_batched(_t(q), _t(k), _t(v), 0.5, 0.01)
    jout, jkeep, jcut = jmd.attn_mincut_device_batched(_j(q), _j(k), _j(v), 0.5, 0.01)
    np.testing.assert_array_equal(keep.numpy(), np.asarray(jkeep))
    _close(out, jout, tol=1e-5)
    _close(cut, jcut, tol=1e-4)
    o1, k1, c1 = tmd.attn_mincut_device(_t(q[0]), _t(k[0]), _t(v[0]))
    np.testing.assert_array_equal(k1.numpy(), keep[0].numpy())
    _close(o1, out[0], tol=1e-6)
    _, gating = jmc.attn_mincut(_j(q[0]), _j(k[0]), _j(v[0]), jmc.MincutGateConfig())
    np.testing.assert_array_equal(k1.numpy().reshape(-1), gating.keep_mask)
    reg = get_attention("mincut")
    _close(reg.apply(None, tmc.MincutGateConfig(), _t(q[1]), _t(k[1]), _t(v[1])),
           jget_attention("mincut").apply(None, jmc.MincutGateConfig(), _j(q[1]), _j(k[1]),
                                          _j(v[1])), tol=1e-5)
    kd, cd = tmd.mincut_gate_device(torch.full((6, 6), -2.0), 0.5, 0.01)
    assert int(kd.sum()) == 0 and float(cd) == 0.0


def test_hysteresis_matches_jax():
    """No flip before tau, a flip at tau (hysteresis.rs tests), step by
    step against JAX's state."""
    seq = [[True, True, False]] + [[False, True, True]] * 3 + [[True, False, True]] * 2
    state, jstate = tmc.hysteresis_init((3,), "cpu"), jmc.hysteresis_init((3,))
    outs = []
    for raw in seq:
        state, out = tmc.hysteresis_apply(state, torch.tensor(raw), tau=3)
        jstate, jout = jmc.hysteresis_apply(jstate, jnp.asarray(raw), tau=3)
        np.testing.assert_array_equal(out.numpy(), np.asarray(jout))
        np.testing.assert_array_equal(state.counts.numpy(), np.asarray(jstate.counts))
        outs.append(out.tolist())
    assert outs[:4] == [[True, True, False]] * 3 + [[False, True, True]]
    assert int(state.step) == len(seq)


def test_attn_mincut_witness_logging():
    q, k, v = rand(4, 8, seed=50), rand(4, 8, seed=51), rand(4, 8, seed=52)
    log = twit.WitnessLog()
    tmc.attn_mincut(_t(q), _t(k), _t(v), tmc.MincutGateConfig(), witness_log=log)
    assert len(log.records) == 1 and log.records[0].label == "attn_mincut"
    assert log.verify()
    log2 = twit.WitnessLog()
    tmc.attn_mincut(_t(q), _t(k), _t(v), tmc.MincutGateConfig(), witness_log=log2)
    assert log.head == log2.head
    log2.records[0].meta["lam"] = 0.7
    assert not log2.verify()


def test_witness_matches_jax():
    """The port's copy of utils/witness: the same arrays and records give
    the same hashes and chain as the JAX package's."""
    arrays = [rand(3, 4, seed=60), np.arange(6, dtype=np.int32), np.ones(5, bool)]
    assert twit.tensor_witness(*arrays) == jwit.tensor_witness(*arrays)
    logs = (twit.WitnessLog(), jwit.WitnessLog())
    for i, a in enumerate(arrays):
        for log in logs:
            log.record(f"step{i}", a, cut=0.25 * i, kept=i)
    assert logs[0].head == logs[1].head
    assert [r.chain_hash for r in logs[0].records] == [r.chain_hash for r in logs[1].records]
    assert logs[0].verify()


# --- the coherence-gated transformer -------------------------------------------------

def test_router_lane_boundaries_match_jax():
    for avg in (False, True):
        cfg = dict(theta_reflex=1.0, theta_standard=5.0, theta_deep=20.0, use_average_energy=avg)
        e = np.asarray([0.5, 1.5, 10.0, 50.0, 8.0, 0.2, 90.0, 400.0], np.float32)
        lanes = tcgt.route_by_energy(_t(e), tcgt.TokenRouterConfig(**cfg))
        np.testing.assert_array_equal(
            lanes.numpy(), np.asarray(jcgt.route_by_energy(_j(e), jcgt.TokenRouterConfig(**cfg))))
    lanes = tcgt.route_by_energy(_t(e[:4]), tcgt.TokenRouterConfig(
        theta_reflex=1.0, theta_standard=5.0, theta_deep=20.0, use_average_energy=False))
    assert lanes.tolist() == [0, 1, 2, 3]
    stats = tcgt.lane_statistics(lanes)
    assert stats == tcgt.LaneStatistics(**dataclasses.asdict(jcgt.lane_statistics(lanes.numpy())))
    assert stats.reflex_ratio == stats.deep_ratio == 0.25
    assert stats.estimate_latency_ms() == pytest.approx(0.1 + 1.0 + 5.0 + 0.05)
    # energy 8 over context 4 -> mean 2 -> the standard lane
    assert (tcgt.route_by_energy(torch.full((4,), 8.0), tcgt.TokenRouterConfig(
        theta_reflex=1.0, theta_standard=5.0, theta_deep=20.0)) == 1).all()
    with pytest.raises(ValueError):
        tcgt.TokenRouterConfig(theta_reflex=5.0, theta_standard=1.0).validate()
    assert tcgt.ComputeLane.DEEP.typical_latency_ms == jcgt.ComputeLane.DEEP.typical_latency_ms


@pytest.mark.parametrize("lanes", [[1, 1, 1, 1], [0, 0, 3, 2, 1], [2, 2, 0]])
def test_tune_thresholds_matches_jax(lanes):
    cfg = dict(theta_reflex=1.0, theta_standard=5.0, theta_deep=20.0)
    got = tcgt.tune_thresholds(tcgt.TokenRouterConfig(**cfg),
                               tcgt.lane_statistics(np.asarray(lanes)), 0.5, 0.25)
    want = jcgt.tune_thresholds(jcgt.TokenRouterConfig(**cfg),
                                jcgt.lane_statistics(np.asarray(lanes)), 0.5, 0.25)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    if lanes == [1, 1, 1, 1]:      # want 50% reflex -> theta_reflex must rise
        assert got.theta_reflex > 1.0
        assert got.theta_reflex < got.theta_standard < got.theta_deep


@pytest.mark.parametrize("case", ["floor", "window", "ties", "nonfinite"])
def test_residual_sparse_mask_matches_jax(case):
    rng = np.random.default_rng(0)
    s = 16
    if case == "floor":
        e = rng.uniform(0, 2, (s, s)).astype(np.float32)
        cfg = dict(residual_threshold=1.9, max_sparsity=0.95, min_connections=3)
    elif case == "window":
        s = 12
        e = np.arange(s * s, dtype=np.float32).reshape(s, s) * 1e-3
        cfg = dict(residual_threshold=10.0, max_sparsity=1.0, min_connections=1,
                   include_self=False, local_window=2)
    elif case == "ties":            # every entry tied with the k-th is kept
        e = rng.integers(0, 3, (s, s)).astype(np.float32)
        cfg = dict(residual_threshold=5.0, max_sparsity=1.0, min_connections=2,
                   include_self=False)
    else:
        e = rng.uniform(0, 2, (s, s)).astype(np.float32)
        e[2, :10] = np.inf
        e[3, 5] = np.nan
        cfg = dict(residual_threshold=1.5, max_sparsity=0.9, min_connections=2)
    mask = tcgt.residual_sparse_mask(_t(e), tcgt.SparseResidualConfig(**cfg))
    want = np.asarray(jcgt.residual_sparse_mask(_j(e), jcgt.SparseResidualConfig(**cfg)))
    np.testing.assert_array_equal(mask.numpy(), want)
    if case == "floor":
        m = mask.numpy()
        assert m.diagonal().all() and (m.sum(1) >= 3).all() and m[e >= 1.9].all()
        stats = tcgt.sparsity_statistics(mask)
        assert dataclasses.asdict(stats) == dataclasses.asdict(jcgt.sparsity_statistics(want))
        assert 0 < stats.sparsity < 1 and stats.estimated_speedup > 1
        row_ptr, cols = tcgt.mask_to_csr(mask)
        jrow_ptr, jcols = jcgt.mask_to_csr(want)
        np.testing.assert_array_equal(row_ptr, jrow_ptr)
        np.testing.assert_array_equal(cols, jcols)
        assert row_ptr[-1] == stats.nnz
    if case == "ties":
        assert (mask.numpy().sum(1) > 2).any()


@pytest.mark.parametrize("case", ["contraction", "diverging", "min_layers", "zero_energy"])
def test_early_exit_matches_jax(case):
    """layers_used, the converged count and the exit reason equal JAX's;
    the energies within 2e-5 relative."""
    factor, cfg, x0 = {
        "contraction": (0.5, dict(epsilon=1e-2, max_layers=30, patience=2, ema_alpha=1.0), 2.0),
        "diverging": (1.5, dict(epsilon=1e-6, max_layers=5, patience=3, ema_alpha=1.0), 1.0),
        "min_layers": (0.9, dict(epsilon=0.5, min_layers=4, max_layers=9, patience=1), 1.0),
        "zero_energy": (0.0, dict(epsilon=1e-3, max_layers=7), 1.0),
    }[case]
    x = np.full((4,), x0, np.float32)
    xf, n, ema, conv, e0 = tcgt.run_with_early_exit(
        lambda z: factor * z, _t(x), lambda z: torch.sum(z * z), tcgt.EarlyExitConfig(**cfg))
    jxf, jn, jema, jconv, je0 = jcgt.run_with_early_exit(
        lambda z: factor * z, _j(x), lambda z: jnp.sum(z * z), jcgt.EarlyExitConfig(**cfg))
    assert (n, conv) == (int(jn), int(jconv))
    _close(xf, jxf)
    _close(ema, jema)
    res, stats = tcgt.early_exit_result(n, ema, conv, tcgt.EarlyExitConfig(**cfg), e0)
    jres, jstats = jcgt.early_exit_result(jn, jema, jconv, jcgt.EarlyExitConfig(**cfg), je0)
    assert res.exit_reason.name == jres.exit_reason.name
    assert stats.layers_saved == jstats.layers_saved
    if case == "contraction":
        assert n < 30 and stats.speedup_ratio > 1 and stats.energy_reduction > 0.5
    if case == "diverging":
        assert n == 5 and res.exit_reason is tcgt.ExitReason.MAX_LAYERS_REACHED


_ROUTERS = {
    "default": {},
    "lanes": dict(theta_reflex=1e-4, theta_standard=1e-2, theta_deep=1e6),
    # between the quartiles of the block test's mean token energies
    "mixed": dict(theta_reflex=4.85, theta_standard=5.3, theta_deep=6.0),
    # the same for the forward test's inputs
    "mixed_forward": dict(theta_reflex=2.75, theta_standard=3.1, theta_deep=3.45),
}


def _cgt_cfgs(d, router):
    sparse = dict(residual_threshold=0.1, max_sparsity=0.8, min_connections=2, local_window=1)
    return (tcgt.CgtConfig(dim=d, router=tcgt.TokenRouterConfig(**router),
                           sparse=tcgt.SparseResidualConfig(**sparse), reflex_window=2),
            jcgt.CgtConfig(dim=d, router=jcgt.TokenRouterConfig(**router),
                           sparse=jcgt.SparseResidualConfig(**sparse), reflex_window=2))


@pytest.mark.parametrize("router", sorted(_ROUTERS))
def test_cgt_block_matches_jax(router):
    """One lane-modulated block (tests/test_cgt.py's case and two more
    routers): lanes equal, outputs and energies within 2e-5 of scale."""
    d, s = 32, 24
    cfg, jcfg = _cgt_cfgs(d, _ROUTERS[router])
    jparams = jcgt.cgt_init(jax.random.key(0), jcfg)
    x = rand(s, d, seed=1, scale=0.3 if router == "mixed" else 1.0)
    out, lanes, energy = tcgt.cgt_block_apply(_p(jparams), cfg, _t(x))
    jout, jlanes, jenergy = jcgt.cgt_block_apply(jparams, jcfg, _j(x))
    np.testing.assert_array_equal(lanes.numpy(), np.asarray(jlanes))
    _close(out, jout)
    _close(energy, jenergy)
    assert energy.numpy().min() >= 0 and set(lanes.tolist()) <= {0, 1, 2, 3}
    if router == "mixed":
        assert set(lanes.tolist()) == {0, 1, 2, 3}


@pytest.mark.parametrize("router", ["default", "mixed_forward"])
def test_cgt_forward_matches_jax(router):
    """The full stack under the early exit: layers_used, the converged
    count and the final lanes equal JAX's."""
    d, s = 16, 12
    cfg, jcfg = _cgt_cfgs(d, _ROUTERS[router])
    jparams = jcgt.cgt_init(jax.random.key(2), jcfg)
    x = rand(s, d, seed=3, scale=0.3 if router == "mixed_forward" else 1.0)
    ecfg = dict(epsilon=5e-2, max_layers=6, patience=1)
    xf, n, ema, conv, e0, lanes = tcgt.cgt_forward(_p(jparams), cfg, _t(x),
                                                   tcgt.EarlyExitConfig(**ecfg))
    jxf, jn, jema, jconv, je0, jlanes = jax.jit(
        lambda p, xx: jcgt.cgt_forward(p, jcfg, xx, jcgt.EarlyExitConfig(**ecfg)))(jparams, _j(x))
    assert (n, conv) == (int(jn), int(jconv)) and 1 <= n <= 6
    np.testing.assert_array_equal(lanes.numpy(), np.asarray(jlanes))
    _close(xf, jxf)
    _close(ema, jema)
    res, stats = tcgt.early_exit_result(n, ema, conv, tcgt.EarlyExitConfig(**ecfg), e0)
    assert isinstance(res.exit_reason, tcgt.ExitReason) and stats.max_layers == 6


def test_cgt_gelu_is_the_tanh_form(monkeypatch):
    """jax.nn.gelu is the tanh approximation: the deep lanes' FFN with
    torch's default erf GELU misses JAX's block by more than the
    tolerance, the tanh form matches it."""
    d, s = 16, 8
    cfg, jcfg = _cgt_cfgs(d, _ROUTERS["lanes"])
    jparams = jcgt.cgt_init(jax.random.key(4), jcfg)
    jparams["ffn_in"]["kernel"] = jparams["ffn_in"]["kernel"] * 4.0
    x = rand(s, d, seed=5)
    want = jcgt.cgt_block_apply(jparams, jcfg, _j(x))[0]
    _close(tcgt.cgt_block_apply(_p(jparams), cfg, _t(x))[0], want)
    erf = types.SimpleNamespace(gelu=lambda z, approximate="none": torch.nn.functional.gelu(z))
    monkeypatch.setattr(tcgt, "F", erf)
    with pytest.raises(AssertionError):
        _close(tcgt.cgt_block_apply(_p(jparams), cfg, _t(x))[0], want)


# --- mixture of experts -----------------------------------------------------------------

def _moe(d=16, experts=3, top_k=2, jitter=0.0, seed=3):
    jcfg = jmoe.MoEAttentionConfig(dim=d, num_experts=experts, top_k=top_k, jitter_noise=jitter)
    cfg = tmoe.MoEAttentionConfig(dim=d, num_experts=experts, top_k=top_k, jitter_noise=jitter)
    return cfg, jcfg, jmoe.moe_attention_init(jax.random.key(seed), jcfg)


@pytest.mark.parametrize("experts,top_k", [(3, 2), (3, 1), (4, 3), (2, 5)])
@pytest.mark.parametrize("masked", [False, True])
def test_moe_matches_jax(experts, top_k, masked):
    cfg, jcfg, jparams = _moe(experts=experts, top_k=top_k)
    q, k, v, mask = _qkv(4, 8, 16, seed=35, scale=0.1, masked=masked)
    targs, jargs = _both(q, k, v, mask)
    out = tmoe.moe_attention_apply(_p(jparams), cfg, *targs)
    assert out.shape == (4, 16)
    _close(out, jmoe.moe_attention_apply(jparams, jcfg, *jargs))


def test_moe_top_k_keeps_ties():
    """Router logits tied with the k-th largest are all kept (sort, then
    >=), as in JAX: with a zero router every expert ties, so top-1 blends
    all three equally."""
    cfg, jcfg, jparams = _moe(top_k=1)
    jparams["router"] = {"kernel": jnp.zeros_like(jparams["router"]["kernel"]),
                         "bias": jnp.zeros_like(jparams["router"]["bias"])}
    q, k, v, _ = _qkv(4, 8, 16, seed=36, scale=0.1)
    targs, jargs = _both(q, k, v)
    out = tmoe.moe_attention_apply(_p(jparams), cfg, *targs)
    _close(out, jmoe.moe_attention_apply(jparams, jcfg, *jargs))
    one = tmoe.moe_attention_apply(_p(jparams), dataclasses.replace(cfg, num_experts=1), *targs)
    assert float((out - one).abs().max()) > 1e-3


def test_moe_gradients_match_jax():
    cfg, jcfg, jparams = _moe()
    q, k, v = rand(4, 16, seed=35, scale=0.1), rand(4, 8, 16, seed=36, scale=0.1), rand(4, 8, 16, seed=37)
    jgrad = jax.grad(lambda p: jnp.sum(jmoe.moe_attention_apply(
        p, jcfg, _j(q), _j(k), _j(v)) ** 2))(jparams)
    params = jax.tree_util.tree_map(
        lambda a: torch.from_numpy(np.array(a)).requires_grad_(True), jparams)
    torch.sum(tmoe.moe_attention_apply(params, cfg, _t(q), _t(k), _t(v)) ** 2).backward()
    assert np.abs(params["router"]["kernel"].grad.numpy()).max() > 0
    for path in (("router", "kernel"), ("router", "bias"), ("linear_expert", "proj")):
        got = params[path[0]][path[1]].grad
        want = np.asarray(jgrad[path[0]][path[1]])
        _close(got, want, tol=F32_TOL * max(1.0, float(np.abs(want).max())))


def test_moe_jitter_is_seeded():
    """Jitter draws from the caller's torch.Generator: finite, of the right
    shape, the same for the same seed, other for another."""
    cfg, _, jparams = _moe(jitter=0.5)
    params = _p(jparams)
    q, k, v, _ = _qkv(6, 8, 16, seed=38, scale=0.1)
    targs, _ = _both(q, k, v)

    def run(seed):
        return tmoe.moe_attention_apply(params, cfg, *targs,
                                        rng=torch.Generator().manual_seed(seed))

    a, b, c = run(0), run(0), run(1)
    assert a.shape == (6, 16) and np.all(np.isfinite(a.numpy()))
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert not np.array_equal(a.numpy(), c.numpy())
    # without a generator the jitter is off, as in JAX without a key
    _close(tmoe.moe_attention_apply(params, cfg, *targs),
           jmoe.moe_attention_apply(jparams, dataclasses.replace(
               jmoe.MoEAttentionConfig(dim=16), jitter_noise=0.5), *_both(q, k, v)[1]))


# --- the SDK and the registry -------------------------------------------------------------

def test_presets_build_and_match_jax():
    """All ten presets build; each runs in its own form (longformer over a
    sequence) and agrees with the JAX preset, parameters carried over."""
    q, k, v = rand(2, 32, seed=23, scale=0.1), rand(2, 8, 32, seed=24, scale=0.1), rand(2, 8, 32, seed=25)
    x = rand(40, 32, seed=26)
    assert tsdk.PRESETS == jsdk.PRESETS and len(tsdk.PRESETS) == 10
    for name in tsdk.PRESETS:
        jbuilt = jsdk.preset(name, 32)
        built = tsdk.preset(name, 32, device="cpu")
        assert (built.name, built.config, built.apply_kwargs) == (
            jbuilt.name, _tcfg(jbuilt.config), jbuilt.apply_kwargs), name
        if jbuilt.params is not None:
            built = dataclasses.replace(built, params=_p(jbuilt.params))
        if name == "longformer":
            out = built(_t(x), _t(x), _t(x), local_window=4, num_global=2)
            want = jbuilt(_j(x), _j(x), _j(x), local_window=4, num_global=2)
        else:
            out, want = built(_t(q), _t(k), _t(v)), jbuilt(_j(q), _j(k), _j(v))
        _close(out, want)
    with pytest.raises(ValueError):
        tsdk.preset("nope", 8)


def _tcfg(jcfg):
    """The port's config of the same name and fields as a JAX config."""
    if jcfg is None:
        return None
    mod = {"LinearAttentionConfig": LinearAttentionConfig,
           "MoEAttentionConfig": tmoe.MoEAttentionConfig}[type(jcfg).__name__]
    return mod(**dataclasses.asdict(jcfg))


def test_attention_pipeline_matches_jax():
    q, k, v = rand(2, 16, seed=26), rand(2, 4, 16, seed=27), rand(2, 4, 16, seed=28)
    p = tsdk.AttentionPipeline([tsdk.AttentionBuilder(16).mechanism("scaled_dot").build(),
                                tsdk.AttentionBuilder(16).mechanism("flash").build()])
    jp = jsdk.AttentionPipeline([jsdk.AttentionBuilder(16).mechanism("scaled_dot").build(),
                                 jsdk.AttentionBuilder(16).mechanism("flash").build()])
    out = p(_t(q), _t(k), _t(v))
    assert out.shape == (2, 16)
    _close(out, jp(_j(q), _j(k), _j(v)))
    built = tsdk.AttentionBuilder(16).mechanism("scaled_dot").temperature(2.0).build()
    jbuilt = jsdk.AttentionBuilder(16).mechanism("scaled_dot").temperature(2.0).build()
    _close(built(_t(q), _t(k), _t(v)), jbuilt(_j(q), _j(k), _j(v)))


def test_builder_seed_takes_a_generator():
    """Parameters come from a torch.Generator: an int seed and a generator
    seeded alike build the same parameters; another seed other ones."""
    def build(seed):
        return (tsdk.AttentionBuilder(16, device="cpu").mechanism("moe")
                .config(tmoe.MoEAttentionConfig(dim=16)).seed(seed).build())

    a, b, c = build(5), build(torch.Generator().manual_seed(5)), build(6)
    np.testing.assert_array_equal(a.params["router"]["kernel"].numpy(),
                                  b.params["router"]["kernel"].numpy())
    assert not np.array_equal(a.params["router"]["kernel"].numpy(),
                              c.params["router"]["kernel"].numpy())


def test_registry_covers_full_family():
    names = set(list_attention())
    for want in ["scaled_dot", "flash", "linear", "local_global", "edge_featured", "mincut",
                 "hyperbolic", "moe", "dual_space", "sliced_wasserstein", "centroid_ot",
                 "info_bottleneck", "diffusion", "sheaf", "mixed_curvature",
                 "lorentz_cascade", "coherence_gated"]:
        assert want in names, want
    from ruvector_tpu.attention import list_attention as jlist

    assert names == set(jlist())


_REGISTERED = {
    "dual_space": (tds.DualSpaceConfig(dim=16), jds.DualSpaceConfig(dim=16)),
    "mixed_curvature": (tmix.MixedCurvatureConfig(dim=15), jmix.MixedCurvatureConfig(dim=15)),
    "lorentz_cascade": (None, None),
    "coherence_gated": (ttop.TopologyConfig(dim=16), jtop.TopologyConfig(dim=16)),
    "moe": (tmoe.MoEAttentionConfig(dim=16), jmoe.MoEAttentionConfig(dim=16)),
}


@pytest.mark.parametrize("name", sorted(_REGISTERED))
def test_registered_mechanisms_match_jax(name):
    """Each new mechanism through the registry, the per-node form with a
    mask, against the JAX registry's."""
    cfg, jcfg = _REGISTERED[name]
    jmech = jget_attention(name)
    jparams = jmech.init(jax.random.key(7), jcfg) if jmech.init is not None else None
    q, k, v, mask = _qkv(5, 7, 16 if name != "mixed_curvature" else 15, seed=70, scale=0.1,
                         masked=True)
    targs, jargs = _both(q, k, v, mask)
    mech = get_attention(name)
    params = _p(jparams) if jparams is not None else None
    _close(mech.apply(params, cfg, *targs), jmech.apply(jparams, jcfg, *jargs))
