"""Parity of the port's min-cut-gated transformer (serving and training
path: config, packets, gate, quant, kv_cache, sparse_attention,
mod_routing, model, trace, decode, spec_decode, train_spec) against the
JAX package, on the CPU. Mirrors tests/test_transformer.py, the MoD and
sparse-attention cases of tests/test_transformer_subsystems.py, the
speculative and train_spec cases of tests/test_serve.py, and the
speculative integration case of tests/test_integration_extra.py
(test_transformer_with_sona_adapter waits for the port of `sona/`).

Weights are JAX-initialised (`init_weights(jax.random.key(n), micro)`) and
cross over as numpy; token inputs are numpy. Exact: gate decisions, tiers,
witnesses (but the logits hash, which hashes float bits), int8 codes and
scales, int32 sums, KV-cache codes, scales and positions fed the same K/V,
layers run, greedy and speculative tokens, acceptance counts. f32 logits
within 1e-4 max / 1e-5 mean of their scale; the int8 route's whole-model
logits within 1e-3 of their scale (the f32 LayerNorm around each int8
product may round one activation code the other way).

JAX runs quantization inside jitted programs, where XLA folds a division
by a constant into a product with its float32 reciprocal; the quant and
cache comparisons call the JAX functions under jax.jit for that reason.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ruvector_tpu import transformer as J
from ruvector_tpu.transformer import decode as jdec
from ruvector_tpu.transformer import kv_cache as jkv
from ruvector_tpu.transformer import mod_routing as jmod
from ruvector_tpu.transformer import quant as jquant
from ruvector_tpu.transformer import sparse_attention as jsparse
from ruvector_tpu.transformer import spec_decode as jspec
from ruvector_tpu.transformer import trace as jtrace
from ruvector_tpu.transformer import train_spec as jtrain
from ruvector_tpu_torch import transformer as T
from ruvector_tpu_torch.convert import params_to_numpy
from ruvector_tpu_torch.transformer import decode as tdec
from ruvector_tpu_torch.transformer import kv_cache as tkv
from ruvector_tpu_torch.transformer import mod_routing as tmod
from ruvector_tpu_torch.transformer import quant as tquant
from ruvector_tpu_torch.transformer import sparse_attention as tsparse
from ruvector_tpu_torch.transformer import spec_decode as tspec
from ruvector_tpu_torch.transformer import trace as ttrace
from ruvector_tpu_torch.transformer import train_spec as ttrain

CPU = "cpu"
MICRO = J.TransformerConfig.micro()
TMICRO = T.TransformerConfig.micro()
INT8_TOL = 1e-3


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


_jax_init = jax.jit(J.init_weights, static_argnums=(1, 2))


@functools.lru_cache(maxsize=None)
def jax_weights(seed, cfg=MICRO, quantize=True):
    """(JAX weights, the port's copy on the CPU); no test changes either."""
    w = _jax_init(jax.random.key(seed), cfg, quantize)
    return w, T.init_weights(np_tree(w), T.TransformerConfig(**dataclasses.asdict(cfg)),
                             device=CPU)


def tcfg(cfg):
    return T.TransformerConfig(**dataclasses.asdict(cfg))


def tgate(g):
    return None if g is None else T.GatePacket(**dataclasses.asdict(g))


def tspike(s):
    return None if s is None else T.SpikePacket(**dataclasses.asdict(s))


def close_scaled(got, want, tol=(1e-4, 1e-5)):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape and np.isfinite(got).all()
    scale = max(np.abs(want).max(), 1e-30)
    err = np.abs(got - want) / scale
    assert err.max() <= tol[0] and err.mean() <= tol[1], (err.max(), err.mean())


def same_witness(wt, wj, with_hash=False):
    assert (wt.tier, wt.decision.value, wt.reason.value, wt.kv_writes_enabled,
            wt.external_writes_enabled, wt.layers_run, wt.early_exit_layer) == (
        wj.tier, wj.decision.value, wj.reason.value, wj.kv_writes_enabled,
        wj.external_writes_enabled, wj.layers_run, wj.early_exit_layer)
    if with_hash:
        assert wt.logits_hash == wj.logits_hash


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for this module's small tensors: beside the
    other workers of a parallel test run, many-threaded torch ops
    oversubscribe the cores (20 micro training steps took 56 s instead of
    0.6 s beside six busy processes)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def models():
    wj, wt = jax_weights(0)
    return (J.MincutGatedTransformer(MICRO, J.GatePolicy(), wj),
            T.MincutGatedTransformer(TMICRO, T.GatePolicy(), wt, device=CPU))


# --- config, packets, gate controller (gate.rs semantics) -------------------

def test_config_presets_and_policy_match():
    for name in ("baseline", "micro"):
        a, b = getattr(J.TransformerConfig, name)(), getattr(T.TransformerConfig, name)()
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
        assert (a.head_dim, a.ffn_dim) == (b.head_dim, b.ffn_dim)
    assert dataclasses.asdict(J.GatePolicy()) == dataclasses.asdict(T.GatePolicy())


def test_packets_and_witness_hash_match():
    for g in (J.GatePacket(lam=40, lam_prev=100), J.GatePacket(lam=120, lam_prev=100),
              J.GatePacket(lam_prev=0, flags=3)):
        t = tgate(g)
        assert (t.drop_ratio_q15(), t.lambda_delta(), t.force_safe(), t.skip_requested()) == (
            g.drop_ratio_q15(), g.lambda_delta(), g.force_safe(), g.skip_requested())
    logits = np.random.default_rng(0).normal(size=(256,)).astype(np.float32)
    assert T.Witness.hash_logits(logits) == J.Witness.hash_logits(logits)
    assert T.Witness.hash_logits(logits[::2]) == J.Witness.hash_logits(logits[::2])


GATE_CASES = {
    "normal": (J.GatePacket(lam=100, lam_prev=100), None),
    "skip_flag": (J.GatePacket(flags=J.GatePacket.FLAG_SKIP), None),
    "force_safe": (J.GatePacket(flags=J.GatePacket.FLAG_FORCE_SAFE), None),
    "lambda_below_min": (J.GatePacket(lam=5), None),
    "lambda_drop_flushes_kv": (J.GatePacket(lam=40, lam_prev=100), None),
    "boundary_spike_reduces": (J.GatePacket(boundary_edges=100), None),
    "boundary_concentration": (J.GatePacket(boundary_concentration_q15=30000), None),
    "partition_drift": (J.GatePacket(partition_count=20), None),
    "spike_inactive_skips": (J.GatePacket(), J.SpikePacket(fired=0)),
    "spike_storm_goes_safe": (J.GatePacket(), J.SpikePacket(fired=1, rate_q15=30000)),
}


@pytest.mark.parametrize("case", sorted(GATE_CASES))
def test_gate_decisions_match(models, case):
    mj, mt = models
    g, s = GATE_CASES[case]
    dj = mj.gate_controller.evaluate(g, s)
    dt = mt.gate_controller.evaluate(tgate(g), tspike(s))
    assert dt.decision.value == dj.decision.value and dt.reason.value == dj.reason.value
    assert (dt.tier, dt.skip, dt.layers_to_run, dt.effective_seq_len, dt.effective_window) == (
        dj.tier, dj.skip, dj.layers_to_run, dj.effective_seq_len, dj.effective_window)
    assert mt.gate_controller.should_allow_kv_writes(tgate(g)) == \
        mj.gate_controller.should_allow_kv_writes(g)
    assert mt.gate_controller.should_allow_external_writes(tgate(g)) == \
        mj.gate_controller.should_allow_external_writes(g)


# --- int8 quantization --------------------------------------------------------

@pytest.mark.parametrize("shape", [(8, 64, 32), (1, 128, 384), (5, 512, 128)])
def test_int8_codes_sums_and_matmul_bit_equal(shape):
    m, k, n = shape
    rng = np.random.default_rng(m * k)
    x = rng.normal(size=(m, k)).astype(np.float32)
    w = rng.normal(size=(k, n)).astype(np.float32)
    wq_j, s_j = jax.jit(jquant.quantize_weight_int8)(jnp.asarray(w))
    wq_t, s_t = tquant.quantize_weight_int8(torch.from_numpy(w))
    np.testing.assert_array_equal(wq_t.numpy(), np.asarray(wq_j))
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))
    xq_j, xs_j = jax.jit(jquant.quantize_activation_int8)(jnp.asarray(x))
    xq_t, xs_t = tquant.quantize_activation_int8(torch.from_numpy(x))
    np.testing.assert_array_equal(xq_t.numpy(), np.asarray(xq_j))
    np.testing.assert_array_equal(xs_t.numpy(), np.asarray(xs_j))
    acc_j = jax.lax.dot_general(xq_j, wq_j, (((1,), (0,)), ((), ())),
                                preferred_element_type=jnp.int32)
    np.testing.assert_array_equal(tquant.int8_sums(xq_t, wq_t).numpy(), np.asarray(acc_j))
    out_j = jax.jit(jquant.int8_matmul)(jnp.asarray(x), wq_j, s_j)
    out_t = tquant.int8_matmul(torch.from_numpy(x), wq_t, s_t)
    np.testing.assert_array_equal(out_t.numpy(), np.asarray(out_j))
    # with a bias XLA contracts the last product and the add into one FMA
    bias = rng.normal(size=(n,)).astype(np.float32)
    out_j = jax.jit(jquant.int8_matmul)(jnp.asarray(x), wq_j, s_j, jnp.asarray(bias))
    out_t = tquant.int8_matmul(torch.from_numpy(x), wq_t, s_t, torch.from_numpy(bias))
    close_scaled(out_t.numpy(), out_j, (1e-6, 1e-7))
    np.testing.assert_array_equal(tquant.dequantize_int8(wq_t, s_t).numpy(),
                                  np.asarray(jquant.dequantize_int8(wq_j, s_j)))


def test_int8_sums_do_not_wrap_at_127():
    """int8 x int8 through torch.matmul wraps on the CPU (a row of 127s
    times a column of 127s over K=4 gives 4); the sums must be exact."""
    k = 4096
    x = torch.full((3, k), 127, dtype=torch.int8)
    x[1] = -127
    x[2, ::2] = -127
    w = torch.full((k, 2), 127, dtype=torch.int8)
    w[:, 1] = -127
    got = tquant.int8_sums(x, w)
    want = x.numpy().astype(np.int64) @ w.numpy().astype(np.int64)
    assert want[0, 0] == 127 * 127 * k
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.dtype == torch.int32


def test_int8_matmul_accuracy():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(8, 64)).astype(np.float32)
    w = rng.normal(size=(64, 32)).astype(np.float32)
    wq, s = tquant.quantize_weight_int8(torch.from_numpy(w))
    exact = x @ w
    approx = tquant.int8_matmul(torch.from_numpy(x), wq, s).numpy()
    assert np.abs(approx - exact).max() / np.abs(exact).max() < 0.05


def test_int8_matmul_deterministic():
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.normal(size=(4, 16)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(16, 8)).astype(np.float32))
    wq, s = tquant.quantize_weight_int8(w)
    assert torch.equal(tquant.int8_matmul(x, wq, s), tquant.int8_matmul(x, wq, s))


# --- KV cache tiers -----------------------------------------------------------

def assert_cache_equal(st, sj):
    for f in tkv._FIELDS:
        np.testing.assert_array_equal(getattr(st, f).numpy(), np.asarray(getattr(sj, f)),
                                      err_msg=f)


CACHE_RUNS = {
    # (hot, warm, archive, heads, head_dim, tokens, disabled steps, seed)
    "hot_only": (4, 4, 4, 2, 8, 3, (), 2),
    "spill_to_warm": (2, 4, 4, 1, 8, 5, (), 3),
    "spill_to_archive": (2, 2, 4, 1, 8, 6, (), 4),
    "archive_wraps": (3, 4, 5, 2, 16, 20, (), 5),
    "gate_frozen_writes": (3, 4, 5, 2, 16, 17, (4, 5, 11), 6),
}


@pytest.mark.parametrize("run", sorted(CACHE_RUNS))
def test_kv_cache_bit_equal_to_jax(run):
    hc, wc, ac, h, d, n, off, seed = CACHE_RUNS[run]
    cj = J.KVCacheConfig(hot_capacity=hc, warm_capacity=wc, archive_capacity=ac, heads=h,
                         head_dim=d)
    ct = T.KVCacheConfig(**dataclasses.asdict(cj))
    append_j = jax.jit(jkv.kv_cache_append, static_argnums=0)
    sj, st = jkv.kv_cache_init(cj), tkv.kv_cache_init(ct, device=CPU)
    ks = np.random.default_rng(seed).normal(size=(n, 2, h, d)).astype(np.float32)
    for i in range(n):
        en = i not in off
        sj = append_j(cj, sj, jnp.asarray(ks[i, 0]), jnp.asarray(ks[i, 1]), en)
        st = tkv.kv_cache_append(ct, st, torch.from_numpy(ks[i, 0]), torch.from_numpy(ks[i, 1]),
                                 enabled=en)
        assert_cache_equal(st, sj)
    for a, b in zip(tkv.kv_cache_read(ct, st), jkv.kv_cache_read(cj, sj)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    pos = tkv.kv_cache_positions(ct, st).numpy()
    np.testing.assert_array_equal(pos, np.asarray(jkv.kv_cache_positions(cj, sj)))
    # the JAX tests' own checks: live count, chronological reconstruction
    k, _, mask = tkv.kv_cache_read(ct, st)
    live = [i for i in range(n) if i not in off]
    m = mask.numpy() > 0
    assert int(m.sum()) == min(len(live), hc + wc + ac)
    got = k.numpy()[m][np.argsort(pos[m])]
    want = ks[live, 0][-int(m.sum()):]
    np.testing.assert_allclose(got[-hc:], want[-hc:], atol=1e-6)       # hot exact
    np.testing.assert_allclose(got, want, atol=0.25)                   # int4 coarsest
    flushed = tkv.kv_cache_flush(ct, st)
    assert int(flushed.length) == 0 and bool((flushed.hot_pos == -1).all())


def test_kv_cache_batched_append_freezes_members():
    """A batched state with per-member `enabled`: each member equals its
    own unbatched run, a disabled member's live rows and length stay."""
    ct = T.KVCacheConfig(hot_capacity=2, warm_capacity=3, archive_capacity=2, heads=2,
                         head_dim=4)
    rng = np.random.default_rng(7)
    kv = torch.from_numpy(rng.normal(size=(9, 3, 2, 2, 4)).astype(np.float32))
    en = torch.from_numpy(rng.random((9, 3)) > 0.3)
    batched = tkv.kv_cache_init(ct, device=CPU, batch=3)
    singles = [tkv.kv_cache_init(ct, device=CPU) for _ in range(3)]
    for i in range(9):
        batched = tkv.kv_cache_append(ct, batched, kv[i, :, 0], kv[i, :, 1], enabled=en[i])
        singles = [tkv.kv_cache_append(ct, s, kv[i, b, 0], kv[i, b, 1], enabled=bool(en[i, b]))
                   for b, s in enumerate(singles)]
    for f in tkv._FIELDS:
        stacked = torch.stack([getattr(single, f) for single in singles])
        assert torch.equal(getattr(batched, f), stacked), f
    assert batched.length.tolist() == en.sum(0).tolist()


def test_kv_cache_zero_capacity_tiers_live_rows_match_jax():
    """warm = archive = 0 (the hot-only serving cache): the port skips the
    tiers that are only scratch rows; everything readable equals JAX's."""
    cj = J.KVCacheConfig(hot_capacity=3, warm_capacity=0, archive_capacity=0, heads=2,
                         head_dim=8)
    ct = T.KVCacheConfig(**dataclasses.asdict(cj))
    append_j = jax.jit(jkv.kv_cache_append, static_argnums=0)
    sj, st = jkv.kv_cache_init(cj), tkv.kv_cache_init(ct, device=CPU)
    ks = np.random.default_rng(8).normal(size=(7, 2, 2, 8)).astype(np.float32)
    for i in range(7):
        sj = append_j(cj, sj, jnp.asarray(ks[i, 0]), jnp.asarray(ks[i, 1]), True)
        st = tkv.kv_cache_append(ct, st, torch.from_numpy(ks[i, 0]), torch.from_numpy(ks[i, 1]))
    for f in ("hot_k", "hot_v", "hot_pos", "length"):
        np.testing.assert_array_equal(getattr(st, f).numpy(), np.asarray(getattr(sj, f)))
    for a, b in zip(tkv.kv_cache_read(ct, st), jkv.kv_cache_read(cj, sj)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


# --- the tier programs: determinism, tiers, witnesses -------------------------

def test_deterministic_inference(models):
    _, mt = models
    tokens = np.asarray([1, 2, 3, 4, 5, 6, 7, 8])
    out1, out2 = mt.infer(tokens=tokens), mt.infer(tokens=tokens)
    np.testing.assert_array_equal(out1.logits, out2.logits)  # bit-exact
    assert out1.witness.logits_hash == out2.witness.logits_hash
    assert out1.witness.tier == 0


def test_different_inputs_different_witness(models):
    _, mt = models
    w1 = mt.infer(tokens=np.asarray([1, 2, 3])).witness
    w2 = mt.infer(tokens=np.asarray([4, 5, 6])).witness
    assert w1.logits_hash != w2.logits_hash


INFER_CASES = {
    "normal_8": (np.arange(1, 9), J.GatePacket(), None),
    "normal_full_window": (np.arange(40) % 256, J.GatePacket(), None),
    "reduced_boundary": (np.arange(20), J.GatePacket(boundary_edges=100), None),
    "safe_forced": (np.arange(12), J.GatePacket(flags=J.GatePacket.FLAG_FORCE_SAFE), None),
    "quarantine_low_lambda": (np.asarray([1]), J.GatePacket(lam=5), None),
    "flush_lambda_drop": (np.asarray([7, 3, 9]), J.GatePacket(lam=40, lam_prev=100), None),
    "spike_storm": (np.arange(5), J.GatePacket(), J.SpikePacket(fired=1, rate_q15=30000)),
}


@pytest.mark.parametrize("case", sorted(INFER_CASES))
def test_tier_logits_and_witness_match_jax(models, case):
    mj, mt = models
    tokens, g, s = INFER_CASES[case]
    oj = mj.infer(tokens=tokens, gate=g, spikes=s)
    ot = mt.infer(tokens=tokens, gate=tgate(g), spikes=tspike(s))
    assert ot.logits.shape == (MICRO.logits,) and ot.logits.dtype == np.float32
    close_scaled(ot.logits, oj.logits, (INT8_TOL, INT8_TOL))
    same_witness(ot.witness, oj.witness)
    assert ot.stats == oj.stats


def test_skip_tier_returns_cached(models):
    _, mt = models
    tokens = np.asarray([1, 2, 3, 4])
    full = mt.infer(tokens=tokens)
    skipped = mt.infer(tokens=tokens, gate=T.GatePacket(flags=T.GatePacket.FLAG_SKIP))
    assert skipped.stats.get("skipped")
    np.testing.assert_array_equal(skipped.logits, full.logits)
    assert skipped.witness.layers_run == 0
    assert skipped.witness.logits_hash == full.witness.logits_hash


def test_tier_programs_have_static_shapes(models):
    _, mt = models
    out = mt.infer(tokens=np.arange(20), gate=T.GatePacket(boundary_edges=100))
    assert out.witness.tier == 1
    assert out.logits.shape == (MICRO.logits,)


def test_embedding_input_matches_jax(models):
    mj, mt = models
    e = np.random.default_rng(3).normal(size=(11, MICRO.hidden)).astype(np.float32)
    oj, ot = mj.infer(embedding=e), mt.infer(embedding=e)
    close_scaled(ot.logits, oj.logits, (INT8_TOL, INT8_TOL))
    same_witness(ot.witness, oj.witness)


# the relative change of this model's 4 layers on the test's input is
# 37.9, 1.14, 0.70, 0.61: these thresholds exit after 4 (none), 3, 2 and 1
@pytest.mark.parametrize("threshold,layers", [(0.0, 4), (0.8, 3), (2.0, 2), (1e9, 1)])
def test_early_exit_layers_match_jax(threshold, layers):
    cfg = dataclasses.replace(MICRO, layers=4, layers_degraded=2)
    wj, wt = jax_weights(1, cfg)
    mj = J.MincutGatedTransformer(cfg, J.GatePolicy(), wj, early_exit_threshold=threshold)
    mt = T.MincutGatedTransformer(tcfg(cfg), T.GatePolicy(), wt,
                                  early_exit_threshold=threshold, device=CPU)
    tokens = np.asarray([1, 2, 3, 9, 4])
    oj, ot = mj.infer(tokens=tokens), mt.infer(tokens=tokens)
    same_witness(ot.witness, oj.witness)
    close_scaled(ot.logits, oj.logits, (INT8_TOL, INT8_TOL))
    assert ot.witness.layers_run == layers


def test_external_writes_gating(models):
    _, mt = models
    assert mt.infer(tokens=np.asarray([1])).witness.external_writes_enabled == 1
    frozen = mt.infer(tokens=np.asarray([1]), gate=T.GatePacket(lam=5)).witness
    assert frozen.external_writes_enabled == 0


def test_trace_state_counters_and_snapshot(models):
    """trace.rs TraceCounters/TraceSnapshot over the same witnesses."""
    mj, mt = models
    trace_j, trace_t = jtrace.TraceState(), ttrace.TraceState(keep_last=4)
    tokens = np.arange(8) % MICRO.vocab
    for g in (J.GatePacket(), J.GatePacket(), J.GatePacket(flags=J.GatePacket.FLAG_SKIP),
              J.GatePacket(boundary_edges=100), J.GatePacket(lam=5), J.GatePacket()):
        trace_j.record(mj.infer(tokens=tokens, gate=g).witness)
        trace_t.record(mt.infer(tokens=tokens, gate=tgate(g)).witness)
    sj, st = trace_j.snapshot(), trace_t.snapshot()
    for f in ("inferences", "tier_counts", "skips", "early_exits", "total_layers_run",
              "kv_writes_enabled", "distinct_logit_hashes"):
        assert getattr(st, f) == getattr(sj, f), f
    assert st.mean_layers_per_inference == sj.mean_layers_per_inference
    assert sorted(st.decision_counts.values()) == sorted(sj.decision_counts.values())
    assert len(trace_t.recent()) == 4 and st.inferences == 6


# --- MoD routing and min-cut sparse attention --------------------------------

ROUTE_CASES = {
    "capacity_target": (jmod.ModRoutingConfig(layer_capacity_ratio=0.5, min_tokens_per_layer=2,
                                              adaptive_capacity=False),
                        J.GatePacket(partition_count=1)),
    "boundary_forced": (jmod.ModRoutingConfig(layer_capacity_ratio=0.25),
                        J.GatePacket(partition_count=4)),
    "stable_lambda": (jmod.ModRoutingConfig(layer_capacity_ratio=0.25),
                      J.GatePacket(lam=100, lam_prev=100)),
    "unstable_lambda": (jmod.ModRoutingConfig(layer_capacity_ratio=0.25),
                        J.GatePacket(lam=100, lam_prev=50)),
    "flops_reduction": (jmod.ModRoutingConfig.with_flops_reduction(0.7),
                        J.GatePacket(partition_count=3)),
}


@pytest.mark.parametrize("case", sorted(ROUTE_CASES))
def test_mod_routes_match_jax(case):
    cj, g = ROUTE_CASES[case]
    rj = jmod.MincutDepthRouter(cj)
    rt = tmod.MincutDepthRouter(tmod.ModRoutingConfig(**dataclasses.asdict(cj)))
    routes_j = rj.route_tokens(g, np.arange(32))
    routes_t = rt.route_tokens(tgate(g), np.arange(32))
    assert [r.value for r in routes_t] == [r.value for r in routes_j]
    np.testing.assert_array_equal(rt.compute_layer_mask(routes_t), rj.compute_layer_mask(routes_j))
    assert dataclasses.asdict(rt.routing_stats(routes_t)) == \
        dataclasses.asdict(rj.routing_stats(routes_j))


def test_mod_capacity_boundaries_and_adaptivity():
    router = tmod.MincutDepthRouter(tmod.ModRoutingConfig(
        layer_capacity_ratio=0.5, min_tokens_per_layer=2, adaptive_capacity=False))
    stats = router.routing_stats(router.route_tokens(T.GatePacket(partition_count=1),
                                                     np.arange(32)))
    assert stats.compute_tokens == 16 and stats.skip_tokens == 16
    routes = tmod.MincutDepthRouter(tmod.ModRoutingConfig(layer_capacity_ratio=0.25)) \
        .route_tokens(T.GatePacket(partition_count=4), np.arange(32))
    assert sum(r is tmod.TokenRoute.BOUNDARY for r in routes) == 4
    assert routes[0] is tmod.TokenRoute.BOUNDARY and routes[8] is tmod.TokenRoute.BOUNDARY
    adaptive = tmod.MincutDepthRouter(tmod.ModRoutingConfig(layer_capacity_ratio=0.25))
    stable = adaptive.routing_stats(adaptive.route_tokens(T.GatePacket(lam=100, lam_prev=100),
                                                          np.arange(32)))
    unstable = adaptive.routing_stats(adaptive.route_tokens(T.GatePacket(lam=100, lam_prev=50),
                                                            np.arange(32)))
    assert unstable.compute_tokens > stable.compute_tokens
    with pytest.raises(ValueError):
        tmod.ModRoutingConfig(layer_capacity_ratio=0.0).validate()


def test_mod_apply_masked_and_routed_match_jax():
    x = np.random.default_rng(0).normal(size=(8, 4)).astype(np.float32)
    mask = np.asarray([1, 0, 1, 0, 1, 0, 1, 0], np.float32)
    idx = np.asarray([0, 2, 4, 6])
    layer_j, layer_t = (lambda v: v * 2.0 + 1.0), (lambda v: v * 2.0 + 1.0)
    masked_j = jmod.apply_layer_masked(layer_j, jnp.asarray(x), jnp.asarray(mask))
    masked_t = tmod.apply_layer_masked(layer_t, torch.from_numpy(x), torch.from_numpy(mask))
    routed_t = tmod.apply_layer_routed(layer_t, torch.from_numpy(x), torch.from_numpy(idx))
    np.testing.assert_array_equal(masked_t.numpy(), np.asarray(masked_j))
    np.testing.assert_array_equal(
        routed_t.numpy(), np.asarray(jmod.apply_layer_routed(layer_j, jnp.asarray(x),
                                                             jnp.asarray(idx))))
    np.testing.assert_array_equal(masked_t[1].numpy(), x[1])


SPARSE_CASES = {
    "unstructured_full": (jsparse.SparsityConfig(), J.GatePacket(partition_count=1), 32),
    "partitioned": (jsparse.SparsityConfig(), J.GatePacket(lam=100, partition_count=4), 32),
    "linear": (jsparse.SparsityConfig(lambda_based_density=jsparse.LambdaDensitySchedule(
        "linear", 0.2, 0.8)), J.GatePacket(lam=120, partition_count=3), 40),
    "threshold": (jsparse.SparsityConfig(lambda_based_density=jsparse.LambdaDensitySchedule(
        "threshold", dense_above_lambda=150)), J.GatePacket(lam=200, partition_count=5), 24),
    "no_schedule_no_cross": (jsparse.SparsityConfig(lambda_based_density=None,
                                                    boundary_cross_attention=False),
                             J.GatePacket(lam=60, partition_count=2), 20),
}


def _tsparsity(cj):
    sched = cj.lambda_based_density
    return tsparse.SparsityConfig(**{
        **dataclasses.asdict(cj),
        "lambda_based_density": None if sched is None else tsparse.LambdaDensitySchedule(
            **dataclasses.asdict(sched))})


@pytest.mark.parametrize("case", sorted(SPARSE_CASES))
def test_sparse_masks_match_jax(case):
    cj, g, s = SPARSE_CASES[case]
    mj = jsparse.MincutSparseAttention(cj).build_mask(g, s)
    sa = tsparse.MincutSparseAttention(_tsparsity(cj))
    mt = sa.build_mask(tgate(g), s)
    np.testing.assert_array_equal(mt.mask, mj.mask)
    assert (mt.density, mt.partition_boundaries, mt.boundary_tokens) == (
        mj.density, mj.partition_boundaries, mj.boundary_tokens)
    assert sa.calculate_density(tgate(g)) == \
        jsparse.MincutSparseAttention(cj).calculate_density(g)
    assert not np.any(np.triu(mt.mask, k=1))           # causal


def test_sparse_attention_matches_jax_and_dense_on_full_mask():
    rng = np.random.default_rng(1)
    q, k, v = (rng.normal(size=(8, 16)).astype(np.float32) for _ in range(3))
    full = tsparse.SparseMask.full(8)
    out = tsparse.sparse_attention(*(torch.from_numpy(a) for a in (q, k, v)), full.mask)
    scores = q @ k.T / 4.0
    scores[np.triu_indices(8, 1)] = -np.inf
    attn = np.exp(scores - scores.max(1, keepdims=True))
    np.testing.assert_allclose(out.numpy(), attn / attn.sum(1, keepdims=True) @ v, atol=1e-4)
    # a mask with an empty row: that row contributes 0, as in JAX
    mask = np.tril(rng.random((8, 8)) > 0.4)
    mask[3] = False
    got = tsparse.sparse_attention(*(torch.from_numpy(a) for a in (q, k, v)), mask)
    want = jsparse.sparse_attention(*(jnp.asarray(a) for a in (q, k, v)), mask)
    close_scaled(got.numpy(), want)
    assert not got[3].any()


def test_model_with_sparse_attention_and_mod_matches_jax():
    wj, wt = jax_weights(2)
    mod_j = jmod.ModRoutingConfig(layer_capacity_ratio=0.15, min_tokens_per_layer=2,
                                  adaptive_capacity=False)
    mj = J.MincutGatedTransformer(MICRO, J.GatePolicy(), wj,
                                  sparsity_config=jsparse.SparsityConfig(), mod_config=mod_j)
    mt = T.MincutGatedTransformer(TMICRO, T.GatePolicy(), wt,
                                  sparsity_config=tsparse.SparsityConfig(),
                                  mod_config=tmod.ModRoutingConfig(**dataclasses.asdict(mod_j)),
                                  device=CPU)
    tokens = np.arange(24)
    g = J.GatePacket(lam=100, partition_count=4)
    oj, ot = mj.infer(tokens=tokens, gate=g), mt.infer(tokens=tokens, gate=tgate(g))
    close_scaled(ot.logits, oj.logits, (INT8_TOL, INT8_TOL))
    same_witness(ot.witness, oj.witness)
    np.testing.assert_array_equal(mt.infer(tokens=tokens, gate=tgate(g)).logits, ot.logits)
    plain = T.MincutGatedTransformer(TMICRO, T.GatePolicy(), wt, device=CPU)
    assert not np.array_equal(ot.logits, plain.infer(tokens=tokens, gate=tgate(g)).logits)


# --- decode with the KV cache --------------------------------------------------

@pytest.fixture(scope="module")
def decoders():
    wj, wt = jax_weights(3)
    return (jdec.Decoder(MICRO, J.GatePolicy(), wj),
            tdec.Decoder(TMICRO, T.GatePolicy(), wt, device=CPU))


def test_decoder_generates_deterministically_and_matches_jax(decoders):
    dj, dt = decoders
    prompt = np.asarray([1, 2, 3])
    r1, r2 = dt.generate(prompt, max_new_tokens=5), dt.generate(prompt, max_new_tokens=5)
    assert r1.tokens == r2.tokens and len(r1.tokens) == 8
    assert all(0 <= t < MICRO.logits for t in r1.tokens)
    assert r1.tokens == dj.generate(prompt, max_new_tokens=5).tokens


def test_decoder_gate_flushes_kv_like_jax():
    wj, wt = jax_weights(4)
    dj = jdec.Decoder(MICRO, J.GatePolicy(), wj)
    dt = tdec.Decoder(TMICRO, T.GatePolicy(), wt, device=CPU)

    def crisis(cls):
        # big lambda drop on step 2 -> FlushKv; low lambda at 5 freezes writes
        return lambda step: (cls(lam=10, lam_prev=100) if step == 2 else
                             cls(lam=5) if step == 5 else cls())

    rj = dj.generate(np.asarray([1, 2, 3, 4]), max_new_tokens=4, gate_fn=crisis(J.GatePacket))
    rt = dt.generate(np.asarray([1, 2, 3, 4]), max_new_tokens=4, gate_fn=crisis(T.GatePacket))
    assert rt.kv_flushes == rj.kv_flushes == 1
    assert rt.frozen_steps == rj.frozen_steps and rt.frozen_steps >= 1
    assert rt.tokens == rj.tokens


def test_decode_step_logits_and_cache_match_jax(decoders):
    """The step over a prompt long enough to spill into warm and archive
    (micro's default cache: hot 8, warm 32, archive 32)."""
    dj, dt = decoders
    cj, ct = dj.init_caches(), dt.init_caches()
    tokens = np.random.default_rng(5).integers(0, MICRO.vocab, 44)
    for pos, t in enumerate(tokens):
        lj, cj = dj._step(dj.weights, cj, jnp.int32(t), jnp.int32(pos), jnp.bool_(True))
        lt, ct = dt._step(dt.weights, ct, int(t), pos, True)
        close_scaled(lt.numpy(), lj, (INT8_TOL, INT8_TOL))
    for c_t, c_j in zip(ct, cj):
        for f in tkv._FIELDS:
            a, b = getattr(c_t, f).numpy(), np.asarray(getattr(c_j, f))
            if a.dtype == np.float32:        # hot K/V and the scales
                close_scaled(a, b)
            else:                            # codes, positions, length
                np.testing.assert_array_equal(a, b, err_msg=f)


def test_jitted_generation_matches_host_loop(decoders):
    dj, dt = decoders
    prompt = np.asarray([2, 9, 4])
    host = dt.generate(prompt, max_new_tokens=4)
    gen = tdec.make_generate_fn(TMICRO, dt.cache_cfg, prompt_len=3, max_new_tokens=4, device=CPU)
    tokens, _ = gen(dt.weights, dt.init_caches(), prompt)
    np.testing.assert_array_equal(tokens.numpy(), host.tokens[:7])
    gen_j = jdec.make_generate_fn(MICRO, dj.cache_cfg, prompt_len=3, max_new_tokens=4)
    np.testing.assert_array_equal(
        tokens.numpy(), np.asarray(gen_j(dj.weights, dj.init_caches(), jnp.asarray(prompt))[0]))


def test_batched_generation_matches_single_and_jax():
    wj, wt = jax_weights(7)
    dj = jdec.Decoder(MICRO, J.GatePolicy(), wj)
    dt = tdec.Decoder(TMICRO, T.GatePolicy(), wt, device=CPU)
    prompts = np.asarray([[2, 9, 4], [1, 1, 3], [5, 0, 2], [8, 7, 6]])
    gen1 = tdec.make_generate_fn(TMICRO, dt.cache_cfg, 3, 5, device=CPU)
    singles = np.stack([gen1(wt, dt.init_caches(), p)[0].numpy() for p in prompts])
    genb = tdec.make_batched_generate_fn(TMICRO, dt.cache_cfg, 3, 5, device=CPU)
    batched, caches = genb(wt, dt.init_caches(batch=4), prompts)
    np.testing.assert_array_equal(batched.numpy(), singles)
    assert caches[0].length.tolist() == [8] * 4
    genb_j = jdec.make_batched_generate_fn(MICRO, dj.cache_cfg, 3, 5)
    caches_j = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs),
                                      *[dj.init_caches() for _ in prompts])
    np.testing.assert_array_equal(batched.numpy(),
                                  np.asarray(genb_j(wj, caches_j, jnp.asarray(prompts))[0]))


def test_gather_clamps_ids_past_the_vocab():
    """logits > vocab: the argmax can name an id past the embedding table.
    JAX clamps the gather to the last row; the port must too (torch would
    assert on the device)."""
    cfg = dataclasses.replace(MICRO, vocab=8)
    wj, wt = jax_weights(9, cfg)
    dj = jdec.Decoder(cfg, J.GatePolicy(), wj)
    dt = tdec.Decoder(tcfg(cfg), T.GatePolicy(), wt, device=CPU)
    rt = dt.generate(np.asarray([1, 7, 3]), max_new_tokens=6)
    assert max(rt.tokens[3:]) >= cfg.vocab
    assert rt.tokens == dj.generate(np.asarray([1, 7, 3]), max_new_tokens=6).tokens
    mj = J.MincutGatedTransformer(cfg, J.GatePolicy(), wj)
    mt = T.MincutGatedTransformer(tcfg(cfg), T.GatePolicy(), wt, device=CPU)
    toks = np.asarray([1, 200, 7, 255])
    close_scaled(mt.infer(tokens=toks).logits, mj.infer(tokens=toks).logits,
                 (INT8_TOL, INT8_TOL))


# --- speculative decoding ------------------------------------------------------

SPEC_CACHE = dict(hot_capacity=8, warm_capacity=16, archive_capacity=16,
                  heads=MICRO.heads, head_dim=MICRO.head_dim)


def _warm(step, weights, caches, prompt, jax_side):
    logits = None
    for pos, t in enumerate(prompt):
        if jax_side:
            logits, caches = step(weights, caches, jnp.int32(int(t)), jnp.int32(pos),
                                  jnp.bool_(True))
        else:
            logits, caches = step(weights, caches, int(t), pos, True)
    return logits, caches


def test_speculative_generate_matches_greedy_and_jax():
    wj, wt = jax_weights(7)
    cj, ct = J.KVCacheConfig(**SPEC_CACHE), T.KVCacheConfig(**SPEC_CACHE)
    step_j = jdec.make_decode_step(MICRO, cj)
    step_t = tdec.make_decode_step(TMICRO, ct, device=CPU)
    prompt = [5, 17, 9]
    lj, caches_j = _warm(step_j, wj, [jkv.kv_cache_init(cj) for _ in range(2)], prompt, True)
    lt, caches_t = _warm(step_t, wt, [tkv.kv_cache_init(ct, CPU) for _ in range(2)], prompt,
                         False)
    b = torch.argmax(lt)
    assert int(b) == int(jnp.argmax(lj))
    max_new = 10
    greedy, g_caches, cur, pos = [], caches_t, b, len(prompt)
    for _ in range(max_new):
        greedy.append(int(cur))
        g_logits, g_caches = step_t(wt, g_caches, cur, pos, True)
        cur, pos = torch.argmax(g_logits), pos + 1
    gen = tspec.make_speculative_generate_fn(TMICRO, ct, T.SpecDecodeConfig(4, 1), max_new,
                                             device=CPU)
    out, count, _, acc_total, commits = gen(wt, caches_t, b)
    assert int(count) == max_new and out.tolist() == greedy
    c = commits.numpy()
    assert c[: int(np.searchsorted(np.cumsum(c), max_new)) + 1].min() >= 1
    gen_j = jspec.make_speculative_generate_fn(MICRO, cj, jspec.SpecDecodeConfig(4, 1), max_new)
    oj = gen_j(wj, caches_j, jnp.argmax(lj).astype(jnp.int32))
    assert out.tolist() == np.asarray(oj[0]).tolist() and int(count) == int(oj[1])
    assert int(acc_total) == int(oj[3])
    np.testing.assert_array_equal(commits.numpy(), np.asarray(oj[4]))


def test_decoder_generate_speculative_matches_greedy(decoders):
    dj, dt = decoders
    prompt = np.asarray([3, 1, 4, 1])
    rt = dt.generate_speculative(prompt, max_new_tokens=9, gamma=3, draft_layers=1)
    assert rt.tokens == dt.generate(prompt, max_new_tokens=9).tokens
    assert rt.tokens == dj.generate(prompt, max_new_tokens=9).tokens
    assert 0 <= rt.accepted <= 9


@pytest.fixture(scope="module")
def trained():
    """Early-exit weights trained by the port (the test_serve protocol,
    from JAX's initial weights; the port must clear the JAX test's bar)."""
    init = np_tree(_jax_init(jax.random.key(0), MICRO, False))
    res = ttrain.train_early_exit(TMICRO, draft_layers=1, steps=150, batch=16, seq_len=32,
                                  seed=0, init=init, device=CPU)
    assert res.agreement >= 0.8, res
    return jax.tree_util.tree_map(jnp.asarray, params_to_numpy(res.weights)), res.weights


def _spec_batch_jax(wj, cj, prompts, new_tokens, gamma):
    step = jax.jit(jax.vmap(jdec.make_decode_step(MICRO, cj), in_axes=(None, 0, 0, None, None)))
    caches = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *[
        [jkv.kv_cache_init(cj) for _ in range(MICRO.layers)] for _ in prompts])
    logits = None
    for pos in range(prompts.shape[1]):
        logits, caches = step(wj, caches, jnp.asarray(prompts[:, pos]), jnp.int32(pos),
                              jnp.bool_(True))
    sgen = jspec.make_speculative_generate_fn(MICRO, cj, jspec.SpecDecodeConfig(gamma, 1),
                                              new_tokens)
    return jax.jit(jax.vmap(sgen, in_axes=(None, 0, 0)))(
        wj, caches, jnp.argmax(logits, axis=-1).astype(jnp.int32))


def test_trained_draft_batched_speculative_matches_jax_and_greedy(trained):
    """The benchmark's protocol at micro size: trained early-exit weights,
    a hot-only cache, 4 prompts decoded together greedily and
    speculatively. Tokens identical to greedy, acceptance >= 0.5 and every
    output equal to JAX's vmapped loop."""
    wj, wt = trained
    cj = J.KVCacheConfig(hot_capacity=64, warm_capacity=0, archive_capacity=0,
                         heads=MICRO.heads, head_dim=MICRO.head_dim)
    ct = T.KVCacheConfig(**dataclasses.asdict(cj))
    prompts, _ = ttrain.markov_corpus(0, MICRO.vocab, n_seq=4, seq_len=6, sample_seed=77)
    new_tokens, gamma = 24, 4
    genb = tdec.make_batched_generate_fn(TMICRO, ct, 6, new_tokens, device=CPU)
    greedy, _ = genb(wt, [tkv.kv_cache_init(ct, CPU, batch=4) for _ in range(2)], prompts)
    step = tdec.make_decode_step(TMICRO, ct, device=CPU)
    caches = [tkv.kv_cache_init(ct, CPU, batch=4) for _ in range(2)]
    logits = None
    for pos in range(6):
        logits, caches = step(wt, caches, torch.from_numpy(prompts[:, pos]), pos, True)
    sgen = tspec.make_speculative_generate_fn(TMICRO, ct, T.SpecDecodeConfig(gamma, 1),
                                              new_tokens, device=CPU)
    toks, counts, _, acc, commits = sgen(wt, caches, torch.argmax(logits, dim=-1))
    np.testing.assert_array_equal(toks.numpy(), greedy.numpy()[:, 6:])
    assert counts.tolist() == [new_tokens] * 4
    n_macros = (commits > 0).sum(1).numpy()
    acceptance = acc.numpy() / np.maximum((gamma - 1) * n_macros, 1)
    assert acceptance.mean() >= 0.5, acceptance
    oj = _spec_batch_jax(wj, cj, prompts, new_tokens, gamma)
    for got, want in zip((toks, counts, acc, commits), (oj[0], oj[1], oj[3], oj[4])):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_batched_speculative_freezes_finished_members():
    """Members that finish at different macro steps: each equals its own
    unbatched run (tokens, count, acceptance, commits, cache length, codes
    and positions exactly; the f32 K/V and scales within 1e-5 of their
    scale, since a batched product rounds apart from a single row's; the
    scratch rows, where a frozen member's disabled writes land, aside), so
    a finished member's state stays frozen while the others run on."""
    _, wt = jax_weights(7)
    ct = T.KVCacheConfig(**SPEC_CACHE)
    prompts = np.asarray([[5, 17, 9], [3, 3, 3], [200, 1, 64], [9, 8, 7]])
    step = tdec.make_decode_step(TMICRO, ct, device=CPU)
    gen = tspec.make_speculative_generate_fn(TMICRO, ct, T.SpecDecodeConfig(4, 1), 12,
                                             device=CPU)
    singles = []
    for p in prompts:
        lt, c = _warm(step, wt, [tkv.kv_cache_init(ct, CPU) for _ in range(2)], p, False)
        singles.append(gen(wt, c, torch.argmax(lt)))
    caches = [tkv.kv_cache_init(ct, CPU, batch=4) for _ in range(2)]
    logits = None
    for pos in range(3):
        logits, caches = step(wt, caches, torch.from_numpy(prompts[:, pos]), pos, True)
    toks, counts, out_caches, acc, commits = gen(wt, caches, torch.argmax(logits, dim=-1))
    n_macros = (commits > 0).sum(1)
    assert len(set(n_macros.tolist())) > 1, n_macros        # members finish apart
    for i, (s_toks, s_count, s_caches, s_acc, s_commits) in enumerate(singles):
        assert toks[i].tolist() == s_toks.tolist() and int(counts[i]) == int(s_count)
        assert int(acc[i]) == int(s_acc) and commits[i].tolist() == s_commits.tolist()
        for layer in range(2):
            for f in tkv._FIELDS:
                got, want = getattr(out_caches[layer], f)[i], getattr(s_caches[layer], f)
                if f != "length":          # the scratch rows take the frozen writes
                    got, want = got[:-1], want[:-1]
                if got.dtype == torch.float32:
                    close_scaled(got.numpy(), want.numpy(), (1e-5, 1e-6))
                else:
                    assert torch.equal(got, want), (i, layer, f)


# --- early-exit training -------------------------------------------------------

@pytest.mark.parametrize("seeds", [(3, None), (3, 9), (0, 1234)])
def test_markov_corpus_bit_equal(seeds):
    chain, sample = seeds
    tj, sj = jtrain.markov_corpus(chain, 32, n_seq=6, seq_len=20, sample_seed=sample)
    tt, st = ttrain.markov_corpus(chain, 32, n_seq=6, seq_len=20, sample_seed=sample)
    np.testing.assert_array_equal(tt, tj)
    np.testing.assert_array_equal(st, sj)
    assert (tt[:, 1:] == st[tt[:, :-1]]).mean() > 0.8


def test_seq_logits_at_depths_match_jax():
    wj, wt = jax_weights(0, quantize=False)
    toks, _ = jtrain.markov_corpus(3, MICRO.vocab, n_seq=2, seq_len=40)
    logits_j = jax.jit(jtrain.seq_logits_at_depths, static_argnums=(1, 3))
    for seq in toks:
        lj = logits_j(wj, MICRO, jnp.asarray(seq), (1, MICRO.layers))
        lt = ttrain.seq_logits_at_depths(wt, TMICRO, torch.from_numpy(seq), (1, MICRO.layers))
        for a, b in zip(lt, lj):
            assert a.shape == (40, MICRO.logits)
            close_scaled(a.numpy(), b)
    batched = ttrain.seq_logits_at_depths(wt, TMICRO, torch.from_numpy(toks), (1,))[0]
    close_scaled(batched[1].numpy(), logits_j(wj, MICRO, jnp.asarray(toks[1]), (1,))[0])


def test_train_early_exit_losses_match_jax():
    """Three Adam steps from JAX's initial weights: the losses within 1e-4
    relative, and the evaluation's accuracies within one position."""
    kw = dict(draft_layers=1, steps=3, batch=8, seq_len=32, seed=0)
    rj = jtrain.train_early_exit(MICRO, **kw)
    init = np_tree(J.init_weights(jax.random.key(0), MICRO, quantize=False))
    rt = ttrain.train_early_exit(TMICRO, init=init, device=CPU, **kw)
    np.testing.assert_allclose(rt.losses, rj.losses, rtol=1e-4)
    for f in ("full_acc", "draft_acc", "agreement"):
        assert abs(getattr(rt, f) - getattr(rj, f)) <= 1 / (64 * 31), f
