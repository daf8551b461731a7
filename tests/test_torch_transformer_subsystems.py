"""Parity of the port's transformer subsystems (speculative draft trees,
KV-cache metrics and tier policy, KVQuant and SQuat, the spike scheduler
and energy gate, spike-driven attention, Mamba, spectral positions)
against the JAX package, on the CPU. Mirrors the subsystem cases of
tests/test_transformer_subsystems.py and the draft-tree case of
tests/test_integration_extra.py.

Inputs are numpy from a seed; Mamba weights are JAX-initialised and cross
over as numpy. Exact: masks, verification results, policies, spike trains,
codes and scales, Lanczos (host numpy on both sides). f32 outputs within
1e-4 max / 1e-5 mean of their scale. The SQuat basis comes from an
eigensolver: on calibration data with well separated eigenvalues its
columns are held to JAX's up to sign and each subspace by its projector;
with JAX's basis carried across the codes are equal, and with a signed
permutation basis (an exact projection) codes, scales and zeros too.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ruvector_tpu import transformer as J
from ruvector_tpu.attention import rope as jrope
from ruvector_tpu.graph.csr import CSRGraph as JCSR
from ruvector_tpu.transformer import decode as jdec
from ruvector_tpu.transformer import kv_metrics as jkm
from ruvector_tpu.transformer import kv_quantizers as jkq
from ruvector_tpu.transformer import mamba as jmamba
from ruvector_tpu.transformer import spectral as jspectral
from ruvector_tpu.transformer import speculative as jspec
from ruvector_tpu.transformer import spike as jspike
from ruvector_tpu.transformer import spike_attention as jsa
from ruvector_tpu_torch import transformer as T
from ruvector_tpu_torch.attention import rope as trope
from ruvector_tpu_torch.graph.csr import CSRGraph as TCSR
from ruvector_tpu_torch.transformer import decode as tdec
from ruvector_tpu_torch.transformer import kv_cache as tkv
from ruvector_tpu_torch.transformer import kv_metrics as tkm
from ruvector_tpu_torch.transformer import kv_quantizers as tkq
from ruvector_tpu_torch.transformer import mamba as tmamba
from ruvector_tpu_torch.transformer import spectral as tspectral
from ruvector_tpu_torch.transformer import speculative as tspec
from ruvector_tpu_torch.transformer import spike as tspike
from ruvector_tpu_torch.transformer import spike_attention as tsa

CPU = "cpu"


def close_scaled(got, want, tol=(1e-4, 1e-5)):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape and np.isfinite(got).all()
    scale = max(np.abs(want).max(), 1e-30)
    err = np.abs(got - want) / scale
    assert err.max() <= tol[0] and err.mean() <= tol[1], (err.max(), err.mean())


def t(a):
    return torch.from_numpy(np.array(a))


def tgate(g):
    return None if g is None else T.GatePacket(**dataclasses.asdict(g))


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


# --- speculative draft trees (speculative.rs) ---------------------------------

def make_tree(mod):
    tree = mod.DraftTree()
    r = tree.add(5, 0.9, None)
    a = tree.add(7, 0.8, r)
    tree.add(9, 0.75, r)
    tree.add(11, 0.9, a)
    return tree


def test_tree_attention_mask_ancestors_only():
    mask = tspec.generate_tree_attention_mask(make_tree(tspec))
    np.testing.assert_array_equal(mask, jspec.generate_tree_attention_mask(make_tree(jspec)))
    assert mask[3, 1] and mask[3, 0] and mask[3, 3]
    assert not mask[3, 2] and not mask[1, 2] and not mask[2, 1]


def _verify_both(logits, threshold=0.5, guidance=False, gate=None):
    cj = jspec.SpeculativeConfig(acceptance_threshold=threshold, use_lambda_guidance=guidance)
    rj = jspec.SpeculativeDecoder(cj).verify(make_tree(jspec), logits, gate)
    rt = tspec.SpeculativeDecoder(tspec.SpeculativeConfig(**dataclasses.asdict(cj))).verify(
        make_tree(tspec), logits, tgate(gate))
    assert dataclasses.asdict(rt) == dataclasses.asdict(rj)
    return rt


def test_speculative_verify_accepts_matching_prefix():
    logits = np.full((4, 16), -10.0, np.float32)
    logits[0, 7] = 10.0
    logits[1, 11] = 10.0
    logits[3, 2] = 10.0
    logits[0, 5] = 5.0
    assert _verify_both(logits).num_accepted == 0
    logits[0, 5] = 20.0
    assert _verify_both(logits).accepted_tokens[:1] == [5]
    # lambda-guided threshold: a crisis raises it past the drafts' confidence
    _verify_both(logits, threshold=0.7, guidance=True, gate=J.GatePacket(lam=30, lam_prev=100))


def test_speculative_lambda_guidance_raises_threshold():
    dec = tspec.SpeculativeDecoder(tspec.SpeculativeConfig(acceptance_threshold=0.7))
    calm = dec.effective_threshold(T.GatePacket(lam=100, lam_prev=100))
    crisis = dec.effective_threshold(T.GatePacket(lam=30, lam_prev=100))
    assert crisis > calm
    jdec_ = jspec.SpeculativeDecoder(jspec.SpeculativeConfig(acceptance_threshold=0.7))
    assert crisis == jdec_.effective_threshold(J.GatePacket(lam=30, lam_prev=100))


def test_speculative_decode_against_real_model():
    """Self-drafting with the port's decoder (test_integration_extra.py):
    the draft tree's root chain is the greedy path, so verification accepts
    it, as JAX's does on the same logits."""
    cfg = J.TransformerConfig.micro()
    wj = J.init_weights(jax.random.key(7), cfg)
    wt = T.init_weights(jax.tree_util.tree_map(np.asarray, wj), T.TransformerConfig.micro(),
                        device=CPU)
    dt = tdec.Decoder(T.TransformerConfig.micro(), T.GatePolicy(), wt, device=CPU)
    r = dt.generate(np.asarray([3, 1, 4]), max_new_tokens=3)
    greedy = r.tokens[3:]
    assert r.tokens == jdec.Decoder(cfg, J.GatePolicy(), wj).generate(
        np.asarray([3, 1, 4]), max_new_tokens=3).tokens
    caches = dt.init_caches()
    logits_seq = []
    for pos, tok in enumerate(r.tokens[:-1]):
        logits, caches = dt._step(wt, caches, tok, pos, True)
        logits_seq.append(logits.numpy())
    tree_t, tree_j = tspec.DraftTree(), jspec.DraftTree()
    pt = pj = None
    for tok in greedy:
        pt = tree_t.add(int(tok), 0.95, pt)
        pj = tree_j.add(int(tok), 0.95, pj)
    target = np.stack(logits_seq[2: 2 + len(greedy)])
    cfg_s = dict(acceptance_threshold=0.5, use_lambda_guidance=False)
    rt = tspec.SpeculativeDecoder(tspec.SpeculativeConfig(**cfg_s)).verify(tree_t, target)
    rj = jspec.SpeculativeDecoder(jspec.SpeculativeConfig(**cfg_s)).verify(tree_j, target)
    assert rt.num_accepted >= 1 and rt.accepted_tokens[0] == greedy[0]
    assert dataclasses.asdict(rt) == dataclasses.asdict(rj)


# --- KV-cache metrics and the adaptive tier policy ----------------------------

def test_kv_memory_stats_match():
    kw = dict(hot_tokens=16, warm_tokens=48, archive_tokens=64, head_dim=64, heads=4)
    st, sj = tkm.MemoryStats(**kw), jkm.MemoryStats(**kw)
    assert st.tier_percentages() == sj.tier_percentages()
    assert st.bytes_used() == sj.bytes_used()
    assert st.memory_saved_vs_f32() == sj.memory_saved_vs_f32() > 0.4
    np.testing.assert_allclose(sum(st.tier_percentages()), 1.0)


QUALITY_RUNS = {
    "bad_ppl": ([("ppl", 12.0, 10.0)] * 8, 0.95),
    "comfortable": ([("acc", 0.99)] * 8, 0.9),
    "improving": ([("q", v) for v in (0.5, 0.5, 0.6, 0.9, 0.95, 0.99)], 0.95),
    "noisy": ([("q", v) for v in (0.97, 0.9, 0.99, 0.93, 0.96)], 0.95),
    "short": ([("acc", 1.5), ("ppl", 0.0, 1.0)], 0.95),
}


def _feedback(mod, item):
    kind, *vals = item
    if kind == "ppl":
        return mod.QualityFeedback.from_ppl(*vals)
    if kind == "acc":
        return mod.QualityFeedback.from_accuracy(*vals)
    return mod.QualityFeedback(*vals)


@pytest.mark.parametrize("run", sorted(QUALITY_RUNS))
def test_quality_tracker_and_policy_match(run):
    items, target = QUALITY_RUNS[run]
    tj, tt = jkm.QualityTracker(quality_target=target), tkm.QualityTracker(quality_target=target)
    for item in items:
        tj.record(_feedback(jkm, item))
        tt.record(_feedback(tkm, item))
    assert (tt.current, tt.mean(), tt.meets_target(), tt.is_stable(), tt.is_improving()) == (
        tj.current, tj.mean(), tj.meets_target(), tj.is_stable(), tj.is_improving())
    for hot in (8, 16, 128):
        cj = J.KVCacheConfig(hot_capacity=hot)
        ct = tkv.KVCacheConfig(hot_capacity=hot)
        assert dataclasses.asdict(tkm.TierPolicy().adapt(ct, tt)) == \
            dataclasses.asdict(jkm.TierPolicy().adapt(cj, tj))


def test_tier_policy_widens_and_shrinks():
    bad = tkm.QualityTracker(quality_target=0.95)
    for _ in range(8):
        bad.record(tkm.QualityFeedback.from_ppl(12.0, baseline_ppl=10.0))
    cfg = tkv.KVCacheConfig(hot_capacity=16)
    assert tkm.TierPolicy().adapt(cfg, bad).hot_capacity > 16
    good = tkm.QualityTracker(quality_target=0.9)
    for _ in range(8):
        good.record(tkm.QualityFeedback.from_accuracy(0.99))
    assert tkm.TierPolicy().adapt(cfg, good).hot_capacity < 16


# --- KVQuant and SQuat ----------------------------------------------------------

@pytest.mark.parametrize("bits", [2, 3, 4, 8])
def test_kvquant_keys_bit_equal(bits):
    keys = np.random.default_rng(bits).normal(size=(64, 32)).astype(np.float32)
    kj = jkq.kvquant_quantize_keys(jnp.asarray(keys), bits=bits)
    kt = tkq.kvquant_quantize_keys(t(keys), bits=bits)
    np.testing.assert_array_equal(kt.q.numpy(), np.asarray(kj.q))
    np.testing.assert_array_equal(kt.scale.numpy(), np.asarray(kj.scale))
    np.testing.assert_array_equal(tkq.kvquant_dequantize_keys(kt).numpy(),
                                  np.asarray(jkq.kvquant_dequantize_keys(kj)))


def test_kvquant_attention_scores_match():
    rng = np.random.default_rng(9)
    keys = rng.normal(size=(40, 32)).astype(np.float32)
    query = rng.normal(size=(32,)).astype(np.float32)
    pos = np.arange(40)
    cj, sj = jrope.rope_tables(32, 128)
    ct, st = trope.rope_tables(32, 128, device=CPU)
    kj = jkq.kvquant_quantize_keys(jnp.asarray(keys))
    kt = tkq.kvquant_quantize_keys(t(keys))
    close_scaled(tkq.kvquant_attention_scores(t(query), kt, ct, st, t(pos)).numpy(),
                 jkq.kvquant_attention_scores(jnp.asarray(query), kj, cj, sj, jnp.asarray(pos)))


def test_kvquant_pre_rope_beats_post_rope():
    rng = np.random.default_rng(0)
    scale = np.ones(32)
    scale[0:8:2] = 8.0
    keys = t((rng.normal(size=(64, 32)) * scale).astype(np.float32))
    cos_t, sin_t = trope.rope_tables(32, 128, device=CPU)
    positions = torch.arange(64)
    keys_rot = trope.rope_rotate(keys, positions, cos_t, sin_t)
    pre = tkq.kvquant_quantize_keys(keys, bits=3, pre_rope=True)
    rec_pre = trope.rope_rotate(tkq.kvquant_dequantize_keys(pre), positions, cos_t, sin_t)
    rec_post = tkq.kvquant_dequantize_keys(tkq.kvquant_quantize_keys(keys_rot, bits=3,
                                                                     pre_rope=False))
    err_pre = float(torch.mean((rec_pre - keys_rot) ** 2))
    assert err_pre < float(torch.mean((rec_post - keys_rot) ** 2))


@pytest.mark.parametrize("shape", [(16, 32), (48, 64)])
def test_kvquant_nonuniform_values_bit_equal(shape):
    v = np.random.default_rng(1).normal(size=shape).astype(np.float32)
    v[3, 7] = 50.0                        # massive outlier
    nj = jkq.kvquant_quantize_values(jnp.asarray(v), bits=4)
    nt = tkq.kvquant_quantize_values(t(v), bits=4)
    for f in ("q", "scale", "outlier_mask", "outlier_vals"):
        np.testing.assert_array_equal(getattr(nt, f).numpy(), np.asarray(getattr(nj, f)), f)
    dec = tkq.kvquant_dequantize_values(nt).numpy()
    np.testing.assert_array_equal(dec, np.asarray(jkq.kvquant_dequantize_values(nj)))
    assert dec[3, 7] == 50.0 and np.mean((dec - v) ** 2) < 0.05


def _correlated_kv(seed=2, t_=256, d=32):
    rng = np.random.default_rng(seed)
    latent = rng.normal(size=(t_, 4))
    mix = rng.normal(size=(4, d)) * 3.0
    return (latent @ mix + 0.1 * rng.normal(size=(t_, d))).astype(np.float32)


def _spread_kv(seed=3, t_=512, d=32):
    """Calibration data whose covariance has well separated eigenvalues
    (standard deviations 1 to 30 along a random orthogonal basis), so that
    each eigenvector is determined up to sign in float32."""
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.normal(size=(d, d)))
    z = rng.normal(size=(t_, d)) * np.geomspace(1.0, 30.0, d)
    return (z @ q.T).astype(np.float32)


@pytest.mark.parametrize("subspaces", [4, 8])
def test_squat_basis_matches_up_to_sign_and_codes_bit_equal(subspaces):
    kv = _spread_kv()
    bj = jkq.squat_learn_basis(jnp.asarray(kv), num_subspaces=subspaces, bits=4)
    bt = tkq.squat_learn_basis(t(kv), num_subspaces=subspaces, bits=4)
    vj, vt = np.asarray(bj.basis, np.float64), bt.basis.numpy().astype(np.float64)
    d = kv.shape[1]
    for c in range(d):                          # column by column, up to sign
        sign = np.sign(vt[:, c] @ vj[:, c])
        np.testing.assert_allclose(sign * vt[:, c], vj[:, c], atol=1e-3, err_msg=str(c))
    size = d // subspaces
    for s in range(subspaces):                  # each subspace's projector
        cols = slice(s * size, (s + 1) * size)
        np.testing.assert_allclose(vt[:, cols] @ vt[:, cols].T, vj[:, cols] @ vj[:, cols].T,
                                   atol=1e-3)
    # JAX's basis carried across. The projection kv @ basis is a float32
    # product that XLA and torch sum in other orders, so the subspace
    # ranges (scales, zeros) may differ in the last bit; the codes of these
    # inputs are equal all the same
    carried = tkq.SQuatBasis(basis=t(np.asarray(bj.basis)), num_subspaces=subspaces, bits=4)
    for data in (kv, _correlated_kv()):
        cj, ct = jkq.squat_quantize(jnp.asarray(data), bj), tkq.squat_quantize(t(data), carried)
        np.testing.assert_array_equal(ct.codes.numpy(), np.asarray(cj.codes))
        close_scaled(ct.scales.numpy(), cj.scales, (1e-6, 1e-6))
        close_scaled(ct.zeros.numpy(), cj.zeros, (1e-6, 1e-6))
        close_scaled(tkq.squat_dequantize(ct, carried).numpy(), jkq.squat_dequantize(cj, bj))
    # a signed permutation basis makes the projection exact on both sides:
    # then codes, scales, zeros and the reconstruction are equal bit for bit
    rng = np.random.default_rng(subspaces)
    perm = np.eye(d, dtype=np.float32)[rng.permutation(d)] * rng.choice([-1.0, 1.0], d)
    pj = jkq.SQuatBasis(basis=jnp.asarray(perm.astype(np.float32)), num_subspaces=subspaces,
                        bits=4)
    pt = tkq.SQuatBasis(basis=t(perm.astype(np.float32)), num_subspaces=subspaces, bits=4)
    cj, ct = jkq.squat_quantize(jnp.asarray(kv), pj), tkq.squat_quantize(t(kv), pt)
    for f in ("codes", "scales", "zeros"):
        np.testing.assert_array_equal(getattr(ct, f).numpy(), np.asarray(getattr(cj, f)), f)
    np.testing.assert_array_equal(tkq.squat_dequantize(ct, pt).numpy(),
                                  np.asarray(jkq.squat_dequantize(cj, pj)))
    assert tkq.squat_compression_ratio(carried, d) == jkq.squat_compression_ratio(bj, d)


def test_squat_decorrelation_beats_direct_quant():
    kv = t(_correlated_kv())
    basis = tkq.squat_learn_basis(kv, num_subspaces=8, bits=4)
    err_squat = float(torch.mean((tkq.squat_dequantize(tkq.squat_quantize(kv, basis), basis)
                                  - kv) ** 2))
    ident = tkq.SQuatBasis(basis=torch.eye(32), num_subspaces=8, bits=4)
    err_direct = float(torch.mean((tkq.squat_dequantize(tkq.squat_quantize(kv, ident), ident)
                                   - kv) ** 2))
    assert err_squat < err_direct
    prod = tkq.SQuatBasis(basis=torch.eye(128), num_subspaces=4, bits=3)
    assert tkq.squat_compression_ratio(prod, 128) > 3.0


# --- spike scheduler and energy gate ------------------------------------------

def test_spike_scheduler_matches_jax():
    rng = np.random.default_rng(4)
    inputs = [np.ones(8), np.ones(8), np.ones(8) * 5.0, np.ones(8) * 5.02,
              rng.normal(size=8), rng.normal(size=8) * 0.01]
    sj, st = jspike.SpikeScheduler(novelty_threshold=0.1), tspike.SpikeScheduler(0.1)
    packets = []
    for x in inputs:
        pj, pt = sj.observe(x), st.observe(x)
        assert dataclasses.asdict(pt) == dataclasses.asdict(pj)
        packets.append(pt)
    assert packets[0].is_active() and not packets[1].is_active() and packets[2].is_active()
    assert packets[2].novelty_q15 > packets[1].novelty_q15


ENERGY_GATES = [J.GatePacket(lam=200, lam_prev=200),
                J.GatePacket(lam=5, lam_prev=200, boundary_concentration_q15=30000,
                             partition_count=20),
                J.GatePacket(lam=60, lam_prev=100, partition_count=4),
                J.GatePacket(lam=90, boundary_concentration_q15=16000)]


@pytest.mark.parametrize("i", range(len(ENERGY_GATES)))
def test_energy_gate_matches_jax(i):
    g = ENERGY_GATES[i]
    gj, gt = jspike.EnergyGate(), tspike.EnergyGate()
    assert gt.energy(tgate(g)) == gj.energy(g)
    (dt_, ct), (dj, cj) = gt.decide(tgate(g)), gj.decide(g)
    assert dt_.value == dj.value and ct == cj
    if i == 0:
        assert dt_.value == "allow" and ct >= 0.7
    if i == 1:
        assert dt_.value == "freeze_writes" and ct >= 0.7


# --- spike-driven attention ------------------------------------------------------

SPIKE_CFGS = {
    "default": jsa.SpikeDrivenConfig(),
    "fine_no_refractory": jsa.SpikeDrivenConfig(temporal_coding_steps=16, spike_threshold=0.25,
                                                refractory_period=0),
    "odd_steps": jsa.SpikeDrivenConfig(temporal_coding_steps=5, spike_threshold=0.3,
                                       refractory_period=1),
}


@pytest.mark.parametrize("name", sorted(SPIKE_CFGS))
def test_spike_trains_and_attention_match_jax(name):
    cj = SPIKE_CFGS[name]
    ct = tsa.SpikeDrivenConfig(**dataclasses.asdict(cj))
    x = np.random.default_rng(0).normal(size=(6, 8)).astype(np.float32)
    sj, st = jsa.encode_rate(jnp.asarray(x), cj), tsa.encode_rate(t(x), ct)
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    np.testing.assert_array_equal(tsa.decode_rate(st, ct).numpy(),
                                  np.asarray(jsa.decode_rate(sj, cj)))
    out_t = tsa.spike_driven_attention(t(x), t(x[::-1].copy()), t(x), ct)
    out_j = jsa.spike_driven_attention(jnp.asarray(x), jnp.asarray(x[::-1].copy()),
                                       jnp.asarray(x), cj)
    np.testing.assert_array_equal(out_t.numpy(), np.asarray(out_j))
    assert tsa.energy_estimate(ct, 64, 128) == jsa.energy_estimate(cj, 64, 128)


def test_spike_rate_coding_roundtrip_and_refractory():
    cfg = tsa.SpikeDrivenConfig(temporal_coding_steps=16, spike_threshold=0.25,
                                refractory_period=0)
    x = torch.tensor([[1.0, -0.5, 0.0, 2.0]])
    spikes = tsa.encode_rate(x, cfg)
    assert spikes.shape == (16, 1, 4)
    dec = tsa.decode_rate(spikes, cfg).numpy()
    np.testing.assert_allclose(dec, x.numpy(), atol=0.3)
    assert dec[0, 2] == 0.0 and dec[0, 1] < 0
    big = torch.tensor([[10.0]])
    none = tsa.encode_rate(big, tsa.SpikeDrivenConfig(temporal_coding_steps=8,
                                                      refractory_period=0))
    refr = tsa.encode_rate(big, tsa.SpikeDrivenConfig(temporal_coding_steps=8,
                                                      refractory_period=2))
    assert int(refr.abs().sum()) < int(none.abs().sum())
    assert tsa.energy_estimate(tsa.SpikeDrivenConfig(), 64, 128)["energy_ratio"] > 1.0


# --- Mamba -----------------------------------------------------------------------

@pytest.fixture(scope="module", params=["micro", "baseline"])
def mamba(request):
    cj = getattr(jmamba.MambaConfig, request.param)()
    wj = jmamba.mamba_init(jax.random.key(0), cj)
    ct = getattr(tmamba.MambaConfig, request.param)()
    return cj, wj, ct, tmamba.mamba_init(jax.tree_util.tree_map(np.asarray, wj), ct, device=CPU)


def test_mamba_sequence_and_steps_match_jax(mamba):
    cj, wj, ct, wt = mamba
    x = np.random.default_rng(2).normal(size=(12, cj.d_model)).astype(np.float32)
    seq_j = jmamba.mamba_forward_sequence(cj, wj, jnp.asarray(x))
    seq_t = tmamba.mamba_forward_sequence(ct, wt, t(x))
    close_scaled(seq_t.numpy(), seq_j)
    state = tmamba.mamba_state_init(ct, CPU)
    for i in range(12):
        y, state = tmamba.mamba_step(ct, wt, t(x[i]), state)
        np.testing.assert_allclose(y.numpy(), seq_t[i].numpy(), atol=1e-5)
    js = jmamba.mamba_state_init(cj)
    for i in range(12):
        _, js = jmamba.mamba_step(cj, wj, jnp.asarray(x[i]), js)
    close_scaled(state.ssm_state.numpy(), js.ssm_state)
    close_scaled(state.conv_state.numpy(), js.conv_state)


def test_mamba_state_carries_history():
    cfg = tmamba.MambaConfig.micro()
    weights = tmamba.mamba_init(torch.Generator().manual_seed(1), cfg, device=CPU)
    x = torch.ones(cfg.d_model)
    y1, s1 = tmamba.mamba_step(cfg, weights, x, tmamba.mamba_state_init(cfg, CPU))
    y2, _ = tmamba.mamba_step(cfg, weights, x, s1)
    assert not torch.allclose(y1, y2)
    assert weights["a_log"].shape == (cfg.d_inner, cfg.d_state)


# --- spectral positions --------------------------------------------------------------

EDGES = [(0, 1), (1, 2), (0, 2), (3, 4), (4, 5), (3, 5), (2, 3)]


@pytest.mark.parametrize("normalized", [False, True])
def test_laplacian_matches_jax(normalized):
    lt = tspectral.laplacian_from_edges(EDGES + [(9, 1), (2, 2)], 6, normalized)
    np.testing.assert_array_equal(lt, jspectral.laplacian_from_edges(EDGES + [(9, 1), (2, 2)],
                                                                     6, normalized))
    if not normalized:
        np.testing.assert_allclose(lt.sum(axis=1), 0.0, atol=1e-6)


def test_power_iteration_dense_and_sparse_match_jax():
    m = np.diag([1.0, 5.0, 2.0]).astype(np.float32)
    v = tspectral.power_iteration(t(m), 64).numpy()
    np.testing.assert_allclose(np.abs(v), [0.0, 1.0, 0.0], atol=1e-3)
    close_scaled(v, jspectral.power_iteration(jnp.asarray(m), 64))
    rng = np.random.default_rng(6)
    src, dst = rng.integers(0, 30, 120), rng.integers(0, 30, 120)
    w = rng.random(120).astype(np.float32)
    sym = np.random.default_rng(7).normal(size=(30, 30)).astype(np.float32)
    close_scaled(tspectral.power_iteration(t(sym @ sym.T), 32).numpy(),
                 jspectral.power_iteration(jnp.asarray(sym @ sym.T), 32))
    vt = tspectral.power_iteration_sparse(TCSR.from_edges(src, dst, w, 30, device=CPU), 16)
    vj = jspectral.power_iteration_sparse(JCSR.from_edges(src, dst, w, 30), 16)
    close_scaled(vt.numpy(), vj)


def test_lanczos_matches_jax_and_numpy():
    rng = np.random.default_rng(3)
    a = rng.normal(size=(12, 12))
    sym = ((a + a.T) / 2).astype(np.float32)
    et, vt = tspectral.lanczos(t(sym), k=3, max_iters=12)
    ej, vj = jspectral.lanczos(jnp.asarray(sym), k=3, max_iters=12)
    np.testing.assert_array_equal(et, ej)
    np.testing.assert_array_equal(vt, vj)
    np.testing.assert_allclose(et, np.linalg.eigvalsh(sym.astype(np.float64))[:3], atol=1e-3)
    for i in range(3):
        np.testing.assert_allclose(sym @ vt[:, i], et[i] * vt[:, i], atol=1e-2)


def test_spectral_pe_matches_jax_and_separates_components():
    cfg = dict(num_eigenvectors=2)
    enc_t = tspectral.SpectralPositionEncoder(tspectral.SpectralPEConfig(**cfg))
    enc_j = jspectral.SpectralPositionEncoder(jspectral.SpectralPEConfig(**cfg))
    pe = enc_t.encode_from_edges(EDGES, 6)
    np.testing.assert_array_equal(pe, enc_j.encode_from_edges(EDGES, 6))
    assert pe.shape == (6, 2)
    assert enc_t.spectral_distance(pe, 0, 5) > enc_t.spectral_distance(pe, 0, 1)
    emb = np.random.default_rng(8).normal(size=(6, 5)).astype(np.float32)
    np.testing.assert_array_equal(enc_t.add_to_embeddings(t(emb), pe, 0.5).numpy(),
                                  np.asarray(enc_j.add_to_embeddings(jnp.asarray(emb), pe, 0.5)))
    assert enc_t.encode_from_edges([], 0).shape == (0, 2)
