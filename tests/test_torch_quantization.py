"""Parity of the port's vector quantization, tiered compression, Q15 and
temporal stores against the JAX package, on the CPU (the anchors of
tests/test_solver_quant.py, tests/test_properties.py,
tests/test_training_extra.py and tests/test_serve_rerank.py).

Inputs are made with numpy from a seed. Integer outputs (codes, packed
words compared as numpy uint32, Hamming distances, Q15 values) and PQ
codebooks are equal bit for bit; float outputs agree within the mirrored
tests' tolerances, or 2e-5 of their scale where those compare to exact
values.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ruvector_tpu.ops import compress as jcomp
from ruvector_tpu.ops import q15 as jq15
from ruvector_tpu.ops import quantization as jq
from ruvector_tpu.ops import temporal_tensor as jtt
from ruvector_tpu.ops import temporal_tiers as jtiers
from ruvector_tpu_torch.ops import compress as tcomp
from ruvector_tpu_torch.ops import q15 as tq15
from ruvector_tpu_torch.ops import quantization as tq
from ruvector_tpu_torch.ops import temporal_tensor as ttt
from ruvector_tpu_torch.ops import temporal_tiers as ttiers
from ruvector_tpu_torch.ops.quantization import uint32_words

F32_TOL = 2e-5


def rand(*shape, seed=0, scale=1.0):
    return (scale * np.random.default_rng(seed).normal(size=shape)).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want, tol=F32_TOL):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape and np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want, atol=tol * max(1.0, float(np.abs(want).max())), rtol=0)


def _equal(got, want):
    got, want = _np(got), _np(want)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want)


@pytest.fixture
def small_chunks(monkeypatch):
    """Row chunks of a few rows, so the chunked loops take many passes."""
    monkeypatch.setattr(tq, "_CHUNK_BYTES", 4096)


# --- scalar int8 and int4 -----------------------------------------------------------

@pytest.mark.parametrize("seed", range(5))
def test_scalar_and_int4_codes_match_jax(seed):
    """tests/test_properties.py's sweep: random shapes and scales; codes,
    scales and offsets bit-equal, the error bounds on the port."""
    rng = np.random.default_rng(300 + seed)
    x = (rng.normal(scale=rng.random() * 10 + 0.1, size=(int(rng.integers(2, 30)),
                                                         int(rng.integers(4, 100))))
         .astype(np.float32))
    q, jqz = tq.scalar_quantize(_t(x)), jq.scalar_quantize(jnp.asarray(x))
    for f in ("codes", "scale", "offset"):
        _equal(getattr(q, f), getattr(jqz, f))
    dec = tq.scalar_dequantize(q)
    _close(dec, jq.scalar_dequantize(jqz))
    rangex = float(np.ptp(x, axis=1).max())
    assert float((dec - _t(x)).abs().max()) <= rangex / 255.0 + 1e-5
    q4, jq4 = tq.int4_quantize(_t(x)), jq.int4_quantize(jnp.asarray(x))
    for f in ("packed", "scale", "offset"):
        _equal(getattr(q4, f), getattr(jq4, f))
    dec4 = tq.int4_dequantize(q4)
    assert dec4.shape == x.shape
    _close(dec4, jq.int4_dequantize(jq4))
    assert float((dec4 - _t(x)).abs().max()) <= rangex / 15.0 + 1e-5


def test_scalar_quantization_roundtrip():
    x = rand(10, 64, seed=4)
    dec = tq.scalar_dequantize(tq.scalar_quantize(_t(x))).numpy()
    assert np.abs(dec - x).max() < np.ptp(x) / 255.0 * 1.5


def test_int4_roundtrip_odd_dim():
    x = rand(8, 33, seed=6)
    q = tq.int4_quantize(_t(x))
    assert q.packed.shape == (8, 17) and q.packed.dtype == torch.uint8
    dec = tq.int4_dequantize(q).numpy()
    assert dec.shape == (8, 33) and np.abs(dec - x).max() < np.ptp(x) / 15.0 * 1.5


@pytest.mark.parametrize("chunked", [False, True])
def test_scalar_distance_matches_jax(chunked, request):
    if chunked:
        request.getfixturevalue("small_chunks")
    rng = np.random.default_rng(5)
    db = rng.normal(size=(20, 32)).astype(np.float32)
    queries = rng.normal(size=(4, 32)).astype(np.float32)
    q = tq.scalar_quantize(_t(db))
    dist = tq.scalar_distance(_t(queries), q).numpy()
    np.testing.assert_allclose(
        dist, np.asarray(jq.scalar_distance(jnp.asarray(queries), jq.scalar_quantize(
            jnp.asarray(db)))), rtol=1e-3, atol=1e-3)
    dec = tq.scalar_dequantize(q).numpy()
    np.testing.assert_allclose(dist, ((queries[:, None] - dec[None]) ** 2).sum(-1),
                               rtol=1e-3, atol=1e-3)


# --- product quantization -------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 5, 8, 13, 16, 24, 33, 64, 130, 200, 300])
def test_squared_distances_follow_numpy_order(n):
    """numpy's pairwise summation, bit for bit, at every length regime
    (under 8, the 8-way unroll, the halving above 128)."""
    a = rand(40, 1, n, seed=n)
    b = rand(1, 30, n, seed=n + 1)
    _equal(tq.squared_distances(_t(a), _t(b)), ((a - b) ** 2).sum(-1))


@pytest.mark.parametrize("shape,sub,cent,iters", [
    ((200, 32), 4, 16, 5), ((300, 24), 8, 32, 3), ((50, 16), 2, 64, 4), ((120, 64), 4, 8, 10)])
def test_pq_train_codebooks_bit_equal(shape, sub, cent, iters):
    """The port's k-means (assignment by squared_distances, means in numpy)
    gives the JAX package's codebooks bit for bit; k is capped at n."""
    x = rand(*shape, seed=7)
    cb = tq.pq_train(x, subvectors=sub, centroids=cent, iters=iters, seed=3, device="cpu")
    jcb = jq.pq_train(x, subvectors=sub, centroids=cent, iters=iters, seed=3)
    _equal(cb.codebooks, jcb.codebooks)
    assert (cb.dim, cb.subvectors, cb.sub_dim) == (jcb.dim, jcb.subvectors, jcb.sub_dim)


@pytest.mark.parametrize("chunked", [False, True])
def test_pq_roundtrip_and_distance_match_jax(chunked, request):
    if chunked:
        request.getfixturevalue("small_chunks")
    x = rand(200, 32, seed=7)
    cb = tq.pq_train(_t(x), subvectors=4, centroids=16, iters=5, device="cpu")
    jcb = jq.pq_train(x, subvectors=4, centroids=16, iters=5)
    codes = tq.pq_encode(cb, _t(x))
    jcodes = jq.pq_encode(jcb, jnp.asarray(x))
    assert codes.shape == (200, 4)
    _equal(codes, jcodes)
    dec = tq.pq_decode(cb, codes)
    _equal(dec, jq.pq_decode(jcb, jcodes))
    assert ((dec.numpy() - x) ** 2).mean() < x.var()
    dist = tq.pq_distance(cb, _t(x[:3]), codes).numpy()
    jdist = np.asarray(jq.pq_distance(jcb, jnp.asarray(x[:3]), jcodes))
    np.testing.assert_allclose(dist, jdist, rtol=1e-5, atol=1e-5)
    expect = ((x[:3][:, None] - dec.numpy()[None]) ** 2).sum(-1)
    np.testing.assert_allclose(dist, expect, rtol=1e-3, atol=1e-2)
    assert dist[0].argmin() in np.argsort(expect[0])[:5]


# --- binary ---------------------------------------------------------------------------------

@pytest.mark.parametrize("d,threshold", [(64, 0.0), (33, 0.0), (100, 0.3), (32, -0.5)])
@pytest.mark.parametrize("chunked", [False, True])
def test_binary_words_and_hamming_match_jax(d, threshold, chunked, request):
    if chunked:
        request.getfixturevalue("small_chunks")
    x = rand(37, d, seed=d)
    y = rand(23, d, seed=d + 1)
    bx, by = tq.binary_quantize(_t(x), threshold), tq.binary_quantize(_t(y), threshold)
    jbx = jq.binary_quantize(jnp.asarray(x), threshold)
    jby = jq.binary_quantize(jnp.asarray(y), threshold)
    assert bx.bits.dtype == torch.int32
    np.testing.assert_array_equal(uint32_words(bx.bits), np.asarray(jbx.bits))
    np.testing.assert_array_equal(uint32_words(by.bits), np.asarray(jby.bits))
    _equal(tq.hamming_distance(bx, by), jq.hamming_distance(jbx, jby))
    _close(tq.binary_similarity(bx, by), jq.binary_similarity(jbx, jby))


def test_binary_hamming_cases():
    x = np.asarray([[1.0, -1.0, 1.0, -1.0] * 16, [1.0, -1.0, 1.0, -1.0] * 16,
                    [-1.0, 1.0, -1.0, 1.0] * 16], np.float32)
    b = tq.binary_quantize(_t(x))
    h = tq.hamming_distance(b, b).numpy()
    assert h[0, 1] == 0 and h[0, 2] == 64
    sim = tq.binary_similarity(b, b).numpy()
    np.testing.assert_allclose(sim[0, 0], 1.0)
    np.testing.assert_allclose(sim[0, 2], 0.0)


def test_popcount_on_every_bit_pattern_class():
    """Words with the top bit set (negative as int32) and the extremes."""
    vals = np.asarray([0, 1, 0x80000000, 0xFFFFFFFF, 0x7FFFFFFF, 0xAAAAAAAA, 0x12345678,
                       0xF0F0F0F0], np.uint32)
    got = tq.popcount32(tq.u64_from_words(_t(vals.view(np.int32)))).numpy()
    np.testing.assert_array_equal(got, [bin(int(v)).count("1") for v in vals])


# --- tiered compression -------------------------------------------------------------------

def test_tier_policy():
    for f, lvl in ((0.9, "none"), (0.6, "half"), (0.3, "pq8"), (0.05, "pq4"), (0.001, "binary")):
        assert tcomp.level_for_access_frequency(f) == lvl == jcomp.level_for_access_frequency(f)


@pytest.mark.parametrize("level", ["none", "half", "pq8", "pq4", "binary"])
def test_compress_levels_match_jax(level):
    x = rand(64, 32, seed=8)
    tc = tcomp.TensorCompress(pq_subvectors=4, pq_centroids=16)
    jtc = jcomp.TensorCompress(pq_subvectors=4, pq_centroids=16)
    t = tc.compress_level(_t(x), level)
    jt = jtc.compress_level(jnp.asarray(x), level)
    assert (t.level, t.dim, t.bytes_per_vector) == (jt.level, jt.dim, jt.bytes_per_vector)
    if level == "half":
        _equal(t.payload.view(torch.int16), np.asarray(jt.payload).view(np.int16))
    elif level == "pq8":
        _equal(t.payload["codebook"].codebooks, jt.payload["codebook"].codebooks)
        _equal(t.payload["codes"], jt.payload["codes"])
    elif level == "pq4":
        _equal(t.payload["int4"].packed, jt.payload["int4"].packed)
        _equal(t.payload["outlier_idx"], jt.payload["outlier_idx"])
        _equal(t.payload["outlier_val"], jt.payload["outlier_val"])
    elif level == "binary":
        np.testing.assert_array_equal(uint32_words(t.payload.bits), np.asarray(jt.payload.bits))
    _close(tc.decompress(t), jtc.decompress(jt))


def test_compress_roundtrip_all_levels():
    x = rand(64, 32, seed=8)
    tc = tcomp.TensorCompress(pq_subvectors=4, pq_centroids=16, device="cpu")
    prev_bytes = 1e18
    for level, tol in [("none", 0), ("half", 0.05), ("pq8", 3.0), ("pq4", 1.5),
                       ("binary", None)]:
        t = tc.compress_level(_t(x), level)
        dec = tc.decompress(t).numpy()
        assert dec.shape == x.shape
        if level == "none":
            np.testing.assert_array_equal(dec, x)
        elif tol is not None:
            assert np.abs(dec - x).max() < tol, level
        else:
            assert (np.sign(dec) == np.sign(np.where(x > 0, 1.0, -1.0))).mean() > 0.99
        assert t.bytes_per_vector <= prev_bytes or level == "pq4"
        prev_bytes = t.bytes_per_vector
    assert tc.compress(x, 0.001).bytes_per_vector * 32 == 32 * 4
    assert tc.compress(x, 0.9).payload.device.type == "cpu"


# --- Q15 ---------------------------------------------------------------------------------------

def _q15_inputs(seed, shape=(6, 40)):
    rng = np.random.default_rng(seed)
    return (rng.integers(-32768, 32768, size=shape).astype(np.int16),
            rng.integers(-32768, 32768, size=shape).astype(np.int16))


@pytest.mark.parametrize("seed", range(3))
def test_q15_ops_match_jax(seed):
    a, b = _q15_inputs(seed)
    x = rand(50, seed=seed, scale=0.7)
    x[:3] = [2.0, -1.5, 0.99999]
    _equal(tq15.f32_to_q15(_t(x)), jq15.f32_to_q15(jnp.asarray(x)))
    _equal(tq15.q15_to_f32(_t(a)), jq15.q15_to_f32(jnp.asarray(a)))
    for name in ("q15_add", "q15_mul", "q15_dot"):
        _equal(getattr(tq15, name)(_t(a), _t(b)), getattr(jq15, name)(jnp.asarray(a), jnp.asarray(b)))
    t = a[::-1].copy()
    _equal(tq15.q15_lerp(_t(a), _t(b), _t(t)),
           jq15.q15_lerp(jnp.asarray(a), jnp.asarray(b), jnp.asarray(t)))
    _equal(tq15.q15_matmul(_t(a), _t(b.T.copy())), jq15.q15_matmul(jnp.asarray(a), jnp.asarray(b.T)))


def test_q15_extreme_values_wrap_as_jax():
    """int32 accumulation wraps: (-32768)^2 * 2 = 2^31 already leaves the
    int32 range, and the rounding add can too; the port's exact sums
    wrapped to int32 give JAX's values bit for bit."""
    lo, hi = np.int16(-32768), np.int16(32767)
    cases = [np.full((3, 2), lo), np.full((3, 4), lo), np.full((2, 3), hi),
             np.asarray([[lo, hi, lo, lo], [hi, hi, hi, hi]], np.int16)]
    for a in cases:
        a = a.astype(np.int16)
        b = a.T.copy()
        _equal(tq15.q15_matmul(_t(a), _t(b)), jq15.q15_matmul(jnp.asarray(a), jnp.asarray(b)))
        _equal(tq15.q15_dot(_t(a), _t(a)), jq15.q15_dot(jnp.asarray(a), jnp.asarray(a)))
        _equal(tq15.q15_mul(_t(a), _t(a)), jq15.q15_mul(jnp.asarray(a), jnp.asarray(a)))
        _equal(tq15.q15_lerp(_t(a), _t(-a), _t(a)),
               jq15.q15_lerp(jnp.asarray(a), jnp.asarray(-a), jnp.asarray(a)))
    # a sum that wraps to just below 2^31 - 2^14: the rounding add wraps too
    a = np.asarray([[lo, lo, hi, 16384]], np.int16)
    b = np.asarray([[lo], [lo], [-1], [-1]], np.int16)
    _equal(tq15.q15_matmul(_t(a), _t(b)), jq15.q15_matmul(jnp.asarray(a), jnp.asarray(b)))


def test_q15_matmul_sums_in_exact_passes(monkeypatch):
    """K beyond one float64 pass: the passes' exact integer sums add up."""
    a, b = _q15_inputs(9, (5, 64))
    monkeypatch.setattr(tq15, "_EXACT_TERMS", 7)
    _equal(tq15.q15_matmul(_t(a), _t(b.T.copy())),
           jq15.q15_matmul(jnp.asarray(a), jnp.asarray(b.T)))


def test_q15_reference_cases():
    """tests/test_training_extra.py's cases on the port."""
    x = torch.tensor([0.0, 0.5, -0.5, 0.999, -1.0])
    np.testing.assert_allclose(tq15.q15_to_f32(tq15.f32_to_q15(x)).numpy(), x.numpy(), atol=1e-4)
    assert int(tq15.f32_to_q15(torch.tensor(2.0))) == tq15.Q15_MAX
    big = tq15.f32_to_q15(torch.tensor([0.9]))
    assert int(tq15.q15_add(big, big)[0]) == tq15.Q15_MAX
    a = tq15.f32_to_q15(torch.tensor([0.5, 0.25]))
    b = tq15.f32_to_q15(torch.tensor([0.5, 0.5]))
    np.testing.assert_allclose(tq15.q15_to_f32(tq15.q15_mul(a, b)).numpy(), [0.25, 0.125], atol=1e-3)
    np.testing.assert_allclose(float(tq15.q15_to_f32(tq15.q15_dot(a, b))), 0.375, atol=1e-3)
    out = tq15.q15_to_f32(tq15.q15_matmul(tq15.f32_to_q15(torch.tensor([[0.5, 0.0], [0.0, 0.5]])),
                                          tq15.f32_to_q15(torch.tensor([[0.5, 0.0], [0.0, -0.5]]))))
    np.testing.assert_allclose(out.numpy(), [[0.25, 0], [0, -0.25]], atol=1e-3)


# --- temporal stores ---------------------------------------------------------------------------

@pytest.mark.parametrize("bits", [2, 3, 4, 5, 6, 7, 8, 16])
@pytest.mark.parametrize("n", [1, 64, 300])
def test_bitpack_matches_jax(bits, n):
    """Words bit-equal to JAX's shifted fields (widths dividing 32) and its
    bit-buffer loop (the others); the round trip too."""
    x = rand(n, seed=bits * 1000 + n, scale=3.0)
    packed, scales, n_out = ttt.quantize_bits(x, bits, device="cpu")
    jpacked, jscales, jn = jtt.quantize_bits(x, bits)
    np.testing.assert_array_equal(uint32_words(packed), jpacked)
    _equal(scales, jscales)
    assert n_out == jn
    _equal(ttt.dequantize_bits(packed, scales, bits, n_out),
           jtt.dequantize_bits(jpacked, jscales, bits, jn))


@pytest.mark.parametrize("seed", range(5))
def test_bitpack_roundtrip_bounded(seed):
    """tests/test_properties.py's sweep: error within one step a group."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 500))
    bits = int(rng.choice([3, 5, 7, 8]))
    x = (rng.normal(size=n) * float(rng.uniform(0.01, 100.0))).astype(np.float32)
    packed, scales, n_out = ttt.quantize_bits(_t(x), bits)
    back = ttt.dequantize_bits(packed, scales, bits, n_out).numpy()
    step = np.abs(x).max() / ((1 << (bits - 1)) - 1) + 1e-6
    assert back.shape == x.shape and np.max(np.abs(back - x)) <= step


def test_temporal_store_tiers_by_access_match_jax():
    """tests/test_solver_quant.py's case on both stores: the same tiers,
    moves, ratios and words, and reads within 2e-5."""
    rng = np.random.default_rng(1)
    hot = rng.normal(size=(4, 64)).astype(np.float32)
    cold = rng.normal(size=(4, 64)).astype(np.float32)
    st, jst = ttt.TemporalTensorStore(ttt.TierPolicy(), device="cpu"), jtt.TemporalTensorStore()
    for s in (st, jst):
        s.write("hot", hot)
        s.write("cold", cold)
        for _ in range(200):
            s._now()
        for _ in range(50):
            s.read("hot")
    assert st.migrate() == jst.migrate() == {"cold": 3}
    assert st.tier_of("hot") == 8 and st.tier_of("cold") == 3
    for key in ("hot", "cold"):
        assert st.compression_ratio(key) == jst.compression_ratio(key)
        np.testing.assert_array_equal(uint32_words(st._slots[key].packed), jst._slots[key].packed)
        _close(st.read(key), jst.read(key))
    assert st.compression_ratio("cold") > 6
    back = st.read("cold").numpy()
    assert np.corrcoef(back.ravel(), cold.ravel())[0, 1] > 0.95


def test_tier_policy_select_bits_reference_semantics():
    p = ttt.TierPolicy()
    assert p.select_bits(access_count=100, last_access_ts=99, now_ts=100) == 8
    assert p.select_bits(access_count=1, last_access_ts=90, now_ts=100) == 7
    assert p.select_bits(access_count=1, last_access_ts=0, now_ts=10_000) == 3
    assert abs(p.drift_factor() - (1 + 26 / 256)) < 1e-9
    assert dataclasses.asdict(p) == dataclasses.asdict(jtt.TierPolicy())


def _tier_stores(dim, policy):
    clock = [0.0]
    return clock, (ttiers.TemporalTensorStore(dim, ttiers.TierPolicyConfig(**policy),
                                              clock=lambda: clock[0], device="cpu"),
                   jtiers.TemporalTensorStore(dim, jtiers.TierPolicyConfig(**policy),
                                              clock=lambda: clock[0]))


def test_temporal_tiers_roundtrip_and_demotion_match_jax():
    """tests/test_serve_rerank.py's case, both stores on one fake clock:
    hot, warm, cold, each read against JAX's and within its bit width."""
    clock, (store, jstore) = _tier_stores(16, dict(hot_threshold=0.5, warm_threshold=0.05,
                                                   decay_per_second=1.0, demote_interval_s=0.0))
    x = rand(8, 16, seed=2)
    for s in (store, jstore):
        s.write(0, x)
    for tier, advance, bound in (("hot", 0.0, 255), ("warm", 3.0, 15), ("cold", 60.0, 7)):
        clock[0] += advance
        for s in (store, jstore):
            s.tick(force=True)
        assert store.tier_of(0) == jstore.tier_of(0) == tier
        got, want = store.read(0), jstore.read(0)
        _close(got, want)
        assert np.abs(got.numpy() - x).max() < np.ptp(x) / bound * 2
        _equal(store._chunks[0]["data"].scale, jstore._chunks[0]["data"].scale)


def test_temporal_tiers_promotion_and_stats_match_jax():
    clock, (store, jstore) = _tier_stores(8, dict(decay_per_second=1.0, demote_interval_s=0.0))
    x = np.ones((4, 8), np.float32)
    for s in (store, jstore):
        s.write(0, x)
        s.write(1, x)
    clock[0] += 10.0
    for s in (store, jstore):
        s.tick(force=True)
    assert store.tier_of(0) == jstore.tier_of(0) == "cold"
    for s in (store, jstore):
        for _ in range(5):
            s.read(0)
        s.tick(force=True)
    assert store.tier_of(0) == "hot"
    assert store.stats() == jstore.stats()
    st = store.stats()
    assert st["hot"] == 1 and st["cold"] == 1 and st["compression_ratio"] > 1.0
    with pytest.raises(ValueError):
        store.write(2, np.ones((2, 5), np.float32))
