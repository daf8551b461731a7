"""Parity of the plain versions of the gated layer kernels against the JAX
kernels (interpret mode), on the CPU, on the halo-free layout of
test_gated_graph_transformer.py:724 (_halo_free_setup: n=512, d=32,
B=128, 4 heads): K4a gated_block_layer, K4b gated_block_layer_with_sig
and K6c block_gate_signature_ln_x, in f32 and bf16 compute, with a sparse
keep mask, padding rows and a row with nothing kept.

Tolerances: f32 2e-5 (the JAX fused-layer tests' bound); bf16 4e-2 max and
8e-3 mean (the JAX bf16 layer bound); signatures: counts equal, sums
within 2e-6 relative in f32. In bf16 a pooled logit whose float32 sum
lands on the other side of a bf16 rounding boundary moves by one bf16
step, so there the sums are held to 1e-3 relative and counts to 0.5% of
the positive pairs. Against the CUDA kernels the plain versions agree
bit for bit (the same LayerNorm order, float64 sums); the last two tests
pin that contract here.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ruvector_tpu.graph import build_block_dense as jbuild
from ruvector_tpu.graph_transformer.gated import GatedGraphTransformerConfig as JCfg
from ruvector_tpu.graph_transformer.gated import _fold_sig_params as jfold_sig
from ruvector_tpu.graph_transformer.gated import gated_graph_transformer_init as jinit
from ruvector_tpu.graph_transformer.gated import pack_keep as jpack
from ruvector_tpu.ops.pallas.gated_block_attn import block_gate_signature as jk6a
from ruvector_tpu.ops.pallas.gated_block_attn import block_gate_signature_ln_x as jk6c
from ruvector_tpu.ops.pallas.gated_block_attn import block_gate_signature_x as jk6b
from ruvector_tpu.ops.pallas.gated_block_attn import fold_gated_attention_params as jfold_attn
from ruvector_tpu.ops.pallas.gated_block_layer import fold_gated_layer_params as jfold
from ruvector_tpu.ops.pallas.gated_block_layer import gated_block_layer as jk4a
from ruvector_tpu.ops.pallas.gated_block_layer import gated_block_layer_with_sig as jk4b
from ruvector_tpu_torch.convert import params_from_numpy
from ruvector_tpu_torch.graph import build_block_dense
from ruvector_tpu_torch.graph_transformer import GatedGraphTransformerConfig
from ruvector_tpu_torch.graph_transformer.gated import _fold_sig_params
from ruvector_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
from ruvector_tpu_torch.ops.kernels.gated_block_attn import (
    block_gate_signature,
    block_gate_signature_ln_x,
    block_gate_signature_ln_x_reference,
    block_gate_signature_x,
    fold_gated_attention_params,
    head_concat,
    layer_norm_rows,
    matmul_f64,
    mha_body,
    mha_tiles,
    sig_body,
    tree_sum,
)
from ruvector_tpu_torch.ops.kernels.mincut_gate_block import (
    gate_body,
    mincut_gate_block_from_x,
    mincut_gate_block_from_x_reference,
)
from ruvector_tpu_torch.ops.kernels.gated_block_layer import (
    FOLDED_KEYS,
    fold_gated_layer_params,
    gated_block_layer,
    gated_block_layer_with_sig,
    weight_tiles,
)

F32_TOL = 2e-5
BF16_MAX, BF16_MEAN = 4e-2, 8e-3


def _setup(compute="float32", n=500, d=32, block=128, seed=13):
    """_halo_free_setup's graph, with n not a multiple of the block so the
    last block has padding rows."""
    rng = np.random.default_rng(seed)
    base = (np.arange(n)[:, None] // block) * block
    idx = np.minimum(base + rng.integers(0, block, (n, 8)), n - 1).astype(np.int32)
    mask = np.ones((n, 8), np.float32)
    ew = rng.uniform(0.1, 1.0, (n, 8)).astype(np.float32)
    jb = jbuild(idx, mask, ew, block=block)
    tb = build_block_dense(idx, mask, ew, block=block, device="cpu")
    assert tb.table == tb.block and jb.table == jb.block
    jc = JCfg(dim=d, num_heads=4, num_layers=2, fused_gate_attn="always",
              compute_dtype=compute)
    jp = jinit(jax.random.key(0), jc)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    tc = GatedGraphTransformerConfig(dim=d, num_heads=4, num_layers=2,
                                     fused_gate_attn="always", compute_dtype=compute)
    x = rng.normal(size=(tb.n_blocks, block, d)).astype(np.float32)
    keep = rng.uniform(size=(tb.n_blocks, block, block)) < 0.3
    keep[0, 5] = False                   # a row with nothing kept
    kp = np.array(jpack(jnp.asarray(keep)))
    return (jp, jc, jb), (tp, tc, tb), x, kp


def _close(got, want, bf16):
    got = got.float().numpy()
    want = np.asarray(want).astype(np.float32)
    assert got.shape == want.shape and np.all(np.isfinite(got))
    if bf16:
        err = np.abs(got - want)
        assert err.max() < BF16_MAX and err.mean() < BF16_MEAN, (err.max(), err.mean())
    else:
        np.testing.assert_allclose(got, want, atol=F32_TOL, rtol=0)


def _sig_close(rsum, rcnt, jrsum, jrcnt, bf16):
    jrsum, jrcnt = np.asarray(jrsum), np.asarray(jrcnt)
    if bf16:
        assert np.abs(rcnt.numpy() - jrcnt).sum() <= 0.005 * max(jrcnt.sum(), 1)
        np.testing.assert_allclose(rsum.numpy().sum(1), jrsum.sum(1), rtol=1e-3)
    else:
        np.testing.assert_array_equal(rcnt.numpy(), jrcnt)
        np.testing.assert_allclose(rsum.numpy(), jrsum, rtol=2e-6, atol=1e-6)


def _kernel_args(jside, tside, x, kp, bf16):
    (jp, jc, jb), (tp, tc, tb) = jside, tside
    jwd = jb.wdense.astype(jnp.bfloat16) if bf16 else jb.wdense
    twd = tb.wdense.to(torch.bfloat16) if bf16 else tb.wdense
    jf = jfold(jp[0], jc)
    tf = {k: torch.from_numpy(np.array(v)) for k, v in zip(FOLDED_KEYS, jf)}
    jargs = (jnp.asarray(x), jnp.asarray(kp), jb.node_pad, jwd, jf)
    targs = (torch.from_numpy(x), torch.from_numpy(kp.view(np.int32)), tb.node_pad, twd, tf)
    return jargs, targs


def test_fold_gated_layer_params_matches():
    (jp, jc, _), (tp, tc, _), _, _ = _setup()
    got = fold_gated_layer_params(tp[0], tc)
    for key, want in zip(FOLDED_KEYS, jfold(jp[0], jc)):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want), atol=1e-6, rtol=0)
    A, Wvo = fold_gated_attention_params(tp[1], tc)
    jA, jWvo = jfold_attn(jp[1], jc)
    np.testing.assert_allclose(A.numpy(), np.asarray(jA), atol=1e-6)
    np.testing.assert_allclose(Wvo.numpy(), np.asarray(jWvo), atol=1e-6)
    np.testing.assert_allclose(_fold_sig_params(tp[1], tc).numpy(),
                               np.asarray(jfold_sig(jp[1], jc)), atol=1e-6)


@pytest.mark.parametrize("d", [32, 64])
def test_weight_tiles_are_the_jax_kernel_operands(d):
    """The tensor-core body's bf16 [D, D] tiles are the JAX kernel's bf16
    operands in its order of use: head h's columns of A_cat and Wvo_cat,
    W_gnn, FFN chunk c's columns of Wi and rows of Wo."""
    (jp, jc, _), _, _, _ = _setup(d=d, n=300)
    jf = dict(zip(FOLDED_KEYS, (np.asarray(v) for v in jfold(jp[0], jc))))
    heads, fm = jc.num_heads, jf["Wi"].shape[1] // d
    tiles = weight_tiles({k: torch.from_numpy(v.copy()) for k, v in jf.items()}, heads, fm, d)
    cols = lambda m, i: m[:, i * d:(i + 1) * d]  # noqa: E731
    want = ([cols(jf["A_cat"], h) for h in range(heads)]
            + [cols(jf["Wvo_cat"], h) for h in range(heads)] + [jf["Wg"]]
            + [cols(jf["Wi"], c) for c in range(fm)]
            + [jf["Wo"][c * d:(c + 1) * d] for c in range(fm)])
    assert tiles.dtype == torch.bfloat16 and tiles.shape == (len(want), d, d)
    for got, w in zip(tiles, want):
        np.testing.assert_array_equal(
            got.float().numpy(), np.asarray(jnp.asarray(w).astype(jnp.bfloat16), np.float32))


def test_layer_body_follows_shape_and_compute_type():
    # the fused layer's wrappers dispatch on the gated MHA's rule
    layer_module = importlib.import_module("ruvector_tpu_torch.ops.kernels.gated_block_layer")
    assert layer_module.mha_body is mha_body
    assert [mha_body(b, True) for b in (1, 200, 256, 257, 512)] == \
        ["tensor_core"] * 3 + ["block_gemm"] * 2
    assert mha_body(256, False) == "block_gemm"


def test_mha_body_follows_shape_and_compute_type():
    assert [mha_body(b, True) for b in (1, 48, 240, 256, 257, 512)] == \
        ["tensor_core"] * 4 + ["block_gemm"] * 2
    assert [mha_body(b, False) for b in (48, 256, 512)] == ["block_gemm"] * 3


def test_gate_bodies_follow_shape_and_compute_type():
    # K6c: bf16 compute at B <= 256 on the float64 tensor cores
    assert [sig_body(b, True) for b in (1, 100, 240, 256, 257, 512)] == \
        ["tensor_core"] * 4 + ["block_gemm"] * 2
    assert [sig_body(b, False) for b in (100, 256, 512)] == ["block_gemm"] * 3
    # K7: the same, and only with LN1 folded in (rows that are bf16 values)
    ln = (torch.ones(32), torch.zeros(32))
    assert [gate_body(b, True, ln) for b in (32, 128, 256, 288, 512)] == \
        ["tensor_core"] * 3 + ["block_gemm"] * 2
    assert gate_body(256, False, ln) == "block_gemm"
    assert gate_body(256, True, None) == "block_gemm"


@pytest.mark.parametrize("variant", ["exact", "f32_acc", "reach_one_frontier"])
def test_gate_wrappers_take_the_plain_version_on_the_cpu(variant):
    """K6c and K7 on CPU tensors: their plain versions, no launch; a
    planted fault or the probe is a card-only instance and raises."""
    g = torch.Generator().manual_seed(4)
    x = torch.randn(2, 64, 32, generator=g)
    pad = torch.ones(2, 64)
    A = torch.randn(32, 32, generator=g) * 0.1
    ln = (torch.ones(32), torch.zeros(32))
    reset_launch_counts()
    if variant == "exact":
        got = block_gate_signature_ln_x(x, pad, A, *ln, eps=0.01, compute_bf16=True)
        want = block_gate_signature_ln_x_reference(x, pad, A, *ln, eps=0.01, compute_bf16=True)
        assert all(torch.equal(a, w) for a, w in zip(got, want))
        got = mincut_gate_block_from_x(x, pad, A, lam=0.5, eps=0.01, ln=ln, compute_bf16=True)
        want = mincut_gate_block_from_x_reference(x, pad, A, lam=0.5, eps=0.01, ln=ln,
                                                  compute_bf16=True)
        assert all(torch.equal(a, w) for a, w in zip(got, want))
    else:
        with pytest.raises(ValueError):
            if variant == "f32_acc":
                block_gate_signature_ln_x(x, pad, A, *ln, eps=0.01, compute_bf16=True,
                                          variant=variant)
            else:
                mincut_gate_block_from_x(x, pad, A, lam=0.5, eps=0.01, ln=ln,
                                         compute_bf16=True, variant=variant)
    counts = launch_counts()
    assert counts["block_gate_signature_ln_x"] == counts["mincut_gate_block_from_x"] == 0


@pytest.mark.parametrize("variant", ["exact", "f32_acc"])
def test_signature_x_at_the_halo_layout(variant):
    """K6b at the halo layout's B = 240 (B % 32 != 0, the only layout that
    calls it): bf16 compute takes the float64 tensor-core body on the card
    and float32 compute block_gemm's; on CPU tensors the wrapper takes the
    plain version, which agrees with JAX's K6b in interpret mode, and its
    planted fault, a card-only instance, raises."""
    assert sig_body(240, True) == "tensor_core" and sig_body(240, False) == "block_gemm"
    rng = np.random.default_rng(8)
    x = rng.normal(size=(2, 240, 32)).astype(np.float32)
    pad = np.ones((2, 240), np.float32)
    pad[1, 200:] = 0.0
    A = (0.1 * rng.normal(size=(32, 32))).astype(np.float32)
    x_t, pad_t, A_t = (torch.from_numpy(v) for v in (x, pad, A))
    reset_launch_counts()
    if variant == "exact":
        rsum, rcnt = block_gate_signature_x(x_t, pad_t, A_t, eps=0.01, compute_bf16=True)
        jrsum, jrcnt = jk6b(jnp.asarray(x), jnp.asarray(pad), jnp.asarray(A), eps=0.01,
                            compute_bf16=True)
        assert float(rcnt.sum()) > 0 and float(rcnt[1, 200:].sum()) == 0.0
        _sig_close(rsum, rcnt, jrsum, jrcnt, True)
    else:
        with pytest.raises(ValueError):
            block_gate_signature_x(x_t, pad_t, A_t, eps=0.01, compute_bf16=True,
                                   variant=variant)
    assert launch_counts()["block_gate_signature_x"] == 0


@pytest.mark.parametrize("variant", ["exact", "f32_acc"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k6a_body_follows_the_qk_dtype(dtype, variant):
    """K6a's body is `sig_body` with q's dtype as its compute type: bf16 q
    and k at B <= 256 (the halo layout's B = 240 included) take the
    float64 tensor-core body on the card, float32 q and k and B > 256
    block_gemm's. On CPU tensors the wrapper takes the plain version,
    which agrees with JAX's K6a in interpret mode, and its planted fault,
    a card-only instance, raises."""
    assert [sig_body(b, True) for b in (32, 128, 240, 256)] == ["tensor_core"] * 4
    assert [sig_body(b, True) for b in (257, 320, 512)] == ["block_gemm"] * 3
    assert sig_body(240, dtype == torch.bfloat16) == \
        ("tensor_core" if dtype == torch.bfloat16 else "block_gemm")
    rng = np.random.default_rng(9)
    q = rng.normal(size=(2, 240, 32)).astype(np.float32)
    k = rng.normal(size=(2, 240, 32)).astype(np.float32)
    pad = np.ones((2, 240), np.float32)
    pad[1, 200:] = 0.0
    tq, tk = torch.from_numpy(q).to(dtype), torch.from_numpy(k).to(dtype)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    reset_launch_counts()
    if variant == "exact":
        rsum, rcnt = block_gate_signature(tq, tk, torch.from_numpy(pad), eps=0.01, scale=0.2)
        jrsum, jrcnt = jk6a(jnp.asarray(q).astype(jdt), jnp.asarray(k).astype(jdt),
                            jnp.asarray(pad), eps=0.01, scale=0.2)
        assert float(rcnt.sum()) > 0 and float(rcnt[1, 200:].sum()) == 0.0
        _sig_close(rsum, rcnt, jrsum, jrcnt, dtype == torch.bfloat16)
    else:
        with pytest.raises(ValueError):
            block_gate_signature(tq, tk, torch.from_numpy(pad), eps=0.01, scale=0.2,
                                 variant=variant)
    assert launch_counts()["block_gate_signature"] == 0


def test_mha_tiles_are_the_heads_rounded_to_bf16():
    g = torch.Generator().manual_seed(3)
    d, heads = 32, 3
    A = torch.randn(heads, d, d, generator=g)
    Wvo = torch.randn(heads, d, d, generator=g)
    tiles = mha_tiles(head_concat(A), head_concat(Wvo), d)
    assert tiles.dtype == torch.bfloat16 and tiles.shape == (2 * heads, d, d)
    assert torch.equal(tiles, torch.cat([A, Wvo]).to(torch.bfloat16))


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_k4a_plain_matches_jax(compute):
    bf16 = compute == "bfloat16"
    jside, tside, x, kp = _setup(compute)
    jargs, targs = _kernel_args(jside, tside, x, kp, bf16)
    reset_launch_counts()
    got = gated_block_layer(*targs, compute_bf16=bf16)
    assert launch_counts()["gated_block_layer"] == 0
    assert got.dtype == torch.float32
    _close(got, jk4a(*jargs, compute_bf16=bf16), bf16)


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_k4b_plain_matches_jax_and_k4a(compute):
    bf16 = compute == "bfloat16"
    jside, tside, x, kp = _setup(compute)
    (jp, jc, _), (tp, tc, _) = jside, tside
    jargs, targs = _kernel_args(jside, tside, x, kp, bf16)
    jsig = (jfold_sig(jp[1], jc), jp[1]["ln1"]["gamma"], jp[1]["ln1"]["beta"])
    tsig = (_fold_sig_params(tp[1], tc), tp[1]["ln1"]["gamma"], tp[1]["ln1"]["beta"])
    out, rsum, rcnt = gated_block_layer_with_sig(*targs, *tsig, compute_bf16=bf16,
                                                 sig_eps=tc.eps)
    jout, jrsum, jrcnt = jk4b(*jargs, *jsig, compute_bf16=bf16, sig_eps=jc.eps)
    _close(out, jout, bf16)
    _sig_close(rsum, rcnt, jrsum, jrcnt, bf16)
    assert torch.equal(out, gated_block_layer(*targs, compute_bf16=bf16))
    # the emitted signature is K6c's on the written output
    rs6, rc6 = block_gate_signature_ln_x(out, tside[2].node_pad, *tsig, eps=tc.eps,
                                         compute_bf16=bf16)
    assert torch.equal(rs6, rsum) and torch.equal(rc6, rcnt)


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_k6c_plain_matches_jax(compute):
    bf16 = compute == "bfloat16"
    (jp, jc, jb), (tp, tc, tb), x, _ = _setup(compute)
    x = 2.0 * x
    reset_launch_counts()
    rsum, rcnt = block_gate_signature_ln_x(
        torch.from_numpy(x), tb.node_pad, _fold_sig_params(tp[0], tc),
        tp[0]["ln1"]["gamma"], tp[0]["ln1"]["beta"], eps=tc.eps, compute_bf16=bf16)
    assert launch_counts()["block_gate_signature_ln_x"] == 0
    jrsum, jrcnt = jk6c(jnp.asarray(x), jb.node_pad, jfold_sig(jp[0], jc),
                        jp[0]["ln1"]["gamma"], jp[0]["ln1"]["beta"], eps=jc.eps,
                        compute_bf16=bf16)
    assert float(rcnt.sum()) > 0
    _sig_close(rsum, rcnt, jrsum, jrcnt, bf16)
    # padding rows count nothing
    assert float(rcnt[tb.node_pad == 0].sum()) == 0.0


def test_fused_layer_is_forward_only():
    _, (tp, tc, tb), x, kp = _setup()
    folded = fold_gated_layer_params(tp[0], tc)
    folded["Wg"].requires_grad_(True)
    with pytest.raises(RuntimeError, match="forward-only"):
        gated_block_layer(torch.from_numpy(x), torch.from_numpy(kp.view(np.int32)),
                          tb.node_pad, tb.wdense, folded, compute_bf16=False)
    with torch.no_grad():
        gated_block_layer(torch.from_numpy(x), torch.from_numpy(kp.view(np.int32)),
                          tb.node_pad, tb.wdense, folded, compute_bf16=False)


def _warp_tree_sum(row: np.ndarray) -> np.float32:
    """The kernels' row sum (csrc/gated_common.cuh: tree_sum) in float32:
    lane l adds row[l] + row[l + 64] and row[l + 32] + row[l + 96] (0 past
    D), then the two, then the warp butterfly over xor 16, 8, 4, 2, 1."""
    f = np.float32
    d = len(row)
    at = lambda c: row[c] if c < d else f(0)  # noqa: E731
    lanes = [f(f(at(l) + at(l + 64)) + f(at(l + 32) + at(l + 96))) for l in range(32)]
    for o in (16, 8, 4, 2, 1):
        lanes = [f(lanes[l] + lanes[l ^ o]) for l in range(32)]
    assert len({v.tobytes() for v in lanes}) == 1
    return lanes[0]


@pytest.mark.parametrize("d", [32, 64, 128])
def test_plain_layer_norm_rounds_as_the_kernels(d):
    """The plain versions' LayerNorm sums in the kernels' order bit for bit
    (so kernel and plain gate logits agree exactly), and is a LayerNorm."""
    rng = np.random.default_rng(d)
    rows = (rng.normal(size=(64, d)) * 10.0 ** rng.uniform(-3, 3, size=(64, d)))
    rows = rows.astype(np.float32)
    got = tree_sum(torch.from_numpy(rows))[:, 0].numpy()
    want = np.array([_warp_tree_sum(r) for r in rows], np.float32)
    assert got.tobytes() == want.tobytes()
    x = torch.from_numpy(rng.normal(size=(8, 16, d)).astype(np.float32))
    g, b = torch.rand(d) + 0.5, torch.randn(d)
    torch.testing.assert_close(layer_norm_rows(x, g, b),
                               torch.nn.functional.layer_norm(x, (d,), g, b, eps=1e-5),
                               rtol=0.0, atol=2e-6)


def test_matmul_f64_rounds_once():
    """Sums of bf16 products in float64 are exact, so any order of the
    terms gives the same float32 result."""
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.normal(size=(4, 32, 128)).astype(np.float32)).bfloat16().float()
    w = torch.from_numpy(rng.normal(size=(128, 64)).astype(np.float32)).bfloat16().float()
    perm = torch.from_numpy(rng.permutation(128))
    assert torch.equal(matmul_f64(a, w), matmul_f64(a[..., perm], w[perm]))
