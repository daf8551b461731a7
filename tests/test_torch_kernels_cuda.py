"""Each CUDA kernel against its plain PyTorch version, on the card.

Marked `cuda`: without a card every test skips. The JAX package is not
needed (nor installed) on the card's machine, so run them without the
test directory's conftest, which imports jax:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

Tolerances (max abs error on outputs of order 1): f32 1e-4, sums in
another order; bf16 5e-2, the kernels round softmax weights against a
running max where the plain versions use the row max. Gradients (K5b)
are held to the same bounds relative to each tensor's largest magnitude;
signature counts (K6a/K6b/K6c) and gate masks (K7) must be equal. K8 and
K9 (f32 sums of up to 300 terms) are held to f32 1e-4.
"""

import dataclasses

import numpy as np
import pytest
import torch

from ruvector_tpu_torch.graph import build_block_dense
from ruvector_tpu_torch.graph_transformer import (
    GatedGraphTransformerConfig,
    gate_state_init,
    gated_graph_transformer_apply_with_masks,
    gated_graph_transformer_init,
    gated_graph_transformer_loss_with_masks,
    gated_graph_transformer_step,
)
from ruvector_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
from ruvector_tpu_torch.ops.kernels.block_dense_attn import (
    _folded_shapes,
    block_dense_attention,
    block_dense_attention_reference,
    block_dense_layer_fused,
    block_dense_layer_fused_reference,
)
from ruvector_tpu_torch.ops.kernels.flash_neighbor import (
    flash_neighbor_attention,
    flash_neighbor_attention_reference,
)
from ruvector_tpu_torch.ops.kernels.gated_block_attn import (
    block_gate_signature,
    block_gate_signature_ln_x,
    block_gate_signature_ln_x_reference,
    block_gate_signature_reference,
    block_gate_signature_x,
    block_gate_signature_x_reference,
    gated_block_attention_bwd,
    gated_block_attention_bwd_reference,
    gated_block_attention_fwd,
    gated_block_attention_fwd_reference,
    pack_keep,
)
from ruvector_tpu_torch.ops.kernels.gated_block_layer import _folded_shapes as _gated_folded_shapes
from ruvector_tpu_torch.ops.kernels.gated_block_layer import (
    gated_block_layer,
    gated_block_layer_reference,
    gated_block_layer_with_sig,
)
from ruvector_tpu_torch.ops.kernels.mincut_gate_block import (
    isolated_sink,
    mincut_gate_block_from_x,
    mincut_gate_block_from_x_reference,
)
from ruvector_tpu_torch.ops.kernels.neighbor_mix import (
    fused_neighbor_mix,
    fused_neighbor_mix_reference,
)
from ruvector_tpu_torch.ops.kernels.spmm import spmm_gather, spmm_gather_reference

pytestmark = pytest.mark.cuda
TOL = {torch.float32: 1e-4, torch.bfloat16: 5e-2}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    reset_launch_counts()
    return torch.device("cuda")


def _close(got, want, dtype):
    torch.cuda.synchronize()
    assert got.shape == want.shape and torch.isfinite(got.float()).all()
    assert float((got.float() - want.float()).abs().max()) <= TOL[dtype]


def _block_inputs(dev, cdt, nb=3, b=45, t=200, d=64, h=4):
    """Ragged B, T not a multiple of the 32-column chunk, a degree-0 row,
    a 1e-7 edge and a log-multiplicity table."""
    g = torch.Generator().manual_seed(0)
    wd = torch.rand(nb, b, t, generator=g) * (torch.rand(nb, b, t, generator=g) < 0.1)
    wd[0, 3] = 0.0
    wd[1, 4, 150] = 1e-7
    lm = torch.log(torch.randint(1, 3, (nb, b, t), generator=g).float())
    L = torch.randn(nb, t, d, generator=g)
    u = 0.3 * torch.randn(h, nb, b, d, generator=g)
    sb = torch.randn(h, nb, b, generator=g)
    msg = torch.randn(nb, b, d, generator=g)
    folded = {k: 0.2 * torch.randn(s, generator=g) for k, s in _folded_shapes(h, d).items()}
    return (L.to(dev, cdt), u.to(dev, cdt), sb.to(dev), wd.to(dev), lm.to(dev),
            msg.to(dev), {k: v.to(dev) for k, v in folded.items()})


@pytest.mark.parametrize("with_lm", [False, True])
@pytest.mark.parametrize("cdt", [torch.float32, torch.bfloat16])
def test_block_dense_attention_kernel(card, cdt, with_lm):
    L, u, sb, wd, lm, _, _ = _block_inputs(card, cdt)
    lm = lm if with_lm else None
    _close(block_dense_attention(L, u, sb, wd, lm, scale=0.25),
           block_dense_attention_reference(L, u, sb, wd, lm, scale=0.25), cdt)
    assert launch_counts()["block_dense_attention"] == 1


@pytest.mark.parametrize("msg_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cdt", [torch.float32, torch.bfloat16])
def test_block_dense_layer_fused_kernel(card, cdt, msg_dtype):
    L, _, _, wd, lm, msg, folded = _block_inputs(card, cdt)
    msg = msg.to(msg_dtype)
    got = block_dense_layer_fused(L, msg, wd, folded, lm, dropout=0.1, eps=1e-5)
    assert got.dtype == msg_dtype
    tol_dtype = torch.bfloat16 if torch.bfloat16 in (cdt, msg_dtype) else torch.float32
    _close(got, block_dense_layer_fused_reference(L, msg, wd, folded, lm, dropout=0.1,
                                                  eps=1e-5), tol_dtype)
    assert launch_counts()["block_dense_layer_fused"] == 1


@pytest.mark.parametrize("heads", [1, 4, 16])
def test_fused_neighbor_mix_kernel(card, heads):
    g = torch.Generator().manual_seed(heads)
    n, m, d = 1001, 13, 96
    u, bias, nbr = (torch.randn(s, generator=g).to(card)
                    for s in ((n, heads, d), (n, heads), (n, m, d)))
    mask = (torch.rand(n, m, generator=g) > 0.3).float().to(card)
    mask[5] = 0.0
    wnorm = torch.rand(n, m, generator=g).to(card) * mask
    _close(fused_neighbor_mix(u, bias, nbr, mask, wnorm, heads=heads, scale=0.3),
           fused_neighbor_mix_reference(u, bias, nbr, mask, wnorm, heads=heads, scale=0.3),
           torch.float32)
    assert launch_counts()["fused_neighbor_mix"] == 1


def test_wrappers_raise_on_unsupported_input(card):
    L, u, sb, wd, _, _, _ = _block_inputs(card, torch.float32, d=48)
    with pytest.raises(ValueError, match="feature width"):
        block_dense_attention(L, u, sb, wd, scale=0.25)
    L, u, sb, wd, _, _, _ = _block_inputs(card, torch.float32)
    with pytest.raises(ValueError, match="float32"):
        block_dense_attention(L, u, sb, wd.half(), scale=0.25)
    assert launch_counts()["block_dense_attention"] == 0
    x, pad, A, ln, _, _ = _gated_inputs(card, torch.float32, b=48)
    with pytest.raises(ValueError, match="multiple of 32"):
        mincut_gate_block_from_x(x, pad, A, lam=0.5, eps=0.01, ln=ln)
    assert launch_counts()["mincut_gate_block_from_x"] == 0


# ---------------------------------------------------------------------------
# the gated graph transformer's kernels (K4a, K4b, K6c, K7)
# ---------------------------------------------------------------------------

def _gated_inputs(dev, xdt, nb=3, b=256, d=128, h=4, fm=4, seed=0):
    """A short tail block (pad rows), a sparse keep mask with a row that
    keeps nothing, normalized block-local edge weights, and folded layer
    weights at the scale of an initialised model."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(nb, b, d, generator=g)
    pad = torch.ones(nb, b)
    pad[-1, b - b // 3:] = 0.0
    keep = torch.rand(nb, b, b, generator=g) < 0.3
    keep[0, 5] = False
    wd = torch.rand(nb, b, b, generator=g) * (torch.rand(nb, b, b, generator=g) < 0.06)
    wd = wd / wd.sum(-1, keepdim=True).clamp(min=1e-10)
    A = torch.randn(d, d, generator=g) * (0.3 / d ** 0.5)
    ln = (1.0 + 0.1 * torch.randn(d, generator=g), 0.1 * torch.randn(d, generator=g))
    folded = {}
    for key, shape in _gated_folded_shapes(h, d, fm).items():
        if shape[0] == 1:      # LayerNorm rows (gamma near 1) and biases
            base = 1.0 if key.endswith("_g") else 0.0
            folded[key] = base + 0.1 * torch.randn(shape, generator=g)
        else:                  # [in, out]; A_h at the 1/D scale of Wq_h Wk_h^T / sqrt(dh)
            std = 1.0 / d if key == "A_cat" else shape[0] ** -0.5
            folded[key] = std * torch.randn(shape, generator=g)
    x, pad, A = x.to(dev, xdt), pad.to(dev), A.to(dev)
    return (x, pad, A, tuple(v.to(dev) for v in ln), (pack_keep(keep).to(dev), wd.to(dev)),
            {k: v.to(dev) for k, v in folded.items()})


@pytest.mark.parametrize("compute_bf16", [False, True])
@pytest.mark.parametrize("xdt", [torch.float32, torch.bfloat16])
def test_block_gate_signature_ln_x_kernel(card, xdt, compute_bf16):
    x, pad, A, (gm, bt), _, _ = _gated_inputs(card, xdt)
    rsum, rcnt = block_gate_signature_ln_x(x, pad, A, gm, bt, eps=0.01,
                                           compute_bf16=compute_bf16)
    want_s, want_c = block_gate_signature_ln_x_reference(x, pad, A, gm, bt, eps=0.01,
                                                         compute_bf16=compute_bf16)
    torch.cuda.synchronize()
    assert launch_counts()["block_gate_signature_ln_x"] == 1
    # the plain LayerNorm is the kernel's step for step and both sum the
    # logits' products in float64, so every count is equal
    assert torch.equal(rcnt, want_c)
    torch.testing.assert_close(rsum, want_s, rtol=1e-6, atol=0.0)
    assert float(rcnt[pad == 0].sum()) == 0.0


@pytest.mark.parametrize("compute_bf16", [False, True])
@pytest.mark.parametrize("xdt", [torch.float32, torch.bfloat16])
def test_gated_block_layer_kernels(card, xdt, compute_bf16):
    x, pad, A, (gm, bt), (keep, wd), folded = _gated_inputs(card, xdt)
    wd = wd.to(torch.bfloat16) if compute_bf16 else wd
    out = gated_block_layer(x, keep, pad, wd, folded, compute_bf16=compute_bf16)
    want = gated_block_layer_reference(x, keep, pad, wd, folded, compute_bf16=compute_bf16)
    assert out.dtype == xdt and torch.isfinite(out.float()).all()
    # bf16: an output rounds to bf16 (one step is 2^-8 relative), and an
    # operand rounded to bf16 may round the other way after float32 sums
    # taken in another order
    bf16 = torch.bfloat16 in (xdt, wd.dtype)
    torch.testing.assert_close(out.float(), want.float(), atol=TOL[torch.bfloat16 if bf16 else
                                                                  torch.float32],
                               rtol=1e-2 if bf16 else 0.0)
    out2, rsum, rcnt = gated_block_layer_with_sig(x, keep, pad, wd, folded, A, gm, bt,
                                                  compute_bf16=compute_bf16, sig_eps=0.01)
    # one code path: K4b's output is K4a's bit for bit, and its signature
    # is K6c's on the written output bit for bit
    assert torch.equal(out2, out)
    rs6, rc6 = block_gate_signature_ln_x(out, pad, A, gm, bt, eps=0.01,
                                         compute_bf16=compute_bf16)
    assert torch.equal(rsum, rs6) and torch.equal(rcnt, rc6)
    assert launch_counts()["gated_block_layer"] == 1
    assert launch_counts()["gated_block_layer_with_sig"] == 1


@pytest.mark.parametrize("b", [64, 256])
@pytest.mark.parametrize("compute_bf16", [False, True])
def test_mincut_gate_block_kernel(card, b, compute_bf16):
    x, pad, A, ln, _, _ = _gated_inputs(card, torch.float32, nb=6, b=b)
    eye = torch.eye(x.shape[-1], device=card) * 0.1
    x[:2] = isolated_sink(x[:2], 0.1)
    pad[:2] = 1.0
    for A_k, ln_k in ((A, ln), (eye, None)):
        kp, stats = mincut_gate_block_from_x(x, pad, A_k, lam=0.5, eps=0.01, ln=ln_k,
                                             compute_bf16=compute_bf16)
        want_kp, want_stats = mincut_gate_block_from_x_reference(
            x, pad, A_k, lam=0.5, eps=0.01, ln=ln_k, compute_bf16=compute_bf16)
        torch.cuda.synchronize()
        assert torch.equal(kp, want_kp)
        torch.testing.assert_close(stats[:, 2], want_stats[:, 2], rtol=0, atol=0)
        torch.testing.assert_close(stats[:, 0], want_stats[:, 0], rtol=2e-3, atol=1e-4)
    assert float(stats[:2, 2, 0].min()) == 1.0      # the eye case applies its cuts
    assert launch_counts()["mincut_gate_block_from_x"] == 2


def _rel_close(got, want, tol):
    """max |got - want| within tol of want's largest magnitude."""
    torch.cuda.synchronize()
    assert got.shape == want.shape and torch.isfinite(got.float()).all()
    scale = max(float(want.float().abs().max()), 1e-6)
    assert float((got.float() - want.float()).abs().max()) <= tol * scale


@pytest.mark.parametrize("b", [48, 256])
@pytest.mark.parametrize("compute_bf16", [False, True])
@pytest.mark.parametrize("xdt", [torch.float32, torch.bfloat16])
def test_gated_block_attention_kernels(card, xdt, compute_bf16, b):
    """K5a and K5b against their plain versions: f32 1e-4 of each
    tensor's scale (sums in another order), bf16 5e-2."""
    x, pad, _, _, (keep, _), folded = _gated_inputs(card, xdt, b=b)
    A_cat, Wvo_cat = folded["A_cat"], folded["Wvo_cat"]
    g = torch.randn(x.shape, generator=torch.Generator().manual_seed(7)).to(card, xdt)
    tol = TOL[torch.bfloat16 if torch.bfloat16 in (xdt,) or compute_bf16 else torch.float32]
    out = gated_block_attention_fwd(x, keep, pad, A_cat, Wvo_cat, compute_bf16=compute_bf16)
    assert out.dtype == xdt
    _rel_close(out, gated_block_attention_fwd_reference(x, keep, pad, A_cat, Wvo_cat,
                                                        compute_bf16=compute_bf16), tol)
    got = gated_block_attention_bwd(x, keep, pad, A_cat, Wvo_cat, g, compute_bf16=compute_bf16)
    want = gated_block_attention_bwd_reference(x, keep, pad, A_cat, Wvo_cat, g,
                                               compute_bf16=compute_bf16)
    assert got[0].dtype == xdt and got[1].dtype == torch.float32
    for a, w in zip(got, want):
        _rel_close(a, w, tol)
    # the reduction runs in a fixed order: a second run repeats bit for bit
    again = gated_block_attention_bwd(x, keep, pad, A_cat, Wvo_cat, g, compute_bf16=compute_bf16)
    assert all(torch.equal(a, r) for a, r in zip(got, again))
    counts = launch_counts()
    assert counts["gated_block_attention_fwd"] == 1 and counts["gated_block_attention_bwd"] == 2


@pytest.mark.parametrize("compute_bf16", [False, True])
@pytest.mark.parametrize("xdt", [torch.float32, torch.bfloat16])
def test_block_gate_signature_x_and_qk_kernels(card, xdt, compute_bf16):
    """K6b and K6a against their plain versions: float64 sums on both
    sides, so the counts are equal and the sums within 1e-6 relative."""
    x, pad, A, _, _, _ = _gated_inputs(card, xdt, b=48)
    x = 2.0 * x
    rsum, rcnt = block_gate_signature_x(x, pad, A, eps=0.01, compute_bf16=compute_bf16)
    want_s, want_c = block_gate_signature_x_reference(x, pad, A, eps=0.01,
                                                      compute_bf16=compute_bf16)
    torch.cuda.synchronize()
    assert torch.equal(rcnt, want_c) and float(rcnt.sum()) > 0
    torch.testing.assert_close(rsum, want_s, rtol=1e-6, atol=0.0)
    q = (x.float() @ A).to(xdt)
    rsum, rcnt = block_gate_signature(q, x, pad, eps=0.01, scale=0.3)
    want_s, want_c = block_gate_signature_reference(q, x, pad, eps=0.01, scale=0.3)
    torch.cuda.synchronize()
    assert torch.equal(rcnt, want_c) and float(rcnt.sum()) > 0
    torch.testing.assert_close(rsum, want_s, rtol=1e-6, atol=0.0)
    counts = launch_counts()
    assert counts["block_gate_signature_x"] == 1 and counts["block_gate_signature"] == 1


def test_train_step_takes_the_kernels_at_d64(card):
    """Under "auto" a D=64 train step launches K4a forward and K5a/K5b in
    the backward's recompute (one each per layer), and its gradients match
    the plain route's; a B=48 layout (B % 32 != 0) takes K6b."""
    rng = np.random.default_rng(4)
    n, block, d = 512, 128, 64
    base = (np.arange(n)[:, None] // block) * block
    idx = (base + rng.integers(0, block, (n, 8))).astype(np.int32)
    ew = rng.uniform(0.1, 1.0, (n, 8)).astype(np.float32)
    bdg = build_block_dense(idx, np.ones((n, 8), np.float32), ew, block=block, device=card)
    cfg = GatedGraphTransformerConfig(dim=d, num_heads=4, num_layers=2, remat=True)
    params = gated_graph_transformer_init(0, cfg, device=card)
    fpad = bdg.pad_features(torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32)).to(card))
    with torch.no_grad():
        keep = gate_state_init(params, cfg, fpad, bdg)["keep"]
    grads = {}
    for route in ("auto", "never"):
        c = dataclasses.replace(cfg, fused_gate_attn=route)
        leaves = [t.clone().requires_grad_(True) for layer in params for t in _leaves(layer)]
        reset_launch_counts()
        loss = gated_graph_transformer_loss_with_masks(_rebuild(params, leaves), c, fpad, bdg,
                                                       keep, torch.zeros_like(fpad))
        grads[route] = torch.autograd.grad(loss, leaves)
        counts = launch_counts()
        if route == "auto":
            assert counts["gated_block_layer"] == 2
            assert counts["gated_block_attention_fwd"] == 2
            assert counts["gated_block_attention_bwd"] == 2
        else:
            assert not any(counts.values())
    for a, w in zip(grads["auto"], grads["never"]):
        _rel_close(a, w, 1e-3)
    bdg48 = build_block_dense(idx[:480] % 480, np.ones((480, 8), np.float32), ew[:480],
                              block=48, device=card)
    reset_launch_counts()
    with torch.no_grad():
        gate_state_init(params, cfg, bdg48.pad_features(fpad[:480]), bdg48)
    counts = launch_counts()
    assert counts["block_gate_signature_x"] == 2 and counts["gated_block_attention_fwd"] == 2
    assert counts["block_gate_signature_ln_x"] == 0 and counts["mincut_gate_block_from_x"] == 0


def _leaves(layer):
    return [v for k in sorted(layer)
            for v in ([layer[k][kk] for kk in sorted(layer[k])] if isinstance(layer[k], dict)
                      else [layer[k]])]


def _rebuild(params, leaves):
    it = iter(leaves)
    return [{k: ({kk: next(it) for kk in sorted(layer[k])} if isinstance(layer[k], dict)
                 else next(it)) for k in sorted(layer)} for layer in params]


def test_auto_route_takes_the_kernels_at_d64(card):
    """Under "auto", CUDA tensors take the kernel route at any width the
    kernels take: D=64 on a halo-free layout launches K7, K6c and K4a at
    init and K4b on a step, and the layer matches the plain composition."""
    rng = np.random.default_rng(3)
    n, block, d = 512, 128, 64
    base = (np.arange(n)[:, None] // block) * block
    idx = (base + rng.integers(0, block, (n, 8))).astype(np.int32)
    ew = rng.uniform(0.1, 1.0, (n, 8)).astype(np.float32)
    bdg = build_block_dense(idx, np.ones((n, 8), np.float32), ew, block=block, device=card)
    assert bdg.table == bdg.block
    cfg = GatedGraphTransformerConfig(dim=d, num_heads=4, num_layers=2)
    assert cfg.fused_gate_attn == "auto"
    params = gated_graph_transformer_init(0, cfg, device=card)
    fpad = bdg.pad_features(torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32)).to(card))
    with torch.no_grad():
        state = gate_state_init(params, cfg, fpad, bdg)
        counts = launch_counts()
        assert counts["mincut_gate_block_from_x"] == 2
        assert counts["block_gate_signature_ln_x"] == 2
        assert counts["gated_block_layer"] == 2
        out, _, nres = gated_graph_transformer_step(params, cfg, fpad, bdg, state)
        assert nres == 0 and launch_counts()["gated_block_layer_with_sig"] == 1
        plain = gated_graph_transformer_apply_with_masks(
            params, dataclasses.replace(cfg, fused_gate_attn="never"), fpad, bdg, state["keep"])
    torch.testing.assert_close(out, plain, atol=TOL[torch.float32], rtol=0.0)


# ---------------------------------------------------------------------------
# the serving re-rank's attention (K8) and the gather-fused SpMM (K9)
# ---------------------------------------------------------------------------

def _k8_inputs(dev, b, m, d, masked, seed=0):
    g = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn(s, generator=g).to(dev) for s in ((b, d), (b, m, d), (b, m, d)))
    mask = None
    if masked:
        mask = (torch.rand(b, m, generator=g) > 0.5).float()
        mask[3] = 0.0                                  # a fully masked row
        mask[5, : m // 2] = 0.0
        mask = mask.to(dev)
    return q, k, v, mask


@pytest.mark.parametrize("b,m,d,masked", [(64, 256, 128, False), (64, 256, 128, True),
                                          (37, 300, 64, True), (33, 5, 64, False),
                                          (16, 100, 32, True), (16, 70, 256, True)])
def test_flash_neighbor_attention_kernel(card, b, m, d, masked):
    q, k, v, mask = _k8_inputs(card, b, m, d, masked)
    got = flash_neighbor_attention(q, k, v, mask)
    _close(got, flash_neighbor_attention_reference(q, k, v, mask), torch.float32)
    if masked:
        assert float(got[3].abs().max()) == 0.0
    assert launch_counts()["flash_neighbor_attention"] == 1
    # fully masked everywhere: zeros; runs repeat bit for bit (no atomics)
    if mask is not None:
        assert float(flash_neighbor_attention(q, k, v, torch.zeros_like(mask)).abs().max()) == 0.0
        assert torch.equal(flash_neighbor_attention(q, k, v, mask), got)


@pytest.mark.parametrize("n,b,m,d", [(200, 64, 16, 128), (1000, 333, 17, 128),
                                     (500, 45, 40, 64), (300, 10, 3, 260)])
def test_spmm_gather_kernel(card, n, b, m, d):
    g = torch.Generator().manual_seed(n)
    feats = torch.randn(n, d, generator=g).to(card)
    idx = torch.randint(0, n, (b, m), generator=g, dtype=torch.int32)
    idx[1, 2], idx[4, 0] = -3, n + 7                   # out of range: adds nothing
    w = (torch.rand(b, m, generator=g) * (torch.rand(b, m, generator=g) > 0.2)).to(card)
    idx = idx.to(card)
    got = spmm_gather(feats, idx, w)
    _close(got, spmm_gather_reference(feats, idx, w), torch.float32)
    assert launch_counts()["spmm_gather"] == 1


def test_k8_k9_wrappers_raise_on_unsupported_input(card):
    q, k, v, mask = _k8_inputs(card, 8, 20, 64, True)
    for bad, match in (((q.bfloat16(), k, v, mask), "float32"),
                       ((q, k.transpose(1, 2).contiguous().transpose(1, 2), v, mask),
                        "contiguous"),
                       ((q, k, v.cpu(), mask), "different devices"),
                       ((q[:, :48].contiguous(), k[..., :48].contiguous(),
                         v[..., :48].contiguous(), mask), "feature width")):
        with pytest.raises(ValueError, match=match):
            flash_neighbor_attention(*bad)
    assert launch_counts()["flash_neighbor_attention"] == 0
    feats = torch.randn(30, 16, device=card)
    idx = torch.randint(0, 30, (5, 4), device=card, dtype=torch.int32)
    w = torch.rand(5, 4, device=card)
    for bad, match in (((feats.bfloat16(), idx, w), "float32"),
                       ((feats, idx.long(), w), "int32"),
                       ((feats, idx.t().contiguous().t(), w.t().contiguous().t()),
                        "contiguous"),
                       ((feats, idx, w.cpu()), "different devices"),
                       ((feats[:, :6].contiguous(), idx, w), "feature width")):
        with pytest.raises(ValueError, match=match):
            spmm_gather(*bad)
    assert launch_counts()["spmm_gather"] == 0
