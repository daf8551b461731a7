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
K9 (f32 sums of up to 300 terms) are held to f32 1e-4, and their bulk-copy
bodies to 1e-4 / 1e-5 (max / mean). K1's tensor-core
body is held to max and mean limits: bf16 5e-2 / 5e-3, and f32 1e-4 /
1e-5 on one-edge rows, where its attention is exact; K2's tensor-core
body to the same bf16 limits, and K3's two bodies to f32 1e-4 / 1e-5.
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
from ruvector_tpu_torch.ops.kernels import gated_block_attn
from ruvector_tpu_torch.ops.kernels.block_dense_attn import (
    _folded_shapes,
    block_dense_attention,
    block_dense_attention_reference,
    block_dense_layer_fused,
    block_dense_layer_fused_reference,
    k1_body,
    k2_body,
)
from ruvector_tpu_torch.ops.kernels import _lib
from ruvector_tpu_torch.ops.kernels.flash_neighbor import (
    flash_neighbor_attention,
    flash_neighbor_attention_reference,
    k8_body,
)
from ruvector_tpu_torch.ops.kernels.gated_block_attn import (
    block_gate_signature,
    block_gate_signature_ln_x,
    block_gate_signature_ln_x_reference,
    block_gate_signature_reference,
    block_gate_signature_x,
    block_gate_signature_x_reference,
    gated_block_attention_bwd,
    gated_block_attention_bwd_partials,
    gated_block_attention_bwd_reference,
    gated_block_attention_fwd,
    gated_block_attention_fwd_reference,
    mha_body,
    pack_keep,
    reduce_partials,
    sig_body,
)
from ruvector_tpu_torch.ops.kernels.gated_block_layer import _folded_shapes as _gated_folded_shapes
from ruvector_tpu_torch.ops.kernels.gated_block_layer import (
    gated_block_layer,
    gated_block_layer_reference,
    gated_block_layer_with_sig,
)
from ruvector_tpu_torch.ops.kernels.mincut_gate_block import (
    PROBE_PHASES,
    isolated_sink,
    mincut_gate_block_from_x,
    mincut_gate_block_from_x_reference,
    two_hop_sink,
)
from ruvector_tpu_torch.ops.kernels.neighbor_mix import (
    fused_neighbor_mix,
    fused_neighbor_mix_reference,
    k3_body,
)
from ruvector_tpu_torch.ops.kernels.spmm import (
    rows_per_tile,
    spmm_gather,
    spmm_gather_reference,
    staged_tiles,
)

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


# K1's tensor-core body against its plain version, (max, mean) of the
# absolute error (chip_smoke.py's TOL): bf16 compute, and the float32 grade
# that its 3xTF32 products keep where the attention is exact
K1_BF16_TOL, K1_F32_TOL = (5e-2, 5e-3), (1e-4, 1e-5)


def _within(got, want, tol) -> bool:
    torch.cuda.synchronize()
    assert got.shape == want.shape and torch.isfinite(got.float()).all()
    err = (got.float() - want.float()).abs()
    return float(err.max()) <= tol[0] and float(err.mean()) <= tol[1]


@pytest.mark.parametrize("b, t, d, h, msg_dtype, with_lm", [
    (45, 200, 128, 4, torch.float32, True),
    (45, 200, 128, 1, torch.bfloat16, False),
    (504, 1024, 128, 2, torch.float32, False),
    (504, 1024, 128, 8, torch.bfloat16, True),
    (504, 200, 128, 4, torch.bfloat16, False),
    (512, 512, 128, 4, torch.float32, False),
    (45, 1024, 64, 4, torch.float32, True),
    (504, 200, 64, 8, torch.bfloat16, False),
    (504, 200, 32, 2, torch.bfloat16, True),
    (45, 1024, 32, 1, torch.float32, False),
])
def test_block_dense_layer_fused_tensor_core_body(card, b, t, d, h, msg_dtype, with_lm):
    """K1 at bf16 compute runs its tensor-core body (`k1_body`): ragged B
    (45, 504), T = 200, 512 and 1024, with and without lm, msg in float32
    and bf16, dropout 0.1, a degree-0 row and a 1e-7 edge, D = 128 with
    H in {1, 2, 4, 8} and D = 64 and 32; within the bf16 limits."""
    L, _, _, wd, lm, msg, folded = _block_inputs(card, torch.bfloat16, nb=2, b=b, t=t, d=d,
                                                 h=h)
    lm = lm if with_lm else None
    msg = msg.to(msg_dtype)
    assert k1_body(torch.bfloat16) == "tensor_core"
    got = block_dense_layer_fused(L, msg, wd, folded, lm, dropout=0.1, eps=1e-5)
    assert got.dtype == msg_dtype
    assert _within(got, block_dense_layer_fused_reference(L, msg, wd, folded, lm, dropout=0.1,
                                                          eps=1e-5), K1_BF16_TOL)
    assert launch_counts()["block_dense_layer_fused"] == 1


def _one_edge_inputs(dev, nb=2, b=200, t=256, d=128, h=4):
    """One edge per row with wd = 1.0 and a table of bf16 values: p = 1 and
    the attention's outputs (tv_h = wm = the edge's table row) are exact on
    both sides, so what is left is the epilogue's float32 products."""
    g = torch.Generator().manual_seed(5)
    wd = torch.zeros(nb, b, t)
    wd.scatter_(2, torch.randint(0, t, (nb, b, 1), generator=g), 1.0)
    L = torch.randn(nb, t, d, generator=g).to(torch.bfloat16)
    msg = torch.randn(nb, b, d, generator=g)
    folded = {k: torch.randn(s, generator=g) / d ** 0.5 for k, s in _folded_shapes(h, d).items()}
    return L.to(dev), msg.to(dev), wd.to(dev), {k: v.to(dev) for k, v in folded.items()}


def test_block_dense_layer_fused_is_float32_grade(card):
    """On one-edge rows the tensor-core K1 meets the float32 limits 1e-4 /
    1e-5: its epilogue's products are 3xTF32, float32 grade."""
    L, msg, wd, folded = _one_edge_inputs(card)
    want = block_dense_layer_fused_reference(L, msg, wd, folded, dropout=0.1, eps=1e-5)
    assert _within(block_dense_layer_fused(L, msg, wd, folded, dropout=0.1, eps=1e-5), want,
                   K1_F32_TOL)


def test_block_dense_layer_fused_faults_are_rejected(card):
    """Two faults planted in K1's tensor-core body (test-only instances at
    D=128, H=4): single-pass TF32 misses the float32 limits on one-edge
    rows, and head 0 left out of attn_out misses the bf16 limits."""
    L, msg, wd, folded = _one_edge_inputs(card)
    want = block_dense_layer_fused_reference(L, msg, wd, folded, dropout=0.1, eps=1e-5)
    assert not _within(block_dense_layer_fused(L, msg, wd, folded, dropout=0.1, eps=1e-5,
                                               variant="one_tf32"), want, K1_F32_TOL)
    L, _, _, wd, lm, msg, folded = _block_inputs(card, torch.bfloat16, b=504, t=200, d=128)
    want = block_dense_layer_fused_reference(L, msg, wd, folded, lm, dropout=0.1, eps=1e-5)
    assert _within(block_dense_layer_fused(L, msg, wd, folded, lm, dropout=0.1, eps=1e-5),
                   want, K1_BF16_TOL)
    assert not _within(block_dense_layer_fused(L, msg, wd, folded, lm, dropout=0.1, eps=1e-5,
                                               variant="no_head0"), want, K1_BF16_TOL)
    assert launch_counts()["block_dense_layer_fused"] == 3


def test_block_dense_layer_fused_sweep_bf16_io(card):
    """K1 as the scale sweep's 10M row runs it (chip_smoke.py's
    `[scale_sweep]`): no halo, so the table is the bf16 message rows
    themselves (T == B = 256, the same tensor as msgf), bf16 msg in and
    out, a bf16-valued edge table widened to float32 (16 edges a real row
    within its cluster of 128), and a ragged last block whose last 128
    rows are padding (the message bias, no edge). Within the bf16 limits;
    the pad rows within one bf16 step of the plain version's."""
    g = torch.Generator().manual_seed(3)
    nb, b, d, h, cluster, k = 3, 256, 128, 4, 128, 16
    real = nb * b - cluster
    msg = 0.5 * torch.randn(nb * b, d, generator=g)
    msg[real:] = 0.1 * torch.randn(d, generator=g)
    rows = torch.arange(nb * b)
    start = (rows % b) // cluster * cluster
    pick = torch.rand(nb * b, cluster, generator=g)
    pick[rows, rows % b - start] = -1.0                       # no self edge
    cols = start[:, None] + pick.topk(k, dim=1).indices
    w = torch.rand(nb * b, k, generator=g) + 0.1
    wd = torch.zeros(nb * b, b).scatter_(1, cols, w / w.sum(1, keepdim=True))
    wd[real:] = 0.0
    wd = wd.reshape(nb, b, b).to(torch.bfloat16).float().to(card)
    msgf = msg.reshape(nb, b, d).to(card, torch.bfloat16)
    folded = {key: (0.2 * torch.randn(s, generator=g)).to(card)
              for key, s in _folded_shapes(h, d).items()}
    got = block_dense_layer_fused(msgf, msgf, wd, folded, dropout=0.0, eps=1e-5)
    want = block_dense_layer_fused_reference(msgf, msgf, wd, folded, dropout=0.0, eps=1e-5)
    assert got.dtype == torch.bfloat16
    assert _within(got, want, K1_BF16_TOL)
    pad_got, pad_want = got.reshape(-1, d)[real:].float(), want.reshape(-1, d)[real:].float()
    assert bool(((pad_got - pad_want).abs() <= 2.0 ** -7 * torch.clamp(pad_want.abs(),
                                                                      min=1.0)).all())
    assert launch_counts()["block_dense_layer_fused"] == 1


# K2's tensor-core body: every width and head count, cycling through ragged
# B (45, 504), T not a multiple of the 64-row chunk (200, 1000) and lm
_K2_CASES = [(d, h) + ((45, 200, True), (504, 1000, False), (504, 200, True),
                       (45, 1000, False))[i % 4]
             for i, (d, h) in enumerate((d, h) for d in (32, 64, 128) for h in (1, 2, 4, 8))]


@pytest.mark.parametrize("d, h, b, t, with_lm", _K2_CASES)
def test_block_dense_attention_tensor_core_body(card, d, h, b, t, with_lm):
    """K2 at bf16 compute runs its tensor-core body (`k2_body`) at D in
    {32, 64, 128} and H in {1, 2, 4, 8}: ragged B, T = 200 and 1000, with
    and without lm, a degree-0 row, a 1e-7 edge, and rows of 20-100 edges
    over several 64-row chunks; within the bf16 limits 5e-2 / 5e-3."""
    L, u, sb, wd, lm, _, _ = _block_inputs(card, torch.bfloat16, nb=2, b=b, t=t, d=d, h=h)
    lm = lm if with_lm else None
    assert k2_body(torch.bfloat16) == "tensor_core"
    got = block_dense_attention(L, u, sb, wd, lm, scale=0.25)
    want = block_dense_attention_reference(L, u, sb, wd, lm, scale=0.25)
    assert _within(got, want, K1_BF16_TOL)
    assert float(got[:, 0, 3].abs().max()) == 0.0  # the degree-0 row
    assert launch_counts()["block_dense_attention"] == 1


def test_block_dense_attention_fault_is_rejected(card):
    """The online softmax without its correction exp(m_old - m_new) (a
    test-only instance at D=128, H=4) misses the bf16 limits on rows whose
    edges span several chunks (T=1024), which the exact body meets."""
    L, u, sb, wd, lm, _, _ = _block_inputs(card, torch.bfloat16, nb=2, b=504, t=1024, d=128)
    want = block_dense_attention_reference(L, u, sb, wd, lm, scale=0.25)
    assert _within(block_dense_attention(L, u, sb, wd, lm, scale=0.25), want, K1_BF16_TOL)
    assert not _within(block_dense_attention(L, u, sb, wd, lm, scale=0.25,
                                             variant="no_rescale"), want, K1_BF16_TOL)
    assert launch_counts()["block_dense_attention"] == 2


# K3 against its plain version, (max, mean) of the absolute error: f32 sums
# in another order
K3_TOL = (1e-4, 1e-5)


def _mix_inputs(dev, n, heads, m, d, seed=0):
    g = torch.Generator().manual_seed(seed)
    u, bias, nbr = (torch.randn(s, generator=g).to(dev)
                    for s in ((n, heads, d), (n, heads), (n, m, d)))
    mask = (torch.rand(n, m, generator=g) > 0.3).float().to(dev)
    mask[5] = 0.0
    wnorm = torch.rand(n, m, generator=g).to(dev) * mask
    return u, bias, nbr, mask, wnorm


@pytest.mark.parametrize("n, heads, m, d, body", [
    (4099, 4, 16, 128, "streaming"),   # the main path's widths
    (1001, 4, 13, 96, "streaming"),
    (1001, 1, 13, 96, "streaming"),
    (1001, 2, 16, 64, "streaming"),
    (1001, 8, 16, 128, "streaming"),
    (1001, 8, 5, 32, "streaming"),
    (1001, 16, 13, 96, "warp"),
    (1001, 4, 20, 128, "warp"),
    (1001, 4, 13, 98, "warp"),
])
def test_fused_neighbor_mix_bodies(card, n, heads, m, d, body):
    """Both bodies of K3 (`k3_body`) within the float32 limits 1e-4 /
    1e-5: the streaming body at its limits' edges, the warp body past
    them (16 heads, M > 16, D % 4 != 0)."""
    args = _mix_inputs(card, n, heads, m, d)
    assert k3_body(heads, m, d) == body
    assert _within(fused_neighbor_mix(*args, heads=heads, scale=0.3),
                   fused_neighbor_mix_reference(*args, heads=heads, scale=0.3), K3_TOL)
    assert launch_counts()["fused_neighbor_mix"] == 1


def test_fused_neighbor_mix_fault_is_rejected(card):
    """Slot M-1 left out of every sum (a test-only instance of the
    streaming body at H=4) misses the float32 limits."""
    args = _mix_inputs(card, 4099, 4, 16, 128)
    want = fused_neighbor_mix_reference(*args, heads=4, scale=0.3)
    assert not _within(fused_neighbor_mix(*args, heads=4, scale=0.3, variant="drop_last_slot"),
                       want, K3_TOL)


def test_fused_neighbor_mix_config4_leaf_rows(card):
    """Config 4's held-out re-rank (training/feedback.py): 400 subgraphs of
    40 candidate rows and 320 leaf rows, H 4, M 8, d 64 (the streaming
    body). Every slot of a leaf row is masked and its weights are zero, so
    its masked softmax sees only the -1e30 fill: K3 and its plain version
    must both give exact zeros there, never NaN, and agree within the
    float32 limits elsewhere."""
    queries, ef, m, d, heads = 400, 40, 8, 64, 4
    rows = ef + ef * m
    n = queries * rows
    assert k3_body(heads, m, d) == "streaming"
    u, bias, nbr, mask, wnorm = _mix_inputs(card, n, heads, m, d, seed=4)
    leaf = torch.arange(n, device=card) % rows >= ef
    mask[leaf] = 0.0
    wnorm[leaf] = 0.0
    scale = (d // heads) ** -0.5
    got = fused_neighbor_mix(u, bias, nbr, mask, wnorm, heads=heads, scale=scale)
    want = fused_neighbor_mix_reference(u, bias, nbr, mask, wnorm, heads=heads, scale=scale)
    assert launch_counts()["fused_neighbor_mix"] == 1
    zeros = torch.zeros_like(got[leaf])
    assert torch.equal(got[leaf], zeros) and torch.equal(want[leaf], zeros)
    assert _within(got, want, K3_TOL)


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


@pytest.mark.parametrize("b,d", [(256, 128), (240, 128), (256, 64), (100, 32), (320, 128)])
@pytest.mark.parametrize("compute_bf16", [False, True])
@pytest.mark.parametrize("xdt", [torch.float32, torch.bfloat16])
def test_block_gate_signature_ln_x_kernel(card, xdt, compute_bf16, b, d):
    """Both bodies of K6c (`sig_body`): bf16 compute at B <= 256 on the
    float64 tensor cores (ragged B = 240 and 100, D = 64 and 32), float32
    compute and B in (256, 512] on block_gemm."""
    x, pad, A, (gm, bt), _, _ = _gated_inputs(card, xdt, b=b, d=d, seed=b + d)
    assert sig_body(b, compute_bf16) == ("tensor_core" if compute_bf16 and b <= 256
                                         else "block_gemm")
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
    assert float(rcnt.sum()) > 0


def test_block_gate_signature_fault_is_rejected(card):
    """K6c's tensor-core body with its sums rounded to float32 every four
    products (a planted fault, a test-only instance) misses the plain
    version's row sums at 1e-6 relative on three partitions of config 5's
    widths, while the exact instance meets them."""
    x, pad, A, (gm, bt), _, _ = _gated_inputs(card, torch.float32)
    want_s, want_c = block_gate_signature_ln_x_reference(x, pad, A, gm, bt, eps=0.01,
                                                         compute_bf16=True)

    def agrees(got):
        torch.cuda.synchronize()
        return torch.equal(got[1], want_c) and bool(
            torch.allclose(got[0], want_s, rtol=1e-6, atol=0.0))

    assert agrees(block_gate_signature_ln_x(x, pad, A, gm, bt, eps=0.01, compute_bf16=True))
    assert not agrees(block_gate_signature_ln_x(x, pad, A, gm, bt, eps=0.01, compute_bf16=True,
                                                variant="f32_acc"))


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


def _within(got, want, tol=(5e-2, 5e-3)):
    err = (got.float() - want.float()).abs()
    return float(err.max()) <= tol[0] and float(err.mean()) <= tol[1]


@pytest.mark.parametrize("b,d", [(256, 128), (200, 128), (256, 64), (100, 32), (320, 128)])
def test_gated_block_layer_bf16_bodies(card, b, d):
    """bf16 compute at 5e-2 max / 5e-3 mean against the plain version on
    each body: the tensor-core body at B <= 256 (ragged B = 200 and 100 by
    zero-filled rows and masked stores, D = 64 and 32), block_gemm at B in
    (256, 512]; with a short tail block, a row that keeps nothing and a
    degree-0 row. K4b is K4a then K6c bit for bit, and K4a without one
    head's contribution (a control) must be rejected."""
    x, pad, A, (gm, bt), (keep, wd), folded = _gated_inputs(card, torch.float32, b=b, d=d,
                                                            seed=b + d)
    wd[0, 7] = 0.0
    wd = wd.to(torch.bfloat16)
    assert mha_body(b, True) == ("tensor_core" if b <= 256 else "block_gemm")
    out = gated_block_layer(x, keep, pad, wd, folded, compute_bf16=True)
    want = gated_block_layer_reference(x, keep, pad, wd, folded, compute_bf16=True)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all() and _within(out, want)
    out2, rsum, rcnt = gated_block_layer_with_sig(x, keep, pad, wd, folded, A, gm, bt,
                                                  compute_bf16=True, sig_eps=0.01)
    rs6, rc6 = block_gate_signature_ln_x(out, pad, A, gm, bt, eps=0.01, compute_bf16=True)
    assert torch.equal(out2, out) and torch.equal(rsum, rs6) and torch.equal(rcnt, rc6)
    no_head = dict(folded, Wvo_cat=folded["Wvo_cat"].clone())
    no_head["Wvo_cat"][:, :d] = 0.0
    assert not _within(gated_block_layer(x, keep, pad, wd, no_head, compute_bf16=True), want)
    assert launch_counts()["gated_block_layer"] == 2


@pytest.mark.parametrize("b", [64, 256, 512])
@pytest.mark.parametrize("compute_bf16", [False, True])
@pytest.mark.parametrize("xdt", [torch.float32, torch.bfloat16])
def test_mincut_gate_block_kernel(card, xdt, compute_bf16, b):
    """Both logits of K7 (`gate_body`: the float64 tensor cores for bf16
    compute with LN1 folded in at B <= 256, else block_gemm) and the flow
    on bit-packed residuals: random partitions, partitions that apply a
    cut (isolated sink, without LN; up to B = 256) and partitions whose
    cut reaches its source side in two hops (two_hop_sink, unit LN)."""
    d = 128
    x, pad, A, ln, _, _ = _gated_inputs(card, torch.float32, nb=6, b=b)
    x[2:4] = isolated_sink(x[2:4], 0.1)
    x[4:6] = two_hop_sink(2, b, d, 0.1).to(card)
    pad[2:6] = 1.0
    x = x.to(xdt)
    eye = torch.eye(d, device=card) * 0.1
    unit_ln = (torch.ones(d, device=card), torch.zeros(d, device=card))
    for A_k, ln_k, applies in ((A, ln, None), (eye, None, slice(2, 4) if b <= 256 else None),
                               (eye, unit_ln, slice(4, 6))):
        kp, stats = mincut_gate_block_from_x(x, pad, A_k, lam=0.5, eps=0.01, ln=ln_k,
                                             compute_bf16=compute_bf16)
        want_kp, want_stats = mincut_gate_block_from_x_reference(
            x, pad, A_k, lam=0.5, eps=0.01, ln=ln_k, compute_bf16=compute_bf16)
        torch.cuda.synchronize()
        assert torch.equal(kp, want_kp)
        torch.testing.assert_close(stats[:, 2], want_stats[:, 2], rtol=0, atol=0)
        torch.testing.assert_close(stats[:, 0], want_stats[:, 0], rtol=2e-3, atol=1e-4)
        if applies is not None:
            assert float(stats[applies, 2, 0].min()) == 1.0
    assert launch_counts()["mincut_gate_block_from_x"] == 3


def test_mincut_gate_block_variants(card):
    """The probe instance gives the exact instance's masks and stats with
    each partition's phase cycles; the planted fault (the cut's
    reachability stopped after its first frontier) must be rejected on
    partitions whose source side is two hops deep."""
    b, d = 256, 128
    x = two_hop_sink(3, b, d, 0.1).to(card)
    pad = torch.ones(3, b, device=card)
    eye = torch.eye(d, device=card) * 0.1
    gate = dict(lam=0.5, eps=0.01, ln=(torch.ones(d, device=card), torch.zeros(d, device=card)),
                compute_bf16=True)
    want_kp, want_stats = mincut_gate_block_from_x_reference(x, pad, eye, **gate)
    kp, stats = mincut_gate_block_from_x(x, pad, eye, **gate)
    pkp, pstats, cycles = mincut_gate_block_from_x(x, pad, eye, variant="probe", **gate)
    torch.cuda.synchronize()
    assert torch.equal(kp, want_kp) and float(stats[:, 2, 0].min()) == 1.0
    assert torch.equal(pkp, kp) and torch.equal(pstats, stats)
    assert cycles.shape == (3, len(PROBE_PHASES)) and bool((cycles[:, :6] >= 0).all())
    assert bool((cycles[:, 0] > 0).all()) and bool((cycles[:, 7] >= 2).all())
    bad_kp, bad_stats = mincut_gate_block_from_x(x, pad, eye, variant="reach_one_frontier",
                                                 **gate)
    torch.cuda.synchronize()
    assert not torch.equal(bad_kp, want_kp)
    assert not torch.allclose(bad_stats[:, 0], want_stats[:, 0], rtol=2e-3, atol=1e-4)


def _rel_close(got, want, tol):
    """max |got - want| within tol of want's largest magnitude."""
    torch.cuda.synchronize()
    assert got.shape == want.shape and torch.isfinite(got.float()).all()
    scale = max(float(want.float().abs().max()), 1e-6)
    assert float((got.float() - want.float()).abs().max()) <= tol * scale


def _rel_within(got, want, tol):
    """max and mean |got - want| within tol = (max, mean) of want's
    largest magnitude."""
    torch.cuda.synchronize()
    assert got.shape == want.shape and torch.isfinite(got.float()).all()
    scale = max(float(want.float().abs().max()), 1e-6)
    err = (got.float() - want.float()).abs()
    return float(err.max()) <= tol[0] * scale and float(err.mean()) <= tol[1] * scale


@pytest.mark.parametrize("b,d", [(48, 128), (240, 128), (256, 128), (256, 64), (100, 32),
                                 (320, 128)])
@pytest.mark.parametrize("compute_bf16", [False, True])
@pytest.mark.parametrize("xdt", [torch.float32, torch.bfloat16])
def test_gated_block_attention_kernels(card, xdt, compute_bf16, b, d):
    """K5a and K5b against their plain versions on each body (bf16 compute
    at B <= 256 on the tensor cores, B = 240 padded to 256, B = 48 to 64
    and B = 100 to 128, D = 128, 64 and 32; float32 compute, and bf16 at
    B = 320, on block_gemm): f32 1e-4 of each tensor's scale (sums in
    another order), bf16 5e-2; a short tail block and a row that keeps
    nothing; K5b repeats bit for bit."""
    x, pad, _, _, (keep, _), folded = _gated_inputs(card, xdt, b=b, d=d)
    A_cat, Wvo_cat = folded["A_cat"], folded["Wvo_cat"]
    g = torch.randn(x.shape, generator=torch.Generator().manual_seed(7)).to(card, xdt)
    tol = TOL[torch.bfloat16 if torch.bfloat16 in (xdt,) or compute_bf16 else torch.float32]
    assert mha_body(b, compute_bf16) == ("tensor_core" if compute_bf16 and b <= 256
                                         else "block_gemm")
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


# K5b in bf16 compute against its plain version, (max, mean) of each
# gradient's scale (chip_smoke.py's TOL_F32_GRADE): the mean's limit lies
# between the 3xTF32 body's readings (at most 5.5e-6 here) and single-pass
# TF32's (at least 4.8e-5); PERF.md section 6
F32_GRADE = (2e-3, 2e-5)


def _bwd_f32_grade_inputs(card, b):
    x, pad, _, _, (keep, _), folded = _gated_inputs(card, torch.float32, b=b, seed=b)
    g = torch.randn(x.shape, generator=torch.Generator().manual_seed(11)).to(card)
    return x, keep, pad, folded["A_cat"], folded["Wvo_cat"], g


@pytest.mark.parametrize("b", [240, 256])
def test_gated_block_attention_bwd_is_float32_grade(card, b):
    """bf16 compute on float32 x and cotangent: K5b's dx, dA_cat and
    dWvo_cat within F32_GRADE of each tensor's scale. Both sides round the
    recompute of q, y and s alike, so what is left is the order of the
    sums and, on the tensor cores, the float32 products' emulation
    (3xTF32)."""
    args = _bwd_f32_grade_inputs(card, b)
    got = gated_block_attention_bwd(*args, compute_bf16=True)
    want = gated_block_attention_bwd_reference(*args, compute_bf16=True)
    for a, w in zip(got, want):
        assert _rel_within(a, w, F32_GRADE)
    assert float(got[0][0, 5].abs().max()) > 0.0   # row 5 keeps nothing but is a key of others
    assert float(got[0][-1, b - b // 3:].abs().max()) == 0.0   # pad rows get no gradient


@pytest.mark.parametrize("variant,tol", [("one_tf32", F32_GRADE), ("no_dq_a0", (5e-2, 5e-3))])
@pytest.mark.parametrize("b", [240, 256])
def test_gated_block_attention_bwd_faults_are_rejected(card, b, variant, tol):
    """Controls: K5b's tensor-core body with a planted fault disagrees with
    the plain version. Single-pass TF32 in place of 3xTF32 misses
    F32_GRADE; head 0's dq A_0^T left out of dX misses the bf16
    tolerance."""
    args = _bwd_f32_grade_inputs(card, b)
    dx, dA_p, dW_p = gated_block_attention_bwd_partials(*args, compute_bf16=True,
                                                        variant=variant)
    got = (dx, reduce_partials(dA_p), reduce_partials(dW_p))
    want = gated_block_attention_bwd_reference(*args, compute_bf16=True)
    assert not all(_rel_within(a, w, tol) for a, w in zip(got, want))


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
    # K6a's body follows q's dtype: bf16 on the float64 tensor cores,
    # float32 on block_gemm
    assert sig_body(48, xdt == torch.bfloat16) == \
        ("tensor_core" if xdt == torch.bfloat16 else "block_gemm")
    rsum, rcnt = block_gate_signature(q, x, pad, eps=0.01, scale=0.3)
    want_s, want_c = block_gate_signature_reference(q, x, pad, eps=0.01, scale=0.3)
    torch.cuda.synchronize()
    assert torch.equal(rcnt, want_c) and float(rcnt.sum()) > 0
    torch.testing.assert_close(rsum, want_s, rtol=1e-6, atol=0.0)
    gemm = _signature_qk_block_gemm(q, x, pad, 0.3)
    torch.cuda.synchronize()
    assert all(torch.equal(a, w) for a, w in zip((rsum, rcnt), gemm))
    counts = launch_counts()
    assert counts["block_gate_signature_x"] == 1 and counts["block_gate_signature"] == 2


def _signature_qk_block_gemm(q, k, pad, scale):
    """K6a on its block_gemm body, whatever the shape and dtype."""
    return gated_block_attn._signature_launch(
        block_gate_signature, "block_gate_signature", q, pad, k,
        extra=(int(q.dtype == torch.bfloat16), 0, 0, 0.01, scale))


def _qk_inputs(dev, nb, b, d, seed):
    """bf16 q and k at the scale of the halo layout's projections, a pad
    tail on the last partition."""
    g = torch.Generator().manual_seed(seed)
    q = torch.randn(nb, b, d, generator=g).to(dev, torch.bfloat16)
    k = torch.randn(nb, b, d, generator=g).to(dev, torch.bfloat16)
    pad = torch.ones(nb, b)
    pad[-1, b - b // 3:] = 0.0
    return q, k, pad.to(dev)


@pytest.mark.parametrize("b", [32, 128, 240, 256])
@pytest.mark.parametrize("d", [32, 64, 128])
def test_block_gate_signature_qk_tensor_core_body(card, b, d):
    """K6a at bf16 and B <= 256 runs the float64 tensor-core body
    (`sig_body`): counts equal to the plain version's, sums within 1e-6
    relative, and both bit for bit those of the block_gemm body."""
    q, k, pad = _qk_inputs(card, 5, b, d, seed=b + d)
    scale = 1.0 / (d ** 0.5)
    assert sig_body(b, True) == "tensor_core"
    got = block_gate_signature(q, k, pad, eps=0.01, scale=scale)
    want_s, want_c = block_gate_signature_reference(q, k, pad, eps=0.01, scale=scale)
    torch.cuda.synchronize()
    assert torch.equal(got[1], want_c) and float(want_c.sum()) > 0
    assert float(got[1][pad == 0].sum()) == 0.0
    torch.testing.assert_close(got[0], want_s, rtol=1e-6, atol=0.0)
    gemm = _signature_qk_block_gemm(q, k, pad, scale)
    torch.cuda.synchronize()
    assert all(torch.equal(a, w) for a, w in zip(got, gemm))
    assert launch_counts()["block_gate_signature"] == 2


@pytest.mark.parametrize("b,dtype", [(320, torch.bfloat16), (240, torch.float32)])
def test_block_gate_signature_qk_block_gemm_body(card, b, dtype):
    """float32 q and k, and B > 256, keep block_gemm (`sig_body`), which
    meets the plain version as before; the tensor-core body refuses
    them."""
    q, k, pad = _qk_inputs(card, 3, b, 128, seed=b)
    q, k = q.to(dtype), k.to(dtype)
    assert sig_body(b, dtype == torch.bfloat16) == "block_gemm"
    got = block_gate_signature(q, k, pad, eps=0.01, scale=0.1)
    want_s, want_c = block_gate_signature_reference(q, k, pad, eps=0.01, scale=0.1)
    torch.cuda.synchronize()
    assert torch.equal(got[1], want_c) and float(want_c.sum()) > 0
    torch.testing.assert_close(got[0], want_s, rtol=1e-6, atol=0.0)
    lib = _lib.load("gated_block_attn")
    rc = lib.block_gate_signature(q.data_ptr(), pad.data_ptr(), k.data_ptr(), got[0].data_ptr(),
                                  got[1].data_ptr(), None, q.shape[0], b, 128, 1,
                                  int(dtype == torch.bfloat16), 1, 0, 0.01, 0.1,
                                  _lib.stream_handle(q))
    assert rc != 0


def plant_cancelling_pair(q, k, big=256.0):
    """q and k with columns 0 and D/2 replaced by a cancelling pair of
    large products in every row: q[..., 0] = q[..., D/2] = big, k[..., 0]
    = big and k[..., D/2] = -big. The pair's products sum to 0 exactly,
    while a float32 running sum loses the low bits of the terms it holds
    beside big^2."""
    d = q.shape[-1]
    q, k = q.clone(), k.clone()
    q[..., 0] = big
    q[..., d // 2] = big
    k[..., 0] = big
    k[..., d // 2] = -big
    return q, k


def test_block_gate_signature_qk_fault_is_rejected(card):
    """K6a's tensor-core body with its sums rounded to float32 every four
    products (the planted fault F32ACC) misses the plain version's counts
    and row sums on inputs with a cancelling pair of large products,
    where the exact instance meets them."""
    q, k, pad = _qk_inputs(card, 20, 240, 128, seed=11)
    q, k = plant_cancelling_pair(q, k)
    scale = 1.0 / (32 ** 0.5) / 4
    want_s, want_c = block_gate_signature_reference(q, k, pad, eps=0.01, scale=scale)

    def agrees(got):
        torch.cuda.synchronize()
        return torch.equal(got[1], want_c) and bool(
            torch.allclose(got[0], want_s, rtol=1e-6, atol=0.0))

    assert agrees(block_gate_signature(q, k, pad, eps=0.01, scale=scale))
    assert not agrees(block_gate_signature(q, k, pad, eps=0.01, scale=scale,
                                           variant="f32_acc"))


def _signature_x_block_gemm(x, pad, A):
    """K6b on its block_gemm body at bf16 compute, whatever the shape."""
    return gated_block_attn._signature_launch(
        block_gate_signature_x, "block_gate_signature_x", x, pad, A,
        extra=(int(x.dtype == torch.bfloat16), 1, 0, 0, 0.01))


@pytest.mark.parametrize("xdt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b, d", [(48, 128), (240, 128), (48, 64), (240, 64), (48, 32),
                                  (240, 32)])
def test_block_gate_signature_x_tensor_core_body(card, xdt, b, d):
    """K6b at bf16 compute and B <= 256 runs the float64 tensor-core body
    (`sig_body`; B = 48 padded to 64, the halo layout's B = 240 to 256):
    counts equal to the plain version's, sums within 1e-6 relative, and
    both bit for bit those of the block_gemm body."""
    x, pad, A, _, _, _ = _gated_inputs(card, xdt, b=b, d=d, seed=b + d)
    x = 2.0 * x
    assert sig_body(b, True) == "tensor_core"
    got = block_gate_signature_x(x, pad, A, eps=0.01, compute_bf16=True)
    want_s, want_c = block_gate_signature_x_reference(x, pad, A, eps=0.01, compute_bf16=True)
    torch.cuda.synchronize()
    assert torch.equal(got[1], want_c) and float(want_c.sum()) > 0
    assert float(got[1][pad == 0].sum()) == 0.0
    torch.testing.assert_close(got[0], want_s, rtol=1e-6, atol=0.0)
    gemm = _signature_x_block_gemm(x, pad, A)
    torch.cuda.synchronize()
    assert all(torch.equal(a, w) for a, w in zip(got, gemm))
    assert launch_counts()["block_gate_signature_x"] == 2


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_block_gate_signature_x_fault_is_rejected(card, seed):
    """K6b's tensor-core body with its sums rounded to float32 every four
    products (the planted fault F32ACC, as K6c's) misses the plain
    version's row sums at 1e-6 relative on the halo layout's 500
    partitions of B = 240. The fault moves a row sum only where it flips a
    bf16 rounding of Q, so a few partitions can pass it: every seed here
    covers 120,000 rows."""
    g = torch.Generator().manual_seed(seed)
    nb, b, d = 500, 240, 128
    x = torch.randn(nb, b, d, generator=g).to(card)
    pad = torch.ones(nb, b, device=card)
    pad[-1, b - b // 3:] = 0.0
    A = (torch.randn(d, d, generator=g) * (0.3 / d ** 0.5)).to(card)
    want_s, want_c = block_gate_signature_x_reference(x, pad, A, eps=0.01, compute_bf16=True)

    def agrees(got):
        torch.cuda.synchronize()
        return torch.equal(got[1], want_c) and bool(
            torch.allclose(got[0], want_s, rtol=1e-6, atol=0.0))

    assert agrees(block_gate_signature_x(x, pad, A, eps=0.01, compute_bf16=True))
    assert not agrees(block_gate_signature_x(x, pad, A, eps=0.01, compute_bf16=True,
                                             variant="f32_acc"))


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


@pytest.mark.parametrize("xdt", [torch.float32, torch.bfloat16])
def test_chunked_routes_match_straight(card, monkeypatch, xdt):
    """Config 5's chunked routes through the kernels (gated._CHUNK_NB = 2
    on nB = 5: chunks of 2, 2 and 1) against the straight routes, on f32
    and on bf16 features with bf16 compute: gate_state_init and a drifted
    step bit for bit (K7, K6c, K4b and K4a a chunk), the train loss within
    3e-5 (the JAX chunked tests' limit) and every gradient leaf of the
    whole-model chunked loss against the straight loss under remat, each
    route with the launches its design gives. Gradients: 6e-5 of each
    leaf's scale (the JAX tests' limit) on f32 features; on bf16 features
    the backward's recompute rounds the cotangent of the residual stream
    to bf16 after each sublayer, and a product summed in another order
    (the recompute's products over 1,280 rows straight, over 512 or 256 a
    chunk) may round one bf16 step (2^-8) the other way, which over this
    graph's 1,280 rows moves a weight gradient by up to ~1e-3 of its scale
    (3.0e-4 read on an H100): 2e-3, the bf16 bound of
    tests/test_torch_gated_train.py. Over 1,280,000 rows
    (`chip_smoke.py`'s `[config5_10m]`) the same steps average out and
    6e-5 holds."""
    from ruvector_tpu_torch.graph_transformer import gated

    rng = np.random.default_rng(20)
    n, block, d = 5 * 256, 256, 128
    base = (np.arange(n)[:, None] // block) * block
    idx = (base + rng.integers(0, block, (n, 16))).astype(np.int32)
    ew = rng.uniform(0.1, 1.0, (n, 16)).astype(np.float32)
    bdg = build_block_dense(idx, np.ones((n, 16), np.float32), ew, block=block, device=card)
    assert bdg.table == bdg.block and bdg.n_blocks == 5
    cfg = GatedGraphTransformerConfig(dim=d, num_heads=4, num_layers=2, remat=True,
                                      compute_dtype="bfloat16", hysteresis_band=0.0)
    params = gated_graph_transformer_init(0, cfg, device=card)
    feats = rng.normal(size=(n, d)).astype(np.float32)
    fpad = bdg.pad_features(torch.from_numpy(feats).to(card, xdt))
    drifted = bdg.pad_features(torch.from_numpy(
        feats + 0.3 * rng.normal(size=(n, d)).astype(np.float32)).to(card, xdt))

    def run():
        reset_launch_counts()
        with torch.no_grad():
            st = gate_state_init(params, cfg, fpad, bdg)
            step = gated_graph_transformer_step(params, cfg, drifted, bdg, st)
        counts = launch_counts()
        leaves = [t.clone().requires_grad_(True) for layer in params for t in _leaves(layer)]
        reset_launch_counts()
        loss = gated_graph_transformer_loss_with_masks(_rebuild(params, leaves), cfg, fpad, bdg,
                                                       st["keep"], torch.zeros_like(fpad))
        grads = torch.autograd.grad(loss, leaves)
        torch.cuda.synchronize()
        return st, step, float(loss.detach()), grads, counts, launch_counts()

    st_s, step_s, loss_s, grads_s, serve_s, train_s = run()
    monkeypatch.setattr(gated, "_CHUNK_NB", 2)
    st_c, step_c, loss_c, grads_c, serve_c, train_c = run()
    assert step_c[2] == step_s[2] > 0
    assert torch.equal(step_c[0], step_s[0])
    for k in ("keep", "sig", "age"):
        assert torch.equal(st_c[k], st_s[k]) and torch.equal(step_c[1][k], step_s[1][k]), k
    assert abs(loss_c - loss_s) <= 3e-5 * abs(loss_s)
    for a, w in zip(grads_c, grads_s):
        _rel_close(a, w, 6e-5 if xdt == torch.float32 else 2e-3)
    k7 = serve_s["mincut_gate_block_from_x"]
    assert k7 == serve_c["mincut_gate_block_from_x"] > 2
    assert {k: v for k, v in serve_s.items() if v} == {
        "mincut_gate_block_from_x": k7, "block_gate_signature_ln_x": 3,
        "gated_block_layer": 3, "gated_block_layer_with_sig": 1}
    assert {k: v for k, v in serve_c.items() if v} == {
        "mincut_gate_block_from_x": k7, "block_gate_signature_ln_x": 3,
        "gated_block_layer": 9, "gated_block_layer_with_sig": 3}
    assert {k: v for k, v in train_s.items() if v} == {
        "gated_block_layer": 2, "gated_block_attention_fwd": 2, "gated_block_attention_bwd": 2}
    assert {k: v for k, v in train_c.items() if v} == {
        "gated_block_layer": 12, "gated_block_attention_fwd": 6, "gated_block_attention_bwd": 6}


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


def test_flash_neighbor_attention_takes_bf16_and_bool_mask(card):
    """What the JAX function takes: bf16 q, k and v (widened to float32 for
    the kernel) and a bool mask (cast to float32), against the plain
    version on the same inputs."""
    q, k, v, mask = _k8_inputs(card, 64, 256, 128, True)
    q, k, v, mask = q.bfloat16(), k.bfloat16(), v.bfloat16(), mask > 0
    got = flash_neighbor_attention(q, k, v, mask)
    assert got.dtype == torch.float32 and float(got[3].abs().max()) == 0.0
    _close(got, flash_neighbor_attention_reference(q.float(), k.float(), v.float(),
                                                   mask.float()), torch.float32)
    assert launch_counts()["flash_neighbor_attention"] == 1


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
    for bad, match in (((q.half(), k, v, mask), "float32 or bfloat16"),
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


# K8's and K9's bodies on bulk copies against their plain versions: f32
# sums in another order, (max, mean) of the absolute error
F32_TOL = (1e-4, 1e-5)


def _f32_within(got, want) -> bool:
    torch.cuda.synchronize()
    assert got.shape == want.shape and torch.isfinite(got).all()
    err = (got - want).abs()
    return float(err.max()) <= F32_TOL[0] and float(err.mean()) <= F32_TOL[1]


@pytest.mark.parametrize("b, m, d, masked", [
    (1024, 256, 128, False),   # the re-rank's shape: a persistent grid walking rows
    (1000, 256, 128, True),    # B not a multiple of the grid
    (3, 300, 128, False),      # B smaller than the grid
    (64, 5, 64, False),        # M < KC
    (64, 70, 32, True),        # M not a multiple of KC
    (64, 1, 256, False),       # M = 1
    (40, 96, 256, True),
    (50, 512, 64, True),
])
def test_flash_neighbor_attention_ring(card, b, m, d, masked):
    """The ring of bulk copies at its edges, k is v (one copy a chunk) and
    v = k.clone() (two): both within the float32 limits of the plain
    version and bit-identical to each other (the same arithmetic, only the
    copies differ); a chunk whose keys are all masked among valid ones is
    skipped; two calls repeat bit for bit."""
    q, k, _, mask = _k8_inputs(card, b, m, d, masked, seed=b + m)
    if masked and m > 64:
        mask[:, 32:64] = 0.0                           # a whole chunk masked
    v = k.clone()
    assert (k8_body(k, k), k8_body(k, v)) == ("ring_kv_once", "ring_k_and_v")
    once = flash_neighbor_attention(q, k, k, mask)
    assert _f32_within(once, flash_neighbor_attention_reference(q, k, k, mask))
    assert torch.equal(flash_neighbor_attention(q, k, v, mask), once)
    assert torch.equal(flash_neighbor_attention(q, k, k, mask), once)
    if masked:
        assert float(once[3].abs().max()) == 0.0       # fully masked row
    assert launch_counts()["flash_neighbor_attention"] == 3


def test_flash_neighbor_attention_fault_is_rejected(card):
    """The online softmax without its correction exp(m_old - m_new) (a
    test-only instance at D = 128) misses the float32 limits at the
    re-rank's shape; other widths refuse the variant."""
    q, k, _, _ = _k8_inputs(card, 1024, 256, 128, False, seed=11)
    want = flash_neighbor_attention_reference(q, k, k)
    assert not _f32_within(flash_neighbor_attention(q, k, k, variant="no_rescale"), want)
    q, k, _, _ = _k8_inputs(card, 8, 20, 64, False)
    with pytest.raises(ValueError, match="D=128 only"):
        flash_neighbor_attention(q, k, k, variant="no_rescale")
    assert launch_counts()["flash_neighbor_attention"] == 1


def _k9_inputs(dev, n, b, m, d, kind, cluster=128, seed=0):
    """kind "clustered": row r's neighbours within the `cluster` rows of
    r's cluster (the regular graph's locality), "random": uniform over
    [0, n). Two indices out of range in the first tile. Weights U(0, 1) /
    sqrt(m)."""
    g = torch.Generator().manual_seed(seed)
    if kind == "clustered":
        base = (torch.arange(b)[:, None] // cluster) * cluster
        idx = (base + torch.randint(0, cluster, (b, m), generator=g)) % n
    else:
        idx = torch.randint(0, n, (b, m), generator=g)
    idx = idx.int()
    if m >= 3 and b >= 5:
        idx[1, 2], idx[4, 0] = -3, n + 7
    feats = torch.randn(n, d, generator=g)
    w = torch.rand(b, m, generator=g) / max(m, 1) ** 0.5
    return feats.to(dev), idx.to(dev), w.to(dev)


@pytest.mark.parametrize("n, b, m, d, kind, cluster, staged", [
    (4096, 4096, 16, 128, "clustered", 128, "all"),  # the regular graph's tiles
    (4096, 4000, 16, 128, "random", 128, "none"),    # ragged last tile
    (3000, 1000, 17, 128, "clustered", 128, "some"),  # B != N, 120-row tiles
    (1000, 700, 16, 260, "clustered", 128, "none"),  # 128 rows of 1040 B: over 64 KB
    (1000, 300, 64, 260, "clustered", 32, "all"),    # 32-row tiles and windows
    (1000, 300, 12, 260, "random", 128, "none"),
    (600, 500, 64, 512, "clustered", 32, "all"),
    (600, 500, 16, 512, "clustered", 128, "none"),
    (2000, 64, 40, 32, "clustered", 128, "all"),
    (2000, 1000, 19, 64, "clustered", 64, "all"),   # 2033-edge tiles: words loaded plainly
    (500, 6, 3000, 64, "clustered", 128, "all"),     # a row longer than a batch
])
def test_spmm_gather_tiles(card, n, b, m, d, kind, cluster, staged):
    """K9's tiles, staged (the window of feature rows in shared memory) and
    gathering from device memory, within the float32 limits of the plain
    version, with indices out of range inside a staged tile; two calls
    repeat bit for bit."""
    feats, idx, w = _k9_inputs(card, n, b, m, d, kind, cluster, seed=n + m)
    share = staged_tiles(idx, n, d)
    assert {"all": share == 1.0, "none": share == 0.0, "some": 0.0 < share < 1.0}[staged]
    got = spmm_gather(feats, idx, w)
    assert _f32_within(got, spmm_gather_reference(feats, idx, w))
    assert torch.equal(spmm_gather(feats, idx, w), got)
    assert launch_counts()["spmm_gather"] == 2


def test_spmm_gather_unaligned_index_views(card):
    """Indices and weights that start off a 16-byte line (views one row
    in): the producer warp loads a tile's words plainly, no bulk copy."""
    feats, idx, w = _k9_inputs(card, 2048, 1025, 3, 128, "clustered")
    i2, w2 = idx[1:], w[1:]
    assert i2.data_ptr() % 16 != 0 and i2.is_contiguous()
    assert _f32_within(spmm_gather(feats, i2, w2), spmm_gather_reference(feats, i2, w2))
    assert launch_counts()["spmm_gather"] == 1


def test_spmm_gather_fault_is_rejected(card):
    """Edge M - 1 of each row left out (a test-only instance at D = 128)
    misses the float32 limits on staged tiles; other widths refuse it."""
    feats, idx, w = _k9_inputs(card, 4096, 4096, 16, 128, "clustered")
    assert not _f32_within(spmm_gather(feats, idx, w, variant="drop_last_edge"),
                           spmm_gather_reference(feats, idx, w))
    feats, idx, w = _k9_inputs(card, 100, 50, 4, 64, "random")
    with pytest.raises(ValueError, match="D=128 only"):
        spmm_gather(feats, idx, w, variant="drop_last_edge")
    assert launch_counts()["spmm_gather"] == 1


def test_spmm_gather_rows_per_tile_matches_the_kernel(card):
    lib = _lib.load("spmm_gather")
    for m in (0, 1, 3, 16, 17, 40, 1024, 1025, 2048, 3000):
        assert lib.spmm_gather_rows_per_tile(m) == rows_per_tile(m)
