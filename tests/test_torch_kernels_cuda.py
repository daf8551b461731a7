"""Each CUDA kernel against its plain PyTorch version, on the card.

Marked `cuda`: without a card every test skips. The JAX package is not
needed (nor installed) on the card's machine, so run them without the
test directory's conftest, which imports jax:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

Tolerances (max abs error on outputs of order 1): f32 1e-4, sums in
another order; bf16 5e-2, the kernels round softmax weights against a
running max where the plain versions use the row max.
"""

import pytest
import torch

from ruvector_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
from ruvector_tpu_torch.ops.kernels.block_dense_attn import (
    _folded_shapes,
    block_dense_attention,
    block_dense_attention_reference,
    block_dense_layer_fused,
    block_dense_layer_fused_reference,
)
from ruvector_tpu_torch.ops.kernels.neighbor_mix import (
    fused_neighbor_mix,
    fused_neighbor_mix_reference,
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
