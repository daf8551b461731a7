"""Shared pieces of the gated graph transformer's kernels, and the
LN-folded gate signature (K6c): wrapper of csrc/gated_block_attn.cu and
its plain PyTorch version.

Port of ruvector_tpu/ops/pallas/gated_block_attn.py: `keep_words` (:44),
the bit unpacking of `_unpack_bits` (:49), with the packing and unpacking
of graph_transformer/gated.py (`pack_keep`/`unpack_keep`, :367-393),
`fold_gated_attention_params` (:526) and `block_gate_signature_ln_x`
(:487). The gated MHA kernel
(K5a/K5b) and the other signature kernels (K6a/K6b) of that file are not
ported yet.

Packed gate masks are int32 words with the JAX layout: row i of a
[B, B] mask lives in word i // 32 at bit i % 32, so a [..., ceil(B/32), B]
int32 tensor holds the same bits as the JAX package's uint32 words (torch
has no shifts or sums on uint32 on the CPU).
"""

from __future__ import annotations

import torch

from ruvector_tpu_torch.ops.kernels import _lib

COMPUTE_DTYPES = (torch.float32, torch.bfloat16)
WIDTHS = (32, 64, 128)
MAX_B = 512     # the largest partition the kernels take (kMaxB, gated_common.cuh)
LN_EPS = 1e-5   # the pre-norm LayerNorms of the gated layer


def keep_words(b: int) -> int:
    """Packed-mask row words for block size b (rows packed 32 per word)."""
    return -(-b // 32)


def pack_keep(keep: torch.Tensor) -> torch.Tensor:
    """[..., B, B] bool -> [..., ceil(B/32), B] int32 (row i in word i // 32,
    bit i % 32)."""
    b = keep.shape[-2]
    w = keep_words(b)
    if w * 32 != b:
        pad = torch.zeros((*keep.shape[:-2], w * 32 - b, keep.shape[-1]),
                          dtype=keep.dtype, device=keep.device)
        keep = torch.cat([keep, pad], dim=-2)
    bits = keep.reshape(*keep.shape[:-2], w, 32, keep.shape[-1]).to(torch.int64)
    shifts = torch.arange(32, device=keep.device, dtype=torch.int64).reshape(32, 1)
    words = torch.sum(bits << shifts, dim=-2)
    # the low 32 bits as a signed word: the same bit pattern as uint32
    return torch.where(words >= 2 ** 31, words - 2 ** 32, words).to(torch.int32)


def unpack_keep(kp: torch.Tensor, b: int | None = None) -> torch.Tensor:
    """Inverse of pack_keep: [..., W, B] int32 -> [..., B, B] bool."""
    w = kp.shape[-2]
    b = kp.shape[-1] if b is None else b
    shifts = torch.arange(32, device=kp.device, dtype=torch.int32).reshape(32, 1)
    bits = (kp[..., :, None, :] >> shifts) & 1
    return bits.reshape(*kp.shape[:-2], w * 32, kp.shape[-1])[..., :b, :] > 0


def as_cdt(x: torch.Tensor, cdt: torch.dtype) -> torch.Tensor:
    """Round to the compute dtype, then widen to float32, so that a float32
    product of two rounded operands equals a bf16 product accumulated in
    float32."""
    return x.to(cdt).float()


def tree_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis (kept, size 1) in the kernels' order: the
    pairwise halving tree x[..., c] + x[..., c + n/2], then again on the
    first half, the axis padded with zeros to a power of two."""
    n = x.shape[-1]
    p = 1 << max(n - 1, 0).bit_length()
    if p != n:
        x = torch.nn.functional.pad(x, (0, p - n))
    while x.shape[-1] > 1:
        h = x.shape[-1] // 2
        x = x[..., :h] + x[..., h:]
    return x


def layer_norm_rows(x, gamma, beta, eps: float = LN_EPS):
    """LayerNorm over the last axis, biased variance, in float32, step for
    step as the kernels compute it (csrc/gated_common.cuh:
    layer_norm_rows), so that both give the same bits: tree sums, then
    (x - mean) / sqrt(var + eps) * gamma + beta, each step rounded."""
    d = x.shape[-1]
    xc = x - tree_sum(x) / d
    var = tree_sum(xc * xc) / d
    return xc / torch.sqrt(var + eps) * gamma.reshape(-1) + beta.reshape(-1)


def matmul_f64(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b with float64 sums rounded once to float32, as the gate
    kernels' products (block_gemm with a float64 accumulator): products
    of float32 values are exact in float64, so the order of the sums
    does not move the float32 result."""
    return torch.matmul(a.double(), b.double()).float()


def fold_gated_attention_params(p: dict, cfg):
    """Head-fold the gated attention weights: A_h = Wq_h Wk_h^T / sqrt(dh)
    and Wvo_h = Wv_h Wo_h, both [H, D, D] float32."""
    d, hh, dh = cfg.dim, cfg.num_heads, cfg.head_dim
    wq = p["wq"].float().reshape(d, hh, dh).permute(1, 0, 2)   # [H, D, dh]
    wk = p["wk"].float().reshape(d, hh, dh).permute(1, 0, 2)
    wv = p["wv"].float().reshape(d, hh, dh).permute(1, 0, 2)
    wo = p["wo"].float().reshape(hh, dh, d)                     # [H, dh, D]
    A = torch.matmul(wq, wk.transpose(1, 2)) * (1.0 / dh ** 0.5)
    Wvo = torch.matmul(wv, wo)
    return A, Wvo


def head_concat(M: torch.Tensor) -> torch.Tensor:
    """[H, D, D] -> [D, H*D]: heads side by side on the output axis."""
    hh, d, _ = M.shape
    return M.permute(1, 0, 2).reshape(d, hh * d).contiguous()


# ---------------------------------------------------------------------------
# K6c: block_gate_signature_ln_x
# ---------------------------------------------------------------------------

def signature_rows(X, pad, A_sig, gamma, beta, *, eps: float, cdt: torch.dtype):
    """Per-row sum and count of the eps-clamped positive pooled logits
    (LN(X) A_sig) LN(X)^T over valid pairs; X is float32 [nB, B, D].
    Products take compute-dtype operands; sums are float64, rounded to
    float32 (matmul_f64), as in the kernels."""
    Hc = as_cdt(layer_norm_rows(X, gamma, beta), cdt)
    qs = matmul_f64(Hc, as_cdt(A_sig, cdt))
    s = matmul_f64(as_cdt(qs, cdt), Hc.transpose(1, 2))
    padf = pad.float()
    pos = (s > eps) & ((padf[:, :, None] * padf[:, None, :]) > 0)
    rsum = torch.sum(torch.where(pos, s, torch.zeros_like(s)), dim=2, dtype=torch.float64)
    return rsum.float(), torch.sum(pos.float(), dim=2)


def block_gate_signature_ln_x_reference(x, pad, A_sig, gamma, beta, *, eps: float,
                                        compute_bf16: bool):
    """Plain PyTorch version of K6c: (rsum, rcnt), each float32 [nB, B]."""
    cdt = torch.bfloat16 if compute_bf16 else torch.float32
    return signature_rows(x.float(), pad, A_sig.float(), gamma.float(), beta.float(),
                          eps=eps, cdt=cdt)


def check_rows(what: str, x, pad, vectors=(), mats=()):
    """Common input checks of the gated kernels' wrappers."""
    _lib.require(x.device.type == "cuda", f"unsupported device {x.device}")
    _lib.require(x.dim() == 3 and x.dtype in COMPUTE_DTYPES,
                 f"{what}: x must be float32 or bfloat16 [nB, B, D]")
    nb, b, d = x.shape
    _lib.require(d in WIDTHS, f"{what}: feature width must be one of {WIDTHS}, got {d}")
    _lib.require(1 <= b <= MAX_B, f"{what}: block size must be 1..{MAX_B}, got {b}")
    _lib.require(pad.dtype == torch.float32 and tuple(pad.shape) == (nb, b),
                 f"{what}: pad must be float32 [nB, B]")
    for v in vectors:
        _lib.require(v.dtype == torch.float32 and v.numel() == d,
                     f"{what}: LayerNorm vectors must be float32 [D]")
    for m in mats:
        _lib.require(m.dtype == torch.float32 and tuple(m.shape) == (d, d),
                     f"{what}: A_sig must be float32 [D, D]")
    for t in (x, pad, *vectors, *mats):
        _lib.require(t.device == x.device, f"{what}: inputs on different devices")
        _lib.require(t.is_contiguous(), f"{what}: inputs must be contiguous")


def persistent_grid(device: torch.device, nb: int, per_sm: int) -> int:
    """CTAs of a persistent launch: each walks blocks k, k + grid, ...
    and owns one slice of the per-CTA scratch."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return max(1, min(nb, sms * per_sm))


SIG_CTAS_PER_SM = 2


def block_gate_signature_ln_x(x, pad, A_sig, gamma, beta, *, eps: float,
                              compute_bf16: bool):
    """Gate-signature reduction straight from the residual stream.

    x [nB, B, D] (float32 or bfloat16), pad [nB, B] float32, A_sig [D, D]
    float32 = Wq Wk^T / (sqrt(dh) H), gamma/beta [D] the LN1 vectors.
    Per block: h = LN(x) (eps 1e-5), s = (h A_sig) h^T with compute-dtype
    operands, and per row the sum and count of s > eps over valid pairs.
    Returns (rsum, rcnt), float32 [nB, B] each. CPU tensors take the
    plain version; CUDA tensors launch the kernel.
    """
    if x.device.type == "cpu":
        return block_gate_signature_ln_x_reference(x, pad, A_sig, gamma, beta, eps=eps,
                                                   compute_bf16=compute_bf16)
    check_rows("block_gate_signature_ln_x", x, pad, (gamma, beta), (A_sig,))
    nb, b, d = x.shape
    rsum = torch.empty((nb, b), dtype=torch.float32, device=x.device)
    rcnt = torch.empty_like(rsum)
    if nb * b == 0:
        return rsum, rcnt
    grid = persistent_grid(x.device, nb, SIG_CTAS_PER_SM)
    scratch = torch.empty(grid * (2 * b * d + b * b), dtype=torch.float32, device=x.device)
    lib = _lib.load("gated_block_attn")
    rc = lib.block_gate_signature_ln_x(
        x.data_ptr(), pad.data_ptr(), A_sig.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
        rsum.data_ptr(), rcnt.data_ptr(), scratch.data_ptr(), nb, b, d, grid,
        int(x.dtype == torch.bfloat16), int(compute_bf16), eps, _lib.stream_handle(x))
    block_gate_signature_ln_x.launches += 1
    _lib.check(lib, rc, "block_gate_signature_ln_x")
    return rsum, rcnt


block_gate_signature_ln_x.launches = 0
