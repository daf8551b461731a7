"""The gated graph transformer's attention and signature kernels, and the
pieces its kernels share: wrappers of csrc/gated_block_mha.cu (the gated
MHA K5a, its recompute backward K5b) and csrc/gated_block_attn.cu (the
gate signatures K6a, K6b and K6c), each with its plain PyTorch version.

Port of ruvector_tpu/ops/pallas/gated_block_attn.py: `keep_words` (:44),
the bit unpacking of `_unpack_bits` (:49), with the packing and unpacking
of graph_transformer/gated.py (`pack_keep`/`unpack_keep`, :367-393),
`gated_block_attention` (:311, the custom_vjp over `_fwd_pallas` :119 and
`_bwd_pallas` :239, here a torch.autograd.Function),
`block_gate_signature` (:362), `block_gate_signature_x` (:423),
`block_gate_signature_ln_x` (:487) and `fold_gated_attention_params`
(:526).

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
NEG = -1e30     # the masked score


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
    float32. A float64 compute dtype (the formula checks of the tests)
    stays float64."""
    return x.to(cdt).to(torch.float64 if cdt == torch.float64 else torch.float32)


def work_dtype(x: torch.Tensor) -> torch.dtype:
    """The plain versions' working precision: float64 for float64 inputs,
    else float32 (the kernels' sums)."""
    return torch.float64 if x.dtype == torch.float64 else torch.float32


def compute_dtype(x: torch.Tensor, compute_bf16: bool) -> torch.dtype:
    return torch.bfloat16 if compute_bf16 else work_dtype(x)


def keep_valid(keep_packed: torch.Tensor, pad: torch.Tensor) -> torch.Tensor:
    """[nB, B, B] bool: the gate bit and the pad pair both set."""
    padf = pad.float()
    return unpack_keep(keep_packed, pad.shape[-1]) & ((padf[:, :, None] * padf[:, None, :]) > 0)


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
# the gate signatures: K6c (LN folded), K6b (from x), K6a (from q and k)
# ---------------------------------------------------------------------------

def positive_rows(s, pad, eps: float):
    """Per-row sum (float64, rounded to float32) and count of the logits
    s [nB, B, B] above eps over valid pairs."""
    padf = pad.float()
    pos = (s > eps) & ((padf[:, :, None] * padf[:, None, :]) > 0)
    rsum = torch.sum(torch.where(pos, s, torch.zeros_like(s)), dim=2, dtype=torch.float64)
    return rsum.float(), torch.sum(pos.float(), dim=2)


def signature_of_rows(Hc, pad, A_sig, *, eps: float, cdt: torch.dtype):
    """positive_rows of (Hc A_sig) Hc^T for rows Hc already rounded to the
    compute dtype: products take compute-dtype operands, sums are float64
    rounded to float32 (matmul_f64), as in the kernels."""
    qs = matmul_f64(Hc, as_cdt(A_sig, cdt))
    return positive_rows(matmul_f64(as_cdt(qs, cdt), Hc.transpose(1, 2)), pad, eps)


def signature_rows(X, pad, A_sig, gamma, beta, *, eps: float, cdt: torch.dtype):
    """Per-row sum and count of the eps-clamped positive pooled logits
    (LN(X) A_sig) LN(X)^T over valid pairs; X is float32 [nB, B, D]."""
    return signature_of_rows(as_cdt(layer_norm_rows(X, gamma, beta), cdt), pad, A_sig,
                             eps=eps, cdt=cdt)


def block_gate_signature_ln_x_reference(x, pad, A_sig, gamma, beta, *, eps: float,
                                        compute_bf16: bool):
    """Plain PyTorch version of K6c: (rsum, rcnt), each float32 [nB, B]."""
    cdt = torch.bfloat16 if compute_bf16 else torch.float32
    return signature_rows(x.float(), pad, A_sig.float(), gamma.float(), beta.float(),
                          eps=eps, cdt=cdt)


def block_gate_signature_x_reference(x, pad, A_sig, *, eps: float, compute_bf16: bool):
    """Plain PyTorch version of K6b: (rsum, rcnt) of (x A_sig) x^T."""
    cdt = torch.bfloat16 if compute_bf16 else torch.float32
    return signature_of_rows(as_cdt(x.float(), cdt), pad, A_sig.float(), eps=eps, cdt=cdt)


def block_gate_signature_reference(q, k, pad, *, eps: float, scale: float):
    """Plain PyTorch version of K6a: (rsum, rcnt) of q k^T * scale, q and k
    as given (float64 sums rounded to float32, then scaled in float32)."""
    return positive_rows(matmul_f64(q.float(), k.float().transpose(1, 2)) * scale, pad, eps)


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
DMMA_MAX_B = 256  # the largest partition of the float64 tensor-core bodies (kDmmaMaxB)
# K6c's, K6b's and K6a's test-only variants of the tensor-core body
# (csrc/gated_block_attn.cu), faults that the card tests and chip_smoke.py's
# controls must reject; built for D = 128 only, on float32 x (K6c, K6b) or
# bf16 q and k (K6a)
SIG_VARIANTS = {"exact": 0, "f32_acc": 1}


def sig_body(b: int, compute_bf16: bool) -> str:
    """Which body of K6c, K6b or K6a runs a partition of b rows:
    "tensor_core" (bf16 compute, b <= DMMA_MAX_B: the logits on the float64
    tensor cores, the partition's rows in shared memory) or "block_gemm"
    (float32 compute, and b in (256, 512], whose bf16 rows and logits do
    not fit in shared memory). K6a's compute type is its q's and k's."""
    return "tensor_core" if compute_bf16 and b <= DMMA_MAX_B else "block_gemm"


def _signature_launch(wrapper, entry, x, pad, *args, extra=(), scratch: bool = True):
    """Allocates (rsum, rcnt) and, with `scratch`, the per-CTA scratch of a
    signature kernel, and launches `entry` (counting the launch on
    `wrapper`): its arguments are x, pad, args, the outputs and scratch,
    nB, B, D, the grid, extra and the stream."""
    nb, b, d = x.shape
    rsum = torch.empty((nb, b), dtype=torch.float32, device=x.device)
    rcnt = torch.empty_like(rsum)
    if nb * b == 0:
        return rsum, rcnt
    grid = persistent_grid(x.device, nb, SIG_CTAS_PER_SM)
    buf = (torch.empty(grid * (2 * b * d + b * b), dtype=torch.float32, device=x.device)
           if scratch else None)
    lib = _lib.load("gated_block_attn")
    rc = getattr(lib, entry)(x.data_ptr(), pad.data_ptr(), *(t.data_ptr() for t in args),
                             rsum.data_ptr(), rcnt.data_ptr(),
                             None if buf is None else buf.data_ptr(), nb, b, d, grid, *extra,
                             _lib.stream_handle(x))
    wrapper.launches += 1
    _lib.check(lib, rc, entry)
    return rsum, rcnt


def _check_variant(name: str, variant: str, x, compute_bf16: bool,
                   variant_dtype: torch.dtype = torch.float32) -> bool:
    """Checks the `variant` of K6c, K6b or K6a (faults run on the card
    only, in the tensor-core body at D=128 on x of `variant_dtype`) and
    returns whether the tensor-core body runs (`sig_body`; False on CPU
    tensors, which take the plain version)."""
    _lib.require(variant in SIG_VARIANTS, f"{name}: unknown variant {variant!r}")
    if x.device.type == "cpu":
        _lib.require(variant == "exact", f"{name}: variant {variant!r} runs on the card only")
        return False
    _, b, d = x.shape
    tc = sig_body(b, compute_bf16) == "tensor_core"
    _lib.require(variant == "exact" or (tc and d == 128 and x.dtype == variant_dtype),
                 f"{name}: variant {variant!r} is built for the tensor-core body at D=128 "
                 f"on {str(variant_dtype).replace('torch.', '')} x only")
    return tc


def block_gate_signature_ln_x(x, pad, A_sig, gamma, beta, *, eps: float,
                              compute_bf16: bool, variant: str = "exact"):
    """Gate-signature reduction straight from the residual stream (K6c).

    x [nB, B, D] (float32 or bfloat16), pad [nB, B] float32, A_sig [D, D]
    float32 = Wq Wk^T / (sqrt(dh) H), gamma/beta [D] the LN1 vectors.
    Per block: h = LN(x) (eps 1e-5), s = (h A_sig) h^T with compute-dtype
    operands, and per row the sum and count of s > eps over valid pairs.
    Returns (rsum, rcnt), float32 [nB, B] each. CPU tensors take the
    plain version; CUDA tensors launch the kernel, whose body follows the
    shape and compute type (`sig_body`). `variant` other than "exact" runs
    a fault planted in the tensor-core body (SIG_VARIANTS), for controls
    only.
    """
    name = "block_gate_signature_ln_x"
    if x.device.type == "cpu":
        _check_variant(name, variant, x, compute_bf16)
        return block_gate_signature_ln_x_reference(x, pad, A_sig, gamma, beta, eps=eps,
                                                   compute_bf16=compute_bf16)
    check_rows(name, x, pad, (gamma, beta), (A_sig,))
    tc = _check_variant(name, variant, x, compute_bf16)
    return _signature_launch(block_gate_signature_ln_x, name, x, pad, A_sig, gamma, beta,
                             extra=(int(x.dtype == torch.bfloat16), int(compute_bf16), int(tc),
                                    SIG_VARIANTS[variant], eps), scratch=not tc)


block_gate_signature_ln_x.launches = 0


def block_gate_signature_x(x, pad, A_sig, *, eps: float, compute_bf16: bool,
                           variant: str = "exact"):
    """Gate-signature reduction from normalized features, no LN (K6b).

    x [nB, B, D] (float32 or bfloat16), pad [nB, B] float32, A_sig [D, D]
    float32. Per block s = (x A_sig) x^T with compute-dtype operands, and
    per row the sum and count of s > eps over valid pairs. Returns (rsum,
    rcnt), float32 [nB, B] each. CPU tensors take the plain version; CUDA
    tensors launch the kernel, whose body follows the shape and compute
    type (`sig_body`, as K6c's). `variant` other than "exact" runs a fault
    planted in the tensor-core body (SIG_VARIANTS), for controls only.
    """
    name = "block_gate_signature_x"
    if x.device.type == "cpu":
        _check_variant(name, variant, x, compute_bf16)
        return block_gate_signature_x_reference(x, pad, A_sig, eps=eps,
                                                compute_bf16=compute_bf16)
    check_rows(name, x, pad, (), (A_sig,))
    tc = _check_variant(name, variant, x, compute_bf16)
    return _signature_launch(block_gate_signature_x, name, x, pad, A_sig,
                             extra=(int(x.dtype == torch.bfloat16), int(compute_bf16), int(tc),
                                    SIG_VARIANTS[variant], eps), scratch=not tc)


block_gate_signature_x.launches = 0


def block_gate_signature(q, k, pad, *, eps: float, scale: float, variant: str = "exact"):
    """Gate-signature reduction from projected features (K6a).

    q, k [nB, B, D] of one dtype (float32 or bfloat16), pad [nB, B]
    float32. Per block s = q k^T * scale, and per row the sum and count of
    s > eps over valid pairs. Returns (rsum, rcnt), float32 [nB, B] each.
    CPU tensors take the plain version; CUDA tensors launch the kernel,
    whose body follows the shape and q's dtype (`sig_body`: bf16 q and k
    at B <= 256 on the float64 tensor cores). `variant` other than
    "exact" runs a fault planted in the tensor-core body (SIG_VARIANTS, on
    bf16 q and k), for controls only.
    """
    name = "block_gate_signature"
    bf16 = q.dtype == torch.bfloat16
    if q.device.type == "cpu":
        _check_variant(name, variant, q, bf16, torch.bfloat16)
        return block_gate_signature_reference(q, k, pad, eps=eps, scale=scale)
    check_rows(name, q, pad)
    _lib.require(k.dtype == q.dtype and k.shape == q.shape and k.device == q.device
                 and k.is_contiguous(), "block_gate_signature: k must be like q")
    tc = _check_variant(name, variant, q, bf16, torch.bfloat16)
    return _signature_launch(block_gate_signature, name, q, pad, k,
                             extra=(int(bf16), int(tc), SIG_VARIANTS[variant], eps, scale),
                             scratch=not tc)


block_gate_signature.launches = 0


# ---------------------------------------------------------------------------
# K5a / K5b: the gated MHA and its recompute backward
# ---------------------------------------------------------------------------

def gated_mha_reference(hc, keepb, pad, A_cat, Wvo_cat, cdt):
    """Gated MHA of one layer: hc [nB, B, D] (values already in the
    compute dtype), keepb [nB, B, B] bool (kept and pad-valid). Per head:
    s = (hc A_h) hc^T, masked exp against the row max, and the un-normalised
    weights times hc Wvo_h scaled by 1 / sum; rows with nothing kept
    give 0. Returns the sum over heads (before the pad factor), float32
    (float64 for a float64 compute dtype)."""
    d = hc.shape[-1]
    q = torch.matmul(hc, as_cdt(A_cat, cdt))
    y = torch.matmul(hc, as_cdt(Wvo_cat, cdt))
    attn = torch.zeros_like(hc)
    for h in range(A_cat.shape[1] // d):
        s = torch.matmul(as_cdt(q[..., h * d:(h + 1) * d], cdt), hc.transpose(1, 2))
        s = torch.where(keepb, s, torch.full_like(s, NEG))
        smax = torch.amax(s, dim=-1, keepdim=True)
        pu = torch.exp(s - torch.clamp(smax, min=NEG))
        inv = torch.where(smax > -1e29,
                          1.0 / torch.clamp(torch.sum(pu, dim=-1, keepdim=True), min=1e-10),
                          torch.zeros_like(smax))
        attn = attn + torch.matmul(as_cdt(pu, cdt),
                                   as_cdt(y[..., h * d:(h + 1) * d], cdt)) * inv
    return attn


def gated_block_attention_fwd_reference(x, keep_packed, pad, A_cat, Wvo_cat, *,
                                        compute_bf16: bool):
    """Plain PyTorch version of K5a: [nB, B, D] in x's dtype."""
    cdt = compute_dtype(x, compute_bf16)
    attn = gated_mha_reference(as_cdt(x, cdt), keep_valid(keep_packed, pad), pad, A_cat,
                               Wvo_cat, cdt)
    return (attn * pad[..., None].to(attn.dtype)).to(x.dtype)


def gated_block_attention_bwd_reference(x, keep_packed, pad, A_cat, Wvo_cat, g, *,
                                        compute_bf16: bool):
    """Plain PyTorch version of K5b, step for step as the TPU kernel
    (gated_block_attn.py:154-236): the scores recomputed with
    compute-dtype operands, every product of the backward proper in
    float32 (float64 for float64 inputs). Returns (dx in x's dtype, dA_cat,
    dWvo_cat)."""
    wdt = work_dtype(x)
    cdt = compute_dtype(x, compute_bf16)
    X = x.to(wdt)
    d = X.shape[-1]
    keepb = keep_valid(keep_packed, pad)
    G = g.to(wdt) * pad[..., None].to(wdt)
    Xc = as_cdt(X, cdt)
    q = torch.matmul(Xc, as_cdt(A_cat, cdt))
    y = torch.matmul(Xc, as_cdt(Wvo_cat, cdt))
    dX = torch.zeros_like(X)
    dq_parts, dy_parts = [], []
    for h in range(A_cat.shape[1] // d):
        q_h, y_h = q[..., h * d:(h + 1) * d], y[..., h * d:(h + 1) * d]
        s = torch.matmul(as_cdt(q_h, cdt), Xc.transpose(1, 2))
        s = torch.where(keepb, s, torch.full_like(s, NEG))
        smax = torch.clamp(torch.amax(s, dim=-1, keepdim=True), min=NEG)
        pu = torch.where(keepb, torch.exp(s - smax), torch.zeros_like(s))
        p = pu / torch.clamp(torch.sum(pu, dim=-1, keepdim=True), min=1e-10)
        dp = torch.matmul(G, y_h.transpose(1, 2))
        dy_parts.append(torch.matmul(p.transpose(1, 2), G))
        ds = p * (dp - torch.sum(dp * p, dim=-1, keepdim=True))
        dq_parts.append(torch.matmul(ds, X))
        dX = dX + torch.matmul(ds.transpose(1, 2), q_h)
    dQ, dY = torch.cat(dq_parts, dim=-1), torch.cat(dy_parts, dim=-1)
    A, W = A_cat.to(wdt), Wvo_cat.to(wdt)
    dA = torch.einsum("nbd,nbe->de", X, dQ)
    dW = torch.einsum("nbd,nbe->de", X, dY)
    dX = dX + torch.matmul(dQ, A.T) + torch.matmul(dY, W.T)
    return dX.to(x.dtype), dA, dW


TC_MAX_B = 256   # the largest partition of the tensor-core bodies (kTcMaxB, gated_tc.cuh)
MHA_FWD_CTAS_PER_SM = {"tensor_core": 1, "block_gemm": 2}
MHA_BWD_CTAS_PER_SM = 1


def mha_body(b: int, compute_bf16: bool) -> str:
    """Which body of K5a/K5b runs a partition of b rows: "tensor_core"
    (bf16 compute, b <= TC_MAX_B) or "block_gemm" (float32 compute, whose
    1e-4 tolerance single-pass TF32 would break, and b in (256, 512],
    whose rows do not fit in shared memory)."""
    return "tensor_core" if compute_bf16 and b <= TC_MAX_B else "block_gemm"


def head_tiles(m: torch.Tensor, d: int) -> torch.Tensor:
    """[D, n*D] with n [in, out] blocks side by side -> [n, D, D]."""
    return m.reshape(d, -1, d).permute(1, 0, 2)


def mha_tiles(A_cat: torch.Tensor, Wvo_cat: torch.Tensor, d: int) -> torch.Tensor:
    """The tensor-core bodies' weights: bf16 [2H, D, D] tiles A_0..A_{H-1},
    Wvo_0..Wvo_{H-1}, each [in, out] and rounded to nearest even as a bf16
    product's operand."""
    return torch.cat([head_tiles(A_cat, d), head_tiles(Wvo_cat, d)]).to(
        torch.bfloat16).contiguous()


def _check_mha(name, x, keep_packed, pad, A_cat, Wvo_cat, g=None):
    check_rows(name, x, pad)
    nb, b, d = x.shape
    for key, m in (("A_cat", A_cat), ("Wvo_cat", Wvo_cat)):
        _lib.require(m.dtype == torch.float32 and m.dim() == 2 and m.shape[0] == d
                     and m.shape[1] >= d and m.shape[1] % d == 0 and m.shape == A_cat.shape
                     and m.device == x.device and m.is_contiguous(),
                     f"{name}: {key} must be contiguous float32 [D, H*D]")
    _lib.require(keep_packed.dtype == torch.int32
                 and tuple(keep_packed.shape) == (nb, keep_words(b), b)
                 and keep_packed.device == x.device and keep_packed.is_contiguous(),
                 f"{name}: keep must be contiguous int32 [nB, ceil(B/32), B]")
    if g is not None:
        _lib.require(g.dtype == x.dtype and g.shape == x.shape and g.device == x.device
                     and g.is_contiguous(), f"{name}: the cotangent must be like x")


def gated_block_attention_fwd(x, keep_packed, pad, A_cat, Wvo_cat, *, compute_bf16: bool):
    """Gated MHA per partition (K5a).

    x [nB, B, D] pre-norm features (float32 or bfloat16; the output
    follows), keep_packed [nB, ceil(B/32), B] int32 gate words, pad [nB, B]
    float32, A_cat/Wvo_cat [D, H*D] float32, the heads' A_h = Wq_h Wk_h^T /
    sqrt(dh) and Wvo_h = Wv_h Wo_h side by side (head_concat). Returns
    [nB, B, D] in x's dtype. CPU tensors take the plain version; CUDA
    tensors launch the kernel, whose body follows the shape: bf16 compute
    at B <= 256 on the tensor cores, else block_gemm (`mha_body`).
    """
    if x.device.type == "cpu":
        return gated_block_attention_fwd_reference(x, keep_packed, pad, A_cat, Wvo_cat,
                                                   compute_bf16=compute_bf16)
    name = "gated_block_attention_fwd"
    _check_mha(name, x, keep_packed, pad, A_cat, Wvo_cat)
    nb, b, d = x.shape
    out = torch.empty_like(x)
    if nb * b == 0:
        return out
    body = mha_body(b, compute_bf16)
    grid = persistent_grid(x.device, nb, MHA_FWD_CTAS_PER_SM[body])
    tiles = mha_tiles(A_cat, Wvo_cat, d) if body == "tensor_core" else None
    lib = _lib.load("gated_block_mha")
    scratch = _mha_scratch(lib, True, body, x, grid)
    rc = lib.gated_block_mha_fwd(
        x.data_ptr(), keep_packed.data_ptr(), pad.data_ptr(), A_cat.data_ptr(),
        Wvo_cat.data_ptr(), None if tiles is None else tiles.data_ptr(), out.data_ptr(),
        scratch.data_ptr(), nb, b, d, A_cat.shape[1] // d, grid,
        int(x.dtype == torch.bfloat16), int(compute_bf16), _lib.stream_handle(x))
    gated_block_attention_fwd.launches += 1
    _lib.check(lib, rc, name)
    return out


gated_block_attention_fwd.launches = 0


def _mha_scratch(lib, fwd: bool, body: str, x: torch.Tensor, grid: int) -> torch.Tensor:
    """The float32 scratch of K5a (fwd) or K5b: grid times the floats each
    block of `body` owns, as the kernel source counts them."""
    _, b, d = x.shape
    per_block = lib.gated_block_mha_scratch_floats(int(fwd), int(body == "tensor_core"), b, d,
                                                   int(x.dtype == torch.bfloat16))
    _lib.require(per_block > 0, f"gated_block_mha: no {body} body for B={b}, D={d}")
    return torch.empty(grid * per_block, dtype=torch.float32, device=x.device)


# K5b's test-only variants of the tensor-core body (BwdVariant,
# csrc/gated_block_mha.cu), faults that the card tests and chip_smoke.py's
# controls must reject; built for D = 128 on float32 x only
MHA_BWD_VARIANTS = {"exact": 0, "one_tf32": 1, "no_dq_a0": 2}


def reduce_partials(parts: torch.Tensor) -> torch.Tensor:
    """parts [C, ...] float32 on the card -> their sum over C, taken in
    order c = 0, 1, ... by a kernel (K5b's second pass: no float atomics,
    so the sum repeats bit for bit)."""
    _lib.require(parts.device.type == "cuda" and parts.dtype == torch.float32
                 and parts.is_contiguous(), "reduce_partials: contiguous float32 on the card")
    out = torch.empty(parts.shape[1:], dtype=torch.float32, device=parts.device)
    lib = _lib.load("gated_block_mha")
    _lib.check(lib, lib.reduce_partials(parts.data_ptr(), parts.shape[0], out.numel(),
                                        out.data_ptr(), _lib.stream_handle(parts)),
               "reduce_partials")
    return out


def gated_block_attention_bwd_partials(x, keep_packed, pad, A_cat, Wvo_cat, g, *,
                                       compute_bf16: bool, variant: str = "exact"):
    """K5b's first pass on the card: (dx, dA partials, dWvo partials), the
    partials [C, D, H*D] float32 with one slice per block of the
    persistent grid (block c holds partitions c, c + C, ...). `variant`
    other than "exact" runs a fault planted in the tensor-core body
    (MHA_BWD_VARIANTS), for controls only."""
    name = "gated_block_attention_bwd"
    _check_mha(name, x, keep_packed, pad, A_cat, Wvo_cat, g)
    nb, b, d = x.shape
    dx = torch.empty_like(x)
    grid = persistent_grid(x.device, max(nb, 1), MHA_BWD_CTAS_PER_SM)
    dA_parts = torch.zeros((grid, *A_cat.shape), dtype=torch.float32, device=x.device)
    dW_parts = torch.zeros_like(dA_parts)
    if nb * b == 0:
        return dx, dA_parts, dW_parts
    body = mha_body(b, compute_bf16)
    _lib.require(variant in MHA_BWD_VARIANTS
                 and (variant == "exact" or (body == "tensor_core" and d == 128
                                             and x.dtype == torch.float32)),
                 f"{name}: variant {variant!r} is built for the tensor-core body at D=128 "
                 f"on float32 x only")
    tiles = mha_tiles(A_cat, Wvo_cat, d) if body == "tensor_core" else None
    lib = _lib.load("gated_block_mha")
    scratch = _mha_scratch(lib, False, body, x, grid)
    rc = lib.gated_block_mha_bwd(
        x.data_ptr(), keep_packed.data_ptr(), pad.data_ptr(), A_cat.data_ptr(),
        Wvo_cat.data_ptr(), None if tiles is None else tiles.data_ptr(), g.data_ptr(),
        dx.data_ptr(), dA_parts.data_ptr(),
        dW_parts.data_ptr(), scratch.data_ptr(), nb, b, d, A_cat.shape[1] // d, grid,
        int(x.dtype == torch.bfloat16), int(compute_bf16), MHA_BWD_VARIANTS[variant],
        _lib.stream_handle(x))
    gated_block_attention_bwd.launches += 1
    _lib.check(lib, rc, name)
    return dx, dA_parts, dW_parts


def gated_block_attention_bwd(x, keep_packed, pad, A_cat, Wvo_cat, g, *, compute_bf16: bool):
    """Recompute backward of K5a (K5b): the cotangent g [nB, B, D] (x's
    dtype) -> (dx in x's dtype, dA_cat, dWvo_cat float32 [D, H*D] summed
    over every partition). CPU tensors take the plain version; CUDA
    tensors launch the kernel and the fixed-order reduction of its
    per-block partials."""
    if x.device.type == "cpu":
        return gated_block_attention_bwd_reference(x, keep_packed, pad, A_cat, Wvo_cat, g,
                                                   compute_bf16=compute_bf16)
    dx, dA_parts, dW_parts = gated_block_attention_bwd_partials(
        x, keep_packed, pad, A_cat, Wvo_cat, g, compute_bf16=compute_bf16)
    return dx, reduce_partials(dA_parts), reduce_partials(dW_parts)


gated_block_attention_bwd.launches = 0


class GatedBlockAttention(torch.autograd.Function):
    """K5a forward, K5b backward (the JAX package's custom_vjp,
    gated_block_attn.py:284-307): dx in x's dtype and dA_cat/dWvo_cat;
    no gradient for the integer gate words, zeros for pad (a gate)."""

    @staticmethod
    def forward(ctx, x, keep_packed, pad, A_cat, Wvo_cat, compute_bf16):
        ctx.compute_bf16 = compute_bf16
        ctx.save_for_backward(x, keep_packed, pad, A_cat, Wvo_cat)
        return gated_block_attention_fwd(x, keep_packed, pad, A_cat, Wvo_cat,
                                         compute_bf16=compute_bf16)

    @staticmethod
    def backward(ctx, g):
        x, keep_packed, pad, A_cat, Wvo_cat = ctx.saved_tensors
        dx, dA, dW = gated_block_attention_bwd(x, keep_packed, pad, A_cat, Wvo_cat,
                                               g.to(x.dtype).contiguous(),
                                               compute_bf16=ctx.compute_bf16)
        return dx, None, torch.zeros_like(pad), dA.to(A_cat.dtype), dW.to(Wvo_cat.dtype), None


def gated_block_attention(x, keep_packed, pad, A, Wvo, *, compute_bf16: bool):
    """Per-partition gated MHA over the block-dense layout, differentiable.

    x [nB, B, D] pre-norm features, keep_packed [nB, ceil(B/32), B] int32,
    pad [nB, B] float32, A/Wvo [H, D, D] (fold_gated_attention_params).
    The heads are concatenated outside the autograd Function, as in the
    JAX package, so autograd maps the [D, H*D] gradients back to [H, D, D].
    Returns [nB, B, D] in x's dtype.
    """
    return GatedBlockAttention.apply(x, keep_packed, pad, head_concat(A), head_concat(Wvo),
                                     compute_bf16)
