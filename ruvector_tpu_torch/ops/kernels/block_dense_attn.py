"""Block-dense attention (K2) and the fused RuvectorLayer (K1): wrappers of
csrc/block_dense_attn.cu and their plain PyTorch versions.

Ports of ruvector_tpu/ops/pallas/block_dense_attn.py:81
block_dense_attention and :246 block_dense_layer_fused. The JAX `tile`
argument does not carry over: the CUDA kernels pick their own row tile
and mask a ragged block edge themselves, so any B works. K1's `scale` is
dropped too: the folded A and c arrive pre-scaled (fold_layer_params).

bf16 compute (L in bfloat16) rounds where the JAX kernels round: u (K2
input; K1 after M A_h + c_h), the softmax weights before the weights-by-L
product, and wd before wd.L. Sums, GRU and LayerNorm math stay float32
(in K1's tensor-core body, its float32 products run as 3xTF32). Both
kernels have two bodies chosen by compute type (`k1_body`, `k2_body`):
bf16 on the tensor cores, float32 on the CUDA cores.
"""

from __future__ import annotations

import ctypes

import torch

from ruvector_tpu_torch.ops.kernels import _lib

NEG = -1e30
WIDTHS = (32, 64, 128)
HEADS = (1, 2, 4, 8)
COMPUTE_DTYPES = (torch.float32, torch.bfloat16)
FOLDED_KEYS = ("A", "c", "Wvo", "bvo", "bout", "Wagg", "bagg", "w3", "b3", "u2",
               "ub2", "uhk", "uhb", "gamma", "beta")


def _as_cdt(x: torch.Tensor, cdt: torch.dtype) -> torch.Tensor:
    """Round to the compute dtype, then widen to float32 for exact products."""
    return x.to(cdt).float()


def _softmax_weights(s, edge, lm):
    """Masked, max-shifted exp of the scores and the eps-guarded sum."""
    if lm is not None:
        s = s + lm.float()
    s = torch.where(edge, s, torch.full_like(s, NEG))
    smax = torch.clamp(torch.amax(s, dim=-1, keepdim=True), min=NEG)
    p = torch.where(edge, torch.exp(s - smax), torch.zeros_like(s))
    return p, torch.clamp(torch.sum(p, dim=-1, keepdim=True), min=1e-10)


def _check_table(L, wd, lm, nb, b, d, heads):
    _lib.require(L.device.type == "cuda", f"unsupported device {L.device}")
    _lib.require(L.dtype in COMPUTE_DTYPES, f"L must be float32 or bfloat16, got {L.dtype}")
    _lib.require(d in WIDTHS, f"feature width must be one of {WIDTHS}, got {d}")
    _lib.require(heads in HEADS, f"heads must be one of {HEADS}, got {heads}")
    _lib.require(L.dim() == 3 and L.shape[0] == nb and L.shape[2] == d, "L shape")
    t = L.shape[1]
    _lib.require(wd.dtype == torch.float32 and tuple(wd.shape) == (nb, b, t),
                 "wd must be float32 [nB, B, T]")
    _lib.require(lm is None or (lm.dtype == torch.float32 and tuple(lm.shape) == (nb, b, t)),
                 "lm must be float32 [nB, B, T]")
    for x in (L, wd) + (() if lm is None else (lm,)):
        _lib.require(x.device == L.device, "inputs on different devices")
        _lib.require(x.is_contiguous(), "inputs must be contiguous")
    return t


# ---------------------------------------------------------------------------
# K2
# ---------------------------------------------------------------------------

def block_dense_attention_reference(L, u, sb, wd, lm=None, *, scale: float) -> torch.Tensor:
    """Plain PyTorch version of K2: mixed [H+1, nB, B, D] float32."""
    cdt = L.dtype
    heads, nb, b, d = u.shape
    Lf = L.float()
    edge = wd.float() > 0
    out = torch.empty((heads + 1, nb, b, d), dtype=torch.float32, device=L.device)
    for h in range(heads):
        s = torch.matmul(u[h].float(), Lf.transpose(1, 2)) * scale + sb[h].float()[..., None]
        p, denom = _softmax_weights(s, edge, lm)
        out[h] = torch.matmul(_as_cdt(p / denom, cdt), Lf)
    out[heads] = torch.matmul(_as_cdt(wd, cdt), Lf)
    return out


# K2's test-only variant of the tensor-core body (csrc/block_dense_attn.cu,
# built at D = 128 for H = 4 only), a fault that the card tests and
# chip_smoke.py's controls must reject: the online softmax's correction
# exp(m_old - m_new) left out of the aggregate and the sums
K2_VARIANTS = {"exact": 0, "no_rescale": 1}


def k2_body(cdt: torch.dtype) -> str:
    """Which body of K2 runs at compute type `cdt`: "tensor_core" at bf16
    (every width, head count, B and T the kernel takes) or "cuda_core" at
    float32, whose 1e-4 tolerance single-pass TF32 products would break."""
    return "tensor_core" if cdt == torch.bfloat16 else "cuda_core"


def _edge_bits(lib, nb: int, b: int, t: int, device, name: str) -> torch.Tensor:
    """The tensor-core bodies' edge-bit scratch, written and read back in
    one launch."""
    words = lib.block_dense_edge_bits_words(nb, b, t)
    _lib.require(words >= 0, f"{name}: edge-bit scratch too large for {nb} x {b} x {t}")
    return torch.empty(words, dtype=torch.int32, device=device)


def block_dense_attention(L, u, sb, wd, lm=None, *, scale: float,
                          variant: str = "exact") -> torch.Tensor:
    """Fused SDDMM + masked softmax + (H+1)-way aggregate over local tables.

    L [nB, T, D] (compute dtype), u [H, nB, B, D] (same dtype, head-major),
    sb [H, nB, B] float32, wd [nB, B, T] float32 (0 = no edge), lm optional
    [nB, B, T] float32. Returns mixed [H+1, nB, B, D] float32: per-head
    attention values, then the weighted mean. CPU tensors take the plain
    version; CUDA tensors launch the kernel, whose body follows the compute
    type (`k2_body`). `variant` other than "exact" runs a fault planted in
    the tensor-core body (K2_VARIANTS), for controls only.
    """
    name = "block_dense_attention"
    _lib.require(variant in K2_VARIANTS, f"{name}: unknown variant {variant!r}")
    if L.device.type == "cpu":
        _lib.require(variant == "exact", f"{name}: variant {variant!r} runs on the card only")
        return block_dense_attention_reference(L, u, sb, wd, lm, scale=scale)
    heads, nb, b, d = u.shape
    t = _check_table(L, wd, lm, nb, b, d, heads)
    tc = k2_body(L.dtype) == "tensor_core"
    _lib.require(variant == "exact" or (tc and d == 128 and heads == 4),
                 f"{name}: variant {variant!r} is built for the tensor-core body at D=128, "
                 f"H=4 only")
    _lib.require(u.dtype == L.dtype and u.device == L.device and u.is_contiguous(),
                 "u must be contiguous, on L's device, in L's dtype")
    _lib.require(sb.dtype == torch.float32 and tuple(sb.shape) == (heads, nb, b)
                 and sb.device == L.device and sb.is_contiguous(), "sb must be float32 [H, nB, B]")
    out = torch.empty((heads + 1, nb, b, d), dtype=torch.float32, device=L.device)
    if nb * b == 0:
        return out
    lib = _lib.load("block_dense_attn")
    bits = _edge_bits(lib, nb, b, t, L.device, name) if tc else None
    rc = lib.block_dense_attention(
        L.data_ptr(), u.data_ptr(), sb.data_ptr(), wd.data_ptr(),
        None if lm is None else lm.data_ptr(), out.data_ptr(),
        None if bits is None else bits.data_ptr(), nb, b, t, d, heads, int(tc),
        K2_VARIANTS[variant], scale, _lib.stream_handle(L))
    block_dense_attention.launches += 1
    _lib.check(lib, rc, name)
    return out


block_dense_attention.launches = 0


# ---------------------------------------------------------------------------
# K1
# ---------------------------------------------------------------------------

def block_dense_layer_fused_reference(L, msgf, wd, folded, lm=None, *,
                                      dropout: float, eps: float) -> torch.Tensor:
    """Plain PyTorch version of K1: the layer output [nB, B, D] in msgf's dtype."""
    cdt = L.dtype
    f = folded
    Lf = L.float()
    M = msgf.float()
    d = M.shape[-1]
    edge = wd.float() > 0
    attn_out = f["bout"]
    for h in range(f["A"].shape[0]):
        u = torch.matmul(M, f["A"][h]) + f["c"][h]
        s = torch.matmul(_as_cdt(u, cdt), Lf.transpose(1, 2))
        p, denom = _softmax_weights(s, edge, lm)
        tv = torch.matmul(_as_cdt(p, cdt), Lf) / denom
        attn_out = attn_out + torch.matmul(tv, f["Wvo"][h])
    wm = torch.matmul(_as_cdt(wd, cdt), Lf)
    has_any = (torch.sum(edge.float(), dim=-1, keepdim=True) > 0).float()
    attn_out = attn_out + has_any * f["bvo"]
    aggregated = torch.matmul(attn_out + wm, f["Wagg"]) + f["bagg"]
    wx = torch.matmul(aggregated, f["w3"]) + f["b3"]
    uh = torch.matmul(M, f["u2"]) + f["ub2"]
    z = torch.sigmoid(wx[..., :d] + uh[..., :d])
    r = torch.sigmoid(wx[..., d:2 * d] + uh[..., d:])
    h_tilde = torch.tanh(wx[..., 2 * d:] + torch.matmul(r * M, f["uhk"]) + f["uhb"])
    dropped = ((1.0 - z) * M + z * h_tilde) * (1.0 - dropout)

    def ln(x):
        mu = torch.mean(x, dim=-1, keepdim=True)
        var = torch.mean(torch.square(x - mu), dim=-1, keepdim=True)
        return (x - mu) * torch.rsqrt(var + eps) * f["gamma"] + f["beta"]

    return torch.where(has_any > 0, ln(dropped), ln(M)).to(msgf.dtype)


def _folded_shapes(heads: int, d: int) -> dict:
    hdd, dd = (heads, d, d), (d, d)
    return dict(A=hdd, c=(heads, 1, d), Wvo=hdd, bvo=(1, d), bout=(1, d), Wagg=dd,
                bagg=(1, d), w3=(d, 3 * d), b3=(1, 3 * d), u2=(d, 2 * d),
                ub2=(1, 2 * d), uhk=dd, uhb=(1, d), gamma=(1, d), beta=(1, d))


# K1's test-only variants of the tensor-core body (csrc/block_dense_attn.cu,
# built at D = 128 for H = 4 only), faults that the card tests and
# chip_smoke.py's controls must reject: single-pass TF32 in the float32
# products, and head 0's tv_0 Wvo_0 left out of attn_out
K1_VARIANTS = {"exact": 0, "one_tf32": 1, "no_head0": 2}


def k1_body(cdt: torch.dtype) -> str:
    """Which body of K1 runs at compute type `cdt`: "tensor_core" at bf16
    (every width, head count, B and T the kernel takes: the table streams
    in chunks) or "cuda_core" at float32, whose 1e-4 tolerance single-pass
    TF32 products would break."""
    return "tensor_core" if cdt == torch.bfloat16 else "cuda_core"


def block_dense_layer_fused(L, msgf, wd, folded, lm=None, *, dropout: float,
                            eps: float, variant: str = "exact") -> torch.Tensor:
    """One-kernel RuvectorLayer forward over local tables.

    L [nB, T, D] local tables (compute dtype), msgf [nB, B, D] message rows
    (float32, or bfloat16 IO: only the buffers round, the GRU/LayerNorm
    math stays float32), wd [nB, B, T] float32, folded: fold_layer_params
    output (float32), lm optional [nB, B, T] float32. Returns [nB, B, D] in
    msgf's dtype. CPU tensors take the plain version; CUDA tensors launch
    the kernel, whose body follows the compute type (`k1_body`). `variant`
    other than "exact" runs a fault planted in the tensor-core body
    (K1_VARIANTS), for controls only.
    """
    name = "block_dense_layer_fused"
    _lib.require(variant in K1_VARIANTS, f"{name}: unknown variant {variant!r}")
    if L.device.type == "cpu":
        _lib.require(variant == "exact", f"{name}: variant {variant!r} runs on the card only")
        return block_dense_layer_fused_reference(L, msgf, wd, folded, lm,
                                                 dropout=dropout, eps=eps)
    nb, b, d = msgf.shape
    heads = folded["A"].shape[0]
    t = _check_table(L, wd, lm, nb, b, d, heads)
    tc = k1_body(L.dtype) == "tensor_core"
    _lib.require(variant == "exact" or (tc and d == 128 and heads == 4),
                 f"{name}: variant {variant!r} is built for the tensor-core body at D=128, "
                 f"H=4 only")
    _lib.require(msgf.dtype in COMPUTE_DTYPES and msgf.device == L.device
                 and msgf.is_contiguous(), "msgf must be contiguous float32 or bfloat16")
    for key, shape in _folded_shapes(heads, d).items():
        x = folded[key]
        _lib.require(x.dtype == torch.float32 and tuple(x.shape) == shape
                     and x.device == L.device and x.is_contiguous(),
                     f"folded[{key!r}] must be contiguous float32 {shape}")
    out = torch.empty((nb, b, d), dtype=msgf.dtype, device=L.device)
    if nb * b == 0:
        return out
    ptrs = (ctypes.c_void_p * len(FOLDED_KEYS))(
        *(folded[key].data_ptr() for key in FOLDED_KEYS))
    lib = _lib.load("block_dense_attn")
    bits = _edge_bits(lib, nb, b, t, L.device, name) if tc else None
    rc = lib.block_dense_layer_fused(
        L.data_ptr(), msgf.data_ptr(), wd.data_ptr(),
        None if lm is None else lm.data_ptr(), ctypes.addressof(ptrs), out.data_ptr(),
        None if bits is None else bits.data_ptr(), nb, b, t, d, heads,
        int(tc), int(msgf.dtype == torch.bfloat16), K1_VARIANTS[variant], dropout, eps,
        _lib.stream_handle(L))
    block_dense_layer_fused.launches += 1
    _lib.check(lib, rc, name)
    return out


block_dense_layer_fused.launches = 0
