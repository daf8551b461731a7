"""The fused gated graph-transformer layer (K4a) and its variant that also
emits the next layer's gate signature (K4b): wrappers of
csrc/gated_block_layer.cu and their plain PyTorch versions.

Ports of ruvector_tpu/ops/pallas/gated_block_layer.py:195
gated_block_layer and :251 gated_block_layer_with_sig. On a halo-free
block layout (local table == block) every sublayer is block-local, so one
pass per block computes

    h  = LN1(x);  x += gated-MHA(h)         (keep & pad-masked softmax)
    g  = LN_g(x); x += ((wd g) Wg + bg) * pad
    h2 = LN2(x);  x += (gelu_tanh(h2 Wi + bi) Wo + bo) * pad

and K4b then reduces the next layer's (rsum, rcnt) from the output,
rounded through the IO dtype first. In bf16 compute mode every product
takes bf16 operands with float32 sums; the residual stream stays float32
inside and is rounded once at the output.

The kernel has two bodies, chosen here on shape and compute type by the
gated MHA's rule (`mha_body`): bf16 compute at B <= 256 runs every
product on the tensor cores (mma.sync) with the partition's operands in
shared memory, taking the weights as bf16 [D, D] tiles (`weight_tiles`);
float32 compute, and bf16 at B in (256, 512], whose rows and weight tiles
do not fit in shared memory, run the float32-FMA block_gemm body. The wrappers are forward-only
(they raise on inputs that require grad); the fused layer's gradient is
graph_transformer/gated.py's autograd Function, whose backward recomputes
the sublayer composition with the gated MHA kernels (K5a/K5b) inside, as
the JAX package's custom_vjp does.
"""

from __future__ import annotations

import ctypes

import torch

from ruvector_tpu_torch.ops.kernels import _lib
from ruvector_tpu_torch.ops.kernels.gated_block_attn import (
    LN_EPS,
    as_cdt,
    check_rows,
    fold_gated_attention_params,
    gated_mha_reference,
    head_concat,
    head_tiles,
    keep_valid,
    keep_words,
    layer_norm_rows,
    mha_body,
    persistent_grid,
    signature_rows,
)

FOLDED_KEYS = ("A_cat", "Wvo_cat", "ln1_g", "ln1_b", "lng_g", "lng_b", "ln2_g", "ln2_b",
               "Wg", "bg", "Wi", "bi", "Wo", "bo")
HEADS = (1, 2, 4, 8)
LAYER_CTAS_PER_SM = {"tensor_core": 1, "block_gemm": 2}


def fold_gated_layer_params(p: dict, cfg) -> dict:
    """Fold one gated layer's parameters for the fused kernel: A_cat and
    Wvo_cat [D, H*D] (fold_gated_attention_params, heads side by side),
    the LayerNorm rows and bias rows as [1, dim], W_gnn and the FFN
    kernels [in, out]. All float32 and contiguous."""
    A, Wvo = fold_gated_attention_params(p, cfg)

    def row(v):
        return v.float().reshape(1, -1).contiguous()

    def mat(v):
        return v.float().contiguous()

    return {
        "A_cat": head_concat(A), "Wvo_cat": head_concat(Wvo),
        "ln1_g": row(p["ln1"]["gamma"]), "ln1_b": row(p["ln1"]["beta"]),
        "lng_g": row(p["ln_g"]["gamma"]), "lng_b": row(p["ln_g"]["beta"]),
        "ln2_g": row(p["ln2"]["gamma"]), "ln2_b": row(p["ln2"]["beta"]),
        "Wg": mat(p["w_gnn"]["kernel"]), "bg": row(p["w_gnn"]["bias"]),
        "Wi": mat(p["ffn_in"]["kernel"]), "bi": row(p["ffn_in"]["bias"]),
        "Wo": mat(p["ffn_out"]["kernel"]), "bo": row(p["ffn_out"]["bias"]),
    }


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """GELU, tanh approximation (jax.nn.gelu's default)."""
    return torch.nn.functional.gelu(x, approximate="tanh")


def _layer_reference(x, keep_packed, pad, wdense, f, ln_eps, compute_bf16):
    """K4's residual stream after the three sublayers, float32."""
    cdt = torch.bfloat16 if compute_bf16 else torch.float32
    X = x.float()
    padf = pad.float()
    padc = padf[:, :, None]
    keepb = keep_valid(keep_packed, pad)
    hc = as_cdt(layer_norm_rows(X, f["ln1_g"], f["ln1_b"], ln_eps), cdt)
    X = X + gated_mha_reference(hc, keepb, padf, f["A_cat"], f["Wvo_cat"], cdt) * padc
    g1 = layer_norm_rows(X, f["lng_g"], f["lng_b"], ln_eps)
    agg = torch.matmul(as_cdt(wdense, cdt), as_cdt(g1, cdt))
    mix = torch.matmul(as_cdt(agg, cdt), as_cdt(f["Wg"], cdt)) + f["bg"].reshape(-1)
    X = X + mix * padc
    h2 = layer_norm_rows(X, f["ln2_g"], f["ln2_b"], ln_eps)
    mid = gelu_tanh(torch.matmul(as_cdt(h2, cdt), as_cdt(f["Wi"], cdt)) + f["bi"].reshape(-1))
    ff = torch.matmul(as_cdt(mid, cdt), as_cdt(f["Wo"], cdt)) + f["bo"].reshape(-1)
    return X + ff * padc


def gated_block_layer_reference(x, keep_packed, pad, wdense, folded, *,
                                ln_eps: float = LN_EPS, compute_bf16: bool):
    """Plain PyTorch version of K4a: [nB, B, D] in x's dtype."""
    return _layer_reference(x, keep_packed, pad, wdense, folded, ln_eps,
                            compute_bf16).to(x.dtype)


def gated_block_layer_with_sig_reference(x, keep_packed, pad, wdense, folded, A_sig_next,
                                         sig_gamma, sig_beta, *, ln_eps: float = LN_EPS,
                                         compute_bf16: bool, sig_eps: float):
    """Plain PyTorch version of K4b: (out, rsum, rcnt)."""
    out = gated_block_layer_reference(x, keep_packed, pad, wdense, folded, ln_eps=ln_eps,
                                      compute_bf16=compute_bf16)
    cdt = torch.bfloat16 if compute_bf16 else torch.float32
    rsum, rcnt = signature_rows(out.float(), pad, A_sig_next.float(), sig_gamma.float(),
                                sig_beta.float(), eps=sig_eps, cdt=cdt)
    return out, rsum, rcnt


def _folded_shapes(heads: int, d: int, fm: int) -> dict:
    row = (1, d)
    return {"A_cat": (d, heads * d), "Wvo_cat": (d, heads * d), "ln1_g": row, "ln1_b": row,
            "lng_g": row, "lng_b": row, "ln2_g": row, "ln2_b": row, "Wg": (d, d), "bg": row,
            "Wi": (d, fm * d), "bi": (1, fm * d), "Wo": (fm * d, d), "bo": row}


def weight_tiles(folded: dict, heads: int, fm: int, d: int) -> torch.Tensor:
    """The tensor-core body's weights: bf16 [2H + 1 + 2F, D, D] tiles
    A_0..A_{H-1}, Wvo_0..Wvo_{H-1}, Wg, Wi_0..Wi_{F-1}, Wo_0..Wo_{F-1}, each
    [in, out] and rounded to nearest even as a bf16 product's operand."""
    return torch.cat([head_tiles(folded["A_cat"], d), head_tiles(folded["Wvo_cat"], d),
                      folded["Wg"][None], head_tiles(folded["Wi"], d),
                      folded["Wo"].reshape(fm, d, d)]).to(torch.bfloat16).contiguous()


def _launch(wrapper, x, keep_packed, pad, wdense, folded, sig, *, ln_eps, compute_bf16,
            sig_eps):
    """Checks inputs and launches the shared kernel body for `wrapper`
    (counting the launch on it); sig = (A_sig_next, gamma, beta) for K4b,
    None for K4a. Returns (out, rsum, rcnt)."""
    name = wrapper.__name__
    check_rows(name, x, pad, () if sig is None else sig[1:], () if sig is None else sig[:1])
    nb, b, d = x.shape
    heads = folded["A_cat"].shape[1] // d
    fm = folded["Wi"].shape[1] // d
    _lib.require(heads in HEADS, f"{name}: heads must be one of {HEADS}, got {heads}")
    _lib.require(fm >= 1 and folded["Wi"].shape[1] == fm * d,
                 f"{name}: the FFN width must be a multiple of D")
    for key, shape in _folded_shapes(heads, d, fm).items():
        t = folded[key]
        _lib.require(t.dtype == torch.float32 and tuple(t.shape) == shape
                     and t.device == x.device and t.is_contiguous(),
                     f"{name}: folded[{key!r}] must be contiguous float32 {shape}")
    _lib.require(keep_packed.dtype == torch.int32
                 and tuple(keep_packed.shape) == (nb, keep_words(b), b)
                 and keep_packed.device == x.device and keep_packed.is_contiguous(),
                 f"{name}: keep must be contiguous int32 [nB, ceil(B/32), B]")
    _lib.require(wdense.dtype in (torch.float32, torch.bfloat16)
                 and tuple(wdense.shape) == (nb, b, b) and wdense.device == x.device
                 and wdense.is_contiguous(),
                 f"{name}: wdense must be contiguous float32 or bfloat16 [nB, B, B] "
                 "(a halo-free layout)")
    out = torch.empty_like(x)
    rsum = torch.empty((nb, b), dtype=torch.float32, device=x.device)
    rcnt = torch.empty_like(rsum)
    if nb * b == 0:
        return out, rsum, rcnt
    body = mha_body(b, compute_bf16)
    tiles = weight_tiles(folded, heads, fm, d) if body == "tensor_core" else None
    grid = persistent_grid(x.device, nb, LAYER_CTAS_PER_SM[body])
    scratch = torch.empty(grid * (5 * b * d + b * b + b), dtype=torch.float32,
                          device=x.device)
    ptrs = (ctypes.c_void_p * len(FOLDED_KEYS))(*(folded[k].data_ptr() for k in FOLDED_KEYS))
    lib = _lib.load("gated_block_layer")
    rc = lib.gated_block_layer(
        x.data_ptr(), keep_packed.data_ptr(), pad.data_ptr(), wdense.data_ptr(),
        ctypes.addressof(ptrs), None if tiles is None else tiles.data_ptr(),
        None if sig is None else sig[0].data_ptr(),
        None if sig is None else sig[1].data_ptr(), None if sig is None else sig[2].data_ptr(),
        out.data_ptr(), rsum.data_ptr(), rcnt.data_ptr(), scratch.data_ptr(),
        nb, b, d, heads, fm, grid, int(x.dtype == torch.bfloat16),
        int(wdense.dtype == torch.bfloat16), int(compute_bf16), float(ln_eps),
        float(sig_eps), _lib.stream_handle(x))
    wrapper.launches += 1
    _lib.check(lib, rc, name)
    return out, rsum, rcnt


def _forward_only(*tensors):
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError("the fused gated layer is forward-only: call it under "
                           "torch.no_grad() or on inputs that do not require grad")


def gated_block_layer(x, keep_packed, pad, wdense, folded, *, ln_eps: float = LN_EPS,
                      compute_bf16: bool):
    """One-kernel gated layer forward over a halo-free block layout.

    x [nB, B, D] residual stream (float32 or bfloat16; the output follows),
    keep_packed [nB, ceil(B/32), B] int32 gate words, pad [nB, B] float32,
    wdense [nB, B, B] normalized edge weights (float32 or bfloat16),
    folded: fold_gated_layer_params. Returns [nB, B, D] in x's dtype. CPU
    tensors take the plain version; CUDA tensors launch the kernel, whose
    body follows the shape (`mha_body`): bf16 compute at B <= 256 on the
    tensor cores, float32 compute or B in (256, 512] on block_gemm.
    """
    _forward_only(x, *folded.values())
    if x.device.type == "cpu":
        return gated_block_layer_reference(x, keep_packed, pad, wdense, folded,
                                           ln_eps=ln_eps, compute_bf16=compute_bf16)
    return _launch(gated_block_layer, x, keep_packed, pad, wdense, folded, None,
                   ln_eps=ln_eps, compute_bf16=compute_bf16, sig_eps=0.0)[0]


gated_block_layer.launches = 0


def gated_block_layer_with_sig(x, keep_packed, pad, wdense, folded, A_sig_next, sig_gamma,
                               sig_beta, *, ln_eps: float = LN_EPS, compute_bf16: bool,
                               sig_eps: float):
    """K4a plus the next layer's gate signature from the output.

    Same computation and output as gated_block_layer (bitwise: one kernel
    body), plus (rsum, rcnt) float32 [nB, B] of the next layer's
    LN-folded signature (A_sig_next [D, D], its LN1 gamma/beta [D])
    taken from the output rounded through x's dtype. Returns
    (out, rsum, rcnt).
    """
    _forward_only(x, *folded.values())
    if x.device.type == "cpu":
        return gated_block_layer_with_sig_reference(
            x, keep_packed, pad, wdense, folded, A_sig_next, sig_gamma, sig_beta,
            ln_eps=ln_eps, compute_bf16=compute_bf16, sig_eps=sig_eps)
    return _launch(gated_block_layer_with_sig, x, keep_packed, pad, wdense, folded,
                   (A_sig_next, sig_gamma, sig_beta), ln_eps=ln_eps,
                   compute_bf16=compute_bf16, sig_eps=sig_eps)


gated_block_layer_with_sig.launches = 0
