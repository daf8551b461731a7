"""Plain reference of the RuvectorLayer (ruvector-gnn's embedding update,
ruvector_tpu_torch/nn/ruvector_layer.py's semantics) on the neighbour
lists, in plain PyTorch. It imports nothing of the port and reads neither
its block table nor its folded weights.

    msg = x W_msg + b                           (in the IO type)
    per head h: q_h = msg Wq_h + bq_h, scores <q_h, k_j> / sqrt(hd) over the
        node's neighbours j, k_j = msg_j Wk_h + bk_h (the bias term is the
        same along a row and cancels in the softmax, so the scores are taken
        as <(q_h Wk_h^T) / sqrt(hd), msg_j>), softmax, values msg_j Wv_h + bv_h
    attn = concat_h(...) W_out + b_out;  mean = sum_j w_ij msg_j
    h' = GRU(input = (attn + mean) W_agg + b_agg, hidden = msg)
    out = LayerNorm(h' (1 - dropout))

Precision is the configuration's: with bf16 compute and IO the message
rows, the scores' query side, the softmax weights and the edge weights
are rounded to bf16 before their products, whose sums are float32; every
other product is float32 (TF32 off); the output is rounded to bf16. With
float8 e4m3 in place of bf16 the same code is the control that must fail.
"""

from __future__ import annotations

import torch

from portbench.reference.gated import rounding

ROWS = 65_536        # nodes a block of the reference works on at a time


def _lin(p: dict, x: torch.Tensor) -> torch.Tensor:
    return torch.matmul(x, p["kernel"].float()) + p["bias"].float()


def messages(params: dict, x: torch.Tensor, cdt: torch.dtype) -> torch.Tensor:
    """The message rows in the IO type `cdt`, as float32 values: the
    product on rounded operands with float32 sums, rounded, then the
    rounded bias added and the sum rounded."""
    rd = rounding(cdt)
    w = params["w_msg"]
    return rd(rd(torch.matmul(rd(x.float()), rd(w["kernel"].float()))) + rd(w["bias"].float()))


def apply_rows(params: dict, msg: torch.Tensor, idx: torch.Tensor, wn: torch.Tensor,
               rows: torch.Tensor, heads: int, cdt: torch.dtype, dropout: float = 0.0,
               eps: float = 1e-5) -> torch.Tensor:
    """The layer's output (float32 values of the cdt-rounded output) for
    the nodes `rows`: msg [N, D] every node's message row, idx [N, M]
    neighbours, wn [N, M] normalised edge weights (every slot a real
    edge)."""
    rd = rounding(cdt)
    d = msg.shape[1]
    hd = d // heads
    M = msg[rows]                                            # [R, D]
    nbr = idx[rows].long()
    L = msg[nbr]                                             # [R, m, D]
    at = params["attn"]
    wq = at["q"]["kernel"].float().reshape(d, heads, hd)
    bq = at["q"]["bias"].float().reshape(heads, hd)
    wk = at["k"]["kernel"].float().reshape(d, heads, hd)
    wv = at["v"]["kernel"].float().reshape(d, heads, hd)
    bv = at["v"]["bias"].float().reshape(heads, hd)
    A = torch.einsum("dhf,ehf->hde", wq, wk) * (1.0 / hd ** 0.5)
    c = torch.einsum("hf,ehf->he", bq, wk) * (1.0 / hd ** 0.5)
    o = []
    for h in range(heads):
        u = torch.matmul(M, A[h]) + c[h]
        s = torch.einsum("rd,rmd->rm", rd(u), L)
        p = torch.exp(s - torch.amax(s, dim=1, keepdim=True))
        denom = torch.sum(p, dim=1, keepdim=True)
        tv = torch.einsum("rm,rmd->rd", rd(p), L) / denom
        o.append(torch.matmul(tv, wv[:, h, :]) + bv[h])
    attn = _lin(at["out"], torch.cat(o, dim=1))
    mean = torch.einsum("rm,rmd->rd", rd(wn[rows]), L)
    agg = _lin(params["w_agg"], attn + mean)
    g = params["gru"]
    z = torch.sigmoid(_lin(g["w_z"], agg) + _lin(g["u_z"], M))
    r = torch.sigmoid(_lin(g["w_r"], agg) + _lin(g["u_r"], M))
    h_tilde = torch.tanh(_lin(g["w_h"], agg) + _lin(g["u_h"], r * M))
    upd = ((1.0 - z) * M + z * h_tilde) * (1.0 - dropout)
    mu = torch.mean(upd, dim=-1, keepdim=True)
    var = torch.mean(torch.square(upd - mu), dim=-1, keepdim=True)
    out = (upd - mu) * torch.rsqrt(var + eps) * params["norm"]["gamma"].float() \
        + params["norm"]["beta"].float()
    return rd(out)


@torch.no_grad()
def compare_rows(params, x, idx, wn, rows, got, heads, cdt, stats: dict) -> None:
    """Add the gaps between `got` [R, D] (the output rows `rows`, as
    served) and the reference's to `stats` (max_abs, sum_abs, sum_ref,
    count), ROWS rows at a time."""
    msg = messages(params, x, cdt)
    for s in range(0, rows.numel(), ROWS):
        r = rows[s:s + ROWS]
        want = apply_rows(params, msg, idx, wn, r, heads, cdt)
        err = (got[s:s + ROWS].float() - want).abs()
        stats["max_abs"] = max(stats.get("max_abs", 0.0), float(err.max()))
        stats["sum_abs"] = stats.get("sum_abs", 0.0) + float(err.sum(dtype=torch.float64))
        stats["sum_ref"] = stats.get("sum_ref", 0.0) + float(want.abs().sum(dtype=torch.float64))
        stats["count"] = stats.get("count", 0) + err.numel()
