"""Plain reference of config 5, the min-cut-gated graph transformer
(ruvector_tpu_torch/graph_transformer/gated.py's semantics), in plain
PyTorch. It imports nothing of the port and takes nothing the port made:
it builds its own partitions and edge table from the neighbour lists,
folds its own weights, solves its own gates and keeps its own state.

A layer over a halo-free partition of B rows (x the float32 stream):

    h  = LN1(x);  x += gated MHA(h) under the partition's keep mask
    g  = LN_g(x); x += ((wd g) W_gnn + b) * pad
    h2 = LN2(x);  x += (gelu_tanh(h2 W_in + b_in) W_out + b_out) * pad

Precision is the configuration's: every product takes operands rounded to
the compute type `cdt` (bf16 for config 5) with float32 sums, the
residual stream and the LayerNorms float32; the gate's logits take
exact products with float64 sums. The LayerNorm sums in the pairwise
halving order that the port's kernels use, so that the bf16 rounding of
its output lands where theirs does. With `cdt` one precision lower
(float8 e4m3) the same code is the control that must fail.

The gate state of a step follows ruvector_tpu_torch's
`gated_graph_transformer_step`: a partition whose signature (its mean
positive pooled logit) moved past the hysteresis band is flagged, and the
oldest flagged partitions, up to the budget, are solved again.
"""

from __future__ import annotations

import torch

from portbench.reference.mincut import mincut_keep

LN_EPS = 1e-5
NEG = -1e30
CHUNK = 256          # partitions a block of the reference works on at a time


def rounding(cdt: torch.dtype):
    """x -> x rounded to cdt, as float32; the gradient passes straight
    through (the rounding is the forward's, not the backward's)."""
    if cdt == torch.float32:
        return lambda x: x
    limit = torch.finfo(cdt).max

    def rd(x: torch.Tensor) -> torch.Tensor:
        y = x.detach().clamp(-limit, limit).to(cdt).float()
        return x + (y - x).detach() if x.requires_grad else y

    return rd


def tree_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis (kept) as pairwise halving, zero-padded to a
    power of two."""
    n = x.shape[-1]
    p = 1 << max(n - 1, 0).bit_length()
    if p != n:
        x = torch.nn.functional.pad(x, (0, p - n))
    while x.shape[-1] > 1:
        h = x.shape[-1] // 2
        x = x[..., :h] + x[..., h:]
    return x


def layer_norm(x: torch.Tensor, ln: dict) -> torch.Tensor:
    d = x.shape[-1]
    xc = x - tree_sum(x) / d
    var = tree_sum(xc * xc) / d
    return xc / torch.sqrt(var + LN_EPS) * ln["gamma"].float() + ln["beta"].float()


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    return torch.nn.functional.gelu(x, approximate="tanh")


def mm64(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b with float64 sums, rounded once to float32."""
    return torch.matmul(a.double(), b.double()).float()


# ---------------------------------------------------------------------------
# the graph: partitions and edge table from the neighbour lists
# ---------------------------------------------------------------------------

def normalized_weights(ew, mask=None):
    """Row-normalised edge weights (numpy float32) with the uniform
    fallback, real edges floored at 1e-7."""
    import numpy as np

    w = np.asarray(ew, np.float32)
    mask = np.ones_like(w) if mask is None else np.asarray(mask, np.float32)
    w = w * mask
    wsum = w.sum(1, keepdims=True)
    deg = np.maximum(mask.sum(1, keepdims=True), 1.0)
    wn = np.where(wsum > 0, w / np.where(wsum > 0, wsum, 1.0), mask / deg)
    return np.where(mask > 0, np.maximum(wn, 1e-7), 0.0).astype(np.float32)


def partitions(idx: torch.Tensor, ew: torch.Tensor, n: int, block: int):
    """Consecutive partitions of `block` nodes and their dense edge table.
    Every neighbour must lie in its node's partition (halo-free). Returns
    (wd [nb, B, B] float32, pad [nb, B] float32)."""
    dev = idx.device
    nb = -(-n // block)
    rows = torch.arange(n, device=dev)
    part = (rows // block)[:, None]
    if not bool((idx.long() // block == part).all()):
        raise ValueError("a neighbour lies outside its node's partition")
    wn = torch.from_numpy(normalized_weights(ew.cpu().numpy())).to(dev)
    wd = torch.zeros(nb * block, block, device=dev)
    wd.index_put_((rows[:, None].expand_as(idx), idx.long() % block), wn, accumulate=True)
    pad = torch.zeros(nb * block, device=dev)
    pad[:n] = 1.0
    return wd.reshape(nb, block, block), pad.reshape(nb, block)


# ---------------------------------------------------------------------------
# the gate
# ---------------------------------------------------------------------------

def sig_matrix(p: dict, heads: int) -> torch.Tensor:
    """Wq Wk^T / (sqrt(dh) H): the head-mean pooled-logit matrix."""
    d = p["wq"].shape[0]
    scale = 1.0 / ((d // heads) ** 0.5) / heads
    return torch.matmul(p["wq"].float(), p["wk"].float().T) * scale


def _valid(pad: torch.Tensor) -> torch.Tensor:
    return (pad[:, :, None] * pad[:, None, :]) > 0


def signature(x, pad, p, cfg, rd) -> torch.Tensor:
    """[K] mean eps-clamped positive pooled logit of each partition, the
    products on rd-rounded operands with float64 sums."""
    A = sig_matrix(p, cfg["num_heads"])
    hc = rd(layer_norm(x, p["ln1"]))
    s = mm64(rd(mm64(hc, rd(A))), hc.transpose(1, 2))
    pos = (s > cfg["eps"]) & _valid(pad)
    rsum = torch.sum(torch.where(pos, s, torch.zeros_like(s)), dim=2, dtype=torch.float64).float()
    rcnt = torch.sum(pos.float(), dim=2)
    return torch.sum(rsum, dim=1) / torch.clamp(torch.sum(rcnt, dim=1), min=1.0)


def gate(x, pad, p, cfg, rd) -> torch.Tensor:
    """[K, B, B] bool keep masks: the min-cut gate of the pooled logits
    (LN1 rows rounded by rd, exact products, float64 sums)."""
    A = sig_matrix(p, cfg["num_heads"])
    hc = rd(layer_norm(x, p["ln1"]))
    lg = mm64(mm64(hc, A), hc.transpose(1, 2))
    lg = torch.where(_valid(pad), lg, torch.full_like(lg, -1.0))
    return mincut_keep(lg, cfg["lam"], cfg["eps"])


# ---------------------------------------------------------------------------
# the layer
# ---------------------------------------------------------------------------

def layer(x, keep, pad, wd, p, cfg, rd) -> torch.Tensor:
    """One gated layer over [K, B, D] partitions under keep [K, B, B]."""
    K, b, d = x.shape
    hh = cfg["num_heads"]
    dh = d // hh
    padc = pad[..., None]
    keepv = keep & _valid(pad)
    hc = rd(layer_norm(x, p["ln1"]))
    # per head A_h = Wq_h Wk_h^T / sqrt(dh) and Wvo_h = Wv_h Wo_h, [H, D, D]
    wq, wk, wv = (p[k].float().reshape(d, hh, dh).permute(1, 0, 2) for k in ("wq", "wk", "wv"))
    A_all = torch.matmul(wq, wk.transpose(1, 2)) * (1.0 / dh ** 0.5)
    Wvo_all = torch.matmul(wv, p["wo"].float().reshape(hh, dh, d))
    attn = torch.zeros_like(x)
    for h in range(hh):
        A, Wvo = A_all[h], Wvo_all[h]
        s = torch.matmul(rd(torch.matmul(hc, rd(A))), hc.transpose(1, 2))
        s = torch.where(keepv, s, torch.full_like(s, NEG))
        smax = torch.amax(s, dim=-1, keepdim=True)
        pu = torch.exp(s - torch.clamp(smax, min=NEG))
        inv = torch.where(smax > -1e29,
                          1.0 / torch.clamp(torch.sum(pu, dim=-1, keepdim=True), min=1e-10),
                          torch.zeros_like(smax))
        y = torch.matmul(hc, rd(Wvo))
        attn = attn + torch.matmul(rd(pu), rd(y)) * inv
    x = x + attn * padc
    g = layer_norm(x, p["ln_g"])
    agg = torch.matmul(rd(wd), rd(g))
    x = x + (torch.matmul(rd(agg), rd(p["w_gnn"]["kernel"].float()))
             + p["w_gnn"]["bias"].float()) * padc
    h2 = layer_norm(x, p["ln2"])
    mid = gelu_tanh(torch.matmul(rd(h2), rd(p["ffn_in"]["kernel"].float()))
                    + p["ffn_in"]["bias"].float())
    ff = torch.matmul(rd(mid), rd(p["ffn_out"]["kernel"].float())) + p["ffn_out"]["bias"].float()
    return x + ff * padc


def _chunks(nb: int):
    for s in range(0, nb, CHUNK):
        yield slice(s, min(nb, s + CHUNK))


# ---------------------------------------------------------------------------
# serving: the gate state's start and one step
# ---------------------------------------------------------------------------

@torch.no_grad()
def init_state(params, cfg, x, pad, wd, rd) -> dict:
    """Every partition's gate solved, layer by layer: {"keep": [L, nb, B,
    B] bool, "sig": [L, nb], "age": [L, nb] int32}."""
    keeps, sigs = [], []
    x = x.float()
    for p in params:
        keep = torch.empty(x.shape[0], x.shape[1], x.shape[1], dtype=torch.bool,
                           device=x.device)
        sig = torch.empty(x.shape[0], device=x.device)
        nxt = torch.empty_like(x)
        for c in _chunks(x.shape[0]):
            keep[c] = gate(x[c], pad[c], p, cfg, rd)
            sig[c] = signature(x[c], pad[c], p, cfg, rd)
            nxt[c] = layer(x[c], keep[c], pad[c], wd[c], p, cfg, rd)
        keeps.append(keep)
        sigs.append(sig)
        x = nxt
    age = torch.zeros(len(params), x.shape[0], dtype=torch.int32, device=x.device)
    return {"keep": torch.stack(keeps), "sig": torch.stack(sigs), "age": age}


@torch.no_grad()
def step(params, cfg, x, pad, wd, state: dict, budget: int, rd):
    """One serving step from `state` (keep [L, nb, B, B] bool, sig, age):
    (out [nb, B, D], new state, partitions solved again)."""
    x = x.float()
    keeps, sigs, ages, solved = [], [], [], 0
    for li, p in enumerate(params):
        sig = torch.cat([signature(x[c], pad[c], p, cfg, rd) for c in _chunks(x.shape[0])])
        prev = state["sig"][li]
        drift = torch.abs(sig - prev)
        flagged = drift > cfg["hysteresis_band"] * (torch.abs(prev) + 1e-6)
        age = state["age"][li] + 1
        keep, sig_l = state["keep"][li].clone(), prev.clone()
        if bool(flagged.any()):
            score = torch.where(flagged, age.float() * 1e6 + drift, torch.full_like(drift, -1.0))
            chosen = torch.sort(score, descending=True, stable=True).indices[:budget]
            chosen = chosen[flagged[chosen]]
            keep[chosen] = gate(x[chosen], pad[chosen], p, cfg, rd)
            sig_l[chosen] = sig[chosen]
            age[chosen] = 0
            solved += int(chosen.numel())
        nxt = torch.empty_like(x)
        for c in _chunks(x.shape[0]):
            nxt[c] = layer(x[c], keep[c], pad[c], wd[c], p, cfg, rd)
        x = nxt
        keeps.append(keep)
        sigs.append(sig_l)
        ages.append(age)
    return x, {"keep": torch.stack(keeps), "sig": torch.stack(sigs),
               "age": torch.stack(ages)}, solved


# ---------------------------------------------------------------------------
# training: the loss under fixed masks, its gradient, SGD
# ---------------------------------------------------------------------------

def leaves(params) -> list:
    """The trainable tensors in a fixed order: layer by layer, keys sorted,
    nested keys sorted."""
    out = []
    for p in params:
        for k in sorted(p):
            if isinstance(p[k], dict):
                out.extend(p[k][kk] for kk in sorted(p[k]))
            else:
                out.append(p[k])
    return out


def with_leaves(params, new: list) -> list:
    """params with its leaves replaced by `new` (in leaves' order)."""
    it = iter(new)
    out = []
    for p in params:
        q = {}
        for k in sorted(p):
            q[k] = ({kk: next(it) for kk in sorted(p[k])} if isinstance(p[k], dict)
                    else next(it))
        out.append(q)
    return out


def loss_and_grads(params, cfg, x, pad, wd, keep, rd):
    """The mean squared output over the real nodes (zero targets) and its
    gradient for every leaf, partition block by block."""
    ws = [w.detach().float().requires_grad_(True) for w in leaves(params)]
    ps = with_leaves(params, ws)
    n_real = float(pad.sum())
    total = 0.0
    for c in _chunks(x.shape[0]):
        h = x[c].float()
        for li, p in enumerate(ps):
            h = layer(h, keep[li, c], pad[c], wd[c], p, cfg, rd)
        part = torch.sum((h * pad[c][..., None]) ** 2) / n_real
        part.backward()
        total += float(part.detach())
    return total, [w.grad for w in ws]


def train(params, cfg, xs, pad, wd, keep, lr: float, rd):
    """len(xs) SGD steps (w - lr g), one on each input: (losses, the first
    step's gradients, the leaves after the last step)."""
    ws = [w.detach().float() for w in leaves(params)]
    losses, first = [], None
    for x in xs:
        loss, grads = loss_and_grads(with_leaves(params, ws), cfg, x, pad, wd, keep, rd)
        losses.append(loss)
        first = grads if first is None else first
        ws = [w - lr * g for w, g in zip(ws, grads)]
    return losses, first, ws
