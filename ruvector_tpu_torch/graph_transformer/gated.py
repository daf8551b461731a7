"""Partitioned min-cut-gated graph transformer (BASELINE config 5).

Port of ruvector_tpu/graph_transformer/gated.py. Partitions are the
block-dense blocks (graph/block_dense.py), so one layer is three batched
sublayers over the [nB, B, D] layout:

  1. intra-partition min-cut-gated MHA: one push-relabel gate per
     partition over the head-mean ("pooled") logits, the mask shared by
     the heads (ruvector-attn-mincut/src/gating.rs:70-102);
  2. cross-partition neighbour mixing with the graph's normalized edge
     weights;
  3. a pre-norm FFN (GELU, tanh approximation).

Temporal gate reuse: `gate_state_init` solves every partition's gate once
and records a per-partition signature (the mean positive pooled logit);
`gated_graph_transformer_step` re-solves only the partitions whose
signature drifted past the hysteresis band, oldest first, under a
re-solve budget, and runs each layer under the refreshed masks.

Kernel route (`fused_gate_attn`): "auto" takes it for CUDA tensors,
"always" forces it (CPU tensors then run the kernels' plain versions),
"never" runs the plain sublayer composition. On the kernel route the
wrappers raise on shapes their kernels do not take (D other than 32, 64
or 128; more than 8 heads; B > 512). On a halo-free layout a layer is one
fused kernel (K4a; K4b when it also emits the next layer's signature);
with a halo it is LN1, the gated MHA kernel (K5a) and the plain neighbour
mix and FFN. With B % 32 == 0 the signature is the LN-folded kernel (K6c)
and the gate the push-relabel kernel (K7); with B % 32 != 0 the signature
is K6b on the normalized stream and the gate the plain batched one, as in
the JAX package (`gate_kernel = fused and b % 32 == 0`).

Training: `gated_graph_transformer_loss_with_masks` differentiates the
forward under fixed masks. The fused layer is an autograd Function whose
backward recomputes the sublayer composition with the gated MHA kernel
and its recompute backward (K5a/K5b) inside, as the JAX package's
custom_vjp does; the graph's edge table, the gate words and pad get no
gradient. `remat` checkpoints each layer (torch.utils.checkpoint).

The stateless forward solves its gates in runs of `gate_chunk`
partitions, as the JAX package's `_ceil_chunked_map` does there: each
run's gates once, without autograd, and its attention checkpointed (at
999,936 nodes the whole [nB, H, B, B] logits and the gate's buffers
would not fit beside a training step). The plain gate of
`gate_state_init` goes in the same runs.

Chunked routes: above `_CHUNK_NB` partitions (nB > 4096, as in the JAX
package) a route runs over the block axis in chunks of `_CHUNK_NB`
(`_chunked_map`), where the JAX package bounds the same intermediates:
the FFN, the plain layer composition, the fused layer (K4a a chunk),
the step's layer with the next signature (K4b a chunk), and the train
step's whole L-layer network with its loss sums
(`_loss_chunked_halo_free`, routed from
`gated_graph_transformer_loss_with_masks` on a halo-free layout on the
kernel route). A chunk is a view of the full tensors, never a copy, and
under autograd each chunk is checkpointed, so the backward holds one
chunk's intermediates at a time. At 9,999,872 nodes (nB = 39,062) the
straight train step's recompute would hold a [39,062, 256, 256] float32
edge table (10.2 GB) beside [9,999,872, 512] float32 FFN tensors (20.5
GB each), and it runs out of an 80 GB card's memory. Every block is
independent in every layer, so a chunked route gives the straight
route's values: the forward's bit for bit, the loss and gradients to
float32 summation order. Parallel callers route on their own nB.

The step branches on the host where JAX uses `lax.cond` (any partition
flagged?), which is one device-to-host sync per layer per step.
"""

from __future__ import annotations

import contextlib
import dataclasses
import warnings

import torch
import torch.utils.checkpoint

from ruvector_tpu_torch.attention.mincut_device import mincut_gate_device
from ruvector_tpu_torch.device import resolve_device
from ruvector_tpu_torch.graph.block_dense import BlockDenseGraph
from ruvector_tpu_torch.nn.core import (
    layer_norm_apply,
    layer_norm_init,
    linear_init,
    make_generator,
    xavier_normal,
)
from ruvector_tpu_torch.ops.kernels.gated_block_attn import (
    block_gate_signature,
    block_gate_signature_ln_x,
    block_gate_signature_x,
    fold_gated_attention_params,
    gated_block_attention,
    pack_keep,
    unpack_keep,
)
from ruvector_tpu_torch.ops.kernels.gated_block_layer import (
    fold_gated_layer_params,
    gated_block_layer,
    gated_block_layer_with_sig,
    gelu_tanh,
)
from ruvector_tpu_torch.ops.kernels.mincut_gate_block import mincut_gate_block_from_x
from ruvector_tpu_torch.ops.segment import masked_softmax


@dataclasses.dataclass(frozen=True)
class GatedGraphTransformerConfig:
    dim: int
    num_heads: int = 4
    ffn_mult: int = 4
    num_layers: int = 2
    lam: float = 0.5            # gate threshold multiplier (mincut.rs:163)
    eps: float = 0.01           # positive-logit clamp
    # partitions a run of plain gate solves takes at a time (the stateless
    # forward, gate_state_init's plain route; memory bound)
    gate_chunk: int = 256
    # 'pooled': one gate per partition over the head-mean logits, mask
    # shared across heads; 'per_head': one gate per head (stateless only)
    gate_mode: str = "pooled"
    # a partition re-solves when its signature moves by more than this
    # fraction of its stored value
    hysteresis_band: float = 0.05
    # per-step re-solve budget as a fraction of partitions (at least 1)
    max_resolve_frac: float = 1 / 16
    # hard staleness bound in steps (0 = pure hysteresis); with it the
    # budget escalates (a second budget-sized solve) on steps where
    # partitions reach the bound
    max_gate_age: int = 0
    # checkpoint each layer (torch.utils.checkpoint): the backward recomputes
    # a layer's forward instead of keeping its activations
    remat: bool = False
    compute_dtype: str = "float32"
    fused_gate_attn: str = "auto"

    @property
    def head_dim(self) -> int:
        assert self.dim % self.num_heads == 0
        return self.dim // self.num_heads

    @property
    def cdt(self) -> torch.dtype:
        return torch.bfloat16 if self.compute_dtype == "bfloat16" else torch.float32


def gated_graph_transformer_init(seed, cfg: GatedGraphTransformerConfig,
                                 device=None) -> list[dict]:
    """Per-layer parameter dicts in the JAX layout ([in, out] kernels),
    drawn from a torch.Generator seeded with `seed`."""
    dev = resolve_device(device)
    gen = make_generator(seed)
    d = cfg.dim
    layers = []
    for _ in range(cfg.num_layers):
        layers.append({
            "wq": xavier_normal(gen, d, d, dev),
            "wk": xavier_normal(gen, d, d, dev),
            "wv": xavier_normal(gen, d, d, dev),
            "wo": xavier_normal(gen, d, d, dev),
            "w_gnn": linear_init(gen, d, d, dev),
            "ln1": layer_norm_init(d, dev),
            "ln_g": layer_norm_init(d, dev),
            "ln2": layer_norm_init(d, dev),
            "ffn_in": linear_init(gen, d, d * cfg.ffn_mult, dev),
            "ffn_out": linear_init(gen, d * cfg.ffn_mult, d, dev),
        })
    return layers


def _linear(p: dict, x: torch.Tensor) -> torch.Tensor:
    """x @ W + b in float32 (a bf16 x promotes, as in JAX)."""
    return torch.matmul(x.float(), p["kernel"].float()) + p["bias"].float()


def _ln(p: dict, x: torch.Tensor) -> torch.Tensor:
    return layer_norm_apply(p, x.float())


# ---------------------------------------------------------------------------
# stateless forward (gates solved inside every call)
# ---------------------------------------------------------------------------

def _chunk_logits(q, k, vm):
    dh = q.shape[-1]
    logits = torch.matmul(q, k.transpose(-1, -2)) * (1.0 / dh ** 0.5)
    return torch.where(vm > 0, logits, torch.full_like(logits, -1.0))


def _chunk_pad(node_pad):
    padf = node_pad.float()
    return padf[:, None, :, None] * padf[:, None, None, :]


def _chunk_gate(cfg, q, k, node_pad):
    """The gates of a run of partitions (no gradient flows through them):
    q, k [C, H, B, dh], node_pad [C, B]. Returns (masked logits [C, H, B,
    B], keep [C, H|1, B, B] bool, cut_cost [C, H])."""
    c, hh, b, _ = q.shape
    logits = _chunk_logits(q, k, _chunk_pad(node_pad))
    if cfg.gate_mode == "pooled":
        keep1, cost1 = mincut_gate_device(torch.mean(logits, dim=1), cfg.lam, cfg.eps)
        return logits, keep1[:, None], cost1[:, None].expand(c, hh)
    keep, cost = mincut_gate_device(logits.reshape(c * hh, b, b), cfg.lam, cfg.eps)
    return logits, keep.reshape(logits.shape), cost.reshape(c, hh)


def _chunk_attention(q, k, v, node_pad, keep, logits=None):
    """The MHA of a run of partitions under its gates: [C, H, B, dh].
    `logits`, the run's masked logits where the gate has them and no
    gradient is taken, spares recomputing them."""
    vm = _chunk_pad(node_pad)
    if logits is None:
        logits = _chunk_logits(q, k, vm)
    return torch.matmul(masked_softmax(logits, keep.float() * vm), v)


def _gated_attention_block(h, node_pad, wq, wk, wv, wo, cfg):
    """Min-cut-gated MHA within each partition. h [nB, B, D], node_pad
    [nB, B]. Returns ([nB, B, D], (cut_applied [nB, H] bool, cut_cost
    [nB, H])). The partitions go through in runs of cfg.gate_chunk (the
    JAX package's `_ceil_chunked_map`; the runs are independent, so the
    result does not depend on the chunk): each run's gates are solved once
    without autograd. Without autograd the attention reuses the gate's
    logits; under autograd it is checkpointed, so only one run's [C, H,
    B, B] logits and gate buffers are live at a time and a backward
    recomputes the logits but not the gates."""
    nb, b, d = h.shape
    hh, dh = cfg.num_heads, cfg.head_dim

    def proj(w):
        return torch.matmul(h.float(), w.float()).reshape(nb, b, hh, dh).permute(0, 2, 1, 3)

    q, k, v = proj(wq), proj(wk), proj(wv)
    outs, costs = [], []
    for c0 in range(0, nb, cfg.gate_chunk):
        run = slice(c0, c0 + cfg.gate_chunk)
        with torch.no_grad():
            logits, keep, cost = _chunk_gate(cfg, q[run], k[run], node_pad[run])
        args = (q[run], k[run], v[run], node_pad[run], keep)
        if torch.is_grad_enabled():
            outs.append(torch.utils.checkpoint.checkpoint(_chunk_attention, *args,
                                                          use_reentrant=False))
        else:
            outs.append(_chunk_attention(*args, logits))
        costs.append(cost)
    out = torch.cat(outs).permute(0, 2, 1, 3).reshape(nb, b, d)
    cost = torch.cat(costs)
    return torch.matmul(out, wo.float()) * node_pad.float()[..., None], (cost > 0, cost)


def _neighbor_mix(h, bdg: BlockDenseGraph, w_gnn):
    """Cross-partition mean aggregate along graph edges, then W_gnn."""
    nb, b, d = h.shape
    local = h if bdg.table == b else h.reshape(nb * b, d)[bdg.local_ids.long()]
    agg = torch.matmul(bdg.wdense.to(h.dtype).float(), local.float()).to(h.dtype)
    return _linear(w_gnn, agg)


def gated_graph_transformer_apply(params: list[dict], cfg: GatedGraphTransformerConfig,
                                  fpad: torch.Tensor, bdg: BlockDenseGraph,
                                  with_stats: bool = False):
    """Forward over the partitioned graph, gates solved in the call.
    Returns [nB*B, D] (and with with_stats the per-layer (cut_applied
    [nB, H], cut_cost [nB, H]))."""
    nb, b = bdg.n_blocks, bdg.block
    x = fpad.reshape(nb, b, -1)
    pad = bdg.node_pad[..., None]
    stats = []

    def layer(p, x):
        a, st = _gated_attention_block(_ln(p["ln1"], x), bdg.node_pad, p["wq"], p["wk"],
                                       p["wv"], p["wo"], cfg)
        x = x + a
        x = x + _neighbor_mix(_ln(p["ln_g"], x), bdg, p["w_gnn"]) * pad
        h2 = _ln(p["ln2"], x)
        return x + _linear(p["ffn_out"], gelu_tanh(_linear(p["ffn_in"], h2))) * pad, st

    for p in params:
        x, st = _remat(cfg, layer, p, x)
        stats.append(st)
    out = x.reshape(nb * b, -1)
    return (out, stats) if with_stats else out


def _loss(out, bdg: BlockDenseGraph, targets):
    """Mean squared error over the real nodes."""
    pad = bdg.node_pad.reshape(-1, 1)
    err = (out - targets) * pad
    return torch.sum(err * err) / torch.clamp(torch.sum(pad), min=1.0)


def gated_graph_transformer_loss(params, cfg: GatedGraphTransformerConfig, fpad,
                                 bdg: BlockDenseGraph, targets):
    """Mean-squared node-embedding loss of the stateless forward (gates
    solved in the call, no gradient through them)."""
    return _loss(gated_graph_transformer_apply(params, cfg, fpad, bdg), bdg, targets)


# ---------------------------------------------------------------------------
# temporal gate reuse
# ---------------------------------------------------------------------------

def _qk_proj(h, wq, wk, cfg):
    q = torch.matmul(h.float(), wq.float()).to(cfg.cdt)
    k = torch.matmul(h.float(), wk.float()).to(cfg.cdt)
    return q, k


def _pooled_from_qk(q, k, node_pad, cfg):
    lg = torch.matmul(q.float(), k.float().transpose(1, 2))
    lg = lg * (1.0 / (cfg.head_dim ** 0.5) / cfg.num_heads)
    padf = node_pad.float()
    valid = padf[:, :, None] * padf[:, None, :]
    return torch.where(valid > 0, lg, torch.full_like(lg, -1.0))


def _fold_sig_params(p, cfg):
    """A_sig = Wq Wk^T / (sqrt(dh) H): the head-mean pooled-logit matrix,
    so signatures and gate logits read the features directly."""
    return torch.matmul(p["wq"].float(), p["wk"].float().T) * (
        1.0 / (cfg.head_dim ** 0.5) / cfg.num_heads)


def _pooled_from_x(h_sel, pad_sel, A_sig):
    """Pooled logits X A_sig X^T for a subset of partitions, -1.0 on
    padding pairs."""
    hf = h_sel.float()
    lg = torch.matmul(torch.matmul(hf, A_sig), hf.transpose(1, 2))
    padf = pad_sel.float()
    valid = padf[:, :, None] * padf[:, None, :]
    return torch.where(valid > 0, lg, torch.full_like(lg, -1.0))


def _gate_signature(pooled, eps):
    """Per-partition mean positive clamped logit (the gate's lambda proxy)."""
    clamped = torch.where(pooled > eps, pooled, torch.zeros_like(pooled))
    npos = torch.sum(clamped > 0, dim=(-2, -1))
    return torch.sum(clamped, dim=(-2, -1)) / torch.clamp(npos, min=1)


def _ln_vectors(p):
    """A LayerNorm's (gamma, beta) as the kernels take them: float32 [D]."""
    return p["gamma"].float().contiguous(), p["beta"].float().contiguous()


def _row_mean_signature(rsum, rcnt):
    """Per-partition signature from the kernels' per-row sums and counts."""
    return torch.sum(rsum, dim=1) / torch.clamp(torch.sum(rcnt, dim=1), min=1.0)


def _signature_from_x(x, p, A_sig, node_pad, cfg):
    """Signature straight from the residual stream, LN1 folded in (K6c)."""
    rsum, rcnt = block_gate_signature_ln_x(
        x, node_pad, A_sig, *_ln_vectors(p["ln1"]), eps=cfg.eps,
        compute_bf16=cfg.compute_dtype == "bfloat16")
    return _row_mean_signature(rsum, rcnt)


def _signature_fused_x(h, A_sig, node_pad, cfg):
    """Signature of the normalized stream h through the kernel (K6b): the
    kernel route's signature where B % 32 != 0."""
    rsum, rcnt = block_gate_signature_x(h.contiguous(), node_pad, A_sig.contiguous(),
                                        eps=cfg.eps,
                                        compute_bf16=cfg.compute_dtype == "bfloat16")
    return _row_mean_signature(rsum, rcnt)


def _signature_fused(q, k, node_pad, cfg):
    """Signature from projected q and k through the kernel (K6a). The JAX
    package defines this route (gated.py:291) but calls it nowhere; its
    sums are ordered unlike _gate_signature's, so init and step must not
    mix the two."""
    rsum, rcnt = block_gate_signature(q.contiguous(), k.contiguous(), node_pad, eps=cfg.eps,
                                      scale=1.0 / (cfg.head_dim ** 0.5) / cfg.num_heads)
    return _row_mean_signature(rsum, rcnt)


def _solve_gates_kernel(x_sel, pad_sel, A_sig, p, cfg):
    """Batched gate solve with LN1 folded in (K7). Returns keep [K, W, B]."""
    keep, _ = mincut_gate_block_from_x(
        x_sel, pad_sel, A_sig, lam=cfg.lam, eps=cfg.eps, ln=_ln_vectors(p["ln1"]),
        compute_bf16=cfg.compute_dtype == "bfloat16")
    return keep


def _solve_gates_plain(h_sel, pad_sel, A_sig, cfg):
    """The gate of the plain route: pooled logits of the normalized
    features, then the batched plain gate."""
    keep, _ = mincut_gate_device(_pooled_from_x(h_sel, pad_sel, A_sig), cfg.lam, cfg.eps)
    return pack_keep(keep)


def _attention_with_keep(h, node_pad, keep, p, cfg):
    """MHA within partitions under a fixed keep mask ([nB, B, B] bool,
    shared by the heads). bf16 compute rounds Q/K/V and the softmax
    weights to bf16, with float32 sums."""
    nb, b, d = h.shape
    hh, dh = cfg.num_heads, cfg.head_dim
    cdt = cfg.cdt

    def proj(w):
        y = torch.matmul(h.float(), w.float()).reshape(nb, b, hh, dh).permute(0, 2, 1, 3)
        return y.to(cdt).float()

    q, k, v = proj(p["wq"]), proj(p["wk"]), proj(p["wv"])
    padf = node_pad.float()
    vm = padf[:, None, :, None] * padf[:, None, None, :]
    logits = torch.matmul(q, k.transpose(-1, -2)) * (1.0 / dh ** 0.5)
    logits = torch.where(vm > 0, logits, torch.full_like(logits, -1.0))
    attn = masked_softmax(logits, keep[:, None].float() * vm)
    out = torch.matmul(attn.to(cdt).float(), v)
    out = torch.matmul(out.permute(0, 2, 1, 3).reshape(nb, b, d), p["wo"].float())
    return out * padf[..., None]


def _use_fused_attn(cfg, device: torch.device) -> bool:
    """The kernel route: forced by "always"; under "auto" for CUDA tensors
    (whose wrappers raise on a shape their kernel does not take)."""
    return cfg.fused_gate_attn == "always" or (
        cfg.fused_gate_attn == "auto" and device.type == "cuda")


# the chunked routes' bound on the block axis (the JAX package's): above
# it a route runs in chunks of this many partitions. Tests monkeypatch it
# to drive the chunked routes on small graphs.
_CHUNK_NB = 4096


def _checkpointed(f, *args):
    """f(*args), checkpointed under autograd: the backward recomputes f
    from its arguments instead of keeping its intermediates."""
    if not torch.is_grad_enabled():
        return f(*args)
    return torch.utils.checkpoint.checkpoint(f, *args, use_reentrant=False)


def _chunked_map(f, args, nb: int, chunk: int, checkpoint: bool = True):
    """f over the leading (block) axis of `args` in ceil(nb / chunk)
    chunks, each f(*[a[s:e] for a in args]) on views of the full tensors;
    the last chunk is the shorter one. f returns a tensor or a tuple of
    tensors, each with the chunk's rows first; the chunks' results are
    written into outputs of nb rows (under autograd through slice
    assignment, whose backward hands each chunk its rows). Under autograd
    each chunk is checkpointed unless `checkpoint` is False. One chunk
    is f(*args) itself."""
    if nb <= chunk:
        return f(*args)
    outs, single = None, False
    for s in range(0, nb, chunk):
        part = [a[s:s + chunk] for a in args]
        y = _checkpointed(f, *part) if checkpoint else f(*part)
        single = isinstance(y, torch.Tensor)
        ys = (y,) if single else y
        if outs is None:
            outs = [t.new_empty((nb, *t.shape[1:])) for t in ys]
        for o, t in zip(outs, ys):
            o[s:s + chunk] = t
    return outs[0] if single else tuple(outs)


def _ffn_apply(p, h2, pad, out_dtype):
    """Pre-norm FFN; the hidden and the output rounded to out_dtype. Above
    _CHUNK_NB partitions in chunks: the float32 [nB, B, ffn_mult*D]
    hidden exists one chunk at a time."""
    def ffn(hh, pp):
        mid = gelu_tanh(_linear(p["ffn_in"], hh)).to(out_dtype)
        return _linear(p["ffn_out"], mid).to(out_dtype) * pp[..., None].to(out_dtype)

    return _chunked_map(ffn, (h2, pad), h2.shape[0], _CHUNK_NB)


def _compose_layer(cfg, p, x, attn, pad, mix):
    """One gated layer as sublayers: attn(h) gives the gated MHA of the
    normalized stream h, mix(g) the projected neighbour mix of g."""
    dt = x.dtype
    h = _ln(p["ln1"], x).to(dt)
    x = x + attn(h).to(dt)
    g = _ln(p["ln_g"], x).to(dt)
    x = x + mix(g).to(dt) * pad[..., None].to(dt)
    h2 = _ln(p["ln2"], x).to(dt)
    return x + _ffn_apply(p, h2, pad, dt)


def _attention(cfg, p, keep_p, pad, kernel: bool):
    """The gated MHA sublayer under bit-packed masks keep_p: the kernel
    (K5a forward, K5b backward) or the plain _attention_with_keep."""
    if kernel:
        A, Wvo = fold_gated_attention_params(p, cfg)
        return lambda h: gated_block_attention(h, keep_p, pad, A, Wvo,
                                               compute_bf16=cfg.compute_dtype == "bfloat16")
    keep = unpack_keep(keep_p, pad.shape[-1])
    return lambda h: _attention_with_keep(h, pad, keep, p, cfg)


def _layer_body_halo_free(cfg, p, x, keep_p, pad, wdense):
    """The sublayer composition of one gated layer on a halo-free layout
    (the neighbour mix is one block-local product): the fused layer's
    reference semantics and its backward's recompute, with the gated MHA
    kernel on the kernel route. Above _CHUNK_NB partitions in
    checkpointed chunks, each chunk's sublayers one after another."""
    dt = x.dtype
    kernel = _use_fused_attn(cfg, x.device)

    def body(xc, kc, pc, wc):
        def mix(g):
            agg = torch.matmul(wc.to(dt).float(), g.float()).to(dt)
            return _linear(p["w_gnn"], agg)

        return _compose_layer(cfg, p, xc, _attention(cfg, p, kc, pc, kernel), pc, mix)

    return _chunked_map(body, (x, keep_p, pad, wdense), x.shape[0], _CHUNK_NB)


def _kernel_wdense(cfg, bdg: BlockDenseGraph) -> torch.Tensor:
    """The edge table the layer kernels read: bf16 in bf16 compute mode
    (cast once per graph), else as stored."""
    return bdg.wdense_as(torch.bfloat16) if cfg.compute_dtype == "bfloat16" else bdg.wdense


def _flatten(p: dict):
    """A layer's parameters as (keys, leaves), in a fixed key order."""
    keys, leaves = [], []
    for k in sorted(p):
        if isinstance(p[k], dict):
            for kk in sorted(p[k]):
                keys.append((k, kk))
                leaves.append(p[k][kk])
        else:
            keys.append((k,))
            leaves.append(p[k])
    return tuple(keys), leaves


def _unflatten(keys, leaves) -> dict:
    p = {}
    for key, t in zip(keys, leaves):
        if len(key) == 1:
            p[key[0]] = t
        else:
            p.setdefault(key[0], {})[key[1]] = t
    return p


# set while torch.utils.checkpoint recomputes a layer's forward (remat)
_recompute_depth = 0


@contextlib.contextmanager
def _recomputing():
    global _recompute_depth
    _recompute_depth += 1
    try:
        yield
    finally:
        _recompute_depth -= 1


class _FusedLayer(torch.autograd.Function):
    """The one-kernel gated layer (K4a) with the JAX package's custom_vjp
    (gated.py:580-621): the forward saves only its inputs, and the backward
    recomputes _layer_body_halo_free under autograd (K5a/K5b inside on the
    kernel route). The edge table, the gate words and pad get no gradient
    (the JAX package's zero cotangents): the graph is data, not trained.
    Under remat the checkpoint's recompute of this forward skips the
    kernel: its output is never read there (the backward needs only the
    saved inputs), as XLA drops the dead recompute in the JAX package.
    The chunked loss's checkpoints keep the kernel in their recompute: a
    chunk's next layer reads this output there."""

    @staticmethod
    def forward(ctx, cfg, keys, keep_p, pad, wdense, x, *leaves):
        ctx.cfg, ctx.keys = cfg, keys
        ctx.save_for_backward(x, keep_p, pad, wdense, *leaves)
        if _recompute_depth:
            return torch.empty_like(x)
        return gated_block_layer(x, keep_p, pad, wdense,
                                 fold_gated_layer_params(_unflatten(keys, leaves), cfg),
                                 compute_bf16=cfg.compute_dtype == "bfloat16")

    @staticmethod
    def backward(ctx, g):
        x, keep_p, pad, wdense, *leaves = ctx.saved_tensors
        need = ctx.needs_input_grad[5:]
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_(n) for t, n in zip((x, *leaves), need)]
            out = _layer_body_halo_free(ctx.cfg, _unflatten(ctx.keys, inputs[1:]), inputs[0],
                                        keep_p, pad, wdense)
            wrt = [t for t in inputs if t.requires_grad]
            grads = iter(torch.autograd.grad(out, wrt, g.to(out.dtype), allow_unused=True)
                         if wrt else ())
        grads = [next(grads) if t.requires_grad else None for t in inputs]
        grads = [torch.zeros_like(t) if gr is None and t.requires_grad else gr
                 for t, gr in zip(inputs, grads)]
        return (None, None, None, None, None, *grads)


def _fused_layer_halo_free(cfg, p, x, keep_p, pad, wdense):
    """One-kernel gated layer forward (K4a), differentiable through
    _FusedLayer."""
    keys, leaves = _flatten(p)
    return _FusedLayer.apply(cfg, keys, keep_p, pad, wdense, x, *leaves)


def _use_fused_layer(bdg):
    """Whole-layer fusion needs every sublayer block-local: halo-free only."""
    return bdg.table == bdg.block


# the step takes the next layer's signature from the fused layer (K4b);
# False drives it through the standalone signature pass (K6c) instead
_FUSE_NEXT_SIG = True


def _layer_with_keep_emit_sig(p, p_next, cfg, x, bdg, keep_p):
    """Fused layer plus the next layer's gate signature (K4b). Returns
    (out, sig_next [nB]). Above _CHUNK_NB partitions one K4b a chunk: the
    signature's rows are block-local, so the chunks' rows joined are the
    straight launch's."""
    folded = fold_gated_layer_params(p, cfg)
    sig = (_fold_sig_params(p_next, cfg), *_ln_vectors(p_next["ln1"]))

    def run(xc, kc, pc, wc):
        return gated_block_layer_with_sig(xc, kc, pc, wc, folded, *sig,
                                          compute_bf16=cfg.compute_dtype == "bfloat16",
                                          sig_eps=cfg.eps)

    out, rsum, rcnt = _chunked_map(run, (x, keep_p, bdg.node_pad, _kernel_wdense(cfg, bdg)),
                                   x.shape[0], _CHUNK_NB)
    return out, _row_mean_signature(rsum, rcnt)


def _layer_with_keep(p, cfg, x, bdg, keep_p, fused=False):
    """One layer under bit-packed masks keep_p [nB, ceil(B/32), B] int32.
    The kernel route on a halo-free layout is one fused kernel (K4a), one
    a chunk above _CHUNK_NB partitions; with the fused layer switched off
    there, the plain composition of _layer_body_halo_free; with a halo it
    is LN1, the gated MHA kernel (K5a) and the plain neighbour mix and
    FFN; otherwise the plain sublayer composition. Every tensor between
    the sublayers stays in x's dtype."""
    pad = bdg.node_pad
    use_fused = fused and _use_fused_attn(cfg, x.device)
    if use_fused and _use_fused_layer(bdg):
        # no checkpoint: the Function keeps only its inputs (views of the
        # full tensors) and its backward recomputes one chunk's body
        return _chunked_map(lambda *a: _fused_layer_halo_free(cfg, p, *a),
                            (x, keep_p, pad, _kernel_wdense(cfg, bdg)), x.shape[0], _CHUNK_NB,
                            checkpoint=False)
    if use_fused and bdg.table == bdg.block:
        return _layer_body_halo_free(cfg, p, x, keep_p, pad, bdg.wdense)
    return _compose_layer(cfg, p, x, _attention(cfg, p, keep_p, pad, use_fused), pad,
                          lambda g: _neighbor_mix(g, bdg, p["w_gnn"]))


def _remat(cfg, layer, *args):
    """layer(*args), checkpointed when cfg.remat (see _FusedLayer)."""
    if not cfg.remat:
        return layer(*args)
    return torch.utils.checkpoint.checkpoint(
        layer, *args, use_reentrant=False,
        context_fn=lambda: (contextlib.nullcontext(), _recomputing()))


def check_gate_age_feasibility(cfg: GatedGraphTransformerConfig, nb: int,
                               max_resolve: int | None = None) -> bool:
    """The hard staleness bound (max_gate_age) holds under saturating drift
    only when nB <= 2 * budget * max_gate_age (the escalation pass doubles
    the per-step budget on bound-threatening steps). Returns True when the
    bound is enforceable; warns and returns False otherwise, and returns
    False without a warning for max_gate_age = 0 (pure hysteresis)."""
    if cfg.max_gate_age <= 0:
        return False
    budget = max_resolve if max_resolve is not None else max(
        1, int(nb * cfg.max_resolve_frac))
    if nb > 2 * budget * cfg.max_gate_age:
        warnings.warn(
            f"gate staleness bound INFEASIBLE: nB={nb} > 2*budget"
            f"({budget})*max_gate_age({cfg.max_gate_age}) — under "
            f"saturating drift the realized mask age can exceed the "
            f"bound. Raise max_resolve_frac to >= "
            f"{1 / (2 * cfg.max_gate_age):.4f} "
            f"(budget >= {-(-nb // (2 * cfg.max_gate_age))}) or "
            f"max_gate_age to >= {-(-nb // (2 * budget))}.",
            stacklevel=3)
        return False
    return True


def gate_state_init(params, cfg: GatedGraphTransformerConfig, fpad, bdg: BlockDenseGraph):
    """Solve every partition's gate once and record the signatures.
    Returns {"keep": [L, nB, ceil(B/32), B] int32 (pack_keep), "sig":
    [L, nB] float32, "age": [L, nB] int32}."""
    return _gate_state_init(params, cfg, fpad, bdg, bdg.n_blocks, 0)


def _gate_state_init(params, cfg, fpad, bdg: BlockDenseGraph, nb_total: int, offset: int):
    """gate_state_init over partitions [offset, offset + nB) of a model of
    nb_total partitions (a rank's share; parallel/gated.py)."""
    if cfg.gate_mode != "pooled":
        raise ValueError(
            "temporal gate reuse operates on the pooled (head-mean) gate "
            "granularity; use the stateless apply for per_head mode")
    nb, b = bdg.n_blocks, bdg.block
    check_gate_age_feasibility(cfg, nb_total)
    x = fpad.reshape(nb, b, -1)
    fused = _use_fused_attn(cfg, x.device)
    gate_kernel = fused and b % 32 == 0
    keeps, sigs = [], []
    for p in params:
        A_sig = _fold_sig_params(p, cfg)
        if gate_kernel:
            keeps.append(_solve_gates_kernel(x, bdg.node_pad, A_sig, p, cfg))
            sigs.append(_signature_from_x(x, p, A_sig, bdg.node_pad, cfg))
        else:
            h = _ln(p["ln1"], x).to(x.dtype)
            # in runs of gate_chunk partitions: one run's pooled logits and
            # gate buffers at a time
            keeps.append(_chunked_map(lambda hc, pc: _solve_gates_plain(hc, pc, A_sig, cfg),
                                      (h, bdg.node_pad), nb, cfg.gate_chunk, checkpoint=False))
            sigs.append(_signature_fused_x(h, A_sig, bdg.node_pad, cfg) if fused else
                        _gate_signature(_pooled_from_x(h, bdg.node_pad, A_sig), cfg.eps))
        x = _layer_with_keep(p, cfg, x, bdg, keeps[-1], fused=True)
    age0 = torch.zeros((len(params), nb), dtype=torch.int32, device=x.device)
    if cfg.max_gate_age > 0:
        # staggered initial ages, so that the partitions do not all reach
        # the hard bound on the same step
        age0 += torch.arange(offset, offset + nb, dtype=torch.int32,
                             device=x.device) % cfg.max_gate_age
    return {"keep": torch.stack(keeps), "sig": torch.stack(sigs), "age": age0}


class _LocalBudget:
    """The re-solve selection over the partitions of one process."""

    @staticmethod
    def any(mask: torch.Tensor) -> bool:
        return bool(mask.any())

    @staticmethod
    def top(score: torch.Tensor, flagged: torch.Tensor, budget: int):
        """(indices of the partitions to re-solve, how many): the `budget`
        highest scores among the flagged partitions; equal scores take the
        lower index first, as lax.top_k does."""
        idx = torch.sort(score, descending=True, stable=True).indices[:budget]
        idx = idx[flagged[idx]]
        return idx, int(idx.numel())


def _refresh(flagged, drift, keep_prev, sig_prev, age, sig, solve_masks, budget, select):
    """Re-solve up to `budget` flagged partitions, oldest first (then by
    drift), chosen by `select`. Returns (keep, sig, age, number
    re-solved)."""
    score = torch.where(flagged, age.float() * 1e6 + drift, torch.full_like(drift, -1.0))
    idx, n = select.top(score, flagged, budget)
    keep_l, sig_l, age_l = keep_prev.clone(), sig_prev.clone(), age.clone()
    if idx.numel():
        keep_l[idx] = solve_masks(idx)
        sig_l[idx] = sig[idx]
        age_l[idx] = 0
    return keep_l, sig_l, age_l, n


def gated_graph_transformer_step(params, cfg: GatedGraphTransformerConfig, fpad,
                                 bdg: BlockDenseGraph, state: dict,
                                 max_resolve: int | None = None):
    """Forward with temporal gate reuse. Returns (out [nB*B, D], new_state,
    n_resolved).

    Per layer: the signature, the partitions whose signature drifted past
    the band (or, with max_gate_age, reached the age bound), a batched
    re-solve of the oldest max_resolve of them, and the layer under the
    refreshed masks. Undrifted partitions keep their stored mask.
    """
    return _step(params, cfg, fpad, bdg, state, max_resolve, bdg.n_blocks, _LocalBudget)


def _step(params, cfg, fpad, bdg: BlockDenseGraph, state: dict, max_resolve, nb_total: int,
          select):
    """gated_graph_transformer_step over this process's nB partitions of a
    model of nb_total: the budget is taken over nb_total, and `select`
    picks the partitions to re-solve (a rank's share takes a global
    choice; parallel/gated.py)."""
    nb, b = bdg.n_blocks, bdg.block
    if max_resolve is None:
        max_resolve = max(1, int(nb_total * cfg.max_resolve_frac))
    max_resolve = min(max_resolve, nb_total)
    check_gate_age_feasibility(cfg, nb_total, max_resolve)
    x = fpad.reshape(nb, b, -1)
    new_keep, new_sig, new_age = [], [], []
    resolved = 0
    ages = state.get("age")
    if ages is None:
        ages = torch.zeros((len(params), nb), dtype=torch.int32, device=x.device)
    fused = _use_fused_attn(cfg, x.device)
    gate_kernel = fused and b % 32 == 0
    emit_sig = _FUSE_NEXT_SIG and gate_kernel and _use_fused_layer(bdg)
    carried_sig = None
    for li, p in enumerate(params):
        A_sig = _fold_sig_params(p, cfg)
        if gate_kernel:
            sig = (carried_sig if carried_sig is not None
                   else _signature_from_x(x, p, A_sig, bdg.node_pad, cfg))

            def solve_masks(idx, p=p, A_sig=A_sig, x=x):
                return _solve_gates_kernel(x[idx].contiguous(),
                                           bdg.node_pad[idx].contiguous(), A_sig, p, cfg)
        else:
            h = _ln(p["ln1"], x).to(x.dtype)
            sig = (_signature_fused_x(h, A_sig, bdg.node_pad, cfg) if fused else
                   _gate_signature(_pooled_from_x(h, bdg.node_pad, A_sig), cfg.eps))

            def solve_masks(idx, h=h, A_sig=A_sig):
                return _solve_gates_plain(h[idx], bdg.node_pad[idx], A_sig, cfg)
        prev_sig = state["sig"][li]
        drift = torch.abs(sig - prev_sig)
        flagged = drift > cfg.hysteresis_band * (torch.abs(prev_sig) + 1e-6)
        age = ages[li] + 1
        if cfg.max_gate_age > 0:
            flagged = flagged | (age >= cfg.max_gate_age)
        keep_l, sig_l, age_l = state["keep"][li], prev_sig, age
        # zero drift: no solve at all (one host sync per layer)
        if select.any(flagged):
            keep_l, sig_l, age_l, nres = _refresh(flagged, drift, keep_l, sig_l, age_l, sig,
                                                  solve_masks, max_resolve, select)
            resolved += nres
        if cfg.max_gate_age > 0:
            # budget escalation: partitions still at or over the age bound
            # get a second budget-sized solve
            overflow = age_l >= cfg.max_gate_age
            if select.any(overflow):
                keep_l, sig_l, age_l, nres = _refresh(overflow, drift, keep_l, sig_l, age_l,
                                                      sig, solve_masks, max_resolve, select)
                resolved += nres
        new_keep.append(keep_l)
        new_sig.append(sig_l)
        new_age.append(age_l)
        if emit_sig and li + 1 < len(params):
            x, carried_sig = _layer_with_keep_emit_sig(p, params[li + 1], cfg, x, bdg, keep_l)
        else:
            carried_sig = None
            x = _layer_with_keep(p, cfg, x, bdg, keep_l, fused=True)
    new_state = {"keep": torch.stack(new_keep), "sig": torch.stack(new_sig),
                 "age": torch.stack(new_age)}
    return x.reshape(nb * b, -1), new_state, resolved


def gated_graph_transformer_apply_with_masks(params, cfg: GatedGraphTransformerConfig, fpad,
                                             bdg: BlockDenseGraph, keep_masks):
    """Differentiable forward under fixed bit-packed masks [L, nB,
    ceil(B/32), B] (from the gate state); no gate solve."""
    nb, b = bdg.n_blocks, bdg.block
    x = fpad.reshape(nb, b, -1)

    def layer(p, x, keep):
        return _layer_with_keep(p, cfg, x, bdg, keep, fused=True)

    for li, p in enumerate(params):
        x = _remat(cfg, layer, p, x, keep_masks[li])
    return x.reshape(nb * b, -1)


def _loss_chunked_halo_free(params, cfg, x, pad, wdense, keep_masks, tgt):
    """The whole-model loss on a halo-free layout, one chunk of _CHUNK_NB
    partitions at a time: every sublayer is block-local, so the L-layer
    network and the loss sums run end to end per chunk, each chunk
    checkpointed (no full-width activation stays alive; the backward
    recomputes one chunk's layers, K4a each, and each fused layer's
    backward recomputes its body, K5a and K5b), and the parameter
    gradients add up across chunks. x, tgt [nB, B, D], pad [nB, B], wdense
    [nB, B, B], keep_masks [L, nB, ceil(B/32), B]."""
    nb = x.shape[0]

    def chunk_sums(xc, pc, wc, tc, *kcs):
        for p, kc in zip(params, kcs):
            xc = _fused_layer_halo_free(cfg, p, xc, kc, pc, wc)
        err = (xc - tc).float() * pc[..., None]
        return torch.sum(err * err), torch.sum(pc)

    err_sum = pad_sum = 0.0
    for s in range(0, nb, _CHUNK_NB):
        part = [t[s:s + _CHUNK_NB] for t in (x, pad, wdense, tgt, *keep_masks)]
        es, ps = _checkpointed(chunk_sums, *part)
        err_sum, pad_sum = err_sum + es, pad_sum + ps
    return err_sum / torch.clamp(pad_sum, min=1.0)


def gated_graph_transformer_loss_with_masks(params, cfg: GatedGraphTransformerConfig, fpad,
                                            bdg: BlockDenseGraph, keep_masks, targets):
    """Mean-squared node-embedding loss under fixed masks: the train
    step's loss (benchmarks/config5_r03.py:204-226). Above _CHUNK_NB
    partitions of a halo-free layout on the kernel route, the whole-model
    chunked loss (_loss_chunked_halo_free; cfg.remat has no effect there,
    each chunk is checkpointed)."""
    nb, b = bdg.n_blocks, bdg.block
    if nb > _CHUNK_NB and _use_fused_attn(cfg, fpad.device) and _use_fused_layer(bdg):
        return _loss_chunked_halo_free(params, cfg, fpad.reshape(nb, b, -1), bdg.node_pad,
                                       _kernel_wdense(cfg, bdg), keep_masks,
                                       targets.reshape(nb, b, -1))
    return _loss(gated_graph_transformer_apply_with_masks(params, cfg, fpad, bdg, keep_masks),
                 bdg, targets)
