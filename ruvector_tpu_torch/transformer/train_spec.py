"""Early-exit (LayerSkip-style) training so speculative decoding has a
REAL draft (port of ruvector_tpu/transformer/train_spec.py): the first
`draft_layers` layers + the shared head learn to predict the next token
alongside the full model, so the layer-prefix draft of spec_decode.py
agrees with the full model's argmax.

Reference: ruvector-mincut-gated-transformer/src/speculative.rs:199-330
(draft proposals verified by the full model) + early_exit.rs (the prefix
head).

Float (quantize=False) weights; the corpus is a peaked order-1 Markov
chain, the minimal task where next-token argmax is learnable by both the
prefix and the full model. Adam follows optax step for step
(training/optimizers.adam).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ruvector_tpu_torch.attention.rope import rope_tables
from ruvector_tpu_torch.device import resolve_device
from ruvector_tpu_torch.training.optimizers import (
    adam,
    apply_updates,
    tree_leaves,
    tree_map,
    tree_unflatten,
)
from ruvector_tpu_torch.transformer.config import TransformerConfig
from ruvector_tpu_torch.transformer.model import (
    _apply_dense,
    _embed,
    _layer_fn,
    _ln,
    _windowed_causal_mask,
    init_weights,
)


def markov_corpus(chain_seed: int, vocab: int, n_seq: int, seq_len: int,
                  peak: float = 0.92,
                  sample_seed: int | None = None
                  ) -> tuple[np.ndarray, np.ndarray]:
    """Sequences from a peaked order-1 Markov chain. `chain_seed` fixes
    the transition matrix; `sample_seed` varies the draws (held-out sets
    share the chain, not the sequences). Returns (tokens [n_seq,
    seq_len], transition argmax [vocab])."""
    rng = np.random.default_rng(chain_seed)
    succ = rng.permutation(vocab)                 # deterministic successor
    probs = np.full((vocab, vocab), (1 - peak) / (vocab - 1))
    probs[np.arange(vocab), succ] = peak
    srng = np.random.default_rng(
        chain_seed if sample_seed is None else sample_seed)
    toks = np.zeros((n_seq, seq_len), np.int32)
    toks[:, 0] = srng.integers(0, vocab, n_seq)
    for t in range(1, seq_len):
        u = srng.random((n_seq, 1))
        cum = np.cumsum(probs[toks[:, t - 1]], axis=1)
        toks[:, t] = (u > cum).sum(axis=1)
    return toks, succ


def seq_logits_at_depths(weights, cfg: TransformerConfig, tokens: torch.Tensor,
                         depths) -> list[torch.Tensor]:
    """Teacher-forced forward of tokens [(B,) S]; logits [(B,) S, logits]
    at each depth in `depths` (shared final_ln + head, matching the
    spec_decode draft path)."""
    s = tokens.shape[-1]
    dev = tokens.device
    # the reference's tables here: max(seq_len_max, S) positions, no scaling
    cos_t, sin_t = rope_tables(cfg.head_dim, max(cfg.seq_len_max, s), cfg.rope_base,
                               device=dev)
    mask = _windowed_causal_mask(s, cfg.seq_len_max, dev)
    x = _embed(weights, tokens)
    outs = {}
    for li, layer in enumerate(weights["layers"]):
        x = _layer_fn(layer, x, cos_t, sin_t, mask, cfg.heads)
        if (li + 1) in depths:
            outs[li + 1] = _apply_dense(weights["head"], _ln(weights["final_ln"], x))
    return [outs[d] for d in depths]


def _next_token_ce(logits: torch.Tensor, toks: torch.Tensor, vocab: int) -> torch.Tensor:
    """Mean next-token cross-entropy per sequence [B]."""
    logp = torch.log_softmax(logits[:, :-1, :vocab], dim=-1)
    return -torch.mean(torch.gather(logp, -1, toks[:, 1:, None]).squeeze(-1), dim=-1)


def early_exit_loss(weights, cfg: TransformerConfig, batch_toks: torch.Tensor,
                    draft_layers: int, draft_loss_weight: float = 0.7) -> torch.Tensor:
    """Joint loss over batch_toks [B, S]: per sequence, full-depth CE plus
    draft_loss_weight x draft-depth CE; the mean over the batch."""
    toks = batch_toks.long()
    ld, lf = seq_logits_at_depths(weights, cfg, toks, (draft_layers, cfg.layers))
    per_seq = (_next_token_ce(lf, toks, cfg.vocab)
               + draft_loss_weight * _next_token_ce(ld, toks, cfg.vocab))
    return torch.mean(per_seq)


@dataclasses.dataclass(frozen=True)
class SpecTrainResult:
    weights: dict
    losses: list
    full_acc: float        # next-token argmax accuracy, full depth
    draft_acc: float       # next-token argmax accuracy, prefix depth
    agreement: float       # fraction of positions where argmaxes agree


def train_early_exit(cfg: TransformerConfig, draft_layers: int = 1,
                     steps: int = 300, batch: int = 32, seq_len: int = 48,
                     lr: float = 3e-3, seed: int = 0,
                     draft_loss_weight: float = 0.7, init=None,
                     device=None) -> SpecTrainResult:
    """Train full-depth + prefix-depth CE jointly; returns trained float
    weights ready for make_speculative_generate_fn. `init`: a
    torch.Generator or a numpy pytree of float weights in the JAX layout
    (default: a generator seeded with `seed`)."""
    dev = resolve_device(device)
    toks_np, _ = markov_corpus(seed, cfg.vocab, n_seq=512, seq_len=seq_len)
    if init is None:
        init = torch.Generator().manual_seed(seed)
    weights = init_weights(init, cfg, quantize=False, device=dev)
    opt = adam(lr)
    opt_state = opt.init(weights)

    rng = np.random.default_rng(seed + 1)
    losses = []
    for _ in range(steps):
        idx = rng.integers(0, len(toks_np), batch)
        w = tree_map(lambda t: t.detach().requires_grad_(True), weights)
        loss = early_exit_loss(w, cfg, torch.from_numpy(toks_np[idx]).to(dev), draft_layers,
                               draft_loss_weight)
        grads = tree_unflatten(w, torch.autograd.grad(loss, tree_leaves(w)))
        updates, opt_state = opt.update(grads, opt_state, weights)
        weights = apply_updates(weights, updates)
        losses.append(float(loss.detach()))

    # eval: argmax accuracy + draft/full agreement on held-out sequences
    # (same chain, fresh draws)
    ev_np, _ = markov_corpus(seed, cfg.vocab, n_seq=64, seq_len=seq_len,
                             sample_seed=seed + 99)
    seqs = torch.from_numpy(ev_np).to(dev).long()
    with torch.no_grad():
        ld, lf = seq_logits_at_depths(weights, cfg, seqs, (draft_layers, cfg.layers))
        pf = torch.argmax(lf[:, :-1, :cfg.vocab], dim=-1)
        pd = torch.argmax(ld[:, :-1, :cfg.vocab], dim=-1)
        tgt = seqs[:, 1:]

        def mean_of_means(hit):
            return float(torch.mean(torch.mean(hit.to(torch.float32), dim=-1)))

        f, d, a = mean_of_means(pf == tgt), mean_of_means(pd == tgt), mean_of_means(pf == pd)
    return SpecTrainResult(weights=weights, losses=losses, full_acc=f, draft_acc=d,
                           agreement=a)
