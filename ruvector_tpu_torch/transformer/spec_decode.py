"""Self-speculative decoding: layer-prefix draft + parallel verify (port of
ruvector_tpu/transformer/spec_decode.py).

Reference: ruvector-mincut-gated-transformer/src/speculative.rs feeds
model.rs's serving loop with draft tokens that the full model verifies.
The draft is an EARLY-EXIT PREFIX of the same model (the first
`draft_layers` layers + the shared head, early_exit.rs); one full forward
verifies a whole chunk, its per-token GEMVs batched into GEMMs. Greedy
acceptance keeps the output identical in token space to plain greedy
decoding (the same argmax chain).

A macro step (chunk of gamma tokens):
  1. draft gamma-1 tokens autoregressively with the prefix, attending over
     the committed KV cache + the chunk so far (no cache writes)
  2. verify: the full model over the whole chunk in one pass (causal
     inside the chunk, the cache beyond it)
  3. accept the longest agreeing prefix; commit its K/V into the tiered
     cache with O(1) conditional appends (enabled = i < n_commit)
  4. the target's own argmax at the cut is the next chunk's first token
     (bonus token): at least one token commits per step

Draft and verify never write the cache, so rejected tokens leave no trace.

Batches: with batched caches and first tokens [B], each sequence keeps its
own cursor and cache length. The loop runs until every member is done; a
member that is done is frozen as the reference's vmapped while_loop
freezes it (its tokens, caches, commits and acceptance stay as they are;
its cache writes go to the scratch rows with `enabled` False). The host
reads one flag per macro step: whether any member is still running.
"""

from __future__ import annotations

import dataclasses

import torch

from ruvector_tpu_torch.attention.rope import rope_rotate
from ruvector_tpu_torch.device import resolve_device
from ruvector_tpu_torch.transformer.config import TransformerConfig
from ruvector_tpu_torch.transformer.decode import decode_rope_tables, token_layer
from ruvector_tpu_torch.transformer.kv_cache import (
    KVCacheConfig,
    _as_batch,
    _unbatch,
    kv_cache_append,
    kv_cache_read,
)
from ruvector_tpu_torch.transformer.model import MASKED, _apply_dense, _embed, _gelu, _ln


@dataclasses.dataclass(frozen=True)
class SpecDecodeConfig:
    gamma: int = 4           # chunk size (1 bonus + gamma-1 drafts)
    draft_layers: int = 1    # early-exit prefix depth for the draft model


def accepted_drafts(chunk_toks: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Drafts accepted per sequence [B]: draft i (i >= 1) is accepted iff
    drafts 1..i all matched the target argmax at the chunk position before
    them. chunk_toks, targets [B, gamma]."""
    agree = chunk_toks[:, 1:] == targets[:, :-1]
    return torch.cumprod(agree.to(torch.int64), dim=-1).sum(dim=-1)


def _verify_layer(layer, X, poss, ck, cv, cm, causal, cos_t, sin_t, heads):
    """The chunk X [B, G, hidden] at positions poss [B, G] through one
    layer, against the cache (ck, cv [B, T, H, hd], cm [B, T]) and causally
    inside the chunk. The cache part and the chunk part of the context are
    summed as two products, as the reference does (spec_decode.py:160-205);
    one softmax product over their concatenation would round otherwise."""
    b, g, d = X.shape
    hd = d // heads
    h = _ln(layer["ln1"], X)
    q, k, v = torch.split(_apply_dense(layer["qkv"], h), d, dim=-1)
    p = poss[:, :, None]
    q = rope_rotate(q.reshape(b, g, heads, hd), p, cos_t, sin_t)     # [B, G, H, hd]
    k = rope_rotate(k.reshape(b, g, heads, hd), p, cos_t, sin_t)
    v = v.reshape(b, g, heads, hd)
    scale = 1.0 / (hd ** 0.5)
    s_cache = torch.einsum("bghd,bthd->bght", q, ck) * scale
    s_cache = torch.where(cm[:, None, None, :] > 0, s_cache, MASKED)
    s_chunk = torch.einsum("bghd,bjhd->bghj", q, k) * scale
    s_chunk = torch.where(causal[None, :, None, :], s_chunk, MASKED)
    attn = torch.softmax(torch.cat([s_cache, s_chunk], dim=-1), dim=-1)
    tc = ck.shape[1]
    ctx = (torch.einsum("bght,bthd->bghd", attn[..., :tc], cv)
           + torch.einsum("bghj,bjhd->bghd", attn[..., tc:], v))
    X = X + _apply_dense(layer["out"], ctx.reshape(b, g, d))
    h2 = _ln(layer["ln2"], X)
    X = X + _apply_dense(layer["ffn_out"], _gelu(_apply_dense(layer["ffn_in"], h2)))
    return X, k, v


def make_speculative_generate_fn(
    config: TransformerConfig,
    cache_cfg: KVCacheConfig,
    spec: SpecDecodeConfig,
    max_new_tokens: int,
    device=None,
):
    """Build generate(weights, caches, first_token) ->
    (tokens [max_new_tokens] int32, count, caches, accepted_total,
    commits [max_new_tokens]), each with a leading [B] for batched caches
    and first tokens [B].

    `first_token` seeds the chain (e.g. the last prompt token's argmax);
    run the prompt through the decode step first to fill the caches. Token
    output is identical to greedy decoding.
    """
    dev = resolve_device(device)
    heads, hd = config.heads, config.head_dim
    gamma, dl = spec.gamma, spec.draft_layers
    cos_t, sin_t = decode_rope_tables(config, dev)
    macro_steps = max_new_tokens     # worst case one token per macro step
    idx = torch.arange(gamma, device=dev)
    causal = idx[None, :] <= idx[:, None]                    # [G, G]

    def generate(weights, caches, first_token):
        one = caches[0].length.dim() == 0
        if one:
            caches = [_as_batch(c)[0] for c in caches]
        n_layers = len(weights["layers"])
        b = torch.as_tensor(first_token, device=dev).reshape(-1).long()
        nb = b.shape[0]
        rows = torch.arange(nb, device=dev)
        cursor = torch.zeros(nb, dtype=torch.long, device=dev)
        out = torch.zeros(nb, max_new_tokens + 1, dtype=torch.int32, device=dev)
        acc_total = torch.zeros(nb, dtype=torch.int32, device=dev)
        commits = torch.zeros(nb, macro_steps, dtype=torch.int32, device=dev)

        for step in range(macro_steps):
            active = cursor < max_new_tokens
            if not bool(active.any()):        # the one host read per macro step
                break
            base_pos = caches[0].length.long()  # committed length = position of b
            reads = [kv_cache_read(cache_cfg, c) for c in caches]

            # ---- 1. draft gamma-1 tokens with the layer prefix ----
            dk = [torch.zeros(nb, gamma, heads, hd, device=dev) for _ in range(dl)]
            dv = [torch.zeros(nb, gamma, heads, hd, device=dev) for _ in range(dl)]
            toks = torch.zeros(nb, gamma, dtype=torch.long, device=dev)
            cur = b
            for i in range(gamma):
                toks[:, i] = cur
                if i == gamma - 1:
                    break      # the last draft's own forward predicts nothing kept
                cmask = (idx < i).to(torch.float32).expand(nb, gamma)
                x = _embed(weights, cur)
                for li in range(dl):
                    ck, cv, cm = reads[li]
                    x, k, v = token_layer(
                        weights["layers"][li], x, base_pos + i, torch.cat([ck, dk[li]], 1),
                        torch.cat([cv, dv[li]], 1), torch.cat([cm, cmask], 1),
                        cos_t, sin_t, heads)
                    dk[li][:, i] = k
                    dv[li][:, i] = v
                logits = _apply_dense(weights["head"], _ln(weights["final_ln"], x))
                cur = torch.argmax(logits, dim=-1)

            # ---- 2. verify: the full model over the whole chunk ----
            X = _embed(weights, toks)                         # [B, G, hidden]
            poss = base_pos[:, None] + idx                    # [B, G]
            vks, vvs = [], []
            for li in range(n_layers):
                ck, cv, cm = reads[li]
                X, k, v = _verify_layer(weights["layers"][li], X, poss, ck, cv, cm, causal,
                                        cos_t, sin_t, heads)
                vks.append(k)
                vvs.append(v)
            chunk_logits = _apply_dense(weights["head"], _ln(weights["final_ln"], X))
            targets = torch.argmax(chunk_logits, dim=-1)      # [B, G]

            # ---- 3. accept the longest agreeing prefix of the drafts ----
            n_acc = accepted_drafts(toks, targets)            # in [0, gamma-1]
            n_commit = torch.where(active, 1 + n_acc, 0)      # frozen: nothing

            # ---- 4. commit the accepted chunk K/V ----
            new_caches = []
            for li, c in enumerate(caches):
                for i in range(gamma):
                    c = kv_cache_append(cache_cfg, c, vks[li][:, i], vvs[li][:, i],
                                        enabled=i < n_commit)
                new_caches.append(c)
            caches = new_caches

            # ---- 5. emit committed tokens; next chain token ----
            emit_pos = cursor[:, None] + idx
            ok = (idx < n_commit[:, None]) & (emit_pos < max_new_tokens)
            # disabled writes land on the scratch slot max_new_tokens
            out[rows[:, None], torch.where(ok, emit_pos, max_new_tokens)] = toks.to(torch.int32)
            b = torch.where(active, targets[rows, n_acc], b)
            cursor = cursor + n_commit
            acc_total = acc_total + torch.where(active, n_acc, 0).to(torch.int32)
            commits[:, step] = n_commit.to(torch.int32)

        count = torch.clamp(cursor, max=max_new_tokens).to(torch.int32)
        res = (out[:, :max_new_tokens], count, caches, acc_total, commits)
        if one:
            return (res[0][0], res[1][0], [_unbatch(c) for c in caches], res[3][0], res[4][0])
        return res

    return generate
