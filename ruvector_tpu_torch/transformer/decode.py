"""Incremental decoding with the tiered KV cache (port of
ruvector_tpu/transformer/decode.py).

Reference: the serving path of ruvector-mincut-gated-transformer —
model.rs run_layers with KV reads/writes (kv_cache/manager.rs), gate-
controlled flush (FlushKv decision), and speculative decoding
(speculative.rs).

The decode step embeds a token, then per layer attends over the cache's
K/V and the new token and appends to the cache, then projects to logits.
It runs B sequences at once when the caches carry a batch dimension (the
reference's vmap): per-token GEMVs become [B, hidden] GEMMs. The
generation loops run on the host, one step per position, with the argmax
on the device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ruvector_tpu_torch.attention.rope import rope_rotate, rope_tables
from ruvector_tpu_torch.device import resolve_device
from ruvector_tpu_torch.transformer.config import GatePolicy, TransformerConfig
from ruvector_tpu_torch.transformer.gate import GateController
from ruvector_tpu_torch.transformer.kv_cache import (
    KVCacheConfig,
    KVCacheState,
    _as_batch,
    _unbatch,
    kv_cache_append,
    kv_cache_flush,
    kv_cache_init,
    kv_cache_read,
)
from ruvector_tpu_torch.transformer.model import MASKED, _apply_dense, _embed, _gelu, _ln
from ruvector_tpu_torch.transformer.packets import GateDecision, GatePacket


def decode_rope_tables(config: TransformerConfig, device) -> tuple[torch.Tensor, torch.Tensor]:
    """The decode paths' RoPE tables: max(seq_len_max * 8, 1024) positions,
    as the reference builds them (decode.py:45-48, spec_decode.py:79-82)."""
    return rope_tables(config.head_dim, max(config.seq_len_max * 8, 1024), config.rope_base,
                       config.rope_scaling, config.rope_scaling_factor, device=device)


def _attend(q, ks, vs, mask, hd):
    """q [B, H, hd] against ks/vs [B, T, H, hd] under mask [B, T] -> [B, H, hd]."""
    scale = 1.0 / (hd ** 0.5)
    scores = torch.einsum("bhd,bthd->bht", q, ks) * scale
    scores = torch.where(mask[:, None, :] > 0, scores, MASKED)
    attn = torch.softmax(scores, dim=-1)
    return torch.einsum("bht,bthd->bhd", attn, vs)


def token_layer(layer, x, pos, ctx_k, ctx_v, ctx_mask, cos_t, sin_t, heads):
    """One token per sequence (x [B, hidden], positions pos [B]) through one
    layer, attending its context ctx_k/ctx_v [B, T, H, hd] under ctx_mask
    [B, T] and itself. Returns (x, k, v), k and v [B, H, hd] rotated."""
    b, d = x.shape
    hd = d // heads
    h = _ln(layer["ln1"], x)
    q, k, v = torch.split(_apply_dense(layer["qkv"], h), d, dim=-1)
    p = pos[:, None]
    q = rope_rotate(q.reshape(b, heads, hd), p, cos_t, sin_t)
    k = rope_rotate(k.reshape(b, heads, hd), p, cos_t, sin_t)
    v = v.reshape(b, heads, hd)
    all_k = torch.cat([ctx_k, k[:, None]], dim=1)
    all_v = torch.cat([ctx_v, v[:, None]], dim=1)
    all_mask = torch.cat([ctx_mask, torch.ones_like(ctx_mask[:, :1])], dim=1)
    ctx = _attend(q, all_k, all_v, all_mask, hd).reshape(b, d)
    x = x + _apply_dense(layer["out"], ctx)
    h2 = _ln(layer["ln2"], x)
    x = x + _apply_dense(layer["ffn_out"], _gelu(_apply_dense(layer["ffn_in"], h2)))
    return x, k, v


def make_decode_step(config: TransformerConfig, cache_cfg: KVCacheConfig, device=None):
    """Build the single-token decode step.

    step(weights, caches [L], token_id, position, kv_write_enabled) ->
        (logits, new_caches)
    One sequence: unbatched caches, a token id and position (ints or 0-dim
    tensors), logits [logits]. B sequences: batched caches, token_id [B],
    position an int or [B], kv_write_enabled a bool or [B]; logits
    [B, logits]. When the gate freezes KV writes the step still attends
    over the existing cache but does not extend it.
    """
    dev = resolve_device(device)
    cos_t, sin_t = decode_rope_tables(config, dev)
    heads = config.heads

    def step(weights, caches, token_id, position, kv_write_enabled):
        one = caches[0].length.dim() == 0
        if one:
            caches = [_as_batch(c)[0] for c in caches]
        b = caches[0].length.shape[0]
        tok = torch.as_tensor(token_id, device=dev).reshape(-1)
        pos = torch.as_tensor(position, device=dev).reshape(-1).long().expand(b)
        x = _embed(weights, tok)                              # [B, hidden]
        new_caches = []
        for layer, cache in zip(weights["layers"], caches):
            ck, cv, cmask = kv_cache_read(cache_cfg, cache)  # [B, T, H, hd]
            x, k, v = token_layer(layer, x, pos, ck, cv, cmask, cos_t, sin_t, heads)
            # O(1) conditional append: a disabled write lands in the
            # scratch rows (see kv_cache.py)
            new_caches.append(kv_cache_append(cache_cfg, cache, k, v, enabled=kv_write_enabled))
        logits = _apply_dense(weights["head"], _ln(weights["final_ln"], x))
        if one:
            return logits[0], [_unbatch(c) for c in new_caches]
        return logits, new_caches

    return step


@dataclasses.dataclass
class GenerationResult:
    tokens: list[int]
    kv_flushes: int
    frozen_steps: int
    accepted: int = 0      # speculative path: drafts accepted in total


def make_generate_fn(config: TransformerConfig, cache_cfg: KVCacheConfig,
                     prompt_len: int, max_new_tokens: int, device=None):
    """Whole-generation loop: prompt consumption, then greedy decoding.

    Returns generate(weights, caches, prompt_ids [prompt_len]) ->
        (tokens [prompt_len + max_new_tokens] int32, caches): the token
    consumed at each position. With batched caches and prompt_ids
    [B, prompt_len] it decodes the B sequences together (tokens [B, ...]).
    """
    dev = resolve_device(device)
    step = make_decode_step(config, cache_cfg, dev)
    total = prompt_len + max_new_tokens

    def generate(weights, caches, prompt_ids):
        prompt = torch.as_tensor(prompt_ids, device=dev).long()
        logits = None
        toks = []
        for pos in range(total):
            # the prompt token, or the argmax of the last logits past it
            tok = prompt[..., pos] if pos < prompt_len else torch.argmax(logits, dim=-1)
            logits, caches = step(weights, caches, tok, pos, True)
            toks.append(tok)
        return torch.stack(toks, dim=-1).to(torch.int32), caches

    return generate


def make_batched_generate_fn(config: TransformerConfig, cache_cfg: KVCacheConfig,
                             prompt_len: int, max_new_tokens: int, device=None):
    """Batched serving decode with shared weights: per-token GEMVs become
    GEMMs.

    Returns generate(weights, caches_batch, prompt_ids [B, prompt_len]) ->
        (tokens [B, prompt_len + max_new_tokens], caches_batch).
    Build caches_batch with `Decoder.init_caches(batch=B)`. Every member
    runs the same number of steps, so nothing needs freezing.
    """
    return make_generate_fn(config, cache_cfg, prompt_len, max_new_tokens, device)


class Decoder:
    """Host-side generation loop with gate-controlled KV discipline."""

    def __init__(self, config: TransformerConfig, policy: GatePolicy,
                 weights: dict, cache_cfg: KVCacheConfig | None = None, device=None):
        self.device = resolve_device(device)
        self.config = config
        self.weights = weights
        self.cache_cfg = cache_cfg or KVCacheConfig(
            hot_capacity=config.window_normal,
            warm_capacity=config.seq_len_max,
            archive_capacity=config.seq_len_max,
            heads=config.heads, head_dim=config.head_dim,
        )
        self.gate_controller = GateController(policy, config)
        self._step = make_decode_step(config, self.cache_cfg, self.device)

    def init_caches(self, batch: int | None = None) -> list[KVCacheState]:
        return [kv_cache_init(self.cache_cfg, self.device, batch)
                for _ in range(len(self.weights["layers"]))]

    def generate_speculative(
        self,
        prompt: np.ndarray,
        max_new_tokens: int = 16,
        gamma: int = 4,
        draft_layers: int = 1,
    ) -> GenerationResult:
        """Speculative serving path: early-exit-prefix draft + parallel
        verify (spec_decode.py). Token-identical to greedy; the drafts
        accepted in total are in `accepted`."""
        from ruvector_tpu_torch.transformer.spec_decode import (
            SpecDecodeConfig,
            make_speculative_generate_fn,
        )

        caches = self.init_caches()
        logits = None
        for pos, t in enumerate(prompt):
            logits, caches = self._step(self.weights, caches, int(t), pos, True)
        b = torch.argmax(logits)
        gen = make_speculative_generate_fn(
            self.config, self.cache_cfg,
            SpecDecodeConfig(gamma=gamma, draft_layers=draft_layers),
            max_new_tokens, self.device,
        )
        out, count, _, acc_total, _ = gen(self.weights, caches, b)
        return GenerationResult(
            tokens=[int(t) for t in prompt] + out[:int(count)].tolist(),
            kv_flushes=0, frozen_steps=0, accepted=int(acc_total),
        )

    def generate(
        self,
        prompt: np.ndarray,
        max_new_tokens: int = 16,
        gate_fn=None,          # step -> GatePacket (coherence stream)
    ) -> GenerationResult:
        caches = self.init_caches()
        tokens = [int(t) for t in prompt]
        flushes = 0
        frozen = 0
        pos = 0
        logits = None
        for t in tokens:
            gate = gate_fn(pos) if gate_fn else GatePacket()
            decision = self.gate_controller.evaluate(gate)
            if decision.decision == GateDecision.FLUSH_KV:
                caches = [kv_cache_flush(self.cache_cfg, c) for c in caches]
                flushes += 1
            kv_ok = self.gate_controller.should_allow_kv_writes(gate)
            if not kv_ok:
                frozen += 1
            logits, caches = self._step(self.weights, caches, t, pos, kv_ok)
            pos += 1
        for _ in range(max_new_tokens):
            nxt = int(torch.argmax(logits))
            tokens.append(nxt)
            gate = gate_fn(pos) if gate_fn else GatePacket()
            kv_ok = self.gate_controller.should_allow_kv_writes(gate)
            logits, caches = self._step(self.weights, caches, nxt, pos, kv_ok)
            pos += 1
        return GenerationResult(tokens=tokens, kv_flushes=flushes, frozen_steps=frozen)
