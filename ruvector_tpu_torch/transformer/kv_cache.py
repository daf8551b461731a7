"""Three-tier KV cache (ADR-004): hot f32 ring -> warm int8 -> archive int4
(port of ruvector_tpu/transformer/kv_cache.py).

Reference: ruvector-mincut-gated-transformer/src/kv_cache/ — HotBuffer,
KIVI-style quantizer, archive tier, tier policy/manager.

The cache is a value: `kv_cache_append` returns a new state and leaves its
input as it was (callers keep an earlier state and decode from it again, as
the speculative tests do). Each tier is a ring with a static capacity; the
write slot is `position % capacity`, and the token being overwritten
cascades down a tier (hot -> warm quantizes to int8, warm -> archive
requantizes to int4 stored as int8 in [-7, 7]). Slots are in ring order;
each tier's `*_pos` holds the absolute position of its slot (-1 = empty).

Every buffer owns one scratch row at index `capacity`: a write that is
turned off (`enabled` False: a gate-frozen step, a member of a batch that
has finished) lands there, and `length` does not advance. A tier of
capacity 0 is only its scratch row; the port leaves such a tier untouched
where nothing can read what the reference writes into it.

A state may carry a leading batch dimension on every field (`length`
[B]); then `k`, `v` are [B, H, hd] and `enabled` is a bool or a [B]
tensor, one sequence per row.
"""

from __future__ import annotations

import dataclasses

import torch

from ruvector_tpu_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class KVCacheConfig:
    hot_capacity: int = 16       # recent tokens kept f32
    warm_capacity: int = 48      # int8 (KIVI scheme)
    archive_capacity: int = 64   # int4 grouped
    heads: int = 4
    head_dim: int = 64


@dataclasses.dataclass(frozen=True)
class KVCacheState:
    # Every buffer is [(B,) capacity + 1, H, hd]; row `capacity` is the
    # scratch row that disabled writes land in.
    hot_k: torch.Tensor
    hot_v: torch.Tensor
    hot_pos: torch.Tensor       # int32 [(B,) hot_cap + 1], -1 = empty
    # warm: int8 + per-(token, head) scales [(B,) warm_cap + 1, H, 1]
    warm_k: torch.Tensor
    warm_k_scale: torch.Tensor
    warm_v: torch.Tensor
    warm_v_scale: torch.Tensor
    warm_pos: torch.Tensor
    # archive: int4 stored as int8 in [-7, 7], coarser scale
    arch_k: torch.Tensor
    arch_k_scale: torch.Tensor
    arch_v: torch.Tensor
    arch_v_scale: torch.Tensor
    arch_pos: torch.Tensor
    # total tokens appended (writes actually committed), int32 [(B,)]
    length: torch.Tensor


_FIELDS = [f.name for f in dataclasses.fields(KVCacheState)]


def kv_cache_init(cfg: KVCacheConfig, device=None, batch: int | None = None) -> KVCacheState:
    """An empty cache on `device`; with `batch`, B empty caches stacked."""
    dev = resolve_device(device)
    h, d = cfg.heads, cfg.head_dim
    lead = () if batch is None else (batch,)

    def full(c, tail, value, dtype):
        return torch.full((*lead, c + 1, *tail), value, dtype=dtype, device=dev)

    def tier(c):
        return (full(c, (h, d), 0, torch.int8), full(c, (h, 1), 1.0, torch.float32),
                full(c, (h, d), 0, torch.int8), full(c, (h, 1), 1.0, torch.float32),
                full(c, (), -1, torch.int32))

    hc = cfg.hot_capacity
    return KVCacheState(
        full(hc, (h, d), 0.0, torch.float32), full(hc, (h, d), 0.0, torch.float32),
        full(hc, (), -1, torch.int32), *tier(cfg.warm_capacity),
        *tier(cfg.archive_capacity),
        torch.zeros(lead, dtype=torch.int32, device=dev))


def _as_batch(state: KVCacheState) -> tuple[KVCacheState, bool]:
    if state.length.dim() == 1:
        return state, False
    return KVCacheState(*(getattr(state, f)[None] for f in _FIELDS)), True


def _unbatch(state: KVCacheState) -> KVCacheState:
    return KVCacheState(*(getattr(state, f)[0] for f in _FIELDS))


def _quant_token(x: torch.Tensor, bits: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-(token, head) quantization of [.., H, hd] to int8/int4.
    The scale is absmax times float32(1 / qmax), the form of JAX's jitted
    decode step (XLA folds the division by a constant); `x / scale`
    divides by a tensor, correctly rounded on the CPU and on CUDA."""
    qmax = 127.0 if bits == 8 else 7.0
    absmax = torch.amax(torch.abs(x), dim=-1, keepdim=True)
    scale = torch.clamp(absmax, min=1e-8) * (1.0 / qmax)
    q = torch.clamp(torch.round(x / scale), -qmax, qmax).to(torch.int8)
    return q, scale


def _ring(pos: torch.Tensor, cap: int) -> torch.Tensor:
    """pos % cap as a slot index. A tier of capacity 0 has only its scratch
    row, where the reference's index (XLA: x % 0 = x, then clamped) lands."""
    return torch.remainder(pos, cap).long() if cap > 0 else torch.zeros_like(pos, dtype=torch.long)


def _put(buf: torch.Tensor, rows: torch.Tensor, slot: torch.Tensor, value) -> torch.Tensor:
    """A copy of buf with buf[b, slot[b]] = value[b] for every b."""
    out = buf.clone()
    out[rows, slot] = value
    return out


def kv_cache_append(
    cfg: KVCacheConfig, state: KVCacheState, k: torch.Tensor, v: torch.Tensor,
    enabled: torch.Tensor | bool = True,
) -> KVCacheState:
    """Append one token's (k, v) [(B,) H, hd]; O(1) row writes into a new
    state. When `enabled` is False every write lands in the scratch rows and
    `length` does not advance."""
    s, one = _as_batch(state)
    if one:
        k, v = k[None], v[None]
    dev = s.length.device
    b = s.length.shape[0]
    rows = torch.arange(b, device=dev)
    en = torch.as_tensor(enabled, dtype=torch.bool, device=dev).expand(b)
    pos = s.length                          # absolute position of this token
    hc, wc, ac = cfg.hot_capacity, cfg.warm_capacity, cfg.archive_capacity
    new = {}

    # --- hot tier ---
    hot_real = _ring(pos, hc)
    hot_slot = torch.where(en, hot_real, hc)
    evict_k = s.hot_k[rows, hot_real]       # token being overwritten
    evict_v = s.hot_v[rows, hot_real]
    new["hot_k"] = _put(s.hot_k, rows, hot_slot, k)
    new["hot_v"] = _put(s.hot_v, rows, hot_slot, v)
    new["hot_pos"] = _put(s.hot_pos, rows, hot_slot, pos)

    # --- warm tier (receives the hot eviction) ---
    if wc > 0 or ac > 0:
        warm_real = _ring(pos - hc, wc)
        warm_slot = torch.where(en & (pos >= hc), warm_real, wc)
        warm_evict_k = s.warm_k[rows, warm_real].to(torch.float32) * s.warm_k_scale[rows, warm_real]
        warm_evict_v = s.warm_v[rows, warm_real].to(torch.float32) * s.warm_v_scale[rows, warm_real]
        for name, x in (("warm_k", evict_k), ("warm_v", evict_v)):
            q, scale = _quant_token(x, 8)
            new[name] = _put(getattr(s, name), rows, warm_slot, q)
            new[name + "_scale"] = _put(getattr(s, name + "_scale"), rows, warm_slot, scale)
        # the position entering warm is the evicted hot token's
        new["warm_pos"] = _put(s.warm_pos, rows, warm_slot, pos - hc)

    # --- archive tier (receives the warm eviction; the oldest rolls off) ---
    if ac > 0:
        arch_real = _ring(pos - hc - wc, ac)
        arch_slot = torch.where(en & (pos >= hc + wc), arch_real, ac)
        for name, x in (("arch_k", warm_evict_k), ("arch_v", warm_evict_v)):
            q, scale = _quant_token(x, 4)
            new[name] = _put(getattr(s, name), rows, arch_slot, q)
            new[name + "_scale"] = _put(getattr(s, name + "_scale"), rows, arch_slot, scale)
        new["arch_pos"] = _put(s.arch_pos, rows, arch_slot, pos - hc - wc)

    new["length"] = s.length + en.to(torch.int32)
    out = KVCacheState(*(new.get(f, getattr(s, f)) for f in _FIELDS))
    return _unbatch(out) if one else out


def kv_cache_positions(cfg: KVCacheConfig, state: KVCacheState) -> torch.Tensor:
    """Absolute token position per slot in read order [archive|warm|hot]
    ([(B,) T_total]); -1 marks empty slots. Slot order is ring order, not
    chronological — sort by this array to reconstruct the sequence."""
    return torch.cat([state.arch_pos[..., :-1], state.warm_pos[..., :-1],
                      state.hot_pos[..., :-1]], dim=-1)


def kv_cache_read(
    cfg: KVCacheConfig, state: KVCacheState
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Effective (K, V, valid_mask) of shapes [(B,) T_total, H, hd] and
    [(B,) T_total], T_total = archive + warm + hot capacities, slots in ring
    order. A warm or archive slot counts as live while its token has not
    been superseded by a newer write of the same ring index."""
    s, one = _as_batch(state)
    hc, wc, ac = cfg.hot_capacity, cfg.warm_capacity, cfg.archive_capacity
    L = s.length[:, None]
    hot_lo = torch.clamp(L - hc, min=0)
    warm_lo = torch.clamp(L - hc - wc, min=0)       # positions now in warm
    arch_lo = torch.clamp(L - hc - wc - ac, min=0)
    ks, vs, masks = [], [], []
    for cap, kq, kscale, vq, vscale, p, lo, hi in (
            (ac, s.arch_k, s.arch_k_scale, s.arch_v, s.arch_v_scale, s.arch_pos,
             arch_lo, warm_lo),
            (wc, s.warm_k, s.warm_k_scale, s.warm_v, s.warm_v_scale, s.warm_pos,
             warm_lo, hot_lo),
            (hc, s.hot_k, None, s.hot_v, None, s.hot_pos, hot_lo, L)):
        if cap == 0:
            continue
        if kscale is None:
            ks.append(kq[:, :-1])
            vs.append(vq[:, :-1])
        else:
            ks.append(kq[:, :-1].to(torch.float32) * kscale[:, :-1])
            vs.append(vq[:, :-1].to(torch.float32) * vscale[:, :-1])
        p = p[:, :-1]
        masks.append(((p >= 0) & (p >= lo) & (p < hi)).to(torch.float32))
    k, v, mask = torch.cat(ks, 1), torch.cat(vs, 1), torch.cat(masks, 1)
    return (k[0], v[0], mask[0]) if one else (k, v, mask)


def kv_cache_flush(cfg: KVCacheConfig, state: KVCacheState) -> KVCacheState:
    """FlushKv intervention (gate decision) — reset to empty."""
    batch = state.length.shape[0] if state.length.dim() == 1 else None
    return kv_cache_init(cfg, device=state.length.device, batch=batch)
