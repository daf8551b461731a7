"""Device min-cut gate: synchronous push-relabel in plain PyTorch.

Port of ruvector_tpu/attention/mincut_device.py:39-207, batched over a
leading partition axis: one call solves K partitions' [S, S] logit
matrices. Each partition keeps its own loop state and stops on its own
condition (converged, round cap, or the stop_above exit); the loop runs
until the last one stops, and a stopped partition's state no longer
changes, as under `jax.vmap` of the JAX while_loop.

Algorithm (phase-separated synchronous push-relabel):
  - push phase: every active node pushes its excess along all admissible
    edges (height exactly one lower) with heights frozen; a row's pushes
    fill its admissible edges in column order (a prefix sum);
  - relabel phase: active nodes with no admissible edge in the updated
    residual lift to 1 + the least residual-neighbour height;
  - every 8 rounds an exact global relabel (two backward BFSs).
The gate takes the canonical minimal-source-side cut (s-reachability in
the residual), applied only when the flow is at most lam times the mean
positive logit (ruvector-attn-mincut/src/mincut.rs:163-221 semantics).
This is the semantic anchor of the K7 kernel (ops/kernels/mincut_gate_block).
`attn_mincut_device` and its batched form wrap the gate in the gated
attention (JAX :210-225).
"""

from __future__ import annotations

import torch

from ruvector_tpu_torch.ops.segment import masked_softmax

_TINY = 1e-12


def _global_relabel(r: torch.Tensor, h: torch.Tensor, s: int, t: int) -> torch.Tensor:
    """Exact distance labels: h[v] = dist(v -> t) over residual edges, or
    n + dist(v -> s) for nodes cut off from t; never below the current h.
    r [K, n, n], h [K, n] int64."""
    k, n, _ = r.shape
    inf = 4 * n
    adj = r > _TINY

    def bfs_to(target: int) -> torch.Tensor:
        d = torch.full((k, n), inf, dtype=torch.int64, device=r.device)
        d[:, target] = 0
        while True:
            via = torch.amin(torch.where(adj, d[:, None, :], inf), dim=2)
            new = torch.minimum(d, 1 + via)
            if not bool((new < d).any()):
                return d
            d = new

    dist_t = bfs_to(t)
    dist_s = bfs_to(s)
    h_new = torch.where(dist_t < inf, dist_t, n + torch.clamp(dist_s, max=n))
    h_new[:, s] = n
    return torch.maximum(h, h_new)


def _push_relabel_maxflow(cap: torch.Tensor, s: int, t: int, max_rounds: int,
                          stop_above: torch.Tensor | None = None,
                          relabel_every: int = 8):
    """Exact max flow on dense capacities cap [K, n, n] (0 = no edge).

    stop_above [K]: a partition stops as soon as its arrived flow e[t]
    exceeds it (its residual is then not a max-flow residual). Returns
    (residual [K, n, n], flow [K], capped [K] bool, rounds [K] int64);
    capped marks partitions stopped by the round cap with active nodes
    left (and, with stop_above, flow still at most stop_above).
    """
    k, n, _ = cap.shape
    dev = cap.device
    idx = torch.arange(n, device=dev)
    not_st = (idx != s) & (idx != t)
    two_n = 2 * n

    h = torch.zeros((k, n), dtype=torch.int64, device=dev)
    h[:, s] = n
    push0 = cap[:, s, :].clone()
    r = cap.clone()
    r[:, s, :] = 0.0
    r[:, :, s] += push0
    e = push0.clone()
    e[:, s] = 0.0
    h = _global_relabel(r, h, s, t)
    rounds = torch.zeros((k,), dtype=torch.int64, device=dev)

    def active(e, h):
        return (e > _TINY) & not_st & (h < two_n)

    def going(e, h, rounds):
        go = active(e, h).any(dim=1) & (rounds < max_rounds)
        if stop_above is not None:
            go = go & (e[:, t] <= stop_above)
        return go

    go = going(e, h, rounds)
    while bool(go.any()):
        act = active(e, h)
        step = h[:, :, None] == h[:, None, :] + 1
        # --- push phase (heights frozen) ---
        ra = torch.where((r > _TINY) & step & act[:, :, None], r, torch.zeros_like(r))
        cums = torch.cumsum(ra, dim=2)
        push = torch.minimum(torch.clamp(e[:, :, None] - (cums - ra), min=0.0), ra)
        r2 = r - push + push.transpose(1, 2)
        e2 = e - torch.sum(push, dim=2) + torch.sum(push, dim=1)
        # --- relabel phase (updated residual) ---
        act2 = active(e2, h)
        resid = r2 > _TINY
        has_adm = (resid & step).any(dim=2)
        lift = 1 + torch.amin(torch.where(resid, h[:, None, :], two_n + 1), dim=2)
        h2 = torch.where(act2 & ~has_adm, torch.maximum(h, lift), h)
        relabel = (rounds + 1) % relabel_every == 0
        if bool((relabel & go).any()):
            h2 = torch.where(relabel[:, None], _global_relabel(r2, h2, s, t), h2)
        r = torch.where(go[:, None, None], r2, r)
        e = torch.where(go[:, None], e2, e)
        h = torch.where(go[:, None], h2, h)
        rounds = rounds + go.long()
        go = going(e, h, rounds)

    capped = active(e, h).any(dim=1)
    if stop_above is not None:
        capped = capped & (e[:, t] <= stop_above)
    return r, e[:, t], capped, rounds


def _reachable_from(r: torch.Tensor, s: int) -> torch.Tensor:
    """[K, n] bool: reachability from s over residual edges (r > 0)."""
    k, n, _ = r.shape
    adj = r > _TINY
    reach = torch.zeros((k, n), dtype=torch.bool, device=r.device)
    reach[:, s] = True
    while True:
        new = reach | (adj & reach[:, :, None]).any(dim=1)
        if bool((new == reach).all()):
            return reach
        reach = new


def mincut_gate_stats(logits: torch.Tensor, lam: float = 0.5, eps: float = 0.01,
                      max_rounds: int = 0):
    """The gate of mincut_gate_device with its solve statistics.

    logits [K, S, S]. Returns (keep [K, S, S] bool, cut_cost [K] (0 where
    the cut is not applied), flow [K], applied [K] bool, rounds [K] int64).
    """
    k, sq, _ = logits.shape
    if sq < 2:
        zeros = torch.zeros((k,), dtype=torch.float32, device=logits.device)
        return (torch.zeros((k, sq, sq), dtype=torch.bool, device=logits.device), zeros,
                zeros, zeros > 0, zeros.long())
    clamped = torch.where(logits > eps, logits, torch.zeros_like(logits))
    pos = clamped > 0
    npos = torch.sum(pos, dim=(1, 2))
    mean_w = torch.sum(clamped, dim=(1, 2)) / torch.clamp(npos, min=1)
    threshold = lam * mean_w
    rounds_cap = max_rounds or (4 * sq * sq + 8)
    # stop_above = threshold: once the arrived flow exceeds the threshold
    # the cut is provably not applied (max flow >= e[t])
    resid, flow, capped, rounds = _push_relabel_maxflow(
        clamped, 0, sq - 1, rounds_cap, stop_above=threshold)
    reach = _reachable_from(resid, 0)
    crossing = reach[:, :, None] & ~reach[:, None, :] & pos
    cut_cost = torch.sum(torch.where(crossing, clamped, torch.zeros_like(clamped)), dim=(1, 2))
    # a capped solve has no max-flow residual: keep = pos (no gating)
    applied = (flow <= threshold) & (npos > 0) & ~capped
    keep = torch.where(applied[:, None, None], pos & ~crossing, pos)
    keep = keep & (npos > 0)[:, None, None]
    total_cut = torch.where(applied, cut_cost, torch.zeros_like(cut_cost))
    return keep, total_cut, flow, applied, rounds


def mincut_gate_device(logits: torch.Tensor, lam: float = 0.5, eps: float = 0.01,
                       max_rounds: int = 0):
    """Device-side dynamic min cut (mincut.rs:163-221 semantics).

    logits [S, S] or [K, S, S]. Returns (keep bool of the same shape,
    cut_cost [] or [K]): edges are the clamped positive logits, s = 0,
    t = S-1; the cut is applied only when its cost is at most lam times
    the mean positive weight.
    """
    single = logits.dim() == 2
    batch = logits[None] if single else logits
    keep, cost, _, _, _ = mincut_gate_stats(batch.float(), lam, eps, max_rounds)
    return (keep[0], cost[0]) if single else (keep, cost)


def attn_mincut_device(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       lam: float = 0.5, eps: float = 0.01):
    """Min-cut gated attention on the device (gating.rs:70-102): SDDMM
    logits, the push-relabel gate, the masked softmax and the SpMM, with no
    host copy of the logits. q, k [S, D], v [S, Dv] ->
    (out [S, Dv], keep [S, S] bool, cut_cost [])."""
    out, keep, cut = attn_mincut_device_batched(q[None], k[None], v[None], lam, eps)
    return out[0], keep[0], cut[0]


def attn_mincut_device_batched(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                               lam: float = 0.5, eps: float = 0.01):
    """attn_mincut_device over a leading batch of sequences, one batched
    gate solve for all of them: q, k [K, S, D], v [K, S, Dv] ->
    (out [K, S, Dv], keep [K, S, S] bool, cut_cost [K])."""
    d = q.shape[-1]
    logits = torch.matmul(q.float(), k.float().transpose(1, 2)) / (d ** 0.5)
    keep, cut, _, _, _ = mincut_gate_stats(logits, lam, eps)
    attn = masked_softmax(logits, keep.float(), dim=-1)
    return torch.matmul(attn, v.float()), keep, cut
