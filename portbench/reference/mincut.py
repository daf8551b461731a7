"""The min-cut gate in plain PyTorch: a frozen copy of the port's plain
version (ruvector_tpu_torch/attention/mincut_device.py, the semantic
anchor of its K7 kernel; ruvector-attn-mincut/src/mincut.rs:163-221).

Per partition the edges are the eps-clamped positive logits, s = 0 and
t = S-1. Synchronous push-relabel finds the max flow (a partition stops
as soon as the flow into t exceeds lam times the mean positive logit,
since the cut is then not applied); the cut is the canonical minimal
source side, the nodes reachable from s in the residual. Where it
applies, the kept edges are the positive ones that do not cross it;
elsewhere every positive edge is kept.
"""

from __future__ import annotations

import torch

_TINY = 1e-12


def _global_relabel(r: torch.Tensor, h: torch.Tensor, s: int, t: int) -> torch.Tensor:
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


def _max_flow(cap: torch.Tensor, s: int, t: int, max_rounds: int, stop_above: torch.Tensor,
              relabel_every: int = 8):
    """(residual, flow into t, capped) of push-relabel on cap [K, n, n]."""
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
        return active(e, h).any(dim=1) & (rounds < max_rounds) & (e[:, t] <= stop_above)

    go = going(e, h, rounds)
    while bool(go.any()):
        act = active(e, h)
        step = h[:, :, None] == h[:, None, :] + 1
        ra = torch.where((r > _TINY) & step & act[:, :, None], r, torch.zeros_like(r))
        cums = torch.cumsum(ra, dim=2)
        push = torch.minimum(torch.clamp(e[:, :, None] - (cums - ra), min=0.0), ra)
        r2 = r - push + push.transpose(1, 2)
        e2 = e - torch.sum(push, dim=2) + torch.sum(push, dim=1)
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
    capped = active(e, h).any(dim=1) & (e[:, t] <= stop_above)
    return r, e[:, t], capped


def _reachable_from(r: torch.Tensor, s: int) -> torch.Tensor:
    k, n, _ = r.shape
    adj = r > _TINY
    reach = torch.zeros((k, n), dtype=torch.bool, device=r.device)
    reach[:, s] = True
    while True:
        new = reach | (adj & reach[:, :, None]).any(dim=1)
        if bool((new == reach).all()):
            return reach
        reach = new


def mincut_keep(logits: torch.Tensor, lam: float, eps: float) -> torch.Tensor:
    """The gate's keep mask [K, S, S] bool of float32 logits [K, S, S]."""
    k, sq, _ = logits.shape
    clamped = torch.where(logits > eps, logits, torch.zeros_like(logits))
    pos = clamped > 0
    npos = torch.sum(pos, dim=(1, 2))
    threshold = lam * (torch.sum(clamped, dim=(1, 2)) / torch.clamp(npos, min=1))
    resid, flow, capped = _max_flow(clamped, 0, sq - 1, 4 * sq * sq + 8, threshold)
    reach = _reachable_from(resid, 0)
    crossing = reach[:, :, None] & ~reach[:, None, :] & pos
    applied = (flow <= threshold) & (npos > 0) & ~capped
    keep = torch.where(applied[:, None, None], pos & ~crossing, pos)
    return keep & (npos > 0)[:, None, None]
