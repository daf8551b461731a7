"""Min-cut gated attention with the host Dinic gate (port of
ruvector_tpu/attention/mincut.py).

The reference's pipeline (ruvector-attn-mincut, gating.rs:70-102):
  1. logits = Q K^T / sqrt(d)                   (on the device)
  2. dynamic min-cut gate over positive logits  (mincut.rs:163-221)
  3. gated entries -> masked                    (on the device)
  4. row softmax, fully gated rows -> 0         (on the device)
  5. weights @ V                                (on the device)
plus temporal hysteresis of the gate mask (hysteresis.rs:1-99).

Step 2 here is an exact s-t max flow (Dinic) on the host over the logit
graph, the oracle of the device gate (`mincut_device`), which the
registry's `mincut` mechanism runs: the canonical minimal source-side
cut is the same for every max flow, so the two give equal masks. As in
the JAX package, the native C++ Dinic (native.dinic_mincut_gate) runs
where the runtime is built, and the Python Dinic below otherwise; the
tests pin the two equal.
"""

from __future__ import annotations

import dataclasses
from collections import deque

import numpy as np
import torch

from ruvector_tpu_torch.attention.base import AttentionMechanism, register_attention
from ruvector_tpu_torch.convert import to_numpy
from ruvector_tpu_torch.device import resolve_device
from ruvector_tpu_torch.ops.segment import masked_softmax


@dataclasses.dataclass(frozen=True)
class MincutGateConfig:
    lam: float = 0.5        # cut-cost acceptance threshold multiplier (lambda)
    tau: int = 2            # hysteresis persistence steps
    eps: float = 0.01       # logit clamp for graph construction


@dataclasses.dataclass
class GatingResult:
    keep_mask: np.ndarray   # [S*S] bool
    cut_cost: float
    edges_kept: int
    edges_total: int


# ---------------------------------------------------------------------------
# Host-side exact min cut (Dinic) over the logit graph
# ---------------------------------------------------------------------------

class _Dinic:
    """Dinic max flow on a small dense-logit graph (mincut.rs:27-160)."""

    def __init__(self, n: int):
        self.n = n
        self.to: list[list[int]] = [[] for _ in range(n)]
        self.cap: list[list[float]] = [[] for _ in range(n)]
        self.rev: list[list[int]] = [[] for _ in range(n)]

    def add_edge(self, u: int, v: int, c: float):
        self.rev[u].append(len(self.to[v]))
        self.rev[v].append(len(self.to[u]))
        self.to[u].append(v)
        self.cap[u].append(c)
        self.to[v].append(u)
        self.cap[v].append(0.0)

    def bfs(self, s: int) -> list[int]:
        level = [-1] * self.n
        level[s] = 0
        q = deque([s])
        while q:
            u = q.popleft()
            for i, v in enumerate(self.to[u]):
                if self.cap[u][i] > 0 and level[v] < 0:
                    level[v] = level[u] + 1
                    q.append(v)
        return level

    def dfs(self, u: int, t: int, f: float, level, it) -> float:
        """One blocking-flow augmentation from u: the recursive Dinic DFS
        (the JAX package's, mincut.rs:27-160) run on an explicit stack, so
        a path longer than the interpreter's recursion limit augments too.
        It takes the same edges in the same order and returns the same
        amount, so the residual capacities are the same floats."""
        path, caps = [u], [f]
        while path:
            w = path[-1]
            if w == t:
                d = caps[-1]
                for x in reversed(path[:-1]):       # innermost edge first
                    i = it[x]
                    self.cap[x][i] -= d
                    self.cap[self.to[x][i]][self.rev[x][i]] += d
                return d
            while it[w] < len(self.to[w]):
                i = it[w]
                v = self.to[w][i]
                if self.cap[w][i] > 0 and level[w] < level[v]:
                    path.append(v)
                    caps.append(min(caps[-1], self.cap[w][i]))
                    break
                it[w] += 1
            else:                                   # dead end: back up
                path.pop()
                caps.pop()
                if path:
                    it[path[-1]] += 1
        return 0.0

    def max_flow(self, s: int, t: int) -> float:
        flow = 0.0
        while True:
            level = self.bfs(s)
            if level[t] < 0:
                return flow
            it = [0] * self.n
            while True:
                f = self.dfs(s, t, float("inf"), level, it)
                if f <= 0:
                    break
                flow += f

    def reachable(self, s: int) -> np.ndarray:
        return np.asarray([lv >= 0 for lv in self.bfs(s)])


def dynamic_min_cut(logits, seq_len: int, lam: float, tau: int, eps: float) -> GatingResult:
    """Gate the edges of the logit graph by an s-t min cut (mincut.rs:163-221).

    Edges are the clamped positive logits, s = 0, t = seq_len - 1. The cut
    applies only when its cost is at most lam times the mean positive
    weight; non-positive logits are always gated off. `tau` belongs to the
    hysteresis and is unused here, as in the reference. Takes the native
    Dinic when the runtime is built.
    """
    from ruvector_tpu_torch import native

    logits = to_numpy(logits).astype(np.float32).reshape(seq_len, seq_len)
    if native.available:
        keep, cost = native.dinic_mincut_gate(logits, lam, eps)
        return GatingResult(keep.reshape(-1), cost, int(keep.sum()), seq_len * seq_len)
    clamped = np.where(logits > eps, logits, 0.0)
    n = seq_len * seq_len
    pos = clamped > 0
    if pos.sum() == 0 or seq_len < 2:
        return GatingResult(np.zeros(n, bool), 0.0, 0, n)

    threshold = lam * float(clamped[pos].mean())
    dinic = _Dinic(seq_len)
    edge_list = []
    for i in range(seq_len):
        for j in range(seq_len):
            if clamped[i, j] > 0:
                edge_list.append((i, j))
                dinic.add_edge(i, j, float(clamped[i, j]))

    cut_cost = dinic.max_flow(0, seq_len - 1)
    keep = pos.copy()
    total_cut = 0.0
    if cut_cost <= threshold:
        reach = dinic.reachable(0)
        for (i, j) in edge_list:
            if reach[i] and not reach[j]:
                keep[i, j] = False
                total_cut += float(clamped[i, j])
    return GatingResult(keep.reshape(-1), total_cut, int(keep.sum()), n)


# ---------------------------------------------------------------------------
# Hysteresis (functional port of hysteresis.rs)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class HysteresisState:
    mask: torch.Tensor      # stabilised bool mask
    counts: torch.Tensor    # consecutive-disagreement counters, int32
    step: torch.Tensor      # scalar int32


def hysteresis_init(shape, device=None) -> HysteresisState:
    dev = resolve_device(device)
    return HysteresisState(mask=torch.zeros(shape, dtype=torch.bool, device=dev),
                           counts=torch.zeros(shape, dtype=torch.int32, device=dev),
                           step=torch.zeros((), dtype=torch.int32, device=dev))


def hysteresis_apply(state: HysteresisState, raw: torch.Tensor,
                     tau: int) -> tuple[HysteresisState, torch.Tensor]:
    """An edge flips only after `tau` consecutive disagreeing steps
    (hysteresis.rs:22-56); the first call passes `raw` through. On the
    device, without a host sync."""
    raw = raw.to(torch.bool)
    first = state.step == 0
    counts = torch.where(raw != state.mask, state.counts + 1, torch.zeros_like(state.counts))
    flip = counts >= tau
    result = torch.where(flip, raw, state.mask)
    counts = torch.where(flip, torch.zeros_like(counts), counts)
    result = torch.where(first, raw, result)
    counts = torch.where(first, torch.zeros_like(counts), counts)
    return HysteresisState(mask=result, counts=counts, step=state.step + 1), result


# ---------------------------------------------------------------------------
# Full gated attention
# ---------------------------------------------------------------------------

def _masked_self_attention(q, k, v, keep_mask):
    """Steps 1, 3, 4, 5: [S, D] x [S, D] x [S, Dv] under keep_mask [S, S]."""
    d = q.shape[-1]
    scale = 1.0 / torch.sqrt(torch.tensor(d, dtype=torch.float32, device=q.device))
    logits = torch.matmul(q.float(), k.float().T) * scale
    attn = masked_softmax(logits, keep_mask.float(), dim=-1)
    return torch.matmul(attn, v.float())


def compute_logits(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Raw scaled logits Q K^T / sqrt(d) (gating.rs:11-23)."""
    return torch.matmul(q.float(), k.float().T) / (q.shape[-1] ** 0.5)


def attn_mincut(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                cfg: MincutGateConfig = MincutGateConfig(),
                witness_log=None) -> tuple[torch.Tensor, GatingResult]:
    """Min-cut gated attention (gating.rs:70-102) with the host gate:
    q, k [S, D], v [S, Dv] -> (output [S, Dv], gating).

    With a witness log (utils.witness.WitnessLog) every gate decision is
    recorded as a SHA-256 witness of the output and the mask (the
    reference's audit log, witness.rs).
    """
    s = q.shape[0]
    gating = dynamic_min_cut(compute_logits(q, k), s, cfg.lam, cfg.tau, cfg.eps)
    keep = torch.from_numpy(gating.keep_mask.reshape(s, s)).to(q.device)
    out = _masked_self_attention(q, k, v, keep)
    if witness_log is not None:
        witness_log.record("attn_mincut", to_numpy(out), gating.keep_mask,
                           cut_cost=gating.cut_cost, edges_kept=gating.edges_kept,
                           edges_total=gating.edges_total, lam=cfg.lam)
    return out, gating


def attn_softmax(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The ungated baseline (gating.rs:59-66)."""
    s = q.shape[0]
    return _masked_self_attention(q, k, v, torch.ones((s, s), dtype=torch.bool, device=q.device))


def _apply_device(params, cfg, q, k, v, mask=None, **kw):
    # the registry's route: the device gate (mincut_device), no host copy
    # of the logits; the host Dinic above is its oracle
    from ruvector_tpu_torch.attention.mincut_device import attn_mincut_device

    c = cfg or MincutGateConfig()
    return attn_mincut_device(q, k, v, c.lam, c.eps)[0]


register_attention(
    AttentionMechanism(name="mincut", init=None, apply=_apply_device,
                       default_config=MincutGateConfig()))
