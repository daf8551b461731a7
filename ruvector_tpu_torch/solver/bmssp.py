"""BMSSP: an algebraic-multigrid V-cycle solver for SPD and Laplacian
systems (port of ruvector_tpu/solver/bmssp.py).

The setup is host numpy, as in the JAX package, and this module keeps its
own copy of it: greedy aggregation over the strong connections
(threshold 0.25, aggregates of up to 4 nodes) and the Galerkin coarse
operators P^T A P, down to at most 100 unknowns. The V-cycles run on the
device: weighted-Jacobi smoothing (omega 2/3, 3 sweeps a side),
restriction as a sum over each aggregate (`index_add_`), prolongation as
a gather, and a float32 dense solve of the coarsest level plus 1e-6 I.
A host loop reads the residual's norm after every cycle.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ruvector_tpu_torch.device import resolve_device

STRONG_THRESHOLD = 0.25
SMOOTH_STEPS = 3
COARSEST_DIRECT_LIMIT = 100
TARGET_AGGREGATE_SIZE = 4


@dataclasses.dataclass
class _Level:
    """One grid level: A in COO plus the aggregate map to the next level."""

    row: np.ndarray
    col: np.ndarray
    val: np.ndarray
    n: int
    diag: np.ndarray
    agg: np.ndarray | None   # [n] aggregate id into the coarser level


def _coarsen(row, col, val, n) -> np.ndarray:
    """Greedy aggregation (bmssp.rs setup): each unaggregated node seeds an
    aggregate with its strong neighbors; leftovers join an aggregate of
    their own."""
    # strength: |a_ij| >= theta * sqrt(|a_ii a_jj|)
    diag = np.zeros(n)
    dmask = row == col
    diag[row[dmask]] = val[dmask]
    off = ~dmask
    strong = np.abs(val[off]) >= STRONG_THRESHOLD * np.sqrt(
        np.abs(diag[row[off]] * diag[col[off]]) + 1e-30)
    sr, sc = row[off][strong], col[off][strong]

    nbrs: list[list[int]] = [[] for _ in range(n)]
    for a, b in zip(sr, sc):
        nbrs[a].append(int(b))

    agg = np.full(n, -1, np.int64)
    next_agg = 0
    for i in range(n):
        if agg[i] >= 0:
            continue
        members = [i] + [j for j in nbrs[i] if agg[j] < 0]
        members = members[:TARGET_AGGREGATE_SIZE]
        for j in members:
            agg[j] = next_agg
        next_agg += 1
    for i in range(n):
        if agg[i] < 0:
            agg[i] = next_agg
            next_agg += 1
    return agg


def _galerkin(row, col, val, agg, nc):
    """Coarse operator A_c = P^T A P with piecewise-constant P (host)."""
    cr, cc = agg[row], agg[col]
    key = cr * nc + cc
    order = np.argsort(key, kind="stable")
    key, v = key[order], val[order]
    uniq, start = np.unique(key, return_index=True)
    sums = np.add.reduceat(v, start)
    return uniq // nc, uniq % nc, sums


@dataclasses.dataclass(frozen=True)
class _DeviceLevel:
    row: torch.Tensor
    col: torch.Tensor
    val: torch.Tensor
    n: int
    diag: torch.Tensor
    agg: torch.Tensor | None


class BmsspSolver:
    """AMG hierarchy: setup on the host, V-cycles on `device` (the CUDA
    card unless the CPU is asked for)."""

    def __init__(self, tolerance: float = 1e-8, max_cycles: int = 200,
                 omega: float = 2.0 / 3.0, device=None):
        self.tolerance = tolerance
        self.max_cycles = max_cycles
        self.omega = omega
        self.device = resolve_device(device)
        self._levels: list[_Level] = []
        self._coarse_dense: np.ndarray | None = None

    def setup(self, row, col, val, n: int) -> "BmsspSolver":
        row, col, val = np.asarray(row), np.asarray(col), np.asarray(val, np.float64)
        self._levels = []
        while n > COARSEST_DIRECT_LIMIT and len(self._levels) < 20:
            diag = np.zeros(n)
            dm = row == col
            diag[row[dm]] = val[dm]
            agg = _coarsen(row, col, val, n)
            nc = int(agg.max()) + 1
            if nc >= n:        # coarsening stalled
                break
            self._levels.append(_Level(row, col, val, n, diag, agg))
            row, col, val = _galerkin(row, col, val, agg, nc)
            n = nc
        diag = np.zeros(n)
        dm = row == col
        diag[row[dm]] = val[dm]
        self._levels.append(_Level(row, col, val, n, diag, None))
        dense = np.zeros((n, n))
        dense[row, col] = val
        self._coarse_dense = dense
        return self

    def _device_levels(self):
        dev = self.device

        def tensor(a, dtype):
            return torch.as_tensor(np.asarray(a), dtype=dtype).to(dev)

        levels = [_DeviceLevel(tensor(lv.row, torch.long), tensor(lv.col, torch.long),
                               tensor(lv.val, torch.float32), lv.n,
                               tensor(np.where(lv.diag == 0, 1.0, lv.diag), torch.float32),
                               None if lv.agg is None else tensor(lv.agg, torch.long))
                  for lv in self._levels]
        coarse = tensor(self._coarse_dense, torch.float32)
        return levels, coarse + 1e-6 * torch.eye(coarse.shape[0], device=dev)

    def solve(self, b, x0=None):
        """Run V-cycles until ||r|| <= tol * ||b|| or max_cycles. Returns
        (x, ||r||, cycles)."""
        levels, coarse = self._device_levels()
        b = torch.as_tensor(b, dtype=torch.float32).to(self.device)
        x = torch.zeros_like(b) if x0 is None else \
            torch.as_tensor(x0, dtype=torch.float32).to(self.device)
        omega = self.omega

        def spmv(lv: _DeviceLevel, v):
            out = torch.zeros(lv.n, dtype=v.dtype, device=v.device)
            return out.index_add_(0, lv.row, lv.val * v[lv.col])

        def smooth(lv: _DeviceLevel, x, rhs):
            for _ in range(SMOOTH_STEPS):
                x = x + omega * (rhs - spmv(lv, x)) / lv.diag
            return x

        def vcycle(i, rhs):
            lv = levels[i]
            if lv.agg is None:                     # coarsest
                return torch.linalg.solve(coarse, rhs)
            x = smooth(lv, torch.zeros_like(rhs), rhs)
            r = rhs - spmv(lv, x)
            nc = levels[i + 1].n
            rc = torch.zeros(nc, dtype=r.dtype, device=r.device).index_add_(0, lv.agg, r)
            x = x + vcycle(i + 1, rc)[lv.agg]      # P e_c
            return smooth(lv, x, rhs)

        bnorm = float(torch.linalg.vector_norm(b)) + 1e-30
        r = b - spmv(levels[0], x)
        k = 0
        while k < self.max_cycles and float(torch.linalg.vector_norm(r)) / bnorm > \
                self.tolerance:
            x = x + vcycle(0, r)
            k += 1
            r = b - spmv(levels[0], x)
        return x, float(torch.linalg.vector_norm(r)), k
