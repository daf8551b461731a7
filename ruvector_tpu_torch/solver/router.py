"""Solver router: sparsity profile, algorithm choice, fallback (port of
ruvector_tpu/solver/router.py).

RouterConfig's thresholds (router.rs:99-110), select_algorithm's rule
order (:164-254), SolverOrchestrator.solve_with_fallback (:351) and
analyze_sparsity (:480). The rules are host control flow: they choose
which solver runs, on the matrix's device.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ruvector_tpu_torch.convert import to_numpy
from ruvector_tpu_torch.graph.csr import CSRGraph
from ruvector_tpu_torch.solver.bmssp import BmsspSolver
from ruvector_tpu_torch.solver.iterative import (
    SolverResult,
    cg_solve,
    estimate_spectral_radius,
    neumann_solve,
)
from ruvector_tpu_torch.solver.true_solver import TrueSolver


@dataclasses.dataclass(frozen=True)
class RouterConfig:
    """Defaults per router.rs:99-110."""

    neumann_spectral_radius_threshold: float = 0.95
    cg_condition_threshold: float = 100.0
    sparsity_sublinear_threshold: float = 0.05
    true_batch_threshold: int = 100
    push_graph_size_threshold: int = 1_000


@dataclasses.dataclass
class SparsityProfile:
    rows: int
    nnz: int
    density: float
    is_diag_dominant: bool
    estimated_spectral_radius: float
    estimated_condition: float


def analyze_sparsity(matrix: CSRGraph) -> SparsityProfile:
    """Profile the matrix (router.rs:480): density, diagonal dominance,
    spectral radius (power iteration on the device), a Gershgorin
    condition estimate (host)."""
    n = matrix.num_nodes
    rows = matrix.row_ids().cpu().numpy()
    cols = matrix.col_idx.cpu().numpy()
    vals = matrix.values.cpu().numpy()
    nnz = len(vals)

    diag = np.zeros(n)
    dm = rows == cols
    diag[rows[dm]] = vals[dm]
    offsum = np.zeros(n)
    np.add.at(offsum, rows[~dm], np.abs(vals[~dm]))
    diag_dom = bool(np.all(np.abs(diag) >= offsum - 1e-12))

    rho = estimate_spectral_radius(matrix)
    hi = np.max(np.abs(diag) + offsum)
    lo = max(np.min(np.abs(diag) - offsum), 1e-12)
    return SparsityProfile(rows=n, nnz=nnz, density=nnz / max(n * n, 1),
                           is_diag_dominant=diag_dom, estimated_spectral_radius=rho,
                           estimated_condition=float(hi / lo))


class SolverRouter:
    def __init__(self, config: RouterConfig | None = None):
        self.config = config or RouterConfig()

    def select_algorithm(self, profile: SparsityProfile, query: str = "linear_system",
                         batch_size: int = 1) -> str:
        """Rule order of router.rs:164-254."""
        c = self.config
        if query == "pagerank_single":
            return "forward_push"
        if query == "pagerank_pairwise":
            return ("hybrid_random_walk" if profile.rows > c.push_graph_size_threshold
                    else "forward_push")
        if query == "spectral_filter":
            return "neumann"
        if query == "batch_linear_system":
            return "true" if batch_size > c.true_batch_threshold else "cg"
        # linear_system: Neumann > CG > BMSSP
        if (profile.is_diag_dominant
                and profile.density < c.sparsity_sublinear_threshold
                and profile.estimated_spectral_radius < c.neumann_spectral_radius_threshold):
            return "neumann"
        if profile.estimated_condition < c.cg_condition_threshold:
            return "cg"
        return "bmssp"


class SolverOrchestrator:
    """Route then solve, with a CG fallback where the chosen solver does
    not converge (router.rs:351 solve_with_fallback)."""

    def __init__(self, config: RouterConfig | None = None):
        self.router = SolverRouter(config)

    def solve(self, matrix: CSRGraph, b, query: str = "linear_system",
              tolerance: float = 1e-6) -> tuple[SolverResult, str]:
        profile = analyze_sparsity(matrix)
        algo = self.router.select_algorithm(profile, query)
        result = self._dispatch(algo, matrix, b, tolerance)
        if not result.converged and algo != "cg":
            fallback = self._dispatch("cg", matrix, b, tolerance)
            if fallback.converged:
                return fallback, "cg"
        return result, algo

    def _dispatch(self, algo: str, matrix: CSRGraph, b, tolerance: float) -> SolverResult:
        if algo == "neumann":
            return neumann_solve(matrix, b, tolerance=tolerance)
        if algo == "cg":
            return cg_solve(matrix, b, tolerance=tolerance)
        if algo == "bmssp":
            solver = BmsspSolver(tolerance=tolerance, device=matrix.row_ptr.device).setup(
                matrix.row_ids().cpu().numpy(), matrix.col_idx.cpu().numpy(),
                matrix.values.cpu().numpy(), matrix.num_nodes)
            x, rnorm, iters = solver.solve(b)
            bnorm = float(np.linalg.norm(to_numpy(b))) + 1e-30
            return SolverResult(x=x, residual_norm=rnorm, iterations=iters,
                                converged=rnorm / bnorm <= tolerance * 10)
        if algo == "true":
            x = TrueSolver().solve(matrix, b)
            return SolverResult(x=x, residual_norm=float("nan"), iterations=1, converged=True)
        raise ValueError(f"unknown algorithm {algo}")
