"""Sparse linear solvers and PageRank (port of ruvector_tpu/solver):
Neumann, CG and Jacobi iterations, push and random-walk PPR, the AMG
V-cycle (BMSSP), the sketched TRUE solver and the router that picks one.
They run on the device of the matrix or graph they are given."""

from ruvector_tpu_torch.solver.iterative import (
    SolverResult,
    cg_solve,
    estimate_spectral_radius,
    jacobi_solve,
    neumann_solve,
)
from ruvector_tpu_torch.solver.push import (
    backward_push_ppr,
    forward_push_ppr,
    ppr_power_iteration,
    random_walk_ppr,
)
from ruvector_tpu_torch.solver.bmssp import BmsspSolver
from ruvector_tpu_torch.solver.true_solver import TrueSolver
from ruvector_tpu_torch.solver.router import (
    RouterConfig,
    SolverOrchestrator,
    SolverRouter,
    SparsityProfile,
    analyze_sparsity,
)

__all__ = [
    "SolverResult",
    "neumann_solve",
    "cg_solve",
    "estimate_spectral_radius",
    "jacobi_solve",
    "forward_push_ppr",
    "backward_push_ppr",
    "ppr_power_iteration",
    "random_walk_ppr",
    "BmsspSolver",
    "TrueSolver",
    "RouterConfig",
    "SparsityProfile",
    "SolverRouter",
    "SolverOrchestrator",
    "analyze_sparsity",
]
