"""Iterative sparse linear solvers over CSR: Neumann series, CG, Jacobi
(port of ruvector_tpu/solver/iterative.py).

Each JAX `lax.while_loop` becomes a host loop that reads the loop's norm
after every iteration (one small device-to-host read an iteration); the
sparse product is `ops/segment.spmm_csr`. The solvers run on the
matrix's device in float32. An iteration count may differ from the JAX
package's by one where a norm lands at the tolerance (float32 sums in
another order).
"""

from __future__ import annotations

import dataclasses

import torch

from ruvector_tpu_torch.graph.csr import CSRGraph
from ruvector_tpu_torch.ops.segment import _segment_sum, spmm_csr


@dataclasses.dataclass
class SolverResult:
    x: torch.Tensor
    iterations: int
    residual_norm: float
    converged: bool


def _spmv(matrix: CSRGraph, x: torch.Tensor) -> torch.Tensor:
    return spmm_csr(matrix, x[:, None])[:, 0]


def _rhs(matrix: CSRGraph, b) -> torch.Tensor:
    """b as float32 on the matrix's device."""
    return torch.as_tensor(b, dtype=torch.float32).to(matrix.row_ptr.device)


def _diagonal(matrix: CSRGraph) -> torch.Tensor:
    """[N] diagonal of the matrix (the sum of its diagonal entries per row)."""
    rows = matrix.row_ids()
    vals = torch.where(matrix.col_idx == rows, matrix.values, torch.zeros_like(matrix.values))
    return _segment_sum(vals, rows.long(), matrix.num_nodes)


def estimate_spectral_radius(matrix: CSRGraph, iters: int = 20) -> float:
    """Power-iteration estimate of rho(I - A) from the unit vector of ones
    (neumann.rs:117-190)."""
    n = matrix.num_nodes
    dev = matrix.row_ptr.device
    v = torch.ones(n, device=dev) / torch.sqrt(torch.tensor(float(n), device=dev))
    nrm = torch.zeros((), device=v.device)
    for _ in range(iters):
        w = v - _spmv(matrix, v)          # (I - A) v
        nrm = torch.linalg.vector_norm(w)
        v = torch.where(nrm > 1e-12, w / torch.clamp(nrm, min=1e-12), v)
    return float(nrm)


def neumann_solve(matrix: CSRGraph, b, tolerance: float = 1e-6,
                  max_iterations: int = 500) -> SolverResult:
    """x = sum_k (I-A)^k b: converges when rho(I-A) < 1 (diagonally
    dominant A; neumann.rs:195-250)."""
    b = _rhs(matrix, b)
    x, term = b, b
    term_norm = float(torch.linalg.vector_norm(b))
    k = 0
    while k < max_iterations and term_norm > tolerance:
        term = term - _spmv(matrix, term)      # (I - A) term
        x = x + term
        k += 1
        term_norm = float(torch.linalg.vector_norm(term))
    res = float(torch.linalg.vector_norm(b - _spmv(matrix, x)))
    bnorm = float(torch.linalg.vector_norm(b))
    return SolverResult(x, k, res, res <= tolerance * max(bnorm, 1.0))


def cg_solve(matrix: CSRGraph, b, tolerance: float = 1e-6, max_iterations: int = 1000,
             use_preconditioner: bool = False) -> SolverResult:
    """Conjugate gradients for SPD A (cg.rs:232+), optionally with the
    Jacobi preconditioner M^-1 = 1/diag(A)."""
    b = _rhs(matrix, b)
    if use_preconditioner:
        diag = _diagonal(matrix)
        minv = torch.where(torch.abs(diag) > 1e-12, 1.0 / diag, torch.ones_like(diag))
    else:
        minv = torch.ones_like(b)
    x = torch.zeros_like(b)
    r = b
    z = minv * r
    p = z
    rz = torch.dot(r, z)
    k = 0
    while k < max_iterations and float(torch.linalg.vector_norm(r)) > tolerance:
        ap = _spmv(matrix, p)
        denom = torch.dot(p, ap)
        alpha = torch.where(torch.abs(denom) > 1e-30, rz / denom, torch.zeros_like(rz))
        x = x + alpha * p
        r = r - alpha * ap
        z = minv * r
        rz_new = torch.dot(r, z)
        beta = torch.where(torch.abs(rz) > 1e-30, rz_new / rz, torch.zeros_like(rz))
        p = z + beta * p
        rz = rz_new
        k += 1
    res = float(torch.linalg.vector_norm(r))
    return SolverResult(x, k, res, res <= tolerance)


def jacobi_solve(matrix: CSRGraph, b, tolerance: float = 1e-6,
                 max_iterations: int = 1000) -> SolverResult:
    """Jacobi iteration x' = x + D^-1 (b - A x)."""
    b = _rhs(matrix, b)
    diag = _diagonal(matrix)
    dinv = torch.where(torch.abs(diag) > 1e-12, 1.0 / diag, torch.zeros_like(diag))
    x = torch.zeros_like(b)
    res, k = float("inf"), 0
    while k < max_iterations and res > tolerance:
        r = b - _spmv(matrix, x)
        x = x + dinv * r
        k += 1
        res = float(torch.linalg.vector_norm(r))
    res = float(torch.linalg.vector_norm(b - _spmv(matrix, x)))
    return SolverResult(x, k, res, res <= tolerance)
