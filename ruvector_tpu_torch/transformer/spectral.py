"""Spectral position encoding from min-cut boundary structure (port of
ruvector_tpu/transformer/spectral.py).

Reference: ruvector-mincut-gated-transformer/src/spectral.rs — SparseCSR
(:27-80), Laplacian from boundary edges (:222-290), power iteration
(:453-556), Lanczos (:557-750), SpectralPositionEncoder (:188-450).

Power iteration runs a fixed number of steps from a fixed start vector
(normalised ones) on the device, the sparse form through the CSR SpMM;
Lanczos runs on the host in float64 numpy from a seeded start, as the
reference's does.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ruvector_tpu_torch.convert import to_numpy
from ruvector_tpu_torch.graph.csr import CSRGraph
from ruvector_tpu_torch.ops.segment import spmm_csr


@dataclasses.dataclass(frozen=True)
class SpectralPEConfig:
    num_eigenvectors: int = 4
    max_iters: int = 32
    normalized: bool = True


def laplacian_from_edges(boundary_edges: list[tuple[int, int]], n: int,
                         normalized: bool = False) -> np.ndarray:
    """Dense (normalized) graph Laplacian L = D - A from undirected edges
    (spectral.rs:222-290)."""
    a = np.zeros((n, n), np.float32)
    for (i, j) in boundary_edges:
        if i < n and j < n and i != j:
            a[i, j] = 1.0
            a[j, i] = 1.0
    d = a.sum(axis=1)
    lap = np.diag(d) - a
    if normalized:
        dinv = np.where(d > 0, 1.0 / np.sqrt(np.maximum(d, 1e-12)), 0.0)
        lap = dinv[:, None] * lap * dinv[None, :]
    return lap


def _power_steps(apply, v: torch.Tensor, num_iters: int) -> torch.Tensor:
    for _ in range(num_iters):
        w = apply(v)
        norm = torch.linalg.vector_norm(w)
        v = torch.where(norm > 1e-12, w / torch.clamp(norm, min=1e-12), v)
    return v


def power_iteration(matrix: torch.Tensor, num_iters: int = 32) -> torch.Tensor:
    """Dominant eigenvector via deterministic power iteration
    (spectral.rs:453-500). Start vector = normalized ones."""
    n = matrix.shape[0]
    v0 = torch.ones(n, device=matrix.device) / torch.sqrt(
        torch.tensor(float(n), device=matrix.device))
    return _power_steps(lambda v: matrix @ v, v0, num_iters)


def power_iteration_sparse(csr: CSRGraph, num_iters: int = 32) -> torch.Tensor:
    """Sparse variant using CSR SpMV (spectral.rs:503-556)."""
    n = csr.num_nodes
    dev = csr.values.device
    v0 = torch.ones(n, 1, device=dev) / torch.sqrt(torch.tensor(float(n), device=dev))
    return _power_steps(lambda v: spmm_csr(csr, v), v0, num_iters)[:, 0]


def lanczos(matrix, k: int, max_iters: int = 32) -> tuple[np.ndarray, np.ndarray]:
    """Smallest-k eigenpairs via Lanczos tridiagonalization
    (spectral.rs:557-750). Returns (eigenvalues [k], eigenvectors [n, k]).

    Deterministic: fixed start vector, full reorthogonalization. Host
    numpy on a tensor or array, as the reference runs it.
    """
    mat = to_numpy(matrix).astype(np.float64)
    n = mat.shape[0]
    m = min(max_iters, n)
    q = np.zeros((n, m + 1))
    alpha = np.zeros(m)
    beta = np.zeros(m + 1)
    # deterministic seeded start: a uniform start has zero overlap with
    # antisymmetric eigenvectors on symmetric graphs and the Krylov space
    # never finds them — seeded noise breaks the symmetry reproducibly.
    v0 = np.random.default_rng(42).normal(size=n)
    q[:, 0] = v0 / np.linalg.norm(v0)
    for j in range(m):
        w = mat @ q[:, j]
        alpha[j] = q[:, j] @ w
        w = w - alpha[j] * q[:, j] - (beta[j] * q[:, j - 1] if j > 0 else 0)
        # full reorthogonalization for stability
        w -= q[:, : j + 1] @ (q[:, : j + 1].T @ w)
        beta[j + 1] = np.linalg.norm(w)
        if beta[j + 1] < 1e-10:
            m = j + 1
            break
        q[:, j + 1] = w / beta[j + 1]
    t = np.diag(alpha[:m]) + np.diag(beta[1:m], 1) + np.diag(beta[1:m], -1)
    evals, evecs = np.linalg.eigh(t)
    k = min(k, m)
    ritz = q[:, :m] @ evecs[:, :k]
    return evals[:k].astype(np.float32), ritz.astype(np.float32)


class SpectralPositionEncoder:
    """Positions from Laplacian eigenvectors (spectral.rs:188-450)."""

    def __init__(self, config: SpectralPEConfig = SpectralPEConfig()):
        self.config = config

    def encode_from_edges(
        self, boundary_edges: list[tuple[int, int]], n: int
    ) -> np.ndarray:
        """[n, num_eigenvectors] spectral PE. Skips the trivial 0-eigenvector."""
        if n == 0:
            return np.zeros((0, self.config.num_eigenvectors), np.float32)
        lap = laplacian_from_edges(boundary_edges, n, self.config.normalized)
        evals, evecs = lanczos(lap, self.config.num_eigenvectors + 1, self.config.max_iters)
        pe = evecs[:, 1 : self.config.num_eigenvectors + 1]
        if pe.shape[1] < self.config.num_eigenvectors:
            pe = np.pad(pe, ((0, 0), (0, self.config.num_eigenvectors - pe.shape[1])))
        return pe

    def spectral_distance(self, pe: np.ndarray, i: int, j: int) -> float:
        return float(np.linalg.norm(pe[i] - pe[j]))

    def add_to_embeddings(self, embeddings: torch.Tensor, pe: np.ndarray,
                          scale: float = 1.0) -> torch.Tensor:
        """Project PE into the embedding (broadcast-add first PE dims)."""
        d = embeddings.shape[-1]
        pe_full = torch.zeros(pe.shape[0], d, device=embeddings.device)
        k = min(pe.shape[1], d)
        pe_full[:, :k] = torch.from_numpy(np.ascontiguousarray(pe[:, :k])).to(embeddings.device)
        return embeddings + scale * pe_full
