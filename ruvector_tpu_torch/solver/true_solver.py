"""TRUE solver: a sketched solve through a Johnson-Lindenstrauss
projection (port of ruvector_tpu/solver/true_solver.py).

x ~= S^T (S A S^T + ridge I)^-1 S b with a dense Rademacher sketch S
[k, n] (entries +-1/sqrt(k)), k = O(log n / eps^2). A S^T is one sparse
product (`ops/segment.spmm_csr`, taken in column chunks so that the
per-edge gather stays under ~1 GB), S (A S^T) and the k x k solve are
dense float32. The sketch is drawn from a seeded CPU generator, so a seed
gives the same sketch on every device; it is not `jax.random`'s sketch,
which a caller may pass in instead (`preprocess(matrix, sketch=...)`).
The preprocessing is cached for repeated right-hand sides.
"""

from __future__ import annotations

import math

import torch

from ruvector_tpu_torch.graph.csr import CSRGraph
from ruvector_tpu_torch.ops.segment import spmm_csr

_GATHER_FLOATS = 1 << 28    # per-edge gather of one column chunk: 1 GB of float32


class TrueSolver:
    """Approximate solve x ~= S^T (S A S^T)^-1 S b with a JL sketch S."""

    def __init__(self, tolerance: float = 0.1, jl_dimension: int = 0,
                 seed: int = 42, ridge: float = 1e-6):
        if not (0.0 < tolerance < 1.0):
            raise ValueError("tolerance must be in (0, 1)")
        self.tolerance = tolerance
        self.jl_dimension = jl_dimension
        self.seed = seed
        self.ridge = ridge
        self._prep = None       # (S [k, n], S A S^T + ridge I [k, k]), cached

    def _dimension(self, n: int) -> int:
        if self.jl_dimension:
            return min(self.jl_dimension, n)
        eps = self.tolerance / 3.0
        return min(n, max(8, int(math.ceil(4.0 * math.log(max(n, 2)) / eps**2 / 100))))

    def preprocess(self, matrix: CSRGraph, sketch=None) -> "TrueSolver":
        """Build and cache the sketch (true_solver.rs TruePreprocessing):
        `sketch` [k, n] if given, else Rademacher signs / sqrt(k) from
        the seed."""
        n = matrix.num_nodes
        dev = matrix.row_ptr.device
        if sketch is None:
            k = self._dimension(n)
            gen = torch.Generator(device="cpu").manual_seed(int(self.seed))
            signs = torch.randint(0, 2, (k, n), generator=gen).to(torch.float32) * 2.0 - 1.0
            s = (signs / math.sqrt(k)).to(dev)
        else:
            s = torch.as_tensor(sketch, dtype=torch.float32).to(dev)
            k = s.shape[0]
        chunk = max(1, _GATHER_FLOATS // max(matrix.num_edges, 1))
        st = s.T
        ast = torch.cat([spmm_csr(matrix, st[:, c:c + chunk].contiguous())
                         for c in range(0, k, chunk)], dim=1)          # [n, k]
        a_k = s @ ast + self.ridge * torch.eye(k, device=dev)
        self._prep = (s, a_k)
        return self

    def solve(self, matrix: CSRGraph, b) -> torch.Tensor:
        if self._prep is None:
            self.preprocess(matrix)
        s, a_k = self._prep
        b = torch.as_tensor(b, dtype=torch.float32).to(s.device)
        xk = torch.linalg.solve(a_k, s @ b)
        return s.T @ xk
