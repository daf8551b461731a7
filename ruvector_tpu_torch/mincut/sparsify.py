"""Spectral graph sparsification by effective-resistance sampling (port
of ruvector_tpu/mincut/sparsify.py).

Reference: ruvector-mincut/src/sparsify — cut-preserving sparsifiers
feeding the j-tree hierarchy. Spielman-Srivastava: sampling each edge
with probability proportional to w_e * R_eff(e) (and reweighting by
1/p_e) preserves every cut within (1 ± eps) with O(n log n / eps^2)
edges.

Solver tie-in: effective resistances come from Laplacian solves —
R_eff(u,v) = (e_u - e_v)^T L^+ (e_u - e_v) — computed here with a few CG
solves against random probe vectors (Johnson-Lindenstrauss sketch of
B L^+, the standard trick), reusing solver/iterative.cg_solve on
`device` (default: the CUDA card). The solves are device math; the
sketch and the sampling are host numpy, drawn from the same seeded
generators as the JAX package.
"""

from __future__ import annotations

import numpy as np

from ruvector_tpu_torch.graph.csr import CSRGraph


def _laplacian_csr(src, dst, w, n, device=None) -> CSRGraph:
    rows = np.concatenate([src, dst, np.arange(n)])
    cols = np.concatenate([dst, src, np.arange(n)])
    deg = np.zeros(n)
    np.add.at(deg, src, w)
    np.add.at(deg, dst, w)
    vals = np.concatenate([-w, -w, deg + 1e-6])
    return CSRGraph.from_edges(rows, cols, vals.astype(np.float32), n, device=device)


def effective_resistances(src, dst, w, n, probes: int = 12,
                          seed: int = 0, device=None) -> np.ndarray:
    """Approximate R_eff per edge via JL-sketched Laplacian solves."""
    from ruvector_tpu_torch.solver import cg_solve

    lap = _laplacian_csr(np.asarray(src), np.asarray(dst),
                         np.asarray(w, np.float64), n, device)
    rng = np.random.default_rng(seed)
    m = len(src)
    # sketch rows of W^1/2 B: q_k = random +-1 combination of edge rows
    z = np.zeros((probes, n), np.float32)
    for k in range(probes):
        signs = rng.choice([-1.0, 1.0], size=m) * np.sqrt(w) / np.sqrt(probes)
        row = np.zeros(n)
        np.add.at(row, src, signs)
        np.add.at(row, dst, -signs)
        sol = cg_solve(lap, row.astype(np.float32), tolerance=1e-6,
                       max_iterations=500)
        z[k] = sol.x.cpu().numpy()
    # R_eff(e) ~= || Z (e_u - e_v) ||^2
    diff = z[:, src] - z[:, dst]                  # [probes, m]
    return np.maximum((diff ** 2).sum(axis=0), 1e-12)


def spectral_sparsify(src, dst, w, n, eps: float = 0.5, seed: int = 0,
                      device=None) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Sample edges ∝ w * R_eff; returns (src', dst', w') reweighted so
    cuts are preserved within ~(1 ± eps)."""
    src = np.asarray(src); dst = np.asarray(dst)
    w = np.asarray(w, np.float64)
    m = len(src)
    r = effective_resistances(src, dst, w, n, seed=seed, device=device)
    scores = w * r                                 # leverage ~ importance
    q = max(int(9.0 * n * np.log(max(n, 2)) / (eps * eps) / 4), n)
    q = min(q, 4 * m)                              # cap the sample budget
    p = np.minimum(scores / scores.sum(), 1.0)
    rng = np.random.default_rng(seed + 1)
    counts = rng.multinomial(q, p / p.sum())
    keep = counts > 0
    new_w = w[keep] * counts[keep] / (q * (p[keep] / p.sum()))
    return src[keep], dst[keep], new_w.astype(np.float32)


def cut_value(src, dst, w, side: np.ndarray) -> float:
    """Weight of edges crossing the boolean partition `side` (undirected)."""
    side = np.asarray(side, bool)
    cross = side[np.asarray(src)] != side[np.asarray(dst)]
    return float(np.asarray(w)[cross].sum())
