"""Degree-bucketed SpMM, the general-degree (power-law) path (port of
ruvector_tpu/ops/spmm_bucketed.py).

Padding every row to the maximum degree multiplies the gather traffic by
max/mean degree (32x on a zipf graph with max 512 and mean 16). Rows are
grouped instead into power-of-two degree classes, which bounds the
padding below 2x; each class is one dense masked reduction. The result is
CSR SpMM out[i] = sum_e w[e] x[col[e]]: bucketing only regroups rows.
Plain PyTorch, as the JAX package leaves it to XLA.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class BucketPlan:
    """Rows grouped by degree class. Per bucket b: rows[b] [Nb] int32
    original row ids, nbr[b] [Nb, caps[b]] int32, w[b] [Nb, caps[b]]
    float32 (weight on real edges, 0 on padding)."""

    rows: tuple
    nbr: tuple
    w: tuple
    num_nodes: int
    caps: tuple


def build_bucket_plan(csr, min_cap: int = 8) -> BucketPlan:
    """Host side: split the CSR rows into power-of-two degree buckets
    (caps min_cap, 2 min_cap, ...; degree-0 rows in none). The plan's
    tensors live on the graph's device."""
    row_ptr = csr.row_ptr.cpu().numpy().astype(np.int64)
    col_idx = csr.col_idx.cpu().numpy()
    values = csr.values.cpu().numpy()
    dev = csr.row_ptr.device
    deg = row_ptr[1:] - row_ptr[:-1]
    caps, rows_l, nbr_l, w_l = [], [], [], []
    cap = min_cap
    remaining = np.arange(csr.num_nodes)[deg > 0]
    while remaining.size:
        in_b = remaining[deg[remaining] <= cap]
        remaining = remaining[deg[remaining] > cap]
        if in_b.size:
            slot = np.arange(cap)[None, :]
            real = slot < deg[in_b][:, None]
            pos = np.where(real, row_ptr[in_b][:, None] + slot, 0)
            nbr = np.where(real, col_idx[pos], 0).astype(np.int32)
            w = np.where(real, values[pos], 0.0).astype(np.float32)
            caps.append(cap)
            rows_l.append(torch.from_numpy(in_b.astype(np.int32)).to(dev))
            nbr_l.append(torch.from_numpy(nbr).to(dev))
            w_l.append(torch.from_numpy(w).to(dev))
        cap *= 2
    return BucketPlan(rows=tuple(rows_l), nbr=tuple(nbr_l), w=tuple(w_l),
                      num_nodes=csr.num_nodes, caps=tuple(caps))


def spmm_bucketed(plan: BucketPlan, features: torch.Tensor) -> torch.Tensor:
    """out[i] = sum_j w[i, j] * x[nbr[i, j]] over all buckets: [N, D]."""
    out = torch.zeros((plan.num_nodes, features.shape[-1]), dtype=features.dtype,
                      device=features.device)
    for rows, nbr, w in zip(plan.rows, plan.nbr, plan.w):
        contrib = torch.einsum("nc,ncd->nd", w, features[nbr.long()])
        out[rows.long()] = contrib                  # the buckets' rows are disjoint
    return out
