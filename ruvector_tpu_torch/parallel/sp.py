"""Sequence parallelism: ring attention over the ranks (port of
ruvector_tpu/parallel/sp.py).

The sequence is split over the ranks; each rank keeps its Q block and
rotates the K/V blocks around the ring with ring shifts, folding each
incoming block into the running (max, sum, accumulator) online-softmax
state: FlashAttention's blockwise recurrence, distributed. The causal mask
is taken on global rows and columns.
"""

from __future__ import annotations

import torch

from ruvector_tpu_torch.parallel.mesh import Mesh


def _block_update(m, l, acc, q, k, v, scale, mask):
    """Fold one K/V block into the online-softmax state."""
    s = (q @ k.T) * scale                                 # [Bq, Bk]
    s = torch.where(mask, s, torch.full_like(s, -torch.inf))
    m_new = torch.maximum(m, torch.max(s, dim=-1).values)
    # fully masked rows keep m = -inf
    safe_m = torch.where(torch.isfinite(m_new), m_new, torch.zeros_like(m_new))
    p = torch.where(mask, torch.exp(s - safe_m[:, None]), torch.zeros_like(s))
    corr = torch.exp(torch.where(torch.isfinite(m), m - safe_m, torch.full_like(m, -torch.inf)))
    return m_new, corr * l + torch.sum(p, dim=-1), corr[:, None] * acc + p @ v


def make_ring_attention(mesh: Mesh, seq_len: int, causal: bool = True):
    """attention(q, k, v) on this rank, the sequence split over the ranks:
    q, k, v are the rank's blocks [S/n, D] (or the whole [S, D], of which
    the rank takes its block); returns the rank's output rows [S/n, D]."""
    n_dev = mesh.size
    if seq_len % n_dev:
        raise ValueError("seq_len must divide over the ranks")
    blk = seq_len // n_dev
    me = mesh.rank

    def attention(q, k, v):
        q, k_blk, v_blk = (mesh.own_rows(t, blk) for t in (q, k, v))
        dev = q.device
        scale = 1.0 / torch.sqrt(torch.tensor(float(q.shape[-1]), dtype=torch.float32,
                                              device=dev))
        rows = me * blk + torch.arange(blk, device=dev)
        m = torch.full((blk,), -torch.inf, device=dev)
        l = torch.zeros((blk,), device=dev)
        acc = torch.zeros_like(q)
        for r in range(n_dev):
            # the K/V block held now came from rank (me - r) mod n
            cols = ((me - r) % n_dev) * blk + torch.arange(blk, device=dev)
            mask = (cols[None, :] <= rows[:, None]) if causal else \
                torch.ones((blk, blk), dtype=torch.bool, device=dev)
            m, l, acc = _block_update(m, l, acc, q, k_blk, v_blk, scale, mask)
            if r + 1 < n_dev:
                k_blk, v_blk = mesh.ppermute(k_blk, 1), mesh.ppermute(v_blk, 1)
        return acc / torch.clamp(l, min=1e-20)[:, None]

    return attention


def reference_attention(q, k, v, causal: bool = True):
    """Dense one-process oracle."""
    s = (q @ k.T) / torch.sqrt(torch.tensor(float(q.shape[-1]), dtype=torch.float32,
                                            device=q.device))
    if causal:
        n = q.shape[0]
        tril = torch.tril(torch.ones((n, n), dtype=torch.bool, device=q.device))
        s = torch.where(tril, s, torch.full_like(s, -torch.inf))
    return torch.softmax(s, dim=-1) @ v
