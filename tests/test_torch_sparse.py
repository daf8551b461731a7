"""Parity of the port's sparse path against the JAX package, on the CPU:
the CSR functions of `ops/segment.py`, the degree-bucketed SpMM and the
plain version of K9 (the gather-fused SpMM) against JAX's Pallas kernel in
interpret mode.

Tolerances: 1e-5 for the CSR and bucketed sums (f32 sums of at most 64
products, in another order); 1e-4 for K9, the bound of the JAX package's
own test (test_pallas.py), which the plain version meets with room
(both sides sum 16 products of order 1).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ruvector_tpu.graph import CSRGraph as JCSR
from ruvector_tpu.graph import NeighborGraph as JNG
from ruvector_tpu.ops import sddmm_csr as jsddmm_csr
from ruvector_tpu.ops import segment_softmax_csr as jsoftmax_csr
from ruvector_tpu.ops import spmm_csr as jspmm_csr
from ruvector_tpu.ops.pallas.spmm import spmm_pallas
from ruvector_tpu.ops.segment import spmm_padded as jspmm_padded
from ruvector_tpu.ops.spmm_bucketed import build_bucket_plan as jbuild_plan
from ruvector_tpu.ops.spmm_bucketed import spmm_bucketed as jspmm_bucketed
from ruvector_tpu_torch.graph import CSRGraph, NeighborGraph
from ruvector_tpu_torch.ops import (
    build_bucket_plan,
    sddmm_csr,
    segment_softmax_csr,
    spmm_bucketed,
    spmm_csr,
)
from ruvector_tpu_torch.ops.kernels.spmm import (
    TILE_EDGES,
    WINDOW_BYTES,
    rows_per_tile,
    spmm_gather,
    spmm_gather_reference,
    staged_tiles,
)

TOL = 1e-5
K9_TOL = 1e-4


def _graphs(seed, n=50, max_deg=8):
    """test_ops.py's random graph (degree 0..max_deg, weights U(0, 1)) with
    node 0 forced empty, in both packages, and their CSR forms."""
    rng = np.random.default_rng(seed)
    lists, weights = [], []
    for i in range(n):
        deg = 0 if i == 0 else int(rng.integers(0, max_deg + 1))
        lists.append(rng.choice(n, size=deg, replace=False).tolist())
        weights.append(rng.random(deg).astype(np.float32).tolist())
    jg = JNG.from_lists(lists, weights, max_degree=max_deg)
    tg = NeighborGraph.from_lists(lists, weights, max_degree=max_deg, device="cpu")
    jcsr, tcsr = jg.to_csr(), tg.to_csr()
    np.testing.assert_array_equal(tcsr.row_ptr.numpy(), np.asarray(jcsr.row_ptr))
    np.testing.assert_array_equal(tcsr.col_idx.numpy(), np.asarray(jcsr.col_idx))
    assert int(tcsr.degrees()[0]) == 0
    return rng, jcsr, tcsr


def _t(x):
    return torch.from_numpy(np.asarray(x))


def test_spmm_csr_matches_jax():
    rng, jcsr, tcsr = _graphs(1)
    x = rng.normal(size=(50, 16)).astype(np.float32)
    got = spmm_csr(tcsr, _t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(jspmm_csr(jcsr, jnp.asarray(x))),
                               atol=TOL, rtol=0)
    assert float(got[0].abs().max()) == 0.0          # the empty row


def test_sddmm_csr_matches_jax():
    rng, jcsr, tcsr = _graphs(2)
    q = rng.normal(size=(50, 16)).astype(np.float32)
    k = rng.normal(size=(50, 16)).astype(np.float32)
    got = sddmm_csr(tcsr, _t(q), _t(k))
    assert got.shape == (tcsr.num_edges,)
    np.testing.assert_allclose(got.numpy(), np.asarray(jsddmm_csr(jcsr, jnp.asarray(q),
                                                                  jnp.asarray(k))),
                               atol=TOL, rtol=0)


def test_segment_softmax_csr_matches_jax_and_rows_sum_to_one():
    rng, jcsr, tcsr = _graphs(3)
    scores = (3.0 * rng.normal(size=(tcsr.num_edges,))).astype(np.float32)
    got = segment_softmax_csr(tcsr, _t(scores)).numpy()
    np.testing.assert_allclose(got, np.asarray(jsoftmax_csr(jcsr, jnp.asarray(scores))),
                               atol=TOL, rtol=0)
    rows = tcsr.row_ids().numpy()
    for i in range(tcsr.num_nodes):
        if (rows == i).any():
            np.testing.assert_allclose(got[rows == i].sum(), 1.0, rtol=1e-5)
    assert np.isfinite(got).all()


def _zipf_csr(n=400, seed=0):
    """test_ops.py's power-law graph: zipf(1.8)*2 degrees capped at 64,
    uniform random destinations, weights U(0.1, 1)."""
    rng = np.random.default_rng(seed)
    deg = np.minimum(rng.zipf(1.8, n) * 2, 64).astype(np.int64)
    deg[:3] = 0                                           # rows in no bucket
    src = np.repeat(np.arange(n, dtype=np.int64), deg)
    dst = rng.integers(0, n, src.size).astype(np.int64)
    w = rng.uniform(0.1, 1.0, src.size).astype(np.float32)
    return (rng, src.size, JCSR.from_edges(src, dst, w, n),
            CSRGraph.from_edges(src, dst, w, n, device="cpu"))


def test_spmm_bucketed_matches_jax():
    rng, edges, jcsr, tcsr = _zipf_csr()
    x = rng.standard_normal((400, 24)).astype(np.float32)
    jplan, plan = jbuild_plan(jcsr), build_bucket_plan(tcsr)
    assert plan.caps == jplan.caps and plan.num_nodes == jplan.num_nodes
    for part in ("rows", "nbr", "w"):
        for got, want in zip(getattr(plan, part), getattr(jplan, part)):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    got = spmm_bucketed(plan, _t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(jspmm_bucketed(jplan, jnp.asarray(x))),
                               atol=TOL, rtol=0)
    np.testing.assert_allclose(got.numpy(), spmm_csr(tcsr, _t(x)).numpy(), atol=TOL, rtol=0)
    cells = sum(r.shape[0] * c for r, c in zip(plan.rows, plan.caps))
    assert cells < 2 * edges


@pytest.mark.parametrize("b", [64, 50])
def test_spmm_gather_plain_version_matches_jax_kernel(b):
    """test_pallas.py's shape (n=200, m=16, d=128, tile_b=32); b=50 makes
    the JAX wrapper pad its last tile."""
    rng = np.random.default_rng(3)
    n, m, d = 200, 16, 128
    feats = rng.normal(size=(n, d)).astype(np.float32)
    idx = rng.integers(0, n, size=(b, m)).astype(np.int32)
    mask = (rng.random((b, m)) > 0.3).astype(np.float32)
    w = rng.random((b, m)).astype(np.float32) * mask
    want = np.asarray(spmm_pallas(jnp.asarray(feats), jnp.asarray(idx), jnp.asarray(w),
                                  tile_b=32, interpret=True))
    got = spmm_gather(_t(feats), _t(idx), _t(w))
    assert got.shape == (b, d) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=K9_TOL, rtol=K9_TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(jspmm_padded(
        jnp.asarray(feats), jnp.asarray(idx), jnp.asarray(w), jnp.asarray(mask))),
        atol=K9_TOL, rtol=0)


def test_spmm_gather_plain_version_skips_indices_out_of_range():
    """An edge whose index lies outside [0, N) adds nothing (the kernel
    never reads its row): the result equals the JAX SpMM with that edge's
    weight set to 0."""
    rng = np.random.default_rng(4)
    n, b, m, d = 30, 7, 5, 8
    feats = rng.normal(size=(n, d)).astype(np.float32)
    idx = rng.integers(0, n, size=(b, m)).astype(np.int32)
    w = rng.random((b, m)).astype(np.float32)
    bad = idx.copy()
    bad[0, 1], bad[3, 4], bad[6, 0] = -1, n, n + 1000
    kept = np.where(bad == idx, w, 0.0).astype(np.float32)
    want = np.asarray(jspmm_padded(jnp.asarray(feats), jnp.asarray(idx), jnp.asarray(kept),
                                   jnp.ones((b, m), jnp.float32)))
    got = spmm_gather_reference(_t(feats), _t(bad), _t(w))
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)


@pytest.mark.parametrize("m, rows", [(0, 128), (1, 128), (16, 128), (17, 120), (40, 51),
                                     (1024, 2), (1025, 1), (3000, 1)])
def test_k9_rows_per_tile(m, rows):
    """A tile holds as many rows as TILE_EDGES edges, 1..128."""
    assert rows_per_tile(m) == rows


def _staged_share_by_loops(idx: np.ndarray, n: int, d: int) -> float:
    """The kernel's per-tile rule written out: each batch of a tile's
    edges (flattened rows, at most TILE_EDGES at once) is staged when its
    indices in [0, n) span at most WINDOW_BYTES of feature rows."""
    b, m = idx.shape
    r = rows_per_tile(m)
    flags = []
    for r0 in range(0, b, r):
        edges = idx[r0:r0 + r].reshape(-1)
        for e0 in range(0, edges.size, TILE_EDGES):
            part = edges[e0:e0 + TILE_EDGES]
            ok = part[(part >= 0) & (part < n)]
            flags.append(ok.size > 0 and (int(ok.max()) - int(ok.min()) + 1) * d * 4
                         <= WINDOW_BYTES)
    return float(np.mean(flags))


@pytest.mark.parametrize("n, b, m, d, kind", [
    (1000, 300, 16, 128, "clustered"),   # 128-row clusters: every tile staged
    (1000, 300, 16, 512, "clustered"),   # 40 rows fit at D = 512: none staged
    (400, 250, 16, 128, "mixed"),        # one tile staged, one not
    (2000, 333, 17, 128, "random"),      # ragged last tile, no tile staged
    (300, 5, 2500, 32, "clustered"),     # rows longer than a batch
])
def test_k9_staged_tiles_share(n, b, m, d, kind):
    """`staged_tiles` (vectorised, what chip_smoke.py reports) equals the
    kernel's rule tile by tile, with out-of-range indices that neither
    widen a window nor count."""
    rng = np.random.default_rng(n + m)
    if kind == "random":
        idx = rng.integers(0, n, size=(b, m))
    else:
        base = (np.arange(b)[:, None] // 128) * 128
        idx = (base + rng.integers(0, 128, size=(b, m))) % n
        if kind == "mixed":  # the first tile clustered, the second random
            idx[128:] = rng.integers(0, n, size=(b - 128, m))
    idx = idx.astype(np.int32)
    idx[1, 2], idx[3, 0] = -5, n + 1000
    got = staged_tiles(torch.from_numpy(idx), n, d)
    assert got == _staged_share_by_loops(idx, n, d)
    cluster_fits = 128 * d * 4 <= WINDOW_BYTES
    assert got == {"clustered": float(cluster_fits), "random": 0.0, "mixed": 0.5}[kind]


def test_k9_staged_tiles_of_empty_inputs():
    assert staged_tiles(torch.zeros((0, 16), dtype=torch.int32), 10, 128) == 0.0
    assert staged_tiles(torch.zeros((5, 0), dtype=torch.int32), 10, 128) == 0.0
    assert staged_tiles(torch.full((5, 3), -1, dtype=torch.int32), 10, 128) == 0.0


@pytest.mark.parametrize("variant", ["drop_last_edge", "no_such_variant"])
def test_k9_variants_raise_on_cpu_tensors(variant):
    """The planted fault runs on the card only; an unknown name raises
    everywhere."""
    feats = torch.zeros(10, 128)
    idx = torch.zeros(4, 3, dtype=torch.int32)
    with pytest.raises(ValueError, match="variant"):
        spmm_gather(feats, idx, torch.ones(4, 3), variant=variant)
