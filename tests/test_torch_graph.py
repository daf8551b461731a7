"""Parity of the port's graph layouts and builders against the JAX
package, on the CPU: kNN construction, graph-grown blocking and the
block-dense layout must give the same graphs (exactly, except kNN, where
top-k ties may order equal neighbors differently, so neighbor sets and
similarities are compared at 1e-5)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ruvector_tpu.graph import CSRGraph as JCSR
from ruvector_tpu.graph import NeighborGraph as JNG
from ruvector_tpu.graph import build_block_dense as jbuild_block_dense
from ruvector_tpu.graph import build_knn_graph as jbuild_knn
from ruvector_tpu.graph import knn_graph_numpy as jknn_numpy
from ruvector_tpu.graph.neighbors import pad_degree_to as jpad_degree_to
from ruvector_tpu.parallel.ordering import graph_grow_blocks as jgrow
from ruvector_tpu_torch.graph import (
    CSRGraph,
    NeighborGraph,
    build_block_dense,
    build_knn_graph,
    knn_graph_numpy,
    pad_degree_to,
)
from ruvector_tpu_torch.parallel.ordering import graph_grow_blocks


def _eq(got, want):
    np.testing.assert_array_equal(np.asarray(got.cpu() if hasattr(got, "cpu") else got),
                                  np.asarray(want))


def _clustered(n, d, seed):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(max(n // 25, 2), d)).astype(np.float32)
    return (centers[rng.integers(0, len(centers), size=n)]
            + 0.25 * rng.normal(size=(n, d))).astype(np.float32)


@pytest.mark.parametrize("metric", ["cosine", "euclidean"])
def test_build_knn_graph(metric):
    x = _clustered(300, 32, seed=0)
    want = jbuild_knn(jnp.asarray(x), k=8, metric=metric, block=128)
    got = build_knn_graph(x, k=8, metric=metric, block=128, device="cpu")
    w_idx, g_idx = np.asarray(want.nbr_idx), got.nbr_idx.numpy()
    assert g_idx.dtype == np.int32 and g_idx.shape == w_idx.shape
    same = [set(a) == set(b) for a, b in zip(g_idx.tolist(), w_idx.tolist())]
    assert np.mean(same) > 0.99           # top-k ties may swap a last slot
    np.testing.assert_allclose(np.sort(got.edge_weight.numpy(), 1),
                               np.sort(np.asarray(want.edge_weight), 1), atol=1e-5)
    assert not np.any(g_idx == np.arange(300)[:, None])   # self excluded


def test_knn_graph_numpy_identical():
    x = _clustered(120, 16, seed=1)
    for a, b in zip(knn_graph_numpy(x, k=6), jknn_numpy(x, k=6)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("leaf_size", [32, 64, 100])
def test_graph_grow_blocks_identical(leaf_size):
    x = _clustered(400, 16, seed=2)
    idx, _ = jknn_numpy(x, k=6)
    mask = np.ones_like(idx, dtype=np.float32)
    mask[::7, 4:] = 0.0
    perm, leaves = graph_grow_blocks(idx, mask, leaf_size=leaf_size)
    jperm, jleaves = jgrow(idx, mask, leaf_size=leaf_size)
    np.testing.assert_array_equal(perm, jperm)
    assert leaves == jleaves


def _random_graph(n, m, seed, duplicate_slots=False):
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, n, (n, m)).astype(np.int32)
    if duplicate_slots:
        idx[1, 1:] = idx[1, 0]
    mask = np.ones((n, m), np.float32)
    mask[7] = 0.0                       # degree-0 node
    mask[11, 2:] = 0.0                  # partial degree
    ew = rng.uniform(0.0, 1.0, (n, m)).astype(np.float32)
    ew[5, 0] = 0.0                      # real zero-weight edge
    ew[13] = 0.0                        # zero-weight row: uniform fallback
    return idx, mask, ew


def _assert_same_layout(got, want):
    for name in ("local_ids", "wdense", "degrees", "node_pad", "node_pos"):
        _eq(getattr(got, name), np.asarray(getattr(want, name)))
    assert got.n == want.n
    assert (got.log_mult is None) == (want.log_mult is None)
    if got.log_mult is not None:
        _eq(got.log_mult, np.asarray(want.log_mult))


@pytest.mark.parametrize("n,m,block,dup", [(203, 5, 64, False), (300, 6, 128, True),
                                           (600, 12, 256, False)])
def test_build_block_dense_uniform(n, m, block, dup):
    idx, mask, ew = _random_graph(n, m, seed=n, duplicate_slots=dup)
    want = jbuild_block_dense(idx, mask, ew, block=block, device_fill=False)
    got = build_block_dense(idx, mask, ew, block=block, device="cpu")
    _assert_same_layout(got, want)
    if dup:
        assert got.log_mult is not None


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_build_block_dense_leaf_sizes(dtype):
    x = _clustered(500, 16, seed=3)
    idx, sim = jknn_numpy(x, k=8)
    mask = np.ones_like(idx, dtype=np.float32)
    ew = np.maximum(sim, 1e-6)
    perm, leaves = graph_grow_blocks(idx, mask, leaf_size=64)
    inv = np.empty(500, np.int64)
    inv[perm] = np.arange(500)
    idx_r = inv[idx[perm]].astype(np.int32)
    jdtype = jnp.bfloat16 if dtype == torch.bfloat16 else np.float32
    want = jbuild_block_dense(idx_r, mask[perm], ew[perm], leaf_sizes=leaves, dtype=jdtype)
    got = build_block_dense(idx_r, mask[perm], ew[perm], leaf_sizes=leaves, dtype=dtype,
                            device="cpu")
    assert got.wdense.dtype == dtype
    for name in ("local_ids", "degrees", "node_pad", "node_pos"):
        _eq(getattr(got, name), np.asarray(getattr(want, name)))
    _eq(got.wdense.float(), np.asarray(want.wdense).astype(np.float32))
    assert got.block % 8 == 0 and got.table % 128 == 0


def test_tail_block_halo_layout():
    """n % block != 0: the tail block's halo starts at column `block`."""
    rng = np.random.default_rng(7)
    n, m = 600, 12
    idx = rng.integers(0, n, (n, m)).astype(np.int32)
    mask = np.ones((n, m), np.float32)
    ew = rng.uniform(0.1, 1.0, (n, m)).astype(np.float32)
    want = jbuild_block_dense(idx, mask, ew, block=256, device_fill=False)
    got = build_block_dense(idx, mask, ew, block=256, device="cpu")
    assert got.table > got.block
    _assert_same_layout(got, want)
    tail = got.n_blocks - 1
    own = n - tail * got.block
    assert int(got.local_ids[tail, own:got.block].abs().sum()) == 0   # padding gap
    assert int((got.local_ids[tail, got.block:] != 0).sum()) > 0     # halo from column B


def test_pad_features_unpad_round_trip():
    idx, mask, ew = _random_graph(203, 5, seed=9)
    bdg = build_block_dense(idx, mask, ew, block=64, device="cpu")
    f = torch.randn(203, 8, generator=torch.Generator().manual_seed(0))
    fp = bdg.pad_features(f)
    assert fp.shape == (bdg.n_blocks * bdg.block, 8)
    assert torch.equal(bdg.unpad(fp), f)


def test_neighbor_graph_and_csr():
    lists = [[1, 2], [], [0, 3, 4], [2], [0, 1, 2, 3]]
    weights = [[0.5, 0.25], [], [1.0, 2.0, 3.0], [0.1], [1, 1, 1, 1]]
    want = JNG.from_lists(lists, weights, max_degree=4)
    got = NeighborGraph.from_lists(lists, weights, max_degree=4, device="cpu")
    for name in ("nbr_idx", "nbr_mask", "edge_weight"):
        _eq(getattr(got, name), np.asarray(getattr(want, name)))
    _eq(got.degrees(), np.asarray(want.degrees()))
    feats = np.arange(20, dtype=np.float32).reshape(5, 4)
    _eq(got.gather(torch.from_numpy(feats)), np.asarray(want.gather(jnp.asarray(feats))))
    csr, jcsr = got.to_csr(), want.to_csr()
    for name in ("row_ptr", "col_idx", "values"):
        _eq(getattr(csr, name), np.asarray(getattr(jcsr, name)))
    _eq(csr.row_ids(), np.asarray(jcsr.row_ids()))
    back = csr.to_padded(4)
    _eq(back.nbr_idx, np.asarray(want.nbr_idx))
    for m in (2, 4, 6):
        _eq(pad_degree_to(got, m).nbr_idx, np.asarray(jpad_degree_to(want, m).nbr_idx))


def test_csr_from_edges():
    src = np.array([2, 0, 1, 2, 0])
    dst = np.array([1, 2, 0, 0, 1])
    w = np.array([0.5, 1.0, 2.0, 3.0, 4.0], np.float32)
    got = CSRGraph.from_edges(src, dst, w, 3, device="cpu")
    want = JCSR.from_edges(src, dst, w, 3)
    for name in ("row_ptr", "col_idx", "values"):
        _eq(getattr(got, name), np.asarray(getattr(want, name)))
    _eq(got.degrees(), np.asarray(want.degrees()))
