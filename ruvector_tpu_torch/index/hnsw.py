"""HNSW index: ctypes wrapper over the native C++ implementation (port of
ruvector_tpu/index/hnsw.py).

Reference: ruvector-core/src/index/hnsw.rs (hnsw_rs wrapper; defaults
m=32, ef_construction=200, ef_search=100, ruvector-core/src/types.rs:86-97).
The library is the port's copy of `native/hnsw.cpp`, built by the native
runtime's loader (same flags, keyed on source, flags and CPU). Exports
level-0 adjacency straight into a NeighborGraph for GNN consumption, the
bridge between the serving index and the device compute path.

The native insert may move the index's storage (its vectors and link
lists grow by reallocation) while a search on another thread reads it, and
the call releases the GIL: a search that ran during an insert read freed
memory and crashed the process, in the JAX package too. So the wrapper
holds a readers-writer lock: searches and exports share it, inserts take it
alone.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import threading

import numpy as np
import torch

from ruvector_tpu_torch.device import resolve_device

_lib = None


def _load():
    global _lib
    if _lib is not None:
        return _lib
    from ruvector_tpu_torch import native

    lib = native.load_library("hnsw")
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    i64 = ctypes.c_int64
    lib.hnsw_new.argtypes = [i64, i64, i64, ctypes.c_int32, ctypes.c_uint64]
    lib.hnsw_new.restype = ctypes.c_void_p
    lib.hnsw_free.argtypes = [ctypes.c_void_p]
    lib.hnsw_add_batch.argtypes = [ctypes.c_void_p, f32p, i64]
    lib.hnsw_add_batch_parallel.argtypes = [ctypes.c_void_p, f32p, i64, i64]
    lib.hnsw_size.argtypes = [ctypes.c_void_p]
    lib.hnsw_size.restype = i64
    lib.hnsw_search_batch.argtypes = [ctypes.c_void_p, f32p, i64, i64, i64, i32p, f32p]
    lib.hnsw_search_batch_parallel.argtypes = [ctypes.c_void_p, f32p, i64, i64, i64, i64,
                                               i32p, f32p]
    lib.hnsw_max_degree.argtypes = [ctypes.c_void_p]
    lib.hnsw_max_degree.restype = i64
    lib.hnsw_adjacency.argtypes = [ctypes.c_void_p, i64, i32p, f32p]
    lib.hnsw_level_count.argtypes = [ctypes.c_void_p]
    lib.hnsw_level_count.restype = i64
    lib.hnsw_level_size.argtypes = [ctypes.c_void_p, i64]
    lib.hnsw_level_size.restype = i64
    lib.hnsw_level_nodes.argtypes = [ctypes.c_void_p, i64, i32p]
    _lib = lib
    return lib


class _ReadWriteLock:
    """Many readers or one writer; a waiting writer holds off new readers."""

    def __init__(self):
        self._cond = threading.Condition()
        self._readers = 0
        self._writer = False
        self._writers_waiting = 0

    @contextlib.contextmanager
    def read(self):
        with self._cond:
            while self._writer or self._writers_waiting:
                self._cond.wait()
            self._readers += 1
        try:
            yield
        finally:
            with self._cond:
                self._readers -= 1
                if not self._readers:
                    self._cond.notify_all()

    @contextlib.contextmanager
    def write(self):
        with self._cond:
            self._writers_waiting += 1
            while self._writer or self._readers:
                self._cond.wait()
            self._writers_waiting -= 1
            self._writer = True
        try:
            yield
        finally:
            with self._cond:
                self._writer = False
                self._cond.notify_all()


@dataclasses.dataclass(frozen=True)
class HnswConfig:
    """Defaults per ruvector-core/src/types.rs:86-97."""

    dim: int
    m: int = 32
    ef_construction: int = 200
    ef_search: int = 100
    metric: str = "cosine"   # cosine | l2
    seed: int = 42


class HnswIndex:
    """The graph, its inserts and its searches are host C++; the level-0
    graph exports to `device` (default: the CUDA card)."""

    def __init__(self, config: HnswConfig, device=None):
        self.config = config
        self.device = resolve_device(device)
        lib = _load()
        self._h = lib.hnsw_new(config.dim, config.m, config.ef_construction,
                               1 if config.metric == "cosine" else 0, config.seed)
        self._lib = lib
        self._rw = _ReadWriteLock()

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.hnsw_free(self._h)
            self._h = None

    def __len__(self) -> int:
        with self._rw.read():
            return int(self._lib.hnsw_size(self._h))

    def add(self, vector: np.ndarray):
        self.add_batch(np.asarray(vector, np.float32)[None, :])

    def add_batch(self, vectors: np.ndarray, num_threads: int = 0):
        """Insert a batch. num_threads=0: serial (deterministic order);
        >0: parallel phase-2 linking with per-node locks (order across
        threads is non-deterministic, recall preserved)."""
        v = np.ascontiguousarray(vectors, np.float32)
        if v.ndim != 2 or v.shape[1] != self.config.dim:
            raise ValueError(f"vectors have shape {v.shape}, the index width {self.config.dim}")
        with self._rw.write():
            if num_threads > 1:
                self._lib.hnsw_add_batch_parallel(self._h, v, v.shape[0], num_threads)
            else:
                self._lib.hnsw_add_batch(self._h, v, v.shape[0])

    def search(self, query: np.ndarray, k: int = 10,
               ef: int | None = None) -> tuple[np.ndarray, np.ndarray]:
        """Single query -> (ids [k], dists [k]); dists are squared L2 in the
        (normalized, for cosine) space; unused slots are id -1."""
        ids, dists = self.search_batch(np.asarray(query, np.float32)[None, :], k, ef)
        return ids[0], dists[0]

    def search_batch(self, queries: np.ndarray, k: int = 10, ef: int | None = None,
                     num_threads: int = 0) -> tuple[np.ndarray, np.ndarray]:
        q = np.ascontiguousarray(queries, np.float32)
        nq = q.shape[0]
        ef = ef or self.config.ef_search
        ids = np.zeros((nq, k), np.int32)
        dists = np.zeros((nq, k), np.float32)
        with self._rw.read():
            if num_threads > 1:
                self._lib.hnsw_search_batch_parallel(self._h, q, nq, k, ef, num_threads, ids,
                                                     dists)
            else:
                self._lib.hnsw_search_batch(self._h, q, nq, k, ef, ids, dists)
        return ids, dists

    def save(self, path, vectors: np.ndarray):
        """Serialize = dump vectors + config; load rebuilds by re-insertion,
        the reference's serialization strategy (index/hnsw.rs:136-228).
        The files are the JAX package's, so either package loads them."""
        import json
        from pathlib import Path

        path = Path(path)
        path.mkdir(parents=True, exist_ok=True)
        (path / "config.json").write_text(json.dumps(dataclasses.asdict(self.config)))
        np.save(path / "vectors.npy", np.asarray(vectors, np.float32))

    @staticmethod
    def load(path, device=None) -> tuple["HnswIndex", np.ndarray]:
        import json
        from pathlib import Path

        path = Path(path)
        cfg = HnswConfig(**json.loads((path / "config.json").read_text()))
        vectors = np.load(path / "vectors.npy")
        idx = HnswIndex(cfg, device=device)
        idx.add_batch(vectors)
        return idx, vectors

    def level_nodes(self) -> list[np.ndarray]:
        """Node ids per HNSW level, top level first: the layer structure
        consumed by serve.search.hierarchical_forward (search.rs:105-162)."""
        out = []
        with self._rw.read():
            levels = int(self._lib.hnsw_level_count(self._h))
            for lvl in range(levels - 1, -1, -1):
                n = int(self._lib.hnsw_level_size(self._h, lvl))
                ids = np.zeros(n, np.int32)
                if n:
                    self._lib.hnsw_level_nodes(self._h, lvl, ids)
                out.append(ids)
        return out

    def to_neighbor_graph(self):
        """Export level-0 adjacency as a NeighborGraph (GNN input) on the
        index's device; the edge weight is the mask, as in the JAX package."""
        from ruvector_tpu_torch.graph.neighbors import NeighborGraph

        with self._rw.read():
            n = int(self._lib.hnsw_size(self._h))
            max_deg = int(self._lib.hnsw_max_degree(self._h))
            idx = np.zeros((n, max_deg), np.int32)
            mask = np.zeros((n, max_deg), np.float32)
            self._lib.hnsw_adjacency(self._h, max_deg, idx, mask)
        mask_t = torch.from_numpy(mask).to(self.device)
        return NeighborGraph(nbr_idx=torch.from_numpy(idx).to(self.device), nbr_mask=mask_t,
                             edge_weight=mask_t.clone())
