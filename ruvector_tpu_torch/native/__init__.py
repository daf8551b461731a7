"""ctypes bindings for the native graph runtime (port of the JAX
package's `native` module).

`graph_runtime.cpp` and `hnsw.cpp` are byte-for-byte copies of the JAX
package's sources, built with the same g++ flags, so every native route
here gives the JAX package's results bit for bit. Each library is built
with g++ at first use into `ruvector_tpu_torch/_build/native/`
(git-ignored), named by a sha256 of its source, the flags and the host
CPU (the flags include `-march=native`, so a library built on one CPU is
never loaded on another). A build writes a temporary file and renames it
into place, so concurrent builders never load a half-written library.

Nothing is built at import: reading `available` (or calling any function
here) builds `graph_runtime.cpp` once per tree and CPU. `available` is
False when the build failed, and `build_error` then holds the compiler's
message; the callers' `auto` routes take their Python versions. Arrays go
in and come out on the host as numpy.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time
from pathlib import Path

import numpy as np

SOURCE_DIR = Path(__file__).resolve().parent
BUILD_DIR = SOURCE_DIR.parent / "_build" / "native"
CXX_FLAGS = ("-O3", "-march=native", "-funroll-loops", "-shared", "-fPIC", "-std=c++17",
             "-pthread")

# seconds each library's build took in this process (0.0: found built)
build_seconds: dict[str, float] = {}
_libs: dict[str, ctypes.CDLL] = {}
_lib = None
_build_lock = threading.Lock()


def cpu_signature() -> str:
    """The host CPU's model name and feature flags (what `-march=native`
    compiles for), from /proc/cpuinfo."""
    try:
        lines = Path("/proc/cpuinfo").read_text().splitlines()
    except OSError:
        import platform

        return platform.machine() + platform.processor()
    keys = ("model name", "flags", "Features", "CPU implementer", "CPU part")
    seen = {}
    for line in lines:
        key, _, value = line.partition(":")
        key = key.strip()
        if key in keys and key not in seen:
            seen[key] = value.strip()
    return "|".join(f"{k}={seen[k]}" for k in keys if k in seen)


def library_path(name: str, flags=CXX_FLAGS) -> Path:
    """The built library of `<name>.cpp`, named by a hash of the source, the
    flags and the CPU."""
    key = (SOURCE_DIR / f"{name}.cpp").read_bytes() + " ".join(flags).encode()
    digest = hashlib.sha256(key + cpu_signature().encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def load_library(name: str) -> ctypes.CDLL:
    """`<name>.cpp` built (if not yet) and loaded. Raises
    subprocess.CalledProcessError (with the compiler's output) or OSError
    when g++ fails or is missing."""
    with _build_lock:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        out = library_path(name)
        t0 = time.perf_counter()
        if not out.exists():
            out.parent.mkdir(parents=True, exist_ok=True)
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            try:
                subprocess.run(["g++", *CXX_FLAGS, str(SOURCE_DIR / f"{name}.cpp"), "-o",
                                str(tmp)], check=True, capture_output=True, text=True,
                               timeout=300)
                os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
            finally:
                tmp.unlink(missing_ok=True)
        build_seconds[name] = time.perf_counter() - t0
        lib = _libs[name] = ctypes.CDLL(str(out))
        return lib


def _declare(lib: ctypes.CDLL) -> None:
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    i32, i64, u64 = ctypes.c_int32, ctypes.c_int64, ctypes.c_uint64
    f32, f64, voidp = ctypes.c_float, ctypes.c_double, ctypes.c_void_p

    lib.bfs_reorder.argtypes = [i32p, f32p, i64, i64, i64p]
    lib.label_propagation_order.argtypes = [i32p, f32p, i64, i64, i64, i64p]
    lib.halo_plan_size.argtypes = [i32p, f32p, i64, i64, i64, i64]
    lib.halo_plan_size.restype = i64
    lib.halo_plan_fill.argtypes = [i32p, f32p, i64, i64, i64, i64, i64, i32p, f32p, i32p]
    lib.sample_fanout.argtypes = [i32p, f32p, i64, i64, i64, u64, i32p, f32p]
    lib.dinic_mincut_gate.argtypes = [f32p, i64, f32, f32, u8p]
    lib.dinic_mincut_gate.restype = f32
    lib.csr_count.argtypes = [f32p, i64, i64]
    lib.csr_count.restype = i64
    lib.csr_fill.argtypes = [i32p, f32p, f32p, i64, i64, i32p, i32p, f32p]

    lib.incmc_create.argtypes = [i32, i32, i32]
    lib.incmc_create.restype = voidp
    lib.incmc_free.argtypes = [voidp]
    lib.incmc_update.argtypes = [voidp, i32, i32, f32, i32]
    lib.incmc_value.argtypes = [voidp]
    lib.incmc_value.restype = f32
    lib.incmc_partition.argtypes = [voidp, u8p]
    lib.incmc_cut_edges.argtypes = [voidp, i32p, i32p, i64]
    lib.incmc_cut_edges.restype = i64
    lib.incmc_stats.argtypes = [voidp, i64p]

    lib.gmc_create.argtypes = [i32]
    lib.gmc_create.restype = voidp
    lib.gmc_free.argtypes = [voidp]
    lib.gmc_insert.argtypes = [voidp, i32, i32, f64]
    lib.gmc_delete.argtypes = [voidp, i32, i32]
    lib.gmc_reweight.argtypes = [voidp, i32, i32, f64]
    lib.gmc_value.argtypes = [voidp]
    lib.gmc_value.restype = f64
    lib.gmc_partition.argtypes = [voidp, u8p]
    lib.gmc_cut_edges.argtypes = [voidp, i32p, i32p, i64]
    lib.gmc_cut_edges.restype = i64
    lib.gmc_stats.argtypes = [voidp, i64p]

    lib.bdense_halo_max.argtypes = [i32p, f32p, i64, i64, i64, i64]
    lib.bdense_halo_max.restype = i64
    lib.bdense_fill.argtypes = [i32p, f32p, f32p, i64, i64, i64, i64, f32, i32, i64, i32p,
                                voidp, f32p, f32p, i64p]
    lib.bdense_fill.restype = i32
    lib.bdense_slots.argtypes = [i32p, f32p, i64, i64, i64, i64, i64, i32p, i32p]
    lib.bdense_slots.restype = i32
    lib.gen_cluster_knn.argtypes = [i64, i64, i64, i64, u64, i64, f32p, i32p, f32p]


def _load() -> None:
    """Build and bind graph_runtime.cpp once; sets `available` and
    `build_error`."""
    global _lib, available, build_error
    try:
        lib = load_library("graph_runtime")
    except subprocess.CalledProcessError as e:
        available, build_error = False, f"g++ exited with {e.returncode}:\n{e.stderr[-4000:]}"
        return
    except (OSError, subprocess.SubprocessError) as e:
        available, build_error = False, f"{type(e).__name__}: {e}"
        return
    _declare(lib)
    _lib, available, build_error = lib, True, None


def __getattr__(name):
    """`available` and `build_error` are resolved by the first build."""
    if name in ("available", "build_error"):
        _load()
        return globals()[name]
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def _runtime() -> ctypes.CDLL:
    if _lib is None:
        _load()
        if _lib is None:
            raise RuntimeError(f"native graph runtime unavailable: {build_error}")
    return _lib


def bfs_reorder(nbr: np.ndarray, mask: np.ndarray) -> np.ndarray:
    n, m = nbr.shape
    out = np.zeros(n, np.int64)
    _runtime().bfs_reorder(np.ascontiguousarray(nbr, np.int32),
                           np.ascontiguousarray(mask, np.float32), n, m, out)
    return out


def label_propagation_order(nbr: np.ndarray, mask: np.ndarray, iters: int = 10) -> np.ndarray:
    n, m = nbr.shape
    out = np.zeros(n, np.int64)
    _runtime().label_propagation_order(np.ascontiguousarray(nbr, np.int32),
                                       np.ascontiguousarray(mask, np.float32), n, m, iters, out)
    return out


def halo_plan(nbr: np.ndarray, mask: np.ndarray, n_shards: int, block: int):
    """Returns (halo, send_idx [S,S,H], send_mask [S,S,H], local_nbr [S,block,M])."""
    lib = _runtime()
    n_pad, m = nbr.shape
    nbr_c = np.ascontiguousarray(nbr, np.int32)
    mask_c = np.ascontiguousarray(mask, np.float32)
    halo = int(lib.halo_plan_size(nbr_c, mask_c, n_pad, m, n_shards, block))
    send_idx = np.zeros((n_shards, n_shards, halo), np.int32)
    send_mask = np.zeros((n_shards, n_shards, halo), np.float32)
    local_nbr = np.zeros((n_shards, block, m), np.int32)
    lib.halo_plan_fill(nbr_c, mask_c, n_pad, m, n_shards, block, halo, send_idx, send_mask,
                       local_nbr)
    return halo, send_idx, send_mask, local_nbr


def sample_fanout(nbr: np.ndarray, mask: np.ndarray, fanout: int, seed: int = 42):
    """Uniform fixed-fanout draws: ([n, fanout] int32 ids, [n, fanout]
    float32 mask); a node of degree <= fanout keeps all its neighbors."""
    n, m = nbr.shape
    out_idx = np.zeros((n, fanout), np.int32)
    out_mask = np.zeros((n, fanout), np.float32)
    _runtime().sample_fanout(np.ascontiguousarray(nbr, np.int32),
                             np.ascontiguousarray(mask, np.float32), n, m, fanout, seed,
                             out_idx, out_mask)
    return out_idx, out_mask


def dinic_mincut_gate(logits: np.ndarray, lam: float, eps: float):
    """Returns (keep_mask [S,S] bool, applied_cut_cost)."""
    seq = logits.shape[0]
    keep = np.zeros(seq * seq, np.uint8)
    cost = _runtime().dinic_mincut_gate(
        np.ascontiguousarray(logits.reshape(-1), np.float32), seq, lam, eps, keep)
    return keep.reshape(seq, seq).astype(bool), float(cost)


def to_csr(nbr: np.ndarray, mask: np.ndarray, weight: np.ndarray):
    """Returns (row_ptr [n+1], col_idx [E], values [E])."""
    lib = _runtime()
    n, m = nbr.shape
    mask_c = np.ascontiguousarray(mask, np.float32)
    e = int(lib.csr_count(mask_c, n, m))
    row_ptr = np.zeros(n + 1, np.int32)
    col_idx = np.zeros(e, np.int32)
    values = np.zeros(e, np.float32)
    lib.csr_fill(np.ascontiguousarray(nbr, np.int32), mask_c,
                 np.ascontiguousarray(weight, np.float32), n, m, row_ptr, col_idx, values)
    return row_ptr, col_idx, values


def _cut_edges(fn, handle) -> list[tuple[int, int]]:
    cap = 1024
    while True:
        us = np.zeros(cap, np.int32)
        vs = np.zeros(cap, np.int32)
        k = int(fn(handle, us, vs, cap))
        if k <= cap:
            return sorted(zip(us[:k].tolist(), vs[:k].tolist()))
        cap = k


class IncrementalMinCut:
    """Persistent-residual incremental s-t min-cut (graph_runtime.cpp
    incmc_*), the large-graph maintainer standing in for the reference's
    subpolynomial structures (ruvector-mincut/src/{linkcut,euler}/).

    Updates are O(1) bookkeeping (value-preserving inserts skip repair
    entirely); queries repair the warm max-flow residual instead of
    recomputing from scratch.
    """

    def __init__(self, n: int, source: int = 0, sink: int | None = None):
        self._lib = _runtime()
        self.n = int(n)
        self.source = int(source)
        self.sink = int(sink if sink is not None else n - 1)
        self._h = self._lib.incmc_create(self.n, self.source, self.sink)

    def close(self):
        if self._h:
            self._lib.incmc_free(self._h)
            self._h = None

    def __del__(self):  # pragma: no cover
        if getattr(self, "_h", None):
            self.close()

    def insert_edge(self, u: int, v: int, w: float):
        self._lib.incmc_update(self._h, u, v, float(w), 0)

    def reweight_edge(self, u: int, v: int, w: float):
        self._lib.incmc_update(self._h, u, v, float(w), 1)

    def delete_edge(self, u: int, v: int):
        self._lib.incmc_update(self._h, u, v, 0.0, 1)

    def cut_value(self) -> float:
        return float(self._lib.incmc_value(self._h))

    def partition(self) -> np.ndarray:
        out = np.zeros(self.n, np.uint8)
        self._lib.incmc_partition(self._h, out)
        return out.astype(bool)

    def cut_edges(self) -> list[tuple[int, int]]:
        return _cut_edges(self._lib.incmc_cut_edges, self._h)

    def stats(self) -> dict:
        out = np.zeros(5, np.int64)
        self._lib.incmc_stats(self._h, out)
        return {"updates": int(out[0]), "o1_skips": int(out[1]),
                "augment_phases": int(out[2]), "cancels": int(out[3]),
                "rebuilds": int(out[4])}


class GlobalIncrementalMinCut:
    """Native GLOBAL (no source/sink) dynamic min-cut (graph_runtime.cpp
    gmc_*), with the same exact incremental invariants as the Python
    mincut/global_dynamic.GlobalDynamicMinCut: O(pool) non-crossing
    updates, one-Dinic decrease repairs, candidate-pool certificates,
    Stoer-Wagner recompute backstop."""

    def __init__(self, n: int):
        self._lib = _runtime()
        self.n = int(n)
        self._h = self._lib.gmc_create(self.n)
        self._updates = 0

    def close(self):
        if self._h:
            self._lib.gmc_free(self._h)
            self._h = None

    def __del__(self):  # pragma: no cover
        if getattr(self, "_h", None):
            self.close()

    @property
    def update_count(self) -> int:
        return self._updates

    def insert_edge(self, u: int, v: int, w: float):
        self._updates += 1
        self._lib.gmc_insert(self._h, u, v, float(w))

    def delete_edge(self, u: int, v: int):
        self._updates += 1
        self._lib.gmc_delete(self._h, u, v)

    def reweight_edge(self, u: int, v: int, w: float):
        self._updates += 1
        self._lib.gmc_reweight(self._h, u, v, float(w))

    def cut_value(self) -> float:
        return float(self._lib.gmc_value(self._h))

    def partition(self) -> np.ndarray:
        out = np.zeros(self.n, np.uint8)
        self._lib.gmc_partition(self._h, out)
        return out.astype(bool)

    def cut_edges(self) -> list[tuple[int, int]]:
        return _cut_edges(self._lib.gmc_cut_edges, self._h)

    def stats(self) -> dict:
        out = np.zeros(5, np.int64)
        self._lib.gmc_stats(self._h, out)
        return {"updates": int(out[0]), "o1_updates": int(out[1]),
                "flow_repairs": int(out[2]), "full_recomputes": int(out[3]),
                "ball_certified": int(out[4])}


def _table_width(lib, nbr_c, mask_c, block: int, table_pad: int, threads: int) -> int:
    n, m = nbr_c.shape
    halo = int(lib.bdense_halo_max(nbr_c, mask_c, n, m, block, threads))
    return -(-(block + halo) // table_pad) * table_pad


def bdense_build(nbr: np.ndarray, mask: np.ndarray, ew: np.ndarray, block: int,
                 table_pad: int = 128, eps_edge: float = 1e-8, bf16: bool = False,
                 threads: int = 0):
    """Threaded block-dense table build (graph/block_dense.py semantics,
    uniform blocks). Returns (local_ids, wdense, degrees, node_pad,
    node_pos, dup). wdense is float32 numpy, or with bf16=True a CPU
    torch.bfloat16 tensor viewing the library's bf16 words (numpy has no
    bf16)."""
    lib = _runtime()
    threads = threads or (os.cpu_count() or 4)
    n, m = nbr.shape
    nbr_c = np.ascontiguousarray(nbr, np.int32)
    mask_c = np.ascontiguousarray(mask, np.float32)
    ew_c = np.ascontiguousarray(ew, np.float32)
    nb = -(-n // block)
    table = _table_width(lib, nbr_c, mask_c, block, table_pad, threads)
    local_ids = np.zeros((nb, table), np.int32)
    wdense = np.zeros((nb, block, table), np.uint16 if bf16 else np.float32)
    degrees = np.zeros((nb, block), np.float32)
    node_pad = np.zeros((nb, block), np.float32)
    node_pos = np.zeros(n, np.int64)
    dup = int(lib.bdense_fill(nbr_c, mask_c, ew_c, n, m, block, table, np.float32(eps_edge),
                              1 if bf16 else 0, threads, local_ids,
                              wdense.ctypes.data_as(ctypes.c_void_p), degrees, node_pad,
                              node_pos))
    if bf16:
        import torch

        wdense = torch.from_numpy(wdense).view(torch.bfloat16)
    return local_ids, wdense, degrees, node_pad, node_pos, dup


def bdense_plan(nbr: np.ndarray, mask: np.ndarray, block: int, table_pad: int = 128,
                threads: int = 0):
    """Compact block-dense plan for device-side densification: returns
    (local_ids [nb, T], slot [n, m], dup). slot[g, j] is edge (g, j)'s
    column in its block's local table (== T for masked edges, the
    scatter-drop sentinel). The [nb, B, T] weight table itself is built on
    the device from (slot, normalized weights) by graph/block_dense.py's
    device-fill route, so only ~n*m values cross to the device instead of
    nb*B*T."""
    lib = _runtime()
    threads = threads or (os.cpu_count() or 4)
    n, m = nbr.shape
    nbr_c = np.ascontiguousarray(nbr, np.int32)
    mask_c = np.ascontiguousarray(mask, np.float32)
    nb = -(-n // block)
    table = _table_width(lib, nbr_c, mask_c, block, table_pad, threads)
    local_ids = np.zeros((nb, table), np.int32)
    slot = np.zeros((n, m), np.int32)
    dup = int(lib.bdense_slots(nbr_c, mask_c, n, m, block, table, threads, local_ids, slot))
    return local_ids, slot, dup


def gen_cluster_knn(n: int, d: int, k: int, cluster: int, seed: int = 0, threads: int = 0):
    """Threaded clustered corpus + exact within-cluster kNN. Returns
    (feats [n,d], idx [n,k], ew [n,k]); ids cluster-contiguous."""
    threads = threads or (os.cpu_count() or 4)
    if n % cluster:
        raise ValueError("n must be a multiple of cluster")
    if not 0 < k < cluster:
        raise ValueError("k must be < cluster (self excluded)")
    feats = np.empty((n, d), np.float32)
    idx = np.empty((n, k), np.int32)
    ew = np.empty((n, k), np.float32)
    _runtime().gen_cluster_knn(n, d, k, cluster, np.uint64(seed), threads, feats, idx, ew)
    return feats, idx, ew
