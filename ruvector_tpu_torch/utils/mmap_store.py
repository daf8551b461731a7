"""Mmap-backed embedding store with dirty-page tracking + prefetch, and an
mmap gradient accumulator (the port's own copy of
ruvector_tpu/utils/mmap_store.py; pure numpy, the same file layout).

Reference: ruvector-gnn/src/mmap.rs — AtomicBitmap (:26) tracking dirty
pages, MmapManager (:118) with get/set_embedding (:221,264), flush_dirty
(:304) syncing only dirty pages, prefetch via madvise (:327); and
MmapGradientAccumulator (:382) with accumulate (:481) and apply(lr)
(:518).

Role: this is the host-side feeder for out-of-core training — batches
are gathered here and shipped to the card as one contiguous array
(cold_tier.py streams from the same layout). Single-process host store, so
the reference's atomics become plain numpy bit ops; durability semantics
(flush only dirty pages) are preserved.
"""

from __future__ import annotations

import mmap as _mmap
from pathlib import Path

import numpy as np


class DirtyBitmap:
    """One bit per page (mmap.rs:26 AtomicBitmap)."""

    def __init__(self, num_pages: int):
        self.bits = np.zeros((num_pages + 63) // 64, np.uint64)
        self.num_pages = num_pages

    def set(self, page: int):
        self.bits[page >> 6] |= np.uint64(1) << np.uint64(page & 63)

    def test(self, page: int) -> bool:
        return bool((self.bits[page >> 6] >> np.uint64(page & 63))
                    & np.uint64(1))

    def clear(self):
        self.bits[:] = 0

    def dirty_pages(self) -> np.ndarray:
        out = []
        for w in range(len(self.bits)):
            word = int(self.bits[w])
            while word:
                b = word & -word
                out.append((w << 6) + b.bit_length() - 1)
                word ^= b
        return np.asarray(out, np.int64)


class MmapEmbeddingStore:
    """File-backed [num_nodes, dim] f32 embedding table (mmap.rs:118)."""

    PAGE_ROWS = 64         # rows per dirty-tracking page

    def __init__(self, path, num_nodes: int, dim: int, create: bool = False):
        self.path = Path(path)
        self.num_nodes = num_nodes
        self.dim = dim
        mode = "w+" if create or not self.path.exists() else "r+"
        self.data = np.memmap(self.path, np.float32, mode=mode,
                              shape=(num_nodes, dim))
        self.dirty = DirtyBitmap((num_nodes + self.PAGE_ROWS - 1)
                                 // self.PAGE_ROWS)

    def get_embedding(self, node: int) -> np.ndarray:
        return np.array(self.data[node])

    def get_batch(self, ids: np.ndarray) -> np.ndarray:
        """Gather a batch — the device-upload path."""
        return np.array(self.data[np.asarray(ids)])

    def set_embedding(self, node: int, value: np.ndarray):
        self.data[node] = value
        self.dirty.set(node // self.PAGE_ROWS)

    def set_batch(self, ids: np.ndarray, values: np.ndarray):
        ids = np.asarray(ids)
        self.data[ids] = values
        for p in np.unique(ids // self.PAGE_ROWS):
            self.dirty.set(int(p))

    def flush_dirty(self) -> int:
        """Sync only dirty pages to disk (mmap.rs:304); returns page count."""
        pages = self.dirty.dirty_pages()
        if len(pages):
            # np.memmap.flush syncs the whole map; for page-granular sync use
            # the underlying mmap's flush(offset, size) where available.
            mm = getattr(self.data, "_mmap", None)
            itemsize = 4 * self.dim * self.PAGE_ROWS
            if mm is not None:
                gran = _mmap.ALLOCATIONGRANULARITY
                for p in pages:
                    off = (int(p) * itemsize) // gran * gran
                    size = min(itemsize + (int(p) * itemsize - off),
                               len(mm) - off)
                    mm.flush(off, size)
            else:  # pragma: no cover
                self.data.flush()
        self.dirty.clear()
        return len(pages)

    def prefetch(self, ids: np.ndarray):
        """madvise(WILLNEED) the pages for an upcoming batch (mmap.rs:327)."""
        mm = getattr(self.data, "_mmap", None)
        if mm is None or not hasattr(mm, "madvise"):  # pragma: no cover
            return
        row_bytes = 4 * self.dim
        gran = _mmap.ALLOCATIONGRANULARITY
        for node in np.unique(np.asarray(ids) // self.PAGE_ROWS):
            off = (int(node) * self.PAGE_ROWS * row_bytes) // gran * gran
            length = min(self.PAGE_ROWS * row_bytes + gran, len(mm) - off)
            mm.madvise(_mmap.MADV_WILLNEED, off, length)

    def close(self):
        self.flush_dirty()
        del self.data


class MmapGradientAccumulator:
    """File-backed gradient accumulation with deferred apply
    (mmap.rs:382-518): accumulate adds per-node gradients; apply(lr) does
    one fused `emb -= lr * grad` sweep and zeroes the accumulator."""

    def __init__(self, path, num_nodes: int, dim: int):
        self.path = Path(path)
        self.grads = np.memmap(self.path, np.float32, mode="w+",
                               shape=(num_nodes, dim))
        self.counts = np.zeros(num_nodes, np.int32)

    def accumulate(self, ids: np.ndarray, grads: np.ndarray):
        ids = np.asarray(ids)
        np.add.at(self.grads, ids, np.asarray(grads, np.float32))
        np.add.at(self.counts, ids, 1)

    def apply(self, store: MmapEmbeddingStore, lr: float,
              average: bool = True) -> int:
        """Apply accumulated gradients to the store; returns nodes updated."""
        touched = np.nonzero(self.counts)[0]
        if len(touched) == 0:
            return 0
        g = self.grads[touched]
        if average:
            g = g / self.counts[touched, None]
        store.set_batch(touched, store.get_batch(touched) - lr * g)
        self.grads[touched] = 0
        self.counts[touched] = 0
        return len(touched)
