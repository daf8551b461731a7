"""Out-of-core training: disk feature storage + hyperbatch streaming (port
of ruvector_tpu/utils/cold_tier.py).

Reference: ruvector-gnn/src/cold_tier.rs — block-aligned FeatureStorage
(:35-240), BFS-reordered HyperbatchIterator with double buffers (:242-349),
LFU-decay AdaptiveHotset (:350-500), ColdTierTrainer epoch loop with
io/compute timing (:503+).

Card mapping: features live in a numpy memmap (the host tier, the same
`.npy` file as the JAX package's); hyperbatches stream to the card with
the next batch's copy in flight while the current one computes. A copy
from pageable memory is synchronous, so each batch is staged in one of
`num_buffers` pinned host buffers and copied on a side stream; the
compute stream waits on the copy's event before it uses the batch, and a
buffer is refilled only after its previous copy has completed. The
AdaptiveHotset caches hot rows as device tensors.
"""

from __future__ import annotations

import dataclasses
import time
from pathlib import Path

import numpy as np
import torch

from ruvector_tpu_torch.device import block_until_ready, resolve_device


class FeatureStorage:
    """Disk-backed [num_nodes, dim] f32 feature store via numpy memmap.

    The memmap replaces the reference's hand-rolled block-aligned file +
    page-size logic (cold_tier.rs:35-240) — the OS page cache provides the
    same block alignment and madvise-style readahead.
    """

    def __init__(self, path: str | Path, dim: int, num_nodes: int,
                 mode: str = "r+", create: bool = False):
        if dim <= 0:
            raise ValueError("dim must be > 0")
        self.path = Path(path)
        self.dim = dim
        self.num_nodes = num_nodes
        if create:
            mm = np.lib.format.open_memmap(
                self.path, mode="w+", dtype=np.float32, shape=(num_nodes, dim)
            )
            mm.flush()
            self._mm = mm
        else:
            self._mm = np.lib.format.open_memmap(self.path, mode=mode)
            if self._mm.shape != (num_nodes, dim):
                raise ValueError(f"{self.path}: shape {self._mm.shape}, expected "
                                 f"{(num_nodes, dim)}")

    @staticmethod
    def create(path, dim: int, num_nodes: int) -> "FeatureStorage":
        return FeatureStorage(path, dim, num_nodes, create=True)

    @staticmethod
    def open(path) -> "FeatureStorage":
        mm = np.lib.format.open_memmap(path, mode="r+")
        fs = FeatureStorage.__new__(FeatureStorage)
        fs.path = Path(path)
        fs._mm = mm
        fs.num_nodes, fs.dim = mm.shape
        return fs

    def write_batch(self, node_ids: np.ndarray, features: np.ndarray):
        self._mm[node_ids] = features

    def read_batch(self, node_ids: np.ndarray) -> np.ndarray:
        return np.asarray(self._mm[node_ids])

    def flush(self):
        self._mm.flush()


@dataclasses.dataclass(frozen=True)
class HyperbatchConfig:
    batch_size: int = 1024
    num_buffers: int = 2


class HyperbatchIterator:
    """Batches in `node_order` (e.g. BFS order) streamed to the device with
    prefetch overlap.

    next_batch() returns (node_ids, features_on_device); the following
    batch's host->device copy is already in flight (double buffering,
    cold_tier.rs:242-330). On a CUDA device `copy_seconds()` reads, after
    the epoch, the copies' device time and the part of it the compute
    stream waited for.
    """

    def __init__(self, storage: FeatureStorage, config: HyperbatchConfig,
                 node_order: np.ndarray | None = None, device=None):
        self.storage = storage
        self.config = config
        self.device = resolve_device(device)
        self.node_order = (
            np.asarray(node_order) if node_order is not None
            else np.arange(storage.num_nodes)
        )
        self._cuda = self.device.type == "cuda"
        if self._cuda:
            shape = (config.batch_size, storage.dim)
            self._pinned = [torch.empty(shape, dtype=torch.float32, pin_memory=True)
                            for _ in range(config.num_buffers)]
            # each buffer's last copy, kept across reset(): a batch handed
            # out may still be in flight from its buffer
            self._done = [None] * config.num_buffers
            self._stream = torch.cuda.Stream(self.device)
        self.reset()

    def reset(self):
        self._offset = 0
        self.batch_counter = 0
        self._inflight = None
        self._slot = 0
        self._copies = []             # (start, end, needed) events of each copy
        self._prefetch()

    def _prefetch(self):
        if self._offset >= len(self.node_order):
            self._inflight = None
            return
        end = min(self._offset + self.config.batch_size, len(self.node_order))
        ids = self.node_order[self._offset: end]
        host = self.storage.read_batch(ids)
        self._offset = end
        if not self._cuda:
            self._inflight = (ids, torch.from_numpy(host).to(self.device), None)
            return
        slot, self._slot = self._slot, (self._slot + 1) % self.config.num_buffers
        if self._done[slot] is not None:
            self._done[slot].synchronize()       # the buffer's last copy has been read
        buf = self._pinned[slot][: len(ids)]
        buf.copy_(torch.from_numpy(host))
        start = torch.cuda.Event(enable_timing=True)
        done = torch.cuda.Event(enable_timing=True)
        with torch.cuda.stream(self._stream):
            start.record()
            dev = buf.to(self.device, non_blocking=True)
            done.record()
        self._done[slot] = done
        self._inflight = (ids, dev, (start, done))

    def next_batch(self):
        if self._inflight is None:
            return None
        ids, dev, events = self._inflight
        if events is not None:
            stream = torch.cuda.current_stream(self.device)
            needed = torch.cuda.Event(enable_timing=True)
            needed.record(stream)
            stream.wait_event(events[1])
            dev.record_stream(stream)            # allocated on the side stream
            self._copies.append((*events, needed))
        self._prefetch()              # start the next copy before returning
        self.batch_counter += 1
        return ids, dev

    def copy_seconds(self) -> tuple[float, float]:
        """(device seconds of the copies handed out so far, seconds of
        them the compute stream waited for). Waits for the copies."""
        copy_s = stall_s = 0.0
        for start, done, needed in self._copies:
            done.synchronize()
            needed.synchronize()
            copy_s += start.elapsed_time(done) / 1e3
            stall_s += max(needed.elapsed_time(done), 0.0) / 1e3
        return copy_s, stall_s


class AdaptiveHotset:
    """LFU-with-decay cache of hot rows (cold_tier.rs:350-500); the loader's
    values, device tensors on the card, are what it keeps."""

    def __init__(self, capacity: int, decay: float = 0.9):
        self.capacity = capacity
        self.decay = decay
        self.scores: dict[int, float] = {}
        self.cache: dict[int, torch.Tensor] = {}

    def access(self, node_id: int, loader=None):
        self.scores[node_id] = self.scores.get(node_id, 0.0) + 1.0
        if node_id in self.cache:
            return self.cache[node_id]
        if loader is None:
            return None
        value = loader(node_id)
        self._insert(node_id, value)
        return value

    def _insert(self, node_id: int, value):
        if len(self.cache) >= self.capacity:
            # evict min-score cached entry
            victim = min(self.cache, key=lambda k: self.scores.get(k, 0.0))
            if self.scores.get(victim, 0.0) >= self.scores.get(node_id, 0.0):
                return  # new entry not hot enough
            del self.cache[victim]
        self.cache[node_id] = value

    def decay_scores(self):
        for k in list(self.scores):
            self.scores[k] *= self.decay
            if self.scores[k] < 1e-3:
                del self.scores[k]

    def hit_rate_nodes(self) -> set[int]:
        return set(self.cache)


@dataclasses.dataclass
class EpochStats:
    batches: int
    io_time_s: float
    compute_time_s: float
    loss: float
    copy_time_s: float = 0.0      # device time of the host->card copies
    copy_wait_s: float = 0.0      # the part of it the compute stream waited for


class ColdTierTrainer:
    """Epoch loop over hyperbatches with io/compute timing
    (cold_tier.rs:503+). `step_fn(node_ids, features) -> loss` is the
    user's compute; its time covers the device work (the loss is waited
    for before the clock is read)."""

    def __init__(self, storage: FeatureStorage, config: HyperbatchConfig,
                 node_order: np.ndarray | None = None, device=None):
        self.storage = storage
        self.config = config
        self.node_order = node_order
        self.device = resolve_device(device)

    def train_epoch(self, step_fn) -> EpochStats:
        it = HyperbatchIterator(self.storage, self.config, self.node_order, self.device)
        io_t = 0.0
        compute_t = 0.0
        losses = []
        while True:
            t0 = time.perf_counter()
            batch = it.next_batch()
            io_t += time.perf_counter() - t0
            if batch is None:
                break
            ids, feats = batch
            t0 = time.perf_counter()
            loss = block_until_ready(step_fn(ids, feats))
            compute_t += time.perf_counter() - t0
            losses.append(float(loss))
        copy_s, wait_s = it.copy_seconds()
        return EpochStats(
            batches=it.batch_counter, io_time_s=io_t,
            compute_time_s=compute_t,
            loss=float(np.mean(losses)) if losses else 0.0,
            copy_time_s=copy_s, copy_wait_s=wait_s,
        )
