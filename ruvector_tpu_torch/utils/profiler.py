"""Profiler: latency/memory accounting + trace hooks (port of
ruvector_tpu/utils/profiler.py).

Reference: ruvector-profiler (latency/memory/power profilers + CSV emitter +
config hashing, crates/ruvector-profiler/src/). Card mapping: wall-clock
regions that wait for the card (`block_until_ready` on the region's
result: CUDA launches return before the work has run), device memory
stats from `torch.cuda.memory_stats`, and trace capture through
`torch.profiler` in the Chrome trace format (TensorBoard, Perfetto).
"""

from __future__ import annotations

import contextlib
import csv
import hashlib
import io
import json
import time
from collections import defaultdict
from pathlib import Path

import numpy as np
import torch

from ruvector_tpu_torch.device import block_until_ready, resolve_device


class Profiler:
    def __init__(self):
        self.records: dict[str, list[float]] = defaultdict(list)

    @contextlib.contextmanager
    def region(self, name: str, sync: bool = True):
        """Time a region; with `sync=True` the time covers the device work
        that produces the last result appended to the yielded list, not
        only its launch."""
        t0 = time.perf_counter()
        result_holder = []
        try:
            yield result_holder
        finally:
            if sync and result_holder:
                block_until_ready(result_holder[-1])
            self.records[name].append(time.perf_counter() - t0)

    def summary(self) -> dict[str, dict]:
        out = {}
        for name, times in self.records.items():
            arr = np.asarray(times)
            out[name] = {
                "count": len(arr),
                "mean_ms": float(arr.mean() * 1e3),
                "p50_ms": float(np.percentile(arr, 50) * 1e3),
                "p99_ms": float(np.percentile(arr, 99) * 1e3),
                "total_s": float(arr.sum()),
            }
        return out

    def to_csv(self) -> str:
        """CSV emission (ruvector-profiler csv_emitter parity)."""
        buf = io.StringIO()
        w = csv.writer(buf)
        w.writerow(["region", "count", "mean_ms", "p50_ms", "p99_ms", "total_s"])
        for name, s in self.summary().items():
            w.writerow([name, s["count"], f"{s['mean_ms']:.4f}",
                        f"{s['p50_ms']:.4f}", f"{s['p99_ms']:.4f}",
                        f"{s['total_s']:.4f}"])
        return buf.getvalue()

    @staticmethod
    def device_memory_stats(device=None) -> dict:
        """The caching allocator's counters of the CUDA device (default: the
        card) as ints, e.g. "allocated_bytes.all.peak"; {} for the CPU,
        which keeps none (as JAX's CPU client)."""
        dev = resolve_device(device)
        if dev.type == "cpu":
            return {}
        return {k: int(v) for k, v in torch.cuda.memory_stats(dev).items()}

    @staticmethod
    def config_hash(config) -> str:
        """Stable hash of a config object for run identification
        (ruvector-profiler config_hash parity; equal to the JAX package's
        for the same config)."""
        try:
            payload = json.dumps(dataclass_to_dict(config), sort_keys=True)
        except TypeError:
            payload = repr(config)
        return hashlib.sha256(payload.encode()).hexdigest()[:16]

    @contextlib.contextmanager
    def xla_trace(self, logdir: str):
        """Capture a `torch.profiler` trace of the region (host, and the
        CUDA devices where torch sees one) into `logdir` as a Chrome trace
        (`*.pt.trace.json`), viewable in TensorBoard or Perfetto. Keeps the
        JAX package's name."""
        Path(logdir).mkdir(parents=True, exist_ok=True)
        activities = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        with torch.profiler.profile(
                activities=activities,
                on_trace_ready=torch.profiler.tensorboard_trace_handler(str(logdir))):
            yield


def dataclass_to_dict(obj):
    import dataclasses

    if dataclasses.is_dataclass(obj):
        return {f.name: dataclass_to_dict(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    if isinstance(obj, (list, tuple)):
        return [dataclass_to_dict(o) for o in obj]
    if isinstance(obj, dict):
        return {k: dataclass_to_dict(v) for k, v in obj.items()}
    return obj


@contextlib.contextmanager
def profile_region(name: str, profiler: Profiler | None = None):
    prof = profiler or _global_profiler
    with prof.region(name) as holder:
        yield holder


_global_profiler = Profiler()
