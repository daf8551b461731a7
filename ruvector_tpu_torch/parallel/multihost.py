"""Multi-host bring-up and elastic checkpoint/restart (port of
ruvector_tpu/parallel/multihost.py).

- process bring-up: torch.distributed.init_process_group, the coordinator
  rendezvous in place of gossip membership;
- elasticity: checkpoint and restart (a failed worker is restarted by the
  scheduler and resumes from the last checkpoint);
- liveness: a heartbeat file the job scheduler can watch.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import time
from pathlib import Path

import torch.distributed as dist

from ruvector_tpu_torch.device import resolve_device
from ruvector_tpu_torch.parallel.mesh import RANK_TIMEOUT_S
from ruvector_tpu_torch.utils.checkpoint import (
    _process_index,
    restore_checkpoint,
    save_checkpoint,
)


def initialize_multihost(coordinator_address: str | None = None,
                         num_processes: int | None = None,
                         process_id: int | None = None, device=None) -> bool:
    """Bring up the default process group; a no-op (False) for one
    process. The arguments default to the usual WORLD_SIZE, RANK and
    MASTER_ADDR:MASTER_PORT environment. The backend is NCCL on cards
    (one card a process) and gloo on the CPU."""
    if num_processes is None and "WORLD_SIZE" in os.environ:
        num_processes = int(os.environ["WORLD_SIZE"])
    if num_processes is None or num_processes <= 1:
        return False
    if process_id is None:
        process_id = int(os.environ["RANK"])
    backend = "nccl" if resolve_device(device).type == "cuda" else "gloo"
    init = f"tcp://{coordinator_address}" if coordinator_address else "env://"
    dist.init_process_group(backend, init_method=init, world_size=num_processes,
                            rank=process_id, timeout=datetime.timedelta(seconds=RANK_TIMEOUT_S))
    return True


@dataclasses.dataclass
class TrainStateCheckpointer:
    """Periodic checkpoint and resume for the training loop."""

    directory: str | Path
    every_steps: int = 100
    keep: int = 2
    _saved_steps: list = dataclasses.field(default_factory=list)

    def maybe_save(self, step: int, state) -> bool:
        if step % self.every_steps != 0:
            return False
        # only process 0 writes (single-writer discipline)
        if _process_index() != 0:
            return False
        save_checkpoint(self.directory, state, step=step)
        self._saved_steps.append(step)
        while len(self._saved_steps) > self.keep:
            old = self._saved_steps.pop(0)
            for suffix in (".npz", ".json"):
                p = Path(self.directory) / f"ckpt_{old}{suffix}"
                if p.exists():
                    p.unlink()
        return True

    def latest_step(self) -> int | None:
        d = Path(self.directory)
        if not d.exists():
            return None
        steps = []
        for p in d.glob("ckpt_*.npz"):
            try:
                steps.append(int(p.stem.split("_")[1]))
            except (IndexError, ValueError):
                continue
        return max(steps) if steps else None

    def restore_latest(self, target):
        """Returns (state, step), or (target, 0) when no checkpoint exists."""
        step = self.latest_step()
        if step is None:
            return target, 0
        return restore_checkpoint(self.directory, target, step=step), step


class Heartbeat:
    """Liveness file for external failure detection."""

    def __init__(self, path: str | Path, interval_s: float = 30.0):
        self.path = Path(path)
        self.interval_s = interval_s
        self._last = 0.0

    def beat(self, step: int | None = None):
        now = time.time()
        if now - self._last < self.interval_s:
            return
        self.path.write_text(f"{now} {step if step is not None else ''}\n")
        self._last = now

    @staticmethod
    def is_alive(path: str | Path, timeout_s: float = 120.0) -> bool:
        p = Path(path)
        if not p.exists():
            return False
        try:
            ts = float(p.read_text().split()[0])
        except (ValueError, IndexError):
            return False
        return (time.time() - ts) < timeout_s
