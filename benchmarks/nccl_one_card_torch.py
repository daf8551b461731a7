#!/usr/bin/env python3
"""Why ranks that share one card run on gloo: two NCCL ranks on one GPU.

Spawns two processes, both on `cuda:0`, that join one NCCL process group
(a `file://` rendezvous in a fresh temporary directory) and sum a tensor
with each other. NCCL refuses two ranks on one device, so a rank must
fail; the script prints the error text each rank reported and the card's
name and power limit, and exits 0 only when a rank raised. A rank waits
at most 60 s in a collective before it fails.

    python3 benchmarks/nccl_one_card_torch.py

Needs one CUDA card.
"""

from __future__ import annotations

import datetime
import multiprocessing
import os
import shutil
import subprocess
import sys
import tempfile
import traceback

import torch
import torch.distributed as dist

WORLD = 2


def rank_main(rank: int, tmp: str) -> None:
    try:
        torch.cuda.set_device(0)
        dist.init_process_group("nccl", init_method=f"file://{tmp}/rendezvous",
                                world_size=WORLD, rank=rank,
                                timeout=datetime.timedelta(seconds=60))
        x = torch.ones(1, device="cuda:0")
        dist.all_reduce(x)
        torch.cuda.synchronize()
        dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(tmp, f"error_{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("nccl_one_card_torch: no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    tmp = tempfile.mkdtemp(prefix="nccl_one_card_")
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=rank_main, args=(r, tmp)) for r in range(WORLD)]
    try:
        for p in procs:
            p.start()
        for p in procs:
            p.join(180)
        codes = [p.exitcode for p in procs]
        errors = [os.path.join(tmp, f"error_{r}.txt") for r in range(WORLD)]
        reported = [r for r in range(WORLD) if os.path.exists(errors[r])]
        for r in reported:
            print(f"--- rank {r}:\n{open(errors[r]).read()[-3000:]}")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join()
        shutil.rmtree(tmp, ignore_errors=True)
    if reported:
        print(f"[nccl_one_card] refused: rank exit codes {codes}")
        return 0
    if any(c != 0 for c in codes):
        print(f"[nccl_one_card] no rank reported an error; exit codes {codes}")
        return 1
    print("[nccl_one_card] not refused: both ranks summed")
    return 1


if __name__ == "__main__":
    sys.exit(main())
