"""The readings that a cell's limits are set from, on the card:

    python3 -m portbench.controls --workload <cell> --seeds 1 2 3 ... [--seconds 2]
        [--control-seeds 1 2 3] [--faults half_batch altered]

For each seed, in one process: the cell's set-up, a short window at the
cell's own load, then its numbers: the program against the plain
reference (the lower readings), and on the control seeds the control, the
reference computed one precision below the configuration's put in the
program's place (the upper readings, which must fail). With --faults,
each fault of portbench.faults is planted in turn under the timed path
and the whole seed run again with it, on the control seeds. One JSON line
a seed. The benchmark's own runs do not run the control.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from portbench import faults, harness


def _cell(workload: str, seed: int, seconds: float, device: torch.device,
          spec: harness.Spec, config_changes: dict | None):
    wl = spec.workload(workload)
    config = dict(spec.config(wl["config"]), **(config_changes or {}))
    traffic = spec.traffic(wl["traffic"])
    cell = spec.driver(traffic).Cell(config, traffic, seed, device)
    cell.setup()
    window = harness.run_window(cell, seconds)
    cell.release()
    return cell, window, traffic["driver"]


def readings(workload: str, seed: int, seconds: float, device: torch.device,
             spec: harness.Spec | None = None, config_changes: dict | None = None,
             control: bool = True, plant: tuple = ()) -> dict:
    """{"program": numbers, "control": numbers, "steps": n, and a fault's
    numbers under its name} of one seed."""
    spec = spec or harness.Spec()
    cell, window, driver = _cell(workload, seed, seconds, device, spec, config_changes)
    out = {"seed": seed, "steps": window["steps"], "program": cell.check()}
    if control:
        out["control"] = cell.check(control=True)
    del cell
    for fault in plant:
        if device.type == "cuda":
            torch.cuda.empty_cache()
        with faults.planted(driver, fault):
            cell = _cell(workload, seed, seconds, device, spec, config_changes)[0]
        out[fault] = cell.check()
        del cell
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=None)
    ap.add_argument("--faults", nargs="*", default=())
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("portbench.controls: no CUDA card", file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for seed in args.seeds:
        t0 = time.perf_counter()
        on = args.control_seeds is None or seed in args.control_seeds
        r = readings(args.workload, seed, args.seconds, torch.device("cuda", 0), control=on,
                     plant=tuple(args.faults) if on else ())
        r["seconds"] = time.perf_counter() - t0
        print(json.dumps(r), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
