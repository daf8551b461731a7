#!/usr/bin/env python3
"""Where K7's time goes: the min-cut gate kernel's phase split on the card.

Runs the probe instance of `mincut_gate_block_from_x` (variant="probe",
csrc/mincut_gate_block.cu) at config 5's two shapes of chip_smoke.py's
`config5_report`: the drift step's K=244 partitions (the features after
five drift steps of 0.1 N(0, 1), the partitions drawn as chip_smoke.py
draws them) and gate initialisation's K=3906 (every partition of the
999,936-node layout), B=256, D=128, bf16 compute, LN1 folded in, random
weights from seed 0. For each shape it prints the launch's time (CUDA
events, median of 5), the per-partition cycles of each phase (sum over
partitions, share, median and max), the per-partition push-relabel
rounds (stats row 3: sum, median, p90, max), the split of the rounds'
cycles between their push pass, apply pass (with the column sums) and
relabel phase, and the BFS sweeps of the global relabels and of the
cut. The probe's masks and stats are held equal to the exact
instance's.

    python3 benchmarks/k7_phases_torch.py

Needs one CUDA card; the kernels build at first use.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from ruvector_tpu_torch.graph import build_block_dense  # noqa: E402
from ruvector_tpu_torch.graph_transformer import gated  # noqa: E402
from ruvector_tpu_torch.ops.kernels import _lib  # noqa: E402
from ruvector_tpu_torch.ops.kernels.mincut_gate_block import (  # noqa: E402
    PROBE_PHASES,
    mincut_gate_block_from_x,
)


def config5_inputs():
    """Config 5's layer-0 input and the drift step's K7 input, as
    chip_smoke.phase_config5 makes them (the drift only adds noise to the
    features, so the steps themselves need not run)."""
    dev = cs.DEV
    feats, idx, ew = cs.cluster_graph(cs.C5_NODES, 128, cs.C5_K)
    bdg = build_block_dense(idx.cpu().numpy(), np.ones((cs.C5_NODES, cs.C5_K), np.float32),
                            ew.cpu().numpy(), block=cs.C5_BLOCK, device=dev)
    nb, b = bdg.n_blocks, bdg.block
    fpad = bdg.pad_features(feats)
    gcfg = gated.GatedGraphTransformerConfig(
        dim=128, num_heads=4, ffn_mult=4, num_layers=2, lam=0.5, eps=0.01,
        hysteresis_band=0.05, max_resolve_frac=1 / 16, compute_dtype="bfloat16")
    gparams = gated.gated_graph_transformer_init(0, gcfg, device=dev)
    budget = max(1, int(nb * gcfg.max_resolve_frac))
    noise = torch.Generator(device=dev).manual_seed(7)
    padcol = bdg.node_pad.reshape(-1, 1)
    f = fpad
    for _ in range(cs.C5_STEPS):
        f = f + cs.C5_DRIFT * torch.randn(f.shape, generator=noise, device=dev) * padcol
    sel = torch.randperm(nb, generator=noise, device=dev)[:budget]
    x0 = fpad.reshape(nb, b, -1)
    x_sel = f.reshape(nb, b, -1)[sel].contiguous()
    A0, ln0 = gated._fold_sig_params(gparams[0], gcfg), gated._ln_vectors(gparams[0]["ln1"])
    gate = dict(lam=gcfg.lam, eps=gcfg.eps, ln=ln0, compute_bf16=True)
    return {"step": (x_sel, bdg.node_pad[sel].contiguous()), "init": (x0, bdg.node_pad)}, \
        A0, gate


def pct(v: torch.Tensor, q: float) -> float:
    return float(torch.quantile(v.double(), q))


def report(shape: str, x, pad, A0, gate) -> dict:
    keep, stats = mincut_gate_block_from_x(x, pad, A0, **gate)
    pkeep, pstats, cycles = mincut_gate_block_from_x(x, pad, A0, variant="probe", **gate)
    torch.cuda.synchronize()
    if not (torch.equal(keep, pkeep) and torch.equal(stats, pstats)):
        raise AssertionError(f"{shape}: the probe instance disagrees with the exact one")
    ms = cs.time_ms(lambda: mincut_gate_block_from_x(x, pad, A0, **gate), iters=5, warmup=1)
    cyc = cycles.cpu()
    rounds = stats[:, 3, 0].cpu()
    timed = cyc[:, :6].double()
    total = float(timed.sum())
    phases = {}
    for i, name in enumerate(PROBE_PHASES[:6]):
        col = timed[:, i]
        phases[name] = {"cycles_sum": int(col.sum()), "share": float(col.sum()) / total,
                        "median": float(col.median()), "max": int(col.max())}
    per_part = timed.sum(1)
    worst = int(per_part.argmax())
    out = {"shape": shape, "K": x.shape[0], "B": x.shape[1], "D": x.shape[2], "ms": ms,
           "phases": phases,
           "partition_cycles": {"median": float(per_part.median()), "p90": pct(per_part, 0.9),
                                "max": int(per_part.max()), "sum": int(per_part.sum())},
           "slowest_partition": {"index": worst, "rounds": int(rounds[worst]),
                                 **{n: int(cyc[worst, i]) for i, n in enumerate(PROBE_PHASES)}},
           "rounds": {"sum": int(rounds.sum()), "median": float(rounds.median()),
                      "p90": pct(rounds, 0.9), "max": int(rounds.max()),
                      "zero": int((rounds == 0).sum())},
           "round_parts": {n: {"cycles_sum": int(cyc[:, i].sum()),
                               "share_of_rounds": float(cyc[:, i].sum()) / max(
                                   float(cyc[:, 2].sum()), 1.0)}
                           for i, n in enumerate(PROBE_PHASES) if i >= 8},
           "relabel_sweeps": {"sum": int(cyc[:, 6].sum()), "max": int(cyc[:, 6].max())},
           "cut_sweeps": {"sum": int(cyc[:, 7].sum()), "max": int(cyc[:, 7].max())},
           "cuts_applied": int(stats[:, 2, 0].sum())}
    print(f"[k7_phases] {json.dumps(out)}", flush=True)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("k7_phases_torch: needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    print(smi, flush=True)
    _lib.build(("mincut_gate_block",))
    with torch.no_grad():
        shapes, A0, gate = config5_inputs()
        for shape, (x, pad) in shapes.items():
            report(shape, x, pad, A0, gate)
    print(json.dumps({"ok": True, "device": torch.cuda.get_device_name(0)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
