"""The benchmark of ruvector_tpu_torch, the PyTorch and CUDA port.

One command runs one cell (a configuration under a traffic mix) once:

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything that belongs to one configuration, one traffic mix or one
per-layer metric is a file of its own, found by the name that
BENCHMARK.json gives it: `configs/<config>.json`, `traffic/<traffic>.json`
(whose "driver" names the module under `drivers/` that runs it),
`metrics/<metric>.py` and `limits/<cell>.json`. The plain references that
decide `correct` live in `reference/` and import nothing of the port.
"""
