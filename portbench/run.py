"""Run one cell of the port's benchmark once and print its result.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The last line of standard output is one JSON
object (correct, attempted, failed, metrics, device, and with --trace 1 a
breakdown), and the last lines of standard error each number compared
with its limit. Exits non-zero, and prints no result, where no CUDA card
is found or fewer than the cell asks for, where the port cannot be
imported, or where the process holds JAX or the JAX package once the
window has closed.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

from portbench.harness import CACHE_DIR, CardQuery, Spec, run  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    card = CardQuery()
    try:
        return _run(args, card)
    finally:
        card.result()


def _run(args, card: CardQuery) -> int:
    # every cache a library may keep goes inside the checkout, at fixed paths
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor"), ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(CACHE_DIR / sub)
    import torch

    spec = Spec()
    wl = spec.workload(args.workload)
    if not torch.cuda.is_available():
        print("portbench: no CUDA card (torch.cuda.is_available() is False)", file=sys.stderr)
        return 3
    if torch.cuda.device_count() < int(wl["chips"]):
        print(f"portbench: {args.workload} needs {wl['chips']} cards, found "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 3
    try:
        import ruvector_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"portbench: the port does not import here: {e}", file=sys.stderr)
        return 4
    result = run(args.workload, args.seed, args.seconds, bool(args.trace),
                 torch.device("cuda", 0), T0, spec,
                 before_check=lambda: print(f"[portbench] card: {card.result()}; torch "
                                            f"{torch.__version__}", file=sys.stderr))
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
