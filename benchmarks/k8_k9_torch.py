"""Where K8's and K9's time goes on the card, at the main paths' shapes.

K8 (the re-rank's neighbor attention, float32) at the re-rank's shape,
q [B, 128] and k, v [B, 256, 128], three ways: k is v (the re-rank passes
the candidate pool as both), v a copy of k, and B = 1056 (8 whole waves
of 132 CTAs, where B = 1024 leaves the last wave part empty); beside it a
plain `pool.clone()` and `pool.sum()`, the card's streaming rates at the
same bytes.

K9 (the gather SpMM, float32) on chip_smoke.py's regular graph (99,840
nodes in clusters of 128, exact within-cluster k = 16, D = 128) as built,
on the same graph with its node ids randomly permuted (every row keeps
its degree, its neighbours land anywhere in feat), and on uniform random
indices; each warm (as chip_smoke.py times it) and with L2 flushed by a
100 MB write between calls (the write outside the timed span).

Each time is a median of CUDA-event timings (`time_ms`: calls back to
back by default, as chip_smoke.py's `kernel_ms`; also single calls, as
its `ms`), beside the bytes bound and the kernel's error against its
plain version. The kernels are called through their C entry points, not
the Python wrappers, so that a single call counts the same host path for
every version. With --parent DIR (the root of another checkout, e.g. an
older commit unpacked with `git archive` into a git-ignored directory)
that checkout's csrc/flash_neighbor.cu and csrc/spmm_gather.cu are built
beside this tree's and timed in turns: parent, this, this, parent. Every
line names the card and its power limit. Needs a CUDA card and nvcc:

    python3 benchmarks/k8_k9_torch.py [--parent DIR]
"""
import argparse
import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from chip_smoke import cluster_graph  # noqa: E402
from ruvector_tpu_torch.ops.kernels import _lib  # noqa: E402
from ruvector_tpu_torch.ops.kernels.flash_neighbor import (  # noqa: E402
    flash_neighbor_attention_reference,
)
from ruvector_tpu_torch.ops.kernels.spmm import spmm_gather_reference  # noqa: E402

K8_M, K8_D = 256, 128
K9_NODES, K9_K, K9_D = 99_840, 16, 128
FLUSH_BYTES = 100 * 2 ** 20
PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
CARD = ""


def say(tag: str, **fields) -> None:
    print(f"[{tag}] card=\"{CARD}\" " + " ".join(f"{k}={v}" for k, v in fields.items()),
          flush=True)


def time_ms(fn, iters: int = 20, flush: torch.Tensor | None = None,
            single: bool = False) -> float:
    """Milliseconds of one call on the card. By default the median over 5
    runs of `iters` calls back to back between two CUDA events, divided by
    `iters`: the host queues the calls ahead of the card, so its own time
    per call is hidden. `single`: the median of `iters` calls, each between
    two events (chip_smoke.py's `ms`: the host's time to launch the call
    counts where the card waits for it).
    `flush`: single calls, each after a write of `flush` (queued before
    the first event, so the call's launch is ahead of the card)."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    one = single or flush is not None
    times = []
    for i in range(iters if one else 5):
        if flush is not None:
            flush.fill_(float(i))
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(1 if one else iters):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / (1 if one else iters))
    return statistics.median(times)


def in_turns(fns: dict, **kw) -> dict:
    """Each version's median; with a parent, timed parent, this, this,
    parent and each version's two medians averaged."""
    if "parent" not in fns:
        return {"this": time_ms(fns["this"], **kw)}
    got = {"parent": [], "this": []}
    for name in ("parent", "this", "this", "parent"):
        got[name].append(time_ms(fns[name], **kw))
    return {name: statistics.mean(t) for name, t in got.items()} | {
        f"{name}_runs": t for name, t in got.items()}


class Entries:
    """K8's and K9's C entry points, called with no wrapper: this tree's
    libraries as `_lib` builds them (root None), or another checkout's
    sources built beside them, called with the arguments they took before
    the test-only `variant` was added."""

    def __init__(self, root: Path | None = None):
        self.variant = (0,) if root is None else ()
        if root is None:
            self.fns = {name: getattr(_lib.load(name), f"{name}_f32")
                        for name in ("flash_neighbor", "spmm_gather")}
            return
        out = _lib.BUILD_DIR / "parent"
        out.mkdir(parents=True, exist_ok=True)
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        specs = {"flash_neighbor": ("flash_neighbor_f32", [P] * 5 + [I] * 3 + [F, P]),
                 "spmm_gather": ("spmm_gather_f32", [P] * 4 + [I] * 4 + [P])}
        procs = {name: subprocess.Popen(
            [_lib.nvcc_path(), *_lib.NVCC_FLAGS, "-o", str(out / f"lib{name}.so"),
             str(root / "ruvector_tpu_torch" / "csrc" / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for name in specs}
        self.fns = {}
        for name, (fn_name, argtypes) in specs.items():
            log = procs[name].communicate()[0]
            if procs[name].returncode != 0:
                raise RuntimeError(f"parent {name}.cu: nvcc failed:\n{log[-4000:]}")
            lib = ctypes.CDLL(str(out / f"lib{name}.so"))
            fn = getattr(lib, fn_name)
            fn.argtypes, fn.restype = argtypes, ctypes.c_int
            self.fns[name] = fn

    def k8(self, q, k, v):
        b, m, d = k.shape
        out = torch.empty(b, d, device=q.device)
        rc = self.fns["flash_neighbor"](q.data_ptr(), k.data_ptr(), v.data_ptr(), None,
                                        out.data_ptr(), b, m, d, d ** -0.5, *self.variant,
                                        _lib.stream_handle(q))
        assert rc == 0, f"K8: CUDA error {rc}"
        return out

    def k9(self, feats, idx, w):
        (n, d), (b, m) = feats.shape, idx.shape
        out = torch.empty(b, d, device=feats.device)
        rc = self.fns["spmm_gather"](feats.data_ptr(), idx.data_ptr(), w.data_ptr(),
                                     out.data_ptr(), n, b, m, d, *self.variant,
                                     _lib.stream_handle(feats))
        assert rc == 0, f"K9: CUDA error {rc}"
        return out


def max_err(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got - want).abs().max())


def k8_cases(dev, this, parent) -> dict:
    g = torch.Generator(device=dev).manual_seed(0)
    res = {}
    for case, b, same in (("k_is_v", 1024, True), ("v_copy", 1024, False),
                          ("k_is_v_b1056", 1056, True)):
        q = torch.randn(b, K8_D, generator=g, device=dev)
        k = torch.randn(b, K8_M, K8_D, generator=g, device=dev)
        v = k if same else k.clone()
        n_bytes = 4 * (2 * q.numel() + k.numel() + (0 if same else v.numel()))
        bound_ms = n_bytes / PEAK_BYTES_PER_S * 1e3
        fns = {"this": lambda: this.k8(q, k, v)}
        if parent:
            fns["parent"] = lambda: parent.k8(q, k, v)
        want = flash_neighbor_attention_reference(q, k, v)
        errs = {name: max_err(fn(), want) for name, fn in fns.items()}
        ms, single = in_turns(fns), in_turns(fns, single=True)
        res[case] = {"B": b, "bound_ms": bound_ms, "ms": ms, "single_call_ms": single,
                     "max_abs_err": errs}
        say("k8", case=case, B=b, M=K8_M, D=K8_D, bound_ms=bound_ms,
            ms=json.dumps(ms), share_of_bound=json.dumps(
                {n: bound_ms / t for n, t in ms.items() if not n.endswith("_runs")}),
            single_call_ms=json.dumps(single), max_abs_err=json.dumps(errs))
        if case == "k_is_v":  # the card's streaming rates at the pool's bytes
            clone_ms, sum_ms = time_ms(lambda: k.clone()), time_ms(lambda: k.sum())
            res["pool_clone"] = {"ms": clone_ms, "bytes": 2 * k.numel() * 4,
                                 "tb_per_s": 2 * k.numel() * 4 / (clone_ms * 1e-3) / 1e12}
            res["pool_sum"] = {"ms": sum_ms, "bytes": k.numel() * 4,
                               "tb_per_s": k.numel() * 4 / (sum_ms * 1e-3) / 1e12}
            say("k8", case="pool_clone", ms=clone_ms, **{
                "read_plus_write_TB_per_s": res["pool_clone"]["tb_per_s"]})
            say("k8", case="pool_sum", ms=sum_ms, **{"read_TB_per_s": res["pool_sum"]["tb_per_s"]})
        del q, k, v, want
    return res


def k9_cases(dev, this, parent) -> dict:
    feats, idx, w = cluster_graph(K9_NODES, K9_D, K9_K)
    n = feats.shape[0]
    g = torch.Generator(device=dev).manual_seed(1)
    perm = torch.randperm(n, generator=g, device=dev)
    feats_p, idx_p, w_p = (torch.empty_like(t) for t in (feats, idx, w))
    feats_p[perm], idx_p[perm], w_p[perm] = feats, perm[idx.long()].int(), w
    idx_u = torch.randint(0, n, (n, K9_K), generator=g, device=dev, dtype=torch.int32)
    w_u = torch.rand(n, K9_K, generator=g, device=dev)
    flush = torch.empty(FLUSH_BYTES // 4, device=dev)
    res = {}
    for case, (f, i, ww) in (("regular", (feats, idx, w)), ("permuted", (feats_p, idx_p, w_p)),
                             ("uniform", (feats, idx_u, w_u))):
        b, m = i.shape
        n_bytes = 4 * (f.numel() + i.numel() + ww.numel() + b * K9_D)
        bound_ms = n_bytes / PEAK_BYTES_PER_S * 1e3
        gather_ms = 4 * b * m * K9_D / PEAK_BYTES_PER_S * 1e3
        fns = {"this": lambda: this.k9(f, i, ww)}
        if parent:
            fns["parent"] = lambda: parent.k9(f, i, ww)
        want = spmm_gather_reference(f, i, ww)
        errs = {name: max_err(fn(), want) for name, fn in fns.items()}
        warm, single = in_turns(fns), in_turns(fns, single=True)
        cold = in_turns(fns, flush=flush)
        res[case] = {"bound_ms": bound_ms, "gather_bound_ms": gather_ms, "warm_ms": warm,
                     "warm_single_call_ms": single, "l2_flushed_ms": cold,
                     "max_abs_err": errs}
        say("k9", case=case, N=n, B=b, M=m, D=K9_D, bound_ms=bound_ms,
            gather_bound_ms=gather_ms, warm_ms=json.dumps(warm),
            warm_single_call_ms=json.dumps(single), l2_flushed_ms=json.dumps(cold),
            max_abs_err=json.dumps(errs))
        del want
    return res


def main() -> int:
    global CARD
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, help="root of another checkout to time beside")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("k8_k9_torch: needs a CUDA card")
    CARD = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(CARD, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    _lib.build(("flash_neighbor", "spmm_gather"))
    this = Entries()
    parent = Entries(args.parent.resolve()) if args.parent else None
    dev = torch.device("cuda")
    with torch.no_grad():
        res = {"card": CARD, "k8": k8_cases(dev, this, parent),
               "k9": k9_cases(dev, this, parent)}
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
