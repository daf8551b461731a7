"""The general harness: finds a cell's files by name, sets it up, runs the
measured window, reads the metrics, decides `correct` and assembles the
result line. Nothing here names a configuration, a traffic mix or a
metric: those are files of their own (see the package's docstring).
"""

from __future__ import annotations

import bisect
import contextlib
import importlib.util
import json
import re
import sys
import time
import types
from pathlib import Path

import torch

PKG = Path(__file__).resolve().parent
ROOT = PKG.parent
CACHE_DIR = PKG / "cache"
# top-level module names that no process of the benchmark may hold
FORBIDDEN = ("jax", "jaxlib", "flax", "ruvector_tpu")
DEVICE_OPS = ("kernel", "gpu_memcpy", "gpu_memset")
_BASE_NAME = re.compile(r"([A-Za-z_]\w*)(?=<|\()")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


# ---------------------------------------------------------------------------
# finding a cell's files by name
# ---------------------------------------------------------------------------

class Spec:
    """BENCHMARK.json and the files that its names point to."""

    def __init__(self, root: Path = ROOT, pkg: Path = PKG):
        self.root, self.pkg = Path(root), Path(pkg)
        self.doc = load_json(self.root / "BENCHMARK.json")

    def workload(self, name: str) -> dict:
        for w in self.doc["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.doc["configs"]:
            if c["name"] == name:
                return load_json(self.root / c["file"])
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        return load_json(self.pkg / "traffic" / f"{name}.json")

    def limits(self, workload: str) -> dict:
        return load_json(self.pkg / "limits" / f"{workload}.json")["numbers"]

    def metrics(self, workload: str, trace: bool) -> list[dict]:
        """The metrics a run of the cell reports: its end-to-end ones
        (trace 0) or its per-layer ones (trace 1)."""
        group = self.doc["per_layer" if trace else "end_to_end"]
        return [m for m in group if workload in m.get("workloads", [workload])]

    def _module(self, folder: str, name: str):
        path = self.pkg / folder / f"{name}.py"
        mod_name = f"portbench_{folder}_" + re.sub(r"\W", "_", name)
        mod = sys.modules.get(mod_name)
        if mod is None or getattr(mod, "__file__", None) != str(path):
            mod_spec = importlib.util.spec_from_file_location(mod_name, path)
            mod = importlib.util.module_from_spec(mod_spec)
            mod_spec.loader.exec_module(mod)
            sys.modules[mod_name] = mod
        return mod

    def driver(self, traffic: dict):
        """drivers/<driver>.py, the module that runs the traffic's cells."""
        return self._module("drivers", traffic["driver"])

    def reader(self, metric: str):
        """metrics/<metric>.py's `read(ctx)`."""
        return self._module("metrics", metric).read


# ---------------------------------------------------------------------------
# the cell a driver runs
# ---------------------------------------------------------------------------

class Cell:
    """What a driver implements. `kind` is "infer" or "train"; `spans`
    names the host spans around its calls into the port (the idle gaps of
    a traced run are named by them); `nodes` the nodes one step serves or
    trains."""

    kind = "infer"
    spans: tuple = ()

    def __init__(self, config: dict, traffic: dict, seed: int, device: torch.device):
        self.config, self.traffic, self.seed, self.device = config, traffic, seed, device
        self.nodes = 0
        self.counters: dict = {}
        self.setup_fields: dict = {}
        self.phases: dict = {}
        self._mark = time.perf_counter()

    def mark(self, phase: str) -> None:
        """Record the seconds since the last mark (synchronised) as the
        set-up phase `phase`."""
        sync(self.device)
        now = time.perf_counter()
        self.phases[phase] = now - self._mark
        self._mark = now

    def setup(self) -> None:
        """Build the graph and the model, warm up; fills setup_fields."""
        raise NotImplementedError

    def step(self, i: int) -> None:
        """Step i of the window (negative: warm-up), done when it returns."""
        raise NotImplementedError

    def bounds(self) -> dict:
        """Least seconds a step's kernels need, by group name."""
        return {}

    def model_ops(self) -> float:
        """The model's operations in one step."""
        return 0.0

    def release(self) -> None:
        """Free the program's state, keeping what check() reads."""

    def check(self, control: bool = False) -> dict:
        """The numbers compared against the plain reference; with control,
        the reference one precision lower in the program's place."""
        raise NotImplementedError


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def span(name: str):
    with torch.profiler.record_function(name):
        yield


def run_window(cell: Cell, seconds: float) -> dict:
    """Closed loop: step after step until `seconds` have passed; the step
    in flight finishes and counts. Returns steps, window seconds and each
    step's latency (host clock; every step ends synchronised)."""
    sync(cell.device)
    lat = []
    with span("window"):
        start = time.perf_counter()
        i = 0
        while True:
            t = time.perf_counter()
            cell.step(i)
            end = time.perf_counter()
            lat.append(end - t)
            i += 1
            if end - start >= seconds:
                break
    return {"steps": i, "window_s": end - start, "latencies": lat}


# ---------------------------------------------------------------------------
# the traced window: device time by kernel and by host span, idle gaps
# ---------------------------------------------------------------------------

def base_name(name: str) -> str:
    """A kernel's function name without namespaces, template arguments or
    parameters ("void ns::tc_layer_kernel<128>(...)" -> "tc_layer_kernel")."""
    m = _BASE_NAME.search(name)
    return m.group(1) if m else name


def summarize_trace(path: Path, spans: tuple) -> dict:
    """Read a chrome trace of the window: busy seconds (the union of device
    operations), the window's length, device seconds by kernel name and by
    (host span that launched it, kernel name), the longest operations, and
    idle seconds by the host span active when the device went idle."""
    events = load_json(path)["traceEvents"]
    window = [e for e in events if e.get("ph") == "X" and e.get("name") == "window"
              and e.get("cat") == "user_annotation"]
    if not window:
        raise RuntimeError("the trace has no window span")
    w0 = float(window[0]["ts"])
    w1 = w0 + float(window[0]["dur"])
    host = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"]) for e in events
                  if e.get("ph") == "X" and e.get("cat") == "user_annotation"
                  and e.get("name") in spans)
    starts = [h[0] for h in host]

    def span_at(t: float) -> str:
        k = bisect.bisect_right(starts, t) - 1
        return host[k][2] if k >= 0 and host[k][1] >= t else "host"

    launch = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in ("cuda_runtime", "cuda_driver"):
            corr = (e.get("args") or {}).get("correlation")
            if corr is not None:
                launch[corr] = float(e["ts"])
    ops = []
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_OPS:
            continue
        t0, t1 = float(e["ts"]), float(e["ts"]) + float(e["dur"])
        if t1 <= w0 or t0 >= w1:
            continue
        corr = (e.get("args") or {}).get("correlation")
        ops.append((max(t0, w0), min(t1, w1), e["name"], span_at(launch.get(corr, t0))))
    ops.sort()
    kernels, by_span, full = {}, {}, {}
    busy, idle = 0.0, {}
    cur0 = cur1 = w0
    for t0, t1, name, sp in ops:
        sec = (t1 - t0) * 1e-6
        b = base_name(name)
        kernels[b] = kernels.get(b, 0.0) + sec
        by_span.setdefault(sp, {})
        by_span[sp][b] = by_span[sp].get(b, 0.0) + sec
        full[name] = full.get(name, 0.0) + sec
        if t0 > cur1:
            busy += (cur1 - cur0) * 1e-6
            gap = span_at(cur1)
            idle[gap] = idle.get(gap, 0.0) + (t0 - cur1) * 1e-6
            cur0, cur1 = t0, t1
        else:
            cur1 = max(cur1, t1)
    busy += (cur1 - cur0) * 1e-6
    if w1 > cur1:
        gap = span_at(cur1)
        idle[gap] = idle.get(gap, 0.0) + (w1 - cur1) * 1e-6
    top = sorted(full.items(), key=lambda kv: -kv[1])[:10]
    return {"window_s": (w1 - w0) * 1e-6, "busy_s": busy, "kernels": kernels,
            "by_span": by_span, "device_ops": [[n[:160], s] for n, s in top],
            "idle_gaps": sorted(([k, v] for k, v in idle.items()), key=lambda kv: -kv[1])[:10],
            "device_op_count": len(ops)}


def device_s(ctx, names=None, span=None, exclude=()) -> float | None:
    """For metric readers: device seconds in the traced window of the
    kernels named (all where None), of those launched inside host span
    `span` (any where None), leaving out the names in `exclude`; None
    without a trace."""
    if ctx.trace is None or not ctx.trace["device_op_count"]:
        return None
    table = ctx.trace["by_span"].get(span, {}) if span else ctx.trace["kernels"]
    return sum(s for k, s in table.items() if (names is None or k in names) and k not in exclude)


def traced_window(cell: Cell, seconds: float, out: Path) -> tuple[dict, dict]:
    """run_window under torch.profiler; the raw trace is read and deleted,
    and its summary kept beside it."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if cell.device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    out.parent.mkdir(parents=True, exist_ok=True)
    with profile(activities=acts) as prof:
        window = run_window(cell, seconds)
    prof.export_chrome_trace(str(out))
    try:
        summary = summarize_trace(out, cell.spans)
    finally:
        out.unlink(missing_ok=True)
    with open(out.with_suffix(".summary.json"), "w") as f:
        json.dump(summary, f)
    return window, summary


# ---------------------------------------------------------------------------
# correct, and the modules the process holds
# ---------------------------------------------------------------------------

def passes(value, limit: float) -> bool:
    """A number at or under its limit passes; one missing or not a number
    fails."""
    return isinstance(value, (int, float)) and value == value and value <= limit


def judge(readings: dict, limits: dict) -> tuple[bool, dict]:
    """(every number passes, {name: {"value", "limit"}})."""
    check = {name: {"value": readings.get(name), "limit": lim["limit"]}
             for name, lim in limits.items()}
    return all(passes(c["value"], c["limit"]) for c in check.values()), check


def forbidden_modules(modules=None) -> list[str]:
    """Top-level names in FORBIDDEN that `modules` (sys.modules) holds,
    each name compared whole: "ruvector_tpu_torch" is not "ruvector_tpu"."""
    names = {m.split(".", 1)[0] for m in (sys.modules if modules is None else modules)}
    return sorted(n for n in names if n in FORBIDDEN)


class CardQuery:
    """The card's name and power limit as nvidia-smi reads them, asked in
    a child process at start (it takes seconds on a card without
    persistence mode) and read, the child waited for, at the end."""

    def __init__(self):
        import subprocess

        try:
            self.proc = subprocess.Popen(["nvidia-smi", "--query-gpu=name,power.limit",
                                          "--format=csv,noheader"],
                                         stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
                                         text=True)
        except OSError:
            self.proc = None

    def result(self) -> str:
        import subprocess

        if self.proc is not None:
            proc, self.proc = self.proc, None
            try:
                out = proc.communicate(timeout=60)[0].strip()
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.communicate()
                out = ""
            self.text = out.splitlines()[0] if out else "unknown"
        return getattr(self, "text", "unknown")


# ---------------------------------------------------------------------------
# one run
# ---------------------------------------------------------------------------

def run(workload: str, seed: int, seconds: float, trace: bool, device: torch.device,
        t0: float, spec: Spec | None = None, config_changes: dict | None = None,
        log=sys.stderr, before_check=None) -> dict:
    """Run one cell once and return its result line (a dict)."""
    spec = spec or Spec()
    wl = spec.workload(workload)
    config = dict(spec.config(wl["config"]), **(config_changes or {}))
    traffic = spec.traffic(wl["traffic"])
    limits = spec.limits(workload)
    metrics = spec.metrics(workload, trace)
    readers = {m["name"]: spec.reader(m["name"]) for m in metrics}
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    imports_s = time.perf_counter() - t0
    cell = spec.driver(traffic).Cell(config, traffic, seed, device)
    cell.setup()
    sync(device)
    setup_s = time.perf_counter() - t0
    print("[portbench] set-up s: " + " ".join(
        f"{k}={v:.3f}" for k, v in {"imports": imports_s, **cell.phases}.items()), file=log)
    if trace:
        window, summary = traced_window(cell, seconds,
                                         spec.pkg / "out" / f"{workload}.{seed}.trace.json")
    else:
        window, summary = run_window(cell, seconds), None
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    ctx = types.SimpleNamespace(cell=cell, setup_s=setup_s, trace=summary, **window)
    values = {}
    for m in metrics:
        v = readers[m["name"]](ctx)
        if v is not None:
            values[m["name"]] = {"value": float(v), "unit": m["unit"]}
    cell.release()
    if before_check is not None:
        before_check()
    t_check = time.perf_counter()
    readings = cell.check()
    correct, check = judge(readings, limits)
    print(f"[portbench] {workload} seed={seed} steps={window['steps']} "
          f"window_s={window['window_s']:.3f} setup_s={setup_s:.3f} "
          f"check_s={time.perf_counter() - t_check:.1f}", file=log)
    found = forbidden_modules()
    if found:
        raise SystemExit(f"portbench: the process holds {found} once the window has closed")
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": int(wl["chips"]), "memory_peak_bytes": int(peak)}
    result = {"correct": correct, "attempted": window["steps"], "failed": 0,
              "metrics": values, "device": dev}
    if summary is not None:
        dev["busy_s"] = summary["busy_s"]
        dev["window_s"] = summary["window_s"]
        result["breakdown"] = {"device_ops": summary["device_ops"],
                               "idle_gaps": summary["idle_gaps"]}
    for name, c in check.items():
        verdict = "ok" if passes(c["value"], c["limit"]) else "FAILS"
        print(f"check {name} {c['value']} limit {c['limit']} {verdict}", file=log)
    result["check"] = check
    return result
