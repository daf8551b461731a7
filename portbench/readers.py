"""What several metric files read alike: a rate of nodes over the window,
the whole step's share of the bf16 peak, and the device's idle share. The
harness calls a metric's reader only in the cells that BENCHMARK.json
lists for it."""

from __future__ import annotations

from portbench.roofline import MFU_PEAK


def nodes_per_s(ctx):
    """Nodes of every step the window finished over its seconds (host
    clock; every step ends synchronised)."""
    return ctx.cell.nodes * ctx.steps / ctx.window_s


def mfu(ctx):
    """The model's operations a step, counted from shapes
    (portbench.roofline), times the traced window's steps, over its seconds
    and the card's bf16 peak (989 TFLOP/s), in %."""
    if ctx.trace is None:
        return None
    return 100.0 * ctx.cell.model_ops() * ctx.steps / ctx.window_s / MFU_PEAK


def idle_share(ctx):
    """The share of the traced window in which no operation ran on the
    device (the union of the trace's kernels, copies and fills), in %."""
    if ctx.trace is None or not ctx.trace["device_op_count"]:
        return None
    t = ctx.trace
    return 100.0 * (t["window_s"] - t["busy_s"]) / t["window_s"]
