"""step_ms_p95: the 95th percentile of the latency of every step in the
window, from the step's call (its input drawn first) to its output ready
(synchronised), in ms."""

import statistics


def read(ctx):
    if len(ctx.latencies) < 2:
        return None
    return statistics.quantiles(ctx.latencies, n=20, method="inclusive")[18] * 1e3
