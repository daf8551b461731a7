"""resolved_per_step: partitions whose gate the step solved again (the
`n_resolved` that gated_graph_transformer_step returns), summed over the
traced window's steps, per step."""


def read(ctx):
    c = ctx.cell.counters
    return c["resolved"] / c["steps"] if c.get("steps") else None
