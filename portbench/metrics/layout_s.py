"""layout_s: seconds the port's block-dense layout of the neighbour lists
took in set-up (graph/block_dense: the host plan, the device fill),
synchronised."""


def read(ctx):
    return ctx.cell.setup_fields.get("layout_s")
