"""train_glue_ms_per_step: device ms a train step of every operation that
is not one of the port's hand-written kernels (PyTorch's own kernels,
copies and fills: the loss, autograd's glue, the recompute's plain
sublayers, the update), launched inside the step's span."""

from portbench.harness import device_s
from portbench.program import PORT_KERNELS


def read(ctx):
    s = device_s(ctx, span="step", exclude=PORT_KERNELS)
    return None if s is None else s / ctx.steps * 1e3
