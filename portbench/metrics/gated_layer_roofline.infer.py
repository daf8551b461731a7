"""gated_layer_roofline.infer: the least time the gated layers' counted
work needs at the card's published peaks (K4b with its emitted signature,
then K4a; portbench.roofline) over the device time of the fused layer
kernel (csrc/gated_block_layer.cu) in the traced window, in %."""

from portbench.harness import device_s

KERNELS = ("tc_layer_kernel", "layer_kernel")


def read(ctx):
    s = device_s(ctx, KERNELS)
    bound = ctx.cell.bounds().get("gated_layers")
    return None if not s or bound is None else 100.0 * bound * ctx.steps / s
