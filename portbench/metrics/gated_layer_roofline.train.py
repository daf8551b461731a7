"""gated_layer_roofline.train: the least time of a train step's gated
kernels at the card's published peaks (per layer K4a forward, K5a's
recompute and K5b's backward; portbench.roofline) over the device time of
those kernels (csrc/gated_block_layer.cu, csrc/gated_block_mha.cu) in the
traced window, in %."""

from portbench.harness import device_s

KERNELS = ("tc_layer_kernel", "layer_kernel", "tc_mha_fwd_kernel", "mha_fwd_kernel",
           "tc_mha_bwd_kernel", "mha_bwd_kernel", "reduce_partials_kernel")


def read(ctx):
    s = device_s(ctx, KERNELS)
    bound = ctx.cell.bounds().get("gated_layers")
    return None if not s or bound is None else 100.0 * bound * ctx.steps / s
