"""k1_roofline: the least time K1's counted work needs at the card's
published peaks (portbench.roofline.k1_bound_s: bf16 products over the
real edges, the float32-grade epilogue, or the bytes) over K1's device
time in the traced window, in %."""

from portbench.harness import device_s

K1 = ("tc_fused_kernel", "fused_layer_kernel")


def read(ctx):
    s = device_s(ctx, K1)
    bound = ctx.cell.bounds().get("k1")
    return None if not s or bound is None else 100.0 * bound * ctx.steps / s
