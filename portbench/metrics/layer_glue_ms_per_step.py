"""layer_glue_ms_per_step: device ms a pass of every operation launched
inside the layer's call other than K1 (csrc/block_dense_attn.cu's fused
layer): the message projection and its bf16 round trip, the float32 copy
of the edge table, the folded weights."""

from portbench.harness import device_s

K1 = ("tc_fused_kernel", "fused_layer_kernel")


def read(ctx):
    s = device_s(ctx, span="pass", exclude=K1)
    return None if s is None else s / ctx.steps * 1e3
