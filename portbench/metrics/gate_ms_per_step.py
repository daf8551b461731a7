"""gate_ms_per_step: device ms a step of the gate's kernels, the LN-folded
signature (K6c, csrc/gated_block_attn.cu) and the min-cut gate (K7,
csrc/mincut_gate_block.cu), in the traced window."""

from portbench.harness import device_s

KERNELS = ("tc_signature_kernel", "signature_kernel", "gate_kernel")


def read(ctx):
    s = device_s(ctx, KERNELS)
    return None if not s else s / ctx.steps * 1e3
