"""mfu.infer: the serving step's share of the bf16 peak (the forward's
operations; the gate's signatures and solves are not the model's)."""

from portbench.readers import mfu as read  # noqa: F401
