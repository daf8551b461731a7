"""mfu.train: the train step's share of the bf16 peak (forward and a backward
of twice its operations; remat's recompute not counted)."""

from portbench.readers import mfu as read  # noqa: F401
