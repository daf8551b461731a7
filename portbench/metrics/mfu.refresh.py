"""mfu.refresh: the RuvectorLayer pass's share of the bf16 peak."""

from portbench.readers import mfu as read  # noqa: F401
