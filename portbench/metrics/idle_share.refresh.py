"""idle_share.refresh: the RuvectorLayer cell's idle share of the traced
window."""

from portbench.readers import idle_share as read  # noqa: F401
