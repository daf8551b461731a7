"""idle_share.train: the train cell's idle share of the traced window."""

from portbench.readers import idle_share as read  # noqa: F401
