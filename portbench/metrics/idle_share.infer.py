"""idle_share.infer: the serving cell's idle share of the traced window."""

from portbench.readers import idle_share as read  # noqa: F401
