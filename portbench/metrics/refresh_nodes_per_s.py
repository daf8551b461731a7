"""refresh_nodes_per_s: nodes the RuvectorLayer refreshed in every pass the
window finished, over the window's seconds."""

from portbench.readers import nodes_per_s as read  # noqa: F401
