"""infer_nodes_per_s: nodes served under drift in every step the window
finished, over the window's seconds."""

from portbench.readers import nodes_per_s as read  # noqa: F401
