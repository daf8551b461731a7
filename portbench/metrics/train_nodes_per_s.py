"""train_nodes_per_s: nodes trained in every step the window finished, over
the window's seconds; the host reads every loss."""

from portbench.readers import nodes_per_s as read  # noqa: F401
