"""Host-side orderings for block execution."""

from ruvector_tpu_torch.parallel.ordering import graph_grow_blocks

__all__ = ["graph_grow_blocks"]
