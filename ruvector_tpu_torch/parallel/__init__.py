"""Host-side orderings for block execution."""

from ruvector_tpu_torch.parallel.ordering import (
    graph_grow_blocks,
    halo_fraction,
    recursive_bisection_order,
)

__all__ = ["graph_grow_blocks", "halo_fraction", "recursive_bisection_order"]
