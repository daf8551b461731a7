"""Vector indexes: the exact flat index."""

from ruvector_tpu_torch.index.flat import FlatIndex

__all__ = ["FlatIndex"]
