"""Vector indexes: HNSW, the exact flat index, the hyperbolic index, payload
filters and the VectorDB facade."""

from ruvector_tpu_torch.index.filter import (
    FilterExpression,
    PayloadIndex,
    matches as filter_matches,
    parse_qdrant_filter,
)
from ruvector_tpu_torch.index.flat import FlatIndex
from ruvector_tpu_torch.index.hnsw import HnswConfig, HnswIndex
from ruvector_tpu_torch.index.hyperbolic_hnsw import HyperbolicIndex
from ruvector_tpu_torch.index.vector_db import DbOptions, SearchResult, VectorDB

__all__ = [
    "HnswIndex",
    "HnswConfig",
    "VectorDB",
    "DbOptions",
    "SearchResult",
    "HyperbolicIndex",
    "FilterExpression",
    "PayloadIndex",
    "filter_matches",
    "parse_qdrant_filter",
    "FlatIndex",
]
