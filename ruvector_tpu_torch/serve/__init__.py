"""Serving: differentiable and hierarchical search, the query engine and
the attention re-rank."""

from ruvector_tpu_torch.serve.query import (
    QueryEngine,
    QueryMode,
    QueryResult,
    RuvectorQuery,
    SubGraph,
    execute_query,
)
from ruvector_tpu_torch.serve.rerank import (
    attention_rerank,
    pairwise_cosine_rows,
    retrieve_and_rerank,
)
from ruvector_tpu_torch.serve.search import (
    differentiable_search,
    hierarchical_forward,
    softmax_temperature,
)

__all__ = ["QueryEngine", "QueryMode", "QueryResult", "RuvectorQuery", "SubGraph",
           "attention_rerank", "differentiable_search", "execute_query",
           "hierarchical_forward", "pairwise_cosine_rows", "retrieve_and_rerank",
           "softmax_temperature"]
