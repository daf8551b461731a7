"""Serving: differentiable and hierarchical search, the query engine, the
attention re-rank and the SQL engine (the HTTP and MCP servers are
`serve.server` and `serve.mcp`)."""

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
from ruvector_tpu_torch.serve.sql import SqlEngine, SqlError, execute_sql
from ruvector_tpu_torch.serve.search import (
    differentiable_search,
    hierarchical_forward,
    softmax_temperature,
)

__all__ = ["QueryEngine", "QueryMode", "QueryResult", "RuvectorQuery", "SqlEngine",
           "SqlError", "SubGraph", "attention_rerank", "differentiable_search", "execute_query",
           "execute_sql", "hierarchical_forward", "pairwise_cosine_rows", "retrieve_and_rerank",
           "softmax_temperature"]
