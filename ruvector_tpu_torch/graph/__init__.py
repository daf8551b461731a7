"""Graph layouts: padded neighbor lists, CSR, block-dense; kNN construction;
the property graph and its Cypher engine."""

from ruvector_tpu_torch.graph.block_dense import BlockDenseGraph, build_block_dense
from ruvector_tpu_torch.graph.build import build_knn_graph, knn_graph_numpy
from ruvector_tpu_torch.graph.csr import CSRGraph
from ruvector_tpu_torch.graph.cypher import (
    CypherEngine,
    CypherSyntaxError,
    cypher_shell,
    execute_cypher,
    parse_cypher,
)
from ruvector_tpu_torch.graph.neighbors import NeighborGraph, pad_degree_to
from ruvector_tpu_torch.graph.property import (
    Hyperedge,
    PEdge,
    PNode,
    PropertyGraph,
    Transaction,
    TransactionAborted,
)

__all__ = ["NeighborGraph", "pad_degree_to", "CSRGraph", "build_knn_graph",
           "knn_graph_numpy", "BlockDenseGraph", "build_block_dense",
           "PropertyGraph", "PNode", "PEdge", "Hyperedge",
           "Transaction", "TransactionAborted"]
