"""Graph layouts: padded neighbor lists, CSR, block-dense; kNN construction."""

from ruvector_tpu_torch.graph.block_dense import BlockDenseGraph, build_block_dense
from ruvector_tpu_torch.graph.build import build_knn_graph, knn_graph_numpy
from ruvector_tpu_torch.graph.csr import CSRGraph
from ruvector_tpu_torch.graph.neighbors import NeighborGraph, pad_degree_to

__all__ = ["NeighborGraph", "pad_degree_to", "CSRGraph", "build_knn_graph",
           "knn_graph_numpy", "BlockDenseGraph", "build_block_dense"]
