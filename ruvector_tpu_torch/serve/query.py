"""Query API: modes, request and result types, execution (port of
ruvector_tpu/serve/query.py; reference ruvector-gnn/src/query.rs).

Candidate retrieval is a brute-force batched cosine top-k on the device;
`ef` is the width of the candidate pool that the GNN re-rank scores,
as in the reference pipeline (HNSW ~50 candidates -> GNN re-rank ->
top-k). Top-k runs with `sorted=True`; on equal scores `torch.topk`
promises no order where `lax.top_k` returns the lower index first.
"""

from __future__ import annotations

import dataclasses
import enum
import time

import numpy as np
import torch

from ruvector_tpu_torch.graph.neighbors import NeighborGraph
from ruvector_tpu_torch.nn.ruvector_layer import RuvectorLayerConfig, ruvector_layer_apply
from ruvector_tpu_torch.ops.distance import pairwise_cosine
from ruvector_tpu_torch.serve.search import differentiable_search, softmax_temperature


class QueryMode(enum.Enum):
    VECTOR_SEARCH = "vector_search"
    NEURAL_SEARCH = "neural_search"
    SUBGRAPH_EXTRACTION = "subgraph_extraction"
    DIFFERENTIABLE_SEARCH = "differentiable_search"


@dataclasses.dataclass
class RuvectorQuery:
    """Query request (query.rs:23-58 defaults)."""

    vector: np.ndarray
    mode: QueryMode = QueryMode.VECTOR_SEARCH
    k: int = 10
    ef: int = 50
    gnn_depth: int = 2
    temperature: float = 1.0
    return_embeddings: bool = False
    return_attention: bool = False


@dataclasses.dataclass
class SubGraph:
    """Extracted neighbourhood (query.rs:173)."""

    nodes: list[int]
    edges: list[tuple[int, int, float]]  # (from, to, weight)


@dataclasses.dataclass
class QueryResult:
    """Query response (query.rs:227-370)."""

    nodes: list[int]
    scores: list[float]
    embeddings: np.ndarray | None = None
    attention: np.ndarray | None = None
    subgraph: SubGraph | None = None
    latency_ms: float = 0.0


class QueryEngine:
    """Executes queries against a feature matrix [N, D] and its neighbour
    graph (both on one device), with an optional stack of RuvectorLayers
    for the neural re-rank."""

    def __init__(self, features: torch.Tensor, graph: NeighborGraph,
                 gnn_params: list[dict] | None = None,
                 gnn_cfgs: list[RuvectorLayerConfig] | None = None):
        self.features = features
        self.graph = graph
        self.gnn_params = gnn_params or []
        self.gnn_cfgs = gnn_cfgs or []
        self._gnn_cache: torch.Tensor | None = None
        self._host: tuple | None = None   # (graph, host copy of its arrays)

    def _gnn_embeddings(self, depth: int) -> torch.Tensor:
        """Run the GNN stack over all nodes once and cache the result. The
        cache is not keyed by depth, as in the JAX package: the first
        neural query's depth holds until `invalidate_cache`."""
        if self._gnn_cache is not None:
            return self._gnn_cache
        x = self.features
        for params, cfg in zip(self.gnn_params[:depth], self.gnn_cfgs[:depth]):
            x = ruvector_layer_apply(params, cfg, x, self.graph)
        self._gnn_cache = x
        return x

    def invalidate_cache(self):
        self._gnn_cache = None
        self._host = None

    def _sims(self, q: torch.Tensor) -> torch.Tensor:
        return pairwise_cosine(q[None, :], self.features)[0]

    def execute(self, query: RuvectorQuery) -> QueryResult:
        t0 = time.perf_counter()
        q = torch.as_tensor(np.asarray(query.vector, np.float32)).to(self.features.device)
        with torch.no_grad():
            result = self._execute(query, q)
        result.latency_ms = (time.perf_counter() - t0) * 1e3
        return result

    def _execute(self, query: RuvectorQuery, q: torch.Tensor) -> QueryResult:
        if query.mode == QueryMode.VECTOR_SEARCH:
            scores, idx = torch.topk(self._sims(q), query.k, sorted=True)
            return QueryResult(nodes=idx.tolist(), scores=scores.tolist())

        if query.mode == QueryMode.DIFFERENTIABLE_SEARCH:
            idx, weights = differentiable_search(q, self.features, query.k, query.temperature)
            return QueryResult(nodes=idx.tolist(), scores=weights.tolist())

        if query.mode == QueryMode.NEURAL_SEARCH:
            # stage 1: the ef-wide candidate pool by raw similarity (the HNSW
            # retrieval stage of the reference pipeline)
            sims = self._sims(q)
            ef = min(query.ef, self.features.shape[0])
            _, cand = torch.topk(sims, ef, sorted=True)
            # stage 2: re-rank in the GNN-updated space: the anchor is the
            # nearest candidate's updated embedding; raw similarity and
            # similarity in the learned space are blended
            cand_emb = self._gnn_embeddings(query.gnn_depth)[cand]
            learned = pairwise_cosine(cand_emb[0][None, :], cand_emb)[0]
            blended = 0.5 * sims[cand] + 0.5 * learned
            scores, local = torch.topk(blended, min(query.k, ef), sorted=True)
            result = QueryResult(nodes=cand[local].tolist(), scores=scores.tolist())
            if query.return_attention:
                attention = softmax_temperature(blended[None, :], query.temperature)[0]
                result.attention = attention[local].cpu().numpy()
            if query.return_embeddings:
                result.embeddings = cand_emb[local].cpu().numpy()
            return result

        if query.mode == QueryMode.SUBGRAPH_EXTRACTION:
            scores, seed = torch.topk(self._sims(q), query.k, sorted=True)
            seeds = seed.cpu().numpy()
            nodes = self._khop(seeds, query.gnn_depth)
            return QueryResult(nodes=seeds.tolist(), scores=scores.tolist(),
                               subgraph=SubGraph(nodes=sorted(nodes),
                                                 edges=self._edges_within(nodes)))
        raise ValueError(f"unknown mode {query.mode}")

    def _host_graph(self):
        """The graph's arrays on the host for the subgraph walk, copied on
        the first walk and again whenever `self.graph` is another object
        (the JAX engine reads `self.graph` on every walk)."""
        g = self.graph
        if self._host is None or self._host[0] is not g:
            self._host = (g, (g.nbr_idx.cpu().numpy(), g.nbr_mask.cpu().numpy() > 0,
                              g.edge_weight.cpu().numpy()))
        return self._host[1]

    def _khop(self, seeds: np.ndarray, depth: int) -> set[int]:
        nbr, mask, _ = self._host_graph()
        frontier = set(int(s) for s in seeds)
        visited = set(frontier)
        for _ in range(depth):
            nxt = set()
            for u in frontier:
                nxt.update(int(v) for v in nbr[u][mask[u]])
            frontier = nxt - visited
            visited |= nxt
        return visited

    def _edges_within(self, nodes: set[int]) -> list[tuple[int, int, float]]:
        nbr, mask, w = self._host_graph()
        edges = []
        for u in sorted(nodes):
            for j, v in enumerate(nbr[u]):
                if mask[u, j] and int(v) in nodes:
                    edges.append((int(u), int(v), float(w[u, j])))
        return edges


def execute_query(query: RuvectorQuery, features: torch.Tensor, graph: NeighborGraph,
                  gnn_params: list[dict] | None = None,
                  gnn_cfgs: list[RuvectorLayerConfig] | None = None) -> QueryResult:
    """One-shot convenience wrapper around QueryEngine."""
    return QueryEngine(features, graph, gnn_params, gnn_cfgs).execute(query)
