"""VectorDB facade: insert/search with optional quantization + GNN re-rank
(port of ruvector_tpu/index/vector_db.py).

Reference: ruvector-core/src/vector_db.rs (VectorDB::new/insert/search,
:22-36) + the neural re-rank pipeline (README:330-343). Storage is
host-side (numpy + HNSW); the flat index, the feature matrix and the
neighbor graph live on `device` (default: the CUDA card), where a GNN
stack consumes them.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ruvector_tpu_torch.device import resolve_device
from ruvector_tpu_torch.index.hnsw import HnswConfig, HnswIndex


@dataclasses.dataclass(frozen=True)
class DbOptions:
    """ruvector-core/src/types.rs:61-126 equivalents."""

    dimensions: int
    metric: str = "cosine"
    m: int = 32
    ef_construction: int = 200
    ef_search: int = 100
    quantization: str | None = None     # None | 'int8' | 'binary'
    index_type: str = "hnsw"            # 'hnsw' | 'flat' (exact, one product)


@dataclasses.dataclass
class SearchResult:
    id: int
    score: float
    vector: np.ndarray | None = None
    payload: dict | None = None


class VectorDB:
    def __init__(self, options: DbOptions, device=None):
        self.options = options
        self.device = resolve_device(device)
        if getattr(options, "index_type", "hnsw") == "flat":
            from ruvector_tpu_torch.index.flat import FlatIndex

            self.index = FlatIndex(options.dimensions, options.metric, device=self.device)
        else:
            self.index = HnswIndex(HnswConfig(
                dim=options.dimensions, m=options.m,
                ef_construction=options.ef_construction,
                ef_search=options.ef_search, metric=options.metric,
            ), device=self.device)
        self._vectors: list[np.ndarray] = []
        self._payloads: dict[int, dict] = {}
        self._ids: list[int | str] = []
        self._id_to_idx: dict = {}
        from ruvector_tpu_torch.index.filter import PayloadIndex

        self._payload_index = PayloadIndex()

    def __len__(self) -> int:
        return len(self._vectors)

    def insert(self, vector, id=None, payload: dict | None = None):
        idx = len(self._vectors)
        vid = id if id is not None else idx
        v = np.asarray(vector, np.float32)
        self._vectors.append(v)
        self._ids.append(vid)
        self._id_to_idx[vid] = idx
        if payload:
            self._payloads[idx] = payload
            self._payload_index.add(idx, payload)
        self.index.add(v)
        return vid

    def insert_batch(self, vectors, ids=None, payloads=None):
        vecs = np.asarray(vectors, np.float32)
        start = len(self._vectors)
        out_ids = []
        for i, v in enumerate(vecs):
            vid = ids[i] if ids is not None else start + i
            self._vectors.append(v)
            self._ids.append(vid)
            self._id_to_idx[vid] = start + i
            if payloads is not None and payloads[i]:
                self._payloads[start + i] = payloads[i]
                self._payload_index.add(start + i, payloads[i])
            out_ids.append(vid)
        self.index.add_batch(vecs)
        return out_ids

    def search(self, query, k: int = 10, ef: int | None = None,
               with_vectors: bool = False,
               filter: "object | dict | None" = None) -> list[SearchResult]:
        """filter: FilterExpression or Qdrant-style dict (ruvector-filter
        role). Filtered search over-fetches from the index and
        post-filters payloads, widening until k survivors or the whole
        collection is scanned."""
        flt = None
        if filter is not None:
            from ruvector_tpu_torch.index.filter import (
                FilterExpression,
                matches,
                parse_qdrant_filter,
            )

            flt = (filter if isinstance(filter, FilterExpression)
                   else parse_qdrant_filter(filter))

        if flt is not None:
            # index-accelerated path (evaluator.rs candidate sets): when
            # the payload index bounds the matching ids tightly, score
            # exactly those candidates instead of over-fetching the ANN
            from ruvector_tpu_torch.index.filter import candidate_ids

            cand = candidate_ids(self._payload_index, flt)
            if cand is not None and len(cand) <= max(4 * k, len(self) // 4):
                return self._search_candidates(
                    np.asarray(query, np.float32), k, cand, flt,
                    with_vectors)

        fetch = k if flt is None else max(4 * k, 32)
        while True:
            ids, dists = self.index.search(
                np.asarray(query, np.float32), min(fetch, len(self)), ef)
            results = []
            for i, d in zip(ids, dists):
                if i < 0:
                    continue
                if flt is not None and not matches(
                        self._payloads.get(int(i)), flt):
                    continue
                if self.options.metric == "cosine":
                    score = 1.0 - d / 2.0   # normalized: d = 2 - 2 cos
                else:
                    score = -float(d)
                results.append(SearchResult(
                    id=self._ids[int(i)], score=float(score),
                    vector=self._vectors[int(i)] if with_vectors else None,
                    payload=self._payloads.get(int(i)),
                ))
                if len(results) >= k:
                    return results
            if flt is None or fetch >= len(self):
                return results
            fetch = min(fetch * 4, len(self))

    def _search_candidates(self, query, k, cand, flt, with_vectors):
        """Exact scoring over an index-bounded candidate id set."""
        from ruvector_tpu_torch.index.filter import matches

        idxs = [i for i in sorted(cand)
                if matches(self._payloads.get(i), flt)]
        if not idxs:
            return []
        mat = np.stack([self._vectors[i] for i in idxs])
        if self.options.metric == "cosine":
            qn = query / max(np.linalg.norm(query), 1e-12)
            mn = mat / np.maximum(
                np.linalg.norm(mat, axis=1, keepdims=True), 1e-12)
            scores = mn @ qn                      # == cos similarity
        else:
            scores = -np.sum((mat - query) ** 2, axis=1)  # -squared L2
        order = np.argsort(-scores)[:k]
        return [SearchResult(
            id=self._ids[idxs[j]], score=float(scores[j]),
            vector=self._vectors[idxs[j]] if with_vectors else None,
            payload=self._payloads.get(idxs[j]),
        ) for j in order]

    def get(self, vid) -> np.ndarray | None:
        idx = self._id_to_idx.get(vid)
        return self._vectors[idx] if idx is not None else None

    def features_matrix(self) -> torch.Tensor:
        return torch.from_numpy(np.stack(self._vectors)).to(self.device)

    def neighbor_graph(self):
        return self.index.to_neighbor_graph()
