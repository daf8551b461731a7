"""The query-feedback learning loop of BASELINE config 4: gradient updates
of a GNN re-ranker from search-result signals (port of the loop in
benchmarks/learned_recall_curve.py:56-210, where it is closures inside
`main()`; here plain functions on tensors with an explicit device and
seeds).

Per query: HNSW retrieves `ef` candidates on the raw vectors; the
RuvectorLayer re-ranker embeds each candidate over its kNN neighbours and
scores it as raw_cos + beta * gnn_cos (beta starts at 0, so the first
query ranks exactly like raw cosine); the feedback (which candidates share
the query's cluster, the click signal) drives one Adam step of an InfoNCE
loss on the re-ranker; and a SONA trajectory records the query. Recall@10
of the re-ranked candidates is read on a fixed held-out query set.

The update trains through the layer's plain slot route (K3 has no
backward); the held-out re-rank, which needs no gradient, takes the K3
route on the card. Corpus, labels and graph live on the loop's device;
a step takes only the candidate ids and the rewards from the host and
reads nothing back.
"""

from __future__ import annotations

import dataclasses
import math
import time

import numpy as np
import torch

from ruvector_tpu_torch.device import resolve_device
from ruvector_tpu_torch.graph.neighbors import NeighborGraph
from ruvector_tpu_torch.index.hnsw import HnswConfig, HnswIndex
from ruvector_tpu_torch.nn.ruvector_layer import RuvectorLayerConfig, ruvector_layer_apply
from ruvector_tpu_torch.sona.engine import SonaEngine
from ruvector_tpu_torch.sona.types import SonaConfig
from ruvector_tpu_torch.training.optimizers import (
    adam,
    apply_updates,
    requiring_grad,
    tree_grad,
    tree_map,
)
from ruvector_tpu_torch.training.schedulers import exponential_schedule


@dataclasses.dataclass(frozen=True)
class FeedbackConfig:
    """The protocol's constants (learned_recall_curve.py:56-60, 72, 76, 80,
    87-88, 114, 139-141, 151, 178, 200)."""

    n: int = 20_000                 # corpus rows
    dim: int = 64
    n_clusters: int = 64
    ef: int = 40                    # candidates a query
    topk: int = 10
    d_inf: int = 16                 # informative subspace: dims 0..d_inf-1
    sig_inf: float = 0.8
    sig_nui: float = 2.0            # nuisance dims dilute raw cosine
    checkpoints: tuple[int, ...] = (0, 1_000, 10_000, 100_000)
    hnsw_m: int = 16
    hnsw_ef_construction: int = 100
    search_ef: int = 64
    knn_k: int = 8                  # the re-ranker's graph: build_knn_graph's cosine kNN
    heads: int = 4
    lr: float = 1e-3
    transition_steps: int = 20_000  # lr = lr * decay_rate^(step / transition_steps)
    decay_rate: float = 0.3
    temperature: float = 0.2
    sona_flush: int = 64
    sona_quality: float = 0.3
    learn_every: int = 5_000        # SONA force_learn after every this many queries
    eval_queries: int = 400
    corpus_seed: int = 0
    eval_seed: int = 999
    stream_seed: int = 1

    def layer_config(self, use_pallas: bool = False) -> RuvectorLayerConfig:
        return RuvectorLayerConfig(self.dim, self.dim, heads=self.heads,
                                   use_pallas=use_pallas)


def _centers(cfg: FeedbackConfig, rng: np.random.Generator) -> np.ndarray:
    """The cluster centres: the corpus generator's first draw (:63-64)."""
    centers = np.zeros((cfg.n_clusters, cfg.dim), np.float32)
    centers[:, :cfg.d_inf] = 2.0 * rng.normal(size=(cfg.n_clusters, cfg.d_inf))
    return centers


def _noise(cfg: FeedbackConfig, rng: np.random.Generator, count: int) -> np.ndarray:
    noise = rng.normal(size=(count, cfg.dim)).astype(np.float32)
    noise[:, :cfg.d_inf] *= cfg.sig_inf
    noise[:, cfg.d_inf:] *= cfg.sig_nui
    return noise


def make_corpus(cfg: FeedbackConfig) -> tuple[np.ndarray, np.ndarray]:
    """(corpus [n, dim] float32, labels [n] int64), drawn as :62-69 draws
    them, so equal to the JAX script's arrays bit for bit."""
    rng = np.random.default_rng(cfg.corpus_seed)
    centers = _centers(cfg, rng)
    labels = rng.integers(0, cfg.n_clusters, size=cfg.n)
    return (centers[labels] + _noise(cfg, rng, cfg.n)).astype(np.float32), labels


def make_queries(cfg: FeedbackConfig, count: int, seed: int) -> tuple[np.ndarray, np.ndarray]:
    """(queries [count, dim] float32, their clusters [count]) as :143-149
    draws them around the corpus's centres."""
    centers = _centers(cfg, np.random.default_rng(cfg.corpus_seed))
    rng = np.random.default_rng(seed)
    clusters = rng.integers(0, cfg.n_clusters, count)
    return (centers[clusters] + _noise(cfg, rng, count)).astype(np.float32), clusters


def feedback_schedule(cfg: FeedbackConfig):
    """optax.exponential_decay(lr, transition_steps, decay_rate) without
    staircase (:87-88) as a step -> lr callable for `optimizers.adam`,
    which reads it at its count before the increment, as optax does:
    `schedulers.exponential_schedule` with gamma = decay_rate^(1 /
    transition_steps)."""
    return exponential_schedule(cfg.lr, cfg.decay_rate ** (1.0 / cfg.transition_steps))


def build_index(cfg: FeedbackConfig, corpus: np.ndarray, num_threads: int = 0,
                device=None) -> HnswIndex:
    """The candidate stage: HNSW on the raw vectors (m 16, ef_construction
    100, cosine; :72-73). num_threads > 1 links in parallel, as the JAX
    script does, so the graph then depends on the threads' order."""
    index = HnswIndex(HnswConfig(dim=cfg.dim, m=cfg.hnsw_m,
                                 ef_construction=cfg.hnsw_ef_construction), device=device)
    index.add_batch(corpus, num_threads=num_threads)
    return index


def subgraph_graph(cand_nbr_w: torch.Tensor) -> NeighborGraph:
    """The re-rank's graph over [..., ef, m] candidate edge weights (:96-106):
    for each query, ef candidate rows whose slots point at their m leaves,
    then ef * m leaf rows with every slot masked (index 0, weight 1).
    Queries stack: query i's rows start at i * (ef + ef * m), and its leaf
    slots point at its own first row, so each row computes what a
    per-query call computes."""
    *lead, ef, m = cand_nbr_w.shape
    count = math.prod(lead)
    rows = ef + ef * m
    dev = cand_nbr_w.device
    local = torch.arange(ef * m, dtype=torch.int32, device=dev).reshape(ef, m) + ef
    pad = torch.zeros((ef * m, m), dtype=torch.int32, device=dev)
    base = torch.arange(count, dtype=torch.int32, device=dev).reshape(count, 1, 1) * rows
    idx = torch.cat([local, pad])[None] + base
    mask = torch.cat([torch.ones((ef, m), device=dev), torch.zeros((ef * m, m), device=dev)])
    weight = torch.cat([cand_nbr_w.reshape(count, ef, m),
                        torch.ones((count, ef * m, m), device=dev)], dim=1)
    return NeighborGraph(nbr_idx=idx.reshape(-1, m),
                         nbr_mask=mask.expand(count, rows, m).reshape(-1, m),
                         edge_weight=weight.reshape(-1, m))


def subgraph_embed(params: dict, layer_cfg: RuvectorLayerConfig, cand_feats: torch.Tensor,
                   cand_nbr_feats: torch.Tensor, cand_nbr_w: torch.Tensor) -> torch.Tensor:
    """The candidates' embeddings over their 1-hop neighbourhoods (:93-107):
    cand_feats [..., ef, d], cand_nbr_feats [..., ef, m, d], cand_nbr_w
    [..., ef, m] -> [..., ef, D], one layer call for all queries."""
    *lead, ef, d = cand_feats.shape
    count = math.prod(lead)
    feats_all = torch.cat([cand_feats.reshape(count, ef, d),
                           cand_nbr_feats.reshape(count, -1, d)], dim=1)
    out = ruvector_layer_apply(params["layer"], layer_cfg, feats_all.reshape(-1, d),
                               subgraph_graph(cand_nbr_w))
    return out.reshape(count, -1, out.shape[-1])[:, :ef].reshape(*lead, ef, -1)


def blended_scores(params: dict, layer_cfg: RuvectorLayerConfig, q: torch.Tensor,
                   cand_feats: torch.Tensor, cand_nbr_feats: torch.Tensor,
                   cand_nbr_w: torch.Tensor) -> torch.Tensor:
    """raw_cos + beta * gnn_cos of the candidates against the query
    (:127-133): q [..., d] -> [..., ef]. Rows are divided by norm + 1e-8
    (an addend, as in the JAX script, not a clamp)."""
    emb = subgraph_embed(params, layer_cfg, cand_feats, cand_nbr_feats, cand_nbr_w)
    emb = emb / (torch.linalg.norm(emb, dim=-1, keepdim=True) + 1e-8)
    qn = (q / (torch.linalg.norm(q, dim=-1, keepdim=True) + 1e-8)).unsqueeze(-1)
    raw = cand_feats / (torch.linalg.norm(cand_feats, dim=-1, keepdim=True) + 1e-8)
    return torch.matmul(raw, qn).squeeze(-1) + params["beta"] * torch.matmul(emb, qn).squeeze(-1)


def feedback_loss(params: dict, layer_cfg: RuvectorLayerConfig, q: torch.Tensor,
                  cand_feats: torch.Tensor, cand_nbr_feats: torch.Tensor,
                  cand_nbr_w: torch.Tensor, rewards: torch.Tensor,
                  temperature: float = 0.2) -> torch.Tensor:
    """InfoNCE with the feedback as labels (:109-117): the rewarded
    candidates are the query's positives."""
    sims = blended_scores(params, layer_cfg, q, cand_feats, cand_nbr_feats,
                          cand_nbr_w) / temperature
    pos = torch.sum(rewards * (sims - torch.logsumexp(sims, dim=-1)))
    return -pos / torch.clamp(torch.sum(rewards), min=1.0)


def eval_scores(params: dict, layer_cfg: RuvectorLayerConfig, corpus: torch.Tensor,
                nbr_idx: torch.Tensor, nbr_w: torch.Tensor, queries: torch.Tensor,
                cands: torch.Tensor) -> torch.Tensor:
    """The blended scores [Q, ef] of every held-out query's candidates
    `cands` [Q, ef], all queries' subgraphs in one layer call."""
    ids = cands.long()
    with torch.no_grad():
        return blended_scores(params, layer_cfg, queries, corpus[ids],
                              corpus[nbr_idx[ids].long()], nbr_w[ids])


def eval_recall(params: dict, layer_cfg: RuvectorLayerConfig, corpus: torch.Tensor,
                labels: torch.Tensor, nbr_idx: torch.Tensor, nbr_w: torch.Tensor,
                queries: torch.Tensor, clusters: torch.Tensor, cands: torch.Tensor,
                topk: int = 10) -> tuple[float, float]:
    """(re-ranked recall@topk, HNSW-only recall@topk) on the held-out
    queries (:155-169): the share of each query's top-k in its cluster,
    the re-ranked top-k by the blended scores (ties to the earlier
    candidate), the HNSW-only one the index's own first k."""
    scores = eval_scores(params, layer_cfg, corpus, nbr_idx, nbr_w, queries, cands)
    order = torch.argsort(-scores, dim=1, stable=True)[:, :topk]
    ids = cands.long()
    hits_rr = labels[torch.gather(ids, 1, order)] == clusters[:, None]
    hits_raw = labels[ids[:, :topk]] == clusters[:, None]
    total = cands.shape[0] * topk
    return int(hits_rr.sum()) / total, int(hits_raw.sum()) / total


class FeedbackLoop:
    """The loop's state on one device: the re-ranker's params ({"beta",
    "layer"}), their Adam state and the SONA engine, beside the corpus,
    its labels and its kNN graph.

    One query's step (:185-202) is `update(q, cids, rewards)`, the
    re-ranker's Adam step on `loss`, then `record(q, cids, rewards)`, the
    SONA trajectory; `stream` runs a query stream through the index, both
    for each query; `eval_recall` reads recall on held-out queries,
    through K3 on the card."""

    def __init__(self, cfg: FeedbackConfig, corpus: np.ndarray, labels: np.ndarray,
                 graph: NeighborGraph, params: dict, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        dev = self.device
        self.corpus_host = np.asarray(corpus, np.float32)
        self.labels_host = np.asarray(labels)
        self.corpus = torch.from_numpy(self.corpus_host).to(dev)
        self.labels = torch.from_numpy(self.labels_host).to(dev)
        self.nbr_idx = graph.nbr_idx.to(dev).long()
        self.nbr_w = graph.edge_weight.to(dev)
        self.params = tree_map(lambda t: t.to(dev), params)
        self.layer_cfg = cfg.layer_config()
        self.eval_cfg = cfg.layer_config(use_pallas=dev.type == "cuda")
        self.opt = adam(feedback_schedule(cfg))
        self.opt_state = self.opt.init(self.params)
        self.sona = SonaEngine(config=SonaConfig(
            hidden_dim=cfg.dim, embedding_dim=cfg.dim, flush_threshold=cfg.sona_flush,
            quality_threshold=cfg.sona_quality), device=dev)
        self.steps = 0

    def loss(self, params: dict, q, cids: np.ndarray, rewards: np.ndarray) -> torch.Tensor:
        """feedback_loss of `params` on the query `q` ([dim], host array or
        tensor on the device), its candidate ids and their rewards (host
        arrays, the only data that crosses to the device)."""
        dev = self.device
        ids = torch.from_numpy(np.asarray(cids, np.int64)).to(dev, non_blocking=True)
        r = torch.from_numpy(np.asarray(rewards, np.float32)).to(dev, non_blocking=True)
        qt = torch.as_tensor(q, dtype=torch.float32).to(dev, non_blocking=True)
        return feedback_loss(params, self.layer_cfg, qt, self.corpus[ids],
                             self.corpus[self.nbr_idx[ids]], self.nbr_w[ids], r,
                             self.cfg.temperature)

    def update(self, q, cids: np.ndarray, rewards: np.ndarray) -> None:
        """One Adam step of `loss` on the query and its candidates."""
        req = requiring_grad(self.params)
        grads = tree_grad(self.loss(req, q, cids, rewards), req)
        with torch.no_grad():
            updates, self.opt_state = self.opt.update(grads, self.opt_state, self.params)
            self.params = apply_updates(self.params, updates)

    def record(self, q: np.ndarray, cids: np.ndarray, rewards: np.ndarray) -> None:
        """The query's SONA trajectory (host arrays; a force_learn after
        every `learn_every` queries), then the step count moves on."""
        traj = self.sona.begin_trajectory(q)
        rel = self.corpus_host[cids[rewards > 0]]
        if len(rel):
            traj.add_step(rel.mean(0) - q, np.zeros(1), float(rewards.mean()))
        self.sona.end_trajectory(traj, float(rewards[:self.cfg.topk].mean()))
        if self.steps % self.cfg.learn_every == self.cfg.learn_every - 1:
            self.sona.force_learn()
        self.steps += 1

    def rewards(self, cids: np.ndarray, cluster: int) -> np.ndarray:
        """The click signal: 1 where a candidate is in `cluster`."""
        return (self.labels_host[cids] == cluster).astype(np.float32)

    def stream(self, index: HnswIndex, queries: np.ndarray, clusters: np.ndarray,
               stop: int) -> dict:
        """Queries self.steps .. stop - 1 of the stream: each searched
        (k = ef at search_ef), rewarded by `clusters`, then stepped.
        Returns the host seconds of the searches, the updates and the SONA
        records; the card may still run the last updates."""
        start = self.steps
        q_dev = torch.from_numpy(np.ascontiguousarray(queries[start:stop])).to(self.device)
        seconds = {"search_s": 0.0, "update_s": 0.0, "sona_s": 0.0}
        for i in range(start, stop):
            t0 = time.perf_counter()
            cids, _ = index.search(queries[i], k=self.cfg.ef, ef=self.cfg.search_ef)
            rewards = self.rewards(cids, clusters[i])
            t1 = time.perf_counter()
            self.update(q_dev[i - start], cids, rewards)
            t2 = time.perf_counter()
            self.record(queries[i], cids, rewards)
            t3 = time.perf_counter()
            seconds["search_s"] += t1 - t0
            seconds["update_s"] += t2 - t1
            seconds["sona_s"] += t3 - t2
        return seconds

    def eval_recall(self, queries: np.ndarray, clusters: np.ndarray,
                    cands: np.ndarray) -> tuple[float, float]:
        """(re-ranked, HNSW-only) recall@topk of the current params on the
        held-out queries, their clusters and candidates [Q, ef]."""
        dev = self.device
        return eval_recall(self.params, self.eval_cfg, self.corpus, self.labels, self.nbr_idx,
                           self.nbr_w, torch.from_numpy(queries).to(dev),
                           torch.from_numpy(np.asarray(clusters)).to(dev),
                           torch.from_numpy(np.asarray(cands)).to(dev), self.cfg.topk)


