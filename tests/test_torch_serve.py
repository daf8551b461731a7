"""Parity of the port's serving path against the JAX package, on the CPU:
`softmax_temperature`, `differentiable_search`, `hierarchical_forward`,
the `QueryEngine` in all four modes (with the JAX engine's kNN graph and
JAX-initialised layers carried over), the flat index and the attention
re-rank on both of its routes (K8's plain version here, and the blockwise
flash attention) against JAX's XLA route. The JAX K8 route does not run on
the CPU (rerank.py passes no interpret flag).

Tolerances: ids equal (random data: no score ties); scores 1e-5 and
softmax weights 1e-6 (f32, sums in another order); 2e-4 for
`hierarchical_forward`, the single-node layer API's bound
(test_ruvector_layer.py); GNN embeddings 2e-5, the f32 layer bound
(test_block_dense_fused.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ruvector_tpu.graph import NeighborGraph as JGraph
from ruvector_tpu.graph import build_knn_graph as jbuild_knn
from ruvector_tpu.index.flat import FlatIndex as JFlat
from ruvector_tpu.nn.ruvector_layer import RuvectorLayerConfig as JCfg
from ruvector_tpu.nn.ruvector_layer import ruvector_layer_init as jinit
from ruvector_tpu.serve import differentiable_search as jdiff_search
from ruvector_tpu.serve import hierarchical_forward as jhier
from ruvector_tpu.serve import softmax_temperature as jsoftmax_t
from ruvector_tpu.serve.query import QueryEngine as JEngine
from ruvector_tpu.serve.query import QueryMode as JMode
from ruvector_tpu.serve.query import RuvectorQuery as JQuery
from ruvector_tpu.serve.rerank import attention_rerank as jrerank
from ruvector_tpu.serve.rerank import retrieve_and_rerank as jretrieve
from ruvector_tpu_torch.convert import params_from_numpy
from ruvector_tpu_torch.graph import NeighborGraph
from ruvector_tpu_torch.index import FlatIndex
from ruvector_tpu_torch.nn.ruvector_layer import RuvectorLayerConfig
from ruvector_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
from ruvector_tpu_torch.serve import (
    QueryEngine,
    QueryMode,
    RuvectorQuery,
    attention_rerank,
    differentiable_search,
    execute_query,
    hierarchical_forward,
    retrieve_and_rerank,
    softmax_temperature,
)

SCORE_TOL = 1e-5
WEIGHT_TOL = 1e-6
SINGLE_TOL = 2e-4
EMB_TOL = 2e-5


def _params(jparams):
    return params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), "cpu")


def _t(x):
    return torch.from_numpy(np.array(x))   # a writable copy: JAX's buffers are read-only


@pytest.mark.parametrize("temperature", [0.1, 1.0, 10.0])
def test_softmax_temperature_matches_jax(temperature):
    v = np.random.default_rng(0).normal(size=(4, 9)).astype(np.float32)
    got = softmax_temperature(_t(v), temperature).numpy()
    np.testing.assert_allclose(got, np.asarray(jsoftmax_t(jnp.asarray(v), temperature)),
                               atol=WEIGHT_TOL, rtol=0)
    np.testing.assert_allclose(got.sum(-1), 1.0, rtol=1e-5)


@pytest.mark.parametrize("batched", [False, True])
def test_differentiable_search_matches_jax(batched):
    rng = np.random.default_rng(1)
    q = rng.normal(size=(5, 8) if batched else (8,)).astype(np.float32)
    c = rng.normal(size=(30, 8)).astype(np.float32)
    jidx, jw = jdiff_search(jnp.asarray(q), jnp.asarray(c), k=4, temperature=0.5)
    idx, w = differentiable_search(_t(q), _t(c), k=4, temperature=0.5)
    assert idx.dtype == torch.int32 and idx.shape == tuple(jidx.shape)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), atol=WEIGHT_TOL, rtol=0)


def test_hierarchical_forward_matches_jax():
    rng = np.random.default_rng(1)
    d = 8
    query = rng.normal(size=(d,)).astype(np.float32)
    layers = [rng.normal(size=(n, d)).astype(np.float32) for n in (4, 12, 0)]
    jcfgs = [JCfg(input_dim=d, hidden_dim=d, heads=2)] * 3
    jparams = [jinit(jax.random.key(i), jcfgs[i]) for i in range(3)]
    want = np.asarray(jhier(jnp.asarray(query), [jnp.asarray(x) for x in layers], jparams,
                            jcfgs))
    cfgs = [RuvectorLayerConfig(input_dim=d, hidden_dim=d, heads=2)] * 3
    got = hierarchical_forward(_t(query), [_t(x) for x in layers],
                               [_params(p) for p in jparams], cfgs)
    assert got.shape == (d,)
    np.testing.assert_allclose(got.numpy(), want, atol=SINGLE_TOL, rtol=0)


def _engines(n, d, heads, use_pallas, seed=2):
    """test_serve.py's engine: features N(0, 1), the JAX k=4 kNN graph, and
    two JAX-initialised layers, in both packages on the same data."""
    rng = np.random.default_rng(seed)
    feats = rng.normal(size=(n, d)).astype(np.float32)
    jg = jbuild_knn(jnp.asarray(feats), k=4)
    graph = NeighborGraph(_t(jg.nbr_idx), _t(jg.nbr_mask), _t(jg.edge_weight))
    jcfg = JCfg(input_dim=d, hidden_dim=d, heads=heads, use_pallas=use_pallas)
    cfg = RuvectorLayerConfig(input_dim=d, hidden_dim=d, heads=heads, use_pallas=use_pallas)
    jparams = [jinit(jax.random.key(i), jcfg) for i in range(2)]
    return (JEngine(jnp.asarray(feats), jg, jparams, [jcfg] * 2),
            QueryEngine(_t(feats), graph, [_params(p) for p in jparams], [cfg] * 2), feats, rng)


def _same_result(got, want, emb_tol=EMB_TOL):
    assert got.nodes == [int(x) for x in want.nodes]
    np.testing.assert_allclose(got.scores, want.scores, atol=SCORE_TOL, rtol=0)
    for part, tol in (("embeddings", emb_tol), ("attention", WEIGHT_TOL)):
        g, w = getattr(got, part), getattr(want, part)
        assert (g is None) == (w is None)
        if g is not None:
            np.testing.assert_allclose(g, np.asarray(w), atol=tol, rtol=0)
    assert (got.subgraph is None) == (want.subgraph is None)
    if got.subgraph is not None:
        assert got.subgraph.nodes == want.subgraph.nodes
        assert [(u, v) for u, v, _ in got.subgraph.edges] == \
            [(u, v) for u, v, _ in want.subgraph.edges]
        np.testing.assert_allclose([w for _, _, w in got.subgraph.edges],
                                   [w for _, _, w in want.subgraph.edges], atol=1e-6, rtol=0)
    assert got.latency_ms > 0


_MODES = [("vector", dict(mode="VECTOR_SEARCH", k=3)),
          ("differentiable", dict(mode="DIFFERENTIABLE_SEARCH", k=4, temperature=0.5)),
          ("neural", dict(mode="NEURAL_SEARCH", k=5, ef=20, return_embeddings=True,
                          return_attention=True)),
          ("neural_depth1", dict(mode="NEURAL_SEARCH", k=5, ef=20, gnn_depth=1,
                                 temperature=0.3, return_attention=True)),
          ("subgraph", dict(mode="SUBGRAPH_EXTRACTION", k=3, gnn_depth=1)),
          ("subgraph_depth2", dict(mode="SUBGRAPH_EXTRACTION", k=2, gnn_depth=2))]


@pytest.mark.parametrize("name,kw", _MODES, ids=[m[0] for m in _MODES])
@pytest.mark.parametrize("width", ["d8_h2", "d32_h4_pallas"])
def test_query_engine_matches_jax(width, name, kw):
    """Exact rows and perturbed ones; the d=32 engines run the K3 route on
    both sides (JAX's Pallas kernel in interpret mode, the port's plain
    version). The second neural query reuses the GNN cache on both sides."""
    d, heads, use_pallas = (8, 2, False) if width == "d8_h2" else (32, 4, True)
    jeng, eng, feats, rng = _engines(50, d, heads, use_pallas)
    mode = kw["mode"]
    for row, noise in ((7, 0.0), (3, 0.3)):
        vec = (feats[row] + noise * rng.normal(size=d)).astype(np.float32)
        want = jeng.execute(JQuery(vector=vec, **{**kw, "mode": JMode[mode]}))
        got = eng.execute(RuvectorQuery(vector=vec, **{**kw, "mode": QueryMode[mode]}))
        _same_result(got, want)
        if noise == 0.0 and mode != "NEURAL_SEARCH":
            assert got.nodes[0] == row


def test_query_engine_gnn_cache_is_not_keyed_by_depth():
    """As in the JAX package: the first neural query's depth fixes the
    cached embeddings until invalidate_cache."""
    jeng, eng, feats, _ = _engines(50, 8, 2, False)
    for depth in (1, 2):
        kw = dict(mode="NEURAL_SEARCH", k=5, ef=20, gnn_depth=depth, return_embeddings=True)
        want = jeng.execute(JQuery(vector=feats[5], **{**kw, "mode": JMode.NEURAL_SEARCH}))
        got = eng.execute(RuvectorQuery(vector=feats[5], **{**kw, "mode": QueryMode.NEURAL_SEARCH}))
        _same_result(got, want)
    cached = eng._gnn_cache
    eng.invalidate_cache()
    eng.execute(RuvectorQuery(vector=feats[5], mode=QueryMode.NEURAL_SEARCH, gnn_depth=2))
    assert not torch.equal(cached, eng._gnn_cache)   # depth 1 cached, then depth 2


def _ring_graphs():
    """Two graphs on the same 4 nodes: g1 links 0-1 and 2-3, g2 links 0-2
    and 1-3 (one neighbour each)."""
    graphs = []
    for nbr in ([[1], [0], [3], [2]], [[2], [3], [0], [1]]):
        idx = np.asarray(nbr, np.int32)
        mask = np.ones((4, 1), np.float32)
        w = np.asarray([[0.5], [0.25], [0.75], [1.0]], np.float32)
        graphs.append((JGraph(jnp.asarray(idx), jnp.asarray(mask), jnp.asarray(w)),
                       NeighborGraph(_t(idx), _t(mask), _t(w))))
    return graphs


@pytest.mark.parametrize("invalidate", [False, True])
def test_query_engine_walks_the_graph_it_holds_now(invalidate):
    """After `engine.graph = g2` the subgraph mode walks g2, as the JAX
    engine does, with or without invalidate_cache()."""
    feats = np.eye(4, dtype=np.float32)
    (jg1, g1), (jg2, g2) = _ring_graphs()
    jeng, eng = JEngine(jnp.asarray(feats), jg1), QueryEngine(_t(feats), g1)
    kw = dict(vector=feats[0], k=1, gnn_depth=1)
    for jg, g in ((jg1, g1), (jg2, g2)):
        jeng.graph, eng.graph = jg, g
        if invalidate:
            jeng.invalidate_cache()
            eng.invalidate_cache()
        want = jeng.execute(JQuery(mode=JMode.SUBGRAPH_EXTRACTION, **kw))
        got = eng.execute(RuvectorQuery(mode=QueryMode.SUBGRAPH_EXTRACTION, **kw))
        _same_result(got, want)
        assert got.subgraph.nodes == ([0, 1] if g is g1 else [0, 2])


def test_execute_query_one_shot():
    _, eng, feats, _ = _engines(50, 8, 2, False)
    res = execute_query(RuvectorQuery(vector=feats[11], k=3), eng.features, eng.graph)
    assert res.nodes[0] == 11 and len(res.nodes) == 3
    np.testing.assert_allclose(res.scores[0], 1.0, rtol=1e-5)


@pytest.mark.parametrize("metric", ["cosine", "euclidean"])
def test_flat_index_matches_jax(metric):
    rng = np.random.default_rng(0)
    data = rng.normal(size=(300, 24)).astype(np.float32)
    queries = np.concatenate([data[[42, 7]], rng.normal(size=(6, 24)).astype(np.float32)])
    jidx, idx = JFlat(dim=24, metric=metric), FlatIndex(dim=24, metric=metric, device="cpu")
    for part in (data[:100], data[100:]):           # the device copy is rebuilt on add
        jidx.add_batch(part)
        idx.add_batch(part)
        jids, jd = jidx.search_batch(queries, k=5)
        ids, dists = idx.search_batch(queries, k=5)
        assert ids.dtype == np.int32 and dists.dtype == np.float32
        np.testing.assert_array_equal(ids, jids)
        np.testing.assert_allclose(dists, jd, atol=1e-5, rtol=0)
    assert len(idx) == 300 and ids[0, 0] == 42 and ids[1, 0] == 7
    one_id, one_d = idx.search(data[42], k=3)
    assert one_id[0] == 42 and one_d[0] < 1e-5


def test_flat_index_pads_when_k_exceeds_the_corpus():
    rng = np.random.default_rng(1)
    data = rng.normal(size=(4, 8)).astype(np.float32)
    jidx, idx = JFlat(dim=8), FlatIndex(dim=8, device="cpu")
    jidx.add_batch(data)
    idx.add_batch(data)
    jids, jd = jidx.search_batch(data[:2], k=6)
    ids, dists = idx.search_batch(data[:2], k=6)
    np.testing.assert_array_equal(ids, jids)
    assert (ids[:, 4:] == -1).all() and np.isinf(dists[:, 4:]).all()
    np.testing.assert_allclose(dists[:, :4], jd[:, :4], atol=1e-5, rtol=0)


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("ef", [64, 256])
def test_attention_rerank_matches_jax(ef, use_pallas):
    """Against JAX's XLA route (its only route off the TPU); the port takes
    either route as asked: K8 (its plain version for CPU tensors) or the
    blockwise flash attention. ef=256 is K8's threshold on the card."""
    rng = np.random.default_rng(1)
    q = rng.normal(size=(4, 32)).astype(np.float32)
    pool = rng.normal(size=(4, ef, 32)).astype(np.float32)
    pool_ids = rng.integers(0, 1000, size=(4, ef)).astype(np.int64)
    jids, jscores = jrerank(jnp.asarray(q), jnp.asarray(pool), jnp.asarray(pool_ids), k=10,
                            temperature=0.7, use_pallas=False)
    reset_launch_counts()
    ids, scores = attention_rerank(_t(q), _t(pool), _t(pool_ids), k=10, temperature=0.7,
                                   use_pallas=use_pallas)
    assert launch_counts()["flash_neighbor_attention"] == 0   # CPU tensors: no launch
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    np.testing.assert_allclose(scores.numpy(), np.asarray(jscores), atol=SCORE_TOL, rtol=0)


@pytest.mark.parametrize("ef", [256, 32])
def test_retrieve_and_rerank_matches_jax(ef):
    """At ef=256 (the default, K8's threshold on the card) and ef=32, against
    JAX's XLA route (its default off the TPU); a CPU corpus takes the flash
    route."""
    rng = np.random.default_rng(0)
    feats = rng.normal(size=(400, 16)).astype(np.float32)
    queries = np.concatenate([feats[[3, 77]], rng.normal(size=(3, 16)).astype(np.float32)])
    jids, jscores = jretrieve(queries, jnp.asarray(feats), ef=ef, k=5)
    ids, scores = retrieve_and_rerank(queries, _t(feats), ef=ef, k=5)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    np.testing.assert_allclose(scores.numpy(), np.asarray(jscores), atol=SCORE_TOL, rtol=0)
    assert int(ids[0, 0]) == 3 and int(ids[1, 0]) == 77
    assert (np.diff(scores.numpy(), axis=1) <= 1e-6).all()
