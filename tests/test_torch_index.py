"""The port's indexes (ruvector_tpu_torch/index) against the JAX package's:
tests/test_index.py and tests/test_filter.py case for case, and
tests/test_end_to_end.py's index -> GNN -> search pipeline.

A serial HNSW build is deterministic and both packages build the same
C++ with the same flags, so graphs, levels, ids and distances are held
equal bit for bit; a threaded build is not deterministic, so only its
recall is held. VectorDB results are held equal (ids, scores, payloads)
with and without filters, by the candidate route and the over-fetch
route. The hyperbolic index gives equal ids and distances at f32 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ruvector_tpu.graph import knn_graph_numpy
from ruvector_tpu.index import DbOptions as JDbOptions
from ruvector_tpu.index import HnswConfig as JHnswConfig
from ruvector_tpu.index import HnswIndex as JHnswIndex
from ruvector_tpu.index import HyperbolicIndex as JHyperbolicIndex
from ruvector_tpu.index import VectorDB as JVectorDB
from ruvector_tpu.index.filter import FilterExpression as JF
from ruvector_tpu.index.filter import candidate_ids as jcandidate_ids
from ruvector_tpu.index.filter import matches as jmatches
from ruvector_tpu.index.hyperbolic_hnsw import HyperbolicConfig as JHyperbolicConfig
from ruvector_tpu.models import ruvector_net_apply as jruvector_net_apply
from ruvector_tpu.models import ruvector_net_init as jruvector_net_init
from ruvector_tpu.nn import ruvector_layer_init as jruvector_layer_init
from ruvector_tpu.serve import hierarchical_forward as jhierarchical_forward
from ruvector_tpu_torch.convert import params_from_numpy
from ruvector_tpu_torch.index import (
    DbOptions,
    FlatIndex,
    HnswConfig,
    HnswIndex,
    HyperbolicIndex,
    PayloadIndex,
    VectorDB,
    parse_qdrant_filter,
)
from ruvector_tpu_torch.index.filter import FilterExpression as F
from ruvector_tpu_torch.index.filter import candidate_ids, matches
from ruvector_tpu_torch.index.hyperbolic_hnsw import HyperbolicConfig
from ruvector_tpu_torch.models import RuvectorNetConfig, ruvector_net_apply
from ruvector_tpu_torch.nn import RuvectorLayerConfig
from ruvector_tpu_torch.serve import hierarchical_forward

CPU = "cpu"
F32_TOL = 1e-5


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _both_hnsw(cfg_kw, data, num_threads=0):
    port = HnswIndex(HnswConfig(**cfg_kw), device=CPU)
    jax_idx = JHnswIndex(JHnswConfig(**cfg_kw))
    port.add_batch(data, num_threads=num_threads)
    jax_idx.add_batch(data, num_threads=num_threads)
    return port, jax_idx


def _same_results(got, want, atol=0.0):
    assert [r.id for r in got] == [r.id for r in want]
    assert [r.payload for r in got] == [r.payload for r in want]
    np.testing.assert_allclose([r.score for r in got], [r.score for r in want], atol=atol,
                               rtol=0)


def _recall(idx, data, gt_idx, queries):
    hits = 0
    for q in queries:
        ids, _ = idx.search(data[q], k=11)   # includes self
        got = {int(i) for i in ids if i >= 0 and i != q}
        hits += len(got & set(gt_idx[q][:10].tolist()))
    return hits / (10 * len(queries))


# --- tests/test_index.py ----------------------------------------------------

def test_hnsw_exact_self_search():
    data = np.random.default_rng(0).normal(size=(200, 32)).astype(np.float32)
    port, jidx = _both_hnsw(dict(dim=32, metric="l2"), data)
    assert len(port) == 200
    ids, dists = port.search(data[17], k=1)
    assert ids[0] == 17 and dists[0] < 1e-9
    jids, jdists = jidx.search(data[17], k=1)
    np.testing.assert_array_equal(ids, jids)
    np.testing.assert_array_equal(dists, jdists)


def test_hnsw_serial_build_equals_jax():
    """Serial build: the level-0 graph, the levels, ids and distances of a
    batch search equal the JAX package's bit for bit."""
    rng = np.random.default_rng(1)
    data = rng.normal(size=(1000, 16)).astype(np.float32)
    port, jidx = _both_hnsw(dict(dim=16, metric="cosine", m=16, ef_construction=100,
                                 ef_search=100), data)
    gt_idx, _ = knn_graph_numpy(data, k=10, metric="cosine")
    assert _recall(port, data, gt_idx, rng.integers(0, 1000, size=50)) > 0.85
    g, jg = port.to_neighbor_graph(), jidx.to_neighbor_graph()
    np.testing.assert_array_equal(g.nbr_idx.numpy(), np.asarray(jg.nbr_idx))
    np.testing.assert_array_equal(g.nbr_mask.numpy(), np.asarray(jg.nbr_mask))
    np.testing.assert_array_equal(g.edge_weight.numpy(), np.asarray(jg.edge_weight))
    for a, b in zip(port.level_nodes(), jidx.level_nodes(), strict=True):
        np.testing.assert_array_equal(a, b)
    queries = rng.normal(size=(64, 16)).astype(np.float32)
    for got, want in zip(port.search_batch(queries, k=10), jidx.search_batch(queries, k=10)):
        np.testing.assert_array_equal(got, want)


def test_hnsw_neighbor_graph_export():
    data = np.random.default_rng(2).normal(size=(100, 8)).astype(np.float32)
    port, jidx = _both_hnsw(dict(dim=8, m=8), data)
    g = port.to_neighbor_graph()
    assert g.num_nodes == 100 and g.nbr_idx.device.type == "cpu"
    assert float(g.degrees().mean()) > 1
    assert int(g.nbr_idx[g.nbr_mask > 0].max()) < 100
    assert torch.equal(g.edge_weight, g.nbr_mask)
    np.testing.assert_array_equal(g.nbr_idx.numpy(), np.asarray(jidx.to_neighbor_graph().nbr_idx))


def test_vector_db_insert_search():
    vecs = np.random.default_rng(3).normal(size=(50, 8)).astype(np.float32)
    db, jdb = VectorDB(DbOptions(dimensions=8), device=CPU), JVectorDB(JDbOptions(dimensions=8))
    payloads = [{"i": i} for i in range(50)]
    ids = db.insert_batch(vecs, payloads=payloads)
    assert ids == jdb.insert_batch(vecs, payloads=payloads)
    res = db.search(vecs[10], k=3, with_vectors=True)
    assert res[0].id == ids[10] and res[0].score > 0.99 and res[0].payload == {"i": 10}
    np.testing.assert_allclose(res[0].vector, vecs[10])
    _same_results(res, jdb.search(vecs[10], k=3, with_vectors=True))
    assert db.insert(vecs[0] + 0.001, id="custom") == "custom"
    assert db.get("custom") is not None and len(db) == 51
    feats = db.features_matrix()
    assert feats.device.type == "cpu" and feats.shape == (51, 8)


def _hyper_points(rng, n, d, scale):
    return scale * rng.normal(size=(n, d)).astype(np.float32)


def _same_hyper(got, want):
    assert [i for i, _ in got] == [i for i, _ in want]
    np.testing.assert_allclose([d for _, d in got], [d for _, d in want], rtol=F32_TOL,
                               atol=F32_TOL)


def test_hyperbolic_tangent_pruning_matches_exact():
    rng = np.random.default_rng(4)
    idx = HyperbolicIndex(HyperbolicConfig(dim=8, prune_candidates=32), device=CPU)
    jidx = JHyperbolicIndex(JHyperbolicConfig(dim=8, prune_candidates=32))
    pts = _hyper_points(rng, 200, 8, 0.1)
    idx.insert_batch(pts)
    jidx.insert_batch(pts)
    q = 0.1 * rng.normal(size=8).astype(np.float32)
    pruned, exact = idx.search(q, k=5), idx.search_exact(q, k=5)
    assert len({i for i, _ in pruned} & {i for i, _ in exact}) >= 4
    assert [d for _, d in pruned] == sorted(d for _, d in pruned)
    _same_hyper(pruned, jidx.search(q, k=5))
    _same_hyper(exact, jidx.search_exact(q, k=5))


def test_hyperbolic_self_match():
    idx = HyperbolicIndex(HyperbolicConfig(dim=4), device=CPU)
    jidx = JHyperbolicIndex(JHyperbolicConfig(dim=4))
    pts = 0.3 * np.eye(4, dtype=np.float32)
    idx.insert_batch(pts)
    jidx.insert_batch(pts)
    res = idx.search(pts[2], k=1)
    assert res[0][0] == 2 and res[0][1] < 1e-4
    _same_hyper(res, jidx.search(pts[2], k=1))
    assert idx.insert(0.1 * np.ones(4, np.float32)) == jidx.insert(0.1 * np.ones(4, np.float32))
    _same_hyper(idx.search(pts[1], k=5), jidx.search(pts[1], k=5))


def test_hyperbolic_ties_keep_index_order():
    """Equal distances: a stable sort keeps index order in both stages, as
    jnp.argsort does. Four copies of each of 8 points tie in groups."""
    rng = np.random.default_rng(11)
    base = _hyper_points(rng, 8, 6, 0.2)
    pts = np.repeat(base, 4, axis=0)
    idx = HyperbolicIndex(HyperbolicConfig(dim=6, prune_candidates=12), device=CPU)
    jidx = JHyperbolicIndex(JHyperbolicConfig(dim=6, prune_candidates=12))
    idx.insert_batch(pts)
    jidx.insert_batch(pts)
    for q in (base[3], base[5] + 0.01):
        got, exact = idx.search(q, k=10), idx.search_exact(q, k=10)
        _same_hyper(got, jidx.search(q, k=10))
        _same_hyper(exact, jidx.search_exact(q, k=10))
        first = [i for i, _ in exact[:4]]
        assert first == sorted(first) and len({i // 4 for i in first}) == 1


def test_hnsw_levels_and_hierarchical_forward():
    d = 16
    data = np.random.default_rng(7).normal(size=(300, d)).astype(np.float32)
    port, jidx = _both_hnsw(dict(dim=d, m=8, seed=3), data)
    levels = port.level_nodes()
    sizes = [len(lv) for lv in levels]
    assert sizes[-1] == 300 and all(a <= b for a, b in zip(sizes, sizes[1:]))
    for a, b in zip(levels, jidx.level_nodes(), strict=True):
        np.testing.assert_array_equal(a, b)
    layer_embs = [data[lv] for lv in levels if len(lv) > 0]
    cfgs = [RuvectorLayerConfig(input_dim=d, hidden_dim=d, heads=2) for _ in layer_embs]
    jparams = [jruvector_layer_init(jax.random.key(i), c) for i, c in enumerate(cfgs)]
    want = jhierarchical_forward(jnp.asarray(data[5]), [jnp.asarray(e) for e in layer_embs],
                                 jparams, cfgs)
    out = hierarchical_forward(torch.from_numpy(data[5]),
                               [torch.from_numpy(e) for e in layer_embs],
                               [params_from_numpy(_np_tree(p), device=CPU) for p in jparams],
                               cfgs)
    assert out.shape == (d,) and bool(torch.isfinite(out).all())
    np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=F32_TOL, rtol=0)


def test_hnsw_parallel_insert_recall_matches_serial():
    rng = np.random.default_rng(3)
    data = rng.normal(size=(1500, 16)).astype(np.float32)
    gt_idx, _ = knn_graph_numpy(data, k=10, metric="cosine")
    queries = rng.integers(0, 1500, size=50)
    par = HnswIndex(HnswConfig(dim=16, metric="cosine", m=16, ef_construction=100,
                               ef_search=100), device=CPU)
    par.add_batch(data, num_threads=4)
    assert len(par) == 1500 and _recall(par, data, gt_idx, queries) > 0.85
    qs = data[queries]
    ids_s, d_s = par.search_batch(qs, k=10)
    ids_p, d_p = par.search_batch(qs, k=10, num_threads=4)
    np.testing.assert_array_equal(ids_s, ids_p)
    np.testing.assert_allclose(d_s, d_p)


def test_hnsw_concurrent_insert_and_search_stress():
    """Parallel inserts racing parallel searches from Python threads
    (ctypes releases the interpreter lock)."""
    import threading

    rng = np.random.default_rng(7)
    d = 16
    base = rng.normal(size=(500, d)).astype(np.float32)
    extra = rng.normal(size=(500, d)).astype(np.float32)
    queries = rng.normal(size=(400, d)).astype(np.float32)
    idx = HnswIndex(HnswConfig(dim=d, m=8, ef_construction=50), device=CPU)
    idx.add_batch(base)
    errors = []

    def inserter():
        try:
            idx.add_batch(extra, num_threads=2)
        except Exception as e:            # pragma: no cover
            errors.append(e)

    def searcher():
        try:
            for _ in range(4):
                ids, dists = idx.search_batch(queries, k=5, num_threads=2)
                valid = ids >= 0
                assert ids.shape == (400, 5) and np.all(ids[valid] < 1000)
                assert np.all(np.isfinite(dists[valid]))
        except Exception as e:            # pragma: no cover
            errors.append(e)

    threads = [threading.Thread(target=inserter)] + [
        threading.Thread(target=searcher) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads) and not errors
    assert len(idx) == 1000
    assert idx.search(base[17], k=1)[1][0] < 1e-6


def test_flat_index_exact_and_vector_db_integration():
    data = np.random.default_rng(0).normal(size=(300, 24)).astype(np.float32)
    idx = FlatIndex(dim=24, metric="cosine", device=CPU)
    idx.add_batch(data)
    ids, dists = idx.search(data[42], k=3)
    assert ids[0] == 42 and dists[0] < 1e-5
    dn = data / np.linalg.norm(data, axis=1, keepdims=True)
    got, _ = idx.search_batch(data[:10], k=1)
    np.testing.assert_array_equal(got[:, 0], np.argmax(dn[:10] @ dn.T, axis=1))
    db = VectorDB(DbOptions(dimensions=24, index_type="flat"), device=CPU)
    jdb = JVectorDB(JDbOptions(dimensions=24, index_type="flat"))
    names = [f"v{i}" for i in range(50)]
    db.insert_batch(data[:50], ids=names)
    jdb.insert_batch(data[:50], ids=names)
    res = db.search(data[7], k=4)
    assert res[0].id == "v7"
    _same_results(res, jdb.search(data[7], k=4), atol=F32_TOL)


def test_recall_gate_reference_operating_point():
    """BASELINE.md row 1's configuration (m=32, efc=200, ef=100, 384-d) on
    the clustered distribution, at tests/test_index.py's 4k points: a
    threaded build, so recall@10 against exact search is held, >= 0.98."""
    n, d, nq = 4_000, 384, 120
    rng = np.random.default_rng(0)
    centers = rng.normal(size=(60, d)).astype(np.float32) * 3.0
    base = (centers[rng.integers(0, 60, n)] + rng.normal(size=(n, d))).astype(np.float32)
    queries = (centers[rng.integers(0, 60, nq)] + rng.normal(size=(nq, d))).astype(np.float32)
    idx = HnswIndex(HnswConfig(dim=d, m=32, ef_construction=200), device=CPU)
    idx.add_batch(base, num_threads=4)
    bn = base / np.linalg.norm(base, axis=1, keepdims=True)
    qn = queries / np.linalg.norm(queries, axis=1, keepdims=True)
    truth = np.argsort(-(qn @ bn.T), axis=1)[:, :10]
    ids, _ = idx.search_batch(queries, k=10, ef=100, num_threads=4)
    hits = sum(len(set(a.tolist()) & set(b.tolist())) for a, b in zip(ids, truth))
    assert hits / (nq * 10) >= 0.98


def test_save_load_round_trip_across_packages(tmp_path):
    """A directory written by either package loads in the other, and the
    reloaded index answers as the original."""
    data = np.random.default_rng(9).normal(size=(300, 16)).astype(np.float32)
    port, jidx = _both_hnsw(dict(dim=16, m=8, seed=5), data)
    port.save(tmp_path / "port", data)
    jidx.save(tmp_path / "jax", data)
    assert (tmp_path / "port" / "config.json").read_text() == \
        (tmp_path / "jax" / "config.json").read_text()
    from_jax, vecs = HnswIndex.load(tmp_path / "jax", device=CPU)
    from_port, _ = JHnswIndex.load(tmp_path / "port")
    np.testing.assert_array_equal(vecs, data)
    want = port.search_batch(data[:20], k=5)
    for got in (from_jax.search_batch(data[:20], k=5), from_port.search_batch(data[:20], k=5)):
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])


# --- tests/test_filter.py ---------------------------------------------------

def test_comparison_and_logic_ops():
    p = {"age": 30, "name": "Alice", "tags": ["a", "b"], "score": 0.5}
    cases = [
        (F.eq("age", 30), JF.eq("age", 30), True), (F.eq("age", 31), JF.eq("age", 31), False),
        (F.ne("name", "Bob"), JF.ne("name", "Bob"), True),
        (F.gt("age", 29), JF.gt("age", 29), True), (F.gt("age", 30), JF.gt("age", 30), False),
        (F.gte("age", 30), JF.gte("age", 30), True), (F.lte("age", 30), JF.lte("age", 30), True),
        (F.range("score", gte=0.0, lt=1.0), JF.range("score", gte=0.0, lt=1.0), True),
        (F.range("score", gt=0.5), JF.range("score", gt=0.5), False),
        (F.in_values("tags", ["b", "z"]), JF.in_values("tags", ["b", "z"]), True),
        (F.in_values("name", ["Alice", "Bob"]), JF.in_values("name", ["Alice", "Bob"]), True),
        (F.match_text("name", "lic"), JF.match_text("name", "lic"), True),
        (F.and_([F.eq("age", 30), F.exists("name")]),
         JF.and_([JF.eq("age", 30), JF.exists("name")]), True),
        (F.or_([F.eq("age", 99), F.eq("name", "Alice")]),
         JF.or_([JF.eq("age", 99), JF.eq("name", "Alice")]), True),
        (F.not_(F.eq("age", 99)), JF.not_(JF.eq("age", 99)), True),
        (F.is_null("missing"), JF.is_null("missing"), True),
        (F.is_null("age"), JF.is_null("age"), False),
        (F.gt("name", 5), JF.gt("name", 5), False),
    ]
    for f, jf, want in cases:
        assert matches(p, f) is want and jmatches(p, jf) is want, f
    assert not matches(None, F.eq("x", 1))


def test_geo_filters():
    sf = {"loc": {"lat": 37.7749, "lon": -122.4194}}
    nyc = {"loc": {"lat": 40.7128, "lon": -74.0060}}
    near_sf = F.geo_radius("loc", 37.77, -122.42, 5_000)
    assert matches(sf, near_sf) and not matches(nyc, near_sf)
    bbox = F.geo_bounding_box("loc", (41.0, -75.0), (40.0, -73.0))
    assert matches(nyc, bbox) and not matches(sf, bbox)
    assert jmatches(sf, JF.geo_radius("loc", 37.77, -122.42, 5_000))


def test_parse_qdrant_filter():
    spec = {"must": [{"key": "city", "match": {"value": "sf"}},
                     {"key": "age", "range": {"gte": 18, "lt": 65}}],
            "must_not": [{"key": "banned", "match": {"value": True}}]}
    f = parse_qdrant_filter(spec)
    from ruvector_tpu.index.filter import parse_qdrant_filter as jparse

    assert repr(f) == repr(jparse(spec))
    assert matches({"city": "sf", "age": 30}, f)
    assert not matches({"city": "sf", "age": 70}, f)
    assert not matches({"city": "sf", "age": 30, "banned": True}, f)
    f2 = parse_qdrant_filter({"should": [{"key": "t", "match": {"any": ["x", "y"]}},
                                         {"key": "v", "match": {"text": "ell"}}]})
    assert matches({"t": "x"}, f2) and matches({"v": "hello"}, f2)
    assert not matches({"t": "z", "v": "nope"}, f2)
    with pytest.raises(ValueError):
        parse_qdrant_filter({})


def test_payload_index_candidates():
    idx = PayloadIndex()
    for i in range(100):
        idx.add(i, {"parity": "even" if i % 2 == 0 else "odd", "v": i})
    assert idx.ids_eq("parity", "even") == set(range(0, 100, 2))
    assert idx.ids_in("parity", ["odd"]) == set(range(1, 100, 2))
    assert idx.ids_range("v", gte=10, lt=13) == {10, 11, 12}
    assert idx.ids_range("v", gt=97) == {98, 99}
    assert idx.ids_range("missing", gte=0) == set()


def _filter_dbs(n, payload, seed, **opts):
    rng = np.random.default_rng(seed)
    db = VectorDB(DbOptions(dimensions=8, **opts), device=CPU)
    jdb = JVectorDB(JDbOptions(dimensions=8, **opts))
    for i in range(n):
        v = rng.normal(size=8).astype(np.float32)
        db.insert(v, id=i, payload=payload(i))
        jdb.insert(v, id=i, payload=payload(i))
    return db, jdb, rng.normal(size=8).astype(np.float32)


@pytest.mark.parametrize("index_type", ["flat", "hnsw"])
def test_vector_db_filtered_search(index_type):
    db, jdb, q = _filter_dbs(200, lambda i: {"group": i % 4, "score": float(i)}, 0,
                             index_type=index_type)
    flt = {"must": [{"key": "group", "match": {"value": 2}}]}
    res = db.search(q, k=5, filter=flt)
    assert len(res) == 5 and all(r.payload["group"] == 2 for r in res)
    best2 = [r.id for r in db.search(q, k=200) if r.payload["group"] == 2][:5]
    assert [r.id for r in res] == best2
    _same_results(res, jdb.search(q, k=5, filter=flt), atol=F32_TOL)
    _same_results(db.search(q, k=7), jdb.search(q, k=7), atol=F32_TOL)
    assert db.search(q, k=5, filter={"must": [{"key": "group", "match": {"value": 99}}]}) == []


def test_filtered_search_of_the_http_route():
    """tests/test_filter.py's HTTP search with a Qdrant filter, through the
    VectorDB the route serves (the port's server is not ported yet)."""
    for db in (VectorDB(DbOptions(dimensions=4), device=CPU), JVectorDB(JDbOptions(dimensions=4))):
        for pid, vec, color in ((1, [1, 0, 0, 0], "red"), (2, [0.99, 0.1, 0, 0], "blue"),
                                (3, [0.98, 0.15, 0, 0], "red")):
            db.insert(np.asarray(vec, np.float32), id=pid, payload={"color": color})
        res = db.search(np.asarray([1, 0, 0, 0], np.float32), k=2,
                        filter={"must": [{"key": "color", "match": {"value": "red"}}]})
        assert [r.id for r in res] == [1, 3]


def test_candidate_ids_soundness():
    from ruvector_tpu.index.filter import PayloadIndex as JPayloadIndex

    idx, jidx = PayloadIndex(), JPayloadIndex()
    for i in range(50):
        idx.add(i, {"g": i % 5, "v": i, "name": f"n{i}"})
        jidx.add(i, {"g": i % 5, "v": i, "name": f"n{i}"})
    assert candidate_ids(idx, F.and_([F.eq("g", 2), F.range("v", gte=10, lte=20)])) == {12, 17}
    assert candidate_ids(idx, F.or_([F.eq("g", 1), F.match_text("name", "n4")])) is None
    assert candidate_ids(idx, F.and_([F.eq("g", 0), F.match_text("name", "n")])) == \
        set(range(0, 50, 5))
    assert candidate_ids(idx, F.gt("v", 47)) == {48, 49}
    assert candidate_ids(idx, F.not_(F.eq("g", 1))) is None
    assert jcandidate_ids(jidx, JF.gt("v", 47)) == candidate_ids(idx, F.gt("v", 47))


@pytest.mark.parametrize("index_type", ["flat", "hnsw"])
def test_accelerated_path_matches_overfetch_path(index_type):
    """The candidate route (30 of 300 match) ranks as the over-fetch route
    (not(not(eq)), which the index cannot bound), in both packages."""
    db, jdb, q = _filter_dbs(300, lambda i: {"g": i % 10}, 3, index_type=index_type)
    fast = db.search(q, k=8, filter={"must": [{"key": "g", "match": {"value": 7}}]})
    slow = db.search(q, k=8, filter=F.not_(F.not_(F.eq("g", 7))))
    if index_type == "flat":
        assert [r.id for r in fast] == [r.id for r in slow]
        np.testing.assert_allclose([r.score for r in fast], [r.score for r in slow], atol=1e-5)
    assert all(r.payload["g"] == 7 for r in fast + slow) and len(slow) == 8
    _same_results(fast, jdb.search(q, k=8, filter={"must": [{"key": "g",
                                                              "match": {"value": 7}}]}),
                  atol=F32_TOL)
    _same_results(slow, jdb.search(q, k=8, filter=JF.not_(JF.not_(JF.eq("g", 7)))),
                  atol=F32_TOL)


def test_list_valued_payloads_indexed():
    idx = PayloadIndex()
    idx.add(1, {"tags": ["red", "blue"], "nums": [3, 7]})
    idx.add(2, {"tags": "red", "nums": 5})
    idx.add(3, {"tags": ["green"]})
    assert idx.ids_eq("tags", "red") == {1, 2}
    assert idx.ids_in("tags", ["blue", "green"]) == {1, 3}
    assert idx.ids_range("nums", gte=4, lte=7) == {1, 2}
    assert matches({"tags": ["red", "blue"]}, F.eq("tags", "red"))
    assert not matches({"tags": ["red"]}, F.ne("tags", "red"))
    assert matches({"nums": [3, 7]}, F.range("nums", gte=6))
    assert matches({"nums": [3, 7]}, F.gt("nums", 5))
    assert not matches({"nums": [3, 7]}, F.gt("nums", 7))


def test_index_accelerated_search_with_array_payloads():
    def tags(i):
        return {"tags": ["even" if i % 2 == 0 else "odd"] + (["tri"] if i % 3 == 0 else [])}

    db, jdb, q = _filter_dbs(60, tags, 1, index_type="flat")
    flt = {"must": [{"key": "tags", "match": {"any": ["tri"]}}]}
    res = db.search(q, k=10, filter=flt)
    assert {r.id for r in res} <= set(range(0, 60, 3)) and len(res) == 10
    assert candidate_ids(db._payload_index, F.in_values("tags", ["tri"])) == set(range(0, 60, 3))
    _same_results(res, jdb.search(q, k=10, filter=flt), atol=F32_TOL)


# --- tests/test_end_to_end.py:116-136 ---------------------------------------

def test_full_pipeline_index_to_gnn():
    """Index -> neighbor graph -> the port's RuvectorNet on the JAX
    parameters -> search, against the JAX run at f32 1e-5."""
    rng = np.random.default_rng(2)
    centers = rng.normal(size=(4, 16)).astype(np.float32)
    feats = np.concatenate([centers[c] + 0.6 * rng.normal(size=(15, 16))
                            for c in range(4)]).astype(np.float32)
    db = VectorDB(DbOptions(dimensions=16, m=8), device=CPU)
    jdb = JVectorDB(JDbOptions(dimensions=16, m=8))
    db.insert_batch(feats)
    jdb.insert_batch(feats)
    graph, jgraph = db.neighbor_graph(), jdb.neighbor_graph()
    assert graph.num_nodes == len(feats)
    np.testing.assert_array_equal(graph.nbr_idx.numpy(), np.asarray(jgraph.nbr_idx))
    cfg = RuvectorNetConfig(input_dim=16, hidden_dim=16, num_layers=1, heads=2)
    jparams = jruvector_net_init(jax.random.key(1), cfg)
    want = jruvector_net_apply(jparams, cfg, jdb.features_matrix(), jgraph)
    out = ruvector_net_apply(params_from_numpy(_np_tree(jparams), device=CPU), cfg,
                             db.features_matrix(), graph)
    assert out.shape == (len(feats), 16) and bool(torch.isfinite(out).all())
    np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=F32_TOL, rtol=0)
    res = db.search(feats[3], k=3)
    assert res[0].id == 3
    _same_results(res, jdb.search(feats[3], k=3))
