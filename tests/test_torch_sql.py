"""The port's SQL engine (ruvector_tpu_torch/serve/sql.py) against the JAX
package's.

Every case of tests/test_sql.py runs twice (tests/torch_mirror.py): as
written, on the JAX package, and with its imports pointed at the port,
whose engines and servers run on the CPU here (device="cpu"). Each run
records what `SqlEngine.execute` and `SqlEngine.gnn_model` return; the
case's own assertions hold on the port, and the two records must be equal:
rows, ids and strings exactly, floats (distances, the hyperbolic maps, the
GNN worker's losses and parameters) within rtol 1e-5, atol 1e-6. JSON text
that a function returns (job status, model summary) is compared parsed.

The GNN worker's case trains from JAX's initial parameters on JAX's draws:
the JAX run records its layer init and the anchors and negatives of every
step, and the port's init and epoch loop replay them (the port draws from a
torch.Generator, the JAX package from numpy). The attention key bias, whose
gradient is rounding noise that the softmax cancels, is held to a move of
at most lr a step instead (tests/test_torch_training.py's rule).

Five behaviours of the JAX engine depart from SQL and pgvector; the port
repairs them, and a test pins each, naming the JAX package's divergence.
"""

import json

import jax
import numpy as np
import pytest
import torch

import ruvector_tpu.nn.ruvector_layer as jlayer
import ruvector_tpu.serve.sql as jsql
import ruvector_tpu.training.train as jtrain
import ruvector_tpu_torch.nn.ruvector_layer as tlayer
import ruvector_tpu_torch.serve.server as tserver
import ruvector_tpu_torch.serve.sql as tsql
import ruvector_tpu_torch.training.train as ttrain
from ruvector_tpu_torch.convert import params_from_numpy
from tests.torch_mirror import Recorder, assert_same, cases, run_case

ANCHOR = "test_sql.py"
CASES = cases(ANCHOR)
RTOL, ATOL = 1e-5, 1e-6
LR = 1e-3                  # the worker's Adam rate (TrainConfig's default)
NOISE_LEAF = ("attn", "k", "bias")


def _decoded(x):
    """Results with their JSON text parsed (floats inside then compare at
    the tolerance)."""
    if isinstance(x, dict):
        return {k: _decoded(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_decoded(v) for v in x]
    if isinstance(x, tuple):
        return tuple(_decoded(v) for v in x)
    if isinstance(x, str) and x[:1] in "{[":
        try:
            return _decoded(json.loads(x))
        except ValueError:
            return x
    return x


def _record(monkeypatch, port: bool) -> list:
    rec = Recorder(monkeypatch, port)
    rec.methods((tsql if port else jsql).SqlEngine, names=("execute", "gnn_model"))
    if port:
        rec.cpu_default(tsql.SqlEngine, "__init__")
        rec.cpu_default(tserver.RuvectorServer, "__init__")
    return rec.log


def _capture_jax_training(monkeypatch) -> dict:
    """Record the JAX worker's initial parameters and each epoch's batches."""
    seen = {"init": [], "epochs": []}
    init, make_step, epoch = (jlayer.ruvector_layer_init, jtrain.make_train_step,
                              jtrain.train_epoch)

    def record_init(*args, **kw):
        params = init(*args, **kw)
        seen["init"].append(jax.tree_util.tree_map(np.asarray, params))
        return params

    def record_step(*args, **kw):
        step = make_step(*args, **kw)

        def run(trainable, opt_state, feats, graph, anchors, negs, *rest):
            seen["epochs"][-1].append((np.array(anchors), np.array(negs)))
            return step(trainable, opt_state, feats, graph, anchors, negs, *rest)

        return run

    def record_epoch(*args, **kw):
        seen["epochs"].append([])
        return epoch(*args, **kw)

    monkeypatch.setattr(jlayer, "ruvector_layer_init", record_init)
    monkeypatch.setattr(jtrain, "make_train_step", record_step)
    monkeypatch.setattr(jtrain, "train_epoch", record_epoch)
    return seen


def _replay_jax_training(monkeypatch, seen: dict) -> None:
    """The port's worker starts from JAX's parameters and steps on JAX's
    batches, epoch by epoch."""
    inits, epochs = list(seen["init"]), list(seen["epochs"])

    def init(seed, cfg, device=None, dtype=torch.float32):
        return params_from_numpy(inits.pop(0), device)

    def epoch(step_fn, trainable, opt_state, features, graph, cfg, generator, ewc_state=None):
        losses = []
        dev = graph.nbr_idx.device
        for anchors, negs in epochs.pop(0):
            trainable, opt_state, loss = step_fn(
                trainable, opt_state, features, graph, torch.from_numpy(anchors).to(dev),
                torch.from_numpy(negs).to(dev))
            losses.append(float(loss))
        return trainable, opt_state, float(np.mean(losses)) if losses else 0.0

    monkeypatch.setattr(tlayer, "ruvector_layer_init", init)
    monkeypatch.setattr(ttrain, "train_epoch", epoch)


def _pop_noise_leaf(log: list) -> list:
    """Take the attention key bias out of every recorded model."""
    out = []
    for name, value in log:
        if name == "SqlEngine.gnn_model" and isinstance(value, dict):
            leaf = value["params"]
            for key in NOISE_LEAF[:-1]:
                leaf = leaf[key]
            out.append(leaf.pop(NOISE_LEAF[-1]))
    return out


@pytest.mark.parametrize("case", CASES)
def test_same_answers_as_jax(case, monkeypatch, tmp_path):
    training = case == "test_gnn_train_worker_bridge"
    seen = _capture_jax_training(monkeypatch) if training else None
    want = _record(monkeypatch, port=False)
    run_case(ANCHOR, case, False, tmp_path / "jax")
    if training:
        _replay_jax_training(monkeypatch, seen)
    got = _record(monkeypatch, port=True)
    run_case(ANCHOR, case, True, tmp_path / "port")
    got, want = _decoded(got), _decoded(want)
    if training:
        steps = sum(len(e) for e in seen["epochs"])
        assert steps >= 2
        init_bias = seen["init"][0]["attn"]["k"]["bias"]
        for bias in _pop_noise_leaf(got):
            assert float(np.abs(bias - init_bias).max()) <= steps * LR * (1 + 1e-5)
        _pop_noise_leaf(want)
    assert [n for n, _ in got] == [n for n, _ in want]
    for i, ((name, a), (_, b)) in enumerate(zip(got, want)):
        assert_same(a, b, f"{name} #{i}", RTOL, ATOL)


def test_every_anchor_case_is_mirrored():
    assert len(CASES) == 23


# --- the device distance pass -------------------------------------------------

@pytest.mark.parametrize("op", ["<->", "<#>", "<=>"])
def test_distance_pass_matches_jax(op):
    rng = np.random.default_rng(3)
    mat = (rng.normal(size=(257, 32)) * rng.uniform(0.1, 3.0, size=(257, 1))).astype(np.float32)
    q = rng.normal(size=32).astype(np.float32)
    got = tsql._distance_column(mat, q, op, torch.device("cpu"))
    want = np.asarray(jsql._distance_column(mat, q, op))
    assert got.shape == want.shape == (257,)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    m64, q64 = mat.astype(np.float64), q.astype(np.float64)
    exact = {"<->": np.linalg.norm(m64 - q64, axis=1), "<#>": -(m64 @ q64),
             "<=>": 1 - (m64 @ q64) / (np.linalg.norm(m64, axis=1) * np.linalg.norm(q64))}[op]
    np.testing.assert_allclose(got, exact, rtol=1e-4, atol=1e-4)


def _vec_text(v) -> str:
    return "[" + ",".join(f"{x:.6f}" for x in v) + "]"


def _both(sql_setup: str):
    j, t = jsql.SqlEngine(), tsql.SqlEngine(device="cpu")
    for eng in (j, t):
        eng.execute(sql_setup)
    return j, t


@pytest.mark.parametrize("op", ["<->", "<#>", "<=>"])
@pytest.mark.parametrize("limit,offset", [(5, 0), (7, 3), (None, 0)])
def test_exact_route_matches_jax(op, limit, offset):
    rng = np.random.default_rng(7)
    mat = rng.normal(size=(300, 16)).astype(np.float32)
    vals = ", ".join(f"({i}, '{_vec_text(mat[i])}')" for i in range(300))
    j, t = _both(f"CREATE TABLE big (id int, v ruvector(16)); INSERT INTO big VALUES {vals}")
    q = _vec_text(rng.normal(size=16))
    tail = "" if limit is None else f" LIMIT {limit} OFFSET {offset}"
    sql = f"SELECT id, v {op} '{q}' AS d FROM big ORDER BY v {op} '{q}'{tail}"
    got, want = t.execute(sql), j.execute(sql)
    assert [r["id"] for r in got] == [r["id"] for r in want]
    assert len(got) == (300 if limit is None else limit)
    assert_same(got, want, sql, RTOL, ATOL)


def test_vector_column_grows_by_doubling():
    """A column is a view of its buffer's first n rows; the buffer doubles,
    so n single-row INSERTs copy O(n) rows, not O(n^2); UPDATE writes
    through the view and DELETE compacts. The rows equal the JAX table's."""
    j, t = _both("CREATE TABLE g (id int, v ruvector(3))")
    caps = []
    for i in range(100):
        for eng in (j, t):
            eng.execute(f"INSERT INTO g VALUES ({i}, '[{i},{i + 1},{-i}]')")
        caps.append(t.tables["g"]._bufs["v"].shape[0])
    assert sorted(set(caps)) == [16, 32, 64, 128]
    tab = t.tables["g"]
    assert tab.vecs["v"].shape == (100, 3) and np.shares_memory(tab.vecs["v"], tab._bufs["v"])
    np.testing.assert_array_equal(tab.vecs["v"], j.tables["g"].vecs["v"])
    for sql in ("UPDATE g SET v = '[7,7,7]' WHERE id = 50", "DELETE FROM g WHERE id < 40",
                "INSERT INTO g VALUES (100, '[1,2,3]')"):
        assert t.execute(sql) == j.execute(sql)
        np.testing.assert_array_equal(tab.vecs["v"], j.tables["g"].vecs["v"])
    assert tab.vecs["v"].shape == (61, 3)
    assert t.execute("SELECT id FROM g ORDER BY v <-> '[7,7,7]' LIMIT 1") == [{"id": 50}]


def _script(seed: int) -> list[str]:
    """A random DML/SELECT script over (id, tag, score, v): inserts in
    batches, updates, deletes, filters, one-key orders, limits, offsets."""
    rng = np.random.default_rng(seed)
    out = ["CREATE TABLE s (id int, tag text, score float, v ruvector(6))"]
    nid = 0
    for _ in range(6):
        rows = []
        for _ in range(int(rng.integers(3, 12))):
            rows.append(f"({nid}, '{'abc'[nid % 3]}', {rng.normal():.4f}, "
                        f"'{_vec_text(rng.normal(size=6))}')")
            nid += 1
        out.append("INSERT INTO s VALUES " + ", ".join(rows))
        q = _vec_text(rng.normal(size=6))
        op = ["<->", "<#>", "<=>"][int(rng.integers(3))]
        k, off = int(rng.integers(1, 6)), int(rng.integers(0, 3))
        out += [
            f"SELECT id, tag, v {op} '{q}' AS d FROM s ORDER BY v {op} '{q}' LIMIT {k} OFFSET {off}",
            f"SELECT id FROM s WHERE tag = 'b' OR score > 0.5 ORDER BY v {op} '{q}' LIMIT {k}",
            f"SELECT id, score * 2 + 1 AS z FROM s WHERE score BETWEEN -0.5 AND 0.5 ORDER BY id DESC",
            "SELECT count(*) FROM s WHERE NOT tag = 'a'",
            f"UPDATE s SET score = score + 1, v = '{q}' WHERE id = {int(rng.integers(nid))}",
            f"DELETE FROM s WHERE id = {int(rng.integers(nid))}",
            "SELECT * FROM s ORDER BY score LIMIT 3",
        ]
    return out


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_random_script_matches_jax(seed):
    j, t = jsql.SqlEngine(), tsql.SqlEngine(device="cpu")
    for sql in _script(seed):
        assert_same(t.execute(sql), j.execute(sql), sql, RTOL, ATOL)


def test_engine_and_index_take_the_requested_device():
    t = tsql.SqlEngine(device="cpu")
    t.execute("CREATE TABLE d (v ruvector(2)); INSERT INTO d VALUES ('[1,0]'), ('[0,1]'), "
              "('[1,1]'); CREATE INDEX di ON d USING hnsw (v vector_l2_ops)")
    assert t.device == torch.device("cpu")
    assert t.tables["d"].indexes["v"].index.device == torch.device("cpu")


# --- the five faults of the reference, repaired --------------------------------

def _ip_table():
    """Rows whose inner-product order differs from their l2 order (norms
    from 0.1 to 3)."""
    rng = np.random.default_rng(5)
    mat = (rng.normal(size=(64, 8)) * rng.uniform(0.1, 3.0, size=(64, 1))).astype(np.float32)
    vals = ", ".join(f"({i}, '{_vec_text(mat[i])}')" for i in range(64))
    return (f"CREATE TABLE t (id int, v ruvector(8)); INSERT INTO t VALUES {vals}",
            _vec_text(rng.normal(size=8)))


@pytest.mark.parametrize("opclass", ["vector_ip_ops", "ruvector_ip_ops"])
def test_ip_opclass_index_is_refused(opclass):
    """The HNSW index has no inner-product metric. The port refuses an
    ip index, and `<#>` stays exact. The JAX package builds vector_ip_ops
    as an l2 index and answers `<#>` from it in l2 order (its
    ruvector_ip_ops does not parse: the next fault)."""
    setup, q = _ip_table()
    j, t = _both(setup)
    query = f"SELECT id FROM t ORDER BY v <#> '{q}' LIMIT 3"
    exact = t.execute(query)
    assert exact == j.execute(query)
    with pytest.raises(tsql.SqlError, match="inner-product"):
        t.execute(f"CREATE INDEX ti ON t USING hnsw (v {opclass})")
    assert t.execute(query) == exact and not t.tables["t"].indexes
    if opclass == "vector_ip_ops":
        j.execute(f"CREATE INDEX ti ON t USING hnsw (v {opclass})")
        assert j.execute(query) != exact          # the JAX package's divergence
    else:
        with pytest.raises(jsql.SqlError, match="expected"):
            j.execute(f"CREATE INDEX ti ON t USING hnsw (v {opclass})")


@pytest.mark.parametrize("opclass,op", [("ruvector_l2_ops", "<->"),
                                        ("ruvector_cosine_ops", "<=>")])
def test_ruvector_opclasses_parse(opclass, op):
    """The reference's own spellings (sql/access_methods.sql) build the
    same index as the vector_* ones in the port; the JAX parser takes only
    identifiers that start with vector_ and raises "expected ')'"."""
    setup, q = _ip_table()
    j, t = _both(setup)
    query = f"SELECT id FROM t ORDER BY v {op} '{q}' LIMIT 4"
    t2 = tsql.SqlEngine(device="cpu")
    t2.execute(setup)
    assert t.execute(f"CREATE INDEX a ON t USING hnsw (v {opclass})") == 64
    t2.execute(f"CREATE INDEX a ON t USING hnsw (v vector{opclass[len('ruvector'):]})")
    assert t.tables["t"].indexes["v"].metric_op == op
    assert any("hnsw index scan" in s["plan"] for s in t.execute("EXPLAIN " + query))
    assert t.execute(query) == t2.execute(query)
    with pytest.raises(jsql.SqlError, match="expected"):
        j.execute(f"CREATE INDEX a ON t USING hnsw (v {opclass})")


_NULL_SETUP = ("CREATE TABLE n (id int, tag text, v ruvector(2)); INSERT INTO n VALUES "
               "(1, 'a', '[1,0]'), (2, 'b', '[0,1]'), (3, NULL, '[1,1]')")


@pytest.mark.parametrize("where,port_ids,jax_ids", [
    ("tag = NULL", [], [3]),
    ("tag <> 'a'", [2], [2, 3]),
    ("NOT (tag = 'a')", [2], [2, 3]),
    ("NOT (tag = 'a' AND id = 3)", [1, 2], [1, 2, 3]),
    ("tag = 'a' OR tag = NULL", [1], [1, 3]),
    ("v = '[0,1]'", [2], ValueError),
    ("v <> '[0,1]'::vector", [1, 3], ValueError),
])
def test_null_and_vector_comparisons(where, port_ids, jax_ids):
    """SQL: a comparison with NULL is NULL, and AND, OR and NOT carry it
    (three-valued logic); vectors compare element by element. The JAX
    engine evaluates NULL = NULL as true, NULL <> x as true, and raises
    numpy's "truth value is ambiguous" on `=` between vectors."""
    j, t = _both(_NULL_SETUP)
    sql = f"SELECT id FROM n WHERE {where} ORDER BY id"
    assert [r["id"] for r in t.execute(sql)] == port_ids
    if jax_ids is ValueError:
        with pytest.raises(ValueError, match="ambiguous"):
            j.execute(sql)
    else:
        assert [r["id"] for r in j.execute(sql)] == jax_ids


def test_serial_counter_fills_only_serial_columns():
    """An omitted serial/bigserial column takes the table's counter; an
    omitted plain int column stays NULL. The JAX engine fills every
    omitted int column from the one counter."""
    setup = ("CREATE TABLE s (id serial, big bigserial, n int, v ruvector(2)); "
             "INSERT INTO s (v) VALUES ('[1,0]'), ('[0,1]'); "
             "INSERT INTO s (id, n, v) VALUES (10, 4, '[1,1]')")
    j, t = _both(setup)
    sql = "SELECT id, big, n FROM s"
    assert t.execute(sql) == [{"id": 1, "big": 2, "n": None}, {"id": 3, "big": 4, "n": None},
                              {"id": 10, "big": 5, "n": 4}]
    assert j.execute(sql) == [{"id": 1, "big": 2, "n": 3}, {"id": 4, "big": 5, "n": 6},
                              {"id": 10, "big": 7, "n": 4}]


def test_secondary_order_keys_order_the_ties():
    """ORDER BY distance, id DESC: the ties at one distance come in
    descending id order. The JAX engine takes the kNN path on the first
    key and drops the rest (ties in row order)."""
    setup = ("CREATE TABLE o (id int, v ruvector(2)); INSERT INTO o VALUES "
             "(1, '[1,0]'), (2, '[0,1]'), (3, '[1,0]'), (4, '[0,1]'), (5, '[1,0]')")
    j, t = _both(setup)
    sql = "SELECT id FROM o ORDER BY v <-> '[1,0]', id DESC LIMIT 4"
    assert [r["id"] for r in t.execute(sql)] == [5, 3, 1, 4]
    assert [r["id"] for r in j.execute(sql)] == [1, 3, 5, 2]
    plan = t.execute("EXPLAIN " + sql)
    assert [s["plan"] for s in plan][1] == "row sort"
    one_key = "SELECT id FROM o ORDER BY v <-> '[1,0]' LIMIT 4"
    assert t.execute(one_key) == j.execute(one_key) == [{"id": 1}, {"id": 3}, {"id": 5},
                                                        {"id": 2}]
