"""Parity of the port's negative mining, curriculum, spectral regularizer,
training worker and training metrics (`ruvector_tpu_torch.training.
{mining,worker,metrics_hook}`) against the JAX package's on the CPU: the
cases of tests/test_attention_extra.py:234-280, tests/test_integration_extra.py:71
(the curriculum-driven loop), tests/test_worker_serde.py:28-66 and
tests/test_utils.py:199-222, each held to that test's own assertions and
tolerances, and the port's results held to the JAX functions' on the same
numpy inputs.

Mining's tie rule: `torch.topk` may order equal scores otherwise than
`lax.top_k` (lower index first), so an id may differ only as a swap among
equal scores or at a tie with the k-th score. Its probability rule: the
distance-weighted draws are the same host numpy draws on the softmax of
each package's own similarities, so the ids must be equal on every row
up to the first whose probabilities differ in a bit (after it the draws'
rng state may diverge); the test asserts that this covers at least one row.
"""

import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ruvector_tpu.graph.build import build_knn_graph as j_build_knn_graph
from ruvector_tpu.nn import RuvectorLayerConfig as JRuvectorLayerConfig
from ruvector_tpu.nn import ruvector_layer_init as j_ruvector_layer_init
from ruvector_tpu.ops.distance import pairwise_cosine as j_pairwise_cosine
from ruvector_tpu.training import metrics_hook as jm
from ruvector_tpu.training import mining as jmin
from ruvector_tpu.training import worker as jw
from ruvector_tpu_torch.convert import params_from_numpy
from ruvector_tpu_torch.graph.build import build_knn_graph as t_build_knn_graph
from ruvector_tpu_torch.nn.ruvector_layer import RuvectorLayerConfig as TRuvectorLayerConfig
from ruvector_tpu_torch.ops.distance import pairwise_cosine as t_pairwise_cosine
from ruvector_tpu_torch.training import metrics_hook as tm
from ruvector_tpu_torch.training import mining as tmin
from ruvector_tpu_torch.training import worker as tw
from ruvector_tpu_torch.training.optimizers import adam
from ruvector_tpu_torch.training.train import TrainConfig, make_train_step, train_epoch

CPU = "cpu"
F32_TOL = dict(rtol=1e-5, atol=1e-6)      # float32 sums in another order
SPECTRAL_RTOL = 1e-3                      # tests/test_attention_extra.py:277


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def t_(x):
    return torch.from_numpy(np.asarray(x, np.float32))


def assert_topk_equal_up_to_ties(got, want, scores):
    """ids equal, except a swap among equal scores or a tie with the k-th
    score (queue 3's tie rule): each row's scores must be equal as lists,
    and ids may differ only where their score ties another candidate's."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    for row in range(got.shape[0]):
        s = scores[row]
        np.testing.assert_array_equal(s[got[row]], s[want[row]])
        for g, w in zip(got[row], want[row]):
            if g != w:
                assert s[g] == s[w]


# --- mining (tests/test_attention_extra.py:234-280) ---------------------------

def test_hard_mining_picks_confusable():
    a, p = [[1.0, 0.0]], [[1.0, 0.1]]
    c = [[0.99, 0.01], [0.0, 1.0], [-1.0, 0.0]]
    cfg_j = jmin.MiningConfig(strategy="hard", n_negatives=1)
    cfg_t = tmin.MiningConfig(strategy="hard", n_negatives=1)
    ij = jmin.mine_negatives(jnp.asarray(a), jnp.asarray(c), jnp.asarray(p), cfg_j)
    it = tmin.mine_negatives(t_(a), t_(c), t_(p), cfg_t)
    assert int(it[0, 0]) == 0 == int(ij[0, 0])
    assert it.dtype == torch.int32


def test_semi_hard_band():
    a, p = [[1.0, 0.0]], [[1.0, 0.0]]
    c = [[0.95, 0.31], [0.5, 0.87], [-1.0, 0.0]]
    cfg_t = tmin.MiningConfig(strategy="semi_hard", margin=0.2, n_negatives=1)
    it = tmin.mine_negatives(t_(a), t_(c), t_(p), cfg_t)
    assert int(it[0, 0]) == 0


@pytest.mark.parametrize("strategy", ["hard", "semi_hard"])
def test_mining_on_random_pools_equals_jax(strategy):
    """32 anchors against a 300-row pool with duplicated rows (exact ties)."""
    rng = np.random.default_rng(4)
    pool = rng.normal(size=(300, 16)).astype(np.float32)
    pool[150:200] = pool[:50]                   # equal scores
    anchors = rng.normal(size=(32, 16)).astype(np.float32)
    positives = anchors + 0.3 * rng.normal(size=(32, 16)).astype(np.float32)
    cfg = dict(strategy=strategy, margin=0.3, n_negatives=12)
    ij = np.asarray(jmin.mine_negatives(jnp.asarray(anchors), jnp.asarray(pool),
                                        jnp.asarray(positives), jmin.MiningConfig(**cfg)))
    it = tmin.mine_negatives(t_(anchors), t_(pool), t_(positives), tmin.MiningConfig(**cfg))
    sims = np.asarray(j_pairwise_cosine(jnp.asarray(anchors), jnp.asarray(pool)))
    np.testing.assert_allclose(t_pairwise_cosine(t_(anchors), t_(pool)).numpy(), sims,
                               **F32_TOL)
    if strategy == "semi_hard":
        pos = np.sum(anchors * positives, -1) / (np.linalg.norm(anchors, axis=-1)
                                                 * np.linalg.norm(positives, axis=-1))
        band = (sims > pos[:, None] - 0.3) & (sims < pos[:, None])
        sims = np.where(band.any(1, keepdims=True), np.where(band, sims, -np.inf), sims)
    assert_topk_equal_up_to_ties(it.numpy(), ij, sims)


def quarter_rows(rng, n, d):
    """Rows of four entries +-1: unit rows of +-0.5, whose cosines are sums
    of +-0.25, exact in any order, so both packages get the same sims."""
    x = np.zeros((n, d), np.float32)
    for i in range(n):
        x[i, rng.choice(d, 4, replace=False)] = rng.choice([-1.0, 1.0], 4)
    return x


def test_distance_weighted_draws_equal_jax():
    """The probability rule on the same sims: walking the rows in order,
    a row whose probabilities agree bit for bit must draw the same ids;
    the first row whose ids differ (allowed only where the probabilities
    differ) ends the walk, since the rng's state may differ after it."""
    rng = np.random.default_rng(5)
    pool, anchors = quarter_rows(rng, 200, 16), quarter_rows(rng, 24, 16)
    cfg = dict(strategy="distance_weighted", temperature=0.25, n_negatives=8)
    ij = np.asarray(jmin.mine_negatives(jnp.asarray(anchors), jnp.asarray(pool),
                                        jnp.asarray(anchors), jmin.MiningConfig(**cfg),
                                        rng=np.random.default_rng(7)))
    it = tmin.mine_negatives(t_(anchors), t_(pool), t_(anchors), tmin.MiningConfig(**cfg),
                             rng=np.random.default_rng(7)).numpy()
    sj = np.asarray(j_pairwise_cosine(jnp.asarray(anchors), jnp.asarray(pool)))
    st = t_pairwise_cosine(t_(anchors), t_(pool)).numpy()
    np.testing.assert_array_equal(st, sj)
    pj = np.asarray(jax.nn.softmax(jnp.asarray(sj) / 0.25, axis=-1))
    pt = torch.softmax(t_(st) / 0.25, dim=-1).numpy()
    np.testing.assert_allclose(pt, pj, **F32_TOL)
    same_p = (pt == pj).all(axis=1)
    checked = 0
    for row in range(len(it)):
        if not np.array_equal(it[row], ij[row]):
            assert not same_p[row], f"row {row}: equal probabilities, other ids"
            break
        checked += int(same_p[row])
    assert checked >= 1, "no row with equal probabilities: the rule checked nothing"
    assert all(len(set(row)) == 8 for row in it)


@pytest.mark.parametrize("include_positive", [False, True])
def test_in_batch_negatives_excludes_self(include_positive):
    it = tmin.in_batch_negatives(4, include_positive, device=CPU)
    ij = np.asarray(jmin.in_batch_negatives(4, include_positive))
    np.testing.assert_array_equal(it.numpy(), ij)
    assert it.dtype == torch.int32
    if not include_positive:
        assert tuple(it.shape) == (4, 3)
        for i in range(4):
            assert i not in it[i].tolist()


def test_curriculum_progression():
    for mod in (jmin, tmin):
        sched = mod.CurriculumScheduler.default_curriculum(300)
        assert sched.current_stage().name == "easy"
        for _ in range(120):
            sched.step()
        assert sched.current_stage().name == "medium"
        for _ in range(120):
            sched.step()
        assert sched.current_stage().name == "hard"
        assert sched.current_stage().negative_count == 32


def test_anneal_temperature():
    for step in (0, 50, 100, 150):
        assert tmin.anneal_temperature(step, 100) == jmin.anneal_temperature(step, 100)
    assert tmin.anneal_temperature(0, 100) == pytest.approx(0.1)
    assert tmin.anneal_temperature(100, 100) == pytest.approx(0.05)
    assert tmin.anneal_temperature(50, 100) == pytest.approx(0.075)


def test_spectral_regularizer():
    params = {"w": torch.eye(4) * 3.0, "b": torch.ones(4)}
    val = float(tmin.spectral_regularizer(params))
    np.testing.assert_allclose(val, 9.0, rtol=SPECTRAL_RTOL)
    leaves = [params["w"].clone().requires_grad_(True), params["b"]]
    g, = torch.autograd.grad(tmin.spectral_regularizer({"w": leaves[0], "b": leaves[1]}),
                             [leaves[0]])
    assert g.abs().max() > 0


def test_spectral_regularizer_and_grad_equal_jax_in_sorted_key_order():
    """A dict built in non-sorted key order, with lists inside: the value
    (a float32 sum over the matrices in JAX's sorted-key order) and every
    matrix's gradient equal JAX's at float32 tolerance."""
    rng = np.random.default_rng(6)
    tree_np = {"zeta": rng.normal(size=(8, 5)).astype(np.float32),
               "alpha": [rng.normal(size=(5, 5)).astype(np.float32) * 100.0,
                         rng.normal(size=(3,)).astype(np.float32)],
               "mid": {"k": rng.normal(size=(6, 4)).astype(np.float32) * 1e-3}}
    jtree = jax.tree_util.tree_map(jnp.asarray, tree_np)
    vj, gj = jax.value_and_grad(jmin.spectral_regularizer)(jtree)
    leaves = {"zeta": t_(tree_np["zeta"]).requires_grad_(True),
              "alpha": [t_(tree_np["alpha"][0]).requires_grad_(True), t_(tree_np["alpha"][1])],
              "mid": {"k": t_(tree_np["mid"]["k"]).requires_grad_(True)}}
    vt = tmin.spectral_regularizer(leaves)
    grads = torch.autograd.grad(vt, [leaves["zeta"], leaves["alpha"][0], leaves["mid"]["k"]])
    np.testing.assert_allclose(float(vt.detach()), float(vj), rtol=1e-6)
    for got, want in zip(grads, (gj["zeta"], gj["alpha"][0], gj["mid"]["k"])):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                                   atol=1e-6 * float(np.abs(want).max()))


def test_curriculum_driven_training_loop():
    """tests/test_integration_extra.py:71 on the port: curriculum stages
    set the temperature and the negatives across epochs of the contrastive
    step; JAX-initialised layer, the same numpy features."""
    rng = np.random.default_rng(0)
    feats_np = rng.normal(size=(48, 16)).astype(np.float32)
    feats = t_(feats_np)
    graph = t_build_knn_graph(feats, k=4, device=CPU)
    jg = j_build_knn_graph(jnp.asarray(feats_np), k=4)
    np.testing.assert_array_equal(graph.nbr_idx.numpy(), np.asarray(jg.nbr_idx))
    jp = j_ruvector_layer_init(jax.random.key(0), JRuvectorLayerConfig(16, 16, heads=4))
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), CPU)
    cfg = TRuvectorLayerConfig(input_dim=16, hidden_dim=16, heads=4)
    sched = tmin.CurriculumScheduler.default_curriculum(3)
    opt = adam(3e-3)
    opt_state = opt.init(params)
    gen = torch.Generator().manual_seed(0)
    losses, temps = [], []
    for _ in range(3):
        stage = sched.current_stage()
        tc = TrainConfig(batch_size=16, n_negatives=min(stage.negative_count, 8),
                         temperature=stage.temperature, learning_rate=3e-3)
        params, opt_state, loss = train_epoch(make_train_step(cfg, opt, tc), params,
                                              opt_state, feats, graph, tc, gen)
        losses.append(loss)
        temps.append(stage.temperature)
        sched.step()
    assert all(np.isfinite(losses))
    assert temps == [0.1, 0.07, 0.05]


# --- worker (tests/test_worker_serde.py:28-66) --------------------------------

def test_worker_trains_and_publishes():
    calls = []

    def train_fn(collection, epochs):
        calls.append(collection)
        return {"weights": torch.ones(4) * epochs}, torch.tensor(0.5 / epochs)

    w = tw.GnnTrainingWorker(train_fn)
    try:
        jid = w.enqueue("products", epochs=2)
        job = w.wait(jid, timeout=10)
        assert job.status is tw.JobStatus.DONE
        assert job.loss == 0.25
        assert torch.equal(w.model("products")["weights"], torch.full((4,), 2.0))
        assert calls == ["products"]
    finally:
        w.shutdown()
    assert not w._thread.is_alive()


def test_worker_failure_keeps_running():
    def train_fn(collection, epochs):
        if collection == "bad":
            # what a failed device op raises
            raise RuntimeError("CUDA error: boom")
        return "ok", 0.1

    w = tw.GnnTrainingWorker(train_fn)
    try:
        bad = w.wait(w.enqueue("bad"), timeout=10)
        assert bad.status is tw.JobStatus.FAILED
        assert "boom" in bad.error and bad.finished_at is not None
        good = w.wait(w.enqueue("good"), timeout=10)
        assert good.status is tw.JobStatus.DONE
        assert w.model("good") == "ok"
    finally:
        w.shutdown()


def test_worker_retrain_throttle():
    count = [0]

    def train_fn(collection, epochs):
        count[0] += 1
        return count[0], 0.0

    w = tw.GnnTrainingWorker(train_fn, min_retrain_interval_s=3600.0)
    try:
        w.wait(w.enqueue("c"), timeout=10)
        skipped = w.wait(w.enqueue("c"), timeout=10)
        assert "skipped" in skipped.error
        forced = w.wait(w.enqueue("c", force=True), timeout=10)
        assert forced.error == ""
        assert count[0] == 2
    finally:
        w.shutdown()


def test_worker_statuses_equal_jax():
    """The same job sequence (train, throttled, forced, failing) gives the
    same statuses, errors and losses in both packages."""
    def make(mod):
        def train_fn(collection, epochs):
            if collection == "bad":
                raise ValueError("boom")
            return collection, 1.0 / epochs
        w = mod.GnnTrainingWorker(train_fn, min_retrain_interval_s=3600.0)
        try:
            jobs = [w.wait(w.enqueue(c, epochs=e, force=f), timeout=10)
                    for c, e, f in (("a", 2, False), ("a", 1, False), ("a", 4, True),
                                    ("bad", 1, False))]
            return [(j.job_id, j.status.value, j.error, j.loss) for j in jobs]
        finally:
            w.shutdown()

    assert make(tw) == make(jw)


def test_worker_stress_many_enqueuers():
    """Eight threads enqueue 200 jobs at once: every job id is unique and
    every job finishes, none lost."""
    w = tw.GnnTrainingWorker(lambda c, e: (c, 0.0))
    ids, lock = [], threading.Lock()
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        def enqueue():
            got = [w.enqueue(f"c{i}", force=True) for i in range(25)]
            with lock:
                ids.extend(got)
        threads = [threading.Thread(target=enqueue) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in threads)
        assert sorted(ids) == list(range(1, 201))
        assert all(w.wait(i, timeout=30).status is tw.JobStatus.DONE for i in ids)
    finally:
        sys.setswitchinterval(switch)
        w.shutdown()


# --- training metrics (tests/test_utils.py:199-222) --------------------------

def test_training_metrics_hook():
    out = []
    for mod in (jm, tm):
        metrics = mod.TrainingMetrics(edges_per_step=1000)
        for loss in [1.0, 0.8, 0.5]:
            metrics.record_step(loss, 0.01)
        assert metrics.steps.get() == 3
        assert metrics.loss_sum.get() == 2.3
        assert metrics.edges_per_second() > 0
        text = metrics.registry.expose()
        assert "train_step_seconds" in text
        out.append((text, metrics.edges_per_second()))
    assert out[0] == out[1]


def test_training_metrics_timed_step():
    metrics = tm.TrainingMetrics()
    out = metrics.timed_step(lambda x: (x, None, torch.tensor(0.7)), 5)
    assert out[0] == 5
    assert abs(metrics.loss_sum.get() - 0.7) < 1e-6
    assert metrics.steps.get() == 1
