"""Parity of the port's SONA engine (`ruvector_tpu_torch.sona`) against the
JAX package's on the CPU: the cases of tests/test_sona.py (16) and
tests/test_sona_export.py (4) on the same numpy inputs, each held to that
test's own assertions and tolerances. The loops and the adapter state are
host numpy in both packages, so every host array (`up`, `grad_up`, the
EWC++ Fisher, the pattern centroids) is held equal bit for bit, and an
exported safetensors file is byte-identical. The adapters' forwards are
float32 on either side: held to the JAX tests' 1e-6 (identity) and 1e-5
(the formula). Also the SONA compositions of tests/test_integration_extra.py:128
(the transformer with a SONA adapter) and tests/test_end_to_end.py:80
(the query feedback loop).
"""

import dataclasses
import json
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ruvector_tpu.sona as J
import ruvector_tpu_torch.sona as T
from ruvector_tpu.ops.distance import pairwise_cosine as j_pairwise_cosine
from ruvector_tpu.sona import export as j_export
from ruvector_tpu.sona.federated import FederatedAggregator as JFederatedAggregator
from ruvector_tpu.sona.types import LearnedPattern as JLearnedPattern
from ruvector_tpu.sona.types import QueryTrajectory as JQueryTrajectory
from ruvector_tpu.sona.types import TrajectoryStep as JTrajectoryStep
from ruvector_tpu_torch.ops.distance import pairwise_cosine as t_pairwise_cosine
from ruvector_tpu_torch.sona import export as t_export
from ruvector_tpu_torch.sona.federated import FederatedAggregator as TFederatedAggregator
from ruvector_tpu_torch.sona.types import LearnedPattern as TLearnedPattern
from ruvector_tpu_torch.sona.types import QueryTrajectory as TQueryTrajectory
from ruvector_tpu_torch.sona.types import TrajectoryStep as TTrajectoryStep

CPU = "cpu"
IDENTITY_TOL = 1e-6     # tests/test_sona.py:27, :155, :185
FORMULA_TOL = 1e-5      # tests/test_sona.py:57


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def np_(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def both_engines(cfg_kwargs):
    return (J.SonaEngine(config=J.SonaConfig(**cfg_kwargs)),
            T.SonaEngine(config=T.SonaConfig(**cfg_kwargs), device=CPU))


def assert_same_state(ej, et):
    """Every host array of the two engines equal bit for bit."""
    mj, mt = ej.coordinator.instant.micro_lora, et.coordinator.instant.micro_lora
    for a, b in ((mj.down, mt.down), (mj.up, mt.up), (mj.grad_up, mt.grad_up)):
        np.testing.assert_array_equal(a, b)
    assert mj.update_count == mt.update_count
    bj, bt = ej.coordinator.background, et.coordinator.background
    for a, b in zip(bj.base_lora.up, bt.base_lora.up):
        np.testing.assert_array_equal(a, b)
    for name in ("current_fisher", "current_weights", "gradient_mean", "gradient_m2"):
        np.testing.assert_array_equal(getattr(bj.ewc, name), getattr(bt.ewc, name))
    assert bj.ewc.lam == bt.ewc.lam and bj.ewc.task_count == bt.ewc.task_count
    assert sorted(bj.bank.patterns) == sorted(bt.bank.patterns)
    for pid in bj.bank.patterns:
        pj, pt = bj.bank.patterns[pid], bt.bank.patterns[pid]
        np.testing.assert_array_equal(pj.centroid, pt.centroid)
        assert (pj.avg_quality, pj.support) == (pt.avg_quality, pt.support)
    assert dataclasses.asdict(ej.stats) == dataclasses.asdict(et.stats)


# --- MicroLoRA --------------------------------------------------------------

def test_micro_lora_zero_init_is_identity():
    x = np.random.default_rng(0).normal(size=(4, 16)).astype(np.float32)
    yj = np.asarray(J.MicroLoRA(hidden_dim=16, rank=2).forward(x))
    yt = T.MicroLoRA(hidden_dim=16, rank=2, device=CPU).forward(x)
    assert yt.device.type == "cpu" and yt.dtype == torch.float32
    np.testing.assert_allclose(np_(yt), x, atol=IDENTITY_TOL)
    np.testing.assert_allclose(np_(yt), yj, atol=IDENTITY_TOL)


def test_micro_lora_accumulate_then_apply():
    loras = (J.MicroLoRA(hidden_dim=8, rank=1), T.MicroLoRA(hidden_dim=8, rank=1, device=CPU))
    g = np.ones(8, np.float32)
    for lora, pkg in zip(loras, (J, T)):
        lora.accumulate_gradient(pkg.LearningSignal(g, quality_score=0.5))
        lora.accumulate_gradient(pkg.LearningSignal(g, quality_score=1.0))
        assert lora.update_count == 2
        assert np.allclose(lora.up, 0.0)
        lora.apply_accumulated(learning_rate=0.1)
        np.testing.assert_allclose(lora.up, 0.075, atol=IDENTITY_TOL)
        assert lora.update_count == 0
    np.testing.assert_array_equal(loras[0].up, loras[1].up)
    x = np.ones((1, 8), np.float32)
    yt = np_(loras[1].forward(x))
    assert not np.allclose(yt, x)
    np.testing.assert_allclose(yt, np.asarray(loras[0].forward(x)), atol=FORMULA_TOL)


@pytest.mark.parametrize("rank", [0, 3])
def test_micro_lora_rank_validation(rank):
    with pytest.raises(ValueError):
        J.MicroLoRA(hidden_dim=8, rank=rank)
    with pytest.raises(ValueError):
        T.MicroLoRA(hidden_dim=8, rank=rank, device=CPU)


def test_micro_lora_forward_formula():
    lj, lt = J.MicroLoRA(hidden_dim=4, rank=1), T.MicroLoRA(hidden_dim=4, rank=1, device=CPU)
    np.testing.assert_array_equal(lj.down, lt.down)
    for lora in (lj, lt):
        lora.up = np.asarray([[1.0, 0.0, 0.0, 0.0]], np.float32)
    x = np.asarray([1.0, 2.0, 3.0, 4.0], np.float32)
    expect = x + lt.scale * (x @ lt.down) @ lt.up
    np.testing.assert_allclose(np_(lt.forward(x)), expect, atol=FORMULA_TOL)
    np.testing.assert_allclose(np_(lt.forward(x)), np.asarray(lj.forward(x)), atol=FORMULA_TOL)


def test_micro_lora_device_copy_follows_up():
    """The adapter's device copy of `up` follows in-place edits and
    replacement of the host array (federated apply, import)."""
    lora = T.MicroLoRA(hidden_dim=4, rank=1, device=CPU)
    x = np.ones((2, 4), np.float32)
    np.testing.assert_allclose(np_(lora.forward(x)), x, atol=IDENTITY_TOL)
    lora.up += 1.0
    y1 = np_(lora.forward(x))
    np.testing.assert_allclose(y1, x + lora.scale * (x @ lora.down) @ lora.up, atol=FORMULA_TOL)
    lora.up = np.zeros((1, 4), np.float32)
    np.testing.assert_allclose(np_(lora.forward(x)), x, atol=IDENTITY_TOL)


def test_base_lora_pattern_update():
    bj, bt = (J.BaseLoRA(hidden_dim=16, num_layers=2, rank=4),
              T.BaseLoRA(hidden_dim=16, num_layers=2, rank=4, device=CPU))
    c = np.random.default_rng(1).normal(size=16).astype(np.float32)
    x = np.random.default_rng(2).normal(size=(3, 16)).astype(np.float32)
    before = np_(bt.forward_layer(0, x))
    for b in (bj, bt):
        b.update_from_pattern(0, c, quality=1.0, lr=0.1)
    np.testing.assert_array_equal(bj.up[0], bt.up[0])
    after = np_(bt.forward_layer(0, x))
    assert not np.allclose(before, after)
    np.testing.assert_allclose(after, np.asarray(bj.forward_layer(0, x)), atol=FORMULA_TOL)
    np.testing.assert_allclose(np_(bt.forward_layer(1, x)), x, atol=IDENTITY_TOL)


# --- EWC++ ------------------------------------------------------------------

def test_ewc_pp_fisher_ema():
    for pkg in (J, T):
        ewc = pkg.EwcPlusPlus(pkg.EwcConfig(param_count=4, fisher_ema_decay=0.5))
        ewc.update_fisher(np.asarray([2.0, 0.0, 0.0, 0.0]))
        np.testing.assert_allclose(ewc.current_fisher, [2.0, 0, 0, 0], atol=IDENTITY_TOL)
        ewc.update_fisher(np.asarray([0.0, 2.0, 0.0, 0.0]))
        np.testing.assert_allclose(ewc.current_fisher, [1.0, 2.0, 0, 0], atol=IDENTITY_TOL)


def test_ewc_pp_boundary_detection():
    ewcs = []
    for pkg in (J, T):
        rng = np.random.default_rng(3)
        ewc = pkg.EwcPlusPlus(pkg.EwcConfig(param_count=32, boundary_threshold=3.0))
        for _ in range(100):
            ewc.update_fisher(rng.normal(0, 1, 32).astype(np.float32))
        assert not ewc.detect_task_boundary(rng.normal(0, 1, 32).astype(np.float32))
        assert ewc.detect_task_boundary(np.full(32, 50.0, np.float32))
        ewcs.append(ewc)
    for name in ("current_fisher", "gradient_mean", "gradient_m2"):
        np.testing.assert_array_equal(getattr(ewcs[0], name), getattr(ewcs[1], name))


def test_ewc_pp_constraints_shrink_important_params():
    out = []
    for pkg in (J, T):
        ewc = pkg.EwcPlusPlus(pkg.EwcConfig(param_count=4, initial_lambda=100.0))
        ewc.current_fisher = np.asarray([10.0, 0.0, 0.0, 0.0], np.float32)
        ewc.start_new_task()
        constrained = ewc.apply_constraints(np.ones(4, np.float32))
        assert constrained[0] < 0.01
        np.testing.assert_allclose(constrained[1:], 1.0, atol=IDENTITY_TOL)
        out.append(constrained)
    np.testing.assert_array_equal(*out)


def test_ewc_pp_task_memory_and_lambda():
    lams = []
    for pkg in (J, T):
        ewc = pkg.EwcPlusPlus(pkg.EwcConfig(param_count=4, max_tasks=2, initial_lambda=100))
        for _ in range(3):
            ewc.start_new_task()
        assert ewc.task_count == 2
        assert ewc.lam > 100
        lams.append(ewc.lam)
    assert lams[0] == lams[1]


def test_ewc_pp_regularization_loss():
    losses = []
    for pkg in (J, T):
        ewc = pkg.EwcPlusPlus(pkg.EwcConfig(param_count=2, initial_lambda=2.0))
        ewc.current_fisher = np.asarray([1.0, 0.0], np.float32)
        ewc.set_optimal_weights(np.asarray([1.0, 1.0], np.float32))
        ewc.start_new_task()
        loss = ewc.regularization_loss(np.asarray([3.0, 1.0], np.float32))
        np.testing.assert_allclose(loss, 0.5 * ewc.lam * 4.0, rtol=1e-5)
        losses.append(loss)
    assert losses[0] == losses[1]


# --- ReasoningBank ----------------------------------------------------------

def make_traj(types, tid, direction, quality, dim=16):
    qt, ts = types
    emb = np.zeros(dim, np.float32)
    emb[direction] = 1.0
    return qt(id=tid, query_embedding=emb, steps=[ts(emb, np.ones(1), reward=1.0)],
              final_quality=quality)


JTYPES, TTYPES = (JQueryTrajectory, JTrajectoryStep), (TQueryTrajectory, TTrajectoryStep)


def test_reasoning_bank_clusters_directions():
    out = []
    for pkg, types in ((J, JTYPES), (T, TTYPES)):
        bank = pkg.ReasoningBank(pkg.PatternConfig(k_clusters=2, embedding_dim=16,
                                                   min_cluster_size=2, quality_threshold=0.1))
        for i in range(6):
            bank.add_trajectory(make_traj(types, i, 0, 0.9))
        for i in range(6, 12):
            bank.add_trajectory(make_traj(types, i, 5, 0.8))
        patterns = bank.extract_patterns()
        assert len(patterns) == 2
        assert sorted(int(np.argmax(np.abs(p.centroid))) for p in patterns) == [0, 5]
        out.append(patterns)
    for pj, pt in zip(*out):
        np.testing.assert_array_equal(pj.centroid, pt.centroid)
        assert (pj.id, pj.avg_quality, pj.support) == (pt.id, pt.avg_quality, pt.support)


def test_reasoning_bank_kmeans_centroids_equal_jax():
    """k-means++ (first point index 0, then the D^2 argmax) and Lloyd's
    iterations on random trajectories: the same centroids, assignments
    and patterns, bit for bit."""
    rng = np.random.default_rng(11)
    embs = rng.normal(size=(60, 12)).astype(np.float32)
    quals = rng.uniform(0.2, 1.0, size=60)
    banks = []
    for pkg, (qt, ts) in ((J, JTYPES), (T, TTYPES)):
        bank = pkg.ReasoningBank(pkg.PatternConfig(k_clusters=5, embedding_dim=12,
                                                   min_cluster_size=1, quality_threshold=0.0))
        for i in range(60):
            bank.add_trajectory(qt(id=i, query_embedding=embs[i],
                                   steps=[ts(embs[(i + 1) % 60], np.ones(1), float(quals[i]))],
                                   final_quality=float(quals[i])))
        bank.extract_patterns()
        banks.append(bank)
    assert banks[0].pattern_count == banks[1].pattern_count >= 1
    for pid, pj in banks[0].patterns.items():
        np.testing.assert_array_equal(pj.centroid, banks[1].patterns[pid].centroid)
    assert [t.cluster for t in banks[0].trajectories] == [t.cluster for t in banks[1].trajectories]


def test_reasoning_bank_find_similar():
    for pkg, types in ((J, JTYPES), (T, TTYPES)):
        bank = pkg.ReasoningBank(pkg.PatternConfig(k_clusters=2, embedding_dim=8,
                                                   min_cluster_size=1, quality_threshold=0.0))
        for i in range(4):
            bank.add_trajectory(make_traj(types, i, 0, 0.9, dim=8))
        for i in range(4, 8):
            bank.add_trajectory(make_traj(types, i, 3, 0.9, dim=8))
        bank.extract_patterns()
        q = np.zeros(8, np.float32)
        q[0] = 1.0
        top = bank.find_similar(q, k=1)
        assert len(top) == 1
        assert int(np.argmax(np.abs(top[0].centroid))) == 0
        assert top[0].access_count == 1


def test_reasoning_bank_consolidate_merges_duplicates():
    merged = []
    for pkg, lp in ((J, JLearnedPattern), (T, TLearnedPattern)):
        bank = pkg.ReasoningBank(pkg.PatternConfig(embedding_dim=4))
        bank.patterns[0] = lp(0, np.asarray([1.0, 0, 0, 0]), 0.9, 2)
        bank.patterns[1] = lp(1, np.asarray([0.99, 0.01, 0, 0]), 0.7, 2)
        bank.patterns[2] = lp(2, np.asarray([0, 1.0, 0, 0]), 0.8, 2)
        bank.consolidate(similarity_threshold=0.95)
        assert bank.pattern_count == 2
        merged.append(bank.patterns[0])
    np.testing.assert_array_equal(merged[0].centroid, merged[1].centroid)
    assert merged[0].avg_quality == merged[1].avg_quality


# --- engine end-to-end ------------------------------------------------------

def test_sona_engine_two_loops():
    ej, et = both_engines(dict(hidden_dim=16, embedding_dim=16, flush_threshold=4,
                               background_interval_s=0.0, pattern_clusters=2,
                               quality_threshold=0.2))
    for engine in (ej, et):
        rng = np.random.default_rng(5)
        for _ in range(8):
            b = engine.begin_trajectory(rng.normal(size=16).astype(np.float32))
            b.add_step(rng.normal(size=16).astype(np.float32), np.ones(4), reward=1.0)
            engine.end_trajectory(b, quality=0.9)
        engine.flush()
    lora = et.coordinator.instant.micro_lora
    assert np.abs(lora.up).max() > 0 and lora.update_count == 0
    x = np.ones((1, 16), np.float32)
    y = np_(et.apply_micro_lora(x))
    assert np.abs(y - x).max() > 0
    np.testing.assert_allclose(y, np.asarray(ej.apply_micro_lora(x)), atol=FORMULA_TOL)
    for engine in (ej, et):
        msg = engine.tick()
        assert msg is not None and "trajectories" in msg
        assert engine.stats.background_cycles == 1
        assert engine.stats.trajectories_seen == 8
    assert_same_state(ej, et)


def test_sona_engine_low_quality_not_learned():
    ej, et = both_engines(dict(hidden_dim=8, embedding_dim=8, flush_threshold=1,
                               quality_threshold=0.5))
    for engine in (ej, et):
        b = engine.begin_trajectory(np.ones(8, np.float32))
        b.add_step(np.ones(8, np.float32), np.ones(1), reward=1.0)
        engine.end_trajectory(b, quality=0.1)
        engine.flush()
    x = np.ones((1, 8), np.float32)
    np.testing.assert_allclose(np_(et.apply_micro_lora(x)), x, atol=IDENTITY_TOL)
    assert_same_state(ej, et)


def test_background_per_parameter_consolidation():
    cfg = dict(hidden_dim=8, embedding_dim=8, num_layers=2, base_lora_rank=4,
               pattern_clusters=1, background_interval_s=0.0, quality_threshold=0.0)
    ej, et = both_engines(cfg)
    for engine in (ej, et):
        rng = np.random.default_rng(0)
        for _ in range(6):
            b = engine.begin_trajectory(np.ones(8, np.float32))
            b.add_step(rng.normal(size=8).astype(np.float32), np.ones(2), reward=1.0)
            engine.end_trajectory(b, quality=0.9)
        engine.coordinator.force_background()
    bg = et.coordinator.background
    n_up = 2 * 4 * 8
    assert bg.ewc.config.param_count == n_up
    assert bg.ewc.current_fisher.shape == (n_up,)
    assert max(np.abs(u).max() for u in bg.base_lora.up) > 0
    assert bg.ewc.current_fisher.max() > 0
    np.testing.assert_allclose(bg.ewc.current_weights,
                               np.concatenate([u.reshape(-1) for u in bg.base_lora.up]))
    assert_same_state(ej, et)


def test_sona_engine_long_stream_state_equal():
    """Many trajectories, several background cycles and a task boundary
    check: the host state of the two engines stays equal bit for bit."""
    ej, et = both_engines(dict(hidden_dim=24, embedding_dim=24, flush_threshold=8,
                               pattern_clusters=4, quality_threshold=0.3,
                               trajectory_capacity=64))
    for engine in (ej, et):
        rng = np.random.default_rng(21)
        for i in range(200):
            b = engine.begin_trajectory(rng.normal(size=24).astype(np.float32))
            for _ in range(2):
                b.add_step(rng.normal(size=24).astype(np.float32), np.ones(2),
                           reward=float(rng.uniform()))
            engine.end_trajectory(b, quality=float(rng.uniform()))
            if i % 50 == 49:
                engine.force_learn()
    assert et.coordinator.background.bank.pattern_count >= 1
    assert_same_state(ej, et)
    q = np.random.default_rng(1).normal(size=24).astype(np.float32)
    assert ([p.id for p in ej.find_similar_patterns(q, k=3)]
            == [p.id for p in et.find_similar_patterns(q, k=3)])
    x = np.random.default_rng(2).normal(size=(5, 24)).astype(np.float32)
    for layer in range(2):
        np.testing.assert_allclose(np_(et.apply_base_lora(layer, x)),
                                   np.asarray(ej.apply_base_lora(layer, x)), atol=FORMULA_TOL)


# --- export + federated (tests/test_sona_export.py) -------------------------

def test_safetensors_roundtrip(tmp_path):
    tensors = {"a": np.arange(12, dtype=np.float32).reshape(3, 4),
               "b": np.ones((2, 2), np.float32)}
    pj, pt = tmp_path / "j.safetensors", tmp_path / "t.safetensors"
    j_export.save_safetensors(pj, tensors, metadata={"k": "v"})
    t_export.save_safetensors(pt, tensors, metadata={"k": "v"})
    assert pt.read_bytes() == pj.read_bytes()
    loaded, meta = t_export.load_safetensors(pj)
    np.testing.assert_array_equal(loaded["a"], tensors["a"])
    np.testing.assert_array_equal(loaded["b"], tensors["b"])
    assert meta["k"] == "v"
    raw = pt.read_bytes()
    (hlen,) = struct.unpack("<Q", raw[:8])
    header = json.loads(raw[8: 8 + hlen])
    assert header["a"]["dtype"] == "F32"
    assert header["a"]["shape"] == [3, 4]


def make_engine(pkg, seed=0):
    cfg = pkg.SonaConfig(hidden_dim=8, embedding_dim=8, flush_threshold=1,
                         quality_threshold=0.0, num_layers=2)
    engine = (pkg.SonaEngine(config=cfg) if pkg is J
              else pkg.SonaEngine(config=cfg, device=CPU))
    rng = np.random.default_rng(seed)
    for _ in range(4):
        b = engine.begin_trajectory(rng.normal(size=8).astype(np.float32))
        b.add_step(rng.normal(size=8).astype(np.float32), np.ones(1), 1.0)
        engine.end_trajectory(b, quality=0.9)
    engine.flush()
    return engine


def test_lora_export_import_roundtrip(tmp_path):
    e1 = make_engine(T, 0)
    p = tmp_path / "lora.safetensors"
    t_export.export_lora(e1, p)
    e2 = make_engine(T, 1)
    t_export.import_lora(e2, p)
    np.testing.assert_array_equal(e2.coordinator.instant.micro_lora.up,
                                  e1.coordinator.instant.micro_lora.up)
    x = np.ones((1, 8), np.float32)
    np.testing.assert_allclose(np_(e1.apply_micro_lora(x)), np_(e2.apply_micro_lora(x)),
                               atol=IDENTITY_TOL)


@pytest.mark.parametrize("seed", [0, 3])
def test_exported_lora_is_byte_identical(tmp_path, seed):
    """The same trajectories give the same adapters, and the two packages
    export them as the same bytes; each package imports the other's file."""
    ej, et = make_engine(J, seed), make_engine(T, seed)
    for engine in (ej, et):
        engine.force_learn()
    pj, pt = tmp_path / "j.safetensors", tmp_path / "t.safetensors"
    j_export.export_lora(ej, pj)
    t_export.export_lora(et, pt)
    assert pt.read_bytes() == pj.read_bytes()
    fresh_t, fresh_j = make_engine(T, 9), make_engine(J, 9)
    t_export.import_lora(fresh_t, pj)
    j_export.import_lora(fresh_j, pt)
    np.testing.assert_array_equal(fresh_t.coordinator.instant.micro_lora.up,
                                  fresh_j.coordinator.instant.micro_lora.up)
    for a, b in zip(fresh_t.coordinator.background.base_lora.up,
                    fresh_j.coordinator.background.base_lora.up):
        np.testing.assert_array_equal(a, b)


def test_trajectory_dataset_export(tmp_path):
    out = []
    for exp, (qt, ts) in ((j_export, JTYPES), (t_export, TTYPES)):
        t = qt(id=1, query_embedding=np.ones(4, np.float32),
               steps=[ts(np.zeros(4, np.float32), np.ones(1), 0.5, "s")],
               final_quality=0.8, model_route="fast", latency_us=7)
        p = tmp_path / f"ds_{len(out)}.jsonl"
        exp.export_trajectory_dataset([t], p)
        rec = json.loads(p.read_text().strip().split("\n")[0])
        assert rec["quality"] == 0.8
        assert rec["steps"][0]["reward"] == 0.5
        out.append(p.read_bytes())
    assert out[0] == out[1]


def test_federated_aggregation():
    results = []
    for pkg, agg_cls in ((J, JFederatedAggregator), (T, TFederatedAggregator)):
        engines = [make_engine(pkg, s) for s in range(3)]
        agg = (agg_cls(hidden_dim=8, num_layers=2) if pkg is J
               else agg_cls(hidden_dim=8, num_layers=2, device=CPU))
        updates = [agg.collect(e, weight=w) for e, w in zip(engines, [1.0, 1.0, 2.0])]
        merged = agg.aggregate(updates)
        expect = (updates[0].micro_up * 0.25 + updates[1].micro_up * 0.25
                  + updates[2].micro_up * 0.5)
        np.testing.assert_allclose(merged.micro_up, expect, atol=IDENTITY_TOL)
        target = make_engine(pkg, 9)
        agg.apply(target, merged)
        np.testing.assert_array_equal(target.coordinator.instant.micro_lora.up, merged.micro_up)
        results.append((merged, target))
    (mj, tj), (mt, tt) = results
    np.testing.assert_array_equal(mj.micro_up, mt.micro_up)
    for a, b in zip(mj.base_ups, mt.base_ups):
        np.testing.assert_array_equal(a, b)
    x = np.ones((2, 8), np.float32)
    np.testing.assert_allclose(np_(tt.apply_micro_lora(x)), np.asarray(tj.apply_micro_lora(x)),
                               atol=FORMULA_TOL)


# --- compositions -----------------------------------------------------------

def test_transformer_with_sona_adapter():
    """tests/test_integration_extra.py:128 on the port: a MicroLoRA adapts
    the transformer's input embeddings and the logits change; the adapted
    embeddings equal the JAX engine's (1e-5), and so do the logits."""
    import ruvector_tpu.transformer as JT
    import ruvector_tpu_torch.transformer as TT

    cfg = JT.TransformerConfig.micro()
    wj = jax.jit(JT.init_weights, static_argnums=(1, 2))(jax.random.key(8), cfg, True)
    tcfg = TT.TransformerConfig(**dataclasses.asdict(cfg))
    wt = TT.init_weights(jax.tree_util.tree_map(np.asarray, wj), tcfg, device=CPU)
    model = TT.MincutGatedTransformer(tcfg, TT.GatePolicy(), wt, device=CPU)
    sona_cfg = dict(hidden_dim=cfg.hidden, embedding_dim=cfg.hidden, flush_threshold=1,
                    quality_threshold=0.0)
    ej, et = both_engines(sona_cfg)
    emb = np.asarray(wj["embedding"])[np.arange(8)]
    out_base = model.infer(embedding=emb)
    for engine in (ej, et):
        b = engine.begin_trajectory(emb[0])
        b.add_step(np.ones(cfg.hidden, np.float32) * 5.0, np.ones(1), reward=1.0)
        engine.end_trajectory(b, quality=1.0)
        engine.flush()
    adapted = np_(et.apply_micro_lora(emb))
    np.testing.assert_allclose(adapted, np.asarray(ej.apply_micro_lora(emb)), atol=FORMULA_TOL)
    out_adapted = model.infer(embedding=adapted)
    assert not np.array_equal(np_(out_base.logits), np_(out_adapted.logits))


def clustered_data(n_clusters=4, per_cluster=20, d=16, noise=0.6, seed=1):
    """tests/test_end_to_end.py:23."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(n_clusters, d)).astype(np.float32)
    feats, labels = [], []
    for c in range(n_clusters):
        feats.append(centers[c] + noise * rng.normal(size=(per_cluster, d)))
        labels.extend([c] * per_cluster)
    return np.concatenate(feats).astype(np.float32), np.asarray(labels), rng


def test_query_feedback_loop():
    """tests/test_end_to_end.py:80 on the port: search-result relevance
    signals update the adapters online. The top-5 lists come from each
    package's own cosines; where they agree, the engines' host state is
    equal bit for bit."""
    feats, labels, rng = clustered_data()
    cfg = dict(hidden_dim=16, embedding_dim=16, flush_threshold=4, background_interval_s=0.0,
               quality_threshold=0.1)
    ej, et = both_engines(cfg)
    queries = rng.integers(0, len(feats), size=12)
    for engine, sims_of in ((ej, lambda q: np.asarray(j_pairwise_cosine(
            jnp.asarray(q[None]), jnp.asarray(feats)))[0]),
                            (et, lambda q: np_(t_pairwise_cosine(
                                torch.from_numpy(q[None]), torch.from_numpy(feats)))[0])):
        for qi in queries:
            q = feats[qi]
            top = np.argsort(-sims_of(q), kind="stable")[1:6]
            reward = float((labels[top] == labels[qi]).mean())
            b = engine.begin_trajectory(q)
            for t in top:
                b.add_step(feats[t], np.ones(1), reward=reward)
            engine.end_trajectory(b, quality=reward)
        engine.flush()
    lora = et.coordinator.instant.micro_lora
    assert np.abs(lora.up).max() > 0
    adapted = et.apply_micro_lora(feats[:4])
    assert tuple(adapted.shape) == (4, 16)
    np.testing.assert_allclose(np_(adapted), np.asarray(ej.apply_micro_lora(feats[:4])),
                               atol=FORMULA_TOL)
    for engine in (ej, et):
        assert engine.tick() is not None
    assert et.coordinator.background.bank.pattern_count >= 1
    assert_same_state(ej, et)
