"""Parity of the port's host utilities (`ruvector_tpu_torch.utils.
{checkpoint,metrics,monitoring,profiler,mmap_store,cold_tier}`) against
the JAX package's on the CPU: the cases of tests/test_utils.py (the
witness log's are in tests/test_torch_quantization.py, the training
metrics' in tests/test_torch_training_utils.py), each held to that test's
own assertions, and the files each package writes read by the other:
checkpoints (float32 and bf16 leaves; JAX's `.npz` holds a bf16 leaf as
void |V2 words), sharded checkpoints, the feature store and the mmap
embedding store. Also `config_hash` equal in both packages, and the
port's copies of `recursive_bisection_order` and `halo_fraction` equal to
JAX's on the same inputs.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ruvector_tpu.parallel import ordering as jord
from ruvector_tpu.utils import checkpoint as jck
from ruvector_tpu.utils import cold_tier as jct
from ruvector_tpu.utils import metrics as jmet
from ruvector_tpu.utils import mmap_store as jmm
from ruvector_tpu.utils import monitoring as jmon
from ruvector_tpu.utils import profiler as jprof
from ruvector_tpu_torch.parallel import ordering as tord
from ruvector_tpu_torch.utils import checkpoint as tck
from ruvector_tpu_torch.utils import cold_tier as tct
from ruvector_tpu_torch.utils import metrics as tmet
from ruvector_tpu_torch.utils import mmap_store as tmm
from ruvector_tpu_torch.utils import monitoring as tmon
from ruvector_tpu_torch.utils import profiler as tprof

CPU = "cpu"


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _tree_np(rng):
    return {"a": np.asarray([1.0, 2.0], np.float32),
            "b": {"c": rng.normal(size=(3, 4)).astype(np.float32)},
            "lst": [np.zeros(2, np.float32), np.ones(2, np.float32)]}


def _as_torch(tree):
    return jax.tree_util.tree_map(torch.from_numpy, tree)


def _as_jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _assert_trees_equal(got, want):
    """Leaf by leaf in JAX's order: equal bits, equal dtype."""
    gl, wl = jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)
    assert len(gl) == len(wl)
    for g, w in zip(gl, wl):
        if isinstance(g, torch.Tensor):
            assert isinstance(w, torch.Tensor) and g.dtype == w.dtype
            assert torch.equal(g, w)
        else:
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


# --- checkpoints ------------------------------------------------------------

def test_checkpoint_roundtrip_npz(tmp_path):
    tree = _as_torch(_tree_np(np.random.default_rng(0)))
    tck.save_checkpoint(tmp_path, tree, step=7)
    restored = tck.restore_checkpoint(tmp_path, tree, step=7)
    _assert_trees_equal(restored, tree)
    assert all(t.device.type == "cpu" for t in jax.tree_util.tree_leaves(restored))


def test_checkpoint_detects_corruption(tmp_path):
    tree = {"w": torch.ones(8)}
    path = tck.save_checkpoint(tmp_path, tree, step=0)
    data = np.load(path)
    np.savez(path[:-4], w=np.asarray(data["w"]) + 1.0)
    with pytest.raises(ValueError, match="checksum"):
        tck.restore_checkpoint(tmp_path, tree, step=0)


def test_checkpoint_files_cross_packages(tmp_path):
    """The same tree (float32 leaves, a bf16 leaf, a None) saved by each
    package: the same members, bytes and meta file; the port restores
    JAX's file, bf16 through the target's dtype; JAX restores the port's
    float32 file (JAX's own restore refuses a |V2 leaf)."""
    tree_np = _tree_np(np.random.default_rng(1))
    bf = np.random.default_rng(2).normal(size=(5,)).astype(np.float32)
    jtree = {**_as_jax(tree_np), "h": jnp.asarray(bf).astype(jnp.bfloat16), "none": None}
    ttree = {**_as_torch(tree_np), "h": torch.from_numpy(bf).bfloat16(), "none": None}
    pj = jck.save_checkpoint(tmp_path / "j", jtree, step=3, use_orbax=False)
    pt = tck.save_checkpoint(tmp_path / "t", ttree, step=3)
    assert ((tmp_path / "j" / "ckpt_3.json").read_text()
            == (tmp_path / "t" / "ckpt_3.json").read_text())
    zj, zt = np.load(pj), np.load(pt)
    assert sorted(zj.files) == sorted(zt.files) == ["a", "b/c", "h", "lst/0", "lst/1"]
    for k in zj.files:
        assert zj[k].dtype == zt[k].dtype and zj[k].tobytes() == zt[k].tobytes()
    assert zt["h"].dtype == np.dtype("V2")
    restored = tck.restore_checkpoint(tmp_path / "j", ttree, step=3)
    _assert_trees_equal(restored, ttree)
    assert restored["h"].dtype == torch.bfloat16

    f32_t, f32_j = _as_torch(tree_np), _as_jax(tree_np)
    tck.save_checkpoint(tmp_path / "t32", f32_t, step=1)
    back = jck.restore_checkpoint(tmp_path / "t32", f32_j, step=1, use_orbax=False)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(f32_j)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_async_sharded_checkpoint_roundtrip(tmp_path):
    """Background save of the snapshot taken at save(), restore
    resume-identical; the leaves edited after save() keep their saved
    values."""
    n = 16
    tree = {"feats": torch.arange(n * 4, dtype=torch.float32).reshape(n, 4),
            "step_scalar": torch.tensor(3.5),
            "opt": {"m": torch.ones(n, 4) * 2, "h": torch.ones(3, dtype=torch.bfloat16)}}
    saved = jax.tree_util.tree_map(torch.clone, tree)
    ck = tck.AsyncShardedCheckpointer(tmp_path)
    ck.save(tree, step=7)
    tree["opt"]["m"].add_(1.0)                  # after the snapshot
    ck.wait_until_finished()
    proto = jax.tree_util.tree_map(torch.zeros_like, tree)
    _assert_trees_equal(ck.restore(proto, step=7), saved)
    meta = json.loads((tmp_path / "ckpt_7.proc0.json").read_text())
    assert meta["keys"]["opt/h"]["dtype"] == "bfloat16"
    assert meta["keys"]["feats"]["indices"] == [[]]
    with pytest.raises(FileNotFoundError):
        ck.restore(proto, step=8)


def test_async_sharded_checkpoint_reads_jax_shards(tmp_path):
    """A checkpoint that JAX writes from arrays sharded over the 8 CPU
    devices (one shard a device) restores whole in the port; and JAX
    restores the port's single-shard files."""
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    devs = jax.devices()
    sh = NamedSharding(Mesh(np.array(devs), ("x",)), P("x"))
    n = 8 * len(devs)
    feats = np.arange(n * 4, dtype=np.float32).reshape(n, 4)
    jtree = {"feats": jax.device_put(jnp.asarray(feats), sh), "s": jnp.float32(3.5)}
    jc = jck.AsyncShardedCheckpointer(tmp_path / "j")
    jc.save(jtree, step=2)
    jc.wait_until_finished()
    proto = {"feats": torch.zeros(n, 4), "s": torch.zeros(())}
    got = tck.AsyncShardedCheckpointer(tmp_path / "j").restore(proto, step=2)
    np.testing.assert_array_equal(got["feats"].numpy(), feats)
    assert float(got["s"]) == 3.5

    tc = tck.AsyncShardedCheckpointer(tmp_path / "t")
    tc.save({"feats": torch.from_numpy(feats), "s": torch.tensor(3.5)}, step=2)
    tc.wait_until_finished()
    back = jck.AsyncShardedCheckpointer(tmp_path / "t").restore(
        jax.tree_util.tree_map(jnp.zeros_like, jtree), step=2)
    np.testing.assert_array_equal(np.asarray(back["feats"]), feats)


def test_meta_to_index_never_evals():
    assert tck._meta_to_index("()") == ()
    assert tck._meta_to_index("(slice(0, 4, None), slice(None, None, None))") == (
        slice(0, 4, None), slice(None, None, None))
    assert tck._meta_to_index([[0, 4, None]]) == (slice(0, 4, None),)
    with pytest.raises(ValueError):
        tck._meta_to_index("__import__('os').system('true')")
    with pytest.raises(ValueError):
        tck._meta_to_index("slice(__import__('os'), 1, None)")


# --- metrics, monitoring, profiler ----------------------------------------------

def test_metrics_counter_histogram():
    texts = []
    for mod in (jmet, tmet):
        reg = mod.MetricsRegistry()
        c = reg.counter("search_total", "searches")
        c.inc(collection="a")
        c.inc(collection="a")
        c.inc(collection="b")
        assert c.get(collection="a") == 2
        h = reg.histogram("latency_seconds")
        for v in [0.0002, 0.003, 0.004, 0.2]:
            h.observe(v, op="search")
        assert h.percentile(50, op="search") <= 0.005
        text = reg.expose()
        assert "search_total" in text and "latency_seconds_bucket" in text
        assert reg.health()["status"] == "healthy"
        texts.append(text)
    assert texts[0] == texts[1]


def test_histogram_timer():
    h = tmet.Histogram("t")
    with h.time():
        pass
    assert h._total[()] == 1


def test_profiler_regions_and_csv():
    prof = tprof.Profiler()
    x = torch.ones(100, 100)
    for _ in range(3):
        with prof.region("matmul") as holder:
            holder.append({"y": [x @ x]})
    s = prof.summary()
    assert s["matmul"]["count"] == 3
    assert s["matmul"]["mean_ms"] > 0
    assert "matmul" in prof.to_csv()
    assert len(tprof.Profiler.config_hash({"a": 1})) == 16
    with tprof.profile_region("global") as holder:
        holder.append(x.sum())
    assert tprof._global_profiler.summary()["global"]["count"] >= 1


@dataclasses.dataclass(frozen=True)
class _Inner:
    width: int = 4
    rate: float = 0.5


@dataclasses.dataclass(frozen=True)
class _Outer:
    name: str = "cfg"
    inner: _Inner = _Inner()
    dims: tuple = (1, 2)
    extra: dict = dataclasses.field(default_factory=lambda: {"b": 1, "a": [1.5]})


@pytest.mark.parametrize("config", [{"a": 1}, _Outer(), _Inner(width=7)],
                         ids=["dict", "nested_dataclass", "dataclass"])
def test_config_hash_equals_jax(config):
    assert tprof.Profiler.config_hash(config) == jprof.Profiler.config_hash(config)
    assert tprof.dataclass_to_dict(config) == jprof.dataclass_to_dict(config)


def test_profiler_device_memory_stats_and_trace(tmp_path):
    """The CPU keeps no allocator counters ({} as JAX's CPU client); the
    trace of a region lands in logdir as a Chrome trace."""
    assert tprof.Profiler.device_memory_stats("cpu") == {}
    prof = tprof.Profiler()
    with prof.xla_trace(str(tmp_path / "trace")):
        (torch.ones(64, 64) @ torch.ones(64, 64)).sum()
    traces = list((tmp_path / "trace").glob("*.pt.trace.json"))
    assert len(traces) == 1
    events = json.loads(traces[0].read_text())["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events)


def test_metric_watcher_edge_triggered_with_hysteresis():
    fired = []
    w = tmon.MetricWatcher()
    w.watch("lambda", threshold=0.8, direction="above",
            callback=lambda n, v: fired.append(v), hysteresis=0.1)
    for v in [0.5, 0.85, 0.9, 0.95]:
        w.observe("lambda", v)
    assert fired == [0.85]
    w.observe("lambda", 0.65)
    w.observe("lambda", 0.9)
    assert fired == [0.85, 0.9]
    assert w.recent("lambda") == [0.5, 0.85, 0.9, 0.95, 0.65, 0.9]
    below = []
    w.watch("loss", threshold=0.1, direction="below", callback=lambda n, v: below.append(n))
    w.observe("loss", 0.05)
    assert below == ["loss_below_0.1"]


def test_health_monitor_states_and_quorum():
    for mod in (jmon, tmon):
        hm = mod.HealthMonitor(unhealthy_after=2, unresponsive_after_s=5.0)
        for m in ("a", "b", "c"):
            hm.report_success(m)
        assert hm.quorum_healthy()
        hm.report_failure("c")
        hm.report_failure("c")
        assert hm.members["c"].status == "unhealthy"
        assert hm.quorum_healthy()
        hm.members["b"].last_seen -= 10.0
        assert hm.sweep()["b"] == "unresponsive"
        assert not hm.quorum_healthy()


# --- cold tier ----------------------------------------------------------------

def test_feature_storage_roundtrip(tmp_path):
    fs = tct.FeatureStorage.create(tmp_path / "feat.npy", dim=8, num_nodes=100)
    data = np.random.default_rng(0).normal(size=(100, 8)).astype(np.float32)
    fs.write_batch(np.arange(100), data)
    fs.flush()
    got = tct.FeatureStorage.open(tmp_path / "feat.npy").read_batch(np.asarray([5, 50, 99]))
    np.testing.assert_array_equal(got, data[[5, 50, 99]])
    with pytest.raises(ValueError):
        tct.FeatureStorage(tmp_path / "feat.npy", dim=4, num_nodes=100)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_feature_storage_files_cross_packages(tmp_path, writer):
    data = np.random.default_rng(3).normal(size=(40, 6)).astype(np.float32)
    w, r = (jct, tct) if writer == "jax" else (tct, jct)
    fs = w.FeatureStorage.create(tmp_path / "f.npy", dim=6, num_nodes=40)
    fs.write_batch(np.arange(40), data)
    fs.flush()
    np.testing.assert_array_equal(
        r.FeatureStorage.open(tmp_path / "f.npy").read_batch(np.arange(40)), data)


def test_hyperbatch_iterator_covers_epoch(tmp_path):
    fs = tct.FeatureStorage.create(tmp_path / "f.npy", dim=4, num_nodes=25)
    data = np.arange(100, dtype=np.float32).reshape(25, 4)
    fs.write_batch(np.arange(25), data)
    order = np.random.default_rng(1).permutation(25)
    it = tct.HyperbatchIterator(fs, tct.HyperbatchConfig(batch_size=10), order, device=CPU)
    seen = []
    while True:
        batch = it.next_batch()
        if batch is None:
            break
        ids, feats = batch
        assert feats.device.type == "cpu"
        seen.extend(ids.tolist())
        np.testing.assert_array_equal(feats.numpy(), data[ids])
    assert seen == order.tolist()
    assert it.batch_counter == 3
    assert it.copy_seconds() == (0.0, 0.0)


def test_cold_tier_trainer_epoch(tmp_path):
    fs = tct.FeatureStorage.create(tmp_path / "f.npy", dim=4, num_nodes=32)
    fs.write_batch(np.arange(32), np.ones((32, 4), np.float32))
    trainer = tct.ColdTierTrainer(fs, tct.HyperbatchConfig(batch_size=8), device=CPU)
    stats = trainer.train_epoch(lambda ids, feats: torch.mean(feats ** 2))
    assert stats.batches == 4
    np.testing.assert_allclose(stats.loss, 1.0, atol=1e-6)
    assert stats.io_time_s >= 0 and stats.compute_time_s > 0


def test_adaptive_hotset_lfu():
    hs = tct.AdaptiveHotset(capacity=2)
    loads = []

    def loader(i):
        loads.append(i)
        return torch.full((2,), float(i * 10))

    for _ in range(3):
        hs.access(0, loader)
        hs.access(1, loader)
    assert float(hs.access(0, loader)[0]) == 0.0
    assert loads.count(0) == 1
    hs.access(2, loader)
    assert 0 in hs.hit_rate_nodes() and 1 in hs.hit_rate_nodes()
    hs.decay_scores()
    assert all(v < 4 for v in hs.scores.values())


# --- mmap store ---------------------------------------------------------------

def test_mmap_store_roundtrip_and_dirty_flush(tmp_path):
    st = tmm.MmapEmbeddingStore(tmp_path / "emb.bin", num_nodes=300, dim=8, create=True)
    vals = np.random.default_rng(0).normal(size=(300, 8)).astype(np.float32)
    st.set_batch(np.arange(300), vals)
    assert st.flush_dirty() > 0
    assert st.flush_dirty() == 0
    st.set_embedding(5, np.ones(8, np.float32))
    assert st.dirty.test(5 // st.PAGE_ROWS)
    np.testing.assert_array_equal(st.get_embedding(5), np.ones(8))
    st.prefetch(np.asarray([0, 100, 299]))
    st.close()
    st2 = tmm.MmapEmbeddingStore(tmp_path / "emb.bin", num_nodes=300, dim=8)
    np.testing.assert_array_equal(st2.get_embedding(7), vals[7])


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_mmap_store_files_cross_packages(tmp_path, writer):
    """A store (and a gradient accumulator applied to it) written by one
    package reads the same in the other; the dirty pages agree."""
    w, r = (jmm, tmm) if writer == "jax" else (tmm, jmm)
    vals = np.random.default_rng(4).normal(size=(200, 8)).astype(np.float32)
    st = w.MmapEmbeddingStore(tmp_path / "e.bin", num_nodes=200, dim=8, create=True)
    st.set_batch(np.arange(200), vals)
    st.flush_dirty()
    acc = w.MmapGradientAccumulator(tmp_path / "g.bin", num_nodes=200, dim=8)
    acc.accumulate(np.asarray([3, 70, 3]), np.ones((3, 8), np.float32))
    assert acc.apply(st, lr=0.5) == 2
    pages = st.dirty.dirty_pages().tolist()
    assert pages == [0, 1]
    st.close()
    other = r.MmapEmbeddingStore(tmp_path / "e.bin", num_nodes=200, dim=8)
    want = vals.copy()
    want[[3, 70]] -= 0.5
    np.testing.assert_array_equal(other.get_batch(np.arange(200)), want)
    twin = r.DirtyBitmap(4)
    for p in (0, 1):
        twin.set(p)
    assert twin.dirty_pages().tolist() == pages


def test_mmap_gradient_accumulator(tmp_path):
    st = tmm.MmapEmbeddingStore(tmp_path / "e.bin", num_nodes=50, dim=4, create=True)
    st.set_batch(np.arange(50), np.zeros((50, 4), np.float32))
    acc = tmm.MmapGradientAccumulator(tmp_path / "g.bin", num_nodes=50, dim=4)
    acc.accumulate(np.asarray([3, 7]), np.ones((2, 4), np.float32))
    acc.accumulate(np.asarray([3]), np.ones((1, 4), np.float32))
    assert acc.apply(st, lr=0.5) == 2
    np.testing.assert_allclose(st.get_embedding(3), -0.5 * np.ones(4))
    np.testing.assert_allclose(st.get_embedding(7), -0.5 * np.ones(4))
    assert acc.apply(st, lr=0.5) == 0


# --- host orderings (parallel/ordering.py:42-105) --------------------------------

def test_recursive_bisection_order_equals_jax():
    rng = np.random.default_rng(8)
    centers = rng.normal(size=(12, 16)).astype(np.float32)
    feats = (centers[rng.integers(0, 12, size=900)]
             + 0.2 * rng.normal(size=(900, 16))).astype(np.float32)
    pj, lj = jord.recursive_bisection_order(feats, leaf_size=64, seed=3)
    pt, lt = tord.recursive_bisection_order(torch.from_numpy(feats), leaf_size=64, seed=3)
    np.testing.assert_array_equal(pt, pj)
    assert lt == lj and sum(lt) == 900


def test_halo_fraction_equals_jax():
    rng = np.random.default_rng(9)
    nbr = rng.integers(0, 300, size=(300, 6)).astype(np.int32)
    mask = (rng.uniform(size=(300, 6)) > 0.2).astype(np.float32)
    for block in (32, 100, 300):
        assert (tord.halo_fraction(torch.from_numpy(nbr), torch.from_numpy(mask), block)
                == jord.halo_fraction(nbr, mask, block))
