"""The port's native runtime (ruvector_tpu_torch/native) against the JAX
package's (tests/test_native.py, case for case).

Both packages build byte-identical C++ sources with the same g++ flags,
so every native route must give the JAX package's arrays bit for bit.
build_block_dense's three routes (Python, native host fill, device fill)
are held to one another and to the JAX package's builder.
"""

import hashlib
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ruvector_tpu import native as jnative
from ruvector_tpu.graph import NeighborGraph as JNeighborGraph
from ruvector_tpu.graph.block_dense import build_block_dense as jbuild_block_dense
from ruvector_tpu_torch import native
from ruvector_tpu_torch.attention.mincut import _Dinic
from ruvector_tpu_torch.graph import NeighborGraph, build_block_dense
from ruvector_tpu_torch.graph.block_dense import _EPS_EDGE

REPO = Path(__file__).resolve().parents[1]


def random_graph(rng, n=60, max_deg=6):
    """tests/test_native.py's random graph, as numpy (nbr, mask, weight)."""
    lists, weights = [], []
    for _ in range(n):
        deg = int(rng.integers(0, max_deg + 1))
        lists.append(rng.choice(n, size=deg, replace=False).tolist())
        weights.append(rng.random(deg).astype(np.float32).tolist())
    g = JNeighborGraph.from_lists(lists, weights, max_degree=max_deg)
    return np.array(g.nbr_idx), np.array(g.nbr_mask), np.array(g.edge_weight)


def _bf16_words(wd) -> np.ndarray:
    if isinstance(wd, torch.Tensor):
        return wd.view(torch.int16).numpy().view(np.uint16)
    return np.asarray(wd).view(np.uint16)


def _block_graph(seed, n, m, dup=False):
    rng = np.random.default_rng(seed)
    idx = np.stack([rng.choice(n, m, replace=False) for _ in range(n)]).astype(np.int32)
    mask = (rng.uniform(size=(n, m)) > 0.1).astype(np.float32)
    mask[5] = 0.0                       # isolated node
    ew = rng.uniform(0, 1, (n, m)).astype(np.float32)
    ew[7] = 0.0                         # uniform-fallback row
    ew[9, 0] = 0.0                      # zero-weight edge -> eps floor
    if dup:
        idx[0, 1] = idx[0, 0]
    return idx, mask, ew


def test_native_builds():
    assert native.available and native.build_error is None
    assert jnative.available


def test_bfs_reorder_equals_jax():
    nbr, mask, _ = random_graph(np.random.default_rng(0))
    order = native.bfs_reorder(nbr, mask)
    assert sorted(order.tolist()) == list(range(nbr.shape[0]))
    np.testing.assert_array_equal(order, jnative.bfs_reorder(nbr, mask))


def test_label_propagation_order_equals_jax():
    nbr, mask, _ = random_graph(np.random.default_rng(5), n=200)
    order = native.label_propagation_order(nbr, mask, iters=10)
    assert sorted(order.tolist()) == list(range(nbr.shape[0]))
    np.testing.assert_array_equal(order, jnative.label_propagation_order(nbr, mask, iters=10))


def test_halo_plan_equals_jax():
    nbr, mask, _ = random_graph(np.random.default_rng(1), n=64)
    got = native.halo_plan(nbr, mask, 4, 16)
    want = jnative.halo_plan(nbr, mask, 4, 16)
    assert got[0] == want[0]
    for a, b in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("trial", range(5))
def test_native_mincut_matches_python_dinic(trial):
    """The native gate's cut equals the Python Dinic's max flow (1e-4 as in
    tests/test_native.py), and equals the JAX package's native gate bit for
    bit."""
    rng = np.random.default_rng(2 + 100 * trial)
    seq = int(rng.integers(3, 10))
    logits = rng.normal(size=(seq, seq)).astype(np.float32)
    keep, cost = native.dinic_mincut_gate(logits, lam=0.5, eps=0.01)
    jkeep, jcost = jnative.dinic_mincut_gate(logits, lam=0.5, eps=0.01)
    np.testing.assert_array_equal(keep, jkeep)
    assert cost == jcost
    clamped = np.where(logits > 0.01, logits, 0.0)
    d = _Dinic(seq)
    for i in range(seq):
        for j in range(seq):
            if clamped[i, j] > 0:
                d.add_edge(i, j, float(clamped[i, j]))
    flow = d.max_flow(0, seq - 1)
    pos = clamped > 0
    if pos.sum() == 0:
        assert keep.sum() == 0
        return
    if flow <= 0.5 * clamped[pos].mean():
        np.testing.assert_allclose(cost, flow, rtol=1e-4, atol=1e-5)
    else:
        assert cost == 0.0
        np.testing.assert_array_equal(keep, pos)
    assert not np.any(keep & ~pos)


def test_native_sample_fanout_equals_jax():
    nbr, mask, _ = random_graph(np.random.default_rng(3))
    idx, smask = native.sample_fanout(nbr, mask, fanout=3, seed=42)
    jidx, jmask = jnative.sample_fanout(nbr, mask, fanout=3, seed=42)
    np.testing.assert_array_equal(idx, jidx)
    np.testing.assert_array_equal(smask, jmask)
    gm = mask > 0
    for i in range(nbr.shape[0]):
        k = int(smask[i].sum())
        assert k == min(int(gm[i].sum()), 3)
        picked = idx[i][smask[i] > 0]
        assert set(picked.tolist()) <= set(nbr[i][gm[i]].tolist())
        assert len(set(picked.tolist())) == k


def test_native_csr_equals_jax_and_python():
    nbr, mask, w = random_graph(np.random.default_rng(4))
    got = native.to_csr(nbr, mask, w)
    for a, b in zip(got, jnative.to_csr(nbr, mask, w)):
        np.testing.assert_array_equal(a, b)
    csr = NeighborGraph(torch.from_numpy(nbr), torch.from_numpy(mask),
                        torch.from_numpy(w)).to_csr()
    np.testing.assert_array_equal(got[0], csr.row_ptr.numpy())
    np.testing.assert_array_equal(got[1], csr.col_idx.numpy())
    np.testing.assert_array_equal(got[2], csr.values.numpy())


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_bdense_build_equals_jax(bf16):
    """The threaded host fill, f32 and bf16 words, against the JAX
    package's, bit for bit (n = 1300 with a tail block, B = 256)."""
    idx, mask, ew = _block_graph(3, 1300, 10)
    got = native.bdense_build(idx, mask, ew, block=256, eps_edge=_EPS_EDGE, bf16=bf16)
    want = jnative.bdense_build(idx, mask, ew, block=256, eps_edge=_EPS_EDGE, bf16=bf16)
    assert got[5] == want[5] == 0
    if bf16:
        assert got[1].dtype == torch.bfloat16
        np.testing.assert_array_equal(_bf16_words(got[1]), _bf16_words(want[1]))
    else:
        np.testing.assert_array_equal(got[1], want[1])
    for i in (0, 2, 3, 4):
        np.testing.assert_array_equal(got[i], want[i])


def test_bdense_plan_equals_jax():
    idx, mask, _ = _block_graph(3, 1000, 16)
    got = native.bdense_plan(idx, mask, block=128)
    want = jnative.bdense_plan(idx, mask, block=128)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert got[2] == 0 and got[1].max() == got[0].shape[1]   # masked edges carry T


def test_bdense_build_duplicate_slots_fall_back():
    idx = np.asarray([[1, 1], [0, 0]], np.int32)
    ones = np.ones((2, 2), np.float32)
    assert native.bdense_build(idx, ones, ones, block=2)[5] == 1
    assert native.bdense_plan(idx, ones, block=2)[2] == 1
    for device_fill in (None, False):
        bdg = build_block_dense(idx, ones, ones, block=2, device_fill=device_fill,
                                device="cpu")
        assert bdg.log_mult is not None


def test_gen_cluster_knn_equals_jax():
    n, d, k, cl = 1024, 32, 8, 128
    feats, idx, ew = native.gen_cluster_knn(n, d, k, cl, seed=7)
    jf, ji, jw = jnative.gen_cluster_knn(n, d, k, cl, seed=7)
    np.testing.assert_array_equal(feats, jf)
    np.testing.assert_array_equal(idx, ji)
    np.testing.assert_array_equal(ew, jw)
    rows = np.arange(n)
    assert (idx // cl == (rows // cl)[:, None]).all() and (idx != rows[:, None]).all()
    r = 33
    dvec = np.linalg.norm(feats[idx[r]] - feats[r], axis=1)
    np.testing.assert_allclose(ew[r], 1.0 / (1.0 + dvec), rtol=1e-4)


def _tables(bdg):
    wd = bdg.wdense
    wd = _bf16_words(wd) if wd.dtype == torch.bfloat16 else wd.numpy()
    return dict(local_ids=bdg.local_ids.numpy(), wdense=wd, degrees=bdg.degrees.numpy(),
                node_pad=bdg.node_pad.numpy(), node_pos=bdg.node_pos.numpy())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_build_block_dense_three_routes(dtype, monkeypatch):
    """The device fill (device_fill None and False: the port keeps JAX's
    argument and builds both ways by the device fill) == the Python route,
    bit for bit, in f32 and bf16, and == the JAX package's default route."""
    idx, mask, ew = _block_graph(3, 1000, 16)
    device = build_block_dense(idx, mask, ew, block=128, dtype=dtype, device="cpu")
    asked_host = build_block_dense(idx, mask, ew, block=128, dtype=dtype, device_fill=False,
                                   device="cpu")
    jdt = np.float32 if dtype == torch.float32 else jnp.bfloat16
    jax_default = jbuild_block_dense(idx, mask, ew, block=128, dtype=jdt)
    monkeypatch.setattr(native, "available", False)
    python = build_block_dense(idx, mask, ew, block=128, dtype=dtype, device="cpu")
    a, h, p = _tables(device), _tables(asked_host), _tables(python)
    for name in a:
        np.testing.assert_array_equal(a[name], p[name], err_msg=name)
        np.testing.assert_array_equal(h[name], p[name], err_msg=name)
    assert device.wdense.dtype == asked_host.wdense.dtype == python.wdense.dtype == dtype
    jw = np.asarray(jax_default.wdense)
    jw = jw.view(np.uint16) if dtype == torch.bfloat16 else jw
    np.testing.assert_array_equal(a["wdense"], jw)
    np.testing.assert_array_equal(a["local_ids"], np.asarray(jax_default.local_ids))
    assert device.log_mult is None and python.log_mult is None


def test_library_location_and_key(monkeypatch):
    """The libraries live under ruvector_tpu_torch/_build/native/ (ignored
    by git); the name changes with the source, the flags and the CPU."""
    path = native.library_path("graph_runtime")
    assert path.parent == REPO / "ruvector_tpu_torch" / "_build" / "native"
    assert "ruvector_tpu_torch/_build/" in (REPO / ".gitignore").read_text().split()
    assert path.exists() and native._libs["graph_runtime"]._name == str(path)
    assert native.library_path("graph_runtime", flags=native.CXX_FLAGS[1:]) != path
    assert native.library_path("hnsw") != path
    assert native.CXX_FLAGS == ("-O3", "-march=native", "-funroll-loops", "-shared", "-fPIC",
                                "-std=c++17", "-pthread")
    monkeypatch.setattr(native, "cpu_signature", lambda: "model name=another CPU")
    assert native.library_path("graph_runtime") != path


@pytest.mark.parametrize("name", ["graph_runtime", "hnsw"])
def test_sources_are_the_jax_packages(name):
    """The port's C++ is a byte-for-byte copy: a change to either copy is a
    deliberate one."""
    def digest(p):
        return hashlib.sha256(p.read_bytes()).hexdigest()

    assert digest(native.SOURCE_DIR / f"{name}.cpp") == \
        digest(REPO / "ruvector_tpu" / "native" / f"{name}.cpp")


_BUILD = """
import sys
from pathlib import Path
import ruvector_tpu_torch.native as n
n.BUILD_DIR = Path(sys.argv[1])
lib = n.load_library("hnsw")
print(Path(lib._name).name)
"""


def test_concurrent_builders_load_one_whole_library(tmp_path):
    """Three processes build the same library into one empty directory at
    once: each renames its own temporary file into place, so every one
    loads a whole library and no temporary file is left."""
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD, str(tmp_path)], cwd=REPO,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(3)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert all(p.returncode == 0 for p in procs), [o[1] for o in outs]
    names = {o[0].strip() for o in outs}
    assert len(names) == 1 and sorted(q.name for q in tmp_path.iterdir()) == sorted(names)
