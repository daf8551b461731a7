"""The port's min-cut toolkit (ruvector_tpu_torch/mincut) and its native
maintainers against the JAX package's.

Every case of tests/test_global_mincut.py, tests/test_incremental_mincut.py
and tests/test_mincut_toolkit.py runs twice (tests/torch_mirror.py): as
written, on the JAX package, and with its imports pointed at the port.
Each run records what the maintainers (both backends: the native
s-t and global solvers and the Python ones) and the toolkit functions
return; the case's own assertions hold on the port, and the records must
be equal: cut values, partitions, cut edges and certificates bit for bit
where the code is host C++ or numpy, and cut values at 1e-4 relative
where the port computes on torch (the PPR push of local_cluster and the
expander decomposition, the CG solves of the sparsifier). The
sparsifier's draws see probabilities that move with the resistances'
last bits, so the port's resistances are held to JAX's at 1e-4 and the
port then samples from JAX's: the sampled edges must be equal.
"""

import numpy as np
import pytest

import ruvector_tpu.mincut as jmincut
import ruvector_tpu.native as jnative
import ruvector_tpu_torch.mincut as tmincut
import ruvector_tpu_torch.native as tnative
from ruvector_tpu.graph.csr import CSRGraph as JCSRGraph
from ruvector_tpu.mincut.sparsify import effective_resistances as jeffective_resistances
from ruvector_tpu_torch.attention.trainable import TrainableAttention
from ruvector_tpu_torch.graph.csr import CSRGraph
from ruvector_tpu_torch.mincut import dynamic, expander, global_dynamic, jtree, local, sparsify
from ruvector_tpu_torch.mincut.sparsify import effective_resistances
from tests.torch_mirror import Recorder, cases, compare_logs, params, run_case

ANCHORS = ("test_global_mincut.py", "test_incremental_mincut.py", "test_mincut_toolkit.py")
CASES = [(a, c, p) for a in ANCHORS for c in cases(a) for p in params(a, c)]
# where the port computes on torch: 1e-4 relative (the JAX tests' own limit)
TORCH_TOL = dict(rtol=1e-4, atol=1e-6)
FUNCTIONS = ("stoer_wagner", "noi_mincut", "conductance", "local_cluster", "local_k_cut",
             "expander_decompose", "spectral_sparsify", "cut_value")


def _modules(pkg):
    return [pkg] + [getattr(pkg, m) for m in ("dynamic", "global_dynamic", "local", "sparsify",
                                              "expander", "jtree")]


def _record(monkeypatch, pkg, native, port: bool, resistances: list) -> list:
    rec = Recorder(monkeypatch, port)
    for owner in (pkg.dynamic.DynamicMinCut, pkg.dynamic.GlobalMinCutFacade,
                  pkg.global_dynamic.GlobalDynamicMinCut, pkg.jtree.JTree,
                  native.IncrementalMinCut, native.GlobalIncrementalMinCut):
        rec.methods(owner)
    rec.functions(_modules(pkg), FUNCTIONS, cpu=("spectral_sparsify",))
    if not port:
        def record_r(*args, **kw):
            r = jeffective_resistances(*args, **kw)
            resistances.append(r)
            return r

        monkeypatch.setattr(jmincut.sparsify, "effective_resistances", record_r)
    else:
        rec.cpu_default(CSRGraph, "from_edges")
        rec.cpu_default(TrainableAttention, "__init__")

        def same_z(*args, **kw):
            r = effective_resistances(*args, **kw)
            want = resistances.pop(0)
            np.testing.assert_allclose(r, want, rtol=1e-4, atol=1e-9)
            return want

        monkeypatch.setattr(tmincut.sparsify, "effective_resistances", same_z)
    return rec.log


def _case_id(case):
    anchor, name, param = case
    return f"{anchor[5:-3]}::{name}" + ("" if param is None else f"[{param}]")


@pytest.mark.parametrize("anchor,case,param", CASES, ids=[_case_id(c) for c in CASES])
def test_same_cuts_as_jax(anchor, case, param, monkeypatch, tmp_path):
    resistances = []
    want = _record(monkeypatch, jmincut, jnative, False, resistances)
    run_case(anchor, case, False, tmp_path / "jax", param)
    got = _record(monkeypatch, tmincut, tnative, True, resistances)
    run_case(anchor, case, True, tmp_path / "port", param)
    assert not resistances
    torch_side = any(s in case for s in ("local_cluster", "expander", "jtree", "sparsif"))
    compare_logs(got, want, **(TORCH_TOL if torch_side else {}))


def test_every_anchor_case_is_mirrored():
    assert [len(cases(a)) for a in ANCHORS] == [14, 4, 14]
    assert len(CASES) == 20 + 8 + 16


def _planted_clusters(n_per=20, seed=2):
    rng = np.random.default_rng(seed)
    edges = []
    for block in (range(n_per), range(n_per, 2 * n_per)):
        for i in block:
            for j in block:
                if i < j and rng.random() < 0.5:
                    edges.append((i, j, 1.0))
    edges.append((5, n_per + 5, 0.1))
    src = np.asarray([e[0] for e in edges] + [e[1] for e in edges])
    dst = np.asarray([e[1] for e in edges] + [e[0] for e in edges])
    return src, dst, np.asarray([e[2] for e in edges] * 2, np.float32), 2 * n_per


def test_effective_resistances_match_jax():
    """The 12 CG Laplacian solves on the port (CPU) against JAX's: 1e-4
    relative."""
    rng = np.random.default_rng(0)
    n, m = 60, 900
    src = rng.integers(0, n, size=m)
    dst = (src + 1 + rng.integers(0, n - 1, size=m)) % n
    w = rng.uniform(0.5, 2.0, size=m)
    np.testing.assert_allclose(effective_resistances(src, dst, w, n, device="cpu"),
                               jeffective_resistances(src, dst, w, n), rtol=1e-4, atol=1e-9)


def test_local_toolkit_on_a_device_graph_matches_jax():
    """local_cluster, local_k_cut, expander_decompose and JTree on the
    port's CSR tensors (read to the host once per call) against JAX's."""
    src, dst, w, n = _planted_clusters()
    g = CSRGraph.from_edges(src, dst, w, n, device="cpu")
    jg = JCSRGraph.from_edges(src, dst, w, n)
    members, phi = local.local_cluster(g, seed=3)
    jmembers, jphi = jmincut.local_cluster(jg, seed=3)
    np.testing.assert_array_equal(np.sort(members), np.sort(jmembers))
    assert phi == pytest.approx(jphi, rel=1e-4)
    cut, jcut = local.local_k_cut(g, seed=3, k=5.0), jmincut.local_k_cut(jg, seed=3, k=5.0)
    np.testing.assert_array_equal(cut.members, jcut.members)
    assert cut.value == pytest.approx(jcut.value, rel=1e-6) and cut.cut_edges == jcut.cut_edges
    labels, clusters, boundary = expander.expander_decompose(g, phi_target=0.1)
    jlabels, jclusters, jboundary = jmincut.expander_decompose(jg, phi_target=0.1)
    np.testing.assert_array_equal(labels, jlabels)
    assert boundary == jboundary and len(clusters) == len(jclusters)
    jt, jjt = jtree.JTree(g, phi_target=0.2), jmincut.JTree(jg, phi_target=0.2)
    assert jt.query_cut_upper_bound(0, 25) == pytest.approx(
        jjt.query_cut_upper_bound(0, 25), rel=1e-6)
    assert len(jt.levels) == len(jjt.levels)


def test_both_backends_are_chosen_as_in_jax(monkeypatch):
    """`auto` takes the native maintainers where the runtime is built and
    the Python ones otherwise; `native` raises without the runtime."""
    assert dynamic.DynamicMinCut(4)._inc is not None
    assert isinstance(dynamic.DynamicMinCut(4, source=None)._g, tnative.GlobalIncrementalMinCut)
    assert dynamic.DynamicMinCut(4, backend="python")._inc is None
    monkeypatch.setattr(tnative, "available", False)
    assert dynamic.DynamicMinCut(4)._inc is None
    assert isinstance(dynamic.DynamicMinCut(4, source=None)._g,
                      global_dynamic.GlobalDynamicMinCut)
    with pytest.raises(RuntimeError, match="unavailable"):
        dynamic.DynamicMinCut(4, backend="native")
    assert sparsify.cut_value([0, 1], [1, 2], [1.0, 2.0], np.array([True, False, False])) == 1.0


def test_python_maintainer_on_paths_past_the_recursion_limit():
    """A ring of 3,000 nodes: a decrease repair runs Dinic along ~1,500
    nodes. The JAX package's Python Dinic recurses once a node and raises
    RecursionError there; the port's runs on an explicit stack and gives
    the native maintainer's cut at every query."""
    from ruvector_tpu.mincut.global_dynamic import GlobalDynamicMinCut as JGlobal

    n = 3000
    rng = np.random.default_rng(4)
    w = rng.uniform(0.5, 1.5, n)
    port, nat, jax_py = (global_dynamic.GlobalDynamicMinCut(n),
                         tnative.GlobalIncrementalMinCut(n), JGlobal(n))
    for i in range(n):
        for mc in (port, nat, jax_py):
            mc.insert_edge(i, (i + 1) % n, float(w[i]))
    assert port.cut_value() == pytest.approx(nat.cut_value(), rel=1e-6)
    jax_py.cut_value()
    for step, i in enumerate((700, 1500, 2200)):
        port.reweight_edge(i, i + 1, 0.3 * float(w[i]))
        nat.reweight_edge(i, i + 1, 0.3 * float(w[i]))
        assert port.cut_value() == pytest.approx(nat.cut_value(), rel=1e-6), step
    with pytest.raises(RecursionError):
        jax_py.reweight_edge(700, 701, 0.3 * float(w[700]))
        jax_py.cut_value()
