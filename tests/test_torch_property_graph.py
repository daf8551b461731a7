"""The port's property graph and Cypher engine (ruvector_tpu_torch/graph/
{property,cypher}.py) against the JAX package's.

Every case of tests/test_property_graph.py and tests/test_cypher.py runs
twice (tests/torch_mirror.py): as written, on the JAX package, and with
its imports pointed at the port. Each run records what the engine
returns for every query (CypherEngine.execute, which execute_cypher and
the shell call) and what every public method of PropertyGraph and
Transaction returns (lookups, CRUD, the lowerings to_neighbor_graph,
to_csr and feature_matrix); the case's own assertions hold on the port,
and the two records must be equal, bit for bit: the same rows in the
same order, the same lookups, the same padded graph and the same CSR.
The port's lowerings run on the CPU here (device="cpu").
"""

import numpy as np
import pytest
import torch

import ruvector_tpu.graph.cypher as jcypher
import ruvector_tpu.graph.property as jproperty
import ruvector_tpu_torch.graph.cypher as tcypher
import ruvector_tpu_torch.graph.property as tproperty
from tests.torch_mirror import Recorder, cases, compare_logs, run_case

ANCHORS = ("test_property_graph.py", "test_cypher.py")
CASES = [(a, c) for a in ANCHORS for c in cases(a)]


def _record(monkeypatch, cypher, prop, port: bool) -> list:
    rec = Recorder(monkeypatch, port)
    rec.methods(cypher.CypherEngine, names=("execute",))
    rec.methods(prop.PropertyGraph, cpu=("to_neighbor_graph", "to_csr"))
    rec.methods(prop.Transaction)
    return rec.log


@pytest.mark.parametrize("anchor,case", CASES, ids=[f"{a[5:-3]}::{c}" for a, c in CASES])
def test_same_answers_as_jax(anchor, case, monkeypatch, tmp_path):
    want = _record(monkeypatch, jcypher, jproperty, port=False)
    run_case(anchor, case, False, tmp_path / "jax")
    got = _record(monkeypatch, tcypher, tproperty, port=True)
    run_case(anchor, case, True, tmp_path / "port")
    compare_logs(got, want)


def test_every_anchor_case_is_mirrored():
    assert len(cases("test_property_graph.py")) == 15 and len(cases("test_cypher.py")) == 32


def test_lowering_lands_on_the_requested_device():
    g = tproperty.PropertyGraph.from_edge_list(np.array([0, 0, 1]), np.array([1, 2, 2]),
                                               np.array([1.0, 2.0, 3.0], np.float32))
    ng, ids = g.to_neighbor_graph(device="cpu")
    csr, ids2 = g.to_csr(device="cpu")
    assert ids == ids2 == ["0", "1", "2"]
    assert ng.nbr_idx.device.type == csr.row_ptr.device.type == "cpu"
    assert csr.row_ptr.dtype == torch.int32 and csr.row_ptr.tolist() == [0, 2, 3, 3]
    assert csr.col_idx.tolist() == [1, 2, 2] and csr.values.tolist() == [1.0, 2.0, 3.0]
