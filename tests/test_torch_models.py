"""Parity of the port's GNN model family (GraphSAGE with fanout sampling,
GCN, GAT, generic message passing, the edge-featured attention under GAT)
against the JAX package, on the CPU.

Inputs are made with numpy from a seed and handed to both packages; the
port's graph holds the JAX graph's arrays, and JAX-initialised
parameters cross over with params_from_numpy. f32 outputs agree within
2e-5; gradients within 2e-5 of each leaf's scale; sampled ids exactly.
The JAX package samples through its native runtime where that builds;
these tests switch it to its Python route (`ruvector_tpu.native.available`
set to False for the test), which the port implements.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ruvector_tpu.native as jnative
from ruvector_tpu.graph import NeighborGraph as JNG
from ruvector_tpu.graph import build_knn_graph as jbuild_knn
from ruvector_tpu.models import gat as jgat
from ruvector_tpu.models import gcn as jgcn
from ruvector_tpu.models import graphsage as jsage
from ruvector_tpu.models import message_passing as jmp
from ruvector_tpu_torch.convert import params_from_numpy
from ruvector_tpu_torch.graph import NeighborGraph
from ruvector_tpu_torch.models import (
    GATConfig,
    GCNConfig,
    GraphSAGEConfig,
    GraphSAGENetConfig,
    gat_apply,
    gat_init,
    gcn_apply,
    gcn_init,
    graphsage_apply,
    graphsage_init,
    graphsage_net_apply,
    graphsage_net_init,
    sample_fanout,
)
from ruvector_tpu_torch.models import message_passing as tmp

F32_TOL = 2e-5


@pytest.fixture
def python_sampling(monkeypatch):
    """The JAX package's Python sampling route (the port's)."""
    monkeypatch.setattr(jnative, "available", False)


def _np_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, atol=F32_TOL):
    np.testing.assert_allclose(np.asarray(got.detach()), np.asarray(want), atol=atol, rtol=0)


def _tgraph(jg) -> NeighborGraph:
    return NeighborGraph(_t(jg.nbr_idx), _t(jg.nbr_mask), _t(jg.edge_weight))


def setup(n=40, d=8, k=4, seed=0):
    """Features and the JAX kNN graph (the anchor's setup), with the
    port's copy of the graph."""
    rng = np.random.default_rng(seed)
    feats = rng.normal(size=(n, d)).astype(np.float32)
    jg = jbuild_knn(jnp.asarray(feats), k=k)
    return feats, jg, _tgraph(jg)


def _ragged():
    """Six nodes of degrees 5, 1, 2, 0, 3, 1 under max degree 5, with edge
    weights."""
    lists = [[1, 2, 3, 4, 5], [0], [0, 1], [], [0, 1, 2], [4]]
    weights = [[1.0, 0.5, 2.0, 0.25, 1.5], [3.0], [1.0, 2.0], [], [0.5, 0.5, 4.0], [2.0]]
    jg = JNG.from_lists(lists, weights=weights, max_degree=5)
    return jg, NeighborGraph.from_lists(lists, weights=weights, max_degree=5, device="cpu")


# --- sampling -----------------------------------------------------------------

@pytest.mark.parametrize("fanout,seed", [(3, 42), (2, 7)])
def test_graphsage_fanout_sampling(python_sampling, fanout, seed):
    jg, tg = _ragged()
    idx, mask = sample_fanout(tg, fanout=fanout, seed=seed)
    jidx, jmask = jsage.sample_fanout(jg, fanout=fanout, seed=seed)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    assert idx.shape == (6, fanout) and idx.dtype == torch.int32
    m = mask.numpy()
    # degree <= fanout kept entirely, degree > fanout down to exactly fanout
    assert m[1].sum() == 1 and m[3].sum() == 0
    assert m[0].sum() == fanout
    assert set(idx.numpy()[0][m[0] > 0].tolist()) <= {1, 2, 3, 4, 5}


def test_sample_fanout_ids_equal_on_knn_graph(python_sampling):
    _, jg, tg = setup(n=60, k=8, seed=3)
    for seed in (42, 43):
        idx, mask = sample_fanout(tg, 5, seed=seed)
        jidx, jmask = jsage.sample_fanout(jg, 5, seed=seed)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
        np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))


# --- GraphSAGE ----------------------------------------------------------------

@pytest.mark.parametrize("agg", ["mean", "max"])
def test_graphsage_forward_mean_and_max(python_sampling, agg):
    feats, jg, tg = setup()
    jidx, jmask = jsage.sample_fanout(jg, fanout=3)
    cfg = GraphSAGEConfig(in_features=8, out_features=12, aggregator=agg)
    jparams = jsage.graphsage_init(jax.random.key(1), jsage.GraphSAGEConfig(8, 12, aggregator=agg))
    want = jsage.graphsage_apply(jparams, jsage.GraphSAGEConfig(8, 12, aggregator=agg),
                                 jnp.asarray(feats), jidx, jmask)
    idx, mask = sample_fanout(tg, fanout=3)
    out = graphsage_apply(params_from_numpy(_np_tree(jparams), "cpu"), cfg, _t(feats), idx, mask)
    assert out.shape == (40, 12)
    _close(out, want)
    norms = np.linalg.norm(out.numpy(), axis=1)
    # L2-normalized (or zero for all-relu-dead rows)
    assert np.all((np.abs(norms - 1.0) < 1e-4) | (norms < 1e-6))


@pytest.mark.parametrize("agg", ["mean", "max"])
def test_graphsage_isolated_node_zero_agg(agg):
    jg, tg = _ragged()
    feats = np.eye(6, 4, dtype=np.float32) + 0.5
    jcfg = jsage.GraphSAGEConfig(in_features=4, out_features=4, aggregator=agg, normalize=False)
    jparams = jsage.graphsage_init(jax.random.key(2), jcfg)
    params = params_from_numpy(_np_tree(jparams), "cpu")
    idx, mask = tg.nbr_idx[:, :2], tg.nbr_mask[:, :2]
    out = graphsage_apply(params, GraphSAGEConfig(4, 4, aggregator=agg, normalize=False),
                          _t(feats), idx, mask)
    want = jsage.graphsage_apply(jparams, jcfg, jnp.asarray(feats), jg.nbr_idx[:, :2],
                                 jg.nbr_mask[:, :2])
    _close(out, want)
    # node 3 has no neighbor: only its self path contributes
    expect = torch.relu(_t(feats[3]) @ params["w_self"])
    _close(out[3], expect, atol=1e-6)


def test_graphsage_net_stack(python_sampling):
    feats, jg, tg = setup(n=30, d=8, k=5)
    jcfg = jsage.GraphSAGENetConfig(in_features=8, hidden_features=16, out_features=12,
                                    fanouts=(4, 3))
    cfg = GraphSAGENetConfig(in_features=8, hidden_features=16, out_features=12, fanouts=(4, 3))
    jparams = jsage.graphsage_net_init(jax.random.key(6), jcfg)
    params = params_from_numpy(_np_tree(jparams), "cpu")
    assert len(params) == 2
    out = graphsage_net_apply(params, cfg, _t(feats), tg)
    assert out.shape == (30, 12)
    _close(out, jsage.graphsage_net_apply(jparams, jcfg, jnp.asarray(feats), jg))
    # deterministic sampling -> identical reruns
    assert torch.equal(out, graphsage_net_apply(params, cfg, _t(feats), tg))


def test_graphsage_net_init_layers():
    cfg = GraphSAGENetConfig(in_features=8, hidden_features=16, out_features=12,
                             fanouts=(4, 3, 2))
    params = graphsage_net_init(0, cfg, device="cpu")
    shapes = [tuple(p["w_neighbor"].shape) for p in params]
    assert shapes == [(8, 16), (16, 16), (16, 12)]
    assert all(p["w_self"].shape == p["w_neighbor"].shape for p in params)
    again = graphsage_net_init(0, cfg, device="cpu")
    assert all(torch.equal(a["w_self"], b["w_self"]) for a, b in zip(params, again))
    assert not torch.equal(params[0]["w_self"], params[0]["w_neighbor"])
    one = graphsage_init(0, GraphSAGEConfig(8, 4), device="cpu")
    assert one["w_self"].shape == (8, 4) and one["w_neighbor"].shape == (8, 4)


# --- GCN ----------------------------------------------------------------------

@pytest.mark.parametrize("normalize,use_bias,use_edge_weights",
                         [(True, True, True), (False, False, False), (True, True, False)])
def test_gcn_forward(normalize, use_bias, use_edge_weights):
    feats, jg, tg = setup()
    jcfg = jgcn.GCNConfig(in_features=8, out_features=6, normalize=normalize, use_bias=use_bias)
    jparams = jgcn.gcn_init(jax.random.key(3), jcfg)
    if use_bias:   # a non-zero bias, so that it is exercised
        jparams["bias"] = jnp.linspace(-0.5, 0.5, 6)
    out = gcn_apply(params_from_numpy(_np_tree(jparams), "cpu"),
                    GCNConfig(8, 6, normalize=normalize, use_bias=use_bias), _t(feats), tg,
                    use_edge_weights=use_edge_weights)
    assert out.shape == (40, 6)
    assert np.all(out.numpy() >= 0)   # relu
    _close(out, jgcn.gcn_apply(jparams, jcfg, jnp.asarray(feats), jg,
                               use_edge_weights=use_edge_weights))


def test_gcn_degree_zero_row():
    jg, tg = _ragged()
    feats = np.random.default_rng(4).normal(size=(6, 8)).astype(np.float32)
    jcfg = jgcn.GCNConfig(in_features=8, out_features=6)
    jparams = jgcn.gcn_init(jax.random.key(5), jcfg)
    out = gcn_apply(params_from_numpy(_np_tree(jparams), "cpu"), GCNConfig(8, 6), _t(feats), tg)
    _close(out, jgcn.gcn_apply(jparams, jcfg, jnp.asarray(feats), jg))
    assert float(out[3].abs().max()) == 0.0   # no neighbor, no bias: relu(0)


def test_gcn_init_shapes():
    p = gcn_init(0, GCNConfig(8, 6), device="cpu")
    assert p["kernel"].shape == (8, 6) and float(p["bias"].abs().max()) == 0.0
    assert "bias" not in gcn_init(0, GCNConfig(8, 6, use_bias=False), device="cpu")


# --- GAT ----------------------------------------------------------------------

@pytest.mark.parametrize("heads,concat", [(4, True), (2, False)])
def test_gat_forward_residual(heads, concat):
    feats, jg, tg = setup(d=16)
    jcfg = jgat.GATConfig(node_dim=16, num_heads=heads, concat_heads=concat)
    jparams = jgat.gat_init(jax.random.key(4), jcfg)
    params = params_from_numpy(_np_tree(jparams), "cpu")
    cfg = GATConfig(node_dim=16, num_heads=heads, concat_heads=concat)
    out = gat_apply(params, cfg, _t(feats), tg)
    _close(out, jgat.gat_apply(jparams, jcfg, jnp.asarray(feats), jg))
    out_nores = gat_apply(params, GATConfig(node_dim=16, num_heads=heads, concat_heads=concat,
                                            residual=False), _t(feats), tg)
    if concat:
        assert out.shape == (40, 16)
        _close(out, out_nores + _t(feats), atol=1e-5)
    else:   # [N, hd] differs from [N, D]: no residual
        assert out.shape == (40, 16 // heads)
        assert torch.equal(out, out_nores)


def test_gat_ragged_graph_and_slope():
    jg, tg = _ragged()
    feats = np.random.default_rng(6).normal(size=(6, 8)).astype(np.float32)
    jcfg = jgat.GATConfig(node_dim=8, num_heads=2, negative_slope=0.05)
    jparams = jgat.gat_init(jax.random.key(7), jcfg)
    out = gat_apply(params_from_numpy(_np_tree(jparams), "cpu"),
                    GATConfig(node_dim=8, num_heads=2, negative_slope=0.05), _t(feats), tg)
    want = jgat.gat_apply(jparams, jcfg, jnp.asarray(feats), jg)
    _close(out, want)
    # node 3 has no neighbor: zero attention, the residual alone
    _close(out[3], feats[3], atol=0.0)


def test_gat_init_shapes():
    p = gat_init(0, GATConfig(node_dim=16, num_heads=4), device="cpu")["attn"]
    assert p["w_node"].shape == (4, 16, 4) and p["w_edge"].shape == (4, 1, 4)
    assert all(p[n].shape == (4, 4) for n in ("a_src", "a_dst", "a_edge"))


# --- differentiability ----------------------------------------------------------

def _sage_pair(feats, jg, tg):
    jcfg = jsage.GraphSAGEConfig(8, 8)
    jidx, jmask = jsage.sample_fanout(jg, 3)
    idx, mask = _t(jidx), _t(jmask)
    return (jsage.graphsage_init(jax.random.key(8), jcfg),
            lambda p, x: jsage.graphsage_apply(p, jcfg, x, jidx, jmask),
            lambda p, x: graphsage_apply(p, GraphSAGEConfig(8, 8), x, idx, mask))


def _gcn_pair(feats, jg, tg):
    jcfg = jgcn.GCNConfig(8, 8)
    return (jgcn.gcn_init(jax.random.key(9), jcfg),
            lambda p, x: jgcn.gcn_apply(p, jcfg, x, jg),
            lambda p, x: gcn_apply(p, GCNConfig(8, 8), x, tg))


def _gat_pair(feats, jg, tg):
    jcfg = jgat.GATConfig(node_dim=8, num_heads=2)
    return (jgat.gat_init(jax.random.key(10), jcfg),
            lambda p, x: jgat.gat_apply(p, jcfg, x, jg),
            lambda p, x: gat_apply(p, GATConfig(node_dim=8, num_heads=2), x, tg))


@pytest.mark.parametrize("model", ["graphsage", "gcn", "gat"])
def test_models_are_differentiable(model):
    """Gradients of sum(out^2) with respect to the parameters and the
    features against jax.grad."""
    feats, jg, tg = setup()
    jparams, japply, tapply = {"graphsage": _sage_pair, "gcn": _gcn_pair,
                               "gat": _gat_pair}[model](feats, jg, tg)
    jgp, jgx = jax.grad(lambda p, x: jnp.sum(japply(p, x) ** 2), argnums=(0, 1))(
        jparams, jnp.asarray(feats))
    params = params_from_numpy(_np_tree(jparams), "cpu")
    leaves, treedef = jax.tree_util.tree_flatten(params)
    leaves = [t.requires_grad_(True) for t in leaves]
    x = _t(feats).requires_grad_(True)
    loss = torch.sum(tapply(jax.tree_util.tree_unflatten(treedef, leaves), x) ** 2)
    grads = torch.autograd.grad(loss, leaves + [x])
    for got, want in zip(grads, jax.tree_util.tree_leaves(jgp) + [jgx]):
        want = np.asarray(want)
        assert np.all(np.isfinite(got.numpy()))
        _close(got, want, atol=F32_TOL * max(1.0, float(np.abs(want).max())))


# --- message passing ------------------------------------------------------------

def test_generic_message_passing():
    jg = JNG.from_lists([[1, 2], [0], []], weights=[[2.0, 1.0], [1.0], []], max_degree=2)
    g = NeighborGraph.from_lists([[1, 2], [0], []], weights=[[2.0, 1.0], [1.0], []],
                                 max_degree=2, device="cpu")
    feats = np.eye(3, dtype=np.float32)
    # default: weighted sum of neighbor features
    out = tmp.propagate(_t(feats), g)
    _close(out[0], [0, 2, 1], atol=1e-6)
    _close(out[2], [0, 0, 0], atol=1e-6)
    _close(out, jmp.propagate(jnp.asarray(feats), jg))
    # mean aggregate ignores edge weight in the custom message
    out2 = tmp.propagate(_t(feats), g, message_fn=lambda nbr, w: nbr, aggregate="mean")
    _close(out2[0], [0, 0.5, 0.5], atol=1e-6)
    # max + custom update
    out3 = tmp.propagate(_t(feats), g, message_fn=lambda nbr, w: nbr, aggregate="max",
                         update_fn=lambda agg, x: agg + x)
    _close(out3[1], [1, 1, 0], atol=1e-6)


@pytest.mark.parametrize("aggregate", ["sum", "mean", "max"])
@pytest.mark.parametrize("custom", [False, True])
def test_propagate_matches_jax(aggregate, custom):
    """Each aggregator on a kNN graph and on a ragged graph with a
    degree-0 row, with the default message and update and with custom
    ones."""
    for feats, jg, tg in (setup(n=30, d=6, k=5, seed=11),
                          (np.random.default_rng(12).normal(size=(6, 6)).astype(np.float32),
                           *_ragged())):
        kw = {}
        if custom:
            kw = {"message_fn": lambda nbr, w: nbr * w[..., None] ** 2 - nbr,
                  "update_fn": lambda agg, x: 0.5 * agg + x}
        got = tmp.propagate(_t(feats), tg, aggregate=aggregate, **kw)
        want = jmp.propagate(jnp.asarray(feats), jg, aggregate=aggregate, **kw)
        _close(got, want)
    assert tmp.AGGREGATORS.keys() == jmp.AGGREGATORS.keys()


def test_propagate_callable_aggregate():
    feats, jg, tg = setup(n=20, d=4, k=3, seed=13)

    def l1(messages, mask):
        return (messages.abs() if isinstance(messages, torch.Tensor)
                else jnp.abs(messages)).sum(1)

    _close(tmp.propagate(_t(feats), tg, aggregate=l1), jmp.propagate(jnp.asarray(feats), jg,
                                                                      aggregate=l1))
