"""The port's parallel package against the JAX package, on the CPU.

Mirrors tests/test_parallel.py case by case: the same numpy inputs and
JAX-initialised parameters go through the JAX function on a 4-device mesh
(tests/conftest.py's virtual CPU devices) and through the port at world 4
under gloo (world 3 for the uneven blocks), at the JAX tests' tolerances.
Each world's ranks are spawned once (a module-scoped fixture runs every
case in one group); the rank functions live in tests/torch_parallel_ranks.py,
which imports no JAX. The halo and overlap plans equal the JAX package's
bit for bit on the native and the Python route. The sharded gated graph
transformer is held against the port's own one-process model: loss and
gradients, gate state, and drifted steps under the global re-solve
budget (the same blocks re-solved, the same masks).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ruvector_tpu.native as jnative
import ruvector_tpu.parallel.partition as jpart
import torch_parallel_ranks as ranks
from ruvector_tpu.graph import NeighborGraph as JGraph
from ruvector_tpu.graph import build_knn_graph as jknn
from ruvector_tpu.models import RuvectorNetConfig as JNetConfig
from ruvector_tpu.models import ruvector_net_apply as jnet_apply
from ruvector_tpu.models import ruvector_net_init as jnet_init
from ruvector_tpu.parallel import make_mesh as jmesh
from ruvector_tpu.parallel import make_sharded_layer_forward as jsharded_forward
from ruvector_tpu.parallel import make_sharded_train_step as jsharded_step
from ruvector_tpu.training.optimizers import adam as jadam
from ruvector_tpu_torch import native
from ruvector_tpu_torch.convert import params_from_numpy
from ruvector_tpu_torch.graph import NeighborGraph
from ruvector_tpu_torch.graph_transformer import GatedGraphTransformerConfig
from ruvector_tpu_torch.models import RuvectorNetConfig
from ruvector_tpu_torch.parallel import (
    EpConfig,
    TpLayerConfig,
    build_halo_plan,
    build_overlap_plan,
    make_blocked_layer_forward,
    make_blocked_train_step,
    pad_features_for_plan,
    reference_attention,
    reference_ep_forward,
    reference_pp_forward,
    reference_tp_layer_forward,
    run_ranks,
)
from ruvector_tpu_torch.training.optimizers import adam

WORLD = 4


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _port_graph(jgraph):
    return NeighborGraph(*(torch.from_numpy(np.asarray(a)) for a in
                           (jgraph.nbr_idx, jgraph.nbr_mask, jgraph.edge_weight)))


def make_setup(n=96, d=16, h=16, k=6, seed=0, n_shards=WORLD):
    """test_parallel.py:24 make_setup, both packages."""
    rng = np.random.default_rng(seed)
    feats = rng.normal(size=(n, d)).astype(np.float32)
    jgraph = jknn(jnp.asarray(feats), k=k)
    jcfg = JNetConfig(input_dim=d, hidden_dim=h, num_layers=2, heads=4)
    jparams = jnet_init(jax.random.key(1), jcfg)
    graph = _port_graph(jgraph)
    plan, perm = build_halo_plan(graph, n_shards)
    return dict(feats=feats, jgraph=jgraph, graph=graph, jcfg=jcfg, jparams=jparams,
                cfg=RuvectorNetConfig(input_dim=d, hidden_dim=h, num_layers=2, heads=4),
                plan=plan, perm=perm)


def _overlap_graph():
    """test_parallel.py:302's clustered adjacency with cross links."""
    rng = np.random.default_rng(7)
    n, d, m = 230, 16, 5
    feats = rng.normal(size=(n, d)).astype(np.float32)
    idx = np.zeros((n, m), np.int32)
    for i in range(n):
        idx[i] = ((i // 32) * 32 + rng.choice(32, m, replace=False)) % n
    idx[::17] = rng.integers(0, n, (len(idx[::17]), m))
    mask = np.ones((n, m), np.float32)
    mask[3] = 0.0
    ew = rng.uniform(0.1, 1.0, (n, m)).astype(np.float32)
    return feats, idx, mask, ew


def _gcn_params(d, h):
    from ruvector_tpu.models.gcn import GCNConfig, gcn_init

    return [(GCNConfig(in_features=d, out_features=h), gcn_init(jax.random.key(0),
                                                                GCNConfig(d, h))),
            (GCNConfig(in_features=h, out_features=h), gcn_init(jax.random.key(1),
                                                                GCNConfig(h, h)))]


def _gated_setup(n_blocks=9, blk=16, d=16, seed=0):
    """__graft_entry__.py:133-150's halo-free layout and config, with
    n_blocks blocks (uneven over the ranks), JAX-initialised weights and
    two drifted feature sets."""
    from ruvector_tpu.graph_transformer import (
        GatedGraphTransformerConfig as JGatedConfig,
        gated_graph_transformer_init as jgated_init,
    )

    rng = np.random.default_rng(seed)
    n_g = n_blocks * blk
    gidx = rng.integers(0, n_g, (n_g, 4)).astype(np.int32)
    gidx = ((gidx % blk) + (np.arange(n_g)[:, None] // blk) * blk).astype(np.int32)
    kw = dict(dim=d, num_heads=2, num_layers=2, gate_chunk=2)
    jparams = jgated_init(jax.random.key(3), JGatedConfig(**kw))
    feats = rng.normal(size=(n_g, d)).astype(np.float32)
    drift1 = feats + 0.5 * rng.normal(size=feats.shape).astype(np.float32)
    drift2 = drift1 + 0.5 * rng.normal(size=feats.shape).astype(np.float32)
    return dict(fn="gated_cases", idx=gidx, mask=np.ones((n_g, 4), np.float32),
                ew=rng.uniform(0.1, 1, (n_g, 4)).astype(np.float32), block=blk, table_pad=8,
                cfg=GatedGraphTransformerConfig(**kw), params=_np(jparams), feats=feats,
                steps=[(feats, None), (drift1, None), (drift2, 3)],
                jparams=jparams, jkw=kw)


@pytest.fixture(scope="module")
def s4():
    return make_setup()


@pytest.fixture(scope="module")
def s3():
    return make_setup(n=90, n_shards=3)


@pytest.fixture(scope="module")
def gated_setup():
    return _gated_setup()


@pytest.fixture(scope="module")
def overlap():
    feats, idx, mask, ew = _overlap_graph()
    graph = NeighborGraph(torch.from_numpy(idx), torch.from_numpy(mask), torch.from_numpy(ew))
    cfg = RuvectorNetConfig(input_dim=16, hidden_dim=16, num_layers=2, heads=4)
    jparams = jnet_init(jax.random.key(0), JNetConfig(input_dim=16, hidden_dim=16,
                                                      num_layers=2, heads=4))
    plan, perm = build_overlap_plan(graph, WORLD, reorder="cluster")
    fpad = np.zeros((plan.n_shards * plan.block, 16), np.float32)
    live = perm >= 0
    fpad[live] = feats[perm[live]]
    return dict(feats=feats, idx=idx, mask=mask, ew=ew, cfg=cfg, jparams=jparams, plan=plan,
                perm=perm, fpad=fpad)


def _neg_ids(setup, q, seed):
    n_pad = setup["plan"].n_shards * setup["plan"].block
    rng = np.random.default_rng(seed)
    return rng.integers(0, setup["graph"].num_nodes, size=(n_pad, q)).astype(np.int32)


@pytest.fixture(scope="module")
def world4(s4, overlap, gated_setup):
    """Every world-4 case, one group of 4 spawned ranks."""
    fpad = pad_features_for_plan(s4["feats"], s4["plan"], s4["perm"], device="cpu").numpy()
    gcn = [(_np(p), (cfg.normalize, cfg.use_bias)) for cfg, p in _gcn_params(16, 16)]
    rng = np.random.default_rng(0)
    tp_cfg = TpLayerConfig(hidden=32, heads=8, head_dim=8, ffn=64)
    tpg_cfg = TpLayerConfig(hidden=16, heads=8, head_dim=4, ffn=32)
    ep_cfg = EpConfig(hidden=16, ffn=32, num_experts=8)
    from ruvector_tpu.parallel import EpConfig as JEp, ep_init as jep_init
    from ruvector_tpu.parallel.tp import TpLayerConfig as JTp, tp_layer_init as jtp_init

    tp_params = _np(jtp_init(jax.random.key(0), JTp(hidden=32, heads=8, head_dim=8, ffn=64)))
    tpg_params = _np(jtp_init(jax.random.key(1), JTp(hidden=16, heads=8, head_dim=4, ffn=32)))
    ep_params = _np(jep_init(jax.random.key(0), JEp(hidden=16, ffn=32, num_experts=8)))
    prng = np.random.default_rng(0)
    pp_params = {"w": (prng.normal(size=(WORLD, 8, 8)) * 0.2).astype(np.float32),
                 "b": (prng.normal(size=(WORLD, 8)) * 0.1).astype(np.float32)}
    pp_x = prng.normal(size=(4, 3, 8)).astype(np.float32)
    srng = np.random.default_rng(0)
    qkv = [srng.normal(size=(32, 16)).astype(np.float32) for _ in range(3)]
    g = {k: v for k, v in gated_setup.items() if k not in ("jparams", "jkw")}
    cases = {
        "halo": dict(fn="halo_cases", cfg=s4["cfg"], plan=s4["plan"], feats_pad=fpad,
                     params=_np(s4["jparams"]), steps=10, lr=3e-3, neg_ids=_neg_ids(s4, 8, 5),
                     gcn=gcn, overlap=dict(plan=overlap["plan"], feats_pad=overlap["fpad"],
                                           params=_np(overlap["jparams"]))),
        "transformer": dict(
            fn="transformer_cases",
            tp=dict(cfg=tp_cfg, params=tp_params, x=rng.normal(size=(10, 32)).astype(np.float32)),
            tp_grad=dict(cfg=tpg_cfg, params=tpg_params,
                         x=np.random.default_rng(1).normal(size=(6, 16)).astype(np.float32)),
            ep=dict(cfg=ep_cfg, params=ep_params,
                    x=np.random.default_rng(0).normal(size=(24, 16)).astype(np.float32)),
            pp=dict(params=pp_params, x=pp_x, m=4), sp=dict(qkv=qkv)),
        "gated": g,
    }
    return run_ranks(ranks.all_cases, WORLD, cases, device="cpu", threads=1)


@pytest.fixture(scope="module")
def world3(s3):
    fpad = pad_features_for_plan(s3["feats"], s3["plan"], s3["perm"], device="cpu").numpy()
    cases = {"halo": dict(fn="halo_cases", cfg=s3["cfg"], plan=s3["plan"], feats_pad=fpad,
                          params=_np(s3["jparams"]))}
    return run_ranks(ranks.all_cases, 3, cases, device="cpu", threads=1)


def _rows(results, case, key):
    return np.concatenate([r[case][key].numpy() for r in results])


def _single(setup):
    return np.asarray(jnet_apply(setup["jparams"], setup["jcfg"], jnp.asarray(setup["feats"]),
                                 setup["jgraph"]))


# --- plans ----------------------------------------------------------------

@pytest.fixture(params=["native", "python"])
def route(request, monkeypatch):
    """Both packages on the native or the Python route."""
    if request.param == "python":
        monkeypatch.setattr(native, "available", False)
        monkeypatch.setattr(jnative, "available", False)
    else:
        assert native.available and jnative.available
    return request.param


@pytest.mark.parametrize("reorder", [False, "bfs", "cluster"])
def test_halo_plan_equals_jax(route, reorder):
    s = make_setup(n=90, n_shards=WORLD)
    plan, perm = build_halo_plan(s["graph"], WORLD, reorder=reorder, min_halo=2)
    jplan, jperm = jpart.build_halo_plan(s["jgraph"], WORLD, reorder=reorder, min_halo=2)
    np.testing.assert_array_equal(perm, jperm)
    assert (plan.n_shards, plan.block, plan.halo) == (jplan.n_shards, jplan.block, jplan.halo)
    for name, arr in plan.host_arrays().items():
        want = getattr(jplan, name)
        assert arr.dtype == want.dtype, name
        np.testing.assert_array_equal(arr, want, err_msg=name)


def test_overlap_plan_equals_jax(route, overlap):
    jgraph = JGraph(*(jnp.asarray(overlap[k]) for k in ("idx", "mask", "ew")))
    graph = NeighborGraph(*(torch.from_numpy(overlap[k]) for k in ("idx", "mask", "ew")))
    plan, perm = build_overlap_plan(graph, WORLD, reorder="cluster")
    jplan, jperm = jpart.build_overlap_plan(jgraph, WORLD, reorder="cluster")
    np.testing.assert_array_equal(perm, jperm)
    assert (plan.bmax, plan.n_interior) == (jplan.bmax, jplan.n_interior)
    for name, arr in plan.host_arrays().items():
        np.testing.assert_array_equal(arr, getattr(jplan, name), err_msg=name)
    assert plan.bytes_per_layer(16) == jplan.bytes_per_layer(16)


def test_halo_plan_global_consistency(s4):
    """test_parallel.py:35: the plan reconstructs the global adjacency."""
    plan, graph = s4["plan"], s4["graph"]
    b, h = plan.block, plan.halo
    nbr = graph.nbr_idx.numpy()
    for s in range(plan.n_shards):
        for i in range(b):
            g_row = s * b + i
            if g_row >= graph.num_nodes:
                continue
            for j in range(plan.local_nbr_idx.shape[2]):
                if plan.nbr_mask[s, i, j] == 0:
                    continue
                local = plan.local_nbr_idx[s, i, j]
                if local < b:
                    g = s * b + local
                else:
                    src, pos = divmod(local - b, h)
                    assert plan.send_mask[src, s, pos] == 1.0
                    g = src * b + plan.send_idx[src, s, pos]
                assert g == nbr[g_row, j], (s, i, j)


# --- sharded forward and training -------------------------------------------

def test_ranks_import_no_jax(world4, world3):
    assert all(r["jax_modules"] == [] for r in world4 + world3)


def test_sharded_forward_matches_single_device(s4, world4):
    out = _rows(world4, "halo", "forward")[: s4["graph"].num_nodes]
    np.testing.assert_allclose(out, _single(s4), atol=2e-4)
    jfwd = jsharded_forward(s4["jcfg"], jpart.build_halo_plan(s4["jgraph"], WORLD)[0], jmesh(4))
    jout = np.asarray(jfwd(s4["jparams"], jpart.pad_features_for_plan(
        s4["feats"], s4["plan"], s4["perm"])))[: s4["graph"].num_nodes]
    np.testing.assert_allclose(out, jout, atol=2e-4)


def test_sharded_forward_uneven_blocks(s3, world3):
    out = _rows(world3, "halo", "forward")
    assert out.shape[0] == s3["plan"].n_shards * s3["plan"].block
    np.testing.assert_allclose(out[: s3["graph"].num_nodes], _single(s3), atol=2e-4)
    np.testing.assert_allclose(out[s3["graph"].num_nodes:], 0.0, atol=1e-6)


def test_sharded_train_step_decreases_loss(s4, world4):
    losses = world4[0]["halo"]["losses"]
    assert all(r["halo"]["losses"] == losses for r in world4)
    assert losses[-1] < losses[0], losses
    assert all(np.isfinite(losses))
    # the JAX package's sharded step on the same inputs, step by step
    jplan = jpart.build_halo_plan(s4["jgraph"], WORLD)[0]
    opt = jadam(3e-3)
    jstep = jsharded_step(s4["jcfg"], jplan, jmesh(4), opt, temperature=0.07)
    p, state = s4["jparams"], opt.init(s4["jparams"])
    fpad = jpart.pad_features_for_plan(s4["feats"], s4["plan"], s4["perm"])
    neg = jnp.asarray(_neg_ids(s4, 8, 5))
    jlosses = []
    for _ in range(10):
        p, state, loss = jstep(p, state, fpad, neg)
        jlosses.append(float(loss))
    np.testing.assert_allclose(losses[0], jlosses[0], rtol=1e-5)
    np.testing.assert_allclose(losses, jlosses, rtol=1e-3)
    # every rank ends with the same parameters
    for r in world4[1:]:
        for a, b in zip(jax.tree_util.tree_leaves(_np(r["halo"]["trained"])),
                        jax.tree_util.tree_leaves(_np(world4[0]["halo"]["trained"]))):
            np.testing.assert_array_equal(a, b)


def test_sharded_train_step_equals_blocked_step(s4, world4):
    """One blocked step in one process gives the sharded step's first loss."""
    params = params_from_numpy(_np(s4["jparams"]), "cpu")
    opt = adam(3e-3)
    step = make_blocked_train_step(s4["cfg"], s4["plan"], opt, 0.07, device="cpu")
    fpad = pad_features_for_plan(s4["feats"], s4["plan"], s4["perm"], device="cpu")
    _, _, loss = step(params, opt.init(params), fpad, torch.from_numpy(_neg_ids(s4, 8, 5)))
    np.testing.assert_allclose(float(loss), world4[0]["halo"]["losses"][0], rtol=1e-5)


def test_sharded_gcn_matches_single_device(s4, world4):
    from ruvector_tpu.models.gcn import gcn_apply

    (c1, p1), (c2, p2) = _gcn_params(16, 16)
    feats = jnp.asarray(s4["feats"])
    ref = np.asarray(gcn_apply(p2, c2, gcn_apply(p1, c1, feats, s4["jgraph"]), s4["jgraph"]))
    out = _rows(world4, "halo", "gcn")[: s4["graph"].num_nodes]
    np.testing.assert_allclose(out, ref, atol=2e-4)


def test_tp_layer_matches_single_device(world4):
    from ruvector_tpu.parallel.tp import (
        TpLayerConfig as JTp, reference_tp_layer_forward as jref, tp_layer_init as jinit,
    )

    jcfg = JTp(hidden=32, heads=8, head_dim=8, ffn=64)
    jp = jinit(jax.random.key(0), jcfg)
    x = np.random.default_rng(0).normal(size=(10, 32)).astype(np.float32)
    want = np.asarray(jref(jp, jcfg, jnp.asarray(x)))
    for r in world4:
        np.testing.assert_allclose(r["transformer"]["tp"].numpy(), want, atol=2e-5)
    port = reference_tp_layer_forward(params_from_numpy(_np(jp), "cpu"),
                                      TpLayerConfig(hidden=32, heads=8, head_dim=8, ffn=64),
                                      torch.from_numpy(x))
    np.testing.assert_allclose(port.numpy(), want, atol=2e-5)


def test_tp_layer_grads_flow(world4):
    for r in world4:
        g = r["transformer"]["tp_grad_wq"]
        assert bool(torch.isfinite(g).all())
        assert float(torch.linalg.norm(g)) > 0


def test_ep_moe_matches_single_device(world4):
    from ruvector_tpu.parallel import (
        EpConfig as JEp, ep_init as jinit, reference_ep_forward as jref,
    )

    jcfg = JEp(hidden=16, ffn=32, num_experts=8)
    jp = jinit(jax.random.key(0), jcfg)
    x = np.random.default_rng(0).normal(size=(24, 16)).astype(np.float32)
    want = np.asarray(jref(jp, jcfg, jnp.asarray(x)))
    for r in world4:
        np.testing.assert_allclose(r["transformer"]["ep"].numpy(), want, atol=2e-5)
    port = reference_ep_forward(params_from_numpy(_np(jp), "cpu"),
                                EpConfig(hidden=16, ffn=32, num_experts=8), torch.from_numpy(x))
    np.testing.assert_allclose(port.numpy(), want, atol=2e-5)
    assign = np.argmax(x @ np.asarray(jp["router"]), axis=-1)
    assert len(set(assign.tolist())) > 2


def test_pp_pipeline_matches_sequential(world4):
    from ruvector_tpu.parallel import make_pp_forward as jpp, reference_pp_forward as jref

    prng = np.random.default_rng(0)
    params = {"w": (prng.normal(size=(WORLD, 8, 8)) * 0.2).astype(np.float32),
              "b": (prng.normal(size=(WORLD, 8)) * 0.1).astype(np.float32)}
    x = prng.normal(size=(4, 3, 8)).astype(np.float32)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    jlayer = lambda p, xb: jnp.tanh(xb @ p["w"] + p["b"])  # noqa: E731
    want = np.asarray(jref(jlayer, jparams, jnp.asarray(x)))
    np.testing.assert_allclose(np.asarray(jpp(jlayer, jmesh(WORLD), 4)(jparams, jnp.asarray(x))),
                               want, atol=2e-5)
    for r in world4:
        np.testing.assert_allclose(r["transformer"]["pp"].numpy(), want, atol=2e-5)
    port = reference_pp_forward(ranks._tanh_layer, params_from_numpy(params, "cpu"),
                                torch.from_numpy(x))
    np.testing.assert_allclose(port.numpy(), want, atol=2e-5)


@pytest.mark.parametrize("causal", [True, False])
def test_ring_attention_matches_dense(world4, causal):
    from ruvector_tpu.parallel import reference_attention as jref

    srng = np.random.default_rng(0)
    q, k, v = (srng.normal(size=(32, 16)).astype(np.float32) for _ in range(3))
    want = np.asarray(jref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal))
    out = np.concatenate([r["transformer"]["sp"][causal].numpy() for r in world4])
    np.testing.assert_allclose(out, want, atol=3e-5)
    port = reference_attention(*(torch.from_numpy(a) for a in (q, k, v)), causal=causal)
    np.testing.assert_allclose(port.numpy(), want, atol=3e-5)


def test_blocked_forward_matches_single_device(s4):
    fwd = make_blocked_layer_forward(s4["cfg"], s4["plan"], device="cpu")
    fpad = pad_features_for_plan(s4["feats"], s4["plan"], s4["perm"], device="cpu")
    out = fwd(params_from_numpy(_np(s4["jparams"]), "cpu"), fpad).numpy()
    np.testing.assert_allclose(out[: s4["graph"].num_nodes], _single(s4), atol=2e-4)


def test_blocked_train_step_decreases_loss(s4):
    params = params_from_numpy(_np(s4["jparams"]), "cpu")
    opt = adam(5e-3)
    state = opt.init(params)
    step = make_blocked_train_step(s4["cfg"], s4["plan"], opt, device="cpu")
    fpad = pad_features_for_plan(s4["feats"], s4["plan"], s4["perm"], device="cpu")
    neg = torch.from_numpy(_neg_ids(s4, 4, 0))
    losses = []
    for _ in range(8):
        params, state, loss = step(params, state, fpad, neg)
        losses.append(float(loss))
    assert losses[-1] < losses[0]
    assert all(np.isfinite(losses))


def test_overlap_plan_matches_unsharded(overlap, world4):
    plan, perm = overlap["plan"], overlap["perm"]
    assert 0 <= plan.n_interior <= plan.block
    model = plan.bytes_per_layer(16)
    assert model["all_gather_bytes"] <= model["all_to_all_padded_bytes_upper"]
    jgraph = JGraph(*(jnp.asarray(overlap[k]) for k in ("idx", "mask", "ew")))
    ref = np.asarray(jnet_apply(overlap["jparams"], JNetConfig(input_dim=16, hidden_dim=16,
                                                               num_layers=2, heads=4),
                                jnp.asarray(overlap["feats"]), jgraph))
    out = _rows(world4, "halo", "overlap")
    live = perm >= 0
    np.testing.assert_allclose(out[live], ref[perm[live]], atol=2e-4)


# --- the sharded gated graph transformer -----------------------------------

@pytest.fixture(scope="module")
def gated_reference(gated_setup):
    c = {k: v for k, v in gated_setup.items() if k not in ("jparams", "jkw", "fn")}
    return ranks.run_gated_unsharded(c)


def _gated_rows(world4, key):
    return [r["gated"][key] for r in world4]


def _cat_state(states):
    return {k: torch.cat([s[k] for s in states], dim=1) for k in states[0]}


def _assert_grads(got, want, tol=1e-5):
    for g_layer, w_layer in zip(got, want):
        for gl, wl in zip(jax.tree_util.tree_leaves(_np(g_layer)),
                          jax.tree_util.tree_leaves(_np(w_layer))):
            scale = max(float(np.abs(wl).max()), 1e-30)
            assert float(np.abs(gl - wl).max()) <= tol * scale


def test_sharded_gated_ranges_are_uneven(world4):
    assert [r["gated"]["range"] for r in world4] == [(0, 3), (3, 5), (5, 7), (7, 9)]


def test_sharded_gated_value_and_grad(world4, gated_reference, gated_setup):
    for r in world4:
        np.testing.assert_allclose(float(r["gated"]["loss"]), float(gated_reference["loss"]),
                                   rtol=1e-5)
        _assert_grads(r["gated"]["grads"], gated_reference["grads"])
    # the JAX package's dry-run program: jit's value_and_grad on the
    # block-sharded layout
    from ruvector_tpu.graph import build_block_dense as jbuild
    from ruvector_tpu.graph_transformer import (
        GatedGraphTransformerConfig as JGatedConfig,
        gated_graph_transformer_loss as jloss,
    )
    from jax.sharding import NamedSharding, PartitionSpec as P

    g = gated_setup
    bdg = jbuild(g["idx"], g["mask"], g["ew"], block=g["block"], table_pad=g["table_pad"])
    fpad = bdg.pad_features(jnp.asarray(g["feats"]))
    shard = NamedSharding(jax.sharding.Mesh(np.asarray(jax.devices()[:3]), ("nodes",)),
                          P("nodes"))
    nb = bdg.n_blocks
    bdg_s = jax.tree_util.tree_map(
        lambda x: jax.device_put(x, shard)
        if hasattr(x, "ndim") and x.ndim >= 1 and x.shape[0] == nb else x, bdg)
    jl, jg = jax.jit(jax.value_and_grad(jloss), static_argnums=1)(
        g["jparams"], JGatedConfig(**g["jkw"]), fpad, bdg_s, jnp.zeros_like(fpad))
    np.testing.assert_allclose(float(world4[0]["gated"]["loss"]), float(jl), rtol=1e-5)
    _assert_grads(world4[0]["gated"]["grads"], jg)


def test_sharded_gate_state_init_equals_unsharded(world4, gated_reference):
    got = _cat_state(_gated_rows(world4, "init"))
    for k, want in gated_reference["init"].items():
        assert torch.equal(got[k], want), k


def test_sharded_steps_take_the_global_budget(world4, gated_reference):
    """Same input: no re-solve; drifted: the global budget (1 block of 9,
    then 3 given) picks the same blocks, masks equal bit for bit."""
    want_nres = [s[2] for s in gated_reference["steps"]]
    assert want_nres[0] == 0
    assert want_nres[1] == 2 and want_nres[2] == 6      # budget per layer, two layers
    for i, (y_ref, st_ref, n_ref) in enumerate(gated_reference["steps"]):
        steps = [r["gated"]["steps"][i] for r in world4]
        assert all(s[2] == n_ref for s in steps), (i, [s[2] for s in steps], n_ref)
        got = _cat_state([s[1] for s in steps])
        for k in ("keep", "age"):
            assert torch.equal(got[k], st_ref[k]), (i, k)
        np.testing.assert_allclose(got["sig"].numpy(), st_ref["sig"].numpy(), rtol=2e-6)
        np.testing.assert_allclose(torch.cat([s[0] for s in steps]).numpy(), y_ref.numpy(),
                                   atol=2e-5)


def test_sharded_masked_grad(world4, gated_reference):
    for r in world4:
        np.testing.assert_allclose(float(r["gated"]["masked_loss"]),
                                   float(gated_reference["masked_loss"]), rtol=1e-5)
        _assert_grads(r["gated"]["masked_grads"], gated_reference["masked_grads"])


def test_slice_refuses_a_table_across_ranks():
    from ruvector_tpu_torch.graph import build_block_dense
    from ruvector_tpu_torch.parallel.gated import slice_block_dense

    rng = np.random.default_rng(0)
    n = 64
    idx = rng.integers(0, n, (n, 4)).astype(np.int32)      # edges across blocks
    bdg = build_block_dense(idx, np.ones((n, 4), np.float32), np.ones((n, 4), np.float32),
                            block=16, table_pad=8, device="cpu")
    assert bdg.table > bdg.block
    with pytest.raises(ValueError, match="other blocks"):
        slice_block_dense(bdg, 0, 2)
    whole = slice_block_dense(bdg, 0, bdg.n_blocks)
    assert torch.equal(whole.local_ids, bdg.local_ids)
    assert dataclasses.replace(whole).n == bdg.n


def test_stateless_gate_runs_do_not_change_the_result(gated_setup):
    """The stateless forward's gate runs (gate_chunk) split the partitions
    only: the loss, the gradients and the cut statistics are those of one
    run over all of them."""
    from ruvector_tpu_torch.graph import build_block_dense
    from ruvector_tpu_torch.graph_transformer import gated

    g = gated_setup
    bdg = build_block_dense(g["idx"], g["mask"], g["ew"], block=g["block"],
                            table_pad=g["table_pad"], device="cpu")
    fpad = bdg.pad_features(torch.from_numpy(g["feats"]))
    results = []
    for chunk in (2, 4, 256):
        cfg = dataclasses.replace(g["cfg"], gate_chunk=chunk)
        params = params_from_numpy(g["params"], "cpu")
        leaves = [t.requires_grad_(True) for layer in params for t in gated._flatten(layer)[1]]
        loss = gated.gated_graph_transformer_loss(params, cfg, fpad, bdg, torch.zeros_like(fpad))
        _, stats = gated.gated_graph_transformer_apply(params, cfg, fpad, bdg, with_stats=True)
        results.append((loss.detach(), torch.autograd.grad(loss, leaves), stats))
    base_loss, base_grads, base_stats = results[-1]
    for loss, grads, stats in results[:-1]:
        np.testing.assert_allclose(float(loss), float(base_loss), rtol=1e-6)
        for a, b in zip(grads, base_grads):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-7)
        for (ap, ac), (bp, bc) in zip(stats, base_stats):
            assert torch.equal(ap, bp)
            np.testing.assert_allclose(ac.numpy(), bc.numpy(), rtol=1e-6)


def test_stateless_forward_without_autograd_equals_with_it(gated_setup):
    """Without autograd the stateless forward feeds the gate's logits to
    the attention; under autograd it recomputes them in a checkpoint. Both
    give the same output and cut statistics."""
    from ruvector_tpu_torch.graph import build_block_dense
    from ruvector_tpu_torch.graph_transformer import gated

    g = gated_setup
    bdg = build_block_dense(g["idx"], g["mask"], g["ew"], block=g["block"],
                            table_pad=g["table_pad"], device="cpu")
    fpad = bdg.pad_features(torch.from_numpy(g["feats"]))
    params = params_from_numpy(g["params"], "cpu")
    for layer in params:
        for t in gated._flatten(layer)[1]:
            t.requires_grad_(True)
    with torch.no_grad():
        out0, stats0 = gated.gated_graph_transformer_apply(params, g["cfg"], fpad, bdg,
                                                           with_stats=True)
    out1, stats1 = gated.gated_graph_transformer_apply(params, g["cfg"], fpad, bdg,
                                                       with_stats=True)
    assert out1.requires_grad and not out0.requires_grad
    np.testing.assert_array_equal(out0.numpy(), out1.detach().numpy())
    for (ap, ac), (bp, bc) in zip(stats0, stats1):
        assert torch.equal(ap, bp)
        np.testing.assert_array_equal(ac.numpy(), bc.numpy())


def test_own_rows_takes_the_rows_or_the_whole_array(gated_setup):
    """A rank's rows come as they are or out of the whole padded array; any
    other length raises, on the mesh and on a gated shard alike."""
    from ruvector_tpu_torch.graph import build_block_dense
    from ruvector_tpu_torch.parallel.gated import GatedShard, slice_block_dense
    from ruvector_tpu_torch.parallel.mesh import Mesh, own_rows

    x = torch.arange(12.0)[:, None]
    assert torch.equal(own_rows(x, 4, 8, 12), x[4:8])
    assert torch.equal(own_rows(x[4:8], 4, 8, 12), x[4:8])
    with pytest.raises(ValueError, match="expected 4 or 12 rows, got 11"):
        own_rows(x[:11], 4, 8, 12)
    rank1 = Mesh(group=None, rank=1, size=2, axis_name="nodes", device=torch.device("cpu"))
    assert torch.equal(rank1.own_rows(x[:6], 3), x[3:6])
    with pytest.raises(ValueError, match="expected 3 or 6 rows, got 5"):
        rank1.own_rows(x[:5], 3)
    mesh = Mesh(group=None, rank=0, size=1, axis_name="nodes", device=torch.device("cpu"))

    g = gated_setup
    bdg = build_block_dense(g["idx"], g["mask"], g["ew"], block=g["block"],
                            table_pad=g["table_pad"], device="cpu")
    b, nb = bdg.block, bdg.n_blocks
    shard = GatedShard(mesh, slice_block_dense(bdg, 1, 2), 1, 2, nb)
    whole = torch.arange(float(nb * b))[:, None]
    assert torch.equal(shard.own(whole), whole[b:2 * b])
    assert torch.equal(shard.own(whole[b:2 * b]), whole[b:2 * b])
    with pytest.raises(ValueError, match="rows, got"):
        shard.own(whole[:(nb - 1) * b])
