"""Parity of the port's training package against the JAX package, on the
CPU: losses (and the info_nce/EWC goldens at test_goldens.py's
tolerances), distances, the optimizers' update rules over 5 updates,
the schedules, EWC, the replay buffer (test_training.py's behaviour) and
one contrastive train step (adam; plain, with EWC, with train_features)
and one online update through the RuvectorLayer.

Tolerances: elementwise ops and losses 1e-5 relative (float32 in another
order); optimizer states after 5 updates 1e-5; train-step loss and
parameters 1e-5 relative (one RuvectorLayer forward and backward).
"""

import dataclasses
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import ruvector_tpu.training as jt
import ruvector_tpu.training.train as jtrain
from ruvector_tpu.graph import build_knn_graph as jknn
from ruvector_tpu.nn import RuvectorLayerConfig as JLayerCfg
from ruvector_tpu.nn import ruvector_layer_init as jlayer_init
from ruvector_tpu.ops import distance as jdist
from ruvector_tpu_torch import training as tt
from ruvector_tpu_torch.convert import params_from_numpy
from ruvector_tpu_torch.graph import NeighborGraph
from ruvector_tpu_torch.nn.ruvector_layer import RuvectorLayerConfig
from ruvector_tpu_torch.ops import distance as tdist
from ruvector_tpu_torch.training import train as ttrain
from ruvector_tpu_torch.training.optimizers import tree_leaves, tree_map

GOLDEN = json.loads((Path(__file__).parent / "goldens" / "goldens.json").read_text())
RTOL = 1e-5


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _rng_arrays(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32) for s in shapes]


# --- losses and distances ---------------------------------------------------

def test_info_nce_and_ewc_match_goldens():
    """test_goldens.py:107-131, the same tolerances."""
    nce = GOLDEN["inputs"]["nce"]
    loss = tt.info_nce_loss(_t(nce["anchor"]), _t(nce["positives"]), _t(nce["negatives"]),
                            nce["temperature"])
    np.testing.assert_allclose(float(loss), GOLDEN["cases"]["info_nce"], rtol=2e-5)
    e = GOLDEN["inputs"]["ewc"]
    state = tt.EWCState(fisher=_t(e["fisher"]), anchor=_t(e["anchor"]), lam=e["lambda"],
                        active=True)
    np.testing.assert_allclose(float(tt.ewc_penalty(state, _t(e["weights"]))),
                               GOLDEN["cases"]["ewc_penalty"], rtol=2e-5)
    np.testing.assert_allclose(tt.ewc_gradient(state, _t(e["weights"])).numpy(),
                               np.asarray(GOLDEN["cases"]["ewc_gradient"], np.float32),
                               rtol=2e-4)


@pytest.mark.parametrize("masked", [False, True])
def test_batched_info_nce_matches_jax(masked):
    a, p, q = _rng_arrays(0, (5, 8), (5, 4, 8), (5, 6, 8))
    mask = (np.random.default_rng(1).uniform(size=(5, 4)) > 0.4).astype(np.float32)
    mask[2] = 0.0                                  # an anchor without positives
    m = mask if masked else None
    got = tt.batched_info_nce(_t(a), _t(p), _t(q), 0.07, None if m is None else _t(m))
    want = jt.batched_info_nce(jnp.asarray(a), jnp.asarray(p), jnp.asarray(q), 0.07,
                               None if m is None else jnp.asarray(m))
    np.testing.assert_allclose(float(got), float(want), rtol=RTOL)


def test_pointwise_losses_match_jax():
    pred, tgt = _rng_arrays(2, (4, 8), (4, 8))
    probs = np.abs(pred) / np.abs(pred).sum(1, keepdims=True)
    onehot = np.eye(8, dtype=np.float32)[[1, 3, 5, 7]]
    bern = 1.0 / (1.0 + np.exp(-pred))
    for tfn, jfn, x, y in ((tt.mse_loss, jt.mse_loss, pred, tgt),
                           (tt.cross_entropy_loss, jt.cross_entropy_loss, probs, onehot),
                           (tt.binary_cross_entropy_loss, jt.binary_cross_entropy_loss, bern,
                            (tgt > 0).astype(np.float32))):
        np.testing.assert_allclose(float(tfn(_t(x), _t(y))),
                                   float(jfn(jnp.asarray(x), jnp.asarray(y))), rtol=RTOL)
    a, pos, neg = _rng_arrays(3, (8,), (3, 8), (5, 8))
    np.testing.assert_allclose(
        float(tt.local_contrastive_loss(_t(a), _t(pos), _t(neg))),
        float(jt.local_contrastive_loss(jnp.asarray(a), jnp.asarray(pos), jnp.asarray(neg))),
        rtol=RTOL)


def test_distances_match_jax():
    q, x = _rng_arrays(4, (3, 16), (7, 16))
    x[2] = 0.0                                     # a zero-norm row gives 0
    for name in ("pairwise_dot", "pairwise_cosine", "pairwise_euclidean"):
        np.testing.assert_allclose(getattr(tdist, name)(_t(q), _t(x)).numpy(),
                                   np.asarray(getattr(jdist, name)(jnp.asarray(q),
                                                                   jnp.asarray(x))),
                                   rtol=RTOL, atol=1e-5)
    np.testing.assert_allclose(tdist.cosine_similarity(_t(q[:1]), _t(x)).numpy(),
                               np.asarray(jdist.cosine_similarity(jnp.asarray(q[:1]),
                                                                  jnp.asarray(x))),
                               rtol=RTOL, atol=1e-6)


# --- optimizers and schedules -----------------------------------------------

OPTIMIZERS = {
    "sgd": (lambda m: m.sgd(0.1), lambda m: m.sgd(0.1)),
    "sgd_momentum": (lambda m: m.sgd(0.05, momentum=0.9), lambda m: m.sgd(0.05, momentum=0.9)),
    "adam": (lambda m: m.adam(0.01), lambda m: m.adam(0.01)),
    "adamw": (lambda m: m.adamw(0.01, weight_decay=0.1), lambda m: m.adamw(0.01,
                                                                          weight_decay=0.1)),
    "adam_schedule": (lambda m: m.adam(jt.exponential_schedule(0.01, 0.9)),
                      lambda m: m.adam(tt.exponential_schedule(0.01, 0.9))),
}


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_optimizer_matches_jax_over_five_updates(name):
    """The reference's update rules (sgd momentum with lr inside the
    velocity, bias-corrected adam, optax's adamw), 5 updates of a pytree
    with gradients from numpy."""
    make_j, make_t = OPTIMIZERS[name]
    w, b = _rng_arrays(5, (4, 3), (3,))
    jparams = {"w": jnp.asarray(w), "b": [jnp.asarray(b)]}
    tparams = {"w": _t(w), "b": [_t(b)]}
    jopt, topt = make_j(jt), make_t(tt)
    jst, tst = jopt.init(jparams), topt.init(tparams)
    for i in range(5):
        gw, gb = _rng_arrays(10 + i, (4, 3), (3,))
        ju, jst = jopt.update({"w": jnp.asarray(gw), "b": [jnp.asarray(gb)]}, jst, jparams)
        jparams = optax.apply_updates(jparams, ju)
        tu, tst = topt.update({"w": _t(gw), "b": [_t(gb)]}, tst, tparams)
        tparams = tt.apply_updates(tparams, tu)
    for got, want in zip(_jax_order(tparams), jax.tree_util.tree_leaves(jparams)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=1e-7)


def test_sgd_momentum_reference_values():
    """test_training.py:143: v2 = 0.9 * 0.01 + 0.01; p = 0.99 - 0.019."""
    opt = tt.sgd(0.1, momentum=0.9)
    params = {"w": torch.tensor([1.0])}
    state = opt.init(params)
    for want in (0.99, 0.971):
        u, state = opt.update({"w": torch.tensor([0.1])}, state, params)
        params = tt.apply_updates(params, u)
        np.testing.assert_allclose(params["w"].numpy(), [want], atol=1e-6)


SCHEDULES = {
    "constant": {},
    "step_decay": {"step_size": 10, "gamma": 0.5},
    "exponential": {"gamma": 0.9},
    "cosine_annealing": {"t_max": 10, "eta_min": 0.1},
    "warmup_linear": {"warmup_steps": 10, "total_steps": 110},
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedule_matches_jax(name):
    ts = tt.make_schedule(name, 1.0, **SCHEDULES[name])
    js = jt.make_schedule(name, 1.0, **SCHEDULES[name])
    for step in (0, 1, 5, 10, 25, 60, 110, 130):
        np.testing.assert_allclose(ts(step), float(js(step)), rtol=RTOL, atol=1e-7)


def test_reduce_on_plateau():
    """test_training.py:193."""
    r = tt.make_schedule("reduce_on_plateau", 1.0, factor=0.5, patience=2, min_lr=0.1)
    assert [r.step_with_metric(m) for m in (1.0, 1.0, 1.0, 0.5)] == [1.0, 1.0, 0.5, 0.5]
    r2 = tt.ReduceOnPlateau(0.15, factor=0.5, patience=1, min_lr=0.1)
    r2.step_with_metric(1.0)
    assert r2.step_with_metric(2.0) == 0.1


# --- EWC and replay ---------------------------------------------------------

def test_ewc_lifecycle_matches_jax():
    """test_training.py:206 on both packages, and the penalty's autograd
    gradient equals ewc_gradient (test_training.py:226)."""
    w, g1, g2, moved = _rng_arrays(6, (5,), (5,), (5,), (5,))
    jst = jt.ewc_init({"w": jnp.asarray(w)}, lam=10.0)
    tst = tt.ewc_init({"w": _t(w)}, lam=10.0)
    assert float(tt.ewc_penalty(tst, {"w": _t(moved)})) == 0.0
    assert float(tt.ewc_gradient(tst, {"w": _t(moved)})["w"].abs().max()) == 0.0
    jst = jt.ewc_consolidate(jt.ewc_compute_fisher(
        jst, [{"w": jnp.asarray(g1)}, {"w": jnp.asarray(g2)}]), {"w": jnp.asarray(w)})
    tst = tt.ewc_consolidate(tt.ewc_compute_fisher(tst, [{"w": _t(g1)}, {"w": _t(g2)}]),
                             {"w": _t(w)})
    np.testing.assert_allclose(tst.fisher["w"].numpy(), np.asarray(jst.fisher["w"]), rtol=RTOL)
    np.testing.assert_allclose(float(tt.ewc_penalty(tst, {"w": _t(moved)})),
                               float(jt.ewc_penalty(jst, {"w": jnp.asarray(moved)})), rtol=RTOL)
    tg = tt.ewc_gradient(tst, {"w": _t(moved)})["w"]
    np.testing.assert_allclose(tg.numpy(),
                               np.asarray(jt.ewc_gradient(jst, {"w": jnp.asarray(moved)})["w"]),
                               rtol=RTOL)
    leaf = _t(moved).requires_grad_(True)
    (auto,) = torch.autograd.grad(tt.ewc_penalty(tst, {"w": leaf}), [leaf])
    np.testing.assert_allclose(auto.numpy(), tg.numpy(), rtol=RTOL)


def test_replay_buffer_reservoir_and_shift():
    """test_training.py:239-261."""
    buf = tt.ReplayBuffer(capacity=10, seed=0)
    for i in range(100):
        buf.add(np.asarray([float(i)]), [i])
    assert len(buf) == 10 and buf.total_seen == 100
    assert len(buf.sample(5)) == 5
    qs, ids = buf.sample_arrays(3)
    assert qs.shape == (3, 1) and len(ids) == 3
    buf = tt.ReplayBuffer(capacity=200, seed=1)
    rng = np.random.default_rng(2)
    for _ in range(100):
        buf.add(rng.normal(0.0, 1.0, size=8), [0])
    no_shift = buf.detect_distribution_shift(20)
    for _ in range(100):
        buf.add(rng.normal(5.0, 1.0, size=8), [0])
    shift = buf.detect_distribution_shift(20)
    assert shift > no_shift and shift > 0.5


# --- the contrastive train step ---------------------------------------------

def _contrastive_setup(n=64, d=16):
    """test_training.py:266's model: n nodes, k=4 kNN graph, one
    RuvectorLayer (d=16, 4 heads)."""
    rng = np.random.default_rng(3)
    feats = rng.normal(size=(n, d)).astype(np.float32)
    jg = jknn(jnp.asarray(feats), k=4)
    tg = NeighborGraph(torch.from_numpy(np.array(jg.nbr_idx)),
                       torch.from_numpy(np.array(jg.nbr_mask)),
                       torch.from_numpy(np.array(jg.edge_weight)))
    jcfg = JLayerCfg(input_dim=d, hidden_dim=d, heads=4, dropout=0.0)
    tcfg = RuvectorLayerConfig(input_dim=d, hidden_dim=d, heads=4, dropout=0.0)
    jp = jlayer_init(jax.random.key(0), jcfg)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    anchors = rng.permutation(n)[:16].astype(np.int32)
    negs = rng.integers(0, n, (16, 8)).astype(np.int32)
    return (jg, jcfg, jp, jnp.asarray(feats)), (tg, tcfg, tp, torch.from_numpy(feats)), \
        anchors, negs


def _jax_named(tree, path=""):
    """(path, tensor) of a pytree in jax.tree_util's order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _jax_named(tree[k], f"{path}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [leaf for i, t in enumerate(tree) for leaf in _jax_named(t, f"{path}/{i}")]
    return [(path, tree)]


def _jax_order(tree):
    return [t for _, t in _jax_named(tree)]


# The attention's key bias adds the same score to all of a node's
# neighbours, so the softmax cancels it: its gradient is rounding noise
# (~1e-10) on both sides, which Adam scales to lr * g / (|g| + eps). That
# leaf is held to a move of at most lr; every other leaf to RTOL.
NOISE_LEAF = "attn/k/bias"


@pytest.mark.parametrize("variant", ["plain", "ewc", "train_features"])
def test_train_step_matches_jax(variant):
    (jg, jcfg, jp, jf), (tg, tcfg, tp, tf), anchors, negs = _contrastive_setup()
    cfg = jtrain.TrainConfig(batch_size=16, n_negatives=8,
                             train_features=variant == "train_features")
    tcfg_train = ttrain.TrainConfig(**dataclasses.asdict(cfg))
    jtr, ttr = ((jp, jf), (tp, tf)) if cfg.train_features else (jp, tp)
    jopt, topt = jt.adam(1e-3), tt.adam(1e-3)
    extra_j, extra_t = (), ()
    if variant == "ewc":
        grads = [jax.tree_util.tree_map(lambda a, i=i: 0.1 * (i + 1) * jnp.ones_like(a), jp)
                 for i in range(2)]
        jst = jt.ewc_consolidate(jt.ewc_compute_fisher(jt.ewc_init(jp, 5.0), grads),
                                 jax.tree_util.tree_map(lambda a: a + 0.01, jp))
        tst = tt.ewc_consolidate(
            tt.ewc_compute_fisher(tt.ewc_init(tp, 5.0),
                                  [params_from_numpy(jax.tree_util.tree_map(np.asarray, g), "cpu")
                                   for g in grads]),
            tree_map(lambda a: a + 0.01, tp))
        extra_j, extra_t = (jst,), (tst,)
    jstep = jtrain.make_train_step(jcfg, jopt, cfg, with_ewc=variant == "ewc")
    tstep = ttrain.make_train_step(tcfg, topt, tcfg_train, with_ewc=variant == "ewc")
    topt_state = topt.init(ttr)
    jopt_state = jopt.init(jtr)
    ttr, _, tloss = tstep(ttr, topt_state, tf, tg, torch.from_numpy(anchors),
                          torch.from_numpy(negs), *extra_t)
    jtr, _, jloss = jstep(jtr, jopt_state, jf, jg, jnp.asarray(anchors), jnp.asarray(negs),
                          *extra_j)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=RTOL)
    jleaves = jax.tree_util.tree_leaves(jtr)
    named = _jax_named(ttr)
    tleaves = [t for _, t in named]
    assert len(tleaves) == len(jleaves)
    before = _jax_order((tp, tf) if cfg.train_features else tp)
    for (path, got), want, old in zip(named, jleaves, before):
        if path.endswith(NOISE_LEAF):
            assert float((got - old).abs().max()) <= 1e-3 * (1 + 1e-5)
        else:
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=1e-6)
    assert all(bool(torch.isfinite(t).all()) for t in tleaves)


def test_online_update_matches_jax():
    (jg, jcfg, jp, jf), (tg, tcfg, tp, tf), _, negs = _contrastive_setup()
    ocfg = jtrain.OnlineConfig(local_steps=3)
    jparams, jfeats = jtrain.make_online_update(jcfg, ocfg, learning_rate=0.01)(
        jp, jf, jg, 5, jnp.asarray(negs[0]))
    tparams, tfeats = ttrain.make_online_update(tcfg, ttrain.OnlineConfig(local_steps=3),
                                                learning_rate=0.01)(
        tp, tf, tg, 5, torch.from_numpy(negs[0]))
    np.testing.assert_allclose(tfeats.numpy(), np.asarray(jfeats), rtol=RTOL, atol=1e-6)
    assert not np.array_equal(tfeats[5].numpy(), tf[5].numpy())
    assert np.array_equal(np.delete(tfeats.numpy(), 5, 0), np.delete(tf.numpy(), 5, 0))
    jl = jax.tree_util.tree_leaves(jparams)
    tl = _jax_order(tparams)
    assert len(tl) == len(jl)
    for got, want in zip(tl, jl):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=1e-6)


def test_train_epoch_reduces_loss_and_negatives_avoid_neighbours():
    """test_training.py:266 and :291 with the port's torch.Generator."""
    _, (tg, tcfg, tp, tf), _, _ = _contrastive_setup()
    cfg = ttrain.TrainConfig(batch_size=32, n_negatives=8, learning_rate=0.01)
    opt = tt.adam(cfg.learning_rate)
    step = ttrain.make_train_step(tcfg, opt, cfg)
    gen = torch.Generator().manual_seed(3)
    params, state, losses = tp, opt.init(tp), []
    for _ in range(12):
        params, state, loss = ttrain.train_epoch(step, params, state, tf, tg, cfg, gen)
        losses.append(loss)
    assert losses[-1] < losses[0], losses
    g = NeighborGraph.from_lists([[1, 2], [0], [0, 3], [2]], max_degree=2, device="cpu")
    negs = ttrain.sample_negatives(torch.Generator().manual_seed(4), g, np.asarray([0]), 2)
    assert negs.shape == (1, 2) and set(negs[0].tolist()).isdisjoint({0, 1, 2})
    np.testing.assert_allclose(ttrain.sgd_step(torch.tensor([1.0, 2.0, 3.0]),
                                               torch.tensor([0.1, -0.2, 0.3]), 0.01).numpy(),
                               [0.999, 2.002, 2.997], atol=1e-6)
