"""Parity of the port's query-feedback loop (`training/feedback.py`,
BASELINE config 4) against the JAX composition of
benchmarks/learned_recall_curve.py:93-137 on the CPU: the same functions
written here from `ruvector_tpu.nn.ruvector_layer`, `NeighborGraph` and
optax, fed the same numpy inputs and JAX-initialised parameters.

The corpus is cut to 2,000 x 64 in 16 clusters (ef 40, the k = 8 graph);
both packages take the same candidate ids, an exact numpy cosine top-ef,
since a threaded HNSW build depends on its threads' order.

Tolerances: the corpus and queries bit for bit; the schedule 1e-7
relative (optax computes it in float32); the layer's slot route 2e-5 and
its K3 route 1e-4 (tests/test_torch_ruvector_layer.py's F32_TOL and
PALLAS_TOL), the blended scores 2e-5; the loss and its gradients 1e-5
relative with 1e-6 absolute (the contrastive step's, tests/
test_torch_training.py); 20 Adam steps 1e-5 absolute (1% of one step's
lr: Adam's update is the gradient's sign to first order, so a float32
rounding moves a parameter by a share of lr, not of itself); recall equal
under ROADMAP queue 3's tie rule (a swap at the k-th place between
scores within 1e-6).
"""

import collections
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ruvector_tpu.graph.neighbors import NeighborGraph as JNG
from ruvector_tpu.nn.ruvector_layer import RuvectorLayerConfig as JCfg
from ruvector_tpu.nn.ruvector_layer import ruvector_layer_apply as jlayer
from ruvector_tpu.nn.ruvector_layer import ruvector_layer_init as jinit
from ruvector_tpu.sona.engine import SonaEngine as JSonaEngine
from ruvector_tpu.sona.types import SonaConfig as JSonaConfig
from ruvector_tpu_torch.convert import params_from_numpy
from ruvector_tpu_torch.graph import NeighborGraph, build_knn_graph
from ruvector_tpu_torch.nn.ruvector_layer import ruvector_layer_apply
from ruvector_tpu_torch.training import feedback as fb
from ruvector_tpu_torch.training.optimizers import requiring_grad, sorted_leaves, tree_grad

CFG = fb.FeedbackConfig(n=2_000, n_clusters=16)
EF, M, D, TOPK = CFG.ef, CFG.knn_k, CFG.dim, CFG.topk
LAYER_TOL, K3_TOL, SCORE_TOL = 2e-5, 1e-4, 2e-5
GRAD_RTOL, GRAD_ATOL = 1e-5, 1e-6
ADAM_ATOL = 1e-5
TIE_TOL = 1e-6
EVAL_Q = 16


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# --- the JAX side: learned_recall_curve.py's closures, over this test's sizes

JLAYER = JCfg(input_dim=D, hidden_dim=D, heads=CFG.heads)


@functools.partial(jax.jit, static_argnames="cfg")
def j_subgraph_embed(p, cand_feats, cand_nbr_feats, cand_nbr_w, cfg=JLAYER):
    feats_all = jnp.concatenate([cand_feats, cand_nbr_feats.reshape(-1, D)], axis=0)
    local = jnp.arange(EF * M).reshape(EF, M) + EF
    pad = jnp.zeros((EF * M, M), jnp.int32)
    g = JNG(nbr_idx=jnp.concatenate([local, pad], axis=0),
            nbr_mask=jnp.concatenate([jnp.ones((EF, M)), jnp.zeros((EF * M, M))], axis=0),
            edge_weight=jnp.concatenate([cand_nbr_w, jnp.ones((EF * M, M))], axis=0))
    return jlayer(p["layer"], cfg, feats_all, g)


def j_blended(p, q, cand_feats, cand_nbr_feats, cand_nbr_w):
    emb = j_subgraph_embed(p, cand_feats, cand_nbr_feats, cand_nbr_w)[:EF]
    emb = emb / (jnp.linalg.norm(emb, axis=1, keepdims=True) + 1e-8)
    qn = q / (jnp.linalg.norm(q) + 1e-8)
    raw = cand_feats / (jnp.linalg.norm(cand_feats, axis=1, keepdims=True) + 1e-8)
    return raw @ qn + p["beta"] * (emb @ qn)


def j_loss(p, q, cand_feats, cand_nbr_feats, cand_nbr_w, rewards):
    sims = j_blended(p, q, cand_feats, cand_nbr_feats, cand_nbr_w) / 0.2
    logz = jax.nn.logsumexp(sims)
    pos = jnp.sum(rewards * (sims - logz))
    return -pos / jnp.maximum(jnp.sum(rewards), 1.0)


j_rerank = jax.jit(j_blended)


# --- shared inputs -------------------------------------------------------------

def _setup(beta=0.0, key=0):
    corpus, labels = fb.make_corpus(CFG)
    graph = build_knn_graph(corpus, k=CFG.knn_k, device="cpu")
    jparams = {"layer": jinit(jax.random.key(key), JLAYER), "beta": jnp.asarray(beta, jnp.float32)}
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    return corpus, labels, graph, jparams, tparams


def _exact_cands(corpus, queries):
    """Exact cosine top-ef of each query (float64), both packages' candidates."""
    x = corpus / np.linalg.norm(corpus, axis=1, keepdims=True)
    qn = queries / np.linalg.norm(queries, axis=1, keepdims=True)
    return np.argsort(-(qn.astype(np.float64) @ x.T.astype(np.float64)), axis=1,
                      kind="stable")[:, :EF].astype(np.int32)


def _inputs(corpus, graph, cids):
    nbr = graph.nbr_idx.numpy()
    w = graph.edge_weight.numpy()
    return corpus[cids], corpus[nbr[cids]], w[cids]


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _close(got, want, rtol, atol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol)


# --- cases ---------------------------------------------------------------------

def _script_arrays(cfg):
    """learned_recall_curve.py:62-69 and :143-151, as the script writes them."""
    n, d, n_clusters, d_inf, sig_inf, sig_nui = (cfg.n, cfg.dim, cfg.n_clusters, cfg.d_inf,
                                                 cfg.sig_inf, cfg.sig_nui)
    rng = np.random.default_rng(0)
    centers = np.zeros((n_clusters, d), np.float32)
    centers[:, :d_inf] = 2.0 * rng.normal(size=(n_clusters, d_inf))
    labels = rng.integers(0, n_clusters, size=n)
    noise_mat = rng.normal(size=(n, d)).astype(np.float32)
    noise_mat[:, :d_inf] *= sig_inf
    noise_mat[:, d_inf:] *= sig_nui
    corpus = (centers[labels] + noise_mat).astype(np.float32)

    def make_queries(count, seed):
        r = np.random.default_rng(seed)
        qc = r.integers(0, n_clusters, count)
        nm = r.normal(size=(count, d)).astype(np.float32)
        nm[:, :d_inf] *= sig_inf
        nm[:, d_inf:] *= sig_nui
        return (centers[qc] + nm).astype(np.float32), qc

    return corpus, labels, make_queries(400, 999), make_queries(1000, 1)


@pytest.mark.parametrize("cfg", [fb.FeedbackConfig(), CFG], ids=["full", "cut"])
def test_corpus_and_queries_equal_the_script_bit_for_bit(cfg):
    corpus, labels, (eq, ec), (sq, sc) = _script_arrays(cfg)
    got_corpus, got_labels = fb.make_corpus(cfg)
    assert got_corpus.dtype == np.float32 and np.array_equal(got_corpus, corpus)
    assert np.array_equal(got_labels, labels)
    for (q, c), seed in (((eq, ec), cfg.eval_seed), ((sq, sc), cfg.stream_seed)):
        got_q, got_c = fb.make_queries(cfg, len(q), seed)
        assert np.array_equal(got_q, q) and np.array_equal(got_c, c)


def test_schedule_equals_optax_exponential_decay():
    cfg = fb.FeedbackConfig()
    want = optax.exponential_decay(1e-3, transition_steps=20_000, decay_rate=0.3)
    got = fb.feedback_schedule(cfg)
    for count in (0, 1, 19_999, 20_000, 40_000):
        np.testing.assert_allclose(got(count), float(want(count)), rtol=1e-7, atol=0)


def test_subgraph_embed_and_blended_scores_match_jax():
    """The slot route over the subgraph, every row: the 320 leaf rows (all
    slots masked, zero wnorm) finite and equal to JAX's; the K3 route (its
    plain version here, JAX's Pallas kernel in interpret mode) too; then
    the candidates' embeddings and the blended scores."""
    corpus, _, graph, jparams, tparams = _setup(beta=0.7)
    q = fb.make_queries(CFG, 1, 5)[0][0]
    cids = _exact_cands(corpus, q[None])[0]
    cf, cnf, cnw = _inputs(corpus, graph, cids)
    feats_all = np.concatenate([cf, cnf.reshape(-1, D)])
    g = fb.subgraph_graph(torch.from_numpy(cnw))
    assert g.num_nodes == EF + EF * M and float(g.nbr_mask[EF:].sum()) == 0.0
    for use_pallas, tol in ((False, LAYER_TOL), (True, K3_TOL)):
        jcfg = dataclasses.replace(JLAYER, use_pallas=use_pallas)
        want = np.asarray(j_subgraph_embed(jparams, *map(jnp.asarray, (cf, cnf, cnw)), cfg=jcfg))
        got = ruvector_layer_apply(tparams["layer"], CFG.layer_config(use_pallas),
                                   torch.from_numpy(feats_all), g)
        assert np.all(np.isfinite(got.numpy())) and np.all(np.isfinite(want))
        _close(got, want, 0, tol)
    emb = fb.subgraph_embed(tparams, CFG.layer_config(), *_t(cf, cnf, cnw))
    _close(emb, np.asarray(j_subgraph_embed(jparams, *map(jnp.asarray, (cf, cnf, cnw))))[:EF],
           0, LAYER_TOL)
    got = fb.blended_scores(tparams, CFG.layer_config(), *_t(q, cf, cnf, cnw))
    assert got.shape == (EF,)
    _close(got, j_blended(jparams, *map(jnp.asarray, (q, cf, cnf, cnw))), 0, SCORE_TOL)


def test_stacked_subgraphs_equal_per_query_calls():
    """Three queries' subgraphs in one call give each row what its own
    call gives: leaf slots point into their own query's rows."""
    corpus, _, graph, _, tparams = _setup(beta=0.7)
    qs = fb.make_queries(CFG, 3, 6)[0]
    cids = _exact_cands(corpus, qs)
    cf, cnf, cnw = _inputs(corpus, graph, cids)
    g = fb.subgraph_graph(torch.from_numpy(cnw))
    rows = EF + EF * M
    idx = g.nbr_idx.reshape(3, rows, M)
    for i in range(3):
        assert int(idx[i].min()) >= i * rows and int(idx[i].max()) < (i + 1) * rows
    stacked = fb.blended_scores(tparams, CFG.layer_config(), *_t(qs, cf, cnf, cnw))
    for i in range(3):
        one = fb.blended_scores(tparams, CFG.layer_config(), *_t(qs[i], cf[i], cnf[i], cnw[i]))
        _close(stacked[i], one.numpy(), 0, 1e-6)


@pytest.mark.parametrize("beta", [0.0, 0.4])
def test_feedback_loss_and_gradients_match_jax(beta):
    """At beta = 0 the layer's gradients are exactly zero on both sides
    (the first step moves beta alone)."""
    corpus, labels, graph, jparams, tparams = _setup(beta=beta)
    qs, qc = fb.make_queries(CFG, 1, 7)
    cids = _exact_cands(corpus, qs)[0]
    rewards = (labels[cids] == qc[0]).astype(np.float32)
    assert 0 < rewards.sum() < EF
    args = (qs[0],) + _inputs(corpus, graph, cids) + (rewards,)
    jloss, jgrads = jax.jit(jax.value_and_grad(j_loss))(jparams, *map(jnp.asarray, args))
    req = requiring_grad(tparams)
    loss = fb.feedback_loss(req, CFG.layer_config(), *_t(*args))
    _close(loss, float(jloss), GRAD_RTOL, GRAD_ATOL)
    grads = sorted_leaves(tree_grad(loss, req))
    want = jax.tree_util.tree_leaves(jgrads)
    assert len(grads) == len(want)
    for got, w in zip(grads, want):
        _close(got, w, GRAD_RTOL, GRAD_ATOL)
    if beta == 0.0:
        assert all(float(g.abs().max()) == 0.0 for g in grads[1:])


def test_stream_steps_match_optax():
    """20 steps of the loop (transition_steps cut to 10, so the decay
    shows: lr falls to 0.3^1.9 of its start) against optax.adam on the
    JAX loss over the same candidates and rewards; the SONA engines fed
    alike (force_learn every 10) end in the same host state."""
    cfg = dataclasses.replace(CFG, transition_steps=10, learn_every=10)
    corpus, labels, graph, jparams, tparams = _setup()
    loop = fb.FeedbackLoop(cfg, corpus, labels, graph, tparams, device="cpu")
    opt = optax.adam(optax.exponential_decay(1e-3, transition_steps=10, decay_rate=0.3))

    @jax.jit
    def j_step(p, st, *args):
        g = jax.grad(j_loss)(p, *args)
        upd, st = opt.update(g, st)
        return optax.apply_updates(p, upd), st

    jsona = JSonaEngine(config=JSonaConfig(hidden_dim=D, embedding_dim=D, flush_threshold=64,
                                           quality_threshold=0.3))
    p, st = jparams, opt.init(jparams)
    qs, qc = fb.make_queries(cfg, 20, cfg.stream_seed)
    cands = _exact_cands(corpus, qs)
    for i in range(20):
        cids, q = cands[i], qs[i]
        rewards = loop.rewards(cids, qc[i])
        loop.update(q, cids, rewards)
        loop.record(q, cids, rewards)
        p, st = j_step(p, st, *map(jnp.asarray, (q,) + _inputs(corpus, graph, cids) +
                                   (rewards,)))
        traj = jsona.begin_trajectory(q)
        rel = corpus[cids[rewards > 0]]
        if len(rel):
            traj.add_step(rel.mean(0) - q, np.zeros(1), float(rewards.mean()))
        jsona.end_trajectory(traj, float(rewards[:TOPK].mean()))
        if i % 10 == 9:
            jsona.force_learn()
    got = sorted_leaves(loop.params)
    want = jax.tree_util.tree_leaves(p)
    assert len(got) == len(want) and float(got[0]) != 0.0
    for g, w in zip(got, want):
        _close(g, w, 0, ADAM_ATOL)
    assert loop.opt_state["count"] == int(st[0].count) == 20
    assert dataclasses.asdict(loop.sona.stats) == dataclasses.asdict(jsona.stats)
    assert loop.sona.stats.background_cycles == 2
    tm, jm = loop.sona.coordinator.instant.micro_lora, jsona.coordinator.instant.micro_lora
    assert np.array_equal(tm.up, jm.up) and np.array_equal(tm.grad_up, jm.grad_up)


def _hits(scores, cands, labels, clusters):
    order = np.argsort(-scores, axis=1, kind="stable")[:, :TOPK]
    return (labels[np.take_along_axis(cands, order, 1)] == clusters[:, None]).sum(1)


def _equal_under_ties(got_scores, want_scores, cands, labels, clusters):
    """Per-query hits equal, except where the k-th and (k+1)-th scores of
    either side lie within TIE_TOL (a swap at the k-th place)."""
    a = _hits(got_scores, cands, labels, clusters)
    b = _hits(want_scores, cands, labels, clusters)
    for i in np.flatnonzero(a != b):
        s = np.sort(want_scores[i])[::-1]
        assert s[TOPK - 1] - s[TOPK] <= TIE_TOL, f"query {i}: {a[i]} vs {b[i]} hits"
    return a.sum() / (len(a) * TOPK)


def test_eval_recall_stacked_equals_per_query_loop_and_jax():
    corpus, labels, graph, jparams, tparams = _setup(beta=0.6, key=1)
    qs, qc = fb.make_queries(CFG, EVAL_Q, CFG.eval_seed)
    cands = _exact_cands(corpus, qs)
    tc, tl, tq, tcl, tca = _t(corpus, labels, qs, qc, cands)
    args = (tparams, CFG.layer_config(), tc, graph.nbr_idx, graph.edge_weight)
    stacked = fb.eval_scores(*args, tq, tca).numpy()
    per_query = np.stack([fb.eval_scores(*args, tq[i], tca[i]).numpy() for i in range(EVAL_Q)])
    jax_scores = np.stack([np.asarray(j_rerank(jparams, *map(jnp.asarray, (qs[i],) + _inputs(
        corpus, graph, cands[i])))) for i in range(EVAL_Q)])
    _close(stacked, per_query, 0, 1e-6)
    _close(stacked, jax_scores, 0, SCORE_TOL)
    rr, raw = fb.eval_recall(tparams, CFG.layer_config(), tc, tl, graph.nbr_idx,
                             graph.edge_weight, tq, tcl, tca, TOPK)
    assert rr == _equal_under_ties(stacked, per_query, cands, labels, qc)
    assert rr == _equal_under_ties(stacked, jax_scores, cands, labels, qc)
    assert raw == (labels[cands[:, :TOPK]] == qc[:, None]).mean()
    # the K3 route (its plain version on the CPU), the card's evaluation route
    k3 = fb.eval_scores(tparams, CFG.layer_config(use_pallas=True), tc, graph.nbr_idx,
                        graph.edge_weight, tq, tca).numpy()
    _close(k3, stacked, 0, K3_TOL)
    _equal_under_ties(k3, stacked, cands, labels, qc)


def test_recall_at_beta_zero_equals_raw_cosine():
    """beta = 0: the blended score is the raw cosine, whatever the layer."""
    corpus, labels, graph, _, tparams = _setup(beta=0.0, key=2)
    qs, qc = fb.make_queries(CFG, EVAL_Q, CFG.eval_seed)
    cands = _exact_cands(corpus, qs)
    # a candidate order that is not the cosine order: the ranking must do it
    cands = cands[:, ::-1].copy()
    tc, tl, tq, tcl, tca = _t(corpus, labels, qs, qc, cands)
    rr, raw = fb.eval_recall(tparams, CFG.layer_config(), tc, tl, graph.nbr_idx,
                             graph.edge_weight, tq, tcl, tca, TOPK)
    x = corpus[cands] / np.linalg.norm(corpus[cands], axis=2, keepdims=True)
    cos = np.einsum("qed,qd->qe", x, qs / np.linalg.norm(qs, axis=1, keepdims=True))
    assert rr == _hits(cos, cands, labels, qc).sum() / (EVAL_Q * TOPK)
    assert raw == (labels[cands[:, :TOPK]] == qc[:, None]).mean()
    scores = fb.eval_scores(tparams, CFG.layer_config(), tc, graph.nbr_idx,
                            graph.edge_weight, tq, tca).numpy()
    _close(scores, cos, 0, 1e-6)


def test_loop_streams_through_the_index():
    """The loop end to end on the CPU through its HNSW index (serial
    build): recall at 0 queries equals the HNSW-only baseline within one
    swap at the 10th place of a query; 100 queries move beta off 0 and
    feed SONA one trajectory each (learning itself: the optax parity above
    and the card's 1,000-query gain in chip_smoke.py's `[config4]`)."""
    corpus, labels, graph, _, tparams = _setup()
    index = fb.build_index(CFG, corpus, device="cpu")
    loop = fb.FeedbackLoop(CFG, corpus, labels, graph, tparams, device="cpu")
    assert not loop.eval_cfg.use_pallas
    eq, ec = fb.make_queries(CFG, 64, CFG.eval_seed)
    cands, _ = index.search_batch(eq, k=EF, ef=CFG.search_ef)
    rr0, raw = loop.eval_recall(eq, ec, cands)
    assert abs(rr0 - raw) <= 1 / (64 * TOPK)
    sq, sc = fb.make_queries(CFG, 100, CFG.stream_seed)
    loop.stream(index, sq, sc, 60)
    seconds = loop.stream(index, sq, sc, 100)     # resumes at step 60
    assert set(seconds) == {"search_s", "update_s", "sona_s"} and loop.steps == 100
    assert loop.opt_state["count"] == 100 and float(loop.params["beta"]) != 0.0
    assert loop.sona.stats.trajectories_seen == 100
    rr, raw_after = loop.eval_recall(eq, ec, cands)
    assert raw_after == raw and 0.0 < rr <= 1.0


class _Ops(TorchDispatchMode):
    """Counts the aten ops dispatched under it."""

    def __init__(self):
        super().__init__()
        self.ops = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops[str(func.overloadpacket)] += 1
        return func(*args, **(kwargs or {}))


def test_update_reads_nothing_back():
    """A feedback update (forward, backward, Adam) dispatches no op that
    copies a value to the host (`.item()`, `float(loss)`, a bool of a
    tensor: `aten._local_scalar_dense`), so on the card the host queues
    updates ahead of it. Its op count is about the launches a card update
    costs (PERF.md section 6)."""
    corpus, labels, graph, _, tparams = _setup(beta=0.3)
    loop = fb.FeedbackLoop(CFG, corpus, labels, graph, tparams, device="cpu")
    qs, qc = fb.make_queries(CFG, 2, 8)
    cands = _exact_cands(corpus, qs)
    loop.update(qs[0], cands[0], loop.rewards(cands[0], qc[0]))
    with _Ops() as counter:
        loop.update(qs[1], cands[1], loop.rewards(cands[1], qc[1]))
    assert counter.ops["aten._local_scalar_dense"] == 0
    views = {"aten.view", "aten._unsafe_view", "aten.reshape", "aten.expand", "aten.unsqueeze",
             "aten.squeeze", "aten.slice", "aten.select", "aten.permute", "aten.transpose",
             "aten.t", "aten.alias", "aten.detach", "aten.as_strided", "aten.split"}
    computing = sum(n for op, n in counter.ops.items() if op not in views)
    print(f"ops an update: {sum(counter.ops.values())}, computing {computing}")
    assert 0 < computing < 1000


def test_subgraph_graph_layout():
    w = torch.rand(2, EF, M)
    g = fb.subgraph_graph(w)
    rows = EF + EF * M
    assert isinstance(g, NeighborGraph) and g.num_nodes == 2 * rows and g.max_degree == M
    idx, mask, ew = (t.reshape(2, rows, M) for t in (g.nbr_idx, g.nbr_mask, g.edge_weight))
    assert idx.dtype == torch.int32
    assert torch.equal(idx[1, :EF] - rows, torch.arange(EF, rows, dtype=torch.int32).reshape(EF, M))
    assert torch.equal(idx[1, EF:], torch.full((EF * M, M), rows, dtype=torch.int32))
    assert torch.equal(mask[:, :EF], torch.ones(2, EF, M))
    assert torch.equal(mask[:, EF:], torch.zeros(2, EF * M, M))
    assert torch.equal(ew[:, :EF], w) and torch.equal(ew[:, EF:], torch.ones(2, EF * M, M))
