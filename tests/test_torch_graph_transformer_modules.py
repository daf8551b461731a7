"""Parity of the rest of the port's graph transformers against the JAX
package, on the CPU: the cases of tests/test_graph_transformer.py
(verified training, sublinear attention, the transformer block) and
tests/test_graph_transformer_modules.py (physics, biological,
self-organizing, manifold, temporal, economic), each on the same numpy
inputs in both packages and held to that test's own property and
tolerance, plus the port's output against the JAX function's.

Tolerances: float32 outputs within 2e-5 of their scale (sums in another
order); iterated maps (100-200 leapfrog, Adam or Oja steps) within 1e-4;
least-squares ratios within 1e-3 relative (float32 SVDs from different
LAPACK routines); masks, bucket ids, spike counts, aggregates and grown
edges exactly. JAX's random draws (LSH planes, the inhibitor seeds,
Shapley permutations, the TRUE sketch) are computed here and passed to
the port; certificates hash the same bytes and records in both packages.
"""

import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ruvector_tpu.graph_transformer as jgt
from ruvector_tpu.attention.hyperbolic import poincare_distance as jpoincare
from ruvector_tpu.graph import build_knn_graph as jbuild_knn
from ruvector_tpu.graph.neighbors import NeighborGraph as JNeighborGraph
from ruvector_tpu.graph_transformer import economic as jeco
from ruvector_tpu.training import optimizers as jopt
import ruvector_tpu_torch.graph_transformer as tgt
from ruvector_tpu_torch.attention.hyperbolic import poincare_distance as tpoincare
from ruvector_tpu_torch.convert import params_from_numpy
from ruvector_tpu_torch.graph.neighbors import NeighborGraph as TNeighborGraph
from ruvector_tpu_torch.graph_transformer import economic as teco
from ruvector_tpu_torch.graph_transformer.verified import sorted_leaves
from ruvector_tpu_torch.training import optimizers as topt
from ruvector_tpu_torch.training.optimizers import tree_leaves

F32_TOL = 2e-5
ITER_TOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for this module's small tensors: beside the
    other workers of a parallel test run, many-threaded torch ops
    oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, tol=F32_TOL):
    """Within tol of want's scale (at least 1)."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want, atol=tol * max(1.0, float(np.abs(want).max())), rtol=0)


def _port_graph(jg):
    return TNeighborGraph(_t(jg.nbr_idx), _t(jg.nbr_mask), _t(jg.edge_weight))


def _ring_graph(n: int, d: int, seed: int = 0):
    """Symmetric ring: each node sees its left and right neighbor."""
    idx = np.stack([(np.arange(n) - 1) % n, (np.arange(n) + 1) % n], axis=1).astype(np.int32)
    mask = np.ones((n, 2), np.float32)
    jg = JNeighborGraph(nbr_idx=jnp.asarray(idx), nbr_mask=jnp.asarray(mask),
                        edge_weight=jnp.asarray(mask))
    x = np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)
    return jg, _port_graph(jg), x


def _p(jparams):
    return params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), "cpu")


# --- verified training ------------------------------------------------------------

def _quad_loss_j(params, batch):
    return jnp.sum((params["w"] - batch) ** 2)


def _quad_loss_t(params, batch):
    return torch.sum((params["w"] - batch) ** 2)


def test_verified_trainer_commits_good_steps():
    """100 Adam steps on the quadratic: every step commits in both
    packages, the weights follow JAX's within 1e-4, the certificate's
    counts agree."""
    invs = lambda m: [m.LossStabilityBound(spike_cap=10.0, max_gradient_norm=1000.0,  # noqa: E731
                                           max_step_size=10.0),
                      m.WeightNormBound(max_norm=100.0)]
    jt = jgt.VerifiedTrainer(_quad_loss_j, jopt.adam(0.3), {"w": jnp.asarray([5.0, 5.0])},
                             invs(jgt))
    tt = tgt.VerifiedTrainer(_quad_loss_t, topt.adam(0.3), {"w": torch.tensor([5.0, 5.0])},
                             invs(tgt))
    for _ in range(100):
        assert tt.train_step(torch.zeros(2)).committed
        assert jt.train_step(jnp.zeros(2)).committed
    assert tt.latest_loss < 5.0
    _close(tt.params["w"], jt.params["w"], ITER_TOL)
    cert, jcert = tt.seal(), jt.seal()
    assert (cert.steps, cert.committed_steps, cert.total_violations) == (100, 100, 0)
    assert (jcert.steps, jcert.committed_steps, jcert.total_violations) == (100, 100, 0)
    assert len(cert.chain_hash) == 64 and cert.invariants == jcert.invariants


def test_verified_trainer_rejects_gradient_explosion():
    tt = tgt.VerifiedTrainer(_quad_loss_t, topt.sgd(1.0), {"w": torch.tensor([5.0])},
                             [tgt.LossStabilityBound(spike_cap=0.5, max_gradient_norm=1.0,
                                                     max_step_size=0.1)])
    r = tt.train_step(torch.zeros(1))   # grad = 10 > 1.0
    assert not r.committed
    np.testing.assert_allclose(tt.params["w"].numpy(), [5.0])     # fail-closed
    assert tt.total_violations >= 1
    jt = jgt.VerifiedTrainer(_quad_loss_j, jopt.sgd(1.0), {"w": jnp.asarray([5.0])},
                             [jgt.LossStabilityBound(spike_cap=0.5, max_gradient_norm=1.0,
                                                     max_step_size=0.1)])
    jr = jt.train_step(jnp.zeros(1))
    assert [(c.name, c.passed, c.value) for c in r.checks] == \
        [(c.name, c.passed, c.value) for c in jr.checks]
    assert tt.total_violations == jt.total_violations


def test_verified_trainer_weight_norm_rollback():
    tt = tgt.VerifiedTrainer(lambda p, b: -torch.sum(p["w"] ** 2), topt.sgd(10.0),
                             {"w": torch.tensor([1.0])}, [tgt.WeightNormBound(max_norm=2.0)])
    for _ in range(5):
        tt.train_step(torch.zeros(1))
    # violating steps are discarded, so the norm never exceeds the bound
    assert float(torch.abs(tt.params["w"][0])) <= 2.0 + 1e-6
    assert tt.total_violations == 5


def test_verified_certificate_deterministic():
    def build():
        t = tgt.VerifiedTrainer(_quad_loss_t, topt.sgd(0.1), {"w": torch.tensor([3.0])},
                                [tgt.WeightNormBound(max_norm=10.0)])
        for _ in range(5):
            t.train_step(torch.zeros(1))
        return t.seal()

    c1, c2 = build(), build()
    assert c1.chain_hash == c2.chain_hash
    assert c1.final_weights_hash == c2.final_weights_hash


def test_seal_hashes_equal_jax_for_unsorted_keys():
    """A params dict built with its keys out of sorted order ("w" before
    "b"): the port's seal flattens in JAX's sorted-key order, so the
    weights hash (and, on exact arithmetic, the record chain) equals
    JAX's; the insertion-order bytes would hash otherwise."""
    def loss_j(p, batch):
        return jnp.sum(p["w"] ** 2) + jnp.sum(p["b"] ** 2)

    def loss_t(p, batch):
        return torch.sum(p["w"] ** 2) + torch.sum(p["b"] ** 2)

    w0, b0 = np.asarray([4.0, 2.0], np.float32), np.asarray([1.0], np.float32)
    invs = lambda m: [m.WeightNormBound(max_norm=10.0), m.EnergyGateInvariant()]  # noqa: E731
    # sgd(0.25): each step halves every weight, exactly
    jt = jgt.VerifiedTrainer(loss_j, jopt.sgd(0.25),
                             {"w": jnp.asarray(w0), "b": jnp.asarray(b0)}, invs(jgt))
    tt = tgt.VerifiedTrainer(loss_t, topt.sgd(0.25), {"w": _t(w0), "b": _t(b0)}, invs(tgt))
    assert list(tt.params) == ["w", "b"]
    for _ in range(3):
        jt.train_step(jnp.zeros(1))
        tt.train_step(torch.zeros(1))
    np.testing.assert_array_equal(tt.params["w"].numpy(), [0.5, 0.25])
    cert, jcert = tt.seal(), jt.seal()
    assert cert.final_weights_hash == jcert.final_weights_hash
    assert cert.chain_hash == jcert.chain_hash
    insertion = np.concatenate([t.numpy().reshape(-1) for t in tree_leaves(tt.params)])
    assert hashlib.sha256(insertion.tobytes()).hexdigest() != cert.final_weights_hash
    assert [t.numpy().tolist() for t in sorted_leaves(tt.params)] == [[0.125], [0.5, 0.25]]


def test_permutation_equivariance_invariant():
    batch = np.random.default_rng(0).normal(size=(8, 4)).astype(np.float32)
    for forward_t, forward_j, committed in (
            (lambda p, x: x * p["w"], lambda p, x: x * p["w"], True),
            (lambda p, x: x * torch.arange(x.shape[0], dtype=x.dtype)[:, None],
             lambda p, x: x * jnp.arange(x.shape[0], dtype=x.dtype)[:, None], False)):
        tt = tgt.VerifiedTrainer(
            lambda p, b: torch.sum((b * p["w"] - 1.0) ** 2), topt.sgd(0.001),
            {"w": torch.tensor(2.0)}, [tgt.PermutationEquivariance(tolerance=1e-4)],
            forward_fn=forward_t)
        jt = jgt.VerifiedTrainer(
            lambda p, b: jnp.sum((b * p["w"] - 1.0) ** 2), jopt.sgd(0.001),
            {"w": jnp.asarray(2.0)}, [jgt.PermutationEquivariance(tolerance=1e-4)],
            forward_fn=forward_j)
        r, jr = tt.train_step(_t(batch)), jt.train_step(jnp.asarray(batch))
        assert r.committed == jr.committed == committed
        np.testing.assert_allclose(r.checks[0].value, jr.checks[0].value, atol=1e-6)


def test_energy_gate_rejects_dead_gradient():
    tt = tgt.VerifiedTrainer(lambda p, b: torch.sum(p["w"] ** 2), topt.sgd(0.1),
                             {"w": torch.tensor([0.0])},
                             [tgt.EnergyGateInvariant(energy_threshold=1e-6)])
    assert not tt.train_step(torch.zeros(1)).committed


def test_lipschitz_bound_checks_spectral_norm():
    w = np.eye(4, dtype=np.float32) * 50.0
    tt = tgt.VerifiedTrainer(lambda p, b: torch.sum(p["w"] ** 2) * 1e-6, topt.sgd(0.001),
                             {"w": _t(w)}, [tgt.LipschitzBound(tolerance=10.0)])
    jt = jgt.VerifiedTrainer(lambda p, b: jnp.sum(p["w"] ** 2) * 1e-6, jopt.sgd(0.001),
                             {"w": jnp.asarray(w)}, [jgt.LipschitzBound(tolerance=10.0)])
    r, jr = tt.train_step(torch.zeros(1)), jt.train_step(jnp.zeros(1))
    assert not r.committed and not jr.committed   # spectral norm ~50 > 10
    np.testing.assert_allclose(r.checks[0].value, jr.checks[0].value, rtol=1e-6)


# --- sublinear attention ----------------------------------------------------------

def _jax_planes(d, num_hashes, seed=0):
    return np.asarray(jax.random.normal(jax.random.key(seed), (d, num_hashes)))


def test_lsh_buckets_group_similar():
    rng = np.random.default_rng(1)
    base = rng.normal(size=(1, 16)).astype(np.float32)
    feats = np.concatenate([base + 0.01 * rng.normal(size=(10, 16)),
                            -base + 0.01 * rng.normal(size=(10, 16))]).astype(np.float32)
    buckets = tgt.lsh_bucket_assignments(_t(feats), num_hashes=4,
                                         planes=_t(_jax_planes(16, 4))).numpy()
    assert len(set(buckets[:10])) == 1 and len(set(buckets[10:])) == 1
    assert buckets[0] != buckets[10]
    np.testing.assert_array_equal(buckets, jgt.lsh_bucket_assignments(jnp.asarray(feats), 4))
    # the port's own planes group the clusters too
    own = tgt.lsh_bucket_assignments(_t(feats), num_hashes=4).numpy()
    assert len(set(own[:10])) == 1 and own.dtype == np.int32


def test_lsh_attention_matches_jax():
    feats = np.random.default_rng(2).normal(size=(20, 8)).astype(np.float32)
    cfg = dict(num_hashes=2)
    out = tgt.lsh_bucket_attention(_t(feats), tgt.SublinearConfig(**cfg),
                                   planes=_t(_jax_planes(8, 2)))
    assert out.shape == (20, 8)
    _close(out, jgt.lsh_bucket_attention(jnp.asarray(feats), jgt.SublinearConfig(**cfg)))


def test_ppr_sampled_attention_matches_jax():
    feats = np.random.default_rng(3).normal(size=(30, 8)).astype(np.float32)
    jg = jbuild_knn(jnp.asarray(feats), k=4)
    queries = np.asarray([0, 5, 7])
    out = tgt.ppr_sampled_attention(_t(feats), _port_graph(jg).to_csr(), queries,
                                    tgt.SublinearConfig(ppr_top_k=8))
    assert out.shape == (3, 8)
    _close(out, jgt.ppr_sampled_attention(jnp.asarray(feats), jg.to_csr(), queries,
                                          jgt.SublinearConfig(ppr_top_k=8)))


# --- transformer block ------------------------------------------------------------

def _block_case(n=24, d=16, seed=4):
    feats = np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)
    jg = jbuild_knn(jnp.asarray(feats), k=4)
    cfg = dict(dim=d, num_heads=4, num_layers=2)
    jparams = jgt.graph_transformer_init(jax.random.key(0), jgt.GraphTransformerConfig(**cfg))
    return feats, jg, cfg, jparams


def test_graph_transformer_block_matches_jax():
    feats, jg, cfg, jparams = _block_case()
    tcfg, jcfg = tgt.GraphTransformerConfig(**cfg), jgt.GraphTransformerConfig(**cfg)
    params, graph = _p(jparams), _port_graph(jg)
    out = tgt.graph_transformer_apply(params, tcfg, _t(feats), graph)
    assert out.shape == (24, 16)
    _close(out, jgt.graph_transformer_apply(jparams, jcfg, jnp.asarray(feats), jg))
    # gradients of sum(out^2): finite, and JAX's within 2e-5 of each leaf's scale
    leaves = [t.requires_grad_(True) for t in tree_leaves(params)]
    torch.sum(tgt.graph_transformer_apply(params, tcfg, _t(feats), graph) ** 2).backward()
    jgrads = jax.grad(lambda p: jnp.sum(jgt.graph_transformer_apply(
        p, jcfg, jnp.asarray(feats), jg) ** 2))(jparams)
    want = tree_leaves(_p(jgrads))
    assert len(leaves) == len(want)
    for leaf, w in zip(leaves, want):
        _close(leaf.grad, w)


def test_graph_transformer_init_layout():
    """The port's own init has the JAX layout (keys and shapes)."""
    cfg = dict(dim=16, num_heads=4, num_layers=2)
    params = tgt.graph_transformer_init(0, tgt.GraphTransformerConfig(**cfg), device="cpu")
    jparams = jgt.graph_transformer_init(jax.random.key(0), jgt.GraphTransformerConfig(**cfg))
    shapes = jax.tree_util.tree_map(lambda a: tuple(a.shape), jparams)
    assert [jax.tree_util.tree_map(lambda t: tuple(t.shape), layer) for layer in params] == \
        shapes


# --- physics ----------------------------------------------------------------------

def test_hamiltonian_leapfrog_conserves_energy():
    jg, tg, x = _ring_graph(32, 4)
    net = tgt.HamiltonianGraphNet(tgt.PhysicsConfig(dt=0.01))
    q, p = net.init_state(_t(0.1 * x))
    e0 = float(tgt.hamiltonian(q, p, tg, net.config))
    q2, p2, energies = net.forward(q, p, tg, steps=200)
    drift = abs(float(energies[-1]) - e0) / (abs(e0) + 1e-9)
    assert drift < 1e-3, drift
    assert not np.allclose(q2.numpy(), q.numpy())
    jnet = jgt.HamiltonianGraphNet(jgt.PhysicsConfig(dt=0.01))
    jq, jp = jnet.init_state(jnp.asarray(0.1 * x))
    np.testing.assert_allclose(e0, float(jgt.hamiltonian(jq, jp, jg, jnet.config)), rtol=1e-6)
    jq2, jp2, jenergies = jnet.forward(jq, jp, jg, steps=200)
    _close(q2, jq2, ITER_TOL)
    _close(p2, jp2, ITER_TOL)
    _close(energies, jenergies, ITER_TOL)


def test_conservative_pde_attention_preserves_mass():
    jg, tg, x = _ring_graph(64, 8)
    out, drift = tgt.conservative_pde_attention(_t(x), tg, diffusion=0.2, steps=10)
    assert abs(float(drift)) < 1e-3

    def roughness(v):
        return float(np.sum((v - np.roll(v, 1, axis=0)) ** 2))

    assert roughness(out.numpy()) < roughness(x)
    jout, _ = jgt.conservative_pde_attention(jnp.asarray(x), jg, diffusion=0.2, steps=10)
    _close(out, jout)


# --- biological -------------------------------------------------------------------

@pytest.mark.parametrize("k_winners", [0, 6])
def test_spiking_attention_matches_jax(k_winners):
    jg, tg, x = _ring_graph(32, 8, seed=1)
    cfg = dict(threshold=0.5, k_winners=k_winners)
    agg, counts, v = tgt.SpikingGraphAttention(tgt.BiologicalConfig(**cfg)).forward(
        _t(x), tg, steps=10)
    assert float(torch.sum(counts)) > 0 and agg.shape == x.shape
    jagg, jcounts, jv = jgt.SpikingGraphAttention(jgt.BiologicalConfig(**cfg)).forward(
        jnp.asarray(x), jg, steps=10)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jcounts))
    _close(agg, jagg)
    _close(v, jv)


def test_spike_surrogate_gradient():
    """The straight-through spike: hard in value, the sigmoid's derivative
    in gradient, as jax.grad of the JAX spike."""
    from ruvector_tpu.graph_transformer.biological import _spike as jspike
    from ruvector_tpu_torch.graph_transformer.biological import _spike as tspike

    v = np.linspace(-1.0, 3.0, 9).astype(np.float32)
    tv = _t(v).requires_grad_(True)
    out = tspike(tv, 1.0, 4.0)
    np.testing.assert_array_equal(out.detach().numpy(), (v >= 1.0).astype(np.float32))
    out.sum().backward()
    jgrad = jax.grad(lambda a: jnp.sum(jspike(a, 1.0, 4.0)))(jnp.asarray(v))
    _close(tv.grad, jgrad)


def test_k_winners_take_all():
    v = torch.tensor([0.1, 3.0, 2.0, 5.0])
    out = tgt.k_winners_take_all(v, torch.ones(4), k=2).numpy()
    np.testing.assert_array_equal(out, [0.0, 1.0, 0.0, 1.0])


def test_stdp_sign_structure():
    """Pre before post potentiates; post before pre depresses
    (biological.rs:512); every step equals JAX's within 1e-7."""
    jg, tg, _ = _ring_graph(4, 2)
    w0, zeros = np.full((4, 2), 0.5, np.float32), np.zeros(4, np.float32)
    pre_spk = np.asarray([0.0, 1.0, 0.0, 0.0], np.float32)
    post_spk = np.asarray([1.0, 0.0, 0.0, 0.0], np.float32)

    def run(first, second):
        w1, pre_tr, post_tr = tgt.stdp_update(_t(w0), _t(zeros), _t(zeros), *first, tg)
        w2, _, _ = tgt.stdp_update(w1, pre_tr, post_tr, *second, tg)
        jw1, jpre, jpost = jgt.stdp_update(jnp.asarray(w0), jnp.asarray(zeros),
                                           jnp.asarray(zeros),
                                           *[jnp.asarray(_np(a)) for a in first], jg)
        jw2, _, _ = jgt.stdp_update(jw1, jpre, jpost, *[jnp.asarray(_np(a)) for a in second],
                                    jg)
        np.testing.assert_allclose(w2.numpy(), np.asarray(jw2), atol=1e-7)
        return w2

    w2 = run((_t(pre_spk), _t(zeros)), (_t(zeros), _t(post_spk)))
    assert float(w2[0, 1]) > 0.5          # slot 1 = right neighbor (node 1)
    w2b = run((_t(zeros), _t(post_spk)), (_t(pre_spk), _t(zeros)))
    assert float(w2b[0, 1]) < 0.5


def test_hebbian_oja_bounds_norm():
    pre = np.random.default_rng(0).normal(size=8).astype(np.float32)
    w, jw = torch.zeros((8, 8)), jnp.zeros((8, 8))
    for _ in range(200):
        w = tgt.hebbian_update(w, _t(pre), _t(pre), rule="oja", lr=0.05)
        jw = jgt.hebbian_update(jw, jnp.asarray(pre), jnp.asarray(pre), rule="oja", lr=0.05)
    assert float(torch.linalg.vector_norm(w)) < 100.0
    _close(w, jw, ITER_TOL)
    w2, jw2 = torch.zeros((8, 8)), jnp.zeros((8, 8))
    for _ in range(50):
        w2 = tgt.hebbian_update(w2, _t(pre), _t(pre), rule="hebbian", lr=0.5, norm_bound=2.0)
        jw2 = jgt.hebbian_update(jw2, jnp.asarray(pre), jnp.asarray(pre), rule="hebbian",
                                 lr=0.5, norm_bound=2.0)
    assert float(torch.linalg.vector_norm(w2)) <= 2.0 + 1e-4
    _close(w2, jw2, ITER_TOL)
    with pytest.raises(ValueError):
        tgt.hebbian_update(w2, _t(pre), _t(pre), rule="nope")


# --- self-organizing --------------------------------------------------------------

def test_morphogenetic_field_differentiates():
    jg, tg, _ = _ring_graph(128, 1)
    uniform = np.array(jax.random.uniform(jax.random.key(0), (128,)))
    field = tgt.MorphogeneticField()
    a, b = field.init_state(128, uniform=uniform, device="cpu")
    ja, jb = jgt.MorphogeneticField().init_state(128, seed=0)
    np.testing.assert_array_equal(b.numpy(), np.asarray(jb))
    seeded = b.numpy() > 0
    assert seeded.any() and not seeded.all()
    a2, b2, scores = field.step(a, b, tg, steps=10)
    assert np.all(np.isfinite(scores.numpy())) and np.all(np.isfinite(a2.numpy()))
    # the reaction consumes the activator where the inhibitor was seeded
    assert a2.numpy()[seeded].mean() < a2.numpy()[~seeded].mean()
    ja2, jb2, _ = jgt.MorphogeneticField().step(ja, jb, jg, steps=10)
    _close(a2, ja2)
    _close(b2, jb2)
    # the port's own seeds: a field of the same kind
    _, own = field.init_state(128, seed=0, device="cpu")
    assert set(np.unique(own.numpy())) <= {0.0, 0.25}


def test_developmental_program_grows_within_budget():
    jg, tg, _ = _ring_graph(32, 1)
    scores = np.linspace(1.0, 0.0, 32)
    res = tgt.DevelopmentalProgram(max_growth_budget=5, threshold=0.3).grow(tg, scores)
    assert 0 < res.budget_used <= 5 and res.new_edges.shape[1] == 2
    idx = tg.nbr_idx.numpy()
    for i, t in res.new_edges:
        assert t not in idx[i]
    jres = jgt.DevelopmentalProgram(max_growth_budget=5, threshold=0.3).grow(jg, scores)
    np.testing.assert_array_equal(res.new_edges, jres.new_edges)


def test_graph_coarsener_roundtrip():
    jg, tg, x = _ring_graph(64, 4)
    c = tgt.GraphCoarsener()
    res = c.coarsen(tg, _t(x))
    assert 1 < res.num_coarse < 64
    back = c.uncoarsen(res, res.coarse_features)
    assert back.shape == x.shape
    agg = torch.from_numpy(res.agg)
    m1 = torch.zeros(res.num_coarse, 4).index_add_(0, agg, _t(x))
    m2 = torch.zeros(res.num_coarse, 4).index_add_(0, agg, back)
    np.testing.assert_allclose(m1.numpy(), m2.numpy(), atol=1e-4)
    jres = jgt.GraphCoarsener().coarsen(jg, jnp.asarray(x))
    np.testing.assert_array_equal(res.agg, jres.agg)
    _close(res.coarse_features, jres.coarse_features)


# --- manifold ---------------------------------------------------------------------

def test_curvature_router_directions():
    r, jr = tgt.CurvatureAdaptiveRouter(), jgt.CurvatureAdaptiveRouter()
    w_neg = r.route(-0.5)
    assert w_neg.hyperbolic > w_neg.spherical and w_neg.hyperbolic > w_neg.euclidean
    w_pos = r.route(0.5)
    assert w_pos.spherical > w_pos.hyperbolic
    w_flat = r.route(0.0)
    assert w_flat.euclidean >= max(w_flat.spherical, w_flat.hyperbolic)
    curv = np.asarray([-0.5, -0.05, 0.0, 0.3, 0.5], np.float32)
    batch = r.route_batch(curv).numpy()
    np.testing.assert_allclose(batch.sum(axis=1), 1.0, atol=1e-6)
    _close(batch, jr.route_batch(jnp.asarray(curv)))


def test_ollivier_ricci_triangles_vs_tree():
    n = 8
    idx = np.stack([np.delete(np.arange(n), i) for i in range(n)]).astype(np.int32)
    ones = np.ones((n, n - 1), np.float32)
    jg_complete = JNeighborGraph(nbr_idx=jnp.asarray(idx), nbr_mask=jnp.asarray(ones),
                                 edge_weight=jnp.asarray(ones))
    jg_ring, tg_ring, _ = _ring_graph(8, 1)
    k_complete = tgt.estimate_ollivier_ricci(_port_graph(jg_complete))
    k_ring = tgt.estimate_ollivier_ricci(tg_ring)
    assert float(k_complete.mean()) > float(k_ring.mean())
    _close(k_complete, jgt.estimate_ollivier_ricci(jg_complete))
    _close(k_ring, jgt.estimate_ollivier_ricci(jg_ring))


def test_ollivier_ricci_on_a_knn_graph():
    """A kNN graph with ragged masks: every node's estimate equals JAX's."""
    feats = np.random.default_rng(5).normal(size=(40, 6)).astype(np.float32)
    jg = jbuild_knn(jnp.asarray(feats), k=5)
    mask = np.array(jg.nbr_mask)
    mask[::3, -1] = 0.0
    jg = JNeighborGraph(nbr_idx=jg.nbr_idx, nbr_mask=jnp.asarray(mask),
                        edge_weight=jg.edge_weight)
    _close(tgt.estimate_ollivier_ricci(_port_graph(jg)), jgt.estimate_ollivier_ricci(jg))


def test_riemannian_adam_descends_and_stays_in_ball():
    target = np.asarray([[0.3, 0.2]], np.float32)
    z0 = np.asarray([[-0.4, 0.1]], np.float32)
    params, state = {"z": _t(z0)}, None
    state = tgt.riemannian_adam_init(params)
    jparams = {"z": jnp.asarray(z0)}
    jstate = jgt.riemannian_adam_init(jparams)

    def loss(p):
        return torch.sum(tpoincare(p["z"], _t(target)) ** 2)

    l0 = float(loss(params))
    for _ in range(100):
        z = params["z"].clone().requires_grad_(True)
        loss({"z": z}).backward()
        params, state = tgt.riemannian_adam_update(params, {"z": z.grad}, state, lr=0.05)
        jgrads = jax.grad(lambda p: jnp.sum(jpoincare(p["z"], jnp.asarray(target)) ** 2))(
            jparams)
        jparams, jstate = jgt.riemannian_adam_update(jparams, jgrads, jstate, lr=0.05)
    assert float(loss(params)) < l0 * 0.1
    assert float(torch.linalg.vector_norm(params["z"])) < 1.0
    assert state["t"] == int(jstate["t"]) == 100
    _close(params["z"], jparams["z"], ITER_TOL)
    _close(state["v"]["z"], jstate["v"]["z"], ITER_TOL)


def test_geodesic_message_passing_contracts():
    jg, tg, _ = _ring_graph(16, 2)
    x = (0.3 * np.random.default_rng(0).normal(size=(16, 2))).astype(np.float32)
    out = tgt.geodesic_message_passing(_t(x), tg)
    assert np.all(np.linalg.norm(out.numpy(), axis=1) < 1.0)
    assert float(torch.var(out)) < float(np.var(x)) * 1.5
    _close(out, jgt.geodesic_message_passing(jnp.asarray(x), jg))


# --- temporal ---------------------------------------------------------------------

def test_temporal_attention_is_causal():
    seq = np.random.default_rng(0).normal(size=(12, 6)).astype(np.float32)
    out, w = tgt.temporal_attention(seq)
    assert tgt.verify_causal_ordering(w) and out.shape == seq.shape
    np.testing.assert_allclose(w[0].numpy(), np.eye(12)[0], atol=1e-6)
    jout, jw = jgt.temporal_attention(seq)
    _close(out, jout)
    _close(w, jw)
    assert not tgt.verify_causal_ordering(torch.ones(3, 3))


def _granger_series():
    rng = np.random.default_rng(42)
    t = 400
    x = rng.normal(size=t).astype(np.float32)
    y = np.zeros(t, np.float32)
    for i in range(2, t):                 # y driven by lagged x
        y[i] = 0.8 * x[i - 2] + 0.1 * rng.normal()
    return x, y


def test_granger_causality_detects_direction():
    x, y = _granger_series()
    ratio_xy, causal_xy = tgt.granger_causality(x, y, max_lag=4)
    ratio_yx, _ = tgt.granger_causality(y, x, max_lag=4)
    assert causal_xy and ratio_xy > ratio_yx
    jxy, jcausal = jgt.granger_causality(x, y, max_lag=4)
    jyx, _ = jgt.granger_causality(y, x, max_lag=4)
    assert causal_xy == jcausal
    np.testing.assert_allclose([ratio_xy, ratio_yx], [jxy, jyx], rtol=1e-3)


def test_granger_matrix_matches_jax():
    x, y = _granger_series()
    series = np.stack([x, y, np.roll(x, 5)])[:, :200]
    got, want = tgt.granger_matrix(series, max_lag=3), jgt.granger_matrix(series, max_lag=3)
    assert np.all(np.diag(got) == 0.0)
    np.testing.assert_allclose(got, want, rtol=1e-3)


# --- economic ---------------------------------------------------------------------

def test_shapley_efficiency_and_relevance():
    rng = np.random.default_rng(0)
    n, d = 10, 8
    x = rng.normal(size=(n, d)).astype(np.float32)
    query = x[3] + 0.01 * rng.normal(size=d).astype(np.float32)
    key = jax.random.key(0)
    perms = np.array(jax.vmap(lambda k: jax.random.permutation(k, n))(
        jax.random.split(key, 64)))
    phi = tgt.shapley_attention(_t(x), _t(query), perms).numpy()
    assert np.argmax(phi) == 3
    v_grand = float(teco._coalition_value(_t(x), _t(query), torch.ones(n)))
    v_empty = float(teco._coalition_value(_t(x), _t(query), torch.zeros(n)))
    np.testing.assert_allclose(phi.sum(), v_grand - v_empty, atol=1e-3)
    np.testing.assert_allclose(v_grand, float(jeco._coalition_value(
        jnp.asarray(x), jnp.asarray(query), jnp.ones(n))), atol=1e-6)
    _close(phi, jgt.shapley_attention(jnp.asarray(x), jnp.asarray(query), key,
                                      num_permutations=64))
    own = tgt.shapley_attention(_t(x), _t(query), num_permutations=64).numpy()
    assert np.argmax(own) == 3
    np.testing.assert_allclose(own.sum(), v_grand - v_empty, atol=1e-3)


def test_nash_attention_converges_row_stochastic():
    x = np.random.default_rng(1).normal(size=(12, 4)).astype(np.float32)
    stakes = np.linspace(0.5, 1.5, 12).astype(np.float32)
    alloc, payoffs = tgt.nash_attention(_t(x), stakes=_t(stakes), iters=50)
    a = alloc.numpy()
    np.testing.assert_allclose(a.sum(axis=1), 1.0, atol=1e-3)
    assert np.all(a >= 0) and np.all(np.isfinite(payoffs.numpy()))
    jalloc, jpayoffs = jgt.nash_attention(jnp.asarray(x), stakes=jnp.asarray(stakes), iters=50)
    _close(alloc, jalloc)
    _close(payoffs, jpayoffs)


def test_incentive_slashing():
    jg, tg, x = _ring_graph(16, 4, seed=2)
    x[5] = 100.0                          # node 5 is a wild outlier
    consensus, state, slashed = tgt.incentive_aligned_step(
        _t(x), tg.nbr_idx, tg.nbr_mask, tgt.IncentiveState(stakes=torch.ones(16)))
    assert bool(slashed[5]) and float(state.stakes[5]) < 1.0
    jcons, jstate, jslashed = jgt.incentive_aligned_step(
        jnp.asarray(x), jg.nbr_idx, jg.nbr_mask, jgt.IncentiveState(stakes=jnp.ones(16)))
    np.testing.assert_array_equal(slashed.numpy(), np.asarray(jslashed))
    _close(consensus, jcons)
    _close(state.stakes, jstate.stakes)


# --- the slice as a whole ---------------------------------------------------------

def test_verified_training_of_the_block_matches_jax():
    """The slice end to end: three verified Adam steps of the 2-layer
    graph transformer on a kNN graph (MSE to a target), then PPR-sampled
    attention over its output. Losses and the invariants' values within
    2e-5 of scale, the same commits, the final weights within 1e-4."""
    feats, jg, cfg, jparams = _block_case(n=32, d=16, seed=6)
    target = np.random.default_rng(7).normal(size=feats.shape).astype(np.float32)
    tcfg, jcfg = tgt.GraphTransformerConfig(**cfg), jgt.GraphTransformerConfig(**cfg)
    graph = _port_graph(jg)

    def loss_t(p, batch):
        return torch.mean((tgt.graph_transformer_apply(p, tcfg, batch, graph) - _t(target)) ** 2)

    def loss_j(p, batch):
        return jnp.mean((jgt.graph_transformer_apply(p, jcfg, batch, jg) - target) ** 2)

    invs = lambda m: [m.LossStabilityBound(), m.WeightNormBound(),  # noqa: E731
                      m.LipschitzBound(tolerance=1e6), m.EnergyGateInvariant()]
    tt = tgt.VerifiedTrainer(loss_t, topt.adam(1e-2), _p(jparams), invs(tgt))
    jt = jgt.VerifiedTrainer(loss_j, jopt.adam(1e-2), jparams, invs(jgt))
    for _ in range(3):
        r, jr = tt.train_step(_t(feats)), jt.train_step(jnp.asarray(feats))
        assert r.committed == jr.committed
        np.testing.assert_allclose(r.loss, jr.loss, rtol=F32_TOL)
        for c, jc in zip(r.checks, jr.checks):
            assert (c.name, c.passed) == (jc.name, jc.passed)
            np.testing.assert_allclose(c.value, jc.value, rtol=1e-4, atol=1e-6)
    for got, want in zip(tree_leaves(tt.params), tree_leaves(_p(jt.params))):
        _close(got, want, ITER_TOL)
    cert, jcert = tt.seal(), jt.seal()
    assert (cert.steps, cert.committed_steps, cert.total_violations) == \
        (jcert.steps, jcert.committed_steps, jcert.total_violations)
    out = tgt.graph_transformer_apply(tt.params, tcfg, _t(feats), graph).detach()
    jout = jgt.graph_transformer_apply(jt.params, jcfg, jnp.asarray(feats), jg)
    queries = np.asarray([1, 9, 30])
    _close(tgt.ppr_sampled_attention(out, graph.to_csr(), queries,
                                     tgt.SublinearConfig(ppr_top_k=6)),
           jgt.ppr_sampled_attention(jout, jg.to_csr(), queries,
                                     jgt.SublinearConfig(ppr_top_k=6)), ITER_TOL)
