"""Parity of the port's extended attention family against the JAX
package, on the CPU (the anchors of tests/test_attention_extra.py):
sliced-Wasserstein and centroid-OT transport, the KL rate and the
information bottleneck, the graph Laplacian and diffusion, sheaf
attention with its restriction maps, routing and early exit, and the
sparse mask builder.

Inputs are made with numpy from a seed and handed to both packages;
JAX-initialised parameters cross over with params_from_numpy. f32 outputs
agree within 2e-5, masks and lanes exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ruvector_tpu.attention import info_bottleneck as jib
from ruvector_tpu.attention import mask as jmask
from ruvector_tpu.attention import pde as jpde
from ruvector_tpu.attention import sheaf as jsheaf
from ruvector_tpu.attention import transport as jtr
from ruvector_tpu_torch.attention import SparseMaskBuilder
from ruvector_tpu_torch.attention import info_bottleneck as tib
from ruvector_tpu_torch.attention import pde as tpde
from ruvector_tpu_torch.attention import sheaf as tsheaf
from ruvector_tpu_torch.attention import transport as ttr
from ruvector_tpu_torch.convert import params_from_numpy

F32_TOL = 2e-5


def rand(*shape, seed=0, scale=1.0):
    return (scale * np.random.default_rng(seed).normal(size=shape)).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _j(a):
    return jnp.asarray(a)


def _p(jparams):
    return params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), "cpu")


def _close(got, want, atol=F32_TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), atol=atol, rtol=0)


def _qkv(b, s, d, seed, scale=1.0, masked=False):
    q, k, v = (rand(b, d, seed=seed, scale=scale), rand(b, s, d, seed=seed + 1, scale=scale),
               rand(b, s, d, seed=seed + 2))
    mask = None
    if masked:
        mask = (np.random.default_rng(seed + 3).random((b, s)) > 0.3).astype(np.float32)
        mask[0] = 0.0           # a row with no key
    return q, k, v, mask


def _both(q, k, v, mask):
    """(torch args, jax args) of the same arrays."""
    conv = [(None if a is None else _t(a), None if a is None else _j(a)) for a in (q, k, v, mask)]
    return [c[0] for c in conv], [c[1] for c in conv]


# --- transport ----------------------------------------------------------------------

def test_sliced_wasserstein_identity_zero():
    jcfg = jtr.TransportConfig(dim=8, num_projections=32)
    jparams = jtr.transport_init(jax.random.key(1), jcfg)
    proj = _p(jparams)["proj"]
    x = rand(5, 8, seed=7)
    _close(ttr.sliced_wasserstein_distance(_t(x), _t(x), proj), 0.0, atol=1e-5)
    y = rand(5, 8, seed=8) + 3.0
    assert float(ttr.sliced_wasserstein_distance(_t(x), _t(y), proj)) > 0.5
    # sets of other sizes, aligned on the common grid
    for a, b in ((x, y), (x, rand(9, 8, seed=9)), (rand(3, 8, seed=10), y)):
        _close(ttr.sliced_wasserstein_distance(_t(a), _t(b), proj),
               jtr.sliced_wasserstein_distance(_j(a), _j(b), jparams["proj"]))


def test_transport_init_unit_columns():
    p = ttr.transport_init(0, ttr.TransportConfig(dim=8, num_projections=32), device="cpu")
    assert p["proj"].shape == (8, 32)
    _close(torch.linalg.vector_norm(p["proj"], dim=0), np.ones(32), atol=1e-6)


@pytest.mark.parametrize("masked", [False, True])
def test_sw_attention(masked):
    jcfg = jtr.TransportConfig(dim=8, temperature=0.3)
    jparams = jtr.transport_init(jax.random.key(2), jcfg)
    q, k, v, mask = _qkv(4, 7, 8, seed=40, masked=masked)
    targs, jargs = _both(q, k, v, mask)
    cfg = ttr.TransportConfig(dim=8, temperature=0.3)
    _close(ttr.sliced_wasserstein_attention(_p(jparams), cfg, *targs),
           jtr.sliced_wasserstein_attention(jparams, jcfg, *jargs))


def test_sw_attention_prefers_similar_keys():
    cfg = ttr.TransportConfig(dim=8, temperature=0.1)
    params = ttr.transport_init(2, cfg, device="cpu")
    q = rand(1, 8, seed=9)
    k = np.concatenate([q[:, None, :], 5.0 + rand(1, 3, 8, seed=10)], axis=1)
    v = np.concatenate([np.ones((1, 1, 8)), np.zeros((1, 3, 8))], axis=1).astype(np.float32)
    out = ttr.sliced_wasserstein_attention(params, cfg, _t(q), _t(k), _t(v))
    assert float(out[0, 0]) > 0.7   # mass concentrated on the matching key


@pytest.mark.parametrize("case", ["plain", "masked", "duplicate_keys", "few_keys"])
def test_centroid_ot_attention(case):
    """Plain, masked, keys repeated among the first C (equal centroids:
    argmin's first index wins), and fewer keys than centroids."""
    s = 3 if case == "few_keys" else 12
    jcfg = jtr.TransportConfig(dim=8, num_centroids=5)
    jparams = jtr.transport_init(jax.random.key(3), jcfg)
    q, k, v, mask = _qkv(3, s, 8, seed=11, masked=case == "masked")
    if case == "duplicate_keys":
        k[:, 1] = k[:, 0]
        k[:, 4] = k[:, 2]
        k[:, 9] = k[:, 0]
    targs, jargs = _both(q, k, v, mask)
    out = ttr.centroid_ot_attention(_p(jparams), ttr.TransportConfig(dim=8, num_centroids=5),
                                    *targs)
    assert out.shape == (3, 8)
    assert np.all(np.isfinite(out.numpy()))
    _close(out, jtr.centroid_ot_attention(jparams, jcfg, *jargs))


# --- info bottleneck ------------------------------------------------------------------

def test_kl_diagonal_gaussian():
    mu, logvar = rand(3, 4, seed=50), rand(3, 4, seed=51)
    _close(tib.kl_diagonal_gaussian(_t(mu), _t(logvar)),
           jib.kl_diagonal_gaussian(_j(mu), _j(logvar)))
    _close(tib.kl_diagonal_gaussian(torch.zeros(3, 4), torch.zeros(3, 4)), np.zeros(3),
           atol=1e-6)
    assert float(tib.kl_diagonal_gaussian(torch.ones(1, 4), torch.zeros(1, 4))[0]) > 0


@pytest.mark.parametrize("masked", [False, True])
def test_ib_attention(masked):
    jcfg = jib.IBConfig(dim=16, bottleneck_dim=8)
    jparams = jib.ib_init(jax.random.key(4), jcfg)
    params = _p(jparams)
    cfg = tib.IBConfig(dim=16, bottleneck_dim=8)
    q, k, v, mask = _qkv(3, 5, 16, seed=14, masked=masked)
    targs, jargs = _both(q, k, v, mask)
    o1, r1 = tib.ib_attention(params, cfg, *targs)
    jo, jr = jib.ib_attention(jparams, jcfg, *jargs)
    _close(o1, jo)
    _close(r1, jr)
    o2, r2 = tib.ib_attention(params, cfg, *targs)
    assert torch.equal(o1, o2) and float(r1) >= 0
    # the sampled path: the same rate term, deterministic under one seed,
    # and not the mean's output
    o3, r3 = tib.ib_attention(params, cfg, *targs, rng=torch.Generator().manual_seed(5))
    o4, _ = tib.ib_attention(params, cfg, *targs, rng=torch.Generator().manual_seed(5))
    _, jr3 = jib.ib_attention(jparams, jcfg, *jargs, rng=jax.random.key(5))
    _close(r3, jr3)
    assert torch.equal(o3, o4)
    assert not np.allclose(o1.numpy(), o3.numpy())


# --- diffusion ----------------------------------------------------------------------

@pytest.mark.parametrize("normalized", [True, False])
def test_graph_laplacian(normalized):
    k = rand(2, 5, 8, seed=17)
    mask = np.ones((2, 5), np.float32)
    mask[1, 3:] = 0.0
    lap = tpde.graph_laplacian(_t(k), _t(mask), normalized=normalized)
    _close(lap, jpde.graph_laplacian(_j(k), _j(mask), normalized=normalized))
    if not normalized:
        _close(lap.sum(-1), np.zeros((2, 5)), atol=1e-4)   # rows sum to zero


@pytest.mark.parametrize("steps,normalized,masked", [(0, True, False), (4, True, True),
                                                     (3, False, False)])
def test_diffusion_attention(steps, normalized, masked):
    q, k, v, mask = _qkv(2, 6, 8, seed=18, masked=masked)
    cfg = tpde.DiffusionConfig(dim=8, num_steps=steps, normalized=normalized, temperature=0.7)
    jcfg = jpde.DiffusionConfig(dim=8, num_steps=steps, normalized=normalized, temperature=0.7)
    targs, jargs = _both(q, k, v, mask)
    out = tpde.diffusion_attention(*targs, cfg=cfg)
    assert np.all(np.isfinite(out.numpy()))
    _close(out, jpde.diffusion_attention(*jargs, cfg=jcfg))


def test_diffusion_attention_smooths():
    q, k, v, _ = _qkv(2, 6, 8, seed=18)
    out0 = tpde.diffusion_attention(_t(q), _t(k), _t(v), cfg=tpde.DiffusionConfig(8, num_steps=0))
    out4 = tpde.diffusion_attention(_t(q), _t(k), _t(v), cfg=tpde.DiffusionConfig(8, num_steps=4))
    assert not np.allclose(out0.numpy(), out4.numpy())


# --- sheaf ----------------------------------------------------------------------------

def test_restriction_map_orthonormal():
    r = tsheaf.restriction_map_init(6, 16, 16, device="cpu")
    _close(r.T @ r, np.eye(16), atol=1e-4)
    r = tsheaf.restriction_map_init(7, 16, 8, device="cpu")
    assert r.shape == (16, 8)
    _close(r.T @ r, np.eye(8), atol=1e-4)


def test_sheaf_attention_coherence_weighting():
    jcfg = jsheaf.SheafAttentionConfig(dim=8, restriction_dim=8, beta=1.0)
    jparams = jsheaf.sheaf_init(jax.random.key(7), jcfg)
    # two identical tokens + one outlier: coherent pair attends each other
    base = np.random.default_rng(21).normal(size=8).astype(np.float32)
    x = np.stack([base, base, base + 50.0])
    out, energy = tsheaf.sheaf_attention(_p(jparams), tsheaf.SheafAttentionConfig(8, 8), _t(x))
    assert out.shape == (3, 8)
    assert float(energy[2]) > float(energy[0])      # the outlier carries the energy
    jout, jenergy = jsheaf.sheaf_attention(jparams, jcfg, _j(x))
    _close(out, jout, atol=F32_TOL * 50)            # outputs of order 50
    np.testing.assert_allclose(energy.numpy(), np.asarray(jenergy), rtol=1e-5)


@pytest.mark.parametrize("threshold,masked", [(0.0, False), (0.0, True), (0.5, False),
                                              (0.3, True)])
def test_sheaf_attention(threshold, masked):
    s = 24
    jcfg = jsheaf.SheafAttentionConfig(dim=8, restriction_dim=6, beta=0.5,
                                       residual_sparse_threshold=threshold)
    cfg = tsheaf.SheafAttentionConfig(dim=8, restriction_dim=6, beta=0.5,
                                      residual_sparse_threshold=threshold)
    jparams = jsheaf.sheaf_init(jax.random.key(8), jcfg)
    x = rand(s, 8, seed=24, scale=0.5)
    mask = (np.arange(s) % 5 != 2).astype(np.float32) if masked else None
    out, energy = tsheaf.sheaf_attention(_p(jparams), cfg, _t(x),
                                         None if mask is None else _t(mask))
    jout, jenergy = jsheaf.sheaf_attention(jparams, jcfg, _j(x),
                                           None if mask is None else _j(mask))
    _close(out, jout)
    np.testing.assert_allclose(energy.numpy(), np.asarray(jenergy), rtol=1e-5, atol=1e-5)


def test_sheaf_token_routing():
    energy = [0.1, 0.2, 5.0, 0.15, 8.0, 0.05]
    lanes = tsheaf.route_tokens_by_energy(torch.tensor(energy), full_quantile=0.7,
                                          skip_quantile=0.3)
    assert lanes[4] is tsheaf.ComputeLane.FULL
    assert lanes[5] is tsheaf.ComputeLane.SKIP
    want = jsheaf.route_tokens_by_energy(jnp.asarray(energy), 0.7, 0.3)
    assert [lane.value for lane in lanes] == [lane.value for lane in want]


def test_route_lanes_device_batched():
    e = np.random.default_rng(0).uniform(0, 5, size=(4, 32)).astype(np.float32)
    e[2, :6] = e[2, 6]          # ties at a quantile
    lanes = tsheaf.route_lanes_device(_t(e))
    assert lanes.shape == (4, 32) and lanes.dtype == torch.int32
    np.testing.assert_array_equal(lanes.numpy(), np.asarray(jsheaf.route_lanes_device(_j(e))))
    for b in range(4):
        hi, lo = np.quantile(e[b], 0.7), np.quantile(e[b], 0.3)
        assert (lanes[b].numpy()[e[b] >= hi] == tsheaf.ComputeLane.FULL.value).all()
        assert (lanes[b].numpy()[e[b] <= lo] == tsheaf.ComputeLane.SKIP.value).all()


def test_sheaf_early_exit_converges():
    jcfg = jsheaf.SheafAttentionConfig(dim=8, restriction_dim=8, exit_energy_tol=0.5)
    jparams = jsheaf.sheaf_init(jax.random.key(8), jcfg)
    x = rand(4, 8, seed=22, scale=0.1)
    out, layers = tsheaf.process_with_early_exit(
        _p(jparams), tsheaf.SheafAttentionConfig(dim=8, restriction_dim=8, exit_energy_tol=0.5),
        _t(x), max_layers=8)
    jout, jlayers = jsheaf.process_with_early_exit(jparams, jcfg, _j(x), max_layers=8)
    assert layers < 8 and layers == jlayers
    _close(out, jout)


# --- mask builder ------------------------------------------------------------------------

def test_sparse_mask_builder_patterns():
    m = SparseMaskBuilder(16, device="cpu").add_local_window(2).add_global_tokens([0]).build()
    m = m.numpy()
    assert m[5, 4] and m[5, 7]            # inside window
    assert not m[5, 10]                   # outside window, not global
    assert m[0].all() and m[:, 0].all()   # global token row+col

    causal = SparseMaskBuilder(16, device="cpu").add_local_window(3).add_causal().build()
    assert not causal.numpy()[3, 5]       # future masked

    blocks = SparseMaskBuilder(16, device="cpu").add_block_diagonal(4)
    assert blocks.build().numpy()[1, 3] and not blocks.build().numpy()[3, 4]
    assert 0 < blocks.density() < 1
    r, c = blocks.to_coo()
    assert len(r) == 16 * 4               # 4 blocks of 4x4


@pytest.mark.parametrize("recipe", [
    [("add_local_window", 3, 2), ("add_global_tokens", [1, 7])],
    [("add_block_diagonal", 5), ("add_strided", 4), ("add_causal",)],
    [("add_local_window", 2), ("add_strided", 3), ("add_global_tokens", [0, 18]),
     ("add_causal",)],
])
def test_sparse_mask_builder_matches_jax(recipe):
    got, want = SparseMaskBuilder(19, device="cpu"), jmask.SparseMaskBuilder(19)
    for name, *args in recipe:
        getattr(got, name)(*args)
        getattr(want, name)(*args)
    np.testing.assert_array_equal(got.build().numpy(), np.asarray(want.build()))
    assert got.density() == pytest.approx(want.density(), abs=1e-7)
    for a, b in zip(got.to_coo(), want.to_coo()):
        np.testing.assert_array_equal(a, b)
