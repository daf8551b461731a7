"""Parity of the port's attention family against the JAX package, on the
CPU (the anchors of tests/test_attention.py): linear attention and its
kernels, the local/global window, edge features, the Poincaré maps and
hyperbolic attention, graph RoPE and its scalings, the registry over the
whole family, and the trainable adapter's Adam step.

Inputs are made with numpy from a seed and handed to both packages;
JAX-initialised parameters cross over with params_from_numpy. f32 outputs
agree within 2e-5 (the anchors' looser bounds only for their identities,
such as the hyperbolic round trip near a base point at 2e-2); masks
exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ruvector_tpu.attention import edge_featured as jef
from ruvector_tpu.attention import hyperbolic as jhyp
from ruvector_tpu.attention import info_bottleneck as jib
from ruvector_tpu.attention import linear_attn as jlin
from ruvector_tpu.attention import local_global as jlg
from ruvector_tpu.attention import pde as jpde
from ruvector_tpu.attention import rope as jrope
from ruvector_tpu.attention import sheaf as jsheaf
from ruvector_tpu.attention import trainable as jtrain
from ruvector_tpu.attention import transport as jtr
from ruvector_tpu.attention.base import get_attention as jget_attention
from ruvector_tpu_torch.attention import (
    EdgeFeaturedConfig,
    TrainableAttention,
    edge_featured_apply,
    edge_featured_init,
    exp_map,
    get_attention,
    graph_rope_encode,
    hyperbolic_attention,
    linear_attention_apply,
    linear_attention_init,
    list_attention,
    local_global_attention,
    log_map,
    mobius_add,
    mobius_scalar_mult,
    poincare_distance,
    project_to_ball,
    rope_rotate,
)
from ruvector_tpu_torch.attention import info_bottleneck as tib
from ruvector_tpu_torch.attention import pde as tpde
from ruvector_tpu_torch.attention import sheaf as tsheaf
from ruvector_tpu_torch.attention import transport as ttr
from ruvector_tpu_torch.attention.linear_attn import LinearAttentionConfig
from ruvector_tpu_torch.attention.local_global import local_global_mask
from ruvector_tpu_torch.attention.rope import rope_tables
from ruvector_tpu_torch.convert import params_from_numpy

F32_TOL = 2e-5


def rand(*shape, seed=0, scale=1.0):
    return (scale * np.random.default_rng(seed).normal(size=shape)).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _j(a):
    return jnp.asarray(a)


def _np_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def _p(jparams):
    return params_from_numpy(_np_tree(jparams), "cpu")


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


# --- linear attention -----------------------------------------------------------

@pytest.mark.parametrize("kernel", ["softmax", "relu", "elu"])
@pytest.mark.parametrize("masked", [False, True])
def test_linear_attention_kernels(kernel, masked):
    jcfg = jlin.LinearAttentionConfig(dim=16, num_features=64, kernel=kernel)
    jparams = jlin.linear_attention_init(jax.random.key(0), jcfg)
    scale = 0.3 if kernel == "softmax" else 1.0
    q, k, v, mask = _qkv(3, 20, 16, seed=11, scale=scale, masked=masked)
    targs, jargs = _both(q, k, v, mask)
    out = linear_attention_apply(_p(jparams), LinearAttentionConfig(16, 64, kernel), *targs)
    want = jlin.linear_attention_apply(jparams, jcfg, *jargs)
    assert np.all(np.isfinite(out.numpy()))
    _close(out, want, atol=F32_TOL * max(1.0, float(np.abs(want).max())))
    if kernel == "softmax" and not masked:
        # output should be a convex-ish combination: within value range bounds
        assert np.abs(out.numpy()).max() < np.abs(v).max() * 2


def test_linear_attention_init():
    p = linear_attention_init(0, LinearAttentionConfig(dim=16, num_features=256), device="cpu")
    assert p["proj"].shape == (256, 16)
    assert abs(float(p["proj"].std()) - 0.25) < 0.02    # N(0, 1) / sqrt(16)


# --- local / global ---------------------------------------------------------------

def test_local_global_window():
    s, d = 32, 8
    q, k, v = rand(s, d, seed=17), rand(s, d, seed=18), rand(s, d, seed=19)
    out = local_global_attention(_t(q), _t(k), _t(v), local_window=4, num_global=2)
    assert out.shape == (s, d)
    _close(out, jlg.local_global_attention(_j(q), _j(k), _j(v), local_window=4, num_global=2))
    # position 20 attends only {0,1} ∪ {18..22}; verify by perturbing key 10
    k2 = k.copy()
    k2[10] += 100.0
    out2 = local_global_attention(_t(q), _t(k2), _t(v), local_window=4, num_global=2)
    _close(out[20], out2[20], atol=1e-5)
    # but perturbing key 0 (global) changes everything
    k3 = k.copy()
    k3[0] += 100.0
    out3 = local_global_attention(_t(q), _t(k3), _t(v), local_window=4, num_global=2)
    assert not np.allclose(out[20].numpy(), out3[20].numpy())


@pytest.mark.parametrize("window,num_global", [(64, 4), (6, 0), (0, 3)])
def test_local_global_mask_and_key_mask(window, num_global):
    s, d = 40, 8
    m = local_global_mask(s, window, num_global, device="cpu")
    np.testing.assert_array_equal(m.numpy(), np.asarray(jlg.local_global_mask(s, window,
                                                                              num_global)))
    q, k, v = rand(s, d, seed=20), rand(s, d, seed=21), rand(s, 5, seed=22)
    keys = (np.arange(s) % 3 != 1).astype(np.float32)
    out = local_global_attention(_t(q), _t(k), _t(v), window, num_global, mask=_t(keys))
    _close(out, jlg.local_global_attention(_j(q), _j(k), _j(v), window, num_global,
                                           mask=_j(keys)))


# --- edge features ----------------------------------------------------------------

@pytest.mark.parametrize("concat", [True, False])
@pytest.mark.parametrize("with_edges,masked", [(False, False), (True, False), (True, True)])
def test_edge_featured(concat, with_edges, masked):
    jcfg = jef.EdgeFeaturedConfig(node_dim=32, edge_dim=8, num_heads=4, concat_heads=concat)
    cfg = EdgeFeaturedConfig(node_dim=32, edge_dim=8, num_heads=4, concat_heads=concat)
    jparams = jef.edge_featured_init(jax.random.key(2), jcfg)
    q, k, v, mask = _qkv(3, 10, 32, seed=20, masked=masked)
    e = rand(3, 10, 8, seed=23) if with_edges else None
    targs, jargs = _both(q, k, v, mask)
    out = edge_featured_apply(_p(jparams), cfg, *targs,
                              edges=None if e is None else _t(e))
    want = jef.edge_featured_apply(jparams, jcfg, *jargs, edges=None if e is None else _j(e))
    assert out.shape == ((3, 32) if concat else (3, 8))
    _close(out, want)


def test_edge_features_matter_and_k_is_v():
    cfg = EdgeFeaturedConfig(node_dim=32, edge_dim=8, num_heads=4)
    params = edge_featured_init(2, cfg, device="cpu")
    q, k, v, _ = _qkv(3, 10, 32, seed=20)
    e = _t(rand(3, 10, 8, seed=23))
    out0 = edge_featured_apply(params, cfg, _t(q), _t(k), _t(v))
    out1 = edge_featured_apply(params, cfg, _t(q), _t(k), _t(v), edges=e)
    assert not np.allclose(out0.numpy(), out1.numpy())
    kt = _t(k)   # one tensor as keys and values takes one transform
    _close(edge_featured_apply(params, cfg, _t(q), kt, kt),
           edge_featured_apply(params, cfg, _t(q), kt, kt.clone()), atol=0.0)


# --- hyperbolic -----------------------------------------------------------------

def test_poincare_identities():
    u = project_to_ball(_t(rand(5, 8, seed=27, scale=0.3)))
    v = project_to_ball(_t(rand(5, 8, seed=28, scale=0.3)))
    # d(u, u) = 0
    _close(poincare_distance(u, u), np.zeros(5), atol=1e-3)
    # symmetry
    np.testing.assert_allclose(poincare_distance(u, v).numpy(),
                               poincare_distance(v, u).numpy(), rtol=1e-4)
    # mobius_add(0, v) = v
    _close(mobius_add(torch.zeros_like(u), v), v, atol=1e-5)
    # exp/log round trip at the origin is exact
    t = _t(rand(5, 8, seed=29, scale=0.1))
    zero_p = torch.zeros_like(t)
    _close(log_map(exp_map(t, zero_p), zero_p), t, atol=1e-5)
    # near a small-norm base point the round trip is approximate
    p_small = project_to_ball(_t(rand(5, 8, seed=41, scale=0.05)))
    _close(log_map(exp_map(t, p_small), p_small), t, atol=2e-2)


@pytest.mark.parametrize("c", [1.0, 0.5])
def test_poincare_ops_match_jax(c):
    """Each map against JAX, with points near and at the boundary and a
    zero tangent vector (the EPS guards)."""
    x = rand(6, 8, seed=30, scale=0.4)
    x[1] *= 40.0        # projected onto the boundary
    y = rand(6, 8, seed=31, scale=0.3)
    t = rand(6, 8, seed=32, scale=0.2)
    t[2] = 0.0
    tx, ty, tt = _t(x), _t(y), _t(t)
    jx, jy, jt = _j(x), _j(y), _j(t)
    px, jpx = project_to_ball(tx, c), jhyp.project_to_ball(jx, c)
    py, jpy = project_to_ball(ty, c), jhyp.project_to_ball(jy, c)
    _close(px, jpx)
    # inside the ball (at the boundary 1 - c||x||^2 is rounding noise)
    inner = np.arange(6) != 1
    _close(poincare_distance(px, py, c)[inner],
           np.asarray(jhyp.poincare_distance(jpx, jpy, c))[inner], atol=F32_TOL * 10)
    _close(mobius_add(px, py, c), jhyp.mobius_add(jpx, jpy, c))
    _close(mobius_scalar_mult(0.7, py, c), jhyp.mobius_scalar_mult(0.7, jpy, c))
    _close(mobius_scalar_mult(1.3, tt, c), jhyp.mobius_scalar_mult(1.3, jt, c))
    _close(exp_map(tt, py, c), jhyp.exp_map(jt, jpy, c))
    _close(log_map(px, py, c), jhyp.log_map(jpx, jpy, c), atol=1e-4)


@pytest.mark.parametrize("masked", [False, True])
def test_hyperbolic_attention(masked):
    q, k, v, mask = _qkv(3, 6, 8, seed=30, scale=0.3, masked=masked)
    targs, jargs = _both(q, k, v, mask)
    out = hyperbolic_attention(*targs, c=0.8, temperature=0.5)
    assert out.shape == (3, 8)
    assert np.all(np.isfinite(out.numpy()))
    _close(out, jhyp.hyperbolic_attention(*jargs, c=0.8, temperature=0.5))


# --- RoPE -------------------------------------------------------------------------

def test_rope_relative_property():
    # RoPE: score depends only on relative distance
    dim = 16
    cos_t, sin_t = rope_tables(dim, max_position=64, device="cpu")
    q, k = _t(rand(1, dim, seed=33)), _t(rand(1, 4, dim, seed=34))
    d1 = torch.tensor([[1, 2, 3, 4]], dtype=torch.int32)
    q1, k1 = graph_rope_encode(q, k, d1, cos_t, sin_t)
    s1 = torch.einsum("bd,bsd->bs", q1, k1)
    off = 7
    q2 = rope_rotate(q, torch.full(q.shape[:-1], off, dtype=torch.int32), cos_t, sin_t)
    k2 = rope_rotate(k, d1 + off, cos_t, sin_t)
    _close(s1, torch.einsum("bd,bsd->bs", q2, k2), atol=1e-4)
    jcos, jsin = jrope.rope_tables(dim, max_position=64)
    jq1, jk1 = jrope.graph_rope_encode(_j(q.numpy()), _j(k.numpy()), _j(d1.numpy()), jcos, jsin)
    _close(q1, jq1)
    _close(k1, jk1)


@pytest.mark.parametrize("scaling", ["none", "linear", "ntk", "yarn"])
def test_rope_scaling_variants(scaling):
    cos_t, sin_t = rope_tables(16, 32, scaling=scaling, scaling_factor=2.0, device="cpu")
    assert cos_t.shape == (32, 8)
    assert np.all(np.isfinite(cos_t.numpy()))
    jcos, jsin = jrope.rope_tables(16, 32, scaling=scaling, scaling_factor=2.0)
    _close(cos_t, jcos)
    _close(sin_t, jsin)


# --- registry ---------------------------------------------------------------------------

_FAMILY = ["edge_featured", "linear", "hyperbolic", "local_global", "diffusion",
           "sliced_wasserstein", "centroid_ot", "sheaf", "info_bottleneck"]


def test_registry_has_the_family():
    names = list_attention()
    for want in ["scaled_dot", "flash", *_FAMILY]:
        assert want in names, names


def _registry_case(name):
    """A small config (None: the mechanism takes none) and whether it is
    the sequence form."""
    cfg = {"edge_featured": (jef.EdgeFeaturedConfig(16, 4, 2), EdgeFeaturedConfig(16, 4, 2)),
           "linear": (jlin.LinearAttentionConfig(16, 32, "relu"),
                      LinearAttentionConfig(16, 32, "relu")),
           "diffusion": (jpde.DiffusionConfig(16, num_steps=2), tpde.DiffusionConfig(16,
                                                                                     num_steps=2)),
           "sliced_wasserstein": (jtr.TransportConfig(16), ttr.TransportConfig(16)),
           "centroid_ot": (jtr.TransportConfig(16, num_centroids=3),
                           ttr.TransportConfig(16, num_centroids=3)),
           "sheaf": (jsheaf.SheafAttentionConfig(16, 8), tsheaf.SheafAttentionConfig(16, 8)),
           "info_bottleneck": (jib.IBConfig(16, 4), tib.IBConfig(16, 4))}.get(name, (None, None))
    return cfg, name in ("local_global", "sheaf")


@pytest.mark.parametrize("name", _FAMILY)
def test_get_attention_applies(name):
    """Each mechanism through both registries: JAX-initialised parameters,
    the same inputs, the same output."""
    (jcfg, cfg), sequence = _registry_case(name)
    jm, tm = jget_attention(name), get_attention(name)
    assert (jm.init is None) == (tm.init is None)
    jparams = jm.init(jax.random.key(12), jcfg) if jm.init is not None else None
    params = _p(jparams) if jparams is not None else None
    if sequence:
        q, k, v = rand(12, 16, seed=60), rand(12, 16, seed=61), rand(12, 16, seed=62)
        mask = (np.arange(12) % 4 != 3).astype(np.float32)
    else:
        q, k, v, mask = _qkv(3, 6, 16, seed=60, scale=0.3, masked=True)
    out = tm.apply(params, cfg, _t(q), _t(k), _t(v), _t(mask))
    want = jm.apply(jparams, jcfg, _j(q), _j(k), _j(v), _j(mask))
    assert out.shape == want.shape
    _close(out, want)
    if tm.init is not None:   # the port's own init at the default config's shapes
        own = tm.init(0, tm.default_config, device="cpu")
        ref = jax.eval_shape(lambda key: jm.init(key, jm.default_config), jax.random.key(0))
        assert jax.tree_util.tree_map(lambda a: tuple(a.shape), ref) == jax.tree_util.tree_map(
            lambda t: tuple(t.shape), own)


# --- trainable --------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["edge_featured", "linear"])
def test_trainable_train_step_matches_jax(name):
    """One Adam step of a parametric mechanism from JAX's parameters: the
    loss, the gradient norm and every parameter after the step."""
    cfg = {"edge_featured": (jef.EdgeFeaturedConfig(16, 4, 2), EdgeFeaturedConfig(16, 4, 2)),
           "linear": (jlin.LinearAttentionConfig(16, 32, "relu"),
                      LinearAttentionConfig(16, 32, "relu"))}[name]
    jt = jtrain.TrainableAttention(name, cfg[0], seed=3, learning_rate=1e-2)
    tt = TrainableAttention(name, cfg[1], seed=3, learning_rate=1e-2, device="cpu")
    tt.params = _p(jt.params)
    tt.opt_state = tt.opt.init(tt.params)
    q, k, v, _ = _qkv(4, 5, 16, seed=70, scale=0.5)
    target = rand(4, 16, seed=74)
    jg = jt.backward(_j(q), _j(k), _j(v), _j(target))
    tg = tt.backward(_t(q), _t(k), _t(v), _t(target))
    assert tg.loss == pytest.approx(jg.loss, abs=F32_TOL)
    assert tg.grad_norm == pytest.approx(jg.grad_norm, rel=1e-5)
    jloss = jt.train_step(_j(q), _j(k), _j(v), _j(target))
    loss = tt.train_step(_t(q), _t(k), _t(v), _t(target))
    assert loss == pytest.approx(jloss, abs=F32_TOL)
    for got, want in zip(jax.tree_util.tree_leaves(tt.params),
                         jax.tree_util.tree_leaves(_np_tree(jt.params))):
        assert not got.requires_grad
        _close(got, want)
    _close(tt.forward(_t(q), _t(k), _t(v)), jt.forward(_j(q), _j(k), _j(v)))


def test_trainable_parameter_free_and_moves():
    q, k, v, _ = _qkv(4, 5, 16, seed=71)
    target = _t(rand(4, 16, seed=75))
    free = TrainableAttention("hyperbolic", device="cpu")
    jfree = jtrain.TrainableAttention("hyperbolic")
    g = free.backward(_t(q), _t(k), _t(v), target)
    assert g.grads is None and g.grad_norm == 0.0
    assert g.loss == pytest.approx(float(jfree.backward(_j(q), _j(k), _j(v),
                                                        _j(target.numpy())).loss), abs=F32_TOL)
    free.update(g)
    assert free.params is None
    tt = TrainableAttention("edge_featured", EdgeFeaturedConfig(16, 4, 2), device="cpu")
    before = [p.clone() for p in jax.tree_util.tree_leaves(tt.params)]
    losses = [tt.train_step(_t(q), _t(k), _t(v), target) for _ in range(3)]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    assert any(not torch.equal(a, b) for a, b in zip(before, jax.tree_util.tree_leaves(
        tt.params)))
