"""Parity of the port's segment ops, nn/core, serde and parameter
conversion against the JAX package, on the CPU.

Inputs are made with numpy from a seed and handed to both packages; JAX
parameters come from the JAX init functions and cross over with
params_from_numpy. Tolerance 1e-5 for f32 ops of a few products (sums
run in another order), exact equality for the conversions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ruvector_tpu.nn import core as jcore
from ruvector_tpu.nn import serde as jserde
from ruvector_tpu.ops import segment as jseg
from ruvector_tpu_torch.convert import params_from_numpy, params_to_numpy
from ruvector_tpu_torch.nn import core as tcore
from ruvector_tpu_torch.nn import serde as tserde
from ruvector_tpu_torch.nn.ruvector_layer import RuvectorLayerConfig, ruvector_layer_init
from ruvector_tpu_torch.ops import segment as tseg

F32_TOL = 1e-5


def _np_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, atol=F32_TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol, rtol=0)


def _scores_and_mask(seed, all_masked_row):
    rng = np.random.default_rng(seed)
    scores = rng.normal(size=(6, 3, 9)).astype(np.float32) * 4
    mask = (rng.random((6, 1, 9)) > 0.4).astype(np.float32)
    if all_masked_row:
        mask[2] = 0.0
    return scores, mask


@pytest.mark.parametrize("all_masked_row", [False, True])
def test_masked_softmax(all_masked_row):
    scores, mask = _scores_and_mask(0, all_masked_row)
    want = jseg.masked_softmax(jnp.asarray(scores), jnp.asarray(mask))
    got = tseg.masked_softmax(_t(scores), _t(mask))
    assert torch.isfinite(got).all()
    _close(got, want)
    if all_masked_row:
        assert float(got[2].abs().max()) == 0.0


@pytest.mark.parametrize("zero_weight_row", [False, True])
def test_masked_weighted_mean(zero_weight_row):
    rng = np.random.default_rng(1)
    feats = rng.normal(size=(5, 7, 16)).astype(np.float32)
    w = rng.random((5, 7)).astype(np.float32)
    mask = (rng.random((5, 7)) > 0.3).astype(np.float32)
    if zero_weight_row:
        w[3] = 0.0      # uniform fallback over the valid neighbors
    want = jseg.masked_weighted_mean(jnp.asarray(feats), jnp.asarray(w), jnp.asarray(mask))
    _close(tseg.masked_weighted_mean(_t(feats), _t(w), _t(mask)), want)


def test_spmm_sddmm_padded():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(20, 8)).astype(np.float32)
    q = rng.normal(size=(20, 8)).astype(np.float32)
    idx = rng.integers(0, 20, (20, 5)).astype(np.int32)
    w = rng.random((20, 5)).astype(np.float32)
    mask = (rng.random((20, 5)) > 0.3).astype(np.float32)
    _close(tseg.spmm_padded(_t(x), _t(idx), _t(w), _t(mask)),
           jseg.spmm_padded(jnp.asarray(x), jnp.asarray(idx), jnp.asarray(w), jnp.asarray(mask)))
    _close(tseg.sddmm_padded(_t(q), _t(x), _t(idx), _t(mask)),
           jseg.sddmm_padded(jnp.asarray(q), jnp.asarray(x), jnp.asarray(idx), jnp.asarray(mask)))


def test_linear_and_layer_norm():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(9, 12)).astype(np.float32) * 3 + 1
    lin = _np_tree(jcore.linear_init(jax.random.key(0), 12, 7))
    lin["bias"] = rng.normal(size=7).astype(np.float32)
    ln = {"gamma": rng.normal(size=12).astype(np.float32),
          "beta": rng.normal(size=12).astype(np.float32)}
    _close(tcore.linear_apply(params_from_numpy(lin, "cpu"), _t(x)),
           jcore.linear_apply(lin, jnp.asarray(x)))
    _close(tcore.layer_norm_apply(params_from_numpy(ln, "cpu"), _t(x)),
           jcore.layer_norm_apply(ln, jnp.asarray(x)))


@pytest.mark.parametrize("heads", [1, 4])
def test_mha_apply(heads):
    rng = np.random.default_rng(4)
    n, m, d = 7, 5, 16
    params = _np_tree(jcore.mha_init(jax.random.key(1), d, heads))
    q = rng.normal(size=(n, d)).astype(np.float32)
    kv = rng.normal(size=(n, m, d)).astype(np.float32)
    mask = (rng.random((n, m)) > 0.3).astype(np.float32)
    mask[0] = 0.0
    want = jcore.mha_apply(params, jnp.asarray(q), jnp.asarray(kv), jnp.asarray(kv),
                           jnp.asarray(mask), heads)
    got = tcore.mha_apply(params_from_numpy(params, "cpu"), _t(q), _t(kv), _t(kv),
                          _t(mask), heads)
    _close(got, want)


def test_gru_apply():
    rng = np.random.default_rng(5)
    params = _np_tree(jcore.gru_init(jax.random.key(2), 10, 16))
    x = rng.normal(size=(6, 10)).astype(np.float32)
    h = rng.normal(size=(6, 16)).astype(np.float32)
    _close(tcore.gru_apply(params_from_numpy(params, "cpu"), _t(x), _t(h)),
           jcore.gru_apply(params, jnp.asarray(x), jnp.asarray(h)))


def test_params_from_numpy_round_trip():
    from ruvector_tpu.nn.ruvector_layer import RuvectorLayerConfig as JCfg
    from ruvector_tpu.nn.ruvector_layer import ruvector_layer_init as jinit

    tree = _np_tree(jinit(jax.random.key(3), JCfg(12, 16, heads=4)))
    back = params_to_numpy(params_from_numpy(tree, "cpu"))
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(tree)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(tree)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    # bf16 leaves keep their bits
    bf = np.asarray(jnp.asarray([1.5, -2.25, 3.0e-3], jnp.bfloat16))
    t = params_from_numpy({"w": bf}, "cpu")["w"]
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.float().numpy(), bf.astype(np.float32))


def test_port_init_matches_jax_tree():
    """Same keys, shapes and dtypes as the JAX init; Glorot scale."""
    from ruvector_tpu.nn.ruvector_layer import RuvectorLayerConfig as JCfg
    from ruvector_tpu.nn.ruvector_layer import ruvector_layer_init as jinit

    jtree = _np_tree(jinit(jax.random.key(0), JCfg(64, 128, heads=4)))
    ttree = params_to_numpy(ruvector_layer_init(0, RuvectorLayerConfig(64, 128, heads=4),
                                                device="cpu"))
    assert jax.tree_util.tree_structure(ttree) == jax.tree_util.tree_structure(jtree)
    for a, b in zip(jax.tree_util.tree_leaves(ttree), jax.tree_util.tree_leaves(jtree)):
        assert a.shape == b.shape and a.dtype == b.dtype
    std = ttree["w_agg"]["kernel"].std()
    assert abs(std - (2.0 / 256) ** 0.5) < 0.01


def test_serde_json_crosses_packages():
    from ruvector_tpu.nn.ruvector_layer import RuvectorLayerConfig as JCfg
    from ruvector_tpu.nn.ruvector_layer import ruvector_layer_init as jinit

    jparams = jinit(jax.random.key(4), JCfg(8, 8, heads=2))
    tparams = tserde.params_from_json(jserde.params_to_json(jparams), device="cpu")
    back = jserde.params_from_json(tserde.params_to_json(tparams))
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(jparams)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
