"""Parity of the port's attention over per-query key sets against the JAX
package, on the CPU: the plain version of K8 (flash_neighbor_attention)
against JAX's Pallas kernel in interpret mode in test_pallas.py's four
cases, the blockwise `flash_attention` and `scaled_dot_attention` against
JAX's, and the registry.

Tolerances: 1e-4 for K8, the JAX package's own bound (test_pallas.py);
1e-5 for flash and scaled-dot attention (f32 softmax over at most 256
keys, sums in another order, outputs of order 1).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ruvector_tpu.attention.flash import flash_attention as jflash
from ruvector_tpu.attention.scaled_dot import scaled_dot_attention as jscaled
from ruvector_tpu.ops.pallas.flash_neighbor import flash_neighbor_attention as jkernel
from ruvector_tpu_torch.attention import (
    flash_attention,
    get_attention,
    list_attention,
    scaled_dot_attention,
)
from ruvector_tpu_torch.ops.kernels.flash_neighbor import (
    flash_neighbor_attention,
    flash_neighbor_attention_reference,
)

K8_TOL = 1e-4
TOL = 1e-5


def _qkv(seed, b, m, d, masked=False):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=s).astype(np.float32) for s in ((b, d), (b, m, d), (b, m, d)))
    mask = (rng.random((b, m)) > 0.5).astype(np.float32) if masked else None
    return q, k, v, mask


def _case(name):
    """test_pallas.py's inputs: dense, masked, fully masked, ragged."""
    if name == "dense":
        return _qkv(0, 8, 256, 128)
    if name == "masked":
        return _qkv(1, 8, 256, 128, masked=True)
    if name == "fully_masked":
        ones = np.ones((8, 128, 128), np.float32)
        return np.ones((8, 128), np.float32), ones, ones, np.zeros((8, 128), np.float32)
    return _qkv(2, 5, 100, 128)                            # ragged B and M


def _t(x):
    return None if x is None else torch.from_numpy(x)


@pytest.mark.parametrize("name", ["dense", "masked", "fully_masked", "ragged"])
def test_flash_neighbor_plain_version_matches_jax_kernel(name):
    q, k, v, mask = _case(name)
    jm = None if mask is None else jnp.asarray(mask)
    want = np.asarray(jkernel(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jm,
                              tile_b=8, block_m=128, interpret=True))
    got = flash_neighbor_attention(_t(q), _t(k), _t(v), _t(mask))
    assert got.shape == q.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=K8_TOL, rtol=0)
    if name == "fully_masked":
        assert float(got.abs().max()) == 0.0
    else:
        np.testing.assert_allclose(got.numpy(), np.asarray(jscaled(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jm)), atol=K8_TOL, rtol=0)


@pytest.mark.parametrize("mask_dtype", [np.bool_, np.int32])
def test_flash_neighbor_takes_bf16_inputs_and_any_mask_as_jax_does(mask_dtype):
    """bf16 q, k and v and a bool or int mask, as JAX's function takes them
    (it casts the mask to float32), against its Pallas kernel in interpret
    mode on the same bf16 inputs. JAX forms the scores and weighted sums in
    bf16 where the port widens to float32, so the bound is bf16's: 5e-2 max
    and 5e-3 mean on outputs of order 1."""
    q, k, v, mask = _qkv(7, 8, 256, 128, masked=True)
    mask[3] = 0.0
    mask = mask.astype(mask_dtype)
    jq, jk, jv = (jnp.asarray(t, dtype=jnp.bfloat16) for t in (q, k, v))
    want = np.asarray(jkernel(jq, jk, jv, jnp.asarray(mask), tile_b=8, block_m=128,
                              interpret=True), np.float32)
    tq, tk, tv = (torch.from_numpy(t).bfloat16() for t in (q, k, v))
    got = flash_neighbor_attention(tq, tk, tv, torch.from_numpy(mask))
    assert got.dtype == torch.float32 and float(got[3].abs().max()) == 0.0
    err = np.abs(got.numpy() - want)
    assert err.max() <= 5e-2 and err.mean() <= 5e-3


def test_flash_neighbor_plain_version_with_a_fully_masked_row_among_others():
    q, k, v, mask = _qkv(5, 6, 40, 32, masked=True)
    mask[2] = 0.0
    got = flash_neighbor_attention_reference(_t(q), _t(k), _t(v), _t(mask))
    assert float(got[2].abs().max()) == 0.0
    np.testing.assert_allclose(got.numpy(), flash_attention(
        _t(q), _t(k), _t(v), _t(mask), block_size=16).numpy(), atol=TOL, rtol=0)


@pytest.mark.parametrize("block_size", [128, 32])
@pytest.mark.parametrize("masked", [False, True])
def test_flash_attention_matches_jax(masked, block_size):
    """s=100 with block 32 pads the last block; one row fully masked."""
    q, k, v, mask = _qkv(3, 6, 100, 16, masked=masked)
    if masked:
        mask[4] = 0.0
    jm = None if mask is None else jnp.asarray(mask)
    want = np.asarray(jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jm,
                             block_size=block_size))
    got = flash_attention(_t(q), _t(k), _t(v), _t(mask), block_size=block_size)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)


@pytest.mark.parametrize("temperature", [1.0, 0.5])
@pytest.mark.parametrize("masked", [False, True])
def test_scaled_dot_attention_matches_jax(masked, temperature):
    q, k, v, mask = _qkv(4, 6, 50, 16, masked=masked)
    if masked:
        mask[1] = 0.0
    jm = None if mask is None else jnp.asarray(mask)
    want = np.asarray(jscaled(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jm,
                              temperature=temperature))
    got = scaled_dot_attention(_t(q), _t(k), _t(v), _t(mask), temperature=temperature)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)


def test_registry_returns_both_by_name():
    assert {"flash", "scaled_dot"} <= set(list_attention())
    q, k, v, mask = _qkv(6, 3, 20, 8, masked=True)
    args = (_t(q), _t(k), _t(v), _t(mask))
    np.testing.assert_array_equal(get_attention("flash").apply(None, None, *args).numpy(),
                                  flash_attention(*args).numpy())
    np.testing.assert_array_equal(get_attention("scaled_dot").apply(None, None, *args).numpy(),
                                  scaled_dot_attention(*args).numpy())
    with pytest.raises(KeyError, match="unknown attention"):
        get_attention("no_such_mechanism")
