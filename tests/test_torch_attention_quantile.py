"""The port's quantile (jnp.quantile's linear method: sort, then
interpolate) against jnp.quantile and np.quantile, and sheaf attention's
residual-sparse threshold above the 2^24 elements torch.quantile takes,
against the JAX package on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ruvector_tpu.attention import sheaf as jsheaf
from ruvector_tpu_torch.attention import sheaf as tsheaf
from ruvector_tpu_torch.convert import params_from_numpy

F32_TOL = 2e-5


def rand(*shape, seed=0, scale=1.0):
    return (scale * np.random.default_rng(seed).normal(size=shape)).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _j(a):
    return jnp.asarray(a)


def _close(got, want, atol=F32_TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), atol=atol, rtol=0)


@pytest.mark.parametrize("q", [0.0, 0.3, 0.5, 0.7, 1.0])
def test_quantile_matches_jnp(q):
    x = rand(5, 37, seed=26)
    x[1, :10] = x[1, 10]        # ties
    _close(tsheaf.quantile(_t(x), q), jnp.quantile(_j(x), q))
    for dim, keepdim in ((-1, True), (0, False), (1, False), (None, True)):
        got = tsheaf.quantile(_t(x), q, dim=dim, keepdim=keepdim)
        want = jnp.quantile(_j(x), q, axis=dim, keepdims=keepdim)
        assert got.shape == want.shape
        _close(got, want)


def test_quantile_above_two_to_the_24():
    x = np.random.default_rng(27).random((4097, 4096), dtype=np.float32)
    with pytest.raises(RuntimeError, match="too large"):
        torch.quantile(_t(x), 0.5)
    for q in (0.5, 0.9):
        # np.quantile places q(n - 1) exactly, JAX and the port in float32:
        # order statistics ~6e-8 apart
        np.testing.assert_allclose(float(tsheaf.quantile(_t(x), q)), np.quantile(x, q),
                                   atol=1e-6, rtol=0)


def test_sheaf_threshold_above_two_to_the_24():
    """The residual-sparse quantile over S^2 > 2^24 energies, which
    torch.quantile refuses."""
    s = 4100
    jcfg = jsheaf.SheafAttentionConfig(dim=4, restriction_dim=4, beta=0.5,
                                       residual_sparse_threshold=0.5)
    cfg = tsheaf.SheafAttentionConfig(dim=4, restriction_dim=4, beta=0.5,
                                      residual_sparse_threshold=0.5)
    jparams = jsheaf.sheaf_init(jax.random.key(9), jcfg)
    x = rand(s, 4, seed=25)
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    out, energy = tsheaf.sheaf_attention(params, cfg, _t(x))
    jout, jenergy = jsheaf.sheaf_attention(jparams, jcfg, _j(x))
    _close(out, jout)
    np.testing.assert_allclose(energy.numpy(), np.asarray(jenergy), rtol=1e-4)
