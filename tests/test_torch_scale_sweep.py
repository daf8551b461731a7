"""The RuvectorLayer on the JAX scale sweep's layout (benchmarks/
scale_sweep_r03.py:37-44,91-100), port against the JAX package on the CPU:
clusters of 128, the exact within-cluster kNN (k = 16), uniform blocks
of 256, so every block holds whole clusters and the layout has no halo
(T == B). n = 640 ends on a ragged last block (one cluster and 128 pad
rows), as the sweep's 10,000,000 nodes do; n = 768 fills its last block.
The layer runs with float32 IO and a float32 edge table, and with
io_dtype=bfloat16 and a bf16 edge table (the sweep's 10M row).

The graph comes from each package's native gen_cluster_knn where the
native runtime builds (both must give the same arrays), else from a
numpy generator of the same shape. Tolerances are
tests/test_torch_block_dense.py's: 2e-5 in float32, 4e-2 max and 8e-3
mean in bf16 compute or IO.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ruvector_tpu import native as jnative
from ruvector_tpu.graph import build_block_dense as jbuild
from ruvector_tpu.nn.block_dense_layer import (
    ruvector_layer_apply_block_dense_fused as jfused,
)
from ruvector_tpu.nn.ruvector_layer import RuvectorLayerConfig as JCfg
from ruvector_tpu.nn.ruvector_layer import ruvector_layer_init as jinit
from ruvector_tpu_torch import native
from ruvector_tpu_torch.convert import params_from_numpy
from ruvector_tpu_torch.graph import build_block_dense
from ruvector_tpu_torch.nn.block_dense_layer import ruvector_layer_apply_block_dense_fused
from ruvector_tpu_torch.nn.ruvector_layer import RuvectorLayerConfig
from ruvector_tpu_torch.ops.kernels import launch_counts, reset_launch_counts

CLUSTER, DEGREE, BLOCK, D, HEADS = 128, 16, 256, 128, 4
F32_TOL = 2e-5
BF16_MAX, BF16_MEAN = 4e-2, 8e-3


def _numpy_clusters(n, d, k, seed=0):
    """benchmarks/scale_sweep_r02.py:69-94 in numpy: clusters of CLUSTER
    around N(0, 1) centres with std 0.25, the exact within-cluster kNN
    (self excluded), weights 1 / (1 + dist)."""
    rng = np.random.default_rng(seed)
    nc = n // CLUSTER
    pts = (rng.normal(size=(nc, 1, d)) + 0.25 * rng.normal(size=(nc, CLUSTER, d))
           ).astype(np.float32)
    sq = np.sum(pts * pts, -1)
    d2 = sq[:, :, None] + sq[:, None, :] - 2.0 * np.einsum("cid,cjd->cij", pts, pts)
    d2 = d2 + 1e30 * np.eye(CLUSTER, dtype=np.float32)
    ni = np.argsort(d2, axis=-1, kind="stable")[..., :k]
    dist = np.sqrt(np.maximum(np.take_along_axis(d2, ni, -1), 0.0))
    base = np.arange(nc, dtype=np.int64)[:, None, None] * CLUSTER
    return (pts.reshape(n, d), (ni + base).reshape(n, k).astype(np.int32),
            (1.0 / (1.0 + dist)).reshape(n, k).astype(np.float32))


def _graph(n):
    if native.available and jnative.available:
        feats, idx, ew = native.gen_cluster_knn(n, D, DEGREE, CLUSTER, seed=0)
        want = jnative.gen_cluster_knn(n, D, DEGREE, CLUSTER, seed=0)
        for got, ref in zip((feats, idx, ew), want):
            np.testing.assert_array_equal(got, ref)
        return feats, idx, ew
    return _numpy_clusters(n, D, DEGREE)


@pytest.mark.parametrize("io", ["f32", "bf16"])
@pytest.mark.parametrize("n", [640, 768])
def test_sweep_layout_and_layer_match_jax(n, io):
    feats, idx, ew = _graph(n)
    mask = np.ones((n, DEGREE), np.float32)
    bf16 = io == "bf16"
    jb = jbuild(idx, mask, ew, block=BLOCK, dtype=jnp.bfloat16 if bf16 else np.float32)
    tb = build_block_dense(idx, mask, ew, block=BLOCK,
                           dtype=torch.bfloat16 if bf16 else torch.float32, device="cpu")
    # the layout: no halo, the last block ragged where n % BLOCK != 0
    nb = -(-n // BLOCK)
    assert (tb.n_blocks, tb.block, tb.table) == (jb.n_blocks, jb.block, jb.table) == (
        nb, BLOCK, BLOCK)
    assert tb.wdense.dtype == (torch.bfloat16 if bf16 else torch.float32)
    np.testing.assert_array_equal(tb.local_ids.numpy(), np.asarray(jb.local_ids))
    np.testing.assert_array_equal(tb.wdense.float().numpy(),
                                  np.asarray(jb.wdense).astype(np.float32))
    np.testing.assert_array_equal(tb.node_pad.numpy(), np.asarray(jb.node_pad))
    np.testing.assert_array_equal(tb.degrees.numpy(), np.asarray(jb.degrees))
    assert float(tb.node_pad[-1].sum()) == n - (nb - 1) * BLOCK

    jc = JCfg(D, D, heads=HEADS, compute_dtype="bfloat16")
    jp = jinit(jax.random.key(0), jc)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    tc = RuvectorLayerConfig(D, D, heads=HEADS, compute_dtype="bfloat16")
    if bf16:
        import ml_dtypes

        jf = jb.pad_features(jnp.asarray(feats.astype(ml_dtypes.bfloat16)))
        tf = tb.pad_features(torch.from_numpy(feats).to(torch.bfloat16))
    else:
        jf, tf = jb.pad_features(jnp.asarray(feats)), tb.pad_features(torch.from_numpy(feats))
    reset_launch_counts()
    got = ruvector_layer_apply_block_dense_fused(tp, tc, tf, tb,
                                                 io_dtype=torch.bfloat16 if bf16 else None)
    want = jfused(jp, jc, jf, jb, tile=BLOCK, io_dtype=jnp.bfloat16 if bf16 else None)
    assert launch_counts()["block_dense_layer_fused"] == 0    # CPU: the plain version
    assert got.dtype == (torch.bfloat16 if bf16 else torch.float32)
    got = got.float().numpy()
    want = np.asarray(want).astype(np.float32)
    assert got.shape == want.shape == (nb * BLOCK, D) and np.all(np.isfinite(got))
    err = np.abs(got - want)
    assert err.max() < BF16_MAX and err.mean() < BF16_MEAN, (err.max(), err.mean())
    # the pad rows (LayerNorm of the message bias, no edge) on their own
    pad = tb.node_pad.reshape(-1).numpy() == 0
    assert pad.any() == (n % BLOCK != 0)
    if pad.any():
        tol = BF16_MAX if bf16 else F32_TOL
        np.testing.assert_allclose(got[pad], want[pad], atol=tol, rtol=0)
