"""The gate under sustained drift with a hard staleness bound
(benchmarks/gate_staleness.py:51-131), port against the JAX package on
the CPU, at a small size: 16 halo-free partitions of 64 (clusters of 32,
k = 8, dim 32), 2 layers, the two bounded rows (max_gate_age 8 at budget
nB/16, 4 at nB/8, max_resolve_frac = budget / nB) over 4 drift steps of
features += 0.05 N(0, 1), the noise made with numpy and fed to both
packages. At each step: the budgeted step, a fresh gate_state_init and a
step from the fresh state, as the JAX protocol runs them (its side under
jax.jit, as the protocol's). The routes are the kernel routes
("always"): the port's kernels' plain versions here, JAX's Pallas
kernels in interpret mode. Masks, ages and re-solve counts must be equal,
signatures within 2e-6 relative and outputs within 2e-5
(tests/test_torch_gated_transformer.py's limits). The infeasible row
(age 4 at budget nB // 64) must warn with the same message in both.
"""

import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ruvector_tpu.graph_transformer.gated as jg
from ruvector_tpu.graph import build_block_dense as jbuild
from ruvector_tpu_torch.convert import params_from_numpy
from ruvector_tpu_torch.graph import build_block_dense
from ruvector_tpu_torch.graph_transformer import (
    GatedGraphTransformerConfig,
    check_gate_age_feasibility,
    gate_state_init,
    gated_graph_transformer_init,
    gated_graph_transformer_step,
)

SIG_RTOL, OUT_TOL = 2e-6, 2e-5
NB, BLOCK, CLUSTER, K, DIM, STEPS, SIGMA = 16, 64, 32, 8, 32, 4, 0.05


def _cluster_graph(seed=0):
    """chip_smoke.cluster_graph's shape in numpy: contiguous clusters
    around N(0, 1) centres (std 0.25), the exact within-cluster kNN."""
    rng = np.random.default_rng(seed)
    n, nc = NB * BLOCK, NB * BLOCK // CLUSTER
    pts = (rng.normal(size=(nc, 1, DIM)) + 0.25 * rng.normal(size=(nc, CLUSTER, DIM))
           ).astype(np.float32)
    d2 = np.sum((pts[:, :, None] - pts[:, None, :]) ** 2, -1) + 1e30 * np.eye(CLUSTER)
    ni = np.argsort(d2, axis=-1, kind="stable")[..., :K]
    dist = np.sqrt(np.take_along_axis(d2, ni, -1))
    idx = (ni + np.arange(nc)[:, None, None] * CLUSTER).reshape(n, K).astype(np.int32)
    return pts.reshape(n, DIM), idx, (1.0 / (1.0 + dist)).reshape(n, K).astype(np.float32)


@pytest.fixture(scope="module")
def setup():
    feats, idx, ew = _cluster_graph()
    mask = np.ones_like(ew)
    jb = jbuild(idx, mask, ew, block=BLOCK, table_pad=BLOCK)
    tb = build_block_dense(idx, mask, ew, block=BLOCK, table_pad=BLOCK, device="cpu")
    assert tb.n_blocks == NB and tb.table == BLOCK
    noise = np.random.default_rng(7).normal(size=(STEPS, NB * BLOCK, DIM)).astype(np.float32)
    return jb, tb, feats, SIGMA * noise


def _words(kp):
    return kp.numpy().view(np.uint32)


def _same_state(tst, jst):
    np.testing.assert_array_equal(_words(tst["keep"]), np.asarray(jst["keep"]))
    np.testing.assert_array_equal(tst["age"].numpy(), np.asarray(jst["age"]))
    np.testing.assert_allclose(tst["sig"].numpy(), np.asarray(jst["sig"]), rtol=SIG_RTOL,
                               atol=1e-7)


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=OUT_TOL, rtol=OUT_TOL)


@pytest.mark.parametrize("age_bound, budget", [(8, NB // 16), (4, NB // 8)])
def test_bounded_row_matches_jax(setup, age_bound, budget):
    jb, tb, feats, noise = setup
    kw = dict(dim=DIM, num_layers=2, max_gate_age=age_bound, max_resolve_frac=budget / NB,
              fused_gate_attn="always")
    jc, tc = jg.GatedGraphTransformerConfig(**kw), GatedGraphTransformerConfig(**kw)
    jp = jg.gated_graph_transformer_init(jax.random.key(0), jc)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    init_fn = jax.jit(lambda p, f: jg.gate_state_init(p, jc, f, jb))
    step_fn = jax.jit(lambda p, f, s: jg.gated_graph_transformer_step(
        p, jc, f, jb, s, max_resolve=budget))
    jf, tf = jb.pad_features(jnp.asarray(feats)), tb.pad_features(torch.from_numpy(feats))
    jst, tst = init_fn(jp, jf), gate_state_init(tp, tc, tf, tb)
    _same_state(tst, jst)
    counts, max_ages = [], []
    for t in range(STEPS):
        jf, tf = jf + jnp.asarray(noise[t]), tf + torch.from_numpy(noise[t])
        jout, jst, jn = step_fn(jp, jf, jst)
        tout, tst, tn = gated_graph_transformer_step(tp, tc, tf, tb, tst, max_resolve=budget)
        assert tn == int(jn)
        _same_state(tst, jst)
        _close(tout, jout)
        # the zero-staleness oracle: a fresh init and a step from it
        jfresh, tfresh = init_fn(jp, jf), gate_state_init(tp, tc, tf, tb)
        _same_state(tfresh, jfresh)
        jout_f, _, jn_f = step_fn(jp, jf, jfresh)
        tout_f, _, tn_f = gated_graph_transformer_step(tp, tc, tf, tb, tfresh,
                                                       max_resolve=budget)
        assert tn_f == int(jn_f)
        _close(tout_f, jout_f)
        counts.append(tn)
        max_ages.append(int(tst["age"].max()))
    assert max(max_ages) <= age_bound, max_ages
    # the escalation ran: some step re-solved more than one budget a layer
    assert max(counts) > 2 * budget, counts


def test_infeasible_row_warns_as_jax():
    bad_budget = max(1, NB // 64)
    kw = dict(dim=DIM, num_layers=2, max_gate_age=4)
    messages = []
    for check, cfg in ((check_gate_age_feasibility, GatedGraphTransformerConfig(**kw)),
                       (jg.check_gate_age_feasibility, jg.GatedGraphTransformerConfig(**kw))):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            assert check(cfg, NB, bad_budget) is False
        assert len(caught) == 1 and "INFEASIBLE" in str(caught[0].message)
        messages.append(str(caught[0].message))
    assert messages[0] == messages[1]
    # the guard fires from the port's init on such a config too
    cfg = dataclasses.replace(GatedGraphTransformerConfig(**kw),
                              max_resolve_frac=bad_budget / NB)
    feats, idx, ew = _cluster_graph()
    tb = build_block_dense(idx, np.ones_like(ew), ew, block=BLOCK, table_pad=BLOCK,
                           device="cpu")
    params = gated_graph_transformer_init(0, cfg, device="cpu")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        gate_state_init(params, cfg, tb.pad_features(torch.from_numpy(feats)), tb)
    assert any("INFEASIBLE" in str(w.message) for w in caught)
