"""Parity of the port's gated graph transformer (config 5) against the JAX
package, on the CPU: gate_state_init and gated_graph_transformer_step
(steady and drifted steps) on both routes ("always": the kernels' plain
versions here, JAX's Pallas kernels in interpret mode; "never": the
plain sublayer composition), the stateless apply, and the budget,
age and escalation cases of test_gated_graph_transformer.py:196-252 and
:395-538, each run on both packages step by step.

Tolerances are the JAX tests' own: masks, ages and resolve counts equal;
signatures within 2e-6 relative and outputs within 2e-5 in f32.
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
    gated_graph_transformer_apply,
    gated_graph_transformer_apply_with_masks,
    gated_graph_transformer_init,
    gated_graph_transformer_step,
)
from ruvector_tpu_torch.ops.kernels import launch_counts, reset_launch_counts

SIG_RTOL, OUT_TOL = 2e-6, 2e-5


class Side:
    """One model on both packages: params, config, features, graph."""

    def __init__(self, idx, mask, ew, feats, *, block, table_pad=128, **cfg):
        self.jb = jbuild(idx, mask, ew, block=block, table_pad=table_pad)
        self.tb = build_block_dense(idx, mask, ew, block=block, table_pad=table_pad,
                                    device="cpu")
        self.jc = jg.GatedGraphTransformerConfig(**cfg)
        self.tc = GatedGraphTransformerConfig(**cfg)
        self.jp = jg.gated_graph_transformer_init(jax.random.key(0), self.jc)
        self.tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, self.jp), "cpu")
        self.jf = self.jb.pad_features(jnp.asarray(feats))
        self.tf = self.tb.pad_features(torch.from_numpy(feats))

    def replace(self, **kw):
        self.jc = dataclasses.replace(self.jc, **kw)
        self.tc = dataclasses.replace(self.tc, **kw)
        return self

    def features(self, feats):
        """(JAX, port) padded features for new node features."""
        return self.jb.pad_features(jnp.asarray(feats)), self.tb.pad_features(
            torch.from_numpy(feats))


def _halo_free(n=512, d=32, block=128, seed=13, **cfg):
    """test_gated_graph_transformer.py:724 _halo_free_setup."""
    rng = np.random.default_rng(seed)
    base = (np.arange(n)[:, None] // block) * block
    idx = (base + rng.integers(0, block, (n, 8))).astype(np.int32)
    ew = rng.uniform(0.1, 1.0, (n, 8)).astype(np.float32)
    feats = rng.normal(size=(n, d)).astype(np.float32)
    kw = dict(dim=d, num_heads=4, num_layers=2, fused_gate_attn="always",
              hysteresis_band=0.05)
    kw.update(cfg)
    side = Side(idx, np.ones((n, 8), np.float32), ew, feats, block=block, **kw)
    assert side.tb.table == side.tb.block
    return side, rng


def _random(n=96, m=8, seed=0, d=32, block=32, **cfg):
    """test_gated_graph_transformer.py:166 _state_setup: a random graph
    with halos, blocks of 32, the default ("auto") route."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, n, (n, m)).astype(np.int32)
    ew = rng.uniform(0.1, 1.0, (n, m)).astype(np.float32)
    feats = np.random.default_rng(seed + 1).normal(size=(n, d)).astype(np.float32)
    kw = dict(dim=d, num_heads=4, num_layers=2, hysteresis_band=0.05)
    kw.update(cfg)
    return Side(idx, np.ones((n, m), np.float32), ew, feats, block=block, table_pad=8, **kw)


def _words(kp):
    a = kp.numpy() if isinstance(kp, torch.Tensor) else np.asarray(kp)
    return a.view(np.uint32)


def _same_state(tst, jst, sig_rtol=SIG_RTOL):
    np.testing.assert_array_equal(_words(tst["keep"]), np.asarray(jst["keep"]))
    np.testing.assert_array_equal(tst["age"].numpy(), np.asarray(jst["age"]))
    np.testing.assert_allclose(tst["sig"].numpy(), np.asarray(jst["sig"]), rtol=sig_rtol,
                               atol=1e-7)


def _close(got, want, tol=OUT_TOL):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want).astype(np.float32),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("route", ["always", "never"])
def test_init_steady_and_drifted_step_match_jax(route):
    side, rng = _halo_free(fused_gate_attn=route)
    reset_launch_counts()
    tst = gate_state_init(side.tp, side.tc, side.tf, side.tb)
    jst = jg.gate_state_init(side.jp, side.jc, side.jf, side.jb)
    _same_state(tst, jst)
    # steady: the same input reuses every gate
    tout, tst1, tn = gated_graph_transformer_step(side.tp, side.tc, side.tf, side.tb, tst)
    jout, jst1, jn = jg.gated_graph_transformer_step(side.jp, side.jc, side.jf, side.jb, jst)
    assert tn == int(jn) == 0
    _same_state(tst1, jst1)
    _close(tout, jout)
    # drifted: band 0, so every drifted partition re-solves (up to the budget)
    drift = rng.normal(size=(512, 32)).astype(np.float32)
    jf2, tf2 = side.features(np.asarray(side.jb.unpad(side.jf)) + 0.3 * drift)
    side.replace(hysteresis_band=0.0)
    tout, tst2, tn = gated_graph_transformer_step(side.tp, side.tc, tf2, side.tb, tst)
    jout, jst2, jn = jg.gated_graph_transformer_step(side.jp, side.jc, jf2, side.jb, jst)
    assert tn == int(jn) > 0
    _same_state(tst2, jst2)
    _close(tout, jout)
    assert all(v == 0 for v in launch_counts().values())   # CPU: plain versions only


def test_init_matches_stateless_apply():
    """test_gated_graph_transformer.py:182: init-solved masks reproduce the
    stateless pooled-gate forward (port and JAX)."""
    side = _random(n=90)         # 3 blocks of 32, 6 padding rows
    tst = gate_state_init(side.tp, side.tc, side.tf, side.tb)
    out = gated_graph_transformer_apply_with_masks(side.tp, side.tc, side.tf, side.tb,
                                                   tst["keep"])
    ref = gated_graph_transformer_apply(side.tp, side.tc, side.tf, side.tb)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=2e-5, atol=2e-5)
    _close(ref, jg.gated_graph_transformer_apply(side.jp, side.jc, side.jf, side.jb))
    tref, tstats = gated_graph_transformer_apply(side.tp, side.tc, side.tf, side.tb,
                                                 with_stats=True)
    _, jstats = jg.gated_graph_transformer_apply(side.jp, side.jc, side.jf, side.jb,
                                                 with_stats=True)
    for (ta, tcost), (ja, jcost) in zip(tstats, jstats):
        np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
        np.testing.assert_allclose(tcost.numpy(), np.asarray(jcost), atol=1e-5)
    pad = side.tb.node_pad.reshape(-1)
    assert float(tref[pad == 0].abs().max()) == 0.0


def _run_steps(side, inputs, max_resolve, init_age=True):
    """Drive both packages through the same steps; every step must agree
    on the resolve count, masks, ages and signatures. init_age=False
    starts from a state initialised without the age bound (all ages 0).
    Returns the port's (per-step resolve counts, per-step max age, initial
    and final state)."""
    age = {} if init_age else {"max_gate_age": 0}
    tst = tst0 = gate_state_init(side.tp, dataclasses.replace(side.tc, **age), side.tf,
                                 side.tb)
    jst = jg.gate_state_init(side.jp, dataclasses.replace(side.jc, **age), side.jf, side.jb)
    _same_state(tst, jst)
    counts, max_ages = [], []
    for jf, tf in inputs:
        tout, tst, tn = gated_graph_transformer_step(side.tp, side.tc, tf, side.tb, tst,
                                                     max_resolve=max_resolve)
        jout, jst, jn = jg.gated_graph_transformer_step(side.jp, side.jc, jf, side.jb, jst,
                                                        max_resolve=max_resolve)
        assert tn == int(jn)
        _same_state(tst, jst)
        _close(tout, jout)
        counts.append(tn)
        max_ages.append(int(tst["age"].max()))
    return counts, max_ages, tst0, tst


def _drifted(side, scale, seed, n):
    rng = np.random.default_rng(seed)
    base = np.asarray(side.jb.unpad(side.jf))
    return side.features(base + scale * rng.normal(size=base.shape).astype(np.float32))


def _case_same_input_reuses_all_gates():
    side = _random()
    counts, _, _, _ = _run_steps(side, [(side.jf, side.tf)], None)
    assert counts == [0]


def _case_full_budget_matches_fresh_solve():
    side = _random().replace(hysteresis_band=0.0)
    jf2, tf2 = _drifted(side, 0.25, 9, 96)
    counts, _, _, _ = _run_steps(side, [(jf2, tf2)], side.tb.n_blocks)
    assert counts[0] > 0
    tout, _, _ = gated_graph_transformer_step(
        side.tp, side.tc, tf2, side.tb, gate_state_init(side.tp, side.tc, side.tf, side.tb),
        max_resolve=side.tb.n_blocks)
    ref = gated_graph_transformer_apply(side.tp, side.tc, tf2, side.tb)
    np.testing.assert_allclose(tout.numpy(), ref.numpy(), rtol=2e-5, atol=2e-5)


def _case_respects_resolve_budget():
    side = _random()
    jf2, tf2 = _drifted(side, 0.5, 3, 96)
    counts, _, _, _ = _run_steps(side, [(jf2, tf2)], 1)
    assert counts[0] <= 1


def _case_age_tracks_deferred_resolves():
    side = _random().replace(hysteresis_band=0.0)
    jf2, tf2 = _drifted(side, 0.5, 3, 96)
    steps = 2 * side.tb.n_blocks + 2
    tst = gate_state_init(side.tp, side.tc, side.tf, side.tb)
    solved = np.zeros((2, side.tb.n_blocks), bool)
    jst = jg.gate_state_init(side.jp, side.jc, side.jf, side.jb)
    for _ in range(steps):
        _, tst, tn = gated_graph_transformer_step(side.tp, side.tc, tf2, side.tb, tst,
                                                  max_resolve=1)
        _, jst, jn = jg.gated_graph_transformer_step(side.jp, side.jc, jf2, side.jb, jst,
                                                     max_resolve=1)
        assert tn == int(jn) and tn <= 2
        _same_state(tst, jst)
        solved |= tst["age"].numpy() == 0
    assert solved.all()


def _case_max_gate_age_forces_refresh():
    side = _random().replace(max_gate_age=3)
    counts, max_ages, tst0, tst = _run_steps(side, [(side.jf, side.tf)] * 4,
                                             side.tb.n_blocks, init_age=False)
    assert max(max_ages) <= 3
    assert counts[0] == 0 and counts[1] == 0
    assert counts[2] == 2 * side.tb.n_blocks
    assert torch.equal(tst["keep"], tst0["keep"])


def _case_escalation_under_saturating_drift():
    side = _random(n=256, seed=5, num_layers=1).replace(hysteresis_band=0.0, max_gate_age=4)
    assert side.tb.n_blocks == 8
    rng = np.random.default_rng(9)
    base = np.asarray(side.jb.unpad(side.jf))
    inputs = [side.features(base + 0.3 * rng.normal(size=base.shape).astype(np.float32))
              for _ in range(10)]
    counts, max_ages, _, _ = _run_steps(side, inputs, 1)
    assert max(counts) <= 2
    assert max(max_ages[6:]) <= 4, max_ages


CASES = {
    "same_input_reuses_all_gates": _case_same_input_reuses_all_gates,
    "full_budget_matches_fresh_solve": _case_full_budget_matches_fresh_solve,
    "respects_resolve_budget": _case_respects_resolve_budget,
    "age_tracks_deferred_resolves": _case_age_tracks_deferred_resolves,
    "max_gate_age_forces_refresh": _case_max_gate_age_forces_refresh,
    "escalation_under_saturating_drift": _case_escalation_under_saturating_drift,
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_step_budget_and_age_cases(case):
    CASES[case]()


def test_gate_age_feasibility_guard():
    """test_gated_graph_transformer.py:455."""
    base = GatedGraphTransformerConfig(dim=32, num_heads=4, num_layers=1)
    bad = dataclasses.replace(base, max_gate_age=2)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        assert check_gate_age_feasibility(bad, 64) is False
    assert any("INFEASIBLE" in str(w.message) for w in caught)
    good = dataclasses.replace(base, max_gate_age=8)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        assert check_gate_age_feasibility(good, 64) is True
        assert check_gate_age_feasibility(base, 64) is False
    assert not caught
    side = _random(n=128, num_layers=1, max_resolve_frac=1 / 4, max_gate_age=1)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        gate_state_init(side.tp, side.tc, side.tf, side.tb)
    assert any("INFEASIBLE" in str(w.message) for w in caught)


def test_emitted_signature_route_matches_standalone(monkeypatch):
    """test_gated_graph_transformer.py:789: the step with the next layer's
    signature from the fused layer (K4b) equals the route through the
    standalone signature (K6c), on a steady and a drifted step."""
    import ruvector_tpu_torch.graph_transformer.gated as tg

    side, rng = _halo_free(compute_dtype="bfloat16")
    st = gate_state_init(side.tp, side.tc, side.tf, side.tb)
    _, tf2 = _drifted(side, 0.3, 4, 512)
    for inp, band in ((side.tf, 0.05), (tf2, 0.0)):
        cfg = dataclasses.replace(side.tc, hysteresis_band=band)
        reset_launch_counts()
        out_f, st_f, n_f = gated_graph_transformer_step(side.tp, cfg, inp, side.tb, st)
        monkeypatch.setattr(tg, "_FUSE_NEXT_SIG", False)
        out_s, st_s, n_s = gated_graph_transformer_step(side.tp, cfg, inp, side.tb, st)
        monkeypatch.setattr(tg, "_FUSE_NEXT_SIG", True)
        assert n_f == n_s and (band > 0 or n_f > 0)
        assert torch.equal(out_f, out_s)
        for k in ("keep", "sig", "age"):
            assert torch.equal(st_f[k], st_s[k])


def test_pooled_logits_and_layer_body_match_jax():
    """The pooled-logit identity the signatures and gates rest on,
    (h Wq)(h Wk)^T / (sqrt(dh) H) = h A_sig h^T (gated.py:281-311,355), and
    the halo-free sublayer composition (gated.py:541), the fused layer's
    reference semantics: against JAX, and against K4a's plain version."""
    import ruvector_tpu_torch.graph_transformer.gated as tg
    from ruvector_tpu_torch.ops.kernels.gated_block_layer import (
        fold_gated_layer_params,
        gated_block_layer,
    )

    side, rng = _halo_free(fused_gate_attn="never")
    nb, b = side.tb.n_blocks, side.tb.block
    tx, jx = side.tf.reshape(nb, b, -1), side.jf.reshape(nb, b, -1)
    tp, jp = side.tp[0], side.jp[0]
    th = tg._ln(tp["ln1"], tx)
    jh = jg.layer_norm_apply(jp["ln1"], jx)
    pooled = tg._pooled_from_qk(*tg._qk_proj(th, tp["wq"], tp["wk"], side.tc),
                                side.tb.node_pad, side.tc)
    _close(pooled, jg._pooled_logits(jh, side.jb.node_pad, jp["wq"], jp["wk"], side.jc),
           tol=1e-5)
    _close(tg._pooled_from_x(th, side.tb.node_pad, tg._fold_sig_params(tp, side.tc)),
           pooled, tol=1e-5)
    keep = rng.uniform(size=(nb, b, b)) < 0.4
    jkp = jg.pack_keep(jnp.asarray(keep))
    tkp = torch.from_numpy(np.array(jkp).view(np.int32))
    body = tg._layer_body_halo_free(side.tc, tp, tx, tkp, side.tb.node_pad, side.tb.wdense)
    _close(body, jg._layer_body_halo_free(side.jc, jp, jx, jkp, side.jb.node_pad,
                                          side.jb.wdense))
    fused = gated_block_layer(tx, tkp, side.tb.node_pad, side.tb.wdense,
                              fold_gated_layer_params(tp, side.tc), compute_bf16=False)
    _close(fused, body.numpy())


def test_init_uses_torch_generator():
    cfg = GatedGraphTransformerConfig(dim=16, num_heads=2, num_layers=2)
    a = gated_graph_transformer_init(3, cfg, device="cpu")
    b = gated_graph_transformer_init(3, cfg, device="cpu")
    assert len(a) == 2 and set(a[0]) == {"wq", "wk", "wv", "wo", "w_gnn", "ln1", "ln_g",
                                         "ln2", "ffn_in", "ffn_out"}
    assert a[1]["ffn_in"]["kernel"].shape == (16, 64)
    assert all(torch.equal(a[i]["wq"], b[i]["wq"]) for i in range(2))
    assert not torch.equal(a[0]["wq"], a[1]["wq"])


def test_params_from_jax_keep_layout_and_bf16_leaves():
    """A JAX config-5 parameter tree crosses unchanged: keys, [in, out]
    layouts, and bf16 leaves stay bf16."""
    cfg = jg.GatedGraphTransformerConfig(dim=32, num_heads=4, num_layers=2)
    jp = jg.gated_graph_transformer_init(jax.random.key(1), cfg)
    jp16 = jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16), jp)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp16), "cpu")
    assert [set(layer) for layer in tp] == [set(layer) for layer in jp]
    assert tp[0]["ffn_in"]["kernel"].shape == (32, 128)
    assert tp[0]["ffn_in"]["kernel"].dtype == torch.bfloat16
    np.testing.assert_array_equal(tp[1]["wq"].float().numpy(),
                                  np.asarray(jp16[1]["wq"]).astype(np.float32))
