"""The chunked routes of the port's gated graph transformer (config 5 above
_CHUNK_NB partitions) on the CPU, against the JAX package's chunked routes
and the port's own straight routes: the FFN, the whole layer (the plain
composition and the fused layer, K4a a chunk) with its gradients, the
whole-model chunked loss with its gradients, the step's layer with the
next signature (K4b a chunk), and gate_state_init's plain gate in runs of
gate_chunk. Both packages' `_CHUNK_NB` is monkeypatched small, as
tests/test_gated_graph_transformer.py:539-870 does, so nb = 5 and nb = 6
end on a short chunk. JAX's Pallas kernels run in interpret mode
("always"), the port's kernels as their plain versions.

Tolerances are the JAX tests' own, chunked against straight: FFN 1e-6,
the plain layer 2e-5, the fused layer 3e-5; losses 2e-5 (one layer) and
3e-5 (the model) relative, gradients 6e-5 of each leaf's largest
magnitude; the step's output and state bit for bit. The port against JAX
on the same route: outputs 2e-5 and signatures 2e-6 relative with masks,
ages and counts equal (tests/test_torch_gated_transformer.py), and the
chunked-against-straight limits for losses and gradients.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ruvector_tpu.graph_transformer.gated as jg
import ruvector_tpu_torch.graph_transformer.gated as tg
from ruvector_tpu.graph import build_block_dense as jbuild
from ruvector_tpu_torch.convert import params_from_numpy
from ruvector_tpu_torch.graph import build_block_dense

OUT_TOL, SIG_RTOL = 2e-5, 2e-6


def _chunk(monkeypatch, nb):
    """Both packages' chunk bound set to nb."""
    monkeypatch.setattr(jg, "_CHUNK_NB", nb)
    monkeypatch.setattr(tg, "_CHUNK_NB", nb)


def _params(cfg_kw, key=0):
    jc = jg.GatedGraphTransformerConfig(**cfg_kw)
    jp = jg.gated_graph_transformer_init(jax.random.key(key), jc)
    return jc, tg.GatedGraphTransformerConfig(**cfg_kw), jp, params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jp), "cpu")


def _block_local(n, block, seed):
    """test_gated_graph_transformer.py:605: 8 neighbours within each block
    (a halo-free layout at block >= 128), both packages' graphs."""
    rng = np.random.default_rng(seed)
    base = (np.arange(n)[:, None] // block) * block
    idx = (base + rng.integers(0, block, (n, 8))).astype(np.int32)
    mask = np.ones((n, 8), np.float32)
    ew = rng.uniform(0.1, 1.0, (n, 8)).astype(np.float32)
    jb = jbuild(idx, mask, ew, block=block)
    tb = build_block_dense(idx, mask, ew, block=block, device="cpu")
    assert tb.table == tb.block and jb.table == jb.block
    return rng, jb, tb


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=0)


def _grads_close(got, want, tol):
    """Every leaf within tol of its own largest magnitude (the JAX tests'
    assert_grads_close)."""
    assert len(got) == len(want)
    for a, b in zip(got, want):
        b = _np(b)
        np.testing.assert_allclose(_np(a), b, atol=tol * (float(np.abs(b).max()) + 1e-9))


def _port_value_and_grad(loss_fn, params, *rest):
    """loss_fn(params, *rest) and its gradients for every leaf of params
    (a layer dict or a list of them, in the JAX tree's leaf order) and for
    each tensor of rest that requires grad."""
    layers = params if isinstance(params, list) else [params]
    leaves = [t.clone().requires_grad_(True) for p in layers for t in tg._flatten(p)[1]]
    it = iter(leaves)
    rebuilt = [tg._unflatten(tg._flatten(p)[0], [next(it) for _ in tg._flatten(p)[1]])
               for p in layers]
    wrt = leaves + [t for t in rest if isinstance(t, torch.Tensor) and t.requires_grad]
    loss = loss_fn(rebuilt if isinstance(params, list) else rebuilt[0], *rest)
    return float(loss.detach()), torch.autograd.grad(loss, wrt)


def test_chunked_ffn_matches_straight_path(monkeypatch):
    """test_gated_graph_transformer.py:539: nb = 6 in chunks of 4 (a short
    last chunk of 2)."""
    nb, b, d = 6, 16, 32
    rng = np.random.default_rng(5)
    h2 = rng.normal(size=(nb, b, d)).astype(np.float32)
    pad = (rng.uniform(size=(nb, b)) > 0.1).astype(np.float32)
    _, _, jp, tp = _params(dict(dim=d), key=3)
    th2, tpad = torch.from_numpy(h2), torch.from_numpy(pad)
    straight = tg._ffn_apply(tp[0], th2, tpad, th2.dtype)
    _chunk(monkeypatch, 4)
    chunked = tg._ffn_apply(tp[0], th2, tpad, th2.dtype)
    _close(chunked, straight, 1e-6)
    _close(chunked, jg._ffn_apply(jp[0], jnp.asarray(h2), jnp.asarray(pad), jnp.float32),
           OUT_TOL)


def _layer_setup(n, seed):
    """One layer of dim 32 on the kernel route ("always"), every pair kept."""
    rng, jb, tb = _block_local(n, 128, seed)
    jc, tc, jp, tp = _params(dict(dim=32, num_heads=4, num_layers=1, fused_gate_attn="always"))
    x = rng.normal(size=(tb.n_blocks, 128, 32)).astype(np.float32)
    jkp = jg.pack_keep(jnp.ones((tb.n_blocks, 128, 128), bool))
    tkp = torch.from_numpy(np.array(jkp).view(np.int32))
    return dict(jb=jb, tb=tb, jc=jc, tc=tc, jp=jp[0], tp=tp[0], x=x, jkp=jkp, tkp=tkp)


def _no_fused_layer(monkeypatch):
    """Both packages' fused-layer kernel switched off: the plain routes."""
    monkeypatch.setattr(jg, "_use_fused_layer", lambda *a: False)
    monkeypatch.setattr(tg, "_use_fused_layer", lambda *a: False)


def test_chunked_whole_layer_matches_straight(monkeypatch):
    """test_gated_graph_transformer.py:597: the plain layer composition
    chunked (nb = 4 in chunks of 2) against the straight one, the fused
    layer against it, and the fused layer chunked (K4a a chunk) against
    the fused layer straight; each chunked route against JAX's."""
    s = _layer_setup(512, 7)
    tx = torch.from_numpy(s["x"])

    def port():
        return tg._layer_with_keep(s["tp"], s["tc"], tx, s["tb"], s["tkp"], fused=True)

    def jax_():
        return jg._layer_with_keep(s["jp"], s["jc"], jnp.asarray(s["x"]), s["jb"], s["jkp"],
                                   fused=True)

    fused_straight = port()
    fused_layer = jg._use_fused_layer, tg._use_fused_layer
    _no_fused_layer(monkeypatch)
    straight = port()
    _chunk(monkeypatch, 2)
    chunked = port()
    _close(chunked, straight, 2e-5)
    _close(chunked, jax_(), OUT_TOL)
    _close(fused_straight, straight, 3e-5)
    monkeypatch.setattr(jg, "_use_fused_layer", fused_layer[0])
    monkeypatch.setattr(tg, "_use_fused_layer", fused_layer[1])
    fused_chunked = port()
    _close(fused_chunked, fused_straight, 3e-5)
    _close(fused_chunked, jax_(), OUT_TOL)


def test_chunked_whole_layer_grad_parity(monkeypatch):
    """test_gated_graph_transformer.py:636: value and gradients (params and
    x) through the chunked layer at nb = 5 in chunks of 2: the plain
    composition chunked against straight (loss 2e-5, gradients 6e-5), the
    fused layer (its Function's recompute backward) against the plain
    straight route (3e-5, 6e-5), the fused layer chunked against straight,
    and each chunked route against JAX's."""
    s = _layer_setup(640, 9)
    assert s["tb"].n_blocks == 5

    def port():
        x = torch.from_numpy(s["x"]).requires_grad_(True)
        return _port_value_and_grad(
            lambda p, x_: (lambda o: torch.sum(o * o) / o.numel())(
                tg._layer_with_keep(p, s["tc"], x_, s["tb"], s["tkp"], fused=True)),
            s["tp"], x)

    def jax_():
        def loss(p, x):
            out = jg._layer_with_keep(p, s["jc"], x, s["jb"], s["jkp"], fused=True)
            return jnp.sum(out * out) / out.size
        v, (gp, gx) = jax.value_and_grad(loss, argnums=(0, 1))(s["jp"], jnp.asarray(s["x"]))
        return float(v), jax.tree_util.tree_leaves(gp) + [gx]

    v_k, g_k = port()
    _chunk(monkeypatch, 2)
    v_kc, g_kc = port()
    np.testing.assert_allclose(v_kc, v_k, rtol=3e-5)
    _grads_close(g_kc, g_k, 6e-5)
    v_j, g_j = jax_()     # JAX's fused layer at nb > _CHUNK_NB: K4a a chunk
    np.testing.assert_allclose(v_kc, v_j, rtol=3e-5)
    _grads_close(g_kc, g_j, 6e-5)
    _no_fused_layer(monkeypatch)
    v_c, g_c = port()
    _chunk(monkeypatch, 4096)
    v_s, g_s = port()
    np.testing.assert_allclose(v_c, v_s, rtol=2e-5)
    _grads_close(g_c, g_s, 6e-5)
    np.testing.assert_allclose(v_k, v_s, rtol=3e-5)
    _grads_close(g_k, g_s, 6e-5)
    _chunk(monkeypatch, 2)
    v_j, g_j = jax_()
    np.testing.assert_allclose(v_c, v_j, rtol=2e-5)
    _grads_close(g_c, g_j, 6e-5)


def _model_setup(n=640, seed=11, **cfg):
    """test_gated_graph_transformer.py:685: two layers on the kernel route,
    JAX's gate state (bit for bit the port's, test_torch_gated_transformer),
    random targets."""
    rng, jb, tb = _block_local(n, 128, seed)
    kw = dict(dim=32, num_heads=4, num_layers=2, fused_gate_attn="always")
    kw.update(cfg)
    jc, tc, jp, tp = _params(kw)
    feats = rng.normal(size=(n, 32)).astype(np.float32)
    jf, tf = jb.pad_features(jnp.asarray(feats)), tb.pad_features(torch.from_numpy(feats))
    jst = jg.gate_state_init(jp, jc, jf, jb)
    tgt = rng.normal(size=tuple(tf.shape)).astype(np.float32)
    return dict(jb=jb, tb=tb, jc=jc, tc=tc, jp=jp, tp=tp, jf=jf, tf=tf, jkeep=jst["keep"],
                tkeep=torch.from_numpy(np.array(jst["keep"]).view(np.int32)),
                jtgt=jnp.asarray(tgt), ttgt=torch.from_numpy(tgt), rng=rng)


@pytest.mark.parametrize("remat", [False, True])
def test_chunked_whole_model_loss_parity(monkeypatch, remat):
    """test_gated_graph_transformer.py:685: the whole-model chunked loss at
    nb = 5 in chunks of 2 against the straight loss (3e-5; gradients 6e-5
    of scale) and against JAX's chunked loss. Its fused layers run K4a
    twice a chunk and layer (the forward and the chunk's recompute, which
    the remat trick must not skip) and K5a once (the Function's backward),
    whatever cfg.remat says."""
    s = _model_setup(remat=remat)
    assert s["tb"].n_blocks == 5
    calls = {"gated_block_layer": 0, "gated_block_attention": 0}
    for name in calls:
        orig = getattr(tg, name)
        monkeypatch.setattr(tg, name, lambda *a, _o=orig, _n=name, **k: (
            calls.__setitem__(_n, calls[_n] + 1), _o(*a, **k))[1])

    def port():
        for name in calls:
            calls[name] = 0
        return _port_value_and_grad(
            lambda p: tg.gated_graph_transformer_loss_with_masks(
                p, s["tc"], s["tf"], s["tb"], s["tkeep"], s["ttgt"]), s["tp"])

    v_s, g_s = port()
    assert calls == {"gated_block_layer": 2, "gated_block_attention": 2}
    _chunk(monkeypatch, 2)
    v_c, g_c = port()
    assert calls == {"gated_block_layer": 2 * 2 * 3, "gated_block_attention": 2 * 3}
    np.testing.assert_allclose(v_c, v_s, rtol=3e-5)
    _grads_close(g_c, g_s, 6e-5)
    v_j, g_j = jax.value_and_grad(lambda p: jg.gated_graph_transformer_loss_with_masks(
        p, s["jc"], s["jf"], s["jb"], s["jkeep"], s["jtgt"]))(s["jp"])
    np.testing.assert_allclose(v_c, float(v_j), rtol=3e-5)
    _grads_close(g_c, jax.tree_util.tree_leaves(g_j), 6e-5)


def _drifted(s, scale=0.3):
    """s's features moved by scale N(0, 1) (padding rows kept at 0), for
    both packages."""
    drift = s["rng"].normal(size=tuple(s["tf"].shape)).astype(np.float32)
    pad = s["tb"].node_pad.reshape(-1, 1).numpy()
    f = (s["tf"].numpy() + scale * drift) * pad
    return jnp.asarray(f), torch.from_numpy(f)


def _words(kp):
    return kp.numpy().view(np.uint32) if isinstance(kp, torch.Tensor) else np.asarray(kp)


@pytest.mark.parametrize("compute", ["bfloat16", "float32"])
def test_step_fused_next_sig_chunked_route(monkeypatch, compute):
    """test_gated_graph_transformer.py:840: a drifted step whose layers run
    K4b and K4a a chunk (nb = 5 in chunks of 2) equals the straight step
    bit for bit: output, keep, sig, age and the re-solve count. Against
    JAX's chunked step: masks, ages and counts equal, signatures 2e-6
    relative, outputs 2e-5 (float32 compute)."""
    # band 0: the drifted step re-solves (the emitted signature feeds refreshes)
    s = _model_setup(n=640, seed=13, compute_dtype=compute, hysteresis_band=0.0)
    tst = tg.gate_state_init(s["tp"], s["tc"], s["tf"], s["tb"])
    jf2, tf2 = _drifted(s)
    out_s, st_s, n_s = tg.gated_graph_transformer_step(s["tp"], s["tc"], tf2, s["tb"], tst)
    _chunk(monkeypatch, 2)
    out_c, st_c, n_c = tg.gated_graph_transformer_step(s["tp"], s["tc"], tf2, s["tb"], tst)
    assert n_c == n_s > 0
    assert torch.equal(out_c, out_s)
    for k in ("keep", "sig", "age"):
        assert torch.equal(st_c[k], st_s[k]), k
    if compute == "float32":
        jst = jg.gate_state_init(s["jp"], s["jc"], s["jf"], s["jb"])
        jout, jst2, jn = jg.gated_graph_transformer_step(s["jp"], s["jc"], jf2, s["jb"], jst)
        assert n_c == int(jn)
        np.testing.assert_array_equal(_words(st_c["keep"]), _words(jst2["keep"]))
        np.testing.assert_array_equal(st_c["age"].numpy(), np.asarray(jst2["age"]))
        np.testing.assert_allclose(st_c["sig"].numpy(), np.asarray(jst2["sig"]),
                                   rtol=SIG_RTOL, atol=1e-7)
        _close(out_c, jout, OUT_TOL)


def test_gate_init_plain_route_in_gate_chunk_runs(monkeypatch):
    """gate_state_init's plain route (JAX gated.py:793-803) solves the
    gates in runs of gate_chunk partitions: with 5 runs of 2 over 9
    partitions (a short last run), the masks and signatures equal the
    JAX package's and the port's in one run, and each run takes at most
    gate_chunk partitions."""
    rng = np.random.default_rng(0)
    n, m, d = 288, 8, 32            # 9 blocks of 32, a halo
    idx = rng.integers(0, n, (n, m)).astype(np.int32)
    ew = rng.uniform(0.1, 1.0, (n, m)).astype(np.float32)
    feats = rng.normal(size=(n, d)).astype(np.float32)
    mask = np.ones((n, m), np.float32)
    jb = jbuild(idx, mask, ew, block=32, table_pad=8)
    tb = build_block_dense(idx, mask, ew, block=32, table_pad=8, device="cpu")
    kw = dict(dim=d, num_heads=4, num_layers=2, gate_chunk=2, fused_gate_attn="never")
    jc, tc, jp, tp = _params(kw)
    jf, tf = jb.pad_features(jnp.asarray(feats)), tb.pad_features(torch.from_numpy(feats))
    runs = []
    orig = tg._solve_gates_plain
    monkeypatch.setattr(tg, "_solve_gates_plain",
                        lambda h, *a: (runs.append(h.shape[0]), orig(h, *a))[1])
    tst = tg.gate_state_init(tp, tc, tf, tb)
    assert runs == [2, 2, 2, 2, 1] * 2
    one = tg.gate_state_init(tp, dataclasses.replace(tc, gate_chunk=9), tf, tb)
    for k in ("keep", "sig", "age"):
        assert torch.equal(tst[k], one[k]), k
    jst = jg.gate_state_init(jp, jc, jf, jb)
    np.testing.assert_array_equal(_words(tst["keep"]), _words(jst["keep"]))
    np.testing.assert_allclose(tst["sig"].numpy(), np.asarray(jst["sig"]), rtol=SIG_RTOL,
                               atol=1e-7)


def _narrow(nb):
    """nb partitions of 32 nodes, 4 neighbours within the partition
    (halo-free with table_pad 8), dim 8, 2 heads, 2 layers, the kernel
    route: config 5's partition count at a width the CPU runs quickly."""
    rng = np.random.default_rng(nb)
    n = nb * 32
    idx = ((np.arange(n)[:, None] // 32) * 32 + rng.integers(0, 32, (n, 4))).astype(np.int32)
    ew = rng.uniform(0.1, 1.0, (n, 4)).astype(np.float32)
    tb = build_block_dense(idx, np.ones((n, 4), np.float32), ew, block=32, table_pad=8,
                           device="cpu")
    assert tb.table == tb.block and tb.n_blocks == nb
    cfg = tg.GatedGraphTransformerConfig(dim=8, num_heads=2, num_layers=2,
                                         fused_gate_attn="always")
    params = tg.gated_graph_transformer_init(0, cfg, device="cpu")
    return cfg, params, tb, tb.pad_features(torch.from_numpy(
        rng.normal(size=(n, 8)).astype(np.float32)))


@pytest.mark.parametrize("nb, chunks", [(3906, 1), (4096, 1), (4097, 2)])
def test_routes_chunk_only_above_the_bound(monkeypatch, nb, chunks):
    """The routes chunk exactly where the JAX package chunks them, nB >
    _CHUNK_NB = 4096: at config 5's 999,936 nodes (nB = 3,906) and at 4096
    every route is straight (one K4a a layer at init and in the train
    step's forward, one K4b on a step, the straight loss), at 4097 each
    runs in two chunks."""
    assert tg._CHUNK_NB == jg._CHUNK_NB == 4096
    cfg, params, tb, fpad = _narrow(nb)
    calls = {"gated_block_layer": 0, "gated_block_layer_with_sig": 0}
    for name in calls:
        orig = getattr(tg, name)
        monkeypatch.setattr(tg, name, lambda *a, _o=orig, _n=name, **k: (
            calls.__setitem__(_n, calls[_n] + 1), _o(*a, **k))[1])
    chunked_loss = []
    orig_loss = tg._loss_chunked_halo_free
    monkeypatch.setattr(tg, "_loss_chunked_halo_free",
                        lambda *a: (chunked_loss.append(1), orig_loss(*a))[1])
    with torch.no_grad():
        state = tg.gate_state_init(params, cfg, fpad, tb)
        assert calls == {"gated_block_layer": 2 * chunks, "gated_block_layer_with_sig": 0}
        tg.gated_graph_transformer_step(params, cfg, fpad, tb, state)
        assert calls == {"gated_block_layer": 3 * chunks, "gated_block_layer_with_sig": chunks}
    calls["gated_block_layer"] = 0
    loss, _ = _port_value_and_grad(lambda p: tg.gated_graph_transformer_loss_with_masks(
        p, cfg, fpad, tb, state["keep"], torch.zeros_like(fpad)), params)
    assert np.isfinite(loss)
    assert len(chunked_loss) == (chunks > 1)
    assert calls["gated_block_layer"] == (2 if chunks == 1 else 2 * 2 * chunks)
