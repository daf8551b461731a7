"""Parity of the port's config-5 training path against the JAX package, on
the CPU: the gated MHA (K5a) and its recompute backward (K5b), the
signatures from x and from q/k (K6b, K6a), the fused layer's autograd
Function, `remat`, `gated_graph_transformer_loss` and
`gated_graph_transformer_loss_with_masks` (value and every parameter
gradient), and the step on layouts off the halo-free B % 32 == 0 route.
The JAX Pallas kernels run in interpret mode ("always", as
tests/test_gated_graph_transformer.py:353-392 runs them); the port runs
the kernels' plain versions.

Tolerances:
  * K5a: f32 2e-4 max / 1e-4 mean; bf16 4e-2 max / 8e-3 mean (the JAX
    bf16 layer bound).
  * K5b against jax.vjp: atol 2e-4 * scale, rtol 2e-3 (the JAX fused-
    kernel gradient test's bound; scale = the tensor's largest magnitude).
  * K6a/K6b: f32 counts equal, sums 2e-6 relative; bf16 counts within
    0.5% of the positive pairs and sums 1e-3 relative (a logit within f32
    rounding of eps may count on the other side of JAX's f32 sums).
  * loss and gradients: "never" rtol 1e-5 on the loss and (rtol 5e-4,
    atol 5e-5) on the gradients (test_gated_graph_transformer.py:266-269);
    "always" rtol 1e-4 and (atol 2e-4 * scale, rtol 2e-3) (:388-392). In
    bf16 compute both packages round cotangents to bf16 where the forward
    rounds its operands, and an f32 cotangent summed in another order may
    round one bf16 step (2^-8) the other way; such isolated steps move a
    weight gradient by up to ~1e-3 of its scale, so bf16 gradients are
    held to (atol 2e-3 * scale, rtol 2e-3) and the loss to 1e-4.
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
from ruvector_tpu.ops.pallas.gated_block_attn import block_gate_signature as jk6a
from ruvector_tpu.ops.pallas.gated_block_attn import block_gate_signature_x as jk6b
from ruvector_tpu.ops.pallas.gated_block_attn import gated_block_attention as jk5
from ruvector_tpu_torch.convert import params_from_numpy
from ruvector_tpu_torch.graph import build_block_dense
from ruvector_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
from ruvector_tpu_torch.ops.kernels.gated_block_attn import (
    block_gate_signature,
    block_gate_signature_x,
    gated_block_attention,
    gated_block_attention_bwd_reference,
    gated_block_attention_fwd_reference,
    head_concat,
    pack_keep,
)

BF16_MAX, BF16_MEAN = 4e-2, 8e-3


def _mha_inputs(seed=0, nb=3, b=40, d=32, h=4):
    """A ragged block (B=40: two gate words), a short tail block, a row
    with nothing kept, and folded weights at an initialised model's scale."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(nb, b, d)).astype(np.float32)
    pad = np.ones((nb, b), np.float32)
    pad[-1, 29:] = 0.0
    keep = rng.uniform(size=(nb, b, b)) < 0.35
    keep[0, 5] = False
    A = (rng.normal(size=(h, d, d)) / d).astype(np.float32)
    Wvo = (rng.normal(size=(h, d, d)) / np.sqrt(d)).astype(np.float32)
    g = rng.normal(size=(nb, b, d)).astype(np.float32)
    kp = np.array(pack_keep(torch.from_numpy(keep)).numpy())
    return x, pad, kp, A, Wvo, g


def _jax_kp(kp):
    return jnp.asarray(kp.view(np.uint32))


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_k5a_plain_matches_jax(compute):
    bf16 = compute == "bfloat16"
    x, pad, kp, A, Wvo, _ = _mha_inputs()
    reset_launch_counts()
    got = gated_block_attention(torch.from_numpy(x), torch.from_numpy(kp), torch.from_numpy(pad),
                                torch.from_numpy(A), torch.from_numpy(Wvo),
                                compute_bf16=bf16).numpy()
    assert not any(launch_counts().values())
    want = np.asarray(jk5(jnp.asarray(x), _jax_kp(kp), jnp.asarray(pad), jnp.asarray(A),
                          jnp.asarray(Wvo), compute_bf16=bf16))
    err = np.abs(got - want)
    assert np.all(np.isfinite(got)) and float(np.abs(got[-1, 29:]).max()) == 0.0
    tol = (BF16_MAX, BF16_MEAN) if bf16 else (2e-4, 1e-4)
    assert err.max() <= tol[0] and err.mean() <= tol[1], (err.max(), err.mean())


def _allclose_scaled(got, want, atol_scale, rtol):
    want = np.asarray(want, np.float32)
    scale = max(float(np.abs(want).max()), 1e-3)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, atol=atol_scale * scale,
                               rtol=rtol)


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_k5b_plain_matches_jax_vjp(compute):
    bf16 = compute == "bfloat16"
    x, pad, kp, A, Wvo, g = _mha_inputs(seed=1)
    jkp, jpad = _jax_kp(kp), jnp.asarray(pad)
    _, vjp = jax.vjp(lambda x_, a_, w_: jk5(x_, jkp, jpad, a_, w_, compute_bf16=bf16),
                     jnp.asarray(x), jnp.asarray(A), jnp.asarray(Wvo))
    jdx, jdA, jdW = vjp(jnp.asarray(g))
    tx, tA, tW = (torch.from_numpy(v).requires_grad_(True) for v in (x, A, Wvo))
    out = gated_block_attention(tx, torch.from_numpy(kp), torch.from_numpy(pad), tA, tW,
                                compute_bf16=bf16)
    dx, dA, dW = torch.autograd.grad(out, (tx, tA, tW), torch.from_numpy(g))
    for got, want in ((dx, jdx), (dA, jdA), (dW, jdW)):
        assert got.shape == want.shape
        _allclose_scaled(got.numpy(), want, 2e-4, 2e-3)


def test_k5b_plain_is_the_gradient_of_k5a_plain():
    """In float64 at a tiny shape, K5b's plain version equals PyTorch
    autograd through K5a's plain version: the backward's formula."""
    x, pad, kp, A, Wvo, g = _mha_inputs(seed=2, nb=2, b=12, d=8, h=2)
    keep, padt = torch.from_numpy(kp), torch.from_numpy(pad)
    tx, tA, tW = (torch.from_numpy(v).double().requires_grad_(True)
                  for v in (x, head_concat(torch.from_numpy(A)).numpy(),
                            head_concat(torch.from_numpy(Wvo)).numpy()))
    gd = torch.from_numpy(g).double()
    out = gated_block_attention_fwd_reference(tx, keep, padt, tA, tW, compute_bf16=False)
    assert out.dtype == torch.float64
    auto = torch.autograd.grad(out, (tx, tA, tW), gd)
    manual = gated_block_attention_bwd_reference(tx.detach(), keep, padt, tA.detach(),
                                                 tW.detach(), gd, compute_bf16=False)
    for a, m in zip(auto, manual):
        assert m.dtype == torch.float64
        torch.testing.assert_close(m, a, rtol=1e-9, atol=1e-12)


def _sig_close(got, want, bf16):
    (rsum, rcnt), (jrsum, jrcnt) = got, (np.asarray(want[0]), np.asarray(want[1]))
    assert float(rcnt.sum()) > 0
    if bf16:
        assert np.abs(rcnt.numpy() - jrcnt).sum() <= 0.005 * max(jrcnt.sum(), 1)
        np.testing.assert_allclose(rsum.numpy().sum(1), jrsum.sum(1), rtol=1e-3)
    else:
        np.testing.assert_array_equal(rcnt.numpy(), jrcnt)
        np.testing.assert_allclose(rsum.numpy(), jrsum, rtol=2e-6, atol=1e-6)


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_k6b_plain_matches_jax(compute):
    bf16 = compute == "bfloat16"
    x, pad, _, A, _, _ = _mha_inputs(seed=3)
    x = 2.0 * x
    A_sig = A[0] * 4.0
    reset_launch_counts()
    got = block_gate_signature_x(torch.from_numpy(x), torch.from_numpy(pad),
                                 torch.from_numpy(A_sig), eps=0.01, compute_bf16=bf16)
    assert not any(launch_counts().values())
    want = jk6b(jnp.asarray(x), jnp.asarray(pad), jnp.asarray(A_sig), eps=0.01,
                compute_bf16=bf16)
    _sig_close(got, want, bf16)
    assert float(got[1][torch.from_numpy(pad) == 0].sum()) == 0.0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k6a_plain_matches_jax(dtype):
    x, pad, _, A, _, _ = _mha_inputs(seed=4)
    q = 2.0 * x @ A[0] * 4.0
    k = 2.0 * x
    tq, tk = torch.from_numpy(q.astype(np.float32)), torch.from_numpy(k)
    jq, jk = jnp.asarray(q), jnp.asarray(k)
    if dtype == "bfloat16":
        tq, tk, jq, jk = tq.bfloat16(), tk.bfloat16(), jq.astype(jnp.bfloat16), \
            jk.astype(jnp.bfloat16)
    got = block_gate_signature(tq, tk, torch.from_numpy(pad), eps=0.01, scale=0.125)
    want = jk6a(jq, jk, jnp.asarray(pad), eps=0.01, scale=0.125)
    _sig_close(got, want, dtype == "bfloat16")


# ---------------------------------------------------------------------------
# the loss, its gradients, the fused layer's Function and remat
# ---------------------------------------------------------------------------

class Model:
    """One model on both packages: graph, config, parameters (the JAX
    init, copied), features and the gate state's masks."""

    def __init__(self, idx, ew, feats, *, block, **cfg):
        n, m = idx.shape
        mask = np.ones((n, m), np.float32)
        self.jb = jbuild(idx, mask, ew, block=block, table_pad=8)
        self.tb = build_block_dense(idx, mask, ew, block=block, table_pad=8, device="cpu")
        self.jc = jg.GatedGraphTransformerConfig(**cfg)
        self.tc = tg.GatedGraphTransformerConfig(**cfg)
        self.jp = jg.gated_graph_transformer_init(jax.random.key(0), self.jc)
        self.tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, self.jp), "cpu")
        self.jf = self.jb.pad_features(jnp.asarray(feats))
        self.tf = self.tb.pad_features(torch.from_numpy(feats))
        jst = jg.gate_state_init(self.jp, dataclasses.replace(self.jc, fused_gate_attn="never"),
                                 self.jf, self.jb)
        self.jkeep = jst["keep"]
        self.tkeep = torch.from_numpy(np.array(self.jkeep).view(np.int32))

    def replace(self, **kw):
        self.jc = dataclasses.replace(self.jc, **kw)
        self.tc = dataclasses.replace(self.tc, **kw)
        return self


def _halo_free_d128(**cfg):
    """test_gated_graph_transformer.py:366: 4 blocks of 8, D=128, neighbours
    within the block (no halo)."""
    rng = np.random.default_rng(11)
    blk, nblocks, deg, d = 8, 4, 3, 128
    n = blk * nblocks
    idx = ((rng.integers(0, n, (n, deg)) % blk)
           + (np.arange(n)[:, None] // blk) * blk).astype(np.int32)
    ew = rng.uniform(0.1, 1, (n, deg)).astype(np.float32)
    model = Model(idx, ew, rng.normal(size=(n, d)).astype(np.float32), block=blk, dim=d,
                  num_heads=4, num_layers=2, **cfg)
    assert model.tb.table == model.tb.block
    return model


def _halo(**cfg):
    """test_gated_graph_transformer.py:19 _graph: a random graph (a halo),
    blocks of 32, table_pad 8."""
    rng = np.random.default_rng(0)
    n, m, d = 96, 8, 32
    idx = rng.integers(0, n, (n, m)).astype(np.int32)
    ew = rng.uniform(0.1, 1.0, (n, m)).astype(np.float32)
    feats = np.random.default_rng(1).normal(size=(n, d)).astype(np.float32)
    model = Model(idx, ew, feats, block=32, dim=d, num_heads=4, num_layers=2, **cfg)
    assert model.tb.table > model.tb.block
    return model


def _named_leaves(params):
    return [(f"{li}/{'/'.join(k)}", t) for li, layer in enumerate(params)
            for k, t in zip(*tg._flatten(layer))]


def _jax_leaf(jtree, name):
    li, *path = name.split("/")
    node = jtree[int(li)]
    for k in path:
        node = node[k]
    return np.asarray(node)


def _port_loss_and_grads(model, loss_fn, *args):
    named = [(n, t.clone().requires_grad_(True)) for n, t in _named_leaves(model.tp)]
    it = iter(t for _, t in named)
    params = [tg._unflatten(tg._flatten(layer)[0], [next(it) for _ in tg._flatten(layer)[1]])
              for layer in model.tp]
    loss = loss_fn(params, model.tc, model.tf, model.tb, *args)
    grads = torch.autograd.grad(loss, [t for _, t in named])
    return float(loss.detach()), {n: g.numpy() for (n, _), g in zip(named, grads)}


def _check_grads(model, tloss, tgrads, jloss, jgrads, route):
    bf16 = model.tc.compute_dtype == "bfloat16"
    np.testing.assert_allclose(tloss, float(jloss), rtol=1e-5 if route == "never" and not bf16
                               else 1e-4)
    assert len(tgrads) == len(jax.tree_util.tree_leaves(jgrads))
    for name, got in tgrads.items():
        want = _jax_leaf(jgrads, name)
        assert got.shape == want.shape and np.all(np.isfinite(got)), name
        if bf16:
            _allclose_scaled(got, want, 2e-3, 2e-3)
        elif route == "never":
            np.testing.assert_allclose(got, want, rtol=5e-4, atol=5e-5, err_msg=name)
        else:
            _allclose_scaled(got, want, 2e-4, 2e-3)


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
@pytest.mark.parametrize("route", ["never", "always"])
@pytest.mark.parametrize("layout", ["halo_free", "halo"])
def test_loss_with_masks_value_and_grads_match_jax(layout, route, compute):
    model = (_halo_free_d128 if layout == "halo_free" else _halo)(
        fused_gate_attn=route, compute_dtype=compute)
    reset_launch_counts()
    tloss, tgrads = _port_loss_and_grads(model, tg.gated_graph_transformer_loss_with_masks,
                                         model.tkeep, torch.zeros_like(model.tf))
    assert not any(launch_counts().values())      # CPU: plain versions only
    jloss, jgrads = jax.value_and_grad(jg.gated_graph_transformer_loss_with_masks)(
        model.jp, model.jc, model.jf, model.jb, model.jkeep, jnp.zeros_like(model.jf))
    _check_grads(model, tloss, tgrads, jloss, jgrads, route)


def test_stateless_loss_grads_match_jax():
    """test_gated_graph_transformer.py:121: the in-line-gate loss (gates
    solved in the call, no gradient through them)."""
    rng = np.random.default_rng(5)
    n, d = 64, 32
    idx = rng.integers(0, n, (n, 8)).astype(np.int32)
    ew = rng.uniform(0.1, 1.0, (n, 8)).astype(np.float32)
    feats = np.random.default_rng(7).normal(size=(n, d)).astype(np.float32)
    model = Model(idx, ew, feats, block=32, dim=d, num_heads=4, num_layers=2)
    tloss, tgrads = _port_loss_and_grads(model, tg.gated_graph_transformer_loss,
                                         torch.zeros_like(model.tf))
    jloss, jgrads = jax.value_and_grad(jg.gated_graph_transformer_loss)(
        model.jp, model.jc, model.jf, model.jb, jnp.zeros_like(model.jf))
    assert tloss > 0
    _check_grads(model, tloss, tgrads, jloss, jgrads, "never")


@pytest.mark.parametrize("route", ["never", "always"])
def test_remat_gives_equal_grads(route, monkeypatch):
    """remat checkpoints each layer: the same loss and gradients, and on
    the kernel route the recompute skips the fused layer's kernel (one
    K4a call per layer, as without remat)."""
    calls = []
    orig = tg.gated_block_layer
    monkeypatch.setattr(tg, "gated_block_layer", lambda *a, **k: calls.append(1) or orig(*a, **k))
    model = _halo_free_d128(fused_gate_attn=route)
    out = {}
    for remat in (False, True):
        model.replace(remat=remat)
        calls.clear()
        out[remat] = _port_loss_and_grads(model, tg.gated_graph_transformer_loss_with_masks,
                                          model.tkeep, torch.zeros_like(model.tf))
        assert len(calls) == (2 if route == "always" else 0)
    assert out[True][0] == out[False][0]
    for name, g in out[False][1].items():
        np.testing.assert_array_equal(out[True][1][name], g, err_msg=name)


def test_fused_layer_function_grads():
    """The fused layer's Function: no gradient for the edge table, the gate
    words or pad; its x and parameter gradients are autograd's through the
    plain _layer_body_halo_free (the same recompute, bit for bit), and its
    output is that body's within f32."""
    model = _halo_free_d128(fused_gate_attn="always")
    nb, b = model.tb.n_blocks, model.tb.block
    x0 = model.tf.reshape(nb, b, -1)
    g = torch.from_numpy(np.random.default_rng(3).normal(size=tuple(x0.shape)).astype(np.float32))
    grads = {}
    for how in ("function", "body"):
        named = [(n, t.clone().requires_grad_(True)) for n, t in _named_leaves(model.tp[:1])]
        p = tg._unflatten(tg._flatten(model.tp[0])[0], [t for _, t in named])
        x = x0.clone().requires_grad_(True)
        wd = model.tb.wdense.clone().requires_grad_(True)
        pad = model.tb.node_pad.clone().requires_grad_(True)
        keep = model.tkeep[0]
        fn = tg._fused_layer_halo_free if how == "function" else tg._layer_body_halo_free
        out = fn(model.tc, p, x, keep, pad, wd)
        torch.sum(out * g).backward()
        if how == "function":
            assert wd.grad is None and pad.grad is None
            fused_out = out.detach()
        else:
            torch.testing.assert_close(fused_out, out.detach(), rtol=0, atol=2e-5)
        grads[how] = [x.grad] + [t.grad for _, t in named]
    for a, w in zip(grads["function"], grads["body"]):
        assert a is not None and torch.equal(a, w)


@pytest.mark.parametrize("block", [48, 32])
def test_off_route_step_matches_jax(block):
    """The kernel route on a layout with a halo: B=48 (B % 32 != 0, the
    signature is K6b and the gate the plain batched one) and B=32 (K6c and
    K7); the layer is LN1, K5a and the plain mix and FFN in both. Init, a
    steady and a drifted step against JAX's interpret-mode kernels: masks,
    ages and resolve counts equal, signatures 2e-6 relative, outputs 2e-5."""
    rng = np.random.default_rng(block)
    n, m, d = 2 * block + 20, 8, 32
    idx = rng.integers(0, n, (n, m)).astype(np.int32)
    ew = rng.uniform(0.1, 1.0, (n, m)).astype(np.float32)
    feats = rng.normal(size=(n, d)).astype(np.float32)
    model = Model(idx, ew, feats, block=block, dim=d, num_heads=4, num_layers=2,
                  fused_gate_attn="always", hysteresis_band=0.0)
    assert model.tb.table > model.tb.block
    tst = tg.gate_state_init(model.tp, model.tc, model.tf, model.tb)
    jst = jg.gate_state_init(model.jp, model.jc, model.jf, model.jb)
    drift = feats + 0.3 * rng.normal(size=feats.shape).astype(np.float32)
    inputs = [(model.jf, model.tf), (model.jb.pad_features(jnp.asarray(drift)),
                                     model.tb.pad_features(torch.from_numpy(drift)))]
    for jf, tf in [(None, None)] + inputs:
        if jf is not None:
            tout, tst, tn = tg.gated_graph_transformer_step(model.tp, model.tc, tf, model.tb, tst)
            jout, jst, jn = jg.gated_graph_transformer_step(model.jp, model.jc, jf, model.jb,
                                                            jst)
            assert tn == int(jn)
            np.testing.assert_allclose(tout.numpy(), np.asarray(jout), atol=2e-5, rtol=2e-5)
        np.testing.assert_array_equal(tst["keep"].numpy().view(np.uint32), np.asarray(jst["keep"]))
        np.testing.assert_array_equal(tst["age"].numpy(), np.asarray(jst["age"]))
        np.testing.assert_allclose(tst["sig"].numpy(), np.asarray(jst["sig"]), rtol=2e-6,
                                   atol=1e-7)
    assert tn > 0
