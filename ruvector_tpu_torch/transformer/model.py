"""MincutGatedTransformer — tiered, deterministic, int8 inference (port of
ruvector_tpu/transformer/model.py).

Reference: ruvector-mincut-gated-transformer/src/model.rs — infer
(:393-465), run_layers (:534), run_single_layer (:583), output projection
(:631), witness creation (:640).

Layer: pre-LayerNorm -> windowed causal MHA with RoPE (int8 or f32 QKV/out
projections) -> residual -> LayerNorm -> FFN (GELU) -> residual. Early
exit: after each layer the relative change of the hidden state is
measured, and once it drops below the threshold the remaining layers are
skipped (CoherenceEarlyExit, early_exit.rs). The reference compiles one
program per tier; the port runs the same function for every tier, its
layer loop on the host (one host read per layer, only when an early-exit
threshold is set).

Weights use the JAX layout: {"embedding" [vocab, hidden], "layers": [{qkv,
out, ffn_in, ffn_out, ln1, ln2}], "head", "final_ln"}; a dense leaf is
{"w_q" int8 [in, out], "scale", "bias"} or {"w" [in, out], "bias"}.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ruvector_tpu_torch.attention.rope import rope_rotate, rope_tables
from ruvector_tpu_torch.convert import params_from_numpy
from ruvector_tpu_torch.device import resolve_device
from ruvector_tpu_torch.transformer.config import GatePolicy, TransformerConfig
from ruvector_tpu_torch.transformer.gate import GateController
from ruvector_tpu_torch.transformer.packets import (
    GateDecision,
    GatePacket,
    InferOutput,
    SpikePacket,
    Witness,
)
from ruvector_tpu_torch.transformer.quant import int8_matmul, quantize_weight_int8

# JAX fills masked scores with -1e30, not -inf: a fully masked row then
# softmaxes to a uniform row, as in JAX, instead of NaN
MASKED = -1e30


# --- weights ----------------------------------------------------------------

def init_weights(init, cfg: TransformerConfig, quantize: bool = True, device=None) -> dict:
    """Random-init weights from a torch.Generator (int8-quantized per
    channel unless quantize=False), or load a numpy pytree in the JAX
    layout (e.g. weights JAX initialised) onto `device`."""
    dev = resolve_device(device)
    if not isinstance(init, torch.Generator):
        return params_from_numpy(init, dev)
    g = init
    d, f, v, lg = cfg.hidden, cfg.ffn_dim, cfg.vocab, cfg.logits

    def normal(*shape):
        return torch.randn(shape, generator=g, device=g.device).to(dev)

    def dense(i, o):
        w = normal(i, o) * (2.0 / (i + o)) ** 0.5
        bias = torch.zeros(o, device=dev)
        if quantize:
            wq, s = quantize_weight_int8(w)
            return {"w_q": wq, "scale": s, "bias": bias}
        return {"w": w, "bias": bias}

    def ln():
        return {"gamma": torch.ones(d, device=dev), "beta": torch.zeros(d, device=dev)}

    layers = [{"qkv": dense(d, 3 * d), "out": dense(d, d), "ffn_in": dense(d, f),
               "ffn_out": dense(f, d), "ln1": ln(), "ln2": ln()}
              for _ in range(cfg.layers)]
    emb = normal(v, d) * 0.02
    return {"embedding": emb, "layers": layers, "head": dense(d, lg), "final_ln": ln()}


def _apply_dense(p: dict, x: torch.Tensor) -> torch.Tensor:
    if "w_q" in p:
        return int8_matmul(x, p["w_q"], p["scale"], p["bias"])
    return torch.matmul(x, p["w"]) + p["bias"]


def _ln(p, x, eps=1e-5):
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mu), dim=-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * p["gamma"] + p["beta"]


def _gelu(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu is the tanh form by default
    return F.gelu(x, approximate="tanh")


def _embed(weights: dict, ids: torch.Tensor) -> torch.Tensor:
    """weights["embedding"][ids] with JAX's gather bounds: an id past the
    table (an argmax over `logits` > `vocab` entries) is clamped to the last
    row, where torch would raise a device-side assert."""
    emb = weights["embedding"]
    return emb[torch.clamp(ids.long(), 0, emb.shape[0] - 1)]


# --- core block -------------------------------------------------------------

def _windowed_causal_mask(s: int, window: int, device=None) -> torch.Tensor:
    dev = resolve_device(device)
    rows = torch.arange(s, device=dev)[:, None]
    cols = torch.arange(s, device=dev)[None, :]
    return ((cols <= rows) & (rows - cols < window)).to(torch.float32)


def _layer_fn(layer_params, x, cos_t, sin_t, mask, heads):
    """One layer over x [..., S, d] (leading dims: a batch of sequences)
    with the [S, S] attention mask (1 = attend)."""
    *lead, s, d = x.shape
    hd = d // heads
    h = _ln(layer_params["ln1"], x)
    qkv = _apply_dense(layer_params["qkv"], h)
    q, k, v = torch.split(qkv, d, dim=-1)
    pos = torch.arange(s, device=x.device)

    def heads_first(t):                                   # [..., H, S, hd]
        return t.reshape(*lead, s, heads, hd).transpose(-3, -2)

    q = rope_rotate(heads_first(q), pos, cos_t, sin_t)
    k = rope_rotate(heads_first(k), pos, cos_t, sin_t)
    v = heads_first(v)

    scale = 1.0 / (hd ** 0.5)
    scores = torch.einsum("...hqd,...hkd->...hqk", q, k) * scale
    scores = torch.where(mask > 0, scores, MASKED)
    attn = torch.softmax(scores, dim=-1)
    ctx = torch.einsum("...hqk,...hkd->...hqd", attn, v)
    ctx = ctx.transpose(-3, -2).reshape(*lead, s, d)
    x = x + _apply_dense(layer_params["out"], ctx)

    h2 = _ln(layer_params["ln2"], x)
    ff = _apply_dense(layer_params["ffn_out"], _gelu(_apply_dense(layer_params["ffn_in"], h2)))
    return x + ff


# --- model ------------------------------------------------------------------

class MincutGatedTransformer:
    """Gated transformer with one forward per gate tier.

    infer(input_tokens_or_embedding, gate, spikes) -> InferOutput with
    logits + witness (model.rs:393-465 flow: gate evaluate -> tier -> run
    layers with early exit -> output projection -> witness).
    """

    def __init__(self, config: TransformerConfig, policy: GatePolicy,
                 weights: dict, early_exit_threshold: float = 0.0,
                 sparsity_config=None, mod_config=None, device=None):
        """weights: the tree of tensors (init_weights) on `device`.
        sparsity_config: transformer.sparse_attention.SparsityConfig —
        min-cut partition-structured attention masks built from the gate.
        mod_config: transformer.mod_routing.ModRoutingConfig — Mixture-of-
        Depths token routing (tokens off the route keep their residual).
        """
        self.device = resolve_device(device)
        self.config = config
        self.policy = policy
        self.weights = weights
        self.gate_controller = GateController(policy, config)
        self.early_exit_threshold = early_exit_threshold
        # the reference's tables reach seq_len_max (model.py:143-146)
        self._rope = rope_tables(config.head_dim, config.seq_len_max, config.rope_base,
                                 config.rope_scaling, config.rope_scaling_factor,
                                 device=self.device)
        self._cached_logits: np.ndarray | None = None
        self._sparse = None
        if sparsity_config is not None:
            from ruvector_tpu_torch.transformer.sparse_attention import MincutSparseAttention
            self._sparse = MincutSparseAttention(sparsity_config)
        self._router = None
        if mod_config is not None:
            from ruvector_tpu_torch.transformer.mod_routing import MincutDepthRouter
            self._router = MincutDepthRouter(mod_config)

    def _run(self, layers_to_run: int, seq_len: int, window: int, x: torch.Tensor,
             last_pos: int, extra_mask: torch.Tensor | None,
             mod_mask: torch.Tensor | None) -> tuple[torch.Tensor, int]:
        """The tier's forward: x [seq_len] token ids or [seq_len, hidden]
        embeddings; extra_mask [S, S] (sparse structure, ANDed with the
        windowed causal mask); mod_mask [S] (1 = compute) for every layer.
        Returns (logits, layers run)."""
        cos_t, sin_t = self._rope
        thresh = self.early_exit_threshold
        if x.dtype != torch.float32:
            # the lookup stays on the device (a host gather would move the table)
            x = _embed(self.weights, x)
        mask = _windowed_causal_mask(seq_len, window, self.device)
        if extra_mask is not None:
            mask = mask * extra_mask
        h = x
        i = 0
        while i < layers_to_run:
            h_new = _layer_fn(self.weights["layers"][i], h, cos_t, sin_t, mask,
                              self.config.heads)
            if mod_mask is not None:
                # MoD: skipped tokens keep their residual (mod_routing.rs)
                h_new = torch.where(mod_mask[:, None] > 0, h_new, h)
            i += 1
            exit_now = False
            if thresh > 0:
                # coherence early exit: relative change below threshold
                delta = torch.linalg.vector_norm(h_new - h) / torch.clamp(
                    torch.linalg.vector_norm(h), min=1e-8)
                exit_now = bool(delta < thresh)
            h = h_new
            if exit_now:
                break
        h = _ln(self.weights["final_ln"], h)
        # logits at the last REAL token position (zero-padding beyond)
        return _apply_dense(self.weights["head"], h[last_pos]), i

    def infer(
        self,
        tokens: np.ndarray | None = None,
        gate: GatePacket = GatePacket(),
        spikes: SpikePacket | None = None,
        embedding: np.ndarray | None = None,
    ) -> InferOutput:
        decision = self.gate_controller.evaluate(gate, spikes)
        kv_ok = self.gate_controller.should_allow_kv_writes(gate)
        ext_ok = self.gate_controller.should_allow_external_writes(gate)

        if decision.skip:
            # tier 3: return cached logits or zeros (model.rs:410-430)
            logits = (self._cached_logits if self._cached_logits is not None
                      else np.zeros(self.config.logits, np.float32))
            witness = Witness(
                tier=decision.tier, decision=decision.decision,
                reason=decision.reason, kv_writes_enabled=0,
                external_writes_enabled=0, layers_run=0, early_exit_layer=0,
                logits_hash=Witness.hash_logits(logits),
            )
            return InferOutput(logits=logits, witness=witness, stats={"skipped": True})

        s = decision.effective_seq_len
        if embedding is None:
            ids = np.asarray(tokens, np.int32)[:s]
            x = np.zeros(s, np.int32)
            x[: len(ids)] = ids
        else:
            e = np.asarray(embedding, np.float32)[:s]
            x = np.zeros((s, self.config.hidden), np.float32)
            x[: e.shape[0]] = e
        x = torch.from_numpy(x).to(self.device)
        n_real = min(len(tokens) if tokens is not None else embedding.shape[0], s)

        # sparse-attention structure from the gate (sparse_attention.rs)
        extra_mask = None
        if self._sparse is not None:
            extra_mask = torch.from_numpy(
                self._sparse.build_mask(gate, s).mask.astype(np.float32)).to(self.device)

        # MoD routing from the gate (mod_routing.rs); padding never computes
        mod_mask = None
        if self._router is not None:
            routes = self._router.route_tokens(gate, np.arange(n_real))
            row = np.zeros(s, np.float32)
            row[:n_real] = self._router.compute_layer_mask(routes).astype(np.float32)
            row[max(n_real - 1, 0)] = 1.0   # logits position always computes
            mod_mask = torch.from_numpy(row).to(self.device)

        logits, layers_run = self._run(decision.layers_to_run, s, decision.effective_window,
                                       x, max(n_real - 1, 0), extra_mask, mod_mask)
        logits = logits.cpu().numpy()
        self._cached_logits = logits

        witness = Witness(
            tier=decision.tier, decision=decision.decision,
            reason=decision.reason,
            kv_writes_enabled=int(kv_ok and decision.decision
                                  not in (GateDecision.FLUSH_KV,
                                          GateDecision.FREEZE_WRITES)),
            external_writes_enabled=int(ext_ok and decision.decision == GateDecision.ALLOW),
            layers_run=layers_run,
            early_exit_layer=layers_run if layers_run < decision.layers_to_run else 0,
            logits_hash=Witness.hash_logits(logits),
        )
        return InferOutput(logits=logits, witness=witness,
                           stats={"tier": decision.tier, "layers_run": layers_run})
