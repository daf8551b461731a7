"""The system under test: every call into ruvector_tpu_torch that the
benchmark makes goes through here, so the harness's own files name the
port's entry points in one place.

The CUDA kernels build into the port's own `ruvector_tpu_torch/_build/`
(inside the checkout, named by a hash of their source): a cell's first
run compiles, later runs load them.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

# the port's CUDA sources that each model's path launches
SOURCES = {
    "gated_graph_transformer": ("gated_block_layer", "gated_block_attn", "mincut_gate_block",
                                "gated_block_mha"),
    "ruvector_layer": ("block_dense_attn",),
}
# the port's hand-written kernels, by the CUDA function names that the
# profiler's trace gives them (namespaces and template arguments aside)
PORT_KERNELS = ("tc_fused_kernel", "fused_layer_kernel", "tc_attention_kernel",
                "attention_kernel", "stream_attention_kernel", "tc_signature_kernel",
                "signature_kernel", "tc_layer_kernel", "layer_kernel", "tc_mha_fwd_kernel",
                "mha_fwd_kernel", "tc_mha_bwd_kernel", "mha_bwd_kernel",
                "reduce_partials_kernel", "gate_kernel", "stream_mix_kernel",
                "neighbor_mix_kernel", "spmm_tile_kernel")


def build(model: str, device: torch.device) -> float:
    """Compile the model's kernel sources not built yet (seconds)."""
    if device.type != "cuda":
        return 0.0
    from ruvector_tpu_torch.ops.kernels import _lib

    return _lib.build(SOURCES[model])["total"]


def layout(idx: torch.Tensor, ew: torch.Tensor, block: int, dtype: torch.dtype, device):
    """The port's block-dense layout of the neighbour lists (host plan,
    device fill) and the seconds it took, synchronised."""
    from ruvector_tpu_torch.graph.block_dense import build_block_dense

    t0 = time.perf_counter()
    n, k = idx.shape
    bdg = build_block_dense(idx.cpu().numpy(), np.ones((n, k), np.float32), ew.cpu().numpy(),
                            block=block, dtype=dtype, device=device)
    if device.type == "cuda":
        torch.cuda.synchronize()
    return bdg, time.perf_counter() - t0


# ---------------------------------------------------------------------------
# config 5: the min-cut-gated graph transformer
# ---------------------------------------------------------------------------

def gated_config(cfg: dict, device: torch.device, **changes):
    """The port's GatedGraphTransformerConfig of a configuration file. Off
    the card the kernel route is forced, so that the kernels' plain
    versions run where the card would launch the kernels."""
    from ruvector_tpu_torch.graph_transformer.gated import GatedGraphTransformerConfig

    c = GatedGraphTransformerConfig(
        dim=cfg["dim"], num_heads=cfg["num_heads"], ffn_mult=cfg["ffn_mult"],
        num_layers=cfg["num_layers"], lam=cfg["lam"], eps=cfg["eps"],
        hysteresis_band=cfg["hysteresis_band"], max_resolve_frac=cfg["max_resolve_frac"],
        max_gate_age=cfg["max_gate_age"], compute_dtype=cfg["compute_dtype"],
        fused_gate_attn="auto" if device.type == "cuda" else "always")
    return dataclasses.replace(c, **changes)


def gate_state_init(params, gcfg, fpad, bdg):
    from ruvector_tpu_torch.graph_transformer import gated

    return gated.gate_state_init(params, gcfg, fpad, bdg)


def gated_step(params, gcfg, fpad, bdg, state):
    """(out [nB*B, D], new state, partitions re-solved)."""
    from ruvector_tpu_torch.graph_transformer import gated

    return gated.gated_graph_transformer_step(params, gcfg, fpad, bdg, state)


def gated_loss(params, gcfg, fpad, bdg, keep, targets):
    from ruvector_tpu_torch.graph_transformer import gated

    return gated.gated_graph_transformer_loss_with_masks(params, gcfg, fpad, bdg, keep, targets)


def unpack_keep(kp: torch.Tensor, b: int) -> torch.Tensor:
    """The port's bit-packed gate words [..., ceil(B/32), B] int32 (row i in
    word i // 32, bit i % 32) as [..., B, B] bool: the format is the
    port's output, read here only to judge it."""
    w = kp.shape[-2]
    shifts = torch.arange(32, device=kp.device, dtype=torch.int32).reshape(32, 1)
    bits = (kp[..., :, None, :] >> shifts) & 1
    return bits.reshape(*kp.shape[:-2], w * 32, kp.shape[-1])[..., :b, :] > 0


# ---------------------------------------------------------------------------
# the RuvectorLayer
# ---------------------------------------------------------------------------

def layer_config(cfg: dict):
    from ruvector_tpu_torch.nn.ruvector_layer import RuvectorLayerConfig

    return RuvectorLayerConfig(input_dim=cfg["input_dim"], hidden_dim=cfg["hidden_dim"],
                               heads=cfg["heads"], dropout=cfg["dropout"],
                               compute_dtype=cfg["compute_dtype"])


def layer_pass(params, lcfg, fpad, bdg, io_dtype):
    """One RuvectorLayer pass over the whole graph: [nB*B, D]."""
    from ruvector_tpu_torch.nn.block_dense_layer import ruvector_layer_apply_block_dense_fused

    return ruvector_layer_apply_block_dense_fused(params, lcfg, fpad, bdg, io_dtype=io_dtype)
