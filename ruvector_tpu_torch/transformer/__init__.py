"""Mincut-gated transformer — deterministic, tiered, quantized inference
(port of ruvector_tpu/transformer/, plain PyTorch: no module of this
package reaches a custom kernel).

Reference: `ruvector-mincut-gated-transformer` (lib.rs:29-36):

1. **Transformer kernel** — int8-quantized GEMMs with exact integer sums
   (replacing Q15 fixed-point scalar loops, q15.rs / kernel/qgemm.rs),
   windowed attention with RoPE, FFN. Deterministic: no RNG on the
   inference path.
2. **Spike scheduler** — host-side skip/tier pre-selection (spike.rs).
3. **Mincut gate** — authoritative GateController (gate.rs:195-297) that
   picks the compute tier (layers to run, sequence length, window).

Every inference emits a Witness (packets.rs) recording the gate decision
and a hash of the logits — same inputs give the same witness.

Every entry point takes `device` (default: the CUDA card) and weights in
the JAX layout (`init_weights`, `convert.params_from_numpy`). Decoding and
speculative decoding run B sequences at once on batched caches.
"""

from ruvector_tpu_torch.transformer.config import TransformerConfig, GatePolicy
from ruvector_tpu_torch.transformer.packets import (
    GatePacket,
    SpikePacket,
    GateDecision,
    GateReason,
    TierDecision,
    Witness,
    InferOutput,
)
from ruvector_tpu_torch.transformer.gate import GateController
from ruvector_tpu_torch.transformer.quant import (
    quantize_weight_int8,
    dequantize_int8,
    int8_matmul,
)
from ruvector_tpu_torch.transformer.model import MincutGatedTransformer, init_weights
from ruvector_tpu_torch.transformer.spec_decode import (
    SpecDecodeConfig,
    make_speculative_generate_fn,
)
from ruvector_tpu_torch.transformer.kv_cache import (
    KVCacheConfig,
    KVCacheState,
    kv_cache_init,
    kv_cache_append,
    kv_cache_positions,
    kv_cache_read,
)

__all__ = [
    "TransformerConfig",
    "GatePolicy",
    "GatePacket",
    "SpikePacket",
    "GateDecision",
    "GateReason",
    "TierDecision",
    "Witness",
    "InferOutput",
    "GateController",
    "quantize_weight_int8",
    "dequantize_int8",
    "int8_matmul",
    "MincutGatedTransformer",
    "init_weights",
    "KVCacheConfig",
    "KVCacheState",
    "SpecDecodeConfig",
    "make_speculative_generate_fn",
    "kv_cache_init",
    "kv_cache_append",
    "kv_cache_positions",
    "kv_cache_read",
    "TraceState",
    "TraceSnapshot",
    "Decoder",
    "make_decode_step",
    "make_generate_fn",
    "make_batched_generate_fn",
]

from ruvector_tpu_torch.transformer.trace import TraceState, TraceSnapshot
from ruvector_tpu_torch.transformer.decode import (
    Decoder,
    make_decode_step,
    make_generate_fn,
    make_batched_generate_fn,
)
