"""The yardstick: published H100 peaks, the least time a piece of work
needs at them, and the operations and bytes of the port's kernels and of
the models, each counted from shapes.

Frozen copies of chip_smoke.py's PEAK_BYTES_PER_S, PEAK_OPS_PER_S and
`bound` (chip_smoke.py:647-655, 1092-1098) and of the operation and byte
counts behind PERF.md's kernel table (`config5_report`, `train_report`,
`k1_ops`, `_k1_at_10m`). Later changes to the port do not move them.
"""

from __future__ import annotations

# H100 SXM, NVIDIA's data sheet: dense rates at the 700 W limit
PEAK_BYTES_PER_S = 3.35e12
# "bf16": bf16 operands on the tensor cores; "tf32x3": float32-grade
# products as three TF32 passes (495 TFLOP/s / 3); "f64": float64 sums on
# the float64 tensor cores; "f32": float32 FMA on the CUDA cores
PEAK_OPS_PER_S = {"bf16": 989e12, "tf32x3": 495e12 / 3, "f64": 67e12, "f32": 67e12}
# the rate that model FLOP utilisation (mfu) is taken against
MFU_PEAK = PEAK_OPS_PER_S["bf16"]


def bound_s(n_bytes: float, ops: dict) -> float:
    """Least seconds for the work: bytes over the memory rate or the
    operations over the peak rate of their type, whichever is larger."""
    t_bytes = n_bytes / PEAK_BYTES_PER_S
    t_ops = sum(n / PEAK_OPS_PER_S[kind] for kind, n in ops.items())
    return max(t_bytes, t_ops)


# ---------------------------------------------------------------------------
# config 5's kernels at a halo-free layout of nb partitions of b rows, width
# d, h heads, FFN width f*d; float32 residual stream, bf16 edge table
# ---------------------------------------------------------------------------

def _gated_layer_ops(n: int, b: int, d: int, h: int, f: int) -> float:
    """K4a's bf16 operations: per row the gated MHA (q and y projections,
    scores and weighted values over the partition, per head), the
    neighbour mix and W_gnn, and the FFN."""
    return 2 * n * (h * (2 * d + 2 * b) * d + (b + d) * d + 2 * f * d * d)


def _gated_layer_bytes(n: int, b: int, d: int, h: int, f: int) -> float:
    """K4a's bytes: x in and out (float32), the gate words, pad, the bf16
    edge table and the folded float32 weights."""
    folded = 4 * (2 * h * d * d + 6 * d + d * d + d + 2 * f * d * d + f * d + d)
    return 2 * 4 * n * d + 4 * n * b // 32 + 4 * n + 2 * n * b + folded


def k4a_bound_s(nb: int, b: int, d: int, h: int, f: int) -> float:
    """K4a, the fused gated layer (config5_report's gated_block_layer row)."""
    n = nb * b
    return bound_s(_gated_layer_bytes(n, b, d, h, f), {"bf16": _gated_layer_ops(n, b, d, h, f)})


def k4b_bound_s(nb: int, b: int, d: int, h: int, f: int) -> float:
    """K4b: K4a plus the next layer's signature from its output, whose
    logits are float64 sums (config5_report's gated_block_layer_with_sig)."""
    n = nb * b
    sig_ops = 2 * n * (b + d) * d
    n_bytes = _gated_layer_bytes(n, b, d, h, f) + 4 * (d * d + 2 * d) + 2 * 4 * n
    return bound_s(n_bytes, {"bf16": _gated_layer_ops(n, b, d, h, f), "f64": sig_ops})


def k6c_bound_s(nb: int, b: int, d: int) -> float:
    """K6c, the LN-folded signature over every partition."""
    n = nb * b
    return bound_s(4 * n * d + 4 * n + 4 * (d * d + 2 * d) + 2 * 4 * n,
                   {"f64": 2 * n * (b + d) * d})


def k7_bound_s(k: int, b: int, d: int, rounds: int = 0) -> float:
    """K7 on k partitions: the logits (exact products, float64 sums) plus
    about 10 B^2 float32 operations a push-relabel round, for the rounds
    given (config5_report's gate_bound; 0 counts the logits alone)."""
    n_bytes = (4 * k * b * d + 4 * k * b + 4 * (d * d + 2 * d) + 4 * k * b * b // 32
               + 4 * k * 8 * b)
    return bound_s(n_bytes, {"f64": 2 * k * b * d * (b + d), "f32": 10 * b * b * rounds})


def k5a_bound_s(nb: int, b: int, d: int, h: int) -> float:
    """K5a, the gated MHA forward (train_report's first row)."""
    n = nb * b
    return bound_s(4 * n * d + 4 * n * b // 32 + 4 * n + 2 * 4 * h * d * d + 4 * n * d,
                   {"bf16": 2 * n * h * (2 * d + 2 * b) * d})


def k5b_bound_s(nb: int, b: int, d: int, h: int) -> float:
    """K5b, the gated MHA's recompute backward: bf16 recompute, the
    backward proper float32-grade (train_report's second row)."""
    n = nb * b
    n_bytes = 2 * 4 * n * d + 4 * n * b // 32 + 4 * n + 2 * 2 * 4 * h * d * d + 4 * n * d
    return bound_s(n_bytes, {"bf16": 2 * n * h * (2 * d + b) * d,
                             "tf32x3": 2 * n * h * (4 * d + 4 * b) * d})


# ---------------------------------------------------------------------------
# K1, the fused RuvectorLayer (k1_ops and _k1_at_10m)
# ---------------------------------------------------------------------------

def k1_bound_s(nb: int, b: int, d: int, h: int, edges: int, io_bytes: int = 2) -> float:
    """K1 over nb halo-free blocks of b rows (table T = b): the dense
    tile's bf16 products over the real edges, the epilogue's float32-grade
    products per row; bytes: the table and message rows (io_bytes each),
    the float32 edge table, the folded weights and the output."""
    rows = nb * b
    ops = {"bf16": 2 * (2 * h + 1) * d * edges, "tf32x3": 2 * (2 * h + 7) * d * d * rows}
    folded = 4 * (2 * h * d * d + h * d + 7 * d * d + 11 * d)
    n_bytes = 3 * io_bytes * rows * d + 4 * nb * b * b + folded
    return bound_s(n_bytes, ops)


# ---------------------------------------------------------------------------
# model operations for mfu
# ---------------------------------------------------------------------------

def gated_forward_ops(n: int, b: int, d: int, f: int, layers: int) -> float:
    """Config 5's forward, as the model states it, per step: in each layer
    per node the q, k, v and output projections (8 d^2), the attention
    scores and the weighted values over the node's partition of b (2 b d
    each, all heads together), the neighbour mix over the partition's
    dense edge table (2 b d), W_gnn (2 d^2) and the FFN (4 f d^2). The
    gate's signatures and solves are not the model's and are not counted."""
    return layers * n * (8 * d * d + 4 * b * d + 2 * b * d + 2 * d * d + 4 * f * d * d)


def gated_train_ops(n: int, b: int, d: int, f: int, layers: int) -> float:
    """A train step: the forward and a backward of twice its operations;
    remat's recompute is not the model's and is not counted."""
    return 3 * gated_forward_ops(n, b, d, f, layers)


def ruvector_layer_ops(n: int, d_in: int, d: int, m: int) -> float:
    """One RuvectorLayer pass, as the layer states it, per node: the
    message projection (2 d_in d), q, k and v (6 d^2), the scores and the
    weighted values over m neighbours (4 m d, all heads), the edge-weighted
    mean (2 m d), the output projection and W_agg (4 d^2) and the GRU's
    six gate products (12 d^2)."""
    return n * (2 * d_in * d + 6 * d * d + 6 * m * d + 4 * d * d + 12 * d * d)
