"""K5b's float32 grade on the card: how far the gated MHA backward's
tensor-core body (3xTF32) and its test-only faults (single-pass TF32;
head 0's dq A_0^T left out of dX) land from the plain version, as max
and mean |error| over each gradient's largest magnitude.

It reads the inputs of `tests/test_torch_kernels_cuda.py`'s float32-grade
test (B = 240 and 256) and of `chip_smoke.py`'s `phase_train_parity`
(config 5's widths, seed-0 weights), the readings from which the limit
`TOL_F32_GRADE` is set. Needs a CUDA card and nvcc:

    python3 benchmarks/k5b_float32_grade_torch.py
"""
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "tests")]

import chip_smoke as cs  # noqa: E402
import test_torch_kernels_cuda as card_tests  # noqa: E402
from ruvector_tpu_torch.ops.kernels import gated_block_attn as ga  # noqa: E402

VARIANTS = ("exact", "one_tf32", "no_dq_a0")


def readings(got, want) -> list:
    out = []
    for a, w in zip(got, want):
        a, w = a.float(), w.float()
        scale = float(w.abs().max())
        err = (a - w).abs()
        out.append((float(err.max()) / scale, float(err.mean()) / scale))
    return out


def run_variant(args, variant):
    dx, dA, dW = ga.gated_block_attention_bwd_partials(*args, compute_bf16=True, variant=variant)
    return dx, ga.reduce_partials(dA), ga.reduce_partials(dW)


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    for b in (240, 256):
        args = card_tests._bwd_f32_grade_inputs(dev, b)
        want = ga.gated_block_attention_bwd_reference(*args, compute_bf16=True)
        for v in VARIANTS:
            print(f"card test B={b} {v}: (max, mean) of dx, dA_cat, dWvo_cat",
                  readings(run_variant(args, v), want), flush=True)
    gcfg = cs.gated.GatedGraphTransformerConfig(
        dim=128, num_heads=4, ffn_mult=4, num_layers=2, lam=0.5, eps=0.01,
        hysteresis_band=0.05, max_resolve_frac=1 / 16, compute_dtype="bfloat16")
    p = cs.gated.gated_graph_transformer_init(0, gcfg, device=dev)[0]
    A, Wvo = cs.fold_gated_attention_params(p, gcfg)
    gen = torch.Generator().manual_seed(2)   # phase_train_parity's draws
    nb, b, d = 3, cs.C5_BLOCK, gcfg.dim
    h = torch.randn(nb, b, d, generator=gen).to(dev)
    g = torch.randn(nb, b, d, generator=gen).to(dev)
    pad = torch.ones(nb, b)
    pad[-1, 200:] = 0.0
    keep = torch.rand(nb, b, b, generator=gen) < 0.3
    keep[0, 5] = False
    args = (h, cs.pack_keep(keep).to(dev), pad.to(dev), cs.head_concat(A), cs.head_concat(Wvo),
            g)
    want = ga.gated_block_attention_bwd_reference(*args, compute_bf16=True)
    for v in VARIANTS:
        print(f"train parity B={b} {v}: (max, mean) of dx, dA_cat, dWvo_cat",
              readings(run_variant(args, v), want), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
