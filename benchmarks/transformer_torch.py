"""chip_smoke.py's `[transformer]` phase alone, on the card, without the
kernel build (the phase launches no kernel): the min-cut-gated transformer
at benchmarks/spec_at_size.py's width, trained, decoded greedily and
speculatively, through its tiers, its tiered KV cache and its subsystems,
each against the CPU. Prints the phase's lines and its peak device memory.

With `profile`, it traces instead one batched greedy decode, one
speculative call, one normal-tier call, one decode step through every
tier of the Decoder's cache and one training forward and backward, on
seeded random weights at the same width (torch.profiler, CPU and CUDA activities) and prints each
one's wall time, the device time of its kernels (summed over the kernel
events, and over the operators' device time beside it), their count, and
the device's idle share.

    python3 benchmarks/transformer_torch.py [profile]
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

import chip_smoke as cs  # noqa: E402


def traced(name: str, fn) -> None:
    """fn() once (after one untraced call) under the profiler: wall ms,
    the summed device time of its kernels, their count, the idle share."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    device_ms = sum(e.device_time for e in kernels) / 1e3
    ops_device_ms = sum(e.self_device_time_total for e in prof.key_averages()) / 1e3
    cs.say("transformer_profile", name=name, wall_ms=wall_ms, device_ms=device_ms,
           ops_device_ms=ops_device_ms, kernels=len(kernels),
           device_idle_share=1.0 - device_ms / wall_ms)


def profile_paths() -> None:
    cfg = cs.TransformerConfig(**cs.TF_CFG)
    weights = cs.init_weights(torch.Generator().manual_seed(0), cfg, quantize=False,
                              device=cs.DEV)
    cache_cfg = cs.KVCacheConfig(hot_capacity=cs.TF_HOT, warm_capacity=0, archive_capacity=0,
                                 heads=cfg.heads, head_dim=cfg.head_dim)
    prompts, _ = cs.markov_corpus(0, cfg.vocab, n_seq=cs.TF_BATCH, seq_len=cs.TF_PROMPT,
                                  sample_seed=1234)
    fresh = [cs.kv_cache_init(cache_cfg, cs.DEV, batch=cs.TF_BATCH) for _ in range(cfg.layers)]
    gen_b = cs.make_batched_generate_fn(cfg, cache_cfg, cs.TF_PROMPT, cs.TF_NEW, device=cs.DEV)
    traced("greedy batched decode", lambda: gen_b(weights, fresh, prompts))
    step = cs.make_decode_step(cfg, cache_cfg, cs.DEV)
    caches, logits = cs.warm_caches(step, weights, cfg, cache_cfg,
                                    torch.from_numpy(prompts).long().to(cs.DEV), cs.DEV)
    first = torch.argmax(logits, dim=-1)
    sgen = cs.make_speculative_generate_fn(
        cfg, cache_cfg, cs.SpecDecodeConfig(cs.TF_GAMMA, cs.TF_DRAFT), cs.TF_NEW, device=cs.DEV)
    traced("speculative decode (random weights)", lambda: sgen(weights, caches, first))
    wq = cs.init_weights(torch.Generator().manual_seed(1), cfg, quantize=True, device=cs.DEV)
    model = cs.MincutGatedTransformer(cfg, cs.GatePolicy(), wq, device=cs.DEV)
    tokens, _ = cs.markov_corpus(2, cfg.vocab, n_seq=1, seq_len=cs.TF_TIER_TOKENS)
    traced("normal tier, int8", lambda: model.infer(tokens=tokens[0]))
    dec = cs.Decoder(cfg, cs.GatePolicy(), weights, device=cs.DEV)
    empty = dec.init_caches()
    traced("tiered-cache decode step (every tier)",
           lambda: dec._step(weights, empty, 1, 0, True))
    toks, _ = cs.markov_corpus(0, cfg.vocab, n_seq=cs.TF_TRAIN["batch"],
                               seq_len=cs.TF_TRAIN["seq_len"])
    batch = torch.from_numpy(toks).to(cs.DEV)
    leaves = cs.tree_leaves(weights)

    def forward_backward():
        for t in leaves:
            t.requires_grad_(True)
        loss = cs.early_exit_loss(weights, cfg, batch, cs.TF_DRAFT)
        torch.autograd.grad(loss, leaves)
        for t in leaves:
            t.requires_grad_(False)

    traced("train step, forward and backward (no Adam)", forward_backward)


def main() -> int:
    t0 = time.perf_counter()
    cs.phase_device()
    torch.cuda.reset_peak_memory_stats()
    if "profile" in sys.argv[1:]:
        profile_paths()
    else:
        cs.phase_transformer()
    cs.say("done", seconds=round(time.perf_counter() - t0, 1),
           peak_mem_gb=round(torch.cuda.max_memory_allocated() / 1e9, 2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
