"""The inputs a run makes from its seed: the same seed gives the same graph,
weights and drift draws, another seed others; the counts of the yardstick
against hand counts at tiny shapes."""

from __future__ import annotations

import pytest
import torch

from portbench import graphgen, roofline, weights

CPU = torch.device("cpu")
SEEDS = (0, 2**31 + 5, 123_456_789_012)


@pytest.mark.parametrize("seed", SEEDS)
def test_same_seed_same_inputs(seed):
    a = graphgen.cluster_graph(512, 16, 4, 128, seed, CPU)
    b = graphgen.cluster_graph(512, 16, 4, 128, seed, CPU)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert torch.equal(graphgen.drifted(a[0], 0.1, seed, 3), graphgen.drifted(b[0], 0.1, seed, 3))
    wa, wb = weights.gated_params(seed, 16, 4, 2, CPU), weights.gated_params(seed, 16, 4, 2, CPU)
    assert torch.equal(wa[1]["ffn_out"]["kernel"], wb[1]["ffn_out"]["kernel"])


def test_other_seed_or_step_other_inputs():
    a = graphgen.cluster_graph(512, 16, 4, 128, 1, CPU)
    b = graphgen.cluster_graph(512, 16, 4, 128, 2, CPU)
    assert not torch.equal(a[0], b[0])
    base = a[0]
    assert not torch.equal(graphgen.drifted(base, 0.1, 1, 0), graphgen.drifted(base, 0.1, 1, 1))
    assert not torch.equal(graphgen.drifted(base, 0.1, 1, 0), graphgen.drifted(base, 0.1, 2, 0))
    assert not torch.equal(weights.ruvector_params(1, 16, 16, CPU)["w_msg"]["kernel"],
                           weights.ruvector_params(2, 16, 16, CPU)["w_msg"]["kernel"])


def test_graph_is_the_exact_in_cluster_knn():
    feats, idx, ew = graphgen.cluster_graph(256, 8, 5, 128, 9, CPU)
    for i in (0, 127, 128, 255):
        c = i // 128
        members = torch.arange(c * 128, (c + 1) * 128)
        d = torch.linalg.vector_norm(feats[members] - feats[i], dim=1)
        d[i - c * 128] = float("inf")
        want = members[torch.argsort(d)[:5]]
        assert set(idx[i].tolist()) == set(want.tolist())
        assert torch.allclose(ew[i].sort().values,
                              (1.0 / (1.0 + d.sort().values[:5])).sort().values, atol=1e-5)
    # a drift step keeps the work of every step the same: not a running sum
    a = graphgen.drifted(feats, 0.1, 9, 5)
    assert float((a - feats).std()) == pytest.approx(0.1, rel=0.1)


def test_counts_against_hand_counts():
    n, b, d, h, f = 4 * 8, 8, 4, 2, 2
    # K4a: per row q and y projections (2 d d h each), scores and weighted
    # values (b d h each), the mix (b d) and W_gnn (d d), the FFN (2 f d d);
    # two operations a product
    per_row = h * (2 * d * d + 2 * b * d) + b * d + d * d + 2 * f * d * d
    assert roofline._gated_layer_ops(n, b, d, h, f) == 2 * n * per_row
    # the model's forward per node: 4 projections, scores and values over
    # the partition, the dense mix, W_gnn, the FFN's two products
    per_node = 4 * 2 * d * d + 2 * 2 * b * d + 2 * b * d + 2 * d * d + 2 * 2 * f * d * d
    assert roofline.gated_forward_ops(n, b, d, f, 3) == 3 * n * per_node
    assert roofline.gated_train_ops(n, b, d, f, 1) == 3 * n * per_node
    # the RuvectorLayer per node: msg, q, k, v, scores and values and the
    # weighted mean over m neighbours, out and W_agg, the GRU's six products
    m, di = 5, 3
    per_node = 2 * di * d + 3 * 2 * d * d + 3 * 2 * m * d + 2 * 2 * d * d + 6 * 2 * d * d
    assert roofline.ruvector_layer_ops(n, di, d, m) == n * per_node


def test_bounds_at_the_published_peaks():
    # bytes alone bound a copy-like shape; operations alone a product-heavy one
    assert roofline.bound_s(3.35e12, {}) == pytest.approx(1.0)
    assert roofline.bound_s(0, {"bf16": 989e12, "f64": 67e12}) == pytest.approx(2.0)
    # PERF.md's kernel table: K4a 1.16 ms, K4b 2.63, K5a 0.80, K5b 10.06,
    # K6c 1.47 at config 5's shape; K1 30.16 ms at 10M nodes
    assert roofline.k4a_bound_s(3906, 256, 128, 4, 4) == pytest.approx(1.16e-3, rel=0.01)
    assert roofline.k4b_bound_s(3906, 256, 128, 4, 4) == pytest.approx(2.63e-3, rel=0.01)
    assert roofline.k5a_bound_s(3906, 256, 128, 4) == pytest.approx(0.80e-3, rel=0.01)
    assert roofline.k5b_bound_s(3906, 256, 128, 4) == pytest.approx(10.06e-3, rel=0.01)
    assert roofline.k6c_bound_s(3906, 256, 128) == pytest.approx(1.47e-3, rel=0.01)
    assert roofline.k1_bound_s(39063, 256, 128, 4, 160_000_000) == pytest.approx(30.16e-3,
                                                                                  rel=0.01)


def test_k7_counts_logits_and_rounds():
    # K7 at the budget's 244 partitions: the logits' float64 products
    # (B x D into D x D, then B x D into B x B per partition) bound it; each
    # push-relabel round adds ~10 B^2 float32 operations
    k, b, d = 244, 256, 128
    logits = 2 * k * b * d * (b + d) / 67e12
    assert roofline.k7_bound_s(k, b, d) == pytest.approx(logits)
    assert roofline.k7_bound_s(k, b, d, rounds=40) == pytest.approx(logits + 10 * b * b * 40
                                                                    / 67e12)
