#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (ruvector_tpu_torch).

Builds the CUDA kernels from `ruvector_tpu_torch/csrc/`, holds each kernel
against its plain PyTorch version, then drives the port's paths on one
card:

  * the RuvectorLayer at the bench's headline width: a clustered
    100k-node, 128-d feature set (bench.py's data, seed 0), its k=16
    cosine kNN graph built on the card, graph-grown 512-node blocks, and
    the block-dense layer (d=128, 4 heads, bf16 compute) as the fused
    kernel, applied a few times to its own output. The other kernel
    routes (block-dense attention, slot neighbor-mix) and the 2-layer
    RuvectorNet run on the same graph.
  * the GNN model family and the attention family on the same graph and
    features (`[gnn_family]`, no kernel): the 2-layer GraphSAGE of
    BASELINE config 2 (fanouts (10, 10)) and the GAT layer of config 3,
    a GCN layer, message passing, each per-node attention mechanism
    through the registry, local-global and sheaf attention as sequences,
    and three trainable Adam steps, each card output against the same
    function on the CPU.
  * the rest of the attention family (`[attention_rest]`, no kernel) on
    the same graph: dual-space, mixed-curvature, Lorentz-cascade,
    coherence-gated and mixture-of-experts attention per node, the ten
    SDK presets, the min-cut gate over the 390 consecutive 256-node
    sequences (its masks against the host Dinic) and the coherence-gated
    transformer over 8192 nodes, each against the CPU.
  * the solvers (`[solver]`, no kernel) on an SPD system built from the
    same graph (A = 0.05 L_w + I, symmetrised): CG with and without its
    preconditioner, Jacobi, the Neumann series, push, power and
    random-walk PageRank, the sketched TRUE solve, the orchestrator's
    routing, and BMSSP's V-cycles on tests/test_solver_quant.py's grid,
    each against the CPU.
  * the rest of the graph transformers (`[graph_transformer_rest]`, no
    kernel) on the same graph at d=128: the 2-layer graph transformer
    block, LSH and PPR-sampled attention, the Hamiltonian net and the
    conservative PDE, spiking attention, STDP and Oja, the morphogenetic
    field, growth and coarsening, Ollivier-Ricci routing, geodesic
    message passing and Riemannian Adam, causal attention and Granger,
    Shapley, Nash and incentive attention, and verified training with its
    certificate, each against the CPU.
  * the min-cut-gated graph transformer's serving path (BASELINE config
    5, benchmarks/config5_r03.py): 999,936 nodes in clusters of 128 with
    exact within-cluster k=16 kNN made on the card, 256-node partitions
    (3906, halo-free), d=128, 4 heads, FFN x4, 2 layers, bf16 compute,
    random weights from seed 0. gate_state_init solves every gate; then
    steady steps (the same input: every gate reused) and drift steps
    (features moved by 0.1 N(0,1) each step: budget-capped re-solves).
  * config 5's train step on the same graph, weights and masks
    (config5_r03.py:204-226: the loss against zero targets under the
    state's masks, its gradient, then w - 1e-3 g; remat, bf16 compute),
    with the kernel route's gradients held against the plain route's on
    the first 244 partitions.
  * config 5's layers on a layout with a halo (120,000 nodes, 240-node
    partitions, B % 32 != 0): init, steady and drift steps and one train
    step, against the plain route.
  * the RuvectorLayer's contrastive train step (Adam) on the 100k-node
    graph.
  * serving (`[serve]`): the query engine over the same 100k-node corpus
    and graph with a 2-layer RuvectorLayer stack (d=128, 4 heads, f32, the
    K3 route), 32 requests in each of its four modes, and the flat index
    on the same queries.
  * the attention re-rank (`[rerank]`): `retrieve_and_rerank` over a
    1,000,000 x 128 corpus, 4 batches of 1024 queries at ef=256, which
    takes the K8 kernel.
  * vector quantization (`[quantization]`, no kernel) on the re-rank's
    1M x 128 corpus with 1024 queries: scalar int8, int4, PQ and binary
    codes with their distances, tiered compression at every level, the
    Q15 ops, and both temporal tiered stores, each against the CPU.
  * the CSR SpMM path (`[csr_spmm]`, after benchmarks/csr_spmm_bench.py):
    the padded SpMM, the K9 gather-fused SpMM on the whole graph and the
    CSR SpMM on a regular 99,840-node k=16 graph; the degree-bucketed,
    max-degree padded and CSR SpMM on a 50,000-node power-law graph.
  * SONA (`[sona]`, no kernel): MicroLoRA at 4096 wide, rank 2, then a
    SonaEngine (hidden 128) fed 4,096 trajectories of the 100k-node
    graph with its learning cycles, the adapters applied on the card,
    pattern retrieval, a federated average and an export round trip; the
    same stream on the CPU must leave the same host state, bit for bit.
  * the training utilities (`[training_utils]`) on the same graph: the
    three mining strategies for 1,024 anchors against all 100k nodes, the
    spectral regularizer, the training metrics around the contrastive
    step, a training worker's jobs, the profiler around the fused K1
    layer (its region against the CUDA-event time), checkpoints of config
    5's parameters, and the cold tier: the features on disk streamed in
    hyperbatches of 4,096, the hotset and the mmap store.
  * the min-cut-gated transformer (`[transformer]`, no kernel) at
    benchmarks/spec_at_size.py's width (12 layers x 1024 hidden x 16
    heads, 152M parameters): early-exit training, greedy and speculative
    batched decoding, the gate's tier programs on the int8 route, the
    tiered KV cache through every tier and the subsystems, each against
    the CPU.
  * the port's native runtime (`[native]`): its g++ build, config 5's
    layout by the device fill and the Python route (equal),
    GraphSAGE's fanout draws and the min-cut gate by the native and the
    Python routes.
  * the vector database (`[index]`) on the 100k corpus: the serial HNSW
    build, 1,000 searches against the flat index's exact top-10, payload
    filters by both routes, the index's level-0 graph through `[serve]`'s
    K3 stack (K3's warp body at the index's widest list) and the
    hierarchical forward, BASELINE.md row 1's operating point, the
    hyperbolic index's pruned search against its exact one and a save/load
    round trip.
  * the property graph (`[graph_store]`): the 100k kNN graph with its
    1.6M edges, Cypher queries against the arrays' answers, writes and a
    rolled-back transaction, its CSR through the CSR SpMM and its padded
    lowering through the K3 stack.
  * the min-cut toolkit (`[mincut]`, host maintainers): the global
    maintainer at 500k nodes, the s-t one at 100k, the Python maintainer
    against the native one, local cuts on the bench graph's CSR on the
    card, and the expander, j-tree and sparsifier (CG on the card) on one
    cluster's neighbourhood, each against the CPU.
  * the front ends (`[front_ends]`, no kernel) over the 100k corpus: the
    HTTP server with `[index]`'s collection (256 searches, 64 of them
    filtered, against the collection's own search and the exact top-10),
    a second collection filled by 10 upserts of 1,000 and then the
    concurrent storm, scroll, point reads, DELETE and /sql; the MCP
    server's search, 10 train steps and its four query modes at gnn_depth
    2; the SQL engine with the corpus loaded by INSERT text and its exact
    kNN by every operator and under a WHERE, against the exact top-10 and
    a CPU engine; with FE_FULL_IN_MAIN, or run alone, also MCP's min-cut
    tool, the SQL HNSW route, GNN worker and fault controls, and the CLI
    in this process (lifecycle, mincut, `benchmark`).
  * the multichip dry run's sharded paths (`[parallel]`,
    __graft_entry__.py:44-190) as 4 rank processes on the one card (gloo,
    collectives staged through the host; four ranks on one card measure
    correctness and the staging cost, not scaling): the halo-sharded
    2-layer RuvectorNet on the 100k-node graph (forward, overlap forward,
    an Adam step), a TP layer, an expert-parallel MoE, a 4-stage pipeline
    and ring attention at the transformer's width, the scatter-gather
    search over the re-rank's 1M-row corpus, and config 5 sharded over its
    3906 blocks (loss and gradient, gate state, a drifted step under the
    global re-solve budget, the masked gradient; K4a, K4b, K5a, K5b, K6c
    and K7 on every rank), each against the same computation in one
    process; then the forward at world 1 on NCCL.

Prints one line per phase, the card's name and power limit, a `kernels`
JSON line (launches on the main paths, error against the plain version,
times on the card, the least time the card could take), and as the last
line `{"ok": true, "device": {...}}`. Any failed phase exits non-zero
before that line; so does a run without a CUDA card or without the
package beside this script.

    python3 chip_smoke.py
    python3 chip_smoke.py solver graph_transformer_rest    (those phases alone)
    python3 chip_smoke.py sona training_utils              (those phases alone)
    python3 chip_smoke.py native index graph_store mincut  (those phases alone)
    python3 chip_smoke.py parallel                         (that phase alone)
    python3 chip_smoke.py front_ends                       (that phase alone)
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import hashlib
import io
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import types
import urllib.error
import urllib.request
from unittest import mock

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from ruvector_tpu_torch.attention import (  # noqa: E402
    PRESETS,
    CgtConfig,
    EarlyExitConfig,
    EdgeFeaturedConfig,
    LinearAttentionConfig,
    MoEAttentionConfig,
    SparseResidualConfig,
    TokenRouterConfig,
    TrainableAttention,
    cgt_forward,
    cgt_init,
    dynamic_min_cut,
    flash_attention,
    get_attention,
    lane_statistics,
    preset,
    residual_sparse_mask,
    route_by_energy,
)
from ruvector_tpu_torch.attention.cgt import early_exit_result, sparsity_statistics  # noqa: E402
from ruvector_tpu_torch.attention.rope import rope_rotate  # noqa: E402
from ruvector_tpu_torch.attention.dual_space import DualSpaceConfig  # noqa: E402
from ruvector_tpu_torch.attention.info_bottleneck import IBConfig  # noqa: E402
from ruvector_tpu_torch.attention.mincut_device import (  # noqa: E402
    attn_mincut_device_batched,
    mincut_gate_stats,
)
from ruvector_tpu_torch.attention.mixed_curvature import (  # noqa: E402
    MixedCurvatureConfig,
    lorentz_cascade_attention,
)
from ruvector_tpu_torch.attention.pde import DiffusionConfig  # noqa: E402
from ruvector_tpu_torch.attention.sheaf import SheafAttentionConfig, edge_energies  # noqa: E402
from ruvector_tpu_torch.attention.topology import (  # noqa: E402
    TopologyConfig,
    coherence_gated_attention,
)
from ruvector_tpu_torch.attention.transport import TransportConfig  # noqa: E402
from ruvector_tpu_torch.graph import (  # noqa: E402
    CSRGraph,
    NeighborGraph,
    PropertyGraph,
    build_block_dense,
    build_knn_graph,
    execute_cypher,
)
from ruvector_tpu_torch.attention.hyperbolic import poincare_distance  # noqa: E402
from ruvector_tpu_torch.graph_transformer import (  # noqa: E402
    BiologicalConfig,
    CurvatureAdaptiveRouter,
    DevelopmentalProgram,
    EnergyGateInvariant,
    GraphCoarsener,
    GraphTransformerConfig,
    HamiltonianGraphNet,
    IncentiveState,
    LipschitzBound,
    LossStabilityBound,
    MorphogeneticField,
    PhysicsConfig,
    SpikingGraphAttention,
    SublinearConfig,
    VerifiedTrainer,
    WeightNormBound,
    conservative_pde_attention,
    estimate_ollivier_ricci,
    gated,
    geodesic_message_passing,
    granger_causality,
    graph_transformer_apply,
    graph_transformer_init,
    hamiltonian,
    hebbian_update,
    incentive_aligned_step,
    k_winners_take_all,
    lsh_bucket_assignments,
    lsh_bucket_attention,
    nash_attention,
    ppr_sampled_attention,
    riemannian_adam_init,
    riemannian_adam_update,
    shapley_attention,
    stdp_update,
    temporal_attention,
    verify_causal_ordering,
)
from ruvector_tpu_torch.graph_transformer.economic import (  # noqa: E402
    _coalition_value as eco_coalition_value,
    shapley_permutations,
)
from ruvector_tpu_torch.graph_transformer.sublinear import lsh_planes  # noqa: E402
from ruvector_tpu_torch.graph_transformer.verified import sorted_leaves  # noqa: E402
from ruvector_tpu_torch import native  # noqa: E402
from ruvector_tpu_torch.index import (  # noqa: E402
    DbOptions,
    FlatIndex,
    HnswConfig,
    HnswIndex,
    HyperbolicIndex,
    VectorDB,
)
from ruvector_tpu_torch.index.filter import candidate_ids, parse_qdrant_filter  # noqa: E402
from ruvector_tpu_torch.index.hyperbolic_hnsw import HyperbolicConfig  # noqa: E402
from ruvector_tpu_torch.mincut import (  # noqa: E402
    DynamicMinCut,
    JTree,
    cut_value,
    expander_decompose,
    local_cluster,
    local_k_cut,
    spectral_sparsify,
)
from ruvector_tpu_torch.mincut.sparsify import effective_resistances  # noqa: E402
from ruvector_tpu_torch.models import (  # noqa: E402
    GATConfig,
    GCNConfig,
    GraphSAGENetConfig,
    RuvectorNetConfig,
    gat_apply,
    gat_init,
    gcn_apply,
    gcn_init,
    graphsage_apply,
    graphsage_net_apply,
    graphsage_net_init,
    ruvector_net_apply,
    ruvector_net_init,
    sample_fanout,
)
from ruvector_tpu_torch.models.message_passing import propagate  # noqa: E402
from ruvector_tpu_torch.nn.block_dense_layer import (  # noqa: E402
    fold_layer_params,
    ruvector_layer_apply_block_dense,
    ruvector_layer_apply_block_dense_fused,
)
from ruvector_tpu_torch.nn.core import linear_apply  # noqa: E402
from ruvector_tpu_torch.nn.ruvector_layer import (  # noqa: E402
    RuvectorLayerConfig,
    ruvector_layer_apply,
    ruvector_layer_init,
)
from ruvector_tpu_torch.ops import kernels, temporal_tensor, temporal_tiers  # noqa: E402
from ruvector_tpu_torch.ops.compress import TensorCompress  # noqa: E402
from ruvector_tpu_torch.ops.distance import pairwise_cosine  # noqa: E402
from ruvector_tpu_torch.ops.kernels import _lib  # noqa: E402
from ruvector_tpu_torch.ops.kernels.block_dense_attn import (  # noqa: E402
    block_dense_attention,
    block_dense_attention_reference,
    block_dense_layer_fused,
    block_dense_layer_fused_reference,
    k1_body,
    k2_body,
)
from ruvector_tpu_torch.ops.kernels.flash_neighbor import (  # noqa: E402
    flash_neighbor_attention,
    flash_neighbor_attention_reference,
    k8_body,
)
from ruvector_tpu_torch.ops.kernels.gated_block_attn import (  # noqa: E402
    as_cdt,
    block_gate_signature,
    block_gate_signature_ln_x,
    block_gate_signature_ln_x_reference,
    block_gate_signature_reference,
    block_gate_signature_x,
    block_gate_signature_x_reference,
    fold_gated_attention_params,
    gated_block_attention_bwd,
    gated_block_attention_bwd_partials,
    gated_block_attention_bwd_reference,
    gated_block_attention_fwd,
    gated_block_attention_fwd_reference,
    head_concat,
    layer_norm_rows,
    matmul_f64,
    mha_body,
    pack_keep,
    reduce_partials,
    sig_body,
    unpack_keep,
)
from ruvector_tpu_torch.ops.kernels.gated_block_layer import (  # noqa: E402
    fold_gated_layer_params,
    gated_block_layer,
    gated_block_layer_reference,
    gated_block_layer_with_sig,
    gated_block_layer_with_sig_reference,
)
from ruvector_tpu_torch.ops.kernels.mincut_gate_block import (  # noqa: E402
    gate_body,
    gate_from_logits,
    isolated_sink,
    mincut_gate_block_from_x,
    mincut_gate_block_from_x_reference,
    two_hop_sink,
)
from ruvector_tpu_torch.ops.kernels.neighbor_mix import (  # noqa: E402
    fused_neighbor_mix,
    fused_neighbor_mix_reference,
    k3_body,
)
from ruvector_tpu_torch.ops.kernels.spmm import (  # noqa: E402
    spmm_gather,
    spmm_gather_reference,
    staged_tiles,
)
from ruvector_tpu_torch.ops.q15 import (  # noqa: E402
    f32_to_q15,
    q15_add,
    q15_dot,
    q15_lerp,
    q15_matmul,
    q15_mul,
    q15_to_f32,
)
from ruvector_tpu_torch.ops.quantization import (  # noqa: E402
    BinaryQuantized,
    PQCodebook,
    ScalarQuantized,
    binary_quantize,
    binary_similarity,
    hamming_distance,
    int4_dequantize,
    int4_quantize,
    pq_decode,
    pq_distance,
    pq_encode,
    pq_train,
    scalar_dequantize,
    scalar_distance,
    scalar_quantize,
    squared_distances,
)
from ruvector_tpu_torch.ops.segment import (  # noqa: E402
    masked_softmax,
    normalized_weights,
    spmm_csr,
    spmm_padded,
)
from ruvector_tpu_torch.ops.spmm_bucketed import build_bucket_plan, spmm_bucketed  # noqa: E402
from ruvector_tpu_torch.graph.block_dense import BlockDenseGraph  # noqa: E402
from ruvector_tpu_torch.parallel import (  # noqa: E402
    EpConfig,
    GatedShard,
    TpLayerConfig,
    build_halo_plan,
    build_overlap_plan,
    ep_init,
    make_blocked_layer_forward,
    make_blocked_train_step,
    make_ep_forward,
    make_overlap_layer_forward,
    make_pp_forward,
    make_ring_attention,
    make_sharded_layer_forward,
    make_sharded_train_step,
    make_tp_layer_forward,
    pad_features_for_plan,
    reference_attention,
    reference_ep_forward,
    reference_pp_forward,
    reference_tp_layer_forward,
    run_ranks,
    sharded_gate_state_init,
    sharded_step,
    sharded_value_and_grad,
    tp_layer_init,
)
from ruvector_tpu_torch.parallel.gated import block_ranges, slice_block_dense  # noqa: E402
from ruvector_tpu_torch.parallel.mesh import rank_devices  # noqa: E402
from ruvector_tpu_torch.parallel.ordering import graph_grow_blocks  # noqa: E402
from ruvector_tpu_torch.serve import (  # noqa: E402
    QueryEngine,
    QueryMode,
    RuvectorQuery,
    attention_rerank,
    hierarchical_forward,
    retrieve_and_rerank,
)
from ruvector_tpu_torch.solver import (  # noqa: E402
    BmsspSolver,
    SolverOrchestrator,
    TrueSolver,
    backward_push_ppr,
    cg_solve,
    estimate_spectral_radius,
    forward_push_ppr,
    jacobi_solve,
    neumann_solve,
    ppr_power_iteration,
    random_walk_ppr,
)
from ruvector_tpu_torch.solver import bmssp as sv_bmssp  # noqa: E402
from ruvector_tpu_torch.solver import push as sv_push  # noqa: E402
from ruvector_tpu_torch.serve.distributed import make_distributed_search  # noqa: E402
from ruvector_tpu_torch.serve import sql as sql_mod  # noqa: E402
from ruvector_tpu_torch.serve.mcp import McpServer  # noqa: E402
from ruvector_tpu_torch.serve.server import RuvectorServer  # noqa: E402
from ruvector_tpu_torch.serve.sql import SqlEngine, SqlError  # noqa: E402
from ruvector_tpu_torch.__main__ import main as cli_main  # noqa: E402
from ruvector_tpu_torch.serve.rerank import (  # noqa: E402
    rerank_scores,
    retrieve_candidates,
)
from ruvector_tpu_torch.sona import SonaConfig, SonaEngine  # noqa: E402
from ruvector_tpu_torch.sona.export import export_lora, import_lora  # noqa: E402
from ruvector_tpu_torch.sona.federated import FederatedAggregator  # noqa: E402
from ruvector_tpu_torch.sona.lora import MicroLoRA, lora_forward  # noqa: E402
from ruvector_tpu_torch.sona.types import LearningSignal  # noqa: E402
from ruvector_tpu_torch.training import (  # noqa: E402
    TrainConfig,
    TrainingMetrics,
    adam,
    batched_info_nce,
    make_train_step,
    sample_negatives,
    train_epoch,
)
from ruvector_tpu_torch.training.mining import (  # noqa: E402
    MiningConfig,
    in_batch_negatives,
    mine_negatives,
    spectral_regularizer,
)
from ruvector_tpu_torch.training.worker import GnnTrainingWorker, JobStatus  # noqa: E402
from ruvector_tpu_torch.training.optimizers import tree_leaves, tree_map  # noqa: E402
from ruvector_tpu_torch.transformer import (  # noqa: E402
    Decoder,
    GatePacket,
    GatePolicy,
    KVCacheConfig,
    KVCacheState,
    MincutGatedTransformer,
    SpecDecodeConfig,
    SpikePacket,
    TransformerConfig,
    init_weights,
    int8_matmul,
    kv_cache_append,
    kv_cache_init,
    kv_cache_read,
    make_batched_generate_fn,
    make_decode_step,
    make_speculative_generate_fn,
)
from ruvector_tpu_torch.transformer import decode as tf_decode  # noqa: E402
from ruvector_tpu_torch.transformer import model as tf_model  # noqa: E402
from ruvector_tpu_torch.transformer import spec_decode as tf_spec  # noqa: E402
from ruvector_tpu_torch.transformer.kv_quantizers import (  # noqa: E402
    SQuatBasis,
    kvquant_dequantize_keys,
    kvquant_quantize_keys,
    kvquant_quantize_values,
    squat_dequantize,
    squat_learn_basis,
    squat_quantize,
)
from ruvector_tpu_torch.transformer.mamba import (  # noqa: E402
    MambaConfig,
    mamba_forward_sequence,
    mamba_init,
)
from ruvector_tpu_torch.transformer.mod_routing import ModRoutingConfig  # noqa: E402
from ruvector_tpu_torch.transformer.quant import int8_sums, quantize_activation_int8  # noqa: E402
from ruvector_tpu_torch.transformer.sparse_attention import SparsityConfig  # noqa: E402
from ruvector_tpu_torch.transformer.spectral import (  # noqa: E402
    SpectralPositionEncoder,
    laplacian_from_edges,
    power_iteration,
    power_iteration_sparse,
)
from ruvector_tpu_torch.transformer.spike_attention import (  # noqa: E402
    SpikeDrivenConfig,
    encode_rate,
    spike_driven_attention,
)
from ruvector_tpu_torch.transformer.train_spec import (  # noqa: E402
    early_exit_loss,
    markov_corpus,
    seq_logits_at_depths,
    train_early_exit,
)
from ruvector_tpu_torch.utils.checkpoint import (  # noqa: E402
    AsyncShardedCheckpointer,
    restore_checkpoint,
    save_checkpoint,
)
from ruvector_tpu_torch.utils.cold_tier import (  # noqa: E402
    AdaptiveHotset,
    ColdTierTrainer,
    FeatureStorage,
    HyperbatchConfig,
)
from ruvector_tpu_torch.utils.mmap_store import MmapEmbeddingStore  # noqa: E402
from ruvector_tpu_torch.utils.profiler import Profiler  # noqa: E402

DEV = torch.device("cuda")
REPO_DIR = os.path.dirname(os.path.abspath(__file__))
N_NODES = 100_000   # bench.py's headline graph
ITERS = 3           # layer applications on the main path, each on its own output
# H100 SXM published peaks (NVIDIA data sheet; dense, at the 700 W limit)
PEAK_BYTES_PER_S = 3.35e12
# "tf32x3": float32-grade products on the tensor cores as three TF32
# passes (495 TFLOP/s / 3), the least time this card needs for the float32
# products of a kernel that runs them there (K5b's and K1's tensor-core
# bodies). "f64": float64 sums on the float64 tensor cores (67 TFLOP/s),
# the rate of the gate logits, whose products must be exact and whose sums
# float64 (K6a, K6b, K6c, K4b's signature, K7): bf16 tensor cores with
# float32 sums cannot give the plain version's bits
PEAK_OPS_PER_S = {torch.bfloat16: 989e12, torch.float32: 67e12, "tf32x3": 495e12 / 3,
                  "f64": 67e12}
# tolerances against the plain versions on the same inputs. f32: sums of
# up to T=1024 products in another order, on outputs of order 1.
# bf16: the kernels round the softmax weights relative to a running max
# (online softmax over streamed chunks) where the plain version rounds
# them relative to the row max; a weight of relative size 2^-9 may round
# the other way, so outputs of order 1 move by up to a few 1e-3.
TOL = {torch.float32: (1e-4, 1e-5), torch.bfloat16: (5e-2, 5e-3)}   # (max, mean)
# K5b in bf16 compute against its plain version, relative to each
# gradient's scale: both sides round the recompute of q, y and s alike and
# take float32 products in the backward proper, so what is left is the
# order of the sums and the tensor cores' float32 emulation (3xTF32). The
# mean's limit lies between the 3xTF32 body's readings (at most 5.5e-6)
# and single-pass TF32's (at least 4.8e-5, the "one_tf32" control); the
# max, set by rare bf16 roundings of q that flip, tells the two apart less
# well (up to 3.9e-4 against 5.6e-4). PERF.md section 6.
TOL_F32_GRADE = (2e-3, 2e-5)
SOURCES = {
    "block_dense_layer_fused": ("ruvector_tpu_torch/csrc/block_dense_attn.cu",
                                "ruvector_tpu/ops/pallas/block_dense_attn.py:246"),
    "block_dense_attention": ("ruvector_tpu_torch/csrc/block_dense_attn.cu",
                              "ruvector_tpu/ops/pallas/block_dense_attn.py:81"),
    "fused_neighbor_mix": ("ruvector_tpu_torch/csrc/neighbor_mix.cu",
                           "ruvector_tpu/ops/pallas/neighbor_mix.py:68"),
    "gated_block_layer": ("ruvector_tpu_torch/csrc/gated_block_layer.cu",
                          "ruvector_tpu/ops/pallas/gated_block_layer.py:195"),
    "gated_block_layer_with_sig": ("ruvector_tpu_torch/csrc/gated_block_layer.cu",
                                   "ruvector_tpu/ops/pallas/gated_block_layer.py:251"),
    "block_gate_signature_ln_x": ("ruvector_tpu_torch/csrc/gated_block_attn.cu",
                                  "ruvector_tpu/ops/pallas/gated_block_attn.py:487"),
    "mincut_gate_block_from_x": ("ruvector_tpu_torch/csrc/mincut_gate_block.cu",
                                 "ruvector_tpu/ops/pallas/mincut_gate_block.py:234"),
    "gated_block_attention_fwd": ("ruvector_tpu_torch/csrc/gated_block_mha.cu",
                                  "ruvector_tpu/ops/pallas/gated_block_attn.py:119"),
    "gated_block_attention_bwd": ("ruvector_tpu_torch/csrc/gated_block_mha.cu",
                                  "ruvector_tpu/ops/pallas/gated_block_attn.py:239"),
    "block_gate_signature_x": ("ruvector_tpu_torch/csrc/gated_block_attn.cu",
                               "ruvector_tpu/ops/pallas/gated_block_attn.py:423"),
    "block_gate_signature": ("ruvector_tpu_torch/csrc/gated_block_attn.cu",
                             "ruvector_tpu/ops/pallas/gated_block_attn.py:362"),
    "flash_neighbor_attention": ("ruvector_tpu_torch/csrc/flash_neighbor.cu",
                                 "ruvector_tpu/ops/pallas/flash_neighbor.py:69"),
    "spmm_gather": ("ruvector_tpu_torch/csrc/spmm_gather.cu",
                    "ruvector_tpu/ops/pallas/spmm.py:34"),
}
# K1's ptxas report (registers, spill stores, spill loads) by instance, as
# the tensor-core body (variants 1 and 2: test-only faults) and the
# float32 body built before K2 shared their table passes
K1_PTXAS = {
    "tc_fused_kernelILi32ELi0EE": (172, 0, 0),
    "tc_fused_kernelILi64ELi0EE": (186, 0, 0),
    "tc_fused_kernelILi128ELi0EE": (255, 8, 8),
    "tc_fused_kernelILi128ELi1EE": (255, 32, 56),
    "tc_fused_kernelILi128ELi2EE": (255, 8, 8),
    "fused_layer_kernelIfLi128ELi8EE": (254, 0, 0),
    "fused_layer_kernelIfLi128ELi4EE": (140, 0, 0),
    "fused_layer_kernelIfLi128ELi2EE": (86, 0, 0),
    "fused_layer_kernelIfLi128ELi1EE": (64, 0, 0),
    "fused_layer_kernelIfLi64ELi8EE": (204, 0, 0),
    "fused_layer_kernelIfLi64ELi4EE": (128, 20, 20),
    "fused_layer_kernelIfLi64ELi2EE": (72, 0, 0),
    "fused_layer_kernelIfLi64ELi1EE": (58, 0, 0),
    "fused_layer_kernelIfLi32ELi8EE": (204, 0, 0),
    "fused_layer_kernelIfLi32ELi4EE": (142, 0, 0),
    "fused_layer_kernelIfLi32ELi2EE": (64, 0, 0),
    "fused_layer_kernelIfLi32ELi1EE": (58, 0, 0),
}
# kernels that no path of the JAX package reaches (shown, with launches 0)
OFF_PATH = {"block_gate_signature": "no caller in the JAX package (gated.py:291 is unused)"}
# config 5 (benchmarks/config5_r03.py, CONFIG5_BENCH_r05.json): clusters of
# 128 (benchmarks/scale_sweep_r02.py), 256-node partitions, k=16
C5_NODES, C5_CLUSTER, C5_BLOCK, C5_K = 999_936, 128, 256, 16
C5_KERNELS = ("gated_block_layer", "gated_block_layer_with_sig", "block_gate_signature_ln_x",
              "mincut_gate_block_from_x")
C5_STEPS = 5        # steady steps, then as many drift steps
C5_DRIFT = 0.1      # drift step: features += C5_DRIFT * N(0, 1)
# one layer of the kernel route (every product on bf16 operands, float32
# sums) against the plain sublayer composition under the same masks
# (float32 except bf16 Q/K/V and softmax weights): each bf16 operand is
# off by up to 2^-9 relative, and a layer chains about seven products
# into outputs of order 1-5, so a few 1e-2 at most and 1e-3 on average
C5_ROUTE_TOL = (5e-2, 5e-3)
# config 5's train step (benchmarks/config5_r03.py:204-226): timed steps,
# the SGD rate, and the partitions of the gradient check (the budget's
# count; the layout is halo-free, so a slice of partitions is its own graph)
C5_TRAIN_STEPS, C5_TRAIN_LR, C5_GRAD_PARTS = 4, 1e-3, 244
# config 5's layers on a layout with a halo: clusters of 120, two per
# 240-node partition (B % 32 = 16), k=16 of which 14 within the cluster
H_NODES, H_CLUSTER, H_BLOCK, H_K, H_K_IN = 120_000, 120, 240, 16, 14
H_STEPS = 2         # steady steps, then as many drift steps
CONTRASTIVE_STEPS = 3
# serving: requests per query mode, k and ef (the JAX defaults), query noise
SERVE_PER_MODE, SERVE_K, SERVE_EF, SERVE_NOISE = 32, 10, 50, 0.05
# the re-rank at the README's scale: corpus rows, batches of queries, ef
# (retrieve_and_rerank's default, K8's threshold), k, query noise
RR_NODES, RR_BATCHES, RR_BATCH, RR_EF, RR_K, RR_NOISE = 1_000_000, 4, 1024, 256, 10, 0.1
# benchmarks/csr_spmm_bench.py's graphs: regular (clusters of 128, k=16),
# the gather kernel's 12,288-row slice there, and the power-law graph
CSR_NODES, CSR_K, K9_SLICE, PL_NODES = 99_840, 16, 12_288, 50_000
# K8 against its plain version: (B, M, D, masked) at the re-rank's shape,
# at benchmarks/suite.py:174's shape with a random mask, and ragged
K8_PARITY = ((1024, 256, 128, False), (1024, 512, 128, True), (1000, 300, 64, True))
# the GNN model family on the main graph: BASELINE config 2 (benchmarks/
# suite.py:151-165: 2-layer GraphSAGE, fanouts (10, 10), d=128) and config
# 3 (a GAT layer); the per-node attention forms checked on their first
# GNN_ROWS rows, the sequence forms at their lengths; the trainable step's
# batch of nodes
GNN_FANOUTS, GNN_ROWS, GNN_LG_S, GNN_SHEAF_S = (10, 10), 8192, 4096, 8192
GNN_TRAIN_BATCH, GNN_TRAIN_STEPS = 4096, 3
# the min-cut gate over the features' consecutive sequences: length, eps,
# the sequences held against the host Dinic, the largest lam tried
MC_SEQ, MC_EPS, MC_HOST, MC_LAM_MAX = 256, 0.01, 8, 1024.0
# the solvers on the 100k-node graph (`[solver]`): the SPD system A = L_w +
# I of the symmetrised kNN graph with its weights times SV_WEIGHT
# (diagonally dominant, as tests/test_solver_quant.py's dd_matrix; at 0.05
# the largest row sum, a hub's, is ~11, so A over it has rho(I - A) ~0.91,
# under the router's 0.95 for the Neumann series), the residual at which the
# iterations stop (float32: a residual of 1e-3 over 316 = ||b||), their
# cap, the push's eps and sweeps, the random walks, and BMSSP's grid side
# (tests/test_solver_quant.py:246's system; on the kNN graph the
# aggregation finds no strong connection, so the coarsest level would be
# the whole graph as one dense solve)
SV_WEIGHT, SV_TOL, SV_MAX_ITERS, SV_PUSH_EPS, SV_SWEEPS = 0.05, 1e-3, 1000, 1e-6, 100
SV_WALKS, SV_WALK_LEN, SV_GRID, SV_AMG_CYCLES = 100_000, 50, 20, 100
# a solve's x on the card against the CPU's: both stop at a residual of
# SV_TOL, and a run one iteration longer moves x by less than that
SV_X_TOL = (SV_TOL, 1e-4)
# the rest of the graph transformers on the same graph (`[graph_transformer_rest]`):
# the rows of the graph-local subgraph (the first GT_ROWS nodes of the
# main path's block order, for the O(N^2) forms: Ollivier-Ricci and the
# verified trainer's loss) and of LSH attention, the PPR queries and how
# many of them the CPU repeats, the temporal sequence, Shapley's nodes
# and permutations, Nash's nodes, the steps of the leapfrog, the spiking
# net, the morphogenetic field and the verified trainer
GT_ROWS, GT_QUERIES, GT_CPU_QUERIES, GT_SEQ = 8192, 64, 4, 4096
GT_SHAPLEY_N, GT_SHAPLEY_P, GT_NASH_N = 64, 32, 1024
GT_LEAPFROG, GT_SPIKE_STEPS, GT_MORPH_STEPS, GT_TRAIN_STEPS = 10, 8, 50, 3
# vector quantization on the re-rank's corpus: queries; PQ (training rows,
# subvectors, centroids, iterations, the rows of the card-vs-CPU codebook
# check); Q15 matmul [M, K] x [K, M]; the temporal stores' chunks of
# QZ_CHUNK x d, the hot chunks and their read rounds
QZ_QUERIES = 1024
QZ_PQ_TRAIN, QZ_PQ_SUB, QZ_PQ_K, QZ_PQ_ITERS, QZ_PQ_CHECK = 65_536, 8, 256, 10, 4096
QZ_Q15_M, QZ_Q15_K = 4096, 128
QZ_CHUNKS, QZ_CHUNK, QZ_HOT, QZ_HAMMER = 1024, 128, 64, 64
# the min-cut-gated transformer at benchmarks/spec_at_size.py:59-70's width
# (152,205,824 parameters, nothing cut): its config, the draft depth,
# gamma, the batch of prompts, prompt length and new tokens, the training
# run, the hot-only serving cache, the tier programs' prompt, how far past
# hot + warm + archive the tiered cache decodes (its archive ring wraps),
# Mamba's steps, and the int8 route's limit against the CPU
# (test_int8_matmul_accuracy's bound, tests/test_transformer.py:139-147)
TF_CFG = dict(seq_len_max=512, hidden=1024, heads=16, layers=12, vocab=512, logits=512,
              layers_degraded=2, seq_len_degraded=64, seq_len_safe=32)
TF_DRAFT, TF_GAMMA, TF_BATCH, TF_PROMPT, TF_NEW = 2, 6, 4, 9, 128
TF_TRAIN = dict(steps=250, batch=16, seq_len=48, lr=1e-3, seed=0)
TF_HOT, TF_TIER_TOKENS, TF_CACHE_EXTRA, TF_MAMBA_STEPS = 256, 512, 16, 512
TF_INT8_TOL = 5e-2
# the f32 route's logits against the CPU's, relative to their scale: ten
# times inside the f32 limits (1e-4, 1e-5). The trained model's logits
# read 5.2e-7 max and 4.4e-8 mean on an H100 at 700 W (PERF.md section 6); the
# exact-erf GELU moves them by 1.75e-4, under twice the f32 limit, and
# this limit rejects it with room to spare
TF_F32_TOL = (1e-5, 1e-6)
# SONA (`[sona]`): MicroLoRA at benchmarks/suite.py:374-390's shapes (4096
# wide, rank 2, one query and a batch of 256); the engine at
# benchmarks/learned_recall_curve.py:139-141's settings (hidden = embedding
# = 128, flush 64, quality 0.3) over the main path's graph: trajectories,
# a force_learn every SN_LEARN_EVERY of them, the rows of apply_micro_lora,
# the trajectories of the second engine of the federated average
SN_WIDE, SN_RANK, SN_BATCH = 4096, 2, 256
SN_FLUSH, SN_QUALITY = 64, 0.3
SN_TRAJ, SN_LEARN_EVERY, SN_APPLY_ROWS, SN_PEER_TRAJ = 4096, 1024, 1024, 1024
# the training utilities on the same graph (`[training_utils]`): mined
# anchors (a [1024, 100k] score matrix) and negatives each; the in-batch
# batch; the contrastive steps timed by TrainingMetrics; the batch of the
# worker's one-epoch job; the profiled K1 layer calls; the cold tier's
# hyperbatch, the hotset's capacity and accesses, the mmap store's dirty rows
TU_ANCHORS, TU_NEGATIVES, TU_IN_BATCH = 1024, 16, 1024
# the native runtime (`[native]`): GraphSAGE's fanout, and the sequences of
# the min-cut gate that the Python Dinic also cuts at each lam (half the
# first ones, half the first the native gate cut; 0.2 s a sequence on the
# host: all 390 at two lams would take ~160 s)
NT_FANOUT, NT_PY_SEQS = 10, 16
# the vector database (`[index]`) over the main path's corpus: queries, k,
# query noise, the queries of the filtered and the hierarchical searches,
# BASELINE.md row 1's corpus (rows, width, centres, queries:
# benchmarks/hnsw_parity.py's clustered set), the hyperbolic queries, those
# of them the CPU repeats when `[index]` runs alone, and the radius the
# features are scaled to
IX_QUERIES, IX_K, IX_NOISE, IX_FILTER_QUERIES, IX_HIER_QUERIES = 1000, 10, 0.05, 32, 8
IX_BASE_N, IX_BASE_D, IX_BASE_CENTERS, IX_BASE_Q = 10_000, 384, 100, 1000
IX_HYPER_QUERIES, IX_HYPER_CPU, IX_HYPER_RADIUS = 256, 64, 0.9
# the min-cut toolkit (`[mincut]`): GLOBAL_MINCUT_SCALE_r05.json's 500k cell
# (clusters, cluster size, seed; benchmarks/global_mincut_scale_r04.py) and
# the updates streamed with a query after each; MINCUT_SCALE_r02.json's
# 100k-node s-t row with all 2,000 of its updates on the native class, as
# benchmarks/mincut_scale.py runs it, and the first MC_ST_FACADE through
# DynamicMinCut (its query also lists the cut's edges, 55-85 ms on the
# card's host); the 20k cell (400 x 50, seed 0) whose first
# updates the Python maintainer repeats (~0.2 s an update on the host:
# 2,000 would take ~400 s); the local cuts' seed and the neighbourhood of
# one cluster for the expander, the j-tree and the sparsifier
MC_GLOBAL_CL, MC_GLOBAL_SIZE, MC_GLOBAL_SEED, MC_GLOBAL_UPDATES = 10_000, 50, 1, 20_000
MC_ST_NODES, MC_ST_UPDATES, MC_ST_FACADE = 100_000, 2_000, 20
MC_PY_CL, MC_PY_SIZE, MC_PY_UPDATES = 400, 50, 50
MC_LOCAL_SEED, MC_SPARSIFY_EPS = 0, 0.5
TU_METRIC_STEPS, TU_WORKER_BATCH, TU_PROFILE_ITERS = 3, 8192, 10
TU_HYPERBATCH, TU_HOT_CAP, TU_HOT_ACCESSES, TU_MMAP_DIRTY = 4096, 1024, 20_000, 4096


# the multichip dry run's sharded paths (`[parallel]`, __graft_entry__.py:44-190)
# as rank processes on the one card: the ranks; part 1's Adam rate and
# negatives a node (the dry run's); part 2 at `[transformer]`'s width: a TP
# layer of 16 heads x 64 and FFN 4096 over 512 tokens, 4 experts 1024 ->
# 4096 over 2048 tokens, 4 pipeline stages of 1024 x 1024 with 8
# microbatches of 512 rows, ring attention over 8192 positions at d=64;
# part 3's queries and k; the sources the ranks' kernels come from; the
# kernels every rank must launch in part 4; the limits: the JAX tests' (2e-4
# for the halo forward, 2e-5 for TP, EP and PP, 3e-5 for the ring) and
# 1e-5 of scale for gradients
PAR_WORLD, PAR_LR, PAR_NEGS = 4, 1e-3, 4
PAR_TP = dict(hidden=1024, heads=16, head_dim=64, ffn=4096)
PAR_EP = dict(hidden=1024, ffn=4096, num_experts=4)
PAR_TP_TOKENS, PAR_EP_TOKENS, PAR_PP_MICRO, PAR_PP_ROWS, PAR_PP_D = 512, 2048, 8, 512, 1024
PAR_SP_SEQ, PAR_SP_D, PAR_SEARCH_Q, PAR_SEARCH_K = 8192, 64, 1024, 10
PAR_SOURCES = ("gated_block_layer", "gated_block_attn", "gated_block_mha", "mincut_gate_block")
PAR_C5_KERNELS = ("gated_block_layer", "gated_block_layer_with_sig", "block_gate_signature_ln_x",
                  "mincut_gate_block_from_x", "gated_block_attention_fwd",
                  "gated_block_attention_bwd")
PAR_HALO_TOL, PAR_TOL, PAR_RING_TOL, PAR_GRAD_TOL = 2e-4, 2e-5, 3e-5, 1e-5
# the front ends (`[front_ends]`) over the bench corpus at d=128: the HTTP
# server's searches of the 100k collection (the last ones filtered by
# cluster), the rows of the collection filled by upserts and of one upsert;
# the concurrent storm (tests/test_serve_extra.py's at the card's scale:
# writers x new points one a request, readers x searches each with a
# /metrics read); MCP's searches, train steps (the tool's default), queries
# a mode and at the second round, gnn_depth, the min-cut tool's k; SQL's
# rows an INSERT statement, exact kNN SELECTs by <-> and by each other
# operator, filtered SELECTs, the queries the CPU engine repeats, the
# indexed table's rows; the CLI's lifecycle rows; the recall floor
FE_SEARCHES, FE_FILTERED, FE_UPSERT_ROWS, FE_UPSERT_BATCH = 256, 64, 10_000, 1_000
FE_STORM_WRITERS, FE_STORM_POINTS, FE_STORM_READERS, FE_STORM_SEARCHES = 4, 250, 8, 64
FE_MCP_SEARCHES, FE_MCP_STEPS, FE_MCP_QUERIES, FE_MCP_AGAIN = 64, 10, 32, 8
FE_MCP_DEPTH, FE_MCP_CUT_K = 2, 8
FE_SQL_BATCH, FE_SQL_L2, FE_SQL_OTHER, FE_SQL_WHERE, FE_SQL_CPU = 5_000, 256, 64, 64, 64
FE_SQL_INDEX_ROWS, FE_CLI_ROWS, FE_RECALL_MIN = 10_000, 2_000, 0.95
# the whole phase in the main run; False keeps there only what reaches the
# card (HTTP search and the storm, MCP train and query, SQL's exact kNN)
# and leaves the CLI, the SQL HNSW route and worker, the fault controls and
# MCP's min-cut tool to the phase run alone
FE_FULL_IN_MAIN = False


def say(phase: str, **fields) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in fields.items()), flush=True)


def agree(name: str, got: torch.Tensor, want: torch.Tensor, dtype: torch.dtype,
          tol: tuple[float, float] | None = None) -> float:
    """Max abs error of got against want; raises beyond the tolerance
    (TOL[dtype] unless `tol` = (max, mean) is given)."""
    got, want = got.float(), want.float()
    if got.shape != want.shape or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{name}: shape {tuple(got.shape)} vs {tuple(want.shape)} "
                             f"or non-finite output")
    err = (got - want).abs()
    max_err, mean_err = float(err.max()), float(err.mean())
    tol_max, tol_mean = tol or TOL[dtype]
    ok = max_err <= tol_max and mean_err <= tol_mean
    say("agree", name=name, dtype=str(dtype).replace("torch.", ""), max_abs_err=max_err,
        mean_abs_err=mean_err, tol_max=tol_max, tol_mean=tol_mean, ok=ok)
    if not ok:
        raise AssertionError(f"{name}: disagrees with its reference")
    return max_err


def _agree_as(dtype: torch.dtype):
    """A report row's check: agree() with the tolerance of `dtype`."""
    return lambda name, got, want: agree(name, got, want, dtype)


def agree_scaled(name: str, got: torch.Tensor, want: torch.Tensor, dtype: torch.dtype,
                 tol: tuple[float, float] | None = None) -> float:
    """agree() on errors relative to want's largest magnitude (for
    gradients, whose scale varies by tensor): max and mean of |got - want|
    / max|want| within TOL[dtype] (or `tol`). Returns the max abs error."""
    got, want = got.float(), want.float()
    if got.shape != want.shape or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{name}: shape {tuple(got.shape)} vs {tuple(want.shape)} "
                             f"or non-finite output")
    scale = max(float(want.abs().max()), 1e-30)
    err = (got - want).abs()
    rel_max, rel_mean = float(err.max()) / scale, float(err.mean()) / scale
    tol_max, tol_mean = tol or TOL[dtype]
    ok = rel_max <= tol_max and rel_mean <= tol_mean
    say("agree", name=name, dtype=str(dtype).replace("torch.", ""), scale=scale,
        max_rel_err=rel_max, mean_rel_err=rel_mean, tol_max=tol_max, tol_mean=tol_mean, ok=ok)
    if not ok:
        raise AssertionError(f"{name}: disagrees with its reference")
    return float(err.max())


def agree_grads(name: str, got, want, dtype: torch.dtype,
                tol: tuple[float, float] | None = None) -> float:
    """K5b's (dx, dA_cat, dWvo_cat) against its plain version, each
    relative to its own scale (TOL[dtype] unless `tol` is given)."""
    return max(agree_scaled(f"{name} {part}", g, w, dtype, tol)
               for part, g, w in zip(("dx", "dA_cat", "dWvo_cat"), got, want))


def agree_rows(name: str, got, want) -> float:
    """Signature rows (rsum, rcnt) against the plain version's: the logits'
    products are summed in float64 on both sides (exact for bf16 products,
    within 2^-53 for f32 ones, rounded once), so the counts must be equal
    and the row sums (float64, rounded once) within 1e-6 relative. Returns
    the max abs error of rsum."""
    (rsum, rcnt), (wsum, wcnt) = got, want
    if rsum.shape != wsum.shape or not bool(torch.isfinite(rsum).all()):
        raise AssertionError(f"{name}: wrong shape or non-finite output")
    counts_equal = torch.equal(rcnt, wcnt)
    sums_close = bool(torch.allclose(rsum, wsum, rtol=1e-6, atol=0.0))
    say("agree", name=name, rows=rcnt.numel(), positive=int(wcnt.sum()),
        counts_equal=counts_equal, count_diffs=float((rcnt - wcnt).abs().sum()),
        sums_equal=torch.equal(rsum, wsum), sums_close=sums_close, sums_rtol=1e-6,
        ok=counts_equal and sums_close)
    if not (counts_equal and sums_close):
        raise AssertionError(f"{name}: disagrees with its reference")
    return float((rsum - wsum).abs().max())


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Median milliseconds of one call on the card (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def kernel_ms(fn, iters: int = 10, runs: int = 3) -> float:
    """Milliseconds of one call on the card: the median over `runs` runs
    of `iters` calls back to back between two CUDA events, divided by
    `iters`. The host queues the calls ahead of the card, so its own time
    per call (the wrapper's checks and the launch) is hidden where it is
    shorter than the call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def bound(n_bytes: int, ops: dict) -> tuple[float, str]:
    """Least time for the work: bytes over the memory rate or operations
    over the peak rate of their type, whichever is larger (ms)."""
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = sum(n / PEAK_OPS_PER_S[dt] for dt, n in ops.items()) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_device() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is False)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    say("device", name=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
        torch=torch.__version__, cuda=torch.version.cuda)


def ptxas_entries(text: str) -> list[dict]:
    """Registers and spill bytes of each kernel entry in an nvcc -Xptxas -v log."""
    entries = []
    for line in text.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?([\w$]+)'?", line)
        if m:
            # the layer's kernels by name and template arguments (mangled)
            short = re.search(r"((?:tc_)?(?:layer|mha_fwd|mha_bwd|signature|gate|attention|"
                              r"fused_layer|fused|stream_mix|neighbor_mix|stream_attention|"
                              r"spmm_tile)_kernelI\w*?)Ev(?:NS|PK)", m.group(1))
            name = short.group(1) if short else m.group(1)
            if not entries or entries[-1]["entry"] != name:
                entries.append({"entry": name})
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and entries:
            entries[-1].update(spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and entries:
            entries[-1]["registers"] = int(m.group(1))
    return entries


def _native_runtime() -> None:
    """Build the port's native libraries with g++ (before any layout,
    sampler or gate reads `native.available`), or fail: no phase may run
    on the Python routes because the library did not build."""
    if not native.available:
        print(native.build_error, flush=True)
        raise AssertionError("the native runtime did not build")
    native.load_library("hnsw")


def phase_build() -> None:
    seconds = _lib.build()
    _native_runtime()
    spills = []
    for name in _lib.SOURCES:
        log = _lib.log_path(name)
        text = log.read_text() if log.exists() else ""
        spills += [line.strip() for line in text.splitlines()
                   if re.search(r"\b[1-9]\d* bytes spill", line)]
        _lib.load(name)
    say("build", seconds=round(seconds.pop("total", 0.0), 3), sources=",".join(_lib.SOURCES),
        ptxas_lines_with_spills=len(spills))
    say("build_sources", **{name: round(t, 3) for name, t in seconds.items()})
    for line in spills[:8]:
        print("  ptxas:", line, flush=True)
    # the instances of the tensor-core bodies and of the bodies beside them
    for source in ("block_dense_attn", "neighbor_mix", "gated_block_layer", "gated_block_mha",
                   "gated_block_attn", "mincut_gate_block", "flash_neighbor", "spmm_gather"):
        for e in ptxas_entries(_lib.log_path(source).read_text()):
            say("build_ptxas", source=source, **e)
    # K1's instances must build as before K2's tensor-core body came to
    # share its table passes (wd_pass, head_pass)
    got = {e["entry"]: (e.get("registers"), e.get("spill_stores", 0), e.get("spill_loads", 0))
           for e in ptxas_entries(_lib.log_path("block_dense_attn").read_text())}
    changed = {name: got.get(name) for name, want in K1_PTXAS.items() if got.get(name) != want}
    say("build_ptxas_k1", instances=len(K1_PTXAS), unchanged=not changed)
    if changed:
        raise AssertionError(f"K1's ptxas report changed: {changed}")


def _sparse_wd(nb, b, t, per_row, gen):
    """Normalized weights of ~per_row edges per row, a degree-0 row and a
    real zero-weight edge (1e-7)."""
    cols = torch.randint(0, t, (nb, b, per_row), generator=gen)
    w = torch.zeros(nb, b, t)
    w.scatter_(2, cols, torch.rand(nb, b, per_row, generator=gen) + 0.05)
    w = w / w.sum(-1, keepdim=True).clamp(min=1e-10)
    w[0, 3] = 0.0
    w[0, 5, cols[0, 5, 0]] = 1e-7
    return w


def phase_parity(params, cfg) -> float:
    """Each kernel against its plain version at the main path's widths
    (D=128, H=4), with a ragged B, a local table T > 512 (a real halo),
    with and without log_mult, in f32 and bf16 (K1: each of its bodies).
    K1's tensor-core body is also held to the float32 limits where its
    attention is exact (one edge per row, wd = 1.0, a table of bf16
    values: p = 1), and two controls planted in that body must be
    rejected: single-pass TF32 (by the float32 limits) and head 0 left out
    of attn_out (by the bf16 limits). Two more controls: K2's tensor-core
    body without the online softmax's rescale and K3's streaming body
    without slot M-1. Returns that float32-grade max abs error."""
    gen = torch.Generator().manual_seed(0)
    nb, b, t, d, h = 6, 504, 1024, cfg.hidden_dim, cfg.heads
    wd = _sparse_wd(nb, b, t, 16, gen).to(DEV)
    lm = torch.log(torch.randint(1, 3, (nb, b, t), generator=gen).float()).to(DEV)
    folded = fold_layer_params(params, cfg)
    for cdt in (torch.float32, torch.bfloat16):
        L = torch.randn(nb, t, d, generator=gen).to(DEV, cdt)
        u = (0.3 * torch.randn(h, nb, b, d, generator=gen)).to(DEV, cdt)
        sb = torch.randn(h, nb, b, generator=gen).to(DEV)
        msg = torch.randn(nb, b, d, generator=gen).to(DEV)
        for lm_case in (None, lm):
            tag = "" if lm_case is None else "+lm"
            agree(f"K2 block_dense_attention T={t}{tag} body={k2_body(cdt)}",
                  block_dense_attention(L, u, sb, wd, lm_case, scale=0.25),
                  block_dense_attention_reference(L, u, sb, wd, lm_case, scale=0.25), cdt)
            agree(f"K1 block_dense_layer_fused T={t}{tag} body={k1_body(cdt)}",
                  block_dense_layer_fused(L, msg, wd, folded, lm_case, dropout=0.0,
                                          eps=cfg.eps),
                  block_dense_layer_fused_reference(L, msg, wd, folded, lm_case,
                                                    dropout=0.0, eps=cfg.eps), cdt)
    # control: the online softmax without its correction exp(m_old -
    # m_new), on rows of 16 edges over T=1024 (the last bf16 inputs, with lm)
    expect_rejected("K2 without the online softmax's rescale", lambda: agree(
        "control: K2 body=tensor_core without the rescale",
        block_dense_attention(L, u, sb, wd, lm, scale=0.25, variant="no_rescale"),
        block_dense_attention_reference(L, u, sb, wd, lm, scale=0.25), torch.bfloat16))
    # control: head 0 left out of attn_out (the last bf16 inputs, with lm)
    expect_rejected("K1 without head 0's tv_0 Wvo_0", lambda: agree(
        "control: K1 body=tensor_core without head 0",
        block_dense_layer_fused(L, msg, wd, folded, lm, dropout=0.0, eps=cfg.eps,
                                variant="no_head0"),
        block_dense_layer_fused_reference(L, msg, wd, folded, lm, dropout=0.0, eps=cfg.eps),
        torch.bfloat16))
    # float32 grade: one edge per row, wd = 1.0, a table of bf16 values
    wd1 = torch.zeros(nb, b, t)
    wd1.scatter_(2, torch.randint(0, t, (nb, b, 1), generator=gen), 1.0)
    wd1 = wd1.to(DEV)
    L1 = torch.randn(nb, t, d, generator=gen).to(DEV, torch.bfloat16)
    msg1 = torch.randn(nb, b, d, generator=gen).to(DEV)
    want1 = block_dense_layer_fused_reference(L1, msg1, wd1, folded, dropout=0.0, eps=cfg.eps)
    f32_grade = agree(f"K1 block_dense_layer_fused one edge a row, float32 grade "
                      f"body={k1_body(torch.bfloat16)}",
                      block_dense_layer_fused(L1, msg1, wd1, folded, dropout=0.0, eps=cfg.eps),
                      want1, torch.float32)
    expect_rejected("K1 with single-pass TF32 products", lambda: agree(
        "control: K1 body=tensor_core with single-pass TF32, float32 grade",
        block_dense_layer_fused(L1, msg1, wd1, folded, dropout=0.0, eps=cfg.eps,
                                variant="one_tf32"), want1, torch.float32))
    n, m = 4099, 16
    k3 = [torch.randn(s, generator=gen).to(DEV) for s in ((n, h, d), (n, h), (n, m, d))]
    mask = (torch.rand(n, m, generator=gen) > 0.2).float().to(DEV)
    mask[7] = 0.0
    wnorm = normalized_weights(torch.rand(n, m, generator=gen).to(DEV), mask)
    want3 = fused_neighbor_mix_reference(*k3, mask, wnorm, heads=h, scale=0.25)
    agree(f"K3 fused_neighbor_mix N={n} body={k3_body(h, m, d)}",
          fused_neighbor_mix(*k3, mask, wnorm, heads=h, scale=0.25), want3, torch.float32)
    expect_rejected("K3 without slot M-1", lambda: agree(
        "control: K3 body=streaming without slot M-1",
        fused_neighbor_mix(*k3, mask, wnorm, heads=h, scale=0.25, variant="drop_last_slot"),
        want3, torch.float32))
    torch.cuda.synchronize()
    return f32_grade


def tile_share(wd: torch.Tensor, rows: int = 16, cols: int = 64) -> float:
    """Share of the [rows, cols] tiles of wd [nB, B, T] that hold an edge:
    K2's tensor-core body computes those (a warp's 16-row strip against a
    64-row chunk of the table) and skips the others."""
    nb, b, t = wd.shape
    e = F.pad((wd > 0).float(), (0, -t % cols, 0, -b % rows))
    return float(e.reshape(nb, -1, rows, e.shape[2] // cols, cols).amax(dim=(2, 4)).mean())


def bench_clusters(n: int, d: int) -> tuple[np.ndarray, np.ndarray]:
    """bench.py's clustered data: 1000 centers x (n/1000) points, std 0.25;
    (features, each point's center)."""
    rng = np.random.default_rng(0)
    centers = rng.normal(size=(1000, d)).astype(np.float32)
    labels = rng.integers(0, 1000, size=n)
    return (centers[labels] + 0.25 * rng.normal(size=(n, d))).astype(np.float32), labels


def bench_features(n: int, d: int) -> np.ndarray:
    return bench_clusters(n, d)[0]


def block_layout(feats_np: np.ndarray, graph: NeighborGraph):
    """The main path's layout: graph-grown 512-node blocks of the kNN
    graph. Returns (perm, the block-dense graph, the padded features)."""
    idx = graph.nbr_idx.cpu().numpy()
    mask = graph.nbr_mask.cpu().numpy()
    ew = graph.edge_weight.cpu().numpy()
    perm, leaves = graph_grow_blocks(idx, mask, leaf_size=512)
    inv = np.empty(len(idx), np.int64)
    inv[perm] = np.arange(len(idx))
    bdg = build_block_dense(inv[idx[perm]].astype(np.int32), mask[perm], ew[perm],
                            leaf_sizes=leaves, dtype=torch.float32, device=DEV)
    return perm, bdg, bdg.pad_features(torch.from_numpy(feats_np[perm]).to(DEV))


def counted(kernel_names, fn):
    """Run fn with every launch count at 0 before and read just after;
    fail if a kernel of this path was never launched."""
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    for name in kernel_names:
        if counts[name] < 1:
            raise AssertionError(f"{name} was not launched on its path: {counts}")
    return out, counts


# ---------------------------------------------------------------------------
# config 5: the min-cut-gated graph transformer
# ---------------------------------------------------------------------------

def agree_signature(name: str, got, x, pad, sig, compute_bf16: bool, eps: float) -> float:
    """K6c's rows (rsum, rcnt) of x against the plain version on x (the
    kernel's LayerNorm is the plain one step for step): agree_rows."""
    return agree_rows(name, got, block_gate_signature_ln_x_reference(
        x, pad, *sig, eps=eps, compute_bf16=compute_bf16))


def agree_layer_with_sig(name: str, got, want, pad, sig, dtype: torch.dtype,
                         eps: float) -> float:
    """K4b (out, rsum, rcnt) against its plain version (want = the plain
    layer's output and signature): the output to the layer tolerance of
    `dtype`, the signature to the plain signature of the kernel's own
    output (in bf16 the plain layer's output differs from the kernel's
    within the layer tolerance, and the signature is discontinuous at
    eps). Returns the larger max abs error of out and rsum."""
    out, rsum, rcnt = got
    out_err = agree(f"{name} out", out, want[0], dtype)
    return max(out_err, agree_signature(f"{name} signature", (rsum, rcnt), out, pad, sig,
                                        dtype == torch.bfloat16, eps))


def agree_gate(name: str, got, want) -> float:
    """K7 (keep words, stats) against its plain version: the logits are the
    same bits in both (the plain LayerNorm step for step, float64 sums),
    so the masks and the applied flags must be equal; the cut cost within
    1e-4, or 2e-3 relative where a cut applies (push amounts may differ in
    ulps; the cut does not). Returns the max abs error of the cut cost."""
    (kp, st), (wkp, wst) = got, want
    masks_equal = torch.equal(kp, wkp)
    applied_equal = torch.equal(st[:, 2], wst[:, 2])
    err = (st[:, 0, 0] - wst[:, 0, 0]).abs()
    cost_ok = bool((err <= torch.clamp(2e-3 * wst[:, 0, 0].abs(), min=1e-4)).all())
    b = kp.shape[-1]
    ok = masks_equal and applied_equal and cost_ok
    say("agree", name=name, partitions=kp.shape[0], masks_equal=masks_equal,
        bits_differ=int((unpack_keep(kp, b) != unpack_keep(wkp, b)).sum()),
        applied_equal=applied_equal, cuts_applied=int(st[:, 2, 0].sum()),
        cost_max_abs_err=float(err.max()), ok=ok)
    if not ok:
        raise AssertionError(f"{name}: disagrees with its reference")
    return float(err.max())


def gate_qs_bf16(x, pad, A_sig, *, lam, eps, ln, compute_bf16):
    """A faulty plain K7 for the controls: qs = X A_sig rounded to bf16
    before the logits (K6c's rounding in K7's place)."""
    X = layer_norm_rows(x.float(), *ln)
    if compute_bf16:
        X = X.to(torch.bfloat16).float()
    lg = matmul_f64(as_cdt(matmul_f64(X, A_sig), torch.bfloat16), X.transpose(1, 2))
    valid = (pad[:, :, None] * pad[:, None, :]) > 0
    return gate_from_logits(torch.where(valid, lg, torch.full_like(lg, -1.0)), lam=lam, eps=eps)


def expect_rejected(name: str, check) -> None:
    """A control: `check` holds a deliberately wrong result against the
    plain version and must raise."""
    try:
        check()
    except AssertionError:
        say("control", name=name, rejected=True)
        return
    raise AssertionError(f"control {name}: a wrong result passed the check")


def phase_gated_parity(gparams, gcfg) -> None:
    """K4a/K4b/K6c/K7 against their plain versions at config 5's widths
    (D=128, 4 heads, FFN x4, B=256), with a short tail block (pad rows),
    a sparse keep mask with a row that keeps nothing, a degree-0 row, in
    f32 and bf16 compute; K4a/K4b in bf16 also at B=200, at D=64 and at
    B=320 (each body of the kernel), and a control that must be rejected
    (K4a without one head); K6c with a fault planted in its tensor-core
    body (float32 sums), to be rejected; K7 on random partitions and on
    partitions built so that the cut applies, its source side one or two
    hops from s, and with a fault planted in its reachability (stopped
    after one frontier), to be rejected."""
    gen = torch.Generator().manual_seed(1)
    nb, b, d = 3, C5_BLOCK, gcfg.dim
    x = torch.randn(nb, b, d, generator=gen).to(DEV)
    pad = torch.ones(nb, b)
    pad[-1, 200:] = 0.0
    pad = pad.to(DEV)
    keep = torch.rand(nb, b, b, generator=gen) < 0.3
    keep[0, 5] = False
    keep = pack_keep(keep).to(DEV)
    wd = _sparse_wd(nb, b, b, C5_K, gen).to(DEV)
    p, p_next = gparams
    folded = fold_gated_layer_params(p, gcfg)
    sig = (gated._fold_sig_params(p_next, gcfg), *gated._ln_vectors(p_next["ln1"]))
    for cbf in (False, True):
        cdt, tag = (torch.bfloat16, "bf16") if cbf else (torch.float32, "f32")
        wdc = wd.to(cdt)
        out = gated_block_layer(x, keep, pad, wdc, folded, compute_bf16=cbf)
        agree(f"K4a gated_block_layer B={b} {tag}", out,
              gated_block_layer_reference(x, keep, pad, wdc, folded, compute_bf16=cbf), cdt)
        out_b, rsum, rcnt = gated_block_layer_with_sig(x, keep, pad, wdc, folded, *sig,
                                                       compute_bf16=cbf, sig_eps=gcfg.eps)
        agree_layer_with_sig(
            f"K4b gated_block_layer_with_sig {tag}", (out_b, rsum, rcnt),
            gated_block_layer_with_sig_reference(x, keep, pad, wdc, folded, *sig,
                                                 compute_bf16=cbf, sig_eps=gcfg.eps),
            pad, sig, cdt, gcfg.eps)
        # one code path: K4b's output is K4a's, and its signature is K6c's
        # on the written output, bit for bit
        rs6, rc6 = block_gate_signature_ln_x(out, pad, *sig, eps=gcfg.eps, compute_bf16=cbf)
        same = torch.equal(out_b, out) and torch.equal(rsum, rs6) and torch.equal(rcnt, rc6)
        say("agree", name=f"K4b = K4a then K6c, bitwise {tag}", ok=same)
        if not same:
            raise AssertionError("K4b disagrees bitwise with K4a followed by K6c")
        agree_signature(f"K6c block_gate_signature_ln_x {tag}",
                        block_gate_signature_ln_x(x, pad, *sig, eps=gcfg.eps, compute_bf16=cbf),
                        x, pad, sig, cbf, gcfg.eps)
    # control: K4a without head 0's contribution (its Wvo columns zeroed)
    wdb = wd.to(torch.bfloat16)
    no_head = dict(folded, Wvo_cat=folded["Wvo_cat"].clone())
    no_head["Wvo_cat"][:, :d] = 0.0
    expect_rejected("K4a without one head's contribution", lambda: agree(
        "control: K4a without head 0",
        gated_block_layer(x, keep, pad, wdb, no_head, compute_bf16=True),
        gated_block_layer_reference(x, keep, pad, wdb, folded, compute_bf16=True),
        torch.bfloat16))
    # the bf16 bodies at other shapes: a ragged B and D=64 on the tensor
    # cores (zero-filled rows, masked stores), B in (256, 512] on block_gemm
    cfg64 = dataclasses.replace(gcfg, dim=64)
    p64, p64_next = gated.gated_graph_transformer_init(1, cfg64, device=DEV)
    cases = ((200, folded, sig),
             (256, fold_gated_layer_params(p64, cfg64),
              (gated._fold_sig_params(p64_next, cfg64), *gated._ln_vectors(p64_next["ln1"]))),
             (320, folded, sig))
    for bc, fc, sc in cases:
        dc = fc["Wg"].shape[0]
        xc = torch.randn(nb, bc, dc, generator=gen).to(DEV)
        pc = torch.ones(nb, bc)
        pc[-1, bc - bc // 4:] = 0.0
        pc = pc.to(DEV)
        kc = torch.rand(nb, bc, bc, generator=gen) < 0.3
        kc[0, 5] = False
        kc = pack_keep(kc).to(DEV)
        wc = _sparse_wd(nb, bc, bc, C5_K, gen).to(DEV, torch.bfloat16)
        tag = f"bf16 B={bc} D={dc} body={mha_body(bc, True)}"
        out = gated_block_layer(xc, kc, pc, wc, fc, compute_bf16=True)
        agree(f"K4a gated_block_layer {tag}", out,
              gated_block_layer_reference(xc, kc, pc, wc, fc, compute_bf16=True), torch.bfloat16)
        out_b, rsum, rcnt = gated_block_layer_with_sig(xc, kc, pc, wc, fc, *sc, compute_bf16=True,
                                                       sig_eps=gcfg.eps)
        rs6, rc6 = block_gate_signature_ln_x(out, pc, *sc, eps=gcfg.eps, compute_bf16=True)
        same = torch.equal(out_b, out) and torch.equal(rsum, rs6) and torch.equal(rcnt, rc6)
        say("agree", name=f"K4b = K4a then K6c, bitwise {tag}", ok=same)
        if not same:
            raise AssertionError("K4b disagrees bitwise with K4a followed by K6c")
    # control: f32 products where the signature takes bf16 ones
    expect_rejected("K6c with float32 instead of bf16 products", lambda: agree_signature(
        "control: signature with float32 products",
        block_gate_signature_ln_x_reference(x, pad, *sig, eps=gcfg.eps, compute_bf16=False),
        x, pad, sig, True, gcfg.eps))
    # control: a fault planted in K6c's tensor-core body, float32 sums
    expect_rejected("K6c with float32 instead of float64 sums", lambda: agree_signature(
        f"control: K6c body={sig_body(b, True)} with float32 sums",
        block_gate_signature_ln_x(x, pad, *sig, eps=gcfg.eps, compute_bf16=True,
                                  variant="f32_acc"),
        x, pad, sig, True, gcfg.eps))
    A0, ln0 = gated._fold_sig_params(p, gcfg), gated._ln_vectors(p["ln1"])
    xr = torch.randn(6, b, d, generator=gen).to(DEV)
    pad_r = torch.ones(6, b)
    pad_r[-1, 230:] = 0.0
    pad_r = pad_r.to(DEV)
    gate = dict(lam=gcfg.lam, eps=gcfg.eps)
    for cbf in (False, True):
        want = mincut_gate_block_from_x_reference(xr, pad_r, A0, ln=ln0, compute_bf16=cbf,
                                                  **gate)
        agree_gate(f"K7 mincut_gate_block_from_x random B={b} bf16={cbf}",
                   mincut_gate_block_from_x(xr, pad_r, A0, ln=ln0, compute_bf16=cbf, **gate),
                   want)
    # control: qs rounded to bf16 where the gate keeps it float32
    expect_rejected("K7 with qs rounded to bf16", lambda: agree_gate(
        "control: gate with qs rounded to bf16",
        gate_qs_bf16(xr, pad_r, A0, ln=ln0, compute_bf16=True, **gate), want))
    xs = isolated_sink(torch.randn(4, b, d, generator=gen), 0.1, gcfg.eps).to(DEV)
    ps, eye = torch.ones(4, b, device=DEV), 0.1 * torch.eye(d, device=DEV)
    got = mincut_gate_block_from_x(xs, ps, eye, **gate)
    agree_gate(f"K7 mincut_gate_block_from_x isolated sink B={b}", got,
               mincut_gate_block_from_x_reference(xs, ps, eye, **gate))
    applied = int(got[1][:, 2, 0].sum())
    # partitions whose cut reaches its source side in two hops, on the
    # tensor-core logits (unit LN1), and a fault planted in K7: the cut's
    # reachability stopped after its first frontier
    two = dict(gate, ln=(torch.ones(d, device=DEV), torch.zeros(d, device=DEV)),
               compute_bf16=True)
    xt = two_hop_sink(4, b, d, 0.1, gcfg.eps).to(DEV)
    got2 = mincut_gate_block_from_x(xt, ps, eye, **two)
    want2 = mincut_gate_block_from_x_reference(xt, ps, eye, **two)
    agree_gate(f"K7 mincut_gate_block_from_x two-hop sink B={b} "
               f"body={gate_body(b, True, two['ln'])}", got2, want2)
    applied2 = int(got2[1][:, 2, 0].sum())
    say("gate_cuts", partitions=8, applied=applied + applied2)
    if applied + applied2 != 8:
        raise AssertionError("the isolated- and two-hop-sink partitions must apply their cut")
    expect_rejected("K7 with the cut's reachability stopped after one frontier",
                    lambda: agree_gate("control: K7 reachability after one frontier",
                                       mincut_gate_block_from_x(
                                           xt, ps, eye, variant="reach_one_frontier", **two),
                                       want2))
    torch.cuda.synchronize()


def phase_train_parity(gparams, gcfg) -> None:
    """K5a, K5b, K6a and K6b against their plain versions at config 5's
    widths (D=128, 4 heads, B=256), with a short tail block (pad rows), a
    sparse keep mask with a row that keeps nothing, in f32 and bf16
    compute, and in bf16 at the halo layout's B = 240 (the tensor-core
    bodies, padded to 256) and at B = 320 (block_gemm's bf16 bodies). The
    bf16 tensor-core K5b is also held to TOL_F32_GRADE at B = 256 and 240.
    Controls that must fail: K5b's dA reduced without partition 0's
    partial; two faults planted in K5b's tensor-core body, head 0's
    dq A_0^T left out of dX, and single-pass TF32 in place of 3xTF32
    (against TOL_F32_GRADE)."""
    gen = torch.Generator().manual_seed(2)
    nb, b, d = 3, C5_BLOCK, gcfg.dim
    h = torch.randn(nb, b, d, generator=gen).to(DEV)
    g = torch.randn(nb, b, d, generator=gen).to(DEV)
    pad = torch.ones(nb, b)
    pad[-1, 200:] = 0.0
    pad = pad.to(DEV)
    keep = torch.rand(nb, b, b, generator=gen) < 0.3
    keep[0, 5] = False
    keep = pack_keep(keep).to(DEV)
    p = gparams[0]
    A, Wvo = fold_gated_attention_params(p, gcfg)
    A_cat, Wvo_cat = head_concat(A), head_concat(Wvo)
    A_sig = gated._fold_sig_params(p, gcfg)
    scale = 1.0 / (gcfg.head_dim ** 0.5) / gcfg.num_heads
    for cbf in (False, True):
        cdt, tag = (torch.bfloat16, "bf16") if cbf else (torch.float32, "f32")
        args = (h, keep, pad, A_cat, Wvo_cat)
        agree(f"K5a gated_block_attention_fwd B={b} {tag} body={mha_body(b, cbf)}",
              gated_block_attention_fwd(*args, compute_bf16=cbf),
              gated_block_attention_fwd_reference(*args, compute_bf16=cbf), cdt)
        agree_grads(f"K5b gated_block_attention_bwd B={b} {tag} body={mha_body(b, cbf)}",
                    gated_block_attention_bwd(*args, g, compute_bf16=cbf),
                    gated_block_attention_bwd_reference(*args, g, compute_bf16=cbf), cdt)
        agree_rows(f"K6b block_gate_signature_x {tag}",
                   block_gate_signature_x(h, pad, A_sig, eps=gcfg.eps, compute_bf16=cbf),
                   block_gate_signature_x_reference(h, pad, A_sig, eps=gcfg.eps,
                                                    compute_bf16=cbf))
        q, k = gated._qk_proj(h, p["wq"], p["wk"], dataclasses.replace(
            gcfg, compute_dtype="bfloat16" if cbf else "float32"))
        agree_rows(f"K6a block_gate_signature q/k {tag} body={sig_body(b, cbf)}",
                   block_gate_signature(q, k, pad, eps=gcfg.eps, scale=scale),
                   block_gate_signature_reference(q, k, pad, eps=gcfg.eps, scale=scale))
    # bf16 at the halo layout's B = 240 (padded to 256 on the tensor cores)
    # and at B = 320 (block_gemm's bf16 bodies); the rows of B = 320 past
    # 256 are new draws
    h320 = torch.cat([h, torch.randn(nb, 64, d, generator=gen).to(DEV)], 1)
    g320 = torch.cat([g, torch.randn(nb, 64, d, generator=gen).to(DEV)], 1)
    pad320 = torch.cat([pad, torch.ones(nb, 64, device=DEV)], 1)
    pad320[-1, 200:] = 0.0
    for bs in (H_BLOCK, 320):
        kb = torch.rand(nb, bs, bs, generator=gen) < 0.3
        kb[0, 5] = False
        args_b = (h320[:, :bs].contiguous(), pack_keep(kb).to(DEV),
                  pad320[:, :bs].contiguous(), A_cat, Wvo_cat)
        gb = g320[:, :bs].contiguous()
        tag = f"B={bs} bf16 body={mha_body(bs, True)}"
        agree(f"K5a gated_block_attention_fwd {tag}",
              gated_block_attention_fwd(*args_b, compute_bf16=True),
              gated_block_attention_fwd_reference(*args_b, compute_bf16=True), torch.bfloat16)
        got = gated_block_attention_bwd(*args_b, gb, compute_bf16=True)
        want = gated_block_attention_bwd_reference(*args_b, gb, compute_bf16=True)
        agree_grads(f"K5b gated_block_attention_bwd {tag}", got, want, torch.bfloat16)
        if mha_body(bs, True) == "tensor_core":
            agree_grads(f"K5b gated_block_attention_bwd float32 grade {tag}", got, want,
                        torch.bfloat16, TOL_F32_GRADE)
    # K6b at the halo layout's B = 240 in bf16 (the float64 tensor-core
    # body, padded to 256)
    xh, ph = h320[:, :H_BLOCK].contiguous(), pad320[:, :H_BLOCK].contiguous()
    agree_rows(f"K6b block_gate_signature_x B={H_BLOCK} bf16 body={sig_body(H_BLOCK, True)}",
               block_gate_signature_x(xh, ph, A_sig, eps=gcfg.eps, compute_bf16=True),
               block_gate_signature_x_reference(xh, ph, A_sig, eps=gcfg.eps, compute_bf16=True))
    # K6a: bf16 q and k at the halo layout's B = 240 (the float64
    # tensor-core body, padded to 256), the same q and k in float32 and
    # bf16 at B = 320 (block_gemm), and bf16 random q and k at B in {32,
    # 128, 256} x D in {32, 64, 128} (the tensor-core body)
    qk_cases = []
    for bs, xs_, ps_ in ((H_BLOCK, xh, ph), (320, h320, pad320)):
        qs, ks = gated._qk_proj(xs_, p["wq"], p["wk"], gcfg)
        qk_cases.append((f"B={bs} bf16", qs, ks, ps_, scale))
        if bs == H_BLOCK:
            qk_cases.append((f"B={bs} f32", qs.float(), ks.float(), ps_, scale))
    for bs in (32, 128, 256):
        for dd in (32, 64, 128):
            pr = torch.ones(nb, bs)
            pr[-1, bs - bs // 3:] = 0.0
            qk_cases.append((f"B={bs} D={dd} bf16",
                             torch.randn(nb, bs, dd, generator=gen).to(DEV, torch.bfloat16),
                             torch.randn(nb, bs, dd, generator=gen).to(DEV, torch.bfloat16),
                             pr.to(DEV), 1.0 / dd ** 0.5))
    for tag, qs, ks, ps_, sc in qk_cases:
        body = sig_body(qs.shape[1], qs.dtype == torch.bfloat16)
        agree_rows(f"K6a block_gate_signature {tag} body={body}",
                   block_gate_signature(qs, ks, ps_, eps=gcfg.eps, scale=sc),
                   block_gate_signature_reference(qs, ks, ps_, eps=gcfg.eps, scale=sc))
    bodies = {tag: sig_body(qs.shape[1], qs.dtype == torch.bfloat16)
              for tag, qs, *_ in qk_cases[:3]}
    say("k6a_bodies", **{t.replace(" ", "_").replace("=", ""): v for t, v in bodies.items()})
    if list(bodies.values()) != ["tensor_core", "block_gemm", "block_gemm"]:
        raise AssertionError(f"K6a's bodies: {bodies}")
    # the tensor-core K5b at B = 256: float32 grade, and two planted faults
    args = (h, keep, pad, A_cat, Wvo_cat)
    want = gated_block_attention_bwd_reference(*args, g, compute_bf16=True)
    agree_grads(f"K5b gated_block_attention_bwd float32 grade B={b} body={mha_body(b, True)}",
                gated_block_attention_bwd(*args, g, compute_bf16=True), want, torch.bfloat16,
                TOL_F32_GRADE)

    def variant(name):
        dx, dA_p, dW_p = gated_block_attention_bwd_partials(*args, g, compute_bf16=True,
                                                            variant=name)
        return dx, reduce_partials(dA_p), reduce_partials(dW_p)

    expect_rejected("K5b with head 0's dq A_0^T left out of dX", lambda: agree_grads(
        "control: K5b body without head 0's dq A_0^T in dX", variant("no_dq_a0"), want,
        torch.bfloat16))
    expect_rejected("K5b with single-pass TF32 products", lambda: agree_grads(
        "control: K5b body with single-pass TF32, float32 grade", variant("one_tf32"), want,
        torch.bfloat16, TOL_F32_GRADE))
    # control: one partition's dA partial left out of the reduction (with
    # nB = 3 partitions each block of the grid holds exactly one)
    dx, dA_parts, _ = gated_block_attention_bwd_partials(h, keep, pad, A_cat, Wvo_cat, g,
                                                         compute_bf16=False)
    if dA_parts.shape[0] != nb:
        raise AssertionError(f"K5b's grid holds {dA_parts.shape[0]} partials, not one per "
                             f"partition ({nb})")
    want_dA = gated_block_attention_bwd_reference(h, keep, pad, A_cat, Wvo_cat, g,
                                                  compute_bf16=False)[1]
    agree_scaled("K5b dA from its partials, all partitions", reduce_partials(dA_parts), want_dA,
                 torch.float32)
    expect_rejected("K5b dA without partition 0's partial", lambda: agree_scaled(
        "control: K5b dA without partition 0's partial",
        reduce_partials(dA_parts[1:].contiguous()), want_dA, torch.float32))
    torch.cuda.synchronize()


def cluster_graph(n: int, d: int, k: int, seed: int = 0, chunk: int = 512):
    """Config 5's data (benchmarks/scale_sweep_r02.py:82-94), made on the
    card: clusters of C5_CLUSTER points around N(0, 1) centres with std
    0.25, contiguous, and the exact within-cluster kNN (self excluded)
    with weights 1/(1 + dist). Returns (feats [n, d] f32, idx [n, k]
    int32, ew [n, k] f32), on the card."""
    gen = torch.Generator(device=DEV).manual_seed(seed)
    nc, c_sz = n // C5_CLUSTER, C5_CLUSTER
    feats = torch.empty(n, d, device=DEV)
    idx = torch.empty(n, k, dtype=torch.int32, device=DEV)
    ew = torch.empty(n, k, device=DEV)
    self_pair = 1e30 * torch.eye(c_sz, device=DEV)
    for s in range(0, nc, chunk):
        c = min(chunk, nc - s)
        pts = (torch.randn(c, 1, d, generator=gen, device=DEV)
               + 0.25 * torch.randn(c, c_sz, d, generator=gen, device=DEV))
        sq = (pts * pts).sum(-1)
        d2 = sq[:, :, None] + sq[:, None, :] - 2.0 * torch.bmm(pts, pts.transpose(1, 2))
        neg, nn_idx = torch.topk(-(d2 + self_pair), k, dim=-1)
        rows = slice(s * c_sz, (s + c) * c_sz)
        feats[rows] = pts.reshape(-1, d)
        base = torch.arange(s, s + c, device=DEV, dtype=torch.int32)[:, None, None] * c_sz
        idx[rows] = (nn_idx.int() + base).reshape(-1, k)
        ew[rows] = (1.0 / (1.0 + torch.sqrt(torch.clamp(-neg, min=0.0)))).reshape(-1, k)
    return feats, idx, ew


def _synced_ms(fn):
    """(result, host milliseconds) of fn, synchronised on both sides."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def phase_config5(gparams, gcfg, d: int) -> dict:
    """The serving path of config 5 at full width: gate_state_init, steady
    steps (each must re-solve 0 partitions: K4b's emitted signature
    equals K6c's), drift steps (each must re-solve between 1 and twice
    the budget), one layer of the kernel route against the plain
    composition under the same masks, and K7 re-solving layer 0's gates
    over every partition (the init masks, reproduced)."""
    t0 = time.perf_counter()
    feats, idx, ew = cluster_graph(C5_NODES, d, C5_K)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    bdg = build_block_dense(idx.cpu().numpy(), np.ones((C5_NODES, C5_K), np.float32),
                            ew.cpu().numpy(), block=C5_BLOCK, device=DEV)
    layout_s = time.perf_counter() - t0
    del idx, ew
    nb, b = bdg.n_blocks, bdg.block
    if bdg.table != b or nb * b != C5_NODES:
        raise AssertionError(f"config 5 layout is not halo-free: nB={nb} B={b} T={bdg.table}")
    budget = max(1, int(nb * gcfg.max_resolve_frac))
    fpad = bdg.pad_features(feats)
    del feats
    step = gated.gated_graph_transformer_step

    # --- init: every gate solved once -------------------------------------
    (state, init_ms), init_counts = counted(
        ["mincut_gate_block_from_x", "block_gate_signature_ln_x", "gated_block_layer"],
        lambda: _synced_ms(lambda: gated.gate_state_init(gparams, gcfg, fpad, bdg)))

    # --- steady steps: the same input reuses every gate ---------------------
    def steady():
        st, times, res = state, [], []
        for _ in range(C5_STEPS):
            (out, st, nres), ms = _synced_ms(lambda: step(gparams, gcfg, fpad, bdg, st))
            times.append(ms)
            res.append(nres)
        return out, st, times, res

    (out, st_steady, steady_ms, steady_res), steady_counts = counted(
        ["block_gate_signature_ln_x", "gated_block_layer_with_sig", "gated_block_layer"],
        steady)
    if any(steady_res) or out.shape != fpad.shape or not bool(torch.isfinite(out).all()):
        raise AssertionError(f"steady steps re-solved {steady_res} partitions (must be 0) "
                             "or gave a non-finite output")

    # --- drift steps: features move each step; the perturbation is outside
    # the timed window ---------------------------------------------------
    noise = torch.Generator(device=DEV).manual_seed(7)
    padcol = bdg.node_pad.reshape(-1, 1)

    def drift():
        f, st, times, res = fpad, st_steady, [], []
        for _ in range(C5_STEPS):
            f = f + C5_DRIFT * torch.randn(f.shape, generator=noise, device=DEV) * padcol
            (out, st, nres), ms = _synced_ms(lambda: step(gparams, gcfg, f, bdg, st))
            times.append(ms)
            res.append(nres)
        return out, f, times, res

    (out, f_drift, drift_ms, drift_res), drift_counts = counted(
        ["mincut_gate_block_from_x", "block_gate_signature_ln_x",
         "gated_block_layer_with_sig", "gated_block_layer"], drift)
    if (not all(0 < r <= 2 * budget for r in drift_res) or out.shape != fpad.shape
            or not bool(torch.isfinite(out).all())):
        raise AssertionError(f"drift steps re-solved {drift_res} partitions (must be in "
                             f"1..{2 * budget}) or gave a non-finite output")

    # --- one layer: kernel route (K4a) vs the plain composition -----------
    x0, keep0 = fpad.reshape(nb, b, d), state["keep"][0]
    k_out = gated._layer_with_keep(gparams[0], gcfg, x0, bdg, keep0, fused=True)
    p_out = gated._layer_with_keep(gparams[0], dataclasses.replace(gcfg, fused_gate_attn="never"),
                                   x0, bdg, keep0, fused=True)
    agree("config5 layer 0: kernel route (K4a) vs plain composition", k_out, p_out,
          torch.bfloat16, tol=C5_ROUTE_TOL)
    del k_out, p_out

    # --- K7 over every partition: its plain version's masks, and the init
    # masks again ----------------------------------------------------------
    A0, ln0 = gated._fold_sig_params(gparams[0], gcfg), gated._ln_vectors(gparams[0]["ln1"])
    gate = dict(lam=gcfg.lam, eps=gcfg.eps, ln=ln0, compute_bf16=True)
    kp, stats = mincut_gate_block_from_x(x0, bdg.node_pad, A0, **gate)
    agree_gate(f"K7 at the init shape (K={nb})", (kp, stats),
               mincut_gate_block_from_x_reference(x0, bdg.node_pad, A0, **gate))
    if not torch.equal(kp, keep0):
        raise AssertionError("K7 over every partition does not reproduce the init masks")
    edges = C5_NODES * C5_K * gcfg.num_layers
    steady_med, drift_med = statistics.median(steady_ms), statistics.median(drift_ms)
    say("config5", nodes=C5_NODES, nB=nb, B=b, d=d, heads=gcfg.num_heads,
        layers=gcfg.num_layers, budget=budget, edges_per_step=edges, gen_s=round(gen_s, 3),
        layout_s=round(layout_s, 3), gate_init_ms=init_ms, forward_steady_ms=steady_med,
        forward_drift_ms=drift_med, resolved_per_drift_step=drift_res,
        cuts_applied=int(stats[:, 2, 0].sum()), edges_per_s_steady=edges / (steady_med * 1e-3),
        edges_per_s_drift=edges / (drift_med * 1e-3))
    say("config5_steps", steady_ms=[round(t, 3) for t in steady_ms],
        drift_ms=[round(t, 3) for t in drift_ms],
        mean_push_relabel_rounds=float(stats[:, 3, 0].mean()))
    say("config5_launches", init=_nonzero(init_counts), steady=_nonzero(steady_counts),
        drift=_nonzero(drift_counts))
    launches = {name: steady_counts[name] + drift_counts[name] for name in C5_KERNELS}
    sel = torch.randperm(nb, generator=noise, device=DEV)[:budget]
    return dict(bdg=bdg, x0=x0, keep0=keep0, keep=state["keep"],
                x_sel=f_drift.reshape(nb, b, d)[sel].contiguous(),
                pad_sel=bdg.node_pad[sel].contiguous(), launches=launches)


def _nonzero(counts: dict) -> dict:
    return {k: v for k, v in counts.items() if v}


def config5_report(c5: dict, gparams, gcfg) -> list:
    """Report rows of the config-5 kernels at the step path's shapes:
    K4a/K4b/K6c on every partition (layer 0's input and init masks), K7
    at the step shape (budget partitions of drifted features) and, for
    its time only, at the init shape (every partition)."""
    bdg, x0, keep0 = c5["bdg"], c5["x0"], c5["keep0"]
    pad = bdg.node_pad
    nb, b, d = x0.shape
    hh, fm = gcfg.num_heads, gcfg.ffn_mult
    wd = gated._kernel_wdense(gcfg, bdg)
    folded = fold_gated_layer_params(gparams[0], gcfg)
    A0, ln0 = gated._fold_sig_params(gparams[0], gcfg), gated._ln_vectors(gparams[0]["ln1"])
    sig = (gated._fold_sig_params(gparams[1], gcfg), *gated._ln_vectors(gparams[1]["ln1"]))
    n = nb * b
    bf16 = torch.bfloat16
    layer_ops = 2 * n * (hh * (2 * d + 2 * b) * d + (b + d) * d + 2 * fm * d * d)
    sig_ops = 2 * n * (b + d) * d
    layer_bytes = nbytes(x0, keep0, pad, wd, *folded.values()) + nbytes(x0)
    sig_out = 2 * n * 4
    rows = []
    k4a = lambda: gated_block_layer(x0, keep0, pad, wd, folded, compute_bf16=True)  # noqa: E731
    k4a_ref = lambda: gated_block_layer_reference(  # noqa: E731
        x0, keep0, pad, wd, folded, compute_bf16=True)
    body = {"body": mha_body(b, True)}
    rows.append(("gated_block_layer", k4a, k4a_ref,
                 _agree_as(bf16),
                 bound(layer_bytes, {bf16: layer_ops}), dict(body)))
    k4b = lambda: gated_block_layer_with_sig(  # noqa: E731
        x0, keep0, pad, wd, folded, *sig, compute_bf16=True, sig_eps=gcfg.eps)
    k4b_ref = lambda: gated_block_layer_with_sig_reference(  # noqa: E731
        x0, keep0, pad, wd, folded, *sig, compute_bf16=True, sig_eps=gcfg.eps)
    rows.append(("gated_block_layer_with_sig", k4b, k4b_ref,
                 lambda name, got, want: agree_layer_with_sig(name, got, want, pad, sig, bf16,
                                                              gcfg.eps),
                 bound(layer_bytes + nbytes(*sig) + sig_out, {bf16: layer_ops, "f64": sig_ops}),
                 dict(body)))
    k6c = lambda: block_gate_signature_ln_x(x0, pad, A0, *ln0, eps=gcfg.eps,  # noqa: E731
                                            compute_bf16=True)
    k6c_ref = lambda: block_gate_signature_ln_x_reference(  # noqa: E731
        x0, pad, A0, *ln0, eps=gcfg.eps, compute_bf16=True)
    rows.append(("block_gate_signature_ln_x", k6c, k6c_ref,
                 lambda name, got, want: agree_signature(name, got, x0, pad, (A0, *ln0), True,
                                                         gcfg.eps),
                 bound(nbytes(x0, pad, A0, *ln0) + sig_out, {"f64": sig_ops}),
                 {"body": sig_body(b, True)}))

    gate = dict(lam=gcfg.lam, eps=gcfg.eps, ln=ln0, compute_bf16=True)
    x_sel, pad_sel = c5["x_sel"], c5["pad_sel"]

    def gate_bound(x, pad_k, kp, stats):
        """Logits (exact products, float64 sums) plus ~10 B^2 float32
        operations per push-relabel round, with this run's rounds (stats
        row 3)."""
        ops = {"f64": 2 * x.shape[0] * b * d * (b + d),
               torch.float32: 10 * b * b * int(stats[:, 3, 0].sum())}
        return bound(nbytes(x, pad_k, A0, *ln0, kp, stats), ops)

    k7 = lambda: mincut_gate_block_from_x(x_sel, pad_sel, A0, **gate)  # noqa: E731
    k7_ref = lambda: mincut_gate_block_from_x_reference(x_sel, pad_sel, A0, **gate)  # noqa: E731
    k7_init = lambda: mincut_gate_block_from_x(x0, pad, A0, **gate)  # noqa: E731
    init_out = k7_init()
    init_bound_ms, _ = gate_bound(x0, pad, *init_out)
    step_out = k7()
    rows.append(("mincut_gate_block_from_x", k7, k7_ref, agree_gate,
                 gate_bound(x_sel, pad_sel, *step_out),
                 {"shape": f"step: K={x_sel.shape[0]} partitions (plain_ms at this shape "
                           f"only)",
                  "ms_init_shape": time_ms(k7_init, iters=2, warmup=0),
                  "bound_ms_init_shape": init_bound_ms,
                  "init_shape": f"K={nb} partitions",
                  "body": gate_body(b, True, ln0),
                  "rounds_step": int(step_out[1][:, 3, 0].sum()),
                  "rounds_init": int(init_out[1][:, 3, 0].sum()),
                  "rounds_max_step": int(step_out[1][:, 3, 0].max()),
                  "rounds_max_init": int(init_out[1][:, 3, 0].max())}))
    return rows


# ---------------------------------------------------------------------------
# training: config 5's train step, the halo layout, the contrastive step
# ---------------------------------------------------------------------------

def _leaves(params):
    """The trainable tensors of the gated model, in a fixed order."""
    return [t for layer in params for t in gated._flatten(layer)[1]]


def _rebuild(params, leaves):
    it = iter(leaves)
    out = []
    for layer in params:
        keys, vals = gated._flatten(layer)
        out.append(gated._unflatten(keys, [next(it) for _ in vals]))
    return out


def _loss_and_grads(params, cfg, fpad, bdg, keep):
    """config5_r03's loss (zero targets, the state's masks; with keep None
    the stateless loss, gates solved in the call) and its gradient, for
    every leaf of params."""
    leaves = [t.detach().requires_grad_(True) for t in _leaves(params)]
    zeros = torch.zeros_like(fpad)
    if keep is None:
        loss = gated.gated_graph_transformer_loss(_rebuild(params, leaves), cfg, fpad, bdg, zeros)
    else:
        loss = gated.gated_graph_transformer_loss_with_masks(_rebuild(params, leaves), cfg, fpad,
                                                             bdg, keep, zeros)
    return loss.detach(), leaves, torch.autograd.grad(loss, leaves)


def _grads_agree(name, params, cfg, fpad, bdg, keep) -> None:
    """The kernel route's parameter gradients against the plain route's,
    each leaf relative to its own scale, at C5_ROUTE_TOL."""
    _, _, kernel = _loss_and_grads(params, cfg, fpad, bdg, keep)
    _, _, plain = _loss_and_grads(params, dataclasses.replace(cfg, fused_gate_attn="never"),
                                  fpad, bdg, keep)
    names = [f"{li}/{'/'.join(k)}" for li, layer in enumerate(params)
             for k in gated._flatten(layer)[0]]
    for leaf, kg, pg in zip(names, kernel, plain):
        agree_scaled(f"{name} grad {leaf}", kg, pg, torch.bfloat16, tol=C5_ROUTE_TOL)


def first_partitions(bdg, k: int):
    """The first k partitions of a halo-free layout as their own graph."""
    if bdg.table != bdg.block:
        raise AssertionError("a slice of partitions is its own graph only without a halo")
    b = bdg.block
    return dataclasses.replace(bdg, local_ids=bdg.local_ids[:k], wdense=bdg.wdense[:k],
                               degrees=bdg.degrees[:k], node_pad=bdg.node_pad[:k],
                               node_pos=bdg.node_pos[bdg.node_pos < k * b],
                               n=int(bdg.node_pad[:k].sum()), log_mult=None)


def phase_config5_train(gparams, gcfg, c5: dict) -> dict:
    """Config 5's train step at full width on the serving phase's graph,
    weights and init masks: C5_TRAIN_STEPS steps of loss, gradient and
    w - lr g (remat on, bf16 compute on f32 features). Each step must
    launch K4a once per layer (forward) and K5a and K5b once per layer
    (the fused layer's backward recompute), and no other kernel. Then the
    kernel route's gradients against the plain route's on the first
    C5_GRAD_PARTS partitions."""
    bdg, keep = c5["bdg"], c5["keep"]
    nb, b, d = c5["x0"].shape
    fpad = c5["x0"].reshape(nb * b, d)
    cfg = dataclasses.replace(gcfg, remat=True)
    layers = len(gparams)

    def train_step(params):
        loss, leaves, grads = _loss_and_grads(params, cfg, fpad, bdg, keep)
        with torch.no_grad():
            return _rebuild(params, [w - C5_TRAIN_LR * g for w, g in zip(leaves, grads)]), loss

    def run():
        params, times, losses = gparams, [], []
        for _ in range(C5_TRAIN_STEPS):
            (params, loss), ms = _synced_ms(lambda: train_step(params))
            times.append(ms)
            losses.append(float(loss))
        return params, times, losses

    torch.cuda.reset_peak_memory_stats()
    (params, times, losses), counts = counted(
        ["gated_block_layer", "gated_block_attention_fwd", "gated_block_attention_bwd"], run)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    per_step = {k: v / C5_TRAIN_STEPS for k, v in counts.items() if v}
    want = {k: layers for k in ("gated_block_layer", "gated_block_attention_fwd",
                                "gated_block_attention_bwd")}
    if per_step != want or not all(np.isfinite(losses)):
        raise AssertionError(f"train step launches {per_step} (must be {want}) or a "
                             f"non-finite loss {losses}")
    moved = max(float((a - w).abs().max()) for a, w in zip(_leaves(params), _leaves(gparams)))
    if not moved > 0:
        raise AssertionError("the train steps did not move the parameters")
    sub = first_partitions(bdg, C5_GRAD_PARTS)
    _grads_agree(f"config5 train, first {C5_GRAD_PARTS} partitions: kernel vs plain route",
                 gparams, cfg, c5["x0"][:C5_GRAD_PARTS].reshape(-1, d), sub,
                 keep[:, :C5_GRAD_PARTS].contiguous())
    step_ms = statistics.median(times)
    edges = C5_NODES * C5_K * layers
    say("config5_train", nodes=nb * b, nB=nb, B=b, d=d, layers=layers, remat=True, lr=C5_TRAIN_LR,
        train_step_ms=step_ms, steps_ms=[round(t, 3) for t in times], losses=losses,
        edges_per_s=edges / (step_ms * 1e-3), peak_mem_gb=round(peak_gb, 2),
        launches_per_step=per_step, grad_check_partitions=C5_GRAD_PARTS)
    return {k: counts[k] for k in want}


def halo_graph(n: int, d: int, seed: int = 1):
    """Clusters of H_CLUSTER points (centres N(0, 1), std 0.25, contiguous,
    made on the card); each node's H_K_IN nearest within its cluster (self
    excluded) and H_K - H_K_IN random nodes of other clusters, weights
    1/(1 + dist). Returns (feats, idx int32, ew) on the card."""
    gen = torch.Generator(device=DEV).manual_seed(seed)
    nc, c = n // H_CLUSTER, H_CLUSTER
    pts = (torch.randn(nc, 1, d, generator=gen, device=DEV)
           + 0.25 * torch.randn(nc, c, d, generator=gen, device=DEV))
    sq = (pts * pts).sum(-1)
    d2 = sq[:, :, None] + sq[:, None, :] - 2.0 * torch.bmm(pts, pts.transpose(1, 2))
    neg, nn_idx = torch.topk(-(d2 + 1e30 * torch.eye(c, device=DEV)), H_K_IN, dim=-1)
    base = torch.arange(nc, device=DEV)[:, None, None] * c
    inner = (nn_idx + base).reshape(n, H_K_IN)
    dist_in = torch.sqrt(torch.clamp(-neg, min=0.0)).reshape(n, H_K_IN)
    own = torch.arange(n, device=DEV)[:, None] // c
    other = (own + torch.randint(1, nc, (n, H_K - H_K_IN), generator=gen, device=DEV)) % nc
    outer = other * c + torch.randint(0, c, (n, H_K - H_K_IN), generator=gen, device=DEV)
    feats = pts.reshape(n, d)
    dist_out = torch.linalg.vector_norm(feats[outer] - feats[:, None, :], dim=-1)
    idx = torch.cat([inner, outer], dim=1).int()
    ew = 1.0 / (1.0 + torch.cat([dist_in, dist_out], dim=1))
    return feats, idx, ew


def phase_config5_halo(gparams, gcfg) -> dict:
    """Config 5's layers on a layout with a halo and B % 32 != 0: the
    signature is K6b and the gate the plain batched one (the JAX
    package's choice at B % 32 != 0), each layer LN1, K5a and the plain
    mix and FFN. gate_state_init, H_STEPS steady and H_STEPS drift steps,
    one train step; the steady step's output and the train step's
    gradients against the plain route."""
    d = gcfg.dim
    t0 = time.perf_counter()
    feats, idx, ew = halo_graph(H_NODES, d)
    bdg = build_block_dense(idx.cpu().numpy(), np.ones((H_NODES, H_K), np.float32),
                            ew.cpu().numpy(), block=H_BLOCK, device=DEV)
    layout_s = time.perf_counter() - t0
    nb, b = bdg.n_blocks, bdg.block
    if bdg.table <= b or b % 32 == 0:
        raise AssertionError(f"the halo layout has no halo or B % 32 == 0: B={b} T={bdg.table}")
    budget = max(1, int(nb * gcfg.max_resolve_frac))
    fpad = bdg.pad_features(feats)
    step = gated.gated_graph_transformer_step
    step_kernels = ["block_gate_signature_x", "gated_block_attention_fwd"]
    off_route = ("gated_block_layer", "gated_block_layer_with_sig", "block_gate_signature_ln_x",
                 "mincut_gate_block_from_x")
    with torch.no_grad():
        (state, init_ms), init_counts = counted(
            step_kernels, lambda: _synced_ms(lambda: gated.gate_state_init(gparams, gcfg, fpad,
                                                                           bdg)))

        def steps(inputs):
            st, out, times, res = state, None, [], []
            for f in inputs:
                (out, st, nres), ms = _synced_ms(lambda: step(gparams, gcfg, f, bdg, st))
                times.append(ms)
                res.append(nres)
            return out, times, res

        noise = torch.Generator(device=DEV).manual_seed(8)
        padcol = bdg.node_pad.reshape(-1, 1)
        drifted = [fpad + C5_DRIFT * (i + 1) * torch.randn(fpad.shape, generator=noise,
                                                           device=DEV) * padcol
                   for i in range(H_STEPS)]
        (out, steady_ms, steady_res), steady_counts = counted(
            step_kernels, lambda: steps([fpad] * H_STEPS))
        (out_d, drift_ms, drift_res), drift_counts = counted(step_kernels,
                                                             lambda: steps(drifted))
        if (any(steady_res) or not all(0 <= r <= 2 * budget for r in drift_res)
                or sum(drift_res) < 1 or not bool(torch.isfinite(out_d).all())):
            raise AssertionError(f"halo steps re-solved {steady_res} / {drift_res} partitions "
                                 f"(must be 0 / at most {2 * budget}, some) or gave a "
                                 "non-finite output")
        out_plain, _, _ = step(gparams, dataclasses.replace(gcfg, fused_gate_attn="never"), fpad,
                               bdg, state)
        agree("config5 halo steady step: kernel route vs plain route", out, out_plain,
              torch.bfloat16, tol=C5_ROUTE_TOL)
    (loss, _, _), train_counts = counted(
        ["gated_block_attention_fwd", "gated_block_attention_bwd"],
        lambda: _loss_and_grads(gparams, gcfg, fpad, bdg, state["keep"]))
    _, train_ms = _synced_ms(lambda: _loss_and_grads(gparams, gcfg, fpad, bdg, state["keep"]))
    layers = len(gparams)
    for what, counts in (("init", init_counts), ("steady", steady_counts),
                         ("drift", drift_counts), ("train", train_counts)):
        if any(counts[k] for k in off_route):
            raise AssertionError(f"halo {what} launched a halo-free kernel: {_nonzero(counts)}")
    if (train_counts["gated_block_attention_fwd"] != layers
            or train_counts["gated_block_attention_bwd"] != layers):
        raise AssertionError(f"halo train step launches {_nonzero(train_counts)}")
    _grads_agree("config5 halo train: kernel vs plain route", gparams, gcfg, fpad, bdg,
                 state["keep"])
    say("config5_halo", nodes=H_NODES, nB=nb, B=b, T=bdg.table, k=H_K, k_within=H_K_IN,
        layout_s=round(layout_s, 3), gate_init_ms=init_ms,
        steady_ms=[round(t, 3) for t in steady_ms], drift_ms=[round(t, 3) for t in drift_ms],
        resolved_per_drift_step=drift_res, budget=budget, train_step_ms=train_ms,
        loss=float(loss), k6b_body=sig_body(b, gcfg.compute_dtype == "bfloat16"))
    say("config5_halo_launches", init=_nonzero(init_counts), steady=_nonzero(steady_counts),
        drift=_nonzero(drift_counts), train=_nonzero(train_counts))
    h = gated._ln(gparams[0]["ln1"], fpad.reshape(nb, b, d)).contiguous()
    launches = {k: init_counts[k] + steady_counts[k] + drift_counts[k] + train_counts[k]
                for k in ("block_gate_signature_x", "gated_block_attention_fwd",
                          "gated_block_attention_bwd")}
    return dict(h=h, pad=bdg.node_pad, launches=launches)


def phase_halo_signature_control(halo: dict, gparams, gcfg) -> None:
    """K6b on the halo layout's own input (layer 0's normalized stream,
    every partition) against its plain version, and a fault planted in
    its tensor-core body, float32 sums, which must be rejected there. (On
    three random partitions the fault can pass: its float32 sums move a
    row sum past 1e-6 only where they flip a bf16 rounding of Q.) K6a on
    the same stream's bf16 q and k, and its own float32-sums fault on
    them with a cancelling pair planted: K6a rounds nothing between its
    products, so without the pair the fault moves a row sum by about
    1e-8 and flips a count only at eps, and the check cannot see it."""
    h, pad = halo["h"], halo["pad"]
    nb, b, _ = h.shape
    A_sig = gated._fold_sig_params(gparams[0], gcfg)
    want = block_gate_signature_x_reference(h, pad, A_sig, eps=gcfg.eps, compute_bf16=True)
    tag = f"halo layout nB={nb} B={b} body={sig_body(b, True)}"
    agree_rows(f"K6b block_gate_signature_x {tag}",
               block_gate_signature_x(h, pad, A_sig, eps=gcfg.eps, compute_bf16=True), want)
    expect_rejected("K6b with float32 instead of float64 sums", lambda: agree_rows(
        f"control: K6b {tag} with float32 sums",
        block_gate_signature_x(h, pad, A_sig, eps=gcfg.eps, compute_bf16=True,
                               variant="f32_acc"), want))
    # K6a on the halo layout's bf16 q and k, then on the same q and k with
    # a cancelling pair of large products planted in every row: the exact
    # body meets the plain version on both, the fault planted in its
    # tensor-core body (float32 sums) not on the second
    q, k = gated._qk_proj(h, gparams[0]["wq"], gparams[0]["wk"], gcfg)
    scale = 1.0 / (gcfg.head_dim ** 0.5) / gcfg.num_heads
    tag = f"halo layout nB={nb} B={b} bf16 body={sig_body(b, q.dtype == torch.bfloat16)}"
    agree_rows(f"K6a block_gate_signature {tag}",
               block_gate_signature(q, k, pad, eps=gcfg.eps, scale=scale),
               block_gate_signature_reference(q, k, pad, eps=gcfg.eps, scale=scale))
    qc, kc = plant_cancelling_pair(q, k)
    want = block_gate_signature_reference(qc, kc, pad, eps=gcfg.eps, scale=scale)
    agree_rows(f"K6a block_gate_signature {tag}, a cancelling pair planted",
               block_gate_signature(qc, kc, pad, eps=gcfg.eps, scale=scale), want)
    expect_rejected("K6a with float32 instead of float64 sums", lambda: agree_rows(
        f"control: K6a {tag}, a cancelling pair planted, with float32 sums",
        block_gate_signature(qc, kc, pad, eps=gcfg.eps, scale=scale, variant="f32_acc"), want))
    torch.cuda.synchronize()


def plant_cancelling_pair(q, k, big: float = 256.0):
    """q and k with columns 0 and D/2 replaced by a cancelling pair of
    large products in every row: q[..., 0] = q[..., D/2] = big, k[..., 0]
    = big, k[..., D/2] = -big. The pair's products sum to 0 exactly and
    the float64 sums stay exact, while a float32 running sum loses the low
    bits of the terms it adds beside big^2."""
    d = q.shape[-1]
    q, k = q.clone(), k.clone()
    q[..., 0] = big
    q[..., d // 2] = big
    k[..., 0] = big
    k[..., d // 2] = -big
    return q, k


def _tree_cpu(tree):
    return None if tree is None else tree_map(lambda t: t.cpu(), tree)


def agree_cpu(name: str, got: torch.Tensor, want: torch.Tensor) -> float:
    """A card output against the same port function run on the CPU in
    float32 with the same parameters: the f32 limits."""
    return agree(f"{name}: card vs CPU", got.cpu(), want, torch.float32)


def phase_gnn_family(feats: torch.Tensor, graph: NeighborGraph, d: int, heads: int) -> None:
    """The GNN model family and the attention family on the 100k-node
    graph (`[gnn_family]`), seed-0 weights on the card. BASELINE config 2:
    the 2-layer GraphSAGE (fanouts (10, 10), mean, normalised, 128 wide),
    its host sampling (`sample_s`) apart from its forward (`sage_ms`);
    config 3: a GAT layer (4 heads, the edge weight as a 1-d edge
    feature, the residual); a GCN layer; `propagate` with each
    aggregator. Then each per-node mechanism of the family through the
    registry (q = features, k = v = the 16 neighbors' features, the
    graph's mask), the sequence forms (local-global at S=4096, sheaf at
    S=8192 with the quantile over 6.7e7 energies) and 3 trainable Adam
    steps of the edge-featured mechanism on 4096 nodes. No kernel runs
    here: the paths are plain PyTorch, so each card output is held
    against the same function on the CPU (the whole graph for the
    models, the first GNN_ROWS rows for the per-node mechanisms) within
    the f32 limits; a GAT with its LeakyReLU slope set to 0 must be
    rejected. Times: medians of 10 calls (CUDA events)."""
    t_phase = time.perf_counter()
    before = kernels.launch_counts()
    n = graph.num_nodes
    edges = int((graph.nbr_mask > 0).sum())
    feats_c = feats.cpu()
    graph_c = NeighborGraph(graph.nbr_idx.cpu(), graph.nbr_mask.cpu(), graph.edge_weight.cpu())
    fields = {}

    # BASELINE config 2: sampling on the host, then the forward
    sage_cfg = GraphSAGENetConfig(in_features=d, hidden_features=d, out_features=d,
                                  fanouts=GNN_FANOUTS)
    sage_p = graphsage_net_init(0, sage_cfg, device=DEV)
    t0 = time.perf_counter()
    samples = [sample_fanout(graph, lc.num_samples, seed=42 + i)
               for i, lc in enumerate(sage_cfg.layer_cfgs())]
    torch.cuda.synchronize()
    fields["sample_s"] = round(time.perf_counter() - t0, 3)

    def sage(params, x, smp):
        for p, lc, (idx, mask) in zip(params, sage_cfg.layer_cfgs(), smp):
            x = graphsage_apply(p, lc, x, idx, mask)
        return x

    sage_out = sage(sage_p, feats, samples)
    if not torch.equal(graphsage_net_apply(sage_p, sage_cfg, feats, graph), sage_out):
        raise AssertionError("graphsage_net_apply differs from its layers on the same samples")
    agree_cpu("GraphSAGE 2 layers", sage_out,
              sage(_tree_cpu(sage_p), feats_c, _tree_cpu(samples)))
    fields["sage_ms"] = time_ms(lambda: sage(sage_p, feats, samples), iters=10)
    fields["sage_nodes_per_s"] = n / (fields["sage_ms"] * 1e-3)

    # BASELINE config 3: the GAT layer, and its planted control
    gat_cfg = GATConfig(node_dim=d, num_heads=heads, edge_dim=1, residual=True)
    gat_p = gat_init(0, gat_cfg, device=DEV)
    gat_want = gat_apply(_tree_cpu(gat_p), gat_cfg, feats_c, graph_c)
    agree_cpu("GAT", gat_apply(gat_p, gat_cfg, feats, graph), gat_want)
    slope0 = dataclasses.replace(gat_cfg, negative_slope=0.0)
    expect_rejected("GAT with LeakyReLU slope 0", lambda: agree_cpu(
        "GAT, slope 0 (control)", gat_apply(gat_p, slope0, feats, graph), gat_want))
    fields["gat_ms"] = time_ms(lambda: gat_apply(gat_p, gat_cfg, feats, graph), iters=10)
    fields["gat_edges_per_s"] = edges / (fields["gat_ms"] * 1e-3)

    gcn_cfg = GCNConfig(in_features=d, out_features=d)
    gcn_p = gcn_init(0, gcn_cfg, device=DEV)
    agree_cpu("GCN", gcn_apply(gcn_p, gcn_cfg, feats, graph),
              gcn_apply(_tree_cpu(gcn_p), gcn_cfg, feats_c, graph_c))
    fields["gcn_ms"] = time_ms(lambda: gcn_apply(gcn_p, gcn_cfg, feats, graph), iters=10)
    for agg in ("sum", "mean", "max"):
        agree_cpu(f"propagate {agg}", propagate(feats, graph, aggregate=agg),
                  propagate(feats_c, graph_c, aggregate=agg))
        fields[f"propagate_{agg}_ms"] = time_ms(
            lambda: propagate(feats, graph, aggregate=agg), iters=10)

    # the per-node mechanisms: q = features, k = v = the neighbors'. The
    # linear mechanism on the ReLU kernel: FAVOR+ (the default) underflows
    # to 0 at these features' ||x||^2 ~ 136, and ELU's normaliser nears 0
    nbr = feats[graph.nbr_idx.long()]
    rows = slice(0, GNN_ROWS)
    q_c, nbr_c, mask_c = feats_c[rows], nbr[rows].cpu(), graph_c.nbr_mask[rows]
    mechanisms = {
        "edge_featured": EdgeFeaturedConfig(node_dim=d, num_heads=heads),
        "linear": LinearAttentionConfig(dim=d, kernel="relu"),
        "hyperbolic": None,
        "diffusion": DiffusionConfig(dim=d),
        "sliced_wasserstein": TransportConfig(dim=d),
        "centroid_ot": TransportConfig(dim=d),
        "info_bottleneck": IBConfig(dim=d),
    }
    for name, cfg in mechanisms.items():
        mech = get_attention(name)
        params = mech.init(0, cfg, DEV) if mech.init is not None else None
        out = mech.apply(params, cfg, feats, nbr, nbr, graph.nbr_mask)
        if out.shape != (n, d) or not bool(torch.isfinite(out).all()):
            raise AssertionError(f"{name}: output not finite or of the wrong shape")
        agree_cpu(f"{name} attention, first {GNN_ROWS} rows", out[rows],
                  mech.apply(_tree_cpu(params), cfg, q_c, nbr_c, nbr_c, mask_c))
        fields[f"{name}_ms"] = time_ms(
            lambda: mech.apply(params, cfg, feats, nbr, nbr, graph.nbr_mask), iters=10)
    del nbr

    # the sequence forms over the first S nodes' features
    lg = get_attention("local_global")
    x_lg = feats[:GNN_LG_S]
    agree_cpu(f"local_global S={GNN_LG_S}", lg.apply(None, None, x_lg, x_lg, x_lg, None,
                                                      local_window=64, num_global=4),
              lg.apply(None, None, x_lg.cpu(), x_lg.cpu(), x_lg.cpu(), None,
                       local_window=64, num_global=4))
    fields["local_global_ms"] = time_ms(lambda: lg.apply(
        None, None, x_lg, x_lg, x_lg, None, local_window=64, num_global=4), iters=10)
    sheaf = get_attention("sheaf")
    sheaf_cfg = SheafAttentionConfig(dim=d, restriction_dim=d, residual_sparse_threshold=0.5)
    sheaf_p = sheaf.init(0, sheaf_cfg, DEV)
    x_sh = feats[:GNN_SHEAF_S]
    agree_cpu(f"sheaf S={GNN_SHEAF_S}, threshold 0.5",
              sheaf.apply(sheaf_p, sheaf_cfg, x_sh, x_sh, x_sh),
              sheaf.apply(_tree_cpu(sheaf_p), sheaf_cfg, x_sh.cpu(), x_sh.cpu(), x_sh.cpu()))
    fields["sheaf_ms"] = time_ms(lambda: sheaf.apply(sheaf_p, sheaf_cfg, x_sh, x_sh, x_sh),
                                 iters=10)

    # three trainable steps: edge-featured attention of a batch of nodes
    # over their neighborhoods, fitted to the nodes' own features
    ta = TrainableAttention("edge_featured", EdgeFeaturedConfig(node_dim=d, num_heads=heads),
                            seed=0, device=DEV)
    start = [p.clone() for p in _flat_dict(ta.params)]
    batch = torch.randperm(n, generator=torch.Generator().manual_seed(0))[:GNN_TRAIN_BATCH]
    batch = batch.to(DEV)
    q_b, k_b = feats[batch], feats[graph.nbr_idx[batch].long()]
    losses, steps_ms = [], []
    for _ in range(GNN_TRAIN_STEPS):
        loss, ms = _synced_ms(lambda: ta.train_step(q_b, k_b, k_b, q_b))
        losses.append(loss)
        steps_ms.append(round(ms, 3))
    moved = max(float((a - b).abs().max()) for a, b in zip(_flat_dict(ta.params), start))
    if not all(np.isfinite(losses)) or not moved > 0:
        raise AssertionError(f"trainable steps: losses {losses}, parameters moved {moved}")

    if kernels.launch_counts() != before:
        raise AssertionError("the GNN and attention families launched a kernel")
    say("gnn_family", nodes=n, d=d, edges=edges, fanouts=list(GNN_FANOUTS), heads=heads,
        **fields, trainable_steps_ms=steps_ms, trainable_losses=losses,
        trainable_max_param_move=moved, kernel_launches=0,
        seconds=round(time.perf_counter() - t_phase, 1))


def equal_cpu(name: str, got, want) -> None:
    """An integer, mask or word output of the card equal to the CPU's, bit
    for bit."""
    got, want = got.cpu(), want.cpu()
    same = got.shape == want.shape and bool(torch.equal(got, want))
    differ = int((got != want).sum()) if got.shape == want.shape else -1
    say("equal", name=f"{name}: card vs CPU", shape=list(got.shape), differ=differ, ok=same)
    if not same:
        raise AssertionError(f"{name}: the card's values differ from the CPU's")


def control_far(name: str, got: torch.Tensor, want: torch.Tensor, check) -> None:
    """A planted control: first that it moves the output well past the
    limit (10x the f32 max), then that the check rejects it."""
    err = float((got.float().cpu() - want.float().cpu()).abs().max())
    far = err > 10 * TOL[torch.float32][0]
    say("control_size", name=name, max_abs_err=err, limit=TOL[torch.float32][0], far=far)
    if not far:
        raise AssertionError(f"control {name} moves the output by only {err}")
    expect_rejected(name, check)


def _unit_rows(x: torch.Tensor) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)


def phase_attention_rest(feats: torch.Tensor, graph: NeighborGraph, d: int) -> None:
    """The rest of the attention family on the 100k-node graph
    (`[attention_rest]`), seed-0 weights on the card, no kernel: the
    per-node mechanisms dual_space, mixed_curvature, lorentz_cascade,
    coherence_gated and moe (3 experts, top-2, 64 features) through the
    registry (q = features, k = v = the 16 neighbors'); the ten SDK
    presets, each in its own form, on unit rows; the min-cut gate over
    the 390 consecutive 256-node sequences (q = k = v), at lam 0.5 and at
    the first lam of 1, 2, 4, 8, ... at which gates cut, its masks against
    the host Dinic on the first 8 sequences' logits; the CGT over the first
    8192 nodes. Each output against the same function on the CPU (f32
    limits on the first GNN_ROWS rows; masks, lanes and layer counts
    equal); dual-space attention without its hyperbolic branch must be
    rejected. Times: medians of 10 calls (CUDA events)."""
    t_phase = time.perf_counter()
    before = kernels.launch_counts()
    n = graph.num_nodes
    fields = {}
    nbr = feats[graph.nbr_idx.long()]
    rows = slice(0, GNN_ROWS)
    q_c, nbr_c, mask_c = feats[rows].cpu(), nbr[rows].cpu(), graph.nbr_mask[rows].cpu()

    mechanisms = {
        "dual_space": DualSpaceConfig(dim=d),
        "mixed_curvature": MixedCurvatureConfig(dim=d),
        "lorentz_cascade": None,
        "coherence_gated": TopologyConfig(dim=d),
        "moe": MoEAttentionConfig(dim=d, num_experts=3, top_k=2, num_features=64),
    }
    for name, cfg in mechanisms.items():
        mech = get_attention(name)
        params = mech.init(0, cfg, DEV) if mech.init is not None else None
        out = mech.apply(params, cfg, feats, nbr, nbr, graph.nbr_mask)
        if out.shape != (n, d) or not bool(torch.isfinite(out).all()):
            raise AssertionError(f"{name}: output not finite or of the wrong shape")
        want = mech.apply(_tree_cpu(params), cfg, q_c, nbr_c, nbr_c, mask_c)
        agree_cpu(f"{name} attention, first {GNN_ROWS} rows", out[rows], want)
        fields[f"{name}_ms"] = time_ms(
            lambda: mech.apply(params, cfg, feats, nbr, nbr, graph.nbr_mask), iters=10)
        if name == "lorentz_cascade":
            # a curvature of 2 in place of 1 only rescales distances that are
            # near-equal on these neighbors: recorded, too small a control
            c2 = lorentz_cascade_attention(feats[rows], nbr[rows], nbr[rows],
                                           graph.nbr_mask[rows], curvatures=(0.5, 2.0, 2.0))
            fields["lorentz_curvature_2_move"] = float((c2.cpu() - want).abs().max())
        if name == "dual_space":
            # control: the hyperbolic branch dropped (all weight on the
            # Euclidean scores)
            euc_only = dataclasses.replace(cfg, hyperbolic_weight=0.0)
            bad = mech.apply(params, euc_only, feats[rows], nbr[rows], nbr[rows],
                             graph.nbr_mask[rows])
            control_far("dual_space without its hyperbolic branch", bad, want,
                        lambda: agree_cpu("dual_space, Euclidean only (control)", bad, want))
    tcfg = mechanisms["coherence_gated"]
    _, lam2 = coherence_gated_attention(feats, nbr, nbr, graph.nbr_mask, tcfg)
    _, lam2_c = coherence_gated_attention(q_c, nbr_c, nbr_c, mask_c, tcfg)
    agree_cpu(f"coherence_gated lambda_2, first {GNN_ROWS} rows", lam2[rows], lam2_c)
    equal_cpu("coherence_gated fragmented rows", lam2[rows] < tcfg.coherence_threshold,
              lam2_c < tcfg.coherence_threshold)
    fields["fragmented_share"] = float((lam2 < tcfg.coherence_threshold).float().mean())
    # every neighborhood here lies in one cluster: lambda_2 well above the
    # threshold, the fragmented branch is the CPU tests' to check
    fields["lambda2_min_median"] = [float(lam2.min()), float(lam2.median())]
    fields["lambda2_within_1e-5_of_threshold"] = int(
        ((lam2 - tcfg.coherence_threshold).abs() < 1e-5).sum())
    del nbr

    # the ten SDK presets at dim d, each in its own form, on unit rows
    # (FAVOR+, the performer's kernel, underflows to 0 at ||x||^2 ~ 136)
    unit = _unit_rows(feats)
    unbr = unit[graph.nbr_idx.long()]
    x_lg = unit[:GNN_LG_S]
    preset_ms = {}
    for name in PRESETS:
        built = preset(name, d, device=DEV)
        built_c = dataclasses.replace(built, params=_tree_cpu(built.params))
        if name == "longformer":
            call = lambda b=built: b(x_lg, x_lg, x_lg, local_window=64, num_global=4)  # noqa: E731
            want = built_c(x_lg.cpu(), x_lg.cpu(), x_lg.cpu(), local_window=64, num_global=4)
            got = call()
        else:
            call = lambda b=built: b(unit, unbr, unbr, graph.nbr_mask)  # noqa: E731
            got = call()[rows]
            want = built_c(unit[rows].cpu(), unbr[rows].cpu(), unbr[rows].cpu(), mask_c)
        agree_cpu(f"preset {name}", got, want)
        preset_ms[name] = time_ms(call, iters=10)
    fields["preset_ms"] = json.dumps(preset_ms, separators=(",", ":"))
    del unbr

    fields.update(_mincut_rest(feats, d))
    fields.update(_cgt_rest(feats, unit, d))

    if kernels.launch_counts() != before:
        raise AssertionError("the attention family launched a kernel")
    say("attention_rest", nodes=n, d=d, **fields, kernel_launches=0,
        seconds=round(time.perf_counter() - t_phase, 1))


def _mincut_rest(feats: torch.Tensor, d: int) -> dict:
    """attn_mincut_device_batched over the features' consecutive
    MC_SEQ-node sequences (q = k = v). The masks of the first MC_HOST
    sequences against the host Dinic (dynamic_min_cut, attn_mincut's gate)
    and the CPU push-relabel on the same logits, bit for bit; the card's
    output against the CPU's masked softmax of those logits."""
    k = feats.shape[0] // MC_SEQ
    xs = feats[:k * MC_SEQ].reshape(k, MC_SEQ, d)
    # attn_mincut_device_batched's own product, so the same logits
    logits = torch.matmul(xs, xs.transpose(1, 2)) / (d ** 0.5)
    pos = logits > MC_EPS
    lg_c = logits[:MC_HOST].cpu()
    fields, cuts = {"sequences": k, "seq_len": MC_SEQ}, {}

    def gate(lam):
        out, keep, cost = attn_mincut_device_batched(xs, xs, xs, lam, MC_EPS)
        cuts[lam] = int((keep != pos).any(dim=(1, 2)).sum())
        return out, keep, cost

    def against_host(lam, out, keep, cost):
        host_costs = []
        for i in range(MC_HOST):
            host = dynamic_min_cut(lg_c[i].numpy(), MC_SEQ, lam, 2, MC_EPS)
            equal_cpu(f"min-cut lam {lam} sequence {i}: card gate vs host Dinic",
                      keep[i].reshape(-1), torch.from_numpy(host.keep_mask))
            c = float(cost[i])
            if abs(c - host.cut_cost) > 2e-3 * abs(host.cut_cost):
                raise AssertionError(f"min-cut lam {lam} sequence {i}: cut cost {c} "
                                     f"against the host's {host.cut_cost}")
            host_costs.append(round(host.cut_cost, 4))
        keep_c = mincut_gate_stats(lg_c, lam, MC_EPS)[0]
        equal_cpu(f"min-cut lam {lam}, first {MC_HOST}: card vs CPU push-relabel",
                  keep[:MC_HOST], keep_c)
        agree_cpu(f"min-cut gated attention lam {lam}, first {MC_HOST} sequences",
                  out[:MC_HOST], masked_softmax(lg_c, keep_c.float(), dim=-1) @ xs[:MC_HOST].cpu())
        fields[f"host_cut_costs_lam_{lam}"] = host_costs

    lam = 0.5
    against_host(lam, *gate(lam))
    if cuts[lam] == 0:
        # no gate cuts at 0.5: the smallest lam of 1, 2, 4, ... at which some do
        lam = 1.0
        res = gate(lam)
        while cuts[lam] == 0:
            if lam >= MC_LAM_MAX:
                raise AssertionError(f"no gate cuts at lam up to {lam}: {cuts}")
            lam *= 2
            res = gate(lam)
        against_host(lam, *res)
    lam_cut = lam
    rounds = mincut_gate_stats(logits, lam_cut, MC_EPS)[4]
    fields["cuts_applied"] = json.dumps({str(lam): c for lam, c in cuts.items()},
                                        separators=(",", ":"))
    fields["lam_cut"] = lam_cut
    fields["rounds_at_lam_cut"] = {"max": int(rounds.max()), "median": float(rounds.float().median())}
    for lam in (0.5, lam_cut):
        fields[f"mincut_ms_lam_{lam}"] = time_ms(
            lambda: attn_mincut_device_batched(xs, xs, xs, lam, MC_EPS), iters=10, warmup=1)
    return fields


def _cgt_rest(feats: torch.Tensor, unit: torch.Tensor, d: int) -> dict:
    """cgt_forward over the first GNN_SHEAF_S nodes: on the features with
    the default router, sparse and early-exit configs; and on unit rows
    with every token in the standard lane (the residual-sparse mask, the
    early exit, 4 layers at most) and in the deep lane (full attention and
    the FFN, 3 layers at most), whose CPU references cost about a second a
    layer. Against the CPU: outputs, layers_used and lanes. The
    residual-sparse mask and the router on the same energies, bit for bit."""
    fields = {}
    cfg_default = CgtConfig(dim=d)
    params = cgt_init(0, cfg_default, DEV)
    params_c = _tree_cpu(params)
    runs = {
        "default": (feats[:GNN_SHEAF_S], cfg_default, EarlyExitConfig()),
        "standard_lane": (unit[:GNN_SHEAF_S], dataclasses.replace(
            cfg_default, router=TokenRouterConfig(1e-6, 1e6, 2e6)),
            EarlyExitConfig(max_layers=4)),
        "deep_lane": (unit[:GNN_SHEAF_S], dataclasses.replace(
            cfg_default, router=TokenRouterConfig(1e-9, 2e-9, 1e9)),
            EarlyExitConfig(max_layers=3)),
    }
    for name, (x, cfg, ecfg) in runs.items():
        xf, n_layers, ema, conv, e0, lanes = cgt_forward(params, cfg, x, ecfg)
        xf_c, n_c, _, conv_c, _, lanes_c = cgt_forward(params_c, cfg, x.cpu(), ecfg)
        if (n_layers, conv) != (n_c, conv_c):
            raise AssertionError(f"CGT {name}: layers_used {n_layers} / converged {conv} "
                                 f"against the CPU's {n_c} / {conv_c}")
        agree_cpu(f"CGT {name}, S={GNN_SHEAF_S}", xf, xf_c)
        equal_cpu(f"CGT {name} lanes", lanes, lanes_c)
        stats = lane_statistics(lanes)
        reason = early_exit_result(n_layers, ema, conv, ecfg, e0)[0].exit_reason.name
        fields[f"cgt_{name}"] = json.dumps(
            {"layers_used": n_layers, "exit": reason,
             "lanes": [stats.reflex_count, stats.standard_count, stats.deep_count,
                       stats.escalate_count],
             "ms": time_ms(lambda: cgt_forward(params, cfg, x, ecfg), iters=10, warmup=1)},
            separators=(",", ":"))
    # the mask and the router on identical energies (the unit rows')
    e = edge_energies(params["sheaf"], unit[:GNN_SHEAF_S])
    e_c = e.cpu()
    scfg = SparseResidualConfig(residual_threshold=2.2)
    mask = residual_sparse_mask(e, scfg)
    equal_cpu(f"residual-sparse mask S={GNN_SHEAF_S}", mask, residual_sparse_mask(e_c, scfg))
    token = e.sum(-1)
    qs = torch.sort(token / GNN_SHEAF_S).values
    # thresholds midway between neighbouring energies at the quartiles
    cut = [float((qs[i - 1] + qs[i]) / 2) for i in (len(qs) // 4, len(qs) // 2, 3 * len(qs) // 4)]
    rcfg = TokenRouterConfig(*cut)
    lanes = route_by_energy(token, rcfg, GNN_SHEAF_S)
    equal_cpu("router lanes at the quartiles", lanes, route_by_energy(token.cpu(), rcfg, GNN_SHEAF_S))
    fields["sparse_mask_sparsity"] = sparsity_statistics(mask).sparsity
    fields["quartile_router_lanes"] = dataclasses.astuple(lane_statistics(lanes))
    return fields


# ---------------------------------------------------------------------------
# the solvers and the rest of the graph transformers (plain PyTorch)
# ---------------------------------------------------------------------------

def spd_system(graph: NeighborGraph, weight: float):
    """COO (rows, cols, vals, n) of A = L_w + I on the symmetrised graph:
    off-diagonal -weight * w_ij (the mean of w_ij and w_ji where both
    edges exist), diagonal 1 + the row's off-diagonal sum. Diagonally
    dominant and SPD, as tests/test_solver_quant.py's systems."""
    n = graph.num_nodes
    mask = graph.nbr_mask.cpu().numpy().ravel() > 0
    src = np.repeat(np.arange(n), graph.max_degree)[mask]
    dst = graph.nbr_idx.cpu().numpy().astype(np.int64).ravel()[mask]
    w = graph.edge_weight.cpu().numpy().astype(np.float64).ravel()[mask]
    off = src != dst
    r = np.concatenate([src[off], dst[off]])
    c = np.concatenate([dst[off], src[off]])
    key, inv = np.unique(r * n + c, return_inverse=True)
    vals = weight * np.bincount(inv, weights=np.concatenate([w[off], w[off]])) / np.bincount(inv)
    r, c = key // n, key % n
    diag = 1.0 + np.bincount(r, weights=vals, minlength=n)
    return (np.concatenate([r, np.arange(n)]), np.concatenate([c, np.arange(n)]),
            np.concatenate([-vals, diag]), n)


def grid_laplacian(side: int):
    """2-D grid Laplacian + I as COO (tests/test_solver_quant.py:219)."""
    n = side * side
    i, j = np.divmod(np.arange(n), side)
    rows, cols = [np.arange(n)], [np.arange(n)]
    deg = np.zeros(n)
    for di, dj in ((1, 0), (-1, 0), (0, 1), (0, -1)):
        ok = (i + di >= 0) & (i + di < side) & (j + dj >= 0) & (j + dj < side)
        rows.append(np.arange(n)[ok])
        cols.append(((i + di) * side + j + dj)[ok])
        deg += ok
    vals = [deg + 1.0] + [-np.ones(len(r)) for r in rows[1:]]
    return np.concatenate(rows), np.concatenate(cols), np.concatenate(vals), n


def _csr_both(rows, cols, vals, n):
    return (CSRGraph.from_edges(rows, cols, vals, n, device=DEV),
            CSRGraph.from_edges(rows, cols, vals, n, device="cpu"))


def _rel_residual(mat: CSRGraph, x: torch.Tensor, b: torch.Tensor) -> float:
    r = b - spmm_csr(mat, x[:, None])[:, 0]
    return float(torch.linalg.vector_norm(r) / torch.linalg.vector_norm(b))


def agree_solve(name: str, got, want, tol=SV_X_TOL) -> None:
    """A solve on the card against the same solve on the CPU: iteration
    counts within one (a norm at the tolerance), the same verdict, x
    within `tol`."""
    same_run = abs(got.iterations - want.iterations) <= 1 and got.converged == want.converged
    say("agree", name=f"{name}: iterations and verdict, card vs CPU",
        iterations=[got.iterations, want.iterations],
        converged=[got.converged, want.converged], ok=same_run)
    if not same_run:
        raise AssertionError(f"{name}: the card's run differs from the CPU's")
    agree(f"{name} x", got.x.cpu(), want.x, torch.float32, tol)


def phase_solver(graph: NeighborGraph) -> None:
    """The solvers on the 100k-node graph (`[solver]`, no kernel): the SPD
    system A = L_w + I of the symmetrised kNN graph (weights times
    SV_WEIGHT) and a right-hand side from a seed; CG with and without the
    Jacobi preconditioner, Jacobi and, on A scaled by its largest row sum
    (rho(I - A) < 1), the Neumann series; forward and backward push,
    power-iteration and random-walk PPR from node 0 on the kNN graph; the
    TRUE solver's sketched solve; the orchestrator's dispatch on A (CG)
    and on the scaled A (Neumann); BMSSP on tests/test_solver_quant.py's
    grid (the kNN graph's aggregation is reported: it finds no strong
    connection). Each card result against the same function on the CPU
    from the same inputs; ms (host clock, synchronised), iterations and
    the relative residual of each."""
    t_phase = time.perf_counter()
    before = kernels.launch_counts()
    rows, cols, vals, n = spd_system(graph, SV_WEIGHT)
    rowmax = float(np.max(np.bincount(rows, weights=np.abs(vals), minlength=n)))
    A, A_c = _csr_both(rows, cols, vals, n)
    As, As_c = _csr_both(rows, cols, vals / rowmax, n)
    b_c = torch.from_numpy(np.random.default_rng(5).normal(size=n).astype(np.float32))
    b, bs_c = b_c.to(DEV), b_c / rowmax
    bs = bs_c.to(DEV)
    fields = dict(nnz=len(vals), rowmax=rowmax)

    solves = {
        "cg": lambda m, ms_, rhs, rhs_s: cg_solve(m, rhs, tolerance=SV_TOL,
                                                  max_iterations=SV_MAX_ITERS),
        "cg_jacobi": lambda m, ms_, rhs, rhs_s: cg_solve(
            m, rhs, tolerance=SV_TOL, max_iterations=SV_MAX_ITERS, use_preconditioner=True),
        "jacobi": lambda m, ms_, rhs, rhs_s: jacobi_solve(m, rhs, tolerance=SV_TOL,
                                                          max_iterations=SV_MAX_ITERS),
        "neumann": lambda m, ms_, rhs, rhs_s: neumann_solve(
            ms_, rhs_s, tolerance=SV_TOL / rowmax, max_iterations=SV_MAX_ITERS),
    }
    for name, solve in solves.items():
        got = solve(A, As, b, bs)
        agree_solve(name, got, solve(A_c, As_c, b_c, bs_c))
        _, ms = _synced_ms(lambda: solve(A, As, b, bs))     # the second call, warm
        fields[f"{name}_ms"] = round(ms, 3)
        fields[f"{name}_iterations"] = got.iterations
        fields[f"{name}_residual"] = _rel_residual(A, got.x, b)
        if not got.converged:
            raise AssertionError(f"{name} did not converge on the SPD system")
    # 20 power iterations stop short of convergence, so the rounding of
    # each device's sums shows in the estimate: 1e-4 relative (3e-5 read
    # on an H100)
    rho, ms = _synced_ms(lambda: estimate_spectral_radius(As))
    rho_c = estimate_spectral_radius(As_c)
    say("agree", name="spectral radius of I - A/rowmax: card vs CPU", rho=[rho, rho_c],
        rtol=1e-4, ok=abs(rho - rho_c) <= 1e-4 * rho_c)
    if abs(rho - rho_c) > 1e-4 * rho_c:
        raise AssertionError("the spectral radius on the card differs from the CPU's")
    fields.update(spectral_radius=rho, spectral_radius_ms=round(ms, 3))

    # PageRank from node 0 on the kNN graph (directed, as built)
    G = graph.to_csr()
    G_c = CSRGraph(G.row_ptr.cpu(), G.col_idx.cpu(), G.values.cpu(), G.num_nodes)
    power, ms = _synced_ms(lambda: ppr_power_iteration(G, 0, 0.15, iters=50))
    agree("ppr_power_iteration: card vs CPU", power.cpu(),
          ppr_power_iteration(G_c, 0, 0.15, iters=50), torch.float32)
    fields["ppr_power_ms"] = round(ms, 3)
    for name, fn in (("forward_push", forward_push_ppr), ("backward_push", backward_push_ppr)):
        x, ms = _synced_ms(lambda: fn(G, 0, 0.15, SV_PUSH_EPS, SV_SWEEPS))
        agree(f"{name}_ppr: card vs CPU", x.cpu(), fn(G_c, 0, 0.15, SV_PUSH_EPS, SV_SWEEPS),
              torch.float32)
        fields[f"{name}_ms"] = round(ms, 3)
        fields[f"{name}_mass"] = float(x.sum())
    seed0 = torch.zeros(n, device=DEV)
    seed0[0] = 1.0
    push_x, _, sweeps = sv_push._push_sweeps(G, seed0, 0.15, SV_PUSH_EPS, SV_SWEEPS)
    fields.update(forward_push_sweeps=sweeps,
                  forward_push_l1_to_power=float((push_x - power).abs().sum()))
    mc, ms = _synced_ms(lambda: random_walk_ppr(G, 0, 0.15, SV_WALKS, SV_WALK_LEN, seed=0))
    equal_cpu("random_walk_ppr (the same draws)", mc,
              random_walk_ppr(G_c, 0, 0.15, SV_WALKS, SV_WALK_LEN, seed=0))
    fields.update(random_walk_ms=round(ms, 3),
                  random_walk_l1_to_power=float((mc - power).abs().sum()))

    # the TRUE solver's sketched solve (the sketch from its seed: the same
    # on both devices)
    ts_, ms = _synced_ms(lambda: TrueSolver(tolerance=0.1).preprocess(A))
    x_true, ms_solve = _synced_ms(lambda: ts_.solve(A, b))
    agree_scaled("TrueSolver x: card vs CPU", x_true.cpu(),
                 TrueSolver(tolerance=0.1).preprocess(A_c).solve(A_c, b_c), torch.float32)
    fields.update(true_k=ts_._prep[0].shape[0], true_preprocess_ms=round(ms, 3),
                  true_solve_ms=round(ms_solve, 3), true_residual=_rel_residual(A, x_true, b))

    # the orchestrator: profile, route, solve; the scaled A goes to the
    # Neumann series (rho(I - A) < 0.95), A itself, whose hubs give it a
    # rho(I - A) far above 1, to CG
    for tag, m, m_c, rhs, rhs_c, tol, route in (
            ("A", A, A_c, b, b_c, SV_TOL, None),
            ("A_scaled", As, As_c, bs, bs_c, SV_TOL / rowmax, "neumann")):
        (res, algo), ms = _synced_ms(lambda: SolverOrchestrator().solve(m, rhs, tolerance=tol))
        res_c, algo_c = SolverOrchestrator().solve(m_c, rhs_c, tolerance=tol)
        ok = algo == algo_c and route in (None, algo) and res.converged
        say("agree", name=f"orchestrator on {tag}: card vs CPU", algo=[algo, algo_c], ok=ok)
        if not ok:
            raise AssertionError(f"orchestrator on {tag}: {algo} (CPU {algo_c}, expected "
                                 f"{route}), converged {res.converged}")
        agree_solve(f"orchestrator {algo} on {tag}", res, res_c)
        fields[f"orchestrator_{tag}_algo"] = algo
        fields[f"orchestrator_{tag}_ms"] = round(ms, 3)

    # BMSSP: the AMG V-cycles on the grid; on the kNN system the
    # aggregation is only counted (every node its own aggregate would make
    # the coarsest level the whole graph)
    t0 = time.perf_counter()
    fields["bmssp_knn_aggregates"] = int(sv_bmssp._coarsen(rows, cols, vals, n).max()) + 1
    fields["bmssp_knn_aggregate_s"] = round(time.perf_counter() - t0, 3)
    g_rows, g_cols, g_vals, gn = grid_laplacian(SV_GRID)
    dense = np.zeros((gn, gn))
    dense[g_rows, g_cols] = g_vals
    x_grid = np.random.default_rng(0).normal(size=gn)
    b_grid = dense @ x_grid
    amg = BmsspSolver(tolerance=1e-5, max_cycles=SV_AMG_CYCLES, device=DEV).setup(
        g_rows, g_cols, g_vals, gn)
    (x_amg, rnorm, cycles), ms = _synced_ms(lambda: amg.solve(b_grid))
    x_amg_c, _, cycles_c = BmsspSolver(tolerance=1e-5, max_cycles=SV_AMG_CYCLES,
                                       device="cpu").setup(g_rows, g_cols, g_vals,
                                                           gn).solve(b_grid)
    agree("BMSSP x: card vs CPU", x_amg.cpu(), x_amg_c, torch.float32)
    err = float(np.abs(x_amg.cpu().numpy() - x_grid).max())
    if abs(cycles - cycles_c) > 1 or err > 5e-3:
        raise AssertionError(f"BMSSP: cycles {cycles} (CPU {cycles_c}), error {err}")
    fields.update(bmssp_grid=gn, bmssp_levels=[lv.n for lv in amg._levels], bmssp_cycles=cycles,
                  bmssp_ms=round(ms, 3), bmssp_residual=rnorm / float(np.linalg.norm(b_grid)),
                  bmssp_max_err=err)

    if kernels.launch_counts() != before:
        raise AssertionError("the solvers launched a kernel")
    say("solver", nodes=n, **fields, kernel_launches=0,
        seconds=round(time.perf_counter() - t_phase, 1))


def local_subgraph(graph: NeighborGraph, nodes: np.ndarray) -> NeighborGraph:
    """The subgraph induced on `nodes` (host ids), relabelled 0..len-1:
    neighbors outside it masked out."""
    pos = np.full(graph.num_nodes, -1, np.int64)
    pos[nodes] = np.arange(len(nodes))
    local = pos[graph.nbr_idx.cpu().numpy()[nodes]]
    inside = (local >= 0) & (graph.nbr_mask.cpu().numpy()[nodes] > 0)
    w = graph.edge_weight.cpu().numpy()[nodes]
    return NeighborGraph(torch.from_numpy(np.where(inside, local, 0).astype(np.int32)).to(DEV),
                         torch.from_numpy(inside.astype(np.float32)).to(DEV),
                         torch.from_numpy(np.where(inside, w, 0.0).astype(np.float32)).to(DEV))


def mutual_graph(graph: NeighborGraph) -> NeighborGraph:
    """The mutual kNN graph: edge (i, j) where j is among i's neighbors
    and i among j's. Symmetric, so the diffusion conserves mass."""
    idx = graph.nbr_idx.long()
    rows = torch.arange(graph.num_nodes, device=idx.device)[:, None, None]
    back = (graph.nbr_idx[idx] == rows).any(-1).to(graph.nbr_mask.dtype)
    return NeighborGraph(graph.nbr_idx, graph.nbr_mask * back, graph.edge_weight)


def _graph_cpu(graph: NeighborGraph) -> NeighborGraph:
    return NeighborGraph(graph.nbr_idx.cpu(), graph.nbr_mask.cpu(), graph.edge_weight.cpu())


def equal_up_to_ties(name: str, got, want, margin, tol: float) -> int:
    """Boolean outputs of the card against the CPU's: equal except where
    the quantity they threshold lies within `tol` of the threshold
    (`margin`, on the CPU), where the two devices' roundings may fall on
    either side. Returns the count of such ties."""
    differ = (got.cpu() != want.cpu())
    ties = int(differ.sum())
    ok = bool((margin[differ] < tol).all())
    say("equal", name=f"{name}: card vs CPU up to ties", differ=ties, tie_tol=tol, ok=ok)
    if not ok:
        raise AssertionError(f"{name}: the card differs from the CPU away from the threshold")
    return ties


def phase_graph_transformer_rest(feats: torch.Tensor, graph: NeighborGraph,
                                 local_nodes: np.ndarray, d: int, heads: int) -> None:
    """The rest of the graph transformers on the 100k-node graph
    (`[graph_transformer_rest]`, no kernel), seed-0 weights on the card:
    the 2-layer graph transformer block; LSH attention over the first
    GT_ROWS rows and PPR-sampled attention for GT_QUERIES query nodes;
    the Hamiltonian net (leapfrog, autograd forces) and the conservative
    PDE on the mutual kNN graph; spiking attention, STDP and Oja; the
    morphogenetic field, growth and coarsening; Ollivier-Ricci curvature
    and its routing on the graph-local GT_ROWS-node subgraph, geodesic
    message passing, Riemannian Adam; causal attention over GT_SEQ rows
    and Granger causality; Shapley and Nash attention and the incentive
    step; GT_TRAIN_STEPS verified Adam steps of the block on the local
    subgraph and its sealed certificate. Functions without a graph take
    the JAX tests' shapes or the features' rows. Each card output against
    the same function on the CPU (float32 limits; PPR on its first
    GT_CPU_QUERIES queries); ms are medians of 5 calls (CUDA events) or
    one synchronised call (host loops)."""
    t_phase = time.perf_counter()
    before = kernels.launch_counts()
    n = graph.num_nodes
    feats_c, graph_c = feats.cpu(), _graph_cpu(graph)
    local = local_subgraph(graph, local_nodes)
    local_c = _graph_cpu(local)
    x_loc = feats[torch.from_numpy(local_nodes).to(DEV)]
    fields = {}

    # the transformer block: 2 pre-norm layers of edge-featured attention
    # (the edge weight as its 1-d feature) and a tanh-GELU FFN
    bcfg = GraphTransformerConfig(dim=d, num_heads=heads, num_layers=2)
    bp = graph_transformer_init(0, bcfg, device=DEV)
    agree_cpu("graph_transformer_apply 2 layers", graph_transformer_apply(bp, bcfg, feats, graph),
              graph_transformer_apply(_tree_cpu(bp), bcfg, feats_c, graph_c))
    fields["block_ms"] = time_ms(lambda: graph_transformer_apply(bp, bcfg, feats, graph), iters=5)

    # LSH buckets on features and planes in steps of 1/16, whose products
    # and sums are exact in float32 in any order: the bucket bits are the
    # same on both devices (a dot product of float features near 0 may
    # fall on either side)
    x_lsh = torch.clamp(torch.round(feats[:GT_ROWS] * 16), -128, 127) / 16
    planes = torch.clamp(torch.round(lsh_planes(d, 4) * 16), -64, 63) / 16
    scfg = SublinearConfig(num_hashes=4, ppr_top_k=32)
    equal_cpu("lsh_bucket_assignments", lsh_bucket_assignments(x_lsh, 4, planes=planes),
              lsh_bucket_assignments(x_lsh.cpu(), 4, planes=planes))
    agree_cpu(f"lsh_bucket_attention N={GT_ROWS}", lsh_bucket_attention(x_lsh, scfg, planes),
              lsh_bucket_attention(x_lsh.cpu(), scfg, planes))
    fields["lsh_ms"] = time_ms(lambda: lsh_bucket_attention(x_lsh, scfg, planes), iters=5)
    csr = graph.to_csr()
    csr_c = CSRGraph(csr.row_ptr.cpu(), csr.col_idx.cpu(), csr.values.cpu(), n)
    queries = np.random.default_rng(1).choice(n, GT_QUERIES, replace=False)
    ppr_out, ms = _synced_ms(lambda: ppr_sampled_attention(feats, csr, queries, scfg))
    agree_cpu(f"ppr_sampled_attention, first {GT_CPU_QUERIES} queries",
              ppr_out[:GT_CPU_QUERIES],
              ppr_sampled_attention(feats_c, csr_c, queries[:GT_CPU_QUERIES], scfg))
    fields["ppr_attention_ms"] = round(ms, 3)

    # physics: leapfrog on the kNN graph from q = 0.1 x, p = 0 (the CPU
    # repeats it on the graph-local subgraph: a full-width step takes it
    # seconds); the PDE on the mutual graph
    net = HamiltonianGraphNet(PhysicsConfig(dt=0.01))
    q0, p0 = net.init_state(0.1 * feats)
    e0 = float(hamiltonian(q0, p0, graph, net.config))
    (q1, p1, energies), ms = _synced_ms(lambda: net.forward(q0, p0, graph, steps=GT_LEAPFROG))
    drift = abs(float(energies[-1]) - e0) / abs(e0)
    if drift >= 1e-3 or not bool(torch.isfinite(q1).all()):
        raise AssertionError(f"leapfrog energy drift {drift}")
    ql, pl = net.init_state(0.1 * x_loc)
    ql1, pl1, el = net.forward(ql, pl, local, steps=GT_LEAPFROG)
    ql1_c, pl1_c, el_c = net.forward(ql.cpu(), pl.cpu(), local_c, steps=GT_LEAPFROG)
    agree_cpu(f"Hamiltonian net q after {GT_LEAPFROG} steps, N={len(local_nodes)}", ql1, ql1_c)
    agree_cpu(f"Hamiltonian net p after {GT_LEAPFROG} steps, N={len(local_nodes)}", pl1, pl1_c)
    agree_scaled("Hamiltonian energies: card vs CPU", el.cpu(), el_c, torch.float32)
    fields.update(leapfrog_ms=round(ms, 3), energy_drift=drift)
    mutual = mutual_graph(graph)
    pde_args = dict(diffusion=0.1, dt=0.1, steps=5)
    (pde, mass_drift) = conservative_pde_attention(feats, mutual, **pde_args)
    pde_c, _ = conservative_pde_attention(feats_c, _graph_cpu(mutual), **pde_args)
    agree_cpu("conservative_pde_attention (mutual kNN graph)", pde, pde_c)
    rel_mass = abs(float(mass_drift)) / float(feats.abs().sum())
    if rel_mass >= 1e-6:
        raise AssertionError(f"the PDE moved the mass by {rel_mass} of sum|x|")
    fields.update(pde_ms=time_ms(lambda: conservative_pde_attention(feats, mutual, **pde_args),
                                 iters=5),
                  pde_mass_drift=rel_mass, mutual_edges=int(mutual.nbr_mask.sum()))

    # biological: spiking attention (the JAX test's threshold), one STDP
    # step on the kNN graph's weights, 200 Oja steps (the JAX test's shape)
    spk = SpikingGraphAttention(BiologicalConfig(threshold=0.5))
    agg, counts, v = spk.forward(feats, graph, steps=GT_SPIKE_STEPS)
    agg_c, counts_c, v_c = spk.forward(feats_c, graph_c, steps=GT_SPIKE_STEPS)
    equal_cpu("spiking attention spike counts", counts, counts_c)
    agree_cpu("spiking attention aggregate", agg, agg_c)
    agree_cpu("spiking attention potentials", v, v_c)
    fields.update(spiking_ms=time_ms(lambda: spk.forward(feats, graph, steps=GT_SPIKE_STEPS),
                                     iters=5), spikes=float(counts.sum()))
    gen = torch.Generator().manual_seed(3)
    pre_s, post_s = ((torch.rand(n, generator=gen) < 0.1).float() for _ in range(2))
    trace = torch.rand(n, generator=gen)
    w0 = torch.clamp(graph.edge_weight, 0.0, 1.0)
    stdp = lambda g, w, *a: stdp_update(w, *a, g)  # noqa: E731
    agree_cpu("stdp_update", stdp(graph, w0, trace.to(DEV), trace.to(DEV), pre_s.to(DEV),
                                  post_s.to(DEV))[0],
              stdp(graph_c, w0.cpu(), trace, trace, pre_s, post_s)[0])
    pre = torch.from_numpy(np.random.default_rng(0).normal(size=8).astype(np.float32))

    def oja(vec):
        w = torch.zeros((8, 8), device=vec.device)
        for _ in range(200):
            w = hebbian_update(w, vec, vec, rule="oja", lr=0.05)
        return w

    agree_cpu("hebbian_update oja, 200 steps", oja(pre.to(DEV)), oja(pre))
    kwta = torch.tensor([0.1, 3.0, 2.0, 5.0])
    equal_cpu("k_winners_take_all", k_winners_take_all(kwta.to(DEV), torch.ones(4, device=DEV), 2),
              k_winners_take_all(kwta, torch.ones(4), 2))

    # self-organizing: the field, growth from its scores, coarsening
    field = MorphogeneticField()
    a0, b0 = field.init_state(n, seed=0, device=DEV)
    (a1, b1, scores), ms = _synced_ms(lambda: field.step(a0, b0, graph, steps=GT_MORPH_STEPS))
    a1_c, b1_c, _ = field.step(a0.cpu(), b0.cpu(), graph_c, steps=GT_MORPH_STEPS)
    agree_cpu("morphogenetic field a", a1, a1_c)
    agree_cpu("morphogenetic field b", b1, b1_c)
    prog = DevelopmentalProgram(max_growth_budget=64, threshold=0.2)
    grown = prog.grow(graph, scores)
    equal_cpu("developmental growth (the card's scores)", torch.from_numpy(grown.new_edges),
              torch.from_numpy(prog.grow(graph_c, scores.cpu()).new_edges))
    coarsened, ms_coarsen = _synced_ms(lambda: GraphCoarsener().coarsen(graph, feats))
    coarsened_c = GraphCoarsener().coarsen(graph_c, feats_c)
    equal_cpu("coarsening aggregates", torch.from_numpy(coarsened.agg),
              torch.from_numpy(coarsened_c.agg))
    agree_cpu("coarse features", coarsened.coarse_features, coarsened_c.coarse_features)
    fields.update(morphogenetic_ms=round(ms, 3), grown_edges=grown.budget_used,
                  coarsen_ms=round(ms_coarsen, 3), coarse_nodes=coarsened.num_coarse)

    # manifold: curvature on the graph-local subgraph and its routing,
    # geodesic message passing inside the ball, Riemannian Adam
    kappa = estimate_ollivier_ricci(local)
    agree_cpu(f"estimate_ollivier_ricci N={len(local_nodes)}", kappa,
              estimate_ollivier_ricci(local_c))
    router = CurvatureAdaptiveRouter()
    agree_cpu("curvature routing", router.route_batch(kappa), router.route_batch(kappa.cpu()))
    fields.update(ricci_ms=time_ms(lambda: estimate_ollivier_ricci(local), iters=5),
                  mean_curvature=float(kappa.mean()),
                  local_edges=int(local.nbr_mask.sum()))
    x_ball = 0.5 * feats / float(torch.linalg.vector_norm(feats, dim=-1).max())
    agree_cpu("geodesic_message_passing", geodesic_message_passing(x_ball, graph),
              geodesic_message_passing(x_ball.cpu(), graph_c))
    fields["geodesic_ms"] = time_ms(lambda: geodesic_message_passing(x_ball, graph), iters=5)

    def radam(dev):
        target = torch.tensor([[0.3, 0.2]], device=dev)
        params = {"z": torch.tensor([[-0.4, 0.1]], device=dev)}
        state = riemannian_adam_init(params)
        for _ in range(100):
            z = params["z"].clone().requires_grad_(True)
            torch.sum(poincare_distance(z, target) ** 2).backward()
            params, state = riemannian_adam_update(params, {"z": z.grad}, state, lr=0.05)
        return params["z"]

    agree_cpu("riemannian_adam 100 steps", radam(DEV), radam("cpu"))

    # temporal: causal attention over the first GT_SEQ rows; Granger on
    # the JAX test's series
    seq = feats[:GT_SEQ]
    t_out, t_w = temporal_attention(seq)
    t_out_c, t_w_c = temporal_attention(seq.cpu())
    agree_cpu(f"temporal_attention T={GT_SEQ}", t_out, t_out_c)
    agree_cpu(f"temporal_attention weights T={GT_SEQ}", t_w, t_w_c)
    if not verify_causal_ordering(t_w):
        raise AssertionError("temporal attention moved mass from the future")
    fields["temporal_ms"] = time_ms(lambda: temporal_attention(seq), iters=5)
    rng = np.random.default_rng(42)
    xs = rng.normal(size=400).astype(np.float32)
    ys = np.zeros(400, np.float32)
    for i in range(2, 400):
        ys[i] = 0.8 * xs[i - 2] + 0.1 * rng.normal()
    ratio, causal = granger_causality(torch.from_numpy(xs).to(DEV), torch.from_numpy(ys))
    ratio_c, causal_c = granger_causality(xs, ys)
    say("agree", name="granger_causality: card vs CPU", ratio=[ratio, ratio_c],
        ok=causal and causal_c and abs(ratio - ratio_c) <= 1e-3 * ratio_c)
    if not (causal and causal_c and abs(ratio - ratio_c) <= 1e-3 * ratio_c):
        raise AssertionError("granger_causality: the card's ratio differs from the CPU's")
    fields["granger_ratio"] = ratio

    # economic: Shapley over GT_SHAPLEY_N rows (permutations from a seed,
    # the same on both devices), Nash over GT_NASH_N rows, the incentive
    # step on the whole graph
    xs_n = feats[:GT_SHAPLEY_N]
    query = xs_n[3] + 0.01 * torch.randn(d, generator=torch.Generator().manual_seed(4)).to(DEV)
    perms = shapley_permutations(GT_SHAPLEY_N, GT_SHAPLEY_P, seed=0)
    phi = shapley_attention(xs_n, query, perms)
    agree_cpu("shapley_attention", phi, shapley_attention(xs_n.cpu(), query.cpu(), perms))
    full = eco_coalition_value(xs_n, query, torch.ones(GT_SHAPLEY_N, device=DEV))
    if abs(float(phi.sum()) - float(full)) > 1e-3:
        raise AssertionError("Shapley values miss efficiency: sum(phi) != v(all) - v(empty)")
    fields["shapley_ms"] = time_ms(lambda: shapley_attention(xs_n, query, perms), iters=5)
    xn = feats[:GT_NASH_N]
    stakes = torch.ones(GT_NASH_N, device=DEV)
    alloc, payoffs = nash_attention(xn, stakes)
    alloc_c, payoffs_c = nash_attention(xn.cpu(), stakes.cpu())
    agree_cpu("nash_attention allocation", alloc, alloc_c)
    agree_scaled("nash_attention payoffs: card vs CPU", payoffs.cpu(), payoffs_c, torch.float32)
    fields["nash_ms"] = time_ms(lambda: nash_attention(xn, stakes), iters=5)
    state = IncentiveState(stakes=torch.ones(n, device=DEV))
    cons, new_state, slashed = incentive_aligned_step(feats, graph.nbr_idx, graph.nbr_mask, state)
    cons_c, _, slashed_c = incentive_aligned_step(feats_c, graph_c.nbr_idx, graph_c.nbr_mask,
                                                  IncentiveState(stakes=torch.ones(n)))
    agree_cpu("incentive consensus", cons, cons_c)
    dev_c = torch.linalg.vector_norm(feats_c - cons_c, dim=-1)
    thr = torch.mean(dev_c) + 2.0 * torch.std(dev_c, correction=0)
    equal_up_to_ties("incentive slashing", slashed, slashed_c, (dev_c - thr).abs() / thr, 1e-5)
    fields.update(incentive_ms=time_ms(lambda: incentive_aligned_step(
        feats, graph.nbr_idx, graph.nbr_mask, state), iters=5), slashed=int(slashed.sum()))

    # verified training: GT_TRAIN_STEPS Adam steps of the block on the
    # local subgraph (its features reconstructed), then the certificate
    def trainer(dev, g):
        def loss(p, batch):
            return torch.mean((graph_transformer_apply(p, bcfg, batch, g) - batch) ** 2)

        invs = [LossStabilityBound(), WeightNormBound(), LipschitzBound(tolerance=1e4),
                EnergyGateInvariant()]
        return VerifiedTrainer(loss, adam(1e-3), graph_transformer_init(0, bcfg, device=dev),
                               invs)

    vt, vt_c = trainer(DEV, local), trainer("cpu", local_c)
    steps_ms = []
    for _ in range(GT_TRAIN_STEPS):
        r, ms = _synced_ms(lambda: vt.train_step(x_loc))
        r_c = vt_c.train_step(x_loc.cpu())
        steps_ms.append(round(ms, 3))
        same = (r.committed and r_c.committed and abs(r.loss - r_c.loss) <= 1e-4 * abs(r_c.loss)
                and all(c.passed == cc.passed for c, cc in zip(r.checks, r_c.checks)))
        say("agree", name=f"verified step {r.step}: card vs CPU", loss=[r.loss, r_c.loss],
            committed=[r.committed, r_c.committed], ok=same)
        if not same:
            raise AssertionError("verified training: the card's step differs from the CPU's")
    # Adam's first steps are +-lr wherever a gradient is far above eps: an
    # entry whose gradient is rounding noise on one device may step the
    # other way, by at most 2 lr a step
    for got, want in zip(sorted_leaves(vt.params), sorted_leaves(vt_c.params)):
        agree("verified weights: card vs CPU", got.cpu(), want, torch.float32,
              (2e-3 * GT_TRAIN_STEPS, 1e-6))
    cert, cert_again = vt.seal(), vt.seal()
    flat = np.concatenate([t.cpu().numpy().ravel() for t in sorted_leaves(vt.params)])
    sealed = (cert == cert_again and cert.committed_steps == GT_TRAIN_STEPS
              and cert.final_weights_hash == hashlib.sha256(flat.tobytes()).hexdigest())
    say("agree", name="verified certificate", steps=cert.steps,
        committed=cert.committed_steps, violations=cert.total_violations,
        chain_equal_cpu=cert.chain_hash == vt_c.seal().chain_hash, ok=sealed)
    if not sealed:
        raise AssertionError("the verified certificate is not the sealed weights' hash")
    fields.update(verified_step_ms=steps_ms, verified_losses=[r.loss for r in vt.step_results])

    if kernels.launch_counts() != before:
        raise AssertionError("the graph transformers launched a kernel")
    say("graph_transformer_rest", nodes=n, d=d, heads=heads, **fields, kernel_launches=0,
        seconds=round(time.perf_counter() - t_phase, 1))


def phase_contrastive(params, cfg, feats, graph) -> None:
    """The RuvectorLayer's contrastive train step (TrainConfig defaults:
    batch 256, 64 negatives, tau 0.07) with Adam (lr 1e-3) on the 100k-node
    graph: anchors and negatives drawn on the host outside the timed
    window; the losses must be finite and the parameters must move."""
    tcfg = TrainConfig()
    opt = adam(tcfg.learning_rate)
    step = make_train_step(cfg, opt, tcfg)
    gen = torch.Generator().manual_seed(0)
    p, state, times, losses = params, opt.init(params), [], []
    for _ in range(CONTRASTIVE_STEPS):
        anchors = torch.randperm(graph.num_nodes, generator=gen)[:tcfg.batch_size].int()
        negs = sample_negatives(gen, graph, anchors, tcfg.n_negatives)
        (p, state, loss), ms = _synced_ms(lambda: step(p, state, feats, graph, anchors.to(DEV),
                                                       negs.to(DEV)))
        times.append(ms)
        losses.append(float(loss))
    moved = max(float((a - b).abs().max()) for a, b in
                zip(_flat_dict(p), _flat_dict(params)))
    if not all(np.isfinite(losses)) or not moved > 0:
        raise AssertionError(f"contrastive step: losses {losses}, parameters moved {moved}")
    say("contrastive", nodes=graph.num_nodes, batch=tcfg.batch_size,
        negatives=tcfg.n_negatives, temperature=tcfg.temperature, lr=tcfg.learning_rate,
        optimizer="adam", step_ms=statistics.median(times),
        steps_ms=[round(t, 3) for t in times], losses=losses, max_param_move=moved)


def _flat_dict(tree):
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _flat_dict(tree[k])]
    return [tree]


# ---------------------------------------------------------------------------
# SONA and the training utilities (plain PyTorch and host numpy, no kernel
# but the profiled K1 layer)
# ---------------------------------------------------------------------------

def _sona_stream(feats: torch.Tensor, graph: NeighborGraph, labels: np.ndarray):
    """SN_TRAJ trajectories over distinct nodes (seed 0): the query is the
    node's feature, the step the mean of its kNN neighbours minus the
    query, the reward the share of those neighbours in the node's cluster.
    Computed on the card, handed to the engines as host arrays."""
    nodes = np.random.default_rng(0).choice(graph.num_nodes, SN_TRAJ, replace=False)
    ids = torch.from_numpy(nodes).to(DEV)
    nbr, m = graph.nbr_idx[ids].long(), graph.nbr_mask[ids]
    count = torch.clamp(m.sum(1, keepdim=True), min=1.0)
    q = feats[ids]
    step = (feats[nbr] * m[..., None]).sum(1) / count - q
    lab = torch.from_numpy(labels).to(DEV)
    reward = ((lab[nbr] == lab[ids][:, None]).float() * m).sum(1) / count[:, 0]
    return q.cpu().numpy(), step.cpu().numpy(), reward.cpu().numpy()


def _sona_feed(engine, q, step, reward) -> list:
    """Feed trajectories; force_learn every SN_LEARN_EVERY. Returns the
    force_learn milliseconds."""
    learn_ms = []
    for i in range(len(q)):
        b = engine.begin_trajectory(q[i])
        b.add_step(step[i], np.ones(1, np.float32), float(reward[i]))
        engine.end_trajectory(b, quality=float(reward[i]))
        if (i + 1) % SN_LEARN_EVERY == 0:
            t0 = time.perf_counter()
            engine.force_learn()
            learn_ms.append(round((time.perf_counter() - t0) * 1e3, 3))
    return learn_ms


def _sona_host_state(engine) -> dict:
    """Every host array of an engine's loops, for bit-for-bit comparison."""
    micro = engine.coordinator.instant.micro_lora
    bg = engine.coordinator.background
    state = {"micro.up": micro.up, "micro.grad_up": micro.grad_up,
             "ewc.fisher": bg.ewc.current_fisher, "ewc.weights": bg.ewc.current_weights}
    state.update({f"base.up.{i}": u for i, u in enumerate(bg.base_lora.up)})
    state.update({f"pattern.{pid}": p.centroid for pid, p in bg.bank.patterns.items()})
    return state


def _equal_host(name: str, got: dict, want: dict) -> None:
    same = got.keys() == want.keys() and all(np.array_equal(got[k], want[k]) for k in got)
    say("equal", name=f"{name}: card engine vs CPU engine", arrays=len(got), ok=same)
    if not same:
        raise AssertionError(f"{name}: the host state differs between the engines")


def _micro_lora_bench() -> dict:
    """MicroLoRA at 4096 x rank 2 on one query and a batch of 256: the
    adapter's forward (device copies of down and up kept while their
    contents are unchanged) and the same forward with both copied to the
    card on every call; each held to the CPU."""
    ml = MicroLoRA(SN_WIDE, rank=SN_RANK, device=DEV)
    rng = np.random.default_rng(5)
    ml.accumulate_gradient(LearningSignal(rng.normal(size=SN_WIDE).astype(np.float32), 1.0))
    ml.apply_accumulated(0.01)
    cpu = MicroLoRA(SN_WIDE, rank=SN_RANK, device="cpu")
    cpu.up = ml.up.copy()
    out = {}
    for label, shape in (("single", (SN_WIDE,)), ("batch256", (SN_BATCH, SN_WIDE))):
        x_np = rng.normal(size=shape).astype(np.float32)
        x = torch.from_numpy(x_np).to(DEV)
        agree_scaled(f"MicroLoRA {label}: card vs CPU", ml.forward(x).cpu(),
                     cpu.forward(x_np), torch.float32)
        copied = lambda: lora_forward(x, torch.from_numpy(ml.down).to(DEV),  # noqa: E731
                                      torch.from_numpy(ml.up).to(DEV), ml.scale)
        agree(f"MicroLoRA {label}: copied every call vs kept", copied(), ml.forward(x),
              torch.float32, tol=(0.0, 0.0))
        kept_ms = time_ms(lambda: ml.forward(x), iters=100)
        copied_ms = time_ms(copied, iters=100)
        down, up = torch.from_numpy(ml.down).to(DEV), torch.from_numpy(ml.up).to(DEV)
        device_ms = kernel_ms(lambda: lora_forward(x, down, up, ml.scale), iters=100)
        rows = 1 if len(shape) == 1 else shape[0]
        out[label] = {"us": round(kept_ms * 1e3, 2), "copied_us": round(copied_ms * 1e3, 2),
                      "back_to_back_us": round(device_ms * 1e3, 2),
                      "rows_per_s": round(rows / (kept_ms * 1e-3), 1)}
    return out


def phase_sona(feats: torch.Tensor, graph: NeighborGraph, labels: np.ndarray) -> None:
    """SONA (`[sona]`): MicroLoRA at 4096 x rank 2, then a SonaEngine at
    learned_recall_curve.py's settings fed SN_TRAJ trajectories of the
    100k-node graph (a force_learn every SN_LEARN_EVERY), the adapters
    applied on the card, pattern retrieval, a federated average of two
    engines and an export/import round trip. The same stream through an
    engine on the CPU: its host state (up, grad_up, the EWC++ Fisher, the
    centroids) and its exported file equal bit for bit, the card's
    outputs within the f32 limits of scale."""
    t_phase = time.perf_counter()
    before = kernels.launch_counts()
    bench = _micro_lora_bench()
    d = feats.shape[1]
    cfg = SonaConfig(hidden_dim=d, embedding_dim=d, flush_threshold=SN_FLUSH,
                     quality_threshold=SN_QUALITY)
    q, step, reward = _sona_stream(feats, graph, labels)
    engine, engine_cpu = SonaEngine(config=cfg, device=DEV), SonaEngine(config=cfg, device="cpu")
    t0 = time.perf_counter()
    learn_ms = _sona_feed(engine, q, step, reward)
    feed_s = time.perf_counter() - t0
    _sona_feed(engine_cpu, q, step, reward)
    _equal_host("SONA stream", _sona_host_state(engine), _sona_host_state(engine_cpu))

    x = torch.from_numpy(q[:SN_APPLY_ROWS]).to(DEV)
    ms = {"apply_micro_lora": time_ms(lambda: engine.apply_micro_lora(x), iters=10)}
    agree_scaled("apply_micro_lora: card vs CPU", engine.apply_micro_lora(x).cpu(),
                 engine_cpu.apply_micro_lora(x.cpu()), torch.float32)
    for layer in range(cfg.num_layers):
        ms[f"apply_base_lora_{layer}"] = time_ms(lambda: engine.apply_base_lora(layer, x),
                                                 iters=10)
        agree_scaled(f"apply_base_lora {layer}: card vs CPU",
                     engine.apply_base_lora(layer, x).cpu(),
                     engine_cpu.apply_base_lora(layer, x.cpu()), torch.float32)
    t0 = time.perf_counter()
    similar = [p.id for p in engine.find_similar_patterns(q[0], k=3)]
    ms["find_similar"] = (time.perf_counter() - t0) * 1e3
    if similar != [p.id for p in engine_cpu.find_similar_patterns(q[0], k=3)] or not similar:
        raise AssertionError(f"find_similar_patterns: {similar}")

    # federated: this engine and a peer fed the stream's first SN_PEER_TRAJ
    peer = SonaEngine(config=cfg, device=DEV)
    _sona_feed(peer, q[:SN_PEER_TRAJ], step[:SN_PEER_TRAJ], reward[:SN_PEER_TRAJ])
    agg = FederatedAggregator(d, num_layers=cfg.num_layers, device=DEV)
    t0 = time.perf_counter()
    updates = [agg.collect(engine), agg.collect(peer)]
    merged = agg.aggregate(updates)
    target = SonaEngine(config=cfg, device=DEV)
    agg.apply(target, merged)
    ms["federated"] = (time.perf_counter() - t0) * 1e3
    total = sum(u.weight for u in updates)
    want_up = sum(u.micro_up * (u.weight / total) for u in updates)
    if not np.array_equal(target.coordinator.instant.micro_lora.up, want_up):
        raise AssertionError("federated average: the merged adapter differs")
    agree_scaled("federated adapter: card vs its host state", target.apply_micro_lora(x).cpu(),
                 lora_forward(x.cpu(), torch.from_numpy(target.coordinator.instant.micro_lora.down),
                              torch.from_numpy(want_up), target.coordinator.instant.micro_lora.scale),
                 torch.float32)

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        export_lora(engine, f"{tmp}/card.safetensors")
        fresh = SonaEngine(config=cfg, device=DEV)
        import_lora(fresh, f"{tmp}/card.safetensors")
        ms["export_import"] = (time.perf_counter() - t0) * 1e3
        export_lora(engine_cpu, f"{tmp}/cpu.safetensors")
        export_lora(fresh, f"{tmp}/round.safetensors")
        raw = {n: open(f"{tmp}/{n}.safetensors", "rb").read() for n in ("card", "cpu", "round")}
    same = raw["card"] == raw["cpu"] == raw["round"]
    say("equal", name="exported adapters: card, CPU and round trip", bytes=len(raw["card"]),
        ok=same)
    if not same:
        raise AssertionError("the exported adapter files differ")
    agree("imported adapter vs exported engine", fresh.apply_micro_lora(x),
          engine.apply_micro_lora(x), torch.float32, tol=(0.0, 0.0))
    if kernels.launch_counts() != before:
        raise AssertionError("SONA launched a kernel")
    say("sona", micro_lora=json.dumps(bench, separators=(",", ":")), hidden=d,
        trajectories=SN_TRAJ, trajectories_per_s=round(SN_TRAJ / feed_s, 1),
        force_learn_ms=learn_ms, patterns=engine.coordinator.background.bank.pattern_count,
        **{f"{k}_ms": round(v, 4) for k, v in ms.items()}, kernel_launches=0,
        seconds=round(time.perf_counter() - t_phase, 1))


def mined_agree(name: str, ids, ids_cpu, sims_cpu: np.ndarray, scores_cpu=None, edges=None,
                tol: float = 1e-5) -> float:
    """Mined negatives of the card against the CPU's (queue 3's tie rule).
    For the semi-hard band, an id within tol of a band edge `edges` [B, 2]
    may fall inside the band on one device and outside on the other (the
    positive's own row sits at the upper edge); such ids are set aside,
    and the rest of each list is compared over the shorter one's length.
    There an id in one list and not the other must be a tie: within tol of
    the k-th similarity or, where the band holds fewer than k, an
    out-of-band filler (score -inf in `scores_cpu`) as the CPU list holds
    one. Returns the share of rows with equal ids."""
    ids, ids_cpu = np.asarray(ids.cpu()), np.asarray(ids_cpu.cpu())
    scores_cpu = sims_cpu if scores_cpu is None else scores_cpu
    differ = (ids != ids_cpu).any(axis=1)
    bad = []
    for r in np.nonzero(differ)[0]:
        s, sc = sims_cpu[r], scores_cpu[r]
        at_edge = (lambda i: False) if edges is None else (
            lambda i: min(abs(s[i] - e) for e in edges[r]) <= tol)
        a = [i for i in ids_cpu[r] if not at_edge(i)]
        b = [i for i in ids[r] if not at_edge(i)]
        m = min(len(a), len(b))
        a, b = a[:m], b[:m]
        kth = min(s[a]) if m else -np.inf
        filler = bool(np.isneginf(sc[a]).any())
        for i in set(a) ^ set(b):
            if not (abs(s[i] - kth) <= tol or (filler and bool(np.isneginf(sc[i])))):
                bad.append((int(r), int(i), float(s[i]), float(kth)))
    equal = 1.0 - float(differ.mean())
    say("agree", name=f"{name}: card vs CPU", rows=len(ids), rows_ids_equal=equal,
        differ_only_at_ties=not bad, tol=tol, ok=not bad,
        **({"first_bad": json.dumps(bad[:4])} if bad else {}))
    if bad:
        raise AssertionError(f"{name}: the mined ids differ away from a tie")
    return equal


def _mining(feats: torch.Tensor, graph: NeighborGraph) -> dict:
    """mine_negatives' three strategies for TU_ANCHORS anchors (their
    first kNN neighbour the positive) against the whole graph, on the card
    and on the CPU; in_batch_negatives at TU_IN_BATCH."""
    anchors_np = np.random.default_rng(1).choice(graph.num_nodes, TU_ANCHORS, replace=False)
    ids = torch.from_numpy(anchors_np).to(DEV)
    a, pos = feats[ids], feats[graph.nbr_idx[ids, 0].long()]
    a_c, pos_c, pool_c = a.cpu(), pos.cpu(), feats.cpu()
    sims_cpu = pairwise_cosine(a_c, pool_c).numpy()
    out = {}
    for strategy in ("hard", "semi_hard", "distance_weighted"):
        mcfg = MiningConfig(strategy=strategy, n_negatives=TU_NEGATIVES)
        mine = lambda: mine_negatives(a, feats, pos, mcfg,  # noqa: E731
                                      rng=np.random.default_rng(2))
        # the distance-weighted draws run on the host: one synchronised call
        got, ms = _synced_ms(mine) if strategy == "distance_weighted" else (
            mine(), time_ms(mine, iters=5))
        want = mine_negatives(a_c, pool_c, pos_c, mcfg, rng=np.random.default_rng(2))
        out[f"{strategy}_ms"] = ms
        if strategy == "hard":
            out["hard_rows_equal"] = mined_agree("mine hard", got, want, sims_cpu)
        elif strategy == "semi_hard":
            ps = (torch.sum(a_c * pos_c, -1) / torch.clamp(
                torch.linalg.vector_norm(a_c, dim=-1) * torch.linalg.vector_norm(pos_c, dim=-1),
                min=1e-12)).numpy()
            band = (sims_cpu > ps[:, None] - mcfg.margin) & (sims_cpu < ps[:, None])
            scored = np.where(band.any(1, keepdims=True),
                              np.where(band, sims_cpu, -np.inf), sims_cpu)
            edges = np.stack([ps, ps - mcfg.margin], axis=1)
            out["semi_hard_rows_equal"] = mined_agree("mine semi_hard", got, want, sims_cpu,
                                                      scored, edges)
            del band, scored
        else:
            p = torch.softmax(pairwise_cosine(a, feats) / mcfg.temperature, dim=-1).cpu()
            p_cpu = torch.softmax(torch.from_numpy(sims_cpu) / mcfg.temperature, dim=-1)
            agree_scaled("distance-weighted probabilities: card vs CPU", p, p_cpu,
                         torch.float32)
            got_np, want_np = got.cpu().numpy(), want.numpy()
            same_p = (p == p_cpu).all(dim=1).numpy()
            checked, rows_equal = 0, (got_np == want_np).all(axis=1)
            for r in range(len(got_np)):
                if not rows_equal[r]:
                    if same_p[r]:
                        raise AssertionError(f"distance-weighted row {r}: equal "
                                             "probabilities, other ids")
                    break
                checked += int(same_p[r])
            valid = all(len(set(row)) == TU_NEGATIVES for row in got_np) and bool(
                (p.gather(1, got.cpu().long()) > 0).all())
            if not valid:
                raise AssertionError("distance-weighted ids repeat or have probability 0")
            out["dw_rows_equal"] = float(rows_equal.mean())
            out["dw_rows_equal_p_checked"] = checked
            del p, p_cpu
    equal_cpu("in_batch_negatives", in_batch_negatives(TU_IN_BATCH, device=DEV),
              in_batch_negatives(TU_IN_BATCH, device="cpu"))
    out["in_batch_ms"] = time_ms(lambda: in_batch_negatives(TU_IN_BATCH, device=DEV), iters=10)
    return out


def _spectral(cfg32: RuvectorLayerConfig) -> dict:
    """spectral_regularizer and its gradient over the RuvectorLayer's
    parameters (d=128, 4 heads), card against CPU."""
    params = ruvector_layer_init(0, cfg32, device=DEV)

    def value_and_grads(tree):
        leaves = [t.detach().requires_grad_(True) for t in tree_leaves(tree)]
        it = iter(leaves)
        val = spectral_regularizer(tree_map(lambda _: next(it), tree))
        return val, torch.autograd.grad(val, leaves, allow_unused=True)

    val, grads = value_and_grads(params)
    ms = time_ms(lambda: value_and_grads(params), iters=5)
    val_c, grads_c = value_and_grads(_tree_cpu(params))
    agree_scaled("spectral_regularizer: card vs CPU", val.detach().cpu()[None],
                 val_c.detach()[None], torch.float32)
    mats = 0
    for g, gc in zip(grads, grads_c):
        if gc is None:
            if g is not None:
                raise AssertionError("spectral gradient on a non-matrix leaf")
            continue
        agree_scaled("spectral gradient: card vs CPU", g.cpu(), gc, torch.float32)
        mats += 1
    return {"spectral_ms": ms, "spectral": float(val.detach()), "spectral_matrices": mats}


def _train_metrics_and_worker(params, cfg, feats, graph) -> dict:
    """TrainingMetrics.timed_step around TU_METRIC_STEPS contrastive steps
    (phase_contrastive's step, after one untimed step), then a
    GnnTrainingWorker job running one epoch of that step (batches of
    TU_WORKER_BATCH) and a job that fails on the card (features of the
    wrong width)."""
    tcfg = TrainConfig()
    opt = adam(tcfg.learning_rate)
    step = make_train_step(cfg, opt, tcfg)
    edges = int(graph.nbr_mask.sum())
    tm = TrainingMetrics(edges_per_step=edges)
    gen = torch.Generator().manual_seed(3)
    p, state, losses = params, opt.init(params), []
    for i in range(TU_METRIC_STEPS + 1):
        anchors = torch.randperm(graph.num_nodes, generator=gen)[:tcfg.batch_size].int()
        negs = sample_negatives(gen, graph, anchors, tcfg.n_negatives)
        args = (p, state, feats, graph, anchors.to(DEV), negs.to(DEV))
        p, state, loss = tm.timed_step(step, *args) if i else step(*args)
        losses.append(float(loss))
    if tm.steps.get() != TU_METRIC_STEPS or not np.isclose(tm.loss_sum.get(), sum(losses[1:])):
        raise AssertionError("TrainingMetrics did not record the steps")
    out = {"metrics_edges_per_s": tm.edges_per_second(),
           "metrics_step_ms": round(edges / tm.edges_per_second() * 1e3, 3)}

    wcfg = TrainConfig(batch_size=TU_WORKER_BATCH)
    wstep = make_train_step(cfg, opt, wcfg)
    narrow = feats[:, : feats.shape[1] // 2]

    def train_fn(collection, epochs):
        x = narrow if collection == "wrong_width" else feats
        tr, st = params, opt.init(params)
        for _ in range(epochs):
            tr, st, loss = train_epoch(wstep, tr, st, x, graph, wcfg,
                                       torch.Generator().manual_seed(4))
        return tr, loss

    worker = GnnTrainingWorker(train_fn)
    try:
        t0 = time.perf_counter()
        job = worker.wait(worker.enqueue("bench", epochs=1), timeout=600)
        out["worker_epoch_s"] = round(time.perf_counter() - t0, 3)
        bad = worker.wait(worker.enqueue("wrong_width"), timeout=600)
    finally:
        worker.shutdown()
    ok = (job.status is JobStatus.DONE and np.isfinite(job.loss)
          and worker.model("bench") is not None and bad.status is JobStatus.FAILED
          and bool(bad.error))
    say("worker", jobs=2, epoch_status=job.status.value, epoch_loss=job.loss,
        steps=graph.num_nodes // TU_WORKER_BATCH, failing_status=bad.status.value,
        failing_error=json.dumps(bad.error[:80]), ok=ok)
    if not ok:
        raise AssertionError("the training worker's jobs did not end as expected")
    return out


def _profiler(params, cfg, fpad, bdg) -> dict:
    """Profiler.region around the fused K1 layer TU_PROFILE_ITERS times:
    its p50 within 10% + 0.05 ms of the CUDA-event layer time shows that
    the region waits for the card (the same region without the wait reads
    the launch alone); the allocator's peak; one trace. Each region's call
    follows one timed by CUDA events, so both medians see the same state
    of the card and its host."""
    layer = lambda: ruvector_layer_apply_block_dense_fused(params, cfg, fpad, bdg)  # noqa: E731
    prof = Profiler()
    event_ms = []
    layer()
    for sync in (True, False):
        name = "k1_layer" if sync else "k1_layer_no_sync"
        for _ in range(TU_PROFILE_ITERS):
            if sync:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                torch.cuda.synchronize()
                start.record()
                layer()
                end.record()
                end.synchronize()
                event_ms.append(start.elapsed_time(end))
            torch.cuda.synchronize()
            with prof.region(name, sync=sync) as holder:
                holder.append(layer())
    torch.cuda.synchronize()
    summary = prof.summary()
    p50 = summary["k1_layer"]["p50_ms"]
    layer_ms = statistics.median(event_ms)
    ok = abs(p50 - layer_ms) <= 0.1 * layer_ms + 0.05
    say("agree", name="Profiler.region p50 vs CUDA-event layer_ms", region_p50_ms=p50,
        layer_ms=layer_ms, tol="10% + 0.05 ms", ok=ok)
    if not ok:
        raise AssertionError("the profiler's region does not time the card's work")
    stats = Profiler.device_memory_stats()
    with tempfile.TemporaryDirectory() as tmp:
        with prof.xla_trace(tmp):
            layer()
            torch.cuda.synchronize()
        trace = [f for f in os.listdir(tmp) if f.endswith(".pt.trace.json")]
        if len(trace) != 1:
            raise AssertionError(f"xla_trace wrote {trace}")
        with open(os.path.join(tmp, trace[0])) as f:
            events = json.load(f)["traceEvents"]
    kernel_events = [e for e in events if e.get("cat") == "kernel"]
    return {"region_p50_ms": p50, "region_no_sync_p50_ms": summary["k1_layer_no_sync"]["p50_ms"],
            "profiled_layer_ms": layer_ms,
            "peak_allocated_gb": round(stats["allocated_bytes.all.peak"] / 1e9, 3),
            "trace_events": len(events), "trace_kernel_events": len(kernel_events),
            "trace_kernel_us": round(sum(e.get("dur", 0) for e in kernel_events), 1)}


def _checkpoints(gparams, tmp: str) -> dict:
    """save/restore_checkpoint and AsyncShardedCheckpointer on config 5's
    parameters (2 layers, dim 128): restored bit for bit."""
    proto = tree_map(torch.zeros_like, gparams)

    def same(tree) -> bool:
        return all(torch.equal(a, b) for a, b in zip(tree_leaves(tree), tree_leaves(gparams)))

    t0 = time.perf_counter()
    save_checkpoint(f"{tmp}/ckpt", gparams, step=1)
    save_ms = (time.perf_counter() - t0) * 1e3
    restored, restore_ms = _synced_ms(lambda: restore_checkpoint(f"{tmp}/ckpt", proto, step=1))
    ck = AsyncShardedCheckpointer(f"{tmp}/async")
    t0 = time.perf_counter()
    ck.save(gparams, step=1)
    snapshot_ms = (time.perf_counter() - t0) * 1e3
    ck.wait_until_finished()
    async_ms = (time.perf_counter() - t0) * 1e3
    restored_async = ck.restore(proto, step=1)
    on_device = all(t.device.type == DEV.type for t in tree_leaves(restored))
    ok = same(restored) and same(restored_async) and on_device
    n_bytes = nbytes(*tree_leaves(gparams))
    say("equal", name="checkpoint round trips: config 5's parameters", leaves=len(
        tree_leaves(gparams)), bytes=n_bytes, on_device=on_device, ok=ok)
    if not ok:
        raise AssertionError("a restored checkpoint differs from the saved parameters")
    return {"ckpt_bytes": n_bytes, "ckpt_save_ms": save_ms, "ckpt_restore_ms": restore_ms,
            "ckpt_async_snapshot_ms": snapshot_ms, "ckpt_async_total_ms": async_ms}


def _cold_tier(feats_np: np.ndarray, feats: torch.Tensor, graph: NeighborGraph,
               order: np.ndarray, tmp: str) -> dict:
    """The features in a FeatureStorage on disk; one ColdTierTrainer epoch
    in hyperbatches of TU_HYPERBATCH in the graph-grown (BFS) order, each
    batch's contrastive loss (its rows as anchors, their kNN neighbours'
    rows from the card as positives, 64 rows of the batch as negatives),
    every streamed batch held equal to the card's rows; the same losses on
    the CPU. Then an AdaptiveHotset pass over zipf accesses and an
    MmapEmbeddingStore with a dirty flush."""
    n, d = feats_np.shape
    t0 = time.perf_counter()
    fs = FeatureStorage.create(f"{tmp}/features.npy", dim=d, num_nodes=n)
    fs.write_batch(np.arange(n), feats_np)
    fs.flush()
    out = {"storage_write_s": round(time.perf_counter() - t0, 3)}
    negs = torch.randint(0, TU_HYPERBATCH, (TU_HYPERBATCH, 64),
                         generator=torch.Generator().manual_seed(5))

    def loss_on(x, ids, table, nbr_idx, nbr_mask, neg):
        ids_t = torch.from_numpy(ids).to(x.device)
        nbr = nbr_idx[ids_t].long()
        return batched_info_nce(x, table[nbr], x[neg[: len(ids)] % len(ids)], 0.07,
                                nbr_mask[ids_t])

    mismatched = []
    negs_dev = negs.to(DEV)

    def step(ids, x):
        mismatched.append(int((x != feats[torch.from_numpy(ids).to(DEV)]).any()))
        return loss_on(x, ids, feats, graph.nbr_idx, graph.nbr_mask, negs_dev)

    trainer = ColdTierTrainer(fs, HyperbatchConfig(batch_size=TU_HYPERBATCH), order, DEV)
    stats = trainer.train_epoch(step)
    if sum(mismatched) or stats.batches != -(-n // TU_HYPERBATCH):
        raise AssertionError(f"cold tier: {sum(mismatched)} batches differ from the stored rows")
    cpu_graph = _graph_cpu(graph)
    cpu_losses = [float(loss_on(torch.from_numpy(fs.read_batch(order[s: s + TU_HYPERBATCH])),
                                order[s: s + TU_HYPERBATCH], torch.from_numpy(feats_np),
                                cpu_graph.nbr_idx, cpu_graph.nbr_mask, negs))
                  for s in range(0, n, TU_HYPERBATCH)]
    agree_scaled("cold-tier epoch loss: card vs CPU", torch.tensor([stats.loss]),
                 torch.tensor([float(np.mean(cpu_losses))]), torch.float32)
    hidden = 1.0 - stats.copy_wait_s / stats.copy_time_s if stats.copy_time_s > 0 else 0.0
    # the host-to-card rate of one hyperbatch from pinned memory, alone
    pinned = torch.empty((TU_HYPERBATCH, d), pin_memory=DEV.type == "cuda")
    on_dev = torch.empty((TU_HYPERBATCH, d), device=DEV)
    copy_ms = kernel_ms(lambda: on_dev.copy_(pinned, non_blocking=True))
    out["h2d_gb_per_s"] = nbytes(pinned) / (copy_ms * 1e-3) / 1e9
    out.update(batches=stats.batches, io_time_s=stats.io_time_s,
               compute_time_s=stats.compute_time_s, copy_time_s=stats.copy_time_s,
               copy_wait_s=stats.copy_wait_s, copy_hidden_share=hidden, epoch_loss=stats.loss)

    hot = AdaptiveHotset(TU_HOT_CAP)
    accesses = np.random.default_rng(6).zipf(1.3, TU_HOT_ACCESSES) % n
    hits = 0
    t0 = time.perf_counter()
    for node in accesses:
        hits += int(int(node) in hot.cache)
        hot.access(int(node), lambda i: torch.from_numpy(fs.read_batch([i])[0]).to(DEV))
    torch.cuda.synchronize()
    hot_s = time.perf_counter() - t0
    cached = sorted(hot.cache)
    equal_cpu("hotset rows", torch.stack([hot.cache[i] for i in cached]),
              torch.from_numpy(feats_np[cached]))
    out.update(hotset_hit_rate=hits / TU_HOT_ACCESSES, hotset_cached=len(cached),
               hotset_us_per_access=round(hot_s / TU_HOT_ACCESSES * 1e6, 2))

    store = MmapEmbeddingStore(f"{tmp}/emb.bin", num_nodes=n, dim=d, create=True)
    store.set_batch(np.arange(n), feats_np)
    t0 = time.perf_counter()
    full_pages = store.flush_dirty()
    full_ms = (time.perf_counter() - t0) * 1e3
    rows = np.random.default_rng(7).choice(n, TU_MMAP_DIRTY, replace=False)
    store.set_batch(rows, store.get_batch(rows) * 2.0)
    t0 = time.perf_counter()
    dirty_pages = store.flush_dirty()
    dirty_ms = (time.perf_counter() - t0) * 1e3
    store.close()
    want = feats_np.copy()
    want[rows] *= 2.0
    reread = MmapEmbeddingStore(f"{tmp}/emb.bin", num_nodes=n, dim=d).get_batch(np.arange(n))
    if not np.array_equal(reread, want):
        raise AssertionError("the mmap store reads back other values")
    out.update(mmap_full_flush_pages=full_pages, mmap_full_flush_ms=full_ms,
               mmap_dirty_rows=TU_MMAP_DIRTY, mmap_dirty_pages=dirty_pages,
               mmap_dirty_flush_ms=dirty_ms)
    return out


def phase_training_utils(params, cfg, gparams, feats_np: np.ndarray, feats: torch.Tensor,
                         graph: NeighborGraph, order: np.ndarray, fpad, bdg) -> None:
    """The training utilities on the 100k-node graph (`[training_utils]`):
    mining, the spectral regularizer, TrainingMetrics around the
    contrastive step, the training worker, the profiler around the K1
    layer, checkpoints of config 5's parameters, and the cold tier (disk
    features streamed in hyperbatches), the hotset and the mmap store;
    each checked against the CPU or read back."""
    t_phase = time.perf_counter()
    d, heads = feats.shape[1], cfg.heads
    fields = _mining(feats, graph)
    fields.update(_spectral(RuvectorLayerConfig(d, d, heads=heads)))
    fields.update(_train_metrics_and_worker(params, cfg, feats, graph))
    fields.update(_profiler(params, cfg, fpad, bdg))
    with tempfile.TemporaryDirectory() as tmp:
        fields.update(_checkpoints(gparams, tmp))
        fields.update(_cold_tier(feats_np, feats, graph, order, tmp))
    say("training_utils", nodes=graph.num_nodes, d=d, anchors=TU_ANCHORS,
        negatives=TU_NEGATIVES, hyperbatch=TU_HYPERBATCH,
        **{k: round(v, 6) if isinstance(v, float) else v for k, v in fields.items()},
        seconds=round(time.perf_counter() - t_phase, 1))


def train_report(c5: dict, halo: dict, gparams, gcfg) -> list:
    """Report rows of the training kernels: K5a and K5b at the train
    step's shapes (layer 0's normalized input, init masks, every
    partition; a cotangent from a seed), K6b and K6a at the halo layout's
    (layer 0's normalized stream; q and k its bf16 projections)."""
    bdg, x0, keep0 = c5["bdg"], c5["x0"], c5["keep0"]
    nb, b, d = x0.shape
    hh = gcfg.num_heads
    p = gparams[0]
    h0 = gated._ln(p["ln1"], x0).contiguous()
    pad = bdg.node_pad
    A, Wvo = fold_gated_attention_params(p, gcfg)
    A_cat, Wvo_cat = head_concat(A), head_concat(Wvo)
    g = torch.randn(h0.shape, generator=torch.Generator(device=DEV).manual_seed(9), device=DEV)
    n = nb * b
    bf16, f32 = torch.bfloat16, torch.float32
    args = (h0, keep0, pad, A_cat, Wvo_cat)
    rows = [
        ("gated_block_attention_fwd",
         lambda: gated_block_attention_fwd(*args, compute_bf16=True),
         lambda: gated_block_attention_fwd_reference(*args, compute_bf16=True),
         _agree_as(bf16),
         bound(nbytes(*args) + nbytes(h0), {bf16: 2 * n * hh * (2 * d + 2 * b) * d}),
         {"body": mha_body(b, True)}),
        ("gated_block_attention_bwd",
         lambda: gated_block_attention_bwd(*args, g, compute_bf16=True),
         lambda: gated_block_attention_bwd_reference(*args, g, compute_bf16=True),
         lambda name, got, want: agree_grads(name, got, want, bf16),
         bound(nbytes(*args, g) + nbytes(h0, A_cat, Wvo_cat),
               {bf16: 2 * n * hh * (2 * d + b) * d,
                "tf32x3": 2 * n * hh * (4 * d + 4 * b) * d}),
         {"body": mha_body(b, True)})]
    hx, hpad = halo["h"], halo["pad"]
    hn, hb = hx.shape[0] * hx.shape[1], hx.shape[1]
    A_sig = gated._fold_sig_params(p, gcfg)
    q, k = gated._qk_proj(hx, p["wq"], p["wk"], gcfg)
    scale = 1.0 / (gcfg.head_dim ** 0.5) / hh
    sig_out = 2 * hn * 4
    rows.append(("block_gate_signature_x",
                 lambda: block_gate_signature_x(hx, hpad, A_sig, eps=gcfg.eps, compute_bf16=True),
                 lambda: block_gate_signature_x_reference(hx, hpad, A_sig, eps=gcfg.eps,
                                                          compute_bf16=True),
                 agree_rows, bound(nbytes(hx, hpad, A_sig) + sig_out,
                                   {"f64": 2 * hn * (hb + d) * d}),
                 {"shape": f"halo layout: nB={hx.shape[0]}, B={hb}",
                  "body": sig_body(hb, True)}))
    rows.append(("block_gate_signature",
                 lambda: block_gate_signature(q, k, hpad, eps=gcfg.eps, scale=scale),
                 lambda: block_gate_signature_reference(q, k, hpad, eps=gcfg.eps, scale=scale),
                 agree_rows, bound(nbytes(q, k, hpad) + sig_out, {"f64": 2 * hn * hb * d}),
                 {"shape": f"halo layout: nB={hx.shape[0]}, B={hb}, q/k bf16",
                  "body": sig_body(hb, q.dtype == torch.bfloat16),
                  "path": OFF_PATH["block_gate_signature"]}))
    return rows

# ---------------------------------------------------------------------------
# serving: the query engine, the flat index, the re-rank (K8); the CSR
# SpMM path (K9)
# ---------------------------------------------------------------------------

def same_topk(name: str, ids_a, scores_a, ids_b, scores_b, tol: float,
              min_equal: float = 0.0) -> float:
    """Two top-k lists per row ([R, k] each), each with the scores of its
    own ids: the scores agree within tol at every rank, and where the ids
    differ, list b's id at that rank is either in list a's row (an order
    swapped between tied scores) or scores within tol of list a's k-th
    score (a tie at the boundary). At least min_equal of the rows must
    have equal ids. Returns the share of rows with equal ids."""
    ids_a, ids_b = np.asarray(ids_a), np.asarray(ids_b)
    sa, sb = np.asarray(scores_a, np.float64), np.asarray(scores_b, np.float64)
    score_err = float(np.abs(sa - sb).max())
    differ = (ids_a != ids_b).any(axis=1)
    ties_ok = True
    for r in np.nonzero(differ)[0]:
        for j in np.nonzero(ids_a[r] != ids_b[r])[0]:
            ties_ok &= bool(ids_b[r, j] in ids_a[r] or abs(sb[r, j] - sa[r, -1]) <= tol)
    equal = 1.0 - float(differ.mean())
    ok = score_err <= tol and ties_ok and equal >= min_equal
    say("agree", name=name, rows=len(ids_a), rows_ids_equal=equal, score_max_abs_err=score_err,
        tol=tol, differ_only_at_ties=ties_ok, ok=ok)
    if not ok:
        raise AssertionError(f"{name}: top-k lists disagree")
    return equal


def phase_serve_parity() -> None:
    """K8 against its plain version at K8_PARITY's shapes (8 fully masked
    rows where masked)."""
    gen = torch.Generator().manual_seed(3)
    for b, m, d, masked in K8_PARITY:
        q = torch.randn(b, d, generator=gen).to(DEV)
        k, v = (torch.randn(b, m, d, generator=gen).to(DEV) for _ in range(2))
        mask = None
        if masked:
            mask = (torch.rand(b, m, generator=gen) > 0.5).float()
            mask[:8] = 0.0
            mask = mask.to(DEV)
        got = flash_neighbor_attention(q, k, v, mask)
        agree(f"K8 flash_neighbor_attention [{b}, {m}, {d}] mask={masked}", got,
              flash_neighbor_attention_reference(q, k, v, mask), torch.float32)
        if masked and float(got[:8].abs().max()) != 0.0:
            raise AssertionError("K8: fully masked rows must give 0")
        del q, k, v, mask, got
    torch.cuda.synchronize()


def _latency(results) -> dict:
    """Median and maximum (over SERVE_PER_MODE requests: too few for a p99)."""
    ms = [r.latency_ms for r in results]
    return {"p50": float(np.percentile(ms, 50)), "max": float(np.max(ms))}


def phase_serve(feats_np: np.ndarray, feats, graph, d: int, heads: int) -> int:
    """The query engine over the RuvectorLayer corpus and its kNN graph,
    with a 2-layer f32 RuvectorLayer stack on the K3 route (seeds 0 and 1):
    SERVE_PER_MODE requests in each mode (k=10, ef=50, depth 2, subgraph
    depth 1), each a corpus row plus SERVE_NOISE N(0, 1), and the flat index
    on the same queries. Returns K3's launches."""
    n = feats.shape[0]
    cfg, stack = _k3_stack(d, heads)
    engine = QueryEngine(feats, graph, stack, [cfg, cfg])
    rng = np.random.default_rng(5)
    modes = (QueryMode.VECTOR_SEARCH, QueryMode.DIFFERENTIABLE_SEARCH, QueryMode.NEURAL_SEARCH,
             QueryMode.SUBGRAPH_EXTRACTION)
    rows = rng.choice(n, size=(len(modes), SERVE_PER_MODE), replace=False)
    queries = (feats_np[rows] + SERVE_NOISE * rng.standard_normal(
        (*rows.shape, d))).astype(np.float32)

    def request(eng, mode, vec):
        return eng.execute(RuvectorQuery(
            vector=vec, mode=mode, k=SERVE_K, ef=SERVE_EF,
            gnn_depth=1 if mode == QueryMode.SUBGRAPH_EXTRACTION else 2))

    def run():
        return {mode: [request(engine, mode, vec) for vec in queries[i]]
                for i, mode in enumerate(modes)}

    results, counts = counted(["fused_neighbor_mix"], run)
    for mode, res in results.items():
        for r in res:
            if len(r.nodes) != SERVE_K or not np.isfinite(r.scores).all():
                raise AssertionError(f"{mode.value}: {len(r.nodes)} nodes or non-finite scores")
        if mode == QueryMode.SUBGRAPH_EXTRACTION and any(
                not set(r.nodes) <= set(r.subgraph.nodes) for r in res):
            raise AssertionError("subgraph: a seed is missing from its subgraph")
    # an unperturbed corpus row finds itself at rank 0
    own = int(rows[0, 0])
    for mode in (QueryMode.VECTOR_SEARCH, QueryMode.DIFFERENTIABLE_SEARCH):
        if request(engine, mode, feats_np[own]).nodes[0] != own:
            raise AssertionError(f"{mode.value}: corpus row {own} is not its own top match")
    # the flat index on the same queries: its ids are the cosine top-k,
    # which vector, differentiable and subgraph search return as nodes
    index = FlatIndex(dim=d, metric="cosine", device=DEV)
    index.add_batch(feats_np)
    flat_ids, flat_d = index.search_batch(queries.reshape(-1, d), k=SERVE_K)
    flat_ids, flat_sim = flat_ids.reshape(len(modes), -1, SERVE_K), 1.0 - flat_d / 2.0
    flat_sim = flat_sim.reshape(flat_ids.shape)
    unit = feats_np / np.linalg.norm(feats_np, axis=1, keepdims=True)
    for i, mode in enumerate(modes):
        if mode == QueryMode.NEURAL_SEARCH:
            continue
        res = results[mode]
        nodes = np.asarray([r.nodes for r in res])
        # vector search scores cosines; the other two modes' scores are not,
        # so their nodes are scored by their own cosines to the query
        if mode == QueryMode.VECTOR_SEARCH:
            scores = np.asarray([r.scores for r in res])
        else:
            qn = queries[i] / np.linalg.norm(queries[i], axis=1, keepdims=True)
            scores = np.einsum("rkd,rd->rk", unit[nodes], qn)
        same_topk(f"flat index vs {mode.value} nodes", flat_ids[i], flat_sim[i], nodes, scores,
                  1e-5)
    # neural search through K3 against the same engine on the slot route
    plain = QueryEngine(feats, graph, stack, [dataclasses.replace(cfg, use_pallas=False)] * 2)
    neural = results[QueryMode.NEURAL_SEARCH]
    plain_res = [request(plain, QueryMode.NEURAL_SEARCH, v) for v in queries[2]]
    same_topk("neural search: K3 route vs slot route", [r.nodes for r in neural],
              [r.scores for r in neural], [r.nodes for r in plain_res],
              [r.scores for r in plain_res], 1e-4)
    lat = {mode.value: _latency(res[1:] if mode == QueryMode.NEURAL_SEARCH else res)
           for mode, res in results.items()}
    say("serve", nodes=n, d=d, heads=heads, layers=len(stack), k=SERVE_K, ef=SERVE_EF,
        requests_per_mode=SERVE_PER_MODE, first_neural_ms=neural[0].latency_ms,
        latency_ms=json.dumps(lat, separators=(",", ":")), k3_launches=counts["fused_neighbor_mix"],
        flat_queries=flat_ids.size // SERVE_K)
    return counts["fused_neighbor_mix"]


def phase_rerank(d: int) -> dict:
    """retrieve_and_rerank over an RR_NODES x d corpus (bench.py's
    clustered data) on the card: RR_BATCHES batches of RR_BATCH queries,
    each a corpus row plus RR_NOISE N(0, 1), at ef=RR_EF (K8 once per
    batch) and k=RR_K; the kernel route against the plain flash route on
    every batch, a control (K8 without the online softmax's rescale, a
    fault planted in the kernel, on the last batch's pool), and the time
    of each stage on the last batch."""
    # the brute-force product is float32 at full precision: phase_device
    # turned TF32 off, as every f32 product here needs
    t0 = time.perf_counter()
    corpus_np = bench_features(RR_NODES, d)
    corpus = torch.from_numpy(corpus_np).to(DEV)
    rng = np.random.default_rng(6)
    rows = rng.integers(0, RR_NODES, size=(RR_BATCHES, RR_BATCH))
    batches = [(corpus_np[r] + RR_NOISE * rng.standard_normal((RR_BATCH, d))).astype(np.float32)
               for r in rows]
    del corpus_np
    gen_s = time.perf_counter() - t0

    def run():
        out, times = [], []
        for qb in batches:
            res, ms = _synced_ms(lambda: retrieve_and_rerank(qb, corpus, ef=RR_EF, k=RR_K))
            out.append(res)
            times.append(ms)
        return out, times

    (results, times), counts = counted(["flash_neighbor_attention"], run)
    if counts["flash_neighbor_attention"] != RR_BATCHES:
        raise AssertionError(f"K8 launched {counts['flash_neighbor_attention']} times for "
                             f"{RR_BATCHES} batches")
    ids = torch.cat([r[0] for r in results]).cpu().numpy()
    scores = torch.cat([r[1] for r in results]).cpu().numpy()
    if ids.shape != (RR_BATCHES * RR_BATCH, RR_K) or not np.isfinite(scores).all() \
            or (np.diff(scores, axis=1) > 1e-6).any():
        raise AssertionError("re-rank: wrong shape, non-finite or unsorted scores")
    plain_ids, plain_scores = [], []
    with torch.no_grad():
        for i, qb in enumerate(batches):
            q = torch.from_numpy(qb).to(DEV)
            cand = retrieve_candidates(q, corpus, RR_EF)
            pool = corpus[cand]
            agree(f"re-rank batch {i}: K8 context vs flash route", flash_neighbor_attention(
                q, pool, pool), flash_attention(q, pool, pool, block_size=min(128, RR_EF)),
                torch.float32)
            p_ids, p_scores = attention_rerank(q, pool, cand, RR_K, use_pallas=False)
            plain_ids.append(p_ids.cpu().numpy())
            plain_scores.append(p_scores.cpu().numpy())
    equal = same_topk("re-rank: K8 route vs flash route, top-k", ids, scores,
                      np.concatenate(plain_ids), np.concatenate(plain_scores), 1e-5,
                      min_equal=0.999)
    # each query is its source row plus noise of norm ~RR_NOISE sqrt(d), a
    # quarter of the distance to the row's cluster neighbours
    src = rows.reshape(-1)
    in_topk = float((ids == src[:, None]).any(axis=1).mean())
    if in_topk < 0.99:
        raise AssertionError(f"re-rank: the source row is in the top {RR_K} of only "
                             f"{in_topk:.4f} of the queries")
    with torch.no_grad():
        # control: a fault planted in K8, the online softmax without its
        # correction exp(m_old - m_new), on the last batch's pool
        expect_rejected("K8 without the online softmax's rescale", lambda: agree(
            f"control: K8 body={k8_body(pool, pool)} without the rescale",
            flash_neighbor_attention(q, pool, pool, variant="no_rescale"),
            flash_neighbor_attention_reference(q, pool, pool), torch.float32))
        # the stages of one batch (the last one's inputs)
        ctx = flash_neighbor_attention(q, pool, pool)
        stages = {
            "product": time_ms(lambda: pairwise_cosine(q, corpus), iters=5),
            "product_topk": time_ms(lambda: retrieve_candidates(q, corpus, RR_EF), iters=5),
            "pool_gather": time_ms(lambda: corpus[cand], iters=5),
            "k8": time_ms(lambda: flash_neighbor_attention(q, pool, pool), iters=10),
            "blend_topk": time_ms(lambda: torch.topk(rerank_scores(q, ctx, pool), RR_K, dim=1),
                                  iters=10)}
    batch_ms = statistics.median(times)
    say("rerank", corpus=RR_NODES, d=d, batches=RR_BATCHES, batch=RR_BATCH, ef=RR_EF, k=RR_K,
        gen_s=round(gen_s, 3), batch_ms=[round(t, 3) for t in times], batch_ms_median=batch_ms,
        queries_per_s=RR_BATCH / (batch_ms * 1e-3), k8_launches=counts["flash_neighbor_attention"],
        rows_ids_equal_plain=equal, source_row_at_rank0=float((ids[:, 0] == src).mean()),
        source_row_in_topk=in_topk,
        stage_ms=json.dumps(stages, separators=(",", ":")))
    return dict(q=q, pool=pool, launches=counts["flash_neighbor_attention"])


def _pq_tie_share(name: str, codes, codes_c, x_c, cb_c) -> float:
    """PQ codes of the card against the CPU's: they may differ only where
    the two centroids' distances tie within 1e-5 relative, on at most
    1e-4 of the codes. Returns the share that differs."""
    diff = (codes.cpu() != codes_c)
    share = float(diff.float().mean())
    if bool(diff.any()):
        n, s = codes_c.shape
        sub = x_c.reshape(n, s, -1)
        r, c = torch.nonzero(diff, as_tuple=True)
        books = cb_c.codebooks[c]
        d_card = ((sub[r, c] - books[torch.arange(len(r)), codes.cpu()[r, c].long()]) ** 2).sum(-1)
        d_cpu = ((sub[r, c] - books[torch.arange(len(r)), codes_c[r, c].long()]) ** 2).sum(-1)
        ties = bool(((d_card - d_cpu).abs() <= 1e-5 * d_cpu.abs()).all())
    else:
        ties = True
    ok = ties and share <= 1e-4
    say("equal", name=f"{name}: card vs CPU", differ_share=share, only_ties=ties, ok=ok)
    if not ok:
        raise AssertionError(f"{name}: codes differ beyond ties")
    return share


def phase_quantization(d: int) -> dict:
    """Vector quantization on `[rerank]`'s corpus (`[quantization]`):
    RR_NODES x d f32 (bench.py's data, seed 0) and QZ_QUERIES queries
    (corpus rows plus RR_NOISE N(0, 1)). Scalar int8 (quantize,
    dequantize, the asymmetric distance [queries, corpus]), int4, PQ
    (pq_train on the first QZ_PQ_TRAIN rows, 8 x 256 x 10 iterations, the
    encoding of the whole corpus, ADC distances), binary (words, Hamming
    distances, similarity), TensorCompress at every level, every Q15 op
    (the matmul at 4096 x 128 x 4096) and both temporal stores (1024
    chunks of 128 x 128 through every tier). Against the CPU: codes,
    words, Hamming distances, codebooks, Q15 values and stored words bit
    for bit; float outputs within the f32 limits of their scale (the
    distances on the first GNN_ROWS corpus rows); a scalar distance with
    its offset term dropped must be rejected. Times: medians of 10 calls
    (CUDA events); pq_train and the pq8 level one call (host clock)."""
    t_phase = time.perf_counter()
    before = kernels.launch_counts()
    t0 = time.perf_counter()
    corpus_np = bench_features(RR_NODES, d)
    rng = np.random.default_rng(7)
    q_np = (corpus_np[rng.integers(0, RR_NODES, size=QZ_QUERIES)]
            + RR_NOISE * rng.standard_normal((QZ_QUERIES, d))).astype(np.float32)
    corpus, queries = torch.from_numpy(corpus_np).to(DEV), torch.from_numpy(q_np).to(DEV)
    corpus_c, queries_c = torch.from_numpy(corpus_np), torch.from_numpy(q_np)
    fields = {"corpus": RR_NODES, "d": d, "queries": QZ_QUERIES,
              "gen_s": round(time.perf_counter() - t0, 3)}
    ms = {}
    sub = slice(0, GNN_ROWS)

    def scaled(name, got, want):
        agree_scaled(f"{name}: card vs CPU", got.cpu(), want, torch.float32)

    # scalar int8
    sq, sq_c = scalar_quantize(corpus), scalar_quantize(corpus_c)
    for f in ("codes", "scale", "offset"):
        equal_cpu(f"scalar int8 {f}", getattr(sq, f), getattr(sq_c, f))
    scaled("scalar dequantize", scalar_dequantize(sq), scalar_dequantize(sq_c))
    sq_sub_c = ScalarQuantized(sq_c.codes[sub], sq_c.scale[sub], sq_c.offset[sub])
    dist = scalar_distance(queries, sq)
    want = scalar_distance(queries_c, sq_sub_c)
    scaled(f"scalar_distance, first {GNN_ROWS} rows", dist[:, sub], want)
    no_offset = ScalarQuantized(sq.codes[sub], sq.scale[sub], torch.zeros_like(sq.scale[sub]))
    bad = scalar_distance(queries, no_offset)
    control_far("scalar_distance without its offset term", bad, want, lambda: scaled(
        "scalar_distance without the offset (control)", bad, want))
    del dist, bad
    ms["scalar_quantize"] = time_ms(lambda: scalar_quantize(corpus), iters=10)
    ms["scalar_dequantize"] = time_ms(lambda: scalar_dequantize(sq), iters=10)
    ms["scalar_distance"] = time_ms(lambda: scalar_distance(queries, sq), iters=10)

    # int4
    q4, q4_c = int4_quantize(corpus), int4_quantize(corpus_c)
    for f in ("packed", "scale", "offset"):
        equal_cpu(f"int4 {f}", getattr(q4, f), getattr(q4_c, f))
    scaled("int4 dequantize", int4_dequantize(q4), int4_dequantize(q4_c))
    ms["int4_quantize"] = time_ms(lambda: int4_quantize(corpus), iters=10)
    ms["int4_dequantize"] = time_ms(lambda: int4_dequantize(q4), iters=10)
    del q4, q4_c

    # PQ: codebooks on the card and the CPU equal on a small slice; at full
    # width the assignment's squared distances equal numpy's, bit for bit
    t0 = time.perf_counter()
    cb = pq_train(corpus_np[:QZ_PQ_TRAIN], QZ_PQ_SUB, QZ_PQ_K, QZ_PQ_ITERS, device=DEV)
    torch.cuda.synchronize()
    fields["pq_train_s"] = round(time.perf_counter() - t0, 3)
    small = corpus_np[:QZ_PQ_CHECK]
    equal_cpu(f"pq_train codebooks on {QZ_PQ_CHECK} rows",
              pq_train(small, QZ_PQ_SUB, QZ_PQ_K, QZ_PQ_ITERS, device=DEV).codebooks,
              pq_train(small, QZ_PQ_SUB, QZ_PQ_K, QZ_PQ_ITERS, device="cpu").codebooks)
    ds = d // QZ_PQ_SUB
    sub0 = corpus_np[:QZ_PQ_TRAIN, :ds]
    cent0 = cb.codebooks[0].cpu().numpy()
    equal_cpu(f"pq_train assignment distances, {QZ_PQ_TRAIN} x {QZ_PQ_K}",
              squared_distances(torch.from_numpy(sub0).to(DEV)[:, None, :],
                                cb.codebooks[0][None]),
              torch.from_numpy(((sub0[:, None, :] - cent0[None]) ** 2).sum(-1)))
    cb_c = PQCodebook(cb.codebooks.cpu(), cb.dim)
    codes = pq_encode(cb, corpus)
    codes_c = pq_encode(cb_c, corpus_c[sub])
    fields["pq_code_tie_share"] = _pq_tie_share(f"pq_encode, first {GNN_ROWS} rows",
                                                codes[sub], codes_c, corpus_c[sub], cb_c)
    scaled("pq_decode", pq_decode(cb, codes[sub]), pq_decode(cb_c, codes[sub].cpu()))
    scaled(f"pq_distance, first {GNN_ROWS} rows", pq_distance(cb, queries, codes)[:, sub],
           pq_distance(cb_c, queries_c, codes[sub].cpu()))
    ms["pq_encode"] = time_ms(lambda: pq_encode(cb, corpus), iters=10)
    ms["pq_decode"] = time_ms(lambda: pq_decode(cb, codes), iters=10)
    ms["pq_distance"] = time_ms(lambda: pq_distance(cb, queries, codes), iters=10)
    del codes

    # binary
    bq, bq_c = binary_quantize(corpus), binary_quantize(corpus_c)
    equal_cpu("binary words", bq.bits, bq_c.bits)
    bqq, bqq_c = binary_quantize(queries), binary_quantize(queries_c)
    sub_c = BinaryQuantized(bq_c.bits[sub], d)
    ham = hamming_distance(bqq, bq)
    equal_cpu(f"hamming_distance, first {GNN_ROWS} rows", ham[:, sub],
              hamming_distance(bqq_c, sub_c))
    del ham
    scaled(f"binary_similarity, first {GNN_ROWS} rows", binary_similarity(bqq, bq)[:, sub],
           binary_similarity(bqq_c, sub_c))
    ms["binary_quantize"] = time_ms(lambda: binary_quantize(corpus), iters=10)
    ms["hamming_distance"] = time_ms(lambda: hamming_distance(bqq, bq), iters=10)
    ms["binary_similarity"] = time_ms(lambda: binary_similarity(bqq, bq), iters=10)
    del bq, bq_c

    # TensorCompress at every level: the whole corpus on the card; the card
    # against the CPU on the first QZ_PQ_CHECK rows
    tc = TensorCompress(device=DEV)
    compress = {}
    for level in ("none", "half", "pq8", "pq4", "binary"):
        small_t = tc.compress_level(corpus[:QZ_PQ_CHECK], level)
        small_c = tc.compress_level(corpus_c[:QZ_PQ_CHECK], level)
        scaled(f"TensorCompress {level} round trip, {QZ_PQ_CHECK} rows",
               tc.decompress(small_t), tc.decompress(small_c))
        payload = {"none": lambda t: [t.payload], "half": lambda t: [t.payload],
                   "pq8": lambda t: [t.payload["codebook"].codebooks, t.payload["codes"]],
                   "pq4": lambda t: [t.payload["int4"].packed, t.payload["outlier_idx"],
                                     t.payload["outlier_val"]],
                   "binary": lambda t: [t.payload.bits]}[level]
        for i, (a, b) in enumerate(zip(payload(small_t), payload(small_c))):
            equal_cpu(f"TensorCompress {level} payload {i}", a, b)
        t0 = time.perf_counter()
        ct = tc.compress_level(corpus, level)
        torch.cuda.synchronize()
        once_s = time.perf_counter() - t0
        dec = tc.decompress(ct)
        rmse = float(torch.sqrt(torch.mean((dec - corpus) ** 2)))
        entry = {"bytes_per_vector": ct.bytes_per_vector,
                 "ratio": d * 4 / ct.bytes_per_vector, "rmse": rmse,
                 "decompress_ms": time_ms(lambda: tc.decompress(ct), iters=10)}
        if level == "pq8":
            entry["compress_s"] = round(once_s, 3)
        else:
            entry["compress_ms"] = time_ms(lambda: tc.compress_level(corpus, level), iters=10)
        compress[level] = entry
        del ct, dec
    fields["compress"] = json.dumps(compress, separators=(",", ":"))

    fields["q15_dot_row0"] = _q15_rest(ms)
    fields.update(_stores_rest(d))
    fields["ms"] = json.dumps(ms, separators=(",", ":"))
    if kernels.launch_counts() != before:
        raise AssertionError("the quantization ops launched a kernel")
    say("quantization", **fields, kernel_launches=0,
        seconds=round(time.perf_counter() - t_phase, 1))


def _q15_rest(ms: dict) -> int:
    """Every Q15 op on the card against the CPU, bit for bit: the
    elementwise ops and the dot over [QZ_Q15_M, QZ_Q15_K], the matmul
    [QZ_Q15_M, QZ_Q15_K] x [QZ_Q15_K, QZ_Q15_M], on random int16 values
    with the extremes planted (whose int32 sums wrap)."""
    g = torch.Generator().manual_seed(15)
    a_c, b_c, t_c = (torch.randint(-32768, 32768, (QZ_Q15_M, QZ_Q15_K), generator=g,
                                   dtype=torch.int16) for _ in range(3))
    a_c[0], b_c[0] = -32768, -32768
    x_c = torch.rand((QZ_Q15_M, QZ_Q15_K), generator=g) * 2.5 - 1.25
    a, b, t, x = (v.to(DEV) for v in (a_c, b_c, t_c, x_c))
    bt, bt_c = b.T.contiguous(), b_c.T.contiguous()
    ops = {
        "f32_to_q15": (lambda: f32_to_q15(x), lambda: f32_to_q15(x_c)),
        "q15_to_f32": (lambda: q15_to_f32(a), lambda: q15_to_f32(a_c)),
        "q15_add": (lambda: q15_add(a, b), lambda: q15_add(a_c, b_c)),
        "q15_mul": (lambda: q15_mul(a, b), lambda: q15_mul(a_c, b_c)),
        "q15_lerp": (lambda: q15_lerp(a, b, t), lambda: q15_lerp(a_c, b_c, t_c)),
        "q15_dot": (lambda: q15_dot(a, b), lambda: q15_dot(a_c, b_c)),
        "q15_matmul": (lambda: q15_matmul(a, bt), lambda: q15_matmul(a_c, bt_c)),
    }
    for name, (card, cpu) in ops.items():
        equal_cpu(f"{name} [{QZ_Q15_M}, {QZ_Q15_K}]", card(), cpu())
        ms[name] = time_ms(card, iters=10)
    return int(q15_dot(a, b)[0])     # all -32768: the int32 sum wraps


def _stores_rest(d: int) -> dict:
    """Both temporal stores, QZ_CHUNKS chunks of QZ_CHUNK x d, the same
    sequence on the card and the CPU. temporal_tensor: writes (8 bits),
    a migration on the write clock (3, 7 and 8 bits), reads, QZ_HAMMER
    read rounds over the first QZ_HOT chunks, a migration (they return to
    8 bits, the rest go to 3). temporal_tiers on a fake clock: hot, then
    warm after 3 s, cold after 60 more, and 10 s later the first QZ_HOT
    chunks back to hot after 5 reads each.
    Stored words and scales equal, reads within the f32 limits."""
    g = torch.Generator().manual_seed(16)
    chunks = torch.randn((QZ_CHUNKS, QZ_CHUNK, d), generator=g)
    fields = {}

    def tensor_store(dev):
        st = temporal_tensor.TemporalTensorStore(device=dev)
        src = chunks.to(dev)
        tiers, reads = [], []
        for i in range(QZ_CHUNKS):
            st.write(i, src[i])
        tiers.append(st.migrate())
        reads.append(torch.stack([st.read(i) for i in range(QZ_CHUNKS)]))
        for _ in range(QZ_HAMMER):
            for i in range(QZ_HOT):
                st.read(i)
        tiers.append(st.migrate())
        reads.append(torch.stack([st.read(i) for i in range(QZ_CHUNKS)]))
        return st, tiers, reads

    def tier_store(dev):
        clock = [0.0]
        st = temporal_tiers.TemporalTensorStore(
            d, temporal_tiers.TierPolicyConfig(decay_per_second=1.0, demote_interval_s=0.0),
            clock=lambda: clock[0], device=dev)
        reads, tiers = [], []
        src = chunks.to(dev)
        for i in range(QZ_CHUNKS):
            st.write(i, src[i])
        for advance in (0.0, 3.0, 60.0):
            clock[0] += advance
            st.tick(force=True)
            tiers.append(st.stats())
            reads.append(torch.stack([st.read(i) for i in range(QZ_CHUNKS)]))
        clock[0] += 10.0
        for _ in range(5):
            for i in range(QZ_HOT):
                st.read(i)
        st.tick(force=True)
        tiers.append(st.stats())
        return st, tiers, reads

    def tier_words(st):
        """Every chunk's stored codes (int8 hot, uint8 nibbles otherwise)
        and scales, flattened."""
        data = [st._chunks[i]["data"] for i in range(QZ_CHUNKS)]
        return (torch.cat([(q.codes if isinstance(q, ScalarQuantized) else q.packed)
                           .reshape(-1).to(torch.int16) for q in data]),
                torch.cat([q.scale for q in data]))

    for name, run in (("temporal_tensor", tensor_store), ("temporal_tiers", tier_store)):
        (st, tiers, reads), t_ms = _synced_ms(lambda: run(DEV))
        st_c, tiers_c, reads_c = run("cpu")
        if tiers != tiers_c:
            raise AssertionError(f"{name}: tiers {tiers} against the CPU's {tiers_c}")
        for i, (r, r_c) in enumerate(zip(reads, reads_c)):
            agree_scaled(f"{name} reads, pass {i}: card vs CPU", r.cpu(), r_c, torch.float32)
        if name == "temporal_tensor":
            words = torch.cat([st._slots[i].packed.reshape(-1) for i in range(QZ_CHUNKS)])
            words_c = torch.cat([st_c._slots[i].packed.reshape(-1) for i in range(QZ_CHUNKS)])
            equal_cpu(f"{name} stored words", words, words_c)
            used = sum(s.packed.nbytes + s.scales.nbytes for s in st._slots.values())
            bits = [st.tier_of(i) for i in range(QZ_CHUNKS)]
            fields[name] = {"tiers_after_migrations": [
                {str(b): c for b, c in sorted(collections.Counter(m.values()).items())}
                for m in tiers], "bits_now": dict(collections.Counter(bits)),
                "MB": used / 1e6, "ratio": chunks.numel() * 4 / used,
                "sequence_ms": round(t_ms, 1)}
        else:
            for part, a_, b_ in zip(("codes", "scales"), tier_words(st), tier_words(st_c)):
                equal_cpu(f"{name} stored {part}", a_, b_)
            used = (tiers[-1]["hot"] * QZ_CHUNK * d
                    + (QZ_CHUNKS - tiers[-1]["hot"]) * QZ_CHUNK * ((d + 1) // 2))
            fields[name] = {"tiers": [{k: v for k, v in t.items() if k != "compression_ratio"}
                                      for t in tiers], "MB": used / 1e6,
                            "ratio": tiers[-1]["compression_ratio"],
                            "sequence_ms": round(t_ms, 1)}
    return {k: json.dumps(v, separators=(",", ":")) for k, v in fields.items()}


def _edges_per_s(edges: int, ms: float) -> float:
    return edges / (ms * 1e-3)


def timed(fn):
    """fn() once on the card: (its result, host seconds to a synchronised
    end, CUDA-event milliseconds between its first and last launch)."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, start.elapsed_time(end)


def agree_logits(name: str, got: torch.Tensor, want: torch.Tensor,
                 tol: tuple[float, float] | None = None) -> float:
    """Card logits against the CPU's, relative to the CPU logits' scale
    (max and mean): TF_F32_TOL unless `tol` is given."""
    return agree_scaled(f"{name}: card vs CPU", got.cpu(), want.cpu(), torch.float32,
                        tol or TF_F32_TOL)


def control_moves(name: str, got: torch.Tensor, want: torch.Tensor, limit: float, check) -> None:
    """A planted control: first that it moves the output by more than 10x
    the limit (relative to the reference's scale), then that the check
    rejects it."""
    got, want = got.float().cpu(), want.float().cpu()
    rel = float((got - want).abs().max()) / max(float(want.abs().max()), 1e-30)
    far = rel > 10 * limit
    say("control_size", name=name, max_rel_err=rel, limit=limit, far=far)
    if not far:
        raise AssertionError(f"control {name} moves the output by only {rel}")
    expect_rejected(name, check)


def greedy_with_gaps(weights, cfg, cache_cfg, prompts: np.ndarray, dev):
    """Greedy batched decode through the decode step (as
    make_batched_generate_fn runs it), keeping each generated step's top-2
    logit gap: (tokens [B, P + N], gaps [B, N], the logits' scale)."""
    step = make_decode_step(cfg, cache_cfg, dev)
    caches = [kv_cache_init(cache_cfg, dev, batch=prompts.shape[0]) for _ in range(cfg.layers)]
    p = torch.from_numpy(prompts).long().to(dev)
    toks, gaps, scale, logits = [], [], 0.0, None
    for pos in range(TF_PROMPT + TF_NEW):
        if pos < TF_PROMPT:
            tok = p[:, pos]
        else:
            top2 = torch.topk(logits, 2, dim=-1).values
            gaps.append(top2[:, 0] - top2[:, 1])
            tok = torch.argmax(logits, dim=-1)
        logits, caches = step(weights, caches, tok, pos, True)
        scale = max(scale, float(logits.abs().max()))
        toks.append(tok)
    return torch.stack(toks, 1).cpu(), torch.stack(gaps, 1).cpu(), scale


def warm_caches(step, weights, cfg, cache_cfg, prompts: torch.Tensor, dev):
    """The prompts through the decode step: (caches, the next token's
    logits [B, logits])."""
    caches = [kv_cache_init(cache_cfg, dev, batch=prompts.shape[0]) for _ in range(cfg.layers)]
    logits = None
    for pos in range(prompts.shape[1]):
        logits, caches = step(weights, caches, prompts[:, pos], pos, True)
    return caches, logits


def same_tokens(name: str, got: torch.Tensor, want: torch.Tensor, counts, gaps=None) -> None:
    """Each sequence's first counts[i] tokens equal; before failing, the
    first position that differs and the reference's top-2 gap there."""
    bad = []
    for i in range(got.shape[0]):
        k = int(counts[i])
        diff = torch.nonzero(got[i, :k].cpu() != want[i, :k].cpu()).flatten()
        if diff.numel():
            j = int(diff[0])
            bad.append((i, j, None if gaps is None else float(gaps[i, j])))
    if bad:
        say("token_mismatch", name=name, sequence_position_gap=bad)
        raise AssertionError(f"{name}: {len(bad)} sequences differ")


def _tf_train(cfg) -> dict:
    """Early-exit training at full width, then its first step at batch 2
    against the CPU: in float64 the loss and each leaf's gradient norm
    within 1e-4 relative; in float32 the card no further from the float64
    step than twice the CPU is."""
    t0 = time.perf_counter()
    res = train_early_exit(cfg, draft_layers=TF_DRAFT, device=DEV, **TF_TRAIN)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    fields = {"train_s": round(train_s, 3), "loss_first": res.losses[0],
              "loss_last": res.losses[-1], "full_acc": res.full_acc,
              "draft_acc": res.draft_acc, "agreement": res.agreement,
              "n_params": sum(t.numel() for t in tree_leaves(res.weights)),
              "train_ms_per_step": round(train_s * 1e3 / TF_TRAIN["steps"], 3)}
    if res.agreement < 0.8 or not all(np.isfinite(res.losses)):
        raise AssertionError(f"early-exit training: agreement {res.agreement} < 0.8")

    seed = TF_TRAIN["seed"]
    toks_np, _ = markov_corpus(seed, cfg.vocab, n_seq=512, seq_len=TF_TRAIN["seq_len"])
    idx = np.random.default_rng(seed + 1).integers(0, len(toks_np), TF_TRAIN["batch"])[:2]
    batch = torch.from_numpy(toks_np[idx])
    w0 = init_weights(torch.Generator().manual_seed(seed), cfg, quantize=False, device="cpu")

    def loss_and_norms(dev, dtype):
        w = tree_map(lambda t: t.detach().to(dev, dtype).requires_grad_(True), w0)
        loss = early_exit_loss(w, cfg, batch.to(dev), TF_DRAFT)
        grads = torch.autograd.grad(loss, tree_leaves(w))
        return np.array([float(loss.detach())] + [float(torch.linalg.vector_norm(g))
                                                  for g in grads])

    def rel(a, b):
        return np.abs(a - b) / np.maximum(np.abs(b), 1e-30)

    # the check: the same step in float64 on the card and on the CPU, where
    # the sums' order cannot move the loss or a norm by 1e-4
    d64, c64 = loss_and_norms(DEV, torch.float64), loss_and_norms("cpu", torch.float64)
    err64 = rel(d64, c64)
    # float32 beside it, each side against the CPU's float64: the card's
    # error may not exceed twice the CPU's (a product that lost precision,
    # TF32 say, would)
    d32, c32 = loss_and_norms(DEV, torch.float32), loss_and_norms("cpu", torch.float32)
    card32, cpu32 = rel(d32, c64), rel(c32, c64)
    fields.update(step_loss=c64[0], step_f64_max_rel_err=float(err64.max()),
                  step_f32_cpu_worst_leaf=int(np.argmax(cpu32)) - 1,
                  step_f32_card_vs_cpu_max_rel_err=float(rel(d32, c32).max()),
                  step_f32_card_vs_f64_max_rel_err=float(card32.max()),
                  step_f32_cpu_vs_f64_max_rel_err=float(cpu32.max()),
                  step_f32_worst_leaf=int(np.argmax(card32)) - 1)
    if err64.max() > 1e-4:
        raise AssertionError(f"first train step in float64: loss or a gradient norm "
                             f"{err64.max()} off the CPU's (leaf {int(np.argmax(err64)) - 1})")
    if card32.max() > 2 * cpu32.max() + 1e-6:
        raise AssertionError(f"first train step in float32: the card {card32.max()} off "
                             f"float64, the CPU {cpu32.max()}")
    say("transformer_train", **fields, ok=True)
    return res.weights


def _tf_decode(weights, cfg) -> dict:
    """Greedy and speculative batched decoding (benchmarks/spec_at_size.py's
    protocol and counts), their first logits and teacher-forced logits
    against the CPU, greedy streams against the CPU's, and two controls."""
    fields = {}
    cache_cfg = KVCacheConfig(hot_capacity=TF_HOT, warm_capacity=0, archive_capacity=0,
                              heads=cfg.heads, head_dim=cfg.head_dim)
    prompts, _ = markov_corpus(0, cfg.vocab, n_seq=TF_BATCH, seq_len=TF_PROMPT,
                               sample_seed=1234)
    prompts_d = torch.from_numpy(prompts).long().to(DEV)
    fresh = [kv_cache_init(cache_cfg, DEV, batch=TF_BATCH) for _ in range(cfg.layers)]

    # --- greedy: the batched whole-generation loop ---
    gen_b = make_batched_generate_fn(cfg, cache_cfg, TF_PROMPT, TF_NEW, device=DEV)
    gen_b(weights, fresh, prompts)                                   # first call
    (out_g, _), greedy_s, greedy_ev_ms = timed(lambda: gen_b(weights, fresh, prompts))
    greedy_tps = TF_BATCH * (TF_PROMPT + TF_NEW) / greedy_s
    fields.update(greedy_s=greedy_s, greedy_event_ms=greedy_ev_ms,
                  greedy_tokens_per_s=greedy_tps,
                  greedy_ms_per_step=greedy_s * 1e3 / (TF_PROMPT + TF_NEW))
    toks_g = out_g[:, TF_PROMPT:].cpu()

    # --- speculative: caches warmed on the prompt, then the batched loop ---
    step = make_decode_step(cfg, cache_cfg, DEV)
    sgen = make_speculative_generate_fn(cfg, cache_cfg, SpecDecodeConfig(TF_GAMMA, TF_DRAFT),
                                        TF_NEW, device=DEV)
    caches_w, first_logits = warm_caches(step, weights, cfg, cache_cfg, prompts_d, DEV)
    first = torch.argmax(first_logits, dim=-1)
    sgen(weights, caches_w, first)                                   # first call
    out_s, spec_s, spec_ev_ms = timed(lambda: sgen(weights, caches_w, first))
    toks_s, counts, _, acc_totals, commits = (x.cpu() if torch.is_tensor(x) else x
                                              for x in out_s)
    accs = []
    for i in range(TF_BATCH):
        n_macros = int(np.searchsorted(np.cumsum(commits[i].numpy()), float(counts[i]))) + 1
        accs.append(float(acc_totals[i]) / max((TF_GAMMA - 1) * n_macros, 1))
    g_toks, g_gaps, g_scale = greedy_with_gaps(weights, cfg, cache_cfg, prompts, DEV)
    same_tokens("greedy loop vs make_batched_generate_fn", g_toks, out_g.cpu(),
                [TF_PROMPT + TF_NEW] * TF_BATCH)
    same_tokens("speculative vs greedy", toks_s, toks_g, counts, g_gaps)
    fields.update(spec_s=spec_s, spec_event_ms=spec_ev_ms,
                  spec_tokens_per_s=TF_BATCH * TF_NEW / spec_s,
                  acceptance=float(np.mean(accs)), macro_steps=int((commits > 0).sum(1).max()),
                  speedup_vs_greedy=(greedy_s / (TF_PROMPT + TF_NEW)) / (spec_s / TF_NEW),
                  token_identical_to_greedy=True)

    # --- against the CPU: the f32 route ---
    w_cpu = _tree_cpu(weights)
    step_c = make_decode_step(cfg, cache_cfg, "cpu")
    caches_c, first_logits_c = warm_caches(step_c, w_cpu, cfg, cache_cfg,
                                           prompts_d.cpu(), "cpu")
    agree_logits("prompt's last decode logits", first_logits, first_logits_c)
    dec_logits, _ = step(weights, caches_w, first, TF_PROMPT, True)
    dec_logits_c, _ = step_c(w_cpu, caches_c, first.cpu(), TF_PROMPT, True)
    agree_logits("first decode logits", dec_logits, dec_logits_c)
    ev_np, _ = markov_corpus(TF_TRAIN["seed"], cfg.vocab, n_seq=TF_BATCH,
                             seq_len=TF_TRAIN["seq_len"], sample_seed=TF_TRAIN["seed"] + 99)
    ev = torch.from_numpy(ev_np).long()
    depths = (TF_DRAFT, cfg.layers)
    with torch.no_grad():
        tf_d = seq_logits_at_depths(weights, cfg, ev.to(DEV), depths)
        tf_c = seq_logits_at_depths(w_cpu, cfg, ev, depths)
    for depth, a, b in zip(depths, tf_d, tf_c):
        agree_logits(f"teacher-forced logits at depth {depth}", a, b)
    c_toks, c_gaps, c_scale = greedy_with_gaps(w_cpu, cfg, cache_cfg, prompts, "cpu")
    near_tie = c_gaps < 1e-5 * c_scale
    first_tie = [int(torch.nonzero(row).flatten()[0]) if bool(row.any()) else TF_NEW
                 for row in near_tie]
    same_tokens("greedy streams, card vs CPU, before each first near tie", toks_g,
                c_toks[:, TF_PROMPT:], first_tie, c_gaps)
    fields.update(cpu_first_near_tie_step=[t if t < TF_NEW else None for t in first_tie],
                  cpu_min_top2_gap_rel=float(c_gaps.min()) / c_scale,
                  card_min_top2_gap_rel=float(g_gaps.min()) / g_scale,
                  greedy_equal_cpu=bool(torch.equal(toks_g, c_toks[:, TF_PROMPT:])))

    say("transformer_decode", batch=TF_BATCH, prompt=TF_PROMPT, new_tokens=TF_NEW,
        gamma=TF_GAMMA, draft_layers=TF_DRAFT, hot=TF_HOT, **fields)
    return {"step": step, "caches_w": caches_w, "first": first, "dec_logits_c": dec_logits_c,
            "ev": ev, "tf_c": tf_c[1], "sgen": sgen, "toks_g": toks_g}


def _tf_controls(weights, cfg, ctx: dict) -> None:
    """Three planted faults, each first shown to move its output well past
    the limit, then rejected by the check the real path passed: the
    exact-erf GELU (teacher-forced logits against the CPU's), RoPE
    positions off by one in the decode step (first decode logits against
    the CPU's), a verify that accepts every draft (speculative tokens
    against greedy)."""
    with torch.no_grad(), mock.patch.object(tf_model, "_gelu", F.gelu):   # exact erf GELU
        bad = seq_logits_at_depths(weights, cfg, ctx["ev"].to(DEV), (cfg.layers,))[0]
    control_moves("teacher-forced logits with the exact-erf GELU", bad, ctx["tf_c"],
                  TF_F32_TOL[0],
                  lambda: agree_logits("teacher-forced logits, erf GELU (control)", bad,
                                       ctx["tf_c"]))
    shifted = lambda x, pos, c, s: rope_rotate(x, pos + 1, c, s)        # noqa: E731
    with mock.patch.object(tf_decode, "rope_rotate", shifted):
        bad, _ = ctx["step"](weights, ctx["caches_w"], ctx["first"], TF_PROMPT, True)
    control_moves("first decode logits with RoPE positions off by one", bad,
                  ctx["dec_logits_c"], TF_F32_TOL[0],
                  lambda: agree_logits("first decode logits, RoPE + 1 (control)", bad,
                                       ctx["dec_logits_c"]))
    accept_all = lambda toks, targets: torch.full(                       # noqa: E731
        (toks.shape[0],), toks.shape[1] - 1, dtype=torch.long, device=toks.device)
    with mock.patch.object(tf_spec, "accepted_drafts", accept_all):
        bad_s = ctx["sgen"](weights, ctx["caches_w"], ctx["first"])[0].cpu()
    wrong = int((bad_s != ctx["toks_g"]).sum())
    say("control_size", name="a verify that accepts every draft", tokens_wrong=wrong,
        of=TF_BATCH * TF_NEW, far=wrong > 0)
    if wrong == 0:
        raise AssertionError("control: accepting every draft left the tokens unchanged")
    expect_rejected("a verify that accepts every draft", lambda: same_tokens(
        "speculative, every draft accepted (control)", bad_s, ctx["toks_g"],
        [TF_NEW] * TF_BATCH))


class CodeRecorder:
    """Wraps model.int8_matmul: keeps every call's activation codes."""

    def __init__(self):
        self.codes = []

    def __call__(self, x, w_q, w_scale, bias=None):
        self.codes.append(quantize_activation_int8(x)[0].cpu())
        return int8_matmul(x, w_q, w_scale, bias)


def _tf_tiers(cfg) -> dict:
    """The tier programs on the int8 route at full width with a 512-token
    prompt, driven by the gate packets of tests/test_transformer.py:39-110
    and once more with min-cut sparse attention and MoD routing: witnesses
    deterministic, logits within 5e-2 of the CPU's; int8 codes and int32
    sums equal on equal inputs."""
    fields = {}
    wq = init_weights(torch.Generator().manual_seed(1), cfg, quantize=True, device=DEV)
    wq_c = _tree_cpu(wq)
    toks, _ = markov_corpus(2, cfg.vocab, n_seq=1, seq_len=TF_TIER_TOKENS)
    tokens = toks[0]
    policy = GatePolicy()
    model = MincutGatedTransformer(cfg, policy, wq, device=DEV)
    model_c = MincutGatedTransformer(cfg, policy, wq_c, device="cpu")
    # tests/test_transformer.py:228-230's routing: 15% of the tokens (the
    # most recent) compute, fewer than the last token's receptive field of
    # 12 x 15 positions, so the logits change (the default 50% would not)
    mod = ModRoutingConfig(layer_capacity_ratio=0.15, min_tokens_per_layer=2,
                           adaptive_capacity=False)
    sparse = MincutGatedTransformer(cfg, policy, wq, sparsity_config=SparsityConfig(),
                                    mod_config=mod, device=DEV)
    sparse_c = MincutGatedTransformer(cfg, policy, wq_c, sparsity_config=SparsityConfig(),
                                      mod_config=mod, device="cpu")
    runs = {
        "normal": (model, model_c, GatePacket(lam=100, lam_prev=100), None),
        "reduced": (model, model_c, GatePacket(boundary_edges=100), None),
        "safe": (model, model_c, GatePacket(flags=GatePacket.FLAG_FORCE_SAFE), None),
        "quarantine": (model, model_c, GatePacket(lam=5), None),
        "flush": (model, model_c, GatePacket(lam=40, lam_prev=100), None),
        "spike_storm": (model, model_c, GatePacket(), SpikePacket(fired=1, rate_q15=30000)),
        "skip": (model, model_c, GatePacket(flags=GatePacket.FLAG_SKIP), None),
        "spike_inactive": (model, model_c, GatePacket(), SpikePacket(fired=0)),
        "sparse_mod": (sparse, sparse_c, GatePacket(lam=100, partition_count=4), None),
    }
    tiers = {}
    for name, (m, m_c, gate, spikes) in runs.items():
        rec, rec_c = CodeRecorder(), CodeRecorder()
        with mock.patch.object(tf_model, "int8_matmul", rec):
            out = m.infer(tokens=tokens, gate=gate, spikes=spikes)
        again = m.infer(tokens=tokens, gate=gate, spikes=spikes)
        if dataclasses.asdict(again.witness) != dataclasses.asdict(out.witness):
            raise AssertionError(f"tier {name}: the same input gave another witness")
        _, host_s, ev_ms = timed(lambda: m.infer(tokens=tokens, gate=gate, spikes=spikes))
        if not np.isfinite(out.logits).all() or out.logits.shape != (cfg.logits,):
            raise AssertionError(f"tier {name}: logits not finite or of the wrong shape")
        with mock.patch.object(tf_model, "int8_matmul", rec_c):
            out_c = m_c.infer(tokens=tokens, gate=gate, spikes=spikes)
        if (out.witness.tier, out.witness.layers_run, out.witness.decision) != (
                out_c.witness.tier, out_c.witness.layers_run, out_c.witness.decision):
            raise AssertionError(f"tier {name}: the card's witness differs from the CPU's")
        dev_err = agree_logits(f"tier {name} logits (int8 route)", torch.from_numpy(out.logits),
                               torch.from_numpy(out_c.logits), (TF_INT8_TOL, TF_INT8_TOL))
        scale = max(float(np.abs(out_c.logits).max()), 1e-30)
        n_codes = sum(c.numel() for c in rec_c.codes)
        differ = sum(int((a != b).sum()) for a, b in zip(rec.codes, rec_c.codes))
        tiers[name] = {"tier": out.witness.tier, "layers_run": out.witness.layers_run,
                       "ms": round(host_s * 1e3, 3), "event_ms": round(ev_ms, 3),
                       "max_logit_dev": dev_err, "max_logit_rel_dev": dev_err / scale,
                       "codes_differ_share": differ / n_codes if n_codes else 0.0}
    if np.array_equal(sparse.infer(tokens=tokens, gate=runs["sparse_mod"][2]).logits,
                      model.infer(tokens=tokens, gate=runs["sparse_mod"][2]).logits):
        raise AssertionError("sparse attention + MoD left the normal tier's logits unchanged")
    fields["tiers"] = json.dumps(tiers, separators=(",", ":"))

    # int8 codes and int32 sums, card vs CPU, on layer 0's own input
    layer = wq["layers"][0]
    with torch.no_grad():
        x = tf_model._embed(wq, torch.from_numpy(tokens).to(DEV))
        h = tf_model._ln(layer["ln1"], x)
    x_q, x_s = quantize_activation_int8(h)
    x_qc, x_sc = quantize_activation_int8(h.cpu())
    equal_cpu("layer 0 activation codes", x_q, x_qc)
    equal_cpu("layer 0 activation scales", x_s, x_sc)
    for leaf in ("qkv", "ffn_in"):            # [1024, 3072] and [1024, 4096]
        p = layer[leaf]
        equal_cpu(f"layer 0 {leaf} int32 sums", int8_sums(x_q, p["w_q"]),
                  int8_sums(x_qc, p["w_q"].cpu()))
        equal_cpu(f"layer 0 {leaf} int8_matmul", int8_matmul(h, p["w_q"], p["scale"], p["bias"]),
                  int8_matmul(h.cpu(), p["w_q"].cpu(), p["scale"].cpu(), p["bias"].cpu()))
    say("transformer_tiers", prompt=TF_TIER_TOKENS, **fields, ok=True)
    return tiers


def _tf_cache(weights, cfg) -> tuple[KVCacheConfig, KVCacheState]:
    """The Decoder's default tiered cache (hot = window_normal, warm =
    archive = seq_len_max) through enough tokens that the archive ring
    wraps, three gate-frozen steps among them: every layer's codes, scales
    and positions equal a CPU cache fed the same per-step K/V."""
    dec = Decoder(cfg, GatePolicy(), weights, device=DEV)
    cc = dec.cache_cfg
    n_tok = cc.hot_capacity + cc.warm_capacity + cc.archive_capacity + TF_CACHE_EXTRA
    stream, _ = markov_corpus(3, cfg.vocab, n_seq=1, seq_len=n_tok)
    frozen = {n_tok // 4, n_tok // 2, n_tok - 5}
    caches = dec.init_caches()
    rows, enabled, length = [], [], 0

    def run():
        nonlocal caches, length
        for pos, tok in enumerate(stream[0]):
            gate = GatePacket(lam=5) if pos in frozen else GatePacket()
            kv_ok = dec.gate_controller.should_allow_kv_writes(gate)
            _, caches = dec._step(weights, caches, int(tok), pos, kv_ok)
            # the hot row this step wrote: its ring slot, or the scratch row
            slot = length % cc.hot_capacity if kv_ok else cc.hot_capacity
            rows.append(torch.stack([torch.stack([c.hot_k[slot], c.hot_v[slot]])
                                     for c in caches]))
            enabled.append(kv_ok)
            length += int(kv_ok)

    _, host_s, _ = timed(run)
    rows_c = torch.stack(rows).cpu()                    # [N, L, 2, H, hd]
    for li, cache in enumerate(caches):
        ref = kv_cache_init(cc, device="cpu")
        for i in range(n_tok):
            ref = kv_cache_append(cc, ref, rows_c[i, li, 0], rows_c[i, li, 1], enabled[i])
        for f in (field.name for field in dataclasses.fields(KVCacheState)):
            got, want = getattr(cache, f).cpu(), getattr(ref, f)
            if not torch.equal(got, want):
                raise AssertionError(f"layer {li} cache {f}: the card differs from the CPU")
    wrapped = int(caches[0].arch_pos.max()) >= cc.archive_capacity
    if int(caches[0].length) != length or not wrapped:
        raise AssertionError(f"tiered cache: length {int(caches[0].length)}, archive wrapped "
                             f"{wrapped}")
    fields = {"tokens": n_tok, "frozen_steps": len(frozen), "length": length,
              "hot_warm_archive": [cc.hot_capacity, cc.warm_capacity, cc.archive_capacity],
              "archive_wrapped": wrapped, "decode_s": host_s,
              "decode_ms_per_token": host_s * 1e3 / n_tok, "layers_equal_cpu": len(caches)}
    say("transformer_cache", **fields, ok=True)
    return cc, caches[0]


def _tf_subsystems(cache0: KVCacheState, cc: KVCacheConfig) -> dict:
    """Mamba over 512 steps, spike-driven attention, spectral positions, and
    KVQuant and SQuat on layer 0's cached K/V, each against the CPU."""
    fields = {}
    mcfg = MambaConfig.baseline()
    mw = mamba_init(torch.Generator().manual_seed(4), mcfg, device=DEV)
    xs = torch.randn(TF_MAMBA_STEPS, mcfg.d_model, generator=torch.Generator().manual_seed(5))
    ys, host_s, _ = timed(lambda: mamba_forward_sequence(mcfg, mw, xs.to(DEV)))
    agree_cpu(f"mamba over {TF_MAMBA_STEPS} steps", ys,
              mamba_forward_sequence(mcfg, _tree_cpu(mw), xs))
    fields["mamba_s"] = host_s

    k, v, mask = kv_cache_read(cc, cache0)
    live = mask > 0
    k_live, v_live = k[live], v[live]                 # [T, H, hd], in ring order
    head0 = k_live[:, 0].contiguous()
    scfg = SpikeDrivenConfig()
    equal_cpu("spike trains of layer 0's head-0 keys", encode_rate(head0, scfg),
              encode_rate(head0.cpu(), scfg))
    att, host_s, _ = timed(lambda: spike_driven_attention(head0, head0, v_live[:, 0], scfg))
    agree_cpu("spike-driven attention on layer 0's head-0 K/V", att,
              spike_driven_attention(head0.cpu(), head0.cpu(), v_live[:, 0].cpu(), scfg))
    fields["spike_attention_ms"] = host_s * 1e3

    n = head0.shape[0]
    edges = [(i, (i + 1) % n) for i in range(n)] + [(i, (i + 7) % n) for i in range(0, n, 16)]
    enc = SpectralPositionEncoder()
    pe = enc.encode_from_edges(edges, n)
    agree_cpu("spectral positions added to layer 0's keys", enc.add_to_embeddings(head0, pe),
              enc.add_to_embeddings(head0.cpu(), pe))
    lap = torch.from_numpy(laplacian_from_edges(edges, n, normalized=True))
    agree_cpu("power iteration on the key graph's Laplacian", power_iteration(lap.to(DEV)),
              power_iteration(lap))
    src, dst = np.asarray(edges).T
    csr = CSRGraph.from_edges(np.r_[src, dst], np.r_[dst, src], None, n, device=DEV)
    csr_c = CSRGraph.from_edges(np.r_[src, dst], np.r_[dst, src], None, n, device="cpu")
    agree_cpu("sparse power iteration", power_iteration_sparse(csr), power_iteration_sparse(csr_c))

    keys = k_live.reshape(-1, cc.head_dim)
    vals = v_live.reshape(-1, cc.head_dim)
    kq, kq_c = kvquant_quantize_keys(keys), kvquant_quantize_keys(keys.cpu())
    equal_cpu("KVQuant key codes", kq.q, kq_c.q)
    equal_cpu("KVQuant key scales", kq.scale, kq_c.scale)
    nv, nv_c = kvquant_quantize_values(vals), kvquant_quantize_values(vals.cpu())
    equal_cpu("KVQuant value codes", nv.q, nv_c.q)
    equal_cpu("KVQuant value outliers", nv.outlier_mask, nv_c.outlier_mask)
    basis = squat_learn_basis(keys, num_subspaces=4, bits=4)
    carried = SQuatBasis(basis.basis.cpu(), 4, 4)
    sq, sq_c = squat_quantize(keys, basis), squat_quantize(keys.cpu(), carried)
    rec = squat_dequantize(sq, basis)
    rec_c = squat_dequantize(sq_c, carried)
    mse, mse_c = float(torch.mean((rec - keys) ** 2)), float(torch.mean((rec_c - keys.cpu()) ** 2))
    if abs(mse - mse_c) > 1e-2 * mse_c:
        raise AssertionError(f"SQuat reconstruction error: card {mse}, CPU {mse_c}")
    fields.update(kv_rows=int(keys.shape[0]),
                  kvquant_key_mse=float(torch.mean((kvquant_dequantize_keys(kq) - keys) ** 2)),
                  squat_mse=mse, squat_codes_differ_share=float(
                      (sq.codes.cpu() != sq_c.codes).float().mean()))
    say("transformer_subsystems", mamba_steps=TF_MAMBA_STEPS, mamba_d_model=mcfg.d_model,
        **fields, ok=True)
    return fields


def phase_transformer() -> None:
    """The min-cut-gated transformer (`[transformer]`, no kernel) at
    benchmarks/spec_at_size.py:59-70's full width (12 layers, hidden 1024,
    16 heads, vocab and logits 512; nothing cut): early-exit training (250
    Adam steps, batch 16), greedy and speculative batched decoding of 4
    prompts (128 new tokens, gamma 6, a 2-layer draft), the tier programs
    on the int8 route, the tiered KV cache through every tier, and the
    subsystems; each against the same function on the CPU, with three
    planted controls (the exact-erf GELU, RoPE positions off by one in the
    decode step, a verify that accepts every draft; run last). Times: the host clock
    around a synchronised call (as the JAX bench times), CUDA events
    beside it."""
    t_phase = time.perf_counter()
    before = kernels.launch_counts()
    cfg = TransformerConfig(**TF_CFG)
    weights = _tf_train(cfg)
    ctx = _tf_decode(weights, cfg)
    _tf_tiers(cfg)
    cc, cache0 = _tf_cache(weights, cfg)
    _tf_subsystems(cache0, cc)
    _tf_controls(weights, cfg, ctx)
    if kernels.launch_counts() != before:
        raise AssertionError("the transformer launched a kernel")
    say("transformer", layers=cfg.layers, hidden=cfg.hidden, heads=cfg.heads, vocab=cfg.vocab,
        kernel_launches=0, seconds=round(time.perf_counter() - t_phase, 1))


# ---------------------------------------------------------------------------
# the native runtime, the vector database, the property graph, the min-cut
# toolkit (host workloads: the card does the layouts, the CSR and CG parts,
# the GNN on the index's graph and the exact scoring)
# ---------------------------------------------------------------------------

def _python_route(fn):
    """fn with the native runtime switched off: the Python routes."""
    with mock.patch.object(native, "available", False):
        return fn()


def _equal_layouts(name: str, got, want) -> None:
    """Two block-dense layouts: every table equal bit for bit."""
    for field in ("local_ids", "degrees", "node_pad", "node_pos"):
        if not torch.equal(getattr(got, field), getattr(want, field)):
            raise AssertionError(f"{name}: {field} differs")
    differ = int((got.wdense.float() != want.wdense.float()).sum())
    say("equal", name=name, wdense_entries_differ=differ, ok=differ == 0)
    if differ or got.log_mult is not None:
        raise AssertionError(f"{name}: wdense differs")


def _valid_draws(nbr: np.ndarray, mask: np.ndarray, idx: np.ndarray, smask: np.ndarray,
                 fanout: int) -> None:
    """Every drawn id is one of the node's neighbours, none twice, and a
    node of degree <= fanout keeps all of them."""
    real = mask > 0
    picked = smask > 0
    is_nbr = ((idx[:, :, None] == nbr[:, None, :]) & real[:, None, :]).any(2)
    # distinct fill values where nothing was drawn, so only repeats match
    srt = np.sort(np.where(picked, idx, -1 - np.arange(fanout)[None, :]), axis=1)
    # as many distinct neighbours as min(degree, fanout): all of a small node's
    ok = (bool((picked.sum(1) == np.minimum(real.sum(1), fanout)).all())
          and bool(is_nbr[picked].all()) and bool((srt[:, 1:] != srt[:, :-1]).all()))
    if not ok:
        raise AssertionError("sample_fanout: a draw is not a neighbour, repeats, or drops one")


def phase_native(feats: torch.Tensor, graph: NeighborGraph, d: int) -> None:
    """The port's own native runtime (`[native]`): the library must build
    (its g++ seconds and paths are printed); then each native route
    against its Python route. Config 5's 999,936-node layout (uniform
    256-node blocks) by the device fill and the Python route; GraphSAGE's
    fanout draws on the 100k graph by both routes (each checked, the
    forward run on the native draws against the CPU); the min-cut gate over the 390 sequences of `[attention_rest]` by
    the native Dinic, and its first NT_PY_SEQS by the Python Dinic too."""
    t_phase = time.perf_counter()
    before = kernels.launch_counts()
    _native_runtime()
    say("native", available=True, build_s=json.dumps(
        {k: round(v, 3) for k, v in native.build_seconds.items()}, separators=(",", ":")),
        libraries=",".join(os.path.relpath(native.library_path(n), REPO_DIR)
                           for n in ("graph_runtime", "hnsw")))

    # config 5's layout by the device fill and the Python route
    _, idx, ew = cluster_graph(C5_NODES, d, C5_K)
    idx, ew = idx.cpu().numpy(), ew.cpu().numpy()
    ones = np.ones_like(ew)

    def layout(**kw):
        return build_block_dense(idx, ones, ew, block=C5_BLOCK, device=DEV, **kw)

    ms = {}
    fill, ms["device_fill"] = _synced_ms(layout)
    python, ms["python"] = _synced_ms(lambda: _python_route(layout))
    _equal_layouts("config5 layout: device fill vs Python route", fill, python)
    del python
    # bf16: the device fill's table is its f32 table rounded
    _equal_layouts("config5 bf16 layout: device fill vs its f32 table rounded",
                   layout(dtype=torch.bfloat16),
                   dataclasses.replace(fill, wdense=fill.wdense.to(torch.bfloat16)))
    del fill
    torch.cuda.empty_cache()
    say("native_layout", nodes=C5_NODES, block=C5_BLOCK,
        layout_ms=json.dumps({k: round(v, 1) for k, v in ms.items()}, separators=(",", ":")))

    # GraphSAGE's fanout draws
    nbr, mask = graph.nbr_idx.cpu().numpy(), graph.nbr_mask.cpu().numpy()
    (n_idx, n_mask), native_ms = _synced_ms(lambda: sample_fanout(graph, NT_FANOUT, seed=42))
    (p_idx, p_mask), python_ms = _synced_ms(
        lambda: _python_route(lambda: sample_fanout(graph, NT_FANOUT, seed=42)))
    for i, m in ((n_idx, n_mask), (p_idx, p_mask)):
        _valid_draws(nbr, mask, i.cpu().numpy(), m.cpu().numpy(), NT_FANOUT)
    sage_cfg = GraphSAGENetConfig(in_features=d, hidden_features=d, out_features=d,
                                  fanouts=(NT_FANOUT,))
    sage_p = graphsage_net_init(0, sage_cfg, device=DEV)
    lc = sage_cfg.layer_cfgs()[0]
    out = graphsage_apply(sage_p[0], lc, feats, n_idx, n_mask)
    agree_cpu("GraphSAGE layer on the native draws", out,
              graphsage_apply(_tree_cpu(sage_p[0]), lc, feats.cpu(), n_idx.cpu(), n_mask.cpu()))
    say("native_sampling", nodes=graph.num_nodes, fanout=NT_FANOUT, native_ms=native_ms,
        python_ms=python_ms, ids_equal_across_routes=bool(torch.equal(n_idx, p_idx)))

    # the min-cut gate: native against Python
    k = feats.shape[0] // MC_SEQ
    xs = feats[:k * MC_SEQ].reshape(k, MC_SEQ, d)
    logits = (torch.matmul(xs, xs.transpose(1, 2)) / (d ** 0.5)).cpu().numpy()
    costs = []

    def gate(lam, seqs):
        return [dynamic_min_cut(logits[i], MC_SEQ, lam, 2, MC_EPS) for i in seqs]

    res = {}
    res[0.5], native_ms = _synced_ms(lambda: gate(0.5, range(k)))
    lam_cut = 1.0       # the smallest lam of 1, 2, 4, ... at which the gate cuts
    while not any(r.cut_cost > 0 for r in res.setdefault(lam_cut, gate(lam_cut, range(k)))):
        if lam_cut >= MC_LAM_MAX:
            raise AssertionError(f"no gate cuts at lam up to {lam_cut}")
        lam_cut *= 2
    for lam in (0.5, lam_cut):
        # the first sequences and the first that the native gate cut
        cut_seqs = [i for i, r in enumerate(res[lam]) if r.cut_cost > 0]
        seqs = sorted(set(range(NT_PY_SEQS // 2)) | set(cut_seqs[:NT_PY_SEQS // 2]))
        py, py_ms = _synced_ms(lambda: _python_route(lambda: gate(lam, seqs)))
        for i, b in zip(seqs, py):
            a = res[lam][i]
            if not np.array_equal(a.keep_mask, b.keep_mask) or \
                    abs(a.cut_cost - b.cut_cost) > 1e-4 * max(1.0, abs(b.cut_cost)):
                raise AssertionError(f"min-cut gate lam {lam} sequence {i}: native "
                                     f"({a.cut_cost}) vs Python ({b.cut_cost})")
        costs.append({"lam": lam, "cuts": len(cut_seqs), "python_checked": len(seqs),
                      "python_checked_cuts": len(set(seqs) & set(cut_seqs)),
                      "python_ms_per_seq": py_ms / len(seqs)})
    say("native_mincut_gate", sequences=k, seq_len=MC_SEQ, native_ms_per_seq=native_ms / k,
        lam_cut=lam_cut,
        by_lam=json.dumps(costs, separators=(",", ":")), masks_equal=True)
    after = kernels.launch_counts()
    say("native_done", seconds=round(time.perf_counter() - t_phase, 1),
        kernel_launches=sum(after[n] - before[n] for n in after))


def _recall(ids: np.ndarray, truth: np.ndarray, k: int) -> float:
    return float(np.mean([len(set(a[:k].tolist()) & set(b[:k].tolist())) / k
                          for a, b in zip(ids, truth)]))


def _k3_at(params, feats: torch.Tensor, g: NeighborGraph, heads: int):
    """K3's call and its plain version's at a graph's shapes (layer 0 of a
    stack, inputs as the `kernels` line builds them), its bound, and the
    bound's time for the inputs as passed. The bound counts the gathered
    rows of real slots only: a masked slot's row is padding that the
    function needs not read (the HNSW graph fills 60% of its slots)."""
    d = feats.shape[1]
    hd = d // heads
    wk = params["attn"]["k"]["kernel"].reshape(d, heads, hd)
    bk = params["attn"]["k"]["bias"].reshape(heads, hd)
    msg = linear_apply(params["w_msg"], feats)
    q = linear_apply(params["attn"]["q"], msg).reshape(-1, heads, hd)
    args = (torch.einsum("nhf,dhf->nhd", q, wk).contiguous(),
            torch.einsum("nhf,hf->nh", q, bk).contiguous(),
            msg[g.nbr_idx.long()].contiguous(), g.nbr_mask.contiguous(),
            normalized_weights(g.edge_weight, g.nbr_mask).contiguous())
    edges = int((g.nbr_mask > 0).sum())
    ops = {torch.float32: 2 * (2 * heads + 1) * d * edges}
    out = (heads + 1) * feats.shape[0] * d * 4
    real_rows = edges * d * args[2].element_size()
    return (lambda: fused_neighbor_mix(*args, heads=heads, scale=hd ** -0.5),
            lambda: fused_neighbor_mix_reference(*args, heads=heads, scale=hd ** -0.5),
            bound(nbytes(args[0], args[1], args[3], args[4]) + real_rows + out, ops),
            bound(nbytes(*args) + out, ops)[0])


def _k3_stack(d: int, heads: int):
    """`[serve]`'s 2-layer f32 RuvectorLayer stack on the K3 route."""
    cfg = RuvectorLayerConfig(d, d, heads=heads, use_pallas=True)
    return cfg, [ruvector_layer_init(seed, cfg, device=DEV) for seed in (0, 1)]


def _apply_stack(stack, cfg, x, g):
    for p in stack:
        x = ruvector_layer_apply(p, cfg, x, g)
    return x


def phase_index(feats_np: np.ndarray, feats: torch.Tensor, labels: np.ndarray, d: int,
                heads: int, cpu_rerun: bool = False) -> dict:
    """The vector database (`[index]`): VectorDB with the HNSW defaults
    (m 32, ef_construction 200, ef_search 100) loaded with the main path's
    corpus by the serial insert_batch, each row's payload {cluster, bucket};
    IX_QUERIES searches (corpus rows plus IX_NOISE N(0, 1)) at k=10 against
    the flat index's exact top-10 on the card; a cluster filter (the
    candidate route, against exact scoring of the cluster) and a bucket
    range filter (the over-fetch route); the index's level-0 graph and
    features on the card through `[serve]`'s K3 stack (K3 at M = the
    index's widest list) and the hierarchical forward over its levels;
    BASELINE.md row 1's operating point; the hyperbolic index's pruned
    search against its exact one, and with cpu_rerun (the phase run alone)
    both against the CPU; a save/load round trip. Returns K3's launches
    and its time at M."""
    t_phase = time.perf_counter()
    n = feats_np.shape[0]
    db = VectorDB(DbOptions(dimensions=d), device=DEV)
    payloads = [{"cluster": int(c), "bucket": i % 10} for i, c in enumerate(labels)]
    _, build_ms = _synced_ms(lambda: db.insert_batch(feats_np, payloads=payloads))
    rng = np.random.default_rng(11)
    rows = rng.choice(n, IX_QUERIES, replace=False)
    queries = (feats_np[rows] + IX_NOISE * rng.standard_normal((IX_QUERIES, d))).astype(np.float32)
    ids, lat = np.full((IX_QUERIES, IX_K), -1, np.int64), []
    for i, q in enumerate(queries):
        t0 = time.perf_counter()
        res = db.search(q, k=IX_K)
        lat.append((time.perf_counter() - t0) * 1e3)
        ids[i, :len(res)] = [r.id for r in res]
    flat = FlatIndex(dim=d, metric="cosine", device=DEV)
    flat.add_batch(feats_np)
    exact, _ = flat.search_batch(queries, k=IX_K)
    recall = _recall(ids, exact, IX_K)
    say("index", rows=n, d=d, m=32, ef_construction=200, ef_search=100, build_s=build_ms / 1e3,
        inserts_per_s=n / (build_ms / 1e3), queries=IX_QUERIES, k=IX_K,
        p50_ms=float(np.percentile(lat, 50)), p99_ms=float(np.percentile(lat, 99)),
        qps=IX_QUERIES / (sum(lat) * 1e-3), recall_at_10=recall, recall_min=0.95)
    if recall < 0.95:
        raise AssertionError(f"VectorDB recall@10 {recall} under 0.95")

    # filters: a cluster (candidate route) and a bucket range (over-fetch)
    c0 = int(labels[rows[0]])
    members = np.nonzero(labels == c0)[0]
    cl_filter = {"must": [{"key": "cluster", "match": {"value": c0}}]}
    bk_filter = {"must": [{"key": "bucket", "range": {"gte": 2, "lt": 6}}]}
    bound = max(4 * IX_K, n // 4)
    routes = {name: "candidates" if len(candidate_ids(db._payload_index,
                                                      parse_qdrant_filter(f))) <= bound
              else "over-fetch" for name, f in (("cluster", cl_filter), ("bucket", bk_filter))}
    if routes != {"cluster": "candidates", "bucket": "over-fetch"}:
        raise AssertionError(f"filters took the routes {routes}")
    unit = torch.nn.functional.normalize(torch.from_numpy(feats_np[members]).to(DEV), dim=1)
    filt_ms = []
    for q in queries[:IX_FILTER_QUERIES]:
        t0 = time.perf_counter()
        res = db.search(q, k=IX_K, filter=cl_filter)
        filt_ms.append((time.perf_counter() - t0) * 1e3)
        sims = unit @ torch.nn.functional.normalize(torch.from_numpy(q).to(DEV), dim=0)
        top = torch.topk(sims, min(IX_K, len(members)))
        same_topk(f"cluster filter vs exact scoring of cluster {c0}",
                  [members[top.indices.cpu().numpy()]], [top.values.cpu().numpy()],
                  [[r.id for r in res]], [[r.score for r in res]], 1e-5)
        res = db.search(q, k=IX_K, filter=bk_filter)
        if len(res) != IX_K or not all(2 <= r.payload["bucket"] < 6 for r in res):
            raise AssertionError("bucket filter: a result outside its filter")
    say("index_filters", cluster=c0, cluster_rows=len(members), routes=json.dumps(routes),
        cluster_filter_ms=statistics.median(filt_ms), queries=IX_FILTER_QUERIES)

    # index -> GNN: the level-0 graph on the card through the K3 stack
    g, fm = db.neighbor_graph(), db.features_matrix()
    m_idx = g.max_degree
    cfg, stack = _k3_stack(d, heads)
    out, counts = counted(["fused_neighbor_mix"], lambda: _apply_stack(stack, cfg, fm, g))
    agree("index graph: K3 stack vs slot route", out,
          _apply_stack(stack, dataclasses.replace(cfg, use_pallas=False), fm, g), torch.float32)
    k3, k3_ref, (k3_bound, k3_by), k3_as_passed = _k3_at(stack[0], fm, g, heads)
    err = agree(f"K3 at the index's M={m_idx}", k3(), k3_ref(), torch.float32)
    edges = int((g.nbr_mask > 0).sum())
    layer_ms = time_ms(lambda: ruvector_layer_apply(stack[0], cfg, fm, g), iters=10)
    k3_info = {"index_M": m_idx, "index_body": k3_body(heads, m_idx, d),
               "index_ms": time_ms(k3, iters=10), "index_kernel_ms": kernel_ms(k3),
               "index_plain_ms": time_ms(k3_ref, iters=10), "index_bound_ms": k3_bound,
               "index_bound_by": k3_by, "index_bound_ms_as_passed": k3_as_passed,
               "index_max_abs_err": err}
    del k3, k3_ref
    say("index_gnn", nodes=n, M=m_idx, edges=edges, body=k3_info["index_body"],
        layer_ms=layer_ms, edges_per_s=edges / (layer_ms * 1e-3),
        k3_ms=k3_info["index_ms"], k3_kernel_ms=k3_info["index_kernel_ms"],
        k3_plain_ms=k3_info["index_plain_ms"], k3_bound_ms=k3_bound, k3_bound_by=k3_by,
        k3_bound_ms_as_passed=k3_as_passed, k3_launches=counts["fused_neighbor_mix"])

    levels = [torch.from_numpy(lv.astype(np.int64)).to(DEV) for lv in db.index.level_nodes()
              if len(lv)]
    h_cfgs = [RuvectorLayerConfig(d, d, heads=heads) for _ in levels]
    h_params = [ruvector_layer_init(i, c, device=DEV) for i, c in enumerate(h_cfgs)]
    embs = [fm[lv] for lv in levels]
    h_ms = []
    for q in queries[:IX_HIER_QUERIES]:
        qt = torch.from_numpy(q).to(DEV)
        h, ms = _synced_ms(lambda: hierarchical_forward(qt, embs, h_params, h_cfgs))
        h_ms.append(ms)
        agree_cpu("hierarchical forward over the HNSW levels", h, hierarchical_forward(
            qt.cpu(), [e.cpu() for e in embs], _tree_cpu(h_params), h_cfgs))
    say("index_hierarchical", levels=[len(lv) for lv in levels], queries=IX_HIER_QUERIES,
        ms=statistics.median(h_ms))

    # BASELINE.md row 1: 10k x 384, m 32, efc 200, ef 100
    brng = np.random.default_rng(0)
    centers = brng.normal(size=(IX_BASE_CENTERS, IX_BASE_D)).astype(np.float32) * 3.0
    base = (centers[brng.integers(0, IX_BASE_CENTERS, IX_BASE_N)]
            + brng.normal(size=(IX_BASE_N, IX_BASE_D))).astype(np.float32)
    bq = (centers[brng.integers(0, IX_BASE_CENTERS, IX_BASE_Q)]
          + brng.normal(size=(IX_BASE_Q, IX_BASE_D))).astype(np.float32)
    hcfg = HnswConfig(dim=IX_BASE_D, m=32, ef_construction=200, ef_search=100)
    hidx = HnswIndex(hcfg, device=DEV)
    _, base_build_ms = _synced_ms(lambda: hidx.add_batch(base))
    (b_ids, b_d), search_ms = _synced_ms(lambda: hidx.search_batch(bq, k=100, ef=100))
    bflat = FlatIndex(dim=IX_BASE_D, metric="cosine", device=DEV)
    bflat.add_batch(base)
    truth, _ = bflat.search_batch(bq, k=100)
    with tempfile.TemporaryDirectory() as tmp:
        hidx.save(tmp, base)
        loaded, _ = HnswIndex.load(tmp, device=DEV)
        l_ids, l_d = loaded.search_batch(bq, k=100, ef=100)
    if not (np.array_equal(l_ids, b_ids) and np.array_equal(l_d, b_d)):
        raise AssertionError("HNSW save/load: the reloaded index answers otherwise")
    say("index_baseline_row1", rows=IX_BASE_N, d=IX_BASE_D, queries=IX_BASE_Q,
        build_s=base_build_ms / 1e3, recall_at_1=_recall(b_ids, truth, 1),
        recall_at_10=_recall(b_ids, truth, 10), recall_at_100=_recall(b_ids, truth, 100),
        single_thread_qps=IX_BASE_Q / (search_ms / 1e3), save_load_ids_equal=True)

    # the hyperbolic index: the features scaled into the ball
    pts = feats_np * (IX_HYPER_RADIUS / float(np.linalg.norm(feats_np, axis=1).max()))
    hq = pts[rows[:IX_HYPER_QUERIES]] + 0.01 * IX_HYPER_RADIUS * rng.standard_normal(
        (IX_HYPER_QUERIES, d)).astype(np.float32)
    # the CPU's rerun (host parity the CPU tests also hold) only when the
    # phase runs alone
    runs = []
    for dev, qs in ((DEV, hq), (torch.device("cpu"), hq[:IX_HYPER_CPU]))[:1 + cpu_rerun]:
        hyp = HyperbolicIndex(HyperbolicConfig(dim=d), device=dev)
        hyp.insert_batch(pts)
        runs.append(_synced_ms(lambda: ([hyp.search(q, k=IX_K) for q in qs],
                                     [hyp.search_exact(q, k=IX_K) for q in qs])))
    (pruned, exact_h), hyp_ms = runs[0]
    for (pruned_c, exact_c), _ in runs[1:]:
        for name, a, b in (("pruned", pruned_c, pruned[:IX_HYPER_CPU]),
                           ("exact", exact_c, exact_h[:IX_HYPER_CPU])):
            same_topk(f"hyperbolic {name} search: CPU vs card", [[i for i, _ in r] for r in a],
                      [[x for _, x in r] for r in a], [[i for i, _ in r] for r in b],
                      [[x for _, x in r] for r in b], 1e-4)
    say("index_hyperbolic", rows=n, queries=IX_HYPER_QUERIES, k=IX_K,
        recall_vs_exact=_recall(np.asarray([[i for i, _ in r] for r in pruned]),
                                np.asarray([[i for i, _ in r] for r in exact_h]), IX_K),
        ms_per_query_pair=hyp_ms / IX_HYPER_QUERIES,
        cpu_queries_equal=sum(len(r[0][0]) for r in runs[1:]))
    say("index_done", seconds=round(time.perf_counter() - t_phase, 1),
        kernel_launches=counts["fused_neighbor_mix"])
    return {"launches": counts["fused_neighbor_mix"], "k3": k3_info, "db": db}


_GS_QUERIES = {
    "one_hop_count": "MATCH (a:Point {{idx: {i}}})-[:KNN]->(b) RETURN count(*) AS n",
    "in_count": "MATCH (a:Point {{idx: {i}}})<-[:KNN]-(b) RETURN count(*) AS n",
    "two_hop_same_cluster": "MATCH (a:Point {{idx: {i}}})-[:KNN]->(b)-[:KNN]->(c) "
                            "WHERE c.cluster = a.cluster RETURN count(*) AS n",
    "order_by_limit": "MATCH (a:Point {{idx: {i}}})-[:KNN]->(b) RETURN b.idx AS id, "
                      "b.cluster AS c ORDER BY id DESC LIMIT 5",
    "cluster_count": "MATCH (a:Point {{cluster: {c}}}) RETURN count(*) AS n",
}


def _numpy_answers(i: int, nbr, mask, labels) -> dict:
    """The same questions answered from the graph's arrays."""
    real = mask > 0
    out_i = nbr[i][real[i]]
    return {
        "one_hop_count": [{"n": int(real[i].sum())}],
        "in_count": [{"n": int(((nbr == i) & real).sum())}],
        "two_hop_same_cluster": [{"n": int(sum((labels[nbr[b][real[b]]] == labels[i]).sum()
                                               for b in out_i))}],
        "order_by_limit": [{"id": int(j), "c": int(labels[j])} for j in np.sort(out_i)[::-1][:5]],
        "cluster_count": [{"n": int((labels == labels[i]).sum())}],
    }


def phase_graph_store(feats_np: np.ndarray, feats: torch.Tensor, labels: np.ndarray,
                      graph: NeighborGraph, d: int, heads: int) -> int:
    """The property graph (`[graph_store]`): the 100k-node kNN graph as a
    PropertyGraph (zero-padded ids in index order; label Point, properties
    idx, cluster and the embedding row; each kNN edge KNN with its
    weight); Cypher queries against the same questions answered from the
    arrays; Cypher writes, then a transaction rolled back; its CSR on the
    card through the CSR SpMM against the padded SpMM of the kNN graph;
    its padded lowering and feature matrix through `[serve]`'s K3 stack,
    equal to the stack on the kNN graph. Returns K3's launches."""
    t_phase = time.perf_counter()
    n = feats_np.shape[0]
    nbr, mask = graph.nbr_idx.cpu().numpy(), graph.nbr_mask.cpu().numpy()
    w = graph.edge_weight.cpu().numpy()
    names = [f"{i:06d}" for i in range(n)]

    def build():
        g = PropertyGraph()
        for i in range(n):
            g.add_node(names[i], ("Point",), idx=i, cluster=int(labels[i]), embedding=feats_np[i])
        for i in range(n):
            for j in np.nonzero(mask[i] > 0)[0]:
                g.add_edge(names[i], names[nbr[i, j]], "KNN", weight=float(w[i, j]))
        return g

    g, build_ms = _synced_ms(build)
    if g.node_ids() != names or g.edge_count != int((mask > 0).sum()):
        raise AssertionError("property graph: ids out of index order or edges missing")
    q_ms = {}
    for i in (0, n // 8 + 5, n - 1):
        want = _numpy_answers(i, nbr, mask, labels)
        for name, text in _GS_QUERIES.items():
            rows, ms = _synced_ms(lambda: execute_cypher(g, text.format(i=i, c=int(labels[i]))))
            q_ms.setdefault(name, []).append(ms)
            if rows != want[name]:
                raise AssertionError(f"cypher {name} at node {i}: {rows} != {want[name]}")
    say("graph_store", nodes=n, edges=g.edge_count, build_s=build_ms / 1e3, answers_equal=True,
        query_ms=json.dumps({k: round(statistics.median(v), 3) for k, v in q_ms.items()},
                            separators=(",", ":")))

    # writes: Cypher CREATE / SET / DELETE, then a transaction rolled back
    n0, e0 = g.node_count, g.edge_count
    execute_cypher(g, "CREATE (x:Point {idx: -1, cluster: -1})")
    execute_cypher(g, "MATCH (x:Point {idx: -1}), (b:Point {idx: 0}) "
                      "CREATE (x)-[:KNN {since: 2024}]->(b)")
    execute_cypher(g, "MATCH (x:Point {idx: -1}) SET x.cluster = 7")
    rows = execute_cypher(g, "MATCH (x:Point {idx: -1})-[r:KNN]->(b) "
                             "RETURN x.cluster AS c, b.idx AS b, r.since AS s")
    if rows != [{"c": 7, "b": 0, "s": 2024}]:
        raise AssertionError(f"cypher writes read back {rows}")
    _, delete_ms = _synced_ms(lambda: execute_cypher(g, "MATCH (x:Point {idx: -1}) DELETE x"))
    tx = g.begin()
    tx.add_node("new", ("Point",), idx=-2, cluster=-2)
    tx.add_edge("new", names[0], "KNN", weight=0.25)
    tx.set_property(names[1], "cluster", -5)
    tx.delete_node(names[2])
    seen = tx.read_node("new") is not None and tx.read_node(names[2]) is None
    tx.rollback()
    restored = (g.node_count, g.edge_count) == (n0, e0) and \
        g.get_node(names[1]).properties["cluster"] == int(labels[1]) and \
        execute_cypher(g, _GS_QUERIES["one_hop_count"].format(i=2)) == \
        _numpy_answers(2, nbr, mask, labels)["one_hop_count"]
    if not (seen and restored):
        raise AssertionError("transaction: read-your-writes or the rollback failed")
    say("graph_store_writes", cypher_create_set_delete=True, delete_ms=delete_ms,
        transaction_rolled_back=True)

    # lowerings on the card: CSR through the CSR SpMM, padded through K3
    (csr, ids), csr_ms = _synced_ms(lambda: g.to_csr(device=DEV))
    agree("property graph CSR SpMM vs the kNN graph's padded SpMM", spmm_csr(csr, feats),
          spmm_padded(feats, graph.nbr_idx, graph.edge_weight, graph.nbr_mask), torch.float32)
    ((ng, _), fm), lower_ms = _synced_ms(lambda: (g.to_neighbor_graph(max_degree=graph.max_degree,
                                                                  device=DEV),
                                              torch.from_numpy(g.feature_matrix()).to(DEV)))
    for a, b in ((ng.nbr_idx, graph.nbr_idx), (ng.nbr_mask, graph.nbr_mask),
                 (ng.edge_weight, graph.edge_weight), (fm, feats)):
        if not torch.equal(a, b):
            raise AssertionError("property graph lowering differs from the kNN graph")
    cfg, stack = _k3_stack(d, heads)
    out, counts = counted(["fused_neighbor_mix"], lambda: _apply_stack(stack, cfg, fm, ng))
    equal_cpu("K3 stack on the property graph's lowering vs on the kNN graph", out,
              _apply_stack(stack, cfg, feats, graph))
    say("graph_store_lowering", csr_ms=csr_ms, padded_ms=lower_ms, ids_in_order=ids == names,
        k3_launches=counts["fused_neighbor_mix"])
    say("graph_store_done", seconds=round(time.perf_counter() - t_phase, 1),
        kernel_launches=counts["fused_neighbor_mix"])
    return counts["fused_neighbor_mix"]


def _clustered_global(mc, rng, n_cl: int, cluster: int) -> dict:
    """benchmarks/global_mincut_scale_r04.py's clustered growth: a path and
    chords in each cluster, one light bridge between consecutive clusters
    and one closing the ring."""
    live = {}

    def ins(u, v, w):
        mc.insert_edge(u, v, w)
        live[(min(u, v), max(u, v))] = w

    for c in range(n_cl):
        base = c * cluster
        for i in range(1, cluster):
            ins(base + i - 1, base + i, float(rng.uniform(0.8, 1.2)))
        for _ in range(int(cluster * 0.3)):
            a, b = rng.integers(0, cluster, 2)
            if a != b:
                ins(base + int(a), base + int(b), float(rng.uniform(0.5, 1.0)))
    for c in range(1, n_cl):
        ins((c - 1) * cluster + int(rng.integers(cluster)), c * cluster + int(rng.integers(cluster)),
            float(rng.uniform(0.05, 0.3)))
    ins(int(rng.integers(cluster)), (n_cl - 1) * cluster + int(rng.integers(cluster)),
        float(rng.uniform(0.05, 0.3)))
    return live


def _reweight_stream(mcs, live: dict, rng, steps: int) -> list:
    """The drift stream: a random live edge reweighted by U(0.9, 1.1), a
    query after each; every maintainer in mcs gets the same updates.
    Returns each step's cut values."""
    keys = list(live)
    values = []
    for _ in range(steps):
        key = keys[int(rng.integers(len(keys)))]
        w = live[key] * float(rng.uniform(0.9, 1.1))
        live[key] = w
        for mc in mcs:
            mc.reweight_edge(key[0], key[1], w)
        values.append([mc.cut_value() for mc in mcs])
    return values


def _two_communities(n: int, rng) -> np.ndarray:
    """benchmarks/mincut_scale.py's s-t graph: two communities of n/2
    (intra-degree ~8) joined by 6 light bridges."""
    half, edges = n // 2, []
    for lo, hi in ((0, half), (half, n)):
        src = rng.integers(lo, hi, size=(hi - lo) * 4)
        dst = rng.integers(lo, hi, size=src.size)
        keep = src != dst
        wt = rng.uniform(0.5, 1.5, size=src.size).astype(np.float32)
        edges.append(np.stack([src[keep], dst[keep], wt[keep].astype(np.float64)], 1))
    edges.append(np.stack([rng.integers(0, half, 6), rng.integers(half, n, 6),
                           rng.uniform(0.01, 0.05, 6)], 1))
    return np.concatenate(edges)


def _st_updates(n: int, rng, steps: int) -> list:
    """benchmarks/mincut_scale.py's mixed stream, drawn as it draws it:
    80% inserts inside a community, 10% bridge reweights, 10% deletes
    inside a community; None where an insert drew a self-loop (the query
    still follows)."""
    half, ops = n // 2, []
    for _ in range(steps):
        op = rng.random()
        if op < 0.8:
            lo = 0 if rng.random() < 0.5 else half
            u, v = int(rng.integers(lo, lo + half)), int(rng.integers(lo, lo + half))
            ops.append(("insert_edge", u, v, float(rng.uniform(0.5, 1.5))) if u != v else None)
        elif op < 0.9:
            ops.append(("reweight_edge", int(rng.integers(0, half)), int(rng.integers(half, n)),
                        float(rng.uniform(0.01, 0.05))))
        else:
            lo = 0 if rng.random() < 0.5 else half
            ops.append(("delete_edge", int(rng.integers(lo, lo + half)),
                        int(rng.integers(lo, lo + half))))
    return ops


def _apply_updates(mc, ops: list) -> list:
    """Each update, then a query; the cut values."""
    values = []
    for op in ops:
        if op is not None:
            getattr(mc, op[0])(*op[1:])
        values.append(mc.cut_value())
    return values


def _cluster_neighbourhood(graph: NeighborGraph, labels: np.ndarray, c: int):
    """One cluster's members and their kNN neighbours, as a symmetrised
    edge list over local ids: (src, dst, w, n)."""
    nbr, mask = graph.nbr_idx.cpu().numpy(), graph.nbr_mask.cpu().numpy() > 0
    w = graph.edge_weight.cpu().numpy()
    members = np.nonzero(labels == c)[0]
    nodes = np.unique(np.concatenate([members, nbr[members][mask[members]]]))
    local = {int(v): i for i, v in enumerate(nodes)}
    pairs = {}
    for u in nodes:
        for j in np.nonzero(mask[u])[0]:
            v = int(nbr[u, j])
            if v in local and v != u:
                key = (min(local[int(u)], local[v]), max(local[int(u)], local[v]))
                pairs[key] = max(pairs.get(key, 0.0), float(w[u, j]))
    src = np.asarray([a for a, _ in pairs], np.int64)
    dst = np.asarray([b for _, b in pairs], np.int64)
    return src, dst, np.asarray(list(pairs.values()), np.float32), len(nodes)


def phase_mincut(graph: NeighborGraph, labels: np.ndarray) -> None:
    """The min-cut toolkit (`[mincut]`). Host workloads: the maintainers
    are host C++ (native) or numpy (Python); the card runs only the CSR
    parts (PPR push) and the CG solves. The global maintainer at
    GLOBAL_MINCUT_SCALE_r05.json's 500k cell (growth, then
    MC_GLOBAL_UPDATES drift updates, a query after each); the s-t
    maintainer at MINCUT_SCALE_r02.json's 100k row (its 2,000 mixed
    updates, a query after each, on native.IncrementalMinCut as the
    benchmark drives it; the DynamicMinCut facade on the first
    MC_ST_FACADE, equal); the Python maintainer against the native one on
    the 20k cell's first MC_PY_UPDATES updates (1e-4 at every query); then
    on the bench graph's symmetrised CSR on the card, its clusters joined
    in a ring by light bridges: local_cluster and local_k_cut from one
    node (a cut of positive conductance), and on one cluster's
    neighbourhood expander_decompose, JTree and spectral_sparsify, each
    against the same call on the CPU."""
    t_phase = time.perf_counter()
    before = kernels.launch_counts()

    # global, native: the 500k cell
    rng = np.random.default_rng(MC_GLOBAL_SEED)
    mc = DynamicMinCut(MC_GLOBAL_CL * MC_GLOBAL_SIZE, source=None)
    live, grow_ms = _synced_ms(lambda: _clustered_global(mc, rng, MC_GLOBAL_CL, MC_GLOBAL_SIZE))
    cut0, first_ms = _synced_ms(mc.cut_value)
    vals, stream_ms = _synced_ms(lambda: _reweight_stream([mc], live, rng, MC_GLOBAL_UPDATES))
    say("mincut_global", nodes=MC_GLOBAL_CL * MC_GLOBAL_SIZE, edges=len(live), grow_s=grow_ms / 1e3,
        first_query_ms=first_ms, cut_after_growth=cut0, updates=MC_GLOBAL_UPDATES,
        updates_per_s=MC_GLOBAL_UPDATES / (stream_ms / 1e3), final_cut=vals[-1][0],
        solver=type(mc._g).__name__, stats=json.dumps(mc.solver_stats(), separators=(",", ":")))
    del mc, live

    # s-t, native: the 100k row, driven as benchmarks/mincut_scale.py
    # drives it (native.IncrementalMinCut, a query after each update)
    n = MC_ST_NODES
    edges = _two_communities(n, np.random.default_rng(0))
    ops = _st_updates(n, np.random.default_rng(1), MC_ST_UPDATES)

    def load(mc):
        for u, v, w in edges:
            mc.insert_edge(int(u), int(v), float(w))
        return mc.cut_value()

    st = native.IncrementalMinCut(n, 0, n - 1)
    cut0, load_ms = _synced_ms(lambda: load(st))
    values, st_ms = _synced_ms(lambda: _apply_updates(st, ops))
    # the DynamicMinCut facade on the first MC_ST_FACADE updates: the same
    # values, and a query that also lists the cut's edges
    facade = DynamicMinCut(n, 0, n - 1)
    load(facade)
    f_values, facade_ms = _synced_ms(lambda: _apply_updates(facade, ops[:MC_ST_FACADE]))
    if f_values != values[:MC_ST_FACADE]:
        raise AssertionError("s-t min cut: the DynamicMinCut facade and the native class differ")
    say("mincut_st", nodes=n, edges=len(edges), load_and_first_query_s=load_ms / 1e3,
        first_cut=cut0, updates=MC_ST_UPDATES, us_per_update_query=st_ms / MC_ST_UPDATES * 1e3,
        updates_per_s=MC_ST_UPDATES / (st_ms / 1e3), final_cut=values[-1],
        stats=json.dumps(st.stats(), separators=(",", ":")), facade_updates=MC_ST_FACADE,
        facade_us_per_update_query=facade_ms / MC_ST_FACADE * 1e3, facade_values_equal=True)
    st.close()
    del st, facade, edges

    # the Python maintainer against the native one: the 20k cell
    mcs = [DynamicMinCut(MC_PY_CL * MC_PY_SIZE, source=None, backend=b)
           for b in ("native", "python")]
    rng = np.random.default_rng(0)
    both = types.SimpleNamespace(insert_edge=lambda u, v, w: [mc.insert_edge(u, v, w)
                                                              for mc in mcs])
    live = _clustered_global(both, rng, MC_PY_CL, MC_PY_SIZE)
    first, py_ms = _synced_ms(lambda: [mc.cut_value() for mc in mcs])
    vals, py_stream_ms = _synced_ms(lambda: _reweight_stream(mcs, live, rng, MC_PY_UPDATES))
    worst = max(abs(a - b) / max(abs(a), 1e-12) for a, b in [first] + vals)
    if worst > 1e-4 or type(mcs[1]._g).__name__ != "GlobalDynamicMinCut":
        raise AssertionError(f"global min cut: Python vs native differ by {worst} relative")
    say("mincut_python_route", nodes=MC_PY_CL * MC_PY_SIZE, edges=len(live),
        updates=MC_PY_UPDATES, queries_equal=len(vals) + 1, max_rel_diff=worst,
        first_query_ms_both=py_ms, stream_ms_both=py_stream_ms)
    del mcs

    # the bench graph's CSR on the card, each cluster's first node joined
    # to the next cluster's by a light bridge (the kNN clusters are
    # components of their own): local cuts from one node
    nbr, mask = graph.nbr_idx.cpu().numpy(), graph.nbr_mask.cpu().numpy() > 0
    w = graph.edge_weight.cpu().numpy()
    rows = np.repeat(np.arange(graph.num_nodes), mask.sum(1))
    firsts = np.unique(labels, return_index=True)[1]
    src, dst = np.r_[rows, firsts], np.r_[nbr[mask], np.roll(firsts, -1)]
    wt = np.r_[w[mask], np.full(len(firsts), w[mask].min(), np.float32)]
    sym = (np.r_[src, dst], np.r_[dst, src], np.r_[wt, wt], graph.num_nodes)
    g_card, g_cpu = (CSRGraph.from_edges(*sym, device=dev) for dev in (DEV, "cpu"))
    ms = {}
    (members, phi), ms["local_cluster"] = _synced_ms(lambda: local_cluster(g_card, MC_LOCAL_SEED))
    members_c, phi_c = local_cluster(g_cpu, MC_LOCAL_SEED)
    if not phi_c > 0:
        raise AssertionError("local_cluster: a cut of no edges, so the sweep's cut is untested")
    if set(members.tolist()) != set(members_c.tolist()) or abs(phi - phi_c) > 1e-4 * phi_c:
        raise AssertionError("local_cluster: card vs CPU")
    cut, ms["local_k_cut"] = _synced_ms(lambda: local_k_cut(g_card, MC_LOCAL_SEED, k=1e9))
    cut_c = local_k_cut(g_cpu, MC_LOCAL_SEED, k=1e9)
    if cut.cut_edges != cut_c.cut_edges or abs(cut.value - cut_c.value) > 1e-4 * cut_c.value:
        raise AssertionError("local_k_cut: card vs CPU")

    # one cluster's neighbourhood: expander, j-tree, sparsifier
    c0 = int(labels[MC_LOCAL_SEED])
    s_src, s_dst, s_w, s_n = _cluster_neighbourhood(graph, labels, c0)
    sub = (np.r_[s_src, s_dst], np.r_[s_dst, s_src], np.r_[s_w, s_w], s_n)
    sub_card, sub_cpu = (CSRGraph.from_edges(*sub, device=dev) for dev in (DEV, "cpu"))
    (labels_x, clusters, boundary), ms["expander_decompose"] = _synced_ms(
        lambda: expander_decompose(sub_card))
    labels_xc, _, boundary_c = expander_decompose(sub_cpu)
    if not np.array_equal(labels_x, labels_xc) or boundary != boundary_c:
        raise AssertionError("expander_decompose: card vs CPU")
    jt, ms["jtree"] = _synced_ms(lambda: JTree(sub_card))
    jt_c = JTree(sub_cpu)
    ub = [jt.query_cut_upper_bound(0, t) for t in range(1, min(s_n, 64))]
    ub_c = [jt_c.query_cut_upper_bound(0, t) for t in range(1, min(s_n, 64))]
    if not np.allclose(ub, ub_c, rtol=1e-4, atol=0.0, equal_nan=True):
        raise AssertionError("JTree: card vs CPU upper bounds")
    r, ms["effective_resistances"] = _synced_ms(
        lambda: effective_resistances(s_src, s_dst, s_w, s_n, device=DEV))
    r_c = effective_resistances(s_src, s_dst, s_w, s_n, device="cpu")
    r_err = float(np.max(np.abs(r - r_c) / np.abs(r_c)))
    if r_err > 1e-4:
        raise AssertionError(f"effective resistances: card vs CPU {r_err} relative")
    (k_src, k_dst, k_w), ms["spectral_sparsify"] = _synced_ms(
        lambda: spectral_sparsify(s_src, s_dst, s_w, s_n, eps=MC_SPARSIFY_EPS, device=DEV))
    crng = np.random.default_rng(1)
    worst_cut = 0.0
    for _ in range(16):
        side = crng.random(s_n) < 0.5
        c1 = cut_value(s_src, s_dst, s_w, side)
        worst_cut = max(worst_cut, abs(cut_value(k_src, k_dst, k_w, side) - c1) / max(c1, 1e-9))
    if worst_cut >= MC_SPARSIFY_EPS:
        raise AssertionError(f"spectral_sparsify moved a cut by {worst_cut}")
    after = kernels.launch_counts()
    say("mincut_toolkit", graph_nodes=graph.num_nodes, csr_entries=int(g_card.num_edges),
        bridges=len(firsts), cluster=c0, cluster_nodes=s_n, cluster_edges=len(s_src),
        local_members=len(members),
        conductance=phi, local_k_cut_value=cut.value, local_k_cut_explored=cut.explored,
        expander_clusters=len(clusters), expander_boundary=boundary, jtree_levels=len(jt.levels),
        resistance_max_rel_err=r_err, sparsified_edges=len(k_src), worst_cut_rel=worst_cut,
        ms=json.dumps({k: round(v, 1) for k, v in ms.items()}, separators=(",", ":")))
    say("mincut_done", seconds=round(time.perf_counter() - t_phase, 1),
        kernel_launches=sum(after[k] - before[k] for k in after),
        note="host workloads: the card runs the CSR push and the CG solves only")


def phase_csr_spmm(d: int) -> dict:
    """The port's counterpart of benchmarks/csr_spmm_bench.py:58-159. The
    regular graph (cluster_graph, CSR_NODES, k=16): spmm_padded, K9 on the
    whole graph and spmm_csr, each held to spmm_csr within 1e-3 and K9 to
    its plain version at f32 1e-4 / 1e-5; K9 against its plain version on
    the 12,288-row slice and on uniform random indices (M=17, B = N - 1),
    and two controls (a plain version without one edge, and K9 with edge
    M-1 of every row left out, a fault planted in the kernel). The
    power-law graph (zipf(1.7) x 4 degrees capped at 512, uniform
    destinations, weights U(0.1, 1), seed 0): spmm_bucketed and the
    max-degree spmm_padded against spmm_csr within 1e-3."""
    f32 = torch.float32
    feats, idx, ew = cluster_graph(CSR_NODES, d, CSR_K)
    n = feats.shape[0]
    mask = torch.ones_like(ew)
    w = (ew * mask).contiguous()
    csr = NeighborGraph(idx, mask, ew).to_csr()
    edges = csr.num_edges
    want = spmm_csr(csr, feats)
    got, counts = counted(["spmm_gather"], lambda: spmm_gather(feats, idx, w))
    agree("K9 whole graph vs spmm_csr", got, want, f32, tol=(1e-3, 1e-4))
    agree("K9 whole graph vs its plain version", got, spmm_gather_reference(feats, idx, w), f32)
    agree("spmm_padded vs spmm_csr", spmm_padded(feats, idx, ew, mask), want, f32,
          tol=(1e-3, 1e-4))
    ms = {"spmm_padded": time_ms(lambda: spmm_padded(feats, idx, ew, mask), iters=10),
          "k9_spmm_gather": time_ms(lambda: spmm_gather(feats, idx, w), iters=10),
          "spmm_csr": time_ms(lambda: spmm_csr(csr, feats), iters=10)}
    # K9 on the gather kernel's slice of the JAX bench, and without locality
    npk = min(K9_SLICE, n)
    fk, ik, wk = feats[:npk].contiguous(), (idx[:npk] % npk).contiguous(), w[:npk].contiguous()
    agree(f"K9 on the {npk}-row slice", spmm_gather(fk, ik, wk),
          spmm_gather_reference(fk, ik, wk), f32)
    gen = torch.Generator(device=DEV).manual_seed(4)
    ridx = torch.randint(0, n, (n - 1, 17), generator=gen, device=DEV, dtype=torch.int32)
    rw = torch.rand(n - 1, 17, generator=gen, device=DEV)
    agree("K9 uniform random indices M=17 B=N-1", spmm_gather(feats, ridx, rw),
          spmm_gather_reference(feats, ridx, rw), f32)
    w_drop = w.clone()
    w_drop[0, 0] = 0.0
    expect_rejected("K9 against a plain version without one edge", lambda: agree(
        "control: K9 vs plain version without edge (0, 0)", got,
        spmm_gather_reference(feats, idx, w_drop), f32))
    # control: a fault planted in K9, edge M-1 of every row left out
    expect_rejected("K9 without edge M-1", lambda: agree(
        "control: K9 without edge M-1 of each row",
        spmm_gather(feats, idx, w, variant="drop_last_edge"),
        spmm_gather_reference(feats, idx, w), f32))
    say("csr_spmm_regular", nodes=n, k=CSR_K, d=d, edges=edges,
        ms=json.dumps(ms, separators=(",", ":")),
        edges_per_s=json.dumps({k: _edges_per_s(edges, v) for k, v in ms.items()},
                               separators=(",", ":")),
        k9_launches=counts["spmm_gather"])
    del ridx, rw, want, got

    rng = np.random.default_rng(0)
    deg = np.minimum(rng.zipf(1.7, PL_NODES) * 4, 512).astype(np.int64)
    src = np.repeat(np.arange(PL_NODES, dtype=np.int64), deg)
    dst = rng.integers(0, PL_NODES, src.size).astype(np.int64)
    w_e = rng.uniform(0.1, 1.0, src.size).astype(np.float32)
    csr_pl = CSRGraph.from_edges(src, dst, w_e, PL_NODES, device=DEV)
    feats_pl = torch.from_numpy(rng.standard_normal((PL_NODES, d)).astype(np.float32)).to(DEV)
    e_pl = int(src.size)
    ref = spmm_csr(csr_pl, feats_pl)
    t0 = time.perf_counter()
    plan = build_bucket_plan(csr_pl)
    plan_s = time.perf_counter() - t0
    agree("spmm_bucketed vs spmm_csr (power law)", spmm_bucketed(plan, feats_pl), ref, f32,
          tol=(1e-3, 1e-4))
    padded = csr_pl.to_padded()
    agree("max-degree spmm_padded vs spmm_csr (power law)", spmm_padded(
        feats_pl, padded.nbr_idx, padded.edge_weight, padded.nbr_mask), ref, f32,
        tol=(1e-3, 1e-4))
    ms_pl = {"spmm_padded_maxdeg": time_ms(lambda: spmm_padded(
                 feats_pl, padded.nbr_idx, padded.edge_weight, padded.nbr_mask), iters=3),
             "spmm_bucketed": time_ms(lambda: spmm_bucketed(plan, feats_pl), iters=10),
             "spmm_csr": time_ms(lambda: spmm_csr(csr_pl, feats_pl), iters=10)}
    cells = sum(r.shape[0] * c for r, c in zip(plan.rows, plan.caps))
    say("csr_spmm_power_law", nodes=PL_NODES, edges=e_pl, max_degree=int(deg.max()),
        mean_degree=float(deg.mean()), bucket_caps=list(plan.caps),
        bucket_padding_waste=cells / e_pl, maxdeg_padding_waste=PL_NODES * int(deg.max()) / e_pl,
        plan_s=round(plan_s, 3), ms=json.dumps(ms_pl, separators=(",", ":")),
        edges_per_s=json.dumps({k: _edges_per_s(e_pl, v) for k, v in ms_pl.items()},
                               separators=(",", ":")))
    return dict(feats=feats, idx=idx, w=w, edges=edges, launches=counts["spmm_gather"])


def serve_report(rr: dict, sp: dict) -> list:
    """Report rows of K8 at the re-rank's shape (the last batch's queries
    and pool; the pool passed as k and as v) and K9 at the regular graph's,
    each with the one PyTorch call that computes the same function. Both
    plain versions are timed over as many calls as the kernels."""
    q, pool = rr["q"], rr["pool"]
    b, m, d = pool.shape
    f32 = torch.float32
    # k is v: the function needs the pool once (q + pool + out); the bound
    # of the arguments as passed, the pool twice, is reported beside it
    k8_ops = {f32: 4 * b * m * d}
    rows = [("flash_neighbor_attention",
             lambda: flash_neighbor_attention(q, pool, pool),
             lambda: flash_neighbor_attention_reference(q, pool, pool),
             _agree_as(f32), bound(nbytes(q, pool) + nbytes(q), k8_ops),
             {"shape": f"B={b}, M=ef={m}, D={d}, k = v = the pool",
              "body": k8_body(pool, pool),
              "bound_ms_as_passed": bound(nbytes(q, pool, pool) + nbytes(q), k8_ops)[0],
              "library": lambda: F.scaled_dot_product_attention(
                  q[:, None, None], pool[:, None], pool[:, None])[:, 0, 0],
              "library_call": "F.scaled_dot_product_attention(q[:, None, None], k[:, None], "
                              "v[:, None])"})]
    feats, idx, w = sp["feats"], sp["idx"], sp["w"]
    n_rows, fd = idx.numel(), feats.shape[1]
    rows.append(("spmm_gather",
                 lambda: spmm_gather(feats, idx, w),
                 lambda: spmm_gather_reference(feats, idx, w),
                 _agree_as(f32), bound(nbytes(feats, idx, w) + idx.shape[0] * fd * 4,
                                       {f32: 2 * sp["edges"] * fd}),
                 {"shape": f"N=B={feats.shape[0]}, M={idx.shape[1]}, D={fd} (regular graph)",
                  "body": "bulk_tiles",
                  "staged_tiles": staged_tiles(idx, feats.shape[0], fd),
                  "gather_bound_ms": n_rows * fd * 4 / PEAK_BYTES_PER_S * 1e3,
                  "library": lambda: F.embedding_bag(idx, feats, per_sample_weights=w,
                                                     mode="sum"),
                  "library_call": "F.embedding_bag(nbr, feat, per_sample_weights=w, "
                                  "mode='sum')"}))
    return rows


# ---------------------------------------------------------------------------
# [parallel]: the multichip dry run's sharded paths (__graft_entry__.py:44-190)
# as PAR_WORLD rank processes on the one card
# ---------------------------------------------------------------------------

def _rank_setup(mesh) -> None:
    """A rank's first step: TF32 off as in phase_device, and no build
    (the parent built every kernel and the native runtime)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    missing = [n for n in PAR_SOURCES if not _lib.library_path(n).exists()]
    if missing and mesh.device.type == "cuda":
        raise RuntimeError(f"a rank would build {missing}: the parent builds before spawning")


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _rank_ms(mesh, fn):
    """(result, milliseconds) of fn on the rank's device, synchronised on
    both sides (the collectives' host staging included)."""
    _sync(mesh.device)
    t0 = time.perf_counter()
    out = fn()
    _sync(mesh.device)
    return out, (time.perf_counter() - t0) * 1e3


def _par_net(d: int, heads: int, dev):
    cfg = RuvectorNetConfig(input_dim=d, hidden_dim=d, num_layers=2, heads=heads)
    return cfg, ruvector_net_init(0, cfg, device=dev)


def _par_sizes() -> dict:
    """Part 2's sizes, handed to the ranks with the inputs' seeds."""
    return dict(world=PAR_WORLD, tp=PAR_TP, ep=PAR_EP, tp_tokens=PAR_TP_TOKENS,
                ep_tokens=PAR_EP_TOKENS, pp_micro=PAR_PP_MICRO, pp_rows=PAR_PP_ROWS,
                pp_d=PAR_PP_D, sp_seq=PAR_SP_SEQ, sp_d=PAR_SP_D)


def _par_transformer_inputs(dev, z: dict):
    """TP, EP, PP and SP inputs at the sizes z, drawn on the host from
    fixed seeds, so that the parent and every rank hold the same tensors
    without handing them over."""
    gen = torch.Generator().manual_seed(11)
    tp_cfg, ep_cfg = TpLayerConfig(**z["tp"]), EpConfig(**z["ep"])
    d = z["pp_d"]
    pp = {"w": torch.randn(z["world"], d, d, generator=gen) / np.sqrt(d),
          "b": torch.randn(z["world"], d, generator=gen) * 0.1}
    return dict(
        tp_cfg=tp_cfg, tp=tp_layer_init(12, tp_cfg, device=dev),
        tp_x=torch.randn(z["tp_tokens"], tp_cfg.hidden, generator=gen).to(dev),
        ep_cfg=ep_cfg, ep=ep_init(13, ep_cfg, device=dev),
        ep_x=torch.randn(z["ep_tokens"], ep_cfg.hidden, generator=gen).to(dev),
        pp={k: v.to(dev) for k, v in pp.items()},
        pp_x=torch.randn(z["pp_micro"], z["pp_rows"], d, generator=gen).to(dev),
        sp=[torch.randn(z["sp_seq"], z["sp_d"], generator=gen).to(dev) for _ in range(3)])


def _pp_layer(p, x):
    return torch.tanh(x @ p["w"] + p["b"])


def _par_halo_rank(mesh, s: dict) -> dict:
    """Part 1: the halo-sharded RuvectorNet: forward (timed warm), the
    overlap forward, one Adam train step."""
    dev = mesh.device
    cfg, params = _par_net(s["d"], s["heads"], dev)
    fpad = torch.from_numpy(s["fpad"]).to(dev)
    fwd = make_sharded_layer_forward(cfg, s["plan"], mesh)
    fwd(params, fpad)
    before = mesh.staged_bytes
    y, fwd_ms = _rank_ms(mesh, lambda: fwd(params, fpad))
    fwd_staged = mesh.staged_bytes - before
    ov = make_overlap_layer_forward(cfg, s["ov_plan"], mesh)
    ov_fpad = torch.from_numpy(s["ov_fpad"]).to(dev)
    ov(params, ov_fpad)
    y_ov, ov_ms = _rank_ms(mesh, lambda: ov(params, ov_fpad))
    opt = adam(s["lr"])
    step = make_sharded_train_step(cfg, s["plan"], mesh, opt)
    neg_ids = torch.from_numpy(s["neg_ids"]).to(dev)
    first_ms = _rank_ms(mesh, lambda: step(params, opt.init(params), fpad, neg_ids))[1]
    before = mesh.staged_bytes
    # the same step again, from the same parameters: timed warm
    (p1, st1, loss), step_ms = _rank_ms(mesh, lambda: step(params, opt.init(params), fpad,
                                                           neg_ids))
    return dict(forward=y, overlap=y_ov, loss=loss, params=p1, mu=st1["mu"],
                forward_ms=fwd_ms, overlap_ms=ov_ms, step_ms=step_ms, first_step_ms=first_ms,
                forward_staged_bytes=fwd_staged, step_staged_bytes=mesh.staged_bytes - before)


def _par_transformer_rank(mesh, z: dict) -> dict:
    """Part 2: TP, EP, PP and SP at the transformer's width, each timed on
    its second call."""
    t = _par_transformer_inputs(mesh.device, z)
    calls = {"tp": lambda: make_tp_layer_forward(t["tp_cfg"], mesh)(t["tp"], t["tp_x"]),
             "ep": lambda: make_ep_forward(t["ep_cfg"], mesh)(t["ep"], t["ep_x"]),
             "pp": lambda: make_pp_forward(_pp_layer, mesh, z["pp_micro"])(t["pp"], t["pp_x"]),
             "sp": lambda: make_ring_attention(mesh, z["sp_seq"])(*t["sp"])}
    out = {}
    for name, call in calls.items():
        call()
        out[name], out[f"{name}_ms"] = _rank_ms(mesh, call)
    return out


def _par_search_rank(mesh, s: dict) -> dict:
    """Part 3: the scatter-gather search over the rank's corpus rows."""
    rows = torch.from_numpy(np.load(s["corpus"][mesh.rank])).to(mesh.device)
    queries = torch.from_numpy(s["queries"]).to(mesh.device)
    search = make_distributed_search(mesh, s["n"], s["k"])
    search(queries, rows)
    (ids, scores), ms = _rank_ms(mesh, lambda: search(queries, rows))
    return dict(ids=ids, scores=scores, ms=ms)


def _par_gated_rank(mesh, s: dict) -> dict:
    """Part 4: config 5 sharded over its blocks: the stateless loss and
    gradient, gate_state_init, one drifted step under the global budget,
    the gradient under the step's masks; the rank's kernel launches."""
    part = torch.load(s["slices"][mesh.rank], map_location=mesh.device)
    bdg = BlockDenseGraph(**part["bdg"])
    shard = GatedShard(mesh, bdg, part["start"], part["stop"], s["nb_total"])
    cfg = s["cfg"]
    params = gated.gated_graph_transformer_init(0, cfg, device=mesh.device)
    x0, x1 = part["x0"], part["x1"]
    zeros = torch.zeros_like(x0)
    train_cfg = dataclasses.replace(cfg, remat=True)
    kernels.reset_launch_counts()
    (loss, grads), vg_ms = _rank_ms(mesh, lambda: sharded_value_and_grad(
        params, train_cfg, x0, shard, zeros))
    state, init_ms = _rank_ms(mesh, lambda: sharded_gate_state_init(params, cfg, x0, shard))
    (y, state1, nres), step_ms = _rank_ms(mesh, lambda: sharded_step(params, cfg, x1, shard,
                                                                     state))
    (mloss, mgrads), mg_ms = _rank_ms(mesh, lambda: sharded_value_and_grad(
        params, train_cfg, x1, shard, zeros, keep_masks=state1["keep"]))
    return dict(range=(shard.start, shard.stop), loss=loss, grads=grads, keep0=state["keep"],
                state1=state1, nres=nres, y=y, masked_loss=mloss, masked_grads=mgrads,
                launches=kernels.launch_counts(), value_grad_ms=vg_ms, init_ms=init_ms,
                step_ms=step_ms, masked_grad_ms=mg_ms)


def par_rank(mesh, spec: dict) -> dict:
    """One rank of the [parallel] phase: the dry run's parts in its order."""
    _rank_setup(mesh)
    out = {"backend": mesh.backend}
    t0 = time.perf_counter()
    parts = (("halo", lambda: _par_halo_rank(mesh, spec["halo"])),
             ("transformer", lambda: _par_transformer_rank(mesh, spec["transformer"])),
             ("search", lambda: _par_search_rank(mesh, spec["search"])),
             ("gated", lambda: _par_gated_rank(mesh, spec["gated"])))
    for name, part in parts:
        out[name] = part()
        if mesh.rank == 0:   # progress, while the parent waits
            say("parallel_rank0", part=name, seconds=round(time.perf_counter() - t0, 1))
    out["staged_bytes"] = mesh.staged_bytes
    out["seconds"] = time.perf_counter() - t0
    return out


def par_nccl_rank(mesh, s: dict) -> dict:
    """Part 5: part 1's forward at world 1 on the NCCL route (no staging)."""
    _rank_setup(mesh)
    cfg, params = _par_net(s["d"], s["heads"], mesh.device)
    fwd = make_sharded_layer_forward(cfg, s["plan"], mesh)
    feats = torch.from_numpy(s["fpad"]).to(mesh.device)
    cold, cold_ms = _rank_ms(mesh, lambda: fwd(params, feats))
    y, ms = _rank_ms(mesh, lambda: fwd(params, feats))
    if not torch.equal(y, cold):
        raise AssertionError("the world-1 forward differs between two calls")
    return dict(cold_ms=cold_ms, forward=y, ms=ms, backend=mesh.backend, staged=mesh.staged,
                staged_bytes=mesh.staged_bytes)


def _par_write_slices(tmp: str, bdg, x0, x1) -> list[str]:
    """Each rank's blocks of config 5's layout and features, one file a
    rank (the layout is built once, here)."""
    paths = []
    b = bdg.block
    for r, (start, stop) in enumerate(block_ranges(bdg.n_blocks, PAR_WORLD)):
        sl = slice_block_dense(bdg, start, stop)
        rows = slice(start * b, stop * b)
        part = {"bdg": {f.name: (getattr(sl, f.name).cpu() if torch.is_tensor(getattr(sl, f.name))
                                 else getattr(sl, f.name))
                        for f in dataclasses.fields(sl)},
                "start": start, "stop": stop, "x0": x0[rows].cpu(), "x1": x1[rows].cpu()}
        paths.append(os.path.join(tmp, f"c5_rank{r}.pt"))
        torch.save(part, paths[-1])
    return paths


def _grads_scaled(name: str, names: list, got, want, tol: float) -> float:
    """Each leaf's gradient within tol of its own scale, or, for a leaf
    whose gradient is rounding noise (a scale below 1e-6 of the largest
    leaf's: the attention key bias, whose exact gradient is 0), within tol
    of the largest leaf's scale. Returns the largest relative error."""
    top = max(float(w.abs().max()) for w in want)
    worst = 0.0
    for leaf, gl, wl in zip(names, got, want):
        own = float(wl.abs().max())
        scale = max(own if own >= 1e-6 * top else top, 1e-30)
        err = float((gl.to(wl.device).float() - wl.float()).abs().max()) / scale
        worst = max(worst, err)
        if err > tol:
            raise AssertionError(f"{name}: {leaf} off by {err:.3e} of its scale (limit {tol})")
    return worst


def _gated_leaf_names(params) -> list:
    return [f"{li}/{'/'.join(k)}" for li, layer in enumerate(params)
            for k in gated._flatten(layer)[0]]


def _agree_adam(name: str, got, want, grads_want, lr: float, eps: float = 1e-8) -> dict:
    """One Adam step's parameters from gradients that agree within d =
    PAR_GRAD_TOL of their scale (as _grads_scaled holds them). The first
    step moves each parameter by lr g / (|g| + eps), which moves by at most
    lr eps d / (|g| - d + eps)^2 when g moves by d, and by up to 2 lr where
    |g| <= d (its sign may flip); parameters must agree within that bound
    plus 1e-6. Returns the largest error and how many elements sit at the
    sign bound."""
    top = max(float(g.abs().max()) for g in tree_leaves(grads_want))
    worst, flips = 0.0, 0
    for g, w, gw in zip(tree_leaves(got), tree_leaves(want), tree_leaves(grads_want)):
        own = float(gw.abs().max())
        d = PAR_GRAD_TOL * (own if own >= 1e-6 * top else top)
        mag = gw.abs()
        bound = torch.where(mag > d, lr * eps * d / (mag - d + eps) ** 2,
                            torch.full_like(mag, 2 * lr)) + 1e-6
        err = (g.to(w.device) - w).abs()
        if not bool((err <= bound).all()):
            raise AssertionError(f"{name}: a parameter moved {float((err - bound).max()):.3e} "
                                 "past Adam's bound")
        worst = max(worst, float(err.max()))
        flips += int((mag <= d).sum())
    say("agree", name=name, max_abs_err=worst, sign_bound_elements=flips, ok=True)
    return {"max_abs_err": worst, "sign_bound_elements": flips}


def _agree_abs(name: str, got: torch.Tensor, want: torch.Tensor, tol: float) -> float:
    """agree() within an absolute limit, as the JAX tests' assert_allclose(atol=tol)."""
    return agree(name, got, want, torch.float32, tol=(tol, tol))


def _par_c5_inputs(d: int, c5: dict | None):
    """Config 5's layout and layer-0 input (the serving phase's when it
    ran) and a drifted copy of the features."""
    if c5 is not None:
        bdg, x0 = c5["bdg"], c5["x0"].reshape(-1, d)
    else:
        feats, idx, ew = cluster_graph(C5_NODES, d, C5_K)
        bdg = build_block_dense(idx.cpu().numpy(), np.ones((C5_NODES, C5_K), np.float32),
                                ew.cpu().numpy(), block=C5_BLOCK, device=DEV)
        x0 = bdg.pad_features(feats)
    noise = torch.Generator(device=DEV).manual_seed(17)
    x1 = x0 + C5_DRIFT * torch.randn(x0.shape, generator=noise, device=DEV) * \
        bdg.node_pad.reshape(-1, 1)
    return bdg, x0, x1


def phase_parallel(feats_np: np.ndarray, graph: NeighborGraph, d: int, heads: int,
                   c5: dict | None = None) -> dict:
    """The multichip dry run's sharded paths at full width, PAR_WORLD rank
    processes (on one card: gloo, collectives staged through the host; on
    a machine with PAR_WORLD cards: NCCL, a card each), each part held
    against the same computation in this process:
    1. RuvectorNet halo-sharded on the bench graph (build_halo_plan with
       reorder="cluster"): forward, overlap forward, one Adam step;
    2. TP, EP, PP and SP at the transformer's width;
    3. the distributed search over the re-rank's corpus;
    4. config 5 sharded over its blocks: loss and gradient, gate state,
       a drifted step under the global budget, the masked gradient;
    5. part 1's forward at world 1 on the NCCL route.
    Four ranks on one card measure correctness and the staging cost, not
    scaling."""
    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_parallel_")
    try:
        return _phase_parallel(feats_np, graph, d, heads, c5, tmp, t_phase)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _phase_parallel(feats_np, graph, d, heads, c5, tmp, t_phase) -> dict:
    n = graph.num_nodes
    cfg, params = _par_net(d, heads, DEV)
    # --- part 1's inputs: the plans, built once here -----------------------
    t0 = time.perf_counter()
    plan, perm = build_halo_plan(graph, PAR_WORLD, reorder="cluster")
    ov_plan, ov_perm = build_overlap_plan(graph, PAR_WORLD, reorder="cluster")
    plans_s = time.perf_counter() - t0
    fpad = pad_features_for_plan(feats_np, plan, perm, device=DEV)
    ov_fpad = np.zeros((ov_plan.n_shards * ov_plan.block, d), np.float32)
    live = ov_perm >= 0
    ov_fpad[live] = feats_np[ov_perm[live]]
    n_pad = plan.n_shards * plan.block
    neg_ids = np.random.default_rng(5).integers(0, n, size=(n_pad, PAR_NEGS)).astype(np.int32)
    halo_spec = dict(d=d, heads=heads, plan=plan, ov_plan=ov_plan, fpad=fpad.cpu().numpy(),
                     ov_fpad=ov_fpad, neg_ids=neg_ids, lr=PAR_LR)
    # --- part 3's corpus, one file a rank ------------------------------------
    corpus = bench_features(RR_NODES, d)
    rng = np.random.default_rng(8)
    queries = (corpus[rng.integers(0, RR_NODES, PAR_SEARCH_Q)]
               + RR_NOISE * rng.standard_normal((PAR_SEARCH_Q, d))).astype(np.float32)
    block = RR_NODES // PAR_WORLD
    corpus_files = []
    for r in range(PAR_WORLD):
        corpus_files.append(os.path.join(tmp, f"corpus_rank{r}.npy"))
        np.save(corpus_files[-1], corpus[r * block:(r + 1) * block])
    # --- part 4's layout, one file a rank ------------------------------------
    gcfg = config5_config(d, heads)
    bdg, x0, x1 = _par_c5_inputs(d, c5)
    slices = _par_write_slices(tmp, bdg, x0, x1)
    spec = dict(halo=halo_spec, transformer=_par_sizes(),
                search=dict(corpus=corpus_files, queries=queries, n=RR_NODES, k=PAR_SEARCH_K),
                gated=dict(slices=slices, cfg=gcfg, nb_total=bdg.n_blocks))
    setup_s = time.perf_counter() - t0

    # --- the ranks ------------------------------------------------------------
    t0 = time.perf_counter()
    res = run_ranks(par_rank, PAR_WORLD, spec, device=DEV)
    ranks_s = time.perf_counter() - t0
    # gloo where the ranks share a card, NCCL where each has its own
    backend = rank_devices(PAR_WORLD, DEV)[1]
    if any(r["backend"] != backend for r in res):
        raise AssertionError(f"the ranks ran on {[r['backend'] for r in res]}, not {backend}")

    # --- part 1 against one process ---------------------------------------------
    t0 = time.perf_counter()
    feats = torch.from_numpy(feats_np).to(DEV)
    single = ruvector_net_apply(params, cfg, feats, graph)
    single_ms = time_ms(lambda: ruvector_net_apply(params, cfg, feats, graph), iters=5)
    want = single[torch.from_numpy(perm).to(DEV)]
    out = torch.cat([r["halo"]["forward"] for r in res]).to(DEV)
    err_fwd = _agree_abs("parallel halo: sharded forward vs one process", out[:n], want,
                             PAR_HALO_TOL)
    if bool(out[n:].any()):
        raise AssertionError("padding rows of the sharded forward are not zero")
    blocked_fwd = make_blocked_layer_forward(cfg, plan, DEV)
    blocked = blocked_fwd(params, fpad)
    blocked_ms = time_ms(lambda: blocked_fwd(params, fpad), iters=5)
    _agree_abs("parallel halo: blocked forward vs one process", blocked[:n], want,
                   PAR_HALO_TOL)
    ov_out = torch.cat([r["halo"]["overlap"] for r in res]).to(DEV)
    live_t = torch.from_numpy(np.nonzero(live)[0]).to(DEV)
    _agree_abs("parallel halo: overlap forward vs one process", ov_out[live_t],
                   single[torch.from_numpy(ov_perm[live]).to(DEV)], PAR_HALO_TOL)
    opt = adam(PAR_LR)
    bstate = opt.init(params)
    p_b, st_b, loss_b = make_blocked_train_step(cfg, plan, opt, device=DEV)(
        params, bstate, fpad, torch.from_numpy(neg_ids).to(DEV))
    losses = [float(r["halo"]["loss"]) for r in res]
    if len(set(losses)) != 1 or abs(losses[0] - float(loss_b)) > 1e-5 * abs(float(loss_b)):
        raise AssertionError(f"sharded step losses {losses} vs the blocked step's "
                             f"{float(loss_b)}")
    # Adam's first moment after one step is (1 - b1) g
    g_b = tree_map(lambda m: m / (1 - 0.9), st_b["mu"])
    g_s = tree_map(lambda m: m / (1 - 0.9), res[0]["halo"]["mu"])
    grad_err = _grads_scaled("parallel halo: sharded step gradients vs blocked step",
                             [str(i) for i in range(len(tree_leaves(g_b)))],
                             tree_leaves(g_s), tree_leaves(g_b), PAR_GRAD_TOL)
    for r in res[1:]:
        for a, b in zip(tree_leaves(r["halo"]["params"]), tree_leaves(res[0]["halo"]["params"])):
            if not torch.equal(a, b):
                raise AssertionError("the ranks' parameters differ after the step")
    adam_err = _agree_adam("parallel halo: sharded Adam step vs blocked step",
                           res[0]["halo"]["params"], p_b, g_b, PAR_LR)
    h = [r["halo"] for r in res]
    say("parallel_halo", nodes=n, d=d, heads=heads, layers=2, world=PAR_WORLD, halo=plan.halo,
        block=plan.block, overlap_bmax=ov_plan.bmax, overlap_interior=ov_plan.n_interior,
        plans_s=round(plans_s, 3), one_process_ms=single_ms, blocked_ms=blocked_ms,
        forward_ms=[round(x["forward_ms"], 3) for x in h],
        overlap_ms=[round(x["overlap_ms"], 3) for x in h],
        step_ms=[round(x["step_ms"], 3) for x in h],
        first_step_ms=[round(x["first_step_ms"], 3) for x in h],
        forward_staged_bytes=h[0]["forward_staged_bytes"],
        step_staged_bytes=h[0]["step_staged_bytes"], forward_max_abs_err=err_fwd,
        loss=losses[0], loss_blocked=float(loss_b), grad_rel_err=grad_err,
        adam_max_abs_err=adam_err["max_abs_err"],
        adam_sign_bound_elements=adam_err["sign_bound_elements"])
    part1_s = time.perf_counter() - t0

    # --- part 2 against the references ------------------------------------------
    t = _par_transformer_inputs(DEV, _par_sizes())
    ref_calls = {"tp": lambda: reference_tp_layer_forward(t["tp"], t["tp_cfg"], t["tp_x"]),
                 "ep": lambda: reference_ep_forward(t["ep"], t["ep_cfg"], t["ep_x"]),
                 "pp": lambda: reference_pp_forward(_pp_layer, t["pp"], t["pp_x"]),
                 "sp": lambda: reference_attention(*t["sp"])}
    errs = {}
    for name in ("tp", "ep", "pp"):
        errs[name] = max(_agree_abs(f"parallel {name}: rank {i} vs reference",
                                        r["transformer"][name].to(DEV), ref_calls[name](),
                                        PAR_TOL) for i, r in enumerate(res))
    ring = torch.cat([r["transformer"]["sp"] for r in res]).to(DEV)
    errs["sp"] = _agree_abs("parallel sp: ring attention vs dense", ring, ref_calls["sp"](),
                                PAR_RING_TOL)
    ref_ms = {k: time_ms(call, iters=5) for k, call in ref_calls.items()}
    tr = [r["transformer"] for r in res]
    say("parallel_transformer", tp=PAR_TP, tp_tokens=PAR_TP_TOKENS, ep=PAR_EP,
        ep_tokens=PAR_EP_TOKENS, pp_stages=PAR_WORLD, pp_micro=PAR_PP_MICRO,
        pp_rows=PAR_PP_ROWS, pp_d=PAR_PP_D, sp_seq=PAR_SP_SEQ, sp_d=PAR_SP_D,
        **{f"{k}_max_abs_err": v for k, v in errs.items()},
        **{f"{k}_ms": [round(x[f"{k}_ms"], 3) for x in tr] for k in ("tp", "ep", "pp", "sp")},
        **{f"{k}_one_process_ms": v for k, v in ref_ms.items()})

    # --- part 3 against one process ---------------------------------------------
    corpus_t = torch.from_numpy(corpus).to(DEV)
    q_t = torch.from_numpy(queries).to(DEV)
    s1, i1 = torch.topk(pairwise_cosine(q_t, corpus_t), PAR_SEARCH_K, dim=1, sorted=True)
    search_ms = time_ms(lambda: torch.topk(pairwise_cosine(q_t, corpus_t), PAR_SEARCH_K, dim=1,
                                           sorted=True), iters=5)
    del corpus_t, corpus
    for i, r in enumerate(res):
        same_topk(f"parallel search: rank {i} vs one process", i1.cpu().numpy(),
                  s1.cpu().numpy(), r["search"]["ids"].numpy(), r["search"]["scores"].numpy(),
                  tol=1e-5)
    say("parallel_search", corpus=RR_NODES, d=d, queries=PAR_SEARCH_Q, k=PAR_SEARCH_K,
        ms=[round(r["search"]["ms"], 3) for r in res], one_process_ms=search_ms)

    # --- part 4 against one process ---------------------------------------------
    t0 = time.perf_counter()
    gparams = gated.gated_graph_transformer_init(0, gcfg, device=DEV)
    train_cfg = dataclasses.replace(gcfg, remat=True)
    loss, _, grads = _loss_and_grads(gparams, train_cfg, x0, bdg, None)
    torch.cuda.empty_cache()
    state = gated.gate_state_init(gparams, gcfg, x0, bdg)
    y_ref, st1, nres = gated.gated_graph_transformer_step(gparams, gcfg, x1, bdg, state)
    mloss, _, mgrads = _loss_and_grads(gparams, train_cfg, x1, bdg, st1["keep"])
    g = [r["gated"] for r in res]
    ranges = [x["range"] for x in g]
    if ranges != block_ranges(bdg.n_blocks, PAR_WORLD):
        raise AssertionError(f"rank block ranges {ranges}")
    for i, x in enumerate(g):
        for nm, got_l, want_l in (("loss", x["loss"], loss), ("masked loss", x["masked_loss"],
                                                              mloss)):
            if abs(float(got_l) - float(want_l)) > 1e-5 * abs(float(want_l)):
                raise AssertionError(f"rank {i} {nm} {float(got_l)} vs {float(want_l)}")
    names = _gated_leaf_names(gparams)
    gerr = max(_grads_scaled(f"parallel gated grads, rank {i}", names, _leaves(x["grads"]),
                             grads, PAR_GRAD_TOL) for i, x in enumerate(g))
    mgerr = max(_grads_scaled(f"parallel gated masked grads, rank {i}", names,
                              _leaves(x["masked_grads"]), mgrads, PAR_GRAD_TOL)
                for i, x in enumerate(g))
    if not torch.equal(torch.cat([x["keep0"] for x in g], dim=1).to(DEV), state["keep"]):
        raise AssertionError("sharded gate_state_init masks differ from one process's")
    for key in ("keep", "sig", "age"):
        if not torch.equal(torch.cat([x["state1"][key] for x in g], dim=1).to(DEV), st1[key]):
            raise AssertionError(f"sharded step {key} differs from one process's")
    if any(x["nres"] != nres for x in g):
        raise AssertionError(f"sharded step re-solved {[x['nres'] for x in g]} vs {nres}")
    budget = max(1, int(bdg.n_blocks * gcfg.max_resolve_frac))
    if not 0 < nres <= gcfg.num_layers * budget:
        raise AssertionError(f"the drifted step re-solved {nres} (budget {budget} a layer)")
    y_err = _agree_abs("parallel gated: sharded step output vs one process",
                           torch.cat([x["y"] for x in g]).to(DEV), y_ref, PAR_TOL)
    per_rank = {k: [x["launches"][k] for x in g] for k in kernels.launch_counts()}
    missing = {k: v for k, v in per_rank.items() if k in PAR_C5_KERNELS and min(v) < 1}
    if missing:
        raise AssertionError(f"kernels not launched on every rank: {missing}")
    say("parallel_gated", nodes=bdg.n_blocks * bdg.block, nB=bdg.n_blocks, B=bdg.block,
        ranges=ranges, budget=budget, resolved=nres, loss=float(loss),
        masked_loss=float(mloss), grad_rel_err=gerr, masked_grad_rel_err=mgerr,
        step_max_abs_err=y_err, masks_equal=True,
        value_grad_ms=[round(x["value_grad_ms"], 3) for x in g],
        init_ms=[round(x["init_ms"], 3) for x in g], step_ms=[round(x["step_ms"], 3) for x in g],
        masked_grad_ms=[round(x["masked_grad_ms"], 3) for x in g],
        launches_per_rank={k: v for k, v in per_rank.items() if any(v)})
    part4_s = time.perf_counter() - t0
    del grads, mgrads, y_ref, st1, state
    torch.cuda.empty_cache()

    # --- part 5: world 1 on NCCL ----------------------------------------------------
    t0 = time.perf_counter()
    plan1, _ = build_halo_plan(graph, 1)
    (one,) = run_ranks(par_nccl_rank, 1, dict(d=d, heads=heads, plan=plan1, fpad=feats_np),
                       device=DEV)
    if one["backend"] != "nccl" or one["staged"] or one["staged_bytes"]:
        raise AssertionError(f"the world-1 run took {one['backend']} with "
                             f"{one['staged_bytes']} bytes staged")
    nccl_err = _agree_abs("parallel nccl: world-1 forward vs one process",
                              one["forward"].to(DEV), single, PAR_HALO_TOL)
    say("parallel_nccl", world=1, backend=one["backend"], staged_bytes=one["staged_bytes"],
        forward_ms=round(one["ms"], 3), first_call_ms=round(one["cold_ms"], 3),
        max_abs_err=nccl_err, seconds=round(
            time.perf_counter() - t0, 1))
    staged = [r["staged_bytes"] for r in res]
    say("parallel", world=PAR_WORLD, backend=backend, cards=torch.cuda.device_count(),
        staged_bytes_per_rank=staged,
        rank_seconds=[round(r["seconds"], 1) for r in res], setup_s=round(setup_s, 1),
        ranks_s=round(ranks_s, 1), part1_check_s=round(part1_s, 1),
        part4_check_s=round(part4_s, 1), seconds=round(time.perf_counter() - t_phase, 1))
    return {"launches_per_rank": per_rank}


# ---------------------------------------------------------------------------
# the front ends: the HTTP server, MCP, SQL and the CLI
# ---------------------------------------------------------------------------

def _http(base: str, method: str, path: str, payload=None):
    """(status, parsed body) of one request to the HTTP server; /metrics
    comes back as text. A status other than 2xx raises (HTTPError)."""
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(base + path, data=data, method=method,
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=300) as resp:
        body = resp.read()
        return resp.status, body.decode() if path == "/metrics" else json.loads(body)


def _profile_summary(prof, n: int = 6) -> dict:
    """The top ops of a torch.profiler run by host and by device self
    time (ms), and the device's busy ms: the sum over the device's own
    events (kernels, copies), which the ops that launch them repeat."""
    events = prof.key_averages()
    dev = [(e.key, getattr(e, "self_device_time_total", 0) / 1e3) for e in events]
    host = [(e.key, e.self_cpu_time_total / 1e3) for e in events]
    on_device = [getattr(e, "self_device_time_total", 0) / 1e3 for e in events
                 if e.device_type == torch.autograd.DeviceType.CUDA]
    top = lambda rows: json.dumps({k: round(v, 3) for k, v in  # noqa: E731
                                   sorted(rows, key=lambda r: -r[1])[:n]})
    return {"device_busy_ms": round(sum(on_device), 3), "device_top_ms": top(dev),
            "host_top_ms": top(host)}


def _host_profile(fn, n: int = 5):
    """(fn's result, its top host functions by own time, as JSON of s)."""
    import cProfile
    import pstats

    prof = cProfile.Profile()
    out = prof.runcall(fn)
    stats = pstats.Stats(prof).stats
    top = sorted(stats.items(), key=lambda kv: -kv[1][2])[:n]
    return out, json.dumps({f"{os.path.basename(f)}:{line}({name})": round(v[2], 3)
                            for (f, line, name), v in top})


def _fe_queries(feats_np: np.ndarray, count: int, seed: int):
    """(rows, queries): corpus rows plus IX_NOISE N(0, 1), as `[index]`'s."""
    rng = np.random.default_rng(seed)
    rows = rng.choice(feats_np.shape[0], count, replace=False)
    noise = IX_NOISE * rng.standard_normal((count, feats_np.shape[1]))
    return rows, (feats_np[rows] + noise).astype(np.float32)


def _fe_payload(i: int, labels: np.ndarray) -> dict:
    return {"cluster": int(labels[i]), "bucket": i % 10}


def _fe_percentiles(ms: list) -> dict:
    return {"p50_ms": float(np.percentile(ms, 50)), "p99_ms": float(np.percentile(ms, 99)),
            "qps": len(ms) / (sum(ms) * 1e-3)}


def _fe_storm(base: str, feats_np: np.ndarray, labels: np.ndarray) -> float:
    """tests/test_serve_extra.py's concurrent load at the card's scale on
    the `upserts` collection: writers upsert new ids one point a request
    while readers search and read /metrics. Every request must return 200."""
    n_read = FE_STORM_READERS * FE_STORM_SEARCHES
    _, queries = _fe_queries(feats_np, n_read, 51)
    statuses, errors = [], []

    def writer(w: int):
        try:
            for i in range(FE_STORM_POINTS):
                pid = FE_UPSERT_ROWS + w * FE_STORM_POINTS + i
                status, _ = _http(base, "PUT", "/collections/upserts/points", {"points": [
                    {"id": pid, "vector": feats_np[pid].tolist(),
                     "payload": _fe_payload(pid, labels)}]})
                statuses.append(status)
        except Exception as exc:
            errors.append(repr(exc))

    def reader(r: int):
        try:
            for q in queries[r * FE_STORM_SEARCHES:(r + 1) * FE_STORM_SEARCHES]:
                status, out = _http(base, "POST", "/collections/upserts/points/search",
                                    {"vector": q.tolist(), "limit": IX_K})
                statuses.append(status)
                if len(out["result"]) != IX_K:
                    raise AssertionError(f"a storm search returned {len(out['result'])} results")
                status, text = _http(base, "GET", "/metrics")
                statuses.append(status)
                if "search_latency_seconds" not in text:
                    raise AssertionError("/metrics lacks search_latency_seconds")
        except Exception as exc:
            errors.append(repr(exc))

    threads = ([threading.Thread(target=writer, args=(w,)) for w in range(FE_STORM_WRITERS)]
               + [threading.Thread(target=reader, args=(r,)) for r in range(FE_STORM_READERS)])
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    storm_s = time.perf_counter() - t0
    want = FE_STORM_WRITERS * FE_STORM_POINTS + 2 * n_read
    if errors or len(statuses) != want or set(statuses) != {200}:
        raise AssertionError(f"storm: {len(statuses)} of {want} requests answered 200 "
                             f"({sorted(set(statuses))}), errors {errors[:3]}")
    return storm_s


def _fe_http(db: VectorDB, feats_np: np.ndarray, labels: np.ndarray, flat: FlatIndex):
    """The HTTP server on 127.0.0.1 with the 100k collection registered and
    a second filled through PUT; returns that second collection."""
    n, d = feats_np.shape
    server = RuvectorServer(port=0, device=DEV).start()
    base = f"http://127.0.0.1:{server.port}"
    try:
        server.state.collections["bench"] = db
        _http(base, "PUT", "/collections/upserts", {"vectors": {"size": d, "distance": "Cosine"}})
        bodies = [{"points": [{"id": i, "vector": feats_np[i].tolist(),
                               "payload": _fe_payload(i, labels)}
                              for i in range(lo, lo + FE_UPSERT_BATCH)]}
                  for lo in range(0, FE_UPSERT_ROWS, FE_UPSERT_BATCH)]
        t0 = time.perf_counter()
        for body in bodies:
            _http(base, "PUT", "/collections/upserts/points", body)
        upsert_s = time.perf_counter() - t0
        del bodies

        # searches of the 100k collection, the last FE_FILTERED filtered by cluster
        rows, queries = _fe_queries(feats_np, FE_SEARCHES, 21)
        unfiltered = FE_SEARCHES - FE_FILTERED
        ids, lat, lat_f = np.full((unfiltered, IX_K), -1, np.int64), [], []
        for i, q in enumerate(queries):
            body, flt = {"vector": q.tolist(), "limit": IX_K}, None
            if i >= unfiltered:
                flt = body["filter"] = {"must": [{"key": "cluster",
                                                  "match": {"value": int(labels[rows[i]])}}]}
            t0 = time.perf_counter()
            _, out = _http(base, "POST", "/collections/bench/points/search", body)
            (lat if flt is None else lat_f).append((time.perf_counter() - t0) * 1e3)
            got = [(r["id"], r["score"]) for r in out["result"]]
            if got != [(r.id, r.score) for r in db.search(q, k=IX_K, filter=flt)]:
                raise AssertionError(f"HTTP search {i} differs from db.search")
            if flt is None:
                ids[i, :len(got)] = [g[0] for g in got]
            elif not all(r["payload"]["cluster"] == labels[rows[i]] for r in out["result"]):
                raise AssertionError("HTTP filtered search: a result outside its cluster")
        exact, _ = flat.search_batch(queries[:unfiltered], k=IX_K)
        recall = _recall(ids, exact, IX_K)
        if recall < FE_RECALL_MIN:
            raise AssertionError(f"HTTP search recall@10 {recall} under {FE_RECALL_MIN}")

        storm_s = _fe_storm(base, feats_np, labels)
        updb = server.state.collections["upserts"]
        points = FE_UPSERT_ROWS + FE_STORM_WRITERS * FE_STORM_POINTS
        _, info = _http(base, "GET", "/collections/upserts")
        if info["result"]["points_count"] != points or updb.neighbor_graph().num_nodes != points:
            raise AssertionError(f"after the storm: {info['result']['points_count']} points, "
                                 f"{points} written")

        # scroll one cluster to the end, 7 points a page
        c0 = int(labels[0])
        want = [vid for i, vid in enumerate(updb._ids)
                if (updb._payloads.get(i) or {}).get("cluster") == c0]
        flt, seen, offset, pages = {"must": [{"key": "cluster", "match": {"value": c0}}]}, [], None, 0
        while True:
            body = {"limit": 7, "filter": flt, **({} if offset is None else {"offset": offset})}
            _, out = _http(base, "POST", "/collections/upserts/points/scroll", body)
            seen += [p["id"] for p in out["result"]["points"]]
            pages += 1
            offset = out["result"]["next_page_offset"]
            if offset is None:
                break
        if seen != want:
            raise AssertionError(f"scroll returned {len(seen)} ids, {len(set(seen))} distinct; "
                                 f"cluster {c0} holds {len(want)}")

        _, point = _http(base, "GET", "/collections/upserts/points/5")
        if point["result"]["vector"] != feats_np[5].tolist() \
                or point["result"]["payload"] != _fe_payload(5, labels):
            raise AssertionError("GET point 5 answers another vector or payload")
        health = _http(base, "GET", "/health")[1]
        ready = _http(base, "GET", "/ready")[1]
        _http(base, "POST", "/sql", {"sql": "CREATE TABLE t (id int, v ruvector(2)); INSERT INTO t "
                                            "VALUES (1, '[1,0]'), (2, '[0,1]')"})
        sql = _http(base, "POST", "/sql", {"sql": "SELECT id FROM t ORDER BY v <-> '[0,1]' LIMIT 1"})
        if sql[1]["result"] != [{"id": 2}] or server.state.sql.device != DEV:
            raise AssertionError(f"/sql answered {sql}")
        _http(base, "DELETE", "/collections/upserts")
        try:
            _http(base, "GET", "/collections/upserts")
            raise AssertionError("a deleted collection still answers")
        except urllib.error.HTTPError as err:
            if err.code != 404:
                raise
    finally:
        server.stop()
    say("front_ends_http", collection_rows=n, d=d, upsert_rows=FE_UPSERT_ROWS,
        upsert_requests=FE_UPSERT_ROWS // FE_UPSERT_BATCH, upsert_s=upsert_s,
        upsert_points_per_s=FE_UPSERT_ROWS / upsert_s, searches=unfiltered, k=IX_K,
        **_fe_percentiles(lat), filtered_searches=FE_FILTERED,
        filtered_p50_ms=float(np.percentile(lat_f, 50)), recall_at_10=recall,
        recall_min=FE_RECALL_MIN, equal_to_db_search=True,
        storm_writers=FE_STORM_WRITERS, storm_points=FE_STORM_POINTS,
        storm_readers=FE_STORM_READERS, storm_searches=FE_STORM_SEARCHES, storm_s=storm_s,
        points_after_storm=points, scroll_cluster=c0, scroll_ids=len(seen), scroll_pages=pages,
        health=health.get("status"), ready=ready.get("status"))
    return updb


def _fe_mcp(db: VectorDB, updb: VectorDB, feats_np: np.ndarray, full: bool) -> None:
    """The MCP server over the 100k collection: search, train, the four
    query modes twice (the second round from the engine cache), and on the
    10k collection the min-cut tool; one sql call."""
    mcp = McpServer(device=DEV)

    def rpc(method: str, params=None):
        return mcp.handle({"jsonrpc": "2.0", "id": 1, "method": method, "params": params or {}})

    def call(tool: str, args: dict):
        res = rpc("tools/call", {"name": tool, "arguments": args})["result"]
        if res.get("isError"):
            raise AssertionError(f"MCP {tool}: {res['content'][0]['text']}")
        return json.loads(res["content"][0]["text"])

    init = rpc("initialize")["result"]
    tools = {t["name"] for t in rpc("tools/list")["result"]["tools"]}
    lines = [json.dumps({"jsonrpc": "2.0", "id": 1, "method": "initialize"}),
             json.dumps({"jsonrpc": "2.0", "method": "notifications/initialized"}),
             json.dumps({"jsonrpc": "2.0", "id": 2, "method": "tools/list"}),
             json.dumps({"jsonrpc": "2.0", "id": 3, "method": "ping"})]
    out = io.StringIO()
    mcp.serve_stdio(stdin=iter(lines), stdout=out)
    replies = [json.loads(line) for line in out.getvalue().splitlines()]
    if init["serverInfo"]["name"] != "ruvector-tpu" or not {"search", "query", "train", "sql",
                                                            "graph_mincut"} <= tools \
            or [r["id"] for r in replies] != [1, 2, 3]:
        raise AssertionError(f"MCP handshake: {init}, {sorted(tools)}, {replies}")
    mcp.collections["bench"] = db
    mcp.collections["upserts"] = updb

    _, queries = _fe_queries(feats_np, FE_MCP_SEARCHES, 31)
    search_ms = []
    for q in queries:
        t0 = time.perf_counter()
        res = call("search", {"collection": "bench", "vector": q.tolist(), "k": IX_K})
        search_ms.append((time.perf_counter() - t0) * 1e3)
        if [(r["id"], r["score"]) for r in res["results"]] != \
                [(r.id, r.score) for r in db.search(q, k=IX_K)]:
            raise AssertionError("MCP search differs from db.search")

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tr = call("train", {"collection": "bench", "steps": FE_MCP_STEPS})
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    if tr["steps"] != FE_MCP_STEPS or not np.isfinite([tr["loss_first"], tr["loss_last"]]).all():
        raise AssertionError(f"MCP train: {tr}")
    if full:
        # where a train call's time goes: two more steps under the profiler
        activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=activities) as prof:
            _, profiled_ms = _synced_ms(lambda: call("train", {"collection": "bench",
                                                               "steps": 2}))
        say("front_ends_mcp_train_profile", steps=2, wall_ms=profiled_ms,
            **_profile_summary(prof))

    # the four modes, then a second, shorter round: every query after the
    # first finds its engine (and its GNN embeddings) in the cache
    modes = ("vector_search", "neural_search", "subgraph_extraction", "differentiable_search")
    _, qq = _fe_queries(feats_np, FE_MCP_QUERIES, 41)
    query_ms, hits, first_ms, answers, subgraph = {m: [] for m in modes}, [], None, [], []
    for rnd, count in enumerate((FE_MCP_QUERIES, FE_MCP_AGAIN)):
        for mode in modes:
            for q in qq[:count]:
                t0 = time.perf_counter()
                r = call("query", {"collection": "bench", "vector": q.tolist(), "mode": mode,
                                   "k": IX_K, "gnn_depth": FE_MCP_DEPTH})
                ms = (time.perf_counter() - t0) * 1e3
                if first_ms is None:
                    first_ms = ms
                elif rnd == 0:
                    query_ms[mode].append(ms)
                if rnd == 0 and mode == "vector_search":
                    answers.append(r)
                if rnd == 0 and mode == "subgraph_extraction":
                    subgraph.append((len(r["subgraph"]["nodes"]), len(r["subgraph"]["edges"])))
                if len(r["nodes"]) != IX_K or not np.isfinite(r["scores"]).all():
                    raise AssertionError(f"MCP query {mode}: {r}")
        hits.append(call("info", {})["gnn_cache"]["hits"])
    if hits[1] - hits[0] != len(modes) * FE_MCP_AGAIN or hits[0] < 1:
        raise AssertionError(f"MCP engine cache hits {hits}")
    params, cfgs = mcp.trained["bench"]
    engine = QueryEngine(db.features_matrix(), db.neighbor_graph(), params, cfgs)
    want = [engine.execute(RuvectorQuery(vector=q, mode=QueryMode.VECTOR_SEARCH, k=IX_K,
                                         gnn_depth=FE_MCP_DEPTH)) for q in qq]
    same_topk("MCP vector_search vs a direct QueryEngine", [w.nodes for w in want],
              [w.scores for w in want], [a["nodes"] for a in answers],
              [a["scores"] for a in answers], 1e-6, min_equal=1.0)
    mincut = {}
    if full:
        t0 = time.perf_counter()
        mc, top = _host_profile(lambda: call("graph_mincut", {"collection": "upserts",
                                                              "k": FE_MCP_CUT_K}))
        mincut = {"mincut_s": time.perf_counter() - t0, "mincut_host_top": top,
                  "mincut_value": mc["value"],
                  "mincut_sides": [mc["side_a"], mc["side_b"]]}
        if mc["side_a"] + mc["side_b"] != len(updb) or not np.isfinite(mc["value"]):
            raise AssertionError(f"MCP graph_mincut: {mc}")
    sql = call("sql", {"sql": "CREATE TABLE m (id int, v ruvector(2)); INSERT INTO m VALUES "
                              "(1, '[1,0]'), (2, '[0,1]'); SELECT id FROM m ORDER BY v <-> "
                              "'[0,1]' LIMIT 1"})
    if sql["result"] != [{"id": 2}]:
        raise AssertionError(f"MCP sql: {sql}")
    say("front_ends_mcp", collection_rows=len(db), searches=FE_MCP_SEARCHES,
        search_p50_ms=float(np.percentile(search_ms, 50)), train_steps=FE_MCP_STEPS,
        train_s=train_s, train_ms_per_step=train_s * 1e3 / FE_MCP_STEPS,
        loss_first=tr["loss_first"], loss_last=tr["loss_last"], queries_per_mode=FE_MCP_QUERIES,
        gnn_depth=FE_MCP_DEPTH, first_query_ms=first_ms,
        query_ms=json.dumps({m: float(np.median(v)) for m, v in query_ms.items()}),
        subgraph_nodes_edges_median=np.median(subgraph, axis=0).tolist(),
        cache_hits=hits, vector_search_equals_engine=True,
        **{**mincut, **({"mincut_rows": len(updb), "mincut_k": FE_MCP_CUT_K} if full else {})})


def _vec_text(v: np.ndarray) -> str:
    """A vector literal; each float32 is written as its double's repr, which
    reads back to the same float32."""
    return str(v.tolist())


def _sql_insert_texts(feats_np: np.ndarray, labels: np.ndarray, table: str, n: int) -> list:
    return ["INSERT INTO " + table + " (cluster, embedding) VALUES " + ", ".join(
        f"({int(labels[i])}, '{_vec_text(feats_np[i])}')" for i in range(lo, min(n, lo + FE_SQL_BATCH)))
        for lo in range(0, n, FE_SQL_BATCH)]


def _sql_distances(rows: np.ndarray, qs: np.ndarray, op: str) -> np.ndarray:
    """pgvector's distances of rows [Q, k, D] to queries [Q, D], in float64."""
    x, q = rows.astype(np.float64), qs.astype(np.float64)[:, None, :]
    dots = np.sum(x * q, axis=2)
    if op == "<#>":
        return -dots
    if op == "<=>":
        return 1.0 - dots / (np.linalg.norm(x, axis=2) * np.linalg.norm(q, axis=2))
    return np.linalg.norm(x - q, axis=2)


def _sql_knn(eng: SqlEngine, table: str, op: str, q: np.ndarray, where: str = ""):
    """(row ids, SQL distances, ms) of one exact top-k SELECT (ids are
    serial: row + 1)."""
    qt = _vec_text(q)
    t0 = time.perf_counter()
    out = eng.execute(f"SELECT id, embedding {op} '{qt}' AS d FROM {table}{where} "
                      f"ORDER BY embedding {op} '{qt}' LIMIT {IX_K}")
    ms = (time.perf_counter() - t0) * 1e3
    return [r["id"] - 1 for r in out], [r["d"] for r in out], ms


def _fe_sql_controls(eng: SqlEngine, feats_np: np.ndarray, d: int) -> None:
    """One control for each of the reference's five SQL faults that the
    port repairs; each must behave as repaired."""
    rows = ", ".join(f"('t{i % 2}', '{_vec_text(feats_np[i])}')" for i in range(32))
    eng.execute(f"CREATE TABLE ctl (id serial, n int, tag text, embedding ruvector({d})); "
                f"INSERT INTO ctl (tag, embedding) VALUES {rows}; "
                f"INSERT INTO ctl (tag, embedding) VALUES (NULL, '{_vec_text(feats_np[0])}')")
    got = {}
    try:
        eng.execute("CREATE INDEX ci ON ctl USING hnsw (embedding vector_ip_ops)")
        got["ip_ops"] = "built"
    except SqlError as exc:
        got["ip_ops"] = "refused" if "inner-product" in str(exc) else str(exc)
    eng.execute("CREATE INDEX cl ON ctl USING hnsw (embedding ruvector_l2_ops)")
    q = _vec_text(feats_np[3])
    plan = eng.execute(f"EXPLAIN SELECT id FROM ctl ORDER BY embedding <-> '{q}' LIMIT 3")
    got["ruvector_ops"] = any(s["plan"].startswith("hnsw index scan") for s in plan)
    got["null_eq"] = eng.execute("SELECT id FROM ctl WHERE tag = NULL")
    got["null_ne"] = eng.execute("SELECT count(*) FROM ctl WHERE tag <> 't0'")
    got["vector_eq"] = eng.execute(f"SELECT id FROM ctl WHERE embedding = '{q}'")
    got["serial"] = eng.execute("SELECT id, n FROM ctl WHERE id = 33")
    q0 = _vec_text(feats_np[0])
    got["ties"] = eng.execute(f"SELECT id FROM ctl ORDER BY embedding <-> '{q0}', id DESC LIMIT 2")
    want = {"ip_ops": "refused", "ruvector_ops": True, "null_eq": [], "null_ne": [{"count": 16}], "vector_eq": [{"id": 4}],
            "serial": [{"id": 33, "n": None}], "ties": [{"id": 33}, {"id": 1}]}
    say("front_ends_sql_controls", **{k: json.dumps(v) for k, v in got.items()},
        ok=got == want)
    if got != want:
        raise AssertionError(f"SQL fault controls: {got} != {want}")


def _fe_sql(feats_np: np.ndarray, labels: np.ndarray, flat: FlatIndex, flat_l2: FlatIndex,
            full: bool) -> None:
    """The SQL engine on the card: the 100k corpus loaded by INSERT text,
    exact kNN by each operator and under a WHERE, the card's distances
    against a CPU engine's, count/UPDATE/DELETE; with `full`, an HNSW
    index on a 10k table against the exact route, the GNN worker and the
    fault controls."""
    n, d = feats_np.shape
    eng = SqlEngine(device=DEV)
    eng.execute(f"CREATE TABLE items (id serial, cluster int, embedding ruvector({d}))")
    t0 = time.perf_counter()
    texts = _sql_insert_texts(feats_np, labels, "items", n)
    text_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    _, insert_top = _host_profile(lambda: eng.execute(texts[0]))
    for sql in texts[1:]:
        eng.execute(sql)
    insert_s = time.perf_counter() - t0
    del texts
    table = eng.tables["items"]
    if len(table) != n or not np.array_equal(table.vecs["embedding"], feats_np) \
            or table.data["id"][-1] != n:
        raise AssertionError("SQL load: the table differs from the corpus")

    feats = torch.from_numpy(feats_np).to(DEV)
    knn_ms, share_equal = {}, {}
    for op, count, seed in (("<->", FE_SQL_L2, 61), ("<=>", FE_SQL_OTHER, 62),
                            ("<#>", FE_SQL_OTHER, 63)):
        _, qs = _fe_queries(feats_np, count, seed)
        if op == "<->":
            # where an exact query's host time goes
            _, knn_top = _host_profile(lambda: _sql_knn(eng, "items", op, qs[0]))
        ids, dist, ms = zip(*(_sql_knn(eng, "items", op, q) for q in qs))
        knn_ms[op] = float(np.median(ms))
        # the exact top-10's ids: the flat index's (l2, cosine) or one
        # product on the card (inner product); their distances in float64
        # on the host, the tie limit 1e-5 of the largest
        if op == "<#>":
            t_ids = torch.topk(torch.from_numpy(qs).to(DEV) @ feats.T, IX_K,
                               dim=1).indices.cpu().numpy()
        else:
            t_ids, _ = (flat_l2 if op == "<->" else flat).search_batch(qs, k=IX_K)
        t_d = _sql_distances(feats_np[t_ids], qs, op)
        share_equal[op] = same_topk(f"SQL exact {op} vs the exact top-10", t_ids, t_d, ids, dist,
                                    1e-5 * max(1.0, float(np.abs(t_d).max())))

    # WHERE cluster = c: the exact top-10 of the cluster
    rows, qs = _fe_queries(feats_np, FE_SQL_WHERE, 64)
    where_ms, got, want = [], ([], []), ([], [])
    for r, q in zip(rows, qs):
        c = int(labels[r])
        ids, dist, ms = _sql_knn(eng, "items", "<->", q, f" WHERE cluster = {c}")
        where_ms.append(ms)
        members = np.nonzero(labels == c)[0]
        dm = torch.linalg.vector_norm(feats[members] - torch.from_numpy(q).to(DEV), dim=1)
        top = torch.topk(-dm, IX_K)
        got[0].append(ids)
        got[1].append(dist)
        want[0].append(members[top.indices.cpu().numpy()])
    want[1].extend(_sql_distances(feats_np[np.asarray(want[0])], qs, "<->"))
    same_topk("SQL WHERE cluster = c vs the cluster's exact top-10", *want, *got,
              1e-5 * max(1.0, float(np.abs(want[1]).max())))

    # the card's distance pass against a CPU engine's on the same table
    # (the limit is relative to the column's largest distance: a near
    # neighbour's <-> comes from |m|^2 - 2 m.q + |q|^2, terms ~100 times
    # its square, so its float32 error is ~1e-7 of |m|^2, not of itself)
    cpu_eng = SqlEngine(device="cpu")
    cpu_eng.tables["items"] = table
    cpu_rel, cpu_equal = 0.0, {}
    _, qs = _fe_queries(feats_np, FE_SQL_CPU, 66)
    ops = ["<->"] * (FE_SQL_CPU // 2) + ["<=>", "<#>"] * (FE_SQL_CPU // 4)
    for op in ("<->", "<=>", "<#>"):
        got, want = ([], []), ([], [])
        for q in qs[[i for i, o in enumerate(ops) if o == op]]:
            card = sql_mod._distance_column(table.vecs["embedding"], q, op, DEV)
            host = sql_mod._distance_column(table.vecs["embedding"], q, op, torch.device("cpu"))
            cpu_rel = max(cpu_rel, float(np.abs(card - host).max() / np.abs(host).max()))
            for out, e in ((got, eng), (want, cpu_eng)):
                ids, dist, _ = _sql_knn(e, "items", op, q)
                out[0].append(ids)
                out[1].append(dist)
        cpu_equal[op] = same_topk(f"SQL {op}: card vs CPU engine", *want, *got, 1e-5)
    if cpu_rel > 1e-5:
        raise AssertionError(f"SQL distances: card vs CPU {cpu_rel} of the largest, over 1e-5")

    # count, UPDATE and DELETE on a few rows
    t0 = time.perf_counter()
    changed = [eng.execute(f"UPDATE items SET cluster = -1 WHERE id = {rid}")
               for rid in (11, 22, 33)]
    update_ms = (time.perf_counter() - t0) * 1e3 / 3
    t0 = time.perf_counter()
    deleted = eng.execute("DELETE FROM items WHERE cluster = -1")
    delete_ms = (time.perf_counter() - t0) * 1e3
    counts = [eng.execute("SELECT count(*) FROM items")[0]["count"]]
    gone, _, _ = _sql_knn(eng, "items", "<->", feats_np[10])    # row 10 was id 11
    kept, _, _ = _sql_knn(eng, "items", "<->", feats_np[12])
    if changed != [1, 1, 1] or deleted != 3 or counts != [n - 3] or 10 in gone or kept[0] != 12:
        raise AssertionError(f"SQL UPDATE/DELETE: {changed}, {deleted}, {counts}, {gone}, {kept}")

    extra = {}
    if full:
        m = FE_SQL_INDEX_ROWS
        eng.execute(f"CREATE TABLE small (id serial, cluster int, embedding ruvector({d}))")
        for sql in _sql_insert_texts(feats_np, labels, "small", m):
            eng.execute(sql)
        _, qs = _fe_queries(feats_np[:m], FE_SQL_OTHER, 65)
        probe = f"SELECT id FROM small ORDER BY embedding <-> '{_vec_text(qs[0])}' LIMIT {IX_K}"
        plans = [eng.execute("EXPLAIN " + probe)[1]["plan"]]
        t0 = time.perf_counter()
        eng.execute("CREATE INDEX small_hnsw ON small USING hnsw (embedding vector_l2_ops)")
        index_s = time.perf_counter() - t0
        plans.append(eng.execute("EXPLAIN " + probe)[1]["plan"])
        if not (plans[0].startswith("batched device") and plans[1].startswith("hnsw index")):
            raise AssertionError(f"SQL plans before and after CREATE INDEX: {plans}")
        small = eng.tables["small"].vecs["embedding"]
        h_ids, h_ms, exact = [], [], []
        for q in qs:
            ids, _, ms = _sql_knn(eng, "small", "<->", q)
            h_ids.append(ids)
            h_ms.append(ms)
            dist = sql_mod._distance_column(small, q, "<->", DEV)
            exact.append(np.argsort(dist, kind="stable")[:IX_K])
        hnsw_recall = _recall(np.asarray(h_ids), np.asarray(exact), IX_K)
        if hnsw_recall < FE_RECALL_MIN:
            raise AssertionError(f"SQL HNSW route recall@10 {hnsw_recall} under {FE_RECALL_MIN}")
        t0 = time.perf_counter()
        job = eng.execute("SELECT ruvector_gnn_train('small', 1) AS job")[0]["job"]
        status = json.loads(eng.execute(f"SELECT ruvector_gnn_wait({job}, 900.0) AS s")[0]["s"])
        gnn_s = time.perf_counter() - t0
        model = json.loads(eng.execute("SELECT ruvector_gnn_model('small') AS m")[0]["m"])
        if status["status"] != "done" or not np.isfinite(status["loss"]) \
                or model["rows"] != m or model["param_count"] < 1:
            raise AssertionError(f"SQL GNN worker: {status}, {model}")
        _fe_sql_controls(eng, feats_np, d)
        knn_ms["hnsw <->"] = float(np.median(h_ms))
        extra = {"index_rows": m, "index_build_s": index_s, "hnsw_queries": len(qs),
                 "hnsw_recall_at_10": hnsw_recall, "gnn_train_s": gnn_s,
                 "gnn_loss": status["loss"], "gnn_param_count": model["param_count"]}
    eng.close()
    say("front_ends_sql", rows=n, d=d, statement_rows=FE_SQL_BATCH, text_s=text_s,
        insert_s=insert_s, insert_rows_per_s=n / insert_s, first_insert_host_top=insert_top,
        knn_ms=json.dumps(knn_ms), knn_host_top=knn_top, knn_queries=json.dumps({"<->": FE_SQL_L2, "<=>": FE_SQL_OTHER,
                                                           "<#>": FE_SQL_OTHER}),
        ids_equal_share=json.dumps(share_equal), where_queries=FE_SQL_WHERE,
        where_ms=float(np.median(where_ms)), cpu_queries=FE_SQL_CPU,
        cpu_max_err_of_scale=cpu_rel,
        cpu_ids_equal_share=json.dumps(cpu_equal),
        update_ms=update_ms, delete_ms=delete_ms, **extra)


def _fe_cli(feats_np: np.ndarray) -> None:
    """The CLI in this process on the card (its default device): the
    lifecycle on FE_CLI_ROWS rows, mincut on tests/test_cli.py's edge
    file, and `benchmark` at its defaults."""
    d = feats_np.shape[1]

    def run(*argv) -> str:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            cli_main(list(argv))
        return buf.getvalue()

    with tempfile.TemporaryDirectory() as tmp:
        vecs = feats_np[:FE_CLI_ROWS]
        np.save(f"{tmp}/v.npy", vecs)
        col = f"{tmp}/col"
        t0 = time.perf_counter()
        run("create", col, "--dim", str(d))
        inserted = run("insert", col, "--vectors", f"{tmp}/v.npy")
        info = json.loads(run("info", col))
        found = json.loads(run("search", col, "--query", json.dumps(vecs[5].tolist()),
                               "-k", "3").splitlines()[-1])
        run("export", col, f"{tmp}/e.npz")
        run("import", f"{tmp}/e.npz", f"{tmp}/col2")
        info2 = json.loads(run("info", f"{tmp}/col2"))
        run("graph-build", col, f"{tmp}/g.npz", "--k", "8")
        lifecycle_s = time.perf_counter() - t0
        g = np.load(f"{tmp}/g.npz")
        edges = f"{tmp}/edges.tsv"
        with open(edges, "w") as f:
            f.write("0 1 3\n1 2 3\n0 2 3\n3 4 3\n4 5 3\n3 5 3\n2 3 0.4\n")
        cut = json.loads(run("mincut", edges, "--json"))
        cut_st = json.loads(run("mincut", edges, "--source", "0", "--sink", "5", "--json"))
        t0 = time.perf_counter()
        bench = json.loads(run("benchmark").splitlines()[-1])
        bench_s = time.perf_counter() - t0
    ok = (f"inserted {FE_CLI_ROWS}" in inserted and info["points_count"] == FE_CLI_ROWS
          and info2["points_count"] == FE_CLI_ROWS and found["results"][0]["id"] == 5
          and found["results"][0]["score"] > 0.99 and g["nbr_idx"].shape == (FE_CLI_ROWS, 8)
          and abs(cut["value"] - 0.4) < 1e-6 and cut["cut_edges"] == [[2, 3]]
          and cut_st["mode"] == "s-t" and abs(cut_st["value"] - 0.4) < 1e-6)
    if not ok:
        raise AssertionError(f"CLI: {inserted!r}, {info}, {info2}, {found}, {cut}, {cut_st}")
    say("front_ends_cli", rows=FE_CLI_ROWS, lifecycle_s=lifecycle_s,
        self_match_score=found["results"][0]["score"], benchmark_rows=10_000,
        benchmark_queries=100, benchmark_s=bench_s, insert_per_s=bench["insert_per_s"],
        search_qps=bench["search_qps"], search_p50_ms=bench["search_p50_ms"])


def phase_front_ends(feats_np: np.ndarray, labels: np.ndarray, d: int, db: VectorDB,
                     full: bool = True) -> None:
    """The front ends on the card over the 100k corpus (`[front_ends]`):
    the HTTP server with `[index]`'s 100k collection and one filled by
    upserts, its searches, the concurrent storm, scroll, point GET,
    DELETE and /sql; the MCP server's search, train and four query modes;
    the SQL engine with the corpus loaded by INSERT text and its exact kNN
    by every operator; with `full` (the phase run alone), also MCP's
    min-cut tool, the SQL HNSW route, GNN worker and fault controls, and
    the CLI. The front ends launch none of the 13 kernels (their layers
    keep use_pallas=False, as in the JAX package): the phase checks it."""
    t_phase = time.perf_counter()
    flat = FlatIndex(dim=d, metric="cosine", device=DEV)
    flat.add_batch(feats_np)
    flat_l2 = FlatIndex(dim=d, metric="l2", device=DEV)
    flat_l2.add_batch(feats_np)

    def run():
        updb = _fe_http(db, feats_np, labels, flat)
        _fe_mcp(db, updb, feats_np, full)
        _fe_sql(feats_np, labels, flat, flat_l2, full)
        if full:
            _fe_cli(feats_np)

    _, counts = counted([], run)
    launched = {k: v for k, v in counts.items() if v}
    if launched:
        raise AssertionError(f"the front ends launched kernels: {launched}")
    say("front_ends_done", seconds=round(time.perf_counter() - t_phase, 1), full=full,
        kernel_launches=0)


def config5_config(d: int, heads: int) -> gated.GatedGraphTransformerConfig:
    """Config 5: dim 128, 4 heads, FFN x4, 2 layers, lam 0.5, eps 0.01,
    hysteresis band 0.05, budget nB/16, bf16 compute on f32 features."""
    return gated.GatedGraphTransformerConfig(
        dim=d, num_heads=heads, ffn_mult=4, num_layers=2, lam=0.5, eps=0.01,
        hysteresis_band=0.05, max_resolve_frac=1 / 16, compute_dtype="bfloat16")


def main() -> int:
    t_start = time.perf_counter()
    phase_device()
    phase_build()

    d, k, heads = 128, 16, 4
    cfg = RuvectorLayerConfig(d, d, heads=heads, compute_dtype="bfloat16")
    params = ruvector_layer_init(0, cfg, device=DEV)
    k1_f32_grade_err = phase_parity(params, cfg)
    gcfg = config5_config(d, heads)
    gparams = gated.gated_graph_transformer_init(0, gcfg, device=DEV)
    phase_gated_parity(gparams, gcfg)
    phase_train_parity(gparams, gcfg)
    phase_serve_parity()

    # --- main path: the bench's headline route ------------------------------
    t0 = time.perf_counter()
    feats_np, labels = bench_clusters(N_NODES, d)
    graph = build_knn_graph(feats_np, k=k, block=2048, device=DEV)
    torch.cuda.synchronize()
    t_knn = time.perf_counter() - t0
    t0 = time.perf_counter()
    perm, bdg, fpad = block_layout(feats_np, graph)
    t_layout = time.perf_counter() - t0
    edges = int(graph.nbr_mask.sum())
    say("graph", nodes=N_NODES, k=k, edges=edges, knn_s=round(t_knn, 3),
        layout_s=round(t_layout, 3), nB=bdg.n_blocks, B=bdg.block, T=bdg.table,
        halo_ok=bdg.table <= 2 * bdg.block)

    def main_path():
        x = fpad
        for _ in range(ITERS):
            x = ruvector_layer_apply_block_dense_fused(params, cfg, x, bdg)
        return x

    out, counts = counted(["block_dense_layer_fused"], main_path)
    launches = {"block_dense_layer_fused": counts["block_dense_layer_fused"]}
    if out.shape != fpad.shape or not bool(torch.isfinite(out).all()):
        raise AssertionError("main path output is not finite or has the wrong shape")
    one = ruvector_layer_apply_block_dense_fused(params, cfg, fpad, bdg)
    scan = ruvector_layer_apply_block_dense(params, cfg, fpad, bdg)
    agree("main path: fused layer vs scan route", one, scan, torch.bfloat16)
    layer_ms = time_ms(lambda: ruvector_layer_apply_block_dense_fused(params, cfg, fpad, bdg),
                       iters=10)
    say("main_path", launches=launches["block_dense_layer_fused"], layer_ms=layer_ms,
        edges_per_s=edges / (layer_ms * 1e-3))

    # --- the other kernel routes on the same graph ---------------------------
    k2_out, counts = counted(["block_dense_attention"], lambda: ruvector_layer_apply_block_dense(
        params, cfg, fpad, bdg, use_pallas=True))
    launches["block_dense_attention"] = counts["block_dense_attention"]
    agree("K2 route vs scan route", k2_out, scan, torch.bfloat16)
    k2_route_ms = time_ms(lambda: ruvector_layer_apply_block_dense(
        params, cfg, fpad, bdg, use_pallas=True), iters=10)
    say("k2_route", launches=launches["block_dense_attention"], body=k2_body(cfg.cdt),
        k2_route_ms=k2_route_ms, edges_per_s=edges / (k2_route_ms * 1e-3))

    cfg32 = RuvectorLayerConfig(d, d, heads=heads)
    cfg_k3 = RuvectorLayerConfig(d, d, heads=heads, use_pallas=True)
    feats = torch.from_numpy(feats_np).to(DEV)
    k3_out, counts = counted(["fused_neighbor_mix"],
                             lambda: ruvector_layer_apply(params, cfg_k3, feats, graph))
    launches["fused_neighbor_mix"] = counts["fused_neighbor_mix"]
    agree("K3 route vs slot route", k3_out,
          ruvector_layer_apply(params, cfg32, feats, graph), torch.float32)

    net_cfg = RuvectorNetConfig(input_dim=d, hidden_dim=d, num_layers=2, heads=heads)
    net_out = ruvector_net_apply(ruvector_net_init(0, net_cfg, device=DEV), net_cfg,
                                 feats, graph)
    if net_out.shape != (N_NODES, d) or not bool(torch.isfinite(net_out).all()):
        raise AssertionError("RuvectorNet output is not finite or has the wrong shape")
    say("ruvector_net", layers=2, nodes=N_NODES, d=d, heads=heads, finite=True)
    phase_gnn_family(feats, graph, d, heads)
    phase_attention_rest(feats, graph, d)
    phase_solver(graph)
    phase_graph_transformer_rest(feats, graph, perm[:GT_ROWS], d, heads)

    # --- config 5: the gated graph transformer's serving path ---------------
    with torch.no_grad():
        c5 = phase_config5(gparams, gcfg, d)
    launches.update(c5["launches"])

    # --- training: config 5's train step, the halo layout, the contrastive step
    train_launches = phase_config5_train(gparams, gcfg, c5)
    c5_halo = phase_config5_halo(gparams, gcfg)
    phase_halo_signature_control(c5_halo, gparams, gcfg)
    launches["gated_block_layer"] += train_launches["gated_block_layer"]
    for name in ("gated_block_attention_fwd", "gated_block_attention_bwd",
                 "block_gate_signature_x"):
        launches[name] = train_launches.get(name, 0) + c5_halo["launches"][name]
    launches["block_gate_signature"] = 0
    phase_contrastive(params, cfg, feats, graph)
    phase_sona(feats, graph, labels)
    phase_training_utils(params, cfg, gparams, feats_np, feats, graph, perm, fpad, bdg)

    # --- serving: the query engine, the re-rank (K8), the CSR SpMM path (K9)
    launches["fused_neighbor_mix"] += phase_serve(feats_np, feats, graph, d, heads)
    rr = phase_rerank(d)
    launches["flash_neighbor_attention"] = rr["launches"]
    phase_quantization(d)
    sp = phase_csr_spmm(d)
    launches["spmm_gather"] = sp["launches"]

    # --- the native runtime, the database, the property graph, min-cut -----
    phase_native(feats, graph, d)
    ix = phase_index(feats_np, feats, labels, d, heads)
    launches["fused_neighbor_mix"] += ix["launches"]
    launches["fused_neighbor_mix"] += phase_graph_store(feats_np, feats, labels, graph, d, heads)
    phase_mincut(graph, labels)
    phase_front_ends(feats_np, labels, d, ix.pop("db"), full=FE_FULL_IN_MAIN)
    peak_before = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    phase_transformer()
    say("transformer_memory", peak_mem_gb=round(torch.cuda.max_memory_allocated() / 1e9, 2))
    par = phase_parallel(feats_np, graph, d, heads, c5)

    # --- kernels at the main paths' shapes ------------------------------------
    report = []
    with torch.no_grad():
        # K1: the fused layer's own inputs
        msg = linear_apply(params["w_msg"], fpad)
        msgf = msg.reshape(bdg.n_blocks, bdg.block, d)
        halo = msg.to(cfg.cdt)[bdg.local_ids[:, bdg.block:].long()]
        L_tab = torch.cat([msgf.to(cfg.cdt), halo], dim=1).contiguous()
        folded = fold_layer_params(params, cfg)
        wd = bdg.wdense
        k1 = lambda: block_dense_layer_fused(L_tab, msgf, wd, folded, dropout=0.0,  # noqa: E731
                                             eps=cfg.eps)
        k1_ref = lambda: block_dense_layer_fused_reference(  # noqa: E731
            L_tab, msgf, wd, folded, dropout=0.0, eps=cfg.eps)
        n_edges = int((wd > 0).sum())
        rows = bdg.n_blocks * bdg.block
        k1b = k1_body(cfg.cdt)
        # the epilogue's float32 products: float32 grade on the tensor
        # cores (3xTF32) in the tensor-core body, float32 FMA in the other
        ops = {cfg.cdt: 2 * (2 * heads + 1) * d * n_edges,
               "tf32x3" if k1b == "tensor_core" else torch.float32:
                   2 * (2 * heads + 7) * d * d * rows}
        report.append(("block_dense_layer_fused", k1, k1_ref, _agree_as(cfg.cdt),
                       bound(nbytes(L_tab, msgf, wd, *folded.values()) + nbytes(msgf), ops),
                       {"body": k1b, "f32_grade_max_abs_err": k1_f32_grade_err,
                        "f32_grade_check": "one edge a row, wd = 1, bf16-valued table, "
                                           "B=504, T=1024, limits 1e-4 / 1e-5"}))

        # K2: the use_pallas block-dense route's inputs
        hd = d // heads
        q = linear_apply(params["attn"]["q"], msg).reshape(-1, heads, hd)
        wk = params["attn"]["k"]["kernel"].reshape(d, heads, hd)
        bk = params["attn"]["k"]["bias"].reshape(heads, hd)
        L_full = msg.to(cfg.cdt)[bdg.local_ids.long()].contiguous()
        u_hm = torch.einsum("nhf,dhf->hnd", q, wk).reshape(
            heads, bdg.n_blocks, bdg.block, d).to(cfg.cdt).contiguous()
        sb_hm = torch.einsum("nhf,hf->hn", q, bk).reshape(heads, bdg.n_blocks,
                                                          bdg.block).contiguous()
        k2 = lambda: block_dense_attention(L_full, u_hm, sb_hm, wd, scale=hd ** -0.5)  # noqa: E731
        k2_ref = lambda: block_dense_attention_reference(  # noqa: E731
            L_full, u_hm, sb_hm, wd, scale=hd ** -0.5)
        out_bytes = (heads + 1) * rows * d * 4
        report.append(("block_dense_attention", k2, k2_ref, _agree_as(cfg.cdt),
                       bound(nbytes(L_full, u_hm, sb_hm, wd) + out_bytes,
                             {cfg.cdt: 2 * (2 * heads + 1) * d * n_edges}),
                       {"body": k2_body(cfg.cdt), "strip_chunks_with_edges": tile_share(wd)}))

        # K3: the use_pallas slot route's inputs (f32 config)
        k3, k3_ref, k3_bound, k3_as_passed = _k3_at(params, feats, graph, heads)
        report.append(("fused_neighbor_mix", k3, k3_ref, _agree_as(torch.float32), k3_bound,
                       {"body": k3_body(heads, graph.max_degree, d),
                        "bound_ms_as_passed": k3_as_passed, **ix["k3"]}))
        report += config5_report(c5, gparams, gcfg)
        report += train_report(c5, c5_halo, gparams, gcfg)
        report += serve_report(rr, sp)

        lines = []
        for name, fn, ref, check, (bound_ms, bound_by), extra in report:
            want = ref()
            err = check(f"{name} at main-path shapes", fn(), want)
            ms = time_ms(fn, iters=10)
            plain_ms = time_ms(ref, iters=10, warmup=1)
            # beside it: calls back to back, the card's time without the
            # host's launch time where the card waits for it
            extra["kernel_ms"] = kernel_ms(fn)
            # the one PyTorch call that computes the same function, where
            # there is one: timed as a yardstick, never called by the port
            library = extra.pop("library", None)
            library_ms = None
            if library is not None:
                extra["library_max_abs_err"] = float((library().float() - want.float()).abs().max())
                library_ms = time_ms(library, iters=10)
            source, replaces = SOURCES[name]
            if launches[name] < 1 and name not in OFF_PATH:
                raise AssertionError(f"{name} was not launched on its path")
            extra["parallel_launches_per_rank"] = par["launches_per_rank"][name]
            lines.append({"name": name, "route": "cuda", "source": source,
                          "replaces": replaces, "launches": launches[name],
                          "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                          "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms,
                          **extra})
            say("kernel", name=name, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=library_ms, **extra)
            del want
    say("done", seconds=round(time.perf_counter() - t_start, 1),
        peak_mem_gb=round(max(peak_before, torch.cuda.max_memory_allocated()) / 1e9, 2))
    print(json.dumps({"kernels": lines}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


# the phases that run alone (`python3 chip_smoke.py solver
# graph_transformer_rest sona training_utils`, `python3 chip_smoke.py
# native index graph_store mincut`, `python3 chip_smoke.py parallel`): on
# the 100k-node graph, for iterating on them without the whole script;
# `training_utils` builds K1's source (its profiled layer), `index` and
# `graph_store` K3's, `parallel` config 5's four
PHASES_ALONE = ("solver", "graph_transformer_rest", "sona", "training_utils", "native",
                "index", "graph_store", "mincut", "parallel", "front_ends")


def phases_alone(names: list[str]) -> int:
    """Only the named phases of PHASES_ALONE, on the main path's graph."""
    unknown = sorted(set(names) - set(PHASES_ALONE))
    if unknown:
        raise SystemExit(f"chip_smoke: unknown phases {unknown}; these run alone: "
                         f"{', '.join(PHASES_ALONE)}")
    phase_device()
    d, k, heads = 128, 16, 4
    feats_np, labels = bench_clusters(N_NODES, d)
    graph = build_knn_graph(feats_np, k=k, block=2048, device=DEV)
    feats = torch.from_numpy(feats_np).to(DEV)
    perm, bdg, fpad = block_layout(feats_np, graph)
    if "solver" in names:
        phase_solver(graph)
    if "graph_transformer_rest" in names:
        phase_graph_transformer_rest(feats, graph, perm[:GT_ROWS], d, heads)
    if "sona" in names:
        phase_sona(feats, graph, labels)
    if {"index", "graph_store"} & set(names):
        say("build_sources", **{k: round(v, 1) for k, v in _lib.build(("neighbor_mix",)).items()})
    if "native" in names:
        phase_native(feats, graph, d)
    if "index" in names:
        phase_index(feats_np, feats, labels, d, heads, cpu_rerun=True)
    if "graph_store" in names:
        phase_graph_store(feats_np, feats, labels, graph, d, heads)
    if "mincut" in names:
        phase_mincut(graph, labels)
    if "front_ends" in names:
        _native_runtime()    # built before MCP's min-cut tool is timed
        # `[index]`'s database: the HNSW defaults, the serial insert, payloads
        db = VectorDB(DbOptions(dimensions=d), device=DEV)
        db.insert_batch(feats_np, payloads=[_fe_payload(i, labels) for i in range(len(labels))])
        phase_front_ends(feats_np, labels, d, db)
    if "parallel" in names:
        say("build_sources", **{k: round(v, 1) for k, v in _lib.build(PAR_SOURCES).items()})
        _native_runtime()
        phase_parallel(feats_np, graph, d, heads)
    if "training_utils" in names:
        say("build_sources", **{k: round(v, 1) for k, v in _lib.build(("block_dense_attn",)).items()})
        cfg = RuvectorLayerConfig(d, d, heads=heads, compute_dtype="bfloat16")
        phase_training_utils(ruvector_layer_init(0, cfg, device=DEV), cfg,
                             gated.gated_graph_transformer_init(0, config5_config(d, heads),
                                                                device=DEV),
                             feats_np, feats, graph, perm, fpad, bdg)
    return 0


if __name__ == "__main__":
    sys.exit(phases_alone(sys.argv[1:]) if sys.argv[1:] else main())
