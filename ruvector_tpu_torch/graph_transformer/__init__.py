"""Graph transformers (port of ruvector_tpu/graph_transformer): the
partitioned min-cut-gated transformer (config 5), the transformer block,
sublinear (LSH and PPR) attention, verified training with certificates,
and the physics, biological, self-organizing, manifold, temporal and
economic modules."""

from ruvector_tpu_torch.graph_transformer.sublinear import (
    SublinearConfig,
    lsh_bucket_assignments,
    lsh_bucket_attention,
    ppr_sampled_attention,
)
from ruvector_tpu_torch.graph_transformer.verified import (
    EnergyGateInvariant,
    LipschitzBound,
    LossStabilityBound,
    PermutationEquivariance,
    TrainingCertificate,
    TrainingInvariant,
    VerifiedTrainer,
    WeightNormBound,
)
from ruvector_tpu_torch.graph_transformer.block import (
    GraphTransformerConfig,
    graph_transformer_apply,
    graph_transformer_init,
)
from ruvector_tpu_torch.graph_transformer.physics import (
    HamiltonianGraphNet,
    PhysicsConfig,
    conservative_pde_attention,
    hamiltonian,
)
from ruvector_tpu_torch.graph_transformer.biological import (
    BiologicalConfig,
    SpikingGraphAttention,
    StdpConfig,
    hebbian_update,
    k_winners_take_all,
    stdp_update,
)
from ruvector_tpu_torch.graph_transformer.self_organizing import (
    DevelopmentalProgram,
    GraphCoarsener,
    MorphogeneticField,
    SelfOrganizingConfig,
)
from ruvector_tpu_torch.graph_transformer.manifold import (
    CurvatureAdaptiveRouter,
    RoutingWeights,
    estimate_ollivier_ricci,
    geodesic_message_passing,
    riemannian_adam_init,
    riemannian_adam_update,
)
from ruvector_tpu_torch.graph_transformer.temporal import (
    TemporalConfig,
    granger_causality,
    granger_matrix,
    temporal_attention,
    verify_causal_ordering,
)
from ruvector_tpu_torch.graph_transformer.economic import (
    IncentiveState,
    incentive_aligned_step,
    nash_attention,
    shapley_attention,
)
from ruvector_tpu_torch.graph_transformer.gated import (
    GatedGraphTransformerConfig,
    check_gate_age_feasibility,
    gate_state_init,
    gated_graph_transformer_apply,
    gated_graph_transformer_apply_with_masks,
    gated_graph_transformer_init,
    gated_graph_transformer_loss,
    gated_graph_transformer_loss_with_masks,
    gated_graph_transformer_step,
    pack_keep,
    unpack_keep,
)

__all__ = [
    "SublinearConfig",
    "lsh_bucket_attention",
    "ppr_sampled_attention",
    "lsh_bucket_assignments",
    "TrainingInvariant",
    "LossStabilityBound",
    "WeightNormBound",
    "LipschitzBound",
    "PermutationEquivariance",
    "EnergyGateInvariant",
    "VerifiedTrainer",
    "TrainingCertificate",
    "GraphTransformerConfig",
    "graph_transformer_init",
    "graph_transformer_apply",
    "PhysicsConfig",
    "HamiltonianGraphNet",
    "conservative_pde_attention",
    "hamiltonian",
    "BiologicalConfig",
    "SpikingGraphAttention",
    "StdpConfig",
    "stdp_update",
    "hebbian_update",
    "k_winners_take_all",
    "SelfOrganizingConfig",
    "MorphogeneticField",
    "DevelopmentalProgram",
    "GraphCoarsener",
    "CurvatureAdaptiveRouter",
    "RoutingWeights",
    "estimate_ollivier_ricci",
    "riemannian_adam_init",
    "riemannian_adam_update",
    "geodesic_message_passing",
    "TemporalConfig",
    "temporal_attention",
    "verify_causal_ordering",
    "granger_causality",
    "granger_matrix",
    "shapley_attention",
    "nash_attention",
    "IncentiveState",
    "incentive_aligned_step",
    "GatedGraphTransformerConfig",
    "check_gate_age_feasibility",
    "gate_state_init",
    "gated_graph_transformer_apply",
    "gated_graph_transformer_apply_with_masks",
    "gated_graph_transformer_init",
    "gated_graph_transformer_loss",
    "gated_graph_transformer_loss_with_masks",
    "gated_graph_transformer_step",
    "pack_keep",
    "unpack_keep",
]
