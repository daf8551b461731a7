"""Graph transformers: the partitioned min-cut-gated transformer (config 5)."""

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

__all__ = ["GatedGraphTransformerConfig", "check_gate_age_feasibility", "gate_state_init",
           "gated_graph_transformer_apply", "gated_graph_transformer_apply_with_masks",
           "gated_graph_transformer_init", "gated_graph_transformer_loss",
           "gated_graph_transformer_loss_with_masks", "gated_graph_transformer_step",
           "pack_keep", "unpack_keep"]
