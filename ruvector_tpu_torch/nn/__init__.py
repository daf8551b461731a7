"""Neural building blocks and the RuvectorLayer."""

from ruvector_tpu_torch.nn.core import (
    gru_apply,
    gru_init,
    he_normal,
    layer_norm_apply,
    layer_norm_init,
    linear_apply,
    linear_init,
    mha_apply,
    mha_init,
    xavier_normal,
)
from ruvector_tpu_torch.nn.ruvector_layer import (
    RuvectorLayerConfig,
    ruvector_layer_apply,
    ruvector_layer_init,
)

__all__ = [
    "linear_init", "linear_apply", "layer_norm_init", "layer_norm_apply",
    "mha_init", "mha_apply", "gru_init", "gru_apply", "xavier_normal",
    "he_normal", "RuvectorLayerConfig", "ruvector_layer_init",
    "ruvector_layer_apply",
]
