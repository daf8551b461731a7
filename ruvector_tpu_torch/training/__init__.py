"""Training: losses, optimizers, schedules, EWC, replay, the contrastive
train step, negative mining and curricula (`mining`), the background job
worker (`worker`) and the training metrics (`metrics_hook`); port of
ruvector_tpu/training."""

from ruvector_tpu_torch.training.ewc import (
    EWCState,
    ewc_compute_fisher,
    ewc_consolidate,
    ewc_fisher_from_batch,
    ewc_gradient,
    ewc_init,
    ewc_penalty,
)
from ruvector_tpu_torch.training.losses import (
    batched_info_nce,
    binary_cross_entropy_loss,
    cross_entropy_loss,
    info_nce_loss,
    local_contrastive_loss,
    mse_loss,
)
from ruvector_tpu_torch.training.metrics_hook import TrainingMetrics
from ruvector_tpu_torch.training.optimizers import (
    Optimizer,
    adam,
    adamw,
    apply_updates,
    make_optimizer,
    sgd,
)
from ruvector_tpu_torch.training.replay import ReplayBuffer, ReplayEntry
from ruvector_tpu_torch.training.schedulers import (
    ReduceOnPlateau,
    constant_schedule,
    cosine_annealing_schedule,
    exponential_schedule,
    make_schedule,
    step_decay_schedule,
    warmup_linear_schedule,
)
from ruvector_tpu_torch.training.train import (
    OnlineConfig,
    TrainConfig,
    contrastive_loss_fn,
    make_online_update,
    make_train_step,
    sample_negatives,
    sgd_step,
    train_epoch,
)

__all__ = [
    "EWCState", "OnlineConfig", "Optimizer", "ReduceOnPlateau", "ReplayBuffer", "ReplayEntry",
    "TrainConfig", "TrainingMetrics", "adam", "adamw", "apply_updates", "batched_info_nce",
    "binary_cross_entropy_loss", "constant_schedule", "contrastive_loss_fn",
    "cosine_annealing_schedule", "cross_entropy_loss", "ewc_compute_fisher", "ewc_consolidate",
    "ewc_fisher_from_batch", "ewc_gradient", "ewc_init", "ewc_penalty", "exponential_schedule",
    "info_nce_loss", "local_contrastive_loss", "make_online_update", "make_optimizer",
    "make_schedule", "make_train_step", "mse_loss", "sample_negatives", "sgd", "sgd_step",
    "step_decay_schedule", "train_epoch", "warmup_linear_schedule",
]
