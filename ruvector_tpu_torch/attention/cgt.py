"""The coherence-gated transformer (CGT), the full sheaf-attention stack
(port of ruvector_tpu/attention/cgt.py; reference ruvector-attention
src/sheaf/, ADR-015):

- router.rs       compute lanes (reflex / standard / deep / escalate),
                  threshold routing, lane statistics, feedback tuning
- sparse.rs       residual-threshold masks with min-connections, local
                  window and self keep; CSR export; sparsity statistics
- early_exit.rs   energy-based early exit: EMA smoothing, patience,
                  min/max layers, exit reasons, statistics

Routing is an int lane per token on the device; a lane selects its row's
pair mask within one dense [S, S] attention pass. The early exit loops on
the host, one sync a layer, where the JAX package runs a while_loop.
"""

from __future__ import annotations

import dataclasses
import enum

import numpy as np
import torch
import torch.nn.functional as F

from ruvector_tpu_torch.attention.sheaf import SheafAttentionConfig, edge_energies, sheaf_init
from ruvector_tpu_torch.convert import to_numpy
from ruvector_tpu_torch.device import resolve_device
from ruvector_tpu_torch.nn.core import linear_apply, linear_init, make_generator
from ruvector_tpu_torch.ops.quantization import true_div
from ruvector_tpu_torch.ops.segment import masked_softmax


# --------------------------------------------------------------------------
# Compute lanes and the token router (router.rs)
# --------------------------------------------------------------------------

class ComputeLane(enum.IntEnum):
    REFLEX = 0      # minimal compute: local attention, no FFN
    STANDARD = 1    # sparse sheaf attention
    DEEP = 2        # full sheaf attention + FFN
    ESCALATE = 3    # irreconcilable incoherence: passthrough + flag

    @property
    def description(self) -> str:
        return {
            ComputeLane.REFLEX: "minimal compute: local attention",
            ComputeLane.STANDARD: "standard: sparse sheaf attention",
            ComputeLane.DEEP: "deep: full sheaf + FFN",
            ComputeLane.ESCALATE: "escalate: return uncertainty",
        }[self]

    @property
    def typical_latency_ms(self) -> float:
        # router.rs:55-63 nominal lane costs
        return {0: 0.1, 1: 1.0, 2: 5.0, 3: 0.05}[int(self)]


@dataclasses.dataclass(frozen=True)
class TokenRouterConfig:
    """Energy thresholds (router.rs:87-188), strictly increasing."""

    theta_reflex: float = 0.1
    theta_standard: float = 1.0
    theta_deep: float = 10.0
    use_average_energy: bool = True   # normalise by the context size
    min_context_size: int = 1

    def validate(self) -> None:
        if not (0 < self.theta_reflex < self.theta_standard < self.theta_deep):
            raise ValueError("thresholds must satisfy 0 < reflex < standard < deep")


def route_by_energy(token_energy: torch.Tensor, cfg: TokenRouterConfig,
                    context_size: int | None = None) -> torch.Tensor:
    """[S] energies -> [S] int32 lanes, on the device (router.rs:266-338),
    the mean energy correctly rounded on every device."""
    e = token_energy
    if cfg.use_average_energy:
        e = true_div(e, max(context_size or e.shape[0], cfg.min_context_size))
    return ((e > cfg.theta_reflex).to(torch.int32) + (e > cfg.theta_standard).to(torch.int32)
            + (e > cfg.theta_deep).to(torch.int32))


@dataclasses.dataclass
class LaneStatistics:
    reflex_count: int = 0
    standard_count: int = 0
    deep_count: int = 0
    escalate_count: int = 0

    @property
    def total_tokens(self) -> int:
        return self.reflex_count + self.standard_count + self.deep_count + self.escalate_count

    def ratio(self, lane: ComputeLane) -> float:
        t = self.total_tokens
        c = [self.reflex_count, self.standard_count, self.deep_count,
             self.escalate_count][int(lane)]
        return c / t if t else 0.0

    @property
    def reflex_ratio(self) -> float:
        return self.ratio(ComputeLane.REFLEX)

    @property
    def standard_ratio(self) -> float:
        return self.ratio(ComputeLane.STANDARD)

    @property
    def deep_ratio(self) -> float:
        return self.ratio(ComputeLane.DEEP)

    def estimate_latency_ms(self) -> float:
        """router.rs:395-400: the sum of nominal lane costs."""
        return (self.reflex_count * 0.1 + self.standard_count * 1.0
                + self.deep_count * 5.0 + self.escalate_count * 0.05)


def lane_statistics(lanes) -> LaneStatistics:
    counts = np.bincount(to_numpy(lanes).reshape(-1).astype(np.int64), minlength=4)
    return LaneStatistics(*(int(c) for c in counts[:4]))


def tune_thresholds(cfg: TokenRouterConfig, stats: LaneStatistics,
                    target_reflex_ratio: float,
                    target_standard_ratio: float) -> TokenRouterConfig:
    """Feedback controller (router.rs:402-433): nudge the thresholds by 10%
    of the ratio error per call, clamped to keep their order."""
    if stats.total_tokens == 0:
        return cfg
    reflex_adj = (target_reflex_ratio - stats.reflex_ratio) * 0.1
    std_adj = (target_standard_ratio - stats.standard_ratio) * 0.1
    theta_reflex = min(max(cfg.theta_reflex * (1.0 + reflex_adj), 1e-3),
                       cfg.theta_standard * 0.9)
    theta_standard = min(max(cfg.theta_standard * (1.0 + std_adj), theta_reflex * 1.1),
                         cfg.theta_deep * 0.9)
    return dataclasses.replace(cfg, theta_reflex=theta_reflex, theta_standard=theta_standard)


# --------------------------------------------------------------------------
# Residual-sparse attention masks (sparse.rs)
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SparseResidualConfig:
    residual_threshold: float = 1.0   # keep pairs with energy at or above this
    max_sparsity: float = 0.99        # never fewer than (1 - max) S keys a row
    min_connections: int = 2          # top-energy fallback per query
    include_self: bool = True
    local_window: int | None = None

    def validate(self) -> None:
        if not 0.0 <= self.max_sparsity <= 1.0:
            raise ValueError("max_sparsity in [0, 1]")
        if self.residual_threshold < 0:
            raise ValueError("residual_threshold >= 0")


def residual_sparse_mask(energies: torch.Tensor, cfg: SparseResidualConfig) -> torch.Tensor:
    """[S, S] energies -> [S, S] bool keep mask (sparse.rs:298-386).

    Keeps the high-residual (incoherent) pairs, at least the row's
    k_floor = max(min_connections, ceil((1 - max_sparsity) S)) highest, the
    local window and self. Ties in the top-k: the floor is the k-th largest
    value, and every entry at or above it is kept (`>=`), so all entries
    tied with the k-th stay, as in JAX; torch.topk would keep exactly k.
    kthvalue gives the same order statistic as JAX's sort, without sorting.
    """
    s = energies.shape[0]
    e = torch.where(torch.isfinite(energies), energies,
                    torch.full_like(energies, -torch.inf))
    keep = e >= cfg.residual_threshold
    k_floor = max(int(cfg.min_connections), int(np.ceil((1.0 - cfg.max_sparsity) * s)))
    k_floor = min(max(k_floor, 1), s)
    kth = torch.kthvalue(e, s - k_floor + 1, dim=-1, keepdim=True).values   # k-th largest
    keep = keep | (e >= kth)
    idx = torch.arange(s, device=energies.device)
    if cfg.local_window is not None:
        keep = keep | ((idx[:, None] - idx[None, :]).abs() <= cfg.local_window)
    if cfg.include_self:
        keep = keep | (idx[:, None] == idx[None, :])
    return keep


@dataclasses.dataclass
class SparsityStatistics:
    n_queries: int
    n_keys: int
    nnz: int

    @property
    def total_pairs(self) -> int:
        return self.n_queries * self.n_keys

    @property
    def sparsity(self) -> float:
        return 1.0 - self.nnz / self.total_pairs if self.total_pairs else 0.0

    @property
    def estimated_speedup(self) -> float:
        """sparse.rs:538-544: the dense over the sparse work."""
        return self.total_pairs / max(self.nnz, 1)


def sparsity_statistics(mask) -> SparsityStatistics:
    m = to_numpy(mask)
    return SparsityStatistics(n_queries=m.shape[0], n_keys=m.shape[1], nnz=int(m.sum()))


def mask_to_csr(mask) -> tuple[np.ndarray, np.ndarray]:
    """sparse.rs:197-222: (row_ptr [S+1], col_idx [nnz])."""
    m = to_numpy(mask)
    rows, cols = np.nonzero(m)
    row_ptr = np.zeros(m.shape[0] + 1, np.int64)
    np.add.at(row_ptr, rows + 1, 1)
    return np.cumsum(row_ptr), cols.astype(np.int64)


# --------------------------------------------------------------------------
# Energy-based early exit (early_exit.rs)
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class EarlyExitConfig:
    epsilon: float = 1e-3       # relative energy-delta threshold
    min_layers: int = 1
    max_layers: int = 12
    patience: int = 2           # consecutive converged steps required
    ema_alpha: float = 0.3      # energy smoothing (1.0 = none)

    def validate(self) -> None:
        if self.epsilon <= 0:
            raise ValueError("epsilon > 0")
        if not 0 < self.min_layers <= self.max_layers:
            raise ValueError("0 < min_layers <= max_layers")
        if not 0.0 < self.ema_alpha <= 1.0:
            raise ValueError("ema_alpha in (0, 1]")


class ExitReason(enum.Enum):
    ENERGY_CONVERGED = "Energy converged below threshold"
    MAX_LAYERS_REACHED = "Reached maximum layer count"
    PERFECT_COHERENCE = "Achieved perfect coherence (zero energy)"


@dataclasses.dataclass
class EarlyExitResult:
    layers_used: int
    final_energy: float
    energy_delta: float
    converged_steps: int
    exit_reason: ExitReason

    @property
    def layers_saved(self) -> int:
        return 0  # filled by the statistics


@dataclasses.dataclass
class EarlyExitStatistics:
    layers_used: int
    max_layers: int
    energy_reduction: float
    final_energy: float

    @property
    def layers_saved(self) -> int:
        return self.max_layers - self.layers_used

    @property
    def speedup_ratio(self) -> float:
        return self.max_layers / max(self.layers_used, 1)


def run_with_early_exit(layer_fn, x: torch.Tensor, energy_fn, cfg: EarlyExitConfig):
    """Iterate x -> layer_fn(x) until the EMA-smoothed total energy
    converges (early_exit.rs:378-470).

    layer_fn: x -> x_next; energy_fn: x -> scalar energy tensor. The loop
    runs on the host, one sync a layer to read the exit decision, where JAX
    has a lax.while_loop; the EMA, delta and counters stay float32 / int32
    tensors on x's device, so the decisions are JAX's. Returns (x_final,
    layers_used int, final EMA energy, converged steps int, first energy)
    -- wrap with early_exit_result() for the ExitReason view.
    """
    cfg.validate()
    e0 = energy_fn(x)
    ema = e0
    conv = torch.zeros((), dtype=torch.int32, device=e0.device)
    i = 0
    while i < cfg.max_layers:
        x = layer_fn(x)
        e = energy_fn(x)
        ema2 = cfg.ema_alpha * e + (1.0 - cfg.ema_alpha) * ema
        delta = torch.abs(ema - ema2) / torch.clamp(torch.abs(ema), min=1e-8)
        conv = torch.where(delta < cfg.epsilon, conv + 1, torch.zeros_like(conv))
        done = (conv >= cfg.patience) | (e <= 0.0)
        ema = ema2
        i += 1
        if i >= cfg.min_layers and bool(done):
            break
    return x, i, ema, int(conv), e0


def early_exit_result(layers_used, final_energy, converged_steps, cfg: EarlyExitConfig,
                      first_energy=None) -> tuple[EarlyExitResult, EarlyExitStatistics]:
    n = int(layers_used)
    e = float(final_energy)
    conv = int(converged_steps)
    if e <= 0:
        reason = ExitReason.PERFECT_COHERENCE
    elif n >= cfg.max_layers and conv < cfg.patience:
        reason = ExitReason.MAX_LAYERS_REACHED
    else:
        reason = ExitReason.ENERGY_CONVERGED
    e0 = float(first_energy) if first_energy is not None else e
    red = (e0 - e) / max(abs(e0), 1e-8)
    return (EarlyExitResult(layers_used=n, final_energy=e, energy_delta=0.0,
                            converged_steps=conv, exit_reason=reason),
            EarlyExitStatistics(layers_used=n, max_layers=cfg.max_layers,
                                energy_reduction=red, final_energy=e))


# --------------------------------------------------------------------------
# The CGT block: lane-modulated sheaf attention (attention.rs + router.rs)
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class CgtConfig:
    dim: int = 64
    sheaf: SheafAttentionConfig = dataclasses.field(default_factory=SheafAttentionConfig)
    router: TokenRouterConfig = dataclasses.field(default_factory=TokenRouterConfig)
    sparse: SparseResidualConfig = dataclasses.field(default_factory=SparseResidualConfig)
    reflex_window: int = 4      # local-attention half-width for lane 0
    ffn_mult: int = 4


def cgt_init(seed, cfg: CgtConfig, device=None) -> dict:
    dev = resolve_device(device)
    g = make_generator(seed)
    sheaf_cfg = dataclasses.replace(cfg.sheaf, dim=cfg.dim, restriction_dim=cfg.dim)
    return {"sheaf": sheaf_init(g, sheaf_cfg, dev),
            "ffn_in": linear_init(g, cfg.dim, cfg.dim * cfg.ffn_mult, dev),
            "ffn_out": linear_init(g, cfg.dim * cfg.ffn_mult, cfg.dim, dev)}


def _finite_or(e: torch.Tensor, fill: float) -> torch.Tensor:
    return torch.where(torch.isfinite(e), e, torch.full_like(e, fill))


def cgt_block_apply(params: dict, cfg: CgtConfig, x: torch.Tensor):
    """One lane-modulated CGT layer over [S, D] token states.

    A row's pair mask follows its lane: reflex rows see a local band,
    standard rows the residual-sparse pairs, deep rows every pair, escalate
    rows themselves only and pass through (their attention output is
    zeroed). The FFN applies to deep rows only. Returns (x_out, lanes [S]
    int32, token_energy [S]).
    """
    s = x.shape[0]
    e = edge_energies(params["sheaf"], x)                        # [S, S]
    token_energy = torch.sum(_finite_or(e, 0.0), dim=-1)
    lanes = route_by_energy(token_energy, cfg.router, context_size=s)

    idx = torch.arange(s, device=x.device)
    band = (idx[:, None] - idx[None, :]).abs() <= cfg.reflex_window
    self_only = idx[:, None] == idx[None, :]
    sparse = residual_sparse_mask(e, cfg.sparse)
    lane = lanes[:, None]
    # the row's mask by lane: [band, sparse, all, self][lane]
    pair_mask = torch.where(lane == 0, band, torch.where(
        lane == 1, sparse, torch.where(lane == 2, torch.ones_like(band), self_only)))

    scores = -cfg.sheaf.beta * _finite_or(e, 1e30)
    attn = masked_softmax(scores, pair_mask.to(x.dtype), dim=-1)
    out = attn @ (x @ params["sheaf"]["rho_v"])
    out = torch.where(lane == 3, torch.zeros_like(out), out)   # escalate: passthrough
    x = x + out
    # jax.nn.gelu defaults to the tanh approximation; torch's default is erf
    ffn = linear_apply(params["ffn_out"],
                       F.gelu(linear_apply(params["ffn_in"], x), approximate="tanh"))
    x = x + torch.where(lane == 2, ffn, torch.zeros_like(ffn))
    return x, lanes, token_energy


def cgt_forward(params: dict, cfg: CgtConfig, x: torch.Tensor,
                exit_cfg: EarlyExitConfig | None = None):
    """The full CGT: lane-modulated layers under the energy early exit.

    Returns (x_final, layers_used, final EMA energy, converged steps, first
    energy, lanes of the final state); feed the scalars to
    early_exit_result().
    """
    exit_cfg = exit_cfg or EarlyExitConfig()

    def layer(xx):
        return cgt_block_apply(params, cfg, xx)[0]

    def energy(xx):
        return torch.sum(_finite_or(edge_energies(params["sheaf"], xx), 0.0))

    xf, layers_used, ema, conv, e0 = run_with_early_exit(layer, x, energy, exit_cfg)
    _, lanes, _ = cgt_block_apply(params, cfg, xf)
    return xf, layers_used, ema, conv, e0, lanes
