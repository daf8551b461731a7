"""Temporal graph transformer: causal attention and Granger causality
(port of ruvector_tpu/graph_transformer/temporal.py).

temporal_attention (temporal.rs:319) masks future positions to -inf;
verify_causal_ordering (:460) checks that the weights are lower
triangular; granger_causality (:389) compares the residual variances of
two least-squares VAR fits, taken as `jnp.linalg.lstsq` takes them: an
SVD, singular values below eps * max(m, n) * s_max dropped, in float32.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class TemporalConfig:
    max_lag: int = 4
    significance_ratio: float = 1.05   # var(restricted)/var(full) > this => causal


def temporal_attention(sequence):
    """Causal self-attention over [t, d] events: scores x x^T / sqrt(d)
    with future positions at -inf. Returns (output [t, d], weights [t, t])."""
    x = torch.as_tensor(sequence, dtype=torch.float32)
    t, d = x.shape
    scores = (x @ x.T) / torch.sqrt(torch.tensor(float(d), device=x.device))
    causal = torch.tril(torch.ones((t, t), dtype=torch.bool, device=x.device))
    w = torch.softmax(torch.where(causal, scores, torch.full_like(scores, -torch.inf)), dim=-1)
    return w @ x, w


def verify_causal_ordering(weights, atol: float = 1e-6) -> bool:
    """True iff no attention mass flows from the future (temporal.rs:460)."""
    w = weights.detach().cpu().numpy() if isinstance(weights, torch.Tensor) else \
        np.asarray(weights)
    return bool(np.all(np.triu(w, k=1) <= atol))


def _lag_matrix(series: torch.Tensor, max_lag: int):
    """[t] -> ([t - max_lag, max_lag] lagged predictors, [t - max_lag] targets)."""
    t = series.shape[0]
    rows = (torch.arange(t - max_lag, device=series.device)[:, None]
            + torch.arange(max_lag, device=series.device)[None, :])
    return series[rows], series[max_lag:]


def _lstsq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Least squares by SVD with jnp.linalg.lstsq's cut-off (rcond = eps *
    max(m, n) relative to the largest singular value)."""
    m, n = a.shape
    u, s, vt = torch.linalg.svd(a, full_matrices=False)
    rcond = float(torch.finfo(a.dtype).eps) * max(m, n)
    keep = (s > 0) & (s >= rcond * s[0])
    s_inv = torch.where(keep, 1.0 / torch.where(keep, s, torch.ones_like(s)),
                        torch.zeros_like(s))
    return vt.T @ (s_inv[:, None] * (u.T @ b[:, None]))[:, 0]


def granger_causality(x, y, max_lag: int = 4) -> tuple[float, bool]:
    """Does x Granger-cause y? (temporal.rs:389) Fits y_t ~ lags(y)
    (restricted) and y_t ~ lags(y) + lags(x) (full); returns (restricted
    over full residual variance, causal?)."""
    x = torch.as_tensor(x, dtype=torch.float32)
    y = torch.as_tensor(y, dtype=torch.float32).to(x.device)
    ylags, target = _lag_matrix(y, max_lag)
    xlags, _ = _lag_matrix(x, max_lag)
    ones = torch.ones((target.shape[0], 1), device=x.device)
    restricted = torch.cat([ones, ylags], dim=1)
    full = torch.cat([ones, ylags, xlags], dim=1)

    def resid_var(a):
        r = target - a @ _lstsq(a, target)
        return torch.mean(r * r)

    vr, vf = resid_var(restricted), resid_var(full)
    ratio = float(vr / torch.clamp(vf, min=1e-12))
    return ratio, ratio > TemporalConfig().significance_ratio


def granger_matrix(series, max_lag: int = 4) -> np.ndarray:
    """Pairwise Granger ratios for [k, t] series -> [k, k] (i causes j)."""
    k = series.shape[0]
    out = np.zeros((k, k))
    for i in range(k):
        for j in range(k):
            if i != j:
                out[i, j], _ = granger_causality(series[i], series[j], max_lag)
    return out
