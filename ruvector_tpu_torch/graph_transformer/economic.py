"""Economic graph attention: Shapley attribution, Nash-style equilibria,
incentive-aligned message passing (port of
ruvector_tpu/graph_transformer/economic.py).

shapley_attention (economic.rs:269-310) averages, over random
permutations, each node's marginal value when it joins the prefix
coalition; every coalition's value is a masked attention read-out, and
all of them are one batched computation. The permutations are
`jax.random.permutation` draws in the JAX package: the port takes them as
an argument, or draws its own from a seeded CPU generator.
nash_attention (:31-71) is damped best response in a congestion game;
incentive_aligned_step (:440-487) is stake-weighted message passing with
slashing.
"""

from __future__ import annotations

import dataclasses
import math

import torch


def _coalition_value(x: torch.Tensor, query: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Value of coalitions mask [..., n]: the cosine between the query and
    the attention read-out over the member nodes (0 for the empty one)."""
    d = x.shape[-1]
    scores = (x @ query) / torch.sqrt(torch.tensor(float(d), device=x.device))
    members = mask > 0
    w = torch.softmax(torch.where(members, scores, torch.full_like(mask, -math.inf)), dim=-1)
    w = torch.where(torch.any(members, dim=-1, keepdim=True), w, torch.zeros_like(w))
    read = w @ x
    return (read @ query) / (torch.linalg.vector_norm(read, dim=-1)
                             * torch.linalg.vector_norm(query) + 1e-9)


def shapley_permutations(n: int, num_permutations: int = 32, seed: int = 0) -> torch.Tensor:
    """[P, n] random permutations from a seeded CPU generator."""
    g = torch.Generator().manual_seed(int(seed))
    return torch.stack([torch.randperm(n, generator=g) for _ in range(num_permutations)])


def shapley_attention(x: torch.Tensor, query: torch.Tensor, permutations=None,
                      num_permutations: int = 32, seed: int = 0) -> torch.Tensor:
    """Monte-Carlo Shapley values phi [n] (economic.rs:310): for each
    permutation (rows of `permutations` [P, n], else
    shapley_permutations(n, num_permutations, seed)), phi_i averages the
    marginal value of adding node i to the prefix coalition. Efficiency
    holds for every permutation: sum(phi) = v(all) - v(empty)."""
    n = x.shape[0]
    if permutations is None:
        permutations = shapley_permutations(n, num_permutations, seed)
    perms = torch.as_tensor(permutations).to(device=x.device, dtype=torch.long)   # [P, n]
    pos = torch.argsort(perms, dim=1)                      # node -> position
    j = torch.arange(n, device=x.device)
    before = (pos[:, None, :] < j[None, :, None]).to(x.dtype)     # [P, j, node]
    after = (pos[:, None, :] <= j[None, :, None]).to(x.dtype)
    margins = _coalition_value(x, query, after) - _coalition_value(x, query, before)   # [P, j]
    phi = torch.zeros_like(margins).scatter_(1, perms, margins)
    return torch.mean(phi, dim=0)


def nash_attention(x: torch.Tensor, stakes: torch.Tensor, temperature: float = 1.0,
                   iters: int = 20):
    """Iterated best response (economic.rs:31-71): each node allocates its
    attention for affinity minus congestion, where congestion is the total
    attention a target receives; a damped response converges near a Nash
    equilibrium. Returns (allocation [n, n], payoffs [n])."""
    n, d = x.shape
    affinity = (x @ x.T) / torch.sqrt(torch.tensor(float(d), device=x.device))
    affinity = affinity * stakes[None, :]
    alloc = torch.full((n, n), 1.0 / n, dtype=x.dtype, device=x.device)
    for _ in range(iters):
        congestion = torch.sum(alloc, dim=0, keepdim=True)      # demand per target
        best = torch.softmax((affinity - congestion) / temperature, dim=-1)
        alloc = 0.5 * alloc + 0.5 * best
    payoffs = torch.sum(alloc * (affinity - torch.sum(alloc, dim=0, keepdim=True)), dim=1)
    return alloc, payoffs


@dataclasses.dataclass
class IncentiveState:
    stakes: torch.Tensor        # [n] >= 0


def incentive_aligned_step(x: torch.Tensor, graph_nbr_idx: torch.Tensor,
                           graph_nbr_mask: torch.Tensor, state: IncentiveState,
                           min_stake: float = 0.1, slash_fraction: float = 0.5):
    """Stake-weighted message passing with slashing (economic.rs:440-487):
    nodes whose message strays more than two standard deviations past the
    mean distance from their peers' consensus are slashed; stakes below
    min_stake stop contributing. Returns (consensus, new state, slashed)."""
    stakes = state.stakes
    idx = graph_nbr_idx.long()
    active = (stakes >= min_stake).to(torch.float32)
    w = graph_nbr_mask * active[idx] * stakes[idx]
    denom = torch.clamp(torch.sum(w, dim=1, keepdim=True), min=1e-9)
    consensus = torch.sum(w[..., None] * x[idx], dim=1) / denom
    dev = torch.linalg.vector_norm(x - consensus, dim=-1)
    slashed = dev > torch.mean(dev) + 2.0 * torch.std(dev, correction=0)
    new_stakes = torch.where(slashed, stakes * (1.0 - slash_fraction), stakes)
    return consensus, IncentiveState(stakes=new_stakes), slashed
