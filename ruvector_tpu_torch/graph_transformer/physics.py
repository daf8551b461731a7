"""Physics-informed graph networks: Hamiltonian dynamics and a
conservative PDE (port of ruvector_tpu/graph_transformer/physics.py).

HamiltonianGraphNet (physics.rs:38-155) integrates node states (q, p)
under a graph Hamiltonian by leapfrog; its forces are
`torch.autograd.grad` of the scalar Hamiltonian (the JAX package's
`jax.grad`), so any energy form stays symplectic. The step loop is a
Python loop (JAX's `lax.scan`). conservative_pde_attention (:640) is
explicit Euler on dx/dt = -D L x, which conserves sum(x).
"""

from __future__ import annotations

import dataclasses

import torch

from ruvector_tpu_torch.graph.neighbors import NeighborGraph


@dataclasses.dataclass(frozen=True)
class PhysicsConfig:
    dt: float = 0.01
    coupling: float = 0.1       # strength of the graph potential
    mass: float = 1.0


def hamiltonian(q: torch.Tensor, p: torch.Tensor, graph: NeighborGraph,
                cfg: PhysicsConfig) -> torch.Tensor:
    """H = kinetic + on-site quartic + graph coupling (the spring energy
    over edges, each edge counted from both ends). A scalar."""
    kinetic = 0.5 * torch.sum(p * p) / cfg.mass
    onsite = torch.sum(0.25 * q ** 4)
    nbr_q = q[graph.nbr_idx.long()]                              # [n, m, d]
    spring = graph.nbr_mask[..., None] * (q[:, None, :] - nbr_q) ** 2
    return kinetic + onsite + 0.25 * cfg.coupling * torch.sum(spring)


def _grad(q, p, graph, cfg, wrt: int) -> torch.Tensor:
    """dH/dq (wrt 0) or dH/dp (wrt 1) at (q, p)."""
    with torch.enable_grad():
        args = [q.detach(), p.detach()]
        args[wrt].requires_grad_(True)
        return torch.autograd.grad(hamiltonian(*args, graph, cfg), args[wrt])[0]


class HamiltonianGraphNet:
    """Leapfrog (Stormer-Verlet) integrator over the graph Hamiltonian."""

    def __init__(self, config: PhysicsConfig = PhysicsConfig()):
        self.config = config

    def init_state(self, node_features):
        """q = features, p = 0 (physics.rs:102)."""
        q = torch.as_tensor(node_features, dtype=torch.float32)
        return q, torch.zeros_like(q)

    def forward(self, q, p, graph: NeighborGraph, steps: int = 10):
        """`steps` leapfrog steps; returns (q, p, energy trace [steps]).
        Symplectic: H is conserved to O(dt^2), and the energy trace is the
        drift certificate (physics.rs HamiltonianStepResult)."""
        cfg = self.config
        energies = []
        for _ in range(steps):
            p = p - 0.5 * cfg.dt * _grad(q, p, graph, cfg, 0)
            q = q + cfg.dt * _grad(q, p, graph, cfg, 1)
            p = p - 0.5 * cfg.dt * _grad(q, p, graph, cfg, 0)
            with torch.no_grad():
                energies.append(hamiltonian(q, p, graph, cfg))
        return q, p, torch.stack(energies)


def conservative_pde_attention(x: torch.Tensor, graph: NeighborGraph, diffusion: float = 0.1,
                               dt: float = 0.1, steps: int = 5):
    """Mass-conserving graph diffusion (physics.rs:640-688): explicit Euler
    on dx/dt = -D L x; sum(x) is invariant on a symmetric graph. Returns
    (x_out, mass drift), the drift ~0."""
    mass0 = torch.sum(x)
    deg = torch.sum(graph.nbr_mask, dim=1, keepdim=True)
    idx = graph.nbr_idx.long()
    for _ in range(steps):
        nbr = torch.sum(graph.nbr_mask[..., None] * x[idx], dim=1)
        x = x - dt * diffusion * (deg * x - nbr)
    return x, torch.sum(x) - mass0
