"""Speculative decoding with draft trees and tree-attention masks (port of
ruvector_tpu/transformer/speculative.py; numpy).

Reference: ruvector-mincut-gated-transformer/src/speculative.rs —
SpeculativeConfig (:46-70), DraftToken/DraftTree with root-to-leaf paths
(:73-160), tree attention mask generation, verification (accept longest
prefix agreeing with target model, λ-guided acceptance threshold).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ruvector_tpu_torch.transformer.packets import GatePacket


@dataclasses.dataclass(frozen=True)
class SpeculativeConfig:
    max_draft_tokens: int = 5
    tree_width: int = 3
    acceptance_threshold: float = 0.7
    use_lambda_guidance: bool = True


@dataclasses.dataclass
class DraftToken:
    token_id: int
    confidence: float
    parent_idx: int | None
    depth: int


@dataclasses.dataclass
class DraftTree:
    tokens: list[DraftToken] = dataclasses.field(default_factory=list)
    paths: list[list[int]] = dataclasses.field(default_factory=list)

    def add(self, token_id: int, confidence: float, parent_idx: int | None) -> int:
        depth = 0 if parent_idx is None else self.tokens[parent_idx].depth + 1
        self.tokens.append(DraftToken(token_id, confidence, parent_idx, depth))
        return len(self.tokens) - 1

    def max_depth(self) -> int:
        return max((t.depth for t in self.tokens), default=0)

    def tokens_at_depth(self, depth: int) -> list[int]:
        return [i for i, t in enumerate(self.tokens) if t.depth == depth]

    def build_paths(self):
        """Root-to-leaf paths (speculative.rs:121-160)."""
        self.paths = []
        parents = {t.parent_idx for t in self.tokens if t.parent_idx is not None}
        for leaf in range(len(self.tokens)):
            if leaf in parents:
                continue
            path, cur = [], leaf
            while cur is not None:
                path.append(cur)
                cur = self.tokens[cur].parent_idx
            self.paths.append(path[::-1])


def generate_tree_attention_mask(tree: DraftTree) -> np.ndarray:
    """[T, T] bool — token i attends j iff j is an ancestor of i (or i==j).

    This is the standard tree-attention causal structure: each draft path is
    causally consistent while siblings never see each other.
    """
    n = len(tree.tokens)
    mask = np.zeros((n, n), bool)
    for i in range(n):
        cur: int | None = i
        while cur is not None:
            mask[i, cur] = True
            cur = tree.tokens[cur].parent_idx
    return mask


@dataclasses.dataclass
class VerificationResult:
    accepted_tokens: list[int]
    num_accepted: int
    accepted_path: list[int]


class SpeculativeDecoder:
    """Verify a draft tree against target-model argmax (speculative.rs:178+).

    λ-guidance: when coherence is unstable (big λ drop), raise the
    acceptance threshold so fewer speculative tokens survive.
    """

    def __init__(self, config: SpeculativeConfig = SpeculativeConfig()):
        self.config = config

    def effective_threshold(self, gate: GatePacket | None) -> float:
        t = self.config.acceptance_threshold
        if gate is not None and self.config.use_lambda_guidance:
            drop = gate.drop_ratio_q15() / 32768.0
            t = min(t + 0.5 * drop, 0.99)
        return t

    def verify(
        self,
        tree: DraftTree,
        target_logits: np.ndarray,       # [T, vocab] target model logits per node
        gate: GatePacket | None = None,
    ) -> VerificationResult:
        """Accept the longest path prefix where (a) the draft token matches
        the target argmax at its parent position and (b) draft confidence
        clears the (λ-adjusted) threshold."""
        tree.build_paths()
        thresh = self.effective_threshold(gate)
        best: list[int] = []
        for path in tree.paths:
            accepted = []
            for idx in path:
                tok = tree.tokens[idx]
                if tok.confidence < thresh:
                    break
                parent = tok.parent_idx
                check_pos = parent if parent is not None else idx
                if int(np.argmax(target_logits[check_pos])) != tok.token_id:
                    break
                accepted.append(idx)
            if len(accepted) > len(best):
                best = accepted
        return VerificationResult(
            accepted_tokens=[tree.tokens[i].token_id for i in best],
            num_accepted=len(best),
            accepted_path=best,
        )
