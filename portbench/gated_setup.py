"""What config 5's cells share: the graph, the port's layout, the weights
and the gate state made in set-up, and the reference's view of the same
inputs."""

from __future__ import annotations

import torch

from portbench import graphgen, program, roofline, weights
from portbench.harness import Cell, sync
from portbench.reference import gated as ref


class GatedCell(Cell):
    """Config 5 on a halo-free layout (a configuration file of
    model "gated_graph_transformer")."""

    def build(self) -> None:
        c, dev = self.config, self.device
        program.build("gated_graph_transformer", dev)
        self.mark("build")
        n, d = c["nodes"], c["dim"]
        feats, idx, ew = graphgen.cluster_graph(n, d, c["k"], c["cluster"], self.seed, dev)
        self.mark("graph")
        self.idx, self.ew = idx, ew
        table = getattr(torch, c["edge_table_dtype"])
        self.bdg, layout_s = program.layout(idx, ew, c["block"], table, dev)
        bdg = self.bdg
        self.nb, self.b = bdg.n_blocks, bdg.block
        if bdg.table != bdg.block or bdg.n != n:
            raise RuntimeError(f"{n} nodes in blocks of {c['block']} are not halo-free: "
                               f"nB={bdg.n_blocks} B={bdg.block} T={bdg.table}")
        self.feats = feats.to(getattr(torch, c["features_dtype"]))
        del feats
        self.base = bdg.pad_features(self.feats)
        self.params = weights.gated_params(self.seed, d, c["ffn_mult"], c["num_layers"], dev)
        self.mark("layout_weights")
        self.nodes = n
        self.setup_fields["layout_s"] = layout_s
        sync(dev)

    def ref_inputs(self):
        """The reference's own partitions and edge table (from the
        benchmark's neighbour lists) and its own padding of the benchmark's
        features."""
        wd, pad = ref.partitions(self.idx, self.ew, self.config["nodes"], self.config["block"])
        self.ref_nb, self.ref_b = wd.shape[0], wd.shape[1]
        self.ref_base = torch.zeros((self.ref_nb * self.ref_b, self.feats.shape[1]),
                                    dtype=self.feats.dtype, device=self.feats.device)
        self.ref_base[:self.feats.shape[0]] = self.feats
        return wd, pad

    def ref_features(self, step: int | None) -> torch.Tensor:
        """Step `step`'s features (None: the base) as [nb, B, D] for the
        reference: the same draw from the same seed as the window's."""
        x = self.ref_base if step is None else graphgen.drifted(
            self.ref_base, self.traffic["sigma"], self.seed, step)
        return x.reshape(self.ref_nb, self.ref_b, -1)

    def ref_config(self) -> dict:
        c = self.config
        return {k: c[k] for k in ("num_heads", "lam", "eps", "hysteresis_band")}

    def budget(self, nb: int) -> int:
        return max(1, int(nb * self.config["max_resolve_frac"]))

    def layer_bounds(self) -> tuple[float, float]:
        """K4b's and K4a's least seconds over every partition."""
        c = self.config
        args = (self.nb, self.b, c["dim"], c["num_heads"], c["ffn_mult"])
        return roofline.k4b_bound_s(*args), roofline.k4a_bound_s(*args)

    def init_masks(self, got_keep: torch.Tensor, want: dict) -> dict:
        """The gate state's initial masks against the reference's: the
        share of bits that differ and of partitions with any bit that
        differs (in any layer)."""
        differ = got_keep != want["keep"]
        parts = differ.flatten(2).any(dim=2).any(dim=0)
        return {"init_mask_bits": float(differ.sum()) / differ.numel(),
                "init_mask_parts": float(parts.sum()) / parts.numel()}


def precision(config: dict, control: bool) -> torch.dtype:
    """The configuration's compute type, or for the control the nearest
    below it (float8 e4m3 below bf16, bf16 below float32)."""
    cdt = getattr(torch, config["compute_dtype"])
    if not control:
        return cdt
    return torch.float8_e4m3fn if cdt == torch.bfloat16 else torch.bfloat16
