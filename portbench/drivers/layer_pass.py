"""The RuvectorLayer refreshing a whole graph: each pass the features are
the base plus a fresh sigma N(0, 1) draw in the IO type (made on the
device before the pass, inside the window), and one call of
`ruvector_layer_apply_block_dense_fused` updates every node.

Checked after the window against the plain reference on the neighbour
lists: the window's last pass over every node, and from every pass the
output blocks drawn from the seed for it.
"""

from __future__ import annotations

import random

import torch

from portbench import graphgen, program, roofline, weights
from portbench.gated_setup import precision
from portbench.harness import Cell as BaseCell
from portbench.harness import span, sync
from portbench.reference import gated as ref_gated
from portbench.reference import ruvector_layer as ref


class Cell(BaseCell):
    kind = "infer"
    spans = ("pass_input", "pass")

    def setup(self) -> None:
        c, dev = self.config, self.device
        program.build("ruvector_layer", dev)
        self.mark("build")
        n, d = c["nodes"], c["input_dim"]
        feats, idx, ew = graphgen.cluster_graph(n, d, c["k"], c["cluster"], self.seed, dev)
        self.mark("graph")
        self.idx, self.ew = idx, ew
        self.io = getattr(torch, c["io_dtype"])
        table = getattr(torch, c["edge_table_dtype"])
        self.bdg, layout_s = program.layout(idx, ew, c["block"], table, dev)
        bdg = self.bdg
        if bdg.table != bdg.block:
            raise RuntimeError(f"blocks of {c['block']} have a halo: T={bdg.table}")
        self.nb, self.b = bdg.n_blocks, bdg.block
        self.feats = feats.to(self.io)
        del feats
        self.base = bdg.pad_features(self.feats)
        self.params = weights.ruvector_params(self.seed, d, c["hidden_dim"], dev)
        self.lcfg = program.layer_config(c)
        self.mark("layout_weights")
        self.nodes = n
        self.setup_fields["layout_s"] = layout_s
        rng = random.Random(graphgen.sub_seed(self.seed, graphgen.TAG_SAMPLE))
        self.per_pass = self.traffic["sample_blocks"]
        self.sampled = {}
        for i in range(-self.traffic["warmup_steps"], 0):
            self.step(i)
        self.mark("warmup")
        self.rng = rng
        self.sampled = {}

    def step(self, i: int) -> None:
        with span("pass_input"):
            x = graphgen.drifted(self.base, self.traffic["sigma"], self.seed, i)
        with span("pass"):
            out = program.layer_pass(self.params, self.lcfg, x, self.bdg, self.io)
            sync(self.device)
        self.last = (i, out)
        if i >= 0:
            blocks = sorted(self.rng.sample(range(self.nb), min(self.per_pass, self.nb)))
            rows = out.reshape(self.nb, self.b, -1)[blocks]
            self.sampled[i] = (blocks, rows)

    def bounds(self) -> dict:
        c = self.config
        io_bytes = torch.finfo(self.io).bits // 8
        return {"k1": roofline.k1_bound_s(self.nb, self.b, c["hidden_dim"], c["heads"],
                                          self.nodes * c["k"], io_bytes)}

    def model_ops(self) -> float:
        c = self.config
        return roofline.ruvector_layer_ops(self.nodes, c["input_dim"], c["hidden_dim"], c["k"])

    def release(self) -> None:
        del self.bdg, self.base
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    @torch.no_grad()
    def check(self, control: bool = False) -> dict:
        c = self.config
        n, b, heads = c["nodes"], c["block"], c["heads"]
        cdt = precision(c, False)
        wn = torch.from_numpy(ref_gated.normalized_weights(self.ew.cpu().numpy())).to(
            self.device)
        stats: dict = {}

        def judge(step: int, rows: torch.Tensor, got: torch.Tensor) -> None:
            x = self._padded_draw(step)
            if control:
                msg = ref.messages(self.params, x, precision(c, True))
                got = torch.cat([ref.apply_rows(self.params, msg, self.idx, wn,
                                                rows[s:s + ref.ROWS], heads,
                                                precision(c, True))
                                 for s in range(0, rows.numel(), ref.ROWS)])
            ref.compare_rows(self.params, x, self.idx, wn, rows, got, heads, cdt, stats)

        for i, (blocks, got) in self.sampled.items():
            rows = (torch.tensor(blocks, device=self.device)[:, None] * b
                    + torch.arange(b, device=self.device)).reshape(-1)
            real = rows < n
            judge(i, rows[real], got.reshape(-1, got.shape[-1])[real])
        i, out = self.last
        judge(i, torch.arange(n, device=self.device), out[:n])
        return {"out_err_max": stats["max_abs"],
                "out_err_mean": stats["sum_abs"] / stats["sum_ref"]}

    def _padded_draw(self, step: int) -> torch.Tensor:
        """Step `step`'s features of the real nodes: the draw is made over
        whole blocks of rows, as the window's was."""
        n, b = self.config["nodes"], self.config["block"]
        base = torch.zeros((-(-n // b) * b, self.feats.shape[1]), dtype=self.feats.dtype,
                           device=self.feats.device)
        base[:self.feats.shape[0]] = self.feats
        return graphgen.drifted(base, self.traffic["sigma"], self.seed, step)[:self.feats.shape[0]]
