"""Config 5 serving while the embeddings drift: each step the features are
the base plus a fresh sigma N(0, 1) draw (made on the device, inside the
window), and `gated_graph_transformer_step` refreshes every node's output
under gates re-solved on a budget, from the state of the step before.

Checked after the window against the plain reference: the gate state's
start (every initial mask), and the steps drawn from the seed plus the
window's last, each from the state the program carried into it (the
reference follows the program step by step there): the output of every
judged row (`judged_rows`), the new masks, the new gate ages and the count
re-solved. `out_err_all` (the widest gap over every row) is read for
PERF.md and is not judged.
"""

from __future__ import annotations

import random

import torch

from portbench import graphgen, program, roofline
from portbench.gated_setup import GatedCell, precision
from portbench.harness import span, sync
from portbench.reference import gated as ref


class Cell(GatedCell):
    kind = "infer"
    spans = ("drift_input", "step")

    def setup(self) -> None:
        self.build()
        self.gcfg = program.gated_config(self.config, self.device)
        self.state = program.gate_state_init(self.params, self.gcfg, self.base, self.bdg)
        self.init_keep = self.state["keep"]
        self.mark("gate_init")
        rng = random.Random(graphgen.sub_seed(self.seed, graphgen.TAG_SAMPLE))
        self.sampled = {0, rng.randrange(1, self.traffic["sample_below"])}
        self.saved: dict = {}
        self.counters = {"resolved": 0, "steps": 0}
        for i in range(-self.traffic["warmup_steps"], 0):
            self.step(i)
        self.mark("warmup")
        self.counters = {"resolved": 0, "steps": 0}

    def step(self, i: int) -> None:
        with span("drift_input"):
            x = graphgen.drifted(self.base, self.traffic["sigma"], self.seed, i)
        with span("step"):
            out, state, n = program.gated_step(self.params, self.gcfg, x, self.bdg, self.state)
            sync(self.device)
        record = (i, self.state, out, state, n)
        if i in self.sampled:
            self.saved[i] = record
        self.last = record
        self.state = state
        self.counters["resolved"] += n
        self.counters["steps"] += 1

    def bounds(self) -> dict:
        k4b, k4a = self.layer_bounds()
        layers = self.config["num_layers"]
        return {"gated_layers": k4b * (layers - 1) + k4a}

    def model_ops(self) -> float:
        c = self.config
        return roofline.gated_forward_ops(self.nodes, self.b, c["dim"], c["ffn_mult"],
                                          c["num_layers"])

    def release(self) -> None:
        self.saved[self.last[0]] = self.last
        del self.bdg, self.state, self.base, self.last
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    @torch.no_grad()
    def check(self, control: bool = False) -> dict:
        rd_ref = ref.rounding(precision(self.config, False))
        rd_got = ref.rounding(precision(self.config, True)) if control else None
        cfg = self.ref_config()
        wd, pad = self.ref_inputs()
        budget = self.budget(wd.shape[0])
        b = wd.shape[1]
        x0 = self.ref_features(None)
        want = ref.init_state(self.params, cfg, x0, pad, wd, rd_ref)
        got_keep = (ref.init_state(self.params, cfg, x0, pad, wd, rd_got)["keep"] if control
                    else program.unpack_keep(self.init_keep, b))
        out = self.init_masks(got_keep, want)
        del want, got_keep
        err_max = err_all = err_sum = ref_sum = bits = bits_all = ages = ages_all = 0.0
        skipped = rows = 0
        gap = 0
        linked = wd != 0
        for i, before, y, after, n in self.saved.values():
            prior = {"keep": program.unpack_keep(before["keep"], b), "sig": before["sig"],
                     "age": before["age"]}
            x = self.ref_features(i)
            w_out, w_state, w_n = ref.step(self.params, cfg, x, pad, wd, prior, budget, rd_ref)
            if control:
                y, after, n = ref.step(self.params, cfg, x, pad, wd, prior, budget, rd_got)
                g_keep = after["keep"]
            else:
                g_keep = program.unpack_keep(after["keep"], b)
            gaps = (y.reshape(w_out.shape).float() - w_out).abs()
            err = gaps.amax(dim=2)
            judged = judged_rows(g_keep, w_state["keep"], linked)
            err_all = max(err_all, float(err.max()))
            if bool(judged.any()):
                err_max = max(err_max, float(err[judged].max()))
            skipped += int((~judged).sum())
            rows += judged.numel()
            err_sum += float(gaps.sum(dtype=torch.float64))
            del gaps
            ref_sum += float(w_out.abs().sum(dtype=torch.float64))
            bits += float((g_keep != w_state["keep"]).sum())
            bits_all += g_keep.numel()
            ages += float((after["age"].to(w_state["age"].dtype) != w_state["age"]).sum())
            ages_all += w_state["age"].numel()
            gap = max(gap, abs(int(n) - int(w_n)))
        out.update(out_err_max=err_max, out_err_all=err_all, out_err_mean=err_sum / ref_sum,
                   rows_skipped=skipped / rows, mask_bits=bits / bits_all,
                   age_diff=ages / ages_all, resolved_gap=gap)
        return out


def judged_rows(got_keep: torch.Tensor, want_keep: torch.Tensor,
                linked: torch.Tensor) -> torch.Tensor:
    """[nb, B] bool: the rows whose output has to agree with the
    reference's to rounding. A gate is a cut, and rounding upstream can
    flip an edge near eps or move a cut, after which the rows it touches
    differ by far more than rounding; the flips are judged by mask_bits.
    A row is judged where every earlier layer's masks agree in its whole
    partition (attention mixes every row of it), and in the last layer its
    own mask row and those of its neighbours in the edge table (`linked`
    [nb, B, B], the neighbour mix) agree."""
    early = (got_keep[:-1] == want_keep[:-1]).flatten(2).all(dim=2).all(dim=0)
    rowdiff = (got_keep[-1] != want_keep[-1]).any(dim=2)
    touched = rowdiff | (torch.matmul(linked.float(), rowdiff.float()[..., None])[..., 0] > 0)
    return early[:, None] & ~touched
