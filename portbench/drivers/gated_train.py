"""Config 5's full-graph train step: the loss of
`gated_graph_transformer_loss_with_masks` against zero targets under the
masks that `gate_state_init` solved in set-up, its gradient
(torch.autograd.grad), then w - lr g, with remat on. Each step's features
are the base plus a fresh sigma N(0, 1) draw, so that no two steps see the
same rows; the host reads every step's loss, as a training job logs it.

Set-up drives the same step object through its first three steps, through
the window's own call, and the window continues from there. Checked after
the window against the plain reference, which follows those three steps
from the same weights: the initial masks, each step's loss, the first
gradient (from the weights after one step), and the change of the weights
after three, each norm taken leaf by leaf.
"""

from __future__ import annotations

import statistics

import torch

from portbench import graphgen, program, roofline
from portbench.gated_setup import GatedCell, precision
from portbench.harness import span, sync
from portbench.reference import gated as ref

CHECKED_STEPS = 3


class Cell(GatedCell):
    kind = "train"
    spans = ("train_input", "step", "loss_read")

    def setup(self) -> None:
        self.build()
        self.gcfg = program.gated_config(self.config, self.device, remat=True)
        state = program.gate_state_init(self.params, self.gcfg, self.base, self.bdg)
        self.keep = state["keep"]
        del state
        self.mark("gate_init")
        self.zeros = torch.zeros_like(self.base)
        self.lr = self.traffic["lr"]
        self.ws = [w.clone() for w in ref.leaves(self.params)]
        self.w0 = [w.clone() for w in self.ws]
        self.losses = []
        self.first = 0          # the window's steps continue the draws after these
        for i in range(CHECKED_STEPS):
            self.step(i)
            if i == 0:
                self.w1 = [w.clone() for w in self.ws]
            self.mark(f"step{i}")
        self.w3 = [w.clone() for w in self.ws]
        self.first = CHECKED_STEPS

    def step(self, i: int) -> None:
        i += self.first
        with span("train_input"):
            x = graphgen.drifted(self.base, self.traffic["sigma"], self.seed, i)
        with span("step"):
            ws = [w.detach().requires_grad_(True) for w in self.ws]
            loss = program.gated_loss(ref.with_leaves(self.params, ws), self.gcfg, x, self.bdg,
                                      self.keep, self.zeros)
            grads = torch.autograd.grad(loss, ws)
            with torch.no_grad():
                self.ws = [w - self.lr * g for w, g in zip(self.ws, grads)]
        with span("loss_read"):
            value = float(loss.detach())
            sync(self.device)
        if len(self.losses) < CHECKED_STEPS:
            self.losses.append(value)

    def bounds(self) -> dict:
        c = self.config
        nb, b, d, h, f = self.nb, self.b, c["dim"], c["num_heads"], c["ffn_mult"]
        per_layer = (roofline.k4a_bound_s(nb, b, d, h, f) + roofline.k5a_bound_s(nb, b, d, h)
                     + roofline.k5b_bound_s(nb, b, d, h))
        return {"gated_layers": c["num_layers"] * per_layer}

    def model_ops(self) -> float:
        c = self.config
        return roofline.gated_train_ops(self.nodes, self.b, c["dim"], c["ffn_mult"],
                                        c["num_layers"])

    def release(self) -> None:
        del self.bdg, self.base, self.zeros, self.ws
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self, control: bool = False) -> dict:
        rd_ref = ref.rounding(precision(self.config, False))
        cfg = self.ref_config()
        wd, pad = self.ref_inputs()
        x0 = self.ref_features(None)
        want_init = ref.init_state(self.params, cfg, x0, pad, wd, rd_ref)
        xs = [self.ref_features(i) for i in range(CHECKED_STEPS)]
        w_losses, w_grad, w_ws = ref.train(self.params, cfg, xs, pad, wd, want_init["keep"],
                                           self.lr, rd_ref)
        if control:
            rd_got = ref.rounding(precision(self.config, True))
            got_init = ref.init_state(self.params, cfg, x0, pad, wd, rd_got)
            got_keep = got_init["keep"]
            losses, grad, ws = ref.train(self.params, cfg, xs, pad, wd, got_keep, self.lr,
                                         rd_got)
        else:
            got_keep = program.unpack_keep(self.keep, wd.shape[1])
            losses = self.losses
            grad = [(a - b) / self.lr for a, b in zip(self.w0, self.w1)]
            ws = self.w3
        out = self.init_masks(got_keep, want_init)
        out["loss_gap"] = max(abs(g - w) / abs(w) for g, w in zip(losses, w_losses))
        counted = counted_leaves(w_grad)
        out["grad_gap"] = leaf_gap(grad, w_grad, counted)
        out["change_gap"] = leaf_gap([w - w0 for w, w0 in zip(ws, self.w0)],
                                     [w - w0 for w, w0 in zip(w_ws, self.w0)], counted)
        return out


def _norms(ts) -> list[float]:
    return [float(torch.linalg.vector_norm(t.double())) for t in ts]


def counted_leaves(ref_grad) -> list[bool]:
    """Leaves whose reference gradient is not nought to rounding: its norm
    at least a thousandth of the median leaf's (a leaf under it moves by
    round-off alone)."""
    norms = _norms(ref_grad)
    med = statistics.median(norms)
    return [n >= 1e-3 * med for n in norms]


def leaf_gap(got, want, counted) -> float:
    """The worst counted leaf's gap between the two norms, over the
    reference's norm of that leaf or of the median leaf, whichever is
    larger."""
    g, w = _norms(got), _norms(want)
    med = statistics.median(w)
    return max(abs(a - b) / max(b, med) for a, b, c in zip(g, w, counted) if c)
