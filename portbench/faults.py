"""Faults planted under the timed path, one for each that a cell can have
on one card: a step that returns its state unchanged, half of the batch
left out, an answer altered where it is produced. A run with one planted
has to come out not correct (portbench/tests/test_portbench_check.py);
`portbench.controls --faults` reads their numbers on the card, where a
training cell's limits are held against them too.
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch

from portbench import program

_ORIG = {name: getattr(program, name) for name in ("gated_step", "gated_loss", "layer_pass")}


def _leaves(p):
    for v in p.values():
        yield from (v.values() if isinstance(v, dict) else (v,))


def _step_keeps_state(params, gcfg, fpad, bdg, state):
    out, _, n = _ORIG["gated_step"](params, gcfg, fpad, bdg, state)
    return out, state, n


def _step_half_batch(params, gcfg, fpad, bdg, state):
    out, new, n = _ORIG["gated_step"](params, gcfg, fpad, bdg, state)
    half = out.shape[0] // 2
    return torch.cat([out[:half], fpad[half:]]), new, n


def _step_altered(params, gcfg, fpad, bdg, state):
    out, new, n = _ORIG["gated_step"](params, gcfg, fpad, bdg, state)
    out = out.clone()
    out[5, 7] += 1.0
    return out, new, n


def _loss_no_update(params, gcfg, fpad, bdg, keep, targets):
    loss = _ORIG["gated_loss"](params, gcfg, fpad, bdg, keep, targets)
    return loss.detach() + 0.0 * sum(w.sum() for p in params for w in _leaves(p))


def _loss_half_batch(params, gcfg, fpad, bdg, keep, targets):
    pad = bdg.node_pad.clone()
    pad[pad.shape[0] // 2:] = 0.0
    return _ORIG["gated_loss"](params, gcfg, fpad, dataclasses.replace(bdg, node_pad=pad),
                               keep, targets)


def _loss_altered(params, gcfg, fpad, bdg, keep, targets):
    return _ORIG["gated_loss"](params, gcfg, fpad, bdg, keep, targets) * 1.01


def _pass_returns_input(params, lcfg, fpad, bdg, io):
    _ORIG["layer_pass"](params, lcfg, fpad, bdg, io)
    return fpad.clone()


def _pass_half_batch(params, lcfg, fpad, bdg, io):
    out = _ORIG["layer_pass"](params, lcfg, fpad, bdg, io)
    out[out.shape[0] // 2:] = 0
    return out


def _pass_altered(params, lcfg, fpad, bdg, io):
    out = _ORIG["layer_pass"](params, lcfg, fpad, bdg, io)
    out[3, 2] += 1.0
    return out


# by model: fault -> (the program's entry point, its broken stand-in)
FAULTS = {
    "gated_step": {"state_unchanged": ("gated_step", _step_keeps_state),
                   "half_batch": ("gated_step", _step_half_batch),
                   "altered": ("gated_step", _step_altered)},
    "gated_train": {"state_unchanged": ("gated_loss", _loss_no_update),
                    "half_batch": ("gated_loss", _loss_half_batch),
                    "altered": ("gated_loss", _loss_altered)},
    "layer_pass": {"state_unchanged": ("layer_pass", _pass_returns_input),
                   "half_batch": ("layer_pass", _pass_half_batch),
                   "altered": ("layer_pass", _pass_altered)},
}


@contextlib.contextmanager
def planted(driver: str, fault: str):
    """program's entry point replaced by the fault's stand-in while inside."""
    name, broken = FAULTS[driver][fault]
    setattr(program, name, broken)
    try:
        yield
    finally:
        setattr(program, name, _ORIG[name])
