"""The port's multi-host bring-up, checkpoint/restart and heartbeat
(parallel/multihost.py), mirroring tests/test_multihost.py: the same
Adam run through the port's optimizer, interrupted and resumed from a
checkpoint, ends where the uninterrupted run ends, and where JAX's does.
Two spawned processes (one group for the file) come up through
initialize_multihost, one from its arguments and one from the usual
environment, on a port found by binding port 0; only rank 0 writes.
"""

import json
import multiprocessing
import socket
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torch_parallel_ranks as ranks
from ruvector_tpu.training.optimizers import adam as jadam
from ruvector_tpu_torch.parallel.multihost import (
    Heartbeat,
    TrainStateCheckpointer,
    initialize_multihost,
)
from ruvector_tpu_torch.training.optimizers import adam, apply_updates


def test_initialize_single_process_noop(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert initialize_multihost(num_processes=1) is False
    assert initialize_multihost() is False
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert initialize_multihost() is False
    assert not torch.distributed.is_initialized()


def _step(opt, params, opt_state, target):
    w = params["w"].detach().requires_grad_(True)
    loss = torch.sum((w - target) ** 2)
    (g,) = torch.autograd.grad(loss, w)
    updates, opt_state = opt.update({"w": g}, opt_state, params)
    return {"w": apply_updates(params, updates)["w"].detach()}, opt_state, loss


def _jax_run(steps):
    opt = jadam(0.1)
    params = {"w": jnp.ones(4) * 5.0}
    state = opt.init(params)
    for _ in range(steps):
        grads = jax.grad(lambda p: jnp.sum((p["w"] - jnp.zeros(4)) ** 2))(params)
        updates, state = opt.update(grads, state, params)
        params = optax.apply_updates(params, updates)
    return np.asarray(params["w"])


def test_checkpoint_restart_resumes_identically(tmp_path):
    opt = adam(0.1)
    target = torch.zeros(4)

    params = {"w": torch.ones(4) * 5.0}
    opt_state = opt.init(params)
    for _ in range(20):
        params, opt_state, _ = _step(opt, params, opt_state, target)
    uninterrupted = params["w"].numpy()
    # the JAX package's run (optax's Adam): float32 steps in another order
    np.testing.assert_allclose(uninterrupted, _jax_run(20), rtol=1e-5)

    ckpt = TrainStateCheckpointer(tmp_path, every_steps=10)
    params = {"w": torch.ones(4) * 5.0}
    opt_state = opt.init(params)
    for i in range(1, 11):
        params, opt_state, _ = _step(opt, params, opt_state, target)
        ckpt.maybe_save(i, {"params": params, "opt_state": opt_state})
    # crash: a fresh checkpointer restores
    proto = {"params": {"w": torch.zeros(4)}, "opt_state": opt.init({"w": torch.zeros(4)})}
    state, resumed = TrainStateCheckpointer(tmp_path, every_steps=10).restore_latest(proto)
    assert resumed == 10
    params, opt_state = state["params"], state["opt_state"]
    for _ in range(resumed + 1, 21):
        params, opt_state, _ = _step(opt, params, opt_state, target)
    np.testing.assert_allclose(params["w"].numpy(), uninterrupted, atol=1e-6)


def test_checkpointer_keeps_bounded_history(tmp_path):
    ckpt = TrainStateCheckpointer(tmp_path, every_steps=1, keep=2)
    for i in range(1, 6):
        ckpt.maybe_save(i, {"w": torch.ones(2)})
    steps = sorted(int(p.stem.split("_")[1]) for p in tmp_path.glob("ckpt_*.npz"))
    assert steps == [4, 5]
    assert not TrainStateCheckpointer(tmp_path, every_steps=2).maybe_save(7, {"w": torch.ones(2)})


def test_heartbeat(tmp_path):
    hb = Heartbeat(tmp_path / "hb", interval_s=0.0)
    assert not Heartbeat.is_alive(tmp_path / "hb")
    hb.beat(step=5)
    assert Heartbeat.is_alive(tmp_path / "hb", timeout_s=10)
    assert not Heartbeat.is_alive(tmp_path / "hb", timeout_s=0.0)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def two_hosts(tmp_path_factory):
    """Two processes brought up by initialize_multihost; their reports."""
    tmp = tmp_path_factory.mktemp("multihost")
    ctx = multiprocessing.get_context("spawn")
    port = _free_port()
    outs = [tmp / f"rank{r}.json" for r in range(2)]
    procs = [ctx.Process(target=ranks.multihost_rank,
                         args=(r, 2, port, str(tmp / "ckpt"), str(outs[r])))
             for r in range(2)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + 240
    for p in procs:
        p.join(max(1.0, deadline - time.monotonic()))
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    assert [p.exitcode for p in procs] == [0, 0]
    return tmp, [json.loads(o.read_text()) for o in outs]


def test_initialize_multihost_brings_up_a_group(two_hosts):
    _, reports = two_hosts
    assert [r["up"] for r in reports] == [True, True]
    assert [r["sum"] for r in reports] == [3.0, 3.0]
    assert all(r["jax_modules"] == [] for r in reports)


def test_checkpointer_writes_from_rank_zero_only(two_hosts):
    tmp, reports = two_hosts
    assert [r["saved"] for r in reports] == [True, False]
    files = sorted(p.name for p in (tmp / "ckpt").iterdir())
    assert files == ["ckpt_1.json", "ckpt_1.npz"]
    with np.load(tmp / "ckpt" / "ckpt_1.npz") as npz:
        np.testing.assert_array_equal(npz[npz.files[0]], np.zeros(2, np.float32))
