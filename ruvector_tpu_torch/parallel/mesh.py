"""One-axis process mesh on torch.distributed (port of
ruvector_tpu/parallel/mesh.py).

The JAX package runs one `shard_map` program over a device mesh from a
single controller. The port runs one process per shard: `run_ranks`
spawns `world` rank processes, each initialises its process group and
calls a module-level function with its `Mesh`, and the launcher returns
the ranks' results in rank order. The collectives of the JAX code
(`all_to_all`, `all_gather`, `psum`, `ppermute`) are methods of `Mesh`.

Transport. Ranks on separate cards use NCCL. Ranks that share a card use
gloo, since NCCL refuses two ranks on one GPU; gloo moves host memory, so
each collective copies a CUDA tensor to the host, runs there and copies
the result back (`Mesh.staged_bytes` counts both copies). The compute
stays on the card. The choice is keyed on the group's backend, never on
whether a card is present. Nothing falls back: a rank that asks for a card
and finds none raises, and so does a failed collective.

Gradients. `all_to_all`, `all_gather`, `all_reduce` and `ppermute` are
differentiable, with the gradient of the sum of every rank's loss: the
backward of an all-to-all is the same all-to-all, of a gather the sum of
the ranks' slices, of a sum-reduction a sum-reduction, of a ring shift
the opposite shift.
"""

from __future__ import annotations

import dataclasses
import datetime
import multiprocessing
import os
import pickle
import shutil
import tempfile
import time
import traceback

import torch
import torch.distributed as dist

from ruvector_tpu_torch.device import resolve_device

# seconds a rank waits at the rendezvous or in a collective before it
# raises (gloo's own default is 30 minutes)
RANK_TIMEOUT_S = 120.0


@dataclasses.dataclass
class Mesh:
    """One rank's view of a 1-D mesh: its process group, rank, world
    size, axis name and device. A one-rank mesh may have no group
    (group=None); its collectives then move nothing."""

    group: object
    rank: int
    size: int
    axis_name: str
    device: torch.device
    staged_bytes: int = 0

    @property
    def backend(self) -> str:
        """The group's backend; "none" for a one-rank mesh without a group,
        whose collectives move nothing."""
        return "none" if self.group is None else dist.get_backend(self.group)

    @property
    def staged(self) -> bool:
        """True where a collective copies CUDA tensors through the host
        (gloo on a card)."""
        return self.backend == "gloo" and self.device.type == "cuda"

    # --- host staging -----------------------------------------------------
    def _out(self, x: torch.Tensor) -> torch.Tensor:
        if self.staged:
            self.staged_bytes += x.numel() * x.element_size()
            return x.detach().to("cpu").contiguous()
        return x.detach().contiguous()

    def _back(self, y: torch.Tensor) -> torch.Tensor:
        if self.staged:
            self.staged_bytes += y.numel() * y.element_size()
            return y.to(self.device)
        return y

    # --- raw collectives (no autograd) ------------------------------------
    def _alone(self) -> bool:
        if self.group is None and self.size != 1:
            raise ValueError("a mesh of several ranks needs a process group")
        return self.group is None

    def _all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        if x.shape[0] != self.size:
            raise ValueError(f"all_to_all: leading axis {x.shape[0]} != world {self.size}")
        if self._alone():
            return x.detach().clone()
        buf = self._out(x)
        out = torch.empty_like(buf)
        dist.all_to_all_single(out, buf, group=self.group)
        return self._back(out)

    def _all_gather(self, x: torch.Tensor) -> torch.Tensor:
        if self._alone():
            return x.detach().clone()
        buf = self._out(x)
        parts = [torch.empty_like(buf) for _ in range(self.size)]
        dist.all_gather(parts, buf, group=self.group)
        return self._back(torch.cat(parts, dim=0))

    def _all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        if self._alone():
            return x.detach().clone()
        buf = self._out(x).clone()
        dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=self.group)
        return self._back(buf)

    def _ppermute(self, x: torch.Tensor, shift: int) -> torch.Tensor:
        if self._alone() or shift % self.size == 0:
            return x.detach().clone()
        buf = self._out(x)
        out = torch.empty_like(buf)
        dst = (self.rank + shift) % self.size
        src = (self.rank - shift) % self.size
        ops = [dist.P2POp(dist.isend, buf, dst, group=self.group),
               dist.P2POp(dist.irecv, out, src, group=self.group)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return self._back(out)

    # --- differentiable collectives ---------------------------------------
    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        """x [S, ...]: slice j goes to rank j; returns [S, ...] whose slice
        i came from rank i (jax.lax.all_to_all, split and concat axis 0,
        tiled)."""
        return _AllToAll.apply(self, x)

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's x concatenated along axis 0 in rank order
        (jax.lax.all_gather, tiled)."""
        return _AllGather.apply(self, x)

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of every rank's x (jax.lax.psum)."""
        return _AllReduce.apply(self, x)

    def ppermute(self, x: torch.Tensor, shift: int = 1) -> torch.Tensor:
        """Ring shift: rank r sends x to rank r + shift and returns what
        rank r - shift sent (jax.lax.ppermute over [(i, i + shift)])."""
        return _Ppermute.apply(self, x, shift)

    def own_rows(self, x: torch.Tensor, block: int) -> torch.Tensor:
        """The rank's rows of x: x itself when it holds `block` rows, its
        slice when it holds the whole [size*block, ...] array."""
        return own_rows(x, self.rank * block, (self.rank + 1) * block, self.size * block)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, x):
        ctx.mesh = mesh
        return mesh._all_to_all(x)

    @staticmethod
    def backward(ctx, g):
        return None, ctx.mesh._all_to_all(g)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, x):
        ctx.mesh, ctx.n = mesh, x.shape[0]
        return mesh._all_gather(x)

    @staticmethod
    def backward(ctx, g):
        mesh = ctx.mesh
        # each rank's gradient of every slice, summed on the slice's owner
        parts = mesh._all_to_all(g.reshape(mesh.size, ctx.n, *g.shape[1:]))
        return None, parts.sum(0)


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, x):
        ctx.mesh = mesh
        return mesh._all_reduce(x)

    @staticmethod
    def backward(ctx, g):
        return None, ctx.mesh._all_reduce(g)


class _Ppermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, x, shift):
        ctx.mesh, ctx.shift = mesh, shift
        return mesh._ppermute(x, shift)

    @staticmethod
    def backward(ctx, g):
        return None, ctx.mesh._ppermute(g, -ctx.shift), None


def own_rows(x: torch.Tensor, start: int, stop: int, total: int) -> torch.Tensor:
    """Rows [start, stop) of an array of `total` rows, given either those
    rows alone (returned as they are) or the whole array (sliced)."""
    if x.shape[0] == stop - start:
        return x
    if x.shape[0] == total:
        return x[start:stop]
    raise ValueError(f"expected {stop - start} or {total} rows, got {x.shape[0]}")


def device_count() -> int:
    """CUDA cards visible to this process (0 without a card)."""
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def make_mesh(n_devices: int | None = None, axis_name: str = "nodes",
              device=None) -> Mesh:
    """This process's Mesh over the default process group, which must be
    initialised (by `run_ranks` or `multihost.initialize_multihost`).
    `n_devices`, where given, must equal the group's size."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: no process group; start the ranks with run_ranks "
                           "or initialize_multihost")
    size = dist.get_world_size()
    if n_devices is not None and n_devices != size:
        raise ValueError(f"requested {n_devices} devices, the group has {size} ranks")
    return Mesh(group=dist.group.WORLD, rank=dist.get_rank(), size=size,
                axis_name=axis_name, device=resolve_device(device))


def rank_devices(world: int, device=None) -> tuple[list[str], str]:
    """(each rank's device, backend) for `world` ranks on `device`'s kind:
    on cards, one card a rank under NCCL where there are enough, else all
    ranks round-robin over the cards under gloo; on the CPU, gloo."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return [str(dev)] * world, "gloo"
    cards = torch.cuda.device_count()
    if dev.index is not None:
        return [str(dev)] * world, "nccl" if world == 1 else "gloo"
    return [f"cuda:{r % cards}" for r in range(world)], "nccl" if world <= cards else "gloo"


def _to_host(tree):
    """Tensors of a result moved to the host, so the parent can load them
    after the rank exits."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_host(v) for v in tree)
    return tree


def _rank_main(rank, world, backend, device, store_path, out_dir, threads):
    with open(os.path.join(out_dir, "call.pkl"), "rb") as f:
        fn, args = pickle.load(f)
    if threads:
        torch.set_num_threads(threads)
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"rank {rank}: asked for {device} and torch sees no card")
        torch.cuda.set_device(dev)
    try:
        dist.init_process_group(backend, init_method=f"file://{store_path}", world_size=world,
                                rank=rank, timeout=datetime.timedelta(seconds=RANK_TIMEOUT_S))
        mesh = Mesh(group=dist.group.WORLD, rank=rank, size=world, axis_name="nodes",
                    device=dev)
        result = fn(mesh, *args)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        torch.save(_to_host(result), os.path.join(out_dir, f"result_{rank}.pt"))
        dist.barrier()
        dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(out_dir, f"error_{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise


def _errors(tmp: str, world: int) -> str:
    """Every rank's traceback, rank by rank (the first to fail holds the
    cause; the others often report only the lost connection)."""
    texts = []
    for r in range(world):
        path = os.path.join(tmp, f"error_{r}.txt")
        if os.path.exists(path):
            texts.append(f"--- rank {r}:\n{open(path).read()[-3000:]}")
    return "\n".join(texts) or "(no traceback)"


def run_ranks(fn, world: int, *args, device=None, threads: int | None = None) -> list:
    """Spawn `world` rank processes; each calls fn(mesh, *args) and the
    results come back in rank order (tensors on the host). fn must be a
    module-level function and args picklable; hand large inputs over as
    files. Each launch has a rendezvous file of its own, so concurrent
    launches do not meet. A rank that raises or dies makes this raise with
    its traceback, after the other ranks are stopped."""
    devices, backend = rank_devices(world, device)
    tmp = tempfile.mkdtemp(prefix="rvt_ranks_")
    store = os.path.join(tmp, "rendezvous")
    # the call goes through a file, not the spawn pipe: a pipe that holds
    # more than its buffer blocks start() until that child has imported
    # fn's module, which would start the ranks one after another
    with open(os.path.join(tmp, "call.pkl"), "wb") as f:
        pickle.dump((fn, args), f, protocol=pickle.HIGHEST_PROTOCOL)
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, name=f"rank{r}",
                         args=(r, world, backend, devices[r], store, tmp, threads))
             for r in range(world)]
    try:
        for p in procs:
            p.start()
        while True:
            codes = [p.exitcode for p in procs]
            failed = [r for r, c in enumerate(codes) if c not in (None, 0)]
            if failed:
                time.sleep(1.0)   # let the other ranks report what they saw
                raise RuntimeError(f"rank {failed[0]} of {world} exited with "
                                   f"{codes[failed[0]]}:\n" + _errors(tmp, world))
            if all(c == 0 for c in codes):
                break
            time.sleep(0.02)
        return [torch.load(os.path.join(tmp, f"result_{r}.pt"), weights_only=False)
                for r in range(world)]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join()
        shutil.rmtree(tmp, ignore_errors=True)


def local_slice(t: torch.Tensor, spec: tuple, mesh: Mesh) -> torch.Tensor:
    """The rank's slice of a whole tensor under a partition spec: a tuple
    with one entry a dimension, the mesh's axis name on the split one and
    None elsewhere (`()` replicates, as jax.sharding.PartitionSpec)."""
    for dim, name in enumerate(spec):
        if name == mesh.axis_name:
            n = t.shape[dim]
            if n % mesh.size:
                raise ValueError(f"dimension {dim} ({n}) does not divide over {mesh.size} ranks")
            step = n // mesh.size
            return t.narrow(dim, mesh.rank * step, step)
    return t
