"""Checkpoint / resume for params, optimizer state and sharded arrays (port
of ruvector_tpu/utils/checkpoint.py).

Reference: ruvector-snapshot (collection backup/restore with checksums),
GNN layer serde, SONA safetensors export.

The port writes the JAX package's numpy `.npz` route (orbax is a JAX
library): one member per leaf under JAX's path keys (dict keys sorted,
list and tuple indices, joined by "/"; `None` holds no leaf), a JSON meta
file with the step and a sha256 over the sorted members' bytes. A file
either package writes restores in the other. numpy has no bfloat16: a
bf16 leaf is stored as its 2-byte words, void `|V2`, as JAX's `.npz`
holds an `ml_dtypes` bf16 leaf, and is restored through the target
leaf's dtype.
"""

from __future__ import annotations

import glob
import hashlib
import json
import re
import threading
from pathlib import Path
from typing import Any

import numpy as np
import torch

from ruvector_tpu_torch.device import resolve_device


def _paths_and_leaves(tree: Any, prefix: tuple = ()):
    """(path, leaf) pairs in JAX's leaf order: dict keys sorted, lists and
    tuples in order; None is an empty subtree."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [pl for k in sorted(tree) for pl in _paths_and_leaves(tree[k], prefix + (k,))]
    if isinstance(tree, (list, tuple)):
        return [pl for i, t in enumerate(tree) for pl in _paths_and_leaves(t, prefix + (i,))]
    return [(prefix, tree)]


def _key(path: tuple) -> str:
    return "/".join(str(p) for p in path)


def _to_numpy(leaf) -> np.ndarray:
    """A host copy of a leaf; a bf16 tensor as its words viewed as |V2."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view("V2")
        return t.numpy()
    return np.array(leaf)


def _to_tensor(arr: np.ndarray, like, device) -> torch.Tensor:
    """A stored array as a tensor with the target leaf's dtype (a |V2
    array holds bf16 words) on `device`."""
    if arr.dtype == np.dtype("V2"):
        t = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr))
    if isinstance(like, torch.Tensor):
        t = t.to(like.dtype)
    return t.to(device)


def _leaf_device(leaf) -> torch.device:
    """The target leaf's device where it is a tensor, else the card."""
    return leaf.device if isinstance(leaf, torch.Tensor) else resolve_device()


def _checksum(flat: dict[str, np.ndarray]) -> str:
    return hashlib.sha256(b"".join(v.tobytes() for _, v in sorted(flat.items()))).hexdigest()


def _unflatten(tree: Any, leaves: list):
    """`tree`'s structure holding `leaves`, given in _paths_and_leaves order."""
    by_path = dict(zip((p for p, _ in _paths_and_leaves(tree)), leaves))

    def place(node, prefix=()):
        if node is None:
            return None
        if isinstance(node, dict):
            return {k: place(node[k], prefix + (k,)) for k in node}
        if isinstance(node, (list, tuple)):
            return type(node)(place(t, prefix + (i,)) for i, t in enumerate(node))
        return by_path[prefix]

    return place(tree)


def save_checkpoint(directory: str | Path, tree: Any, step: int = 0) -> str:
    """Save a pytree of tensors (or arrays) as `ckpt_<step>.npz` with its
    meta file; returns the `.npz` path."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    path = directory / f"ckpt_{step}"
    flat = {_key(p): _to_numpy(leaf) for p, leaf in _paths_and_leaves(tree)}
    np.savez(str(path) + ".npz", **flat)
    meta = {"step": step, "checksum": _checksum(flat), "keys": sorted(flat)}
    (directory / f"ckpt_{step}.json").write_text(json.dumps(meta))
    return str(path) + ".npz"


def restore_checkpoint(directory: str | Path, target: Any, step: int = 0) -> Any:
    """Restore into the structure of `target` (pytree prototype): each leaf
    a tensor of the target leaf's dtype, on the target leaf's device (the
    card for a leaf that is not a tensor), except that a Python number
    stays a Python number of its type. Raises ValueError when the checksum
    does not match."""
    directory = Path(directory)
    path = directory / f"ckpt_{step}"
    with np.load(str(path) + ".npz") as npz:
        flat = {k: npz[k] for k in npz.files}
    meta = json.loads((directory / f"ckpt_{step}.json").read_text())
    if _checksum(flat) != meta["checksum"]:
        raise ValueError(f"checkpoint corrupt: checksum mismatch at {path}")
    return _unflatten(target, [_restored(flat[_key(p)], leaf)
                               for p, leaf in _paths_and_leaves(target)])


def _restored(arr: np.ndarray, leaf):
    """A stored leaf in the target leaf's form: a Python number stays a
    Python number of its type (an optimizer's step count), anything else
    becomes a tensor (_to_tensor) on the target leaf's device."""
    if isinstance(leaf, (bool, int, float)):
        return type(leaf)(arr.item())
    return _to_tensor(arr, leaf, _leaf_device(leaf))


# ---------------------------------------------------------------------------
# Async checkpointing: the device-to-host snapshot is taken synchronously,
# then serialized and written on a background thread so the train loop
# never blocks on IO.
# ---------------------------------------------------------------------------

def _process_index() -> int:
    """This process's rank in the default process group, 0 without one."""
    dist = torch.distributed
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def _dtype_name(leaf, arr: np.ndarray) -> str:
    if isinstance(leaf, torch.Tensor) and leaf.dtype == torch.bfloat16:
        return "bfloat16"
    return str(arr.dtype)


class AsyncShardedCheckpointer:
    """Per-process checkpoint with background IO, in the JAX package's
    sharded layout (`ckpt_<step>.proc<rank>.npz` + `.json`).

    save():   the device->host copies of the tree's leaves are taken
              synchronously, then serialized and written on a daemon
              thread. A step is visible to restore only after its meta file
              lands (write-then-rename commit). Each tensor is one whole
              shard (the `::()` form); a process's rank comes from
              `torch.distributed` when a process group is initialised.
    restore(): reassembles each array from every process's shards (files
              the JAX package wrote with sharded arrays included) into the
              target's structure. Placing the restored arrays onto
              shardings waits for the port's sharded path (ROADMAP item 23).
    """

    def __init__(self, directory: str | Path):
        self.directory = Path(directory)
        self.directory.mkdir(parents=True, exist_ok=True)
        self._thread: threading.Thread | None = None
        self._error: Exception | None = None

    def save(self, tree: Any, step: int = 0, process_index: int | None = None) -> None:
        proc = _process_index() if process_index is None else process_index
        flat = {}
        index_meta = {}
        for path, leaf in _paths_and_leaves(tree):
            key = _key(path)
            arr = _to_numpy(leaf)            # snapshot NOW (device->host); write later
            flat[f"{key}::()"] = arr
            index_meta[key] = {"global_shape": list(arr.shape),
                               "dtype": _dtype_name(leaf, arr), "indices": [[]]}

        self.wait_until_finished()

        def write():
            try:
                tmp = self.directory / f".tmp_ckpt_{step}.proc{proc}.npz"
                final = self.directory / f"ckpt_{step}.proc{proc}.npz"
                np.savez(tmp, **flat)
                tmp.rename(final)
                meta = {"step": step, "process": proc, "keys": index_meta}
                mtmp = self.directory / f".tmp_ckpt_{step}.proc{proc}.json"
                mfinal = self.directory / f"ckpt_{step}.proc{proc}.json"
                mtmp.write_text(json.dumps(meta))
                mtmp.rename(mfinal)   # commit point
            except Exception as e:  # surfaced on next wait/save
                self._error = e

        self._thread = threading.Thread(target=write, daemon=True)
        self._thread.start()

    def wait_until_finished(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def restore(self, target: Any, step: int = 0) -> Any:
        """Restore into `target`'s structure: each leaf a tensor of the
        target leaf's dtype, on its device (the card for a leaf that is not
        a tensor)."""
        files = sorted(glob.glob(str(self.directory / f"ckpt_{step}.proc*.npz")))
        if not files:
            raise FileNotFoundError(f"no sharded checkpoint for step {step}")
        shards: dict[str, list] = {}
        for f in files:
            with np.load(f) as npz:
                for k in npz.files:
                    name, _, idx = k.partition("::")
                    shards.setdefault(name, []).append((idx, npz[k]))
        metas = {}
        for f in sorted(glob.glob(str(self.directory / f"ckpt_{step}.proc*.json"))):
            metas.update(json.loads(Path(f).read_text())["keys"])

        leaves = []
        for path, leaf in _paths_and_leaves(target):
            key = _key(path)
            parts = shards[key]
            full = np.zeros(tuple(metas[key]["global_shape"]), parts[0][1].dtype)
            for idx, v in parts:
                full[_meta_to_index(idx)] = v
            leaves.append(_to_tensor(full, leaf, _leaf_device(leaf)))
        return _unflatten(target, leaves)


_SLICE_RE = re.compile(r"slice\(([^)]*)\)")


def _meta_to_index(idx_str_or_list):
    """Parse either the '(...)' repr key suffix or a meta list into slices.

    The string form is parsed structurally (regex over ``slice(a, b, c)``
    terms with int/None fields only) — archive-derived strings are never
    evaluated as Python, so a corrupted or untrusted checkpoint cannot
    inject code.
    """
    if isinstance(idx_str_or_list, str):
        s = idx_str_or_list.strip()
        if s in ("()", ""):
            return tuple()
        out = []
        for m in _SLICE_RE.finditer(s):
            parts = [p.strip() for p in m.group(1).split(",")]
            if len(parts) != 3:
                raise ValueError(f"malformed slice in shard index: {s!r}")
            vals = []
            for p in parts:
                if p == "None":
                    vals.append(None)
                else:
                    vals.append(int(p))  # raises on anything non-numeric
            out.append(slice(*vals))
        if not out:
            raise ValueError(f"unparseable shard index: {s!r}")
        return tuple(out)
    return tuple(slice(a, b, c) for a, b, c in idx_str_or_list)
