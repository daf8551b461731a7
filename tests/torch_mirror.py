"""Run a JAX package test file's cases on the port and compare what both
packages return.

A case runs twice: as written, on the JAX package, and with every
`ruvector_tpu` module name pointed at `ruvector_tpu_torch`. Its own
assertions then hold on the port too. A Recorder wraps the functions and
methods under test in both packages, logs what each call returns in a
package-independent form, and `assert_same` holds the two logs equal.
Entry points of the port that default to the CUDA card are given
device="cpu" where the case passes no device.
"""

from __future__ import annotations

import ast
import dataclasses
import inspect
import re
from pathlib import Path

import numpy as np
import torch

TESTS = Path(__file__).resolve().parent


def cases(anchor: str) -> list[str]:
    """The top-level test functions of tests/<anchor>, in file order."""
    tree = ast.parse((TESTS / anchor).read_text())
    return [n.name for n in tree.body
            if isinstance(n, ast.FunctionDef) and n.name.startswith("test_")]


def params(anchor: str, case: str) -> list:
    """The parametrize values of a case (one None where it has none)."""
    tree = ast.parse((TESTS / anchor).read_text())
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == case)
    for dec in fn.decorator_list:
        if isinstance(dec, ast.Call) and getattr(dec.func, "attr", "") == "parametrize":
            return list(ast.literal_eval(dec.args[1]))
    return [None]


def canon(x):
    """A package-independent form of a returned value: dataclasses by class
    name and fields, arrays and tensors as numpy, other objects by their
    class name."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__, {f.name: canon(getattr(x, f.name))
                                   for f in dataclasses.fields(x)})
    if isinstance(x, dict):
        return {k: canon(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [canon(v) for v in x]
    if isinstance(x, (set, frozenset)):
        return sorted(map(repr, x))
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if hasattr(x, "__array__"):
        return np.asarray(x)
    if x is None or isinstance(x, (bool, int, float, str, bytes, np.generic)):
        return x
    return type(x).__name__


def assert_same(got, want, where: str = "result", rtol: float = 0.0, atol: float = 0.0):
    """Equal structure; integers, booleans and strings equal; floats equal
    within (rtol, atol), bit for bit at the default."""
    if isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray) and got.shape == want.shape, where
        if want.dtype.kind == "f" and (rtol or atol):
            np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=where)
        else:
            np.testing.assert_array_equal(got, want, err_msg=where)
    elif isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want), where
        for k in want:
            assert_same(got[k], want[k], f"{where}[{k!r}]", rtol, atol)
    elif isinstance(want, (list, tuple)):
        assert isinstance(got, (list, tuple)) and len(got) == len(want), where
        for i, (a, b) in enumerate(zip(got, want)):
            assert_same(a, b, f"{where}[{i}]", rtol, atol)
    elif isinstance(want, float) and not isinstance(want, bool) and (rtol or atol):
        assert isinstance(got, float), where
        assert abs(got - want) <= atol + rtol * abs(want) or got == want, \
            f"{where}: {got!r} != {want!r}"
    else:
        assert got == want, f"{where}: {got!r} != {want!r}"


class Recorder:
    """Logs (name, canon(result)) of every wrapped call that the case makes
    itself (a wrapped call inside another is not logged: the two packages
    may compose their functions differently)."""

    def __init__(self, monkeypatch, port: bool):
        self.mp, self.port, self.log, self.depth = monkeypatch, port, [], 0

    def _wrapped(self, name, fn, default_cpu):
        def call(*args, **kw):
            if self.port and default_cpu:
                kw.setdefault("device", "cpu")
            self.depth += 1
            try:
                out = fn(*args, **kw)
            finally:
                self.depth -= 1
            if self.depth == 0:
                self.log.append((name, canon(out)))
            return out

        return call

    def methods(self, owner, names=None, cpu=()):
        """Wrap the public methods of a class (or the named ones)."""
        for name, fn in list(vars(owner).items()):
            if names is not None and name not in names:
                continue
            if inspect.isfunction(fn) and not name.startswith("_"):
                self.mp.setattr(owner, name,
                                self._wrapped(f"{owner.__name__}.{name}", fn, name in cpu))

    def functions(self, modules, names, cpu=()):
        """Wrap module functions in every module that binds them."""
        for name in names:
            wrapped = None
            for mod in modules:
                if hasattr(mod, name):
                    if wrapped is None:
                        wrapped = self._wrapped(name, getattr(mod, name), name in cpu)
                    self.mp.setattr(mod, name, wrapped)

    def cpu_default(self, owner, name):
        """An entry point of the port that defaults to the card: default it
        to the CPU (unrecorded)."""
        fn = getattr(owner, name)
        static = isinstance(inspect.getattr_static(owner, name), staticmethod)

        def call(*args, **kw):
            kw.setdefault("device", "cpu")
            return fn(*args, **kw)

        self.mp.setattr(owner, name, staticmethod(call) if static else call)


def run_case(anchor: str, case: str, port: bool, tmp_path: Path, param=None,
             fixtures: dict | None = None, rewrite=None) -> None:
    """Run one case of tests/<anchor> on the JAX package or on the port.
    A case's argument is `tmp_path`, an entry of `fixtures` (e.g. pytest's
    capsys), a fixture that the anchor file defines (called without
    arguments), or else its parametrize value. `rewrite(src)` edits the
    port's copy of the source after the renaming."""
    src = (TESTS / anchor).read_text()
    if port:
        src = re.sub(r"\bruvector_tpu\b(?!_torch)", "ruvector_tpu_torch", src)
        if rewrite is not None:
            src = rewrite(src)
    ns = {"__name__": f"mirror_{anchor[:-3]}_{'port' if port else 'jax'}"}
    exec(compile(src, str(TESTS / anchor), "exec"), ns)
    fn = ns[case]
    sig = inspect.signature(fn).parameters
    kwargs = {}
    if "tmp_path" in sig:
        tmp_path.mkdir(parents=True)
        kwargs["tmp_path"] = tmp_path
    for name in sig:
        if name == "tmp_path":
            continue
        if fixtures and name in fixtures:
            kwargs[name] = fixtures[name]
        elif hasattr(ns.get(name), "__wrapped__"):
            kwargs[name] = ns[name].__wrapped__()
        else:
            kwargs[name] = param
    fn(**kwargs)


def compare_logs(got: list, want: list, rtol: float = 0.0, atol: float = 0.0) -> None:
    assert [name for name, _ in got] == [name for name, _ in want]
    for i, ((name, a), (_, b)) in enumerate(zip(got, want)):
        assert_same(a, b, f"{name} #{i}", rtol, atol)
