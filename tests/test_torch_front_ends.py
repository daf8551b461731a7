"""The port's front ends (ruvector_tpu_torch/serve/{server,mcp}.py and the
CLI, ruvector_tpu_torch/__main__.py) against the JAX package's.

The HTTP and CLI cases of tests/test_serve_extra.py and every case of
tests/test_mcp.py and tests/test_cli.py run twice (tests/torch_mirror.py):
as written, on the JAX package, and with its imports pointed at the port,
whose servers and CLI run on the CPU here (device="cpu", `--device cpu`).
Each run records what the front end answers: every HTTP response (status
and parsed body; of /metrics the metric names), every MCP reply (the tool
payloads parsed, their `latency_ms` left out) and every CLI output (JSON
lines parsed, timings and temporary paths left out). The case's own
assertions hold on the port, and the two records must be equal: ids,
counts and strings exactly, floats (scores, losses) within rtol 1e-5, atol
1e-6. The concurrent-load case issues random requests from 12 threads, so
its order differs run to run: it is run on both and its own assertions
hold, its record is not compared.

MCP's `train` starts from JAX's initial parameters and steps on JAX's
draws: the JAX run records its layer init and each step's anchors and
negatives, and the port replays them (the port draws from a
torch.Generator, the JAX package from numpy).
"""

import contextlib
import io
import json
import re
import subprocess
import threading
import urllib.error
import urllib.parse
import urllib.request

import jax
import numpy as np
import pytest
import torch

import ruvector_tpu.__main__ as jmain
import ruvector_tpu.nn.ruvector_layer as jlayer
import ruvector_tpu.serve.mcp as jmcp
import ruvector_tpu.training.train as jtrain
import ruvector_tpu_torch.__main__ as tmain
import ruvector_tpu_torch.nn.ruvector_layer as tlayer
import ruvector_tpu_torch.serve.mcp as tmcp
import ruvector_tpu_torch.serve.server as tserver
from ruvector_tpu_torch.convert import params_from_numpy
from ruvector_tpu_torch.index.hnsw import HnswConfig, HnswIndex
from tests.torch_mirror import Recorder, assert_same, cases, run_case

RTOL, ATOL = 1e-5, 1e-6
HTTP_CASES = ["test_http_server_roundtrip", "test_http_server_concurrent_load",
              "test_http_server_point_get_and_collection_delete",
              "test_http_scroll_with_filter_and_pagination", "test_cli_create_insert_search"]
CASES = ([("test_serve_extra.py", c) for c in HTTP_CASES]
         + [("test_mcp.py", c) for c in cases("test_mcp.py")]
         + [("test_cli.py", c) for c in cases("test_cli.py")])
UNORDERED = {"test_http_server_concurrent_load"}
# the unpatched callables: each run's recorder wraps these, not the other's
_URLOPEN, _RUN = urllib.request.urlopen, subprocess.run


def _cpu_flag(src: str) -> str:
    """The port's CLI in a subprocess: ask for the CPU."""
    return src.replace('"-m", "ruvector_tpu_torch",', '"-m", "ruvector_tpu_torch", "--device", "cpu",')


def _normal_text(text: str, tmp: str) -> list:
    out = []
    for line in text.replace(tmp, "<tmp>").splitlines():
        try:
            value = json.loads(line)
        except ValueError:
            out.append(re.sub(r" in [0-9.]+s( \([0-9]+/s\))?", "", line))
            continue
        if isinstance(value, dict):
            value.pop("latency_ms", None)
        out.append(value)
    return out


class _Response(io.BytesIO):
    def __init__(self, body: bytes, status: int):
        super().__init__(body)
        self.status = status

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def _record_http(monkeypatch, log: list) -> None:
    """Log (method, path, status, body) of every urlopen; the body comes
    back to the caller unchanged."""
    real = _URLOPEN

    def body_of(path: str, raw: bytes):
        if path.endswith("/metrics"):
            return sorted({re.split(r"[{ ]", ln)[0] for ln in raw.decode().splitlines()
                           if ln and not ln.startswith("#")})
        return json.loads(raw or b"null")

    def urlopen(req, *args, **kw):
        is_req = isinstance(req, urllib.request.Request)
        method = req.get_method() if is_req else "GET"
        path = urllib.parse.urlsplit(req.full_url if is_req else req).path
        try:
            with real(req, *args, **kw) as resp:
                raw, status = resp.read(), resp.status
        except urllib.error.HTTPError as err:
            raw = err.read()
            log.append(("http", (method, path, err.code, body_of(path, raw))))
            raise urllib.error.HTTPError(err.url, err.code, err.msg, err.hdrs,
                                         io.BytesIO(raw)) from None
        log.append(("http", (method, path, status, body_of(path, raw))))
        return _Response(raw, status)

    monkeypatch.setattr(urllib.request, "urlopen", urlopen)


def _mcp_reply(resp):
    if not isinstance(resp, dict) or "result" not in resp:
        return resp
    result = dict(resp["result"])
    if "content" in result and not result.get("isError"):
        payload = json.loads(result["content"][0]["text"])
        if isinstance(payload, dict):
            payload.pop("latency_ms", None)
        result["content"] = payload
    return {**resp, "result": result}


def _record(monkeypatch, port: bool, tmp: str) -> list:
    log = []
    _record_http(monkeypatch, log)
    mcp, main_mod = (tmcp, tmain) if port else (jmcp, jmain)
    handle = mcp.McpServer.handle

    def logged_handle(self, msg):
        resp = handle(self, msg)
        log.append(("mcp", _mcp_reply(resp)))
        return resp

    monkeypatch.setattr(mcp.McpServer, "handle", logged_handle)
    main = main_mod.main

    def logged_main(argv=None):
        argv = list(argv) if argv is not None else None
        if port and argv is not None:
            argv = ["--device", "cpu", *argv]
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            main(argv)
        print(buf.getvalue(), end="")
        log.append(("cli", _normal_text(buf.getvalue(), tmp)))

    monkeypatch.setattr(main_mod, "main", logged_main)
    def logged_run(*args, **kw):
        out = _RUN(*args, **kw)
        log.append(("subprocess", _normal_text(out.stdout, tmp)))
        return out

    monkeypatch.setattr(subprocess, "run", logged_run)
    if port:
        rec = Recorder(monkeypatch, True)
        rec.cpu_default(tmcp.McpServer, "__init__")
        rec.cpu_default(tserver.RuvectorServer, "__init__")
    return log


def _capture_jax_training(monkeypatch) -> dict:
    seen = {"init": [], "batches": []}
    init, negatives = jlayer.ruvector_layer_init, jtrain.sample_negatives

    def record_init(*args, **kw):
        params = init(*args, **kw)
        seen["init"].append(jax.tree_util.tree_map(np.asarray, params))
        return params

    def record_negatives(rng, graph, anchors, n):
        negs = negatives(rng, graph, anchors, n)
        seen["batches"].append((np.array(anchors, np.int32), np.array(negs, np.int32)))
        return negs

    monkeypatch.setattr(jlayer, "ruvector_layer_init", record_init)
    monkeypatch.setattr(jtrain, "sample_negatives", record_negatives)
    return seen


def _replay_jax_training(monkeypatch, seen: dict) -> None:
    inits, batches = list(seen["init"]), list(seen["batches"])
    monkeypatch.setattr(tlayer, "ruvector_layer_init",
                        lambda seed, cfg, device=None, dtype=torch.float32:
                        params_from_numpy(inits.pop(0), device))
    monkeypatch.setattr(tmcp, "_draw_batch", lambda gen, graph, bs, n: tuple(
        torch.from_numpy(a) for a in batches.pop(0)))


@pytest.mark.parametrize("anchor,case", CASES, ids=[f"{a[5:-3]}::{c}" for a, c in CASES])
def test_same_answers_as_jax(anchor, case, monkeypatch, tmp_path, capsys):
    seen = _capture_jax_training(monkeypatch)
    want = _record(monkeypatch, False, str(tmp_path / "jax"))
    run_case(anchor, case, False, tmp_path / "jax", fixtures={"capsys": capsys})
    _replay_jax_training(monkeypatch, seen)
    got = _record(monkeypatch, True, str(tmp_path / "port"))
    run_case(anchor, case, True, tmp_path / "port", fixtures={"capsys": capsys},
             rewrite=_cpu_flag)
    if case in UNORDERED:
        assert len(got) == len(want)
        return
    assert [n for n, _ in got] == [n for n, _ in want]
    for i, ((name, a), (_, b)) in enumerate(zip(got, want)):
        assert_same(a, b, f"{name} #{i}", RTOL, ATOL)


def test_every_anchor_case_is_mirrored():
    assert len(cases("test_mcp.py")) == 6 and len(cases("test_cli.py")) == 2
    assert set(HTTP_CASES) < set(cases("test_serve_extra.py"))


# --- collections cross between the packages ------------------------------------

def _lifecycle(main, col, vecs_path, extra=()):
    main([*extra, "create", str(col), "--dim", "16"])
    main([*extra, "insert", str(col), "--vectors", str(vecs_path)])


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_collection_written_by_one_package_opens_in_the_other(writer, tmp_path, capsys):
    """meta.json and vectors.npz (object arrays for ids and payloads) are
    the same layout in both CLIs: a collection that one writes, the other
    reads, searches and exports with the same answers."""
    rng = np.random.default_rng(4)
    vecs = rng.normal(size=(60, 16)).astype(np.float32)
    np.save(tmp_path / "v.npy", vecs)
    col = tmp_path / "col"
    port_flags = ("--device", "cpu")
    write, read = ((jmain.main, ()), (tmain.main, port_flags))[::1 if writer == "jax" else -1]
    _lifecycle(write[0], col, tmp_path / "v.npy", write[1])
    capsys.readouterr()
    q = json.dumps(vecs[7].tolist())
    answers = []
    for main, flags in (read, write):
        main([*flags, "info", str(col)])
        main([*flags, "search", str(col), "--query", q, "-k", "5"])
        lines = capsys.readouterr().out.strip().splitlines()
        res = json.loads(lines[-1])
        res.pop("latency_ms")
        answers.append((json.loads(lines[0]), res))
    assert answers[0] == answers[1]
    assert answers[0][0]["points_count"] == 60 and answers[0][1]["results"][0]["id"] == 7
    read[0]([*read[1], "export", str(col), str(tmp_path / "e.npz")])
    write[0]([*write[1], "import", str(tmp_path / "e.npz"), str(tmp_path / "col2")])
    data = np.load(tmp_path / "col2" / "vectors.npz", allow_pickle=True)
    np.testing.assert_array_equal(data["vectors"], vecs)
    assert data["ids"].dtype == object and data["ids"].tolist() == list(range(60))


# --- MCP training and the four query modes from preloaded parameters ----------

@pytest.mark.parametrize("mode", ["vector_search", "neural_search", "subgraph_extraction",
                                  "differentiable_search"])
def test_mcp_trains_and_queries_from_preloaded_params(mode, monkeypatch):
    """Both servers hold the same JAX-initialised layer in `trained`; three
    `train` steps on JAX's draws, then a query at gnn_depth 1 through the
    trained layer: the same nodes, scores within the tolerance."""
    rng = np.random.default_rng(2)
    # past the HNSW level-0 degree (2m = 64): with fewer rows every node
    # neighbours all others and no negative exists to draw
    vecs = rng.normal(size=(120, 16)).astype(np.float32)
    jcfg = jlayer.RuvectorLayerConfig(input_dim=16, hidden_dim=16, heads=4)
    init = jax.tree_util.tree_map(np.asarray, jlayer.ruvector_layer_init(jax.random.key(3), jcfg))
    seen = _capture_jax_training(monkeypatch)
    replies = []
    for port in (False, True):
        if port:
            _replay_jax_training(monkeypatch, seen)
        mcp = tmcp if port else jmcp
        s = mcp.McpServer(device="cpu") if port else mcp.McpServer()
        call = lambda tool, args: json.loads(s.handle({  # noqa: E731
            "jsonrpc": "2.0", "id": 1, "method": "tools/call",
            "params": {"name": tool, "arguments": args}})["result"]["content"][0]["text"])
        call("create_collection", {"name": "c", "dimensions": 16})
        call("insert", {"collection": "c", "vectors": vecs.tolist()})
        cfg = tlayer.RuvectorLayerConfig(16, 16, heads=4) if port else jcfg
        s.trained["c"] = ([params_from_numpy(init, "cpu") if port else
                           jax.tree_util.tree_map(jax.numpy.asarray, init)], [cfg])
        out = [call("train", {"collection": "c", "steps": 3})]
        for row in (3, 11):
            q = call("query", {"collection": "c", "vector": vecs[row].tolist(), "mode": mode,
                               "k": 5, "gnn_depth": 1})
            q.pop("latency_ms")
            out.append(q)
        out.append(call("info", {}))
        replies.append(out)
    assert not seen["init"] and len(seen["batches"]) == 3
    assert replies[1][0]["steps"] == 3 and replies[1][-1]["gnn_cache"]["hits"] == 1
    assert_same(replies[1], replies[0], mode, RTOL, ATOL)


def test_mcp_train_without_a_negative_fails_instead_of_hanging():
    """48 rows under the HNSW level-0 degree (2m = 64): every node
    neighbours all others, so no negative exists. The port's
    `sample_negatives` raises and the tool answers isError; the JAX
    package's draws for ever (not run here)."""
    s = tmcp.McpServer(device="cpu")
    vecs = np.random.default_rng(2).normal(size=(48, 16)).astype(np.float32)
    s.handle({"jsonrpc": "2.0", "id": 1, "method": "tools/call", "params": {
        "name": "create_collection", "arguments": {"name": "c", "dimensions": 16}}})
    s.handle({"jsonrpc": "2.0", "id": 2, "method": "tools/call", "params": {
        "name": "insert", "arguments": {"collection": "c", "vectors": vecs.tolist()}}})
    resp = s.handle({"jsonrpc": "2.0", "id": 3, "method": "tools/call", "params": {
        "name": "train", "arguments": {"collection": "c", "steps": 1}}})
    assert resp["result"]["isError"]
    assert "no negative" in resp["result"]["content"][0]["text"]


# --- the HNSW index under concurrent inserts and searches ----------------------

def test_hnsw_searches_during_inserts_stay_valid():
    """The native insert may move the index's storage while a search on
    another thread reads it (the call releases the GIL; without the
    wrapper's readers-writer lock the process crashed, in the JAX package
    too). Four threads search while 20,000 rows go in one at a time: every
    answer names rows that exist, at finite distances."""
    idx = HnswIndex(HnswConfig(dim=8, m=8, ef_construction=32), device="cpu")
    rng = np.random.default_rng(0)
    rows = rng.normal(size=(20_000, 8)).astype(np.float32)
    idx.add_batch(rows[:10])
    stop, bad, done = threading.Event(), [], [0]

    def reader(seed):
        r = np.random.default_rng(seed)
        while not stop.is_set():
            n = len(idx)
            ids, d = idx.search(r.normal(size=8).astype(np.float32), k=5, ef=32)
            live = ids >= 0
            if (ids[live] >= len(idx)).any() or not np.isfinite(d[live]).all() or live.sum() < min(5, n):
                bad.append((ids, d))
            done[0] += 1

    threads = [threading.Thread(target=reader, args=(s,)) for s in range(4)]
    for t in threads:
        t.start()
    for v in rows[10:]:
        idx.add(v)
    stop.set()
    for t in threads:
        t.join()
    assert not bad and done[0] > 0 and len(idx) == 20_000


def test_entry_points_take_the_requested_device(tmp_path, capsys):
    server = tserver.RuvectorServer(port=0, device="cpu")
    try:
        assert server.state.device == torch.device("cpu")
        assert server.state.sql.device == torch.device("cpu")
    finally:
        server.httpd.server_close()
    assert tmcp.McpServer(device="cpu").device == torch.device("cpu")
    tmain.main(["--device", "cpu", "create", str(tmp_path / "c"), "--dim", "4"])
    assert "created collection" in capsys.readouterr().out
