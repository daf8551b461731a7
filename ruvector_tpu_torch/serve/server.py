"""HTTP serving front-end, stdlib only (port of ruvector_tpu/serve/server.py).

Reference: ruvector-server — axum HTTP with Qdrant-style routes
(lib.rs:69-115): PUT/GET /collections/{name}, PUT /collections/{name}/points,
POST /collections/{name}/points/search, /health, /ready, /metrics.

Implemented over http.server (no external deps); state is a dict of
VectorDB collections on one device (default: the CUDA card). Upserts,
point reads, DELETE, scroll and /sql run under the state's lock; searches
run outside it, on the handler threads, as in the JAX package (the HNSW
index serialises its own inserts against searches).
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from ruvector_tpu_torch.device import resolve_device
from ruvector_tpu_torch.index.vector_db import DbOptions, VectorDB
from ruvector_tpu_torch.utils.metrics import MetricsRegistry


class ServerState:
    def __init__(self, device=None):
        self.device = resolve_device(device)
        self.collections: dict[str, VectorDB] = {}
        self.metrics = MetricsRegistry()
        self.lock = threading.Lock()
        self._sql = None            # lazy SqlEngine for the /sql route

    @property
    def sql(self):
        if self._sql is None:
            from ruvector_tpu_torch.serve.sql import SqlEngine
            self._sql = SqlEngine(device=self.device)
        return self._sql


def make_handler(state: ServerState):
    search_hist = state.metrics.histogram("search_latency_seconds")
    insert_counter = state.metrics.counter("points_upserted_total")

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):   # quiet
            pass

        def _json(self, code: int, payload):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _read_body(self):
            length = int(self.headers.get("Content-Length", 0))
            return json.loads(self.rfile.read(length) or b"{}")

        def do_GET(self):
            if self.path == "/health":
                return self._json(200, state.metrics.health())
            if self.path == "/ready":
                return self._json(200, state.metrics.ready())
            if self.path == "/metrics":
                body = state.metrics.expose().encode()
                self.send_response(200)
                self.send_header("Content-Type", "text/plain")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
                return
            if self.path == "/collections":
                return self._json(200, {"result": {
                    "collections": [
                        {"name": n, "points_count": len(db)}
                        for n, db in state.collections.items()
                    ]}})
            parts = self.path.strip("/").split("/")
            if len(parts) == 2 and parts[0] == "collections":
                db = state.collections.get(parts[1])
                if db is None:
                    return self._json(404, {"status": "not found"})
                return self._json(200, {"result": {
                    "name": parts[1], "points_count": len(db),
                    "config": {"params": {"vectors": {
                        "size": db.options.dimensions,
                        "distance": db.options.metric}}},
                }})
            # GET /collections/:name/points/:id (routes/points.rs:59)
            if len(parts) == 4 and parts[0] == "collections" \
                    and parts[2] == "points":
                db = state.collections.get(parts[1])
                if db is None:
                    return self._json(404, {"status": "not found"})
                pid = parts[3]
                vid = int(pid) if pid.lstrip("-").isdigit() else pid
                with state.lock:   # concurrent upsert mutates _id_to_idx
                    vec = db.get(vid)
                    if vec is None:
                        return self._json(404, {"status": "not found"})
                    idx = db._id_to_idx[vid]
                    payload = db._payloads.get(idx)
                return self._json(200, {"result": {
                    "id": vid, "vector": vec.tolist(),
                    **({"payload": payload} if payload is not None else {}),
                }})
            self._json(404, {"status": "not found"})

        def do_DELETE(self):
            # DELETE /collections/:name (routes/collections.rs:48)
            parts = self.path.strip("/").split("/")
            if len(parts) == 2 and parts[0] == "collections":
                with state.lock:
                    gone = state.collections.pop(parts[1], None)
                if gone is None:
                    return self._json(404, {"status": "not found"})
                return self._json(200, {"result": True, "status": "ok"})
            self._json(404, {"status": "not found"})

        def do_PUT(self):
            parts = self.path.strip("/").split("/")
            body = self._read_body()
            if len(parts) == 2 and parts[0] == "collections":
                vectors = body.get("vectors", {})
                dim = int(vectors.get("size", body.get("size", 0)))
                metric = vectors.get("distance", "cosine").lower()
                metric = "cosine" if metric.startswith("cos") else "l2"
                with state.lock:
                    state.collections[parts[1]] = VectorDB(
                        DbOptions(dimensions=dim, metric=metric), device=state.device
                    )
                return self._json(200, {"result": True, "status": "ok"})
            if len(parts) == 3 and parts[2] == "points":
                db = state.collections.get(parts[1])
                if db is None:
                    return self._json(404, {"status": "not found"})
                points = body.get("points", [])
                with state.lock:
                    for p in points:
                        db.insert(np.asarray(p["vector"], np.float32),
                                  id=p.get("id"), payload=p.get("payload"))
                insert_counter.inc(len(points), collection=parts[1])
                return self._json(200, {"result": {"status": "acknowledged"}})
            self._json(404, {"status": "not found"})

        def do_POST(self):
            parts = self.path.strip("/").split("/")
            # POST /sql {"sql": "..."} — pgvector/ruvector SQL surface
            if parts == ["sql"]:
                from ruvector_tpu_torch.serve.sql import SqlError
                body = self._read_body()
                try:
                    with state.lock:
                        out = state.sql.execute(body.get("sql", ""))
                except SqlError as exc:
                    return self._json(400, {"status": "error",
                                            "error": str(exc)})
                return self._json(200, {"result": out})
            # POST /collections/:name/points/scroll — paginated listing
            # with optional payload filter (Qdrant scroll surface)
            if len(parts) == 4 and parts[2] == "points" \
                    and parts[3] == "scroll":
                db = state.collections.get(parts[1])
                if db is None:
                    return self._json(404, {"status": "not found"})
                body = self._read_body()
                limit = int(body.get("limit", 10))
                offset = body.get("offset")
                flt = None
                if body.get("filter"):
                    from ruvector_tpu_torch.index.filter import (
                        matches as _fm,
                        parse_qdrant_filter as _pf,
                    )

                    spec = _pf(body["filter"])
                    flt = lambda p: _fm(p, spec)  # noqa: E731
                points = []
                next_offset = None
                started = offset is None
                with state.lock:   # snapshot vs concurrent upsert
                    for idx_i, vid in enumerate(db._ids):
                        if not started:
                            if vid == offset:
                                started = True
                            else:
                                continue
                        payload = db._payloads.get(idx_i)
                        if flt is not None and not flt(payload):
                            continue
                        if len(points) == limit:
                            next_offset = vid
                            break
                        points.append({
                            "id": vid,
                            **({"payload": payload} if payload else {}),
                            **({"vector": db._vectors[idx_i].tolist()}
                               if body.get("with_vector") else {}),
                        })
                return self._json(200, {"result": {
                    "points": points, "next_page_offset": next_offset}})
            if len(parts) == 4 and parts[2] == "points" and parts[3] == "search":
                db = state.collections.get(parts[1])
                if db is None:
                    return self._json(404, {"status": "not found"})
                body = self._read_body()
                with search_hist.time(collection=parts[1]):
                    res = db.search(
                        np.asarray(body["vector"], np.float32),
                        k=int(body.get("limit", 10)),
                        with_vectors=bool(body.get("with_vector", False)),
                        filter=body.get("filter"),
                    )
                return self._json(200, {"result": [
                    {"id": r.id, "score": r.score,
                     **({"payload": r.payload} if r.payload else {}),
                     **({"vector": r.vector.tolist()}
                        if r.vector is not None else {})}
                    for r in res
                ]})
            self._json(404, {"status": "not found"})

    return Handler


class RuvectorServer:
    """Threaded HTTP server wrapper: start()/stop() for embedding in tests
    or `python -m ruvector_tpu_torch serve` for standalone. Its collections
    and SQL engine live on `device` (default: the CUDA card)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 6333, device=None):
        self.state = ServerState(device)
        self.httpd = ThreadingHTTPServer((host, port), make_handler(self.state))
        self.port = self.httpd.server_port
        self._thread: threading.Thread | None = None

    def start(self):
        self._thread = threading.Thread(target=self.httpd.serve_forever,
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self.httpd.shutdown()
        if self._thread:
            self._thread.join(timeout=5)
        self.httpd.server_close()
