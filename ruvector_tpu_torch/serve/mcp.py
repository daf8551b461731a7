"""MCP (Model Context Protocol) server — the agent-facing control surface
(port of ruvector_tpu/serve/mcp.py).

Reference: ruvector-cli's MCP server (ruvector-cli/src/main.rs:36,168-260)
with its GNN layer LRU cache (mcp/gnn_cache.rs:1-100 — the reference
caches constructed GNN layers behind an LRU with TTL because cold layer
init costs ~2.5s). Here the cache keeps live query engines: each holds the
collection's features and neighbour graph on the device and its GNN
embeddings once computed, so a repeated query skips the copy to the card
and the GNN stack.

Transport: JSON-RPC 2.0 over stdio (one JSON object per line), the MCP
stdio framing. Methods: initialize, tools/list, tools/call, ping.
Tools: create_collection, insert, search, query (4 QueryModes via
serve/query.py), train (contrastive GNN update), info.

Run: `python -m ruvector_tpu_torch mcp` (stdio) — no external dependencies.
Collections, engines and training run on the server's device (default: the
CUDA card).
"""

from __future__ import annotations

import json
import sys
import time
from collections import OrderedDict

import numpy as np
import torch

from ruvector_tpu_torch.device import resolve_device

PROTOCOL_VERSION = "2024-11-05"
SERVER_INFO = {"name": "ruvector-tpu", "version": "0.2.0"}


class GnnProgramCache:
    """LRU+TTL cache of live query engines (mcp/gnn_cache.rs role).

    Keyed by (collection, gnn_depth); entries hold a QueryEngine whose
    device copies and GNN embedding cache stay warm across MCP calls —
    without it every `query` call would copy the collection to the device
    and re-run the stack.
    """

    def __init__(self, capacity: int = 8, ttl_s: float = 600.0):
        self.capacity = capacity
        self.ttl_s = ttl_s
        self._entries: OrderedDict[tuple, tuple[float, object]] = OrderedDict()
        self.hits = 0
        self.misses = 0

    def get(self, key):
        now = time.time()
        entry = self._entries.get(key)
        if entry is not None and now - entry[0] <= self.ttl_s:
            self._entries.move_to_end(key)
            self._entries[key] = (now, entry[1])
            self.hits += 1
            return entry[1]
        if entry is not None:
            del self._entries[key]
        self.misses += 1
        return None

    def put(self, key, value):
        self._entries[key] = (time.time(), value)
        self._entries.move_to_end(key)
        while len(self._entries) > self.capacity:
            self._entries.popitem(last=False)

    def stats(self) -> dict:
        return {"entries": len(self._entries), "hits": self.hits,
                "misses": self.misses, "capacity": self.capacity,
                "ttl_s": self.ttl_s}


TOOLS = [
    {
        "name": "create_collection",
        "description": "Create a vector collection (HNSW or flat MXU index).",
        "inputSchema": {
            "type": "object",
            "properties": {
                "name": {"type": "string"},
                "dimensions": {"type": "integer"},
                "metric": {"type": "string", "enum": ["cosine", "l2"]},
                "index_type": {"type": "string", "enum": ["hnsw", "flat"]},
            },
            "required": ["name", "dimensions"],
        },
    },
    {
        "name": "insert",
        "description": "Insert vectors (list of lists) with optional ids/payloads.",
        "inputSchema": {
            "type": "object",
            "properties": {
                "collection": {"type": "string"},
                "vectors": {"type": "array"},
                "ids": {"type": "array"},
                "payloads": {"type": "array"},
            },
            "required": ["collection", "vectors"],
        },
    },
    {
        "name": "search",
        "description": "ANN search: top-k nearest vectors.",
        "inputSchema": {
            "type": "object",
            "properties": {
                "collection": {"type": "string"},
                "vector": {"type": "array"},
                "k": {"type": "integer"},
                "filter": {"type": "object",
                           "description": "Qdrant-style payload filter "
                                          "(must/should/must_not)"},
            },
            "required": ["collection", "vector"],
        },
    },
    {
        "name": "query",
        "description": ("Graph-intelligence query: modes vector_search, "
                        "neural_search (GNN re-rank), subgraph_extraction, "
                        "differentiable_search."),
        "inputSchema": {
            "type": "object",
            "properties": {
                "collection": {"type": "string"},
                "vector": {"type": "array"},
                "mode": {"type": "string"},
                "k": {"type": "integer"},
                "gnn_depth": {"type": "integer"},
                "temperature": {"type": "number"},
            },
            "required": ["collection", "vector"],
        },
    },
    {
        "name": "train",
        "description": ("Run contrastive GNN training steps on the "
                        "collection graph (query-feedback learning loop)."),
        "inputSchema": {
            "type": "object",
            "properties": {
                "collection": {"type": "string"},
                "steps": {"type": "integer"},
                "learning_rate": {"type": "number"},
            },
            "required": ["collection"],
        },
    },
    {
        "name": "info",
        "description": "Collection stats + GNN program cache stats.",
        "inputSchema": {
            "type": "object",
            "properties": {"collection": {"type": "string"}},
        },
    },
    {
        "name": "graph_mincut",
        "description": ("Minimum cut of a collection's kNN neighbor "
                        "graph: how separable the corpus is. Global by "
                        "default; pass source+sink ids for s-t. Returns "
                        "value, side sizes and crossing edges."),
        "inputSchema": {
            "type": "object",
            "properties": {
                "collection": {"type": "string"},
                "k": {"type": "integer"},
                "source": {"type": "integer"},
                "sink": {"type": "integer"},
            },
            "required": ["collection"],
        },
    },
    {
        "name": "sql",
        "description": ("Execute pgvector/ruvector-compatible SQL against "
                        "the in-process engine: ruvector(D) columns, "
                        "<->/<#>/<=> operators, CREATE INDEX ... USING "
                        "hnsw, EXPLAIN, ruvector_* functions incl. "
                        "ruvector_gnn_train. State persists for the "
                        "session."),
        "inputSchema": {
            "type": "object",
            "properties": {"sql": {"type": "string"}},
            "required": ["sql"],
        },
    },
]


def _draw_batch(gen: torch.Generator, graph, batch: int, n_negatives: int):
    """One training batch: uniform anchors and their negatives, both drawn
    from the CPU generator `gen` (int32 tensors on the CPU)."""
    from ruvector_tpu_torch.training.train import sample_negatives

    anchors = torch.randint(0, graph.num_nodes, (batch,), generator=gen).to(torch.int32)
    return anchors, sample_negatives(gen, graph, anchors, n_negatives)


class McpServer:
    """Stateful MCP server over (reader, writer) line streams; its
    collections and engines live on `device` (default: the CUDA card)."""

    def __init__(self, device=None):
        self.device = resolve_device(device)
        self.collections: dict[str, object] = {}
        self.trained: dict[str, tuple] = {}   # name -> (params list, cfg list)
        self.cache = GnnProgramCache()
        self._sql = None                      # lazy SqlEngine

    def _sql_tool(self, args):
        from ruvector_tpu_torch.serve.sql import SqlEngine

        if self._sql is None:
            self._sql = SqlEngine(device=self.device)
        out = self._sql.execute(args["sql"])
        return {"result": out}

    # --- tool implementations ---

    def _create_collection(self, args: dict) -> dict:
        from ruvector_tpu_torch.index.vector_db import DbOptions, VectorDB

        opts = DbOptions(
            dimensions=int(args["dimensions"]),
            metric=args.get("metric", "cosine"),
            index_type=args.get("index_type", "hnsw"),
        )
        name = args["name"]
        self.collections[name] = VectorDB(opts, device=self.device)
        return {"created": name, "dimensions": opts.dimensions}

    def _db(self, name: str):
        db = self.collections.get(name)
        if db is None:
            raise ValueError(f"unknown collection '{name}'")
        return db

    def _insert(self, args: dict) -> dict:
        db = self._db(args["collection"])
        vecs = np.asarray(args["vectors"], np.float32)
        ids = db.insert_batch(vecs, args.get("ids"), args.get("payloads"))
        # engines for this collection are stale now
        for key in [k for k in list(self.cache._entries)
                    if k[0] == args["collection"]]:
            del self.cache._entries[key]
        return {"inserted": len(ids), "ids": ids[:32]}

    def _search(self, args: dict) -> dict:
        db = self._db(args["collection"])
        res = db.search(np.asarray(args["vector"], np.float32),
                        k=int(args.get("k", 10)),
                        filter=args.get("filter"))
        return {"results": [{"id": r.id, "score": r.score,
                             **({"payload": r.payload} if r.payload
                                else {})} for r in res]}

    def _engine(self, name: str, depth: int):
        from ruvector_tpu_torch.serve.query import QueryEngine

        key = (name, depth)
        engine = self.cache.get(key)
        if engine is None:
            db = self._db(name)
            params, cfgs = self.trained.get(name, ([], []))
            engine = QueryEngine(db.features_matrix(), db.neighbor_graph(),
                                 params, cfgs)
            self.cache.put(key, engine)
        return engine

    def _query(self, args: dict) -> dict:
        from ruvector_tpu_torch.serve.query import QueryMode, RuvectorQuery

        mode = QueryMode[args.get("mode", "vector_search").upper()]
        depth = int(args.get("gnn_depth", 2))
        engine = self._engine(args["collection"], depth)
        q = RuvectorQuery(
            vector=np.asarray(args["vector"], np.float32), mode=mode,
            k=int(args.get("k", 10)), gnn_depth=depth,
            temperature=float(args.get("temperature", 1.0)),
        )
        r = engine.execute(q)
        out = {"nodes": r.nodes, "scores": r.scores,
               "latency_ms": r.latency_ms}
        if r.subgraph is not None:
            out["subgraph"] = {"nodes": r.subgraph.nodes,
                               "edges": r.subgraph.edges}
        return out

    def _train(self, args: dict) -> dict:
        from ruvector_tpu_torch.nn.ruvector_layer import (
            RuvectorLayerConfig,
            ruvector_layer_init,
        )
        from ruvector_tpu_torch.training.optimizers import adam
        from ruvector_tpu_torch.training.train import TrainConfig, make_train_step

        name = args["collection"]
        db = self._db(name)
        feats = db.features_matrix()
        graph = db.neighbor_graph()
        d = feats.shape[1]
        cfg = RuvectorLayerConfig(input_dim=d, hidden_dim=d, heads=4)
        params_list, _ = self.trained.get(name, ([], []))
        params = params_list[0] if params_list else ruvector_layer_init(
            0, cfg, device=self.device)
        steps = int(args.get("steps", 10))
        lr = float(args.get("learning_rate", 1e-3))
        bs = min(64, len(db))
        tcfg = TrainConfig(batch_size=bs, n_negatives=min(16, len(db)),
                           learning_rate=lr)
        opt = adam(lr)
        step_fn = make_train_step(cfg, opt, tcfg)
        opt_state = opt.init(params)
        gen = torch.Generator().manual_seed(0)
        losses = []
        for _ in range(steps):
            anchors, negs = _draw_batch(gen, graph, bs, tcfg.n_negatives)
            params, opt_state, loss = step_fn(
                params, opt_state, feats, graph,
                anchors.to(self.device), negs.to(self.device))
            losses.append(float(loss))
        self.trained[name] = ([params], [cfg])
        for key in [k for k in list(self.cache._entries) if k[0] == name]:
            del self.cache._entries[key]
        return {"steps": steps, "loss_first": losses[0],
                "loss_last": losses[-1]}

    def _info(self, args: dict) -> dict:
        out = {"collections": {
            name: {"vectors": len(db),
                   "dimensions": db.options.dimensions,
                   "trained_gnn_layers": len(self.trained.get(name,
                                                              ([], []))[0])}
            for name, db in self.collections.items()
        }, "gnn_cache": self.cache.stats()}
        return out

    def _graph_mincut(self, args: dict) -> dict:
        from ruvector_tpu_torch.graph import build_knn_graph
        from ruvector_tpu_torch.mincut import DynamicMinCut

        db = self.collections[args["collection"]]
        k = int(args.get("k", 8))
        g = build_knn_graph(db.features_matrix(), k=min(k, len(db) - 1),
                            device=self.device)
        idx = g.nbr_idx.cpu().numpy()
        ew = g.edge_weight.cpu().numpy()
        mask = g.nbr_mask.cpu().numpy()
        src = args.get("source")
        mc = DynamicMinCut(len(db),
                           source=None if src is None else int(src),
                           sink=args.get("sink"))
        for i in range(idx.shape[0]):
            for j in range(idx.shape[1]):
                if mask[i, j] > 0:
                    mc.insert_edge(i, int(idx[i, j]), float(ew[i, j]))
        side = mc.partition()
        return {
            "mode": "global" if src is None else "s-t",
            "value": float(mc.cut_value()),
            "side_a": int(side.sum()),
            "side_b": int((~side).sum()),
            "cut_edges": [list(e) for e in mc.cut_edges()[:50]],
        }

    # --- JSON-RPC dispatch ---

    def handle(self, msg: dict) -> dict | None:
        mid = msg.get("id")
        method = msg.get("method", "")
        try:
            if method == "initialize":
                result = {
                    "protocolVersion": PROTOCOL_VERSION,
                    "serverInfo": SERVER_INFO,
                    "capabilities": {"tools": {}},
                }
            elif method == "notifications/initialized":
                return None
            elif method == "ping":
                result = {}
            elif method == "tools/list":
                result = {"tools": TOOLS}
            elif method == "tools/call":
                p = msg.get("params", {})
                tool = p.get("name")
                args = p.get("arguments", {}) or {}
                fn = {
                    "create_collection": self._create_collection,
                    "insert": self._insert,
                    "search": self._search,
                    "query": self._query,
                    "train": self._train,
                    "info": self._info,
                    "graph_mincut": self._graph_mincut,
                    "sql": self._sql_tool,
                }.get(tool)
                if fn is None:
                    raise ValueError(f"unknown tool '{tool}'")
                payload = fn(args)
                result = {"content": [
                    {"type": "text", "text": json.dumps(payload)}]}
            else:
                if mid is None:
                    return None
                return {"jsonrpc": "2.0", "id": mid,
                        "error": {"code": -32601,
                                  "message": f"method not found: {method}"}}
            if mid is None:
                return None
            return {"jsonrpc": "2.0", "id": mid, "result": result}
        except Exception as e:  # tool errors -> isError result, rpc stays up
            if mid is None:
                return None
            if method == "tools/call":
                return {"jsonrpc": "2.0", "id": mid, "result": {
                    "isError": True,
                    "content": [{"type": "text", "text": str(e)}]}}
            return {"jsonrpc": "2.0", "id": mid,
                    "error": {"code": -32000, "message": str(e)}}

    def serve_stdio(self, stdin=None, stdout=None):
        """Blocking loop: one JSON-RPC message per line."""
        stdin = stdin or sys.stdin
        stdout = stdout or sys.stdout
        for line in stdin:
            line = line.strip()
            if not line:
                continue
            try:
                msg = json.loads(line)
            except json.JSONDecodeError:
                continue
            resp = self.handle(msg)
            if resp is not None:
                stdout.write(json.dumps(resp) + "\n")
                stdout.flush()
