"""CLI: create / insert / search / info / benchmark / serve (port of
ruvector_tpu/__main__.py).

Reference: ruvector-cli (clap CLI, main.rs:36-260) — the operational surface
for the framework, argparse-based, collections persisted as npz files in
the JAX package's layout (`meta.json`, `vectors.npz` with object arrays), so
a collection written by either package opens in the other.

The top-level `--device` (default: cuda) chooses where collections, the
server, the MCP server and the SQL engine run: `python -m ruvector_tpu_torch
--device cpu info <path>` runs on the CPU; without a card, the default
raises.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np

from ruvector_tpu_torch.device import resolve_device


def _load_db(path: Path, device):
    from ruvector_tpu_torch.index.vector_db import DbOptions, VectorDB

    meta = json.loads((path / "meta.json").read_text())
    db = VectorDB(DbOptions(**meta["options"]), device=device)
    data = np.load(path / "vectors.npz", allow_pickle=True)
    vecs = data["vectors"]
    ids = data["ids"].tolist()
    payloads = data["payloads"].tolist()
    if len(vecs):
        db.insert_batch(vecs, ids=ids, payloads=payloads)
    return db


def _save_db(db, path: Path):
    path.mkdir(parents=True, exist_ok=True)
    (path / "meta.json").write_text(json.dumps({
        "options": {
            "dimensions": db.options.dimensions,
            "metric": db.options.metric,
            "m": db.options.m,
            "ef_construction": db.options.ef_construction,
            "ef_search": db.options.ef_search,
        }
    }))
    np.savez(
        path / "vectors.npz",
        vectors=np.stack(db._vectors) if db._vectors else np.zeros((0, db.options.dimensions), np.float32),
        ids=np.asarray(db._ids, dtype=object),
        payloads=np.asarray([db._payloads.get(i) for i in range(len(db._vectors))],
                            dtype=object),
    )


def main(argv=None):
    p = argparse.ArgumentParser(prog="ruvector_tpu_torch")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default: cuda; cpu runs on the host)")
    sub = p.add_subparsers(dest="cmd", required=True)

    c = sub.add_parser("create", help="create a collection")
    c.add_argument("path")
    c.add_argument("--dim", type=int, required=True)
    c.add_argument("--metric", default="cosine")

    i = sub.add_parser("insert", help="insert vectors from a .npy file")
    i.add_argument("path")
    i.add_argument("--vectors", required=True)

    s = sub.add_parser("search", help="search with a query vector (json list)")
    s.add_argument("path")
    s.add_argument("--query", required=True)
    s.add_argument("-k", type=int, default=10)

    sub.add_parser("info", help="collection info").add_argument("path")

    b = sub.add_parser("benchmark", help="insert+search micro benchmark")
    b.add_argument("--dim", type=int, default=128)
    b.add_argument("--n", type=int, default=10000)
    b.add_argument("--queries", type=int, default=100)

    sv = sub.add_parser("serve", help="start the HTTP server")
    sv.add_argument("--host", default="127.0.0.1")
    sv.add_argument("--port", type=int, default=6333)

    ex = sub.add_parser("export", help="export a collection to one .npz")
    ex.add_argument("path")
    ex.add_argument("out")

    im = sub.add_parser("import", help="import a collection from an export")
    im.add_argument("archive")
    im.add_argument("path")

    sub.add_parser("mcp", help="start the MCP (Model Context Protocol) "
                                "stdio server for agent integration")

    gb = sub.add_parser("graph-build",
                        help="build a kNN NeighborGraph from a collection")
    gb.add_argument("path")
    gb.add_argument("out")
    gb.add_argument("--k", type=int, default=16)

    gq = sub.add_parser("graph-query",
                        help="run a Cypher query against a property graph "
                             "(edge-list/.jsonl/.cypher file)")
    gq.add_argument("path")
    gq.add_argument("query")
    gs = sub.add_parser("graph-shell",
                        help="interactive Cypher shell over a property graph")
    gs.add_argument("path")
    mc = sub.add_parser(
        "mincut", help="min cut of an edge-list file (global, or s-t "
                       "with --source/--sink); prints value, partition "
                       "sizes and cut edges")
    mc.add_argument("path", help="TSV/CSV: src dst [weight]")
    mc.add_argument("--source", type=int, default=None)
    mc.add_argument("--sink", type=int, default=None)
    mc.add_argument("--json", action="store_true")
    sq = sub.add_parser(
        "sql", help="pgvector/ruvector-compatible SQL shell (or -c one-shot) "
                    "over the in-process engine")
    sq.add_argument("-c", "--command", default=None,
                    help="execute one ';'-separated script and exit")
    sq.add_argument("-f", "--file", default=None,
                    help="execute statements from a .sql file and exit")

    args = p.parse_args(argv)
    device = resolve_device(args.device)

    if args.cmd == "sql":
        from ruvector_tpu_torch.serve.sql import SqlEngine, SqlError

        eng = SqlEngine(device=device)

        def _run_script(text: str):
            try:
                out = eng.execute(text)
            except SqlError as exc:
                print(f"ERROR: {exc}")
                return
            if isinstance(out, list):
                for row in out:
                    print(json.dumps(row))
            else:
                print(out)

        if args.command or args.file:
            script = args.command or Path(args.file).read_text()
            _run_script(script)
            return
        print("ruvector sql shell — end statements with ';', "
              "\\q to quit")
        buf = ""
        while True:
            try:
                line = input("sql> " if not buf else "...> ")
            except EOFError:
                break
            if line.strip() in ("\\q", "quit", "exit"):
                break
            buf += line + "\n"
            if line.rstrip().endswith(";"):
                _run_script(buf)
                buf = ""
        return

    if args.cmd == "mcp":
        from ruvector_tpu_torch.serve.mcp import McpServer

        McpServer(device=device).serve_stdio()
        return

    if args.cmd == "create":
        from ruvector_tpu_torch.index.vector_db import DbOptions, VectorDB

        db = VectorDB(DbOptions(dimensions=args.dim, metric=args.metric), device=device)
        _save_db(db, Path(args.path))
        print(f"created collection at {args.path} (dim={args.dim})")

    elif args.cmd == "insert":
        db = _load_db(Path(args.path), device)
        vecs = np.load(args.vectors)
        t0 = time.perf_counter()
        db.insert_batch(vecs.astype(np.float32))
        dt = time.perf_counter() - t0
        _save_db(db, Path(args.path))
        print(f"inserted {len(vecs)} vectors in {dt:.3f}s "
              f"({len(vecs)/dt:.0f}/s)")

    elif args.cmd == "search":
        db = _load_db(Path(args.path), device)
        q = np.asarray(json.loads(args.query), np.float32)
        t0 = time.perf_counter()
        res = db.search(q, k=args.k)
        dt = (time.perf_counter() - t0) * 1e3
        print(json.dumps({
            "results": [{"id": r.id, "score": round(r.score, 6)} for r in res],
            "latency_ms": round(dt, 3),
        }))

    elif args.cmd == "info":
        db = _load_db(Path(args.path), device)
        print(json.dumps({
            "points_count": len(db),
            "dimensions": db.options.dimensions,
            "metric": db.options.metric,
        }))

    elif args.cmd == "benchmark":
        from ruvector_tpu_torch.index.vector_db import DbOptions, VectorDB

        rng = np.random.default_rng(0)
        data = rng.normal(size=(args.n, args.dim)).astype(np.float32)
        db = VectorDB(DbOptions(dimensions=args.dim), device=device)
        t0 = time.perf_counter()
        db.insert_batch(data)
        insert_dt = time.perf_counter() - t0
        queries = rng.normal(size=(args.queries, args.dim)).astype(np.float32)
        t0 = time.perf_counter()
        for q in queries:
            db.search(q, k=10)
        search_dt = time.perf_counter() - t0
        print(json.dumps({
            "insert_per_s": round(args.n / insert_dt, 1),
            "search_qps": round(args.queries / search_dt, 1),
            "search_p50_ms": round(search_dt / args.queries * 1e3, 3),
        }))

    elif args.cmd == "export":
        # single-archive export (ruvector-cli export): vectors + ids +
        # payloads + options in one npz
        db = _load_db(Path(args.path), device)
        np.savez_compressed(
            args.out,
            vectors=np.stack(db._vectors) if db._vectors
            else np.zeros((0, db.options.dimensions), np.float32),
            ids=np.asarray(db._ids, dtype=object),
            payloads=np.asarray(
                [db._payloads.get(i) for i in range(len(db._vectors))],
                dtype=object),
            options=np.asarray(json.dumps({
                "dimensions": db.options.dimensions,
                "metric": db.options.metric,
            }), dtype=object),
        )
        print(f"exported {len(db)} points to {args.out}")

    elif args.cmd == "import":
        from ruvector_tpu_torch.index.vector_db import DbOptions, VectorDB

        data = np.load(args.archive, allow_pickle=True)
        opts = json.loads(str(data["options"]))
        db = VectorDB(DbOptions(**opts), device=device)
        vecs = data["vectors"]
        if len(vecs):
            db.insert_batch(vecs, ids=data["ids"].tolist(),
                            payloads=data["payloads"].tolist())
        _save_db(db, Path(args.path))
        print(f"imported {len(vecs)} points into {args.path}")

    elif args.cmd == "graph-build":
        from ruvector_tpu_torch.device import block_until_ready
        from ruvector_tpu_torch.graph import build_knn_graph

        db = _load_db(Path(args.path), device)
        feats = np.stack(db._vectors)
        t0 = time.perf_counter()
        graph = build_knn_graph(feats, k=args.k, device=device)
        block_until_ready([graph.nbr_idx, graph.edge_weight])
        dt = time.perf_counter() - t0
        np.savez(args.out,
                 nbr_idx=graph.nbr_idx.cpu().numpy(),
                 nbr_mask=graph.nbr_mask.cpu().numpy(),
                 edge_weight=graph.edge_weight.cpu().numpy())
        print(f"built k={args.k} graph over {len(feats)} nodes in {dt:.2f}s "
              f"-> {args.out}")

    elif args.cmd in ("graph-query", "graph-shell"):
        from ruvector_tpu_torch.graph.cypher import cypher_shell, execute_cypher
        from ruvector_tpu_torch.graph.property import PNode, PropertyGraph

        path = Path(args.path)
        if path.suffix == ".jsonl":
            pg = PropertyGraph.from_jsonl(str(path))
        elif path.suffix == ".cypher":
            pg = PropertyGraph.from_cypher(path.read_text())
        else:
            pg = PropertyGraph.from_edge_file(str(path))
        if args.cmd == "graph-query":
            for row in execute_cypher(pg, args.query):
                print(json.dumps({
                    k: (v.id if isinstance(v, PNode) else v)
                    for k, v in row.items()}, default=str))
        else:
            cypher_shell(pg)

    elif args.cmd == "mincut":
        import json as _json

        from ruvector_tpu_torch.mincut import DynamicMinCut

        edges = []
        n_max = 0
        with open(args.path) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                parts = line.replace(",", " ").split()
                if len(parts) < 2:
                    continue
                u, v = int(parts[0]), int(parts[1])
                w = float(parts[2]) if len(parts) > 2 else 1.0
                edges.append((u, v, w))
                n_max = max(n_max, u, v)
        mcut = DynamicMinCut(n_max + 1, source=args.source, sink=args.sink)
        for u, v, w in edges:
            mcut.insert_edge(u, v, w)
        val = mcut.cut_value()
        side = mcut.partition()
        cut = mcut.cut_edges()
        if args.json:
            print(_json.dumps({
                "value": val, "cut_edges": [list(e) for e in cut],
                "side_a": int(side.sum()),
                "side_b": int((~side).sum()),
                "mode": "global" if args.source is None else "s-t",
            }))
        else:
            mode = ("global" if args.source is None
                    else f"s-t ({args.source}->{mcut.sink})")
            print(f"{mode} min cut: value={val:.6g}, "
                  f"sides {int(side.sum())}/{int((~side).sum())}, "
                  f"{len(cut)} crossing edges")
            for u, v in cut[:20]:
                print(f"  {u} - {v}")
            if len(cut) > 20:
                print(f"  ... {len(cut) - 20} more")

    elif args.cmd == "serve":
        from ruvector_tpu_torch.serve.server import RuvectorServer

        server = RuvectorServer(args.host, args.port, device=device)
        print(f"serving on http://{args.host}:{server.port}")
        server.start()
        try:
            while True:
                time.sleep(3600)
        except KeyboardInterrupt:
            server.stop()


if __name__ == "__main__":
    main()
