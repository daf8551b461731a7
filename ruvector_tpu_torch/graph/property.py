"""Property graph: the ingestion path from graph data to the compute
layouts (port of ruvector_tpu/graph/property.py).

Reference: ruvector-graph/src/graph.rs:17-306 (GraphDB: node/edge/
hyperedge CRUD, label & property lookup, adjacency queries). The
reference is a full database with a Cypher engine; the framework
needs its INPUT path — a property graph that loads from edge lists /
Cypher dumps and lowers to the compute layouts (NeighborGraph padded
slots, CSR, block-dense). Queries over graph compute go through
serve/query.py; this module is storage + conversion only.

Supported sources:
  - in-memory CRUD (add_node/add_edge, by-label/property lookup)
  - edge-list arrays or TSV/CSV files (src, dst[, weight])
  - JSONL dumps (one {"type": "node"|"relationship", ...} per line —
    the neo4j/apoc export shape)
  - a minimal Cypher CREATE subset: `(a:Label {k: v})`,
    `(a)-[:REL {weight: 0.5}]->(b)` — a loader, not a query engine
    (the reference's full parser is cypher/parser.rs, 1295 LoC).
"""

from __future__ import annotations

import dataclasses
import json
import re
from typing import Any, Iterable

import numpy as np


@dataclasses.dataclass
class PNode:
    id: str
    labels: tuple[str, ...] = ()
    properties: dict[str, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class PEdge:
    src: str
    dst: str
    type: str = "RELATED"
    weight: float = 1.0
    properties: dict[str, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class Hyperedge:
    """N-ary relationship (hyperedge.rs:14-80): one edge connecting any
    number of nodes, with type, confidence and properties."""

    id: str
    nodes: tuple[str, ...]
    edge_type: str = "RELATED"
    description: str | None = None
    confidence: float = 1.0
    properties: dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def order(self) -> int:
        return len(self.nodes)

    def contains_node(self, node_id: str) -> bool:
        return str(node_id) in self.nodes

    def contains_all_nodes(self, node_ids) -> bool:
        return all(self.contains_node(i) for i in node_ids)

    def contains_any_node(self, node_ids) -> bool:
        return any(self.contains_node(i) for i in node_ids)

    def unique_nodes(self) -> set[str]:
        return set(self.nodes)


class PropertyGraph:
    """In-memory property graph (graph.rs:17-306 surface, minus storage)."""

    def __init__(self) -> None:
        self._nodes: dict[str, PNode] = {}
        self._edges: list[PEdge] = []
        self._out: dict[str, list[int]] = {}
        self._in: dict[str, list[int]] = {}
        # hyperedge storage + node index (graph.rs:22-45)
        self._hyperedges: dict[str, Hyperedge] = {}
        self._hyper_by_node: dict[str, set[str]] = {}
        self._hyper_seq = 0

    # --- CRUD (graph.rs:107-246) ---

    def add_node(self, node_id: str, labels: Iterable[str] = (),
                 **properties) -> PNode:
        node = PNode(str(node_id), tuple(labels), dict(properties))
        self._nodes[node.id] = node
        self._out.setdefault(node.id, [])
        self._in.setdefault(node.id, [])
        return node

    def get_node(self, node_id: str) -> PNode | None:
        return self._nodes.get(str(node_id))

    def delete_node(self, node_id: str) -> bool:
        nid = str(node_id)
        if nid not in self._nodes:
            return False
        keep = [e for e in self._edges if e.src != nid and e.dst != nid]
        self._nodes.pop(nid)
        self._edges = keep
        self._reindex()
        # hyperedges touching the node shrink; below order 2 they vanish
        for hid in list(self._hyper_by_node.get(nid, ())):
            he = self._hyperedges[hid]
            rest = tuple(x for x in he.nodes if x != nid)
            self.delete_hyperedge(hid)
            if len(rest) >= 2:
                self.add_hyperedge(rest, he.edge_type, id=hid,
                                   description=he.description,
                                   confidence=he.confidence,
                                   **he.properties)
        self._hyper_by_node.pop(nid, None)
        return True

    def add_edge(self, src: str, dst: str, type: str = "RELATED",
                 weight: float = 1.0, **properties) -> PEdge:
        src, dst = str(src), str(dst)
        for nid in (src, dst):
            if nid not in self._nodes:
                self.add_node(nid)
        e = PEdge(src, dst, type, float(weight), dict(properties))
        self._edges.append(e)
        self._out[src].append(len(self._edges) - 1)
        self._in[dst].append(len(self._edges) - 1)
        return e

    # --- hyperedges (graph.rs:22-45 storage + node index;
    #     hyperedge.rs CRUD surface) ---

    def add_hyperedge(self, nodes: Iterable[str], edge_type: str = "RELATED",
                      id: str | None = None, description: str | None = None,
                      confidence: float = 1.0, **properties) -> Hyperedge:
        node_ids = tuple(str(n) for n in nodes)
        if len(node_ids) < 2:
            raise ValueError("a hyperedge connects at least 2 nodes")
        for nid in node_ids:
            if nid not in self._nodes:
                self.add_node(nid)
        if id is None:
            self._hyper_seq += 1
            id = f"h{self._hyper_seq}"
        he = Hyperedge(str(id), node_ids, edge_type, description,
                       float(confidence), dict(properties))
        self._hyperedges[he.id] = he
        for nid in he.unique_nodes():
            self._hyper_by_node.setdefault(nid, set()).add(he.id)
        return he

    def get_hyperedge(self, he_id: str) -> Hyperedge | None:
        return self._hyperedges.get(str(he_id))

    def delete_hyperedge(self, he_id: str) -> bool:
        he = self._hyperedges.pop(str(he_id), None)
        if he is None:
            return False
        for nid in he.unique_nodes():
            s = self._hyper_by_node.get(nid)
            if s:
                s.discard(he.id)
                if not s:
                    del self._hyper_by_node[nid]
        return True

    def hyperedges_of_node(self, node_id: str) -> list[Hyperedge]:
        """Node-index lookup (hyperedge_node_index role, graph.rs:33)."""
        return [self._hyperedges[h]
                for h in sorted(self._hyper_by_node.get(str(node_id), ()))]

    def hyperedges_by_type(self, edge_type: str) -> list[Hyperedge]:
        return [h for h in self._hyperedges.values()
                if h.edge_type == edge_type]

    @property
    def hyperedge_count(self) -> int:
        return len(self._hyperedges)

    def nodes_by_label(self, label: str) -> list[PNode]:
        return [n for n in self._nodes.values() if label in n.labels]

    def nodes_by_property(self, key: str, value) -> list[PNode]:
        return [n for n in self._nodes.values()
                if n.properties.get(key) == value]

    def edges_by_type(self, edge_type: str) -> list[PEdge]:
        return [e for e in self._edges if e.type == edge_type]

    def outgoing(self, node_id: str) -> list[PEdge]:
        return [self._edges[i] for i in self._out.get(str(node_id), [])]

    def incoming(self, node_id: str) -> list[PEdge]:
        return [self._edges[i] for i in self._in.get(str(node_id), [])]

    @property
    def node_count(self) -> int:
        return len(self._nodes)

    @property
    def edge_count(self) -> int:
        return len(self._edges)

    def _reindex(self) -> None:
        self._out = {nid: [] for nid in self._nodes}
        self._in = {nid: [] for nid in self._nodes}
        for i, e in enumerate(self._edges):
            self._out[e.src].append(i)
            self._in[e.dst].append(i)

    # --- transactions (transaction.rs role) ---

    def begin(self) -> "Transaction":
        """Start a buffered atomic transaction (transaction.rs:107)."""
        return Transaction(self)

    # --- loaders ---

    @staticmethod
    def from_edge_list(
        src: np.ndarray, dst: np.ndarray, weight: np.ndarray | None = None
    ) -> "PropertyGraph":
        g = PropertyGraph()
        w = weight if weight is not None else np.ones(len(src), np.float32)
        for s, d, ww in zip(src, dst, w):
            g.add_edge(str(int(s)), str(int(d)), weight=float(ww))
        return g

    @staticmethod
    def from_edge_file(path: str, delimiter: str | None = None) -> "PropertyGraph":
        """TSV/CSV with 2 or 3 columns: src, dst[, weight]; '#' comments."""
        g = PropertyGraph()
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                parts = (line.split(delimiter) if delimiter
                         else line.replace(",", " ").split())
                if len(parts) < 2:
                    continue
                w = float(parts[2]) if len(parts) > 2 else 1.0
                g.add_edge(parts[0], parts[1], weight=w)
        return g

    @staticmethod
    def from_jsonl(path_or_lines) -> "PropertyGraph":
        """JSONL dump: {"type": "node", "id", "labels", "properties"} /
        {"type": "relationship", "start", "end", "label", "properties"}."""
        g = PropertyGraph()
        if isinstance(path_or_lines, str):
            lines = open(path_or_lines)
        else:
            lines = path_or_lines
        for line in lines:
            line = line.strip()
            if not line:
                continue
            rec = json.loads(line)
            t = rec.get("type")
            if t == "node":
                g.add_node(rec["id"], rec.get("labels", ()),
                           **rec.get("properties", {}))
            elif t in ("relationship", "edge", "rel"):
                props = dict(rec.get("properties", {}))
                w = float(props.pop("weight", 1.0))
                g.add_edge(rec.get("start") or rec["src"],
                           rec.get("end") or rec["dst"],
                           type=rec.get("label", "RELATED"), weight=w,
                           **props)
            elif t == "hyperedge":
                props = dict(rec.get("properties", {}))
                g.add_hyperedge(rec["nodes"],
                                edge_type=rec.get("label", "RELATED"),
                                id=rec.get("id"),
                                description=rec.get("description"),
                                confidence=float(rec.get("confidence", 1.0)),
                                **props)
        return g

    @staticmethod
    def from_cypher(text: str) -> "PropertyGraph":
        """Load a minimal Cypher CREATE subset (a loader — the reference's
        full grammar lives in ruvector-graph/src/cypher/parser.rs)."""
        g = PropertyGraph()
        alias: dict[str, str] = {}

        node_re = re.compile(
            r"\(\s*(?P<alias>\w+)?\s*(?::(?P<labels>[\w:]+))?\s*"
            r"(?:\{(?P<props>[^}]*)\})?\s*\)")
        edge_re = re.compile(
            r"\(\s*(?P<a>\w+)\s*\)\s*-\s*\[\s*:?(?P<type>\w+)?\s*"
            r"(?:\{(?P<props>[^}]*)\})?\s*\]\s*->\s*\(\s*(?P<b>\w+)\s*\)")

        def parse_props(s: str | None) -> dict:
            out: dict[str, Any] = {}
            if not s:
                return out
            for kv in s.split(","):
                if ":" not in kv:
                    continue
                k, v = kv.split(":", 1)
                v = v.strip().strip("'\"")
                try:
                    out[k.strip()] = json.loads(v)
                except Exception:
                    out[k.strip()] = v
            return out

        for stmt in re.split(r";|\n", text):
            stmt = stmt.strip()
            if not stmt.upper().startswith("CREATE"):
                continue
            body = stmt[len("CREATE"):]
            for m in edge_re.finditer(body):
                props = parse_props(m.group("props"))
                w = float(props.pop("weight", 1.0))
                a = alias.get(m.group("a"), m.group("a"))
                b = alias.get(m.group("b"), m.group("b"))
                g.add_edge(a, b, type=m.group("type") or "RELATED",
                           weight=w, **props)
            if not edge_re.search(body):
                for m in node_re.finditer(body):
                    props = parse_props(m.group("props"))
                    labels = tuple((m.group("labels") or "").split(":")) \
                        if m.group("labels") else ()
                    nid = str(props.pop("id", m.group("alias") or
                                        f"n{g.node_count}"))
                    if m.group("alias"):
                        alias[m.group("alias")] = nid
                    g.add_node(nid, labels, **props)
        return g

    # --- lowering to compute layouts ---

    def node_ids(self) -> list[str]:
        return list(self._nodes.keys())

    def to_neighbor_graph(self, max_degree: int | None = None,
                          symmetrize: bool = False,
                          hyperedges: str | None = "clique", device=None):
        """Lower to the padded-slot NeighborGraph on `device` (default: the
        CUDA card) (+ id <-> row maps).

        hyperedges: how N-ary edges reach the pairwise compute layout —
          'clique': each order-k hyperedge becomes k*(k-1) directed pairs
                    with weight confidence/(k-1) (mass-preserving);
          'star':   one virtual hub row per hyperedge (id appended to the
                    returned ids), members <-> hub at weight confidence;
          None:     hyperedges ignored.
        """
        from ruvector_tpu_torch.graph.neighbors import NeighborGraph

        ids = self.node_ids()
        if hyperedges == "star":
            ids = ids + [h.id for h in self._hyperedges.values()]
        row = {nid: i for i, nid in enumerate(ids)}
        lists: list[list[int]] = [[] for _ in ids]
        weights: list[list[float]] = [[] for _ in ids]
        for e in self._edges:
            lists[row[e.src]].append(row[e.dst])
            weights[row[e.src]].append(e.weight)
            if symmetrize:
                lists[row[e.dst]].append(row[e.src])
                weights[row[e.dst]].append(e.weight)
        if hyperedges == "clique":
            for he in self._hyperedges.values():
                members = sorted(he.unique_nodes())
                k = len(members)
                if k < 2:
                    continue
                w = he.confidence / (k - 1)
                for a in members:
                    for b in members:
                        if a != b:
                            lists[row[a]].append(row[b])
                            weights[row[a]].append(w)
        elif hyperedges == "star":
            for he in self._hyperedges.values():
                hub = row[he.id]
                for a in sorted(he.unique_nodes()):
                    lists[row[a]].append(hub)
                    weights[row[a]].append(he.confidence)
                    lists[hub].append(row[a])
                    weights[hub].append(he.confidence)
        m = max_degree or max((len(l) for l in lists), default=1)
        for i in range(len(lists)):
            lists[i] = lists[i][:m]
            weights[i] = weights[i][:m]
        g = NeighborGraph.from_lists(lists, weights, max_degree=m, device=device)
        return g, ids

    def to_csr(self, device=None):
        """Lower to CSRGraph (graph/csr.py) on `device` (default: the CUDA
        card)."""
        from ruvector_tpu_torch.device import resolve_device
        from ruvector_tpu_torch.graph.csr import CSRGraph

        dev = resolve_device(device)

        ids = self.node_ids()
        row = {nid: i for i, nid in enumerate(ids)}
        n = len(ids)
        counts = np.zeros(n + 1, np.int64)
        for e in self._edges:
            counts[row[e.src] + 1] += 1
        row_ptr = np.cumsum(counts)
        col = np.zeros(len(self._edges), np.int32)
        val = np.zeros(len(self._edges), np.float32)
        cursor = row_ptr[:-1].copy()
        for e in self._edges:
            r = row[e.src]
            col[cursor[r]] = row[e.dst]
            val[cursor[r]] = e.weight
            cursor[r] += 1
        import torch

        return CSRGraph(row_ptr=torch.from_numpy(row_ptr.astype(np.int32)).to(dev),
                        col_idx=torch.from_numpy(col).to(dev),
                        values=torch.from_numpy(val).to(dev), num_nodes=n), ids

    def feature_matrix(self, key: str = "embedding",
                       dim: int | None = None) -> np.ndarray:
        """Stack per-node embedding properties into [N, D] (missing ->
        zeros)."""
        ids = self.node_ids()
        vecs = [np.asarray(self._nodes[i].properties.get(key, ()),
                           np.float32) for i in ids]
        d = dim or max((len(v) for v in vecs), default=0)
        out = np.zeros((len(ids), d), np.float32)
        for i, v in enumerate(vecs):
            out[i, : min(len(v), d)] = v[:d]
        return out


class TransactionAborted(RuntimeError):
    """Raised by Transaction.rollback() paths and commit-after-abort."""


class Transaction:
    """Atomic multi-operation unit over a PropertyGraph
    (transaction.rs:282-377 surface): buffered writes become visible at
    commit() as one unit; rollback() (or an exception inside the context
    manager) leaves the graph untouched — including all secondary
    indexes, which round 2 mutated non-atomically during ingestion.

    Reads inside the transaction see its own pending writes
    (read-your-writes), then the committed graph.
    """

    def __init__(self, graph: "PropertyGraph"):
        self.g = graph
        self._ops: list[tuple] = []
        self._pending_nodes: dict[str, PNode] = {}
        self._deleted_nodes: set[str] = set()
        self.state = "active"         # active | committed | rolled_back

    # -- buffered writes ---------------------------------------------------

    def _check(self):
        if self.state != "active":
            raise TransactionAborted(f"transaction is {self.state}")

    def add_node(self, node_id: str, labels=(), **properties):
        self._check()
        node = PNode(str(node_id), tuple(labels), dict(properties))
        self._pending_nodes[node.id] = node
        self._deleted_nodes.discard(node.id)
        self._ops.append(("add_node", node))
        return node

    def add_edge(self, src: str, dst: str, type: str = "RELATED",
                 weight: float = 1.0, **properties):
        self._check()
        self._ops.append(("add_edge", (str(src), str(dst), type,
                                       float(weight), dict(properties))))

    def add_hyperedge(self, nodes, edge_type: str = "RELATED", **kw):
        self._check()
        self._ops.append(("add_hyperedge",
                          (tuple(str(x) for x in nodes), edge_type, kw)))

    def delete_node(self, node_id: str):
        self._check()
        nid = str(node_id)
        self._pending_nodes.pop(nid, None)
        self._deleted_nodes.add(nid)
        self._ops.append(("delete_node", nid))

    def set_property(self, node_id: str, key: str, value):
        self._check()
        self._ops.append(("set_property", (str(node_id), key, value)))

    # -- transactional reads (read-your-writes) -----------------------------

    def read_node(self, node_id: str) -> PNode | None:
        nid = str(node_id)
        if nid in self._deleted_nodes:
            return None
        if nid in self._pending_nodes:
            return self._pending_nodes[nid]
        return self.g.get_node(nid)

    # -- lifecycle -----------------------------------------------------------

    def commit(self):
        """Apply all buffered operations; on ANY failure the graph (and
        its indexes) are restored via an UNDO journal recorded alongside
        each applied op — commit cost scales with the TRANSACTION, not
        the graph (the original full-deepcopy snapshot made every commit
        O(graph); code-review r3)."""
        self._check()
        g = self.g
        undo: list = []          # (fn) closures, applied in reverse
        try:
            for op, payload in self._ops:
                if op == "add_node":
                    old = g._nodes.get(payload.id)
                    existed = payload.id in g._nodes
                    g.add_node(payload.id, payload.labels,
                               **payload.properties)
                    if existed:
                        undo.append(lambda nid=payload.id, o=old:
                                    g._nodes.__setitem__(nid, o))
                    else:
                        undo.append(lambda nid=payload.id: (
                            g._nodes.pop(nid, None),
                            g._out.pop(nid, None),
                            g._in.pop(nid, None)))
                elif op == "add_edge":
                    s, d2, t, w, props = payload
                    created = [x for x in (s, d2) if x not in g._nodes]
                    g.add_edge(s, d2, type=t, weight=w, **props)

                    def undo_edge(s=s, d2=d2, created=tuple(created)):
                        g._edges.pop()
                        g._out[s].pop()
                        g._in[d2].pop()
                        for nid in created:
                            g._nodes.pop(nid, None)
                            g._out.pop(nid, None)
                            g._in.pop(nid, None)
                    undo.append(undo_edge)
                elif op == "add_hyperedge":
                    nodes, t, kw = payload
                    created = [str(x) for x in nodes
                               if str(x) not in g._nodes]
                    old_he = g._hyperedges.get(str(kw.get("id", "")))
                    he = g.add_hyperedge(nodes, edge_type=t, **kw)

                    def undo_he(hid=he.id, old_he=old_he,
                                created=tuple(created)):
                        g.delete_hyperedge(hid)
                        if old_he is not None:
                            g._hyperedges[old_he.id] = old_he
                            for nid in old_he.unique_nodes():
                                g._hyper_by_node.setdefault(
                                    nid, set()).add(old_he.id)
                        for nid in created:
                            g._nodes.pop(nid, None)
                            g._out.pop(nid, None)
                            g._in.pop(nid, None)
                    undo.append(undo_he)
                elif op == "delete_node":
                    # inherently O(E): capture the structures the delete
                    # rewrites (edge list + indexes + touched hyperedges)
                    node = g._nodes.get(payload)
                    edges = list(g._edges)
                    out_idx = {k2: list(v) for k2, v in g._out.items()}
                    in_idx = {k2: list(v) for k2, v in g._in.items()}
                    hyper = dict(g._hyperedges)
                    hyper_by = {k2: set(v)
                                for k2, v in g._hyper_by_node.items()}
                    g.delete_node(payload)

                    def undo_del(node=node, edges=edges, out_idx=out_idx,
                                 in_idx=in_idx, hyper=hyper,
                                 hyper_by=hyper_by, nid=payload):
                        if node is not None:
                            g._nodes[nid] = node
                        g._edges = edges
                        g._out = out_idx
                        g._in = in_idx
                        g._hyperedges = hyper
                        g._hyper_by_node = hyper_by
                    undo.append(undo_del)
                elif op == "set_property":
                    nid, k, v = payload
                    node = g.get_node(nid)
                    if node is None:
                        raise KeyError(f"no node {nid!r}")
                    missing = k not in node.properties
                    old = node.properties.get(k)

                    def undo_set(node=node, k=k, old=old, missing=missing):
                        if missing:
                            node.properties.pop(k, None)
                        else:
                            node.properties[k] = old
                    undo.append(undo_set)
            self.state = "committed"
        except Exception:
            for fn in reversed(undo):
                fn()
            self.state = "rolled_back"
            raise

    def rollback(self):
        self._check()
        self._ops.clear()
        self.state = "rolled_back"

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is not None:
            if self.state == "active":
                self.rollback()
            return False
        if self.state == "active":
            self.commit()
        return False
