"""Cypher query engine over the PropertyGraph (port of
ruvector_tpu/graph/cypher.py).

Reference: ruvector-graph/src/cypher/ (~3.4k LoC: lexer.rs, parser.rs
recursive descent, ast.rs, semantic.rs, optimizer.rs). This is the query
surface the reference exposes via its graph shell
(ruvector-cli Commands::Graph::{Query, Shell}).

Supported subset (the working core of the reference's README):
  MATCH (a:Label {k: v})-[r:TYPE*1..3]->(b) WHERE expr
  OPTIONAL MATCH (...)            (unmatched vars bind to null)
  WITH items [AS alias] [WHERE]   (pipeline stages; entities flow through)
  RETURN [DISTINCT] items [AS alias] / aggregations
         (count/sum/avg/min/max/collect)
  ORDER BY expr|alias [DESC] SKIP n LIMIT n
  CREATE (n:Label {..}), (a)-[:TYPE {..}]->(b)
  MERGE (...) [ON CREATE SET ...] [ON MATCH SET ...]
  SET n.k = v / DELETE n / r
Hyperedge patterns (round 4): MATCH (a)-[r:TYPE]->(b, c, d) matches a
stored N-ary hyperedge (parser.rs:259-284 grammar — whose own test the
reference marks "not yet implemented"; execution here is real): distinct
members must match every node pattern (injective, subset semantics —
the hyperedge may have more members), r binds the Hyperedge. MATCH-only;
create hyperedges via PropertyGraph.add_hyperedge.

Execution: label-indexed scan for the first node pattern, then relation
expansion honoring direction / type / variable-length bounds, row
binding, WHERE filtering, projection/aggregation. Host-side by design —
query results feed the device path via PropertyGraph.to_neighbor_graph().
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Callable, Iterable

from ruvector_tpu_torch.graph.property import PEdge, PNode, PropertyGraph


# --------------------------------------------------------------------------
# Lexer (lexer.rs)
# --------------------------------------------------------------------------

_TOKEN_RE = re.compile(r"""
    (?P<WS>\s+)
  | (?P<KW>(?i:OPTIONAL|MATCH|WHERE|RETURN|CREATE|MERGE|ON|DELETE|SET|
            ORDER|BY|SKIP|LIMIT|DISTINCT|AND|OR|NOT|AS|DESC|ASC|TRUE|
            FALSE|NULL|IN|CONTAINS|STARTS|ENDS|WITH)\b)
  | (?P<NUM>-?\d+\.\d+|-?\d+)
  | (?P<STR>'(?:[^'\\]|\\.)*'|"(?:[^"\\]|\\.)*")
  | (?P<ID>[A-Za-z_][A-Za-z0-9_]*)
  | (?P<OP><>|!=|<=|>=|=~|->|<-|\.\.|[-=<>+*/%(),:.\[\]{}|])
""", re.VERBOSE)


@dataclasses.dataclass
class Token:
    kind: str       # KW | NUM | STR | ID | OP
    text: str
    pos: int


class CypherSyntaxError(ValueError):
    pass


def tokenize(query: str) -> list[Token]:
    out, pos = [], 0
    while pos < len(query):
        m = _TOKEN_RE.match(query, pos)
        if m is None:
            raise CypherSyntaxError(
                f"unexpected character {query[pos]!r} at {pos}")
        pos = m.end()
        kind = m.lastgroup
        if kind == "WS":
            continue
        text = m.group()
        if kind == "KW":
            text = text.upper()
        out.append(Token(kind, text, m.start()))
    return out


# --------------------------------------------------------------------------
# AST (ast.rs)
# --------------------------------------------------------------------------

@dataclasses.dataclass
class NodePattern:
    var: str | None
    labels: list[str]
    props: dict


@dataclasses.dataclass
class RelPattern:
    var: str | None
    types: list[str]
    props: dict
    direction: str            # 'out' | 'in' | 'both'
    min_hops: int = 1
    max_hops: int = 1


@dataclasses.dataclass
class PathPattern:
    nodes: list[NodePattern]
    rels: list[RelPattern]    # len(nodes) - 1


@dataclasses.dataclass
class HyperPattern:
    """N-ary relationship pattern (parser.rs:259-284 / ast.rs
    HyperedgePattern): (a)-[r:TYPE]->(b, c, d). Matches a stored
    hyperedge of the given type whose member set contains DISTINCT
    nodes matching the source and every target pattern (the hyperedge
    may have additional members — subset semantics; members are an
    unordered set per hyperedge.rs, so direction is syntax only)."""

    var: str | None           # binds the Hyperedge object
    types: list[str]
    props: dict
    source: NodePattern
    targets: list[NodePattern]

    @property
    def arity(self) -> int:  # ast.rs HyperedgePattern::arity
        return len(self.targets) + 1


@dataclasses.dataclass
class ReturnItem:
    expr: "Expr"
    alias: str | None
    agg: str | None           # count/sum/avg/min/max/collect or None


@dataclasses.dataclass
class Query:
    matches: list[PathPattern]
    where: "Expr | None"
    returns: list[ReturnItem]
    distinct: bool
    order_by: list[tuple["Expr", bool]]   # (expr, descending)
    skip: int | None
    limit: int | None
    creates: list[PathPattern]
    deletes: list[str]
    sets: list[tuple[str, str, "Expr"]]   # (var, prop, value)
    # MERGE clauses: (pattern, on_create_sets, on_match_sets) — the
    # idempotent ingestion verb (parser.rs MERGE + ON CREATE/ON MATCH)
    merges: list = dataclasses.field(default_factory=list)
    # OPTIONAL MATCH patterns: unmatched rows bind the pattern's vars to
    # null instead of being dropped (null-tolerant WHERE applies after)
    optional_matches: list = dataclasses.field(default_factory=list)
    # WITH pipeline: this stage's `returns` become the projection feeding
    # `next_stage`; with_where filters the projected rows first
    next_stage: "Query | None" = None
    with_where: "Expr | None" = None
    # hyperedge patterns: (a)-[r:TYPE]->(b, c, d) — matched against the
    # graph's N-ary hyperedges after the binary path patterns bind
    hyper_matches: list = dataclasses.field(default_factory=list)


# expressions: nested tuples ('lit', v) ('var', name) ('prop', var, key)
# ('bin', op, l, r) ('not', e)
Expr = tuple


class _Parser:
    """Recursive descent (parser.rs structure, nom combinators replaced
    by methods)."""

    def __init__(self, tokens: list[Token]):
        self.toks = tokens
        self.i = 0
        self.hypers: list[HyperPattern] = []

    # -- token helpers ----------------------------------------------------
    def peek(self, k: int = 0) -> Token | None:
        j = self.i + k
        return self.toks[j] if j < len(self.toks) else None

    def next(self) -> Token:
        t = self.peek()
        if t is None:
            raise CypherSyntaxError("unexpected end of query")
        self.i += 1
        return t

    def accept(self, text: str) -> bool:
        t = self.peek()
        if t is not None and t.text == text:
            self.i += 1
            return True
        return False

    def expect(self, text: str) -> Token:
        t = self.next()
        if t.text != text:
            raise CypherSyntaxError(f"expected {text!r}, got {t.text!r}")
        return t

    # -- grammar ----------------------------------------------------------
    def parse(self) -> Query:
        matches, creates, deletes, sets = [], [], [], []
        merges, optionals = [], []
        where = None
        returns: list[ReturnItem] = []
        distinct = False
        order_by: list[tuple[Expr, bool]] = []
        skip = limit = None
        while self.peek() is not None:
            t = self.next()
            if t.text == "MATCH":
                matches.append(self.path_pattern())
                while self.accept(","):
                    matches.append(self.path_pattern())
            elif t.text == "OPTIONAL":
                self.expect("MATCH")
                nh = len(self.hypers)
                optionals.append(self.path_pattern())
                while self.accept(","):
                    optionals.append(self.path_pattern())
                if len(self.hypers) != nh:
                    raise CypherSyntaxError(
                        "hyperedge patterns are not supported in "
                        "OPTIONAL MATCH")
            elif t.text == "WITH":
                distinct = self.accept("DISTINCT")
                items = [self.return_item()]
                while self.accept(","):
                    items.append(self.return_item())
                w_where = self.expr() if self.accept("WHERE") else None
                # stage boundary: this stage's hyper patterns stay here;
                # the recursive parse() accumulates the next stage's own
                stage_hypers, self.hypers = self.hypers, []
                rest = self.parse()
                return Query(matches, where, items, distinct, [], None,
                             None, creates, deletes, sets, merges,
                             optionals, rest, w_where,
                             hyper_matches=stage_hypers)
            elif t.text == "WHERE":
                where = self.expr()
            elif t.text == "CREATE":
                nh = len(self.hypers)
                creates.append(self.path_pattern())
                while self.accept(","):
                    creates.append(self.path_pattern())
                if len(self.hypers) != nh:
                    raise CypherSyntaxError(
                        "hyperedge patterns are MATCH-only; create "
                        "hyperedges via PropertyGraph.add_hyperedge")
            elif t.text == "MERGE":
                nh = len(self.hypers)
                pat = self.path_pattern()
                if len(self.hypers) != nh:
                    raise CypherSyntaxError(
                        "hyperedge patterns are MATCH-only; create "
                        "hyperedges via PropertyGraph.add_hyperedge")
                on_create, on_match = [], []
                while self.peek() is not None \
                        and self.peek().text == "ON":
                    self.next()
                    which = self.next().text
                    self.expect("SET")
                    items = [self.set_item()]
                    while self.accept(","):
                        items.append(self.set_item())
                    if which == "CREATE":
                        on_create.extend(items)
                    elif which == "MATCH":
                        on_match.extend(items)
                    else:
                        raise CypherSyntaxError(
                            f"expected CREATE or MATCH after ON, got {which!r}")
                merges.append((pat, on_create, on_match))
            elif t.text == "DELETE":
                deletes.append(self.next().text)
                while self.accept(","):
                    deletes.append(self.next().text)
            elif t.text == "SET":
                sets.append(self.set_item())
                while self.accept(","):
                    sets.append(self.set_item())
            elif t.text == "RETURN":
                distinct = self.accept("DISTINCT")
                returns.append(self.return_item())
                while self.accept(","):
                    returns.append(self.return_item())
            elif t.text == "ORDER":
                self.expect("BY")
                while True:
                    e = self.expr()
                    desc = self.accept("DESC")
                    if not desc:
                        self.accept("ASC")
                    order_by.append((e, desc))
                    if not self.accept(","):
                        break
            elif t.text == "SKIP":
                skip = int(self.next().text)
            elif t.text == "LIMIT":
                limit = int(self.next().text)
            else:
                raise CypherSyntaxError(f"unexpected {t.text!r}")
        return Query(matches, where, returns, distinct, order_by,
                     skip, limit, creates, deletes, sets, merges,
                     optionals, hyper_matches=self.hypers)

    def set_item(self) -> tuple[str, str, Expr]:
        var = self.next().text
        self.expect(".")
        prop = self.next().text
        self.expect("=")
        return (var, prop, self.expr())

    def return_item(self) -> ReturnItem:
        t = self.peek()
        agg = None
        if (t is not None and t.kind == "ID"
                and t.text.lower() in ("count", "sum", "avg", "min", "max",
                                       "collect")
                and self.peek(1) is not None and self.peek(1).text == "("):
            agg = t.text.lower()
            self.i += 2
            if self.accept("*"):
                expr: Expr = ("lit", 1)
            else:
                expr = self.expr()
            self.expect(")")
        else:
            expr = self.expr()
        alias = self.next().text if self.accept("AS") else None
        return ReturnItem(expr, alias, agg)

    def path_pattern(self) -> PathPattern:
        nodes = [self.node_pattern()]
        rels: list[RelPattern] = []
        while self.peek() is not None and self.peek().text in ("-", "<-"):
            rel = self.rel_pattern()
            group = self.node_group()
            if len(group) > 1:
                # hyperedge pattern (a)-[r:TYPE]->(b, c, d): N-ary,
                # terminal (parser.rs:259-284 returns immediately too)
                if not rel.types:
                    raise CypherSyntaxError(
                        "hyperedge pattern requires a relationship type")
                if rel.max_hops != 1:
                    raise CypherSyntaxError(
                        "hyperedge pattern cannot be variable-length")
                nxt = self.peek()
                if nxt is not None and nxt.text in ("-", "<-"):
                    raise CypherSyntaxError(
                        "hyperedge pattern must end its path")
                self.hypers.append(HyperPattern(
                    rel.var, rel.types, rel.props, nodes[-1], group))
                break
            rels.append(rel)
            nodes.append(group[0])
        return PathPattern(nodes, rels)

    def node_group(self) -> list[NodePattern]:
        """( content (, content)* ) — one node pattern, or a hyperedge
        target group."""
        self.expect("(")
        group = [self._node_content()]
        while self.accept(","):
            group.append(self._node_content())
        self.expect(")")
        return group

    def node_pattern(self) -> NodePattern:
        self.expect("(")
        pat = self._node_content()
        self.expect(")")
        return pat

    def _node_content(self) -> NodePattern:
        var = None
        labels: list[str] = []
        props: dict = {}
        t = self.peek()
        if t is not None and t.kind == "ID":
            var = self.next().text
        while self.accept(":"):
            labels.append(self.next().text)
        if self.peek() is not None and self.peek().text == "{":
            props = self.prop_map()
        return NodePattern(var, labels, props)

    def rel_pattern(self) -> RelPattern:
        direction = "both"
        if self.accept("<-"):
            direction = "in"
        else:
            self.expect("-")
        var = None
        types: list[str] = []
        props: dict = {}
        min_h = max_h = 1
        if self.accept("["):
            t = self.peek()
            if t is not None and t.kind == "ID":
                var = self.next().text
            while self.accept(":"):
                types.append(self.next().text)
                while self.accept("|"):
                    types.append(self.next().text)
            if self.accept("*"):
                min_h, max_h = 1, 8          # default var-length bound
                t = self.peek()
                if t is not None and t.kind == "NUM":
                    min_h = int(self.next().text)
                    max_h = min_h
                if self.accept(".."):
                    t = self.peek()
                    if t is not None and t.kind == "NUM":
                        max_h = int(self.next().text)
                    else:
                        max_h = 8
            if self.peek() is not None and self.peek().text == "{":
                props = self.prop_map()
            self.expect("]")
        if self.accept("->"):
            if direction == "in":
                raise CypherSyntaxError("<- ... -> is not a direction")
            direction = "out"
        else:
            self.expect("-")
        return RelPattern(var, types, props, direction, min_h, max_h)

    def prop_map(self) -> dict:
        self.expect("{")
        props = {}
        if self.peek() is not None and self.peek().text != "}":
            while True:
                key = self.next().text
                self.expect(":")
                props[key] = self.literal()
                if not self.accept(","):
                    break
        self.expect("}")
        return props

    def literal(self):
        t = self.next()
        if t.kind == "NUM":
            return float(t.text) if "." in t.text else int(t.text)
        if t.kind == "STR":
            return t.text[1:-1]
        if t.text == "TRUE":
            return True
        if t.text == "FALSE":
            return False
        if t.text == "NULL":
            return None
        raise CypherSyntaxError(f"expected literal, got {t.text!r}")

    # expression grammar: or_expr > and_expr > not > cmp > add > mul > atom
    def expr(self) -> Expr:
        e = self.and_expr()
        while self.accept("OR"):
            e = ("bin", "or", e, self.and_expr())
        return e

    def and_expr(self) -> Expr:
        e = self.not_expr()
        while self.accept("AND"):
            e = ("bin", "and", e, self.not_expr())
        return e

    def not_expr(self) -> Expr:
        if self.accept("NOT"):
            return ("not", self.not_expr())
        return self.cmp_expr()

    def cmp_expr(self) -> Expr:
        e = self.add_expr()
        t = self.peek()
        if t is not None and t.text in ("=", "<>", "!=", "<", ">", "<=",
                                        ">=", "IN", "CONTAINS"):
            op = self.next().text
            if op in ("<>", "!="):
                op = "!="
            return ("bin", op.lower(), e, self.add_expr())
        if t is not None and t.text in ("STARTS", "ENDS"):
            kind = self.next().text
            self.expect("WITH")
            return ("bin", kind.lower() + "_with", e, self.add_expr())
        return e

    def add_expr(self) -> Expr:
        e = self.mul_expr()
        while self.peek() is not None and self.peek().text in ("+", "-"):
            op = self.next().text
            e = ("bin", op, e, self.mul_expr())
        return e

    def mul_expr(self) -> Expr:
        e = self.atom()
        while self.peek() is not None and self.peek().text in ("*", "/", "%"):
            op = self.next().text
            e = ("bin", op, e, self.atom())
        return e

    def atom(self) -> Expr:
        t = self.peek()
        if t is None:
            raise CypherSyntaxError("unexpected end of expression")
        if t.text == "(":
            self.next()
            e = self.expr()
            self.expect(")")
            return e
        if t.text == "[":
            self.next()
            items = []
            if self.peek() is not None and self.peek().text != "]":
                while True:
                    items.append(self.expr())
                    if not self.accept(","):
                        break
            self.expect("]")
            return ("list", items)
        if t.kind in ("NUM", "STR") or t.text in ("TRUE", "FALSE", "NULL"):
            return ("lit", self.literal())
        if t.kind == "ID":
            name = self.next().text
            if self.accept("."):
                return ("prop", name, self.next().text)
            return ("var", name)
        raise CypherSyntaxError(f"unexpected {t.text!r} in expression")


def parse_cypher(query: str) -> Query:
    return _Parser(tokenize(query)).parse()


# --------------------------------------------------------------------------
# Executor (semantic.rs role: bind + filter + project)
# --------------------------------------------------------------------------

def _eval(expr: Expr, row: dict) -> Any:
    tag = expr[0]
    if tag == "lit":
        return expr[1]
    if tag == "list":
        return [_eval(e, row) for e in expr[1]]
    if tag == "var":
        return row.get(expr[1])
    if tag == "prop":
        ent = row.get(expr[1])
        if ent is None:
            return None
        return ent.properties.get(expr[2])
    if tag == "not":
        return not _eval(expr[1], row)
    if tag == "bin":
        op, l, r = expr[1], _eval(expr[2], row), _eval(expr[3], row)
        if op == "and":
            return bool(l) and bool(r)
        if op == "or":
            return bool(l) or bool(r)
        if l is None or r is None:
            return False
        try:
            return {
                "=": lambda: l == r, "!=": lambda: l != r,
                "<": lambda: l < r, ">": lambda: l > r,
                "<=": lambda: l <= r, ">=": lambda: l >= r,
                "in": lambda: l in r, "contains": lambda: r in l,
                "starts_with": lambda: str(l).startswith(str(r)),
                "ends_with": lambda: str(l).endswith(str(r)),
                "+": lambda: l + r, "-": lambda: l - r,
                "*": lambda: l * r, "/": lambda: l / r,
                "%": lambda: l % r,
            }[op]()
        except TypeError:
            return False
    raise CypherSyntaxError(f"bad expression {expr!r}")


def _node_matches(node: PNode, pat: NodePattern) -> bool:
    if any(lb not in node.labels for lb in pat.labels):
        return False
    return all(node.properties.get(k) == v for k, v in pat.props.items())


def _edge_matches(edge: PEdge, pat: RelPattern) -> bool:
    if pat.types and edge.type not in pat.types:
        return False
    return all(edge.properties.get(k) == v for k, v in pat.props.items())


class CypherEngine:
    def __init__(self, graph: PropertyGraph):
        self.g = graph

    # -- pattern matching -------------------------------------------------
    def _candidates(self, pat: NodePattern) -> Iterable[PNode]:
        if pat.labels:
            return self.g.nodes_by_label(pat.labels[0])
        return [self.g.get_node(i) for i in self.g.node_ids()]

    def _expand(self, row: dict, src: PNode, rel: RelPattern,
                dst_pat: NodePattern):
        """Yield (edge_binding, dst_node) honoring direction, type and
        variable-length bounds (BFS up to max_hops, no node revisits)."""
        frontier = [(src.id, [])]
        seen = {src.id}
        for hop in range(1, rel.max_hops + 1):
            nxt = []
            for nid, path in frontier:
                steps = []
                if rel.direction in ("out", "both"):
                    steps += [(e, e.dst) for e in self.g.outgoing(nid)]
                if rel.direction in ("in", "both"):
                    steps += [(e, e.src) for e in self.g.incoming(nid)]
                for e, other_id in steps:
                    if not _edge_matches(e, rel):
                        continue
                    if other_id in seen and rel.max_hops > 1:
                        continue
                    node = self.g.get_node(other_id)
                    if node is None:
                        continue
                    new_path = path + [e]
                    if hop >= rel.min_hops and _node_matches(node, dst_pat):
                        yield (new_path if rel.max_hops > 1
                               else new_path[0]), node
                    if hop < rel.max_hops:
                        seen.add(other_id)
                        nxt.append((other_id, new_path))
            frontier = nxt

    def _match_path(self, pat: PathPattern, row: dict):
        """Yield binding rows for one path pattern, extending `row`."""
        first = pat.nodes[0]

        def bind(row, var, val):
            if var is None:
            # anonymous: no binding, always consistent
                return dict(row)
            if var in row:
                return dict(row) if row[var] is val or (
                    hasattr(row[var], "id") and hasattr(val, "id")
                    and row[var].id == val.id) else None
            r2 = dict(row)
            r2[var] = val
            return r2

        starts = ([row[first.var]] if first.var in row
                  and row.get(first.var) is not None
                  else self._candidates(first))
        for start in starts:
            if not _node_matches(start, first):
                continue
            r0 = bind(row, first.var, start)
            if r0 is None:
                continue
            stack = [(0, start, r0)]
            while stack:
                k, cur, r = stack.pop()
                if k == len(pat.rels):
                    yield r
                    continue
                rel, dst_pat = pat.rels[k], pat.nodes[k + 1]
                for edge_bind, dst in self._expand(r, cur, rel, dst_pat):
                    r2 = bind(r, dst_pat.var, dst)
                    if r2 is None:
                        continue
                    if rel.var is not None:
                        r2[rel.var] = edge_bind
                    stack.append((k + 1, dst, r2))

    def _match_hyper(self, hp: HyperPattern, row: dict):
        """Yield rows binding a stored hyperedge to an N-ary pattern:
        DISTINCT members must match the source and every target pattern
        (injective assignment; the hyperedge may have extra members).
        Var-consistent with prior bindings; hp.var binds the Hyperedge."""
        pats = [hp.source] + list(hp.targets)
        seen_ids = set()
        hes = []
        for t in hp.types:
            for he in self.g.hyperedges_by_type(t):
                if he.id not in seen_ids:
                    seen_ids.add(he.id)
                    hes.append(he)
        for he in hes:
            if any(he.properties.get(k) != v for k, v in hp.props.items()):
                continue
            if hp.var is not None and hp.var in row:
                bound = row[hp.var]
                if getattr(bound, "id", None) != he.id:
                    continue
            members = [m for m in
                       (self.g.get_node(n) for n in dict.fromkeys(he.nodes))
                       if m is not None]
            if len(members) < len(pats):
                continue

            def assign(k: int, r: dict, used: frozenset):
                if k == len(pats):
                    if hp.var is not None and hp.var not in r:
                        r = {**r, hp.var: he}
                    yield dict(r)
                    return
                pat = pats[k]
                for m in members:
                    if m.id in used or not _node_matches(m, pat):
                        continue
                    if pat.var is not None and pat.var in r:
                        if getattr(r[pat.var], "id", None) != m.id:
                            continue
                        r2 = r
                    elif pat.var is not None:
                        r2 = {**r, pat.var: m}
                    else:
                        r2 = r
                    yield from assign(k + 1, r2, used | {m.id})

            yield from assign(0, row, frozenset())

    # -- query execution --------------------------------------------------
    def execute(self, query: str | Query,
                optimize: bool = True,
                _rows: list[dict] | None = None) -> list[dict]:
        q = parse_cypher(query) if isinstance(query, str) else query
        if optimize and q.matches:
            q = optimize_query(q, self.g)

        rows: list[dict] = [{}] if _rows is None else _rows
        for pat in q.matches:
            rows = [r2 for r in rows for r2 in self._match_path(pat, r)]
        for hp in q.hyper_matches:
            rows = [r2 for r in rows for r2 in self._match_hyper(hp, r)]
        for pat in q.optional_matches:
            rows = [r2 for r in rows
                    for r2 in self._optional_match(pat, r)]
        if q.where is not None:
            rows = [r for r in rows if _eval(q.where, r)]

        # mutations. Zero rows out of MATCH means zero executions
        # (standard Cypher); only a stage with no MATCH at all runs its
        # CREATE/MERGE once on the empty binding.
        matched_any = bool(q.matches or q.optional_matches
                           or q.hyper_matches)
        base = rows if matched_any else (rows or [{}])
        for pat in q.creates:
            for r in base:
                self._create_path(pat, r)
        if q.merges:
            new_rows = []
            for r in base:
                frontier = [r]
                for pat, on_create, on_match in q.merges:
                    frontier = [r3 for r2 in frontier for r3 in
                                self._merge_path(pat, r2, on_create,
                                                 on_match)]
                new_rows.extend(frontier)
            rows = new_rows
        if q.sets:
            for r in rows:
                for var, prop, e in q.sets:
                    ent = r.get(var)
                    if ent is not None:
                        ent.properties[prop] = _eval(e, r)
        if q.deletes:
            for r in rows:
                for var in q.deletes:
                    ent = r.get(var)
                    if isinstance(ent, PNode):
                        self.g.delete_node(ent.id)

        if q.next_stage is not None:
            projected = self._project(q, rows)
            if q.distinct:
                seen, uniq = set(), []
                for r in projected:
                    key = repr(sorted(r.items(),
                                      key=lambda kv: str(kv[0])))
                    if key not in seen:
                        seen.add(key)
                        uniq.append(r)
                projected = uniq
            if q.with_where is not None:
                projected = [r for r in projected
                             if _eval(q.with_where, r)]
            return self.execute(q.next_stage, optimize=optimize,
                                _rows=projected)

        if not q.returns:
            return []

        results = self._project(q, rows, order=True)
        if q.distinct:
            seen, uniq = set(), []
            for r in results:
                key = repr(sorted(r.items(), key=lambda kv: str(kv[0])))
                if key not in seen:
                    seen.add(key)
                    uniq.append(r)
            results = uniq
        if any(it.agg for it in q.returns):
            for e, desc in reversed(q.order_by):
                name = self._expr_name(e)
                results.sort(
                    key=lambda r: (r.get(name) is None, r.get(name)),
                    reverse=desc)
        if q.skip:
            results = results[q.skip:]
        if q.limit is not None:
            results = results[: q.limit]
        return results

    def _optional_match(self, pat, row):
        """OPTIONAL MATCH: yield extensions, or the row itself with the
        pattern's unbound vars set to null (parser.rs OPTIONAL)."""
        found = False
        for r2 in self._match_path(pat, row):
            found = True
            yield r2
        if not found:
            r2 = dict(row)
            for np_ in pat.nodes:
                if np_.var and np_.var not in r2:
                    r2[np_.var] = None
            for rp in pat.rels:
                if rp.var and rp.var not in r2:
                    r2[rp.var] = None
            yield r2

    def _project(self, q, rows, order=False):
        # projection / aggregation
        aggs = [it for it in q.returns if it.agg]
        if aggs:
            out_row = {}
            for it in q.returns:
                name = it.alias or self._item_name(it)
                vals = [_eval(it.expr, r) for r in rows]
                vals = [v for v in vals if v is not None]
                if it.agg == "count":
                    out_row[name] = len(vals)
                elif it.agg == "sum":
                    out_row[name] = sum(vals)
                elif it.agg == "avg":
                    out_row[name] = sum(vals) / len(vals) if vals else None
                elif it.agg == "min":
                    out_row[name] = min(vals) if vals else None
                elif it.agg == "max":
                    out_row[name] = max(vals) if vals else None
                elif it.agg == "collect":
                    out_row[name] = vals
                else:
                    out_row[name] = vals[0] if vals else None
            return [out_row]
        out = [{(it.alias or self._item_name(it)): _eval(it.expr, r)
                for it in q.returns} for r in rows]
        if order and q.order_by:
            # ORDER BY keys may be bound-row expressions OR projected
            # aliases, in any mix; stable sorts applied in reverse key
            # order give the composite ordering with correct precedence
            names = {it.alias or self._item_name(it) for it in q.returns}
            pairs = list(zip(rows, out))
            for e, desc in reversed(q.order_by):
                if e[0] == "var" and e[1] in names:
                    keyf = (lambda pr, k=e[1]:
                            ((v := pr[1].get(k)) is None, v))
                else:
                    keyf = (lambda pr, e=e:
                            ((v := _eval(e, pr[0])) is None, v))
                pairs.sort(key=keyf, reverse=desc)
            out = [pr[1] for pr in pairs]
        return out

    def _create_path(self, pat: PathPattern, row: dict):
        prev = None
        for k, np_ in enumerate(pat.nodes):
            node = row.get(np_.var) if np_.var else None
            if node is None:
                nid = np_.var or f"_anon{self.g.node_count}"
                if self.g.get_node(nid) is not None:
                    nid = f"{nid}_{self.g.node_count}"
                node = self.g.add_node(nid, np_.labels,
                                        **dict(np_.props))
                if np_.var:
                    row[np_.var] = node
            if k > 0:
                rel = pat.rels[k - 1]
                a, b = (prev, node) if rel.direction != "in" else (node, prev)
                self.g.add_edge(a.id, b.id,
                                rel.types[0] if rel.types else "RELATED",
                                **dict(rel.props))
            prev = node

    def _merge_path(self, pat: PathPattern, row: dict,
                    on_create, on_match) -> list[dict]:
        """MERGE semantics: match the WHOLE pattern (under the row's
        bindings) — yielding EVERY matching binding, each receiving the
        ON MATCH SET items — or create it atomically with ON CREATE SET.
        Idempotent ingestion (parser.rs MERGE)."""
        found = list(self._match_path(pat, row))
        if found:
            for fr in found:
                for var, prop, e in on_match:
                    ent = fr.get(var)
                    if ent is not None:
                        ent.properties[prop] = _eval(e, fr)
            return found
        r2 = dict(row)
        self._create_path(pat, r2)
        for var, prop, e in on_create:
            ent = r2.get(var)
            if ent is not None:
                ent.properties[prop] = _eval(e, r2)
        return [r2]

    @staticmethod
    def _item_name(it: ReturnItem) -> str:
        base = CypherEngine._expr_name(it.expr)
        return f"{it.agg}({base})" if it.agg else base

    @staticmethod
    def _expr_name(e: Expr) -> str:
        if e[0] == "var":
            return e[1]
        if e[0] == "prop":
            return f"{e[1]}.{e[2]}"
        return repr(e)


def execute_cypher(graph: PropertyGraph, query: str) -> list[dict]:
    return CypherEngine(graph).execute(query)


# --------------------------------------------------------------------------
# Shell (ruvector-cli GraphCommands::Shell)
# --------------------------------------------------------------------------

def cypher_shell(graph: PropertyGraph, input_fn: Callable = input,
                 print_fn: Callable = print) -> None:
    """Minimal interactive shell: one query per line, :quit to exit."""
    engine = CypherEngine(graph)
    print_fn("ruvector cypher shell — :quit to exit, :stats for counts")
    while True:
        try:
            line = input_fn("cypher> ")
        except (EOFError, KeyboardInterrupt):
            break
        line = line.strip()
        if not line:
            continue
        if line in (":quit", ":exit", ":q"):
            break
        if line == ":stats":
            print_fn(f"nodes: {graph.node_count}  "
                     f"edges: {graph.edge_count}")
            continue
        try:
            rows = engine.execute(line)
            for r in rows:
                print_fn({k: (v.id if isinstance(v, (PNode,))
                              else v) for k, v in r.items()})
            print_fn(f"({len(rows)} row{'s' if len(rows) != 1 else ''})")
        except Exception as e:
            print_fn(f"error: {e}")


# --------------------------------------------------------------------------
# Query optimizer (optimizer.rs role): cheap logical-plan rewrites
# --------------------------------------------------------------------------

def _selectivity(g: PropertyGraph, pat: NodePattern) -> int:
    """Estimated candidate count for scanning this node pattern."""
    if pat.labels:
        n = len(g.nodes_by_label(pat.labels[0]))
    else:
        n = g.node_count
    if pat.props:          # each bound property ~10x selectivity
        n = max(1, n // (10 * len(pat.props)))
    return n


def _reverse_path(pat: PathPattern) -> PathPattern:
    flip = {"out": "in", "in": "out", "both": "both"}
    rels = [dataclasses.replace(r, direction=flip[r.direction])
            for r in reversed(pat.rels)]
    return PathPattern(list(reversed(pat.nodes)), rels)


def optimize_query(q: Query, g: PropertyGraph) -> Query:
    """Volcano-lite plan rewrites (optimizer.rs):
    1. reverse a path when its LAST node pattern is more selective than
       its first (scan anchor selection);
    2. order multiple MATCH clauses most-selective-first, keeping any
       clause that shares a variable with an earlier clause after it
       (bound variables prune expansion)."""
    paths = []
    for pat in q.matches:
        if (len(pat.nodes) > 1
                and _selectivity(g, pat.nodes[-1])
                < _selectivity(g, pat.nodes[0])):
            pat = _reverse_path(pat)
        paths.append(pat)

    def path_vars(p: PathPattern) -> set:
        vs = {n.var for n in p.nodes if n.var}
        vs |= {r.var for r in p.rels if r.var}
        return vs

    ordered: list[PathPattern] = []
    remaining = sorted(paths,
                       key=lambda p: _selectivity(g, p.nodes[0]))
    bound: set = set()
    while remaining:
        # prefer a clause that joins with already-bound variables
        pick = next((p for p in remaining if path_vars(p) & bound),
                    remaining[0])
        remaining.remove(pick)
        ordered.append(pick)
        bound |= path_vars(pick)
    return dataclasses.replace(q, matches=ordered)
