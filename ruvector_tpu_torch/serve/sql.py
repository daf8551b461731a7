"""pgvector/ruvector-compatible SQL surface over the in-memory store (port
of ruvector_tpu/serve/sql.py).

The reference ships a full Postgres extension (`ruvector-postgres`, pgrx):
a `ruvector` column type, pgvector-style distance operators, an HNSW access
method, and a ~143-function SQL surface (`crates/ruvector-postgres/src/
operators.rs:19-120`, `sql/ruvector--0.3.0.sql`). This module re-designs the
same *surface* as a standalone engine:

- SQL text -> recursive-descent parse -> logical statement -> execution over
  an in-memory columnar store (numpy columns, payload lists).
- Vector columns are contiguous `[n, D]` float32 matrices (a buffer that
  grows by doubling; the column is a view of its first n rows); a kNN
  `ORDER BY embedding <-> '[..]' LIMIT k` executes EITHER through the native
  threaded HNSW index (`index/hnsw.py` -> `native/hnsw.cpp`) when one was
  created with `CREATE INDEX ... USING hnsw`, OR as one `[n, D] @ [D]`
  product on the engine's device (default: the CUDA card) and a stable sort
  of the distances on the host.
- The `ruvector_*` SQL function registry maps the reference's headline
  functions onto the port's modules (quantization, hyperbolic maps,
  property-graph Cypher, graph stats) instead of re-implementing them.

Operator semantics follow pgvector/ruvector exactly:
  `<->` L2 distance, `<#>` NEGATIVE inner product (so ASC = most similar),
  `<=>` cosine distance (1 - cosine similarity).

Only a deliberate subset of full SQL is parsed (CREATE TABLE / DROP TABLE /
CREATE INDEX / INSERT / DELETE / UPDATE / SELECT with WHERE, ORDER BY,
LIMIT) — the subset every pgvector tutorial and the reference's own bench
workloads (`benches/sql/benchmark_workload.sql`) actually use.

Five behaviours differ from the JAX package's, where it departs from SQL
and pgvector: an `*_ip_ops` HNSW index is refused (the index has no inner
product metric; the JAX package builds it as l2 and serves `<#>` from it);
the `ruvector_*_ops` operator classes parse; `=` and `<>` give NULL on a
NULL operand and compare vectors element by element (AND, OR and NOT follow
three-valued logic with them); only `serial`/`bigserial` columns take the
serial counter; and the kNN fast path serves only an ORDER BY whose sole key
is the distance, so further keys order the ties.
"""

from __future__ import annotations

import json
import re
from dataclasses import dataclass, field
from typing import Any, Callable

import numpy as np
import torch

from ruvector_tpu_torch.device import resolve_device

__all__ = [
    "SqlEngine",
    "SqlError",
    "execute_sql",
    "SQL_FUNCTIONS",
]


class SqlError(ValueError):
    """Raised for parse errors and execution errors (bad types, unknown
    tables/columns, dimension mismatches)."""


# ---------------------------------------------------------------------------
# Lexer
# ---------------------------------------------------------------------------

_TOKEN_RE = re.compile(
    r"""
    (?P<ws>\s+)
  | (?P<comment>--[^\n]*)
  | (?P<num>\d+\.\d*(?:[eE][+-]?\d+)?|\.\d+(?:[eE][+-]?\d+)?|\d+(?:[eE][+-]?\d+)?)
  | (?P<str>'(?:[^']|'')*')
  | (?P<op><->|<\#>|<=>|<>|!=|<=|>=|::|[(),;*+\-/=<>.\[\]])
  | (?P<ident>[A-Za-z_][A-Za-z_0-9]*)
    """,
    re.VERBOSE,
)


@dataclass(frozen=True)
class Tok:
    kind: str   # num | str | op | ident | kw
    text: str
    pos: int


_KEYWORDS = {
    "create", "table", "drop", "index", "on", "using", "with", "insert",
    "into", "values", "select", "from", "where", "order", "by", "limit",
    "asc", "desc", "and", "or", "not", "null", "true", "false", "delete",
    "update", "set", "as", "if", "exists", "primary", "key", "default",
    "in", "is", "offset", "count", "between", "explain",
}


def _lex(sql: str) -> list[Tok]:
    toks: list[Tok] = []
    i, n = 0, len(sql)
    while i < n:
        m = _TOKEN_RE.match(sql, i)
        if not m:
            raise SqlError(f"unexpected character {sql[i]!r} at offset {i}")
        i = m.end()
        if m.lastgroup in ("ws", "comment"):
            continue
        text = m.group()
        kind = m.lastgroup
        if kind == "ident" and text.lower() in _KEYWORDS:
            kind, text = "kw", text.lower()
        toks.append(Tok(kind, text, m.start()))
    toks.append(Tok("eof", "", n))
    return toks


# ---------------------------------------------------------------------------
# Expression / statement AST
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Lit:
    value: Any


@dataclass(frozen=True)
class Col:
    name: str


@dataclass(frozen=True)
class Func:
    name: str
    args: tuple


@dataclass(frozen=True)
class Bin:
    op: str
    left: Any
    right: Any


@dataclass(frozen=True)
class Un:
    op: str
    operand: Any


@dataclass(frozen=True)
class Star:
    pass


@dataclass
class ColumnDef:
    name: str
    type: str            # "vector" | "int" | "float" | "text" | "jsonb" | "bool"
    dim: int = 0         # vector columns only
    serial: bool = False  # serial/bigserial: an omitted value takes the counter


@dataclass
class CreateTable:
    name: str
    columns: list[ColumnDef]
    if_not_exists: bool = False


@dataclass
class DropTable:
    name: str
    if_exists: bool = False


@dataclass
class CreateIndex:
    name: str
    table: str
    column: str
    method: str                       # "hnsw"
    opclass: str                      # vector_l2_ops | vector_cosine_ops | vector_ip_ops
    options: dict[str, float] = field(default_factory=dict)


@dataclass
class Insert:
    table: str
    columns: list[str] | None
    rows: list[list[Any]]             # expression AST per value


@dataclass
class Delete:
    table: str
    where: Any | None


@dataclass
class Update:
    table: str
    assignments: list[tuple[str, Any]]
    where: Any | None


@dataclass
class OrderItem:
    expr: Any
    desc: bool = False


@dataclass
class Explain:
    stmt: Any


@dataclass
class Select:
    items: list[tuple[Any, str | None]]   # (expr, alias)
    table: str | None
    where: Any | None
    order: list[OrderItem]
    limit: int | None
    offset: int = 0


class _Parser:
    def __init__(self, toks: list[Tok], sql: str):
        self.toks = toks
        self.sql = sql
        self.i = 0

    # -- token plumbing ----------------------------------------------------
    def peek(self) -> Tok:
        return self.toks[self.i]

    def next(self) -> Tok:
        t = self.toks[self.i]
        self.i += 1
        return t

    def accept(self, kind: str, text: str | None = None) -> Tok | None:
        t = self.peek()
        if t.kind == kind and (text is None or t.text == text):
            return self.next()
        return None

    def expect(self, kind: str, text: str | None = None) -> Tok:
        t = self.accept(kind, text)
        if t is None:
            got = self.peek()
            want = text or kind
            raise SqlError(f"expected {want!r}, got {got.text!r} at offset {got.pos}")
        return t

    def kw(self, word: str) -> bool:
        return self.accept("kw", word) is not None

    def expect_kw(self, word: str) -> None:
        self.expect("kw", word)

    def ident(self) -> str:
        t = self.peek()
        # allow non-reserved keywords (count, key, ...) as identifiers
        if t.kind in ("ident", "kw"):
            self.next()
            return t.text
        raise SqlError(f"expected identifier, got {t.text!r} at offset {t.pos}")

    # -- statements --------------------------------------------------------
    def statement(self):
        if self.kw("explain"):
            return Explain(self.statement())
        if self.kw("create"):
            if self.kw("table"):
                return self._create_table()
            if self.kw("index"):
                return self._create_index()
            raise SqlError("expected TABLE or INDEX after CREATE")
        if self.kw("drop"):
            self.expect_kw("table")
            if_exists = False
            if self.kw("if"):
                self.expect_kw("exists")
                if_exists = True
            return DropTable(self.ident(), if_exists)
        if self.kw("insert"):
            return self._insert()
        if self.kw("delete"):
            return self._delete()
        if self.kw("update"):
            return self._update()
        if self.kw("select"):
            return self._select()
        t = self.peek()
        raise SqlError(f"unsupported statement starting at {t.text!r}")

    def _create_table(self) -> CreateTable:
        ine = False
        if self.kw("if"):
            self.expect_kw("not")
            self.expect_kw("exists")
            ine = True
        name = self.ident()
        self.expect("op", "(")
        cols: list[ColumnDef] = []
        while True:
            cname = self.ident()
            cols.append(self._column_def(cname))
            if not self.accept("op", ","):
                break
        self.expect("op", ")")
        return CreateTable(name, cols, ine)

    def _column_def(self, cname: str) -> ColumnDef:
        t = self.ident().lower()
        dim = 0
        serial = t in ("serial", "bigserial")
        if t in ("ruvector", "vector", "halfvec"):
            self.expect("op", "(")
            dim = int(self.expect("num").text)
            self.expect("op", ")")
            ctype = "vector"
        elif t in ("int", "integer", "bigint", "smallint", "serial", "bigserial"):
            ctype = "int"
        elif t in ("real", "float", "float4", "float8", "double", "numeric"):
            if t == "double":
                self.accept("ident", "precision")
            ctype = "float"
        elif t in ("text", "varchar", "char"):
            if self.accept("op", "("):
                self.expect("num")
                self.expect("op", ")")
            ctype = "text"
        elif t in ("jsonb", "json"):
            ctype = "jsonb"
        elif t in ("bool", "boolean"):
            ctype = "bool"
        else:
            raise SqlError(f"unsupported column type {t!r}")
        # swallow trailing constraints we treat as no-ops
        while True:
            if self.kw("primary"):
                self.expect_kw("key")
            elif self.kw("not"):
                self.expect_kw("null")
            elif self.kw("default"):
                self._expr()
            else:
                break
        return ColumnDef(cname, ctype, dim, serial)

    def _create_index(self) -> CreateIndex:
        name = self.ident()
        self.expect_kw("on")
        table = self.ident()
        self.expect_kw("using")
        method = self.ident().lower()
        self.expect("op", "(")
        column = self.ident()
        opclass = "vector_l2_ops"
        t = self.peek()
        if t.kind in ("ident", "kw") and t.text.lower().startswith(("vector_", "ruvector_")):
            opclass = self.ident().lower()
        self.expect("op", ")")
        options: dict[str, float] = {}
        if self.kw("with"):
            self.expect("op", "(")
            while True:
                key = self.ident().lower()
                self.expect("op", "=")
                options[key] = float(self.expect("num").text)
                if not self.accept("op", ","):
                    break
            self.expect("op", ")")
        return CreateIndex(name, table, column, method, opclass, options)

    def _insert(self) -> Insert:
        self.expect_kw("into")
        table = self.ident()
        columns = None
        if self.accept("op", "("):
            columns = []
            while True:
                columns.append(self.ident())
                if not self.accept("op", ","):
                    break
            self.expect("op", ")")
        self.expect_kw("values")
        rows = []
        while True:
            self.expect("op", "(")
            vals = []
            while True:
                vals.append(self._expr())
                if not self.accept("op", ","):
                    break
            self.expect("op", ")")
            rows.append(vals)
            if not self.accept("op", ","):
                break
        return Insert(table, columns, rows)

    def _delete(self) -> Delete:
        self.expect_kw("from")
        table = self.ident()
        where = self._expr() if self.kw("where") else None
        return Delete(table, where)

    def _update(self) -> Update:
        table = self.ident()
        self.expect_kw("set")
        assigns = []
        while True:
            col = self.ident()
            self.expect("op", "=")
            assigns.append((col, self._expr()))
            if not self.accept("op", ","):
                break
        where = self._expr() if self.kw("where") else None
        return Update(table, assigns, where)

    def _select(self) -> Select:
        items: list[tuple[Any, str | None]] = []
        while True:
            if self.accept("op", "*"):
                items.append((Star(), None))
            else:
                e = self._expr()
                alias = None
                if self.kw("as"):
                    alias = self.ident()
                items.append((e, alias))
            if not self.accept("op", ","):
                break
        table = None
        if self.kw("from"):
            table = self.ident()
        where = self._expr() if self.kw("where") else None
        order: list[OrderItem] = []
        if self.kw("order"):
            self.expect_kw("by")
            while True:
                e = self._expr()
                desc = False
                if self.kw("desc"):
                    desc = True
                else:
                    self.kw("asc")
                order.append(OrderItem(e, desc))
                if not self.accept("op", ","):
                    break
        limit = None
        if self.kw("limit"):
            limit = int(self.expect("num").text)
        offset = 0
        if self.kw("offset"):
            offset = int(self.expect("num").text)
        return Select(items, table, where, order, limit, offset)

    # -- expressions (precedence climbing) ---------------------------------
    # or < and < not < comparison/vector-distance < additive < multiplicative
    def _expr(self):
        return self._or()

    def _or(self):
        left = self._and()
        while self.kw("or"):
            left = Bin("or", left, self._and())
        return left

    def _and(self):
        left = self._not()
        while self.kw("and"):
            left = Bin("and", left, self._not())
        return left

    def _not(self):
        if self.kw("not"):
            return Un("not", self._not())
        return self._cmp()

    _CMP_OPS = ("=", "<>", "!=", "<=", ">=", "<", ">", "<->", "<#>", "<=>")

    def _cmp(self):
        left = self._add()
        t = self.peek()
        if t.kind == "kw" and t.text == "is":
            self.next()
            neg = self.kw("not")
            self.expect_kw("null")
            e = Func("isnull", (left,))
            return Un("not", e) if neg else e
        if t.kind == "kw" and t.text == "between":
            self.next()
            lo = self._add()
            self.expect_kw("and")
            hi = self._add()
            return Bin("and", Bin(">=", left, lo), Bin("<=", left, hi))
        if t.kind == "op" and t.text in self._CMP_OPS:
            self.next()
            right = self._add()
            op = "<>" if t.text == "!=" else t.text
            return Bin(op, left, right)
        return left

    def _add(self):
        left = self._mul()
        while True:
            t = self.peek()
            if t.kind == "op" and t.text in ("+", "-"):
                self.next()
                left = Bin(t.text, left, self._mul())
            else:
                return left

    def _mul(self):
        left = self._unary()
        while True:
            t = self.peek()
            if t.kind == "op" and t.text in ("*", "/"):
                self.next()
                left = Bin(t.text, left, self._unary())
            else:
                return left

    def _unary(self):
        if self.accept("op", "-"):
            return Un("neg", self._unary())
        return self._postfix()

    def _postfix(self):
        e = self._atom()
        while self.accept("op", "::"):
            self.ident()                   # cast target: vector/ruvector/etc
            if self.accept("op", "("):     # vector(3)
                self.expect("num")
                self.expect("op", ")")
            e = Func("_cast_vector", (e,))
        return e

    def _atom(self):
        t = self.peek()
        if t.kind == "num":
            self.next()
            txt = t.text
            return Lit(float(txt) if any(c in txt for c in ".eE") else int(txt))
        if t.kind == "str":
            self.next()
            return Lit(t.text[1:-1].replace("''", "'"))
        if t.kind == "kw" and t.text in ("true", "false"):
            self.next()
            return Lit(t.text == "true")
        if t.kind == "kw" and t.text == "null":
            self.next()
            return Lit(None)
        if self.accept("op", "("):
            e = self._expr()
            self.expect("op", ")")
            return e
        if self.accept("op", "["):         # bare vector literal [1,2,3]
            vals = []
            if not self.accept("op", "]"):
                while True:
                    e = self._expr()
                    if not isinstance(e, (Lit, Un)):
                        raise SqlError("vector literal elements must be numbers")
                    vals.append(_const_number(e))
                    if not self.accept("op", ","):
                        break
                self.expect("op", "]")
            return Lit(np.asarray(vals, np.float32))
        if t.kind in ("ident", "kw"):
            name = self.ident()
            if self.accept("op", "("):
                args = []
                if not self.accept("op", ")"):
                    if self.accept("op", "*"):
                        args.append(Star())
                    else:
                        while True:
                            args.append(self._expr())
                            if not self.accept("op", ","):
                                break
                    self.expect("op", ")")
                return Func(name.lower(), tuple(args))
            return Col(name)
        raise SqlError(f"unexpected token {t.text!r} at offset {t.pos}")


def _const_number(e) -> float:
    if isinstance(e, Un) and e.op == "neg":
        return -_const_number(e.operand)
    if isinstance(e, Lit) and isinstance(e.value, (int, float)):
        return float(e.value)
    raise SqlError("expected numeric constant")


def parse_sql(sql: str) -> list[Any]:
    """Parse one or more ';'-separated statements."""
    p = _Parser(_lex(sql), sql)
    stmts = []
    while p.peek().kind != "eof":
        stmts.append(p.statement())
        while p.accept("op", ";"):
            pass
    return stmts


# ---------------------------------------------------------------------------
# Batched device distance path
# ---------------------------------------------------------------------------

_DIST_OPS = ("<->", "<#>", "<=>")


def _batched_distance(mat: torch.Tensor, query: torch.Tensor, metric: str) -> torch.Tensor:
    """One pass over the whole [n, D] column; pgvector semantics. The
    product is a matrix-vector product in float32 (TF32 stays off, torch's
    default, so the card's distances are float32 grade)."""
    mat = mat.float()
    query = query.float()
    dots = torch.mv(mat, query)                            # [n]
    if metric == "<#>":
        return -dots
    if metric == "<=>":
        qn = torch.sqrt(torch.sum(query * query))
        mn = torch.sqrt(torch.sum(mat * mat, dim=1))
        return 1.0 - dots / torch.clamp(mn * qn, min=1e-30)
    nq = torch.sum(query * query)
    nm = torch.sum(mat * mat, dim=1)
    return torch.sqrt(torch.clamp(nm - 2.0 * dots + nq, min=0.0))


def _distance_column(mat: np.ndarray, query: np.ndarray, metric: str,
                     device: torch.device) -> np.ndarray:
    """The distances of every row of the column to the query, computed on
    `device` and returned to the host."""
    if mat.shape[0] == 0:
        return np.zeros((0,), np.float32)
    with torch.no_grad():
        out = _batched_distance(torch.from_numpy(mat).to(device),
                                torch.from_numpy(np.asarray(query, np.float32)).to(device),
                                metric)
    return out.cpu().numpy()


# ---------------------------------------------------------------------------
# Storage
# ---------------------------------------------------------------------------

@dataclass
class _VecIndex:
    index: Any                # ruvector_tpu_torch.index.hnsw.HnswIndex
    metric_op: str            # which operator this index accelerates
    size: int = 0             # rows covered so far (rows appended after build
                              # are added incrementally on touch)


class _Table:
    def __init__(self, name: str, columns: list[ColumnDef]):
        self.name = name
        self.columns = {c.name: c for c in columns}
        self.order = [c.name for c in columns]
        self.data: dict[str, list[Any]] = {c.name: [] for c in columns}
        # a vector column's rows live in a buffer that grows by doubling;
        # vecs[c] is the view of its first n rows
        self._bufs: dict[str, np.ndarray] = {
            c.name: np.zeros((0, c.dim), np.float32)
            for c in columns if c.type == "vector"
        }
        self.vecs: dict[str, np.ndarray] = {c: b[:0] for c, b in self._bufs.items()}
        self.indexes: dict[str, _VecIndex] = {}
        self.serial = 0

    def __len__(self) -> int:
        first = self.order[0]
        if first in self.vecs:
            return self.vecs[first].shape[0]
        return len(self.data[first])

    def column_values(self, name: str):
        if name in self.vecs:
            return self.vecs[name]
        return self.data[name]

    def _append_vector(self, cname: str, v: np.ndarray) -> None:
        n = self.vecs[cname].shape[0]
        buf = self._bufs[cname]
        if n == buf.shape[0]:
            grown = np.zeros((max(16, 2 * n), buf.shape[1]), np.float32)
            grown[:n] = buf[:n]
            self._bufs[cname] = buf = grown
        buf[n] = v
        self.vecs[cname] = buf[:n + 1]

    def append_row(self, values: dict[str, Any]):
        vectors = {}
        for cname, cdef in self.columns.items():
            if cdef.type == "vector":
                v = values.get(cname)
                if v is None:
                    v = np.zeros((cdef.dim,), np.float32)
                v = np.asarray(v, np.float32).reshape(-1)
                if v.shape[0] != cdef.dim:
                    raise SqlError(
                        f"vector dimension mismatch for {self.name}.{cname}: "
                        f"got {v.shape[0]}, column is {cdef.dim}")
                vectors[cname] = v
        for cname, cdef in self.columns.items():
            v = values.get(cname)
            if cdef.type == "vector":
                self._append_vector(cname, vectors[cname])
            else:
                if v is None and cdef.serial:
                    self.serial += 1
                    v = self.serial
                self.data[cname].append(v)

    def delete_rows(self, mask: np.ndarray):
        keep = ~mask
        for cname in self.vecs:
            self._bufs[cname] = self.vecs[cname][keep]
            self.vecs[cname] = self._bufs[cname][:]
        for cname, col in self.data.items():
            self.data[cname] = [v for v, k in zip(col, keep) if k]
        self.indexes.clear()   # physical renumbering invalidates ANN indexes


# ---------------------------------------------------------------------------
# SQL function registry — mirrors operators.rs / ruvector--0.3.0.sql names
# ---------------------------------------------------------------------------

def _vec(x) -> np.ndarray:
    if isinstance(x, str):
        x = json.loads(x)
    v = np.asarray(x, np.float32).reshape(-1)
    return v


def _pair(a, b) -> tuple[np.ndarray, np.ndarray]:
    va, vb = _vec(a), _vec(b)
    if va.shape != vb.shape:
        raise SqlError(
            f"cannot operate on vectors of different dimensions "
            f"({va.shape[0]} vs {vb.shape[0]})")
    return va, vb


def _f_l2(a, b):
    va, vb = _pair(a, b)
    return float(np.sqrt(np.sum((va - vb) ** 2)))


def _f_cosine_dist(a, b):
    va, vb = _pair(a, b)
    denom = max(float(np.linalg.norm(va) * np.linalg.norm(vb)), 1e-30)
    return 1.0 - float(va @ vb) / denom


def _f_ip(a, b):
    va, vb = _pair(a, b)
    return float(va @ vb)


def _f_l1(a, b):
    va, vb = _pair(a, b)
    return float(np.sum(np.abs(va - vb)))


def _f_binary_quantize(a):
    return [1 if x > 0 else 0 for x in _vec(a)]


# the scalar functions below take and return a few numbers: they run on
# host tensors whatever the engine's device

def _f_scalar_quantize(a):
    from ruvector_tpu_torch.ops.quantization import scalar_quantize
    q = scalar_quantize(torch.from_numpy(_vec(a)))
    return [int(x) for x in q.codes.reshape(-1).tolist()]


def _f_exp_map(v, p, c=1.0):
    from ruvector_tpu_torch.attention.hyperbolic import exp_map
    return [float(x) for x in exp_map(
        torch.from_numpy(_vec(v)), torch.from_numpy(_vec(p)), float(c)).tolist()]


def _f_log_map(y, p, c=1.0):
    from ruvector_tpu_torch.attention.hyperbolic import log_map
    return [float(x) for x in log_map(
        torch.from_numpy(_vec(y)), torch.from_numpy(_vec(p)), float(c)).tolist()]


SQL_FUNCTIONS: dict[str, Callable] = {
    # distance / similarity (operators.rs:19-120 names, both spellings)
    "ruvector_l2_distance": _f_l2,
    "l2_distance_arr": _f_l2,
    "ruvector_cosine_distance": _f_cosine_dist,
    "cosine_distance_arr": _f_cosine_dist,
    "cosine_similarity_arr": lambda a, b: 1.0 - _f_cosine_dist(a, b),
    "ruvector_inner_product": _f_ip,
    "inner_product_arr": _f_ip,
    "neg_inner_product_arr": lambda a, b: -_f_ip(a, b),
    "ruvector_l1_distance": _f_l1,
    "l1_distance_arr": _f_l1,
    # vector algebra
    "ruvector_dims": lambda v: int(_vec(v).shape[0]),
    "ruvector_norm": lambda v: float(np.linalg.norm(_vec(v))),
    "ruvector_normalize": lambda v: [
        float(x) for x in _vec(v) / max(float(np.linalg.norm(_vec(v))), 1e-30)],
    "ruvector_add": lambda a, b: [float(x) for x in np.add(*_pair(a, b))],
    "ruvector_sub": lambda a, b: [float(x) for x in np.subtract(*_pair(a, b))],
    "ruvector_mul_scalar": lambda v, s: [float(x) for x in _vec(v) * float(s)],
    # quantization (sql/ruvector--0.3.0.sql binary_quantize_arr)
    "binary_quantize_arr": _f_binary_quantize,
    "ruvector_quantize_scalar": _f_scalar_quantize,
    # hyperbolic maps (ruvector_exp_map / ruvector_log_map)
    "ruvector_exp_map": _f_exp_map,
    "ruvector_log_map": _f_log_map,
    # scalar helpers
    "abs": abs,
    "sqrt": lambda x: float(np.sqrt(x)),
    "coalesce": lambda *xs: next((x for x in xs if x is not None), None),
    "isnull": lambda x: x is None,
}


# ---------------------------------------------------------------------------
# Engine
# ---------------------------------------------------------------------------

_OPCLASS_TO_OP = {
    "vector_l2_ops": "<->",
    "vector_cosine_ops": "<=>",
    "vector_ip_ops": "<#>",
    "ruvector_l2_ops": "<->",
    "ruvector_cosine_ops": "<=>",
    "ruvector_ip_ops": "<#>",
}


class SqlEngine:
    """In-process engine for the pgvector/ruvector SQL surface.

    The exact kNN pass and the GNN worker run on `device` (default: the
    CUDA card); the store, the parser and the HNSW index are host-side.

    >>> eng = SqlEngine(device="cpu")
    >>> eng.execute("CREATE TABLE items (id int, embedding ruvector(3))")
    >>> eng.execute("INSERT INTO items VALUES (1, '[1,0,0]'), (2, '[0,1,0]')")
    >>> eng.execute("SELECT id FROM items ORDER BY embedding <-> '[1,0,0]' LIMIT 1")
    [{'id': 1}]
    """

    def __init__(self, device=None):
        self.device = resolve_device(device)
        self.tables: dict[str, _Table] = {}
        self.graphs: dict[str, Any] = {}
        self._worker = None            # lazy GnnTrainingWorker
        self._fns = dict(SQL_FUNCTIONS)
        self._fns.update({
            # graph surface needs engine state (ruvector_create_graph etc.)
            "ruvector_create_graph": self._g_create,
            "ruvector_delete_graph": self._g_delete,
            "ruvector_add_node": self._g_add_node,
            "ruvector_add_edge": self._g_add_edge,
            "ruvector_graph_stats": self._g_stats,
            "ruvector_cypher": self._g_cypher,
            # background GNN training worker (workers/gnn.rs:146-345 surface)
            "ruvector_gnn_train": self._gnn_train,
            "ruvector_gnn_worker_status": self._gnn_status,
            "ruvector_gnn_wait": self._gnn_wait,
            "ruvector_gnn_model": self._gnn_model,
        })

    def close(self):
        if self._worker is not None:
            self._worker.shutdown()
            self._worker = None

    # -- background GNN training over a table's vector column --------------
    def _gnn_worker(self):
        if self._worker is None:
            from ruvector_tpu_torch.training.worker import GnnTrainingWorker
            self._worker = GnnTrainingWorker(self._gnn_train_fn)
        return self._worker

    def _gnn_train_fn(self, table: str, epochs: int):
        """Contrastive GNN training over the table's first vector column:
        kNN graph -> RuvectorLayer -> InfoNCE epochs (the per-collection
        model the reference's `ruvector_gnn_train` worker produces), on the
        engine's device. Runs on the worker's thread, over a copy of the
        column taken when the job starts."""
        from ruvector_tpu_torch.graph.build import build_knn_graph
        from ruvector_tpu_torch.nn.ruvector_layer import (
            RuvectorLayerConfig, ruvector_layer_init)
        from ruvector_tpu_torch.training.optimizers import adam
        from ruvector_tpu_torch.training.train import (
            TrainConfig, make_train_step, train_epoch)

        t = self._table(table)
        cname = next(
            (c for c in t.order if t.columns[c].type == "vector"), None)
        if cname is None:
            raise SqlError(f"table {table!r} has no vector column")
        feats = t.vecs[cname].copy()
        n, d = feats.shape
        if n < 4:
            raise SqlError(f"table {table!r} has too few rows to train ({n})")
        graph = build_knn_graph(feats, k=min(8, n - 1), device=self.device)
        layer_cfg = RuvectorLayerConfig(input_dim=d, hidden_dim=d)
        params = ruvector_layer_init(0, layer_cfg, device=self.device)
        cfg = TrainConfig(batch_size=min(32, n), n_negatives=min(16, n - 1))
        opt = adam(cfg.learning_rate)
        step = make_train_step(layer_cfg, opt, cfg)
        opt_state = opt.init(params)
        gen = torch.Generator().manual_seed(0)
        feats_t = torch.from_numpy(feats).to(self.device)
        loss = 0.0
        for _ in range(max(1, int(epochs))):
            params, opt_state, loss = train_epoch(
                step, params, opt_state, feats_t, graph, cfg, gen)
        model = {"column": cname, "layer_cfg": layer_cfg,
                 "params": params, "loss": loss, "rows": n}
        return model, loss

    def _gnn_train(self, table: str, epochs=1, force=True):
        self._table(table)   # validate before queueing
        return int(self._gnn_worker().enqueue(
            str(table), epochs=int(epochs), force=bool(force)))

    def _gnn_status(self, job_id):
        job = self._gnn_worker().status(int(job_id))
        if job is None:
            raise SqlError(f"unknown job {job_id}")
        return json.dumps({
            "job_id": job.job_id, "collection": job.collection,
            "status": job.status.value, "loss": job.loss,
            "error": job.error})

    def _gnn_wait(self, job_id, timeout=60.0):
        self._gnn_worker().wait(int(job_id), float(timeout))
        return self._gnn_status(job_id)

    def _gnn_model(self, table: str):
        """Model summary fetch (workers/gnn.rs:345). The full params live on
        the engine (`engine.gnn_model(table)`); SQL returns the summary."""
        model = self._gnn_worker().model(str(table))
        if model is None:
            raise SqlError(f"no trained model for {table!r}")
        from ruvector_tpu_torch.training.optimizers import tree_leaves

        return json.dumps({
            "collection": str(table), "column": model["column"],
            "rows": model["rows"], "loss": model["loss"],
            "param_count": sum(leaf.numel() for leaf in tree_leaves(model["params"])),
        })

    def gnn_model(self, table: str):
        """Programmatic access to the trained params/config for a table."""
        return self._gnn_worker().model(str(table))

    # -- graph function surface -------------------------------------------
    def _graph(self, name: str):
        if name not in self.graphs:
            raise SqlError(f"unknown graph {name!r}")
        return self.graphs[name]

    def _g_create(self, name: str):
        from ruvector_tpu_torch.graph.property import PropertyGraph
        self.graphs[name] = PropertyGraph()
        return name

    def _g_delete(self, name: str):
        self.graphs.pop(name, None)
        return name

    def _g_add_node(self, graph: str, node_id, labels="", props="{}"):
        g = self._graph(graph)
        lab = [s for s in str(labels).split(",") if s]
        g.add_node(str(node_id), lab, **json.loads(props or "{}"))
        return str(node_id)

    def _g_add_edge(self, graph: str, src, dst, etype="RELATED", props="{}"):
        g = self._graph(graph)
        g.add_edge(str(src), str(dst), str(etype), **json.loads(props or "{}"))
        return f"{src}->{dst}"

    def _g_stats(self, graph: str):
        g = self._graph(graph)
        return json.dumps({"nodes": len(g._nodes), "edges": len(g._edges)})

    def _g_cypher(self, graph: str, query: str):
        from ruvector_tpu_torch.graph.cypher import execute_cypher
        return json.dumps(execute_cypher(self._graph(graph), query), default=str)

    # -- public API --------------------------------------------------------
    def execute(self, sql: str):
        """Execute ';'-separated statements; returns the last statement's
        result (list of row dicts for SELECT, affected-row count otherwise)."""
        result = None
        for stmt in parse_sql(sql):
            result = self._run(stmt)
        return result

    # -- dispatch ----------------------------------------------------------
    def _run(self, stmt):
        if isinstance(stmt, CreateTable):
            if stmt.name in self.tables:
                if stmt.if_not_exists:
                    return 0
                raise SqlError(f"table {stmt.name!r} already exists")
            self.tables[stmt.name] = _Table(stmt.name, stmt.columns)
            return 0
        if isinstance(stmt, DropTable):
            if stmt.name not in self.tables and not stmt.if_exists:
                raise SqlError(f"unknown table {stmt.name!r}")
            self.tables.pop(stmt.name, None)
            return 0
        if isinstance(stmt, CreateIndex):
            return self._create_index(stmt)
        if isinstance(stmt, Insert):
            return self._insert(stmt)
        if isinstance(stmt, Delete):
            return self._delete(stmt)
        if isinstance(stmt, Update):
            return self._update(stmt)
        if isinstance(stmt, Select):
            return self._select(stmt)
        if isinstance(stmt, Explain):
            return self._explain(stmt.stmt)
        raise SqlError(f"unhandled statement {stmt}")

    def _explain(self, stmt) -> list[dict]:
        """EXPLAIN: one row per plan step; for kNN SELECTs, says whether the
        ORDER BY rides the native HNSW index or the batched device scan."""
        if not isinstance(stmt, Select):
            return [{"plan": type(stmt).__name__.lower()}]
        steps: list[dict] = []
        if stmt.table is None:
            return [{"plan": "function scan (no table)"}]
        t = self._table(stmt.table)
        n = len(t)
        filtered = stmt.where is not None
        steps.append({"plan": f"seq scan on {stmt.table} ({n} rows)"
                              + (" with filter" if filtered else "")})
        if stmt.order:
            knn = _knn_order(stmt, t)
            if knn is not None:
                cname, metric, _ = knn
                idx = t.indexes.get(cname)
                k = None if stmt.limit is None else stmt.limit + stmt.offset
                if (idx is not None and idx.metric_op == metric
                        and not filtered and k is not None and k < n):
                    steps.append({"plan": f"hnsw index scan on {cname} "
                                          f"({metric}, k={k})"})
                else:
                    why = ("no index" if idx is None else
                           "metric mismatch" if idx.metric_op != metric else
                           "filtered scan set" if filtered else "no limit")
                    steps.append({"plan": f"batched device distance scan on "
                                          f"{cname} ({metric}; {why})"})
            else:
                steps.append({"plan": "row sort"})
        if stmt.limit is not None:
            steps.append({"plan": f"limit {stmt.limit}"
                                  + (f" offset {stmt.offset}"
                                     if stmt.offset else "")})
        return steps

    def _table(self, name: str) -> _Table:
        if name not in self.tables:
            raise SqlError(f"unknown table {name!r}")
        return self.tables[name]

    # -- DDL/DML -----------------------------------------------------------
    def _create_index(self, stmt: CreateIndex) -> int:
        from ruvector_tpu_torch.index.hnsw import HnswConfig, HnswIndex
        t = self._table(stmt.table)
        cdef = t.columns.get(stmt.column)
        if cdef is None or cdef.type != "vector":
            raise SqlError(f"{stmt.column!r} is not a vector column")
        if stmt.method != "hnsw":
            raise SqlError(f"unsupported index method {stmt.method!r}")
        op = _OPCLASS_TO_OP.get(stmt.opclass)
        if op is None:
            raise SqlError(f"unknown operator class {stmt.opclass!r}")
        if op == "<#>":
            # the HNSW index knows l2 and cosine only: an index built as
            # either would serve <#> in another order
            raise SqlError(
                f"operator class {stmt.opclass!r} is not supported by hnsw "
                f"(no inner-product metric); <#> runs as an exact scan")
        metric = "cosine" if op == "<=>" else "l2"
        cfg = HnswConfig(
            dim=cdef.dim,
            m=int(stmt.options.get("m", 16)),
            ef_construction=int(stmt.options.get("ef_construction", 200)),
            metric=metric,
        )
        idx = HnswIndex(cfg, device=self.device)
        mat = t.vecs[stmt.column]
        if mat.shape[0]:
            idx.add_batch(mat)
        t.indexes[stmt.column] = _VecIndex(index=idx, metric_op=op,
                                           size=mat.shape[0])
        return mat.shape[0]

    def _insert(self, stmt: Insert) -> int:
        t = self._table(stmt.table)
        cols = stmt.columns or t.order
        if any(c not in t.columns for c in cols):
            bad = [c for c in cols if c not in t.columns]
            raise SqlError(f"unknown column(s) {bad} in {stmt.table!r}")
        for row in stmt.rows:
            if len(row) != len(cols):
                raise SqlError("INSERT value count does not match column list")
            values = {}
            for cname, expr in zip(cols, row):
                v = self._eval(expr, t, None)
                if t.columns[cname].type == "vector" and isinstance(v, str):
                    v = _parse_vector_text(v)
                if t.columns[cname].type == "jsonb" and isinstance(v, str):
                    v = json.loads(v)
                values[cname] = v
            t.append_row(values)
        return len(stmt.rows)

    def _delete(self, stmt: Delete) -> int:
        t = self._table(stmt.table)
        n = len(t)
        if stmt.where is None:
            mask = np.ones(n, bool)
        else:
            mask = np.asarray(
                [bool(self._eval(stmt.where, t, i)) for i in range(n)])
        t.delete_rows(mask)
        return int(mask.sum())

    def _update(self, stmt: Update) -> int:
        t = self._table(stmt.table)
        n = len(t)
        changed = 0
        for i in range(n):
            if stmt.where is not None and not self._eval(stmt.where, t, i):
                continue
            for cname, expr in stmt.assignments:
                cdef = t.columns.get(cname)
                if cdef is None:
                    raise SqlError(f"unknown column {cname!r}")
                v = self._eval(expr, t, i)
                if cdef.type == "vector":
                    if isinstance(v, str):
                        v = _parse_vector_text(v)
                    v = np.asarray(v, np.float32).reshape(-1)
                    if v.shape[0] != cdef.dim:
                        raise SqlError("vector dimension mismatch in UPDATE")
                    t.vecs[cname][i] = v
                    t.indexes.pop(cname, None)
                else:
                    t.data[cname][i] = v
            changed += 1
        return changed

    # -- SELECT ------------------------------------------------------------
    def _select(self, stmt: Select):
        if stmt.table is None:
            # function-call select: SELECT ruvector_l2_distance('[..]','[..]')
            out = {}
            for j, (e, alias) in enumerate(stmt.items):
                out[alias or _expr_name(e, j)] = self._eval(e, None, None)
            return [out]
        t = self._table(stmt.table)
        n = len(t)

        # validate column references up front (so empty tables still error)
        for e, _ in stmt.items:
            _check_columns(e, t)
        if stmt.where is not None:
            _check_columns(stmt.where, t)
        for o in stmt.order:
            _check_columns(o.expr, t)

        # WHERE mask
        if stmt.where is None:
            rows = list(range(n))
        else:
            rows = [i for i in range(n) if self._eval(stmt.where, t, i)]

        # aggregate: SELECT count(*) ...
        if (len(stmt.items) == 1 and isinstance(stmt.items[0][0], Func)
                and stmt.items[0][0].name == "count"):
            alias = stmt.items[0][1] or "count"
            return [{alias: len(rows)}]

        # ORDER BY — kNN fast path when the sole key is an ascending
        # distance operator (further keys order the ties: the row sort)
        limited = False
        if stmt.order:
            knn = _knn_order(stmt, t)
            if knn is not None:
                cname, metric, query = knn
                rows = self._knn_rows(t, cname, metric, query, rows,
                                      stmt.limit, stmt.offset)
                limited = True
            else:
                keys = []
                for i in rows:
                    keys.append(tuple(
                        _sort_key(self._eval(o.expr, t, i), o.desc)
                        for o in stmt.order))
                rows = [r for _, r in sorted(zip(keys, rows),
                                             key=lambda p: p[0])]
        if not limited:
            if stmt.offset:
                rows = rows[stmt.offset:]
            if stmt.limit is not None:
                rows = rows[:stmt.limit]

        # projection
        out = []
        for i in rows:
            rec = {}
            for j, (e, alias) in enumerate(stmt.items):
                if isinstance(e, Star):
                    for cname in t.order:
                        rec[cname] = _pyval(self._col_value(t, cname, i))
                else:
                    key = alias or _expr_name(e, j)
                    rec[key] = _pyval(self._eval(e, t, i))
            out.append(rec)
        return out

    def _knn_rows(self, t: _Table, cname: str, metric: str,
                  query: np.ndarray, rows: list[int], limit: int | None,
                  offset: int) -> list[int]:
        """Return row ids sorted by distance. Uses the native HNSW index when
        it matches (full scan set, same metric); otherwise one distance pass
        on the engine's device and a stable argsort on the host."""
        mat = t.vecs[cname]
        if query.shape[0] != mat.shape[1]:
            raise SqlError(
                f"query dimension {query.shape[0]} != column dimension "
                f"{mat.shape[1]}")
        n = mat.shape[0]
        full_scan = len(rows) == n
        idx = t.indexes.get(cname)
        k = None if limit is None else limit + offset
        if (idx is not None and idx.metric_op == metric and full_scan
                and k is not None and k < n):
            if idx.size < n:   # rows appended since index build
                idx.index.add_batch(mat[idx.size:])
                idx.size = n
            ids, _ = idx.index.search(query, k=k,
                                      ef=max(2 * k, idx.index.config.ef_search))
            picked = [int(i) for i in ids if i >= 0]
            return picked[offset:] if offset else picked
        # exact batched path on the device
        d = _distance_column(mat, query, metric, self.device)
        sel = np.asarray(rows, np.int64)
        order = sel[np.argsort(d[sel], kind="stable")]
        out = [int(i) for i in order]
        out = out[offset:] if offset else out
        return out if k is None else out[: (k - offset)]

    # -- expression evaluation --------------------------------------------
    def _col_value(self, t: _Table, cname: str, i: int):
        if cname in t.vecs:
            return t.vecs[cname][i]
        return t.data[cname][i]

    def _eval(self, e, t: _Table | None, i: int | None):
        if isinstance(e, Lit):
            return e.value
        if isinstance(e, Col):
            if t is None or i is None:
                raise SqlError(f"column {e.name!r} outside row context")
            if e.name not in t.columns:
                raise SqlError(f"unknown column {e.name!r}")
            return self._col_value(t, e.name, i)
        if isinstance(e, Un):
            v = self._eval(e.operand, t, i)
            if e.op == "neg":
                return -v
            return None if v is None else not bool(v)
        if isinstance(e, Bin):
            # three-valued AND / OR: NULL where the known side does not decide
            if e.op == "and":
                lv = self._eval(e.left, t, i)
                if lv is not None and not bool(lv):
                    return False
                rv = self._eval(e.right, t, i)
                if rv is not None and not bool(rv):
                    return False
                return None if lv is None or rv is None else True
            if e.op == "or":
                lv = self._eval(e.left, t, i)
                if lv is not None and bool(lv):
                    return True
                rv = self._eval(e.right, t, i)
                if rv is not None and bool(rv):
                    return True
                return None if lv is None or rv is None else False
            lv = self._eval(e.left, t, i)
            rv = self._eval(e.right, t, i)
            if e.op in _DIST_OPS:
                la = _as_vector(lv)
                ra = _as_vector(rv)
                if la.shape != ra.shape:
                    raise SqlError(
                        f"operator {e.op} on different dimensions "
                        f"({la.shape[0]} vs {ra.shape[0]})")
                if e.op == "<->":
                    return _f_l2(la, ra)
                if e.op == "<#>":
                    return -_f_ip(la, ra)
                return _f_cosine_dist(la, ra)
            return _scalar_binop(e.op, lv, rv)
        if isinstance(e, Func):
            if e.name == "_cast_vector":
                return _as_vector(self._eval(e.args[0], t, i))
            fn = self._fns.get(e.name)
            if fn is None:
                raise SqlError(f"unknown function {e.name!r}")
            args = [None if isinstance(a, Star)
                    else self._eval(a, t, i) for a in e.args]
            return fn(*args)
        if isinstance(e, Star):
            raise SqlError("'*' not valid here")
        raise SqlError(f"cannot evaluate {e!r}")


# ---------------------------------------------------------------------------
# Helpers
# ---------------------------------------------------------------------------

def _parse_vector_text(s: str) -> np.ndarray:
    s = s.strip()
    if not (s.startswith("[") and s.endswith("]")):
        raise SqlError(f"malformed vector literal {s!r}")
    body = s[1:-1].strip()
    if not body:
        return np.zeros((0,), np.float32)
    try:
        return np.asarray([float(x) for x in body.split(",")], np.float32)
    except ValueError as exc:
        raise SqlError(f"malformed vector literal {s!r}") from exc


def _as_vector(v) -> np.ndarray:
    if isinstance(v, str):
        return _parse_vector_text(v)
    if isinstance(v, np.ndarray):
        return v.astype(np.float32).reshape(-1)
    if isinstance(v, (list, tuple)):
        return np.asarray(v, np.float32)
    raise SqlError(f"expected a vector, got {type(v).__name__}")


def _scalar_binop(op: str, lv, rv):
    if lv is None or rv is None:
        return None                      # SQL: any comparison with NULL is NULL
    if op in ("=", "<>"):
        if isinstance(lv, np.ndarray) or isinstance(rv, np.ndarray):
            la, ra = _as_vector(lv), _as_vector(rv)
            same = la.shape == ra.shape and bool(np.array_equal(la, ra))
        else:
            same = lv == rv
        return same if op == "=" else not same
    if op == "<":
        return lv < rv
    if op == ">":
        return lv > rv
    if op == "<=":
        return lv <= rv
    if op == ">=":
        return lv >= rv
    if op == "+":
        return lv + rv
    if op == "-":
        return lv - rv
    if op == "*":
        return lv * rv
    if op == "/":
        return lv / rv
    raise SqlError(f"unknown operator {op!r}")


def _sort_key(v, desc: bool):
    if isinstance(v, (int, float, np.floating, np.integer)):
        x = float(v)
        return (-x if desc else x, "")
    s = "" if v is None else str(v)
    if desc:
        # invert string ordering via codepoint complement
        s = "".join(chr(0x10FFFF - ord(c)) for c in s)
    return (float("-inf") if desc else float("inf"), s)


def _knn_order(stmt: Select, t: _Table):
    """(column, operator, query) when the ORDER BY is one ascending distance
    key that the kNN path serves; None otherwise."""
    if len(stmt.order) != 1 or stmt.order[0].desc:
        return None
    return _distance_order_key(stmt.order[0].expr, t)


def _distance_order_key(e, t: _Table):
    """Recognise `vec_column <op> <query>` (either side) for the kNN path."""
    if not isinstance(e, Bin) or e.op not in _DIST_OPS:
        return None
    left, right = e.left, e.right
    if isinstance(right, Col) and not isinstance(left, Col):
        left, right = right, left
    if not isinstance(left, Col) or left.name not in t.vecs:
        return None
    q = right
    if isinstance(q, Func) and q.name == "_cast_vector":
        q = q.args[0]
    if isinstance(q, Lit):
        val = q.value
        if isinstance(val, str):
            val = _parse_vector_text(val)
        if isinstance(val, np.ndarray):
            return left.name, e.op, val.astype(np.float32)
    return None


def _check_columns(e, t: _Table) -> None:
    """Walk an expression and reject unknown column references eagerly."""
    if isinstance(e, Col):
        if e.name not in t.columns:
            raise SqlError(f"unknown column {e.name!r} in table {t.name!r}")
    elif isinstance(e, Bin):
        _check_columns(e.left, t)
        _check_columns(e.right, t)
    elif isinstance(e, Un):
        _check_columns(e.operand, t)
    elif isinstance(e, Func):
        for a in e.args:
            if not isinstance(a, Star):
                _check_columns(a, t)


def _expr_name(e, j: int) -> str:
    if isinstance(e, Col):
        return e.name
    if isinstance(e, Func):
        return e.name
    if isinstance(e, Bin) and e.op in _DIST_OPS:
        return "distance"
    return f"col{j}"


def _pyval(v):
    if isinstance(v, np.ndarray):
        return [float(x) for x in v.reshape(-1)]
    if isinstance(v, (np.floating,)):
        return float(v)
    if isinstance(v, (np.integer,)):
        return int(v)
    if isinstance(v, (np.bool_,)):
        return bool(v)
    return v


def execute_sql(engine: SqlEngine, sql: str):
    """Module-level convenience mirroring `execute_cypher`."""
    return engine.execute(sql)
