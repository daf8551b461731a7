"""Payload filtering for vector search (port of ruvector_tpu/index/filter.py).

Reference: ruvector-filter (expression.rs: FilterExpression with
eq/ne/gt/gte/lt/lte/range/in/match_text/geo/and/or/not/exists/is_null;
evaluator.rs: per-payload matcher + index-accelerated candidate sets;
index.rs: per-field payload indices). The Qdrant-style JSON form
(must/should/must_not with match/range conditions) is what the HTTP
search route accepts.

Host-side by design — filtering is a pre/post step around the device
distance path. The PayloadIndex gives the evaluator exact candidate id
sets for eq/in/range without scanning every payload.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any


@dataclasses.dataclass(frozen=True)
class FilterExpression:
    """Tagged filter node (expression.rs:7-205)."""

    op: str                      # see constructors
    field: str | None = None
    value: Any = None
    children: tuple = ()

    # -- constructors ------------------------------------------------------
    @staticmethod
    def eq(field, value):
        return FilterExpression("eq", field, value)

    @staticmethod
    def ne(field, value):
        return FilterExpression("ne", field, value)

    @staticmethod
    def gt(field, value):
        return FilterExpression("gt", field, value)

    @staticmethod
    def gte(field, value):
        return FilterExpression("gte", field, value)

    @staticmethod
    def lt(field, value):
        return FilterExpression("lt", field, value)

    @staticmethod
    def lte(field, value):
        return FilterExpression("lte", field, value)

    @staticmethod
    def range(field, gte=None, lte=None, gt=None, lt=None):
        return FilterExpression(
            "range", field, {"gte": gte, "lte": lte, "gt": gt, "lt": lt})

    @staticmethod
    def in_values(field, values):
        return FilterExpression("in", field, tuple(values))

    @staticmethod
    def match_text(field, text):
        return FilterExpression("match_text", field, text)

    @staticmethod
    def geo_radius(field, lat, lon, radius_m):
        return FilterExpression("geo_radius", field,
                                {"lat": lat, "lon": lon, "radius": radius_m})

    @staticmethod
    def geo_bounding_box(field, top_left, bottom_right):
        return FilterExpression("geo_bbox", field,
                                {"tl": tuple(top_left),
                                 "br": tuple(bottom_right)})

    @staticmethod
    def and_(filters):
        return FilterExpression("and", children=tuple(filters))

    @staticmethod
    def or_(filters):
        return FilterExpression("or", children=tuple(filters))

    @staticmethod
    def not_(filter):
        return FilterExpression("not", children=(filter,))

    @staticmethod
    def exists(field):
        return FilterExpression("exists", field)

    @staticmethod
    def is_null(field):
        return FilterExpression("is_null", field)

    def get_fields(self) -> list[str]:
        out = [self.field] if self.field is not None else []
        for c in self.children:
            out.extend(c.get_fields())
        return out


def _geo_dist_m(lat1, lon1, lat2, lon2):
    """Haversine (meters)."""
    r = 6_371_000.0
    p1, p2 = math.radians(lat1), math.radians(lat2)
    dp = math.radians(lat2 - lat1)
    dl = math.radians(lon2 - lon1)
    a = (math.sin(dp / 2) ** 2
         + math.cos(p1) * math.cos(p2) * math.sin(dl / 2) ** 2)
    return 2 * r * math.asin(math.sqrt(a))


def _cmp_ok(a, b) -> bool:
    return isinstance(a, (int, float)) and isinstance(b, (int, float)) \
        and not isinstance(a, bool) and not isinstance(b, bool) \
        or (isinstance(a, str) and isinstance(b, str))


def matches(payload: dict | None, f: FilterExpression) -> bool:
    """evaluator.rs:53 — does one payload satisfy the filter?"""
    if f.op == "and":
        return all(matches(payload, c) for c in f.children)
    if f.op == "or":
        return any(matches(payload, c) for c in f.children)
    if f.op == "not":
        return not matches(payload, f.children[0])

    v = (payload or {}).get(f.field)
    if f.op == "exists":
        return v is not None
    if f.op == "is_null":
        return v is None
    if f.op == "eq":
        if isinstance(v, list):
            return f.value in v     # Qdrant array semantics: match any
        return v == f.value
    if f.op == "ne":
        if isinstance(v, list):
            return f.value not in v
        return v != f.value
    if f.op in ("gt", "gte", "lt", "lte"):
        vals = v if isinstance(v, list) else [v]
        return any(
            _cmp_ok(x, f.value)
            and {"gt": x > f.value, "gte": x >= f.value,
                 "lt": x < f.value, "lte": x <= f.value}[f.op]
            for x in vals if x is not None)
    if f.op == "range":
        r = f.value

        def in_range(x):
            if not isinstance(x, (int, float)) or isinstance(x, bool):
                return False
            if r["gte"] is not None and not x >= r["gte"]:
                return False
            if r["lte"] is not None and not x <= r["lte"]:
                return False
            if r["gt"] is not None and not x > r["gt"]:
                return False
            if r["lt"] is not None and not x < r["lt"]:
                return False
            return True

        vals = v if isinstance(v, list) else [v]
        return any(in_range(x) for x in vals if x is not None)
    if f.op == "in":
        if isinstance(v, list):
            return any(x in f.value for x in v)
        return v in f.value
    if f.op == "match_text":
        return isinstance(v, str) and f.value.lower() in v.lower()
    if f.op == "geo_radius":
        if not isinstance(v, dict):
            return False
        return _geo_dist_m(v.get("lat", 0), v.get("lon", 0),
                           f.value["lat"], f.value["lon"]) \
            <= f.value["radius"]
    if f.op == "geo_bbox":
        if not isinstance(v, dict):
            return False
        (t, l), (b, r) = f.value["tl"], f.value["br"]
        return b <= v.get("lat", 0) <= t and l <= v.get("lon", 0) <= r
    raise ValueError(f"unknown filter op {f.op!r}")


def parse_qdrant_filter(spec: dict) -> FilterExpression:
    """Qdrant JSON filter -> FilterExpression.

    {"must": [...], "should": [...], "must_not": [...]} where each
    condition is {"key": f, "match": {"value": v} | {"any": [...]} |
    {"text": t}} or {"key": f, "range": {gte/lte/gt/lt}} or
    {"key": f, "geo_radius": {center: {lat, lon}, radius}} or
    {"is_null"/"is_empty": {"key": f}} or a nested filter dict.
    """
    def cond(c: dict) -> FilterExpression:
        if "must" in c or "should" in c or "must_not" in c:
            return parse_qdrant_filter(c)
        if "is_null" in c:
            return FilterExpression.is_null(c["is_null"]["key"])
        if "is_empty" in c:
            return FilterExpression.is_null(c["is_empty"]["key"])
        key = c["key"]
        if "match" in c:
            m = c["match"]
            if "any" in m:
                return FilterExpression.in_values(key, m["any"])
            if "text" in m:
                return FilterExpression.match_text(key, m["text"])
            return FilterExpression.eq(key, m.get("value"))
        if "range" in c:
            r = c["range"]
            return FilterExpression.range(
                key, gte=r.get("gte"), lte=r.get("lte"),
                gt=r.get("gt"), lt=r.get("lt"))
        if "geo_radius" in c:
            g = c["geo_radius"]
            return FilterExpression.geo_radius(
                key, g["center"]["lat"], g["center"]["lon"], g["radius"])
        if "geo_bounding_box" in c:
            g = c["geo_bounding_box"]
            return FilterExpression.geo_bounding_box(
                key, (g["top_left"]["lat"], g["top_left"]["lon"]),
                (g["bottom_right"]["lat"], g["bottom_right"]["lon"]))
        raise ValueError(f"unknown condition {c!r}")

    parts = []
    if spec.get("must"):
        parts.append(FilterExpression.and_([cond(c) for c in spec["must"]]))
    if spec.get("should"):
        parts.append(FilterExpression.or_([cond(c) for c in spec["should"]]))
    if spec.get("must_not"):
        parts.append(FilterExpression.not_(
            FilterExpression.or_([cond(c) for c in spec["must_not"]])))
    if not parts:
        raise ValueError("empty filter")
    return parts[0] if len(parts) == 1 else FilterExpression.and_(parts)


class PayloadIndex:
    """Per-field inverted + sorted index (index.rs role): exact candidate
    id sets for eq/in, sorted-range scans for range queries."""

    def __init__(self):
        self._by_value: dict[str, dict[Any, set]] = {}
        self._numeric: dict[str, list] = {}       # (value, id), kept sorted
        self._dirty_numeric: set[str] = set()

    def add(self, point_id, payload: dict | None):
        for k, v in (payload or {}).items():
            # Qdrant array semantics: a list-valued field matches a
            # condition if ANY element does, so index every element.
            elems = v if isinstance(v, list) else [v]
            for e in elems:
                if isinstance(e, (str, bool)) or (
                        isinstance(e, (int, float))
                        and not isinstance(e, bool)):
                    self._by_value.setdefault(k, {}).setdefault(
                        e, set()).add(point_id)
                if isinstance(e, (int, float)) and not isinstance(e, bool):
                    self._numeric.setdefault(k, []).append((e, point_id))
                    self._dirty_numeric.add(k)

    def ids_eq(self, field, value) -> set:
        return set(self._by_value.get(field, {}).get(value, ()))

    def ids_in(self, field, values) -> set:
        out = set()
        for v in values:
            out |= self.ids_eq(field, v)
        return out

    def ids_range(self, field, gte=None, lte=None, gt=None, lt=None) -> set:
        import bisect

        arr = self._numeric.get(field)
        if arr is None:
            return set()
        if field in self._dirty_numeric:
            arr.sort(key=lambda t: t[0])
            self._dirty_numeric.discard(field)
        lo = 0
        hi = len(arr)
        keys = [t[0] for t in arr]
        if gte is not None:
            lo = bisect.bisect_left(keys, gte)
        if gt is not None:
            lo = max(lo, bisect.bisect_right(keys, gt))
        if lte is not None:
            hi = bisect.bisect_right(keys, lte)
        if lt is not None:
            hi = min(hi, bisect.bisect_left(keys, lt))
        return {pid for _, pid in arr[lo:hi]}


def candidate_ids(index: PayloadIndex, f: FilterExpression) -> set | None:
    """Index-accelerated candidate set (evaluator.rs:20-50): the ids
    that COULD satisfy the filter, or None when the index cannot bound
    it (the caller falls back to over-fetch + post-filter).

    Sound over-approximation rules:
      and  -> intersection of bounded children (None children ignored;
              all-None -> None)
      or   -> union; any None child -> None (unbounded branch)
      eq/in/range -> exact sets from the index
      everything else (not/ne/match_text/geo/exists/is_null) -> None
    """
    if f.op == "and":
        sets = [s for s in (candidate_ids(index, c) for c in f.children)
                if s is not None]
        if not sets:
            return None
        out = sets[0]
        for s in sets[1:]:
            out = out & s
        return out
    if f.op == "or":
        out = set()
        for c in f.children:
            s = candidate_ids(index, c)
            if s is None:
                return None
            out |= s
        return out
    if f.op == "eq":
        return index.ids_eq(f.field, f.value)
    if f.op == "in":
        return index.ids_in(f.field, f.value)
    if f.op == "range":
        r = f.value
        return index.ids_range(f.field, gte=r["gte"], lte=r["lte"],
                               gt=r["gt"], lt=r["lt"])
    if f.op in ("gt", "gte", "lt", "lte"):
        return index.ids_range(f.field, **{f.op: f.value})
    return None
