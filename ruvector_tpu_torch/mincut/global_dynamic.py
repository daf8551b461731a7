"""Global (no source/sink) dynamic minimum cut (port of
ruvector_tpu/mincut/global_dynamic.py; host numpy).

Reference capability: ruvector-mincut maintains the GLOBAL min cut under
edge insert/delete with subpolynomial structures (linkcut/euler/
subpolynomial subsystems, src/lib.rs:1-57). This is the framework's
equivalent, built on exact incremental invariants rather than a
translation of those tree structures:

  insert(u, v, w):
    - cuts separating {u, v} grow by w; others are unchanged. If the
      current minimum cut does NOT separate u from v its value is still
      attained and no smaller cut can exist (insert never decreases cut
      values) -> O(pool) exact update.
    - if it DOES separate them, some unaffected cut may now be minimum.
      A candidate pool (the best cut-of-the-phase partitions from the
      last Stoer-Wagner sweep, values maintained incrementally) often
      exhibits an unaffected cut at the old value, which proves
      optimality; otherwise one exact Stoer-Wagner recompute repairs.
  delete / decrease (u, v, delta):
    - only cuts separating {u, v} shrink. If the current cut separates
      them: value -= delta, partition unchanged — exact.
    - otherwise the new optimum is min(old value, min u-v cut in G') —
      ONE max-flow (Dinic) repairs exactly; no global recompute.

Semantics: undirected weighted graph over `num_nodes` vertices; the cut
is over ACTIVE nodes (degree > 0). If the active graph is disconnected
the minimum cut is 0 with a connected component as one side. Fewer than
2 active nodes -> value 0, empty partition.

The same design is mirrored natively (graph_runtime.cpp gmc_*) for
at-scale streams; this module is the exact reference implementation the
native solver is fuzz-pinned to, and both are pinned to a brute-force
enumerator in tests/test_global_mincut.py.
"""

from __future__ import annotations

import numpy as np


def stoer_wagner(adj: dict[tuple[int, int], float], nodes: list[int]
                 ) -> tuple[float, set, list[tuple[float, set]]]:
    """Exact global min cut of the connected graph induced on `nodes`.

    Returns (best_value, best_side, phase_cuts) where phase_cuts is every
    cut-of-the-phase (value, side-set) the sweep produced — the natural
    candidate pool for incremental maintenance.
    """
    idx = {v: i for i, v in enumerate(nodes)}
    n = len(nodes)
    w = np.zeros((n, n))
    for (u, v), ww in adj.items():
        if u in idx and v in idx:
            w[idx[u], idx[v]] += ww
            w[idx[v], idx[u]] += ww
    # merged[i] = set of original nodes currently contracted into i
    merged = [{nodes[i]} for i in range(n)]
    alive = list(range(n))
    best, best_side = np.inf, set()
    phases: list[tuple[float, set]] = []
    while len(alive) > 1:
        # minimum cut phase: maximum-adjacency order
        a = [alive[0]]
        rest = set(alive[1:])
        conn = w[alive[0]].copy()
        while rest:
            nxt = max(rest, key=lambda x: conn[x])
            a.append(nxt)
            rest.discard(nxt)
            conn += w[nxt]
        s, t = a[-2], a[-1]
        cut_of_phase = float(w[t, alive].sum())
        side = set(merged[t])
        phases.append((cut_of_phase, side))
        if cut_of_phase < best:
            best, best_side = cut_of_phase, side
        # contract t into s
        w[s] += w[t]
        w[:, s] += w[:, t]
        w[s, s] = 0.0
        w[t, :] = 0.0
        w[:, t] = 0.0
        merged[s] |= merged[t]
        alive.remove(t)
    return best, best_side, phases


def noi_mincut(adj: dict[tuple[int, int], float], nodes: list[int]
               ) -> tuple[float, set, list[tuple[float, set]]]:
    """Exact global min cut via Nagamochi-Ono-Ibaraki scan-contraction.

    Same contract as stoer_wagner (value, side, candidate cuts) but each
    maximum-adjacency scan contracts EVERY consecutive pair (v_{i-1},
    v_i) whose scan value r(v_i) >= lambda-hat — by the NI scan-value
    lemma lambda(v_{i-1}, v_i) >= r(v_i), so no cut better than the
    current bound separates them (and simultaneous contraction is safe:
    contraction never lowers pairwise connectivity). Plus the
    Padberg-Rinaldi rule: any edge of weight >= lambda-hat contracts.
    Clustered graphs collapse in a handful of scans (each O(E log V))
    instead of Stoer-Wagner's O(V) phases — this is what takes the
    500k-node first query from hours to seconds. Worst case (e.g. a
    uniform cycle) degrades to one contraction per scan = Stoer-Wagner.

    Reference capability: ruvector-mincut/src/lib.rs:1-57 (the
    subpolynomial machinery exists to avoid exactly this full-solve
    cost; we make the full solve itself near-linear on real graphs).
    """
    import heapq

    m = len(nodes)
    if m < 2:
        return 0.0, set(), []
    idx = {v: i for i, v in enumerate(nodes)}
    g: list[dict[int, float]] = [{} for _ in range(m)]
    for (u, v), ww in adj.items():
        i, j = idx.get(u), idx.get(v)
        if i is None or j is None or i == j:
            continue
        g[i][j] = g[i].get(j, 0.0) + ww
        g[j][i] = g[j].get(i, 0.0) + ww
    merged: list[list[int]] = [[v] for v in nodes]
    alive = [True] * m
    alive_cnt = m

    best, best_side = np.inf, []
    cands: list[tuple[float, set]] = []

    def consider(val, side_nodes):
        nonlocal best, best_side
        if not (0 < len(side_nodes) < m):   # proper cuts only
            return
        cands.append((val, set(side_nodes)))
        if val < best - 1e-15:
            best, best_side = val, list(side_nodes)

    for i in range(m):
        consider(sum(g[i].values()), merged[i])

    parent = list(range(m))

    def find(a):
        while parent[a] != a:
            parent[a] = parent[parent[a]]
            a = parent[a]
        return a

    while alive_cnt > 1:
        start = next(i for i in range(m) if alive[i])
        conn = [0.0] * m
        in_a = [False] * m
        heap = [(0.0, start)]
        order, rvals = [], []
        while heap:
            negc, x = heapq.heappop(heap)
            if in_a[x] or not alive[x]:
                continue
            in_a[x] = True
            order.append(x)
            rvals.append(-negc)
            for y, ww in g[x].items():
                if alive[y] and not in_a[y]:
                    conn[y] += ww
                    heapq.heappush(heap, (-conn[y], y))
        # cut of the phase: the last scanned group vs the rest
        cop = rvals[-1]
        consider(cop, merged[order[-1]])
        lam = best
        # batch-contract: consecutive scan pairs with r >= lam, the
        # final pair (always safe once lam <= cop), PR1 heavy edges, and
        # the PR2 degree rule (2 w(u,v) >= d(u): any cut separating u,v
        # can be replaced by a no-worse one that doesn't, except the
        # singleton {u} — recorded first). PR2 collapses path interiors
        # in one sweep regardless of lambda-hat.
        for i in range(1, len(order)):
            if rvals[i] >= lam - 1e-12:
                a, b = find(order[i - 1]), find(order[i])
                if a != b:
                    parent[a] = b
        a, b = find(order[-2]), find(order[-1])
        if a != b:
            parent[a] = b
        for i in range(m):
            if not alive[i]:
                continue
            du, wmax, vmax = 0.0, -1.0, -1
            for j, ww in g[i].items():
                if not alive[j]:
                    continue
                du += ww
                if ww > wmax:
                    wmax, vmax = ww, j
                if ww >= lam - 1e-12:
                    ra, rb = find(i), find(j)
                    if ra != rb:
                        parent[ra] = rb
            if vmax >= 0 and 2.0 * wmax >= du - 1e-12:
                consider(du, merged[i])
                ra, rb = find(i), find(vmax)
                if ra != rb:
                    parent[ra] = rb
        # full O(E) rebuild onto group roots (g stores both directions,
        # so iterating every alive node's map reproduces both)
        groups: dict[int, list[int]] = {}
        for i in range(m):
            if alive[i]:
                groups.setdefault(find(i), []).append(i)
        new_g: dict[int, dict[int, float]] = {r: {} for r in groups}
        for i in range(m):
            if not alive[i]:
                continue
            ri = find(i)
            tgt = new_g[ri]
            for j, ww in g[i].items():
                rj = find(j)
                if rj != ri:
                    tgt[rj] = tgt.get(rj, 0.0) + ww
        for root, members in groups.items():
            if len(members) > 1:
                mg: list[int] = []
                for x in members:
                    mg.extend(merged[x])
                    if x != root:
                        alive[x] = False
                        alive_cnt -= 1
                        merged[x] = []
                merged[root] = mg
                consider(sum(new_g[root].values()), mg)
        for i in range(m):
            g[i] = new_g[i] if alive[i] else {}

    cands.sort(key=lambda c: c[0])
    return float(best), set(best_side), cands[:32]


class GlobalDynamicMinCut:
    """Exact global min-cut maintainer under insert/delete/reweight.

    pool_size: number of cut-of-the-phase candidates kept (values updated
    in O(1) per edge update) to certify no-change on inserts that cross
    the primary cut.
    """

    def __init__(self, num_nodes: int, pool_size: int = 8):
        self.n = num_nodes
        self.pool_size = pool_size
        self.weights: dict[tuple[int, int], float] = {}
        self.degree = np.zeros(num_nodes)
        self._value = 0.0
        self._side: np.ndarray = np.zeros(num_nodes, bool)
        # pool entries: [value, side_bool_array]; entry 0 is the primary
        self._pool: list[list] = []
        self._dirty = True          # needs initial/structural recompute
        self.recompute_count = 0
        self.flow_repair_count = 0
        self.o1_update_count = 0
        self.update_count = 0

    # -- helpers -------------------------------------------------------------

    @staticmethod
    def _key(u: int, v: int) -> tuple[int, int]:
        return (u, v) if u < v else (v, u)

    def _active(self) -> np.ndarray:
        return np.nonzero(self.degree > 1e-12)[0]

    def _components(self, active: np.ndarray) -> list[np.ndarray]:
        lbl = {int(a): -1 for a in active}
        adj: dict[int, list[int]] = {int(a): [] for a in active}
        for (u, v) in self.weights:
            adj[u].append(v)
            adj[v].append(u)
        comps = []
        for a in active:
            a = int(a)
            if lbl[a] >= 0:
                continue
            cid = len(comps)
            stack, comp = [a], []
            lbl[a] = cid
            while stack:
                x = stack.pop()
                comp.append(x)
                for y in adj[x]:
                    if lbl[y] < 0:
                        lbl[y] = cid
                        stack.append(y)
            comps.append(np.asarray(comp))
        return comps

    def _full_recompute(self):
        self.recompute_count += 1
        active = self._active()
        self._pool = []
        if len(active) < 2:
            self._value, self._side = 0.0, np.zeros(self.n, bool)
            self._dirty = False
            return
        comps = self._components(active)
        if len(comps) > 1:
            self._value = 0.0
            side = np.zeros(self.n, bool)
            side[comps[0]] = True
            self._side = side
            self._pool = [[0.0, side]]
            self._dirty = False
            return
        val, sset, phases = noi_mincut(self.weights,
                                       [int(a) for a in active])
        self._value = float(val)
        side = np.zeros(self.n, bool)
        side[list(sset)] = True
        self._side = side
        # pool: primary first, then best distinct phase cuts
        pool = [[self._value, side]]
        for pv, ps in sorted(phases, key=lambda p: p[0]):
            if len(pool) >= max(1, int(self._pool_size())):
                break
            s2 = np.zeros(self.n, bool)
            s2[list(ps)] = True
            if any(np.array_equal(s2, e[1]) for e in pool):
                continue
            pool.append([float(pv), s2])
        self._pool = pool
        self._dirty = False

    def _pool_size(self) -> int:
        return getattr(self, "pool_size", 8)

    def _st_cut(self, u: int, v: int) -> tuple[float, np.ndarray]:
        """Exact u-v min cut on the current graph (Dinic, undirected)."""
        from ruvector_tpu_torch.attention.mincut import _Dinic

        active = self._active()
        remap = {int(a): i for i, a in enumerate(active)}
        d = _Dinic(len(active))
        for (a, b), w in self.weights.items():
            d.add_edge(remap[a], remap[b], float(w))
            d.add_edge(remap[b], remap[a], float(w))
        flow = d.max_flow(remap[u], remap[v])
        reach = d.reachable(remap[u])
        side = np.zeros(self.n, bool)
        side[active[reach[:len(active)]]] = True
        return float(flow), side

    def _pool_update_edge(self, u: int, v: int, delta: float):
        for entry in self._pool:
            if entry[1][u] != entry[1][v]:
                entry[0] += delta

    # -- updates -------------------------------------------------------------

    def insert_edge(self, u: int, v: int, w: float):
        # guard at the ACTIVITY threshold (degree > 1e-12), not 0 — an
        # edge in (0, 1e-12] would be stored while leaving its endpoints
        # inactive, corrupting the maintained value (code-review r3)
        if u == v or w <= 1e-12:
            return
        k = self._key(u, v)
        self.weights[k] = self.weights.get(k, 0.0) + w
        was_active = (self.degree[u] > 1e-12, self.degree[v] > 1e-12)
        self.degree[u] += w
        self.degree[v] += w
        self.update_count += 1
        if self._dirty:
            return
        if not (was_active[0] and was_active[1]):
            self._attach_new_node(u, v, w, was_active)
            return
        self._increase_repair(u, v, w)

    def _attach_new_node(self, u, v, w, was_active):
        """O(pool) exact handling of a node joining the active set.

        A leaf x attached to u by weight w adds exactly one new cut
        family: {x alone} of value w; every other new-graph cut equals an
        old-graph cut with x placed on u's side (value unchanged). Hence
        lambda' = min(lambda_old, w)."""
        n_active = int((self.degree > 1e-12).sum())
        if not was_active[0] and not was_active[1]:
            # fresh isolated pair {u, v}
            if n_active == 2:
                side = np.zeros(self.n, bool)
                side[u] = True
                self._value, self._side = w, side
                self._pool = [[w, side]]
            else:
                # new component next to an existing active graph; seat
                # the pair together in every stored cut first (their old
                # bits may be stale from a previous activation — split
                # bits would silently count the new internal edge)
                for entry in self._pool:
                    if entry[1][u] or entry[1][v]:
                        entry[1] = entry[1].copy()
                        entry[1][u] = entry[1][v] = False
                side = np.zeros(self.n, bool)
                side[u] = side[v] = True
                self._value, self._side = 0.0, side
                self._pool.insert(0, [0.0, side])
                del self._pool[self._pool_size():]
            self.o1_update_count += 1
            return
        x, anchor = (u, v) if not was_active[0] else (v, u)
        if n_active == 2:
            side = np.zeros(self.n, bool)
            side[x] = True
            self._value, self._side = w, side
            self._pool = [[w, side]]
            self.o1_update_count += 1
            return
        # seat x on the anchor's side in every stored cut (value
        # unchanged: the new edge then never crosses them); x's old bits
        # may be stale from a previous activation
        for entry in self._pool:
            if entry[1][x] != entry[1][anchor]:
                entry[1] = entry[1].copy()
                entry[1][x] = entry[1][anchor]
        if self._side[x] != self._side[anchor]:
            self._side = self._side.copy()
            self._side[x] = self._side[anchor]
        lam_old = self._value
        if w < lam_old - 1e-12:
            side = np.zeros(self.n, bool)
            side[x] = True
            self._value, self._side = w, side
            self._pool.insert(0, [w, side])
            del self._pool[self._pool_size():]
        self.o1_update_count += 1

    def _increase_repair(self, u: int, v: int, delta: float):
        """Exact repair after the u-v connection strengthened by delta."""
        self._pool_update_edge(u, v, delta)
        if self._side[u] == self._side[v]:
            # primary cut unaffected: still optimal (increases never
            # decrease any cut value)
            self.o1_update_count += 1
            return
        # primary crossed (its pool value was bumped): a pool entry at
        # the old minimum that does NOT separate u,v certifies no change
        old_val = self._value
        if not self._pool:
            self._dirty = True
            return
        best = min(self._pool, key=lambda e: e[0])
        if best[0] <= old_val + 1e-12:
            self._value = best[0]
            self._side = best[1]
            self._pool.remove(best)
            self._pool.insert(0, best)
            self.o1_update_count += 1
            return
        self._dirty = True

    def delete_edge(self, u: int, v: int):
        k = self._key(u, v)
        w = self.weights.pop(k, None)
        if w is None:
            return
        self.degree[u] -= w
        self.degree[v] -= w
        self.update_count += 1
        self._decrease_repair(u, v, w)

    def reweight_edge(self, u: int, v: int, w: float):
        if w <= 1e-12:
            return self.delete_edge(u, v)
        k = self._key(u, v)
        old = self.weights.get(k)
        if old is None:
            return self.insert_edge(u, v, w)
        delta = w - old
        if abs(delta) < 1e-15:
            return
        self.weights[k] = w
        self.degree[u] += delta
        self.degree[v] += delta
        self.update_count += 1
        if self._dirty:
            return
        if delta > 0:
            self._increase_repair(u, v, delta)
        else:
            self._decrease_repair(u, v, -delta)

    def _decrease_repair(self, u: int, v: int, delta: float):
        """Exact repair after the u-v connection weakened by delta."""
        if self._dirty:
            return
        u_off = self.degree[u] <= 1e-12
        v_off = self.degree[v] <= 1e-12
        if u_off and v_off:
            self._dirty = True          # isolated pair vanished
            return
        if u_off or v_off:
            self._leaf_deactivate(*((u, v) if u_off else (v, u)), delta)
            return
        self._pool_update_edge(u, v, -delta)
        if self._side[u] != self._side[v]:
            # primary separates u,v: it shrank with the edge, and every
            # unchanged cut was already >= old value > new value — exact
            self._value -= delta
            self.o1_update_count += 1
            return
        # primary unaffected: only u-v-separating cuts shrank; the best
        # of those is the u-v min cut on the updated graph
        flow, side = self._st_cut(u, v)
        self._after_st_repair(flow, side)

    def _leaf_deactivate(self, x: int, anchor: int, delta: float):
        """Node x lost its last edge (to `anchor`, weight delta). Every
        cut of the shrunken active set is an old cut with x seated on
        anchor's side at unchanged value, so lambda' = min over old
        NON-(x,anchor)-separating cuts >= lambda_old. If the primary did
        not separate x from anchor it is still optimal (O(1)); the only
        separating primary a leaf admits is the singleton {x} (anything
        larger would contradict lambda_old's optimality), in which case a
        valid pool candidate at lambda_old certifies, else recompute."""
        self._pool_update_edge(x, anchor, -delta)
        active = self.degree > 1e-12
        if int(active.sum()) < 2:
            self._dirty = True
            return
        # drop pool entries that became trivial over the active set
        self._pool = [e for e in self._pool
                      if e[1][active].any() and not e[1][active].all()]
        if self._side[x] == self._side[anchor]:
            self.o1_update_count += 1
            return
        lam_old = self._value
        cands = [e for e in self._pool if e[1][x] == e[1][anchor]]
        if cands:
            best = min(cands, key=lambda e: e[0])
            if best[0] <= lam_old + 1e-12:
                self._value = best[0]
                self._side = best[1]
                self._pool.remove(best)
                self._pool.insert(0, best)
                self.o1_update_count += 1
                return
        self._dirty = True

    def _after_st_repair(self, flow: float, side: np.ndarray):
        self.flow_repair_count += 1
        if flow < self._value - 1e-12:
            if not side.any() or side.all():
                self._dirty = True       # disconnection edge case
                return
            self._value = float(flow)
            self._side = side
            self._pool.insert(0, [self._value, side])
            del self._pool[self._pool_size():]

    # -- queries -------------------------------------------------------------

    def cut_value(self) -> float:
        if self._dirty:
            self._full_recompute()
        return self._value

    def partition(self) -> np.ndarray:
        if self._dirty:
            self._full_recompute()
        return self._side.copy()

    def cut_edges(self) -> list[tuple[int, int]]:
        if self._dirty:
            self._full_recompute()
        s = self._side
        return sorted((u, v) for (u, v) in self.weights if s[u] != s[v])

    def stats(self) -> dict:
        return {
            "updates": self.update_count,
            "o1_updates": self.o1_update_count,
            "flow_repairs": self.flow_repair_count,
            "full_recomputes": self.recompute_count,
        }
