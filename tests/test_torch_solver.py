"""Parity of the port's solvers (`ruvector_tpu_torch.solver`) against the
JAX package's on the CPU: the cases of tests/test_solver_quant.py
(:55-118, :217-333) on the same numpy systems, each held to that test's
own tolerance against its exact answer, and the port's result held to the
JAX function's at the same tolerance. Iteration counts may differ by one
where a norm lands at the tolerance (float32 sums in another order). The
random-walk estimator and the TRUE sketch draw their own random numbers
in each package: the walks are held statistically to the power
iteration, and the sketch of the exact case is JAX's, passed in.
"""

import jax
import numpy as np
import pytest
import torch

from ruvector_tpu import solver as js
from ruvector_tpu.graph.csr import CSRGraph as JCSRGraph
from ruvector_tpu_torch import solver as ts
from ruvector_tpu_torch.graph.csr import CSRGraph as TCSRGraph


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for this module's small tensors: beside the
    other workers of a parallel test run, many-threaded torch ops
    oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _both(src, dst, vals, n):
    return (JCSRGraph.from_edges(src, dst, vals, n),
            TCSRGraph.from_edges(src, dst, vals, n, device="cpu"))


def dd_matrix(n=16, seed=0):
    """Random diagonally-dominant SPD matrix (test_solver_quant.py:40)."""
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(n, n)).astype(np.float32) * 0.1
    a = (a + a.T) / 2
    np.fill_diagonal(a, np.abs(a).sum(1) + 1.0)
    src, dst = np.nonzero(a)
    return (src, dst, a[src, dst], n), a


def ring_graph(n=20):
    src = np.repeat(np.arange(n), 2)
    dst = np.stack([(np.arange(n) + 1) % n, (np.arange(n) - 1) % n], 1).reshape(-1)
    return src, dst, None, n


def grid_laplacian(side: int):
    """2-D grid Laplacian + I as COO (test_solver_quant.py:219)."""
    rows, cols, vals = [], [], []
    for i in range(side):
        for j in range(side):
            u = i * side + j
            deg = 0
            for di, dj in ((1, 0), (-1, 0), (0, 1), (0, -1)):
                ii, jj = i + di, j + dj
                if 0 <= ii < side and 0 <= jj < side:
                    rows.append(u)
                    cols.append(ii * side + jj)
                    vals.append(-1.0)
                    deg += 1
            rows.append(u)
            cols.append(u)
            vals.append(deg + 1.0)
    return np.asarray(rows), np.asarray(cols), np.asarray(vals, np.float64), side * side


def _x(r):
    return r.x.numpy() if isinstance(r.x, torch.Tensor) else np.asarray(r.x)


def _same_run(got, want):
    """Iterations within one (a norm at the tolerance), the same verdict."""
    assert abs(got.iterations - int(want.iterations)) <= 1
    assert got.converged == bool(want.converged)


# --- iterative solvers ------------------------------------------------------------

def test_neumann_solves_dd_system():
    (src, dst, vals, n), a = dd_matrix()
    scale = 1.0 / np.abs(a).sum(1).max()
    jm, tm = _both(src, dst, vals * scale, n)
    b = np.ones(16, np.float32) * scale
    got = ts.neumann_solve(tm, b, tolerance=1e-6, max_iterations=1000)
    want = js.neumann_solve(jm, b, tolerance=1e-6, max_iterations=1000)
    expect = np.linalg.solve(a, np.ones(16, np.float32))
    # the JAX test's tolerance: 1e-3 against the exact solution
    np.testing.assert_allclose(_x(got), expect, atol=1e-3)
    np.testing.assert_allclose(_x(got), _x(want), atol=1e-3)
    assert got.converged
    _same_run(got, want)


@pytest.mark.parametrize("precondition", [False, True])
def test_cg_solves_spd_system(precondition):
    (src, dst, vals, n), a = dd_matrix(seed=1)
    jm, tm = _both(src, dst, vals, n)
    b = np.random.default_rng(2).normal(size=16).astype(np.float32)
    got = ts.cg_solve(tm, b, tolerance=1e-6, max_iterations=200,
                      use_preconditioner=precondition)
    want = js.cg_solve(jm, b, tolerance=1e-6, max_iterations=200,
                       use_preconditioner=precondition)
    expect = np.linalg.solve(a, b)
    np.testing.assert_allclose(_x(got), expect, atol=1e-3)
    np.testing.assert_allclose(_x(got), _x(want), atol=1e-3)
    if not precondition:
        assert got.converged
    _same_run(got, want)


def test_jacobi_solves_dd_system():
    (src, dst, vals, n), a = dd_matrix(seed=3)
    jm, tm = _both(src, dst, vals, n)
    b = np.ones(16, np.float32)
    got = ts.jacobi_solve(tm, b, tolerance=1e-6, max_iterations=2000)
    want = js.jacobi_solve(jm, b, tolerance=1e-6, max_iterations=2000)
    np.testing.assert_allclose(_x(got), np.linalg.solve(a, b), atol=1e-3)
    np.testing.assert_allclose(_x(got), _x(want), atol=1e-3)
    _same_run(got, want)


def test_spectral_radius_matches_jax():
    """rho(I - A) by 20 power iterations from the same start: float32
    norms within 1e-5 relative."""
    (src, dst, vals, n), a = dd_matrix(seed=5)
    jm, tm = _both(src, dst, vals / np.abs(a).sum(1).max(), n)
    got, want = ts.estimate_spectral_radius(tm), js.estimate_spectral_radius(jm)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert 0.0 < got < 1.0


# --- PageRank ----------------------------------------------------------------------

def test_forward_push_matches_power_iteration():
    jg, tg = _both(*ring_graph())
    push = ts.forward_push_ppr(tg, source=0, alpha=0.2, epsilon=1e-7, max_sweeps=300).numpy()
    power = ts.ppr_power_iteration(tg, source=0, alpha=0.2, iters=300).numpy()
    np.testing.assert_allclose(push, power, atol=1e-4)
    np.testing.assert_allclose(push.sum(), 1.0, atol=1e-3)
    np.testing.assert_allclose(push, js.forward_push_ppr(jg, 0, alpha=0.2, epsilon=1e-7,
                                                         max_sweeps=300), atol=1e-4)
    np.testing.assert_allclose(power, js.ppr_power_iteration(jg, 0, alpha=0.2, iters=300),
                               atol=1e-4)


def test_backward_push_symmetric_graph():
    jg, tg = _both(*ring_graph())
    fwd = ts.forward_push_ppr(tg, 0, alpha=0.2, epsilon=1e-7, max_sweeps=300).numpy()
    bwd = ts.backward_push_ppr(tg, 0, alpha=0.2, epsilon=1e-7, max_sweeps=300).numpy()
    # undirected regular ring: forward == backward
    np.testing.assert_allclose(fwd, bwd, atol=1e-4)
    np.testing.assert_allclose(bwd, js.backward_push_ppr(jg, 0, alpha=0.2, epsilon=1e-7,
                                                         max_sweeps=300), atol=1e-4)


def test_push_on_a_directed_graph_matches_jax():
    """Forward and backward push where they differ (a random directed
    graph with a dead end): 1e-4 against the JAX functions."""
    rng = np.random.default_rng(7)
    n = 30
    src = rng.integers(0, n - 1, 90)
    dst = rng.integers(0, n, 90)
    w = rng.uniform(0.5, 1.0, 90).astype(np.float32)
    jg, tg = _both(src, dst, w, n)
    for fn in ("forward_push_ppr", "backward_push_ppr"):
        got = getattr(ts, fn)(tg, 3, alpha=0.15, epsilon=1e-6, max_sweeps=200).numpy()
        np.testing.assert_allclose(got, getattr(js, fn)(jg, 3, alpha=0.15, epsilon=1e-6,
                                                        max_sweeps=200), atol=1e-4)


def test_random_walk_ppr_approximates():
    """The JAX test's statistical check (0.03 against the power iteration,
    the port's and JAX's), and the same walks from the same seed. The
    walks draw the port's own uniforms, not jax.random's."""
    jg, tg = _both(*ring_graph(10))
    mc = ts.random_walk_ppr(tg, 0, alpha=0.2, num_walks=20000, max_len=100, seed=0).numpy()
    exact = ts.ppr_power_iteration(tg, 0, alpha=0.2, iters=200).numpy()
    np.testing.assert_allclose(mc, exact, atol=0.03)
    np.testing.assert_allclose(mc, js.ppr_power_iteration(jg, 0, alpha=0.2, iters=200),
                               atol=0.03)
    np.testing.assert_allclose(mc.sum(), 1.0, atol=1e-6)
    mc2 = ts.random_walk_ppr(tg, 0, alpha=0.2, num_walks=20000, max_len=100, seed=0).numpy()
    np.testing.assert_array_equal(mc, mc2)


# --- BMSSP (AMG), TRUE solver, router ---------------------------------------------

def test_bmssp_amg_solves_grid_laplacian():
    rows, cols, vals, n = grid_laplacian(20)    # 400 unknowns, 2 AMG levels
    x_true = np.random.default_rng(0).normal(size=n)
    dense = np.zeros((n, n))
    dense[rows, cols] = vals
    b = dense @ x_true
    solver = ts.BmsspSolver(tolerance=1e-6, max_cycles=100, device="cpu").setup(
        rows, cols, vals, n)
    jsolver = js.BmsspSolver(tolerance=1e-6, max_cycles=100).setup(rows, cols, vals, n)
    # the host setup is the JAX package's, step for step
    assert [lv.n for lv in solver._levels] == [lv.n for lv in jsolver._levels]
    assert len(solver._levels) >= 2
    for lv, jlv in zip(solver._levels, jsolver._levels):
        np.testing.assert_array_equal(lv.row, jlv.row)
        np.testing.assert_array_equal(lv.val, jlv.val)
        if lv.agg is not None:
            np.testing.assert_array_equal(lv.agg, jlv.agg)
    x, rnorm, cycles = solver.solve(b)
    jx, jrnorm, jcycles = jsolver.solve(b)
    assert rnorm / np.linalg.norm(b) < 1e-4
    np.testing.assert_allclose(x.numpy(), x_true, atol=5e-3)
    np.testing.assert_allclose(x.numpy(), jx, atol=5e-3)
    assert cycles < 100 and abs(cycles - jcycles) <= 1


def test_true_solver_exact_at_full_sketch():
    """k = n: the sketched solve is exact. Both packages take JAX's
    sketch; 1e-2 against x_true (the JAX test's) and against JAX's x."""
    rng = np.random.default_rng(1)
    n = 40
    a = np.eye(n) * 4.0
    for i in range(n - 1):
        a[i, i + 1] = a[i + 1, i] = -1.0
    r, c = np.nonzero(a)
    jm, tm = _both(r, c, a[r, c], n)
    x_true = rng.normal(size=n)
    b = a @ x_true
    jsolver = js.TrueSolver(tolerance=0.5, jl_dimension=n, ridge=0.0)
    jx = jsolver.solve(jm, b)
    sketch = np.array(jsolver._prep[0])
    x = ts.TrueSolver(tolerance=0.5, jl_dimension=n, ridge=0.0).preprocess(
        tm, sketch=sketch).solve(tm, b).numpy()
    np.testing.assert_allclose(x, x_true, atol=1e-2)
    np.testing.assert_allclose(x, jx, atol=1e-2)


def test_true_solver_sketch_reduces_dimension():
    n = 500
    r = np.arange(n)
    jm, tm = _both(r, r, np.full(n, 2.0), n)
    s = ts.TrueSolver(tolerance=0.3)
    s.preprocess(tm)
    k = s._prep[0].shape[0]
    jsolver = js.TrueSolver(tolerance=0.3)
    jsolver.preprocess(jm)
    assert k == jsolver._prep[0].shape[0] and 8 <= k < n
    signs = s._prep[0].numpy() * np.sqrt(k)
    np.testing.assert_allclose(np.abs(signs), 1.0, rtol=1e-6)   # Rademacher / sqrt(k)
    x = s.solve(tm, np.ones(n))
    assert x.shape == (n,) and np.all(np.isfinite(x.numpy()))


_PROFILES = {
    "dd_sparse": dict(rows=1000, nnz=3000, density=0.003, is_diag_dominant=True,
                      estimated_spectral_radius=0.5, estimated_condition=10.0),
    "well_cond": dict(rows=1000, nnz=3000, density=0.003, is_diag_dominant=False,
                      estimated_spectral_radius=1.5, estimated_condition=50.0),
    "ill": dict(rows=2000, nnz=3000, density=0.003, is_diag_dominant=False,
                estimated_spectral_radius=1.5, estimated_condition=1e4),
}


@pytest.mark.parametrize("profile", sorted(_PROFILES))
@pytest.mark.parametrize("query,batch", [("linear_system", 1), ("pagerank_single", 1),
                                         ("pagerank_pairwise", 1), ("spectral_filter", 1),
                                         ("batch_linear_system", 200),
                                         ("batch_linear_system", 10)])
def test_router_rule_order(profile, query, batch):
    """The rule order of test_solver_quant.py:286 on every profile and
    query: the same algorithm as the JAX router."""
    got = ts.SolverRouter(ts.RouterConfig()).select_algorithm(
        ts.SparsityProfile(**_PROFILES[profile]), query, batch_size=batch)
    want = js.SolverRouter(js.RouterConfig()).select_algorithm(
        js.SparsityProfile(**_PROFILES[profile]), query, batch_size=batch)
    assert got == want


def test_router_anchor_cases():
    router = ts.SolverRouter(ts.RouterConfig())
    dd, ill = (ts.SparsityProfile(**_PROFILES[k]) for k in ("dd_sparse", "ill"))
    assert router.select_algorithm(dd) == "neumann"
    assert router.select_algorithm(ts.SparsityProfile(**_PROFILES["well_cond"])) == "cg"
    assert router.select_algorithm(ill) == "bmssp"
    assert router.select_algorithm(ill, "pagerank_single") == "forward_push"
    assert router.select_algorithm(ill, "pagerank_pairwise") == "hybrid_random_walk"
    assert router.select_algorithm(dd, "batch_linear_system", batch_size=200) == "true"
    assert router.select_algorithm(dd, "batch_linear_system", batch_size=10) == "cg"


def test_analyze_sparsity_matches_jax():
    rows, cols, vals, n = grid_laplacian(10)
    jm, tm = _both(rows, cols, vals, n)
    got, want = ts.analyze_sparsity(tm), js.analyze_sparsity(jm)
    assert (got.rows, got.nnz, got.is_diag_dominant) == \
        (want.rows, want.nnz, want.is_diag_dominant)
    np.testing.assert_allclose([got.density, got.estimated_condition],
                               [want.density, want.estimated_condition], rtol=1e-12)
    np.testing.assert_allclose(got.estimated_spectral_radius, want.estimated_spectral_radius,
                               rtol=1e-5)


def test_orchestrator_end_to_end():
    rows, cols, vals, n = grid_laplacian(10)
    jm, tm = _both(rows, cols, vals, n)
    x_true = np.random.default_rng(2).normal(size=n)
    dense = np.zeros((n, n))
    dense[rows, cols] = vals
    result, algo = ts.SolverOrchestrator().solve(tm, dense @ x_true)
    jresult, jalgo = js.SolverOrchestrator().solve(jm, dense @ x_true)
    assert result.converged and algo == jalgo
    np.testing.assert_allclose(_x(result), x_true, atol=1e-2)
    np.testing.assert_allclose(_x(result), _x(jresult), atol=1e-2)


@pytest.mark.parametrize("algo", ["neumann", "cg", "bmssp", "true"])
def test_orchestrator_dispatch_reaches_each_solver(algo):
    """Each algorithm the router names runs the port's solver. Neumann on
    the grid scaled to rho(I - A) < 1; the others on the grid itself
    (TRUE at k = n = 100). 1e-2 against x_true where the solver
    converges, and the JAX dispatch's verdict."""
    rows, cols, vals, n = grid_laplacian(10)
    if algo == "neumann":
        vals = vals / 10.0
    jm, tm = _both(rows, cols, vals, n)
    x_true = np.random.default_rng(3).normal(size=n)
    dense = np.zeros((n, n))
    dense[rows, cols] = vals
    b = dense @ x_true
    got = ts.SolverOrchestrator()._dispatch(algo, tm, b, 1e-5)
    want = js.SolverOrchestrator()._dispatch(algo, jm, b, 1e-5)
    assert got.converged == bool(want.converged)
    assert got.x.shape == (n,) and np.all(np.isfinite(_x(got)))
    if algo != "true":
        np.testing.assert_allclose(_x(got), x_true, atol=1e-2)
        np.testing.assert_allclose(_x(got), _x(want), atol=1e-2)
    with pytest.raises(ValueError):
        ts.SolverOrchestrator()._dispatch("nope", tm, b, 1e-5)
