"""The port's scatter-gather search (serve/distributed.py) against the
JAX package's, on the CPU: tests/test_serve_extra.py's case through JAX's
shard_map on a 4-device mesh and through the port at world 4 under gloo,
one group of spawned ranks for every case. A corpus with duplicated rows
holds the top-k tie rule: ids differ only between equal scores.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_ranks as ranks
from ruvector_tpu.ops.distance import pairwise_cosine as jcosine
from ruvector_tpu.parallel import make_mesh as jmesh
from ruvector_tpu.serve.distributed import make_distributed_search as jsearch
from ruvector_tpu_torch.parallel import run_ranks
from ruvector_tpu_torch.serve.distributed import make_distributed_search

WORLD = 4


def _case(seed, n=256, d=16, k=5, b=4, duplicate=False):
    rng = np.random.default_rng(seed)
    feats = rng.normal(size=(n, d)).astype(np.float32)
    if duplicate:
        # every row of block 0 again in block 2: each hit has a tie
        feats[2 * n // WORLD: 3 * n // WORLD] = feats[: n // WORLD]
    queries = rng.normal(size=(b, d)).astype(np.float32)
    return dict(fn="search_case", n=n, k=k, feats=feats, queries=queries)


CASES = {"random": _case(0), "ties": _case(1, duplicate=True), "wide": _case(2, n=1024, k=10,
                                                                               b=16)}


@pytest.fixture(scope="module")
def results():
    return run_ranks(ranks.all_cases, WORLD, {k: dict(v) for k, v in CASES.items()},
                     device="cpu", threads=1)


def _sims(c):
    return np.asarray(jcosine(jnp.asarray(c["queries"]), jnp.asarray(c["feats"])))


@pytest.mark.parametrize("name", ["random", "wide"])
def test_distributed_search_matches_single_device(results, name):
    """test_serve_extra.py:23, and the JAX package's search on the same
    inputs: the same ids, scores within 1e-5."""
    c = CASES[name]
    sims = _sims(c)
    jids, jscores = jsearch(jmesh(WORLD), c["n"], c["k"])(jnp.asarray(c["queries"]),
                                                          jnp.asarray(c["feats"]))
    expect = np.argsort(-sims, axis=1)[:, : c["k"]]
    for r in results:
        ids, scores = (t.numpy() for t in r[name])
        assert ids.dtype == np.int32
        np.testing.assert_array_equal(ids, np.asarray(jids))
        for i in range(len(ids)):
            assert set(ids[i].tolist()) == set(expect[i].tolist())
            np.testing.assert_allclose(scores[i], np.sort(sims[i])[::-1][: c["k"]], rtol=1e-5)
        np.testing.assert_allclose(scores, np.asarray(jscores), rtol=1e-5)


def test_distributed_search_ties(results):
    """Duplicated rows tie: an id may differ from JAX's only where its
    score equals the other's (the top-k tie rule)."""
    c = CASES["ties"]
    sims = _sims(c)
    jids, jscores = jsearch(jmesh(WORLD), c["n"], c["k"])(jnp.asarray(c["queries"]),
                                                          jnp.asarray(c["feats"]))
    jids = np.asarray(jids)
    # the case holds ties: some list has a score twice
    assert any(len(set(row.tolist())) < c["k"] for row in np.asarray(jscores))
    for r in results:
        ids, scores = (t.numpy() for t in r["ties"])
        np.testing.assert_allclose(scores, np.asarray(jscores), rtol=1e-5)
        for i in range(len(ids)):
            for a, b in zip(ids[i], jids[i]):
                assert a == b or abs(sims[i, a] - sims[i, b]) <= 1e-6, (i, a, b)


def test_search_in_one_process_equals_the_ranks(results):
    """World 1 without a group: the same search over the whole corpus."""
    from ruvector_tpu_torch.parallel.mesh import Mesh

    c = CASES["wide"]
    mesh = Mesh(group=None, rank=0, size=1, axis_name="nodes", device=torch.device("cpu"))
    search = make_distributed_search(mesh, c["n"], c["k"])
    sims = torch.topk(torch.from_numpy(_sims(c)), c["k"], dim=1)
    ids, _ = search(torch.from_numpy(c["queries"]), torch.from_numpy(c["feats"]))
    np.testing.assert_array_equal(ids.numpy(), sims.indices.numpy())
    np.testing.assert_array_equal(ids.numpy(), results[0]["wide"][0].numpy())
