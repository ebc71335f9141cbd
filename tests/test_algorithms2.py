"""MST, geolocation, SpGEMM, helper-primitive tests."""

import numpy as np
import jax.numpy as jnp
import pytest

from essentials_tpu.algorithms import mst, geo, spgemm, helpers
from essentials_tpu.formats import Csr, Coo
from essentials_tpu.graph import build_graph
from essentials_tpu.io import generate
from essentials_tpu.io.sample import sample_csr


def _undirected(edges, n, weights):
    src = np.array([e[0] for e in edges] + [e[1] for e in edges])
    dst = np.array([e[1] for e in edges] + [e[0] for e in edges])
    w = np.array(list(weights) + list(weights), np.float32)
    return Csr.from_coo(Coo(n, n, src, dst, w))


def test_mst_known():
    # square with diagonal: MST = 3 cheapest non-cycle edges
    edges = [(0, 1), (1, 2), (2, 3), (3, 0), (0, 2)]
    weights = [1.0, 2.0, 3.0, 4.0, 5.0]
    csr = _undirected(edges, 4, weights)
    g = build_graph(csr, directed=False, weighted=True)
    res = mst.run(g, warmup=False)
    assert res.total_weight == 1.0 + 2.0 + 3.0
    assert res.total_weight == pytest.approx(mst.cpu_reference(csr))


def test_mst_random():
    coo = generate.uniform_random(120, 4, seed=9, undirected=True, weighted=True)
    csr = Csr.from_coo(coo)
    g = build_graph(csr, directed=False, weighted=True)
    res = mst.run(g, warmup=False)
    assert res.total_weight == pytest.approx(mst.cpu_reference(csr), rel=1e-5)


def test_mst_equal_weights():
    # all weights equal: any spanning tree has weight n-1; determinism check
    edges = [(i, j) for i in range(6) for j in range(i + 1, 6)]
    csr = _undirected(edges, 6, [1.0] * len(edges))
    g = build_graph(csr, directed=False, weighted=True)
    r1 = mst.run(g, warmup=False)
    r2 = mst.run(g, warmup=False)
    assert r1.total_weight == 5.0
    np.testing.assert_array_equal(np.asarray(r1.in_mst), np.asarray(r2.in_mst))


def test_mst_disconnected():
    # two components -> spanning forest
    edges = [(0, 1), (2, 3)]
    csr = _undirected(edges, 4, [2.0, 7.0])
    g = build_graph(csr, directed=False, weighted=True)
    res = mst.run(g, warmup=False)
    assert res.total_weight == 9.0


def test_geo(chesapeake, chesapeake_csr):
    n = chesapeake.n_vertices
    rng = np.random.default_rng(0)
    lat = rng.uniform(-60, 60, n).astype(np.float32)
    lon = rng.uniform(-170, 170, n).astype(np.float32)
    unknown = rng.random(n) < 0.4
    lat[unknown] = np.nan
    lon[unknown] = np.nan
    res = geo.run(chesapeake, lat, lon, total_iterations=10, warmup=False)
    rl, rn = geo.cpu_reference(chesapeake_csr, lat, lon, total_iterations=10)
    got = np.asarray(res.lat)
    np.testing.assert_allclose(got, rl, atol=1e-3, equal_nan=True)
    np.testing.assert_allclose(np.asarray(res.lon), rn, atol=1e-3,
                               equal_nan=True)
    # previously-known positions unchanged
    np.testing.assert_allclose(got[~unknown], lat[~unknown], atol=1e-6)


def test_spgemm_identity():
    a = sample_csr()
    eye = Csr(4, 4, np.arange(5, dtype=np.int32),
              np.arange(4, dtype=np.int32), np.ones(4, np.float32))
    res = spgemm.run(a, eye, warmup=False)
    np.testing.assert_array_equal(res.c.row_offsets, [0, 0, 0, 2, 4])
    np.testing.assert_array_equal(res.c.col_indices, [1, 3, 2, 3])
    np.testing.assert_allclose(res.c.values, [8, 5, 3, 6])


def test_spgemm_vs_cpu():
    rng = np.random.default_rng(4)
    coo_a = generate.uniform_random(30, 3, seed=2, undirected=False)
    coo_b = generate.uniform_random(30, 3, seed=3, undirected=False)
    a, b = Csr.from_coo(coo_a), Csr.from_coo(coo_b)
    res = spgemm.run(a, b, warmup=False)
    ref = spgemm.cpu_reference(a, b)
    np.testing.assert_array_equal(res.c.row_offsets, ref.row_offsets)
    np.testing.assert_array_equal(res.c.col_indices, ref.col_indices)
    np.testing.assert_allclose(res.c.values, ref.values, rtol=1e-5)


def test_spgemm_dense_check():
    coo_a = generate.uniform_random(20, 4, seed=5, undirected=False)
    coo_b = generate.uniform_random(20, 4, seed=6, undirected=False)
    a, b = Csr.from_coo(coo_a), Csr.from_coo(coo_b)
    res = spgemm.run(a, b, warmup=False)

    def dense(csr, r, c):
        d = np.zeros((r, c))
        src = np.repeat(np.arange(r), np.diff(csr.row_offsets))
        d[src, np.asarray(csr.col_indices)] = np.asarray(csr.values)
        return d

    np.testing.assert_allclose(dense(res.c, 20, 20),
                               dense(a, 20, 20) @ dense(b, 20, 20), rtol=1e-4)


def test_helpers_search_sort():
    keys = jnp.asarray([1, 3, 3, 7, 9])
    assert int(helpers.lower_bound(keys, 3)) == 1
    assert int(helpers.upper_bound(keys, 3)) == 3
    assert int(helpers.rightmost(keys, 4)) == 2
    assert int(helpers.rightmost(keys, 0)) == -1
    sk = helpers.sort_keys(jnp.asarray([3, 1, 2]), descending=True)
    np.testing.assert_array_equal(np.asarray(sk), [3, 2, 1])
    k, v = helpers.sort_pairs(jnp.asarray([3, 1, 2]), jnp.asarray([30, 10, 20]))
    np.testing.assert_array_equal(np.asarray(v), [10, 20, 30])


def test_spgemm_plan_reuse_across_values():
    """The symbolic plan is value-independent: new values, same structure."""
    from essentials_tpu.io import generate
    rng = np.random.default_rng(7)
    coo_a = generate.uniform_random(40, 4, seed=9, undirected=False)
    coo_b = generate.uniform_random(40, 4, seed=10, undirected=False)
    a, b = Csr.from_coo(coo_a), Csr.from_coo(coo_b)
    plan = spgemm.make_plan(a, b)
    r1 = spgemm.run(a, b, warmup=False, plan=plan)
    a2 = Csr(a.n_rows, a.n_cols, a.row_offsets, a.col_indices,
             rng.random(a.nnz).astype(np.float32))
    b2 = Csr(b.n_rows, b.n_cols, b.row_offsets, b.col_indices,
             rng.random(b.nnz).astype(np.float32))
    r2 = spgemm.run(a2, b2, warmup=False, plan=plan)
    ref2 = spgemm.cpu_reference(a2, b2)
    np.testing.assert_array_equal(r2.c.row_offsets, ref2.row_offsets)
    np.testing.assert_array_equal(r2.c.col_indices, ref2.col_indices)
    np.testing.assert_allclose(r2.c.values, ref2.values, rtol=1e-4)
    assert not np.allclose(r1.c.values, r2.c.values)


def test_mst_grid_routed():
    """MST on a grid mesh (equal-weight ties along long paths)."""
    from essentials_tpu.io import generate
    from essentials_tpu.graph import build_graph
    coo = generate.grid_2d(40, weighted=True)
    csr = Csr.from_coo(coo)
    g = build_graph(csr, directed=False, weighted=True)
    res = mst.run(g, warmup=False)
    ref = mst.cpu_reference(csr)
    assert abs(res.total_weight - ref) < 1e-3 * max(abs(ref), 1.0)


def test_color_spec_valid():
    """Speculative recolor variant: zero conflicts, all colored."""
    import numpy as np
    from essentials_tpu.algorithms import color
    from essentials_tpu.formats import Csr
    from essentials_tpu.graph import build_graph
    from essentials_tpu.io import generate
    coo = generate.rmat(10, 8, seed=5, undirected=True, weighted=False)
    csr = Csr.from_coo(coo)
    g = build_graph(csr, directed=False, weighted=False)
    res = color.run(g, variant="spec", warmup=False)
    assert color.validate(csr, np.asarray(res.colors)) == 0
    n_colors = int(np.max(np.asarray(res.colors))) + 1
    assert n_colors >= 1


def test_problem_api_bfs_sssp():
    """The OO Problem wrapper runs BFS/SSSP to the same results as the
    functional API (reference problem_t/enactor_t shape)."""
    import numpy as np
    from essentials_tpu.framework.problem import BfsProblem, SsspProblem
    from essentials_tpu.algorithms import bfs, sssp
    from essentials_tpu.formats import Csr
    from essentials_tpu.graph import build_graph
    from essentials_tpu.io import generate
    coo = generate.rmat(8, 8, seed=2, undirected=True, weighted=True)
    csr = Csr.from_coo(coo)
    g = build_graph(csr, directed=False, weighted=True)
    res = BfsProblem(g, source=3).enact(warmup=False)
    ref = bfs.cpu_reference(csr, 3)
    assert np.array_equal(np.asarray(res.state.distances[:g.n_vertices]),
                          ref)
    res2 = SsspProblem(g, source=3).enact(warmup=False)
    got = np.asarray(res2.state.distances[:g.n_vertices])
    dref = sssp.cpu_reference(csr, 3)
    fin = np.isfinite(dref)
    assert np.array_equal(np.isfinite(got), fin)
    np.testing.assert_allclose(got[fin], dref[fin], rtol=1e-5, atol=1e-5)


def test_kcore_fused_matches_reference():
    """Peeling on power-law and grid graphs vs the host reference."""
    import numpy as np
    from essentials_tpu.algorithms import kcore
    from essentials_tpu.formats import Csr
    from essentials_tpu.graph import build_graph
    from essentials_tpu.io import generate
    for spec in [("rmat", 9, 8, 3), ("grid", 20, 0, 0)]:
        if spec[0] == "rmat":
            coo = generate.rmat(spec[1], spec[2], seed=spec[3],
                                undirected=True, weighted=False)
        else:
            coo = generate.grid_2d(spec[1], weighted=False)
        csr = Csr.from_coo(coo)
        g = build_graph(csr, directed=False, weighted=False)
        res = kcore.run(g, warmup=False)
        ref = kcore.cpu_reference(csr)
        assert np.array_equal(np.asarray(res.core), ref), spec


def test_kcore_adaptive_spray_matches_reference():
    """Adaptive kcore with the spray branch FORCED on small graphs
    (spray_override=True): exercises the tracked-candidate list (fvalid
    filter), the tiny tier, and multi-wave cascades at one k level —
    the code path large graphs take, validated vs host peeling.
    """
    import numpy as np
    from essentials_tpu.algorithms import kcore
    from essentials_tpu.formats import Csr
    from essentials_tpu.graph import build_graph
    from essentials_tpu.io import generate
    for spec in [("rmat", 9, 8, 3), ("grid", 20, 0, 0)]:
        if spec[0] == "rmat":
            coo = generate.rmat(spec[1], spec[2], seed=spec[3],
                                undirected=True, weighted=False)
        else:
            coo = generate.grid_2d(spec[1], weighted=False)
        csr = Csr.from_coo(coo)
        g = build_graph(csr, directed=False, weighted=False)
        res = kcore.run(g, warmup=False,
                        spray_override=True)
        ref = kcore.cpu_reference(csr)
        assert np.array_equal(np.asarray(res.core), ref), spec


def test_spgemm_chunked_vs_cpu():
    """Chunked numeric phase (device sorts, no per-product plans) with
    TINY chunks to force many chunk boundaries — including mid-row splits
    whose (row,col) duplicates the host merge map folds — vs both the
    host Gustavson reference and the static-plan path."""
    coo_a = generate.uniform_random(60, 5, seed=12, undirected=False)
    coo_b = generate.uniform_random(60, 4, seed=13, undirected=False)
    a, b = Csr.from_coo(coo_a), Csr.from_coo(coo_b)
    ref = spgemm.cpu_reference(a, b)
    for wc, ec in [(1 << 7, 1 << 5), (1 << 9, 1 << 12), (1 << 22, 1 << 22)]:
        res = spgemm.run_chunked(a, b, chunk_products=wc, chunk_edges=ec,
                                 warmup=False)
        np.testing.assert_array_equal(res.c.row_offsets, ref.row_offsets,
                                      err_msg=f"wc={wc}")
        np.testing.assert_array_equal(res.c.col_indices, ref.col_indices,
                                      err_msg=f"wc={wc}")
        np.testing.assert_allclose(res.c.values, ref.values, rtol=1e-4,
                                   atol=1e-5, err_msg=f"wc={wc}")


def test_spgemm_chunked_streamed_mode():
    """stream_to_host=True (the >int32-products capacity mode) must give
    the same merged C values as the resident-buffer mode."""
    coo_a = generate.uniform_random(80, 5, seed=22, undirected=False)
    a = Csr.from_coo(coo_a)
    plan = spgemm.make_chunked_plan(a, a, chunk_products=1 << 8,
                                    chunk_edges=1 << 6)
    ref = spgemm.cpu_reference(a, a)
    v_res = spgemm.numeric_chunked(plan, a, a, stream_to_host=False)
    v_str = spgemm.numeric_chunked(plan, a, a, stream_to_host=True)
    np.testing.assert_array_equal(v_res, v_str)
    np.testing.assert_array_equal(np.asarray(plan.c_col_indices),
                                  ref.col_indices)
    np.testing.assert_allclose(v_str, ref.values, rtol=1e-4, atol=1e-5)
