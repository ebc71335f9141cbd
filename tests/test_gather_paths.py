"""Gather-based paths vs NumPy: the distributed exchange's static gather
indices, the SpGEMM numeric phase, and the id-keyed host caches."""

import numpy as np
import pytest
import jax.numpy as jnp

from essentials_tpu.formats import Csr
from essentials_tpu.io import generate


@pytest.mark.parametrize("n_seg,n_edges,seed", [(7, 64, 0), (300, 4096, 1)])
def test_spread_local_matches_numpy(n_seg, n_edges, seed):
    """Expand per-source values over padded source segments, then gather
    into another edge order by a static index: == np.repeat + take."""
    from essentials_tpu.parallel.distributed import _spread_local
    rng = np.random.default_rng(seed)
    deg = rng.multinomial(n_edges - 5, np.ones(n_seg) / n_seg)
    off = np.zeros(n_seg + 2, np.int32)
    np.cumsum(deg, out=off[1:n_seg + 1])
    off[n_seg + 1] = n_edges                 # pad segment takes the tail
    x = rng.random(n_seg + 1).astype(np.float32)
    perm = rng.permutation(n_edges).astype(np.int32)
    got = _spread_local(jnp.asarray(x), jnp.asarray(off), jnp.asarray(perm),
                        n_edges)
    want = np.repeat(x, np.diff(off))[perm]
    np.testing.assert_array_equal(np.asarray(got), want)


def test_partition_gather_index_sorts_by_destination():
    from essentials_tpu.parallel.partition import partition_graph
    csr = Csr.from_coo(generate.uniform_random(90, 4, seed=2,
                                               undirected=False))
    dg = partition_graph(csr, 4, exchange="all_gather")
    route = np.asarray(dg.route)
    doff = np.asarray(dg.dst_offsets)
    soff = np.asarray(dg.src_offsets)
    for p in range(4):
        es = dg.edges_per_device
        assert np.array_equal(np.sort(route[p]), np.arange(es))
        # local dst of every src-ordered edge, then gathered: ascending
        k = int(doff[p, dg.block_size])
        src_of = np.repeat(np.arange(soff.shape[1] - 1), np.diff(soff[p]))
        dst_sorted = np.repeat(np.arange(dg.block_size + 1),
                               np.diff(doff[p])[:dg.block_size + 1])
        assert dst_sorted.shape[0] == es
        assert np.all(np.diff(dst_sorted[:k]) >= 0)
        assert src_of.shape[0] == es


@pytest.mark.parametrize("n,k,seed", [(5, 2, 0), (60, 4, 1), (200, 6, 2)])
def test_spgemm_numeric_matches_numpy(n, k, seed):
    from essentials_tpu.algorithms import spgemm
    a = Csr.from_coo(generate.uniform_random(n, k, seed=seed,
                                             undirected=False))
    b = Csr.from_coo(generate.uniform_random(n, k, seed=seed + 9,
                                             undirected=False))
    plan = spgemm.make_plan(a, b)
    assert plan.W % 1024 == 0 and plan.W >= plan.n_products
    c_pos = np.asarray(plan.c_pos)
    assert np.all(np.diff(c_pos) >= 0)                   # sorted segments
    assert np.all(c_pos[plan.n_products:] == plan.c_nnz)  # pads dropped
    assert np.all(np.asarray(plan.a_eid)[plan.n_products:] == a.nnz)
    vals = np.asarray(spgemm.numeric(plan, jnp.asarray(a.values),
                                     jnp.asarray(b.values)))

    def dense(m):
        d = np.zeros((m.n_rows, m.n_cols))
        np.add.at(d, (np.repeat(np.arange(m.n_rows), np.diff(m.row_offsets)),
                      m.col_indices), m.values)
        return d
    want = dense(a) @ dense(b)
    rows = np.repeat(np.arange(n), np.diff(np.asarray(plan.c_row_offsets)))
    np.testing.assert_allclose(vals, want[rows, np.asarray(
        plan.c_col_indices)], rtol=1e-5)
    assert plan.c_nnz == int(np.count_nonzero(want))


def _two_graphs():
    g1 = Csr.from_coo(generate.uniform_random(50, 4, seed=3, weighted=False))
    g2 = Csr.from_coo(generate.uniform_random(50, 4, seed=4, weighted=False))
    return g1, g2


def test_intersect_cache_survives_id_reuse():
    """A cache entry whose key collides with a new graph's id() (the id
    of a freed graph, reused) must not serve the old graph's bitmap."""
    from essentials_tpu.ops import intersect
    g1, g2 = _two_graphs()
    stale = intersect._rows_bitmap(g1)
    intersect._bitmap_cache.clear()
    intersect._bitmap_cache[id(g2)] = (g1, stale)       # simulated reuse
    u, v = np.arange(20), np.arange(20, 40)
    got = intersect.intersection_counts(g2, u, v)
    off, cols = g2.row_offsets, g2.col_indices
    adj = [set(cols[off[i]:off[i + 1]].tolist()) for i in range(50)]
    assert np.array_equal(got, [len(adj[a] & adj[b]) for a, b in zip(u, v)])


def test_tc_shift_cache_survives_id_reuse():
    from essentials_tpu.algorithms import tc
    g1, g2 = _two_graphs()
    stale = tc._shift_prep(g1)
    tc._shift_cache.clear()
    tc._shift_cache[id(g2)] = (g1, stale)                # simulated reuse
    assert tc.run(g2, warmup=False, variant="shift").total == \
        tc.cpu_reference(g2)[0]
