"""Shared cases for the algorithm x graph matrix (tests/test_matrix_*.py).

Each ``test_matrix_<graph>.py`` file runs every algorithm in CHECKS on one
graph and compares it with the algorithm's host reference. One file per
graph lets ``--dist loadfile`` spread the matrix over workers.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import jax.numpy as jnp

from essentials_tpu import algorithms as A
from essentials_tpu.formats import Coo, Csr
from essentials_tpu.graph import build_graph
from essentials_tpu.io import generate, load_graph_file
from essentials_tpu.utils import compare

DATASETS = os.path.join(os.path.dirname(__file__), "..", "datasets")


@dataclass
class Case:
    name: str
    csr: Csr
    directed: bool
    weighted: bool

    def __post_init__(self):
        self.g = build_graph(self.csr, directed=self.directed,
                             weighted=self.weighted)
        self.source = int(np.argmax(np.diff(self.csr.row_offsets)))

    def undirected(self) -> "Case":
        """The same graph with every edge also present reversed (for the
        algorithms defined on undirected graphs only)."""
        if not self.directed:
            return self
        coo = self.csr.to_coo()
        rows = np.concatenate([coo.row_indices, coo.col_indices])
        cols = np.concatenate([coo.col_indices, coo.row_indices])
        vals = np.concatenate([coo.values, coo.values])
        key = rows.astype(np.int64) * coo.n_rows + cols
        _, first = np.unique(key, return_index=True)
        sym = Csr.from_coo(Coo(coo.n_rows, coo.n_cols, rows[first],
                               cols[first], vals[first]))
        return Case(self.name + "-sym", sym, False, self.weighted)


def _mtx(name: str) -> Csr:
    return load_graph_file(os.path.join(DATASETS, name), cache=False)


def _irregular() -> Csr:
    """30 connected-ish vertices, 10 isolated ones, self-loops on three
    vertices and a duplicated copy of five undirected edges."""
    base = generate.uniform_random(30, 3, seed=13, undirected=True,
                                   weighted=True)
    r, c, w = base.row_indices, base.col_indices, base.values
    loops = np.array([2, 7, 11])
    dup = np.arange(0, 10, 2)
    rows = np.concatenate([r, loops, r[dup], c[dup]])
    cols = np.concatenate([c, loops, c[dup], r[dup]])
    vals = np.concatenate([w, np.full(3, 5.0, w.dtype), w[dup], w[dup]])
    return Csr.from_coo(Coo(40, 40, rows, cols, vals))


def _two_vertex() -> Csr:
    return Csr.from_coo(Coo(2, 2, np.array([0, 1]), np.array([1, 0]),
                            np.array([2.5, 2.5], np.float32)))


def load(name: str) -> Case:
    if name == "chesapeake":
        return Case(name, _mtx("chesapeake.mtx"), False, False)
    if name == "kron_s12":
        return Case(name, _mtx("kron_s12.mtx"), False, True)
    if name == "road_64x64":
        return Case(name, _mtx("road_64x64.mtx"), False, True)
    if name == "uniform_4096":
        return Case(name, _mtx("uniform_4096.mtx"), True, True)
    if name == "irregular":
        return Case(name, _irregular(), False, True)
    if name == "two_vertex":
        return Case(name, _two_vertex(), False, True)
    raise KeyError(name)


# ------------------------------------------------------------------ checks

def check_bfs(c: Case):
    r = A.bfs.run(c.g, c.source, warmup=False)
    ref = A.bfs.cpu_reference(c.csr, c.source)
    assert np.array_equal(np.asarray(r.distances), ref)
    pred = np.asarray(r.predecessors)
    dist = np.asarray(r.distances)
    off, cols = np.asarray(c.csr.row_offsets), np.asarray(c.csr.col_indices)
    for v in np.nonzero(pred >= 0)[0][:200]:
        u = pred[v]
        assert dist[u] + 1 == dist[v]
        assert v in cols[off[u]:off[u + 1]]


def check_sssp(c: Case):
    r = A.sssp.run(c.g, c.source, warmup=False)
    ref = A.sssp.cpu_reference(c.csr, c.source)
    got = np.asarray(r.distances)
    fin = np.isfinite(ref)
    assert np.array_equal(np.isfinite(got), fin)
    np.testing.assert_allclose(got[fin], ref[fin], rtol=1e-5, atol=1e-5)


def check_pr(c: Case):
    r = A.pr.run(c.g, warmup=False)
    assert compare(r.ranks, A.pr.cpu_reference(c.csr), atol=1e-5,
                   rtol=1e-3) == 0


def check_ppr(c: Case):
    r = A.ppr.run(c.g, c.source, warmup=False)
    assert compare(r.p, A.ppr.cpu_reference(c.csr, c.source), atol=1e-5,
                   rtol=1e-3) == 0


def check_bc(c: Case):
    r = A.bc.run(c.g, c.source, warmup=False)
    ref = A.bc.cpu_reference(c.csr, sources=[c.source],
                             normalize_undirected=False)
    assert compare(r.bc_values, ref, atol=1e-3, rtol=1e-3) == 0


def check_color(c: Case):
    u = c.undirected()
    r = A.color.run(u.g, warmup=False)
    assert A.color.validate(u.csr, np.asarray(r.colors)) == 0


def check_kcore(c: Case):
    u = c.undirected()
    r = A.kcore.run(u.g, warmup=False)
    assert np.array_equal(np.asarray(r.core), A.kcore.cpu_reference(u.csr))


def check_hits(c: Case):
    r = A.hits.run(c.g, max_iterations=30, warmup=False)
    ra, rh = A.hits.cpu_reference(c.csr, max_iterations=30)
    assert compare(r.auth, ra, atol=1e-4, rtol=1e-3) == 0
    assert compare(r.hub, rh, atol=1e-4, rtol=1e-3) == 0


def check_spmv(c: Case):
    x = np.random.default_rng(0).random(c.g.n_vertices_padded) \
        .astype(np.float32)
    x[c.g.n_vertices:] = 0
    r = A.spmv.run(c.g, jnp.asarray(x), warmup=False)
    ref = A.spmv.cpu_reference(c.csr, x[:c.g.n_vertices])
    assert compare(r.y, ref, atol=1e-4, rtol=1e-4) == 0


def check_tc(c: Case):
    u = c.undirected()
    r = A.tc.run(u.csr, warmup=False)
    total, vt = A.tc.cpu_reference(u.csr)
    assert r.total == total
    assert np.array_equal(r.vertex_triangles, vt)


def check_mst(c: Case):
    u = c.undirected()
    r = A.mst.run(u.g, warmup=False)
    ref = A.mst.cpu_reference(u.csr)
    assert abs(r.total_weight - ref) <= 1e-3 * max(abs(ref), 1.0)


def check_geo(c: Case):
    u = c.undirected()
    v, vp = u.g.n_vertices, u.g.n_vertices_padded
    rng = np.random.default_rng(1)
    lat = np.full(vp, np.nan, np.float32)
    lon = np.full(vp, np.nan, np.float32)
    ids = rng.choice(v, max(v // 4, 1), replace=False)
    lat[ids] = rng.uniform(-60, 60, ids.size)
    lon[ids] = rng.uniform(-180, 180, ids.size)
    r = A.geo.run(u.g, lat, lon, warmup=False)
    rl, ro = A.geo.cpu_reference(u.csr, lat[:v], lon[:v])
    for got, ref in ((r.lat, rl), (r.lon, ro)):
        got = np.asarray(got)
        known = ~np.isnan(ref)            # isolated vertices stay unknown
        assert np.array_equal(~np.isnan(got), known)
        assert compare(got[known], ref[known], atol=1e-2, rtol=1e-3) == 0


def check_spgemm(c: Case):
    import scipy.sparse as sp
    a = c.csr
    rows = min(a.n_rows, 256)
    k = int(a.row_offsets[rows])
    left = Csr(rows, a.n_cols, a.row_offsets[:rows + 1], a.col_indices[:k],
               a.values[:k])
    r = A.spgemm.run(left, a, warmup=False)

    def m(x):
        return sp.csr_matrix((np.asarray(x.values, np.float64),
                              x.col_indices, x.row_offsets),
                             shape=(x.n_rows, x.n_cols))
    ref = (m(left) @ m(a)).tocsr()
    ref.sort_indices()
    assert np.array_equal(r.c.row_offsets, ref.indptr)
    assert np.array_equal(r.c.col_indices, ref.indices)
    np.testing.assert_allclose(r.c.values, ref.data, rtol=1e-5)


CHECKS = {name[len("check_"):]: fn for name, fn in globals().items()
          if name.startswith("check_")}
