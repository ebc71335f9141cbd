#!/usr/bin/env python3
"""Smoke run of essentials_tpu on an NVIDIA GPU, end to end.

    python3 chip_smoke.py            # one GPU: every phase below
    python3 chip_smoke.py --multi    # four GPUs: the distributed path only

Phases (one process; any failure exits non-zero):

  1. device      GPU backend required (no CPU fallback); prints the card's
                 name and power limit, the JAX version and XLA_FLAGS.
  2. primitives  times what XLA makes of the edge-axis primitives (gather,
                 scatter-add/min, sort, cumsum, segmented scan, sorted
                 segment_sum/min) at the main graph's padded edge count.
  3. main        Graph500-parameter Kronecker graph (scale 22, edgefactor
                 16, undirected, weighted): build_graph, then bfs, sssp, pr
                 and spmv from the highest-degree vertex, each checked
                 against scipy (BFS exact, SSSP rtol 1e-5, PR L-inf 1e-6 on
                 normalised ranks, SpMV rtol 1e-5 of |A||x|).
  4. suite       every algorithm on datasets/kron_s16.mtx and
                 datasets/road_512x512.mtx against its host reference, plus
                 the CLI once in process.
  5. gpu tests   the tests marked ``gpu``, through pytest.main.

With --multi (four GPUs): the scale-22 graph partitioned over a 1-D mesh
of four devices, dist_bfs / dist_sssp / dist_pagerank in the all_gather,
boundary and overlap exchange modes, each compared with the single-GPU
result and checked to be sharded over the four devices.

The last line of standard output is one JSON object:
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.abspath(__file__))
MAIN_SCALE = 22
EDGE_FACTOR = 16
SEED = 1
# BC's path counts overflow float32 past ~128 levels on a grid; deeper
# graphs are checked on the ball of this radius around the source
BC_MAX_DEPTH = 100


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


class timed:
    """``with timed("label") as t: ...`` then ``t.s`` (seconds)."""

    def __init__(self, label: str | None = None):
        self.label = label

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.s = time.perf_counter() - self.t0
        if self.label and exc[0] is None:
            log(f"  {self.label}: {self.s:.3f} s")
        return False


# ---------------------------------------------------------------- phase 1

def phase_device(n_expected: int):
    import jax
    backend = jax.default_backend()
    check(backend == "gpu", f"JAX backend is {backend!r}, need a GPU")
    devs = jax.devices()
    check(len(devs) >= n_expected,
          f"need {n_expected} GPUs, JAX sees {len(devs)}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    log(f"nvidia-smi: {smi}")
    log(f"jax {jax.__version__}; devices: {len(devs)} x "
        f"{devs[0].device_kind}; XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}")
    from essentials_tpu import runtime
    props = runtime.device_properties(devs[0])
    log(f"peak table: {props.kind}: {props.hbm_gbps} GB/s, "
        f"{props.mem_gib} GiB, L2 {props.l2_mib} MiB, {props.sm_count} SMs")
    return devs


# ---------------------------------------------------------------- phase 3
# (the graph is built before phase 2, which times primitives at its size)

def make_main_graph(scale: int):
    import jax
    from essentials_tpu.formats import Csr
    from essentials_tpu.graph import build_graph
    from essentials_tpu.io import generate
    log(f"main graph: rmat scale {scale}, edgefactor {EDGE_FACTOR}, "
        f"A=.57 B=C=.19, undirected, weighted, seed {SEED}")
    with timed("generate (host)"):
        coo = generate.rmat(scale, EDGE_FACTOR, seed=SEED, undirected=True,
                            weighted=True)
    with timed("Csr.from_coo (host)"):
        csr = Csr.from_coo(coo)
    del coo
    with timed("build_graph (host build + enqueue transfer)"):
        g = build_graph(csr, directed=False, weighted=True)
    with timed("transfer (block_until_ready)"):
        jax.block_until_ready(g)
    log(f"  V={g.n_vertices} E={g.n_edges} Vp={g.n_vertices_padded} "
        f"Ep={g.n_edges_padded} symmetric_layout={g.symmetric_layout}")
    return csr, g


def scipy_matrix(csr, unit: bool = False):
    import numpy as np
    import scipy.sparse as sp
    vals = np.ones(csr.nnz) if unit else np.asarray(csr.values, np.float64)
    return sp.csr_matrix((vals, np.asarray(csr.col_indices),
                          np.asarray(csr.row_offsets)),
                         shape=(csr.n_rows, csr.n_cols))


def pagerank_ref(a, alpha: float = 0.85, tol: float = 1e-10,
                 max_iterations: int = 100):
    """Float64 power iteration with weighted spread and dangling mass
    (the semantics of algorithms/pr.py), on scipy sparse."""
    import numpy as np
    n = a.shape[0]
    wsum = np.asarray(a.sum(axis=1)).ravel()
    at = a.T
    r = np.full(n, 1.0 / n)
    for _ in range(max_iterations):
        contrib = np.where(wsum > 0, alpha * r / np.maximum(wsum, 1e-300), 0)
        new = (1 - alpha) / n + alpha * r[wsum == 0].sum() / n + at @ contrib
        done = np.abs(new - r).sum() < tol
        r = new
        if done:
            break
    return r


def compare_bfs(got, ref_float):
    import numpy as np
    got = np.asarray(got)
    unreached = np.iinfo(np.int32).max
    reach = np.isfinite(ref_float)
    check(np.array_equal(got != unreached, reach), "BFS reach sets differ")
    check(np.array_equal(got[reach], ref_float[reach].astype(np.int64)),
          "BFS depths differ")
    return int(reach.sum())


def compare_sssp(got, ref, rtol: float = 1e-5):
    import numpy as np
    got = np.asarray(got, np.float64)
    fin = np.isfinite(ref)
    check(np.array_equal(np.isfinite(got), fin), "SSSP reach sets differ")
    err = np.abs(got[fin] - ref[fin]) / np.maximum(np.abs(ref[fin]), 1e-30)
    worst = float(err.max()) if err.size else 0.0
    check(worst <= rtol, f"SSSP max rel err {worst:.3e} > {rtol}")
    return worst


def compare_pr(got, ref, atol: float = 1e-6):
    import numpy as np
    got = np.asarray(got, np.float64)
    d = float(np.abs(got / got.sum() - ref / ref.sum()).max())
    check(d <= atol, f"PR L-inf {d:.3e} > {atol}")
    return d


def phase_main(csr, g, source: int):
    import numpy as np
    import jax
    import jax.numpy as jnp
    from scipy.sparse.csgraph import shortest_path, dijkstra
    from essentials_tpu.algorithms import bfs, sssp, pr, spmv
    a = scipy_matrix(csr)
    v = csr.n_rows
    deg = np.diff(np.asarray(csr.row_offsets))
    log(f"source {source} (degree {int(deg[source])})")
    results = {}

    with timed() as t:
        r = bfs.run(g, source)
        dist = np.asarray(r.distances)
    log(f"  bfs: {r.elapsed_ms:.3f} ms, {r.iterations} levels; first call "
        f"incl. compile {t.s - r.elapsed_ms / 1e3:.3f} s")
    with timed("  scipy shortest_path(unweighted)"):
        ref = shortest_path(a, method="D", unweighted=True,
                            indices=source)
    n_reach = compare_bfs(dist, ref)
    pred = np.asarray(r.predecessors)
    ok_pred = pred[(dist != np.iinfo(np.int32).max) & (dist > 0)]
    check(ok_pred.size == 0 or ok_pred.min() >= 0, "BFS predecessor missing")
    results["bfs"] = dict(ms=r.elapsed_ms, iterations=r.iterations,
                          reached=n_reach, exact=True)

    with timed() as t:
        r = sssp.run(g, source)
        d = np.asarray(r.distances)
    log(f"  sssp: {r.elapsed_ms:.3f} ms, {r.iterations} rounds; first call "
        f"incl. compile {t.s - r.elapsed_ms / 1e3:.3f} s")
    with timed("  scipy dijkstra"):
        ref = dijkstra(a, indices=source)
    worst = compare_sssp(d, ref)
    results["sssp"] = dict(ms=r.elapsed_ms, iterations=r.iterations,
                           max_rel_err=worst)

    with timed() as t:
        r = pr.run(g)
        ranks = np.asarray(r.ranks)
    log(f"  pr: {r.elapsed_ms:.3f} ms, {r.iterations} iterations; first "
        f"call incl. compile {t.s - r.elapsed_ms / 1e3:.3f} s")
    with timed("  scipy power iteration"):
        ref = pagerank_ref(a)
    linf = compare_pr(ranks, ref)
    results["pr"] = dict(ms=r.elapsed_ms, iterations=r.iterations,
                         linf=linf)

    x = np.array(jax.random.uniform(jax.random.PRNGKey(SEED),
                                    (g.n_vertices_padded,), jnp.float32))
    x[v:] = 0.0
    with timed() as t:
        r = spmv.run(g, jnp.asarray(x))
        y = np.asarray(r.y, np.float64)
    log(f"  spmv: {r.elapsed_ms:.3f} ms; first call incl. compile "
        f"{t.s - r.elapsed_ms / 1e3:.3f} s")
    xv = x[:v].astype(np.float64)
    ref = a @ xv
    scale = abs(a) @ np.abs(xv)
    rel = np.abs(y - ref) / np.maximum(scale, 1e-30)
    worst = float(rel.max())
    check(worst <= 1e-5, f"SpMV max err {worst:.3e} of |A||x| > 1e-5")
    results["spmv"] = dict(ms=r.elapsed_ms, max_rel_err=worst)
    log("main: " + json.dumps(results))
    return results


# ---------------------------------------------------------------- phase 2

def _median_ms(fn, *args, reps: int = 7) -> float:
    import numpy as np
    import jax
    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(ts))


def phase_primitives(g):
    """Times over the main graph's own index arrays: gathers by its column
    ids and CSC edge ids, scatters and sorted segment reductions by its
    source ids."""
    import jax
    import jax.numpy as jnp
    from essentials_tpu.ops import scan_kernels as sk
    ep, vp = g.n_edges_padded, g.n_vertices_padded
    xv = jnp.arange(vp, dtype=jnp.float32) * 1e-3
    xe = jnp.arange(ep, dtype=jnp.float32) * 1e-6
    ie = jnp.arange(ep, dtype=jnp.int32)
    col, src, perm = g.col_indices, g.src_indices, g.csc_edge_ids
    flags = g.csr_seg_flags
    prims = {
        "gather_v x[col]": (jax.jit(lambda x, i: x[i]), (xv, col), 12),
        "gather_e y[perm]": (jax.jit(lambda y, i: y[i]), (xe, perm), 12),
        "scatter_add": (jax.jit(lambda d, i: jnp.zeros(vp).at[i].add(d)),
                        (xe, col), 12),
        "scatter_min": (jax.jit(lambda d, i: jnp.full(vp, jnp.inf)
                                .at[i].min(d)), (xe, col), 12),
        "sort key+payload": (jax.jit(lambda k, p: jax.lax.sort(
            (k, p), num_keys=1)), (g.csc_rank, xe), 16),
        "cumsum i32": (jax.jit(jnp.cumsum), (ie,), 8),
        "segmented_scan add": (jax.jit(lambda x, f: sk.segmented_scan(
            x, f, "add")), (xe, flags), 9),
        "segment_sum sorted": (jax.jit(lambda d, s: jax.ops.segment_sum(
            d, s, num_segments=vp, indices_are_sorted=True)), (xe, src), 8),
        "segment_min sorted": (jax.jit(lambda d, s: jax.ops.segment_min(
            d, s, num_segments=vp, indices_are_sorted=True)), (xe, src), 8),
    }
    parts = []
    out = {}
    for name, (fn, args, bytes_per_edge) in prims.items():
        ms = _median_ms(fn, *args)
        gbps = ep * bytes_per_edge / (ms * 1e-3) / 1e9
        out[name] = dict(ms=ms, gbps=gbps)
        parts.append(f"{name} {ms:.3f} ms ({gbps:.0f} GB/s)")
    log(f"primitives at Ep={ep} (median of 7, bytes/edge model in "
        f"chip_smoke.phase_primitives): " + "; ".join(parts))
    return out


# ---------------------------------------------------------------- phase 4

def geo_ref(a, lat, lon, total_iterations: int = 10):
    """Vectorised algorithms/geo.py cpu_reference (neighbor mean direction
    per unknown vertex, all in float64) on scipy sparse."""
    import numpy as np
    n = a.shape[0]
    pat = a.copy()
    pat.data[:] = 1.0
    lat = np.array(lat, np.float64)
    lon = np.array(lon, np.float64)
    for _ in range(total_iterations):
        known = ~np.isnan(lat)
        if known.all():
            break
        la, lo = np.deg2rad(np.nan_to_num(lat)), np.deg2rad(np.nan_to_num(lon))
        sx = pat @ (np.cos(la) * np.cos(lo) * known)
        sy = pat @ (np.cos(la) * np.sin(lo) * known)
        sz = pat @ (np.sin(la) * known)
        norm = np.sqrt(sx * sx + sy * sy + sz * sz)
        upd = ~known & (norm > 1e-12)
        nz = np.maximum(norm, 1e-300)
        lat = np.where(upd, np.rad2deg(np.arcsin(np.clip(sz / nz, -1, 1))),
                       lat)
        lon = np.where(upd, np.rad2deg(np.arctan2(sy / nz, sx / nz)), lon)
    return lat, lon


def ppr_ref(a, seed: int, alpha: float = 0.15, eps: float = 1e-6,
            max_iterations: int = 1000):
    """Vectorised algorithms/ppr.py cpu_reference (push-style PPR) on
    scipy sparse."""
    import numpy as np
    n = a.shape[0]
    pat = a.copy()
    pat.data[:] = 1.0
    pt = pat.T.tocsr()
    deg = np.diff(a.indptr)
    p = np.zeros(n)
    r = np.zeros(n)
    r[seed] = 1.0
    c_keep = 2 * alpha / (1 + alpha)
    c_push = (1 - alpha) / (1 + alpha)
    for it in range(max_iterations):
        if it == 0:
            front = np.zeros(n, bool)
            front[seed] = True
        else:
            front = (r >= eps * deg) & (deg > 0)
        if not front.any():
            break
        p[front] += c_keep * r[front]
        push = np.where(front, c_push * r / np.maximum(deg, 1), 0.0)
        r = np.where(front, 0.0, r) + pt @ push
    return p


def bc_ref(csr, src: int, dist, radius: int | None):
    """Host Brandes from ``src``; with ``radius``, on the subgraph induced
    by the vertices at BFS depth <= radius (every shortest path to them
    stays inside), which is what bc.run(max_depth=radius) computes."""
    import numpy as np
    from essentials_tpu import algorithms as A
    from essentials_tpu.formats import Coo, Csr
    if radius is None:
        return A.bc.cpu_reference(csr, sources=[src],
                                  normalize_undirected=False)
    ball = np.nonzero(dist <= radius)[0]
    new = np.full(csr.n_rows, -1, np.int64)
    new[ball] = np.arange(ball.size)
    coo = csr.to_coo()
    keep = (new[coo.row_indices] >= 0) & (new[coo.col_indices] >= 0)
    sub = Csr.from_coo(Coo(ball.size, ball.size,
                           new[coo.row_indices[keep]],
                           new[coo.col_indices[keep]], coo.values[keep]))
    out = np.zeros(csr.n_rows, np.float32)
    out[ball] = A.bc.cpu_reference(sub, sources=[int(new[src])],
                                   normalize_undirected=False)
    return out


def _close(got, ref, atol, rtol, what):
    import numpy as np
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    bad = ~np.isclose(got, ref, atol=atol, rtol=rtol, equal_nan=True)
    check(not bad.any(), f"{what}: {int(bad.sum())} entries outside "
                         f"atol={atol} rtol={rtol}")


def suite_on(path: str, spgemm_rows: int | None):
    """Every algorithm on one dataset, each against its host reference."""
    import numpy as np
    import jax
    import jax.numpy as jnp
    import scipy.sparse as sp
    from scipy.sparse.csgraph import dijkstra, minimum_spanning_tree
    from essentials_tpu import algorithms as A
    from essentials_tpu.graph import build_graph
    from essentials_tpu.io import load_graph_file
    from essentials_tpu.formats import Csr

    name = os.path.basename(path)
    with timed(f"{name}: load + build_graph"):
        csr = load_graph_file(path, cache=False)
        g = jax.block_until_ready(build_graph(csr, directed=False,
                                              weighted=True))
    a = scipy_matrix(csr)
    check(abs(a - a.T).sum() == 0, f"{name} is not symmetric")
    v = csr.n_rows
    deg = np.diff(np.asarray(csr.row_offsets))
    src = int(np.argmax(deg))
    rows = {}

    def row(alg, res, t, **extra):
        # one cold run each: elapsed_ms includes the compilation
        rows[alg] = dict(first_run_ms=getattr(res, "elapsed_ms", None),
                         iterations=getattr(res, "iterations", None),
                         wall_s=round(t.s, 3), **extra)
        log(f"  {name} {alg}: {json.dumps(rows[alg])}")

    with timed() as t:
        r = A.bfs.run(g, src, warmup=False)
        dist = np.asarray(r.distances)
    check(np.array_equal(dist, A.bfs.cpu_reference(csr, src)),
          f"{name} bfs differs from host BFS")
    row("bfs", r, t)

    with timed() as t:
        r = A.sssp.run(g, src, warmup=False)
        d = np.asarray(r.distances)
    row("sssp", r, t, max_rel_err=compare_sssp(d, dijkstra(a, indices=src)))

    with timed() as t:
        r = A.pr.run(g, warmup=False)
        ranks = np.asarray(r.ranks)
    row("pr", r, t, linf=compare_pr(ranks, pagerank_ref(a)))

    with timed() as t:
        r = A.ppr.run(g, src, warmup=False)
        p = np.asarray(r.p)
    _close(p, ppr_ref(a, src), 1e-5, 1e-3, f"{name} ppr")
    row("ppr", r, t)

    depth = int(dist[dist != np.iinfo(np.int32).max].max())
    radius = None if depth <= BC_MAX_DEPTH else BC_MAX_DEPTH
    with timed() as t:
        r = A.bc.run(g, src, max_depth=radius, warmup=False)
        bcv = np.asarray(r.bc_values)
    _close(bcv, bc_ref(csr, src, dist, radius), 1e-3, 1e-3, f"{name} bc")
    row("bc", r, t, radius=radius)

    with timed() as t:
        r = A.color.run(g, warmup=False)
        colors = np.asarray(r.colors)
    check(A.color.validate(csr, colors) == 0, f"{name} color conflicts")
    row("color", r, t, colors=int(colors.max()) + 1)

    with timed() as t:
        r = A.kcore.run(g, warmup=False)
        core = np.asarray(r.core)
    check(np.array_equal(core, A.kcore.cpu_reference(csr)),
          f"{name} kcore differs from host peeling")
    row("kcore", r, t, max_core=int(core.max()))

    with timed() as t:
        r = A.hits.run(g, max_iterations=30, warmup=False)
        auth, hub = np.asarray(r.auth), np.asarray(r.hub)
    ra, rh = A.hits.cpu_reference(csr, max_iterations=30)
    _close(auth, ra, 1e-4, 1e-3, f"{name} hits auth")
    _close(hub, rh, 1e-4, 1e-3, f"{name} hits hub")
    row("hits", r, t)

    x = np.random.default_rng(SEED).random(g.n_vertices_padded) \
        .astype(np.float32)
    x[v:] = 0.0
    with timed() as t:
        r = A.spmv.run(g, jnp.asarray(x), warmup=False)
        y = np.asarray(r.y)
    _close(y, A.spmv.cpu_reference(csr, x[:v]), 1e-4, 1e-4, f"{name} spmv")
    row("spmv", r, t)

    with timed() as t:
        r = A.tc.run(csr, warmup=False)
    check(int(np.asarray(r.vertex_triangles).sum()) == 3 * r.total,
          f"{name} tc per-vertex sum != 3 * total")
    if v <= (1 << 18) and deg.max() <= 64:
        total, vt = A.tc.cpu_reference(csr)
        check(np.array_equal(r.vertex_triangles, vt),
              f"{name} tc per-vertex counts differ")
    else:
        total = A.tc.cpu_reference_total(csr)
    check(r.total == total, f"{name} tc total {r.total} != {total}")
    row("tc", r, t, triangles=int(r.total))

    with timed() as t:
        r = A.mst.run(g, warmup=False)
    ref_w = float(minimum_spanning_tree(sp.triu(a)).sum())
    check(abs(r.total_weight - ref_w) <= 1e-5 * max(ref_w, 1.0),
          f"{name} mst weight {r.total_weight} != {ref_w}")
    row("mst", r, t, weight=float(r.total_weight))

    rng = np.random.default_rng(SEED)
    lat = np.full(g.n_vertices_padded, np.nan, np.float32)
    lon = np.full(g.n_vertices_padded, np.nan, np.float32)
    ids = rng.choice(v, max(v // 10, 1), replace=False)
    lat[ids] = rng.uniform(-60, 60, ids.size)
    lon[ids] = rng.uniform(-180, 180, ids.size)
    with timed() as t:
        r = A.geo.run(g, lat, lon, warmup=False)
        glat, glon = np.asarray(r.lat), np.asarray(r.lon)
    rl, ro = geo_ref(a, lat[:v], lon[:v])
    _close(glat, rl, 1e-2, 1e-3, f"{name} geo lat")
    _close(glon, ro, 1e-2, 1e-3, f"{name} geo lon")
    row("geo", r, t)

    if spgemm_rows is None:
        left = csr
    else:
        k = int(np.asarray(csr.row_offsets)[spgemm_rows])
        left = Csr(spgemm_rows, csr.n_cols,
                   np.asarray(csr.row_offsets)[:spgemm_rows + 1],
                   np.asarray(csr.col_indices)[:k],
                   np.asarray(csr.values)[:k])
    with timed() as t:
        if spgemm_rows is None:
            r = A.spgemm.run(left, csr, warmup=False)
        else:
            r = A.spgemm.run_chunked(left, csr, chunk_products=1 << 24,
                                     warmup=False)
    c = r.c
    ref = (scipy_matrix(left) @ a).tocsr()
    ref.sort_indices()
    check(np.array_equal(np.asarray(c.row_offsets), ref.indptr)
          and np.array_equal(np.asarray(c.col_indices), ref.indices),
          f"{name} spgemm structure differs")
    _close(c.values, ref.data, 1e-3, 1e-5, f"{name} spgemm values")
    row("spgemm", r, t, rows=left.n_rows, nnz=int(ref.nnz),
        path="static plan" if spgemm_rows is None else "chunked")
    return rows


def phase_suite():
    from essentials_tpu import cli
    out = {}
    out["kron_s16"] = suite_on(os.path.join(ROOT, "datasets", "kron_s16.mtx"),
                               spgemm_rows=4096)
    out["road_512x512"] = suite_on(
        os.path.join(ROOT, "datasets", "road_512x512.mtx"), spgemm_rows=None)
    with timed("cli bfs kron_s16 --validate --json"):
        rc = cli.main(["bfs", os.path.join(ROOT, "datasets", "kron_s16.mtx"),
                       "--validate", "--json", "--no-cache", "--runs", "2"])
    check(rc == 0, f"cli returned {rc}")
    return out


# ---------------------------------------------------------------- phase 5

def phase_gpu_tests():
    import pytest
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      os.path.join(ROOT, "tests")])
    check(rc == 0, f"gpu-marked tests: pytest exit code {int(rc)}")


# ---------------------------------------------------------------- --multi

def phase_multi(scale: int, n_devices: int = 4):
    import numpy as np
    import jax
    from essentials_tpu.algorithms import bfs, sssp, pr
    from essentials_tpu.graph import build_graph
    from essentials_tpu.parallel import make_mesh
    from essentials_tpu.parallel.partition import partition_graph
    from essentials_tpu.parallel.distributed import (dist_bfs, dist_sssp,
                                                     dist_pagerank)
    csr, g = make_main_graph(scale)
    v = csr.n_rows
    src = int(np.argmax(np.diff(np.asarray(csr.row_offsets))))

    def partitions():
        with timed("partition_graph (all_gather)"):
            ag = partition_graph(csr, n_devices, exchange="all_gather")
        with timed("partition_graph (boundary, with the overlap split)"):
            bo = partition_graph(csr, n_devices, exchange="boundary",
                                 overlap=True)
        return ag, bo

    # the host partitions build in a thread while the single-device
    # results to compare with compile and run (dist_pagerank spreads
    # unweighted, so its single-device twin runs on unit weights)
    with ThreadPoolExecutor(max_workers=1) as ex:
        parts = ex.submit(partitions)
        with timed("single-device bfs/sssp/pr"):
            ref_bfs = np.asarray(bfs.run(
                g, src, warmup=False, compute_predecessors=False).distances)
            ref_sssp = np.asarray(sssp.run(g, src, warmup=False).distances,
                                  np.float64)
            del g
            gu = build_graph(csr, directed=False, weighted=False)
            ref_pr = np.asarray(pr.run(gu, warmup=False).ranks, np.float64)
            del gu
        dg_ag, dg_bo = parts.result()
    mesh = make_mesh(n_devices)
    out = {}
    for mode, dg, ov in (("all_gather", dg_ag, False),
                         ("boundary", dg_bo, False),
                         ("overlap", dg_bo, True)):
        res = {}
        for alg, fn in (("bfs", lambda: dist_bfs(dg, mesh, src, overlap=ov)),
                        ("sssp", lambda: dist_sssp(dg, mesh, src,
                                                   overlap=ov)),
                        ("pr", lambda: dist_pagerank(
                            dg, mesh, max_iterations=500, overlap=ov))):
            with timed() as t:
                got = jax.block_until_ready(fn())
            with timed() as t2:                   # again, compiled
                jax.block_until_ready(fn())
            devs = {s.device for s in got.addressable_shards}
            check(len(got.sharding.device_set) == n_devices
                  and len(devs) == n_devices,
                  f"{mode} {alg}: result not sharded over {n_devices} "
                  f"devices")
            host = np.asarray(got)[:v]
            if alg == "bfs":
                check(np.array_equal(host, ref_bfs),
                      f"{mode} bfs differs from single device")
                res[alg] = dict(exact=True)
            elif alg == "sssp":
                res[alg] = dict(max_rel_err=compare_sssp(
                    host.astype(np.float64), ref_sssp))
            else:
                res[alg] = dict(linf=compare_pr(host, ref_pr))
            res[alg].update(first_s=round(t.s, 3), second_s=round(t2.s, 3))
            log(f"  {mode} {alg}: {json.dumps(res[alg])} (wall times; the "
                f"first includes compilation)")
        out[mode] = res
    log("multi: " + json.dumps(out))
    return out


# ---------------------------------------------------------------- main

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--multi", action="store_true",
                    help="four GPUs: distributed bfs/sssp/pr only")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    try:
        import essentials_tpu  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: essentials_tpu not importable beside this "
              f"script ({e})", file=sys.stderr)
        return 2
    import jax

    t0 = time.perf_counter()
    n_dev = 4 if args.multi else 1
    log("== phase 1: device")
    devs = phase_device(n_dev)
    if args.multi:
        log("== phase 6: --multi")
        phase_multi(MAIN_SCALE, n_dev)
        count = n_dev
    else:
        log("== phase 3 set-up: main graph")
        csr, g = make_main_graph(MAIN_SCALE)
        log("== phase 2: primitives")
        phase_primitives(g)
        log("== phase 3: main")
        import numpy as np
        src = int(np.argmax(np.diff(np.asarray(csr.row_offsets))))
        phase_main(csr, g, src)
        del g, csr
        log("== phase 4: suite")
        phase_suite()
        log("== phase 5: gpu-marked tests")
        phase_gpu_tests()
        count = len(jax.devices())
    log(f"all phases passed in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr, flush=True)
        sys.exit(1)
