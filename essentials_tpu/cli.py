"""Command-line driver: run any algorithm on a graph file.

Reference parity: the per-algorithm example binaries
(/root/reference/examples/algorithms/*/*.cu) and their protocol — load graph,
run (mean of N), diff against the CPU reference, report timing/MTEPS — as a
single `essentials-tpu <algo> <graph> [options]` entry point (the reference
uses cxxopts per binary, examples/tools/cmd/cmd.cu:6-45).
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def _build(args, weighted_default=True):
    from essentials_tpu.io import load_graph_file
    from essentials_tpu.graph import build_graph
    csr = load_graph_file(args.graph, cache=not args.no_cache)
    g = build_graph(csr, directed=not args.undirected,
                    weighted=weighted_default)
    return csr, g


def main(argv=None):
    p = argparse.ArgumentParser(prog="essentials-tpu",
                                description="graph analytics in JAX")
    p.add_argument("algorithm",
                   choices=["bfs", "sssp", "pr", "ppr", "bc", "color", "kcore",
                            "hits", "spmv", "tc", "mst", "spgemm", "geo"])
    p.add_argument("graph", help=".mtx/.smtx/.csr.npz graph file")
    p.add_argument("--source", type=int, default=0,
                   help="source vertex (bfs/sssp/ppr/bc)")
    p.add_argument("--labels", default=None,
                   help="geo: labels file of 'vertex lat lon' lines "
                        "(default: synthetic 10%% seeded locations)")
    p.add_argument("--runs", type=int, default=5, help="timed runs (mean of)")
    p.add_argument("--undirected", action="store_true",
                   help="treat graph as undirected/symmetric")
    p.add_argument("--no-cache", action="store_true",
                   help="skip the .csr.npz parse cache")
    p.add_argument("--validate", action="store_true",
                   help="diff against the CPU reference")
    p.add_argument("--json", action="store_true", help="JSON stats output")
    p.add_argument("--cpu", action="store_true", help="force JAX CPU backend")
    p.add_argument("--variant", default=None,
                   help="algorithm variant: pr/hits/bc 'spmv'/'generic', "
                        "color 'jp'/'spec', spmv 'pull'/'push', "
                        "tc 'dense'/'sorted'/'shift'")
    args = p.parse_args(argv)

    if args.cpu:
        import jax
        jax.config.update("jax_platforms", "cpu")

    from essentials_tpu import algorithms as A
    from essentials_tpu.utils import compare
    from essentials_tpu.utils.stats import collect_stats
    from essentials_tpu.io.loader import extract_dataset

    csr, g = _build(args)
    name = args.algorithm
    errors = None

    def timed(run_fn, *a, **kw):
        res = run_fn(*a, warmup=True, **kw)
        times = [res.elapsed_ms]
        for _ in range(args.runs - 1):
            times.append(run_fn(*a, warmup=False, **kw).elapsed_ms)
        return res, float(np.mean(times))

    kw = {"variant": args.variant} if args.variant else {}
    if args.variant and name not in ("pr", "hits", "bc", "color", "spmv",
                                     "tc"):
        p.error(f"{name} has no --variant")
    if name == "bfs":
        res, ms = timed(A.bfs.run, g, args.source)
        if args.validate:
            errors = compare(res.distances, A.bfs.cpu_reference(csr, args.source))
    elif name == "sssp":
        res, ms = timed(A.sssp.run, g, args.source)
        if args.validate:
            errors = compare(res.distances, A.sssp.cpu_reference(csr, args.source))
    elif name == "pr":
        res, ms = timed(A.pr.run, g, **kw)
        if args.validate:
            errors = compare(res.ranks, A.pr.cpu_reference(csr),
                             atol=1e-5, rtol=1e-3)
    elif name == "ppr":
        res, ms = timed(A.ppr.run, g, args.source)
        if args.validate:
            errors = compare(res.p, A.ppr.cpu_reference(csr, args.source),
                             atol=1e-5, rtol=1e-3)
    elif name == "bc":
        res, ms = timed(A.bc.run, g, args.source, **kw)
        if args.validate:
            errors = compare(res.bc_values,
                             A.bc.cpu_reference(csr, sources=[args.source],
                                                normalize_undirected=False),
                             atol=1e-3, rtol=1e-3)
    elif name == "color":
        res, ms = timed(A.color.run, g, **kw)
        if args.validate:
            errors = A.color.validate(csr, res.colors)
    elif name == "kcore":
        res, ms = timed(A.kcore.run, g)
        if args.validate:
            errors = compare(res.core, A.kcore.cpu_reference(csr))
    elif name == "hits":
        res, ms = timed(A.hits.run, g, **kw)
        if args.validate:
            ra, rh = A.hits.cpu_reference(csr)
            errors = compare(res.auth, ra, atol=1e-4, rtol=1e-3) + \
                compare(res.hub, rh, atol=1e-4, rtol=1e-3)
    elif name == "spmv":
        res, ms = timed(A.spmv.run, g, **kw)
        if args.validate:
            import jax
            x = np.zeros(g.n_vertices_padded, np.float32)
            key = jax.random.PRNGKey(0)
            x[:] = np.asarray(jax.random.uniform(key, (g.n_vertices_padded,)))
            x[g.n_vertices:] = 0
            import jax.numpy as jnp
            r2 = A.spmv.run(g, jnp.asarray(x), warmup=False, **kw)
            errors = compare(r2.y, A.spmv.cpu_reference(csr, x[:g.n_vertices]),
                             atol=1e-4, rtol=1e-4)
    elif name == "tc":
        res, ms = timed(A.tc.run, csr, **kw)
        if args.validate:
            total, vt = A.tc.cpu_reference(csr)
            errors = int(res.total != total) + int(
                not np.array_equal(res.vertex_triangles, vt))
    elif name == "mst":
        res, ms = timed(A.mst.run, g)
        if args.validate:
            ref = A.mst.cpu_reference(csr)
            errors = int(abs(res.total_weight - ref) > 1e-4 * max(abs(ref), 1))
    elif name == "spgemm":
        res, ms = timed(A.spgemm.run, csr, csr)
        if args.validate:
            ref = A.spgemm.cpu_reference(csr, csr)
            errors = int(not np.array_equal(res.c.col_indices, ref.col_indices))
    elif name == "geo":
        vp = g.n_vertices_padded
        lat = np.full(vp, np.nan, np.float32)
        lon = np.full(vp, np.nan, np.float32)
        if args.labels:
            # reference parity: geo example labels file
            # (examples/algorithms/geo/geo.cu:32-90): "<vertex> <lat> <lon>"
            data = np.loadtxt(args.labels, ndmin=2)
            ids = data[:, 0].astype(np.int64)
            lat[ids], lon[ids] = data[:, 1], data[:, 2]
        else:
            rng = np.random.default_rng(0)
            n_seed = max(g.n_vertices // 10, 1)
            ids = rng.choice(g.n_vertices, n_seed, replace=False)
            lat[ids] = rng.uniform(-60, 60, n_seed)
            lon[ids] = rng.uniform(-180, 180, n_seed)
        res, ms = timed(A.geo.run, g, lat, lon)
        if args.validate:
            rl, ro = A.geo.cpu_reference(csr, lat[:g.n_vertices],
                                         lon[:g.n_vertices])
            errors = compare(res.lat, rl, atol=1e-2, rtol=1e-3) + \
                compare(res.lon, ro, atol=1e-2, rtol=1e-3)

    iters = getattr(res, "iterations", 1)
    stats = collect_stats(name, extract_dataset(args.graph), g if name != "tc"
                          else _GraphShim(csr), ms, iters)
    if args.json:
        print(stats.to_json())
    else:
        print(f"{name} on {stats.dataset}: {ms:.3f} ms "
              f"({iters} iterations, {stats.mteps:.1f} MTEPS)")
        if errors is not None:
            print(f"validation: {'PASS' if errors == 0 else 'FAIL'} "
                  f"({errors} errors)")
    return 1 if errors else 0


class _GraphShim:
    def __init__(self, csr):
        from essentials_tpu.graph.graph import GraphProperties
        self.n_vertices = csr.n_rows
        self.n_edges = csr.nnz
        self.properties = GraphProperties(directed=False, weighted=False)


if __name__ == "__main__":
    sys.exit(main())
