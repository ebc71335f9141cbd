"""Benchmark harness: every algorithm on a dataset suite, JSON output.

Reference parity: the NVBench binaries + test_benchmarks.sh
(/root/reference/benchmarks/, emits per-algorithm JSON). This environment
has no dataset egress, so the default suite is generated (see
datasets/generate_suite.py); pass .mtx paths to use real graphs.

Timing: each algorithm's ``run`` compiles and warms once, then ``--runs``
timed runs, each fenced by ``jax.block_until_ready`` (the algorithm's own
``elapsed_ms``); rows report the median and every cycle.

Usage:
  python benchmarks/run_benchmarks.py [--cpu] [--out results.json] [graphs...]
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def _load(path: str):
    """A dataset path, or a generator spec 'gen:rmat20x16' /
    'gen:grid2048' / 'gen:uniform1048576x8' (no .mtx materialization)."""
    from essentials_tpu.io import load_graph_file, generate
    from essentials_tpu.io.loader import extract_dataset
    from essentials_tpu.formats import Csr
    if not path.startswith("gen:"):
        return load_graph_file(path), extract_dataset(path)
    spec = path[4:]
    if spec.startswith("rmat"):
        scale, ef = spec[4:].split("x")
        coo = generate.rmat(int(scale), int(ef), seed=1, undirected=True,
                            weighted=True)
    elif spec.startswith("grid"):
        side = int(spec[4:])
        coo = generate.grid_2d(side, weighted=True)
    elif spec.startswith("uniform"):
        n, d = spec[7:].split("x")
        coo = generate.uniform_random(int(n), int(d), seed=2,
                                      undirected=True, weighted=True)
    else:
        raise ValueError(spec)
    return Csr.from_coo(coo), spec


def bench_graph(path: str, runs: int, skip: set | None = None,
                flush=None) -> list[dict]:
    import numpy as np
    import jax.numpy as jnp
    from essentials_tpu.graph import build_graph
    from essentials_tpu import algorithms as A
    from essentials_tpu.utils.stats import collect_stats

    csr, ds = _load(path)
    g = build_graph(csr, directed=False, weighted=True)
    deg = np.diff(np.asarray(csr.row_offsets))
    src = int(np.argmax(deg))
    out = []

    def add(name, run_fn, graph=g, **extra):
        if skip and name in skip:
            print(f"  {name:10s} skipped")
            return
        try:
            res = run_fn(True)
            cycles = [res.elapsed_ms] + [run_fn(False).elapsed_ms
                                         for _ in range(runs - 1)]
            ms = float(np.median(cycles))
            st = collect_stats(name, ds, graph, ms,
                               getattr(res, "iterations", 1),
                               cycles_ms=cycles)
            rec = json.loads(st.to_json())
            rec.update(extra)
            out.append(rec)
            share = ("" if st.pct_hbm_roofline is None else
                     f" ({100 * st.pct_hbm_roofline:5.1f}% of peak)")
            print(f"  {name:10s} {ms:10.3f} ms  {st.mteps:10.1f} MTEPS  "
                  f"{st.gbps_effective:8.1f} GB/s{share}", flush=True)
        except Exception as e:  # keep the suite running; the row says why
            print(f"  {name:10s} FAILED: {type(e).__name__}: {e}")
            out.append({"algorithm": name, "dataset": ds, "error": str(e)})
        if flush is not None:
            flush(out)

    add("bfs", lambda w: A.bfs.run(g, src, warmup=w))
    add("sssp", lambda w: A.sssp.run(g, src, warmup=w))
    add("ppr", lambda w: A.ppr.run(g, src, warmup=w))
    add("bc", lambda w: A.bc.run(g, src, warmup=w))
    add("pr", lambda w: A.pr.run(g, warmup=w))
    add("color", lambda w: A.color.run(g, warmup=w))
    add("kcore", lambda w: A.kcore.run(g, warmup=w))
    add("hits", lambda w: A.hits.run(g, warmup=w))
    add("mst", lambda w: A.mst.run(g, warmup=w))

    rng = np.random.default_rng(7)
    n = g.n_vertices
    lat = rng.uniform(-60, 60, n).astype(np.float32)
    lon = rng.uniform(-180, 180, n).astype(np.float32)
    unknown = rng.random(n) > 0.2        # 20% located (ref-style input)
    lat[unknown] = np.nan
    lon[unknown] = np.nan
    add("geo", lambda w: A.geo.run(g, lat, lon, warmup=w))

    x0 = jnp.asarray(np.where(np.arange(g.n_vertices_padded) < n,
                              rng.random(g.n_vertices_padded), 0.0)
                     .astype(np.float32))
    add("spmv", lambda w: A.spmv.run(g, x0, warmup=w))

    # spgemm A @ A: the static plan while the product count keeps it
    # tractable, the chunked numeric phase beyond
    products = int(deg.astype(np.int64)[np.asarray(csr.col_indices)].sum())
    if products <= (1 << 26):
        plan = A.spgemm.make_plan(csr, csr)
        add("spgemm", lambda w: A.spgemm.run(csr, csr, warmup=w, plan=plan),
            edges_visited=products, n_products=products)
    elif products <= np.iinfo(np.int32).max:
        cplan = A.spgemm.make_chunked_plan(csr, csr)
        add("spgemm", lambda w: A.spgemm.run_chunked(csr, csr, warmup=w,
                                                     plan=cplan),
            n_products=products, variant="chunked")
    else:
        print(f"  {'spgemm':10s} skipped for time ({products} products; "
              f"run benchmarks/spgemm_big.py for the streamed run)")
    add("tc", lambda w: A.tc.run(csr, warmup=w))
    return out


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("graphs", nargs="*",
                   default=["datasets/chesapeake.mtx"])
    p.add_argument("--cpu", action="store_true")
    p.add_argument("--runs", type=int, default=4,
                   help="timed runs per algorithm (median reported)")
    p.add_argument("--out", default=None)
    p.add_argument("--skip", default="",
                   help="comma-separated algorithm names to skip")
    args = p.parse_args(argv)
    if args.cpu:
        import jax
        jax.config.update("jax_platforms", "cpu")

    skip = {s for s in args.skip.split(",") if s}
    results = []

    def flush(rows):
        """Write after every row: a killed/timed-out run keeps its rows.
        Atomic temp-file + os.replace so a kill mid-write can't corrupt
        args.out."""
        if args.out:
            tmp = args.out + ".tmp"
            with open(tmp, "w") as f:
                json.dump(results + rows, f, indent=1)
            os.replace(tmp, args.out)

    for path in args.graphs:
        print(f"== {path} ==")
        results.extend(bench_graph(path, args.runs, skip,
                                   flush=flush if args.out else None))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
        print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
