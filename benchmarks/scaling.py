"""Weak/strong scaling harness for the distributed supersteps.

Edges/s at 1..N devices and the weak-scaling efficiency. On a CPU
backend this runs on virtual devices
(XLA_FLAGS=--xla_force_host_platform_device_count=8) to validate the
scaling *code path*; on a multi-GPU host it measures real scaling.

Usage:
  python benchmarks/scaling.py [--cpu] [--scale 16] [--weak]
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--cpu", action="store_true")
    p.add_argument("--scale", type=int, default=14,
                   help="RMAT scale per device for weak scaling")
    p.add_argument("--weak", action="store_true",
                   help="weak scaling (graph grows with devices); default strong")
    p.add_argument("--iters", type=int, default=10)
    args = p.parse_args(argv)
    if args.cpu:
        import os
        os.environ.setdefault("XLA_FLAGS",
                              "--xla_force_host_platform_device_count=8")
        import jax
        jax.config.update("jax_platforms", "cpu")
    import jax
    import numpy as np
    from essentials_tpu.formats import Csr
    from essentials_tpu.io import generate
    from essentials_tpu.parallel import make_mesh
    from essentials_tpu.parallel.partition import partition_graph
    from essentials_tpu.parallel.distributed import dist_pagerank

    max_p = jax.device_count()
    sizes = [p for p in (1, 2, 4, 8, 16, 32) if p <= max_p]
    results = []
    base_rate = None
    for nd in sizes:
        scale = args.scale + (int(np.log2(nd)) if args.weak else 0)
        coo = generate.rmat(scale, 16, seed=1, undirected=True, weighted=False)
        csr = Csr.from_coo(coo)
        dg = partition_graph(csr, nd)
        mesh = make_mesh(nd)
        # compile + warm
        r = dist_pagerank(dg, mesh, max_iterations=args.iters)
        jax.block_until_ready(r)
        t0 = time.perf_counter()
        r = dist_pagerank(dg, mesh, max_iterations=args.iters)
        _ = float(r.sum())   # force through lazy runtimes
        dt = time.perf_counter() - t0
        edges_per_s = csr.nnz * args.iters / dt
        if base_rate is None:
            base_rate = edges_per_s / (csr.nnz if args.weak else 1)
        eff = (edges_per_s / (csr.nnz if args.weak else 1)) / base_rate / \
            (nd if not args.weak else 1)
        if args.weak:
            eff = (edges_per_s / csr.nnz) / base_rate
        results.append({"devices": nd, "edges": csr.nnz,
                        "edges_per_s": round(edges_per_s),
                        "efficiency": round(eff, 3)})
        print(f"P={nd}: E={csr.nnz} {edges_per_s/1e6:.1f}M edges/s "
              f"eff={eff:.2f}")
    print(json.dumps(results))
    return 0


if __name__ == "__main__":
    sys.exit(main())
