"""Distributed-mode evidence on the virtual 8-device CPU mesh.

Runs dist BFS / SSSP / PageRank in BOTH exchange modes (all_gather vs
boundary all_to_all) at rmat16/rmat18 scale, logging:
  * comm_values_per_step — the per-device per-superstep exchange volume
    each mode implies (the quantity that crosses the interconnect);
  * measured per-superstep wall time on the virtual mesh (CPU code-path
    artifact — useful only for relative mode comparison, labeled as such);
  * output parity vs the single-device algorithms.

`python3 chip_smoke.py --multi` runs the same shard_map programs on four
GPUs.

Usage: python benchmarks/dist_bench.py [--out results_dist_r3.json]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

os.environ.setdefault("XLA_FLAGS",
                      "--xla_force_host_platform_device_count=8")

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np
import jax.numpy as jnp
from jax.sharding import Mesh


def bench(spec: str, scale: int, ef: int) -> list[dict]:
    from essentials_tpu.formats import Csr
    from essentials_tpu.io import generate
    from essentials_tpu.graph import build_graph
    from essentials_tpu.parallel.partition import partition_graph
    from essentials_tpu.parallel import distributed as D
    from essentials_tpu.algorithms import bfs, sssp, pr

    coo = generate.rmat(scale, ef, seed=1, undirected=True, weighted=True)
    csr = Csr.from_coo(coo)
    g = build_graph(csr, directed=False, weighted=True)
    src = int(np.argmax(np.diff(np.asarray(csr.row_offsets))))
    devices = np.array(jax.devices()[:8])
    mesh = Mesh(devices, (D.AXIS,))

    # single-device references
    ref_bfs = bfs.cpu_reference(csr, src)
    ref_sssp = sssp.cpu_reference(csr, src)
    # dist_pagerank spreads UNWEIGHTED contributions (p / out_degree);
    # reference must use the unweighted graph for iweights = alpha/deg
    g_unw = build_graph(csr, directed=False, weighted=False)
    ref_pr = np.asarray(pr.run(g_unw, warmup=False).ranks)

    out = []
    for mode in ("all_gather", "boundary"):
        for overlap in (False, True):
            dg = partition_graph(csr, 8, exchange=mode, overlap=overlap)
            rec = {"dataset": spec, "mode": mode, "n_devices": 8,
                   "overlap": overlap,
                   "comm_values_per_step": dg.comm_values_per_step,
                   "comm_reduction_vs_all_gather": round(
                       dg.n_vertices_global /
                       max(dg.comm_values_per_step, 1), 2),
                   # interconnect model: bytes leaving each device per superstep
                   # (4 B values; boundary mode exchanges P*Smax slots,
                   # all_gather ships the (P-1)/P remote share of Vtot).
                   # docs/distributed.md turns this into the weak-scaling
                   # projection.
                   "link_bytes_per_superstep_model": 4 * (
                       dg.comm_values_per_step if dg.boundary_size
                       else dg.n_vertices_global * 7 // 8),
                   "boundary_smax": dg.boundary_size,
                   "edges_per_device": dg.edges_per_device}
            out.append(_run_one(dg, mesh, src, csr, ref_bfs, ref_sssp,
                                ref_pr, rec, overlap))
    return out


def _run_one(dg, mesh, src, csr, ref_bfs, ref_sssp, ref_pr, rec, overlap):
    from essentials_tpu.parallel import distributed as D

    t0 = time.perf_counter()
    d = D.dist_bfs(dg, mesh, src, overlap=overlap)
    d = np.asarray(d)[:csr.n_rows]
    ok_bfs = bool(np.array_equal(d, ref_bfs))
    t_bfs = time.perf_counter() - t0
    it_bfs = int(d[np.isfinite(d.astype(np.float64)) &
                   (d < 2**31 - 1)].max()) if ok_bfs else -1

    t0 = time.perf_counter()
    ds = np.asarray(D.dist_sssp(dg, mesh, src,
                                overlap=overlap))[:csr.n_rows]
    fin = np.isfinite(ref_sssp)
    ok_sssp = bool(np.array_equal(np.isfinite(ds), fin) and
                   np.allclose(ds[fin], ref_sssp[fin], rtol=1e-5,
                               atol=1e-5))
    t_sssp = time.perf_counter() - t0

    t0 = time.perf_counter()
    dp = np.asarray(D.dist_pagerank(dg, mesh,
                                    overlap=overlap))[:csr.n_rows]
    ok_pr = bool(np.allclose(dp, ref_pr, rtol=1e-3, atol=1e-7))
    t_pr = time.perf_counter() - t0

    rec.update({
        "bfs": {"ok": ok_bfs, "wall_s": round(t_bfs, 2),
                "depth": it_bfs,
                "ms_per_superstep_cpu_artifact": round(
                    t_bfs * 1e3 / max(it_bfs, 1), 1)},
        "sssp": {"ok": ok_sssp, "wall_s": round(t_sssp, 2)},
        "pr": {"ok": ok_pr, "wall_s": round(t_pr, 2)},
    })
    print(json.dumps(rec), flush=True)
    return rec


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--out", default=None)
    p.add_argument("--scale", type=int, default=16)
    args = p.parse_args(argv)
    res = bench(f"rmat{args.scale}x16", args.scale, 16)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
        print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
