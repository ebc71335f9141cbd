"""Flagship benchmark: BFS MTEPS on an RMAT power-law graph.

Prints ONE JSON line: {"metric", "value", "unit", "device", ...}.

Methodology: BFS (init + while_loop to convergence) from RUNS distinct
high-degree sources; each run is timed on the host clock around work that
ends in `jax.block_until_ready`, after one warm-up run that compiles. MTEPS
= E / median run time. A second metric, SpMV GB/s (12 B per edge: value +
column + x-gather), rides along. Roofline shares divide by the device's
peak from essentials_tpu.runtime's table and are omitted on a device
without one (the CPU).
"""

from __future__ import annotations

import json
import time

SCALE = 18
EDGE_FACTOR = 16
RUNS = 16


def _median_ms(fn, reps):
    import numpy as np
    import jax
    ts = []
    for i in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(i))
        ts.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(ts)), ts


def main():
    import jax
    import jax.numpy as jnp
    import numpy as np
    from essentials_tpu import runtime
    from essentials_tpu.formats import Csr
    from essentials_tpu.graph import build_graph
    from essentials_tpu.io import generate
    from essentials_tpu.algorithms import bfs, spmv

    dev = jax.devices()[0]
    props = runtime.device_properties(dev)
    coo = generate.rmat(SCALE, EDGE_FACTOR, seed=1, undirected=True,
                        weighted=False)
    csr = Csr.from_coo(coo)
    g = build_graph(csr, directed=False, weighted=False)
    sources = np.argsort(-np.diff(csr.row_offsets))[:RUNS].astype(np.int32)

    bfs.run(g, int(sources[0]), compute_predecessors=False)   # compile
    med_ms, cycles = _median_ms(
        lambda i: bfs.run(g, int(sources[i]), warmup=False,
                          compute_predecessors=False).distances, RUNS)
    mteps = (g.n_edges / 1e6) / (med_ms / 1e3)

    coo_w = generate.rmat(SCALE, EDGE_FACTOR, seed=3, undirected=False,
                          weighted=True)
    gw = build_graph(Csr.from_coo(coo_w), directed=True, weighted=True)
    x = jax.random.uniform(jax.random.PRNGKey(0), (gw.n_vertices_padded,),
                           jnp.float32)
    jax.block_until_ready(spmv.spmv_pull(gw, x))
    spmv_ms, _ = _median_ms(lambda i: spmv.spmv_pull(gw, x), 9)
    spmv_gbps = gw.n_edges * 12.0 / (spmv_ms * 1e-3) / 1e9

    out = {
        "metric": f"bfs_mteps_rmat{SCALE}ef{EDGE_FACTOR}",
        "value": round(mteps, 2),
        "unit": "MTEPS",
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "cycles_ms": [round(c, 3) for c in cycles],
        "spmv_ms": round(spmv_ms, 3),
        "spmv_gbps": round(spmv_gbps, 1),
    }
    if props.hbm_gbps:
        out["spmv_pct_hbm_roofline"] = round(spmv_gbps / props.hbm_gbps, 4)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
