"""SpGEMM benchmark: the swin-transformer pruned-attention .smtx matrix
(reference dataset: datasets/layers.0.blocks.0.attn.proj_swin_tiny_
unstructured_50.smtx) — C = A @ A^T with the structure-static plan.

Reports symbolic (plan) time once, then numeric-phase ms + effective GB/s
across repeated value sets (the plan is value-independent). Falls back to
a generated 50%-unstructured-sparse matrix when the reference checkout is
absent.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

SWIN = ("/root/reference/datasets/"
        "layers.0.blocks.0.attn.proj_swin_tiny_unstructured_50.smtx")


def load_matrix():
    from essentials_tpu.formats import Csr
    if os.path.exists(SWIN):
        from essentials_tpu.io.smtx import load_smtx
        return load_smtx(SWIN), "swin_tiny_proj_50"
    rng = np.random.default_rng(0)
    n = 768
    mask = rng.random((n, n)) < 0.5
    rows, cols = np.nonzero(mask)
    off = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(rows, minlength=n), out=off[1:])
    return Csr(n, n, off, cols.astype(np.int32),
               rng.random(rows.shape[0]).astype(np.float32)), \
        "generated_unstructured_50"


def transpose_csr(a):
    from essentials_tpu.formats import Csr
    from essentials_tpu.formats.coo import Coo
    off = np.asarray(a.row_offsets, np.int64)
    rows = np.repeat(np.arange(a.n_rows), np.diff(off))
    return Csr.from_coo(Coo(a.n_cols, a.n_rows,
                            np.asarray(a.col_indices, np.int32), rows.astype(np.int32),
                            np.asarray(a.values, np.float32)))


def main():
    import jax
    import jax.numpy as jnp
    from essentials_tpu.algorithms import spgemm

    a, name = load_matrix()
    at = transpose_csr(a)
    t0 = time.perf_counter()
    plan = spgemm.make_plan(a, at)
    sym_s = time.perf_counter() - t0
    print(f"# {name}: A {a.n_rows}x{a.n_cols} nnz={a.nnz}; "
          f"products W={plan.n_products} c_nnz={plan.c_nnz}; "
          f"symbolic {sym_s:.2f}s", file=sys.stderr)

    av = jnp.asarray(np.asarray(a.values, np.float32))
    bv = jnp.asarray(np.asarray(at.values, np.float32))

    jax.block_until_ready(spgemm.numeric(plan, av, bv))    # compile
    cycles = []
    for _ in range(7):
        t1 = time.perf_counter()
        jax.block_until_ready(spgemm.numeric(plan, av, bv))
        cycles.append((time.perf_counter() - t1) * 1e3)
    med = float(np.median(cycles))
    # useful bytes: read both value arrays + write C values + the flop
    # inputs the products touch (one a-val + one b-val read per product)
    useful = plan.n_products * 8 + plan.c_nnz * 4
    print(json.dumps({
        "metric": f"spgemm_ms_{name}",
        "value": round(med, 3),
        "unit": "ms",
        "gbps_effective": round(useful / (med / 1e3) / 1e9, 2),
        "products": plan.n_products,
        "c_nnz": plan.c_nnz,
        "symbolic_s": round(sym_s, 2),
        "cycles_ms": [round(c, 3) for c in cycles],
    }))


if __name__ == "__main__":
    main()
