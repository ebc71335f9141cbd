"""Beyond-int32 SpGEMM capability run: product counts
past 2^31 run via int64 product accounting + the host-streamed numeric
mode (C never resides whole on chip).

Default: rmat19x16 A @ A (~2-3e10 products). Pass a gen: spec to change.
Validates a sample of C rows against the host Gustavson reference.

Usage: python benchmarks/spgemm_big.py [gen:rmat19x16] [--rows 4]
"""
import sys
import time

import numpy as np

sys.path.insert(0, ".")
from benchmarks.run_benchmarks import _load
from essentials_tpu.algorithms import spgemm


def main():
    spec = sys.argv[1] if len(sys.argv) > 1 else "gen:rmat19x16"
    csr, ds = _load(spec)
    a_off = np.asarray(csr.row_offsets, np.int64)
    a_cols = np.asarray(csr.col_indices, np.int64)
    products = int(np.diff(a_off)[a_cols].sum())
    print(f"{ds}: E={csr.nnz}  products={products:.3e} "
          f"(int32 max {np.iinfo(np.int32).max:.3e})", flush=True)

    t0 = time.perf_counter()
    plan = spgemm.make_chunked_plan(csr, csr,
                                    cache_dir="datasets/.plan_cache")
    t_sym = time.perf_counter() - t0
    print(f"symbolic: {t_sym:.0f}s  chunks={len(plan.chunks)}  "
          f"c_nnz={int(plan.c_row_offsets[-1])}  "
          f"splits={plan.merge_spans.shape[0]}", flush=True)

    t0 = time.perf_counter()
    vals = spgemm.numeric_chunked(plan, csr, csr, stream_to_host=True)
    t_num = time.perf_counter() - t0
    print(f"numeric (streamed): {t_num:.0f}s  "
          f"c_entries={vals.shape[0]}", flush=True)

    # validate a handful of rows against host Gustavson
    n_check = int(sys.argv[sys.argv.index("--rows") + 1]) \
        if "--rows" in sys.argv else 4
    rng = np.random.default_rng(0)
    deg = np.diff(a_off)
    rows = rng.choice(np.nonzero(deg > 0)[0], n_check, replace=False)
    av = np.asarray(csr.values, np.float64)
    c_off = np.asarray(plan.c_row_offsets, np.int64)
    ok = True
    for r in rows:
        acc = {}
        for e in range(a_off[r], a_off[r + 1]):
            k = a_cols[e]
            for f in range(a_off[k], a_off[k + 1]):
                j = int(a_cols[f])
                acc[j] = acc.get(j, 0.0) + av[e] * av[f]
        cols_ref = np.array(sorted(acc), np.int64)
        got_cols = np.asarray(plan.c_col_indices[c_off[r]:c_off[r + 1]],
                              np.int64)
        got_vals = vals[c_off[r]:c_off[r + 1]]
        if not np.array_equal(cols_ref, got_cols):
            print(f"row {r}: STRUCTURE MISMATCH"); ok = False; continue
        ref_vals = np.array([acc[int(j)] for j in cols_ref])
        if not np.allclose(got_vals, ref_vals, rtol=1e-3, atol=1e-4):
            print(f"row {r}: VALUE MISMATCH"); ok = False
    print(f"validation ({n_check} sampled rows): "
          f"{'OK' if ok else 'FAILED'}", flush=True)
    import json
    print(json.dumps({"dataset": ds, "products": products,
                      "symbolic_s": round(t_sym, 1),
                      "numeric_s": round(t_num, 1),
                      "c_nnz": int(plan.c_row_offsets[-1]),
                      "validated_rows": n_check, "ok": ok}))


if __name__ == "__main__":
    main()
