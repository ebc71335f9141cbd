"""SpGEMM: C = A @ B, both sparse CSR.

Reference parity: gunrock::spgemm (/root/reference/include/gunrock/
algorithms/spgemm.hxx:116-240): Gustavson with an upper-bound nnz
pre-allocation on device, numeric phase, then fix-up compaction (and a
noted WIP bug at :178 — this implementation is correct).

Two-phase design:

* SYMBOLIC phase (host, once per (A, B) *structure*): the Gustavson product
  expansion — one slot per (A(i,k), B(k,j)) pair — and C's sparsity
  pattern are structure-static. They are compiled into an ``SpgemmPlan``:
  per product slot, in (row, col)-sorted order, the A edge id, the B edge
  id and the C position.

* NUMERIC phase (device, reusable across value sets): gather
  ``a_vals[a_eid]`` and ``b_vals[b_eid]``, multiply, and sum by C position
  with a sorted segment reduction. This exceeds the reference, whose
  device sizing pass still reruns per multiply.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from essentials_tpu.formats.csr import Csr
from essentials_tpu.errors import throw_if
from essentials_tpu.ops.scan_kernels import cumsum, segmented_scan
from essentials_tpu.utils.timer import Timer


class SpgemmResult(NamedTuple):
    c: Csr
    elapsed_ms: float


_SLOT_PAD = 1024              # product slots pad to a multiple of this


@partial(jax.tree_util.register_dataclass,
         data_fields=["a_eid", "b_eid", "c_pos", "c_row_offsets",
                      "c_col_indices"],
         meta_fields=["W", "n_products", "c_nnz"])
@dataclass(frozen=True)
class SpgemmPlan:
    """Structure-static Gustavson layout (reusable across value sets).
    Product slots are in (row, col) order, so ``c_pos`` is sorted; pad
    slots point at A/B edge ``nnz`` (a zero value) and at C position
    ``c_nnz`` (dropped)."""
    W: int                    # padded product-slot count
    n_products: int           # real product slots
    c_nnz: int                # unique (row, col) pairs in C
    c_row_offsets: jax.Array  # [n_rows+1] int32: C's row offsets
    c_col_indices: jax.Array  # [c_nnz] int32: C's column indices
    a_eid: jax.Array          # [W] int32: A edge of each product slot
    b_eid: jax.Array          # [W] int32: B edge of each product slot
    c_pos: jax.Array          # [W] int32: C entry each slot sums into


def make_plan(a: Csr, b: Csr) -> SpgemmPlan | None:
    """Symbolic phase. Returns None for an empty product."""
    throw_if(a.n_cols != b.n_rows, "spgemm: inner dimensions disagree")
    a_cols = np.asarray(a.col_indices, np.int64)
    b_off = np.asarray(b.row_offsets, np.int64)
    b_cols = np.asarray(b.col_indices, np.int64)
    a_src = np.repeat(np.arange(a.n_rows, dtype=np.int64),
                      np.diff(np.asarray(a.row_offsets, np.int64)))

    per_edge = np.diff(b_off)[a_cols]                 # products per A edge
    n_products = int(per_edge.sum())
    if n_products == 0:
        return None
    W = -(-n_products // _SLOT_PAD) * _SLOT_PAD

    wc = np.zeros(a.nnz + 1, np.int64)
    np.cumsum(per_edge, out=wc[1:])
    a_eid = np.repeat(np.arange(a.nnz, dtype=np.int64), per_edge)
    k_in_b = np.arange(n_products) - wc[a_eid]
    b_eid = b_off[a_cols[a_eid]] + k_in_b

    rows = a_src[a_eid]
    cols = b_cols[b_eid]
    key_order = np.lexsort((cols, rows))
    sr, sc = rows[key_order], cols[key_order]
    newseg = np.ones(n_products, bool)
    newseg[1:] = (sr[1:] != sr[:-1]) | (sc[1:] != sc[:-1])
    seg_starts = np.nonzero(newseg)[0]
    c_nnz = seg_starts.shape[0]

    def slots(x, pad):
        out = np.full(W, pad, np.int32)
        out[:n_products] = x
        return out

    u_rows = sr[seg_starts]
    u_cols = sc[seg_starts].astype(np.int32)
    c_row_off = np.zeros(a.n_rows + 1, np.int64)
    np.cumsum(np.bincount(u_rows, minlength=a.n_rows), out=c_row_off[1:])

    return SpgemmPlan(
        W=W, n_products=n_products, c_nnz=c_nnz,
        c_row_offsets=c_row_off.astype(np.int32),
        c_col_indices=u_cols,
        a_eid=slots(a_eid[key_order], a.nnz),
        b_eid=slots(b_eid[key_order], b.nnz),
        c_pos=slots(np.cumsum(newseg) - 1, c_nnz))


@jax.jit
def numeric(plan: SpgemmPlan, a_vals: jax.Array, b_vals: jax.Array
            ) -> jax.Array:
    """Device numeric phase: C values for the plan's static structure."""
    av = jnp.pad(a_vals.astype(jnp.float32), (0, 1))      # pad edge = 0
    bv = jnp.pad(b_vals.astype(jnp.float32), (0, 1))
    prod = av[plan.a_eid] * bv[plan.b_eid]
    sums = jax.ops.segment_sum(prod, plan.c_pos,
                               num_segments=plan.c_nnz + 1,
                               indices_are_sorted=True)
    return sums[:plan.c_nnz]


def run(a: Csr, b: Csr, *, warmup: bool = True,
        plan: SpgemmPlan | None = None) -> SpgemmResult:
    if plan is None:
        plan = make_plan(a, b)
    if plan is None:                                      # empty product
        return SpgemmResult(Csr(a.n_rows, b.n_cols,
                                np.zeros(a.n_rows + 1, np.int32),
                                np.empty(0, np.int32),
                                np.empty(0, np.float32)), 0.0)
    av = jnp.asarray(np.asarray(a.values, np.float32))
    bv = jnp.asarray(np.asarray(b.values, np.float32))
    if warmup:
        jax.block_until_ready(numeric(plan, av, bv))
    t = Timer().begin()
    vals = numeric(plan, av, bv)
    ms = t.end(sync=vals)
    return SpgemmResult(Csr(a.n_rows, b.n_cols,
                            np.asarray(plan.c_row_offsets),
                            np.asarray(plan.c_col_indices),
                            np.asarray(vals, np.float32)), ms)


# ------------------------------------------------------------------ #
# chunked numeric phase: product counts beyond what a single static plan
# can carry (the plan costs 12 B per product slot — 1.2e9 products would
# need ~14 GB of slot indices). The chunked path ships NO per-product
# static data at all: the product axis is tiled into fixed-shape chunks
# and each chunk's expansion / key grouping runs with DEVICE sorts, whose
# cost is O(chunk) with zero plan bytes. One jitted chunk program (static
# shapes) serves every chunk.
#
# Per chunk, entirely on device:
#   1. telescoping expansion of a_vals / row / B-row-start over the
#      chunk's A-edge offsets (one small scatter + cumsum)
#   2. b_vals/b_cols gather by b_eid (the reference's per-thread B-row
#      walk, spgemm.hxx:116-175)
#   3. key sort by (row, col) + segmented f32 sum
#   4. compaction of per-segment totals by unique-key rank (one
#      scatter) -> window write into the global C-values buffer
#      (overlapping fixed windows, ascending offsets: garbage tails
#      are overwritten by later chunks)
#
# The host symbolic phase is streamed in O(chunk) memory and computes
# C's exact structure plus a duplicate-merge map for (row,col) segments
# split across chunk boundaries.


@dataclass(frozen=True)
class ChunkedPlan:
    n_products: int
    Wc: int                     # product slots per chunk (static shape)
    Ecap: int                   # A-edge capacity per chunk (static shape)
    chunks: tuple               # ((e0, p0, npc, c_base), ...)
    c_dev_total: int            # device-layout entries (pre-merge, w/ dups)
    merge_spans: np.ndarray     # [K, 3] (s, t, n_runs): junction spans
    merge_order: np.ndarray     # concatenated span-LOCAL stable argsorts
    merge_offsets: np.ndarray   # concatenated span-LOCAL run starts
    c_row_offsets: np.ndarray   # final C structure (post-merge)
    c_col_indices: np.ndarray


def _chunked_plan_cache_key(a: Csr, b: Csr, chunk_products, chunk_edges):
    """Content hash of the STRUCTURES (values don't matter)."""
    import hashlib
    h = hashlib.sha256()
    for arr in (a.row_offsets, a.col_indices, b.row_offsets,
                b.col_indices):
        h.update(np.ascontiguousarray(np.asarray(arr, np.int64)).tobytes())
    h.update(np.int64([a.n_rows, a.n_cols, b.n_rows, b.n_cols,
                       chunk_products, chunk_edges]).tobytes())
    return h.hexdigest()[:24]


def make_chunked_plan(a: Csr, b: Csr, *, chunk_products: int = 1 << 26,
                      chunk_edges: int = 1 << 23,
                      cache_dir: str | None = None) -> ChunkedPlan | None:
    """Streamed symbolic phase: chunk boundaries + exact C structure,
    O(chunk) peak memory.

    The phase is host-compute-heavy but structure-static: pass
    ``cache_dir`` (or set
    ESSENTIALS_TPU_PLAN_CACHE) to persist/reuse it as one .npz keyed by
    a content hash of both sparsity patterns."""
    import os
    cache_dir = cache_dir or os.environ.get("ESSENTIALS_TPU_PLAN_CACHE")
    cpath = None
    if cache_dir:
        key = _chunked_plan_cache_key(a, b, chunk_products, chunk_edges)
        cpath = os.path.join(cache_dir, f"spgemm_chunked_v2_{key}.npz")
        if os.path.exists(cpath):
            z = np.load(cpath)
            return ChunkedPlan(
                n_products=int(z["n_products"]), Wc=int(z["Wc"]),
                Ecap=int(z["Ecap"]),
                chunks=tuple(map(tuple, z["chunks"].tolist())),
                c_dev_total=int(z["c_dev_total"]),
                merge_spans=z["merge_spans"],
                merge_order=z["merge_order"],
                merge_offsets=z["merge_offsets"],
                c_row_offsets=z["c_row_offsets"],
                c_col_indices=z["c_col_indices"])
    plan = _make_chunked_plan_impl(a, b, chunk_products, chunk_edges)
    if plan is not None and cpath:
        os.makedirs(cache_dir, exist_ok=True)
        tmp = cpath + ".tmp.npz"
        with open(tmp, "wb") as f:
            np.savez(f, n_products=plan.n_products, Wc=plan.Wc,
                     Ecap=plan.Ecap,
                     chunks=np.asarray(plan.chunks, np.int64),
                     c_dev_total=plan.c_dev_total,
                     merge_spans=plan.merge_spans,
                     merge_order=plan.merge_order,
                     merge_offsets=plan.merge_offsets,
                     c_row_offsets=plan.c_row_offsets,
                     c_col_indices=plan.c_col_indices)
        os.replace(tmp, cpath)
    return plan


def _chunk_unique_host(wc, per_edge, a_src, a_cols, b_off, b_cols, e0, e1,
                       p0, npc):
    """Host per-chunk sorted-unique (row, col) keys. Allocation-lean:
    np.repeat of per-edge bases instead of chunk-sized gathers."""
    pe = per_edge[e0:e1]
    k = np.arange(npc, dtype=np.int64)
    k -= np.repeat(wc[e0:e1] - p0, pe)            # in-edge position
    b_eid = np.repeat(b_off[a_cols[e0:e1]], pe)
    b_eid += k
    key = np.repeat(a_src[e0:e1].astype(np.uint64) << np.uint64(32), pe)
    key |= b_cols[b_eid].astype(np.uint64)
    key.sort()
    ukey = key[np.concatenate([[True], key[1:] != key[:-1]])]
    return ((ukey >> np.uint64(32)).astype(np.int64),
            (ukey & np.uint64(0xffffffff)).astype(np.int64))


@partial(jax.jit, static_argnames=("Wc", "nrows"))
def _chunk_symbolic_dev(wcs, r_sl, bs_sl, b_colsd, npc, *, Wc: int,
                        nrows: int):
    """Device per-chunk symbolic: same expansion + (row, col) sort as
    the numeric chunk, then unique-compaction. Inputs are HOST-SLICED per
    chunk (in-chunk product offsets already rebased and
    clipped to int32 — the int64 global product space never reaches the
    device). Returns (ucols int32[Wc], row histogram int32[nrows],
    count)."""
    nb = b_colsd.shape[0] - 1
    imax = jnp.iinfo(jnp.int32).max
    offs = wcs                                           # int32 [Ecap+1]

    def expand(vals):
        d = jnp.diff(vals, prepend=jnp.zeros(1, jnp.int32))
        z = jnp.zeros(Wc + 1, jnp.int32).at[offs[:-1]].add(d)
        return cumsum(z[:Wc])

    row = expand(r_sl)
    s = jnp.arange(Wc, dtype=jnp.int32)
    valid = s < npc
    bstart_e = expand(bs_sl)
    estart_e = expand(offs[:-1])
    b_eid = jnp.where(valid, bstart_e + (s - estart_e), nb)
    col = b_colsd[b_eid]
    rowk = jnp.where(valid, row, imax)
    colk = jnp.where(valid, col, imax)
    r3, c3 = jax.lax.sort((rowk, colk), num_keys=2)
    real = r3 != imax
    flags = jnp.concatenate([
        jnp.ones(1, jnp.bool_),
        (r3[1:] != r3[:-1]) | (c3[1:] != c3[:-1])]) & real
    rank = cumsum(flags.astype(jnp.int32)) - 1
    idx = jnp.where(flags, rank, Wc)
    ucols = jnp.zeros(Wc, jnp.int32).at[idx].set(c3, mode="drop")
    # rows travel back as a [nrows] histogram instead of a [Wc] row list;
    # the host rebuilds the sorted row list with np.repeat
    uhist = jnp.zeros(nrows + 1, jnp.int32).at[
        jnp.where(flags, r3, nrows)].add(1, mode="drop")
    return ucols, uhist[:nrows], jnp.sum(flags.astype(jnp.int32))


def _harvest_symbolic(handles, Wc):
    """Fetch a device symbolic chunk: cols via a QUANTIZED-shape slice
    (bounded distinct shapes -> bounded slice-program compiles), rows
    rebuilt from the histogram with np.repeat."""
    uc_d, hist_d, cnt_d = handles
    cnt = int(cnt_d)
    hist = np.asarray(hist_d)
    b = min(Wc, -(-max(cnt, 1) // (1 << 20)) * (1 << 20))
    uc = np.asarray(uc_d[:b])[:cnt]
    ur = np.repeat(np.arange(hist.shape[0], dtype=np.int32), hist)
    return ur, uc


def _make_chunked_plan_impl(a: Csr, b: Csr, chunk_products: int,
                            chunk_edges: int) -> ChunkedPlan | None:
    throw_if(a.n_cols != b.n_rows, "spgemm: inner dimensions disagree")
    a_cols = np.asarray(a.col_indices, np.int64)
    b_off = np.asarray(b.row_offsets, np.int64)
    b_cols = np.asarray(b.col_indices, np.int64)
    a_off = np.asarray(a.row_offsets, np.int64)
    a_src = np.repeat(np.arange(a.n_rows, dtype=np.int64), np.diff(a_off))

    per_edge = np.diff(b_off)[a_cols]
    wc = np.zeros(a.nnz + 1, np.int64)
    np.cumsum(per_edge, out=wc[1:])
    n_products = int(wc[-1])
    if n_products == 0:
        return None
    # int64 product accounting: per-chunk npc <= Wc keeps all DEVICE
    # indices int32; only the global offsets (p0, c_base) are int64.
    Wc = int(chunk_products)
    Ecap = int(min(chunk_edges, a.nnz))

    # device symbolic pays off only for big products
    use_dev = n_products >= (1 << 23)
    dev_arrs = None

    chunks = []
    rows_l, cols_l = [], []
    spans = []
    split_junctions = []          # chunk-list indices k where chunk k-1
    c_base = 0                    # and chunk k share a (split) row
    e0 = 0
    prev_cut_mid_row = False
    while e0 < a.nnz:
        p0 = int(wc[e0])
        # largest e1 with products <= Wc and edges <= Ecap ...
        e_hi = min(a.nnz, e0 + Ecap)
        e1 = int(np.searchsorted(wc, p0 + Wc, side="right")) - 1
        e1 = max(min(e1, e_hi), e0 + 1)      # always progress
        # ... snapped DOWN to an A-row boundary when possible, so
        # (row, col) duplicates never span chunks and the global merge
        # below is (near-)identity instead of a 10^8-scale stable
        # argsort. Mega rows (> Wc products in one row) still split.
        r1 = int(np.searchsorted(a_off, e1, side="right")) - 1
        if a_off[r1] > e0:
            e1 = int(a_off[r1])
            cut_mid_row = e1 != int(a_off[int(np.searchsorted(
                a_off, e1, side="right")) - 1])
        else:
            cut_mid_row = e1 != a.nnz and e1 != int(a_off[r1])
        npc = int(wc[e1] - p0)
        throw_if(npc > Wc, "spgemm: single A edge exceeds chunk_products; "
                           "raise chunk_products")
        if npc > 0:
            if use_dev and npc >= (1 << 20):
                if dev_arrs is None:
                    b_start_h = b_off[a_cols].astype(np.int32)
                    dev_arrs = (jnp.asarray(np.pad(
                        b_cols.astype(np.int32), (0, 1))),)
                Ec = Ecap
                wcs_h = np.minimum(
                    np.pad(wc[e0:min(e0 + Ec + 1, a.nnz + 1)] - p0,
                           (0, max(0, e0 + Ec + 1 - (a.nnz + 1))),
                           mode="edge"),
                    Wc).astype(np.int32)
                r_h = np.pad(a_src[e0:e0 + Ec].astype(np.int32),
                             (0, max(0, e0 + Ec - a.nnz)))
                bs_h = np.pad(b_start_h[e0:e0 + Ec],
                              (0, max(0, e0 + Ec - a.nnz)))
                handles = _chunk_symbolic_dev(
                    jnp.asarray(wcs_h), jnp.asarray(r_h),
                    jnp.asarray(bs_h), dev_arrs[0], jnp.int32(npc),
                    Wc=Wc, nrows=a.n_rows)
                # pipeline: harvest the PREVIOUS chunk while this one
                # computes
                rows_l.append(None)
                cols_l.append(handles)
                if len(chunks) >= 1 and cols_l[-2] is not None \
                        and rows_l[-2] is None:
                    rows_l[-2], cols_l[-2] = _harvest_symbolic(
                        cols_l[-2], Wc)
            else:
                ur, uc = _chunk_unique_host(
                    wc, per_edge, a_src, a_cols, b_off, b_cols, e0, e1,
                    p0, npc)
                rows_l.append(ur.astype(np.int32))
                cols_l.append(uc.astype(np.int32))
            if prev_cut_mid_row:
                split_junctions.append(len(chunks))
            chunks.append((e0, p0, npc, None))
            spans.append(e1 - e0)
            prev_cut_mid_row = cut_mid_row
        e0 = e1

    # harvest any still-pending device chunks, then fill in c_base
    for i in range(len(chunks)):
        if rows_l[i] is None:
            rows_l[i], cols_l[i] = _harvest_symbolic(cols_l[i], Wc)
    c_base = 0
    for i in range(len(chunks)):
        e0_, p0_, npc_, _ = chunks[i]
        chunks[i] = (e0_, p0_, npc_, c_base)
        c_base += rows_l[i].shape[0]

    # shrink the static edge capacity to the largest chunk actually built
    # (the scatter in the device expansion costs per padded element)
    Ecap = max(spans) if spans else 1

    c_dev_total = int(sum(r.shape[0] for r in rows_l))
    # merge map: with row-aligned cuts the concatenated per-chunk unique
    # lists are already globally sorted AND duplicate-free EXCEPT around
    # split-row junctions, where the shared row's column lists
    # interleave — per-junction LOCAL argsorts + fold runs replace the
    # former global stable argsort and full keep/gather passes over the
    # whole O(c_dev) host tail.
    starts = np.array([c[3] for c in chunks] + [c_dev_total], np.int64)
    intervals = []
    for k in split_junctions:
        rr = int(rows_l[k][0])               # the shared row id
        lo_k = k
        while lo_k > 0 and rows_l[lo_k - 1].size \
                and int(rows_l[lo_k - 1][-1]) == rr:
            lo_k -= 1
        s = int(starts[lo_k]) + int(np.searchsorted(rows_l[lo_k], rr,
                                                    side="left"))
        t = int(starts[k]) + int(np.searchsorted(rows_l[k], rr,
                                                 side="right"))
        intervals.append((s, t))
    # merge overlapping intervals (a mega row spanning 3+ chunks
    # produces overlapping junction intervals)
    merged_iv = []
    for s, t in sorted(intervals):
        if merged_iv and s <= merged_iv[-1][1]:
            merged_iv[-1] = [merged_iv[-1][0], max(merged_iv[-1][1], t)]
        else:
            merged_iv.append([s, t])

    # per-chunk row histogram (chunks own disjoint rows up to the span
    # duplicates corrected below) — avoids a c_dev-sized bincount pass
    row_counts = np.zeros(a.n_rows, np.int64)
    for (e0, p0, npc, cb), ur in zip(chunks, rows_l):
        row_counts += np.bincount(ur, minlength=a.n_rows)

    dev_cols_all = np.concatenate(cols_l) if cols_l \
        else np.empty(0, np.int64)
    dev_rows_all = None
    spans_meta, perms, local_offs, col_pieces = [], [], [], []
    pos = 0
    for s, t in merged_iv:
        if dev_rows_all is None:
            dev_rows_all = np.concatenate(rows_l)
        rr_s = dev_rows_all[s:t]
        cc_s = dev_cols_all[s:t]
        kk = (rr_s.astype(np.uint64) << np.uint64(32)) | \
            cc_s.astype(np.uint64)
        p = np.argsort(kk, kind="stable")
        ks = kk[p]
        keep = np.ones(t - s, bool)
        keep[1:] = ks[1:] != ks[:-1]
        runs = np.nonzero(keep)[0]
        spans_meta.append((s, t, runs.shape[0]))
        perms.append(p)
        local_offs.append(runs)
        # folded duplicates all belong to the span's shared rows
        dup_rows = rr_s[p][~keep]
        if dup_rows.size:
            row_counts -= np.bincount(dup_rows, minlength=a.n_rows)
        col_pieces.append((pos, s))           # identity piece
        col_pieces.append((cc_s[p][keep],))   # folded span piece
        pos = t
    merge_spans = np.asarray(spans_meta, np.int64).reshape(-1, 3)
    merge_order = (np.concatenate(perms).astype(np.int64) if perms
                   else np.empty(0, np.int64))
    merge_offsets = (np.concatenate(local_offs).astype(np.int64)
                     if local_offs else np.empty(0, np.int64))
    if col_pieces:
        col_pieces.append((pos, c_dev_total))
        parts = []
        for pc in col_pieces:
            if len(pc) == 2:                  # identity slice
                parts.append(dev_cols_all[pc[0]:pc[1]])
            else:                             # folded span piece
                parts.append(pc[0])
        u_cols = np.concatenate(parts).astype(np.int32)
    else:
        u_cols = dev_cols_all.astype(np.int32) \
            if dev_cols_all.dtype != np.int32 else dev_cols_all
    c_row_off = np.zeros(a.n_rows + 1, np.int64)
    np.cumsum(row_counts, out=c_row_off[1:])
    if c_dev_total <= np.iinfo(np.int32).max:
        c_row_off = c_row_off.astype(np.int32)
    return ChunkedPlan(
        n_products=n_products, Wc=Wc, Ecap=Ecap, chunks=tuple(chunks),
        c_dev_total=c_dev_total, merge_spans=merge_spans,
        merge_order=merge_order, merge_offsets=merge_offsets,
        c_row_offsets=c_row_off, c_col_indices=u_cols)


def _chunk_core(wcs, a_sl, r_sl, bs_sl, b_bits, b_colsd, npc, Wc):
    """One chunk: expansion + b-gather + key sort + segmented sum +
    unique-rank compaction. Inputs are HOST-SLICED per chunk (in-chunk
    product offsets rebased + clipped to int32, so the int64 global
    product space never reaches the device). Returns csum f32[Wc]."""

    nb = b_bits.shape[0] - 1             # last slot = pad sentinel
    imax = jnp.iinfo(jnp.int32).max
    offs = wcs                                               # [Ecap+1]

    def expand(vals):                                        # int32 [Ecap]
        d = jnp.diff(vals, prepend=jnp.zeros(1, jnp.int32))
        z = jnp.zeros(Wc + 1, jnp.int32).at[offs[:-1]].add(d)
        return cumsum(z[:Wc])

    a_e = expand(a_sl)
    row = expand(r_sl)
    s = jnp.arange(Wc, dtype=jnp.int32)
    valid = s < npc
    # b values/cols by b-edge id: direct gather
    bstart_e = expand(bs_sl)
    estart_e = expand(offs[:-1])
    b_eid = jnp.where(valid, bstart_e + (s - estart_e), nb)
    bv_e = b_bits[b_eid]
    col = b_colsd[b_eid]

    prod = jax.lax.bitcast_convert_type(a_e, jnp.float32) * \
        jax.lax.bitcast_convert_type(bv_e, jnp.float32)
    prod = jnp.where(valid, prod, 0.0)
    rowk = jnp.where(valid, row, imax)
    colk = jnp.where(valid, col, imax)

    r3, c3, p3 = jax.lax.sort(
        (rowk, colk, jax.lax.bitcast_convert_type(prod, jnp.int32)),
        num_keys=2)
    pf = jax.lax.bitcast_convert_type(p3, jnp.float32)
    flags = jnp.concatenate([
        jnp.ones(1, jnp.bool_),
        (r3[1:] != r3[:-1]) | (c3[1:] != c3[:-1])])
    sums = segmented_scan(pf, flags, "add")
    endf = jnp.concatenate([flags[1:], jnp.ones(1, jnp.bool_)])
    segid = cumsum(flags.astype(jnp.int32)) - 1
    # compaction by unique-key rank: one scatter (indices are unique;
    # invalid tail drops via mode="drop") instead of a third sort
    ckey = jnp.where(endf & (s < npc), segid, Wc)
    return jnp.zeros(Wc, jnp.float32).at[ckey].set(sums, mode="drop")


@partial(jax.jit, static_argnames=("Wc",), donate_argnums=(8,))
def _chunk_numeric(wcs, a_sl, r_sl, bs_sl, b_bits, b_colsd, npc, c_base,
                   cvals, *, Wc: int):
    """Resident-buffer mode: window write into the device cvals."""
    csum = _chunk_core(wcs, a_sl, r_sl, bs_sl, b_bits, b_colsd, npc, Wc)
    return jax.lax.dynamic_update_slice(cvals, csum, (c_base,))


@partial(jax.jit, static_argnames=("Wc",))
def _chunk_numeric_stream(wcs, a_sl, r_sl, bs_sl, b_bits, b_colsd, npc,
                          *, Wc: int):
    """Streamed mode (C too big for device memory): return the compact
    chunk."""
    return _chunk_core(wcs, a_sl, r_sl, bs_sl, b_bits, b_colsd, npc, Wc)


def _apply_merge(plan: ChunkedPlan, out: np.ndarray) -> np.ndarray:
    """Fold duplicate (row, col) runs. With row-aligned cuts there are
    none and this is the identity; split-row junction spans get a local
    stable reorder + reduceat, everything else passes through."""
    if not plan.merge_spans.size:
        return out
    pieces = []
    pos = 0
    off = 0
    moff = 0
    for s, t, n_runs in plan.merge_spans:
        s, t, n_runs = int(s), int(t), int(n_runs)
        pieces.append(out[pos:s])
        seg = out[s:t][plan.merge_order[off:off + (t - s)]]
        pieces.append(np.add.reduceat(
            seg, plan.merge_offsets[moff:moff + n_runs]))
        off += t - s
        moff += n_runs
        pos = t
    pieces.append(out[pos:])
    return np.concatenate(pieces)


def numeric_chunked(plan: ChunkedPlan, a: Csr, b: Csr,
                    a_vals=None, b_vals=None,
                    stream_to_host: bool | None = None) -> np.ndarray:
    """Run every chunk on device; returns final (merged) C values.
    stream_to_host (default: auto when the device C buffer would exceed
    ~2 GB) fetches each chunk's compacted values instead of holding the
    whole pre-merge C on chip — the capacity mode that lets >int32
    product counts (e.g. rmat20's 7.0e10) run."""
    av = np.asarray(a.values if a_vals is None else a_vals, np.float32)
    bv = np.asarray(b.values if b_vals is None else b_vals, np.float32)
    a_cols = np.asarray(a.col_indices, np.int64)
    b_off = np.asarray(b.row_offsets, np.int64)
    wc_h = np.zeros(a.nnz + 1, np.int64)
    np.cumsum(np.diff(b_off)[a_cols], out=wc_h[1:])
    a_bits_h = av.view(np.int32)
    a_src_h = np.repeat(np.arange(a.n_rows, dtype=np.int32),
                        np.diff(np.asarray(a.row_offsets)))
    b_start_h = b_off[a_cols].astype(np.int32)
    b_bits = jnp.asarray(np.pad(bv.view(np.int32), (0, 1)))
    b_colsd = jnp.asarray(np.pad(np.asarray(b.col_indices, np.int32),
                                 (0, 1)))
    if stream_to_host is None:
        stream_to_host = plan.c_dev_total + plan.Wc > (1 << 29)
    Ec, Wc = plan.Ecap, plan.Wc
    nnz = a.nnz
    bases = [c[3] for c in plan.chunks] + [plan.c_dev_total]

    def slices(e0, p0):
        wcs = np.minimum(
            np.pad(wc_h[e0:min(e0 + Ec + 1, nnz + 1)] - p0,
                   (0, max(0, e0 + Ec + 1 - (nnz + 1))), mode="edge"),
            Wc).astype(np.int32)
        pad_n = max(0, e0 + Ec - nnz)
        return (jnp.asarray(wcs),
                jnp.asarray(np.pad(a_bits_h[e0:e0 + Ec], (0, pad_n))),
                jnp.asarray(np.pad(a_src_h[e0:e0 + Ec], (0, pad_n))),
                jnp.asarray(np.pad(b_start_h[e0:e0 + Ec], (0, pad_n))))

    if stream_to_host:
        out = np.zeros(plan.c_dev_total, np.float32)
        for i, (e0, p0, npc, c_base) in enumerate(plan.chunks):
            wcs, a_sl, r_sl, bs_sl = slices(e0, p0)
            csum = _chunk_numeric_stream(wcs, a_sl, r_sl, bs_sl, b_bits,
                                         b_colsd, jnp.int32(npc), Wc=Wc)
            cnt = bases[i + 1] - c_base
            out[c_base:c_base + cnt] = np.asarray(csum[:cnt])
    else:
        cvals = jnp.zeros(plan.c_dev_total + plan.Wc, jnp.float32)
        for (e0, p0, npc, c_base) in plan.chunks:
            wcs, a_sl, r_sl, bs_sl = slices(e0, p0)
            cvals = _chunk_numeric(wcs, a_sl, r_sl, bs_sl, b_bits,
                                   b_colsd, jnp.int32(npc),
                                   jnp.int32(c_base), cvals, Wc=Wc)
        out = np.asarray(cvals)[:plan.c_dev_total].copy()
    return _apply_merge(plan, out)


def run_chunked(a: Csr, b: Csr, *, chunk_products: int = 1 << 26,
                chunk_edges: int = 1 << 23, warmup: bool = True,
                plan: ChunkedPlan | None = None) -> SpgemmResult:
    """SpGEMM for product counts beyond the static-plan path's range."""
    if plan is None:
        plan = make_chunked_plan(a, b, chunk_products=chunk_products,
                                 chunk_edges=chunk_edges)
    if plan is None:
        return SpgemmResult(Csr(a.n_rows, b.n_cols,
                                np.zeros(a.n_rows + 1, np.int32),
                                np.empty(0, np.int32),
                                np.empty(0, np.float32)), 0.0)
    if warmup:
        numeric_chunked(plan, a, b)
    t = Timer().begin()
    vals = numeric_chunked(plan, a, b)
    ms = t.end()
    return SpgemmResult(Csr(a.n_rows, b.n_cols,
                            np.asarray(plan.c_row_offsets),
                            np.asarray(plan.c_col_indices),
                            vals.astype(np.float32)), ms)


def cpu_reference(a: Csr, b: Csr) -> Csr:
    """Host Gustavson via dict accumulation."""
    from collections import defaultdict
    a_off = np.asarray(a.row_offsets)
    a_cols = np.asarray(a.col_indices)
    a_vals = np.asarray(a.values, np.float64)
    b_off = np.asarray(b.row_offsets)
    b_cols = np.asarray(b.col_indices)
    b_vals = np.asarray(b.values, np.float64)
    rows, cols, vals = [], [], []
    for i in range(a.n_rows):
        acc = defaultdict(float)
        for e in range(a_off[i], a_off[i + 1]):
            k, av = a_cols[e], a_vals[e]
            for f in range(b_off[k], b_off[k + 1]):
                acc[int(b_cols[f])] += av * b_vals[f]
        for j in sorted(acc):
            rows.append(i)
            cols.append(j)
            vals.append(acc[j])
    from essentials_tpu.formats.coo import Coo
    return Csr.from_coo(Coo(a.n_rows, b.n_cols,
                            np.array(rows, np.int32), np.array(cols, np.int32),
                            np.array(vals, np.float32)))
