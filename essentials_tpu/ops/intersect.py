"""Generic neighborhood-intersection operator.

Reference parity: graph::get_intersection_count
(/root/reference/include/gunrock/graph/csr.hxx:110-167) exposes sorted
two-pointer set intersection with a per-match lambda as a reusable graph
primitive (the TC workhorse, also the building block for Jaccard /
clustering-coefficient apps). Here ARBITRARY vertex-pair queries run as
bitmap arithmetic: each vertex's neighborhood is packed into a V-bit row,
and per pair the device gathers the two rows, ANDs them and popcounts:

    intersection_counts(csr, u, v)  -> |N(u) ∩ N(v)| per pair
    jaccard(csr, u, v)              -> |∩| / |∪| per pair

The per-match lambda of the reference becomes the witness accumulator:
``witnesses=True`` additionally returns, per VERTEX c, the number of
queried pairs whose intersection contains c (the reference's
``on_intersection`` callback folded into a deterministic histogram).

Capacity: the all-rows packed bitmap costs (V+1) * V/8 bytes of device
memory. Above ``_DENSE_V_MAX`` vertices the operator switches to the
chunked engine: bitmap rows are restricted to the queried vertices and
the column (witness) axis is processed in vertex-range chunks, so memory
is (n_queried+1) * W/8 per chunk and total bytes moved are
n_queried * V/8 — any-scale pair queries, matching the reference's
contract (csr.hxx:110-167). Whole-graph TC keeps its own paths
(algorithms/tc.py).
"""

from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from essentials_tpu.formats.csr import Csr

_DENSE_V_MAX = 1 << 17        # all-rows bitmap above this: 2 GB+
_CHUNK_BYTES = 1 << 30        # per-chunk bitmap budget for the chunked path
_PAIR_WORDS = 1 << 22         # gathered bitmap words per device batch


def pack_bitmap_rows(n_rows: int, src: np.ndarray, dst: np.ndarray,
                     n_cols: int | None = None) -> np.ndarray:
    """Host: pack edges (src->dst) into [n_rows+1, ceil(n_cols/32)] uint32
    bit rows: bit (d & 31) of word (d >> 5) in row s is set iff edge s->d.
    Row n_rows stays all-zero for pad pairs. ``n_cols`` defaults to
    ``n_rows``."""
    words = max(-(-(n_rows if n_cols is None else n_cols) // 32), 1)
    b = np.zeros((n_rows + 1, words), np.uint32)
    dst = np.asarray(dst, np.int64)
    np.bitwise_or.at(b, (np.asarray(src, np.int64), dst >> 5),
                     np.uint32(1) << (dst & 31).astype(np.uint32))
    return b


@partial(jax.jit, static_argnames=("witness",))
def bitmap_intersect_counts(uu: jax.Array, vv: jax.Array, bitmap: jax.Array,
                            *, witness: bool):
    """Per-pair |row(uu) AND row(vv)| and, with ``witness``, the per-bit
    count of pairs whose AND has that bit set: (cnt int32[P],
    bits int32[words * 32], vertex c at index c). Pad pairs must point at
    the all-zero row."""
    w = bitmap[uu] & bitmap[vv]                            # [P, words]
    cnt = jnp.sum(jax.lax.population_count(w).astype(jnp.int32), axis=1)
    if not witness:
        return cnt, None
    shifts = jnp.arange(32, dtype=jnp.uint32)
    bits = jnp.sum(((w[:, :, None] >> shifts) & 1).astype(jnp.int32), axis=0)
    return cnt, bits.reshape(-1)


def _pair_counts(uu, vv, bitmap: np.ndarray, witness: bool):
    """Run the pair kernel in fixed-size batches (one compiled shape per
    bitmap width). Returns host (cnt int64[P], bits int64[words*32])."""
    npairs = uu.shape[0]
    words = bitmap.shape[1]
    batch = max(1, _PAIR_WORDS // words)
    batch = 1 << (batch.bit_length() - 1)
    batch = min(batch, 1 << max(int(npairs - 1).bit_length(), 0))
    pad_row = bitmap.shape[0] - 1
    bm = jnp.asarray(bitmap)
    cnt = np.zeros(npairs, np.int64)
    bits = np.zeros(words * 32, np.int64) if witness else None
    for lo in range(0, npairs, batch):
        hi = min(lo + batch, npairs)
        bu = np.full(batch, pad_row, np.int32)
        bv = np.full(batch, pad_row, np.int32)
        bu[:hi - lo] = uu[lo:hi]
        bv[:hi - lo] = vv[lo:hi]
        c, wb = bitmap_intersect_counts(jnp.asarray(bu), jnp.asarray(bv), bm,
                                        witness=witness)
        cnt[lo:hi] = np.asarray(c)[:hi - lo]
        if witness:
            bits += np.asarray(wb)
    return cnt, bits


_bitmap_cache: dict = {}


def _rows_bitmap(csr: Csr) -> np.ndarray:
    """All-rows bitmap of ``csr``, cached for the last graph. The entry
    pins ``csr`` itself, so its id() cannot be recycled by a later graph
    while the entry lives (an id hit is the same object)."""
    hit = _bitmap_cache.get(id(csr))
    if hit is not None and hit[0] is csr:
        return hit[1]
    n = csr.n_rows
    off = np.asarray(csr.row_offsets)
    cols = np.asarray(csr.col_indices)
    src = np.repeat(np.arange(n), np.diff(off))
    bm = pack_bitmap_rows(n, src, cols)
    _bitmap_cache.clear()
    _bitmap_cache[id(csr)] = (csr, bm)
    return bm


def intersection_counts(csr: Csr, u, v, *, witnesses: bool = False):
    """|N(u_i) ∩ N(v_i)| for every query pair, on full (undirected)
    neighborhoods. Returns counts int32[len(u)] (and, with
    ``witnesses=True``, the per-vertex witness histogram int64[V]).
    Any V: dense all-rows bitmap up to ``_DENSE_V_MAX``, chunked above."""
    u = np.asarray(u, np.int32)
    v = np.asarray(v, np.int32)
    n = csr.n_rows
    if n > _DENSE_V_MAX:
        return _intersection_counts_chunked(csr, u, v,
                                            witnesses=witnesses)
    cnt, bits = _pair_counts(u, v, _rows_bitmap(csr), witnesses)
    counts = cnt.astype(np.int32)
    if witnesses:
        return counts, bits[:n]
    return counts


def _intersection_counts_chunked(csr: Csr, u, v, *, witnesses: bool):
    """Any-scale pair intersection: bitmap rows restricted to the
    QUERIED vertices, column (witness) axis in vertex-range chunks.
    counts = sum over chunks of |N(u) ∩ N(v) ∩ [lo, lo+W)|."""
    n = csr.n_rows
    npairs = u.shape[0]
    # remap queried vertices to dense row ids
    qverts, inv = np.unique(np.concatenate([u, v]), return_inverse=True)
    nq = int(qverts.shape[0])
    uq = inv[:npairs].astype(np.int32)
    vq = inv[npairs:].astype(np.int32)
    # adjacency of the queried rows only (host gather, once)
    off = np.asarray(csr.row_offsets, np.int64)
    cols = np.asarray(csr.col_indices, np.int64)
    lens = (off[qverts + 1] - off[qverts]).astype(np.int64)
    qsrc = np.repeat(np.arange(nq, dtype=np.int64), lens)
    take = np.concatenate(
        [np.arange(off[q], off[q + 1]) for q in qverts]) \
        if nq else np.zeros(0, np.int64)
    qdst = cols[take]
    order = np.argsort(qdst, kind="stable")
    qsrc, qdst = qsrc[order], qdst[order]

    # chunk width: (nq+1) * W/8 bytes per chunk, a power of two >= 4096 bits
    w_bits = max(_CHUNK_BYTES * 8 // max(nq + 1, 1), 1 << 12)
    w_bits = min(1 << int(np.log2(w_bits)), 1 << 22)
    counts = np.zeros(npairs, np.int64)
    wit = np.zeros(n, np.int64) if witnesses else None
    for lo in range(0, n, w_bits):
        hi = min(lo + w_bits, n)
        a, b = np.searchsorted(qdst, [lo, hi])
        bm = pack_bitmap_rows(nq, qsrc[a:b], qdst[a:b] - lo, n_cols=w_bits)
        cnt, bits = _pair_counts(uq, vq, bm, witnesses)
        counts += cnt
        if witnesses:
            wit[lo:hi] += bits[:hi - lo]
    counts = counts.astype(np.int32)
    if witnesses:
        return counts, wit
    return counts


def jaccard(csr: Csr, u, v):
    """Jaccard similarity |N(u) ∩ N(v)| / |N(u) ∪ N(v)| per query pair
    (0 where the union is empty) — the reference's intersection operator
    applied beyond TC (csr.hxx:110-167 doc note)."""
    u = np.asarray(u, np.int64)
    v = np.asarray(v, np.int64)
    inter = intersection_counts(csr, u, v).astype(np.float64)
    deg = np.diff(np.asarray(csr.row_offsets)).astype(np.float64)
    union = deg[u] + deg[v] - inter
    return np.where(union > 0, inter / np.maximum(union, 1), 0.0)
