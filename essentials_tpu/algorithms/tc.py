"""Triangle counting.

Reference parity: gunrock::tc (/root/reference/include/gunrock/algorithms/
tc.hxx:75-127) which runs a per-edge sorted two-pointer intersection
(graph/csr.hxx:110-167). Formulations here:

* dense path (V <= 8192): orient edges a<b, build the dense int8
  adjacency Ao, and count with integer matrix products:
      M  = (Ao @ Ao) * Ao          -> M[u,v] = triangles closed at edge (u,v)
      total = sum(M);  per-vertex:  u-role = rowsum(M), v-role = colsum(M),
      witness-role = rowsum((Ao^T @ M) * Ao^T).
  int8 operands with int32 accumulation are exact; degree skew is
  irrelevant.

* tagged-sort path (any V): expand each oriented edge (u,v) into wedges
  (v, c) for every c in N+(u) (host preprocessing),
  then test membership of all W wedges against the E oriented edges with
  ONE multi-key `lax.sort` of the concatenated (key1, key2, tag) records:
  edges sort before wedges of equal key, so a segmented forward-fill of
  "segment starts with an edge" marks every triangle wedge; balanced
  regardless of degree skew.

* shift path (any V, total only): see the section below.

Returns total triangles and per-vertex counts (each vertex's triangle
participation), like the reference's vertex_triangles + post-process
reduce (tc.hxx:111-127).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp
from functools import partial

from essentials_tpu.formats.csr import Csr
from essentials_tpu.ops.scan_kernels import segmented_scan
from essentials_tpu.utils.timer import Timer

_DENSE_MAX_V = 8192


class TcResult(NamedTuple):
    total: int
    vertex_triangles: np.ndarray
    elapsed_ms: float


def _oriented_csr(csr: Csr):
    """Host: degree-oriented CSR (edge kept from lower to higher
    (degree, id)) with sorted rows. Degree orientation bounds each
    oriented out-degree by ~sqrt(2E), keeping wedge rows short on
    hub-heavy graphs (id orientation leaves hub rows of size ~V)."""
    n = csr.n_rows
    off = np.asarray(csr.row_offsets)
    cols = np.asarray(csr.col_indices)
    deg_all = np.diff(off).astype(np.int64)
    rank = deg_all * (n + 1) + np.arange(n)     # total order (degree, id)
    src = np.repeat(np.arange(n), deg_all)
    keep = rank[src] < rank[cols]
    s, c = src[keep], cols[keep]
    order = np.lexsort((c, s))
    s, c = s[order], c[order]
    # simple-graph semantics: a duplicated edge closes no extra triangle
    first = np.ones(s.shape[0], bool)
    first[1:] = (s[1:] != s[:-1]) | (c[1:] != c[:-1])
    s, c = s[first], c[first]
    deg = np.bincount(s, minlength=n)
    noff = np.zeros(n + 1, np.int64)
    np.cumsum(deg, out=noff[1:])
    return noff, s, c


# ------------------------------------------------------------------ #
# dense path

@jax.jit
def _dense_kernel(ao):
    """Triangle (a<b<c) algebra over the oriented adjacency Ao:
    (Ao@Ao)[a,c] sums over the MIDDLE vertex b, so M = (Ao@Ao)*Ao holds
    the per-(a,c)-edge triangle count; rowsum = smallest-vertex role,
    colsum = largest-vertex role, and the middle role is
    rowsum(Ao^T * (Ao@Ao^T))."""
    a8 = ao.astype(jnp.int8)
    m = jax.lax.dot(a8, a8, preferred_element_type=jnp.int32)
    m = m * ao.astype(jnp.int32)
    total = jnp.sum(m)
    lo_role = jnp.sum(m, axis=1)                       # a (smallest)
    hi_role = jnp.sum(m, axis=0)                       # c (largest)
    p = jax.lax.dot(a8, a8.T, preferred_element_type=jnp.int32)
    mid_role = jnp.sum(ao.astype(jnp.int32).T * p, axis=1)
    return total, lo_role + hi_role + mid_role


def _run_dense(csr: Csr, warmup: bool) -> TcResult:
    n = csr.n_rows
    noff, es, ec = _oriented_csr(csr)
    vp = -(-n // 128) * 128
    ao = np.zeros((vp, vp), np.int8)
    ao[es, ec] = 1
    ao_d = jnp.asarray(ao)
    if warmup:
        jax.block_until_ready(_dense_kernel(ao_d))
    t = Timer().begin()
    total, vt = _dense_kernel(ao_d)
    ms = t.end(sync=(total, vt))
    return TcResult(int(total), np.asarray(vt)[:n].astype(np.int32), ms)


# ------------------------------------------------------------------ #
# tagged-sort path

@jax.jit
def _sort_kernel(k1, k2, tag, pos):
    """Sort records by (k1, k2, tag); mark records whose key-segment opens
    with a tag-0 (edge) record; return (found, pos) in sorted order."""
    sk1, sk2, stag, spos = jax.lax.sort((k1, k2, tag, pos), num_keys=3)
    new_seg = jnp.concatenate([
        jnp.ones(1, jnp.bool_),
        (sk1[1:] != sk1[:-1]) | (sk2[1:] != sk2[:-1])])
    is_edge_first = new_seg & (stag == 0)
    # forward-fill "segment opened with an edge" over each key segment
    ff = segmented_scan(is_edge_first.astype(jnp.int32), new_seg, "first")
    found = (ff > 0) & (stag == 1)
    return found, spos


_WEDGE_CHUNK = 1 << 24          # wedges per device batch (~16M)


def _run_sorted(csr: Csr, warmup: bool) -> TcResult:
    n = csr.n_rows
    noff, es, ec = _oriented_csr(csr)
    deg_plus = np.diff(noff)
    ne = es.shape[0]

    w_per_edge = deg_plus[es].astype(np.int64)
    W = int(w_per_edge.sum())
    if W == 0:
        return TcResult(0, np.zeros(n, np.int32), 0.0)

    # split the edge list so each batch's wedge expansion stays bounded
    # (host memory AND device sort size) — kron-style graphs can have
    # billions of wedges
    wc = np.concatenate([[0], np.cumsum(w_per_edge)])
    bounds = [0]
    while bounds[-1] < ne:
        nxt = int(np.searchsorted(wc, wc[bounds[-1]] + _WEDGE_CHUNK,
                                  side="right")) - 1
        bounds.append(max(nxt, bounds[-1] + 1))
    chunk_cap = int(max(wc[bounds[i + 1]] - wc[bounds[i]]
                        for i in range(len(bounds) - 1)))

    total = 0
    vt = np.zeros(n, np.int64)
    ms = 0.0
    first = True
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        wpe = w_per_edge[lo:hi]
        Wc = int(wpe.sum())
        wedge_eid = np.repeat(np.arange(lo, hi), wpe)
        base = noff[es[wedge_eid]] + (
            np.arange(Wc) - np.repeat(wc[lo:hi] - wc[lo], wpe))
        wedge_c = ec[base]                              # candidate witness
        wedge_v = ec[wedge_eid]                         # test (v, c) edge

        pad = chunk_cap - Wc
        big = np.int32(2**30 - 1)
        k1 = jnp.asarray(np.concatenate(
            [es, wedge_v, np.full(pad, big)]).astype(np.int32))
        k2 = jnp.asarray(np.concatenate(
            [ec, wedge_c, np.full(pad, big)]).astype(np.int32))
        tag = jnp.asarray(np.concatenate(
            [np.zeros(ne, np.int8), np.ones(Wc + pad, np.int8)]))
        pos = jnp.asarray(np.arange(ne + chunk_cap, dtype=np.int32))
        if warmup and first:
            jax.block_until_ready(_sort_kernel(k1, k2, tag, pos))
            first = False
        t = Timer().begin()
        found, spos = _sort_kernel(k1, k2, tag, pos)
        ms += t.end(sync=(found, spos))

        found = np.asarray(found)
        spos = np.asarray(spos)
        wfound = np.zeros(ne + chunk_cap, bool)
        wfound[spos] = found
        hit = wfound[ne:ne + Wc]                        # per-wedge, in order
        total += int(hit.sum())
        np.add.at(vt, es[wedge_eid][hit], 1)
        np.add.at(vt, wedge_v[hit], 1)
        np.add.at(vt, wedge_c[hit], 1)
    return TcResult(total, vt.astype(np.int32), ms)


# ------------------------------------------------------------------ #
# shift-pass sort-join path (any V; device-resident; total count only)
#
# This path keeps ALL work on device with no per-wedge host expansion:
# relabel vertices by orientation rank (so oriented edges are (lo -> hi)
# in new ids and neighborhoods sort ascending), order rows by out-degree
# DESCENDING, and enumerate every within-row neighbor pair as a LANE SHIFT:
#
#   pass s: candidate pairs (wec[p], wec[p+s]) for p in [0, B_s)
#           (B_s = total degree of rows with degree > s — a PREFIX of the
#           edge axis thanks to the degree-descending row order)
#
# Each unordered pair {i < j} of a row appears in exactly one pass
# (s = j - i), so the candidate multiset is exactly the wedge set
# (sum-of-(d choose 2) pairs). Membership of (c1, c2) in the oriented edge
# set is a sort-join: two int32 keys (c1, c2 << 1 | tag), sort candidates
# + edge keys per chunk, and a wedge counts iff its (c1, c2) group opens
# with an edge record (segmented forward fill).
#
# Reference parity: this replaces graph/csr.hxx:110-167 + tc.hxx:75-93 at
# whole-graph scale where the dense engine cannot reach.

_SHIFT_CHUNK = 1 << 28        # slots per device sort (~2.1 GB of records;
#                               fewer, larger sorts amortize the per-chunk
#                               edge-record re-sort cost)
_shift_cache: dict = {}


def _shift_prep(csr: Csr):
    """Device arrays + chunk plan for ``csr``, cached for the last graph.
    The entry pins ``csr`` itself, so its id() cannot be recycled by a
    later graph while the entry lives (an id hit is the same object)."""
    hit = _shift_cache.get(id(csr))
    if hit is not None and hit[0] is csr:
        return hit[1]
    n = csr.n_rows
    off = np.asarray(csr.row_offsets)
    cols = np.asarray(csr.col_indices)
    deg_all = np.diff(off).astype(np.int64)
    rank = deg_all * (n + 1) + np.arange(n)
    perm = np.argsort(rank, kind="stable")
    newid = np.empty(n, np.int64)
    newid[perm] = np.arange(n)
    src = np.repeat(np.arange(n), deg_all)
    s2, c2 = newid[src], newid[cols]
    keep = s2 < c2                       # orientation == new-id order
    es, ec = s2[keep], c2[keep]
    d = np.bincount(es, minlength=n).astype(np.int64)
    roworder = np.argsort(-d, kind="stable")
    rowpos = np.empty(n, np.int64)
    rowpos[roworder] = np.arange(n)
    order = np.lexsort((ec, rowpos[es]))
    wec = ec[order].astype(np.int32)     # degree-desc rows, asc neighbors
    dsorted = d[roworder]
    ends = np.cumsum(dsorted)
    pos_end = np.repeat(ends, dsorted).astype(np.int32)
    maxd = int(dsorted[0]) if len(dsorted) else 0
    cs = ends[-1] if len(ends) else 0
    B = []
    for s in range(1, maxd):
        k = int(np.count_nonzero(dsorted > s))
        b = int(ends[k - 1]) if k else 0
        B.append(b)
    # chunk plan: greedy pass groups of <= _SHIFT_CHUNK slots
    chunks, cur, tot = [], [], 0
    for s, b in enumerate(B, start=1):
        if b == 0:
            break
        if cur and tot + b > _SHIFT_CHUNK:
            chunks.append(tuple(cur))
            cur, tot = [], 0
        cur.append((s, b))
        tot += b
    if cur:
        chunks.append(tuple(cur))
    ek1 = es.astype(np.int32)
    ek2 = (ec.astype(np.int32) << 1)                 # tag 0 = edge
    prep = (jnp.asarray(np.concatenate([wec, np.zeros(maxd + 1, np.int32)])),
            jnp.asarray(pos_end), (jnp.asarray(ek1), jnp.asarray(ek2)),
            chunks)
    _shift_cache.clear()
    _shift_cache[id(csr)] = (csr, prep)
    return prep


@partial(jax.jit, static_argnums=(3,))
def _shift_chunk_count(wec_pad, pos_end, ekey, parts):
    """Two-key int32 records (k1 = c1, k2 = c2 << 1 | tag). Edges (tag 0)
    sort before wedges (tag 1) of the same pair."""
    ek1, ek2 = ekey
    sent = jnp.int32(2 ** 30)
    r1, r2 = [ek1], [ek2]
    for s, b in parts:
        c1 = jax.lax.slice(wec_pad, [0], [b])
        c2 = jax.lax.slice(wec_pad, [s], [s + b])
        valid = (jnp.arange(b, dtype=jnp.int32) + s) \
            < jax.lax.slice(pos_end, [0], [b])
        r1.append(jnp.where(valid, c1, sent))
        r2.append(jnp.where(valid, (c2 << 1) | 1, sent))
    k1, k2 = jax.lax.sort((jnp.concatenate(r1), jnp.concatenate(r2)),
                          num_keys=2)
    # a wedge (odd k2) is a triangle iff its (c1, c2) run opens with the
    # edge record (same k1, k2 - 1, sorted immediately before the run).
    # Fill by running max: encode (run-start index << 1 | opens-with-edge),
    # -1 elsewhere; running max propagates the nearest run start and the
    # LSB carries the flag.
    n = k1.shape[0]
    p1 = jnp.concatenate([jnp.full(1, -1, jnp.int32), k1[:-1]])
    p2 = jnp.concatenate([jnp.full(1, -1, jnp.int32), k2[:-1]])
    run_start = (p1 != k1) | (p2 != k2)
    opens_edge = run_start & (p1 == k1) & (p2 == k2 - 1)
    idx = jnp.arange(n, dtype=jnp.int32)
    enc = jnp.where(run_start, (idx << 1) | opens_edge.astype(jnp.int32),
                    jnp.full(n, -1, jnp.int32))
    m = jax.lax.cummax(enc)
    found = ((k2 & 1) == 1) & (k1 != sent) & ((m & 1) == 1)
    return jnp.sum(found.astype(jnp.int32)).astype(jnp.int32)


def _run_shift(csr: Csr, warmup: bool) -> TcResult:
    """Exact TOTAL triangle count at any V (vertex_triangles not computed
    on this path — zeros returned; use 'dense'/'sorted' when per-vertex
    counts are needed)."""
    wec_pad, pos_end, ekey, chunks = _shift_prep(csr)
    if not chunks:
        return TcResult(0, np.zeros(csr.n_rows, np.int32), 0.0)
    if warmup:
        # every chunk is a distinct static program (its pass structure is
        # a static arg): warm them ALL or the compiles land in the timing
        for parts in chunks:
            jax.block_until_ready(
                _shift_chunk_count(wec_pad, pos_end, ekey, parts))
    # dispatch ALL chunks asynchronously, fetch once at the end. Host-side
    # Python summation keeps the total exact past 2^31 (each chunk's own
    # count fits int32 by construction: found <= chunk slots).
    t = Timer().begin()
    parts_counts = [_shift_chunk_count(wec_pad, pos_end, ekey, parts)
                    for parts in chunks]
    total = sum(int(c) for c in parts_counts)
    ms = t.end()
    return TcResult(total, np.zeros(csr.n_rows, np.int32), ms)


def cpu_reference_total(csr) -> int:
    """Host exact triangle total via scipy masked A^2 (row-blocked)."""
    import scipy.sparse as sp
    n = csr.n_rows
    noff, es, ec = _oriented_csr(csr)
    a = sp.csr_matrix((np.ones(len(es), np.int64), (es, ec)), shape=(n, n))
    total = 0
    step = 1 << 16
    for lo in range(0, n, step):
        blk = a[lo:lo + step]
        total += int((blk @ a).multiply(blk).sum())
    return total


def run(csr: Csr, *, warmup: bool = True, dense: bool | None = None,
        variant: str | None = None) -> TcResult:
    """variant: None (auto: 'dense' for V <= 8192, else 'sorted') |
    'dense' | 'sorted' | 'shift'. 'shift' scales to any V but reports the
    total only."""
    if variant is None:
        if dense if dense is not None else csr.n_rows <= _DENSE_MAX_V:
            variant = "dense"
        else:
            variant = "sorted"
    return {"dense": _run_dense, "sorted": _run_sorted,
            "shift": _run_shift}[variant](csr, warmup)


def cpu_reference(csr) -> tuple[int, np.ndarray]:
    """Host reference via set intersection (reference parity:
    examples/algorithms/tc/tc_cpu.hxx)."""
    n = csr.n_rows
    noff, es, ec = _oriented_csr(csr)
    adj = [set(ec[noff[v]:noff[v + 1]].tolist()) for v in range(n)]
    total = 0
    vt = np.zeros(n, np.int64)
    for e in range(es.shape[0]):
        u, v = int(es[e]), int(ec[e])
        common = adj[u] & adj[v]
        total += len(common)
        for c in common:
            vt[u] += 1
            vt[v] += 1
            vt[c] += 1
    return total, vt.astype(np.int32)
