"""Graph partitioning for multi-device execution.

The reference's only multi-device mechanism is VMM memory striping with no
compute distribution (/root/reference/include/gunrock/virtual_memory.hxx;
every operator rejects multi-context, advance.hxx:125-128). Here: a 1-D
destination-owner edge partition over a device mesh —

* vertices are split into P contiguous blocks of ``block_size`` (the global
  padded vertex count becomes Vtot = P * block_size);
* each device owns every edge whose *destination* falls in its block, so the
  per-destination combine is purely local;
* per-superstep communication is ONE `all_gather` of the [Vs]-sharded
  frontier/value arrays over the mesh axis;
* the local compute uses the same engine as single-device
  (ops/segment.py): each device stores its edges in global-src-sorted order
  (so the gathered vector expands via the telescoping cumsum), a static
  int32 gather index into local-dst-sorted order, and local combine
  offsets.

Edge blocks are padded to the max per-device edge count so all stacked
arrays (and gather indices) are rectangular.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from essentials_tpu import dtypes
from essentials_tpu.formats.csr import Csr
from essentials_tpu.formats.coo import Coo, pair_order


def _pad_to(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


@partial(jax.tree_util.register_dataclass,
         data_fields=["src_offsets", "dst_offsets", "weights", "route",
                      "vertex_valid", "out_degrees", "send_idx",
                      "csrc_offsets", "peer_route", "peer_dst_offsets",
                      "peer_edge_starts"],
         meta_fields=["n_devices", "block_size", "edges_per_device",
                      "n_vertices", "n_edges", "boundary_size",
                      "peer_edges"])
@dataclass(frozen=True)
class DistGraph:
    """Edge-partitioned graph, stacked per device along axis 0.

    Two exchange modes (SURVEY §5 design):
      all_gather — src_offsets span the full [Vtot] gathered vector;
      boundary   — each device announces the static source sets it needs
                   (send_idx), owners gather + all_to_all exactly those
                   values, and edges expand over COMPACT source slots
                   (csrc_offsets over [P*Smax]). Per-superstep comm drops
                   from Vtot to P*Smax values per device."""
    n_devices: int
    block_size: int            # Vs: vertices owned per device
    edges_per_device: int      # Es: padded edge count per device
    n_vertices: int            # real V
    n_edges: int               # real E
    boundary_size: int         # Smax (0 = all_gather mode)

    src_offsets: jax.Array     # [P, Vtot+1] int32: global-src-sorted offsets
    dst_offsets: jax.Array     # [P, Vs+2] int32: local-dst offsets (+trash)
    weights: jax.Array         # [P, Es] in src-sorted order (pad -> 0)
    route: jax.Array           # [P, Es] int32 gather index: src -> dst order
    vertex_valid: jax.Array    # [P, Vs] bool (real vertices)
    out_degrees: jax.Array     # [P, Vs] int32 global out-degree of owned verts
    send_idx: jax.Array | None     # [P, P, Smax] int32 local ids to send
    csrc_offsets: jax.Array | None  # [P, P*Smax+2] compact-src offsets

    # overlap-mode structures (build with overlap=True): the local edge
    # axis split by SOURCE-OWNER peer, so each exchanged chunk can be
    # expanded/routed/combined the moment it arrives (SURVEY §5
    # comm/compute overlap). peer_edges is the rectangular per-(p,q) edge
    # capacity; per-peer gather indices land each peer's edges in ITS OWN
    # dst-sorted order with its own combine offsets — partial combines
    # accumulate associatively across peers.
    peer_edges: int = 0                      # Eq capacity (0 = not built)
    peer_route: jax.Array | None = None      # [P, P, Eq] int32 gather idx
    peer_dst_offsets: jax.Array | None = None   # [P, P, Vs+2]
    peer_edge_starts: jax.Array | None = None   # [P, P+1] edge range lo

    @property
    def n_vertices_global(self) -> int:
        return self.n_devices * self.block_size

    @property
    def comm_values_per_step(self) -> int:
        """Per-device values exchanged per superstep (comm-volume log)."""
        if self.boundary_size:
            return self.n_devices * self.boundary_size
        return self.n_vertices_global


def partition_graph(csr: Csr | Coo, n_devices: int, *,
                    vertex_align: int = 8,
                    exchange: str = "auto",
                    overlap: bool = False) -> DistGraph:
    """1-D destination-owner partition with per-device gather-free layout.

    exchange: "all_gather" | "boundary" | "auto" (boundary when the static
    source sets make it cheaper than gathering the full vector).
    overlap: additionally build the per-source-owner edge split (per-peer
    gather indices + combine offsets) that lets supersteps process each
    exchanged chunk as it arrives off the ring (distributed.py overlap
    mode)."""

    if isinstance(csr, Coo):
        csr = Csr.from_coo(csr)
    v, e = csr.n_rows, csr.nnz
    vs = _pad_to(max(_pad_to(v, n_devices) // n_devices, 1), vertex_align)
    vtot = n_devices * vs
    coo = csr.to_coo()
    owner = (coo.col_indices // vs).astype(np.int64)
    counts = np.bincount(owner, minlength=n_devices)
    es = _pad_to(max(int(counts.max()), 1), 128)

    # edges grouped by owner, CSR (row-major) order kept within each group
    o1 = np.argsort(owner, kind="stable")
    starts = np.zeros(n_devices + 1, np.int64)
    np.cumsum(counts, out=starts[1:])
    need = []                       # need[q][p] = sorted global src ids
    smax = 1
    for q in range(n_devices):
        srcs = np.unique(coo.row_indices[o1[starts[q]:starts[q + 1]]])
        per_owner = [srcs[(srcs // vs) == p] for p in range(n_devices)]
        need.append(per_owner)
        smax = max(smax, max((x.shape[0] for x in per_owner), default=1))
    smax = _pad_to(smax, 8)
    if exchange == "auto":
        exchange = "boundary" if n_devices * smax < vtot // 2 else \
            "all_gather"

    src_offsets = np.zeros((n_devices, vtot + 1), dtypes.edge_dtype)
    dst_offsets = np.zeros((n_devices, vs + 2), dtypes.edge_dtype)
    weights = np.zeros((n_devices, es), coo.values.dtype)
    send_idx = np.zeros((n_devices, n_devices, smax), dtypes.vertex_dtype)
    nslots = n_devices * smax
    csrc_offsets = np.zeros((n_devices, nslots + 2), dtypes.edge_dtype)
    plans = []
    per_dev_overlap = []

    for p in range(n_devices):
        sl = o1[starts[p]:starts[p + 1]]
        k = sl.shape[0]
        s, d, w = coo.row_indices[sl], coo.col_indices[sl] - p * vs, \
            coo.values[sl]
        if exchange == "boundary":
            # compact-source slot per edge: slot = owner*smax + rank within
            # the (owner -> this device) request list
            gmap = np.full(vtot, -1, np.int64)
            for po in range(n_devices):
                ids = need[p][po]
                send_idx[po, p, :ids.shape[0]] = ids - po * vs
                gmap[ids] = po * smax + np.arange(ids.shape[0])
            slots = gmap[s]
            order = np.argsort(slots, kind="stable")
            s2, d2, w2 = slots[order], d[order], w[order]
            sl_deg = np.bincount(s2, minlength=nslots).astype(np.int64)
            off = np.zeros(nslots + 2, np.int64)
            np.cumsum(sl_deg, out=off[1:nslots + 1])
            off[nslots + 1] = es        # pad slot absorbs pad edges
            csrc_offsets[p] = off
            sort_s, sort_d, sort_w = s2, d2, w2
        else:
            order = np.arange(k)
            sort_s, sort_d, sort_w = s, d, w
            deg = np.bincount(s, minlength=vtot).astype(np.int64)
            off = np.zeros(vtot + 1, np.int64)
            np.cumsum(deg, out=off[1:])
            off[vtot] = es              # pad edges join the last segment
            src_offsets[p] = off
        # local-dst-sorted order: gather index over the (re)sorted edges
        o2 = pair_order(sort_d, sort_s, max(vtot, nslots) + 1)
        gather_idx = np.arange(es, dtype=np.int32)
        gather_idx[:k] = o2
        plans.append(gather_idx)
        ddeg = np.bincount(sort_d[o2], minlength=vs).astype(np.int64)
        doff = np.zeros(vs + 2, np.int64)
        np.cumsum(ddeg, out=doff[1:vs + 1])
        doff[vs + 1] = es                  # trash slot absorbs pad edges
        dst_offsets[p] = doff
        weights[p, :k] = sort_w
        if overlap:
            # per-source-owner edge ranges in the src-sorted layout
            span = smax if exchange == "boundary" else vs
            elo = np.searchsorted(sort_s, np.arange(n_devices + 1) * span)
            per_dev_overlap.append((sort_s, sort_d, elo))

    route = jnp.asarray(np.stack(plans))

    peer_kw = {}
    if overlap:
        eq_cap = _pad_to(max(max(int(np.max(np.diff(elo)))
                                 for _, _, elo in per_dev_overlap), 1), 128)
        p_plans, p_doffs, p_elos = [], [], []
        for sort_s, sort_d, elo in per_dev_overlap:
            for q in range(n_devices):
                lo, hi = int(elo[q]), int(elo[q + 1])
                dq = sort_d[lo:hi]
                oq = pair_order(dq, sort_s[lo:hi], max(vtot, nslots) + 1)
                gidx = np.arange(eq_cap, dtype=np.int32)
                gidx[:hi - lo] = oq
                p_plans.append(gidx)
                ddeg = np.bincount(dq, minlength=vs).astype(np.int64)
                dof = np.zeros(vs + 2, np.int64)
                np.cumsum(ddeg, out=dof[1:vs + 1])
                dof[vs + 1] = eq_cap       # trash slot absorbs peer pad
                p_doffs.append(dof)
            p_elos.append(elo)
        peer_route = jnp.asarray(
            np.stack(p_plans).reshape(n_devices, n_devices, eq_cap))
        peer_kw = dict(
            peer_edges=eq_cap,
            peer_route=peer_route,
            peer_dst_offsets=jnp.asarray(
                np.stack(p_doffs).reshape(n_devices, n_devices, vs + 2)
                .astype(dtypes.edge_dtype)),
            peer_edge_starts=jnp.asarray(
                np.stack(p_elos).astype(dtypes.edge_dtype)))

    vidx = np.arange(vtot).reshape(n_devices, vs)
    vertex_valid = vidx < v
    deg = np.zeros(vtot, dtypes.edge_dtype)
    deg[:v] = np.diff(csr.row_offsets)

    boundary = smax if exchange == "boundary" else 0
    return DistGraph(
        n_devices=n_devices, block_size=vs, edges_per_device=es,
        n_vertices=v, n_edges=e, boundary_size=boundary,
        src_offsets=jnp.asarray(src_offsets),
        dst_offsets=jnp.asarray(dst_offsets),
        weights=jnp.asarray(weights),
        route=route,
        vertex_valid=jnp.asarray(vertex_valid),
        out_degrees=jnp.asarray(deg.reshape(n_devices, vs)),
        send_idx=jnp.asarray(send_idx) if boundary else None,
        csrc_offsets=jnp.asarray(csrc_offsets) if boundary else None,
        **peer_kw,
    )
