"""The Graph pytree.

Design (replaces reference graph_t at
/root/reference/include/gunrock/graph/graph.hxx:52-307):

* Static padded shapes. Vertices are padded to ``Vp`` (multiple of
  ``vertex_pad``, with at least one spare slot) and edges to ``Ep``. The
  spare vertex slot ``pad_vertex == n_vertices`` absorbs padded edges:
  padded edges have src = dst = pad_vertex and weight 0, frontier masks are
  always False there, and per-vertex accumulators simply carry a garbage
  value in slot ``pad_vertex`` that callers never read. This replaces the
  reference's per-element "invalid sentinel" checks with shape-level
  invariants XLA can optimize through.

* Edge-centric dual order. The same edge set is stored twice:
    CSR order (sorted by src, then dst): ``row_offsets, col_indices (dst),
      src_indices, values`` — sorted segment reductions *by source*
      (neighborreduce / SpMV, out-degree ops).
    CSC order (sorted by dst, then src): ``csc_offsets, csc_src_indices,
      csc_dst_indices, csc_values, csc_edge_ids`` — sorted segment
      reductions *by destination* (advance/push combine, pull sweeps).
  ``csc_edge_ids`` maps a CSC slot back to its CSR edge id so edge-keyed
  algorithm state (MST, BC) stays consistent across both orders.

* Everything is a jax Array; the class is a registered dataclass pytree so
  graphs pass through jit/vmap/shard_map boundaries as arguments.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from essentials_tpu import dtypes
from essentials_tpu.errors import throw_if
from essentials_tpu.formats.coo import Coo, pair_order
from essentials_tpu.formats.csr import Csr


def _pad_to(n: int, multiple: int) -> int:
    return ((n + multiple - 1) // multiple) * multiple


@dataclass(frozen=True)
class GraphProperties:
    """Reference parity: graph_properties_t
    (/root/reference/include/gunrock/graph/properties.hxx:13-17)."""
    directed: bool = True
    weighted: bool = True


@partial(jax.tree_util.register_dataclass,
         data_fields=["row_offsets", "col_indices", "src_indices", "values",
                      "csc_offsets", "csc_src_indices", "csc_dst_indices",
                      "csc_values", "csc_edge_ids",
                      "csc_rank", "csc_seg_flags", "csr_seg_flags"],
         meta_fields=["n_vertices", "n_edges", "n_vertices_padded",
                      "n_edges_padded", "properties", "max_degree",
                      "symmetric_layout"])
@dataclass(frozen=True)
class Graph:
    # --- static metadata (pytree aux) ---
    n_vertices: int
    n_edges: int
    n_vertices_padded: int       # Vp >= n_vertices + 1; accumulator length
    n_edges_padded: int          # Ep >= n_edges
    properties: GraphProperties

    # --- CSR order (sorted by src, then dst) ---
    row_offsets: jax.Array       # [Vp + 1] int32; rows >= V own the pad edges
    col_indices: jax.Array       # [Ep] int32 dst; pad = pad_vertex
    src_indices: jax.Array       # [Ep] int32 src; pad = pad_vertex
    values: jax.Array            # [Ep] weight; pad = 0

    # --- CSC order (sorted by dst, then src); None when not built ---
    csc_offsets: jax.Array | None      # [Vp + 1] int32
    csc_src_indices: jax.Array | None  # [Ep] int32
    csc_dst_indices: jax.Array | None  # [Ep] int32
    csc_values: jax.Array | None       # [Ep] weight
    csc_edge_ids: jax.Array | None     # [Ep] int32 -> CSR edge id

    # --- static structures of the segment engine (ops/segment.py) ---
    csc_rank: jax.Array | None         # [Ep] int32: CSC position of CSR edge e
    csc_seg_flags: jax.Array | None    # [Ep] bool: dst-segment starts (CSC)
    csr_seg_flags: jax.Array | None    # [Ep] bool: src-segment starts (CSR)

    # --- static host-side analytics (pytree aux) ---
    max_degree: int = 0                # max out-degree over real vertices
    symmetric_layout: bool = False     # csc_offsets == row_offsets (A == A^T
    #                                    in layout: pull and push coincide)

    # ------------------------------------------------------------------ #
    @property
    def pad_vertex(self) -> int:
        return self.n_vertices

    @property
    def has_csc(self) -> bool:
        return self.csc_offsets is not None

    # Vertex/edge accessor parity with reference graph.hxx:203-307, all
    # vectorized (device arrays in, device arrays out).

    def out_degrees(self) -> jax.Array:
        """[Vp] out-degree per vertex (pad slots report pad-edge counts)."""
        return self.row_offsets[1:] - self.row_offsets[:-1]

    def in_degrees(self) -> jax.Array:
        throw_if(not self.has_csc, "graph built without CSC view")
        return self.csc_offsets[1:] - self.csc_offsets[:-1]

    def get_number_of_neighbors(self, v) -> jax.Array:
        return self.row_offsets[v + 1] - self.row_offsets[v]

    def get_starting_edge(self, v) -> jax.Array:
        return self.row_offsets[v]

    def get_destination_vertex(self, e) -> jax.Array:
        return self.col_indices[e]

    def get_source_vertex(self, e) -> jax.Array:
        """O(1) via the materialized src_indices array (the reference pays a
        binary search here, graph/csr.hxx:61-76)."""
        return self.src_indices[e]

    def get_edge_weight(self, e) -> jax.Array:
        return self.values[e]

    def vertex_mask(self) -> jax.Array:
        """[Vp] bool, True for real vertices."""
        return jnp.arange(self.n_vertices_padded) < self.n_vertices

    def edge_mask(self) -> jax.Array:
        """[Ep] bool, True for real edges (CSR order)."""
        return jnp.arange(self.n_edges_padded) < self.n_edges


def build_graph(csr: Csr | Coo, *, directed: bool = True, weighted: bool = True,
                build_csc: bool = True, vertex_pad: int = 8, edge_pad: int = 128,
                device=None) -> Graph:
    """Build a device Graph from a host Csr/Coo.

    Reference parity: graph::build::from_csr
    (/root/reference/include/gunrock/graph/build.hxx:22-53) — but unlike the
    reference (which cannot combine CSR+CSC, detail/build.hxx:86-89) both
    orders are always available together.
    """
    if isinstance(csr, Coo):
        csr = Csr.from_coo(csr)
    throw_if(csr.n_rows != csr.n_cols,
             "build_graph expects a square adjacency (use Csr directly for SpMV)")
    v, e = csr.n_rows, csr.nnz
    vp = max(_pad_to(v + 1, vertex_pad), vertex_pad)
    ep = max(_pad_to(max(e, 1), edge_pad), edge_pad)
    pad_v = v

    # CSR order arrays.
    row_offsets = np.full(vp + 1, e, dtype=dtypes.edge_dtype)
    row_offsets[: v + 1] = csr.row_offsets
    row_offsets[v + 1:] = ep  # pad edges all belong to row pad_v
    col = np.full(ep, pad_v, dtype=dtypes.vertex_dtype)
    col[:e] = csr.col_indices
    src = np.full(ep, pad_v, dtype=dtypes.vertex_dtype)
    src[:e] = np.repeat(np.arange(v, dtype=dtypes.vertex_dtype),
                        np.diff(csr.row_offsets).astype(np.int64))
    val = np.zeros(ep, dtype=csr.values.dtype if weighted else dtypes.weight_dtype)
    if weighted:
        val[:e] = csr.values
    else:
        val[:e] = 1

    # segment-start flags in CSR order (for MIN/MAX combines by src)
    csr_flags = np.zeros(ep, bool)
    starts = row_offsets[:-1][np.diff(row_offsets.astype(np.int64)) > 0]
    csr_flags[starts] = True

    kw = {"csc_rank": None, "csc_seg_flags": None,
          "csr_seg_flags": csr_flags}
    if build_csc:
        order = pair_order(col[:e], src[:e], v + 1)
        csc_src = np.full(ep, pad_v, dtypes.vertex_dtype)
        csc_dst = np.full(ep, pad_v, dtypes.vertex_dtype)
        csc_val = np.zeros(ep, val.dtype)
        csc_eid = np.arange(ep, dtype=dtypes.edge_dtype)
        csc_src[:e] = src[order]
        csc_dst[:e] = col[order]
        csc_val[:e] = val[order]
        csc_eid[:e] = order.astype(dtypes.edge_dtype)
        in_deg = np.bincount(col[:e], minlength=v).astype(np.int64)
        csc_off = np.full(vp + 1, e, dtype=dtypes.edge_dtype)
        np.cumsum(in_deg, out=csc_off[1: v + 1])
        csc_off[0] = 0
        csc_off[v + 1:] = ep
        # rank permutation: CSC position of each CSR edge (pad edges fixed)
        rank = np.arange(ep, dtype=dtypes.edge_dtype)
        rank[order] = np.arange(e, dtype=dtypes.edge_dtype)
        # segment-start flags in CSC order
        csc_flags = np.zeros(ep, bool)
        cstarts = csc_off[:-1][np.diff(csc_off.astype(np.int64)) > 0]
        csc_flags[cstarts] = True
        kw.update(csc_offsets=csc_off, csc_src_indices=csc_src,
                  csc_dst_indices=csc_dst, csc_values=csc_val,
                  csc_edge_ids=csc_eid, csc_rank=rank,
                  csc_seg_flags=csc_flags)
    else:
        kw.update(csc_offsets=None, csc_src_indices=None, csc_dst_indices=None,
                  csc_values=None, csc_edge_ids=None)

    g = Graph(
        n_vertices=v, n_edges=e, n_vertices_padded=vp, n_edges_padded=ep,
        properties=GraphProperties(directed=directed, weighted=weighted),
        max_degree=int(np.diff(csr.row_offsets).max()) if e else 0,
        symmetric_layout=bool(
            build_csc and np.array_equal(row_offsets, kw["csc_offsets"])),
        row_offsets=row_offsets,
        col_indices=col,
        src_indices=src,
        values=val,
        **kw,
    )
    # one batched transfer for the whole pytree
    return jax.device_put(g, device)
