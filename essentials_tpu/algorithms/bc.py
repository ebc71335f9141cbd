"""Betweenness centrality (Brandes).

Reference parity: gunrock::bc (/root/reference/include/gunrock/algorithms/
bc.hxx:136-269): forward BFS accumulating shortest-path counts (sigma) with
per-depth frontiers, then backward dependency accumulation walking depths
down; all-sources via the batch operator. Here forward and backward
are two `lax.while_loop`s in one jitted program; per-depth frontiers are
implied by the depth labels (no 1000-buffer hack, bc.hxx:241-243); the
all-sources variant vmaps chunks of sources.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp
from functools import partial

from essentials_tpu.framework.enactor import EnactResult
from essentials_tpu.graph.graph import Graph
from essentials_tpu.ops import advance, neighbor_reduce, Combine
from essentials_tpu.utils.timer import Timer

UNSEEN = jnp.iinfo(jnp.int32).max


class BcResult(NamedTuple):
    bc_values: jax.Array
    iterations: int
    elapsed_ms: float


def _single_source_deps(g: Graph, source, max_depth: int):
    """Returns (delta, depth): dependency scores and BFS depths."""
    vp = g.n_vertices_padded
    depth = jnp.full(vp, UNSEEN, jnp.int32).at[source].set(0)
    sigma = jnp.zeros(vp, jnp.float32).at[source].set(1.0)
    frontier = jnp.zeros(vp, jnp.bool_).at[source].set(True)

    def fwd_cond(carry):
        depth, sigma, frontier, it = carry
        return jnp.logical_and(it < max_depth, jnp.any(frontier))

    def fwd_body(carry):
        depth, sigma, frontier, it = carry
        # paths flowing along edges from the current level
        sig_in = advance(g, lambda e: e.src_vals[0], frontier,
                         src_values=(sigma,), combine=Combine.SUM,
                         with_frontier=False)
        newly_mask = (depth == UNSEEN) & (sig_in > 0) & g.vertex_mask()
        depth = jnp.where(newly_mask, it + 1, depth)
        sigma = jnp.where(newly_mask, sig_in, sigma)
        return depth, sigma, newly_mask, it + 1

    depth, sigma, _, levels = jax.lax.while_loop(
        fwd_cond, fwd_body, (depth, sigma, frontier, jnp.asarray(0, jnp.int32)))

    delta = jnp.zeros(vp, jnp.float32)

    def bwd_cond(carry):
        delta, d = carry
        return d > 0

    def bwd_body(carry):
        delta, d = carry
        # contribution to vertices at depth d-1 from successors at depth d
        ratio = (1.0 + delta) / jnp.maximum(sigma, 1e-30)

        def edge_val(e):
            ok = (e.src_vals[0] == d - 1) & (e.dst_vals[0] == d)
            return jnp.where(ok, e.src_vals[1] * e.dst_vals[1], 0.0)

        contrib = neighbor_reduce(g, edge_val, src_values=(depth, sigma),
                                  dst_values=(depth, ratio),
                                  combine=Combine.SUM)
        delta = jnp.where(depth == d - 1, contrib, delta)
        return delta, d - 1

    delta, _ = jax.lax.while_loop(bwd_cond, bwd_body, (delta, levels))
    delta = jnp.where(jnp.arange(vp) == source, 0.0, delta)
    return delta, depth, levels


@partial(jax.jit, static_argnums=(2,))
def _bc_single(g: Graph, source, max_depth: int):
    delta, _, levels = _single_source_deps(g, source, max_depth)
    return delta, levels


def spmv_supported(g: Graph) -> bool:
    """The SpMV-engine levels need A == A^T (symmetric layout)."""
    return bool(g.symmetric_layout)


def _single_source_deps_spmv(g: Graph, source, max_depth: int):
    """Forward sigma levels and backward dependency levels each as ONE
    unweighted pull SpMV (Brandes' per-level sweeps are frontier-masked
    SpMVs; valid when A == A^T)."""
    from essentials_tpu.algorithms.pr import _spmv_engine_call
    vp = g.n_vertices_padded
    mask = g.vertex_mask()
    depth = jnp.full(vp, UNSEEN, jnp.int32).at[source].set(0)
    sigma = jnp.zeros(vp, jnp.float32).at[source].set(1.0)
    frontier = jnp.zeros(vp, jnp.bool_).at[source].set(True)

    def fwd_cond(carry):
        depth, sigma, frontier, it = carry
        return jnp.logical_and(it < max_depth, jnp.any(frontier))

    def fwd_body(carry):
        depth, sigma, frontier, it = carry
        x = jnp.where(frontier, sigma, 0.0)
        sig_in = _spmv_engine_call(g, x, unit=True)[:vp]
        newly = (depth == UNSEEN) & (sig_in > 0) & mask
        depth = jnp.where(newly, it + 1, depth)
        sigma = jnp.where(newly, sig_in, sigma)
        return depth, sigma, newly, it + 1

    depth, sigma, _, levels = jax.lax.while_loop(
        fwd_cond, fwd_body,
        (depth, sigma, frontier, jnp.asarray(0, jnp.int32)))

    delta = jnp.zeros(vp, jnp.float32)

    def bwd_cond(carry):
        delta, d = carry
        return d > 0

    def bwd_body(carry):
        delta, d = carry
        ratio = (1.0 + delta) / jnp.maximum(sigma, 1e-30)
        x = jnp.where(depth == d, ratio, 0.0)
        y = _spmv_engine_call(g, x, unit=True)[:vp]
        delta = jnp.where(depth == d - 1, sigma * y, delta)
        return delta, d - 1

    delta, _ = jax.lax.while_loop(bwd_cond, bwd_body, (delta, levels))
    delta = jnp.where(jnp.arange(vp) == source, 0.0, delta)
    return delta, depth, levels


@partial(jax.jit, static_argnums=(2,))
def _bc_single_spmv(g: Graph, source, max_depth: int):
    delta, _, levels = _single_source_deps_spmv(g, source, max_depth)
    return delta, levels


def run(g: Graph, source: int, *, max_depth: int | None = None,
        warmup: bool = True, variant: str = "auto") -> BcResult:
    """Single-source BC contribution (reference bc.hxx single-source
    mode). variant: 'auto' (SpMV engine on symmetric graphs), 'spmv',
    'generic'."""
    md = max_depth or g.n_vertices + 1
    if variant in ("auto", "spmv") and spmv_supported(g):
        fn = _bc_single_spmv
    else:
        fn = _bc_single
    if warmup:
        jax.block_until_ready(fn(g, source, md))
    t = Timer().begin()
    delta, levels = fn(g, source, md)
    ms = t.end(sync=(delta, levels))
    return BcResult(delta[:g.n_vertices], int(levels), ms)


def run_all(g: Graph, *, sources=None, chunk: int = 32,
            max_depth: int | None = None, normalize_undirected: bool = True,
            warmup: bool = True) -> BcResult:
    """All-sources (or a source subset) BC: vmapped chunks of single-source
    programs summed (batch-operator parity, batch/batch.hxx:61-81)."""
    md = max_depth or g.n_vertices + 1
    if sources is None:
        sources = np.arange(g.n_vertices)
    sources = np.asarray(sources)

    @partial(jax.jit, static_argnums=(2,))
    def chunk_fn(g, srcs, md):
        deltas, _ = jax.vmap(lambda s: _bc_single(g, s, md))(srcs)
        return jnp.sum(deltas, axis=0)

    # pad sources to a multiple of chunk with repeats of the first (their
    # duplicate contribution is subtracted below)
    n_pad = (-len(sources)) % chunk
    padded = np.concatenate([sources, np.full(n_pad, sources[0])])
    if warmup:
        jax.block_until_ready(chunk_fn(g, jnp.asarray(padded[:chunk]), md))
    t = Timer().begin()
    total = jnp.zeros(g.n_vertices_padded, jnp.float32)
    for i in range(0, len(padded), chunk):
        total = total + chunk_fn(g, jnp.asarray(padded[i:i + chunk]), md)
    if n_pad:
        dup, _ = _bc_single(g, int(sources[0]), md)
        total = total - n_pad * dup
    if normalize_undirected:
        total = total * 0.5
    ms = t.end(sync=total)
    return BcResult(total[:g.n_vertices], len(sources), ms)


def cpu_reference(csr, sources=None, normalize_undirected: bool = True):
    """Host Brandes (reference parity: examples/algorithms/bc/bc_cpu.hxx)."""
    from collections import deque
    n = csr.n_rows
    off = np.asarray(csr.row_offsets)
    cols = np.asarray(csr.col_indices)
    if sources is None:
        sources = range(n)
    bc = np.zeros(n)
    for s in sources:
        sigma = np.zeros(n)
        sigma[s] = 1.0
        dist = np.full(n, -1)
        dist[s] = 0
        order = []
        q = deque([s])
        while q:
            u = q.popleft()
            order.append(u)
            for e in range(off[u], off[u + 1]):
                v = cols[e]
                if dist[v] < 0:
                    dist[v] = dist[u] + 1
                    q.append(v)
                if dist[v] == dist[u] + 1:
                    sigma[v] += sigma[u]
        delta = np.zeros(n)
        for u in reversed(order):
            for e in range(off[u], off[u + 1]):
                v = cols[e]
                if dist[v] == dist[u] + 1:
                    delta[u] += sigma[u] / sigma[v] * (1.0 + delta[v])
        delta[s] = 0.0
        bc += delta
    if normalize_undirected:
        bc *= 0.5
    return bc.astype(np.float32)
