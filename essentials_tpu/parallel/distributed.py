"""Distributed supersteps: shard_map + XLA collectives over the mesh.

The per-superstep recipe:
  1. exchange the sharded frontier/value vector over the mesh axis:
     either `all_gather` (full [Vtot] replica) or — when the partitioner
     chose boundary mode — gather each owner's STATIC requested-vertex sets
     and `all_to_all` exactly those values ([P, Smax] per device; comm
     volume P*Smax instead of Vtot — DistGraph.comm_values_per_step);
  2. local expansion of the exchanged vector along the device's
     source-sorted edge block (telescoping cumsum — same engine as
     single-device, ops/segment.py);
  3. one gather by the static index into local-dst order + offset-based
     combine;
  4. psum scalar for convergence.
Everything lives inside one jitted shard_map while_loop: no host round-trips.

Distributed BFS, SSSP and PageRank are the reference patterns; any
advance-based algorithm ports by swapping the expansion/combine pair.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from essentials_tpu.ops.configs import Combine
from essentials_tpu.ops.segment import expand_vertex_to_edges, combine_by_offsets
from essentials_tpu.parallel.partition import DistGraph

AXIS = "v"


def _spread_local(x_full, soff, route, es):
    """Common local step: expand exchanged values along the local
    source-sorted edge axis and gather them into local dst order
    (``route`` is the static [Es] gather index). Returns dst-ordered
    per-edge values [Es]."""
    fe = expand_vertex_to_edges(x_full, soff, es)
    return fe[route]


def _soff(dg: DistGraph):
    """Expansion offsets for the exchanged source vector (mode-dependent)."""
    return dg.csrc_offsets if dg.boundary_size else dg.src_offsets


def _send(dg: DistGraph):
    """send_idx (boundary mode) or a tiny dummy that rides the same specs."""
    if dg.boundary_size:
        return dg.send_idx
    import jax.numpy as _jnp
    return _jnp.zeros((dg.n_devices, dg.n_devices, 8), _jnp.int32)


def _overlap_sweep(dg: DistGraph, vals, send_idx_l, offsets_l,
                   peer_route_l, peer_doff_l, peer_elo_l, wpad_l,
                   combine: Combine, ident, msg=None):
    """Comm/compute-overlapped superstep (SURVEY §5): ring-exchange the
    per-peer chunks and expand/route/combine each chunk AS IT ARRIVES,
    accumulating partial per-destination combines associatively.

    The P-1 ppermute steps are software-pipelined (the next chunk's
    exchange is issued before the current chunk's local work), so XLA's
    async collectives can hide link latency behind the local expansion.
    Exact by construction: per-peer partial combines over disjoint edge
    sets, folded with the same associative `combine`.

    vals [Vs] owned values; msg(fe, w_slice) optional per-edge transform;
    returns combined [Vs]."""
    P_ = dg.n_devices
    eq = dg.peer_edges
    vs = dg.block_size
    span = dg.boundary_size if dg.boundary_size else dg.block_size
    d = jax.lax.axis_index(AXIS)

    def chunk_for_step(k):
        """Chunk of source values from peer (d-k)%P (k=0: my own)."""
        if dg.boundary_size:
            row = jnp.take(vals[send_idx_l], (d + k) % P_, axis=0)
        else:
            row = vals
        if k == 0:
            return row
        perm = [(j, (j + k) % P_) for j in range(P_)]
        return jax.lax.ppermute(row, AXIS, perm)

    def process(acc, chunk, q):
        lo = peer_elo_l[q]
        offs = jax.lax.dynamic_slice(offsets_l, (q * span,), (span + 1,))
        offs = jnp.clip(offs - lo, 0, eq)
        offs2 = jnp.concatenate([offs, jnp.full(1, eq, offs.dtype)])
        cv = jnp.concatenate([chunk, jnp.full(1, ident, chunk.dtype)])
        fe = expand_vertex_to_edges(cv, offs2, eq)
        if msg is not None:
            wq = jax.lax.dynamic_slice(wpad_l, (lo,), (eq,))
            fe = msg(fe, wq)
        fed = fe[peer_route_l[q]]
        doff_q = peer_doff_l[q]
        flags = _dst_seg_flags(doff_q, eq) \
            if combine in (Combine.MIN, Combine.MAX) else None
        part = combine_by_offsets(fed, doff_q, combine, seg_flags=flags)[:vs]
        if combine == Combine.OR:
            return acc | part
        if combine == Combine.SUM:
            return acc + part
        if combine == Combine.MIN:
            return jnp.minimum(acc, part)
        return jnp.maximum(acc, part)

    acc0 = jnp.full(vs, ident, vals.dtype) if combine != Combine.OR \
        else jnp.zeros(vs, jnp.bool_)
    acc = process(acc0, chunk_for_step(0), d)
    nxt = chunk_for_step(1) if P_ > 1 else None
    for k in range(1, P_):
        cur = nxt
        nxt = chunk_for_step(k + 1) if k + 1 < P_ else None
        acc = process(acc, cur, (d - k) % P_)
    return acc


def _exchanger(dg: DistGraph, send_idx_l):
    """Per-superstep value exchange: vals [Vs] -> source vector + its
    expansion offsets length contract. Static mode pick (boundary_size is
    pytree metadata)."""
    if dg.boundary_size:
        def exchange(vals):
            send = vals[send_idx_l]                      # [P, Smax]
            recv = jax.lax.all_to_all(send, AXIS, split_axis=0,
                                      concat_axis=0, tiled=True)
            # pad slot for the pad-edge segment (csrc_offsets has one)
            pad = jnp.zeros(1, vals.dtype)
            return jnp.concatenate([recv.reshape(-1), pad])
        return exchange

    def exchange(vals):
        return jax.lax.all_gather(vals, AXIS, tiled=True)
    return exchange


def _place(mesh, specs, args):
    """Multi-controller placement: under process_count > 1 jit cannot
    accept plain host arrays for cross-process shardings, so every dist_*
    input is routed through multihost.to_global (identity when
    single-process)."""
    if jax.process_count() == 1:
        return args
    from essentials_tpu.parallel import multihost
    return tuple(
        jax.tree_util.tree_map(
            lambda x, s=spec: multihost.to_global(mesh, s, x), a)
        for spec, a in zip(specs, args))


def _peer_args(dg: DistGraph, overlap: bool):
    if not overlap:
        return (), ()
    if not dg.peer_edges:
        raise ValueError("overlap mode needs partition_graph(..., "
                         "overlap=True)")
    return ((dg.peer_route, dg.peer_dst_offsets, dg.peer_edge_starts),
            (P(AXIS, None, None), P(AXIS, None, None), P(AXIS, None)))


def dist_bfs(dg: DistGraph, mesh: Mesh, source: int, *,
             max_iterations: int | None = None, overlap: bool = False):
    """Multi-device BFS. Returns global distances [Vtot] (UNREACHED=int32max).

    overlap=True processes each peer's exchanged chunk as it arrives off
    the ring instead of a monolithic exchange-then-expand superstep."""
    unreached = jnp.iinfo(jnp.int32).max
    vtot = dg.n_vertices_global
    vs = dg.block_size
    es = dg.edges_per_device
    max_it = max_iterations or dg.n_vertices + 1
    extra, extra_specs = _peer_args(dg, overlap)

    @partial(jax.shard_map, mesh=mesh,
             in_specs=(P(AXIS, None), P(AXIS, None), P(AXIS, None),
                       P(AXIS, None), P(AXIS, None, None), P(AXIS),
                       P(AXIS)) + extra_specs,
             out_specs=P(AXIS), check_vma=False)
    def run(soff, doff, route, vvalid, send, dist0, frontier0, *peer):
        soff, doff, vvalid = soff[0], doff[0], vvalid[0]
        route_l = route[0]
        exchange = _exchanger(dg, send[0])
        if overlap:
            pr_l = peer[0][0]
            pdoff_l, pelo_l = peer[1][0], peer[2][0]
            wdummy = jnp.zeros(1, jnp.int8)

        def cond(carry):
            dist, frontier, it = carry
            total = jax.lax.psum(jnp.any(frontier).astype(jnp.int32), AXIS)
            return jnp.logical_and(it < max_it,
                                   jnp.logical_or(it == 0, total > 0))

        def body(carry):
            dist, frontier, it = carry
            if overlap:
                reached = _overlap_sweep(
                    dg, frontier.astype(jnp.int8), send[0], soff,
                    pr_l, pdoff_l, pelo_l, wdummy, Combine.OR,
                    jnp.int8(0))
            else:
                f_src = exchange(frontier.astype(jnp.int8))
                fe = _spread_local(f_src, soff, route_l, es)
                reached = combine_by_offsets(fe != 0, doff, Combine.OR)[:vs]
            newly = reached & (dist == unreached) & vvalid
            dist = jnp.where(newly, it + 1, dist)
            return dist, newly, it + 1

        dist, _, _ = jax.lax.while_loop(cond, body, (dist0, frontier0, 0))
        return dist

    dist0 = jnp.full(vtot, unreached, jnp.int32).at[source].set(0)
    frontier0 = jnp.zeros(vtot, jnp.bool_).at[source].set(True)
    specs = (P(AXIS, None), P(AXIS, None), P(AXIS, None), P(AXIS, None),
             P(AXIS, None, None), P(AXIS), P(AXIS)) + extra_specs
    args = _place(mesh, specs,
                  (_soff(dg), dg.dst_offsets, dg.route, dg.vertex_valid,
                   _send(dg), dist0, frontier0) + tuple(extra))
    return run(*args)


def dist_sssp(dg: DistGraph, mesh: Mesh, source: int, *,
              max_iterations: int | None = None, overlap: bool = False):
    """Multi-device SSSP (Bellman-Ford frontier relaxation): per superstep,
    all_gather the sharded distance vector, relax every local edge
    (dist[src] + w), MIN-combine per owned destination; converge when no
    distance improved anywhere (psum'd flag). Returns distances [Vtot]
    (unreached = +inf). overlap=True: per-peer ring processing."""
    vtot = dg.n_vertices_global
    vs = dg.block_size
    es = dg.edges_per_device
    max_it = max_iterations or dg.n_vertices + 1
    extra, extra_specs = _peer_args(dg, overlap)

    @partial(jax.shard_map, mesh=mesh,
             in_specs=(P(AXIS, None), P(AXIS, None), P(AXIS, None),
                       P(AXIS, None), P(AXIS, None), P(AXIS, None, None),
                       P(AXIS)) + extra_specs,
             out_specs=P(AXIS), check_vma=False)
    def run(soff, doff, route, w, vvalid, send, dist0, *peer):
        soff, doff, vvalid = soff[0], doff[0], vvalid[0]
        route_l = route[0]
        exchange = _exchanger(dg, send[0])
        if overlap:
            pr_l = peer[0][0]
            pdoff_l, pelo_l = peer[1][0], peer[2][0]
            wpad = jnp.pad(w[0], (0, dg.peer_edges))
        else:
            # static per-device data: weights to dst order once
            we = w[0][route_l]

        def cond(carry):
            dist, improved, it = carry
            total = jax.lax.psum(improved.astype(jnp.int32), AXIS)
            return jnp.logical_and(it < max_it,
                                   jnp.logical_or(it == 0, total > 0))

        def body(carry):
            dist, _, it = carry
            if overlap:
                cand = _overlap_sweep(
                    dg, dist, send[0], soff, pr_l, pdoff_l, pelo_l, wpad,
                    Combine.MIN, jnp.float32(jnp.inf),
                    msg=lambda de, wq: jnp.where(jnp.isfinite(de),
                                                 de + wq, jnp.inf))
            else:
                d_src = exchange(dist)
                de = _spread_local(d_src, soff, route_l, es)
                cand = combine_by_offsets(
                    jnp.where(jnp.isfinite(de), de + we, jnp.inf), doff,
                    Combine.MIN,
                    seg_flags=_dst_seg_flags(doff, es))[:vs]
            better = vvalid & (cand < dist)
            dist = jnp.where(better, cand, dist)
            return dist, jnp.any(better), it + 1

        dist, _, _ = jax.lax.while_loop(
            cond, body, (dist0, jnp.asarray(False), 0))
        return dist

    dist0 = jnp.full(vtot, jnp.inf, jnp.float32).at[source].set(0.0)
    specs = (P(AXIS, None), P(AXIS, None), P(AXIS, None), P(AXIS, None),
             P(AXIS, None), P(AXIS, None, None), P(AXIS)) + extra_specs
    args = _place(mesh, specs,
                  (_soff(dg), dg.dst_offsets, dg.route, dg.weights,
                   dg.vertex_valid, _send(dg), dist0) + tuple(extra))
    return run(*args)


def _dst_seg_flags(doff, es):
    """Static segment-start flags over the local dst-sorted edge axis."""
    flags = jnp.zeros(es, jnp.bool_)
    starts = jnp.clip(doff[:-1], 0, es - 1)
    nonempty = doff[1:] > doff[:-1]
    return flags.at[starts].max(nonempty)


def dist_pagerank(dg: DistGraph, mesh: Mesh, *, alpha: float = 0.85,
                  tol: float = 1e-6, max_iterations: int = 100,
                  overlap: bool = False):
    """Multi-device PageRank (unweighted spread). Returns ranks [Vtot].
    overlap=True: per-peer ring processing."""
    vtot = dg.n_vertices_global
    vs = dg.block_size
    es = dg.edges_per_device
    nv = dg.n_vertices
    extra, extra_specs = _peer_args(dg, overlap)

    @partial(jax.shard_map, mesh=mesh,
             in_specs=(P(AXIS, None), P(AXIS, None), P(AXIS, None),
                       P(AXIS, None), P(AXIS, None), P(AXIS, None, None),
                       P(AXIS)) + extra_specs,
             out_specs=P(AXIS), check_vma=False)
    def run(soff, doff, route, vvalid, odeg, send, p0, *peer):
        soff, doff, vvalid, odeg = soff[0], doff[0], vvalid[0], odeg[0]
        route_l = route[0]
        exchange = _exchanger(dg, send[0])
        if overlap:
            pr_l = peer[0][0]
            pdoff_l, pelo_l = peer[1][0], peer[2][0]
            wdummy = jnp.zeros(1, jnp.float32)

        def cond(carry):
            p, err, it = carry
            return jnp.logical_and(it < max_iterations, err > tol)

        def body(carry):
            p, _, it = carry
            # contributions computed owner-side, then exchanged
            contrib = jnp.where(odeg > 0, p / odeg, 0.0)
            if overlap:
                pulled = _overlap_sweep(
                    dg, contrib, send[0], soff, pr_l, pdoff_l, pelo_l,
                    wdummy, Combine.SUM, jnp.float32(0))
            else:
                c_src = exchange(contrib)
                msg = _spread_local(c_src, soff, route_l, es)
                pulled = combine_by_offsets(msg, doff, Combine.SUM)[:vs]
            dangling_local = jnp.sum(jnp.where(vvalid & (odeg == 0), p, 0.0))
            dangling = jax.lax.psum(dangling_local, AXIS)
            base = (1.0 - alpha) / nv + alpha * dangling / nv
            p_new = jnp.where(vvalid, base + alpha * pulled, 0.0)
            err = jax.lax.psum(jnp.sum(jnp.abs(p_new - p)), AXIS)
            return p_new, err, it + 1

        p, _, _ = jax.lax.while_loop(cond, body, (p0, jnp.inf, 0))
        return p

    p0 = jnp.where(jnp.arange(vtot) < nv, 1.0 / nv, 0.0).astype(jnp.float32)
    specs = (P(AXIS, None), P(AXIS, None), P(AXIS, None), P(AXIS, None),
             P(AXIS, None), P(AXIS, None, None), P(AXIS)) + extra_specs
    args = _place(mesh, specs,
                  (_soff(dg), dg.dst_offsets, dg.route, dg.vertex_valid,
                   dg.out_degrees, _send(dg), p0) + tuple(extra))
    return run(*args)
