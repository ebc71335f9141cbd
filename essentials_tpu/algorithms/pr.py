"""PageRank (push-style with dangling-mass redistribution).

Reference parity: gunrock::pr (/root/reference/include/gunrock/algorithms/
pr.hxx:77-216): precomputed inverse out-weight-sums, dangling-rank
redistribution, atomicAdd spread, L1/L-inf convergence. The spread is
one segment-SUM over the dst-sorted edge axis; convergence is an
on-device reduction inside the while_loop (the reference pays a host
round-trip per iteration, pr.hxx:155-178).
"""

from __future__ import annotations

from typing import NamedTuple
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from essentials_tpu.framework.enactor import enact, EnactResult
from essentials_tpu.graph.graph import Graph
from essentials_tpu.ops import advance, neighbor_reduce, Combine, AdvanceIO


class PrState(NamedTuple):
    ranks: jax.Array        # float32[Vp]
    err: jax.Array          # scalar L1 delta of last step
    iweights: jax.Array     # float32[Vp]: alpha / sum of out-edge weights
    alpha: jax.Array        # scalar
    tol: jax.Array          # scalar


class PrResult(NamedTuple):
    ranks: jax.Array
    iterations: int
    elapsed_ms: float


def init(g: Graph, alpha: float = 0.85, tol: float = 1e-6) -> PrState:
    vp = g.n_vertices_padded
    # Reference pr.hxx:77-90: iweight[v] = alpha / sum_w(out edges of v).
    wsum = neighbor_reduce(g, lambda e: e.weight, combine=Combine.SUM)
    iweights = jnp.where(wsum > 0, alpha / wsum, 0.0).astype(jnp.float32)
    ranks = jnp.where(g.vertex_mask(), 1.0 / g.n_vertices, 0.0).astype(jnp.float32)
    return PrState(ranks, jnp.asarray(jnp.inf, jnp.float32), iweights,
                   jnp.asarray(alpha, jnp.float32), jnp.asarray(tol, jnp.float32))


def step(g: Graph, state: PrState, it) -> PrState:
    ranks, _, iweights, alpha, tol = state
    # dangling mass (vertices with no out-weight) redistributed uniformly
    dangling = jnp.sum(jnp.where((iweights == 0.0) & g.vertex_mask(), ranks, 0.0))
    base = (1.0 - alpha) / g.n_vertices + alpha * dangling / g.n_vertices
    contrib = ranks * iweights          # per-vertex work stays on the vertex axis
    spread = advance(g, lambda e: e.src_vals[0] * e.weight, None,
                     src_values=(contrib,), input_kind=AdvanceIO.GRAPH,
                     combine=Combine.SUM, with_frontier=False)
    new_ranks = jnp.where(g.vertex_mask(), base + spread, 0.0)
    err = jnp.sum(jnp.abs(new_ranks - ranks))
    return PrState(new_ranks, err, iweights, alpha, tol)


def converged(g: Graph, state: PrState, it) -> jax.Array:
    return state.err < state.tol


def _spmv_engine_call(g, x, unit: bool = False):
    """One y = A @ x on the pull engine; unit=True drops the weight factor
    (unweighted sum)."""
    from essentials_tpu.algorithms import spmv as SP
    if unit:
        return neighbor_reduce(g, lambda e: e.dst_vals[0],
                               dst_values=(x,), combine=Combine.SUM)
    return SP.spmv_pull(g, x)


@partial(jax.jit, static_argnums=(4,))
def _run_spmv_compiled(g: Graph, iweights, alpha, tol, max_iterations):
    """Power iteration with the whole spread as ONE pull SpMV per
    iteration (valid when A == A^T). State stays on the vertex axis."""
    n = g.n_vertices
    mask = g.vertex_mask()
    r0 = jnp.where(mask, 1.0 / n, 0.0).astype(jnp.float32)
    dang_mask = (iweights == 0.0) & mask

    def cond(c):
        r, err, it = c
        return (it < max_iterations) & (err > tol)

    def body(c):
        r, _, it = c
        dangling = jnp.sum(jnp.where(dang_mask, r, 0.0))
        base = (1.0 - alpha) / n + alpha * dangling / n
        contrib = r * iweights
        spread = _spmv_engine_call(g, contrib)
        if spread.shape[0] < r.shape[0]:
            spread = jnp.pad(spread, (0, r.shape[0] - spread.shape[0]))
        r_new = jnp.where(mask, base + spread[:r.shape[0]], 0.0)
        err = jnp.sum(jnp.abs(r_new - r))
        return r_new, err, it + 1

    r, _, it = jax.lax.while_loop(
        cond, body, (r0, jnp.float32(jnp.inf), jnp.int32(0)))
    return r, it


def run(g: Graph, *, alpha: float = 0.85, tol: float = 1e-6,
        max_iterations: int = 500, warmup: bool = True,
        variant: str = "auto") -> PrResult:
    """variant: 'auto' (spmv on symmetric layouts, else generic), 'spmv'
    or 'generic'. The spmv engine computes the src-keyed pull sum, which
    equals PR's dst-keyed spread only when A == A^T (symmetric layout);
    directed graphs use the generic push formulation."""
    if (variant == "auto" and g.symmetric_layout) or variant == "spmv":
        import time as _time
        st0 = init(g, alpha, tol)
        if warmup:
            jax.block_until_ready(_run_spmv_compiled(
                g, st0.iweights, alpha, tol, max_iterations))
        t0 = _time.perf_counter()
        ranks, it = jax.block_until_ready(_run_spmv_compiled(
            g, st0.iweights, alpha, tol, max_iterations))
        elapsed = (_time.perf_counter() - t0) * 1e3
        return PrResult(ranks[:g.n_vertices], int(it), elapsed)
    res: EnactResult = enact(step, converged, g, init(g, alpha, tol),
                             max_iterations=max_iterations, warmup=warmup)
    return PrResult(res.state.ranks[:g.n_vertices], res.iterations,
                    res.elapsed_ms)


def cpu_reference(csr, alpha: float = 0.85, tol: float = 1e-6,
                  max_iterations: int = 500) -> np.ndarray:
    """Host power iteration with weighted spread + dangling redistribution."""
    n = csr.n_rows
    off = np.asarray(csr.row_offsets)
    cols = np.asarray(csr.col_indices)
    vals = np.asarray(csr.values, np.float64)
    wsum = np.zeros(n)
    np.add.at(wsum, np.repeat(np.arange(n), np.diff(off)), vals)
    src = np.repeat(np.arange(n), np.diff(off))
    pr = np.full(n, 1.0 / n)
    for _ in range(max_iterations):
        contrib = np.where(wsum > 0, alpha * pr / np.maximum(wsum, 1e-300), 0.0)
        nxt = np.zeros(n)
        np.add.at(nxt, cols, contrib[src] * vals)
        dangling = pr[wsum == 0].sum()
        new = (1 - alpha) / n + alpha * dangling / n + nxt
        if np.abs(new - pr).sum() < tol:
            return new.astype(np.float32)
        pr = new
    return pr.astype(np.float32)
