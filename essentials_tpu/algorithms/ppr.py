"""Personalized PageRank (Andersen push), single-seed and batched.

Reference parity: gunrock::ppr (/root/reference/include/gunrock/algorithms/
ppr.hxx:121-201): push-style local PPR — active vertices move
2a/(1+a) * r into p, spread (1-a)/(1+a) * r / deg to neighbors, and the
frontier is every vertex whose residual exceeds eps * deg. The reference's
`run_batch` (CPU thread per seed) becomes one vmapped XLA program over the
seed axis (operators/batch parity, strictly better).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from essentials_tpu.framework.enactor import enact, default_converged, EnactResult
from essentials_tpu.graph.graph import Graph
from essentials_tpu.ops import advance, Combine


class PprState(NamedTuple):
    p: jax.Array          # float32[Vp] personalized pagerank mass
    r: jax.Array          # float32[Vp] residual
    frontier: jax.Array   # bool[Vp]
    alpha: jax.Array
    eps: jax.Array


class PprResult(NamedTuple):
    p: jax.Array
    iterations: int
    elapsed_ms: float


def init(g: Graph, seed_vertex, alpha: float = 0.15,
         eps: float = 1e-6) -> PprState:
    vp = g.n_vertices_padded
    p = jnp.zeros(vp, jnp.float32)
    r = jnp.zeros(vp, jnp.float32).at[seed_vertex].set(1.0)
    frontier = jnp.zeros(vp, jnp.bool_).at[seed_vertex].set(True)
    return PprState(p, r, frontier, jnp.asarray(alpha, jnp.float32),
                    jnp.asarray(eps, jnp.float32))


def step(g: Graph, state: PprState, it) -> PprState:
    p, r, frontier, alpha, eps = state
    deg = g.out_degrees().astype(jnp.float32)
    c_keep = 2.0 * alpha / (1.0 + alpha)
    c_push = (1.0 - alpha) / (1.0 + alpha)

    p = p + jnp.where(frontier, c_keep * r, 0.0)
    push = jnp.where(frontier & (deg > 0), c_push * r / jnp.maximum(deg, 1.0), 0.0)
    inflow = advance(g, lambda e: e.src_vals[0], frontier,
                     src_values=(push,), combine=Combine.SUM,
                     with_frontier=False)
    r = jnp.where(frontier, 0.0, r) + inflow
    new_frontier = (r >= eps * deg) & (deg > 0) & g.vertex_mask()
    return PprState(p, r, new_frontier, alpha, eps)


def run(g: Graph, seed_vertex: int, *, alpha: float = 0.15, eps: float = 1e-6,
        max_iterations: int = 1000, warmup: bool = True) -> PprResult:
    res: EnactResult = enact(step, default_converged, g,
                             init(g, seed_vertex, alpha, eps),
                             max_iterations=max_iterations, warmup=warmup)
    return PprResult(res.state.p[:g.n_vertices], res.iterations, res.elapsed_ms)


def run_batch(g: Graph, seeds, *, alpha: float = 0.15, eps: float = 1e-6,
              max_iterations: int = 1000) -> jax.Array:
    """All seeds as ONE compiled program (vmapped while_loop); returns
    [n_seeds, V] pagerank vectors."""
    seeds = jnp.asarray(seeds)

    @jax.jit
    def one(seed):
        st = init(g, seed, alpha, eps)

        def cond(carry):
            state, it = carry
            return jnp.logical_and(it < max_iterations,
                                   jnp.any(state.frontier))

        def body(carry):
            state, it = carry
            return step(g, state, it), it + 1

        state, _ = jax.lax.while_loop(cond, body, (st, jnp.asarray(0)))
        return state.p[:g.n_vertices]

    return jax.vmap(one)(seeds)


def cpu_reference(csr, seed: int, alpha: float = 0.15, eps: float = 1e-6,
                  max_iterations: int = 1000) -> np.ndarray:
    n = csr.n_rows
    off = np.asarray(csr.row_offsets)
    cols = np.asarray(csr.col_indices)
    deg = np.diff(off)
    p = np.zeros(n)
    r = np.zeros(n)
    r[seed] = 1.0
    c_keep = 2 * alpha / (1 + alpha)
    c_push = (1 - alpha) / (1 + alpha)
    for it in range(max_iterations):
        if it == 0:
            frontier = np.asarray([seed])  # matches device prepare_frontier
        else:
            frontier = np.nonzero((r >= eps * deg) & (deg > 0))[0]
        if frontier.size == 0:
            break
        p[frontier] += c_keep * r[frontier]
        push = c_push * r[frontier] / deg[frontier]
        nr = r.copy()
        nr[frontier] = 0.0
        for i, u in enumerate(frontier):
            # add.at: a duplicated edge pushes once per copy
            np.add.at(nr, cols[off[u]:off[u + 1]], push[i])
        r = nr
    return p.astype(np.float32)
