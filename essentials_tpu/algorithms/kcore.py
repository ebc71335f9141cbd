"""k-core decomposition (iterative peeling).

Reference parity: gunrock::kcore (/root/reference/include/gunrock/algorithms/
kcore.hxx:148-199): for k = 1,2,...: repeatedly delete vertices with
remaining degree < k (their core number is k-1... the reference assigns k to
vertices removed *during* round k); converges when all vertices deleted.
One while_loop over (k, inner peeling) flattened into a single
step function — a vertex's core number is the largest k at which it survives
the peeling of round k.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from essentials_tpu.framework.enactor import enact, EnactResult
from essentials_tpu.graph.graph import Graph
from essentials_tpu.ops import advance_count
from essentials_tpu.ops.sparse_advance import (
    spray_enabled, compact_frontier, frontier_out_degree, spray_candidates,
    spray_dedup, SPRAY_BUDGET, SPRAY_K, TINY_BUDGET, TINY_K)


class KcoreState(NamedTuple):
    core: jax.Array         # int32[Vp] assigned core numbers
    degrees: jax.Array      # int32[Vp] remaining degree
    alive: jax.Array        # bool[Vp]
    k: jax.Array            # current peeling level
    fidx: jax.Array         # int32[SPRAY_K] peel-candidate tracking list
    fvalid: jax.Array       # bool: fidx is a superset of the next peel set


class KcoreResult(NamedTuple):
    core: jax.Array
    iterations: int
    elapsed_ms: float


def init(g: Graph) -> KcoreState:
    deg = jnp.where(g.vertex_mask(), g.out_degrees(), 0).astype(jnp.int32)
    core = jnp.zeros(g.n_vertices_padded, jnp.int32)
    return KcoreState(core, deg, g.vertex_mask(), jnp.asarray(1, jnp.int32),
                      jnp.full(SPRAY_K, g.pad_vertex, jnp.int32),
                      jnp.asarray(False))


def step(g: Graph, state: KcoreState, it, spray_override=None) -> KcoreState:
    """One peeling sweep. Empty peels jump k straight to
    min(remaining degree)+1 (collapsing the reference's one-at-a-time
    k bumps, kcore.hxx:158-178); small peel sets run the budgeted spray
    path (O(sum of peeled degrees), degree-skew tolerant) instead of the
    dense O(E) advance.

    Candidate tracking: within one k level, the next wave's
    peel set is a subset of the current wave's touched neighbors — the
    spray branch already holds that set (``nb``), so it dedups it into a
    tracking list and the NEXT sparse wave filters the list instead of
    paying compact_frontier's [Vp]-sized sort once per wave. The full
    compaction remains only where the subset argument breaks: after a k
    bump and after a dense wave."""
    core, deg, alive, k, fidx, fvalid = state
    vp = g.n_vertices_padded
    pad = g.pad_vertex
    imax = jnp.iinfo(jnp.int32).max

    peel = alive & (deg < k)
    # removed vertices get core number k-1
    core = jnp.where(peel, k - 1, core)
    alive = alive & ~peel

    nofidx = jnp.full(SPRAY_K, pad, jnp.int32)

    def dense(_):
        out = advance_count(g, peel)
        return core, deg - out.astype(jnp.int32), alive, nofidx, \
            jnp.asarray(False)

    def skip(_):
        return core, deg, alive, nofidx, jnp.asarray(False)

    cnt = jnp.count_nonzero(peel)
    use_spray = spray_enabled(g) if spray_override is None else spray_override
    if use_spray:
        def spray_wave(budget, kk):
            """Budget-tiered spray wave: gather/sort costs scale with the
            tier's budget, so the many late-cascade waves that peel a
            handful of vertices run the tiny tier, like bfs.step's 3-way
            ladder."""
            def go(_):
                idx = jax.lax.cond(
                    fvalid,
                    lambda: spray_dedup(fidx[:kk], peel[fidx[:kk]], kk,
                                        pad)[1],
                    lambda: compact_frontier(peel, kk, pad))
                offs, d0 = frontier_out_degree(g, idx)
                _, nb, _, valid = spray_candidates(g, idx, offs, d0,
                                                   budget)
                deg2 = deg.at[nb].add(-valid.astype(jnp.int32),
                                      mode="drop")
                # track the touched neighbors for the next wave's filter
                _, nidx, ncnt = spray_dedup(nb, valid, kk, pad)
                if kk < SPRAY_K:
                    nidx = jnp.concatenate(
                        [nidx, jnp.full(SPRAY_K - kk, pad, jnp.int32)])
                return core, deg2, alive, nidx, ncnt <= kk
            return go

        # spray gate: the peeled vertices' ORIGINAL out-edges must fit the
        # budget (peeled degree < k only counts surviving neighbors).
        # The tiny tier additionally requires a currently-valid tracking
        # list that fits its index capacity (the filter gather is
        # kk-sized, so an un-tracked wave must pay the full compaction
        # at SPRAY_K anyway).
        deg0 = g.out_degrees()
        sumdeg = jnp.sum(jnp.where(peel, deg0, 0))
        tiny_ok = fvalid & (cnt <= TINY_K) & (sumdeg <= TINY_BUDGET) & \
            jnp.all(fidx[TINY_K:] == pad)
        branch = jnp.where(cnt == 0, 0,
                           jnp.where(tiny_ok, 1,
                                     jnp.where((cnt <= SPRAY_K)
                                               & (sumdeg <= SPRAY_BUDGET),
                                               2, 3)))
        core, deg, alive, fidx, fvalid = jax.lax.switch(
            branch.astype(jnp.int32),
            [skip, spray_wave(TINY_BUDGET, TINY_K),
             spray_wave(SPRAY_BUDGET, SPRAY_K), dense], None)
    else:
        core, deg, alive, fidx, fvalid = jax.lax.cond(cnt == 0, skip,
                                                      dense, None)
    # empty sweep: jump k past the levels no vertex can peel at
    min_alive_deg = jnp.min(jnp.where(alive, deg, imax))
    k = jnp.where(cnt > 0, k, jnp.maximum(k + 1, min_alive_deg + 1))
    return KcoreState(core, deg, alive, k, fidx, fvalid)


def converged(g: Graph, state: KcoreState, it) -> jax.Array:
    return jnp.logical_not(jnp.any(state.alive))


def _step_spray_on(g, state, it):
    return step(g, state, it, spray_override=True)


def _step_spray_off(g, state, it):
    return step(g, state, it, spray_override=False)


_STEP_BY_OVERRIDE = {None: step, True: _step_spray_on,
                     False: _step_spray_off}


def run(g: Graph, *, max_iterations: int | None = None,
        warmup: bool = True, spray_override=None) -> KcoreResult:
    """Vertex-axis peeling sweeps with spray waves. spray_override forces
    the spray branch on/off regardless of graph size (tests use it to
    drive the tracked-candidate waves on small graphs)."""
    max_it = max_iterations if max_iterations is not None else 4 * g.n_vertices + 8

    # step_fn is a static argnum of the enactor's jit: pass a STABLE
    # object per spray_override value so repeat calls hit the jit cache.
    step_fn = _STEP_BY_OVERRIDE[spray_override]
    res: EnactResult = enact(step_fn, converged, g, init(g),
                             max_iterations=max_it, warmup=warmup)
    return KcoreResult(res.state.core[:g.n_vertices], res.iterations,
                       res.elapsed_ms)


def cpu_reference(csr) -> np.ndarray:
    """Host peeling reference (matula-beck style)."""
    n = csr.n_rows
    off = np.asarray(csr.row_offsets)
    cols = np.asarray(csr.col_indices)
    deg = np.diff(off).astype(np.int64).copy()
    alive = np.ones(n, bool)
    core = np.zeros(n, np.int32)
    k = 1
    while alive.any():
        while True:
            peel = alive & (deg < k)
            if not peel.any():
                break
            core[peel] = k - 1
            alive &= ~peel
            for u in np.nonzero(peel)[0]:
                for e in range(off[u], off[u + 1]):
                    deg[cols[e]] -= 1
        k += 1
    return core
