"""HITS (hubs & authorities).

Reference parity: gunrock::hits (/root/reference/include/gunrock/algorithms/
hits.hxx:118-271): per iteration a full-graph edge sweep updates
auth[dst] += hub[src] and hub[src] += auth[dst] (two atomicAdds there, two
segment-SUMs here), followed by L2 normalization; fixed iteration count or
unchanged-vector convergence. Results ranked by sorted order.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from essentials_tpu.framework.enactor import enact, EnactResult
from essentials_tpu.graph.graph import Graph
from essentials_tpu.ops import advance, neighbor_reduce, Combine, AdvanceIO


class HitsState(NamedTuple):
    auth: jax.Array
    hub: jax.Array
    delta: jax.Array


class HitsResult(NamedTuple):
    auth: jax.Array
    hub: jax.Array
    iterations: int
    elapsed_ms: float


def init(g: Graph) -> HitsState:
    ones = jnp.where(g.vertex_mask(), 1.0, 0.0).astype(jnp.float32)
    return HitsState(ones, ones, jnp.asarray(jnp.inf, jnp.float32))


def step(g: Graph, state: HitsState, it) -> HitsState:
    auth, hub, _ = state
    # auth[d] = sum over in-edges (s->d) hub[s]  (dst-keyed segment sum)
    new_auth = advance(g, lambda e: e.src_vals[0], None,
                       src_values=(hub,), input_kind=AdvanceIO.GRAPH,
                       combine=Combine.SUM, with_frontier=False)
    # hub[s] = sum over out-edges (s->d) auth[d] (src-keyed segment sum)
    new_hub = neighbor_reduce(g, lambda e: e.dst_vals[0],
                              dst_values=(new_auth,), combine=Combine.SUM)
    na = new_auth / jnp.maximum(jnp.linalg.norm(new_auth), 1e-12)
    nh = new_hub / jnp.maximum(jnp.linalg.norm(new_hub), 1e-12)
    delta = jnp.sum(jnp.abs(na - auth)) + jnp.sum(jnp.abs(nh - hub))
    return HitsState(na.astype(jnp.float32), nh.astype(jnp.float32), delta)


def converged(g: Graph, state: HitsState, it) -> jax.Array:
    return state.delta < 1e-7


def spmv_supported(g: Graph) -> bool:
    """The SpMV-engine iteration needs A == A^T (symmetric layout): both
    half-steps are then the same unweighted y = A @ x."""
    return bool(g.symmetric_layout)


from functools import partial as _partial


@_partial(jax.jit, static_argnums=(1,))
def _run_spmv_compiled(g: Graph, max_iterations, hub0=None):
    """Both half-steps (auth[d] += hub[s], hub[s] += auth[d]) as ONE
    unweighted pull SpMV each (valid when A == A^T).
    hub0: optional initial hub vector."""
    from essentials_tpu.algorithms.pr import _spmv_engine_call
    mask = g.vertex_mask()
    ones = jnp.where(mask, 1.0, 0.0).astype(jnp.float32)
    if hub0 is not None:
        ones = jnp.where(mask, hub0, 0.0).astype(jnp.float32)

    def cond(c):
        auth, hub, delta, it = c
        return (it < max_iterations) & (delta >= 1e-7)

    def body(c):
        auth, hub, _, it = c
        new_auth = _spmv_engine_call(g, hub, unit=True)
        new_auth = jnp.where(mask, new_auth[:auth.shape[0]], 0.0)
        new_hub = _spmv_engine_call(g, new_auth, unit=True)
        new_hub = jnp.where(mask, new_hub[:hub.shape[0]], 0.0)
        na = new_auth / jnp.maximum(jnp.linalg.norm(new_auth), 1e-12)
        nh = new_hub / jnp.maximum(jnp.linalg.norm(new_hub), 1e-12)
        delta = jnp.sum(jnp.abs(na - auth)) + jnp.sum(jnp.abs(nh - hub))
        return na.astype(jnp.float32), nh.astype(jnp.float32), delta, it + 1

    auth, hub, _, it = jax.lax.while_loop(
        cond, body, (ones, ones, jnp.float32(jnp.inf), jnp.int32(0)))
    return auth, hub, it


def run(g: Graph, *, max_iterations: int = 50,
        warmup: bool = True, variant: str = "auto") -> HitsResult:
    """variant: 'auto' (SpMV engine on symmetric graphs, else generic),
    'spmv', 'generic'."""
    v = g.n_vertices
    if variant in ("auto", "spmv") and spmv_supported(g):
        import time as _time
        if warmup:
            jax.block_until_ready(_run_spmv_compiled(g, max_iterations))
        t0 = _time.perf_counter()
        auth, hub, it = jax.block_until_ready(
            _run_spmv_compiled(g, max_iterations))
        elapsed = (_time.perf_counter() - t0) * 1e3
        return HitsResult(auth[:v], hub[:v], int(it), elapsed)
    res: EnactResult = enact(step, converged, g, init(g),
                             max_iterations=max_iterations, warmup=warmup)
    return HitsResult(res.state.auth[:v], res.state.hub[:v],
                      res.iterations, res.elapsed_ms)


def rank(result: HitsResult, k: int = 10):
    """Top-k vertex ids by authority / hub score (reference: stable sort
    ranking, hits.hxx:54-64)."""
    auth_rank = np.argsort(-np.asarray(result.auth), kind="stable")[:k]
    hub_rank = np.argsort(-np.asarray(result.hub), kind="stable")[:k]
    return auth_rank, hub_rank


def cpu_reference(csr, max_iterations: int = 50):
    n = csr.n_rows
    off = np.asarray(csr.row_offsets)
    cols = np.asarray(csr.col_indices)
    src = np.repeat(np.arange(n), np.diff(off))
    auth = np.ones(n)
    hub = np.ones(n)
    for _ in range(max_iterations):
        na = np.zeros(n)
        np.add.at(na, cols, hub[src])
        nh = np.zeros(n)
        np.add.at(nh, src, na[cols])
        na /= max(np.linalg.norm(na), 1e-12)
        nh /= max(np.linalg.norm(nh), 1e-12)
        if np.abs(na - auth).sum() + np.abs(nh - hub).sum() < 1e-7:
            auth, hub = na, nh
            break
        auth, hub = na, nh
    return auth.astype(np.float32), hub.astype(np.float32)
