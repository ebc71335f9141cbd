"""Enactor: compiled superstep loop.

Reference parity: enactor_t::enact()
(/root/reference/include/gunrock/framework/enactor.hxx:243-310): prepare ->
timed while(!converged) loop() -> finalize, where converged defaults to
"frontier empty". The while loop and the convergence predicate
are one `lax.while_loop` inside one jitted program. Double-buffered frontiers
disappear (functional state threading is the double buffer); the
`scanned_work_domain` scratch disappears (no output-size scans needed).

Caching contract: ``step_fn``/``converged_fn`` must be *top-level functions*
(stable identity across calls) of signature ``(graph, state, iteration)``.
The graph is a traced pytree argument, so all graphs with the same padded
shapes share one compiled executable.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from functools import partial
from typing import Any, Callable

import jax
import jax.numpy as jnp


@dataclass
class EnactResult:
    state: Any
    iterations: int
    elapsed_ms: float


@partial(jax.jit, static_argnums=(0, 1, 4))
def _enact_compiled(step_fn, converged_fn, graph, init_state, max_iterations):
    def cond(carry):
        state, it = carry
        done = jnp.logical_and(it > 0, converged_fn(graph, state, it))
        return jnp.logical_and(it < max_iterations, jnp.logical_not(done))

    def body(carry):
        state, it = carry
        return step_fn(graph, state, it), it + 1

    state, it = jax.lax.while_loop(
        cond, body, (init_state, jnp.asarray(0, jnp.int32)))
    return state, it


def default_converged(graph, state, iteration):
    """Reference default: stop when the frontier is empty
    (enactor.hxx:294-296). Expects ``state.frontier`` or ``state[-1]``."""
    frontier = getattr(state, "frontier", None)
    if frontier is None:
        frontier = state[-1]
    return jnp.logical_not(jnp.any(frontier))


def enact(step_fn: Callable, converged_fn: Callable | None, graph, init_state,
          *, max_iterations: int = 1 << 30, warmup: bool = True) -> EnactResult:
    """Run ``state = step_fn(graph, state, it)`` until
    ``converged_fn(graph, state, it)`` (on-device, checked before every
    iteration after the first) or ``max_iterations``.

    Timing protocol matches the reference (enact loop only, excludes graph
    build/IO; util/timer.hxx:17-49): compiled/warmed first, then timed with
    block_until_ready.
    """
    if converged_fn is None:
        converged_fn = default_converged
    if warmup:
        jax.block_until_ready(_enact_compiled(
            step_fn, converged_fn, graph, init_state, max_iterations))
    t0 = time.perf_counter()
    state, it = jax.block_until_ready(_enact_compiled(
        step_fn, converged_fn, graph, init_state, max_iterations))
    elapsed_ms = (time.perf_counter() - t0) * 1e3
    return EnactResult(state=state, iterations=int(it), elapsed_ms=elapsed_ms)
