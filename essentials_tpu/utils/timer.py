"""Wall-clock timer with device synchronization.

Reference parity: util::timer_t (cudaEvent-based,
/root/reference/include/gunrock/util/timer.hxx:17-49): host perf_counter
bracketing `jax.block_until_ready`.
"""

from __future__ import annotations

import time

import jax


class Timer:
    def __init__(self):
        self._t0 = None
        self._ms = 0.0

    def begin(self) -> "Timer":
        self._t0 = time.perf_counter()
        return self

    def end(self, sync=None) -> float:
        """Stop; first block on ``sync`` (a jax array/pytree) when given.
        Returns elapsed milliseconds."""
        if sync is not None:
            jax.block_until_ready(sync)
        self._ms = (time.perf_counter() - self._t0) * 1e3
        return self._ms

    def milliseconds(self) -> float:
        return self._ms
