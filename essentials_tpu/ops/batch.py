"""batch: run one algorithm over many seeds/sources as a single XLA program.

Reference parity: operators::batch::execute, which spawns N CPU std::threads
each running a full GPU job (/root/reference/include/gunrock/framework/
operators/batch/batch.hxx:61-81; used by BC and PPR). Here `jax.vmap`
over the seed axis compiles the whole batch into one program — no context
contention, batched shapes.
"""

from __future__ import annotations

from typing import Callable

import jax


def batch_execute(fn: Callable, seeds, *args, in_axes=0):
    """vmap ``fn(seed, *args)`` over ``seeds``; args are broadcast."""
    axes = (in_axes,) + (None,) * len(args)
    return jax.vmap(fn, in_axes=axes)(seeds, *args)
