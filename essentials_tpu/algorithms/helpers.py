"""Algorithm helper primitives: search, sort, random fill.

Reference parity:
- search::binary lower_bound/upper_bound/rightmost
  (/root/reference/include/gunrock/algorithms/search/binary_search.hxx:38-136)
- sort::radix sort_keys / sort_pairs
  (/root/reference/include/gunrock/algorithms/sort/radix_sort.hxx:40-52)
- generate::random::uniform_distribution
  (/root/reference/include/gunrock/algorithms/generate/random.hxx:22-34)

These are XLA built-ins (vectorized searchsorted; one sort; counter-based
RNG) — wrapped here so algorithm code
reads like the reference's.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def lower_bound(keys: jax.Array, needles, *, sorted: bool = True) -> jax.Array:
    """First index where needle could be inserted keeping order."""
    return jnp.searchsorted(keys, needles, side="left")


def upper_bound(keys: jax.Array, needles) -> jax.Array:
    return jnp.searchsorted(keys, needles, side="right")


def rightmost(keys: jax.Array, needles) -> jax.Array:
    """Index of the rightmost element <= needle (-1 if none) — the variant
    block_mapped advance uses (binary_search.hxx:120-136)."""
    return jnp.searchsorted(keys, needles, side="right") - 1


def sort_keys(keys: jax.Array, *, descending: bool = False) -> jax.Array:
    out = jnp.sort(keys)
    return out[::-1] if descending else out


def sort_pairs(keys: jax.Array, values: jax.Array, *,
               descending: bool = False):
    order = jnp.argsort(keys)
    if descending:
        order = order[::-1]
    return keys[order], values[order]


def uniform_distribution(key: jax.Array, shape, low=0.0, high=1.0,
                         dtype=jnp.float32) -> jax.Array:
    """Fill with uniform randoms (counter-based, reproducible across
    devices — unlike the reference's thrust RNG-by-index)."""
    return jax.random.uniform(key, shape, dtype, low, high)
