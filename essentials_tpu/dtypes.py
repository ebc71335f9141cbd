"""Numeric limits and sentinel conventions.

The reference centers on an "invalid" sentinel per type
(/root/reference/include/gunrock/util/type_limits.hxx:16-50): -1 for signed
ints, max for unsigned, NaN for floats. We keep the same convention for
API parity, but prefer *dense masks* over sentinel-laden sparse lists: a
frontier is a bool[V] map, so most sentinel checks disappear. Sentinels remain
for "no predecessor", "unreached distance", and padded edge slots.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp


def invalid(dtype) -> np.generic:
    """The invalid sentinel for ``dtype``.

    Reference parity: gunrock::numeric_limits<T>::invalid()
    (/root/reference/include/gunrock/util/type_limits.hxx:16-50).
    """
    dt = np.dtype(dtype)
    if np.issubdtype(dt, np.floating):
        return dt.type(np.nan)
    if np.issubdtype(dt, np.unsignedinteger):
        return np.iinfo(dt).max
    if np.issubdtype(dt, np.signedinteger):
        return dt.type(-1)
    raise TypeError(f"no invalid sentinel for dtype {dt}")


def is_valid(x):
    """Elementwise validity test against the sentinel convention.

    Reference parity: util::limits::is_valid
    (/root/reference/include/gunrock/util/type_limits.hxx:57-71).
    """
    dt = np.dtype(x.dtype)
    if np.issubdtype(dt, np.floating):
        return ~jnp.isnan(x)
    if np.issubdtype(dt, np.unsignedinteger):
        return x != np.iinfo(dt).max
    return x >= 0


def infinity(dtype) -> np.generic:
    """Largest finite/"unreached" value for distances of ``dtype``."""
    dt = np.dtype(dtype)
    if np.issubdtype(dt, np.floating):
        return dt.type(np.inf)
    return np.iinfo(dt).max


# Default index / value dtypes for graphs. int32 keeps indices on the VPU's
# fast path and halves HBM traffic vs int64 (XLA default indices).
vertex_dtype = np.int32
edge_dtype = np.int32
weight_dtype = np.float32
