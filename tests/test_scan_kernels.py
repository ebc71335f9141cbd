"""Edge-axis scans (cumsum, segmented scans) vs NumPy references."""

import numpy as np
import jax.numpy as jnp
import pytest

from essentials_tpu.ops import scan_kernels as sk


def _np_segscan(x, flags, op):
    out = np.empty_like(x)
    acc = None
    f = {"add": np.add, "min": np.minimum, "max": np.maximum}[op]
    for i in range(len(x)):
        acc = x[i] if (flags[i] or acc is None) else f(acc, x[i])
        out[i] = acc
    return out


@pytest.mark.parametrize("n", [128, 1024, 130_000])
def test_scan_1d_int32_exact(n):
    rng = np.random.default_rng(n)
    x = rng.integers(-2**31, 2**31, n, dtype=np.int64).astype(np.int32)
    got = np.asarray(sk.cumsum(jnp.asarray(x)))
    want = np.cumsum(x.astype(np.int64)).astype(np.int32)  # wrap-around
    np.testing.assert_array_equal(got, want)


def test_scan_1d_f32():
    rng = np.random.default_rng(0)
    x = rng.standard_normal(4096).astype(np.float32)
    got = np.asarray(sk.cumsum(jnp.asarray(x)))
    np.testing.assert_allclose(got, np.cumsum(x), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("op", ["min", "max", "add"])
@pytest.mark.parametrize("n", [256, 70_000])
def test_segmented_scan(op, n):
    rng = np.random.default_rng(hash((op, n)) % 2**32)
    x = rng.integers(-1000, 1000, n).astype(np.int32)
    flags = rng.random(n) < 0.05
    flags[0] = True
    got = np.asarray(sk.segmented_scan(jnp.asarray(x), jnp.asarray(flags), op))
    np.testing.assert_array_equal(got, _np_segscan(x, flags, op))


def test_segmented_scan_first_op():
    """forward-fill: 'first' keeps each segment's first value."""
    x = np.arange(300, dtype=np.int32)
    flags = np.zeros(300, bool)
    flags[100] = True
    got = np.asarray(sk.segmented_scan(jnp.asarray(x),
                                          jnp.asarray(flags), "first"))
    np.testing.assert_array_equal(got[:100], np.zeros(100))
    np.testing.assert_array_equal(got[100:], np.full(200, 100))


def test_wrappers_cpu_fallback():
    x = jnp.asarray(np.arange(1000, dtype=np.int32))
    np.testing.assert_array_equal(np.asarray(sk.cumsum(x)),
                                  np.cumsum(np.arange(1000)).astype(np.int32))
    flags = jnp.asarray(np.arange(1000) % 100 == 0)
    got = sk.segmented_scan(x, flags, "min")
    np.testing.assert_array_equal(np.asarray(got),
                                  _np_segscan(np.arange(1000, dtype=np.int32),
                                              np.asarray(flags), "min"))


def test_segmented_minmax_matches_separate():
    import numpy as np
    import jax.numpy as jnp
    rng = np.random.default_rng(3)
    n = 5000
    x = jnp.asarray(rng.integers(-1000, 1000, n).astype(np.int32))
    flags = jnp.asarray(rng.random(n) < 0.05)
    active = jnp.asarray(rng.random(n) < 0.7)
    smax, smin = sk.segmented_minmax(x, flags, active)
    imax = np.iinfo(np.int32).max
    xa, fa, aa = np.asarray(x), np.asarray(flags).copy(), np.asarray(active)
    fa[0] = True
    ref_max = _np_segscan(np.where(aa, xa, -imax - 1).astype(np.int32),
                          fa, "max")
    ref_min = _np_segscan(np.where(aa, xa, imax).astype(np.int32), fa, "min")
    assert np.array_equal(np.asarray(smax), ref_max)
    assert np.array_equal(np.asarray(smin), ref_min)
