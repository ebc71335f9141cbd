"""Runtime introspection + conversions + geo spatial median tests."""

import numpy as np
import jax.numpy as jnp

from essentials_tpu import runtime
from essentials_tpu.graph.convert import offsets_to_indices, indices_to_offsets


def test_device_properties():
    p = runtime.device_properties()
    assert p.kind == "cpu" and p.platform == "cpu"
    assert p.hbm_gbps is None
    assert runtime.num_devices() >= 1


def test_offsets_indices_roundtrip():
    off = jnp.asarray([0, 0, 2, 4, 4, 7])
    ids = offsets_to_indices(off, 7)
    np.testing.assert_array_equal(np.asarray(ids), [1, 1, 2, 2, 4, 4, 4])
    back = indices_to_offsets(ids, 5)
    np.testing.assert_array_equal(np.asarray(back), np.asarray(off))


def test_geo_spatial_median(chesapeake):
    from essentials_tpu.algorithms import geo
    import jax.numpy as jnp
    n = chesapeake.n_vertices
    vp = chesapeake.n_vertices_padded
    rng = np.random.default_rng(1)
    lat = np.full(vp, np.nan, np.float32)
    lon = np.full(vp, np.nan, np.float32)
    lat[:n] = rng.uniform(-60, 60, n)
    lon[:n] = rng.uniform(-170, 170, n)
    rl, rn = geo.spatial_median(chesapeake, jnp.asarray(lat), jnp.asarray(lon),
                                iterations=2)
    # refined positions stay on the globe and finite for located vertices
    rl = np.asarray(rl)[:n]
    assert np.all(np.isfinite(rl))
    assert np.all((rl >= -90) & (rl <= 90))
