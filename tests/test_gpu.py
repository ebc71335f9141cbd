"""Checks that need an NVIDIA GPU (marker ``gpu``; skipped elsewhere).
chip_smoke.py runs them in process on the card."""

import numpy as np
import pytest
import jax

from essentials_tpu import algorithms as A
from essentials_tpu import runtime
from essentials_tpu.formats import Csr
from essentials_tpu.graph import build_graph
from essentials_tpu.io import generate

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def kron():
    csr = Csr.from_coo(generate.rmat(12, 16, seed=4, undirected=True,
                                     weighted=True))
    return csr, build_graph(csr, directed=False, weighted=True)


def test_device_table_knows_this_gpu():
    dev = jax.devices()[0]
    props = runtime.device_properties(dev)
    assert props.platform == "gpu" == dev.platform
    assert props.kind == dev.device_kind
    assert props.hbm_gbps > 0 and props.sm_count > 0


def test_spmv_on_gpu(kron):
    """Float sums over segments on the card agree with float64."""
    import jax.numpy as jnp
    csr, g = kron
    x = np.random.default_rng(0).random(g.n_vertices_padded) \
        .astype(np.float32)
    x[g.n_vertices:] = 0
    for variant in ("pull", "push"):          # symmetric: both are A @ x
        r = A.spmv.run(g, jnp.asarray(x), variant=variant, warmup=False)
        np.testing.assert_allclose(
            np.asarray(r.y), A.spmv.cpu_reference(csr, x[:g.n_vertices]),
            rtol=1e-4, atol=1e-4)


def test_tc_dense_int8_dot_on_gpu(kron):
    """The dense path's int8 x int8 -> int32 products are exact."""
    csr, _ = kron
    r = A.tc.run(csr, warmup=False, variant="dense")
    total, vt = A.tc.cpu_reference(csr)
    assert r.total == total
    assert np.array_equal(r.vertex_triangles, vt)


def test_pair_intersection_on_gpu(kron):
    from essentials_tpu.ops import intersect
    csr, _ = kron
    off, cols = csr.row_offsets, csr.col_indices
    adj = [set(cols[off[i]:off[i + 1]].tolist()) for i in range(csr.n_rows)]
    rng = np.random.default_rng(0)
    u = rng.integers(0, csr.n_rows, 300)
    v = rng.integers(0, csr.n_rows, 300)
    got = intersect.intersection_counts(csr, u, v)
    assert np.array_equal(got, [len(adj[a] & adj[b]) for a, b in zip(u, v)])
