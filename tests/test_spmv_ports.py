"""PR / HITS / BC on the shared pull-SpMV engine: the spmv variants must
match the generic engine and the host references.
"""

import numpy as np
import pytest

from essentials_tpu.formats import Csr
from essentials_tpu.graph import build_graph
from essentials_tpu.io import generate
from essentials_tpu.algorithms import pr, hits, bc
from essentials_tpu.utils import compare


@pytest.fixture(scope="module")
def routed_graph():
    """A symmetric power-law graph (the spmv variants' domain)."""
    coo = generate.rmat(10, 8, seed=3, undirected=True, weighted=True)
    csr = Csr.from_coo(coo)
    return build_graph(csr, directed=False, weighted=True), csr


def test_pr_spmv_matches_generic_and_host(routed_graph):
    g, csr = routed_graph
    r_s = pr.run(g, variant="spmv", max_iterations=80, warmup=False)
    r_g = pr.run(g, variant="generic", max_iterations=80, warmup=False)
    ref = pr.cpu_reference(csr, max_iterations=80)
    assert r_s.iterations == r_g.iterations
    assert compare(r_s.ranks, np.asarray(r_g.ranks), atol=1e-7,
                   rtol=1e-5) == 0
    assert compare(r_s.ranks, ref, atol=1e-6, rtol=1e-4) == 0


def test_hits_spmv_matches_generic_and_host(routed_graph):
    g, csr = routed_graph
    r_s = hits.run(g, variant="spmv", max_iterations=30, warmup=False)
    r_g = hits.run(g, variant="generic", max_iterations=30, warmup=False)
    ra, rh = hits.cpu_reference(csr, max_iterations=30)
    assert r_s.iterations == r_g.iterations
    assert compare(r_s.auth, np.asarray(r_g.auth), atol=1e-6,
                   rtol=1e-4) == 0
    assert compare(r_s.auth, ra, atol=1e-4, rtol=1e-3) == 0
    assert compare(r_s.hub, rh, atol=1e-4, rtol=1e-3) == 0


def test_bc_spmv_matches_generic_and_host(routed_graph):
    g, csr = routed_graph
    r_s = bc.run(g, 7, variant="spmv", warmup=False)
    r_g = bc.run(g, 7, variant="generic", warmup=False)
    ref = bc.cpu_reference(csr, sources=[7], normalize_undirected=False)
    assert r_s.iterations == r_g.iterations
    assert compare(r_s.bc_values, np.asarray(r_g.bc_values), atol=1e-4,
                   rtol=1e-3) == 0
    assert compare(r_s.bc_values, ref, atol=1e-3, rtol=1e-3) == 0


def test_unit_spmv_engines_match_pull(routed_graph):
    """The unit=True engine path equals the unweighted pull sum."""
    import jax.numpy as jnp
    from essentials_tpu.algorithms.pr import _spmv_engine_call
    from essentials_tpu.ops import neighbor_reduce, Combine
    g, csr = routed_graph
    x = np.random.default_rng(0).random(g.n_vertices_padded) \
        .astype(np.float32)
    x[g.n_vertices:] = 0
    x = jnp.asarray(x)
    y = _spmv_engine_call(g, x, unit=True)
    ref = neighbor_reduce(g, lambda e: e.dst_vals[0], dst_values=(x,),
                          combine=Combine.SUM)
    assert compare(y[:g.n_vertices], np.asarray(ref)[:g.n_vertices],
                   atol=1e-4, rtol=1e-4) == 0
