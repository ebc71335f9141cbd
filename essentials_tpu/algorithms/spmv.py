"""Sparse matrix-vector multiply y = A @ x.

Reference parity: gunrock::spmv (/root/reference/include/gunrock/algorithms/
spmv.hxx:77-131): pull variant = segmented reduce over CSR rows
(neighborreduce), push variant = scatter-add over out-edges. Both are the
same sorted segment-SUM here, on the segment engine (ops/segment.py).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from essentials_tpu.graph.graph import Graph
from essentials_tpu.ops import advance, neighbor_reduce, Combine, AdvanceIO
from essentials_tpu.utils.timer import Timer


class SpmvResult(NamedTuple):
    y: jax.Array
    elapsed_ms: float


@jax.jit
def spmv_pull(g: Graph, x: jax.Array) -> jax.Array:
    """y[row] = sum over row's edges of w * x[col] — src-keyed segment sum."""
    return neighbor_reduce(g, lambda e: e.weight * e.dst_vals[0],
                           dst_values=(x,), combine=Combine.SUM)


@jax.jit
def spmv_push(g: Graph, x: jax.Array) -> jax.Array:
    """Transpose-free push: y[dst] += w * x[src] over the dst-sorted edges —
    computes A^T @ x in the same graph; with symmetric A equals pull."""
    return advance(g, lambda e: e.weight * e.src_vals[0], None,
                   src_values=(x,), input_kind=AdvanceIO.GRAPH,
                   combine=Combine.SUM, with_frontier=False)


def run(g: Graph, x=None, *, variant: str = "pull", seed: int = 0,
        warmup: bool = True) -> SpmvResult:
    """variant: 'pull' (A @ x) or 'push' (A^T @ x)."""
    if x is None:
        key = jax.random.PRNGKey(seed)
        x = jax.random.uniform(key, (g.n_vertices_padded,), jnp.float32)
        x = jnp.where(g.vertex_mask(), x, 0.0)
    fn = {"pull": spmv_pull, "push": spmv_push}[variant]
    if warmup:
        jax.block_until_ready(fn(g, x))
    t = Timer().begin()
    y = fn(g, x)
    ms = t.end(sync=y)
    return SpmvResult(y[:g.n_vertices], ms)


def cpu_reference(csr, x) -> np.ndarray:
    off = np.asarray(csr.row_offsets)
    cols = np.asarray(csr.col_indices)
    vals = np.asarray(csr.values, np.float64)
    src = np.repeat(np.arange(csr.n_rows), np.diff(off))
    x = np.asarray(x, np.float64)
    y = np.zeros(csr.n_rows)
    np.add.at(y, src, vals * x[cols])
    return y.astype(np.float32)
