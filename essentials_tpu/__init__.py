"""essentials_tpu — a graph analytics & message-passing framework in JAX.

A from-scratch rebuild of the capabilities of gunrock/essentials (CUDA, see
/root/reference): graphs are immutable pytrees with static padded shapes,
frontiers are dense boolean maps over vertices, algorithm iterations are
`jax.lax.while_loop` supersteps compiled once with `jax.jit`, and scale-out
uses `jax.sharding.Mesh` + `shard_map` with XLA collectives.

Layer map (mirrors reference SURVEY.md §1):

  L0 runtime   -> XLA/jit + device helpers        (essentials_tpu.runtime)
  L1 memory    -> jax arrays / pytrees            (implicit)
  L2 formats   -> host COO/CSR/CSC containers     (essentials_tpu.formats)
  L3 graph     -> device Graph pytree + views     (essentials_tpu.graph)
  L4 io        -> .mtx/.smtx/binary loaders       (essentials_tpu.io)
  L5 frontier  -> dense boolmap + index frontiers (essentials_tpu.frontier)
  L6 operators -> advance/filter/for/uniquify/
                  neighborreduce/batch            (essentials_tpu.ops)
  L7 framework -> Problem/Enactor superstep loop  (essentials_tpu.framework)
  L8 algorithms-> bfs/sssp/pr/ppr/bc/color/kcore/
                  mst/tc/hits/geo/spmv/spgemm     (essentials_tpu.algorithms)
  L9 harness   -> CLI, bench, tests               (essentials_tpu.cli, bench/)

Parallel scale-out (absent in the reference):
  essentials_tpu.parallel — vertex 1-D partitions, shard_map supersteps,
  all_gather frontier exchange, psum convergence.
"""

__version__ = "0.1.0"

import os as _os

import jax as _jax

# Persistent compilation cache. JAX reads JAX_COMPILATION_CACHE_DIR itself;
# without it the cache sits at a fixed path inside the checkout (the path
# is part of the cache key, so it must not move between runs).
CACHE_DIR = _os.path.join(
    _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))),
    ".jax_cache")
if not _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    _jax.config.update("jax_compilation_cache_dir", CACHE_DIR)

from essentials_tpu import formats, graph, io, ops, frontier, framework
from essentials_tpu import algorithms, parallel, utils
from essentials_tpu.graph import Graph, build_graph
from essentials_tpu.errors import EssentialsError, throw_if

__all__ = [
    "formats", "graph", "io", "ops", "frontier", "framework", "algorithms",
    "parallel", "utils", "Graph", "build_graph", "EssentialsError", "throw_if",
]
