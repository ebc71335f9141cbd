"""Scale-out: device meshes, partitioned graphs, shard_map supersteps.

The reference has no working multi-device execution (every operator throws on
multi-context, SURVEY.md §2.4); this package is the from-scratch capability:
1-D vertex partitions over a `jax.sharding.Mesh`, frontier/value exchange via
XLA collectives, convergence via psum.
"""

from essentials_tpu.parallel.mesh import make_mesh, device_count

__all__ = ["make_mesh", "device_count"]
