"""Checkpoint/resume for algorithm state pytrees.

The reference's only persistence is the CSR binary cache
(/root/reference/include/gunrock/formats/csr.hxx:159-240 — covered by
formats/csr.py + io/loader.py). This adds what it lacked: saving an
in-progress algorithm state (any pytree of arrays) so long-running jobs can
resume after preemption — relevant on preemptible machines.
"""

from __future__ import annotations

import json

import numpy as np
import jax

_VERSION = 1


def save_state(path: str, state, *, step: int = 0, meta: dict | None = None):
    """Save a pytree of arrays + metadata to an .npz checkpoint."""
    leaves, treedef = jax.tree_util.tree_flatten(state)
    arrays = {f"leaf_{i}": np.asarray(l) for i, l in enumerate(leaves)}
    arrays["__meta__"] = np.frombuffer(json.dumps({
        "version": _VERSION, "step": step, "n_leaves": len(leaves),
        "treedef": str(treedef), "user": meta or {},
    }).encode(), dtype=np.uint8)
    np.savez(path, **arrays)


def load_state(path: str, like):
    """Load a checkpoint into the structure of ``like`` (a pytree with the
    same treedef as the saved state). Returns (state, step)."""
    with np.load(path) as z:
        meta = json.loads(bytes(z["__meta__"]).decode())
        leaves = [z[f"leaf_{i}"] for i in range(meta["n_leaves"])]
    _, treedef = jax.tree_util.tree_flatten(like)
    if treedef.num_leaves != len(leaves):
        raise ValueError(
            f"checkpoint has {len(leaves)} leaves, target structure has "
            f"{treedef.num_leaves}")
    import jax.numpy as jnp
    state = jax.tree_util.tree_unflatten(
        treedef, [jnp.asarray(l) for l in leaves])
    return state, meta["step"]
