"""Multi-host (multi-controller) smoke test: 2 CPU-backend processes
initialize via parallel.multihost, form a global mesh spanning both, and
run dist_bfs end-to-end (shard_map collectives crossing the process
boundary): parallel/multihost.py is executed, not just imported.

Skips when the coordinator port cannot be allocated or the jax build
lacks multi-process CPU support.
"""

import os
import socket
import subprocess
import sys
import textwrap

import pytest

_CHILD = textwrap.dedent("""
    import sys
    import numpy as np
    import jax
    jax.config.update("jax_platforms", "cpu")

    port, pid = sys.argv[1], int(sys.argv[2])
    from essentials_tpu.parallel import multihost
    multihost.initialize(f"127.0.0.1:{port}", 2, pid)
    assert jax.process_count() == 2, jax.process_count()
    assert jax.device_count() == 2 * jax.local_device_count()
    assert multihost.is_coordinator() == (pid == 0)

    mesh = multihost.global_mesh()
    assert len(mesh.devices.ravel()) == jax.device_count()

    from essentials_tpu.formats import Csr
    from essentials_tpu.io import generate
    from essentials_tpu.parallel.partition import partition_graph
    from essentials_tpu.parallel.distributed import dist_bfs
    coo = generate.uniform_random(64, 4, seed=3, undirected=True,
                                  weighted=True)
    csr = Csr.from_coo(coo)
    dg = partition_graph(csr, jax.device_count())
    d = dist_bfs(dg, mesh, 0)

    # host BFS reference; every process checks its LOCAL shards
    from collections import deque
    off = np.asarray(csr.row_offsets); cols = np.asarray(csr.col_indices)
    ref = np.full(dg.block_size * jax.device_count(),
                  np.iinfo(np.int32).max, np.int64)
    ref[0] = 0
    q = deque([0])
    while q:
        u = q.popleft()
        for e in range(off[u], off[u + 1]):
            v = cols[e]
            if ref[v] > ref[u] + 1:
                ref[v] = ref[u] + 1
                q.append(v)
    for shard in d.addressable_shards:
        lo = shard.index[0].start or 0
        got = np.asarray(shard.data)
        want = ref[lo:lo + got.shape[0]]
        valid = np.asarray(dg.vertex_valid[lo // dg.block_size])
        assert (got[valid] == want[valid]).all(), (pid, lo)
    print(f"proc {pid} ok", flush=True)
""")


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_dist_bfs():
    try:
        port = _free_port()
    except OSError:
        pytest.skip("no loopback port available")
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=1"
    env.pop("JAX_PLATFORMS", None)
    repo = os.path.join(os.path.dirname(__file__), "..")
    procs = [subprocess.Popen(
        [sys.executable, "-c", _CHILD, str(port), str(pid)],
        env=env, cwd=repo, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for pid in range(2)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=240)
            outs.append(out)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail("multi-process run timed out:\n" + "\n".join(outs))
    for pid, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0 and ("Unimplemented" in out
                                  or "not supported" in out):
            pytest.skip(f"jax build lacks multi-process CPU: {out[-300:]}")
        assert p.returncode == 0, f"proc {pid} failed:\n{out}"
        assert f"proc {pid} ok" in out
