"""Bitmap packing, the shift TC path, and the pair-intersection operator."""

import numpy as np

from essentials_tpu.ops import intersect as bi


def test_pack_unpack_roundtrip():
    rng = np.random.default_rng(0)
    n = 300
    src = rng.integers(0, n, 500).astype(np.int64)
    dst = rng.integers(0, n, 500).astype(np.int64)
    b = bi.pack_bitmap_rows(n, src, dst)
    words = np.asarray(b).view(np.uint32).reshape(n + 1, -1)
    assert words.shape == (n + 1, -(-n // 32))
    for s, d in zip(src[:50], dst[:50]):
        assert (words[s, d >> 5] >> (d & 31)) & 1 == 1
    assert not words[n].any()  # pad row stays zero


def test_shift_variant_total_matches():
    """Shift-pass sort-join total vs the set-based host reference."""
    import numpy as np
    from essentials_tpu.algorithms import tc
    from essentials_tpu.formats import Csr
    from essentials_tpu.io import generate
    for seed in (3, 11):
        coo = generate.rmat(9, 12, seed=seed, undirected=True,
                            weighted=False)
        csr = Csr.from_coo(coo)
        ref_total, _ = tc.cpu_reference(csr)
        res = tc.run(csr, warmup=False, variant="shift")
        assert res.total == ref_total, (seed, res.total, ref_total)
        assert tc.cpu_reference_total(csr) == ref_total


def test_generic_intersection_operator():
    """ops.intersect: counts + jaccard on arbitrary pair queries vs host
    sets (reference get_intersection_count parity, csr.hxx:110-167)."""
    import numpy as np
    from essentials_tpu.ops import intersect
    from essentials_tpu.formats import Csr
    from essentials_tpu.io import generate
    coo = generate.rmat(8, 8, seed=9, undirected=True, weighted=False)
    csr = Csr.from_coo(coo)
    off = np.asarray(csr.row_offsets)
    cols = np.asarray(csr.col_indices)
    adj = [set(cols[off[i]:off[i + 1]].tolist())
           for i in range(csr.n_rows)]
    rng = np.random.default_rng(0)
    u = rng.integers(0, csr.n_rows, 64)
    v = rng.integers(0, csr.n_rows, 64)
    got, wit = intersect.intersection_counts(csr, u, v, witnesses=True)
    ref = np.array([len(adj[a] & adj[b]) for a, b in zip(u, v)])
    assert np.array_equal(got, ref)
    # witness histogram: per-vertex membership count over all pairs
    wref = np.zeros(csr.n_rows, np.int64)
    for a, b in zip(u, v):
        for c in adj[a] & adj[b]:
            wref[c] += 1
    assert np.array_equal(wit, wref)
    j = intersect.jaccard(csr, u, v)
    jref = np.array([len(adj[a] & adj[b]) / max(len(adj[a] | adj[b]), 1)
                     for a, b in zip(u, v)])
    np.testing.assert_allclose(j, jref, rtol=1e-12)


def test_chunked_intersection_above_dense_cap(monkeypatch):
    """The chunked any-scale path: force the dense cap
    and chunk width small so a mid-size graph runs multiple column
    chunks, and compare against host sets + the dense path."""
    import numpy as np
    from essentials_tpu.ops import intersect
    from essentials_tpu.formats import Csr
    from essentials_tpu.io import generate
    coo = generate.uniform_random(10000, 4, seed=4, undirected=True,
                                  weighted=False)
    csr = Csr.from_coo(coo)
    off = np.asarray(csr.row_offsets)
    cols = np.asarray(csr.col_indices)
    adj = [set(cols[off[i]:off[i + 1]].tolist())
           for i in range(csr.n_rows)]
    rng = np.random.default_rng(1)
    u = rng.integers(0, csr.n_rows, 48)
    v = rng.integers(0, csr.n_rows, 48)
    ref = np.array([len(adj[a] & adj[b]) for a, b in zip(u, v)])
    wref = np.zeros(csr.n_rows, np.int64)
    for a, b in zip(u, v):
        for c in adj[a] & adj[b]:
            wref[c] += 1

    monkeypatch.setattr(intersect, "_DENSE_V_MAX", 64)
    monkeypatch.setattr(intersect, "_CHUNK_BYTES", 1 << 12)  # -> 3 chunks
    got, wit = intersect.intersection_counts(csr, u, v, witnesses=True)
    assert np.array_equal(got, ref)
    assert np.array_equal(wit, wref)
