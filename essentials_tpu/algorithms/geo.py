"""Geolocation: predict unknown vertex locations from located neighbors.

Reference parity: gunrock::geo (/root/reference/include/gunrock/algorithms/
geo.hxx:28-397): pure parallel_for app; per iteration each unlocated vertex
takes the spatial center of its located neighbors (1 neighbor -> copy,
2 -> haversine midpoint, >2 -> spatial median). Here neighbor
aggregation happens in 3-D Cartesian space (sum + normalize = spherical
centroid, the standard robust approximation of the spatial mean); the
spatial-median refinement is a fixed number of Weiszfeld sweeps, each one
segment reduction — no per-vertex serial loops.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from essentials_tpu.framework.enactor import enact, EnactResult
from essentials_tpu.graph.graph import Graph
from essentials_tpu.ops import advance, Combine, AdvanceIO


class GeoState(NamedTuple):
    lat: jax.Array       # float32[Vp] degrees, NaN = unknown
    lon: jax.Array


class GeoResult(NamedTuple):
    lat: jax.Array
    lon: jax.Array
    iterations: int
    elapsed_ms: float


def _to_xyz(lat, lon):
    la, lo = jnp.deg2rad(lat), jnp.deg2rad(lon)
    cl = jnp.cos(la)
    return cl * jnp.cos(lo), cl * jnp.sin(lo), jnp.sin(la)


def _to_latlon(x, y, z):
    norm = jnp.sqrt(x * x + y * y + z * z)
    ok = norm > 1e-12
    x, y, z = x / jnp.maximum(norm, 1e-12), y / jnp.maximum(norm, 1e-12), \
        z / jnp.maximum(norm, 1e-12)
    lat = jnp.rad2deg(jnp.arcsin(jnp.clip(z, -1.0, 1.0)))
    lon = jnp.rad2deg(jnp.arctan2(y, x))
    return jnp.where(ok, lat, jnp.nan), jnp.where(ok, lon, jnp.nan)


def init(g: Graph, lat, lon) -> GeoState:
    vp = g.n_vertices_padded
    la = jnp.full(vp, jnp.nan, jnp.float32).at[:len(np.asarray(lat))].set(
        jnp.asarray(lat, jnp.float32))
    lo = jnp.full(vp, jnp.nan, jnp.float32).at[:len(np.asarray(lon))].set(
        jnp.asarray(lon, jnp.float32))
    return GeoState(la, lo)


def step(g: Graph, state: GeoState, it) -> GeoState:
    lat, lon = state
    known = ~jnp.isnan(lat)
    x, y, z = _to_xyz(jnp.nan_to_num(lat), jnp.nan_to_num(lon))
    kx = jnp.where(known, x, 0.0)
    ky = jnp.where(known, y, 0.0)
    kz = jnp.where(known, z, 0.0)

    from essentials_tpu.ops import advance_multi
    sx, sy, sz = advance_multi(
        g,
        [(lambda e: e.src_vals[0], Combine.SUM),
         (lambda e: e.src_vals[1], Combine.SUM),
         (lambda e: e.src_vals[2], Combine.SUM)],
        None, src_values=(kx, ky, kz), input_kind=AdvanceIO.GRAPH)
    nlat, nlon = _to_latlon(sx, sy, sz)
    new_lat = jnp.where(known, lat, nlat)
    new_lon = jnp.where(known, lon, nlon)
    return GeoState(new_lat, new_lon)


def spatial_median(g: Graph, lat, lon, *, iterations: int = 5):
    """Weiszfeld refinement of the per-vertex neighbor center under great-
    circle distance (reference parity: geo.hxx spatial_median, :28-230).
    Each Weiszfeld iteration is one advance over the edge axis: neighbors'
    positions weighted by 1/haversine-distance to the current estimate.

    Returns refined (lat, lon) for every vertex with located neighbors.
    """
    known = ~jnp.isnan(lat)
    x, y, z = _to_xyz(jnp.nan_to_num(lat), jnp.nan_to_num(lon))
    kx = jnp.where(known, x, 0.0)
    ky = jnp.where(known, y, 0.0)
    kz = jnp.where(known, z, 0.0)
    kf = known.astype(jnp.float32)

    est_lat, est_lon = lat, lon

    from essentials_tpu.ops import advance_multi
    for _ in range(iterations):
        ex, ey, ez = _to_xyz(jnp.nan_to_num(est_lat), jnp.nan_to_num(est_lon))

        def wmsg(i):
            def fn(e):
                # inverse chord distance from dst's current estimate to
                # src's (known) position ~ inverse haversine for small d
                dx = e.src_vals[0] - e.dst_vals[0]
                dy = e.src_vals[1] - e.dst_vals[1]
                dz = e.src_vals[2] - e.dst_vals[2]
                d = jnp.sqrt(dx * dx + dy * dy + dz * dz) + 1e-6
                w = e.src_vals[3] / d
                return w * (e.src_vals[i] if i < 3 else 1.0)
            return fn

        sx, sy, sz, sw = advance_multi(
            g,
            [(wmsg(0), Combine.SUM), (wmsg(1), Combine.SUM),
             (wmsg(2), Combine.SUM), (wmsg(3), Combine.SUM)],
            None, src_values=(kx, ky, kz, kf), dst_values=(ex, ey, ez),
            input_kind=AdvanceIO.GRAPH)
        nlat, nlon = _to_latlon(sx / jnp.maximum(sw, 1e-12),
                                sy / jnp.maximum(sw, 1e-12),
                                sz / jnp.maximum(sw, 1e-12))
        est_lat = jnp.where(jnp.isnan(nlat), est_lat, nlat)
        est_lon = jnp.where(jnp.isnan(nlon), est_lon, nlon)
    return est_lat, est_lon


def converged(g: Graph, state: GeoState, it) -> jax.Array:
    # all real vertices located (isolated vertices can never be located,
    # so also accept fixed-point via max_iterations)
    return jnp.all(~jnp.isnan(jnp.where(g.vertex_mask(), state.lat, 0.0)))


def run(g: Graph, lat, lon, *, total_iterations: int = 10,
        spatial_iterations: int = 1000, warmup: bool = True) -> GeoResult:
    """``total_iterations`` caps the label-propagation sweeps (reference
    param geo.hxx total_iterations); convergence = everything located."""
    res: EnactResult = enact(step, converged, g, init(g, lat, lon),
                             max_iterations=total_iterations, warmup=warmup)
    v = g.n_vertices
    return GeoResult(res.state.lat[:v], res.state.lon[:v],
                     res.iterations, res.elapsed_ms)


def cpu_reference(csr, lat, lon, total_iterations: int = 10):
    n = csr.n_rows
    off = np.asarray(csr.row_offsets)
    cols = np.asarray(csr.col_indices)
    lat = np.array(lat, np.float64)
    lon = np.array(lon, np.float64)
    for _ in range(total_iterations):
        known = ~np.isnan(lat)
        if known[:n].all():
            break
        la, lo = np.deg2rad(np.nan_to_num(lat)), np.deg2rad(np.nan_to_num(lon))
        x = np.cos(la) * np.cos(lo) * known
        y = np.cos(la) * np.sin(lo) * known
        z = np.sin(la) * known
        nl = lat.copy()
        nn = lon.copy()
        for vtx in range(n):
            if known[vtx]:
                continue
            nbrs = cols[off[vtx]:off[vtx + 1]]
            sx, sy, sz = x[nbrs].sum(), y[nbrs].sum(), z[nbrs].sum()
            norm = np.sqrt(sx * sx + sy * sy + sz * sz)
            if norm > 1e-12:
                nl[vtx] = np.rad2deg(np.arcsin(np.clip(sz / norm, -1, 1)))
                nn[vtx] = np.rad2deg(np.arctan2(sy / norm, sx / norm))
        lat, lon = nl, nn
    return lat.astype(np.float32), lon.astype(np.float32)
