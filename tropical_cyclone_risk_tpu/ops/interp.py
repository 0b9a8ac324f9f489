"""Batched bilinear field interpolation on the accelerator.

This replaces the reference's per-point ``RectBivariateSpline(kx=1, ky=1).ev``
calls (util/mat.py:142-173; track/bam_track.py:93-108; intensity/
coupled_fast.py:35-58,126) with a single fused gather over packed device-resident
field stacks.  A kx=ky=1 RectBivariateSpline is exactly bilinear interpolation;
outside the knot domain FITPACK clamps the evaluation point to the boundary
(verified empirically), which we reproduce by clamping the continuous grid
coordinate before splitting it into cell index and fractional offset.

Fields are packed channel-last, ``[..., nlat, nlon, C]``, so the four corner
gathers of one query fetch all C channels contiguously — one gather serves the
full 14-component wind statistics vector plus every environment field.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np


class UniformGrid(NamedTuple):
    """A uniform lon/lat grid: lon[i] = lon0 + i*dlon (ascending),
    lat[j] = lat0 + j*dlat (ascending)."""
    lon0: float
    dlon: float
    nlon: int
    lat0: float
    dlat: float
    nlat: int

    @staticmethod
    def from_axes(lon: np.ndarray, lat: np.ndarray) -> 'UniformGrid':
        lon = np.asarray(lon, dtype=np.float64)
        lat = np.asarray(lat, dtype=np.float64)
        if lat[1] < lat[0]:
            raise ValueError('latitude axis must be ascending; normalize at '
                             'ingestion with io.input.normalize_latlon')
        dlon = float(lon[1] - lon[0])
        dlat = float(lat[1] - lat[0])
        if not (np.allclose(np.diff(lon), dlon, rtol=1e-4) and
                np.allclose(np.diff(lat), dlat, rtol=1e-4)):
            raise ValueError('grid is not uniform')
        return UniformGrid(float(lon[0]), dlon, int(lon.size),
                           float(lat[0]), dlat, int(lat.size))

    def lon_axis(self) -> np.ndarray:
        return self.lon0 + self.dlon * np.arange(self.nlon)

    def lat_axis(self) -> np.ndarray:
        return self.lat0 + self.dlat * np.arange(self.nlat)


# Grid metadata is static structure (shapes depend on it), never traced data:
# a UniformGrid inside any pytree argument stays concrete under jit.
jax.tree_util.register_pytree_node(
    UniformGrid,
    lambda g: ((), tuple(g)),
    lambda aux, _: UniformGrid(*aux))


def _cell_and_weight(x, x0, dx, n):
    """Cell index and fractional offset, clamped to the grid domain."""
    u = jnp.clip((x - x0) / dx, 0.0, n - 1.0)
    i = jnp.clip(jnp.floor(u), 0, n - 2).astype(jnp.int32)
    w = u - i.astype(u.dtype)
    return i, w


def _flat_base(field, grid: UniformGrid, lon, lat,
               plane_idx: Optional[jnp.ndarray]):
    """Shared query machinery of bilinear / bilinear_packed: flatten the
    field's spatial (and optional plane) axes, compute each query's base
    cell index and fractional weights.  Returns (flat [rows, C], base [N],
    wx [N, 1], wy [N, 1])."""
    ix, wx = _cell_and_weight(lon, grid.lon0, grid.dlon, grid.nlon)
    iy, wy = _cell_and_weight(lat, grid.lat0, grid.dlat, grid.nlat)
    if field.ndim == 3:
        if plane_idx is not None:
            raise ValueError('plane_idx given but the field has no plane '
                             'axis — a collapsed field would silently '
                             'serve one plane for every query')
        flat = field.reshape(grid.nlat * grid.nlon, field.shape[-1])
        base = iy * grid.nlon + ix
    else:
        if plane_idx is None:
            raise ValueError('plane_idx required for a stacked field')
        flat = field.reshape(field.shape[0] * grid.nlat * grid.nlon,
                             field.shape[-1])
        base = (plane_idx.astype(jnp.int32) * grid.nlat + iy) * grid.nlon + ix
    return flat, base, wx[..., None], wy[..., None]


def _blend(c00, c01, c10, c11, wx, wy):
    return ((1 - wy) * ((1 - wx) * c00 + wx * c01) +
            wy * ((1 - wx) * c10 + wx * c11))


def bilinear(field, grid: UniformGrid, lon, lat,
             plane_idx: Optional[jnp.ndarray] = None):
    """Bilinearly interpolate a packed field stack at query points.

    field:     [nlat, nlon, C] or [P, nlat, nlon, C] (P = month/time planes)
    lon, lat:  [N] query coordinates (degrees, 0-360 / ascending-lat domain)
    plane_idx: [N] int plane selector (required iff field has a P axis)

    Returns [N, C].  Edge behavior matches scipy RectBivariateSpline kx=ky=1
    (clamped to the boundary outside the grid).
    """
    flat, base, wx, wy = _flat_base(field, grid, lon, lat, plane_idx)
    c00 = jnp.take(flat, base, axis=0)
    c01 = jnp.take(flat, base + 1, axis=0)
    c10 = jnp.take(flat, base + grid.nlon, axis=0)
    c11 = jnp.take(flat, base + grid.nlon + 1, axis=0)
    return _blend(c00, c01, c10, c11, wx, wy)


def bilinear_scalar(field2d, grid: UniformGrid, lon, lat,
                    plane_idx: Optional[jnp.ndarray] = None):
    """Single-channel convenience wrapper: field2d [nlat, nlon] (or stacked
    [P, nlat, nlon]) -> [N]."""
    return bilinear(field2d[..., None], grid, lon, lat, plane_idx)[..., 0]


def regrid(field, src_lon, src_lat, dst_lon, dst_lat):
    """Regrid a [lat, lon] field to a new grid (reference interp_2d_grid,
    util/mat.py:159-164).  Host/device agnostic; returns [dst_lat, dst_lon]."""
    grid = UniformGrid.from_axes(np.asarray(src_lon), np.asarray(src_lat))
    dst_lon = jnp.asarray(dst_lon)
    dst_lat = jnp.asarray(dst_lat)
    qlon, qlat = jnp.meshgrid(dst_lon, dst_lat)
    vals = bilinear_scalar(jnp.asarray(field), grid, qlon.ravel(), qlat.ravel())
    return vals.reshape(dst_lat.size, dst_lon.size)


def pack_corners(field):
    """Pre-pack the four bilinear corner cells into the channel axis.

    field [..., nlat, nlon, C] -> [..., nlat, nlon, 4*C] where channels are
    (c00, c01, c10, c11) = (y,x), (y,x+1), (y+1,x), (y+1,x+1), edge-clamped.
    One 4C-wide row per query replaces four C-wide rows, at the cost of 4x
    memory on this derived stack: a win where the gather is bound by rows
    rather than bytes.  Whether it pays on the H100 is not measured.
    """
    shift_x = jnp.concatenate([field[..., 1:, :], field[..., -1:, :]],
                              axis=-2)
    shift_y = jnp.concatenate([field[..., 1:, :, :], field[..., -1:, :, :]],
                              axis=-3)
    shift_xy = jnp.concatenate([shift_y[..., 1:, :], shift_y[..., -1:, :]],
                               axis=-2)
    return jnp.concatenate([field, shift_x, shift_y, shift_xy], axis=-1)


def bilinear_packed(field4, grid: UniformGrid, lon, lat,
                    plane_idx: Optional[jnp.ndarray] = None):
    """Bilinear interpolation from a corner-packed stack (pack_corners).

    field4: [nlat, nlon, 4C] or [P, nlat, nlon, 4C]; returns [N, C].
    Numerically identical to :func:`bilinear` on the unpacked field.
    """
    C = field4.shape[-1] // 4
    flat, base, wx, wy = _flat_base(field4, grid, lon, lat, plane_idx)
    row = jnp.take(flat, base, axis=0)
    return _blend(row[:, 0 * C:1 * C], row[:, 1 * C:2 * C],
                  row[:, 2 * C:3 * C], row[:, 3 * C:4 * C], wx, wy)
