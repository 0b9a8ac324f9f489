"""Device-resident environment field packs.

The reference builds dozens of scipy spline objects per month per basin
(track/bam_track.py:76-91; intensity/coupled_fast.py:217-225; util/
compute.py:87-121).  Here all monthly environment data lives in a few packed
channel-last arrays so the integration scan samples everything a step needs
with a handful of fused gathers:

  wind [P, nlat, nlon, W + W(W+1)/2] — steering-wind means + lower-tri cov
  env  [P, nlat, nlon, 5]            — chi, vpot, mld, strat, rh_mid
  land / bathy                        — high-res static fields, own grids
  basin_masks [nlat_m, nlon_m, B]    — per-basin ocean masks + run-basin mask

P indexes (year, month) planes: plane = year_idx * 12 + (month - 1).  The
reference freezes fields at the seed month for the whole track
(track/bam_track.py:88-91, util/compute.py:107-121); plane-to-plane time
interpolation is available as an extension (Namelist.time_interp_fields).
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp
import numpy as np

from tropical_cyclone_risk_tpu.config import Namelist
from tropical_cyclone_risk_tpu.ops.interp import UniformGrid

# env channel indices
CHI, VPOT, MLD, STRAT, RH = range(5)
N_ENV = 5


class FieldPack(NamedTuple):
    grid: UniformGrid          # atmospheric grid (env + wind stats)
    wind: jnp.ndarray          # [P, nlat, nlon, W + W(W+1)/2]
    env: jnp.ndarray           # [P, nlat, nlon, N_ENV]
    land_grid: UniformGrid
    land: jnp.ndarray          # [nlat_l, nlon_l] (1.0 = land)
    bathy_grid: UniformGrid
    bathy: jnp.ndarray         # [nlat_b, nlon_b] (m; >= 0 over land)
    mask_grid: UniformGrid
    basin_masks: jnp.ndarray   # [nlat_m, nlon_m, B] per-basin genesis masks
    run_mask: jnp.ndarray      # [nlat_m, nlon_m] mask of the simulated basin

    @property
    def n_planes(self) -> int:
        return self.wind.shape[0]


class GatherStacks(NamedTuple):
    """Trace-time-fused, corner-packed gather sources from a FieldPack.

    The integration RHS samples wind statistics and environment fields at
    the same (lon, lat, plane) — fusing them into one channel stack turns
    two 4-corner gathers into one, and corner-packing (ops.interp.
    pack_corners) turns the four corner rows of each bilinear lookup into a
    single gathered row: 1-2 gather rows per seed per step instead of 8+
    (1 when land/bathy merge into the cell stack, see build_stacks).
    """
    grid: 'UniformGrid'
    cell4: jnp.ndarray         # [P, nlat, nlon, 4*n_cell_ch]
    n_wind_ch: int             # channels 0..n_wind_ch-1 are wind stats
    geo_in_cell: bool          # land/bathy are the last 2 cell channels
    land_grid: 'UniformGrid'
    land_geo4: jnp.ndarray     # [nlat_l, nlon_l, 4*(1 or 2)] (land[, bathy])
    bathy_grid: 'UniformGrid'  # separate-bathy fallback (unused when fused)
    bathy4: jnp.ndarray

    @property
    def fused_geo(self) -> bool:
        return self.land_geo4.shape[-1] == 8


def build_stacks(pack: FieldPack) -> GatherStacks:
    """Build the fused gather stacks (one concatenate + corner pack at trace
    time, hoisted out of the integration loop).

    When land and bathymetry live on the atmospheric grid (no resolution to
    lose), they are merged into the per-plane cell stack so the step loop
    issues ONE gather row per seed.  With a higher-resolution land mask (the
    production 0.125-degree file) they stay a separate gather to preserve
    coastline resolution."""
    from tropical_cyclone_risk_tpu.ops.interp import pack_corners
    cell = jnp.concatenate([pack.wind, pack.env], axis=-1)
    geo_in_cell = (pack.land_grid == pack.grid
                   and pack.bathy_grid == pack.grid)
    if geo_in_cell:
        P_ = cell.shape[0]
        geo = jnp.stack([pack.land, pack.bathy], axis=-1)
        cell = jnp.concatenate(
            [cell, jnp.broadcast_to(geo[None], (P_,) + geo.shape)], axis=-1)
    if pack.land_grid == pack.bathy_grid:
        land_geo = jnp.stack([pack.land, pack.bathy], axis=-1)
    else:
        land_geo = pack.land[..., None]
    return GatherStacks(grid=pack.grid, cell4=pack_corners(cell),
                        n_wind_ch=pack.wind.shape[-1],
                        geo_in_cell=geo_in_cell,
                        land_grid=pack.land_grid,
                        land_geo4=pack_corners(land_geo),
                        bathy_grid=pack.bathy_grid,
                        bathy4=pack_corners(pack.bathy[..., None]))


def crop_pack(pack: FieldPack, cfg: Namelist, basin_id: str,
              margin_deg: float = 2.5) -> FieldPack:
    """Crop the atmospheric stacks to the run basin's bounds plus a margin.

    Tracks terminate one degree outside the basin bounds
    (simulator._events_alive; coupled_fast.py:246-256), so fields beyond
    bounds+margin are never sampled.  The reference crops the same way when
    building its per-basin splines (basins.transform_global_field,
    util/basins.py:57-75).  Matters with corner packing: a 40-year global
    cell stack is ~10 GB of device memory, a basin crop ~1/6 of that.  Land/bathy/basin
    masks keep their own grids (unaffected); GL returns the pack unchanged.
    """
    from tropical_cyclone_risk_tpu.utils import basins as basins_mod
    lo0, la0, lo1, la1 = basins_mod.basin_bounds(cfg, basin_id)
    g = pack.grid
    if (lo1 - lo0) >= 360.0 - g.dlon and (la1 - la0) >= 180.0 - g.dlat:
        return pack
    lon = g.lon_axis()
    lat = g.lat_axis()
    jsel = np.nonzero((lon >= lo0 - margin_deg) & (lon <= lo1 + margin_deg)
                      )[0]
    isel = np.nonzero((lat >= la0 - margin_deg) & (lat <= la1 + margin_deg)
                      )[0]
    j0, j1 = int(jsel[0]), int(jsel[-1]) + 1
    i0, i1 = int(isel[0]), int(isel[-1]) + 1
    new_grid = UniformGrid(float(lon[j0]), g.dlon, j1 - j0,
                           float(lat[i0]), g.dlat, i1 - i0)
    crop = lambda a: a[..., i0:i1, j0:j1, :]
    repl = {'grid': new_grid, 'wind': crop(pack.wind), 'env': crop(pack.env)}
    if pack.land_grid == pack.grid:
        repl.update(land_grid=new_grid,
                    land=pack.land[..., i0:i1, j0:j1])
    if pack.bathy_grid == pack.grid:
        repl.update(bathy_grid=new_grid,
                    bathy=pack.bathy[..., i0:i1, j0:j1])
    return pack._replace(**repl)


def year_plane_indices(cfg: Namelist, n_planes: int, year_idx: int
                       ) -> tuple:
    """(plane index [12] int32, vpot-validity [12] float32) of one simulated
    year — the index arithmetic of slice_pack_year, shared with the fused
    multi-year launch program (pipeline._simulate_years) so both slice the
    pack identically."""
    base = year_idx * 12 + 1 - cfg.start_month
    gl = base + np.arange(12)
    valid = (gl >= 0) & (gl < n_planes)
    return (np.clip(gl, 0, n_planes - 1).astype(np.int32),
            valid.astype(np.float32))


def slice_pack_year(pack: FieldPack, cfg: Namelist, year_idx: int
                    ) -> FieldPack:
    """The 12 calendar-month planes of one simulated year.

    The launch program's compiled shape depends on the plane count, so a
    multi-year pack would compile a fresh executable per year range; slicing
    every year to a fixed 12-plane window (local plane = month - 1, i.e.
    seeding plane_offset = start_month - 1) makes every year of every run
    reuse ONE compiled launch per grid.  Months outside the configured data
    range (before start_month in year 0, after end_month in the last year)
    get a clamped plane with vpot zeroed, so the PI gate rejects them exactly
    like the reference's out-of-range time interpolation (NaN -> vpot 0,
    util/compute.py:107-121).
    """
    idx_np, valid = year_plane_indices(cfg, pack.n_planes, year_idx)
    valid = valid.astype(bool)
    idx = jnp.asarray(idx_np)
    wind = jnp.take(pack.wind, idx, axis=0)
    env = jnp.take(pack.env, idx, axis=0)
    if not valid.all():
        vmask = jnp.asarray(valid.astype(np.float32))[:, None, None]
        env = env.at[..., VPOT].multiply(vmask)
    return pack._replace(wind=wind, env=env)


def prepare_chi(chi_raw: np.ndarray, cfg: Namelist) -> np.ndarray:
    """The chi fudge applied when loading monthly fields
    (util/compute.py:112-115): NaN -> 5, then
    clip(exp(log(chi + 1e-3) + log_chi_fac) + chi_fac, 1e-5, 5)."""
    chi = np.where(np.isnan(chi_raw), 5.0, chi_raw)
    chi = np.exp(np.log(chi + 1e-3) + cfg.log_chi_fac) + cfg.chi_fac
    return np.clip(chi, 1e-5, 5.0)


def synthetic_pack(cfg: Namelist, n_planes: int = 12, nlat: int = 181,
                   nlon: int = 360, seed: int = 0,
                   run_basin: str = 'GL') -> FieldPack:
    """A physically plausible synthetic global environment for tests and
    benchmarks: zonal jets with seasonal modulation, warm-pool PI, idealized
    land band.  Shapes mirror a 1-degree ERA5 preprocessing output."""
    rng = np.random.default_rng(seed)
    W = cfg.n_wind_levels
    lat = np.linspace(-90.0, 90.0, nlat)
    lon = np.arange(0.0, 360.0, 360.0 / nlon)
    grid = UniformGrid.from_axes(lon, lat)
    LA = lat[:, None] + 0 * lon[None, :]
    LO = lon[None, :] + 0 * lat[:, None]

    months = np.arange(n_planes) % 12
    seasonal = np.cos(2 * np.pi * (months[:, None, None] - 7.5) / 12.0)

    # wind means: easterly trades / westerly jets, weak meridional flow;
    # one (u, v) pair per steering level, upper levels stronger
    means = []
    n_lvls = W // 2
    for li in range(n_lvls):
        depth = 1.0 - li / max(n_lvls - 1, 1)      # 1 at top, 0 at bottom
        u_l = (-5.0 - 3.0 * depth
               + (6.0 + 14.0 * depth) * np.sin(np.deg2rad(LA)) ** 2
               + (2.0 + 2.0 * depth) * seasonal)
        v_l = ((1.0 + depth) * np.sin(np.deg2rad((2 - li % 2) * LO))[None]
               + 0 * seasonal)
        means += [u_l, v_l]

    # covariance: diag 6-12 m2/s2 with mild cross-correlation
    n_tri = W * (W + 1) // 2
    tri = []
    base_var = 8.0 + 4.0 * np.cos(np.deg2rad(LA))[None] + 0 * seasonal
    k = 0
    for i in range(W):
        for j in range(i + 1):
            if i == j:
                tri.append(base_var * (1.0 + 0.1 * i))
            else:
                tri.append(0.2 * base_var * np.cos(np.deg2rad(LO))[None])
            k += 1
    wind = np.stack(means + tri, axis=-1).astype(np.float32)
    assert wind.shape[-1] == W + n_tri

    # land: one meridional continent band + polar caps
    land = ((np.abs(LA) > 66) | ((LO > 270) & (LO < 310) & (LA > -60))
            ).astype(np.float32)
    land_pack = land

    # vpot: warm tropical oceans support ~70 m/s, taper poleward; 0 over land
    vpot = 72.0 * np.exp(-((LA / 28.0) ** 4))[None] * \
        (1.0 + 0.15 * seasonal) * (1 - land)[None]
    chi_raw = 0.4 + 0.6 * np.abs(np.sin(np.deg2rad(LA)))[None] * \
        (1.0 + 0.2 * seasonal)
    chi = prepare_chi(np.where(land[None] > 0, np.nan, chi_raw), cfg)
    mld = (30.0 + 40.0 * np.cos(np.deg2rad(LA)) ** 2)[None] * \
        (1.0 + 0.1 * seasonal) * (1 - land)[None]
    strat = (4.0 + 2.0 * np.cos(np.deg2rad(LA)))[None] * \
        (1 + 0 * seasonal) * (1 - land)[None]
    rh = np.clip(0.45 + 0.25 * np.cos(np.deg2rad(LA))[None] *
                 (1 + 0.1 * seasonal) + 0.05 * rng.standard_normal(
                     (n_planes, nlat, nlon)), 0.0, 1.0)
    env = np.stack([chi, vpot, mld, strat, rh], axis=-1).astype(np.float32)

    bathy = np.where(land > 0, 100.0, -4500.0).astype(np.float32)

    # basin masks on the same grid for simplicity (production uses 0.25 deg)
    basin_ids = cfg.basin_ids_sorted()
    from tropical_cyclone_risk_tpu.utils import basins as basins_mod
    masks = []
    for b in basin_ids:
        lo0, la0, lo1, la1 = basins_mod.basin_bounds(cfg, b)
        m = ((LO >= lo0) & (LO <= lo1) & (LA >= la0) & (LA <= la1) &
             (land < 0.5)).astype(np.float32)
        masks.append(m)
    basin_masks = np.stack(masks, axis=-1)
    if run_basin == 'GL':
        run_mask = ((np.abs(LA) <= 50) & (land < 0.5)).astype(np.float32)
    else:
        run_mask = masks[basin_ids.index(run_basin)]

    return FieldPack(
        grid=grid,
        wind=jnp.asarray(wind),
        env=jnp.asarray(env),
        land_grid=grid, land=jnp.asarray(land_pack),
        bathy_grid=grid, bathy=jnp.asarray(bathy),
        mask_grid=grid, basin_masks=jnp.asarray(basin_masks),
        run_mask=jnp.asarray(run_mask))
