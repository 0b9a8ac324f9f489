"""Post-processing analysis of track ensembles.

Reference equivalent: notebooks/sample_analysis.ipynb (cells 1-17) — the
reference ships these recipes only as a notebook; here they are a tested
library: multi-ensemble loading, the seasonal genesis cycle, calibrated
interannual frequency, and point return-period curves.
"""

from __future__ import annotations

import dataclasses
import glob as _glob
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from tropical_cyclone_risk_tpu.io import netcdf

MS_TO_KTS = 1.94384


@dataclasses.dataclass
class TrackEnsemble:
    """All members of a tracks_*.nc ensemble stacked on a leading
    'ensemble' axis (notebook cell 5's open_mfdataset equivalent)."""
    lon: np.ndarray            # [E, n_trk, T]
    lat: np.ndarray
    vmax: np.ndarray
    v: np.ndarray
    tc_month: np.ndarray       # [E, n_trk]
    tc_years: np.ndarray       # [E, n_trk]
    tc_basins: np.ndarray      # [E, n_trk] 'U2'
    seeds_per_month: np.ndarray  # [E, n_year, n_basin, 12]
    year: np.ndarray           # [n_year]
    basin: List[str]

    @property
    def n_ensemble(self) -> int:
        return self.lon.shape[0]


def _decode_str(arr: np.ndarray) -> np.ndarray:
    """Char-matrix (classic NetCDF) -> 'U' string array."""
    if arr.dtype.kind == 'S' and arr.ndim >= 1:
        return arr.view(f'S{arr.shape[-1]}')[..., 0].astype('U')
    return arr.astype('U')


def open_tracks(paths: Sequence[str]) -> TrackEnsemble:
    """Load one or more ensemble member files (same shapes required)."""
    if isinstance(paths, str):
        paths = sorted(_glob.glob(paths))
    # a run that died between the atomic ensemble-name claim and the write
    # leaves a 0-byte placeholder (runtime.fn_tracks_duplicates) — skip it
    # with a warning instead of failing the whole ensemble load
    empty = [p for p in paths if os.path.getsize(p) == 0]
    if empty:
        import logging
        logging.getLogger('tc_risk').warning(
            'skipping %d zero-byte track file(s) (crashed-run name claims; '
            'delete to reuse the ensemble slot): %s', len(empty), empty)
        paths = [p for p in paths if p not in set(empty)]
    if not paths:
        raise FileNotFoundError('no track files given')
    stacks: Dict[str, List[np.ndarray]] = {k: [] for k in (
        'lon_trks', 'lat_trks', 'vmax_trks', 'v_trks', 'tc_month',
        'tc_years', 'tc_basins', 'seeds_per_month')}
    year = basin = None
    for p in paths:
        ds = netcdf.read(p)
        for k in stacks:
            arr = np.asarray(ds[k].data)
            if k == 'tc_basins':
                arr = _decode_str(arr)
            stacks[k].append(arr)
        yr = np.asarray(ds['year'].data)
        if year is not None and not np.array_equal(yr, year):
            # a glob that caught runs with different year ranges would
            # silently mis-key every per-year statistic
            raise ValueError(f'{p}: year axis {yr[[0, -1]]} differs from '
                             f'earlier members {year[[0, -1]]} — not one '
                             f'ensemble')
        year = yr
        basin = [str(x) for x in _decode_str(np.asarray(ds['basin'].data))]
    st = {k: np.stack(v) for k, v in stacks.items()}
    return TrackEnsemble(
        lon=st['lon_trks'], lat=st['lat_trks'], vmax=st['vmax_trks'],
        v=st['v_trks'], tc_month=st['tc_month'], tc_years=st['tc_years'],
        tc_basins=st['tc_basins'], seeds_per_month=st['seeds_per_month'],
        year=year, basin=basin)


def seasonal_cycle(ens: TrackEnsemble, basin_id: str) -> np.ndarray:
    """Normalized genesis-month histogram for one basin
    (notebook cell 9).  Returns density [12]."""
    mask = ens.tc_basins == basin_id
    months = ens.tc_month[mask].astype(int)
    hist = np.bincount(months, minlength=13)[1:13].astype(float)
    total = hist.sum()
    return hist / total if total else hist


def interannual_frequency(ens: TrackEnsemble, basin_id: str,
                          tracks_per_year: Optional[int] = None,
                          obs_tracks_per_year: float = 1.0
                          ) -> Tuple[np.ndarray, float]:
    """Calibrated yearly storm frequency (notebook cell 11).

    gamma(year) = tracks generated that year / total seeds needed that year;
    c = obs / mean(gamma);  returns (c * gamma [n_year], c).

    The track count is taken from the data itself (tc_years/tc_basins), so
    runs with --n-years truncation or an unfilled quota scale correctly;
    pass tracks_per_year only to force the notebook's constant-quota form.
    """
    b = ens.basin.index(basin_id)
    seeds_per_year = ens.seeds_per_month.sum(axis=(0, 3))[:, b]
    if tracks_per_year is not None:
        n_tracks = np.full(ens.year.size, float(tracks_per_year)
                           * ens.n_ensemble)
    else:
        in_basin = ens.tc_basins == basin_id
        n_tracks = np.array([(in_basin & (ens.tc_years == y)).sum()
                             for y in ens.year], float)
    if not np.all(seeds_per_year > 0):
        raise ValueError(f'basin {basin_id!r} has years with zero counted '
                         'seeds in this ensemble — was it simulated?')
    # both numerator and denominator are summed over ensemble members
    gamma = n_tracks / seeds_per_year
    c = obs_tracks_per_year / gamma.mean()
    return c * gamma, float(c)


def max_wind_near_point(ens: TrackEnsemble, poi_lon: float, poi_lat: float,
                        radius_km: float = 100.0) -> np.ndarray:
    """Lifetime-max vmax of each track while within radius of the point
    (notebook cells 13-15).  Returns [E, n_trk] with NaN for never-near."""
    lon1, lat1, lon2, lat2 = map(np.deg2rad, (
        np.float64(poi_lon % 360.0), np.float64(poi_lat),
        ens.lon % 360.0, ens.lat))
    a = (np.sin((lat2 - lat1) / 2) ** 2
         + np.cos(lat1) * np.cos(lat2) * np.sin((lon2 - lon1) / 2) ** 2)
    km = 6378.0 * 2 * np.arcsin(np.sqrt(a))
    v = np.where((km <= radius_km) & np.isfinite(ens.vmax), ens.vmax,
                 -np.inf)
    m = v.max(axis=-1)
    return np.where(np.isfinite(m), m, np.nan)


def _rp_curve(v: np.ndarray, total_years: int, vmax_bins: np.ndarray
              ) -> np.ndarray:
    """Exceedance-count return periods from per-event intensities
    (NaN = no event; notebook cell 17 semantics)."""
    counts = np.array([np.nansum(v >= b) for b in vmax_bins], float)
    with np.errstate(divide='ignore'):
        return np.where(counts > 0, total_years / np.maximum(counts, 1e-30),
                        np.inf)


def return_periods(ens: TrackEnsemble, poi_lon: float, poi_lat: float,
                   radius_km: float = 100.0,
                   vmax_bins: Optional[np.ndarray] = None
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Point return-period curve (notebook cells 15-17).

    Returns (vmax_bins [m/s], return_period_years) with inf where never
    exceeded."""
    if vmax_bins is None:
        vmax_bins = np.arange(10.0, 81.0, 5.0)
    vpoi = max_wind_near_point(ens, poi_lon, poi_lat, radius_km).ravel()
    return vmax_bins, _rp_curve(vpoi, ens.year.size * ens.n_ensemble,
                                vmax_bins)


def track_density(ens: TrackEnsemble, res_deg: float = 2.0,
                  min_wind: float = 0.0) -> Tuple[np.ndarray, np.ndarray,
                                                  np.ndarray]:
    """Track-point density on a lat/lon grid — the parity metric of
    BASELINE.json (not in the notebook, standard in Lin et al. 2023 figs).
    Returns (density [nlat, nlon], lon_edges, lat_edges)."""
    lon_e = np.arange(0.0, 360.0 + res_deg, res_deg)
    lat_e = np.arange(-90.0, 90.0 + res_deg, res_deg)
    sel = np.isfinite(ens.lon) & np.isfinite(ens.lat) & \
        (np.nan_to_num(ens.v) >= min_wind)
    h, _, _ = np.histogram2d(ens.lat[sel].ravel(),
                             (ens.lon[sel] % 360.0).ravel(),
                             bins=(lat_e, lon_e))
    return h, lon_e, lat_e


def genesis_density(ens: TrackEnsemble, res_deg: float = 2.0
                    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Genesis-point density (each track's first valid sample) on a
    lat/lon grid — the "genesis locations" validation metric of Lin et
    al. 2023 (README.md:2).  Returns (density [nlat, nlon], lon_edges,
    lat_edges), same grid conventions as track_density."""
    lon_e = np.arange(0.0, 360.0 + res_deg, res_deg)
    lat_e = np.arange(-90.0, 90.0 + res_deg, res_deg)
    valid = np.isfinite(ens.lon) & np.isfinite(ens.lat)
    has = valid.any(axis=-1)
    i0 = valid.argmax(axis=-1)
    take = np.take_along_axis
    lon0 = take(ens.lon, i0[..., None], axis=-1)[..., 0][has]
    lat0 = take(ens.lat, i0[..., None], axis=-1)[..., 0][has]
    h, _, _ = np.histogram2d(lat0.ravel(), (lon0 % 360.0).ravel(),
                             bins=(lat_e, lon_e))
    return h, lon_e, lat_e


def lmi_distribution(ens: TrackEnsemble, bins: Optional[np.ndarray] = None
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Lifetime-maximum-intensity histogram (BASELINE.json parity metric).
    Returns (bin_centers [m/s], density)."""
    if bins is None:
        bins = np.arange(15.0, 100.0, 5.0)
    with np.errstate(all='ignore'):
        lmi = np.nanmax(np.where(np.isfinite(ens.vmax), ens.vmax, -np.inf),
                        axis=-1).ravel()
    lmi = lmi[np.isfinite(lmi)]
    h, edges = np.histogram(lmi, bins=bins, density=True)
    return 0.5 * (edges[:-1] + edges[1:]), h


def _on_land_at(land, land_lon, land_lat, lon, lat, valid) -> np.ndarray:
    """Nearest-gridpoint land test at arbitrary positions (False where
    invalid)."""
    ii = np.clip(np.round((lat - land_lat[0])
                          / (land_lat[1] - land_lat[0])), 0,
                 land_lat.size - 1)
    dlon = land_lon[1] - land_lon[0]
    jj = np.round((lon % 360.0 - land_lon[0]) / dlon)
    if abs(land_lon.size * dlon - 360.0) < 1e-6:
        jj = jj % land_lon.size          # global grid: wrap the 0/360 seam
    else:
        jj = np.clip(jj, 0, land_lon.size - 1)
    out = np.zeros(lon.shape, bool)
    out[valid] = land[ii[valid].astype(int), jj[valid].astype(int)] >= 0.5
    return out


def landfalls(ens: TrackEnsemble, land: np.ndarray, land_lon: np.ndarray,
              land_lat: np.ndarray, substeps: int = 1
              ) -> Dict[str, np.ndarray]:
    """Landfall statistics per track against a land mask [lat, lon]
    (ascending 0-360 axes, e.g. preprocess.static.load_land output).

    Detection is nearest-gridpoint at the track's output samples.  At the
    default ``substeps=1`` a storm that crosses a sub-grid island — or
    enters and re-exits a coastline between two output samples (< 1 h at
    the default interval) — records no landfall.  ``substeps=S`` closes
    that gap by testing S linearly interpolated positions per segment
    (segment-crossing detection): 'index' is then the output sample at or
    after the crossing and 'lon'/'lat'/'vmax' are interpolated at the first
    on-land subsample.  S=4 at hourly output resolves any feature a storm
    takes >= 15 min to cross; the mask's own resolution (0.25 deg for the
    bundled masks) remains the floor on which islands exist at all.

    Returns dict with 'index' [E, n_trk] (first sample over land after
    being over ocean; -1 = no landfall), 'vmax' (vmax at that sample) and
    'lon'/'lat' (landfall position) — the inputs of landfall return-period
    curves (BASELINE.json config 5; the reference computes these ad hoc in
    analysis, no library equivalent exists there)."""
    valid = np.isfinite(ens.lon) & np.isfinite(ens.lat)
    if substeps <= 1:
        on_land = _on_land_at(land, land_lon, land_lat, ens.lon, ens.lat,
                              valid)
        # first ocean->land transition
        was_ocean = valid & ~on_land
        prev_ocean = np.concatenate([np.zeros_like(was_ocean[..., :1]),
                                     was_ocean[..., :-1]], axis=-1)
        lf = on_land & prev_ocean
        any_lf = lf.any(axis=-1)
        idx = np.where(any_lf, lf.argmax(axis=-1), -1)
        take = np.take_along_axis
        sel = lambda a: np.where(any_lf,
                                 take(a, np.maximum(idx, 0)[..., None],
                                      axis=-1)[..., 0], np.nan)
        return {'index': idx, 'vmax': sel(ens.vmax),
                'lon': sel(ens.lon), 'lat': sel(ens.lat)}

    # sub-stepped segment-crossing detection: loop over time (memory-lean —
    # the full [E, n, T, S] subsample tensor would not fit large ensembles)
    T = ens.lon.shape[-1]
    shape = ens.lon.shape[:-1]
    found = np.zeros(shape, bool)
    idx = np.full(shape, -1, np.int64)
    lf_lon = np.full(shape, np.nan)
    lf_lat = np.full(shape, np.nan)
    lf_vmax = np.full(shape, np.nan)
    ocean_prev = valid[..., 0] & ~_on_land_at(
        land, land_lon, land_lat, ens.lon[..., 0], ens.lat[..., 0],
        valid[..., 0])
    for t in range(T - 1):
        seg_ok = valid[..., t] & valid[..., t + 1]
        for s in range(1, substeps + 1):
            f = s / substeps
            lo = ens.lon[..., t] * (1 - f) + ens.lon[..., t + 1] * f
            la = ens.lat[..., t] * (1 - f) + ens.lat[..., t + 1] * f
            onl = _on_land_at(land, land_lon, land_lat, lo, la, seg_ok)
            new = ~found & ocean_prev & onl
            if new.any():
                idx[new] = t + 1
                lf_lon[new] = lo[new]
                lf_lat[new] = la[new]
                vx = (ens.vmax[..., t] * (1 - f)
                      + ens.vmax[..., t + 1] * f)
                lf_vmax[new] = vx[new]
                found |= new
            ocean_prev = seg_ok & ~onl
    return {'index': idx, 'vmax': lf_vmax, 'lon': lf_lon, 'lat': lf_lat}


def _landfall_vmax(ens: TrackEnsemble, land: np.ndarray,
                   land_lon: np.ndarray, land_lat: np.ndarray,
                   region: Optional[Tuple[float, float, float, float]],
                   substeps: int = 1) -> np.ndarray:
    """Per-track landfall vmax flattened (NaN = no landfall / outside the
    optional region box) — the shared event vector of the landfall
    return-period estimate and its bootstrap band."""
    lf = landfalls(ens, land, land_lon, land_lat, substeps=substeps)
    v = lf['vmax'].ravel().copy()
    if region is not None:
        lon0, lon1, lat0, lat1 = region
        lo, la = lf['lon'].ravel() % 360.0, lf['lat'].ravel()
        v[~((lo >= lon0) & (lo <= lon1)
            & (la >= lat0) & (la <= lat1))] = np.nan
    return v


def landfall_return_periods(ens: TrackEnsemble, land: np.ndarray,
                            land_lon: np.ndarray, land_lat: np.ndarray,
                            vmax_bins: Optional[np.ndarray] = None,
                            region: Optional[Tuple[float, float, float,
                                                   float]] = None,
                            substeps: int = 1
                            ) -> Tuple[np.ndarray, np.ndarray]:
    """Return periods of landfall intensity (BASELINE.json config 5;
    reference notebook cells 16-17 semantics — simulated-year counting —
    applied to landfall events instead of a point of interest).

    region: optional (lon0, lon1, lat0, lat1) box (degrees, 0-360 lon)
    restricting which landfalls count — e.g. one coastline.  Returns
    (vmax_bins [m/s], return_period_years) with inf where never exceeded.
    """
    if vmax_bins is None:
        vmax_bins = np.arange(10.0, 81.0, 5.0)
    v = _landfall_vmax(ens, land, land_lon, land_lat, region, substeps)
    return vmax_bins, _rp_curve(v, ens.year.size * ens.n_ensemble,
                                vmax_bins)


def _block_ids(ens: TrackEnsemble) -> Tuple[np.ndarray, int]:
    """Simulated-year block id per track: (member, year) -> 0..E*Y-1.
    The (member, year) blocks are the independent sampling units of the
    downscaling (each year's quota is drawn independently), so resampling
    them bootstraps both storm counts and intensities."""
    year_pos = np.searchsorted(ens.year, ens.tc_years)
    e_idx = np.broadcast_to(np.arange(ens.n_ensemble)[:, None],
                            ens.tc_years.shape)
    return (e_idx * ens.year.size + year_pos).ravel(), \
        ens.n_ensemble * ens.year.size


def _bootstrap_rp(v: np.ndarray, blocks: np.ndarray, n_blocks: int,
                  vmax_bins: np.ndarray, n_boot: int, ci: float,
                  seed: int) -> Tuple[np.ndarray, np.ndarray]:
    """Year-block bootstrap of a return-period curve.

    v: per-event intensity (NaN = no event for that track); blocks: block
    id per event.  Returns (rp_lo, rp_hi) [n_bins] with inf where a band
    edge is never exceeded."""
    ok = np.isfinite(v)
    v, blocks = v[ok], blocks[ok]
    # per-block exceedance counts [n_blocks, n_bins]
    counts = np.zeros((n_blocks, vmax_bins.size))
    for j, b in enumerate(vmax_bins):
        np.add.at(counts[:, j], blocks[v >= b], 1.0)
    rng = np.random.default_rng(seed)
    draws = rng.integers(0, n_blocks, (n_boot, n_blocks))
    boot_counts = counts[draws].sum(axis=1)            # [n_boot, n_bins]
    # quantile the COUNTS and invert (quantiles of a return-period sample
    # containing inf would interpolate to NaN); high count -> low RP
    alpha = (1.0 - ci) / 2.0
    c_hi = np.quantile(boot_counts, 1.0 - alpha, axis=0)
    c_lo = np.quantile(boot_counts, alpha, axis=0)
    with np.errstate(divide='ignore'):
        lo = np.where(c_hi > 0, n_blocks / np.maximum(c_hi, 1e-30), np.inf)
        hi = np.where(c_lo > 0, n_blocks / np.maximum(c_lo, 1e-30), np.inf)
    return lo, hi


def return_period_ci(ens: TrackEnsemble, poi_lon: float, poi_lat: float,
                     radius_km: float = 100.0,
                     vmax_bins: Optional[np.ndarray] = None,
                     n_boot: int = 1000, ci: float = 0.90, seed: int = 0
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                np.ndarray]:
    """Point return-period curve with a simulated-year block-bootstrap
    confidence band (no reference equivalent — the reference notebook
    itself warns its 5-member estimate is not robust; this quantifies
    that).  Returns (vmax_bins, rp, rp_lo, rp_hi)."""
    if vmax_bins is None:
        vmax_bins = np.arange(10.0, 81.0, 5.0)
    # one geometry pass feeds BOTH the point estimate and the band
    vpoi = max_wind_near_point(ens, poi_lon, poi_lat, radius_km).ravel()
    rp = _rp_curve(vpoi, ens.year.size * ens.n_ensemble, vmax_bins)
    blocks, n_blocks = _block_ids(ens)
    lo, hi = _bootstrap_rp(vpoi, blocks, n_blocks, vmax_bins, n_boot, ci,
                           seed)
    return vmax_bins, rp, lo, hi


def landfall_return_period_ci(ens: TrackEnsemble, land: np.ndarray,
                              land_lon: np.ndarray, land_lat: np.ndarray,
                              vmax_bins: Optional[np.ndarray] = None,
                              region: Optional[Tuple[float, float, float,
                                                     float]] = None,
                              n_boot: int = 1000, ci: float = 0.90,
                              seed: int = 0, substeps: int = 1):
    """landfall_return_periods with a year-block bootstrap band.
    Returns (vmax_bins, rp, rp_lo, rp_hi)."""
    if vmax_bins is None:
        vmax_bins = np.arange(10.0, 81.0, 5.0)
    # one landfall pass feeds BOTH the point estimate and the band
    v = _landfall_vmax(ens, land, land_lon, land_lat, region, substeps)
    rp = _rp_curve(v, ens.year.size * ens.n_ensemble, vmax_bins)
    blocks, n_blocks = _block_ids(ens)
    lo, hi = _bootstrap_rp(v, blocks, n_blocks, vmax_bins, n_boot, ci, seed)
    return vmax_bins, rp, lo, hi


def intensity_change(ens: TrackEnsemble, land: np.ndarray,
                     land_lon: np.ndarray, land_lat: np.ndarray,
                     window_h: float = 24.0,
                     min_vmax_ms: float = 35.0 / MS_TO_KTS,
                     basin_id: Optional[str] = None,
                     dt_s: float = 3600.0) -> np.ndarray:
    """24-hour (window_h) intensity-change samples, the reference README's
    validation distribution (README.md:111-113: "24h-hour intensity change
    distribution ... Only open-ocean tropical cyclones with intensities of
    at-least 35 knots were considered").

    For every track sample t with vmax(t) >= min_vmax_ms (default 35 kt)
    where the storm is over open ocean at BOTH t and t + window_h (nearest-
    gridpoint land test, the same convention as landfalls()), emits
    vmax(t + window_h) - vmax(t).  Overlapping windows are all counted
    (one sample per output step), matching how such distributions are
    accumulated from 6-hourly best-track data.  basin_id restricts to
    tracks whose tc_basins match (the README figure is NA-only).

    Returns the flat array of intensity changes in m/s (multiply by
    MS_TO_KTS for the README's knots axis)."""
    k = int(round(window_h * 3600.0 / dt_s))
    if not 0 < k < ens.vmax.shape[-1]:
        raise ValueError(f'window {window_h} h = {k} steps is outside the '
                         f'track length {ens.vmax.shape[-1]}')
    vmax, lon, lat = ens.vmax, ens.lon, ens.lat
    if basin_id is not None:
        sel = ens.tc_basins == basin_id
        vmax, lon, lat = vmax[sel], lon[sel], lat[sel]
    valid = np.isfinite(vmax) & np.isfinite(lon) & np.isfinite(lat)
    ocean = valid & ~_on_land_at(land, land_lon, land_lat, lon, lat, valid)
    v0, v1 = vmax[..., :-k], vmax[..., k:]
    ok = (ocean[..., :-k] & ocean[..., k:]
          & np.isfinite(v0) & np.isfinite(v1) & (v0 >= min_vmax_ms))
    return (v1 - v0)[ok]


def pdi(ens: TrackEnsemble, dt_s: float = 3600.0) -> np.ndarray:
    """Power dissipation index per year: sum of vmax^3 dt over all track
    samples (the interannual-variability metric of the reference's
    validation, Lin et al. 2023 / README.md:2).  Returns [n_year] in
    m^3 s^-2, summed across ensemble members."""
    v3 = np.where(np.isfinite(ens.vmax), ens.vmax, 0.0) ** 3
    per_track = v3.sum(axis=-1) * dt_s                  # [E, n_trk]
    out = np.zeros(ens.year.size)
    for i, y in enumerate(ens.year):
        out[i] = per_track[ens.tc_years == y].sum()
    return out
