"""Analysis-library tests (reference notebook recipes as code) plus the
standalone BAM tracker and download request contracts."""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from tropical_cyclone_risk_tpu import analysis, runtime
from tropical_cyclone_risk_tpu.config import Namelist
from tropical_cyclone_risk_tpu.models import bam
from tropical_cyclone_risk_tpu.models.fields import synthetic_pack
from tropical_cyclone_risk_tpu.ops import fourier

CFG = Namelist()


def _write_member(path, cfg, seed, n_trk=6):
    rng = np.random.default_rng(seed)
    T = cfg.n_steps_output
    n_years = len(cfg.years())
    lon = np.cumsum(rng.normal(0, 0.2, (n_trk, T)), axis=1) + 250.0
    lat = np.cumsum(rng.normal(0.05, 0.1, (n_trk, T)), axis=1) + 15.0
    v = np.clip(rng.normal(30, 10, (n_trk, T)), 5, None)
    # make track 0 pass near the POI (260E, 25N) with known vmax
    lon[0] = 260.0
    lat[0] = 25.0
    v[0] = 55.0
    out = {
        'lon': lon, 'lat': lat, 'v': v, 'm': v * 0 + 0.5, 'vmax': v + 5,
        'wnds': rng.normal(0, 5, (n_trk, T, 4)),
        'month': rng.integers(6, 11, n_trk),
        'basin_idx': np.full(n_trk, 2),      # 'NA' in sorted basins
        'n_seeds': rng.integers(50, 150, (n_years, 7, 12)).astype(float),
        'year': np.repeat(cfg.years(), n_trk // n_years or 1)[:n_trk],
    }
    runtime.write_tracks_nc(path, out, cfg)
    return out


@pytest.fixture(scope='module')
def ensemble(tmp_path_factory):
    tmp = tmp_path_factory.mktemp('an')
    cfg = CFG.replace(start_year=2016, end_year=2017)
    paths = []
    for e in range(3):
        p = str(tmp / f'tracks_NA_era5_201601_201712_e{e}.nc')
        _write_member(p, cfg, seed=e)
        paths.append(p)
    return analysis.open_tracks(paths), cfg


def test_open_tracks_shapes(ensemble):
    ens, cfg = ensemble
    assert ens.n_ensemble == 3
    assert ens.lon.shape == (3, 6, cfg.n_steps_output)
    assert ens.tc_basins.shape == (3, 6)
    assert ens.tc_basins[0, 0] == 'NA'
    assert list(ens.basin) == list(cfg.basin_ids_sorted())


def test_seasonal_cycle(ensemble):
    ens, _ = ensemble
    dens = analysis.seasonal_cycle(ens, 'NA')
    assert dens.shape == (12,)
    assert dens.sum() == pytest.approx(1.0)
    assert dens[:4].sum() == 0.0          # months drawn in 6..10


def test_interannual_frequency(ensemble):
    ens, cfg = ensemble
    freq, c = analysis.interannual_frequency(ens, 'NA', cfg.tracks_per_year,
                                             obs_tracks_per_year=14.0)
    assert freq.shape == (2,)
    assert freq.mean() == pytest.approx(14.0, rel=0.2)


def test_interannual_frequency_from_data(ensemble):
    """Default mode derives per-year track counts from tc_years/tc_basins,
    so truncated or unfilled-quota runs scale gamma correctly.  The
    fixture has 3 tracks/year/member ('NA'), matching an explicit
    tracks_per_year=3."""
    ens, _ = ensemble
    f_data, c_data = analysis.interannual_frequency(
        ens, 'NA', obs_tracks_per_year=14.0)
    f_quota, c_quota = analysis.interannual_frequency(
        ens, 'NA', tracks_per_year=3, obs_tracks_per_year=14.0)
    np.testing.assert_allclose(f_data, f_quota)
    assert c_data == pytest.approx(c_quota)
    # truncate: drop year-2017 tracks from one member (simulating --n-years)
    import dataclasses
    trunc = dataclasses.replace(
        ens, tc_years=np.where((np.arange(ens.tc_years.shape[0])[:, None]
                                == 0) & (ens.tc_years == 2017),
                               -1, ens.tc_years))
    f_t, _ = analysis.interannual_frequency(trunc, 'NA',
                                            obs_tracks_per_year=14.0)
    # 2017 numerator fell by a third; data-derived gamma reflects it
    assert f_t[1] < f_data[1]


def test_return_periods(ensemble):
    ens, _ = ensemble
    bins, rp = analysis.return_periods(ens, poi_lon=260.0, poi_lat=25.0)
    assert np.all(np.diff(rp[np.isfinite(rp)]) >= 0)   # monotone curve
    # track 0 of each member sits at the POI with vmax 60
    i55 = np.searchsorted(bins, 55.0)
    assert np.isfinite(rp[i55])
    assert rp[-1] == np.inf                            # 80 m/s never reached


def test_track_density_and_lmi(ensemble):
    ens, _ = ensemble
    h, lon_e, lat_e = analysis.track_density(ens, res_deg=5.0)
    assert h.sum() > 0
    # all tracks live in the NA box
    iy, ix = np.nonzero(h)
    assert lat_e[iy].min() >= 0 and lon_e[ix].max() <= 330
    centers, dens = analysis.lmi_distribution(ens)
    assert dens.sum() > 0


def test_genesis_density(ensemble):
    ens, _ = ensemble
    h, lon_e, lat_e = analysis.genesis_density(ens, res_deg=5.0)
    # exactly one genesis point per track with any valid sample
    n_tracks = (np.isfinite(ens.lon).any(axis=-1)).sum()
    assert h.sum() == n_tracks
    # genesis points are a subset of track points: the density support
    # must lie inside the track-density support on the same grid
    ht, _, _ = analysis.track_density(ens, res_deg=5.0)
    assert np.all(ht[h > 0] > 0)


def test_bam_standalone_tracks():
    cfg = Namelist()
    pack = synthetic_pack(cfg, n_planes=12, nlat=91, nlon=180, seed=0)
    n = 8
    fs = fourier.draw_fourier(jax.random.key(0), (n, cfg.n_wind_levels),
                              cfg.T_fourier_s)
    out = bam.gen_tracks(pack, cfg, 'GL',
                         np.linspace(150, 220, n), np.full(n, 15.0),
                         jnp.full(n, 7, jnp.int32), fs)
    lon = np.asarray(out.lon)
    assert lon.shape == (n, cfg.n_steps_output)
    assert np.all(np.asarray(out.alive)[:, 0])
    # tracks move: displacement after one day is nonzero
    assert np.nanmax(np.abs(lon[:, 24] - lon[:, 0])) > 0.1
    # poleward beta drift in the NH
    lat = np.asarray(out.lat)
    mean_drift = np.nanmean(lat[:, 48] - lat[:, 0])
    assert mean_drift > 0


def test_download_request_shapes():
    from tropical_cyclone_risk_tpu.scripts import download_cmip6, download_era5
    reqs = download_era5.year_requests(2020)
    assert len(reqs) == 6
    names = [r[1] for r in reqs]
    assert 'era5_u_daily_2020.nc' in names and 'era5_sst_2020.nc' in names
    daily = dict((r[1], r[2]) for r in reqs)['era5_u_daily_2020.nc']
    assert daily['pressure_level'] == ['250', '850']
    assert daily['time'] == ['00:00', '12:00']
    url = download_cmip6.search_url('ua', 'day')
    assert 'variable_id=ua' in url and 'GFDL-CM4' in url
    # gated error without cdsapi
    cfg = Namelist()
    with pytest.raises(RuntimeError, match='cdsapi'):
        download_era5.download_year(cfg, 2020)


def test_cmip6_offline_url_lists(tmp_path, monkeypatch):
    """Pre-fetched acquisition (the reference's bundled-wget-script mode,
    scripts/download_cmip6.py:17-34 + scripts/GFDL-CM4/wget_*.sh): ESGF
    wget scripts and plain URL lists are consumed without any live search
    endpoint; downloads are idempotent and atomic."""
    from tropical_cyclone_risk_tpu.scripts import download_cmip6

    # a standard ESGF-wget download_files section (the generator's format)
    wget = tmp_path / 'wget_ua_day.sh'
    wget.write_text(
        "#!/bin/bash\ndownload_files=$(cat <<EOF--dataset.file.url\n"
        "'ua_day_GFDL-CM4_ssp585_r1i1p1f1_gr1_20150101-20341231.nc' "
        "'http://esgf.example/ua_day_1.nc' 'SHA256' 'abc123'\n"
        "'ua_day_GFDL-CM4_ssp585_r1i1p1f1_gr1_20350101-20541231.nc' "
        "'http://esgf.example/ua_day_2.nc' 'SHA256' 'def456'\n"
        "EOF--dataset.file.url\n)\n")
    plain = tmp_path / 'tos_urls.txt'
    plain.write_text("# tos Omon\nhttp://esgf.example/tos_Omon_x.nc\n")

    pairs = download_cmip6.file_urls_from_lists([str(tmp_path)])
    assert ('tos_Omon_x.nc', 'http://esgf.example/tos_Omon_x.nc') in pairs
    assert len(pairs) == 3
    assert sum(n.startswith('ua_day_GFDL-CM4') for n, _ in pairs) == 2

    # download_all(url_lists=...) never touches the search API
    fetched = []
    monkeypatch.setattr(download_cmip6.urllib.request, 'urlretrieve',
                        lambda url, tmp: (fetched.append(url),
                                          open(tmp, 'wb').write(b'x')))
    monkeypatch.setattr(
        download_cmip6, 'list_file_urls',
        lambda *a, **k: pytest.fail('search API must not be queried'))
    cfg = Namelist().replace(base_directory=str(tmp_path / 'data'))
    out = download_cmip6.download_all(cfg, url_lists=[str(tmp_path)])
    assert len(out) == 3 and all(os.path.exists(p) for p in out)
    # idempotent rerun: nothing re-fetched
    n0 = len(fetched)
    download_cmip6.download_all(cfg, url_lists=[str(tmp_path)])
    assert len(fetched) == n0

    with pytest.raises(ValueError, match='no ESGF wget entries'):
        empty = tmp_path / 'empty.txt'
        empty.write_text('# nothing\n')
        download_cmip6.file_urls_from_lists([str(empty)])

    # same filename listed twice with the SAME url: fine (listing rerun);
    # with a DIFFERENT url: a conflict that must not be silently resolved
    dup_ok = tmp_path / 'dup_ok.txt'
    dup_ok.write_text('http://esgf.example/tos_Omon_x.nc\n')
    assert len(download_cmip6.file_urls_from_lists(
        [str(plain), str(dup_ok)])) == 1
    conflict = tmp_path / 'conflict.txt'
    conflict.write_text('http://mirror.example/other/tos_Omon_x.nc\n')
    with pytest.raises(ValueError, match='conflicting listings'):
        download_cmip6.file_urls_from_lists([str(plain), str(conflict)])

    # a URL with no filename component would make download_all target the
    # base directory itself — rejected at parse time
    slashy = tmp_path / 'slashy.txt'
    slashy.write_text('http://esgf.example/somedir/\n')
    with pytest.raises(ValueError, match='no filename component'):
        download_cmip6.file_urls_from_lists([str(slashy)])


def test_landfalls():
    ens, cfg = None, CFG.replace(start_year=2016, end_year=2016)
    T = cfg.n_steps_output
    lon = np.full((1, 2, T), np.nan, np.float32)
    lat = np.full((1, 2, T), np.nan, np.float32)
    vmax = np.full((1, 2, T), np.nan, np.float32)
    # track 0 crosses lon=300 eastward onto land at sample 10
    lon[0, 0, :20] = np.linspace(290, 309, 20)
    lat[0, 0, :20] = 20.0
    vmax[0, 0, :20] = np.linspace(30, 49, 20)
    # track 1 stays over ocean
    lon[0, 1, :30] = np.linspace(200, 229, 30)
    lat[0, 1, :30] = 15.0
    vmax[0, 1, :30] = 40.0
    land_lon = np.arange(0.0, 360.0, 1.0)
    land_lat = np.linspace(-90, 90, 181)
    land = np.zeros((181, 360), np.float32)
    land[:, 300:] = 1.0                     # land east of 300E
    ens = analysis.TrackEnsemble(
        lon=lon, lat=lat, vmax=vmax, v=vmax,
        tc_month=np.array([[9, 9]]), tc_years=np.array([[2016, 2016]]),
        tc_basins=np.array([['NA', 'EP']]),
        seeds_per_month=np.zeros((1, 1, 7, 12)),
        year=np.array([2016]), basin=list(cfg.basin_ids_sorted()))
    lf = analysis.landfalls(ens, land, land_lon, land_lat)
    assert lf['index'][0, 0] > 0
    assert lf['index'][0, 1] == -1 and np.isnan(lf['vmax'][0, 1])
    k = lf['index'][0, 0]
    assert abs(lf['lon'][0, 0] - lon[0, 0, k]) < 1e-5
    assert lon[0, 0, k] >= 299.5


def test_landfall_wraps_prime_meridian():
    """Positions within half a cell of the 0/360 seam must sample the
    wrapped land column, not clamp to the last one."""
    cfg = CFG.replace(start_year=2016, end_year=2016)
    T = cfg.n_steps_output
    lon = np.full((1, 1, T), np.nan, np.float32)
    lat = np.full((1, 1, T), np.nan, np.float32)
    vmax = np.full((1, 1, T), np.nan, np.float32)
    lon[0, 0, :10] = np.linspace(358.0, 359.8, 10)   # approaches the seam
    lat[0, 0, :10] = 10.0
    vmax[0, 0, :10] = 35.0
    land_lon = np.arange(0.0, 360.0, 1.0)
    land_lat = np.linspace(-90, 90, 181)
    land = np.zeros((181, 360), np.float32)
    land[:, 0] = 1.0                                  # land only at lon 0
    ens = analysis.TrackEnsemble(
        lon=lon, lat=lat, vmax=vmax, v=vmax,
        tc_month=np.array([[9]]), tc_years=np.array([[2016]]),
        tc_basins=np.array([['NA']]),
        seeds_per_month=np.zeros((1, 1, 7, 12)),
        year=np.array([2016]), basin=list(cfg.basin_ids_sorted()))
    lf = analysis.landfalls(ens, land, land_lon, land_lat)
    # lon 359.8 rounds to column 360 -> wraps to column 0 (land)
    assert lf['index'][0, 0] >= 0
    assert lf['lon'][0, 0] > 359.0


def test_return_period_ci_brackets_estimate(tmp_path):
    """Year-block bootstrap band: identical blocks give a zero-width band
    equal to the point estimate; heterogeneous blocks give lo <= rp <= hi
    with positive width."""
    cfg = CFG.replace(start_year=2016, end_year=2017)
    T = cfg.n_steps_output
    E, n_trk = 2, 4
    rng = np.random.default_rng(0)
    lon = np.full((E, n_trk, T), 250.0, np.float32)
    lat = np.full((E, n_trk, T), 25.0, np.float32)
    vmax = np.full((E, n_trk, T), 30.0, np.float32)
    years = np.tile(np.array([2016, 2016, 2017, 2017]), (E, 1))
    ens_kwargs = dict(
        tc_month=np.full((E, n_trk), 9), tc_years=years,
        tc_basins=np.full((E, n_trk), 'NA'),
        seeds_per_month=np.zeros((E, 2, 7, 12)),
        year=np.array([2016, 2017]), basin=list(cfg.basin_ids_sorted()))
    # identical blocks: every (member, year) has the same exceedance set
    ens = analysis.TrackEnsemble(lon=lon, lat=lat, vmax=vmax, v=vmax,
                                 **ens_kwargs)
    bins, rp, lo, hi = analysis.return_period_ci(
        ens, 250.0, 25.0, vmax_bins=np.array([20.0]), n_boot=200)
    np.testing.assert_allclose([rp[0], lo[0], hi[0]], 0.5)
    # heterogeneous: only member 0 / year 2016 tracks reach 60 m/s
    vmax2 = vmax.copy()
    vmax2[0, :2] = 65.0
    ens2 = analysis.TrackEnsemble(lon=lon, lat=lat, vmax=vmax2, v=vmax2,
                                  **ens_kwargs)
    bins, rp, lo, hi = analysis.return_period_ci(
        ens2, 250.0, 25.0, vmax_bins=np.array([20.0, 60.0]), n_boot=500)
    assert lo[1] <= rp[1] <= hi[1]
    assert hi[1] > lo[1]          # real sampling uncertainty at the tail


def test_landfall_return_periods():
    """Two 1-year members, one landfalling track each at known vmax: the
    return-period curve must count exceedances over member-summed years,
    and the region box must exclude out-of-box landfalls."""
    cfg = CFG.replace(start_year=2016, end_year=2016)
    T = cfg.n_steps_output
    lon = np.full((2, 1, T), np.nan, np.float32)
    lat = np.full((2, 1, T), np.nan, np.float32)
    vmax = np.full((2, 1, T), np.nan, np.float32)
    for e, v_lf in enumerate((45.0, 62.0)):
        lon[e, 0, :20] = np.linspace(290, 309, 20)   # landfall at ~300E
        lat[e, 0, :20] = 20.0 + 10.0 * e             # member 1 at 30N
        vmax[e, 0, :20] = v_lf
    land_lon = np.arange(0.0, 360.0, 1.0)
    land_lat = np.linspace(-90, 90, 181)
    land = np.zeros((181, 360), np.float32)
    land[:, 300:] = 1.0
    ens = analysis.TrackEnsemble(
        lon=lon, lat=lat, vmax=vmax, v=vmax,
        tc_month=np.array([[9], [9]]), tc_years=np.full((2, 1), 2016),
        tc_basins=np.array([['NA'], ['NA']]),
        seeds_per_month=np.zeros((2, 1, 7, 12)),
        year=np.array([2016]), basin=list(cfg.basin_ids_sorted()))
    bins, rp = analysis.landfall_return_periods(
        ens, land, land_lon, land_lat, vmax_bins=np.array([40.0, 60.0, 80.0]))
    # 2 member-years total: both landfalls >= 40 -> RP 1 yr; one >= 60 ->
    # RP 2 yr; none >= 80 -> inf
    np.testing.assert_allclose(rp[:2], [1.0, 2.0])
    assert np.isinf(rp[2])
    # region box excluding member 1's 30N landfall
    _, rp_box = analysis.landfall_return_periods(
        ens, land, land_lon, land_lat, vmax_bins=np.array([40.0, 60.0]),
        region=(280.0, 320.0, 15.0, 25.0))
    np.testing.assert_allclose(rp_box, [2.0, np.inf])


def test_pdi(ensemble):
    ens, cfg = ensemble
    p = analysis.pdi(ens)
    assert p.shape == (2,)
    assert np.all(p > 0)
    # direct check: total PDI equals sum over all finite samples
    total = np.nansum(np.where(np.isfinite(ens.vmax), ens.vmax, 0) ** 3) * 3600
    np.testing.assert_allclose(p.sum(), total, rtol=1e-6)


def test_intensity_change():
    """README.md:111-113 validation distribution: 24-h intensity change
    over open-ocean samples with vmax >= 35 kt, NA-only."""
    cfg = CFG.replace(start_year=2016, end_year=2016)
    T = cfg.n_steps_output
    lon = np.full((1, 3, T), np.nan, np.float32)
    lat = np.full((1, 3, T), np.nan, np.float32)
    vmax = np.full((1, 3, T), np.nan, np.float32)
    # track 0 (NA): 60 ocean samples, vmax = 20 + 0.5 t -> dv24 = 12 exactly
    lon[0, 0, :60] = 280.0
    lat[0, 0, :60] = 20.0
    vmax[0, 0, :60] = 20.0 + 0.5 * np.arange(60)
    # track 1 (NA): same ramp but moves onto land at sample 30
    lon[0, 1, :60] = np.where(np.arange(60) < 30, 280.0, 310.0)
    lat[0, 1, :60] = 20.0
    vmax[0, 1, :60] = 20.0 + 0.5 * np.arange(60)
    # track 2 (EP): strong ramp, excluded by the basin filter
    lon[0, 2, :60] = 240.0
    lat[0, 2, :60] = 15.0
    vmax[0, 2, :60] = 30.0 + 1.0 * np.arange(60)
    land_lon = np.arange(0.0, 360.0, 1.0)
    land_lat = np.linspace(-90, 90, 181)
    land = np.zeros((181, 360), np.float32)
    land[:, 300:] = 1.0
    ens = analysis.TrackEnsemble(
        lon=lon, lat=lat, vmax=vmax, v=vmax,
        tc_month=np.array([[9, 9, 9]]),
        tc_years=np.array([[2016, 2016, 2016]]),
        tc_basins=np.array([['NA', 'NA', 'EP']]),
        seeds_per_month=np.zeros((1, 1, 7, 12)),
        year=np.array([2016]), basin=list(cfg.basin_ids_sorted()))

    dv = analysis.intensity_change(ens, land, land_lon, land_lat,
                                   basin_id='NA')
    # track 0: t = 0..35 all eligible (vmax(0) = 20 >= 35 kt = 18.0 m/s)
    # track 1: both endpoints must be over ocean -> t and t+24 < 30: t 0..5
    assert dv.size == 36 + 6
    np.testing.assert_allclose(dv, 12.0, atol=1e-5)
    # without the basin filter track 2 contributes t = 0..35 at dv = 24
    dv_all = analysis.intensity_change(ens, land, land_lon, land_lat)
    assert dv_all.size == 42 + 36
    np.testing.assert_allclose(np.sort(dv_all)[-36:], 24.0, atol=1e-5)
    # threshold: raising the floor above every sample leaves nothing
    assert analysis.intensity_change(ens, land, land_lon, land_lat,
                                     min_vmax_ms=200.0).size == 0
    with pytest.raises(ValueError):
        analysis.intensity_change(ens, land, land_lon, land_lat,
                                  window_h=T * 2.0)


def test_landfall_substeps_subgrid_island():
    """Hourly nearest-gridpoint sampling steps over a one-cell island
    crossed mid-segment; substeps>1 segment-crossing detection records
    the landfall at the interpolated crossing."""
    cfg = CFG.replace(start_year=2016, end_year=2016)
    T = cfg.n_steps_output
    lon = np.full((1, 2, T), np.nan, np.float32)
    lat = np.full((1, 2, T), np.nan, np.float32)
    vmax = np.full((1, 2, T), np.nan, np.float32)
    # track 0: 2 deg/h zonal motion, samples at even lons; a single 1-deg
    # island sits at lon=301 (odd) -> every hourly sample rounds to ocean
    lon[0, 0, :20] = 292.0 + 2.0 * np.arange(20)
    lat[0, 0, :20] = 20.0
    vmax[0, 0, :20] = np.linspace(30, 49, 20)
    # track 1: same motion but far from the island (control, no landfall)
    lon[0, 1, :20] = 192.0 + 2.0 * np.arange(20)
    lat[0, 1, :20] = 10.0
    vmax[0, 1, :20] = 40.0
    land_lon = np.arange(0.0, 360.0, 1.0)
    land_lat = np.linspace(-90, 90, 181)
    land = np.zeros((181, 360), np.float32)
    land[105:115, 301] = 1.0               # 1-deg island column at 301E
    ens = analysis.TrackEnsemble(
        lon=lon, lat=lat, vmax=vmax, v=vmax,
        tc_month=np.array([[9, 9]]), tc_years=np.array([[2016, 2016]]),
        tc_basins=np.array([['NA', 'EP']]),
        seeds_per_month=np.zeros((1, 1, 7, 12)),
        year=np.array([2016]), basin=list(cfg.basin_ids_sorted()))

    lf1 = analysis.landfalls(ens, land, land_lon, land_lat)
    assert lf1['index'][0, 0] == -1        # hourly sampling misses it
    lf4 = analysis.landfalls(ens, land, land_lon, land_lat, substeps=4)
    k = lf4['index'][0, 0]
    assert k > 0
    assert abs(lf4['lon'][0, 0] - 301.0) <= 0.5   # crossing at the island
    assert np.isfinite(lf4['vmax'][0, 0])
    assert lf4['index'][0, 1] == -1               # control still clean

    # on a coastline held for >= 1 sample both modes agree on the index
    land2 = np.zeros((181, 360), np.float32)
    land2[:, 300:] = 1.0
    a = analysis.landfalls(ens, land2, land_lon, land_lat)
    b = analysis.landfalls(ens, land2, land_lon, land_lat, substeps=4)
    assert a['index'][0, 0] == b['index'][0, 0]
    assert a['index'][0, 1] == b['index'][0, 1] == -1
