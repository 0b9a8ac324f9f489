"""Generate a full-scale synthetic ERA5-style raw workspace (1-degree,
multi-year, twice-daily winds) for production end-to-end runs without
network access.  Usage: python tools/make_synthetic_era5.py WORKDIR [Y0 Y1]
"""
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from tropical_cyclone_risk_tpu.io import netcdf  # noqa: E402

NLON, NLAT = 360, 181
LON = np.arange(0.0, 360.0, 1.0)
LAT = np.linspace(-90.0, 90.0, NLAT)
LEVELS_HPA = np.array([100.0, 250.0, 400.0, 600.0, 850.0, 1000.0])


def land_2d():
    LO, LA = np.meshgrid(LON, LAT)
    return ((np.abs(LA) > 70) | ((LO > 265) & (LO < 310) & (LA > -55) &
                                 (LA < 60)) |
            ((LO > 10) & (LO < 50) & (LA > -35) & (LA < 35))
            ).astype(np.float32)


def write_year(base, year, rng):
    land = land_2d()
    LA = LAT[:, None] + 0 * LON[None, :]
    t_month = np.array([np.datetime64(f'{year}-{m:02d}-01', 's')
                        for m in range(1, 13)])
    t_num = (t_month - np.datetime64('1900-01-01', 's')) / np.timedelta64(1, 'h')
    tattrs = {'units': 'hours since 1900-01-01 00:00:00.0'}

    seasonal = np.cos(2 * np.pi * (np.arange(12)[:, None, None] - 7.5) / 12)
    # mild warming trend (~0.7 K over 45 y; anchored mid-record so early
    # decades stay warm enough for genesis)
    warm = 0.015 * (year - 2000)
    sst = (302.0 + warm - 30.0 * (LA / 90.0) ** 2 + 1.5 * seasonal
           + 0.3 * rng.standard_normal((12, NLAT, NLON))).astype(np.float32)
    sst = np.where(land[None] > 0, np.nan, sst)
    netcdf.write(f'{base}/era5_sst_{year}.nc',
                 {'sst': (('time', 'latitude', 'longitude'), sst)},
                 coords={'time': t_num, 'latitude': LAT, 'longitude': LON},
                 var_attrs={'time': tattrs, 'sst': {'units': 'K'}})
    sp = np.full((12, NLAT, NLON), 101000.0, np.float32)
    netcdf.write(f'{base}/era5_sp_{year}.nc',
                 {'sp': (('time', 'latitude', 'longitude'), sp)},
                 coords={'time': t_num, 'latitude': LAT, 'longitude': LON},
                 var_attrs={'time': tattrs})
    p = LEVELS_HPA * 100.0
    Tsfc = np.broadcast_to(np.nan_to_num(sst, nan=285.0) - 1.0,
                           (12, NLAT, NLON))
    T = np.zeros((12, p.size, NLAT, NLON), np.float32)
    q = np.zeros_like(T)
    for li, pl in enumerate(p):
        T[:, li] = Tsfc * (pl / 101000.0) ** 0.19
        q[:, li] = (0.016 * np.exp(-(101000.0 - pl) / 25000.0)
                    * np.clip((Tsfc - 260.0) / 40.0, 0.05, 1.2))
    for nm, arr in (('t', T), ('q', q)):
        netcdf.write(f'{base}/era5_{nm}_{year}.nc',
                     {nm: (('time', 'level', 'latitude', 'longitude'), arr)},
                     coords={'time': t_num, 'level': LEVELS_HPA,
                             'latitude': LAT, 'longitude': LON},
                     var_attrs={'time': tattrs,
                                'level': {'units': 'millibars'}})

    # twice-daily winds: jets + seasonal + AR(1) synoptic noise
    n_days = 365 + (1 if year % 4 == 0 else 0)
    nt = n_days * 2
    tt = np.arange(nt) * 12.0
    t0 = (np.datetime64(f'{year}-01-01', 's')
          - np.datetime64('1900-01-01', 's')) / np.timedelta64(1, 'h')
    base_u250 = -8.0 + 20.0 * np.sin(np.deg2rad(LA)) ** 2
    base_u850 = -5.0 + 6.0 * np.sin(np.deg2rad(LA)) ** 2
    for nm, base_f in (('u', (base_u250, base_u850)), ('v', (0.0, 0.0))):
        arr = np.empty((nt, 2, NLAT, NLON), np.float32)
        noise = rng.standard_normal((2, NLAT, NLON)).astype(np.float32) * 3
        for it in range(nt):
            season = np.cos(2 * np.pi * (tt[it] / 24.0 / 365.0 - 0.6))
            noise = 0.9 * noise + 0.44 * rng.standard_normal(
                (2, NLAT, NLON)).astype(np.float32) * 3
            for lv in range(2):
                b = base_f[lv] if nm == 'u' else 0.0
                arr[it, lv] = b + 2.0 * season + noise[lv]
        netcdf.write(f'{base}/era5_{nm}_daily_{year}.nc',
                     {nm: (('time', 'level', 'latitude', 'longitude'), arr)},
                     coords={'time': t0 + tt,
                             'level': np.array([250.0, 850.0]),
                             'latitude': LAT, 'longitude': LON},
                     var_attrs={'time': tattrs,
                                'level': {'units': 'millibars'}})


def write_static(ws):
    land = land_2d()
    os.makedirs(f'{ws}/static', exist_ok=True)
    netcdf.write(f'{ws}/static/land.nc', {'land': (('lat', 'lon'), land)},
                 coords={'lat': LAT, 'lon': LON})
    mld = np.where(land[:, :, None] > 0, np.nan,
                   40.0 + 20.0 * np.cos(np.deg2rad(LAT))[:, None, None]
                   * np.ones((NLAT, NLON, 12))).astype(np.float32)
    strat = np.where(land[:, :, None] > 0, np.nan,
                     np.full((NLAT, NLON, 12), 5.0)).astype(np.float32)
    netcdf.write(f'{ws}/static/mld.nc',
                 {'mld': (('lat', 'lon', 'month'), mld)},
                 coords={'lat': LAT, 'lon': LON,
                         'month': np.arange(1.0, 13.0)})
    netcdf.write(f'{ws}/static/strat.nc',
                 {'strat': (('lat', 'lon', 'month'), strat)},
                 coords={'lat': LAT, 'lon': LON,
                         'month': np.arange(1.0, 13.0)})


def make_workspace(ws, y0=2016, y1=2021, tracks_per_year=20,
                   seed_batch=16384):
    """Write static fields, years y0..y1 of raw fields and a namelist.py
    under ws; returns the namelist path.  Every array comes from one
    generator with the fixed seed 0, so a workspace is reproducible."""
    os.makedirs(f'{ws}/raw', exist_ok=True)
    os.makedirs(f'{ws}/out', exist_ok=True)
    rng = np.random.default_rng(0)
    write_static(ws)
    for year in range(y0, y1 + 1):
        write_year(f'{ws}/raw', year, rng)
        print('wrote', year, flush=True)
    fn = f'{ws}/namelist.py'
    with open(fn, 'w') as f:
        f.write(f"""
base_directory = {ws + '/raw'!r}
output_directory = {ws + '/out'!r}
exp_name = 'prod'
exp_prefix = 'era5'
dataset_type = 'ERA5'
start_year = {y0}
start_month = 1
end_year = {y1}
end_month = 12
tracks_per_year = {tracks_per_year}
fn_land = {ws + '/static/land.nc'!r}
fn_bathy = {ws + '/static/bathymetry.nc'!r}
fn_mld = {ws + '/static/mld.nc'!r}
fn_strat = {ws + '/static/strat.nc'!r}
mask_dir = {ws + '/land'!r}
seed_batch = {seed_batch}
""")
    print('workspace ready:', ws, flush=True)
    return fn


def main():
    ws = sys.argv[1]
    y0 = int(sys.argv[2]) if len(sys.argv) > 2 else 2016
    y1 = int(sys.argv[3]) if len(sys.argv) > 3 else 2021
    make_workspace(ws, y0, y1)


if __name__ == '__main__':
    main()
