"""CMIP6 (GCM-forced) end-to-end run: a synthetic GFDL-CM4-ssp585-style raw
workspace (noleap daily ua/va on Pa plev, Amon ta/hus/psl, Omon tos in degC
on a finer ocean grid — tools/make_synthetic_cmip6.py) driven through the
full CLI (land masks -> wind stats -> thermo -> simulation -> tracks NetCDF).

Reference equivalent: running run.py with namelist dataset_type='GCM' on the
GFDL-CM4 wget-script downloads (scripts/download_cmip6.py:17-34,
util/input.py:111-133).
"""

import os
import sys
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).parent.parent))

from tropical_cyclone_risk_tpu import cli  # noqa: E402
from tropical_cyclone_risk_tpu.io import netcdf  # noqa: E402

from tools import make_synthetic_cmip6  # noqa: E402


@pytest.fixture(scope='module')
def gcm_workspace(tmp_path_factory):
    ws = str(tmp_path_factory.mktemp('cmip6'))
    make_synthetic_cmip6.build(ws, 2030, 2031, coarse=True, seed=0)
    # shrink the run for CI: small seed batches, 2 tracks/yr
    nl = Path(ws) / 'namelist.py'
    txt = nl.read_text().replace('tracks_per_year = 14',
                                 'tracks_per_year = 2')
    txt = txt.replace('seed_batch = 16384', 'seed_batch = 1024')
    nl.write_text(txt)
    return ws


def test_cmip6_run_to_tracks(gcm_workspace):
    ws = gcm_workspace
    rc = cli.main(['GL', '--namelist', f'{ws}/namelist.py', '--seed', '3'])
    assert rc == 0
    fn = f'{ws}/out/proj/tracks_GL_ssp585_203001_203112.nc'
    assert os.path.exists(fn), os.listdir(f'{ws}/out/proj')

    ds = netcdf.read(fn)
    for nm in ('lon_trks', 'lat_trks', 'v_trks', 'm_trks', 'vmax_trks',
               'u250_trks', 'v850_trks', 'tc_month', 'tc_basins', 'tc_years',
               'seeds_per_month'):
        assert nm in ds, nm
    v = np.asarray(ds['v_trks'].data)
    years = np.asarray(ds['tc_years'].data)
    assert v.shape == (4, 361)                    # 2 tracks x 2 years
    assert sorted(set(years.tolist())) == [2030, 2031]
    assert np.nanmax(v, axis=1).min() >= 15.0
    spm = np.asarray(ds['seeds_per_month'].data)
    assert spm.shape[0] == 2 and spm.sum() > 0
    # provenance snapshot written
    assert os.path.exists(fn[:-3] + '.config.json')

    # intermediates follow the reference naming contracts
    assert os.path.exists(f'{ws}/out/thermo_ssp585_203001_203112.nc')
    assert os.path.exists(f'{ws}/out/env_wnd_ssp585_203001_203112.nc')
    th = netcdf.read(f'{ws}/out/thermo_ssp585_203001_203112.nc')
    vmax_pi = np.asarray(th['vmax'].data)
    assert vmax_pi.shape[0] == 24                 # monthly over 2 years
    lat = np.asarray(th['lat'].data)
    assert np.nanmax(vmax_pi[:, np.abs(lat) < 25]) > 50.0   # degC->K applied
