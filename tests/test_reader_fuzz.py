"""Reader fuzzing: mutated/corrupted input files must raise NAMED,
actionable errors — never flow silently wrong data into preprocessing
(SURVEY.md section 7's "where silent wrongness lives"
checklist).

Covered mutations: truncated files (classic and HDF5), scrambled dimension
order (time not leading), all-fill variables, 0-length time axes, mixed
hPa/Pa level axes across one file set, mixed lon conventions across one
file set, cross-file level-order mismatch, and non-NetCDF garbage bytes.
"""

from __future__ import annotations

import datetime
import os

import numpy as np
import pytest

from tropical_cyclone_risk_tpu.config import Namelist
from tropical_cyclone_risk_tpu.io import input as tcin
from tropical_cyclone_risk_tpu.io import netcdf


def _write_monthly(path, key='sst', nlon=12, nlat=8, months=(0, 1, 2),
                   lon=None, lat=None, lvl=None, lvl_units=None,
                   data=None, dims=None, time_vals=None):
    lon = np.arange(0.0, 360.0, 360.0 / nlon) if lon is None else lon
    lat = np.linspace(-30.0, 30.0, nlat) if lat is None else lat
    t = (np.asarray(months, float) * 30.4 + 15.0 if time_vals is None
         else np.asarray(time_vals, float))
    shape = [len(t), lat.size, lon.size]
    names = ['time', 'lat', 'lon']
    coords = {'time': t, 'lat': lat, 'lon': lon}
    if lvl is not None:
        shape.insert(1, len(lvl))
        names.insert(1, 'lvl')
        coords['lvl'] = np.asarray(lvl, float)
    if data is None:
        data = np.arange(np.prod(shape), dtype=np.float32).reshape(shape)
    if dims is None:
        dims = tuple(names)
    var_attrs = {'time': {'units': 'days since 2016-01-01'}}
    if lvl_units is not None:
        var_attrs['lvl'] = {'units': lvl_units}
    netcdf.write(path, {key: (dims, data)}, coords=coords,
                 var_attrs=var_attrs)
    return path


def _var(files, key='sst'):
    return tcin.MonthlyVar(list(files), key)


T0 = datetime.datetime(2016, 1, 1)
T1 = datetime.datetime(2016, 12, 31)


def test_truncated_classic_named_error(tmp_path):
    p = str(tmp_path / 'x_sst_a.nc')
    _write_monthly(p)
    raw = open(p, 'rb').read()
    for frac in (0.95, 0.6, 0.2):
        open(p, 'wb').write(raw[:int(len(raw) * frac)])
        with pytest.raises(ValueError, match='x_sst_a.nc'):
            ds = netcdf.read(p)
            np.asarray(ds['sst'].data)     # force data access too


def test_truncated_hdf5_named_error(tmp_path):
    import h5py
    p = str(tmp_path / 'h5_sst.nc')
    with h5py.File(p, 'w') as f:
        f.create_dataset('sst', data=np.ones((4, 8, 12), np.float32))
    raw = open(p, 'rb').read()
    open(p, 'wb').write(raw[:len(raw) // 3])
    with pytest.raises(ValueError, match='h5_sst.nc'):
        netcdf.read(p)


def test_garbage_bytes_named_error(tmp_path):
    p = str(tmp_path / 'junk.nc')
    open(p, 'wb').write(b'\x00\x01\x02\x03 this is not netcdf at all')
    with pytest.raises(ValueError, match='not a NetCDF file'):
        netcdf.read(p)


def test_scrambled_dimension_order_rejected(tmp_path):
    """[lat, lon, time] layout must raise, not slice a spatial axis."""
    p = str(tmp_path / 'y_sst_scrambled.nc')
    nlat, nlon, nt = 8, 12, 3
    data = np.zeros((nlat, nlon, nt), np.float32)
    _write_monthly(p, data=data, dims=('lat', 'lon', 'time'))
    with pytest.raises(ValueError, match='time axis must lead'):
        _var([p]).load_range(T0, T1)


def test_time_length_mismatch_rejected(tmp_path, monkeypatch):
    """Leading axis named 'time' but shorter than the time coordinate =
    corrupt/mislabeled.  A well-formed writer can't produce this shape, so
    the doctored dataset is injected at the reader seam."""
    p = str(tmp_path / 'z_sst_short.nc')
    _write_monthly(p)
    real_read = netcdf.read

    def doctored_read(path):
        ds = real_read(path)
        v = ds['sst']
        ds.variables['sst'] = netcdf.Variable(
            dims=v.dims, data=np.asarray(v.data)[:2], attrs=v.attrs)
        return ds

    monkeypatch.setattr(tcin.netcdf, 'read', doctored_read)
    with pytest.raises(ValueError, match='does not match the time axis'):
        _var([p]).load_range(T0, T1)


def test_all_fill_variable_rejected(tmp_path):
    p = str(tmp_path / 'w_sst_fill.nc')
    data = np.full((3, 8, 12), np.nan, np.float32)
    _write_monthly(p, data=data)
    with pytest.raises(ValueError, match='entirely fill/NaN'):
        _var([p]).load_range(T0, T1)


def test_zero_length_time_axis(tmp_path):
    """A file whose selection is empty is skipped; an all-empty set raises
    the named no-data error."""
    p = str(tmp_path / 'v_sst_empty.nc')
    _write_monthly(p, months=(), data=np.zeros((0, 8, 12), np.float32),
                   time_vals=())
    with pytest.raises(ValueError, match='no data within'):
        _var([p]).load_range(T0, T1)

    # an empty file alongside a good one: good data still loads
    p2 = str(tmp_path / 'v_sst_good.nc')
    _write_monthly(p2)
    t, d, _ = _var([p, p2]).load_range(T0, T1)
    assert t.size == 3 and d.shape[0] == 3


def test_mixed_level_units_across_files_rejected(tmp_path):
    """File A in hPa, file B in Pa: the level coordinate values differ, so
    concatenating them would build a silently inconsistent stack."""
    lvl_h = np.array([1000.0, 850.0, 500.0])
    lvl_p = lvl_h * 100.0
    a = _write_monthly(str(tmp_path / 'a_ta_1.nc'), key='ta',
                       months=(0, 1), lvl=lvl_h, lvl_units='hPa',
                       data=np.zeros((2, 3, 8, 12), np.float32))
    b = _write_monthly(str(tmp_path / 'b_ta_2.nc'), key='ta',
                       months=(2, 3), lvl=lvl_p, lvl_units='Pa',
                       data=np.zeros((2, 3, 8, 12), np.float32))
    with pytest.raises(ValueError, match="coordinate 'lvl' differs"):
        _var([a, b], key='ta').load_range(T0, T1)


def test_mixed_level_order_across_files_rejected(tmp_path):
    lvl = np.array([1000.0, 850.0, 500.0])
    a = _write_monthly(str(tmp_path / 'a_ta_1.nc'), key='ta',
                       months=(0, 1), lvl=lvl,
                       data=np.zeros((2, 3, 8, 12), np.float32))
    b = _write_monthly(str(tmp_path / 'b_ta_2.nc'), key='ta',
                       months=(2, 3), lvl=lvl[::-1],
                       data=np.zeros((2, 3, 8, 12), np.float32))
    with pytest.raises(ValueError, match="coordinate 'lvl' differs"):
        _var([a, b], key='ta').load_range(T0, T1)


def test_mixed_lon_conventions_across_files_rejected(tmp_path):
    lon_0360 = np.arange(0.0, 360.0, 30.0)
    lon_pm180 = np.arange(-180.0, 180.0, 30.0)
    a = _write_monthly(str(tmp_path / 'a_sst_1.nc'), months=(0, 1),
                       lon=lon_0360,
                       data=np.zeros((2, 8, 12), np.float32))
    b = _write_monthly(str(tmp_path / 'b_sst_2.nc'), months=(2, 3),
                       lon=lon_pm180,
                       data=np.zeros((2, 8, 12), np.float32))
    with pytest.raises(ValueError, match="coordinate 'lon' differs"):
        _var([a, b]).load_range(T0, T1)


def test_consistent_multifile_set_loads(tmp_path):
    """Control: a clean two-file set passes every guard and concatenates."""
    a = _write_monthly(str(tmp_path / 'a_sst_1.nc'), months=(0, 1),
                       data=np.ones((2, 8, 12), np.float32))
    b = _write_monthly(str(tmp_path / 'b_sst_2.nc'), months=(2, 3),
                       data=2 * np.ones((2, 8, 12), np.float32))
    t, d, last = _var([a, b]).load_range(T0, T1)
    assert d.shape == (4, 8, 12)
    assert d[0, 0, 0] == 1.0 and d[-1, 0, 0] == 2.0
    assert np.all(np.diff(t.astype('datetime64[D]').astype(int)) > 0)
