"""Round-trip and reference-data tests for the minimal NetCDF layer."""

import os

import numpy as np
import pytest

from tropical_cyclone_risk_tpu.io import netcdf

REF_DATA = '/root/reference/intensity/data'


def test_roundtrip_classic(tmp_path):
    fn = str(tmp_path / 'out.nc')
    rng = np.random.default_rng(0)
    tracks = rng.normal(size=(4, 10)).astype(np.float32)
    months = np.array([1, 5, 9, 12], dtype=np.float64)
    basins_arr = np.array(['NA', 'EP', 'WP', 'SI'], dtype='U2')
    netcdf.write(
        fn,
        data_vars={'lon_trks': (('n_trk', 'time'), tracks),
                   'tc_month': (('n_trk',), months),
                   'tc_basins': (('n_trk',), basins_arr)},
        coords={'time': np.arange(10, dtype=np.float64),
                'n_trk': np.arange(4)},
        attrs={'title': 'test'},
        var_attrs={'time': {'units': 'seconds'}})
    ds = netcdf.read(fn)
    np.testing.assert_allclose(ds['lon_trks'].data, tracks)
    np.testing.assert_allclose(ds['tc_month'].data, months)
    assert ds['lon_trks'].dims == ('n_trk', 'time')
    got_basins = ds['tc_basins'].data
    # char matrix decodes back to the basin strings
    joined = [b''.join(row).decode() for row in got_basins]
    assert joined == ['NA', 'EP', 'WP', 'SI']
    assert ds.attrs['title'] == 'test'
    assert ds['time'].attrs['units'] == 'seconds'


@pytest.mark.skipif(not os.path.exists(f'{REF_DATA}/land.nc'),
                    reason='reference data not mounted')
def test_read_reference_hdf5_land():
    ds = netcdf.read(f'{REF_DATA}/land.nc')
    land = ds['land']
    assert land.data.shape == (1440, 2880)
    assert land.dims == ('lat', 'lon')
    assert ds['lon'].data[0] == 0.0
    assert set(np.unique(land.data)) <= {0, 1}


@pytest.mark.skipif(not os.path.exists(f'{REF_DATA}/mld_climatology.nc'),
                    reason='reference data not mounted')
def test_read_reference_hdf5_mld():
    ds = netcdf.read(f'{REF_DATA}/mld_climatology.nc')
    assert ds['mixed_layer'].data.shape == (180, 361, 12)
    assert ds['mixed_layer'].dims == ('lat', 'lon', 'month')


def test_packed_int_fill_value_decoding(tmp_path):
    """ERA5 CDS files pack variables as int16 with scale/offset and a fill
    sentinel; fill cells must decode to NaN, not a plausible value."""
    from scipy.io import netcdf_file
    fn = str(tmp_path / 'packed.nc')
    raw = np.array([[0, 100, -32767]], np.int16)     # last cell = fill
    with netcdf_file(fn, 'w') as f:
        f.createDimension('y', 1)
        f.createDimension('x', 3)
        v = f.createVariable('sst', np.int16, ('y', 'x'))
        v[:] = raw
        v._FillValue = np.int16(-32767)
        v.scale_factor = 0.01
        v.add_offset = 300.0
    ds = netcdf.read(fn)
    got = ds['sst'].data
    np.testing.assert_allclose(got[0, :2], [300.0, 301.0])
    assert np.isnan(got[0, 2])


def test_missing_value_decoding(tmp_path):
    from scipy.io import netcdf_file
    fn = str(tmp_path / 'mv.nc')
    with netcdf_file(fn, 'w') as f:
        f.createDimension('x', 2)
        v = f.createVariable('t', np.float32, ('x',))
        v[:] = np.array([280.0, -9999.0], np.float32)
        v.missing_value = np.float32(-9999.0)
    ds = netcdf.read(fn)
    assert np.isnan(ds['t'].data[1]) and ds['t'].data[0] == 280.0


def test_write_int64_overflow_falls_back_to_float64(tmp_path):
    """Classic NetCDF3 has no int64: values beyond int32 must round-trip
    via float64, not wrap silently."""
    fn = str(tmp_path / 'big.nc')
    big = np.array([2**40, -2**35, 7], np.int64)
    netcdf.write(fn, {'x': (('n',), big)}, coords={'n': np.arange(3.0)})
    back = np.asarray(netcdf.read(fn)['x'].data)
    np.testing.assert_array_equal(back.astype(np.int64), big)
    small = np.array([1, 2, 3], np.int64)
    netcdf.write(fn, {'x': (('n',), small)}, coords={'n': np.arange(3.0)})
    assert np.asarray(netcdf.read(fn)['x'].data).dtype.kind == 'i'


def test_write_leaves_no_tmp_files(tmp_path):
    fn = str(tmp_path / 'out.nc')
    netcdf.write(fn, {'x': (('n',), np.arange(4.0))},
                 coords={'n': np.arange(4.0)})
    leftovers = [p for p in os.listdir(tmp_path) if '.tmp' in p]
    assert leftovers == []
    assert os.path.exists(fn)


def test_classic_4gib_preflight():
    """The classic-NetCDF 4 GiB fixed-variable
    ceiling is pre-flighted — one oversized variable is reordered last
    (format-legal), two or more raise an actionable error naming the
    ensemble-sharding mitigation before any bytes are staged."""
    from tropical_cyclone_risk_tpu.io.netcdf import _preflight_limit

    gib4 = 1 << 32
    small = {'a': 1024, 'b': 2048, 'c': 4096}
    assert _preflight_limit(dict(small)) == ['a', 'b', 'c']

    one_big = {'a': 1024, 'big': gib4 + 4096, 'c': 4096}
    assert _preflight_limit(dict(one_big)) == ['a', 'c', 'big']

    with pytest.raises(ValueError, match='ensemble members'):
        _preflight_limit({'x': gib4 + 8, 'y': gib4 + 8, 'z': 4})


def _make_feature_rich_classic(fn, version):
    """Every classic-format feature the stream parser handles: record dim
    with multiple record variables, packed int16 + fill, missing_value,
    char matrix, scalar-free mixed fixed vars, global + var attrs."""
    from scipy.io import netcdf_file
    rng = np.random.default_rng(7)
    with netcdf_file(fn, 'w', version=version) as f:
        f.history = 'made by test'
        f.level = np.int32(600)
        f.createDimension('time', None)          # record dimension
        f.createDimension('lat', 5)
        f.createDimension('lon', 7)
        f.createDimension('s2', 2)
        t = f.createVariable('time', np.float64, ('time',))
        u = f.createVariable('u', np.int16, ('time', 'lat', 'lon'))
        u.scale_factor = 0.01
        u.add_offset = 5.0
        u._FillValue = np.int16(-32767)
        w = f.createVariable('w', np.float32, ('time', 'lat', 'lon'))
        w.missing_value = np.float32(-9e9)
        lat = f.createVariable('lat', np.float32, ('lat',))
        lat[:] = np.linspace(-10, 10, 5)
        lat.units = 'degrees_north'
        names = f.createVariable('names', 'S1', ('lat', 's2'))
        names[:] = np.array([list('NA'), list('EP'), list('WP'),
                             list('SI'), list('GL')], 'S1')
        ib = f.createVariable('ib', np.int8, ('lon',))
        ib[:] = np.arange(7, dtype=np.int8)
        for r in range(3):
            t[r] = 100.0 + r
            ur = rng.integers(-1000, 1000, (5, 7)).astype(np.int16)
            ur[0, r] = -32767
            u[r] = ur
            wr = rng.normal(size=(5, 7)).astype(np.float32)
            wr[1, r] = -9e9
            w[r] = wr


@pytest.mark.parametrize('version', [1, 2])
def test_stream_parser_matches_scipy(tmp_path, version):
    """The streaming classic parser (bounded-RSS path) decodes every
    variable, dim tuple, and attribute identically to the scipy fallback,
    for both CDF-1 and CDF-2 and including record variables."""
    from tropical_cyclone_risk_tpu.io.netcdf import (_read_classic_scipy,
                                                     _read_classic_stream)
    fn = str(tmp_path / f'rich_v{version}.nc')
    _make_feature_rich_classic(fn, version)
    a = _read_classic_stream(fn)
    b = _read_classic_scipy(fn)
    assert set(a.keys()) == set(b.keys())
    assert a.attrs.keys() == b.attrs.keys()
    for k in a.attrs:
        np.testing.assert_array_equal(np.asarray(a.attrs[k]),
                                      np.asarray(b.attrs[k]))
    for name in a.keys():
        va, vb = a[name], b[name]
        assert va.dims == vb.dims, name
        assert va.data.shape == vb.data.shape, name
        if va.data.dtype.kind == 'S':
            np.testing.assert_array_equal(va.data, vb.data)
        else:
            assert va.data.dtype == vb.data.dtype.newbyteorder('='), name
            np.testing.assert_array_equal(va.data, vb.data, err_msg=name)
        assert set(va.attrs) == set(vb.attrs), name
        for ak in va.attrs:
            np.testing.assert_array_equal(np.asarray(va.attrs[ak]),
                                          np.asarray(vb.attrs[ak]))


def test_stream_parser_truncated_record_data(tmp_path):
    from tropical_cyclone_risk_tpu.io.netcdf import _read_classic_stream
    fn = str(tmp_path / 'rich.nc')
    _make_feature_rich_classic(fn, 2)
    raw = open(fn, 'rb').read()
    open(fn, 'wb').write(raw[:len(raw) - 40])
    with pytest.raises(ValueError, match='rich.nc'):
        _read_classic_stream(fn)


def test_classic_reader_rss_bounded(tmp_path):
    """Reading a large classic variable must not buffer
    the whole file on top of the decoded array.  Measured in a subprocess:
    peak RSS growth over the post-import baseline stays under 1.35x the
    decoded data (the old slurp path peaked at >= 2x: whole-file copy +
    scipy's materialized data)."""
    import json
    import subprocess
    import sys

    nbytes = 192 * (1 << 20)             # 192 MiB variable
    n = nbytes // 4
    fn = str(tmp_path / 'big.nc')
    netcdf.write(fn, {'v': (('n',), np.zeros(n, np.float32))},
                 coords={})
    code = f"""
import json, resource
import numpy as np
from tropical_cyclone_risk_tpu.io import netcdf
base = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
ds = netcdf.read({fn!r})
data = ds['v'].data
assert data.dtype == np.float32 and data.nbytes == {nbytes}
peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
print(json.dumps({{'base_kib': int(base), 'peak_kib': int(peak)}}))
"""
    out = subprocess.run([sys.executable, '-c', code], capture_output=True,
                         text=True, check=True, cwd='/root/repo')
    r = json.loads(out.stdout.strip().splitlines()[-1])
    growth = (r['peak_kib'] - r['base_kib']) * 1024
    # decoded array + 4 MB chunk buffer + interpreter slack
    assert growth < 1.35 * nbytes + (32 << 20), (
        f'classic reader peak RSS grew {growth / 2**20:.0f} MiB for a '
        f'{nbytes / 2**20:.0f} MiB variable (base {r["base_kib"]} KiB, '
        f'peak {r["peak_kib"]} KiB)')
