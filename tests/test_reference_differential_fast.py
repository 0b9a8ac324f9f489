"""Differential tests of the coupled FAST intensity core against the ACTUAL
reference source (/root/reference/intensity/coupled_fast.py), executed
in-process.

The round-3 differential suite (test_reference_differential.py) covers the
elementwise thermodynamics, CAPE-PI, geometry, interpolation, and the
Fourier spectrum — but not the intensity ODE right-hand side itself, whose
parity was previously established only through the builder-re-derived chain
oracle (tests/reference_chain.py).  This module closes that gap: it imports
the reference's Coupled_FAST class and compares, pointwise on randomized
synthetic fields and states,

  - the intensity-dependent steering weights (coupled_fast.py:183-194)
  - the ocean feedback parameter alpha       (coupled_fast.py:65-95)
  - the FULL per-step state derivative dydt  (coupled_fast.py:196-207):
    spline wind statistics -> Cholesky coloring -> beta-advection velocity
    -> dvdt/dmdt with ventilation and ocean coupling
  - the dvdt-inversion m initialization      (coupled_fast.py:153-167)

against models/fast.py's batched JAX equivalents evaluated through the real
gather/stack machinery (models/fields.build_stacks + ops/interp).

The reference class transitively imports xarray/dask/cftime (absent from
this image) at module top level only; none of the methods under test touch
them, so the fixture injects empty stub modules for the import and builds
the Coupled_FAST instance via object.__new__ with synthetic
RectBivariateSpline fields, bypassing the file-loading __init__
(coupled_fast.py:19-32) the same way util/compute.py:175 bypasses the
namelist h_bl dict.
"""

from __future__ import annotations

import datetime
import os
import sys
import types

import numpy as np
import pytest
from scipy.interpolate import RectBivariateSpline

import jax.numpy as jnp

from tropical_cyclone_risk_tpu.config import load_namelist_py
from tropical_cyclone_risk_tpu.models import fast as my_fast
from tropical_cyclone_risk_tpu.models import fields as F
from tropical_cyclone_risk_tpu.ops.interp import UniformGrid

REF = '/root/reference'

# loading the real namelist warns about its f_mInit lambda (documented
# API difference, config.py load_namelist_py) — expected here
pytestmark = pytest.mark.filterwarnings(
    'ignore:namelist defines f_mInit')

NLON, NLAT = 180, 81          # 2-degree grid, lat -80..80
LON0, DLON = 0.0, 2.0
LAT0, DLAT = -80.0, 2.0
W = 4                         # 2 steering levels x (u, v)
NTRI = W * (W + 1) // 2


# ---------------------------------------------------------------------------
# synthetic fields shared by both sides


def _fields(rng):
    """Smooth synthetic environment on the test grid, float64 [lat, lon]."""
    lon = LON0 + DLON * np.arange(NLON)
    lat = LAT0 + DLAT * np.arange(NLAT)
    LA, LO = np.meshgrid(lat, lon, indexing='ij')
    f = {}
    # steering-wind means, a few m/s with large-scale structure
    ph = rng.uniform(0, 2 * np.pi, 8)
    f['mean'] = np.stack([
        a * np.sin(np.deg2rad(LO) * k + p) * np.cos(np.deg2rad(LA) * 2 + q)
        + c
        for a, k, p, q, c in [(4.0, 2, ph[0], ph[1], -2.0),
                              (3.0, 3, ph[2], ph[3], 1.0),
                              (5.0, 1, ph[4], ph[5], 3.5),
                              (2.5, 2, ph[6], ph[7], -1.0)]], axis=-1)
    # pointwise-SPD covariance: A A^T + 0.5 I with smooth A entries.
    # Bilinear interpolation is a convex combination, so interpolated
    # matrices stay SPD and both sides take the plain-Cholesky path.
    A = np.stack([np.sin(np.deg2rad(LO) * (1 + i % 3) + i)
                  * np.cos(np.deg2rad(LA) + 2 * i) + 0.3 * i
                  for i in range(W * W)], axis=-1).reshape(NLAT, NLON, W, W)
    cov = np.einsum('...ik,...jk->...ij', A, A) + 0.5 * np.eye(W)
    tri = np.stack([cov[..., i, j]
                    for i in range(W) for j in range(i + 1)], axis=-1)
    f['tri'] = tri
    f['cov'] = cov
    # environment: chi, vpot, mld, strat
    f['chi'] = 0.6 + 0.5 * np.cos(np.deg2rad(LO) * 2) ** 2 \
        + 0.4 * np.sin(np.deg2rad(LA) * 3) ** 2
    f['vpot'] = 60.0 + 25.0 * np.cos(np.deg2rad(LA)) \
        + 8.0 * np.sin(np.deg2rad(LO) * 3)
    f['mld'] = 40.0 + 25.0 * np.sin(np.deg2rad(LO) + 1.0) ** 2 \
        + 10.0 * np.cos(np.deg2rad(LA) * 2)
    # stratification, K/100m; an exactly-zero band exercises the
    # t_strat == 0 mixing cutoff (coupled_fast.py:74)
    strat = 0.8 + 0.6 * np.cos(np.deg2rad(LO) * 2 + 0.7)
    strat[:, 100:110] = 0.0
    f['strat'] = strat
    # a rectangular continent with positive topography; ocean depths include
    # a shallow shelf so the -h_m <= bathymetry cutoff also triggers
    land = np.zeros((NLAT, NLON))
    land[30:50, 40:70] = 1.0
    f['land'] = land
    bathy = -3000.0 + 1500.0 * np.sin(np.deg2rad(LO) * 4) \
        - 800.0 * np.cos(np.deg2rad(LA) * 3)
    bathy[:, 140:150] = -20.0                      # shelf shallower than mld
    bathy[30:50, 40:70] = 150.0                    # land topography
    f['bathy'] = bathy
    f['lon'], f['lat'] = lon, lat
    return f


def _spl(f, lon, lat):
    return RectBivariateSpline(lon, lat, np.asarray(f).T, kx=1, ky=1)


@pytest.fixture(scope='module')
def ref_fast():
    """The reference Coupled_FAST over synthetic spline fields, plus the
    equivalent FieldPack/GatherStacks for models/fast.py."""
    if not os.path.isdir(REF):
        pytest.skip(f'reference source tree {REF} is not present')
    # stub the unavailable heavy deps (top-level imports only; the methods
    # under test never call into them)
    stubs = {}
    for name in ('xarray', 'dask', 'cftime'):
        if name not in sys.modules:
            sys.modules[name] = types.ModuleType(name)
            stubs[name] = True
    sys.path.insert(0, REF)
    try:
        import namelist as ref_namelist                      # noqa: F401
        from intensity import coupled_fast as ref_cf
        from track import env_wind as ref_env_wind
    finally:
        sys.path.remove(REF)
        for name in stubs:
            del sys.modules[name]

    rng = np.random.default_rng(20260817)
    f = _fields(rng)
    lon, lat = f['lon'], f['lat']

    cf = object.__new__(ref_cf.Coupled_FAST)
    # FAST constants exactly as __init__ + compute.py:175 set them
    cf.Ck = ref_namelist.Ck
    cf.h_bl = ref_namelist.atm_bl_depth['NA']
    cf.epsilon = 0.33
    cf.kappa = 0.1
    cf.beta = 1 - cf.epsilon - cf.kappa
    cf.debug = False
    # spline fields exactly as init_fields builds them (coupled_fast.py:217)
    cf.f_land = _spl(f['land'], lon, lat)
    cf.f_bath = _spl(f['bathy'], lon, lat)
    cf.f_mld = _spl(f['mld'], lon, lat)
    cf.f_strat = _spl(f['strat'], lon, lat)
    cf.f_vpot = _spl(f['vpot'], lon, lat)
    cf.f_chi = _spl(f['chi'], lon, lat)
    # BetaAdvectionTrack attributes (bam_track.py:50-71) for _step_bam_track
    cf.u_beta = ref_namelist.u_beta
    cf.v_beta = ref_namelist.v_beta
    cf.nLvl = len(ref_namelist.steering_levels)
    cf.nWLvl = 2 * cf.nLvl
    cf.var_names = ref_env_wind.wind_mean_vector_names()
    cf.u_Mean_idxs = np.array(
        [cf.var_names.index('ua%s_Mean' % p)
         for p in ref_namelist.steering_levels])
    cf.v_Mean_idxs = np.array(
        [cf.var_names.index('va%s_Mean' % p)
         for p in ref_namelist.steering_levels])
    cf.datetime_start = datetime.datetime(2016, 9, 1)
    cf.wnd_Mean_Fxs = [_spl(f['mean'][..., i], lon, lat) for i in range(W)]
    cf.wnd_Cov_Fxs = [['' for _ in range(W)] for _ in range(W)]
    for i in range(W):
        for j in range(i + 1):
            cf.wnd_Cov_Fxs[i][j] = _spl(f['cov'][..., i, j], lon, lat)
    # fixed Fourier forcing vector: the series itself is differential-tested
    # separately (test_reference_differential.test_fourier_vs_gen_f_exact)
    fs_vec = rng.uniform(-1.5, 1.5, W)
    cf.Fs_i = lambda ts: fs_vec

    # --- our side: the same fields as a FieldPack -------------------------
    grid = UniformGrid(LON0, DLON, NLON, LAT0, DLAT, NLAT)
    wind = np.concatenate([f['mean'], f['tri']], axis=-1)[None]
    env = np.stack([f['chi'], f['vpot'], f['mld'], f['strat'],
                    np.full_like(f['chi'], 0.5)], axis=-1)[None]
    ones = np.ones((NLAT, NLON))
    pack = F.FieldPack(
        grid=grid, wind=jnp.asarray(wind, jnp.float32),
        env=jnp.asarray(env, jnp.float32),
        land_grid=grid, land=jnp.asarray(f['land'], jnp.float32),
        bathy_grid=grid, bathy=jnp.asarray(f['bathy'], jnp.float32),
        mask_grid=grid, basin_masks=jnp.asarray(ones[..., None],
                                                jnp.float32),
        run_mask=jnp.asarray(ones, jnp.float32))
    cfg = load_namelist_py(REF + '/namelist.py')

    # interior random test points, away from the poleward hard stop
    K = 192
    pts_lon = rng.uniform(5.0, 352.0, K)
    pts_lat = rng.uniform(-70.0, 70.0, K)
    # make sure land / shelf / zero-strat branches are all exercised
    pts_lon[:12] = rng.uniform(82.0, 136.0, 12)    # over the continent
    pts_lat[:12] = rng.uniform(-18.0, 16.0, 12)
    pts_lon[12:20] = rng.uniform(281.0, 297.0, 8)  # shallow shelf
    pts_lon[20:28] = rng.uniform(201.0, 217.0, 8)  # zero stratification

    return types.SimpleNamespace(cf=cf, namelist=ref_namelist, pack=pack,
                                 cfg=cfg, fs=fs_vec, rng=rng,
                                 lon=pts_lon, lat=pts_lat, K=K)


def _params(ref_fast, n):
    plane = jnp.zeros(n, jnp.int32)
    h_bl = jnp.full(n, ref_fast.cf.h_bl, jnp.float32)
    # encode the shared Fourier sample so evaluate(0) == fs exactly
    # (evaluate(0) sums the cos coefficients): init_m_dvdt0 colors winds
    # internally at t=0, matching the reference's Fs_i(0)
    from tropical_cyclone_risk_tpu.ops.fourier import FourierSeries, \
        N_FOURIER
    A = jnp.zeros((n, W, N_FOURIER), jnp.float32)
    B = A.at[:, :, 0].set(jnp.asarray(ref_fast.fs, jnp.float32))
    fourier = FourierSeries(A, B, jnp.asarray(1.0e6, jnp.float32))
    return my_fast.SeedParams(plane=plane, h_bl=h_bl, fourier=fourier)


# ---------------------------------------------------------------------------


def test_steering_coefs_differential(ref_fast):
    """Intensity-dependent steering weights incl. the NaN fallback
    (coupled_fast.py:183-194)."""
    v = np.array([0.0, 5.0, 15.0, 25.0, 40.0, 60.0, 85.0, np.nan])
    mine = np.asarray(my_fast.steering_coefs(ref_fast.cfg,
                                             jnp.asarray(v, jnp.float32)))
    for i, vi in enumerate(v):
        theirs = ref_fast.cf._calc_steering_coefs(vi)
        np.testing.assert_allclose(mine[i], theirs, rtol=1e-6, atol=1e-7)


def test_steering_coefs_uncoupled_differential(ref_fast, monkeypatch):
    """coupled_track=False falls back to the constant namelist coefficients
    (coupled_fast.py:190-192)."""
    monkeypatch.setattr(ref_fast.namelist, 'coupled_track', False)
    cfg_u = ref_fast.cfg.replace(coupled_track=False)
    v = jnp.asarray([10.0, 50.0], jnp.float32)
    mine = np.asarray(my_fast.steering_coefs(cfg_u, v))
    theirs = ref_fast.cf._calc_steering_coefs(10.0)
    np.testing.assert_allclose(mine[0], theirs, rtol=1e-6)
    np.testing.assert_allclose(mine[1], theirs, rtol=1e-6)


def test_ocean_alpha_differential(ref_fast):
    """alpha over deep ocean, shelf, zero stratification, and land
    (coupled_fast.py:65-95)."""
    rng, K = ref_fast.rng, ref_fast.K
    v = rng.uniform(8.0, 75.0, K)
    v_trans = rng.uniform(-8.0, 8.0, (K, 2))

    theirs = np.array([
        ref_fast.cf._calc_alpha(ref_fast.lon[i], ref_fast.lat[i],
                                v_trans[i], v[i])
        for i in range(K)])

    stacks = F.build_stacks(ref_fast.pack)
    smp = my_fast.sample_fields(stacks, jnp.asarray(ref_fast.lon,
                                                    jnp.float32),
                                jnp.asarray(ref_fast.lat, jnp.float32),
                                jnp.zeros(K, jnp.int32))
    u_T = jnp.asarray(np.linalg.norm(v_trans, axis=1), jnp.float32)
    mine, _ = my_fast.ocean_alpha(ref_fast.cfg, smp.env, smp.land,
                                  smp.bathy, u_T,
                                  jnp.asarray(v, jnp.float32))
    # where the reference takes the no-mixing branch (exact 1), ours must
    # too; the converse can't be asserted exactly — a mixing-branch alpha
    # within float32 ulp of 1 (large z) legitimately rounds to 1.0
    mine = np.asarray(mine)
    assert (mine[theirs == 1.0] == 1.0).all()
    assert (mine[theirs < 1.0 - 1e-5] < 1.0).all()
    np.testing.assert_allclose(mine, theirs, rtol=2e-4, atol=2e-4)
    assert (theirs == 1.0).any() and (theirs < 1.0 - 1e-3).any()


def test_dydt_differential(ref_fast):
    """The full per-step state derivative (coupled_fast.py:196-207): wind
    statistics interpolation, Cholesky coloring with a shared Fourier
    sample, intensity-dependent steering, ocean-coupled dvdt, ventilated
    dmdt."""
    rng, K = ref_fast.rng, ref_fast.K
    v = rng.uniform(8.0, 70.0, K)
    m = rng.uniform(0.15, 0.95, K)
    t = 7200.0

    theirs = np.array([
        ref_fast.cf.dydt(t, np.array([ref_fast.lon[i], ref_fast.lat[i],
                                      v[i], m[i]]))
        for i in range(K)])

    stacks = F.build_stacks(ref_fast.pack)
    y = my_fast.State(jnp.asarray(ref_fast.lon, jnp.float32),
                      jnp.asarray(ref_fast.lat, jnp.float32),
                      jnp.asarray(v, jnp.float32),
                      jnp.asarray(m, jnp.float32))
    smp = my_fast.sample_fields(stacks, y.lon, y.lat, jnp.zeros(K,
                                                                jnp.int32))
    fvec = jnp.broadcast_to(jnp.asarray(ref_fast.fs, jnp.float32), (K, W))
    wnds = my_fast.color_winds_given_f(ref_fast.cfg, smp.wind_stats, fvec)
    (dlon, dlat, dvdt, dmdt), _ = my_fast.rhs_given_winds(
        ref_fast.cfg, t, y, _params(ref_fast, K), smp, wnds)

    np.testing.assert_allclose(np.asarray(dlon), theirs[:, 0], rtol=2e-4,
                               atol=2e-9)
    np.testing.assert_allclose(np.asarray(dlat), theirs[:, 1], rtol=2e-4,
                               atol=2e-9)
    np.testing.assert_allclose(np.asarray(dvdt), theirs[:, 2], rtol=2e-3,
                               atol=2e-6)
    np.testing.assert_allclose(np.asarray(dmdt), theirs[:, 3], rtol=2e-3,
                               atol=2e-7)


def test_dydt_debug_mode_differential(ref_fast):
    """debug mode freezes the position (coupled_fast.py:204-205 /
    Namelist.debug_fixed_position): intensity derivatives must be identical
    to the moving case, position derivatives zero."""
    cf = ref_fast.cf
    y = np.array([200.0, 20.0, 30.0, 0.6])
    cf.debug = True
    try:
        theirs = cf.dydt(3600.0, y)
    finally:
        cf.debug = False
    assert theirs[0] == 0.0 and theirs[1] == 0.0

    stacks = F.build_stacks(ref_fast.pack)
    cfg_dbg = ref_fast.cfg.replace(debug_fixed_position=True)
    ys = my_fast.State(jnp.asarray([y[0]], jnp.float32),
                       jnp.asarray([y[1]], jnp.float32),
                       jnp.asarray([y[2]], jnp.float32),
                       jnp.asarray([y[3]], jnp.float32))
    smp = my_fast.sample_fields(stacks, ys.lon, ys.lat,
                                jnp.zeros(1, jnp.int32))
    fvec = jnp.asarray(ref_fast.fs, jnp.float32)[None]
    wnds = my_fast.color_winds_given_f(ref_fast.cfg, smp.wind_stats, fvec)
    (dlon, dlat, dvdt, dmdt), _ = my_fast.rhs_given_winds(
        cfg_dbg, 3600.0, ys, _params(ref_fast, 1), smp, wnds)
    assert float(dlon[0]) == 0.0 and float(dlat[0]) == 0.0
    np.testing.assert_allclose(float(dvdt[0]), theirs[2], rtol=2e-3,
                               atol=2e-6)
    np.testing.assert_allclose(float(dmdt[0]), theirs[3], rtol=2e-3,
                               atol=2e-7)


def test_init_m_differential(ref_fast):
    """m initialization by dvdt inversion (coupled_fast.py:153-167): BAM
    translation speed at t=0, 5-point vpot max, ocean alpha, clipped
    cube root."""
    rng = ref_fast.rng
    K = 64
    lon = ref_fast.lon[:K]
    lat = ref_fast.lat[:K]
    v = rng.uniform(8.0, 40.0, K)

    theirs = np.array([
        ref_fast.cf._init_m(np.array([lon[i], lat[i], v[i], np.nan]), 0.0)
        for i in range(K)])

    mine = np.asarray(my_fast.init_m_dvdt0(
        ref_fast.pack, ref_fast.cfg,
        jnp.asarray(lon, jnp.float32), jnp.asarray(lat, jnp.float32),
        jnp.asarray(v, jnp.float32), _params(ref_fast, K), dvdt=0.0))
    np.testing.assert_allclose(mine, theirs, rtol=5e-4, atol=5e-4)
    assert (theirs > 0.0).all() and (theirs < 1.0).any()
