"""Differential tests against the ACTUAL reference source at /root/reference.

The existing parity oracles (tests/golden_pi.py, tests/reference_chain.py)
are builder-written re-derivations of the reference math; a shared
misreading would pass those tests.  This module closes that hole by
importing the reference's own numpy/scipy modules (verified importable in
this image) and comparing our kernels' outputs against theirs on randomized
inputs:

  * ops/thermo elementwise kernels   vs thermo/thermo.py:19-134
  * invert_entropy_newton            vs the BFGS minimize path (:214-221 idiom)
  * ops/pi.cape_pi (table mode)      vs CAPE_PI_vectorized (:266-412),
                                        fed the reference's OWN bundled
                                        entropy_table.npz
  * ops/pi.cape_pi                   vs scalar CAPE_PI (:144-256) within the
                                        scalar impl's known envelope (it
                                        omits the LNB sub-grid correction)
  * ops/pi.cape_pi (reversible)      vs scalar CAPE_PI select_thermo=2 via
                                        the select_interp=1 minimize path
                                        (entropy_table_reversible.npz is
                                        absent from the snapshot)
  * models/diagnostics.axi_to_max_wind vs wind/tc_wind.py:6-21
  * ops/sphere.translational_speed   vs util/sphere.py:58-83
  * ops/interp.bilinear              vs util/mat.py:142-173 splines
                                        (interior, edge, and out-of-domain
                                        clamping semantics)
  * ops/fourier synthesis            vs track/bam_track.py:23-31 gen_f
                                        (exact, same phases)
  * constants module                  vs util/constants.py attribute-by-
                                        attribute

Error budget: our kernels run in float32 (x64 off).  Entropies are
~2.4-3.6e3 J/kg/K, so f32 rounding is ~2e-4 J/kg/K; through the ds/dT ~ 10
J/kg/K^2 inversion slope that is ~2e-5 K of adiabat temperature, ~0.05 J/kg
of CAPE, and <0.01 m/s of PI.  PI tolerances below (0.02 m/s p99 / 0.5 max)
therefore sit two orders above float noise while being far below the
multiple-m/s signature of any semantic misreading.  The max-tolerance
headroom covers LNB/Icond tie flips, which move a single column by one
pressure level when buoyancy crosses zero within float noise of a grid
level.
"""

from __future__ import annotations

import ast
import importlib.util
import os
import sys
import types

import numpy as np
import pytest

import jax.numpy as jnp

from tropical_cyclone_risk_tpu import constants as my_constants
from tropical_cyclone_risk_tpu.models import diagnostics
from tropical_cyclone_risk_tpu.ops import fourier as my_fourier
from tropical_cyclone_risk_tpu.ops import interp as my_interp
from tropical_cyclone_risk_tpu.ops import pi as my_pi
from tropical_cyclone_risk_tpu.ops import sphere as my_sphere
from tropical_cyclone_risk_tpu.ops import thermo as my_thermo

REF = '/root/reference'


@pytest.fixture(scope='module')
def ref():
    """Import the reference modules from /root/reference.

    sys.path is restored immediately after import; the reference modules
    stay cached in sys.modules under their own top-level names (namelist,
    thermo, util), which nothing else in this repo imports.
    """
    if not os.path.isdir(REF):
        pytest.skip(f'reference source tree {REF} is not present')
    sys.path.insert(0, REF)
    try:
        import namelist as ref_namelist                      # noqa: F401
        from thermo import thermo as ref_thermo
        from util import constants as ref_constants
        from util import mat as ref_mat
        from util import sphere as ref_sphere
        # wind/ has no __init__.py in the reference (SURVEY C18) — load the
        # module straight from its file.
        spec = importlib.util.spec_from_file_location(
            'ref_tc_wind', REF + '/wind/tc_wind.py')
        tc_wind = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(tc_wind)
        # gen_f's module (track/bam_track.py) imports xarray, absent from
        # this image — extract the function def via AST and exec it, so the
        # code under test is still byte-for-byte the reference's.
        src = open(REF + '/track/bam_track.py').read()
        tree = ast.parse(src)
        fndef = next(n for n in tree.body
                     if isinstance(n, ast.FunctionDef) and n.name == 'gen_f')
        mod = ast.Module(body=[fndef], type_ignores=[])
        ns = {'np': np}
        exec(compile(mod, 'bam_track.py::gen_f', 'exec'), ns)
    finally:
        sys.path.remove(REF)
    # GENUINE REFERENCE BUG (found by this differential suite, documented in
    # PARITY.md): scalar CAPE_PI's `CAPE[np.isnan(CAPE)] = 0`
    # (thermo/thermo.py:253) item-assigns into a numpy SCALAR (np.sum of a
    # 1-D slice returns np.float64), which raises TypeError on every numpy
    # version — the transparent scalar path is unrunnable as shipped.  To
    # still differential-test it we exec its source with ONLY that line
    # replaced by the equivalent `CAPE = np.where(np.isnan(CAPE), 0, CAPE)`,
    # sharing the real module's globals so namelist monkeypatches apply.
    import inspect
    src_pi = inspect.getsource(ref_thermo.CAPE_PI)
    patched = src_pi.replace('CAPE[np.isnan(CAPE)] = 0',
                             'CAPE = np.where(np.isnan(CAPE), 0, CAPE)')
    assert patched != src_pi, 'reference CAPE_PI source changed; re-check bug'
    ns_pi: dict = {}
    exec(compile(patched, 'thermo.py::CAPE_PI<scalar-assign-fix>', 'exec'),
         ref_thermo.__dict__, ns_pi)
    return types.SimpleNamespace(
        namelist=ref_namelist, thermo=ref_thermo, mat=ref_mat,
        sphere=ref_sphere, constants=ref_constants,
        tc_wind=tc_wind, gen_f=ns['gen_f'], CAPE_PI_scalar=ns_pi['CAPE_PI'])


# ---------------------------------------------------------------------------
# shared synthetic soundings


def make_soundings(rng, shape=(5, 6), L=24):
    """Realistic tropical sounding grid: hypsometric temperature profile
    with a 195 K tropopause and a slightly warming stratosphere, RH decaying
    with height — chosen so every column condenses and has an interior LNB
    (the regime the production pipeline exercises)."""
    p_env = np.array([100400., 100000., 97500., 95000., 92500., 90000.,
                      85000., 80000., 75000., 70000., 65000., 60000.,
                      55000., 50000., 45000., 40000., 35000., 30000.,
                      25000., 20000., 15000., 10000., 7000., 5000.])[:L]
    T_ns = rng.uniform(296.0, 303.0, shape)
    z = -7500.0 * np.log(p_env / p_env[0])               # [L]
    zc = z[:, None, None]
    T_trop = T_ns[None] - 6.5e-3 * zc
    T_env = np.maximum(T_trop, 195.0 + 1.0e-3 * np.maximum(zc - 16000., 0.))
    T_env += rng.normal(0.0, 0.15, T_env.shape)
    rh_prof = np.clip(0.85 - 0.5 * (1.0 - p_env / p_env[0]), 0.05,
                      1.0)[:, None, None]
    rh_prof = rh_prof * rng.uniform(0.9, 1.05, T_env.shape)
    T_c = T_env - 273.0
    es = 610.94 * np.exp(np.minimum(17.625 * T_c / (T_c + 243.04), 10.0))
    rs = my_constants.eps * es / (p_env[:, None, None] - es)
    r_env = np.clip(rh_prof * rs, 1e-6, 0.03)
    sst = T_ns + rng.uniform(0.5, 2.5, shape)
    p_surf = np.full(shape, 101000.0) + rng.normal(0.0, 300.0, shape)
    return sst, p_surf, p_env, T_env, r_env


def load_ref_table():
    with np.load(REF + '/thermo/entropy_table.npz') as npz:
        return npz['p'].copy(), npz['s'].copy(), npz['T'].copy()


# ---------------------------------------------------------------------------
# elementwise thermodynamics


def test_constants_differential(ref):
    shared = [k for k in vars(ref.constants)
              if not k.startswith('_') and
              isinstance(getattr(ref.constants, k), (int, float))]
    assert len(shared) >= 12
    for k in shared:
        assert hasattr(my_constants, k), f'missing constant {k}'
        assert getattr(my_constants, k) == pytest.approx(
            getattr(ref.constants, k), rel=0, abs=0), k


def test_sat_thermo_differential(ref):
    rng = np.random.default_rng(0)
    T = rng.uniform(200.0, 310.0, (400,))
    p = rng.uniform(5000.0, 105000.0, (400,))
    es_r, rs_r = ref.thermo.sat_thermo(T, p)
    es_m, rs_m = my_thermo.sat_thermo(jnp.asarray(T), jnp.asarray(p))
    np.testing.assert_allclose(np.asarray(es_m), es_r, rtol=2e-5)
    np.testing.assert_allclose(np.asarray(rs_m), rs_r, rtol=2e-5, atol=1e-9)
    es_r, rs_r = ref.thermo.sat_thermo_pog(T, p)
    es_m, rs_m = my_thermo.sat_thermo_pog(jnp.asarray(T), jnp.asarray(p))
    np.testing.assert_allclose(np.asarray(es_m), es_r, rtol=2e-5)
    np.testing.assert_allclose(np.asarray(rs_m), rs_r, rtol=2e-5, atol=1e-9)


@pytest.mark.parametrize('select_thermo', [1, 2])
def test_entropy_differential(ref, select_thermo):
    rng = np.random.default_rng(select_thermo)
    n = 400
    T = rng.uniform(220.0, 305.0, (n,))
    p = rng.uniform(20000.0, 104000.0, (n,))
    _, rs = ref.thermo.sat_thermo(T, p)
    r = np.clip(rs * rng.uniform(0.05, 0.99, (n,)), 1e-6, None)
    r_t = r + rng.uniform(0.0, 0.005, (n,))

    # entropies are ~3e3 J/kg/K with f32 rounding ~2e-4 — atol 5e-3 is 25x
    # float noise and far below any formula discrepancy
    su_r = ref.thermo.s_unsat(T, p, r, r_t, select_thermo)
    su_m = my_thermo.s_unsat(jnp.asarray(T), jnp.asarray(p), jnp.asarray(r),
                             jnp.asarray(r_t), select_thermo)
    np.testing.assert_allclose(np.asarray(su_m), su_r, atol=5e-3, rtol=0)

    ss_r = ref.thermo.s_sat(T, p, r_t, select_thermo)
    ss_m = my_thermo.s_sat(jnp.asarray(T), jnp.asarray(p), jnp.asarray(r_t),
                           select_thermo)
    np.testing.assert_allclose(np.asarray(ss_m), ss_r, atol=5e-3, rtol=0)

    der_r = ref.thermo.s_sat_der(T, p, r_t, select_thermo)
    der_m = my_thermo.s_sat_der(jnp.asarray(T), jnp.asarray(p),
                                jnp.asarray(r_t), select_thermo)
    np.testing.assert_allclose(np.asarray(der_m), der_r, rtol=2e-5)


@pytest.mark.parametrize('select_thermo', [1, 2])
def test_sat_deficit_differential(ref, select_thermo, monkeypatch):
    monkeypatch.setattr(ref.namelist, 'select_thermo', select_thermo)
    rng = np.random.default_rng(7)
    n = 200
    sst = rng.uniform(295.0, 305.0, (n,))
    ps = rng.uniform(99000.0, 103000.0, (n,))
    T = rng.uniform(260.0, 280.0, (n,))
    pm = np.full((n,), 60000.0)
    _, rs_mid = ref.thermo.sat_thermo(T, pm)
    rv = np.clip(rs_mid * rng.uniform(0.2, 0.95, (n,)), 1e-6, None)
    chi_r = ref.thermo.sat_deficit(sst, ps, T, pm, rv)
    chi_m = my_thermo.sat_deficit(jnp.asarray(sst), jnp.asarray(ps),
                                  jnp.asarray(T), jnp.asarray(pm),
                                  jnp.asarray(rv), select_thermo)
    np.testing.assert_allclose(np.asarray(chi_m), chi_r, rtol=5e-4, atol=5e-5)


def test_conv_q_to_rh_differential(ref):
    rng = np.random.default_rng(3)
    T = rng.uniform(260.0, 305.0, (200,))
    p = rng.uniform(50000.0, 103000.0, (200,))
    q = rng.uniform(0.0, 0.025, (200,))
    rh_r = ref.thermo.conv_q_to_rh(T, q, p)
    rh_m = my_thermo.conv_q_to_rh(jnp.asarray(T), jnp.asarray(q),
                                  jnp.asarray(p))
    np.testing.assert_allclose(np.asarray(rh_m), rh_r, rtol=5e-5, atol=1e-6)


def test_lcl_differential(ref):
    """get_LCL incl. our Lambert-W -1 branch vs scipy.special.lambertw."""
    rng = np.random.default_rng(11)
    n = 300
    T = rng.uniform(285.0, 305.0, (n,))
    p = rng.uniform(98000.0, 103000.0, (n,))
    _, rs = ref.thermo.sat_thermo(T, p)
    rh = rng.uniform(0.3, 0.999, (n,))
    r = rh * rs
    p_r = ref.thermo.get_LCL(p, T, r, rh)
    p_m = my_thermo.get_LCL(jnp.asarray(p), jnp.asarray(T), jnp.asarray(r),
                            jnp.asarray(rh))
    np.testing.assert_allclose(np.asarray(p_m), p_r, rtol=2e-5)


def test_calc_T_rho_differential(ref, monkeypatch):
    rng = np.random.default_rng(13)
    T = rng.uniform(200.0, 305.0, (200,))
    rv = rng.uniform(0.0, 0.025, (200,))
    rt = rv + rng.uniform(0.0, 0.005, (200,))
    for st in (1, 2):
        monkeypatch.setattr(ref.namelist, 'select_thermo', st)
        out_r = ref.thermo.calc_T_rho(T, rv, rt)
        out_m = my_thermo.calc_T_rho(jnp.asarray(T), jnp.asarray(rv),
                                     jnp.asarray(rt), st)
        np.testing.assert_allclose(np.asarray(out_m), out_r, rtol=2e-6)


@pytest.mark.parametrize('select_thermo', [1, 2])
def test_entropy_inversion_vs_reference_minimize(ref, select_thermo):
    """invert_entropy_newton vs the reference's BFGS s_diff minimization
    (thermo/thermo.py:214-221, 428-434) — the select_interp=1 production
    idiom, and the only reversible-branch inversion runnable in-image
    (entropy_table_reversible.npz is a missing blob)."""
    from scipy.optimize import minimize
    rng = np.random.default_rng(select_thermo + 20)
    n = 60
    p = rng.uniform(8000.0, 102000.0, (n,))
    r_t = rng.uniform(0.0, 0.03, (n,))
    T_true = rng.uniform(210.0, 300.0, (n,))
    s_ref = ref.thermo.s_sat(T_true, p, r_t, select_thermo)
    T_ref = np.array([
        minimize(ref.thermo.s_diff, 230.0,
                 args=(p[i], r_t[i], select_thermo, s_ref[i]),
                 method='BFGS', jac=ref.thermo.s_diff_der,
                 options={'gtol': 1e-02}).x[0]
        for i in range(n)])
    T_mine = np.asarray(my_thermo.invert_entropy_newton(
        jnp.asarray(p), jnp.asarray(s_ref), jnp.asarray(r_t),
        select_thermo))
    # BFGS itself stops at gtol=1e-2 (~5e-4 J/kg/K residual -> ~5e-5 K);
    # 0.02 K absorbs both solvers' stopping noise
    np.testing.assert_allclose(T_mine, T_ref, atol=2e-2, rtol=0)
    np.testing.assert_allclose(T_mine, T_true, atol=2e-2, rtol=0)


# ---------------------------------------------------------------------------
# CAPE-PI


def test_cape_pi_vs_reference_vectorized_table(ref, monkeypatch):
    """Production path: our cape_pi (fed the reference's OWN bundled
    entropy_table.npz) vs CAPE_PI_vectorized with select_interp=2."""
    monkeypatch.setattr(ref.namelist, 'select_thermo', 1)
    monkeypatch.setattr(ref.namelist, 'select_interp', 2)
    rng = np.random.default_rng(42)
    sst, p_surf, p_env, T_env, r_env = make_soundings(rng, shape=(8, 10))
    pi_ref = ref.thermo.CAPE_PI_vectorized(sst, p_surf, p_env, T_env, r_env)

    p_look, s_look, T_tab = load_ref_table()
    table = my_pi.EntropyTable.from_arrays(p_look, s_look, T_tab)
    pi_mine = np.asarray(my_pi.cape_pi(
        jnp.asarray(sst), jnp.asarray(p_surf), jnp.asarray(p_env),
        jnp.asarray(T_env), jnp.asarray(r_env), table,
        cecd=ref.namelist.Ck / ref.namelist.Cd,
        select_thermo=1, select_interp=2))

    assert pi_ref.max() > 60.0          # soundings actually produce strong PI
    diff = np.abs(pi_mine - pi_ref)
    assert np.percentile(diff, 99) < 2e-2, diff.max()
    assert diff.max() < 0.5             # headroom for a single LNB tie flip


def test_cape_pi_vs_reference_scalar(ref, monkeypatch):
    """Scalar transparent CAPE_PI (table mode).  The scalar impl omits the
    LNB sub-grid correction (add_area) and takes T_out at the LNB grid level
    (thermo/thermo.py:246-256), so exact agreement is impossible; we pin
    that our result sits within the scalar<->vectorized envelope measured
    from the reference's own pair."""
    monkeypatch.setattr(ref.namelist, 'select_thermo', 1)
    monkeypatch.setattr(ref.namelist, 'select_interp', 2)
    rng = np.random.default_rng(5)
    sst, p_surf, p_env, T_env, r_env = make_soundings(rng, shape=(4, 5))
    pi_scalar = np.nan_to_num(
        ref.CAPE_PI_scalar(sst, p_surf, p_env, T_env, r_env))
    pi_vec = ref.thermo.CAPE_PI_vectorized(sst, p_surf, p_env, T_env, r_env)

    p_look, s_look, T_tab = load_ref_table()
    table = my_pi.EntropyTable.from_arrays(p_look, s_look, T_tab)
    pi_mine = np.asarray(my_pi.cape_pi(
        jnp.asarray(sst), jnp.asarray(p_surf), jnp.asarray(p_env),
        jnp.asarray(T_env), jnp.asarray(r_env), table,
        cecd=1.0, select_thermo=1, select_interp=2))

    # the reference's own scalar/vectorized disagreement (add_area + T_out)
    env = np.abs(pi_vec - pi_scalar)
    assert env.max() > 0.0              # the envelope is real, not zero
    # we must match the vectorized one tightly ...
    np.testing.assert_allclose(pi_mine, pi_vec, atol=0.5, rtol=0)
    # ... and the scalar one within its own envelope (+ float headroom)
    assert np.all(np.abs(pi_mine - pi_scalar) <= env + 0.5)


def test_cape_pi_reversible_vs_reference_scalar(ref, monkeypatch):
    """Reversible branch (select_thermo=2) via the select_interp=1
    minimize path — the only reversible mode runnable from the snapshot.
    Same scalar-envelope caveat as above; additionally the scalar path
    leaves PI=NaN where CAPEs < CAPE (negative sqrt operand)."""
    monkeypatch.setattr(ref.namelist, 'select_thermo', 2)
    monkeypatch.setattr(ref.namelist, 'select_interp', 1)
    rng = np.random.default_rng(9)
    # full 24-level soundings: with a truncated (400 hPa top) sounding the
    # LNB exits the column top and BOTH our impl and the reference
    # vectorized path correctly zero PI (NaN outflow), while the scalar
    # path takes T_out at the top grid level regardless.
    sst, p_surf, p_env, T_env, r_env = make_soundings(rng, shape=(3, 3))
    with np.errstate(invalid='ignore'):
        pi_scalar = np.nan_to_num(
            ref.CAPE_PI_scalar(sst, p_surf, p_env, T_env, r_env))

    pi_mine = np.asarray(my_pi.cape_pi(
        jnp.asarray(sst), jnp.asarray(p_surf), jnp.asarray(p_env),
        jnp.asarray(T_env), jnp.asarray(r_env), None,
        cecd=1.0, select_thermo=2, select_interp=1))

    assert pi_scalar.max() > 40.0
    # envelope: the scalar impl omits add_area (Rd*dT1*(p1-p_out)/(p1+p_out)
    # reaches ~100 J/kg where upper levels are 0.4 log-p apart) and takes
    # T_out at the LNB grid level instead of interpolated (several K near the
    # tropopause -> ~1% of PI).  Measured gap on these soundings: +1..+8 m/s,
    # systematically positive (both omissions shrink the scalar PI).  The
    # tight reversible-branch semantics are pinned by
    # test_entropy_differential / test_entropy_inversion_vs_reference_minimize
    # (select_thermo=2); this asserts end-to-end structure at envelope level.
    diff = pi_mine - pi_scalar
    np.testing.assert_allclose(pi_mine, pi_scalar, atol=9.0, rtol=0)
    assert np.median(np.abs(diff)) < 3.5
    assert np.all(diff > -1.0)          # the envelope has a known sign


# ---------------------------------------------------------------------------
# geometry / diagnostics


def test_haversine_differential(ref):
    rng = np.random.default_rng(17)
    lon1 = rng.uniform(0.0, 360.0, (200,))
    lat1 = rng.uniform(-80.0, 80.0, (200,))
    lon2 = lon1 + rng.uniform(-40.0, 40.0, (200,))
    lat2 = np.clip(lat1 + rng.uniform(-30.0, 30.0, (200,)), -89.0, 89.0)
    d_r = ref.sphere.haversine(lon1, lat1, lon2, lat2)
    d_m = np.asarray(my_sphere.haversine(jnp.asarray(lon1), jnp.asarray(lat1),
                                         jnp.asarray(lon2), jnp.asarray(lat2)))
    np.testing.assert_allclose(d_m, d_r, rtol=1e-5, atol=1e-2)


def test_to_sphere_dist_differential(ref):
    rng = np.random.default_rng(19)
    lon = rng.uniform(0.0, 360.0, (100,))
    lat = rng.uniform(-70.0, 70.0, (100,))
    dx = rng.uniform(-2e5, 2e5, (100,))
    dy = rng.uniform(-2e5, 2e5, (100,))
    lon_r, lat_r = ref.sphere.to_sphere_dist(lon, lat, dx, dy)
    lon_m, lat_m = my_sphere.to_sphere_dist(jnp.asarray(lon), jnp.asarray(lat),
                                            jnp.asarray(dx), jnp.asarray(dy))
    np.testing.assert_allclose(np.asarray(lon_m), lon_r, rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(np.asarray(lat_m), lat_r, rtol=1e-5, atol=1e-4)


def _smooth_track(rng, T):
    t = np.arange(T)
    lon = (280.0 + 0.15 * t + 1.5 * np.sin(2 * np.pi * t / 37.0)
           + np.cumsum(rng.normal(0, 0.02, T)))
    lat = (15.0 + 0.08 * t + 0.8 * np.sin(2 * np.pi * t / 23.0)
           + np.cumsum(rng.normal(0, 0.01, T)))
    return lon, lat


def test_translational_speed_differential(ref):
    rng = np.random.default_rng(23)
    lon, lat = _smooth_track(rng, 48)
    # NOTE reference quirk: for 1-D input calc_translational_speed returns
    # shape (1, T) -- its flatten branch (util/sphere.py:81-82) is dead code
    # because `lon` was reassigned to the expanded 2-D array at :63-64.
    # f32 haversine loses ~1e-4 relative to cancellation at ~10 km hourly
    # displacements, hence rtol 1e-3.
    ut_r, vt_r = ref.sphere.calc_translational_speed(lon, lat, 3600.0)
    assert ut_r.shape == (1, lon.size)
    ut_m, vt_m = my_sphere.translational_speed(jnp.asarray(lon),
                                               jnp.asarray(lat), 3600.0)
    np.testing.assert_allclose(np.asarray(ut_m), ut_r.ravel(), rtol=1e-3,
                               atol=1e-2)
    np.testing.assert_allclose(np.asarray(vt_m), vt_r.ravel(), rtol=1e-3,
                               atol=1e-2)

    # 2-sample track exercises pure edge extrapolation
    ut_r, vt_r = ref.sphere.calc_translational_speed(lon[:2], lat[:2], 3600.0)
    ut_m, vt_m = my_sphere.translational_speed(jnp.asarray(lon[:2]),
                                               jnp.asarray(lat[:2]), 3600.0)
    np.testing.assert_allclose(np.asarray(ut_m), ut_r.ravel(), rtol=1e-3,
                               atol=1e-2)
    np.testing.assert_allclose(np.asarray(vt_m), vt_r.ravel(), rtol=1e-3,
                               atol=1e-2)

    # single sample: both produce NaN (util/sphere.py:59-60)
    ut_m, vt_m = my_sphere.translational_speed(jnp.asarray(lon[:1]),
                                               jnp.asarray(lat[:1]), 3600.0)
    assert np.all(np.isnan(np.asarray(ut_m)))
    assert np.all(np.isnan(np.asarray(vt_m)))


def test_axi_to_max_wind_differential(ref):
    rng = np.random.default_rng(29)
    T = 72
    lon, lat = _smooth_track(rng, T)
    tc_v = np.clip(20.0 + 25.0 * np.sin(np.pi * np.arange(T) / T)
                   + rng.normal(0, 2.0, T), 5.0, None)
    env_wnds = rng.normal(0.0, 8.0, (T, 4))
    vmax_r = ref.tc_wind.axi_to_max_wind(lon, lat, 3600.0, tc_v, env_wnds)
    vmax_m = np.asarray(diagnostics.axi_to_max_wind(
        jnp.asarray(lon), jnp.asarray(lat), 3600.0, jnp.asarray(tc_v),
        jnp.asarray(env_wnds)))
    # reference returns (1, T) via the calc_translational_speed shape quirk
    np.testing.assert_allclose(vmax_m, np.asarray(vmax_r).ravel(),
                               rtol=2e-3, atol=5e-3)


# ---------------------------------------------------------------------------
# interpolation


def test_bilinear_vs_rectbivariatespline(ref):
    """interp2_fx (RectBivariateSpline kx=ky=1) vs our fused bilinear gather:
    interior points, exact grid points, and out-of-domain clamping, on both
    ascending and descending latitude inputs (the reference flips
    descending grids internally, util/mat.py:143-148)."""
    rng = np.random.default_rng(31)
    lon = np.arange(250.0, 290.0, 1.0)
    lat_asc = np.arange(5.0, 40.0, 1.0)
    X = rng.normal(0.0, 1.0, (lat_asc.size, lon.size))

    n = 500
    qlon = np.concatenate([
        rng.uniform(lon[0], lon[-1], n),
        lon[rng.integers(0, lon.size, 50)],          # exact grid points
        rng.uniform(lon[0] - 5.0, lon[0], 25),       # out of domain (west)
        rng.uniform(lon[-1], lon[-1] + 5.0, 25)])    # out of domain (east)
    qlat = np.concatenate([
        rng.uniform(lat_asc[0], lat_asc[-1], n),
        lat_asc[rng.integers(0, lat_asc.size, 50)],
        rng.uniform(lat_asc[0] - 5.0, lat_asc[0], 25),
        rng.uniform(lat_asc[-1], lat_asc[-1] + 5.0, 25)])

    grid = my_interp.UniformGrid.from_axes(lon, lat_asc)
    mine = np.asarray(my_interp.bilinear_scalar(jnp.asarray(X), grid,
                                                jnp.asarray(qlon),
                                                jnp.asarray(qlat)))

    for lat_in, X_in in ((lat_asc, X), (lat_asc[::-1], X[::-1])):
        f = ref.mat.interp2_fx(lon, lat_in, X_in)
        theirs = f.ev(qlon, qlat)
        np.testing.assert_allclose(mine, theirs, rtol=1e-4, atol=1e-4)

    # packed-corner fast path is numerically identical to the plain gather
    packed = my_interp.pack_corners(jnp.asarray(X)[..., None])
    mine_packed = np.asarray(my_interp.bilinear_packed(
        packed, grid, jnp.asarray(qlon), jnp.asarray(qlat)))[:, 0]
    np.testing.assert_allclose(mine_packed, mine, atol=1e-4)


def test_regrid_vs_interp_2d_grid(ref):
    rng = np.random.default_rng(37)
    lon = np.arange(0.0, 360.0, 2.0)
    lat = np.arange(-40.0, 42.0, 2.0)
    X = rng.normal(0.0, 1.0, (lat.size, lon.size))
    dlon = np.arange(10.0, 350.0, 1.7)
    dlat = np.arange(-35.0, 35.0, 1.3)
    theirs = ref.mat.interp_2d_grid(lon, lat, X, dlon, dlat)
    mine = np.asarray(my_interp.regrid(X, lon, lat, dlon, dlat))
    np.testing.assert_allclose(mine, theirs, rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# Fourier synthesis


def test_fourier_vs_gen_f_exact(ref):
    """Feed our analytic evaluator the exact phases the reference's gen_f
    draws under a fixed numpy seed — outputs must agree pointwise, pinning
    both the n^-1.5 amplitude law and the sqrt(2/sum n^-3) normalization
    (track/bam_track.py:23-31)."""
    N, num = 15, 4
    T_s = 20.0 * 24 * 3600.0
    t = np.linspace(0.0, 15 * 24 * 3600.0, 361)

    np.random.seed(12345)
    fs_ref = ref.gen_f(N, T_s, t, num)                       # [num, T]

    np.random.seed(12345)
    phases = np.stack([np.tile(np.random.rand(N, 1), (1, t.size))[:, 0]
                       for _ in range(num)])                 # [num, N]
    n = np.arange(1, N + 1, dtype=np.float64)
    amp = np.sqrt(2.0 / np.sum(n ** -3.0)) * n ** -1.5
    series = my_fourier.FourierSeries(
        A=jnp.asarray(amp * np.cos(2 * np.pi * phases)),
        B=jnp.asarray(amp * np.sin(2 * np.pi * phases)),
        T_s=jnp.asarray(T_s))
    mine = np.asarray(series.evaluate_grid(jnp.asarray(t)))  # [T, num]
    np.testing.assert_allclose(mine.T, fs_ref, atol=5e-5)

    # scalar evaluate agrees with the grid path
    one = np.asarray(series.evaluate(jnp.asarray(t[100])))
    np.testing.assert_allclose(one, mine[100], atol=1e-5)
