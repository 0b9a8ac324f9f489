"""Saturation thermodynamics, entropy, and LCL kernels (JAX, fully batched).

Reference equivalent: thermo/thermo.py:19-134.  Every function is elementwise
over arbitrary array shapes and safe under jit/vmap; the reference's
pseudoadiabatic (select_thermo=1) and reversible (=2) branches are both
implemented.  The Lambert-W -1 branch used by the exact LCL expression
(Romps 2017; thermo/thermo.py:107-126) is implemented with a series initial
guess plus Halley refinement since scipy.special is unavailable on device.
"""

from __future__ import annotations

import jax.numpy as jnp

from tropical_cyclone_risk_tpu import constants as pr


def sat_thermo_pog(T, p):
    """O'Gorman constant-Lv saturation formulas (thermo/thermo.py:19-26)."""
    es = pr.e_trip * jnp.exp(pr.Lv / pr.Rv * (1.0 / pr.T_trip - 1.0 / T))
    rs = pr.Rd / pr.Rv * es / (p - es)
    return es, rs


def sat_thermo(T, p):
    """Bolton saturation vapor pressure / mixing ratio (thermo/thermo.py:29-38).

    NaN temperatures propagate NaN (the reference masks them to es=0; we keep
    NaN so missing data stays visible — callers sanitize at ingestion)."""
    T_c = T - 273.0
    es = 610.94 * jnp.exp(jnp.minimum(17.625 * T_c / (T_c + 243.04), 10.0))
    rs = pr.Rd / pr.Rv * es / (p - es)
    return es, rs


def conv_q_to_rh(T, q, p_Pa):
    """Specific humidity -> relative humidity, clipped to [1e-5, 1]
    (thermo/thermo.py:41-46)."""
    _, rs = sat_thermo(T, p_Pa)
    qs = rs / (1 + rs)
    return jnp.clip(q / qs, 1e-5, 1.0)


def s_unsat(T, p, r, r_t, select_thermo: int = 1):
    """Moist entropy of an unsaturated parcel (thermo/thermo.py:49-60)."""
    es, rs = sat_thermo(T, p)
    rh = jnp.maximum(r / rs * (1 + rs / pr.eps) / (1 + r / pr.eps), 0.0)
    if select_thermo == 1:
        return (pr.cp * jnp.log(T) - pr.Rd * jnp.log(p - es * rh)
                + pr.L0 * r / T - r * pr.Rv * jnp.log(rh))
    L = pr.Lv - (pr.cpv - pr.cl) * (273.15 - T)
    return ((pr.cp + pr.cl * r_t) * jnp.log(T)
            - pr.Rd * jnp.log(p - es * rh) + L * r / T
            - r * pr.Rv * jnp.log(rh))


def s_sat(T, p, r_t, select_thermo: int = 1, use_pog: bool = False):
    """Saturation entropy (thermo/thermo.py:64-75).

    use_pog selects the O'Gorman constant-Lv saturation formula — needed to
    reproduce the reference's bundled entropy_table.npz, which was generated
    with that formula even though the reference's current s_sat uses Bolton
    (verified numerically against the snapshot table)."""
    es, rs = sat_thermo_pog(T, p) if use_pog else sat_thermo(T, p)
    T = jnp.maximum(T, 1e-4)
    if select_thermo == 1:
        return (pr.cp * jnp.log(T)
                - pr.Rd * jnp.log(jnp.maximum(p - es, 1e-4)) + pr.L0 * rs / T)
    L = pr.Lv - (pr.cpv - pr.cl) * (273.15 - T)
    return ((pr.cp + r_t * pr.cl) * jnp.log(T)
            - pr.Rd * jnp.log(jnp.maximum(p - es, 1e-4)) + L * rs / T)


def s_sat_der(T, p, r_t, select_thermo: int = 1, use_pog: bool = False):
    """Analytic dT derivative of saturation entropy (thermo/thermo.py:78-89)."""
    es, rs = sat_thermo_pog(T, p) if use_pog else sat_thermo(T, p)
    if select_thermo == 1:
        return (1 / T) * (pr.cp + pr.L0 ** 2 * rs / pr.Rv / T ** 2
                          * (1 - rs / pr.eps))
    L = pr.Lv - (pr.cpv - pr.cl) * (273.15 - T)
    return (1 / T) * (pr.cp + pr.cpv * rs + pr.cl * (r_t - rs)
                      + L ** 2 * rs / pr.Rv / T ** 2 * (1 - rs / pr.eps))


def sat_deficit(sst, ps, T, pm, rv, select_thermo: int = 1):
    """Normalized mid-level saturation entropy deficit chi
    (thermo/thermo.py:92-104)."""
    sp = s_unsat(T, pm, rv, rv, select_thermo)
    sps = s_sat(T, pm, rv, select_thermo)
    spss = s_sat(sst, ps, rv, select_thermo)
    return (sps - sp) / (spss - sps)


def lambertw_m1(x):
    """Lambert W, branch -1, for x in [-1/e, 0).

    Initial guess: branch-point series near -1/e, asymptotic log-log form
    elsewhere; refined with four Halley iterations (quintic convergence —
    float64-exact, well past float32 precision).
    """
    x = jnp.asarray(x)
    # branch-point series: w = -1 - p - p^2/3 - ... with p = sqrt(2(1+e*x))
    p = jnp.sqrt(jnp.maximum(2.0 * (1.0 + jnp.e * x), 0.0))
    w_series = -1.0 - p - p * p / 3.0 - 11.0 / 72.0 * p ** 3
    # asymptotic: w = L1 - L2 + L2/L1, L1 = log(-x), L2 = log(-L1)
    L1 = jnp.log(-x)
    L2 = jnp.log(jnp.maximum(-L1, 1e-30))
    w_asym = L1 - L2 + L2 / L1
    w = jnp.where(x > -0.27, w_asym, w_series)
    for _ in range(4):
        ew = jnp.exp(w)
        f = w * ew - x
        wp1 = w + 1.0
        denom = ew * wp1 - (w + 2.0) * f / (2.0 * wp1)
        w = w - f / denom
    return w


def get_LCL(p, T, r, rh):
    """Exact lifting-condensation-level pressure (Romps 2017;
    thermo/thermo.py:107-126)."""
    E0v = 2.3740e6
    cvv = 1418.0
    cvl = 4119.0
    cpv = cvv + pr.Rv
    q = r / (1 + r)
    Rm = (1 - q) * pr.Rd + q * pr.Rv
    cpm = (1 - q) * pr.cp + q * cpv
    a = cpm / Rm + (cvl - cpv) / pr.Rv
    b = -(E0v - (cvv - cvl) * pr.T_trip) / (pr.Rv * T)
    c = b / a
    T_LCL = c * T / lambertw_m1(rh ** (1 / a) * c * jnp.exp(c))
    p_LCL = p * (T_LCL / T) ** (cpm / Rm)
    return p_LCL


def calc_T_rho(T, rv, rt, select_thermo: int = 1):
    """Density temperature (thermo/thermo.py:129-134)."""
    if select_thermo == 1:
        return T * (1 + rv / pr.eps) / (1 + rv)
    return T * (1 + rv / pr.eps) / (1 + rt)


def invert_entropy_newton(p, s_ref, r_t=0.0, select_thermo: int = 1,
                          T0=250.0, iters: int = 25, use_pog: bool = False):
    """Solve s_sat(T, p, r_t) = s_ref for T by damped Newton iteration.

    Batched replacement for the reference's BFGS minimization
    (thermo/thermo.py:214-221) and the offline Nelder-Mead table generation
    (thermo/thermo.py:451-481).  s_sat is monotone increasing in T over the
    atmospheric range, so Newton from 250 K converges for all table entries.
    """
    T = jnp.full(jnp.broadcast_shapes(jnp.shape(p), jnp.shape(s_ref)), T0,
                 dtype=jnp.result_type(p, s_ref, jnp.float32))
    for _ in range(iters):
        f = s_sat(T, p, r_t, select_thermo, use_pog) - s_ref
        df = s_sat_der(T, p, r_t, select_thermo, use_pog)
        step = jnp.clip(f / df, -30.0, 30.0)   # damp far-from-root steps
        T = jnp.clip(T - step, 40.0, 400.0)
    return T


def generate_entropy_table(pmin_hPa=25.0, pmax_hPa=1050.0, nprs=200,
                           smin=2337.3348599644537, smax=3585.9052076596804,
                           ns=200, select_thermo: int = 1,
                           use_pog: bool = True):
    """Generate the (p, s) -> T entropy-inversion lookup table.

    Matches the reference's bundled ``thermo/entropy_table.npz`` axes (200x200,
    p in [2500, 105000] Pa, s in [2337.33, 3585.91] J/kg/K — verified from the
    snapshot) but is regenerated from our own Newton inversion rather than
    copied (thermo/thermo.py:451-481 is the reference generator).

    use_pog defaults True: the bundled table was produced with the O'Gorman
    saturation formula (verified numerically), and the production PI path
    inverts entropy through that table, so we reproduce it for parity.
    Returns (p[nprs], s[ns], T[nprs, ns]).
    """
    s_look = jnp.linspace(smin, smax, ns)
    p_look = 100.0 * jnp.linspace(pmin_hPa, pmax_hPa, nprs)
    P, S = jnp.meshgrid(p_look, s_look, indexing='ij')
    T = invert_entropy_newton(P, S, 0.0, select_thermo, use_pog=use_pog)
    return p_look, s_look, T


def gpi(PI, chi, vort, S):
    """Genesis potential index (thermo/thermo.py:415-419; kept for API parity
    — the reference pipeline never calls it).  PI thresholded at 35 m/s."""
    PI_abs = jnp.maximum(PI - 35.0, 0.0)
    return jnp.abs(vort) ** 3 * chi ** (-4.0 / 3.0) * PI_abs ** 2 \
        / (S + 25.0) ** 4


def gpi_en04(PI, rh, vort, S):
    """Emanuel (2004) genesis potential index (thermo/thermo.py:421-425;
    API parity, uncalled in the reference pipeline)."""
    return (1e5 * jnp.abs(vort)) ** (rh / 50.0) ** 3 * (PI / 70.0) ** 3 \
        / (1.0 + 0.1 * S) ** 2


def generate_entropy_table_reversible(pmin_hPa=25.0, pmax_hPa=1050.0,
                                      nprs=200, smin=2337.3348599644537,
                                      smax=3585.9052076596804, ns=200,
                                      rtmax=0.035, nrt=16):
    """Generate the 3-D (p, s, r_t) -> T reversible-entropy inversion table
    (reference: entropy_table_reversible.npz, loaded at thermo/thermo.py:
    159-163 and interpolated with interpn at :230 — the blob is absent from
    the snapshot, so axes are chosen to span the physical range; values are
    regenerated by Newton inversion of s_sat(select_thermo=2)).

    Returns (p[nprs], s[ns], rt[nrt], T[nprs, ns, nrt])."""
    s_look = jnp.linspace(smin, smax, ns)
    p_look = 100.0 * jnp.linspace(pmin_hPa, pmax_hPa, nprs)
    rt_look = jnp.linspace(0.0, rtmax, nrt)
    P, S, R = jnp.meshgrid(p_look, s_look, rt_look, indexing='ij')
    T = invert_entropy_newton(P, S, R, select_thermo=2, use_pog=False)
    return p_look, s_look, rt_look, T
