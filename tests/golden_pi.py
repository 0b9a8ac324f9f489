"""Float64 scalar golden implementation of CAPE-PI for testing.

An independent, transparent per-column re-derivation of the downscaling PI
algorithm (Emanuel potential intensity via CAPE differences with table-based
entropy inversion), used as the trusted oracle for the batched float32 JAX
kernel.  Deliberately written loop-wise for clarity.
"""

import numpy as np
from scipy.interpolate import RectBivariateSpline

Rd = 287.04
Rv = 461.5
cp = 718 + Rd
eps = Rd / Rv
L0 = 2.555e6


def sat(T, p):
    Tc = T - 273.0
    es = 610.94 * np.exp(np.minimum(17.625 * Tc / (Tc + 243.04), 10.0))
    return es, Rd / Rv * es / (p - es)


def s_unsat(T, p, r):
    es, rs = sat(T, p)
    rh = max(r / rs * (1 + rs / eps) / (1 + r / eps), 0.0)
    return cp * np.log(T) - Rd * np.log(p - es * rh) + L0 * r / T \
        - r * Rv * np.log(rh)


def s_sat(T, p):
    es, _ = sat(T, p)
    rs = Rd / Rv * es / (p - es)
    return cp * np.log(max(T, 1e-4)) - Rd * np.log(max(p - es, 1e-4)) \
        + L0 * rs / max(T, 1e-4)


def lcl_romps(p, T, r, rh):
    from scipy.special import lambertw
    E0v, cvv, cvl = 2.3740e6, 1418.0, 4119.0
    cpv = cvv + Rv
    q = r / (1 + r)
    Rm = (1 - q) * Rd + q * Rv
    cpm = (1 - q) * cp + q * cpv
    a = cpm / Rm + (cvl - cpv) / Rv
    b = -(E0v - (cvv - cvl) * 273.16) / (Rv * T)
    c = b / a
    T_LCL = c * T / lambertw(rh ** (1 / a) * c * np.exp(c), -1).real
    return p * (T_LCL / T) ** (cpm / Rm)


def t_rho(T, rv):
    return T * (1 + rv / eps) / (1 + rv)


def pi_column(sst, p_surf, p_env, T_env, r_env, p_look, s_look, T_look,
              cecd=1.0):
    """PI for one column; table interpolation via RectBivariateSpline as in
    production pipelines."""
    f = RectBivariateSpline(p_look, s_look, T_look, kx=1, ky=1)
    L = len(p_env)
    T_ns, r_ns, p_ns = T_env[0], r_env[0], p_env[0]
    _, rs = sat(sst, p_surf)
    rh = r_ns / rs * (1 + rs / eps) / (1 + r_ns / eps)
    s_ns = s_unsat(T_ns, p_ns, r_ns)
    ss = s_sat(sst, p_surf)

    lnp = np.log(p_env)
    dlnp = np.diff(lnp, append=2 * lnp[-1] - lnp[-2])
    T_rho_env = t_rho(T_env, r_env)

    pLCL = lcl_romps(p_ns, T_ns, r_ns, rh)
    cond = pLCL > p_env
    cond[-1] = True
    Icond = int(np.argmax(cond))

    Ta = np.empty(L)
    ra = np.empty(L)
    for l in range(L):
        if l < Icond:
            Ta[l] = T_ns * (p_env[l] / p_ns) ** (Rd / cp)
            ra[l] = r_ns
        else:
            Ta[l] = f.ev(p_env[l], s_ns)
            _, ra[l] = sat(Ta[l], p_env[l])
    Ts = np.array([f.ev(p_env[l], ss) for l in range(L)])
    rs_prof = np.array([sat(Ts[l], p_env[l])[1] for l in range(L)])

    Tra = t_rho(Ta, ra)
    Trs = t_rho(Ts, rs_prof)

    def last_buoyant(Trp):
        idx = np.where(Trp >= T_rho_env)[0]
        return int(idx[-1]) if len(idx) else L - 1

    aI = last_buoyant(Tra)
    sI = last_buoyant(Trs)

    def outflow(i, Trp):
        if i >= L - 1:
            return np.nan, 0.0
        dT1 = Trp[i] - T_rho_env[i]
        dT2 = Trp[i + 1] - T_rho_env[i + 1]
        p_out = (p_env[i] * dT2 - p_env[i + 1] * dT1) / (dT2 - dT1)
        T_out = (T_env[i] * (p_out - p_env[i + 1])
                 + T_env[i + 1] * (p_env[i] - p_out)) / (p_env[i] - p_env[i + 1])
        add = Rd * dT1 * (p_env[i] - p_out) / (p_env[i] + p_out)
        return T_out, add

    T_out_s, add_s = outflow(sI, Trs)
    _, add_a = outflow(aI, Tra)

    CAPE = sum(Rd * (Tra[l] - T_rho_env[l]) * -dlnp[l] for l in range(aI + 1))
    CAPEs = sum(Rd * (Trs[l] - T_rho_env[l]) * -dlnp[l] for l in range(sI + 1))
    CAPE = max(CAPE + add_a, 0.0)
    if np.isnan(CAPE):
        CAPE = 0.0
    diff = CAPEs + add_s - CAPE
    val = cecd * sst / T_out_s * diff
    pi = np.sqrt(max(val, 0.0)) if not np.isnan(val) else 0.0
    return pi
