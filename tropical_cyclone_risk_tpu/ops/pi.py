"""Potential intensity (CAPE-PI) on the accelerator.

Reference equivalent: ``CAPE_PI_vectorized`` (thermo/thermo.py:266-412) and
the transparent scalar ``CAPE_PI`` (thermo/thermo.py:144-256).  The reference
vectorizes with per-pressure-level boolean masks and masked spline evals; here
every column is a fixed-shape masked computation, so the whole global grid is
one fused XLA program (vmap is implicit — all ops broadcast over the trailing
column axes).

Entropy inversion uses a (p, s) -> T lookup table interpolated bilinearly
(matching the reference's RectBivariateSpline over entropy_table.npz,
thermo/thermo.py:315-317) — the table itself is regenerated by Newton
inversion (ops/thermo.generate_entropy_table), not copied.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from tropical_cyclone_risk_tpu import constants as pr
from tropical_cyclone_risk_tpu.ops import thermo
from tropical_cyclone_risk_tpu.ops.interp import UniformGrid, bilinear_scalar


class EntropyTable(NamedTuple):
    grid: UniformGrid      # lon-axis = entropy s, lat-axis = pressure p
    T: jnp.ndarray         # [nprs, ns]

    @staticmethod
    def create(select_thermo: int = 1) -> 'EntropyTable':
        p_look, s_look, T = thermo.generate_entropy_table(
            select_thermo=select_thermo)
        grid = UniformGrid.from_axes(np.asarray(s_look), np.asarray(p_look))
        return EntropyTable(grid, T)

    @staticmethod
    def from_arrays(p_look, s_look, T) -> 'EntropyTable':
        grid = UniformGrid.from_axes(np.asarray(s_look), np.asarray(p_look))
        return EntropyTable(grid, jnp.asarray(T))

    def lookup(self, p, s, r_t=None):
        """T(p, s) with boundary clamping (spline-equivalent)."""
        del r_t    # pseudoadiabatic table: no total-water dependence
        shape = jnp.broadcast_shapes(jnp.shape(p), jnp.shape(s))
        p = jnp.broadcast_to(p, shape).reshape(-1)
        s = jnp.broadcast_to(s, shape).reshape(-1)
        return bilinear_scalar(self.T, self.grid, s, p).reshape(shape)


class EntropyTable3(NamedTuple):
    """3-D reversible-entropy inversion table: (p, s, r_t) -> T
    (reference: entropy_table_reversible.npz + interpn,
    thermo/thermo.py:159-163, 230)."""
    grid: UniformGrid          # lon-axis = entropy s, lat-axis = pressure p
    rt0: float
    drt: float
    T: jnp.ndarray             # [nprs, ns, nrt]

    @staticmethod
    def create() -> 'EntropyTable3':
        p_look, s_look, rt_look, T = thermo.generate_entropy_table_reversible()
        grid = UniformGrid.from_axes(np.asarray(s_look), np.asarray(p_look))
        rt = np.asarray(rt_look)
        return EntropyTable3(grid, float(rt[0]), float(rt[1] - rt[0]), T)

    def lookup(self, p, s, r_t):
        """Trilinear T(p, s, r_t) with boundary clamping."""
        shape = jnp.broadcast_shapes(jnp.shape(p), jnp.shape(s),
                                     jnp.shape(r_t))
        p = jnp.broadcast_to(p, shape).reshape(-1)
        s = jnp.broadcast_to(s, shape).reshape(-1)
        r = jnp.broadcast_to(r_t, shape).reshape(-1)
        nrt = self.T.shape[-1]
        u = jnp.clip((r - self.rt0) / self.drt, 0.0, nrt - 1.0)
        k = jnp.clip(jnp.floor(u), 0, nrt - 2).astype(jnp.int32)
        w = (u - k).astype(self.T.dtype)
        # two bilinear (p, s) lookups on adjacent r_t slabs, then lerp.
        # gather the slabs per query via the plane axis of bilinear():
        T_pl = jnp.moveaxis(self.T, -1, 0)   # [nrt, nprs, ns]
        lo = bilinear_scalar(T_pl, self.grid, s, p, plane_idx=k)
        hi = bilinear_scalar(T_pl, self.grid, s, p, plane_idx=k + 1)
        return (lo + w * (hi - lo)).reshape(shape)


@functools.partial(jax.jit,
                   static_argnames=('select_thermo', 'cecd', 'select_interp'))
def cape_pi(sst, p_surf, p_env, T_env, r_env, table: EntropyTable,
            cecd: float = 1.0, select_thermo: int = 1,
            select_interp: int = 2):
    """Potential intensity [m/s] over a grid of columns.

    sst, p_surf: [...] surface fields (K, Pa)
    p_env:       [L] pressure sounding, surface level first (Pa)
    T_env, r_env:[L, ...] temperature (K) and mixing ratio profiles
    select_interp: 2 = entropy-table lookup (production default), 1 = direct
    Newton inversion of the saturation entropy per point (the reference's
    optimization mode, thermo/thermo.py:214-221 / namelist select_interp).

    Mirrors CAPE_PI_vectorized (thermo/thermo.py:266-412) step for step:
    dry adiabat below the LCL, entropy-inverted moist adiabat above, LNB
    with sub-grid linear outflow correction, CAPE/CAPEs log-pressure sums.
    """
    L = p_env.shape[0]
    col_shape = sst.shape
    T_ns = T_env[0]
    r_ns = r_env[0]
    p_ns = p_env[0]

    _, rs = thermo.sat_thermo(sst, p_surf)
    rh = r_ns / rs * (1 + rs / pr.eps) / (1 + r_ns / pr.eps)
    s_ns = thermo.s_unsat(T_ns, p_ns, r_ns, r_ns, select_thermo)
    ss = thermo.s_sat(sst, p_surf, rs, select_thermo)

    lnp = jnp.log(p_env)
    dlnp = jnp.diff(lnp, append=2 * lnp[-1] - lnp[-2])
    T_rho_env = thermo.calc_T_rho(T_env, r_env, r_env, select_thermo)

    pLCL = thermo.get_LCL(p_ns, T_ns, r_ns, rh)

    # First condensing level: first l with pLCL > p_env[l]; forced to the top
    # level when none condenses (thermo/thermo.py:320-325).
    lvl = jnp.arange(L).reshape((L,) + (1,) * len(col_shape))
    p_env_col = p_env.reshape((L,) + (1,) * len(col_shape))
    cond = pLCL[None] > p_env_col
    cond = cond.at[-1].set(True)
    Icond = jnp.argmax(cond, axis=0)

    # Ascent profile: dry adiabat below LCL (constant r), moist adiabat above.
    if select_interp == 1:
        # direct inversion of the same (Bolton) saturation entropy used for
        # the parcel entropies, with the parcel's total water threaded
        # through (needed by the reversible branch)
        invert = lambda p, s_, r_t: thermo.invert_entropy_newton(
            p, s_, r_t, select_thermo, use_pog=False)
    else:
        # table mode: EntropyTable (2-D pseudoadiabatic, reproduces the
        # reference's bundled pog-generated table) or EntropyTable3 (3-D
        # reversible with the r_t axis, like the reference's
        # entropy_table_reversible.npz + interpn, thermo/thermo.py:159,230)
        invert = lambda p, s_, r_t: table.lookup(p, s_, r_t)
    Ta_dry = T_ns[None] * (p_env_col / p_ns) ** (pr.Rd / pr.cp)
    Ta_moist = invert(jnp.broadcast_to(p_env_col, (L,) + col_shape),
                      jnp.broadcast_to(s_ns[None], (L,) + col_shape),
                      r_ns[None])
    below_lcl = lvl < Icond[None]
    Ta_prof = jnp.where(below_lcl, Ta_dry, Ta_moist)
    _, ra_moist = thermo.sat_thermo(Ta_prof, p_env_col)
    ra_prof = jnp.where(below_lcl, r_ns[None], ra_moist)

    # Surface-saturated parcel: moist adiabat from the surface.
    Ts_prof = invert(jnp.broadcast_to(p_env_col, (L,) + col_shape),
                     jnp.broadcast_to(ss[None], (L,) + col_shape),
                     rs[None])
    _, rs_prof = thermo.sat_thermo(Ts_prof, p_env_col)

    T_rho_a = thermo.calc_T_rho(Ta_prof, ra_prof, r_ns[None], select_thermo)
    T_rho_s = thermo.calc_T_rho(Ts_prof, rs_prof, rs[None], select_thermo)

    # Level of neutral buoyancy: LAST level where parcel is buoyant; L-1 when
    # never buoyant (reference flip/argmax idiom, thermo/thermo.py:360-361).
    def last_true(mask):
        idx = jnp.max(jnp.where(mask, lvl, -1), axis=0)
        return jnp.where(idx < 0, L - 1, idx)

    a_out_I = last_true(T_rho_a >= T_rho_env)
    s_out_I = last_true(T_rho_s >= T_rho_env)

    def outflow(out_I, T_rho_p):
        """Sub-grid LNB correction (thermo/thermo.py:363-395). Applied only
        when out_I < L-1; otherwise T_out=NaN-equivalent (0 / NaN handling
        mirrors the reference's zero-init / NaN-init)."""
        i = jnp.minimum(out_I, L - 2)
        take = lambda arr: jnp.take_along_axis(arr, i[None], axis=0)[0]
        take1 = lambda arr: jnp.take_along_axis(arr, i[None] + 1, axis=0)[0]
        p1 = p_env[i]
        p2 = p_env[i + 1]
        dT1 = take(T_rho_p) - take(T_rho_env)
        dT2 = take1(T_rho_p) - take1(T_rho_env)
        p_out = (p1 * dT2 - p2 * dT1) / (dT2 - dT1)
        Te1 = take(T_env)
        Te2 = take1(T_env)
        T_out = (Te1 * (p_out - p2) + Te2 * (p1 - p_out)) / (p1 - p2)
        add_area = pr.Rd * dT1 * (p1 - p_out) / (p1 + p_out)
        valid = out_I < (L - 1)
        return (jnp.where(valid, T_out, jnp.nan),
                jnp.where(valid, add_area, 0.0))

    T_out_s, add_area_s = outflow(s_out_I, T_rho_s)
    _, add_area_a = outflow(a_out_I, T_rho_a)

    contrib_a = pr.Rd * (T_rho_a - T_rho_env) * -dlnp.reshape(
        (L,) + (1,) * len(col_shape))
    contrib_s = pr.Rd * (T_rho_s - T_rho_env) * -dlnp.reshape(
        (L,) + (1,) * len(col_shape))
    CAPE = jnp.sum(jnp.where(lvl <= a_out_I[None], contrib_a, 0.0), axis=0)
    CAPEs = jnp.sum(jnp.where(lvl <= s_out_I[None], contrib_s, 0.0), axis=0)
    CAPE = CAPE + add_area_a
    CAPEs = CAPEs + add_area_s

    CAPE = jnp.maximum(CAPE, 0.0)
    CAPE = jnp.nan_to_num(CAPE)
    cape_diff = CAPEs - CAPE
    PI = jnp.sqrt(jnp.maximum(cecd * sst / T_out_s * cape_diff, 0.0))
    return jnp.nan_to_num(PI)
