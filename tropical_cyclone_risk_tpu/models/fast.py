"""Coupled FAST intensity + intensity-dependent beta-advection RHS.

Reference equivalents: intensity/coupled_fast.py (Coupled_FAST: the FAST ODEs
of Emanuel 2017 with ocean feedback and ventilation) and track/bam_track.py
(BetaAdvectionTrack: steering-flow sampling and beta drift).  The reference
evaluates ~20 scalar spline lookups plus one LAPACK Cholesky per RHS call per
storm; here one step of the whole seed batch costs one corner-packed gather
row per seed (wind stats + environment + land/bathy fused, see
fields.build_stacks) and one unrolled elementwise Cholesky.

State layout: y = (lon, lat, v, m), batched [N].
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from tropical_cyclone_risk_tpu import constants
from tropical_cyclone_risk_tpu.config import Namelist
from tropical_cyclone_risk_tpu.models import fields as F
from tropical_cyclone_risk_tpu.ops import chol, interp
from tropical_cyclone_risk_tpu.ops.fourier import FourierSeries

# FAST dimensionless constants (intensity/coupled_fast.py:25-27)
EPSILON = 0.33
KAPPA = 0.1
BETA = 1.0 - EPSILON - KAPPA

MS_TO_KTS = 1.94384


class SeedParams(NamedTuple):
    """Per-seed static-through-time parameters of one integration batch."""
    plane: jnp.ndarray    # [N] int32: (year, month) plane in the FieldPack
    h_bl: jnp.ndarray     # [N] boundary-layer depth (basin-dependent)
    fourier: FourierSeries  # A/B: [N, W, n_fourier]


class State(NamedTuple):
    lon: jnp.ndarray
    lat: jnp.ndarray
    v: jnp.ndarray
    m: jnp.ndarray


def steering_coefs(cfg: Namelist, v):
    """Intensity-dependent steering weights, clipped (coupled_fast.py:183-192).
    Returns [N, L]."""
    if cfg.coupled_track:
        y_a = jnp.asarray(cfg.y_alpha, v.dtype)
        m_a = jnp.asarray(cfg.m_alpha, v.dtype)
        a = (v[:, None] * MS_TO_KTS) * m_a + y_a
        a = jnp.clip(a, jnp.asarray(cfg.alpha_min, v.dtype),
                     jnp.asarray(cfg.alpha_max, v.dtype))
        return jnp.where(jnp.isnan(a), y_a, a)
    coefs = jnp.asarray(cfg.steering_coefs, v.dtype)
    return jnp.broadcast_to(coefs, v.shape + coefs.shape)


def color_winds_given_f(cfg: Namelist, stats, f):
    """Environmental winds from gathered wind statistics [N, W + W(W+1)/2]
    and an already-evaluated Fourier sample f [N, W]: monthly mean +
    Cholesky-colored synthetic flow (track/bam_track.py:116-128)."""
    W = cfg.n_wind_levels
    mean = stats[:, :W]
    cov = chol.lower_tri_to_full(stats[:, W:], W)
    L, ok = chol.cholesky_unrolled(cov)
    wnds = mean + jnp.einsum('nij,nj->ni', L, f,
                             precision=jax.lax.Precision.HIGHEST)
    # non-PD covariance -> zero winds (reference zero-fallback,
    # track/bam_track.py:123-126)
    return jnp.where(ok[:, None], wnds, 0.0)


def color_winds(cfg: Namelist, stats, fourier: FourierSeries, t):
    """color_winds_given_f with F(t) evaluated analytically at t."""
    return color_winds_given_f(cfg, stats, fourier.evaluate(t))


def sample_env_winds(pack: F.FieldPack, cfg: Namelist, lon, lat, plane,
                     fourier: FourierSeries, t):
    """Winds at (lon, lat, t) gathering from the pack directly (one-shot
    callers; the integration loop gathers via the fused stacks instead)."""
    stats = interp.bilinear(pack.wind, pack.grid, lon, lat, plane)
    return color_winds(cfg, stats, fourier, t)


def deep_layer_indices(cfg: Namelist):
    """Channel indices (iu250, iv250, iu850, iv850) of the deep-layer shear
    components in the (u_l1, v_l1, u_l2, v_l2, ...) wind vector — resolved
    by steering level like the reference's name-based deep_layer_winds
    (track/env_wind.py:49-55), so 3-level configs keep correct shear."""
    levels = list(cfg.steering_levels)
    if 250 not in levels or 850 not in levels:
        raise ValueError('deep-layer shear needs 250 and 850 hPa among '
                         f'steering_levels, got {levels}')
    i250 = levels.index(250)
    i850 = levels.index(850)
    return 2 * i250, 2 * i250 + 1, 2 * i850, 2 * i850 + 1


def shear_magnitude(cfg: Namelist, wnds):
    """250-850 hPa shear magnitude from the sampled wind vector
    (coupled_fast.py:115-122)."""
    iu2, iv2, iu8, iv8 = deep_layer_indices(cfg)
    u_shr = wnds[:, iu2] - wnds[:, iu8]
    v_shr = wnds[:, iv2] - wnds[:, iv8]
    return jnp.sqrt(u_shr ** 2 + v_shr ** 2)


def _is_land(land_val):
    # reference: interpolated land fraction == 1 exactly (coupled_fast.py:38);
    # float32 gather needs a tolerance at the last ulp
    return land_val >= 1.0 - 1e-5


class DerivedSample(NamedTuple):
    """Stage-independent derivations of one FieldSample, hoisted out of the
    per-RK-stage RHS (rhs_given_winds evaluates 4x per step, 12x per
    stride-3 block, but these depend only on the gathered fields): the
    t_strat^-0.4 pow is the single most expensive transcendental in the
    dynamics, and the land/no-mixing masks are pure field predicates.
    z_fac keeps ocean_alpha's exact multiplication order
    (((0.01*s)*h_m)*u_T*v_pot/v), so hoisting is bit-identical."""
    z_fac: jnp.ndarray        # [N] 0.01 * t_strat^-0.4 * h_m
    v_pot: jnp.ndarray        # [N] land-zeroed potential intensity
    no_mixing: jnp.ndarray    # [N] bool: alpha = 1 (land/shallow/unstrat)


def derive_sample(cfg: Namelist, smp: 'FieldSample') -> DerivedSample:
    env = smp.env
    h_m = env[:, F.MLD]
    t_strat = env[:, F.STRAT]
    v_pot = jnp.where(_is_land(smp.land), 0.0, env[:, F.VPOT])
    no_mixing = (smp.bathy >= 0) | (-h_m <= smp.bathy) | (t_strat == 0)
    return DerivedSample(0.01 * t_strat ** -0.4 * h_m, v_pot, no_mixing)


def ocean_alpha(cfg: Namelist, env, land_val, bathy_val, u_T, v, drv=None):
    """Ocean feedback parameter alpha (coupled_fast.py:65-94).

    alpha = 1 over land / shallow / unstratified water; else
    1 - 0.87 exp(-z) with z = 0.01 strat^-0.4 h_m u_T v_pot / v.
    drv: optional precomputed DerivedSample (the integrator hoists it out
    of the RK stage loop)."""
    if drv is None:
        h_m = env[:, F.MLD]
        t_strat = env[:, F.STRAT]
        v_pot = jnp.where(_is_land(land_val), 0.0, env[:, F.VPOT])
        no_mixing = (bathy_val >= 0) | (-h_m <= bathy_val) | (t_strat == 0)
        z = 0.01 * t_strat ** -0.4 * h_m * u_T * v_pot / v
    else:
        v_pot, no_mixing = drv.v_pot, drv.no_mixing
        z = drv.z_fac * u_T * v_pot / v
    fac = jnp.exp(-jnp.clip(z, 0.0, 100.0))
    return jnp.where(no_mixing, 1.0, 1.0 - 0.87 * fac), v_pot


class FieldSample(NamedTuple):
    """Per-seed field values gathered at one position: the expensive random
    access separated from the cheap per-RK-stage dynamics so the integrator
    can sample once per output step (fields vary on ~100 km scales; a storm
    moves ~20 km/h, so per-stage re-gathering changes nothing physical)."""
    wind_stats: jnp.ndarray   # [N, W + W(W+1)/2]
    env: jnp.ndarray          # [N, N_ENV]
    land: jnp.ndarray         # [N]
    bathy: jnp.ndarray        # [N]


def sample_fields(stacks: F.GatherStacks, lon, lat, plane) -> FieldSample:
    """All field gathers for one batch position (the hot memory op):
    one corner-packed gather row per seed when land/bathy share the
    atmospheric grid, two otherwise."""
    cell = interp.bilinear_packed(stacks.cell4, stacks.grid, lon, lat, plane)
    if stacks.geo_in_cell:
        return FieldSample(cell[:, :stacks.n_wind_ch],
                           cell[:, stacks.n_wind_ch:-2],
                           cell[:, -2], cell[:, -1])
    geo = interp.bilinear_packed(stacks.land_geo4, stacks.land_grid,
                                 lon, lat)
    if stacks.fused_geo:
        bathy = geo[:, 1]
    else:
        bathy = interp.bilinear_packed(stacks.bathy4, stacks.bathy_grid,
                                       lon, lat)[:, 0]
    return FieldSample(cell[:, :stacks.n_wind_ch],
                       cell[:, stacks.n_wind_ch:], geo[:, 0], bathy)


SECONDS_PER_MONTH = 30.44 * 86400.0     # mean month, plane-interp time axis


def sample_fields_at_time(stacks: F.GatherStacks, cfg: Namelist, lon, lat,
                          plane, t) -> FieldSample:
    """Field sample with optional linear time interpolation between monthly
    planes (cfg.time_interp_fields; genesis anchored at the seed month's
    mid-month plane, so plane p blends toward p+1 as the track ages)."""
    if not cfg.time_interp_fields:
        return sample_fields(stacks, lon, lat, plane)
    n_planes = stacks.cell4.shape[0]
    tau = jnp.clip(t / SECONDS_PER_MONTH, 0.0, 1.0)
    p1 = jnp.minimum(plane + 1, n_planes - 1)
    s0 = sample_fields(stacks, lon, lat, plane)
    if stacks.geo_in_cell:
        s1 = sample_fields(stacks, lon, lat, p1)
    else:
        # land/bathy are plane-independent: re-gather only the per-plane
        # cell row for p1 (the loop is gather-row-bound; a second geo
        # gather would lerp two identical values at real cost)
        cell = interp.bilinear_packed(stacks.cell4, stacks.grid, lon, lat,
                                      p1)
        s1 = FieldSample(cell[:, :stacks.n_wind_ch],
                         cell[:, stacks.n_wind_ch:], s0.land, s0.bathy)
    tau = jnp.broadcast_to(jnp.asarray(tau, s0.env.dtype), lon.shape)
    return FieldSample(
        s0.wind_stats + tau[:, None] * (s1.wind_stats - s0.wind_stats),
        s0.env + tau[:, None] * (s1.env - s0.env),
        s0.land + tau * (s1.land - s0.land),
        s0.bathy + tau * (s1.bathy - s0.bathy))


def bam_velocity(cfg: Namelist, lat, v, wnds_raw):
    """Beta-advection velocity with the polar hard stop
    (track/bam_track.py:131-144).  Returns (u_bam, v_bam, wnds)."""
    polar = jnp.abs(lat) >= 80.0
    wnds = jnp.where(polar[:, None], 0.0, wnds_raw)
    coefs = steering_coefs(cfg, v)
    w_lat = jnp.cos(jnp.deg2rad(lat))
    hi = jax.lax.Precision.HIGHEST
    u_steer = jnp.einsum('nl,nl->n', wnds[:, 0::2], coefs, precision=hi)
    v_steer = jnp.einsum('nl,nl->n', wnds[:, 1::2], coefs, precision=hi)
    u_bam = jnp.where(polar, 0.0, u_steer + cfg.u_beta * w_lat)
    v_bam = jnp.where(polar, 0.0,
                      v_steer + jnp.sign(lat) * cfg.v_beta * w_lat)
    return u_bam, v_bam, wnds


def rhs_given_winds(cfg: Namelist, t, y: State, params: SeedParams,
                    smp: FieldSample, wnds_raw, drv=None
                    ) -> Tuple[State, jnp.ndarray]:
    """Coupled tendency (coupled_fast.py:196-207) given gathered fields and
    already-colored environmental winds (the stage-independent parts of one
    step; steering weights, ocean feedback and the ODEs below remain exact
    per RK stage).  drv: optional DerivedSample hoisting the field-only
    derivations (t_strat pow, land masks) out of the stage loop."""
    lon, lat, v, m = y
    env = smp.env
    land_val = smp.land
    bathy_val = smp.bathy

    u_bam, v_bam, wnds = bam_velocity(cfg, lat, v, wnds_raw)
    u_T = jnp.sqrt(u_bam ** 2 + v_bam ** 2)
    alpha, v_pot = ocean_alpha(cfg, env, land_val, bathy_val, u_T, v, drv)
    gamma = EPSILON + alpha * KAPPA

    ck_2h = 0.5 * cfg.Ck / params.h_bl
    m3 = m ** 3
    dvdt = ck_2h * (alpha * BETA * v_pot ** 2 * m3 - (1 - gamma * m3) * v ** 2)
    dvdt = jnp.nan_to_num(dvdt)          # coupled_fast.py:150

    S = shear_magnitude(cfg, wnds)
    venti = S * env[:, F.CHI]
    dmdt = ck_2h * ((1 - m) * v - venti * m)

    rad = 180.0 / jnp.pi / constants.earth_R
    dlon = u_bam * rad / jnp.cos(jnp.deg2rad(lat))
    dlat = v_bam * rad
    if cfg.debug_fixed_position:
        # intensity-only integration (coupled_fast.py:204-205)
        dlon = jnp.zeros_like(dlon)
        dlat = jnp.zeros_like(dlat)
    return State(dlon, dlat, dvdt, dmdt), wnds


def rhs_from_sample(cfg: Namelist, t, y: State, params: SeedParams,
                    smp: FieldSample) -> Tuple[State, jnp.ndarray]:
    """Coupled tendency with per-call wind coloring (the exact per-stage
    form; the default integrator colors once per step instead)."""
    wnds = color_winds(cfg, smp.wind_stats, params.fourier, t)
    return rhs_given_winds(cfg, t, y, params, smp, wnds)


def rhs(stacks: F.GatherStacks, cfg: Namelist, t, y: State,
        params: SeedParams) -> Tuple[State, jnp.ndarray]:
    """Full coupled tendency: gather at y's position (and track time, when
    time interpolation is on), then dynamics.
    Returns (dy/dt as a State of tendencies, sampled winds [N, W])."""
    smp = sample_fields_at_time(stacks, cfg, y.lon, y.lat, params.plane, t)
    return rhs_from_sample(cfg, t, y, params, smp)


def init_m_dvdt0(pack: F.FieldPack, cfg: Namelist, lon, lat, v,
                 params: SeedParams, dvdt=0.0):
    """m initialization by dv/dt = dvdt inversion (coupled_fast.py:152-167),
    the reference's fallback when ``gen_track`` receives no m:

        m = clip(cbrt((2 h_bl/Ck dvdt + v^2)
                      / (alpha beta vpot_5^2 + gamma v^2)), 0, 1)

    with vpot_5 the max of the (land-zeroed) potential intensity over the
    seed point and the four (+/-0.25 deg, +/-0.25 deg) corners, and alpha
    evaluated with the BAM translation speed at t=0.  Batched [N]."""
    stats = interp.bilinear(pack.wind, pack.grid, lon, lat, params.plane)
    wnds = color_winds(cfg, stats, params.fourier, jnp.asarray(0.0))
    u_bam, v_bam, _ = bam_velocity(cfg, lat, v, wnds)
    u_T = jnp.sqrt(u_bam ** 2 + v_bam ** 2)

    def vpot_at(lo, la):
        env = interp.bilinear(pack.env, pack.grid, lo, la, params.plane)
        land = interp.bilinear_scalar(pack.land, pack.land_grid, lo, la)
        return jnp.where(_is_land(land), 0.0, env[:, F.VPOT])

    vpot5 = vpot_at(lon, lat)
    for dx, dy in ((-0.25, -0.25), (-0.25, 0.25), (0.25, -0.25),
                   (0.25, 0.25)):
        vpot5 = jnp.maximum(vpot5, vpot_at(lon + dx, lat + dy))

    env_c = interp.bilinear(pack.env, pack.grid, lon, lat, params.plane)
    land_c = interp.bilinear_scalar(pack.land, pack.land_grid, lon, lat)
    bathy_c = interp.bilinear_scalar(pack.bathy, pack.bathy_grid, lon, lat)
    alpha, _ = ocean_alpha(cfg, env_c, land_c, bathy_c, u_T, v)
    gamma = EPSILON + alpha * KAPPA

    numer = 2.0 * params.h_bl / cfg.Ck * dvdt + v ** 2
    denom = alpha * BETA * vpot5 ** 2 + gamma * v ** 2
    return jnp.clip(jnp.cbrt(numer / denom), 0.0, 1.0)


def ventilation_index_reject(stacks: F.GatherStacks, cfg: Namelist,
                             y0: State, params: SeedParams):
    """Genesis gate: reject when S * chi / v_pot >= 1 at t=0 with v_pot > 0
    (coupled_fast.py:237-244).  Returns a boolean keep-mask [N]."""
    # note: the reference samples winds directly (no polar zeroing) here
    smp = sample_fields(stacks, y0.lon, y0.lat, params.plane)
    wnds = color_winds(cfg, smp.wind_stats, params.fourier, jnp.asarray(0.0))
    S = shear_magnitude(cfg, wnds)
    v_pot = jnp.where(_is_land(smp.land), 0.0, smp.env[:, F.VPOT])
    vent = S * smp.env[:, F.CHI] / v_pot
    return ~((v_pot > 0) & (vent >= 1.0))
