"""Track diagnostics: azimuthal -> maximum wind conversion.

Reference equivalent: wind/tc_wind.py:6-21 (axi_to_max_wind) applied per
track; here batched over [N, T] padded track buffers.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from tropical_cyclone_risk_tpu import constants
from tropical_cyclone_risk_tpu.config import Namelist
from tropical_cyclone_risk_tpu.ops import sphere


def _extrapolate_nan_tail(x):
    """Replace the NaN tail of each track with linear extrapolation from the
    last two valid samples (scan along time).  Reproduces the reference's
    edge handling: its translational-speed centered difference linearly
    extrapolates positions past the end of the (compact) valid window
    (util/sphere.py:66-69), which our NaN-padded buffers would otherwise
    turn into a NaN speed at each track's final valid sample."""
    x_t = jnp.moveaxis(x, -1, 0)                      # [T, ...]

    def fill(carry, xt):
        prev, delta = carry
        bad = jnp.isnan(xt)
        cur = jnp.where(bad, prev + delta, xt)
        new_delta = jnp.where(bad, delta, cur - prev)
        return (cur, new_delta), cur

    init = (x_t[0], jnp.zeros_like(x_t[0]))
    _, filled = jax.lax.scan(fill, init, x_t)
    return jnp.moveaxis(filled, 0, -1)


def axi_to_max_wind(track_lon, track_lat, dt_track, tc_v, env_wnds,
                    cfg=None):
    """Maximum wind from azimuthal wind + translation + shear asymmetries.

    track_lon/lat/tc_v: [..., T]; env_wnds: [..., T, W] in
    (u_l1, v_l1, u_l2, v_l2, ...) channel order; cfg resolves which
    channels are the 250/850 hPa shear layers (defaults to the two-level
    layout).  NaN samples beyond a track's death yield NaN vmax (NaN
    env_wnds propagate), matching the reference's NaN-padded output
    buffers; the final valid sample gets the reference's edge extrapolation
    rather than NaN.
    """
    if cfg is not None:
        from tropical_cyclone_risk_tpu.models.fast import deep_layer_indices
        iu2, iv2, iu8, iv8 = deep_layer_indices(cfg)
    else:
        iu2, iv2, iu8, iv8 = 0, 1, 2, 3
    # one fused fill scan for both coordinates (they share the NaN tail)
    pos = jnp.stack([track_lon, track_lat], axis=0)
    pos = _extrapolate_nan_tail(pos)
    utran, vtran = sphere.translational_speed(pos[0], pos[1], dt_track)
    G = jnp.minimum(1.0, 0.8 + 0.35 * (1.0 + jnp.tanh((track_lat - 35.0) / 10.0)))
    u_shr = env_wnds[..., iu2] - env_wnds[..., iu8]
    v_shr = env_wnds[..., iv2] - env_wnds[..., iv8]
    U_inc = G * utran + 0.1 * u_shr * tc_v / 15.0
    V_inc = G * vtran + 0.1 * v_shr * tc_v / 15.0

    mag_inc = jnp.sqrt(U_inc ** 2 + V_inc ** 2)
    return _vmax_from_inc(tc_v, mag_inc)


def _vmax_from_inc(tc_v, mag_inc):
    """vmax = tc_v + min(mag_inc, 0.5 * tc_v): the closed form of the
    reference's optimal-azimuth construction (wind/tc_wind.py:14-21).  With
    r = |inc| and theta = atan2(-U_inc, V_inc), sin(theta) = -U_inc/r and
    cos(theta) = V_inc/r, so ug = U_inc (v/r + fac) and vg = V_inc (v/r +
    fac); hence sqrt(ug^2 + vg^2) = v + r fac = v + min(r, 0.5 v) exactly.
    Dropping the atan2/sin/cos/final-sqrt chain halves the per-row
    transcendental count of the launch's vmax pass; values agree with the
    trig form to float32 rounding (the differential test's rtol 2e-3 and the
    launch identity tests' atol 1e-4 both hold), and NaN samples still
    propagate through mag_inc -> minimum."""
    return tc_v + jnp.minimum(mag_inc, 0.5 * tc_v)


def _translation_tm(lon, lat, lon_prev, lat_prev, lon_next, lat_next, dt_s):
    """Centered-difference translation speed (m/s) given explicit previous /
    next positions, time-major [T, N] (ops.sphere.translational_speed with
    the neighbor construction factored out).

    The two haversines are specialized to their degenerate calls — the zonal
    distance has EQUAL latitudes (sin^2(dlat/2) is exactly 0.0 and the two
    cos(lat) factors are the same value) and the meridional distance EQUAL
    longitudes — and then the arcsin chains collapse (r5; this pass runs
    over every launch row, ~6.7M/launch, where it was ~40% of the vmax
    diagnostic's cost):

    - zonal ``2 asin(cos(lat) |sin(dl2)|)``: the argument is the half
      great-circle chord of ONE step's zonal displacement, physically
      bounded by ~(40 m/s * 2 dt)/(2 R) ~ 0.05, so the 3-term odd series
      ``asin(s) = s (1 + s^2 (1/6 + 3 s^2/40))`` is float32-exact (rel
      truncation 15 s^6/336 < 1 ulp for s <= 0.12 ~ a 105 m/s
      translation; beyond that it degrades gracefully at ~1e-5 relative) —
      dropping the arcsin and the sqrt of the squared form;
    - meridional ``2 asin(|sin(dp2)|) == 2 |dp2|`` exactly (|dp2| <= pi/2
      always) — dropping sin, sqrt, and arcsin.

    Agreement with sphere.haversine is ~1 ulp of the arc (~0.1 m, sub-1e-4
    m/s on vmax, far inside the differential tests' 2e-3 tolerance and the
    in-scan/standalone identity tests' 1e-4)."""
    km = constants.earth_R / 1000.0
    # zonal: haversine(lon_next, lat, lon_prev, lat)
    la = jnp.deg2rad(lat)
    dl2 = (jnp.deg2rad(lon_prev) - jnp.deg2rad(lon_next)) / 2
    s = jnp.cos(la) * jnp.abs(jnp.sin(dl2))
    s2 = jnp.square(s)
    hav_lon = km * 2 * (s * (1.0 + s2 * (1.0 / 6.0 + s2 * (3.0 / 40.0))))
    # meridional: haversine(lon, lat_next, lon, lat_prev)
    dp2 = (jnp.deg2rad(lat_prev) - jnp.deg2rad(lat_next)) / 2
    hav_lat = km * 2 * jnp.abs(dp2)
    dlon = 0.5 * (jnp.sign(lon_next - lon_prev) * hav_lon)
    dlat = 0.5 * (jnp.sign(lat_next - lat_prev) * hav_lat)
    return dlon * 1000.0 / dt_s, dlat * 1000.0 / dt_s


def _shear_channels(cfg):
    if cfg is not None:
        from tropical_cyclone_risk_tpu.models.fast import deep_layer_indices
        return deep_layer_indices(cfg)
    return 0, 1, 2, 3


def vmax_step(cfg, lat, tc_v, env_wnds, ut, vt):
    """vmax of one output sample from values live in the integration scan
    (wind/tc_wind.py:6-21 via the closed form _vmax_from_inc): lat/tc_v [N],
    env_wnds [N, W], ut/vt [N] the centered-difference translation.  The
    in-scan vmax path (Namelist.vmax_in_scan) evaluates this once per step
    while positions and winds are still in registers, replacing the
    standalone [T, m] axi_to_max_wind_raw pass that re-read every launch
    buffer from device memory."""
    iu2, iv2, iu8, iv8 = _shear_channels(cfg)
    G = jnp.minimum(1.0, 0.8 + 0.35 * (1.0 + jnp.tanh((lat - 35.0) / 10.0)))
    u_shr = env_wnds[..., iu2] - env_wnds[..., iu8]
    v_shr = env_wnds[..., iv2] - env_wnds[..., iv8]
    U_inc = G * ut + 0.1 * u_shr * tc_v / 15.0
    V_inc = G * vt + 0.1 * v_shr * tc_v / 15.0
    mag_inc = jnp.sqrt(U_inc ** 2 + V_inc ** 2)
    return _vmax_from_inc(tc_v, mag_inc)


def fix_last_sample(vmax_tm, lon, lat, tc_v, env_wnds, alive, last_step,
                    dt_s, cfg=None, pos_before=None):
    """Apply the reference's edge extrapolation to each track's FINAL valid
    sample of an in-scan vmax buffer (segment-local; the in-scan twin of
    axi_to_max_wind_raw's last_step fix-up).

    The in-scan translation at a track's last valid sample L uses the real
    next position (the integrator keeps stepping before the alive mask
    freezes), but the reference's valid window ENDS at L and its centered
    difference linearly extrapolates past the end (util/sphere.py:66-69).
    Re-derive sample L's vmax with the extrapolated neighbor
    pos[L] + (pos[L] - pos[L-1]) and scatter it back — one [N]-row pass
    against the scan's [T, N] buffers.

    last_step is segment-local: values outside [0, T) mean the track's
    life ended in another segment, and such rows are left untouched.
    Returns (vmax fixed [T, N], vmax_L [N], ok [N]) where ok flags tracks
    whose final valid sample lies in THIS segment (their vmax_L must enter
    the lifetime peak; everything else in the peak comes from the scan's
    running maximum, which excludes final samples by construction)."""
    T = lon.shape[0]
    Lc = jnp.clip(last_step, 0, T - 1)
    take = lambda x: jnp.take_along_axis(x, Lc[None, :], axis=0)[0]
    L = last_step
    Lm1 = jnp.clip(L - 1, 0, T - 1)
    takem = lambda x: jnp.take_along_axis(x, Lm1[None, :], axis=0)[0]
    lon_L, lat_L = take(lon), take(lat)
    lon_P, lat_P = takem(lon), takem(lat)
    if pos_before is not None:
        # a track whose last valid sample is this segment's row 0 reaches
        # one row back across the boundary for its extrapolation base
        lon_P = jnp.where(L == 0, pos_before[0], lon_P)
        lat_P = jnp.where(L == 0, pos_before[1], lat_P)
    ut_L, vt_L = _translation_tm(lon_L, lat_L, lon_P, lat_P,
                                 lon_L + (lon_L - lon_P),
                                 lat_L + (lat_L - lat_P), dt_s)
    wnds_L = jnp.take_along_axis(env_wnds, Lc[None, :, None], axis=0)[0]
    vmax_L = vmax_step(cfg, lat_L, take(tc_v), wnds_L, ut_L, vt_L)
    ok = (L >= 0) & (L < T) & take(alive)
    cols = jnp.arange(lon.shape[1])
    fixed = vmax_tm.at[Lc, cols].set(
        jnp.where(ok, vmax_L, vmax_tm[Lc, cols]), mode='drop')
    return fixed, vmax_L, ok


def axi_to_max_wind_raw(lon, lat, dt_track, tc_v, env_wnds, alive,
                        last_step, cfg=None, pos_before=None,
                        pos_after=None):
    """axi_to_max_wind over time-major UNMASKED buffers (simulator.RawTracks
    layout), returning (vmax [T, N] valid where alive, peak [N]).

    Replaces the sequential NaN-tail extrapolation scan of the masked path
    with an elementwise fix-up: samples past death hold the frozen death
    state, so centered differences are already exact at every valid sample
    except each track's last (where the frozen next position halves the
    difference); that one sample per track gets the reference's linear edge
    extrapolation (util/sphere.py:66-69) via a gather at last_step.  peak is
    the alive-masked lifetime maximum (util/compute.py:205 nanmax input).

    Segmented launches (pipeline.launch_body re-compaction) call this per
    segment: pos_before/pos_after ([2, N] lon/lat rows) supply the sample
    neighboring the segment's first/last row, and last_step is the
    segment-local index of each track's final valid sample — out-of-segment
    values (negative or >= T) simply never trigger the end fix-up, which is
    exactly right for a track that ends in the other segment."""
    if cfg is not None:
        from tropical_cyclone_risk_tpu.models.fast import deep_layer_indices
        iu2, iv2, iu8, iv8 = deep_layer_indices(cfg)
    else:
        iu2, iv2, iu8, iv8 = 0, 1, 2, 3

    # neighbor positions: start-edge linear extrapolation as in
    # translational_speed (or the caller-supplied boundary sample); the end
    # edge is covered by the last_step fix-up (frozen buffers make
    # pos[T] == pos[T-1] == ... past death)
    first = (lambda x, b: jnp.concatenate([b[None], x[:-1]], axis=0))
    if pos_before is None:
        pad0 = lambda x: first(x, 2 * x[0] - x[1])
        lon_b, lat_b = pad0(lon), pad0(lat)
    else:
        lon_b, lat_b = first(lon, pos_before[0]), first(lat, pos_before[1])
    lastr = (lambda x, a: jnp.concatenate([x[1:], a[None]], axis=0))
    if pos_after is None:
        lon_a, lat_a = lastr(lon, lon[-1]), lastr(lat, lat[-1])
    else:
        lon_a, lat_a = lastr(lon, pos_after[0]), lastr(lat, pos_after[1])
    ut, vt = _translation_tm(lon, lat, lon_b, lat_b, lon_a, lat_a, dt_track)

    # per-track fix-up at the last valid sample L: next position is the
    # linear extrapolation pos[L] + (pos[L] - pos[L-1])
    take = lambda x, i: jnp.take_along_axis(
        x, jnp.clip(i, 0, x.shape[0] - 1)[None, :], axis=0)[0]
    L = last_step
    Lm1 = jnp.maximum(L - 1, 0)
    lon_L, lat_L = take(lon, L), take(lat, L)
    lon_P, lat_P = take(lon, Lm1), take(lat, Lm1)
    if pos_before is not None:
        # a track whose last valid sample is this segment's row 0 reaches
        # one row back across the boundary for its extrapolation base
        lon_P = jnp.where(L == 0, pos_before[0], lon_P)
        lat_P = jnp.where(L == 0, pos_before[1], lat_P)
    ut_L, vt_L = _translation_tm(lon_L, lat_L, lon_P, lat_P,
                                 lon_L + (lon_L - lon_P),
                                 lat_L + (lat_L - lat_P), dt_track)
    at_L = jnp.arange(lon.shape[0])[:, None] == L[None, :]
    ut = jnp.where(at_L, ut_L[None, :], ut)
    vt = jnp.where(at_L, vt_L[None, :], vt)

    G = jnp.minimum(1.0, 0.8 + 0.35 * (1.0 + jnp.tanh((lat - 35.0) / 10.0)))
    u_shr = env_wnds[..., iu2] - env_wnds[..., iu8]
    v_shr = env_wnds[..., iv2] - env_wnds[..., iv8]
    U_inc = G * ut + 0.1 * u_shr * tc_v / 15.0
    V_inc = G * vt + 0.1 * v_shr * tc_v / 15.0
    mag_inc = jnp.sqrt(U_inc ** 2 + V_inc ** 2)
    vmax = _vmax_from_inc(tc_v, mag_inc)
    peak = jnp.max(jnp.where(alive, vmax, -jnp.inf), axis=0)
    return vmax, peak


def vmax_filter(cfg: Namelist, vmax):
    """Lifetime-max filter (util/compute.py:205): keep if nanmax >= threshold.

    Reference-shaped API for one-shot callers; the fused launch inlines the
    same test on the raw-path peak (pipeline.launch_body)."""
    peak = jnp.nanmax(jnp.where(jnp.isnan(vmax), -jnp.inf, vmax), axis=-1)
    return peak >= cfg.seed_vmax_threshold_ms
