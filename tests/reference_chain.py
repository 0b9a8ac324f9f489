"""Sequential reference-style downscaling chain in NumPy/SciPy.

An independent, scalar, solve_ivp-based implementation of the reference
pipeline's seed -> integrate -> filter chain, used ONLY to establish
whole-chain statistical parity of the JAX pipeline.

Reference call path being reproduced (cited per stage below):
  util/compute.py:134-175   rejection-sampling seed loop
  track/bam_track.py:23-42  Fourier synthetic-wind series
  track/bam_track.py:93-144 spline wind sampling + Cholesky coloring + BAM
  intensity/coupled_fast.py:65-207,229-267  FAST ODEs, gates, solve_ivp RK45
  util/compute.py:185-209   TC filters
  wind/tc_wind.py:6-21      axi_to_max_wind
  util/sphere.py:15-83      haversine / translational speed

Everything here runs on a FieldPack's arrays through RectBivariateSpline
(kx=ky=1) interpolants — the same data the JAX pipeline gathers — so any
statistical divergence between the two chains isolates implementation error
rather than input differences.
"""

from __future__ import annotations

import dataclasses

import numpy as np
from scipy.integrate import solve_ivp
from scipy.interpolate import RectBivariateSpline

EPSILON = 0.33
KAPPA = 0.1
BETA = 1.0 - EPSILON - KAPPA
MS_TO_KTS = 1.94384
EARTH_R = 6371.0  # km (util/constants.py)
N_FOURIER = 15


def _spl(grid, field2d):
    """kx=ky=1 spline on a UniformGrid field (reference interp2_fx,
    util/mat.py:142-153)."""
    return RectBivariateSpline(grid.lon_axis(), grid.lat_axis(),
                               np.asarray(field2d).T, kx=1, ky=1)


def haversine(lon1, lat1, lon2, lat2):
    """Great-circle km (util/sphere.py:15-30)."""
    p1, p2 = np.deg2rad(lat1), np.deg2rad(lat2)
    dp = p2 - p1
    dl = np.deg2rad(lon2 - lon1)
    a = np.sin(dp / 2) ** 2 + np.cos(p1) * np.cos(p2) * np.sin(dl / 2) ** 2
    return 2 * EARTH_R * np.arcsin(np.sqrt(a))


def translational_speed(lon, lat, dt_s):
    """Centered-difference translation m/s with edge extrapolation
    (util/sphere.py:58-83)."""
    e_lon = np.concatenate([[2 * lon[0] - lon[1]], lon,
                            [2 * lon[-1] - lon[-2]]])
    e_lat = np.concatenate([[2 * lat[0] - lat[1]], lat,
                            [2 * lat[-1] - lat[-2]]])
    dlon = 0.5 * (np.sign(e_lon[2:] - e_lon[:-2]) *
                  haversine(e_lon[2:], e_lat[1:-1], e_lon[:-2], e_lat[1:-1]))
    dlat = 0.5 * (np.sign(e_lat[2:] - e_lat[:-2]) *
                  haversine(e_lon[1:-1], e_lat[2:], e_lon[1:-1], e_lat[:-2]))
    return dlon * 1000.0 / dt_s, dlat * 1000.0 / dt_s


def axi_to_max_wind(lon, lat, dt, v, wnds, iu2=0, iv2=1, iu8=2, iv8=3):
    """wind/tc_wind.py:6-21 on one compact (valid-samples-only) track."""
    ut, vt = translational_speed(lon, lat, dt)
    G = np.minimum(1.0, 0.8 + 0.35 * (1.0 + np.tanh((lat - 35.0) / 10.0)))
    u_shr = wnds[:, iu2] - wnds[:, iu8]
    v_shr = wnds[:, iv2] - wnds[:, iv8]
    U_inc = G * ut + 0.1 * u_shr * v / 15.0
    V_inc = G * vt + 0.1 * v_shr * v / 15.0
    mag_inc = np.sqrt(U_inc ** 2 + V_inc ** 2)
    with np.errstate(divide='ignore', invalid='ignore'):
        mag_fac = np.minimum(1.0, (v * 0.50) / mag_inc)
    theta = np.arctan2(-U_inc, V_inc)
    ug = v * -np.sin(theta) + U_inc * mag_fac
    vg = v * np.cos(theta) + V_inc * mag_fac
    return np.sqrt(ug ** 2 + vg ** 2)


class _Fourier:
    """gen_f series (track/bam_track.py:23-31): N=15 sines, amplitudes
    c_n = sqrt(2 / sum n^-3) n^-1.5, random phases, period T seconds."""

    def __init__(self, rng, n_series, T_s):
        n = np.arange(1, N_FOURIER + 1)
        self.c = np.sqrt(2.0 / np.sum(n ** -3.0)) * n ** -1.5
        self.n = n
        self.T = T_s
        self.phi = rng.uniform(0.0, 1.0, size=(n_series, N_FOURIER))

    def eval(self, t):
        arg = 2 * np.pi * (self.n[None] * t / self.T + self.phi)
        return np.sum(self.c[None] * np.sin(arg), axis=1)


@dataclasses.dataclass
class RefTrack:
    lon: np.ndarray
    lat: np.ndarray
    v: np.ndarray
    m: np.ndarray
    wnds: np.ndarray
    vmax: np.ndarray
    month: int
    basin_idx: int


class ReferenceChain:
    """Spline interpolants over a FieldPack + the sequential chain."""

    def __init__(self, pack, cfg, basin_id='GL'):
        from tropical_cyclone_risk_tpu.utils import basins as basins_mod
        self.cfg = cfg
        self.bounds = basins_mod.basin_bounds(cfg, basin_id)
        self.f_run = _spl(pack.mask_grid, np.asarray(pack.run_mask))
        masks = np.asarray(pack.basin_masks)
        self.f_basins = [_spl(pack.mask_grid, masks[:, :, b])
                         for b in range(masks.shape[-1])]
        env = np.asarray(pack.env)       # [P, lat, lon, 5] chi vpot mld strat rh
        wind = np.asarray(pack.wind)     # [P, lat, lon, W + W(W+1)/2]
        self.n_planes = env.shape[0]
        self.W = cfg.n_wind_levels
        g = pack.grid
        self.f_env = [[_spl(g, env[p, :, :, c]) for c in range(5)]
                      for p in range(self.n_planes)]
        self.f_wnd = [[_spl(g, wind[p, :, :, c])
                       for c in range(wind.shape[-1])]
                      for p in range(self.n_planes)]
        self.f_land = _spl(pack.land_grid, np.asarray(pack.land))
        self.f_bathy = _spl(pack.bathy_grid, np.asarray(pack.bathy))
        self.powers = cfg.lat_vort_power_by_basin()
        self.h_bls = cfg.h_bl_by_basin()

    # ---- per-point physics (scalar) ----

    def _env_winds(self, plane, lon, lat, F):
        """mean + Cholesky(cov) @ F (track/bam_track.py:93-128)."""
        W = self.W
        vals = np.array([f.ev(lon, lat) for f in self.f_wnd[plane]])
        mean = vals[:W]
        cov = np.zeros((W, W))
        k = W
        for i in range(W):
            for j in range(i + 1):
                cov[i, j] = cov[j, i] = vals[k]
                k += 1
        try:
            L = np.linalg.cholesky(cov)
            return mean + L @ F
        except np.linalg.LinAlgError:       # bam_track.py:123-126
            return np.zeros(W)

    def _dydt(self, t, y, plane, h_bl, fourier):
        """Full coupled RHS (coupled_fast.py:196-207)."""
        cfg = self.cfg
        lon, lat, v, m = y
        if abs(lat) >= 80.0:                # bam_track.py:131-135
            wnds = np.zeros(self.W)
            u_bam = v_bam = 0.0
        else:
            wnds = self._env_winds(plane, lon, lat, fourier.eval(t))
            if cfg.coupled_track:           # coupled_fast.py:183-192
                a = np.asarray(cfg.y_alpha) + \
                    np.asarray(cfg.m_alpha) * (v * MS_TO_KTS)
                a = np.clip(a, cfg.alpha_min, cfg.alpha_max)
                a = np.where(np.isnan(a), cfg.y_alpha, a)
            else:
                a = np.asarray(cfg.steering_coefs)
            w_lat = np.cos(np.deg2rad(lat))
            u_bam = float(np.dot(wnds[0::2], a)) + cfg.u_beta * w_lat
            v_bam = float(np.dot(wnds[1::2], a)) + \
                np.sign(lat) * cfg.v_beta * w_lat

        chi = float(self.f_env[plane][0].ev(lon, lat))
        vpot = float(self.f_env[plane][1].ev(lon, lat))
        mld = float(self.f_env[plane][2].ev(lon, lat))
        strat = float(self.f_env[plane][3].ev(lon, lat))
        land = float(self.f_land.ev(lon, lat))
        bathy = float(self.f_bathy.ev(lon, lat))
        if land >= 1.0 - 1e-5:
            vpot = 0.0

        # ocean feedback alpha (coupled_fast.py:65-94)
        u_T = np.hypot(u_bam, v_bam)
        if bathy >= 0 or -mld <= bathy or strat == 0:
            alpha = 1.0
        else:
            z = 0.01 * strat ** -0.4 * mld * u_T * vpot / v
            alpha = 1.0 - 0.87 * np.exp(-np.clip(z, 0.0, 100.0))
        gamma = EPSILON + alpha * KAPPA

        ck_2h = 0.5 * self.cfg.Ck / h_bl
        m3 = m ** 3
        dvdt = ck_2h * (alpha * BETA * vpot ** 2 * m3
                        - (1 - gamma * m3) * v ** 2)
        if np.isnan(dvdt):                  # coupled_fast.py:150
            dvdt = 0.0
        S = np.hypot(wnds[0] - wnds[2], wnds[1] - wnds[3])
        dmdt = ck_2h * ((1 - m) * v - S * chi * m)

        rad = 180.0 / np.pi / (EARTH_R * 1000.0)
        dlon = u_bam * rad / np.cos(np.deg2rad(lat))
        dlat = v_bam * rad
        return [dlon, dlat, dvdt, dmdt]

    def _event(self, t, y, *args):
        """Terminal dissipation event (coupled_fast.py:246-256)."""
        lo0, la0, lo1, la1 = self.bounds
        lon, lat, v, _ = y
        return min(lon - (lo0 + 1), (lo1 - 1) - lon,
                   lat - (la0 + 1), (la1 - 1) - lat,
                   abs(lat) - 2.0, v - 4.0)
    _event.terminal = True

    def gen_track(self, rng, lon0, lat0, v0, m0, plane, h_bl):
        """coupled_fast.py:229-267: Fourier draws, ventilation-index genesis
        gate, solve_ivp RK45 with hourly t_eval.  Returns None if gated."""
        cfg = self.cfg
        fourier = _Fourier(rng, self.W, cfg.T_fourier_s)
        # genesis gate (coupled_fast.py:237-244)
        wnds0 = self._env_winds(plane, lon0, lat0, fourier.eval(0.0))
        S0 = np.hypot(wnds0[0] - wnds0[2], wnds0[1] - wnds0[3])
        chi0 = float(self.f_env[plane][0].ev(lon0, lat0))
        vpot0 = float(self.f_env[plane][1].ev(lon0, lat0))
        if float(self.f_land.ev(lon0, lat0)) >= 1.0 - 1e-5:
            vpot0 = 0.0
        if vpot0 > 0 and S0 * chi0 / vpot0 >= 1.0:
            return None
        T = cfg.total_track_time_s
        t_eval = np.arange(0, T + 1, cfg.output_interval_s, dtype=float)
        ev = lambda t, y, *a: self._event(t, y)
        ev.terminal = True
        res = solve_ivp(self._dydt, (0.0, float(T)), [lon0, lat0, v0, m0],
                        t_eval=t_eval, max_step=86400.0,
                        args=(plane, h_bl, fourier), events=ev)
        lon, lat, v, m = res.y
        # env winds re-evaluated along the track (util/compute.py:198-202)
        wnds = np.stack([self._env_winds(plane, lon[i], lat[i],
                                         fourier.eval(res.t[i]))
                         if abs(lat[i]) < 80 else np.zeros(self.W)
                         for i in range(len(res.t))])
        return res.t, lon, lat, v, m, wnds

    # ---- the chain ----

    def run(self, rng, n_seeds, progress=None):
        """The rejection-sampling seed loop (util/compute.py:134-209) for
        n_seeds counted seeds.  Returns (tracks, n_counted, n_integrated)
        where tracks are the surviving RefTrack objects."""
        cfg = self.cfg
        b = self.bounds
        tracks = []
        n_counted = n_integrated = 0
        # per-(basin, month) counted-seed tally — the seeds_per_month
        # output variable (util/compute.py:163-175 counting semantics)
        self.counted_by_bm = np.zeros((len(self.f_basins), 12), np.int64)
        while n_counted < n_seeds:
            # area-weighted first draw over the genesis belt
            lat_min = 3.0 if np.sign(b[1]) >= 0 else -45.0
            lat_max = 45.0 if np.sign(b[3]) >= 0 else -3.0
            y0, y1 = np.sin(np.deg2rad([lat_min, lat_max]))
            lon = rng.uniform(b[0], b[2])
            lat = np.rad2deg(np.arcsin(rng.uniform(y0, y1)))
            while self.f_run.ev(lon, lat) < 1e-2:     # ocean/basin redraws
                lon = rng.uniform(b[0], b[2])
                lat = rng.uniform(b[1], b[3])
            month = int(rng.integers(1, 13))
            basin_val = np.array([f.ev(lon, lat) for f in self.f_basins])
            b_idx = int(np.argmax(basin_val))
            p_lowlat = min(max((abs(lat) - cfg.lat_vort_fac) / 12.0, 0), 1) \
                ** self.powers[b_idx]
            if not (basin_val.max() > 1e-3 and rng.uniform() < p_lowlat):
                continue
            n_counted += 1
            self.counted_by_bm[b_idx, month - 1] += 1
            plane = month - cfg.start_month
            if not (0 <= plane < self.n_planes):
                continue
            if float(self.f_env[plane][1].ev(lon, lat)) <= 35.0:  # PI gate
                continue
            n_integrated += 1
            v0 = cfg.seed_v_init_ms + rng.standard_normal()
            rh = float(self.f_env[plane][4].ev(lon, lat))
            m0 = max(0.0, cfg.m_init_amp / (
                1.0 + np.exp(-(rh - cfg.m_init_mid) * cfg.m_init_slope))
                + cfg.m_init_base)
            h_bl = self.h_bls[b_idx]
            out = self.gen_track(rng, lon, lat, v0, m0, plane, h_bl)
            if out is None:
                continue
            t, tlon, tlat, tv, tm, wnds = out
            # TC filters (util/compute.py:185-189): peak v and v at 2 days
            # (np.interp clamps to the last sample for early deaths)
            if tv.max() < cfg.seed_v_threshold_ms:
                continue
            v_2d = np.interp(2 * 86400.0, t, tv)
            if v_2d < cfg.seed_v_2d_threshold_ms:
                continue
            vmax = axi_to_max_wind(tlon, tlat, float(cfg.output_interval_s),
                                   tv, wnds)
            if vmax.max() < cfg.seed_vmax_threshold_ms:   # compute.py:205-209
                continue
            tracks.append(RefTrack(tlon, tlat, tv, tm, wnds, vmax,
                                   month, b_idx))
            if progress and len(tracks) % 25 == 0:
                progress(len(tracks), n_counted)
        return tracks, n_counted, n_integrated
