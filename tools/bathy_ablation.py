"""Quantify the bathymetry-proxy deviation.

The reference snapshot ships no bathymetry blob (.MISSING_LARGE_BLOBS:1),
so `preprocess/static.py:load_bathy` substitutes a land-derived proxy
(+100 m land / -4500 m ocean).  That silences the shallow-coastal-water
branch of the ocean-mixing feedback (`-mld <= bathy` in
`models/fast.py`; reference intensity/coupled_fast.py:70-73): over a real
continental shelf alpha is forced to 1 (no cold-wake weakening), so
coastal storms should run HOTTER than the proxy produces.

This tool measures that bound with paired launches (identical PRNG keys)
on the synthetic global environment: arm A uses the proxy bathymetry,
arm B an ETOPO-like synthetic shelf (land +100 m; depth ramps from -60 m
within 1 deg of any coast linearly down to -4500 m by 3 deg offshore,
computed by an exact Euclidean distance transform of the land mask).

Usage:  python tools/bathy_ablation.py [--launches 8] [--seed-batch 16384]
            [--json docs/bathy_ablation.json]
Writes one JSON report: per-arm survivor counts, LMI stats, landfall-vmax
stats, coastal-LMI stats, and paired deltas with across-launch SE.
"""

import argparse
import json
import sys
import os

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _ROOT)


def shelf_bathy(land: np.ndarray, lon: np.ndarray, lat: np.ndarray,
                shelf_deg: float = 1.0, slope_deg: float = 2.0,
                shelf_m: float = -60.0) -> np.ndarray:
    """ETOPO-like synthetic bathymetry from a land mask: shelf_m within
    shelf_deg of the coast, linear to -4500 m over the next slope_deg."""
    from scipy.ndimage import distance_transform_edt
    dlat = abs(lat[1] - lat[0])
    # distance (in cells) from the nearest land cell, over ocean
    d_cells = distance_transform_edt(land < 0.5)
    d_deg = d_cells * dlat                       # isotropic approximation
    far = shelf_deg + slope_deg
    depth = np.where(
        d_deg <= shelf_deg, shelf_m,
        np.where(d_deg >= far, -4500.0,
                 shelf_m + (d_deg - shelf_deg) / slope_deg
                 * (-4500.0 - shelf_m)))
    return np.where(land >= 0.5, 100.0, depth).astype(np.float32)


def branch_active_fraction(pack, bathy: np.ndarray) -> float:
    """Fraction of tropical ocean cells where the shallow-water branch
    forces alpha = 1 (bathy >= -mld; models/fast.py, reference
    coupled_fast.py:70-73), averaged over the 12 monthly planes."""
    env = np.asarray(pack.env)                     # [P, lat, lon, 5]
    mld = env[..., 2]
    land = np.asarray(pack.land)
    lat = pack.grid.lat_axis()
    trop = (np.abs(lat) <= 45.0)[None, :, None]
    ocean = (land < 0.5)[None] & trop
    active = ocean & (bathy[None] >= -mld) & (bathy[None] < 0)
    return float(active.sum() / max(ocean.sum(), 1))


def _stats(tr, k, f_land):
    vmax = np.asarray(tr['vmax'])[:k]
    lon = np.asarray(tr['lon'])[:k]
    lat = np.asarray(tr['lat'])[:k]
    with np.errstate(all='ignore'):
        lmi = np.nanmax(np.where(np.isfinite(vmax), vmax, -np.inf), axis=1)
    # landfall vmax: first sample with land fraction >= 0.5 after an
    # ocean sample (same detector as tools/chain_parity_report.py)
    lf = []
    coastal_lmi = []
    for j in range(k):
        fin = np.isfinite(lon[j]) & np.isfinite(lat[j])
        if not fin.any():
            continue
        landv = f_land.ev(lon[j][fin], lat[j][fin])
        hit = np.flatnonzero(landv >= 0.5)
        if hit.size and hit[0] > 0:
            lf.append(float(vmax[j][fin][hit[0]]))
        # coastal LMI: peak of a storm that ever comes within the shelf
        # band (land fraction > 0 anywhere along track is too strict on a
        # 1-deg mask; use distance via land>=0.5 within the track's
        # neighborhood — storms with any sample near the coast)
        if (landv >= 0.25).any():
            coastal_lmi.append(float(lmi[j]))
    return lmi, np.array(lf), np.array(coastal_lmi)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('--launches', type=int, default=8)
    ap.add_argument('--seed-batch', type=int, default=16384)
    ap.add_argument('--nlat', type=int, default=181)
    ap.add_argument('--nlon', type=int, default=360)
    ap.add_argument('--json', default=None)
    args = ap.parse_args(argv)

    import jax
    import jax.numpy as jnp
    from scipy.stats import ks_2samp
    from scipy.interpolate import RectBivariateSpline

    from tropical_cyclone_risk_tpu.config import Namelist
    from tropical_cyclone_risk_tpu.models import pipeline
    from tropical_cyclone_risk_tpu.models.fields import synthetic_pack

    cfg = Namelist(seed_batch=args.seed_batch)
    pack = synthetic_pack(cfg, n_planes=12, nlat=args.nlat,
                          nlon=args.nlon, seed=0)
    g = pack.bathy_grid
    land = np.asarray(pack.land)
    bathy_b = shelf_bathy(land, g.lon_axis(), g.lat_axis())
    # wide-shelf sensitivity arm: Gulf-of-Mexico / Yellow-Sea scale
    bathy_w = shelf_bathy(land, g.lon_axis(), g.lat_axis(),
                          shelf_deg=3.0, slope_deg=5.0, shelf_m=-40.0)
    pack_b = pack._replace(bathy=jnp.asarray(bathy_b))
    pack_w = pack._replace(bathy=jnp.asarray(bathy_w))
    f_land = RectBivariateSpline(pack.land_grid.lon_axis(),
                                 pack.land_grid.lat_axis(),
                                 land.T, kx=1, ky=1)

    arms = {'proxy': pack, 'shelf': pack_b, 'wide_shelf': pack_w}
    active_frac = {
        'proxy': branch_active_fraction(pack, np.asarray(pack.bathy)),
        'shelf': branch_active_fraction(pack, bathy_b),
        'wide_shelf': branch_active_fraction(pack, bathy_w),
    }
    res = {a: {'lmi': [], 'lf': [], 'coast': [], 'n': []} for a in arms}
    for i in range(args.launches):
        key = jax.random.key(500 + i)
        for a, pk in arms.items():
            tr, meta = pipeline._simulate_batch(
                key, pk, cfg, 'GL', cfg.seed_batch, 2048, jnp.int32(0))
            k = int(np.asarray(tr['valid']).sum())
            lmi, lf, coast = _stats(tr, k, f_land)
            res[a]['lmi'].append(lmi)
            res[a]['lf'].append(lf)
            res[a]['coast'].append(coast)
            res[a]['n'].append(k)
        print(f'launch {i}: proxy n={res["proxy"]["n"][-1]} '
              f'shelf n={res["shelf"]["n"][-1]}', file=sys.stderr)

    def sem(x):
        x = x[np.isfinite(x)]
        return float(np.std(x, ddof=1) / np.sqrt(x.size)) if x.size > 1 \
            else float('nan')

    def agg(a):
        return (np.concatenate(res[a]['lmi']), np.concatenate(res[a]['lf']),
                np.concatenate(res[a]['coast']), np.array(res[a]['n']))

    p_lmi, p_lf, p_coast, p_n = agg('proxy')
    report = {
        'n_launches': args.launches,
        'seed_batch': args.seed_batch,
        'shallow_branch_active_fraction': {
            a: round(f, 4) for a, f in active_frac.items()},
        'survivors_proxy': int(p_n.sum()),
        'lmi_mean_proxy': round(float(p_lmi.mean()), 3),
        'coastal_lmi_mean_proxy': round(float(p_coast.mean()), 3),
        'n_coastal_proxy': int(p_coast.size),
        'landfall_vmax_mean_proxy': round(float(p_lf.mean()), 3)
        if p_lf.size else None,
        'n_landfalls_proxy': int(p_lf.size),
    }
    for a in ('shelf', 'wide_shelf'):
        s_lmi, s_lf, s_coast, s_n = agg(a)
        # paired per-launch deltas (same keys -> same proposals;
        # differences are purely the bathymetry branch)
        d_n = (s_n - p_n).astype(float)
        d_lmi = np.array([np.mean(s) - np.mean(p) for s, p in
                          zip(res[a]['lmi'], res['proxy']['lmi'])])
        d_coast = np.array(
            [np.mean(s) - np.mean(p) if len(s) and len(p) else np.nan
             for s, p in zip(res[a]['coast'], res['proxy']['coast'])])
        report[a] = {
            'survivors': int(s_n.sum()),
            'survivor_delta_per_launch': round(float(d_n.mean()), 3),
            'survivor_delta_sem': sem(d_n),
            'lmi_mean': round(float(s_lmi.mean()), 3),
            'lmi_mean_delta': round(float(d_lmi.mean()), 4),
            'lmi_mean_delta_sem': sem(d_lmi),
            'ks_lmi_vs_proxy': round(
                float(ks_2samp(p_lmi, s_lmi).statistic), 4),
            'coastal_lmi_mean': round(float(s_coast.mean()), 3),
            'coastal_lmi_delta': round(float(np.nanmean(d_coast)), 4),
            'coastal_lmi_delta_sem': sem(d_coast),
            'n_coastal': int(s_coast.size),
            'landfall_vmax_mean': round(float(s_lf.mean()), 3)
            if s_lf.size else None,
            'ks_landfall_vmax_vs_proxy': round(
                float(ks_2samp(p_lf, s_lf).statistic), 4)
            if p_lf.size and s_lf.size else None,
            'n_landfalls': int(s_lf.size),
        }
    out = json.dumps(report, indent=1)
    if args.json:
        with open(args.json, 'w') as f:
            f.write(out + '\n')
    print(out)


if __name__ == '__main__':
    main()
