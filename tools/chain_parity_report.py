"""Offline whole-chain parity report at larger sample size than the CI
test (tests/test_chain_parity.py): the full JAX pipeline vs the
sequential solve_ivp reference chain on the same synthetic environment.

Usage:  JAX_PLATFORMS=cpu python tools/chain_parity_report.py \
            [--ref-seeds 20000] [--launches 6] [--json docs/chain_parity.json]
"""

import argparse
import json
import os
import sys

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _ROOT)
sys.path.insert(0, os.path.join(_ROOT, 'tests'))


def pdi_of(vmax, dt):
    """Power-dissipation index per track: sum vmax^3 dt over finite
    samples (reference notebook cell 16)."""
    v = np.where(np.isfinite(vmax), vmax, 0.0)
    return (v ** 3).sum(axis=-1) * dt


def landfall_vmax(f_land, lon, lat, vmax):
    """vmax at the first along-track sample with land fraction >= 0.5
    (identical detector for both chains: the pack's land spline)."""
    fin = np.isfinite(lon) & np.isfinite(lat)
    if not fin.any():
        return None
    land = f_land.ev(lon[fin], lat[fin])
    hit = np.flatnonzero(land >= 0.5)
    # skip genesis-on-coast samples: require an ocean sample first
    if hit.size and hit[0] > 0:
        return float(vmax[fin][hit[0]])
    return None


def ref_aggregates(rc, tracks, n_counted, dt_s):
    """Collapse RefTrack objects to the cached per-track aggregates."""
    return {
        'lmi': np.array([t.vmax.max() for t in tracks]),
        'lat0': np.array([t.lat[0] for t in tracks]),
        'month': np.array([t.month for t in tracks]),
        'pos': (np.concatenate([np.stack([t.lon, t.lat], 1)
                                for t in tracks])
                if tracks else np.zeros((0, 2))),
        'pdi': np.array([pdi_of(t.vmax, dt_s) for t in tracks]),
        'lf': np.array([v for t in tracks
                        for v in [landfall_vmax(rc.f_land, t.lon, t.lat,
                                                t.vmax)]
                        if v is not None]),
        'spm': rc.counted_by_bm.astype(float),
        'n_counted': n_counted,
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('--ref-seeds', type=int, default=20000)
    ap.add_argument('--launches', type=int, default=6)
    ap.add_argument('--json', default=None)
    ap.add_argument('--stride', type=int, default=None,
                    help='field_sample_stride for the JAX-pipeline side '
                         '(default: the config default; the reference '
                         'chain is stride-independent)')
    ap.add_argument('--jax-dump', default=None,
                    help='npz path: dump the per-launch JAX-side aggregates '
                         '(lmi/lat0/pdi + launch index) for offline '
                         'diagnostics — null-calibration splits, CDF '
                         'deviation shape')
    ap.add_argument('--exact-stage-fields', action='store_true',
                    help='rk_exact_stage_fields=True on the JAX side: '
                         'per-RK-stage field sampling AND per-eval wind '
                         'coloring — the maximal-fidelity RK4, isolating '
                         'the frozen-fields/coloring-cadence deviations')
    ap.add_argument('--rk-substeps', type=int, default=None,
                    help='rk_substeps on the JAX side (solve_ivp-accuracy '
                         'isolator)')
    ap.add_argument('--ref-cache', default=None,
                    help='npz path: save the reference-chain aggregates on '
                         'first run, reuse them on later runs — the '
                         'sequential solve_ivp side dominates the wall '
                         'time and is independent of --stride, so stride '
                         'sweeps only pay the JAX side')
    args = ap.parse_args(argv)

    import jax
    import jax.numpy as jnp
    from scipy.stats import ks_2samp

    from tropical_cyclone_risk_tpu.config import Namelist
    from tropical_cyclone_risk_tpu.models import pipeline
    from tropical_cyclone_risk_tpu.models.fields import synthetic_pack
    from reference_chain import ReferenceChain

    cfg = Namelist(seed_batch=8192)
    if args.stride is not None:
        cfg = cfg.replace(field_sample_stride=args.stride)
    if args.exact_stage_fields:
        cfg = cfg.replace(rk_exact_stage_fields=True)
    if args.rk_substeps is not None:
        cfg = cfg.replace(rk_substeps=args.rk_substeps)
    pack = synthetic_pack(cfg, n_planes=12, nlat=91, nlon=180, seed=0)

    rc = ReferenceChain(pack, cfg, 'GL')
    dt_s = float(cfg.output_interval_s)

    if args.ref_cache and os.path.exists(args.ref_cache):
        c = np.load(args.ref_cache)
        assert int(c['ref_seeds']) == args.ref_seeds, (
            f"cache built for --ref-seeds {int(c['ref_seeds'])}, "
            f"got {args.ref_seeds}")
        ref_lmi, ref_lat0, ref_month = c['lmi'], c['lat0'], c['month']
        ref_pos, ref_pdi, ref_lf = c['pos'], c['pdi'], c['lf']
        ref_spm, n_counted_ref = c['spm'], int(c['n_counted'])
        ref_surv = ref_lmi.size / n_counted_ref
        print(f'reference side loaded from {args.ref_cache} '
              f'({ref_lmi.size} tracks)', flush=True)
    else:
        tracks, n_counted_ref, _ = rc.run(np.random.default_rng(0),
                                          args.ref_seeds)
        agg = ref_aggregates(rc, tracks, n_counted_ref, dt_s)
        ref_lmi, ref_lat0, ref_month = agg['lmi'], agg['lat0'], agg['month']
        ref_pos, ref_pdi, ref_lf = agg['pos'], agg['pdi'], agg['lf']
        ref_spm = agg['spm']
        ref_surv = len(tracks) / n_counted_ref
        if args.ref_cache:
            np.savez_compressed(args.ref_cache, ref_seeds=args.ref_seeds,
                                **agg)
            print(f'reference side cached to {args.ref_cache}', flush=True)

    n_basins = ref_spm.shape[0]
    lmis, lat0s, months, poss, pdis, lfs = [], [], [], [], [], []
    jax_spm = np.zeros((n_basins, 12))
    n_counted = n_kept = 0
    for i in range(args.launches):
        tr, meta = pipeline._simulate_batch(
            jax.random.key(100 + i), pack, cfg, 'GL', cfg.seed_batch,
            1024, jnp.int32(0))
        valid = np.asarray(tr['valid'])
        k = int(valid.sum())
        vmax = np.asarray(tr['vmax'])[:k]
        lon = np.asarray(tr['lon'])[:k]
        lat = np.asarray(tr['lat'])[:k]
        with np.errstate(all='ignore'):
            lmis.append(np.nanmax(np.where(np.isfinite(vmax), vmax,
                                           -np.inf), axis=1))
        lat0s.append(lat[:, 0])
        months.append(np.asarray(tr['month'])[:k])
        fin = np.isfinite(lon)
        poss.append(np.stack([lon[fin], lat[fin]], 1))
        pdis.append(pdi_of(vmax, dt_s))
        for j in range(k):
            v = landfall_vmax(rc.f_land, lon[j], lat[j], vmax[j])
            if v is not None:
                lfs.append(v)
        cm = np.asarray(meta['counted'])
        mm = np.asarray(meta['month'])
        bm = np.asarray(meta['basin_idx'])
        np.add.at(jax_spm, (bm[cm], mm[cm] - 1), 1.0)
        n_counted += int(cm.sum())
        n_kept += k
    jax_lmi = np.concatenate(lmis)
    jax_lat0 = np.concatenate(lat0s)
    jax_month = np.concatenate(months)
    jax_pos = np.concatenate(poss)
    jax_pdi = np.concatenate(pdis)
    jax_lf = np.array(lfs)
    jax_surv = n_kept / n_counted
    if args.jax_dump:
        np.savez_compressed(
            args.jax_dump, lmi=jax_lmi, lat0=jax_lat0, pdi=jax_pdi,
            month=jax_month,
            launch=np.concatenate([np.full(a.size, i, np.int32)
                                   for i, a in enumerate(lmis)]))
        print(f'JAX-side aggregates dumped to {args.jax_dump}', flush=True)

    def density(pos):
        h, _, _ = np.histogram2d(pos[:, 1], pos[:, 0] % 360.0,
                                 bins=(np.arange(-90, 92, 4.0),
                                       np.arange(0, 364, 4.0)))
        return h / h.sum()

    p, q = density(ref_pos), density(jax_pos)
    month_tv = 0.5 * np.abs(
        np.bincount(ref_month.astype(int), minlength=13)[1:] / ref_month.size
        - np.bincount(jax_month.astype(int), minlength=13)[1:]
        / jax_month.size).sum()

    spm_tv = 0.5 * np.abs(ref_spm / ref_spm.sum()
                          - jax_spm / jax_spm.sum()).sum()

    def crit(n1, n2):
        return round(1.63 * np.sqrt((n1 + n2) / (n1 * n2)), 4)

    report = {
        'n_ref_tracks': int(ref_lmi.size),
        'n_tpu_tracks': int(jax_lmi.size),
        'ks_lmi': round(float(ks_2samp(ref_lmi, jax_lmi).statistic), 4),
        'ks_genesis_lat': round(float(ks_2samp(np.abs(ref_lat0),
                                               np.abs(jax_lat0)).statistic),
                                4),
        'ks_pdi': round(float(ks_2samp(ref_pdi, jax_pdi).statistic), 4),
        'ks_landfall_vmax': round(float(
            ks_2samp(ref_lf, jax_lf).statistic), 4),
        'n_ref_landfalls': int(ref_lf.size),
        'n_tpu_landfalls': int(jax_lf.size),
        'seasonal_total_variation': round(float(month_tv), 4),
        'seeds_per_month_total_variation': round(float(spm_tv), 4),
        'n_ref_counted_seeds': int(ref_spm.sum()),
        'n_tpu_counted_seeds': int(jax_spm.sum()),
        'track_density_overlap': round(float(np.minimum(p, q).sum()), 4),
        'survival_ref': round(float(ref_surv), 5),
        'survival_tpu': round(float(jax_surv), 5),
        'survival_ratio': round(float(jax_surv / ref_surv), 4),
        'ks_1pct_critical': crit(ref_lmi.size, jax_lmi.size),
        'ks_1pct_critical_landfall': crit(max(ref_lf.size, 1),
                                          max(jax_lf.size, 1)),
    }
    out = json.dumps(report, indent=1)
    if args.json:
        with open(args.json, 'w') as f:
            f.write(out + '\n')
    print(out)


if __name__ == '__main__':
    main()
