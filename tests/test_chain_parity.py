"""Whole-chain statistical parity: the full JAX pipeline (vectorized seeding
-> fused RK4 scan -> filters -> vmax) against an independent sequential
NumPy/scipy reference chain (solve_ivp RK45, scalar spline physics —
tests/reference_chain.py) on the same synthetic environment.

This is the BASELINE.json quality metric exercised end to end: LMI
distribution, genesis latitude, PDI, landfall vmax, seasonal cycle,
per-(basin,month) counted-seed distribution, track density, and the
survival rate (the model's frequency signal).  Piecewise parity lives in
test_seeding_parity / test_simulator / test_fast_golden /
test_reference_differential; this test catches compounding biases those
cannot.

Sample sizes and thresholds (round-3 ratchet):
N_REF_SEEDS=40000 yields ~1.5k reference tracks in ~7 min; 20 JAX launches
of 8192 yield ~3.5k.  The two-sample KS 1% critical value at those sizes
is ~0.050; we assert < 0.06 (1.2x critical).  The 105k-seed offline report
(docs/chain_parity.json, tools/chain_parity_report.py) pins the same
metrics at KS criticals ~0.03 with stated margins; observed statistics
there sit at or below their critical values, so 0.06 here carries ~2x
margin over the measured asymptotic agreement.  Landfalls are ~10% of
tracks (1% critical ~0.16 at the resulting sizes): assert < 0.20, with the
tight landfall number owned by the offline report.
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from scipy.stats import ks_2samp

sys.path.insert(0, str(Path(__file__).parent))

from tropical_cyclone_risk_tpu.config import Namelist
from tropical_cyclone_risk_tpu.models import pipeline
from tropical_cyclone_risk_tpu.models.fields import synthetic_pack

from reference_chain import ReferenceChain

pytestmark = pytest.mark.slow  # whole-chain statistical parity at ratcheted sample sizes (~9 min)


CFG = Namelist(seed_batch=8192)
N_REF_SEEDS = 40000      # counted seeds for the sequential chain (~7 min)
N_LAUNCHES = 20
KS_THRESH = 0.06         # 1.2x the ~0.050 1% critical at these sizes
KS_LANDFALL_THRESH = 0.20


def _landfall_vmax(f_land, lon, lat, vmax):
    """vmax at the first along-track sample with land fraction >= 0.5,
    requiring an ocean sample first (same detector both chains)."""
    fin = np.isfinite(lon) & np.isfinite(lat)
    if not fin.any():
        return None
    land = f_land.ev(lon[fin], lat[fin])
    hit = np.flatnonzero(land >= 0.5)
    if hit.size and hit[0] > 0:
        return float(vmax[fin][hit[0]])
    return None


def _pdi(vmax, dt_s):
    v = np.where(np.isfinite(vmax), vmax, 0.0)
    return (v ** 3).sum(axis=-1) * dt_s


@pytest.fixture(scope='module')
def populations():
    pack = synthetic_pack(CFG, n_planes=12, nlat=91, nlon=180, seed=0)
    dt_s = float(CFG.output_interval_s)

    rc = ReferenceChain(pack, CFG, 'GL')
    tracks, n_counted, _ = rc.run(np.random.default_rng(0), N_REF_SEEDS)
    ref = {
        'lmi': np.array([t.vmax.max() for t in tracks]),
        'lat0': np.array([t.lat[0] for t in tracks]),
        'month': np.array([t.month for t in tracks]),
        'pos': np.concatenate([np.stack([t.lon, t.lat], 1) for t in tracks]),
        'pdi': np.array([_pdi(t.vmax, dt_s) for t in tracks]),
        'lf': np.array([v for t in tracks
                        for v in [_landfall_vmax(rc.f_land, t.lon, t.lat,
                                                 t.vmax)] if v is not None]),
        'spm': rc.counted_by_bm.astype(float),
        'survival': len(tracks) / n_counted,
    }

    n_basins = ref['spm'].shape[0]
    lmis, lat0s, months, poss, pdis, lfs = [], [], [], [], [], []
    spm = np.zeros((n_basins, 12))
    n_counted = n_kept = 0
    for i in range(N_LAUNCHES):
        tr, meta = pipeline._simulate_batch(
            jax.random.fold_in(jax.random.key(1), i), pack, CFG, 'GL',
            CFG.seed_batch, 2048, jnp.int32(0))
        valid = np.asarray(tr['valid'])
        vmax = np.asarray(tr['vmax'])[valid]
        with np.errstate(all='ignore'):
            lmis.append(np.nanmax(np.where(np.isfinite(vmax), vmax, -np.inf),
                                  axis=1))
        lat0s.append(np.asarray(tr['lat'])[valid, 0])
        months.append(np.asarray(tr['month'])[valid])
        lon_t = np.asarray(tr['lon'])[valid]
        lat_t = np.asarray(tr['lat'])[valid]
        ok = np.isfinite(lon_t)
        poss.append(np.stack([lon_t[ok], lat_t[ok]], 1))
        pdis.append(_pdi(vmax, dt_s))
        for j in range(lon_t.shape[0]):
            v = _landfall_vmax(rc.f_land, lon_t[j], lat_t[j], vmax[j])
            if v is not None:
                lfs.append(v)
        cm = np.asarray(meta['counted'])
        np.add.at(spm, (np.asarray(meta['basin_idx'])[cm],
                        np.asarray(meta['month'])[cm] - 1), 1.0)
        n_counted += int(cm.sum())
        n_kept += int(np.asarray(meta['keep']).sum())
    ours = {
        'lmi': np.concatenate(lmis),
        'lat0': np.concatenate(lat0s),
        'month': np.concatenate(months),
        'pos': np.concatenate(poss),
        'pdi': np.concatenate(pdis),
        'lf': np.array(lfs),
        'spm': spm,
        'survival': n_kept / n_counted,
    }
    assert ref['lmi'].size > 1000 and ours['lmi'].size > 2500
    return ref, ours


def test_lmi_distribution(populations):
    ref, ours = populations
    ks = ks_2samp(ref['lmi'], ours['lmi'])
    assert ks.statistic < KS_THRESH, (ks.statistic, ks.pvalue)


def test_genesis_latitude(populations):
    ref, ours = populations
    ks = ks_2samp(ref['lat0'], ours['lat0'])
    assert ks.statistic < KS_THRESH, (ks.statistic, ks.pvalue)


def test_pdi_distribution(populations):
    """Per-track power-dissipation index (reference notebook cell 16)."""
    ref, ours = populations
    ks = ks_2samp(ref['pdi'], ours['pdi'])
    assert ks.statistic < KS_THRESH, (ks.statistic, ks.pvalue)


def test_landfall_vmax(populations):
    """Intensity at first landfall — the risk-relevant tail."""
    ref, ours = populations
    assert ref['lf'].size > 50 and ours['lf'].size > 120, \
        (ref['lf'].size, ours['lf'].size)
    ks = ks_2samp(ref['lf'], ours['lf'])
    assert ks.statistic < KS_LANDFALL_THRESH, (ks.statistic, ks.pvalue)


def test_seasonal_cycle(populations):
    ref, ours = populations
    h_r = np.bincount(ref['month'], minlength=13)[1:] / ref['month'].size
    h_t = np.bincount(ours['month'], minlength=13)[1:] / ours['month'].size
    tv = 0.5 * np.abs(h_r - h_t).sum()
    assert tv < 0.09, tv


def test_seeds_per_month(populations):
    """Counted seeds per (basin, month) — the seeds_per_month output
    variable's distribution (util/compute.py:163-175).  TV noise floor at
    these counts is ~0.02."""
    ref, ours = populations
    tv = 0.5 * np.abs(ref['spm'] / ref['spm'].sum()
                      - ours['spm'] / ours['spm'].sum()).sum()
    assert tv < 0.05, tv


def test_track_density(populations):
    ref, ours = populations
    bins = [np.arange(0, 361, 10), np.arange(-90, 91, 10)]
    H_r, _, _ = np.histogram2d(ref['pos'][:, 0], ref['pos'][:, 1], bins=bins)
    H_t, _, _ = np.histogram2d(ours['pos'][:, 0], ours['pos'][:, 1], bins=bins)
    overlap = np.minimum(H_r / H_r.sum(), H_t / H_t.sum()).sum()
    assert overlap > 0.85, overlap


def test_survival_rate(populations):
    """Survivors per counted seed — the frequency signal (Gamma in the
    reference's analysis notebook, cell 11).  Combined sampling SE at
    these sizes is ~3%; the offline 105k report pins the central value."""
    ref, ours = populations
    ratio = ours['survival'] / ref['survival']
    assert 0.85 < ratio < 1.18, (ref['survival'], ours['survival'])
