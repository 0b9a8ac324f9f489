"""Pipeline-level statistical properties (SURVEY.md section 4 test tiers):
(c) distributional stability of the physics outputs across independent RNG
streams, (d) bitwise determinism for a fixed key (unlike the reference's
wall-clock reseeding)."""

import jax
import jax.numpy as jnp
import pytest
import numpy as np
from scipy.stats import ks_2samp

from tropical_cyclone_risk_tpu.config import Namelist
from tropical_cyclone_risk_tpu.models import pipeline
from tropical_cyclone_risk_tpu.models.fields import synthetic_pack

CFG = Namelist(seed_batch=4096)


def _launch(key):
    pack = synthetic_pack(CFG, n_planes=12, nlat=91, nlon=180, seed=0)
    return pipeline._simulate_batch(key, pack, CFG, 'GL', CFG.seed_batch,
                                    256, jnp.int32(0))


def test_deterministic_for_fixed_key():
    t1, m1 = _launch(jax.random.key(123))
    t2, m2 = _launch(jax.random.key(123))
    np.testing.assert_array_equal(np.asarray(m1['keep']),
                                  np.asarray(m2['keep']))
    np.testing.assert_array_equal(np.asarray(t1['lon']),
                                  np.asarray(t2['lon']))
    np.testing.assert_array_equal(np.asarray(t1['vmax']),
                                  np.asarray(t2['vmax']))


def test_distributional_stability_across_keys():
    """Independent RNG streams produce statistically indistinguishable
    survivor populations: LMI distribution and genesis latitudes."""
    def stats(key):
        tracks, meta = _launch(key)
        valid = np.asarray(tracks['valid'])
        vmax = np.asarray(tracks['vmax'])[valid]
        lat0 = np.asarray(tracks['lat'])[valid, 0]
        with np.errstate(all='ignore'):
            lmi = np.nanmax(np.where(np.isfinite(vmax), vmax, -np.inf),
                            axis=1)
        return lmi[np.isfinite(lmi)], lat0, int(valid.sum())

    lmi_a, lat_a, n_a = stats(jax.random.key(1))
    lmi_b, lat_b, n_b = stats(jax.random.key(2))
    assert n_a > 30 and n_b > 30
    # survivor counts within Poisson-ish noise of each other
    assert abs(n_a - n_b) < 4 * np.sqrt(0.5 * (n_a + n_b))
    assert ks_2samp(lmi_a, lmi_b).pvalue > 0.01
    assert ks_2samp(lat_a, lat_b).pvalue > 0.01
    # physical sanity of the LMI population
    assert 18.0 <= np.median(np.concatenate([lmi_a, lmi_b])) <= 90.0


def test_year_slice_parity_and_single_compile():
    """run_tracks_year slices the pack to the year's 12 planes: year 1 of a
    24-plane pack must equal year 0 of a pack holding only planes 12..23,
    and both must hit the same compiled executable (one launch shape per
    grid regardless of year count)."""
    cfg = Namelist(seed_batch=2048)
    pack24 = synthetic_pack(cfg, n_planes=24, nlat=91, nlon=180, seed=0)
    pack12 = pack24._replace(wind=pack24.wind[12:24], env=pack24.env[12:24])

    key = jax.random.key(77)
    before = pipeline._simulate_batch._cache_size()
    yt_a = pipeline.run_tracks_year(key, pack24, cfg, 'GL', 1, n_tracks=3)
    mid = pipeline._simulate_batch._cache_size()
    yt_b = pipeline.run_tracks_year(key, pack12, cfg, 'GL', 0, n_tracks=3)
    after = pipeline._simulate_batch._cache_size()
    assert mid - before == 1, 'first year should compile exactly once'
    assert after == mid, 'second year must reuse the compiled launch'

    np.testing.assert_array_equal(yt_a.month, yt_b.month)
    np.testing.assert_array_equal(yt_a.n_seeds, yt_b.n_seeds)
    np.testing.assert_allclose(yt_a.lon, yt_b.lon, rtol=0, atol=0)
    np.testing.assert_allclose(yt_a.vmax, yt_b.vmax, rtol=0, atol=0)


def test_survivor_cap_stopping_rule():
    """Quota filled mid-batch: extra survivors' tracks are discarded while
    seeds up to (and only up to) the final quota survivor's slot are counted
    — the reference's interleaved stopping rule (util/compute.py:134-175,
    where the while loop exits the moment track n_tracks survives, so later
    seeds in program order are never drawn)."""
    cfg = Namelist(seed_batch=4096)
    pack = synthetic_pack(cfg, n_planes=12, nlat=91, nlon=180, seed=0)
    key = jax.random.key(9)

    # ground truth from a raw launch with the same fold_in(key, 0) stream
    _, meta = pipeline._simulate_batch(jax.random.fold_in(key, 0), pack, cfg,
                                       'GL', cfg.seed_batch, 256,
                                       jnp.int32(0))
    keep = np.asarray(meta['keep'])
    counted = np.asarray(meta['counted'])
    surv = np.nonzero(keep)[0]
    assert surv.size >= 5, 'fixture must overfill the quota in one batch'

    quota = 3
    yt = pipeline.run_tracks_year(key, pack, cfg, 'GL', 0, n_tracks=quota)
    # tracks truncated to quota, in slot order (first `quota` survivors)
    assert yt.lon.shape[0] == quota
    cutoff = surv[quota - 1]
    # seeds counted through the final survivor's slot, none after it
    expected = int(counted[:cutoff + 1].sum())
    assert int(yt.n_seeds.sum()) == expected
    assert int(yt.n_seeds.sum()) < int(counted.sum())

    # widening the quota keeps the first `quota` tracks and counts more seeds
    yt5 = pipeline.run_tracks_year(key, pack, cfg, 'GL', 0, n_tracks=5)
    np.testing.assert_array_equal(yt5.lon[:quota], yt.lon)
    np.testing.assert_array_equal(yt5.month[:quota], yt.month)
    assert int(yt5.n_seeds.sum()) == int(counted[:surv[4] + 1].sum())


def test_integrate_compaction_bit_identical():
    """integrate_cap < 1 compacts the scan to the integrable slots but must
    leave trajectories, winds, and keep verdicts bit-identical to the
    uncapped path (Fourier flows are drawn full-width and gathered, so
    per-slot RNG streams are unchanged); the vmax diagnostic to float32
    ULP fusion noise."""
    pack = synthetic_pack(CFG, n_planes=12, nlat=91, nlon=180, seed=0)
    key = jax.random.key(5)
    cfg_cap = CFG.replace(integrate_cap=0.5)
    cfg_full = CFG.replace(integrate_cap=1.0)
    assert pipeline.launch_width(cfg_cap, CFG.seed_batch) == 2048
    t_cap, m_cap = pipeline._simulate_batch(
        key, pack, cfg_cap, 'GL', CFG.seed_batch, 256, jnp.int32(0))
    t_full, m_full = pipeline._simulate_batch(
        key, pack, cfg_full, 'GL', CFG.seed_batch, 256, jnp.int32(0))
    assert int(np.asarray(m_cap['overflow']).sum()) == 0
    np.testing.assert_array_equal(np.asarray(m_cap['keep']),
                                  np.asarray(m_full['keep']))
    # survivor rows must match bit for bit; rows past the survivor count
    # are padding (valid=False — different fill between the paths, never
    # read: the host always slices [:n_new])
    valid = np.asarray(t_full['valid'])
    np.testing.assert_array_equal(np.asarray(t_cap['valid']), valid)
    k_v = int(valid.sum())
    assert k_v > 10
    for k in ('lon', 'lat', 'v', 'm', 'month', 'basin_idx'):
        np.testing.assert_array_equal(np.asarray(t_cap[k])[:k_v],
                                      np.asarray(t_full[k])[:k_v],
                                      err_msg=k)
    # the vmax diagnostic and the recorded wnds output copy pick up
    # width-dependent XLA fusion noise at some strides (trajectories
    # above — the states the winds actually drove — are bit-equal)
    for k in ('vmax', 'wnds'):
        a, b = np.asarray(t_cap[k])[:k_v], np.asarray(t_full[k])[:k_v]
        fin = np.isfinite(a) | np.isfinite(b)
        np.testing.assert_allclose(a[fin], b[fin], rtol=0, atol=1e-4,
                                   err_msg=k)


def test_recompaction_identical():
    """Mid-track re-compaction (two-segment scan) must reproduce the
    single-segment launch: survivor verdicts and trajectories bit-identical;
    the vmax diagnostic to float32 ULP noise (array-width-dependent XLA
    fusion changes FMA contraction in the elementwise chain)."""
    pack = synthetic_pack(CFG, n_planes=12, nlat=91, nlon=180, seed=0)
    key = jax.random.key(5)
    cfg_seg = CFG.replace(integrate_cap=0.5, recompact_step=120,
                          recompact_cap=0.5)
    cfg_one = CFG.replace(integrate_cap=0.5)
    t_s, m_s = pipeline._simulate_batch(key, pack, cfg_seg, 'GL',
                                        CFG.seed_batch, 256, jnp.int32(0))
    t_o, m_o = pipeline._simulate_batch(key, pack, cfg_one, 'GL',
                                        CFG.seed_batch, 256, jnp.int32(0))
    assert int(np.asarray(m_s['overflow']).sum()) == 0
    np.testing.assert_array_equal(np.asarray(m_s['keep']),
                                  np.asarray(m_o['keep']))
    valid = np.asarray(t_o['valid'])
    np.testing.assert_array_equal(np.asarray(t_s['valid']), valid)
    kv = int(valid.sum())
    assert kv > 10
    for k in ('lon', 'lat', 'v', 'm', 'month', 'basin_idx'):
        np.testing.assert_array_equal(np.asarray(t_s[k])[:kv],
                                      np.asarray(t_o[k])[:kv], err_msg=k)
    # the recorded wnds OUTPUT COPY picks up width-dependent XLA fusion
    # noise at some strides (in-chain values are exact: v/m above are
    # bit-equal) — same ULP category as the vmax diagnostic below
    ws, wo = np.asarray(t_s['wnds'])[:kv], np.asarray(t_o['wnds'])[:kv]
    wfin = np.isfinite(ws) | np.isfinite(wo)
    np.testing.assert_allclose(ws[wfin], wo[wfin], rtol=0, atol=1e-4)
    a, b = np.asarray(t_s['vmax'])[:kv], np.asarray(t_o['vmax'])[:kv]
    fin = np.isfinite(a) | np.isfinite(b)
    np.testing.assert_allclose(a[fin], b[fin], rtol=0, atol=1e-4)


def test_multi_segment_schedule_identical():
    """The round-3 multi-boundary recompact_schedule (here 3 boundaries,
    4 scan segments) must reproduce the single-segment launch the same way
    the one-boundary cut does: verdicts and trajectories bit-identical,
    vmax to float32 ULP noise."""
    pack = synthetic_pack(CFG, n_planes=12, nlat=91, nlon=180, seed=0)
    key = jax.random.key(5)
    cfg_seg = CFG.replace(
        integrate_cap=0.5,
        recompact_schedule=((90, 0.625), (180, 0.4375), (270, 0.3125)))
    cfg_one = CFG.replace(integrate_cap=0.5)
    assert len(pipeline.seg_schedule(
        cfg_seg, pipeline.launch_width(cfg_seg, CFG.seed_batch))) == 3
    t_s, m_s = pipeline._simulate_batch(key, pack, cfg_seg, 'GL',
                                        CFG.seed_batch, 256, jnp.int32(0))
    t_o, m_o = pipeline._simulate_batch(key, pack, cfg_one, 'GL',
                                        CFG.seed_batch, 256, jnp.int32(0))
    assert int(np.asarray(m_s['overflow']).sum()) == 0
    np.testing.assert_array_equal(np.asarray(m_s['keep']),
                                  np.asarray(m_o['keep']))
    valid = np.asarray(t_o['valid'])
    np.testing.assert_array_equal(np.asarray(t_s['valid']), valid)
    kv = int(valid.sum())
    assert kv > 10
    for k in ('lon', 'lat', 'v', 'm', 'month', 'basin_idx'):
        np.testing.assert_array_equal(np.asarray(t_s[k])[:kv],
                                      np.asarray(t_o[k])[:kv], err_msg=k)
    # the recorded wnds OUTPUT COPY picks up width-dependent XLA fusion
    # noise at some strides (in-chain values are exact: v/m above are
    # bit-equal) — same ULP category as the vmax diagnostic below
    ws, wo = np.asarray(t_s['wnds'])[:kv], np.asarray(t_o['wnds'])[:kv]
    wfin = np.isfinite(ws) | np.isfinite(wo)
    np.testing.assert_allclose(ws[wfin], wo[wfin], rtol=0, atol=1e-4)
    a, b = np.asarray(t_s['vmax'])[:kv], np.asarray(t_o['vmax'])[:kv]
    fin = np.isfinite(a) | np.isfinite(b)
    np.testing.assert_allclose(a[fin], b[fin], rtol=0, atol=1e-4)


def test_multi_segment_identical_with_stride():
    """Segmented-vs-unsegmented composition stays exact at
    field_sample_stride=2: seg_schedule snaps boundaries to stride
    multiples so every segment's block-gather steps coincide with the
    unsegmented launch's.  The odd requested boundary (91) must snap."""
    cfg2 = CFG.replace(field_sample_stride=2)
    pack = synthetic_pack(cfg2, n_planes=12, nlat=91, nlon=180, seed=0)
    key = jax.random.key(5)
    cfg_seg = cfg2.replace(
        integrate_cap=0.5,
        recompact_schedule=((91, 0.625), (180, 0.4375), (271, 0.3125)))
    cfg_one = cfg2.replace(integrate_cap=0.5)
    sched = pipeline.seg_schedule(cfg_seg,
                                  pipeline.launch_width(cfg_seg,
                                                        cfg2.seed_batch))
    assert [s for s, _ in sched] == [92, 180, 272]
    t_s, m_s = pipeline._simulate_batch(key, pack, cfg_seg, 'GL',
                                        cfg2.seed_batch, 256, jnp.int32(0))
    t_o, m_o = pipeline._simulate_batch(key, pack, cfg_one, 'GL',
                                        cfg2.seed_batch, 256, jnp.int32(0))
    assert int(np.asarray(m_s['overflow']).sum()) == 0
    np.testing.assert_array_equal(np.asarray(m_s['keep']),
                                  np.asarray(m_o['keep']))
    valid = np.asarray(t_o['valid'])
    np.testing.assert_array_equal(np.asarray(t_s['valid']), valid)
    kv = int(valid.sum())
    assert kv > 10
    for k in ('lon', 'lat', 'v', 'm', 'month', 'basin_idx'):
        np.testing.assert_array_equal(np.asarray(t_s[k])[:kv],
                                      np.asarray(t_o[k])[:kv], err_msg=k)
    # the recorded wnds OUTPUT COPY picks up width-dependent XLA fusion
    # noise at some strides (in-chain values are exact: v/m above are
    # bit-equal) — same ULP category as the vmax diagnostic below
    ws, wo = np.asarray(t_s['wnds'])[:kv], np.asarray(t_o['wnds'])[:kv]
    wfin = np.isfinite(ws) | np.isfinite(wo)
    np.testing.assert_allclose(ws[wfin], wo[wfin], rtol=0, atol=1e-4)
    a, b = np.asarray(t_s['vmax'])[:kv], np.asarray(t_o['vmax'])[:kv]
    fin = np.isfinite(a) | np.isfinite(b)
    np.testing.assert_allclose(a[fin], b[fin], rtol=0, atol=1e-4)


def test_multi_segment_overflow_falls_back():
    """A schedule with one impossible boundary cap must overflow and fall
    back to the exact uncapped launch through run_tracks_year."""
    cfg_tiny = Namelist(seed_batch=4096).replace(
        integrate_cap=0.5,
        recompact_schedule=((120, 0.5), (180, 0.0626)))
    pack = synthetic_pack(cfg_tiny, n_planes=12, nlat=91, nlon=180, seed=0)
    key = jax.random.key(9)
    _, meta = pipeline._simulate_batch(
        jax.random.fold_in(key, 0), pack, cfg_tiny, 'GL', 4096, 8,
        jnp.int32(0))
    assert int(np.asarray(meta['overflow']).sum()) > 0
    yt = pipeline.run_tracks_year(key, pack, cfg_tiny, 'GL', 0, n_tracks=3)
    yt_full = pipeline.run_tracks_year(
        key, pack, cfg_tiny.replace(integrate_cap=1.0,
                                    recompact_schedule=None),
        'GL', 0, n_tracks=3)
    np.testing.assert_array_equal(yt.lon, yt_full.lon)
    np.testing.assert_array_equal(yt.n_seeds, yt_full.n_seeds)


def test_recompaction_overflow_falls_back():
    """A recompact cap below the boundary-survivor fraction must trigger
    the uncapped fallback, keeping run output exact."""
    cfg_tiny = Namelist(seed_batch=4096).replace(
        integrate_cap=0.5, recompact_step=120, recompact_cap=0.0626)
    pack = synthetic_pack(cfg_tiny, n_planes=12, nlat=91, nlon=180, seed=0)
    key = jax.random.key(9)
    _, meta = pipeline._simulate_batch(
        jax.random.fold_in(key, 0), pack, cfg_tiny, 'GL', 4096, 8,
        jnp.int32(0))
    assert int(np.asarray(meta['overflow']).sum()) > 0
    yt = pipeline.run_tracks_year(key, pack, cfg_tiny, 'GL', 0, n_tracks=3)
    yt_full = pipeline.run_tracks_year(
        key, pack, cfg_tiny.replace(integrate_cap=1.0, recompact_step=None,
                                    recompact_cap=None),
        'GL', 0, n_tracks=3)
    np.testing.assert_array_equal(yt.lon, yt_full.lon)
    np.testing.assert_array_equal(yt.n_seeds, yt_full.n_seeds)


def test_auto_integrate_cap():
    """None resolves to the smallest bucket covering the measured
    integrable fraction with margin; explicit values pass through; the
    resolved run produces the exact uncapped output."""
    pack = synthetic_pack(CFG, n_planes=12, nlat=91, nlon=180, seed=0)
    key = jax.random.key(4)
    assert CFG.integrate_cap is None
    cfg_auto = pipeline.auto_integrate_cap(jax.random.fold_in(key, 2016),
                                           pack, CFG, 'GL')
    assert cfg_auto.integrate_cap in pipeline.INTEGRATE_CAP_BUCKETS
    # measured fraction ~0.26 on this pack -> bucket clears it with margin
    prop_frac = 0.26
    assert cfg_auto.integrate_cap >= prop_frac
    assert cfg_auto.integrate_cap <= 0.5
    # the alive-decay pathfinder emits a multi-boundary schedule on this
    # environment: ascending steps, strictly decreasing caps, all active
    # at the configured batch size
    sched = cfg_auto.recompact_schedule
    assert sched is not None and len(sched) >= 2
    assert list(sched) == sorted(sched)
    caps = [c for _, c in sched]
    assert caps == sorted(caps, reverse=True) and caps[0] < 1.0
    assert len(pipeline.seg_schedule(
        cfg_auto, pipeline.launch_width(cfg_auto, CFG.seed_batch))) >= 2
    # explicit cap passes through untouched
    explicit = CFG.replace(integrate_cap=0.75)
    assert pipeline.auto_integrate_cap(key, pack, explicit,
                                       'GL').integrate_cap == 0.75
    # end-to-end: the auto-resolved year equals the uncapped year
    yt = pipeline.run_tracks_year(key, pack, cfg_auto, 'GL', 0, n_tracks=3)
    yt_full = pipeline.run_tracks_year(
        key, pack, CFG.replace(integrate_cap=1.0), 'GL', 0, n_tracks=3)
    np.testing.assert_array_equal(yt.lon, yt_full.lon)
    np.testing.assert_array_equal(yt.n_seeds, yt_full.n_seeds)


def test_integrate_cap_overflow_falls_back():
    """A cap smaller than the batch's integrable fraction must trigger the
    uncapped fallback launch, not clip statistics: run_tracks_year output
    matches the uncapped run exactly."""
    cfg_tiny = Namelist(seed_batch=4096).replace(integrate_cap=0.0626)
    pack = synthetic_pack(cfg_tiny, n_planes=12, nlat=91, nlon=180, seed=0)
    key = jax.random.key(9)
    # the fixture batch must actually overflow a 256-wide scan
    _, meta = pipeline._simulate_batch(
        jax.random.fold_in(key, 0), pack, cfg_tiny, 'GL', 4096, 8,
        jnp.int32(0))
    assert int(np.asarray(meta['overflow']).sum()) > 0
    yt = pipeline.run_tracks_year(key, pack, cfg_tiny, 'GL', 0, n_tracks=3)
    yt_full = pipeline.run_tracks_year(key, pack,
                                       cfg_tiny.replace(integrate_cap=1.0),
                                       'GL', 0, n_tracks=3)
    np.testing.assert_array_equal(yt.lon, yt_full.lon)
    np.testing.assert_array_equal(yt.month, yt_full.month)
    np.testing.assert_array_equal(yt.n_seeds, yt_full.n_seeds)


def test_take_capped_at_materialized_rows(monkeypatch):
    """A (sharded) launch can report more survivors in the full-width keep
    mask than the k_max materialized track rows; the year loop must accept
    at most k_max per batch and draw another batch, never slicing past the
    buffer (which silently under-delivered rows while counting the quota
    as filled)."""
    cfg = Namelist(seed_batch=64).replace(integrate_cap=1.0)
    T = cfg.n_steps_output
    # quota 80 > launch_width 64: k_max=64 rows materialized per batch,
    # while the fake keep mask reports 70 survivors
    from tropical_cyclone_risk_tpu.models import fields as fields_mod
    calls = []

    def fake_dispatch(bkey, pack_y, c, basin_id, N, km, plane_off, mesh):
        b = len(calls)
        calls.append(km)
        keep = np.zeros(N, bool)
        keep[: km + 6] = True                 # 6 more survivors than rows
        tracks = {
            'lon': jnp.full((km, T), 100.0 + b), 'lat': jnp.ones((km, T)),
            'v': jnp.ones((km, T)), 'm': jnp.ones((km, T)),
            'vmax': jnp.ones((km, T)), 'wnds': jnp.ones((km, T, 4)),
            'month': jnp.full((km,), 7, jnp.int32),
            'basin_idx': jnp.zeros((km,), jnp.int32),
            'valid': jnp.ones((km,), bool),
        }
        meta = {'keep': jnp.asarray(keep),
                'counted': jnp.asarray(keep),
                'basin_idx': jnp.zeros((N,), jnp.int32),
                'month': jnp.full((N,), 7, jnp.int32),
                'dropped': jnp.zeros((N,), bool),
                'overflow': jnp.zeros((2,), jnp.int32)}
        # the in-launch precomputed decisions (compact_survivors n_basins>0)
        nb = len(c.basin_ids_sorted())
        meta['scalars'] = jnp.asarray(
            [int(keep.sum()), 0, 0, 0, int(keep.sum())], jnp.int32)
        meta['spm_upto'] = pipeline._count_upto_body(
            meta['keep'], meta['counted'], meta['basin_idx'], meta['month'],
            km - 1, nb)
        meta['spm_all'] = pipeline._count_all_body(
            meta['counted'], meta['basin_idx'], meta['month'], nb)
        return tracks, meta

    monkeypatch.setattr(pipeline, '_dispatch_batch', fake_dispatch)
    monkeypatch.setattr(fields_mod, 'slice_pack_year',
                        lambda pack, c, y: pack)
    yt = pipeline.run_tracks_year(jax.random.key(0), None, cfg, 'GL', 0,
                                  n_tracks=80)
    km = calls[0]
    assert km == 64
    assert yt.lon.shape[0] == 80              # full quota, no short rows
    # first batch contributes exactly its materialized rows, second batch
    # the remainder
    assert np.all(yt.lon[:km, 0] == 100.0)
    assert np.all(yt.lon[km:80, 0] == 101.0)


def test_year_slice_out_of_range_months_rejected():
    """Months outside the configured data range integrate=False via the
    vpot-zero padding (reference: out-of-range time interp -> NaN -> vpot 0
    -> PI gate, util/compute.py:107-121)."""
    from tropical_cyclone_risk_tpu.models import fields as F
    from tropical_cyclone_risk_tpu.models import seeding
    cfg = Namelist(seed_batch=512, end_year=2017, end_month=6)
    # 18 planes: 2016-01 .. 2017-06
    pack = synthetic_pack(cfg, n_planes=18, nlat=91, nlon=180, seed=0)
    sub = F.slice_pack_year(pack, cfg, 1)
    assert sub.n_planes == 12
    # planes 0..5 (months 1-6) match the parent; 6..11 have vpot zeroed
    np.testing.assert_array_equal(np.asarray(sub.env[:6]),
                                  np.asarray(pack.env[12:18]))
    assert float(jnp.abs(sub.env[6:, ..., F.VPOT]).max()) == 0.0
    prop = seeding.propose_seeds(jax.random.key(3), sub, cfg, 'GL', 512,
                                 jnp.int32(cfg.start_month - 1))
    month = np.asarray(prop.month)
    integ = np.asarray(prop.integrate)
    assert not integ[month > 6].any()
    assert integ[month <= 6].any()


def test_auto_cap_covers_climate_drift():
    """The integrate-fraction probe samples the FIRST and LAST simulated
    years: a PI-coverage trend (warming) must raise the chosen cap to
    cover the late-period fraction, not just year 0's."""
    cfg2 = Namelist(seed_batch=4096).replace(start_year=2016, end_year=2017)
    pack = synthetic_pack(cfg2, n_planes=24, nlat=91, nlon=180, seed=0)
    from tropical_cyclone_risk_tpu.models import fields as F
    env = np.array(pack.env)
    # year 2: raise vpot everywhere ocean-like, boosting the PI-gate pass
    # fraction well above year 1's
    env[12:, ..., F.VPOT] = np.where(env[12:, ..., F.VPOT] > 0.0,
                                     np.maximum(env[12:, ..., F.VPOT], 80.0),
                                     env[12:, ..., F.VPOT])
    pack_hi = pack._replace(env=jnp.asarray(env))
    key = jax.random.key(3)
    cap_flat = pipeline.auto_integrate_cap(key, pack, cfg2,
                                           'GL').integrate_cap
    cap_drift = pipeline.auto_integrate_cap(key, pack_hi, cfg2,
                                            'GL').integrate_cap
    assert cap_drift > cap_flat


def test_overflow_adapts_caps(caplog):
    """Adaptive recovery: a persistently overflowing environment costs
    exactly ONE uncapped fallback launch, after which the cap is re-tuned
    (bump_caps) to cover the measured demand — and the adapted run stays
    bit-identical to uncapped."""
    import logging

    cfg_tiny = Namelist(seed_batch=4096).replace(integrate_cap=0.0626)
    pack = synthetic_pack(cfg_tiny, n_planes=12, nlat=91, nlon=180, seed=0)
    key = jax.random.key(9)
    # per-batch survivor count (uncapped) so the quota forces >= 2 batches
    _, meta0 = pipeline._simulate_batch(
        jax.random.fold_in(key, 0), pack,
        cfg_tiny.replace(integrate_cap=1.0), 'GL', 4096, 256, jnp.int32(0))
    k0 = int(np.asarray(meta0['keep']).sum())
    assert k0 >= 1
    # measured integrable demand of the overflowing batch
    _, meta_c = pipeline._simulate_batch(
        jax.random.fold_in(key, 0), pack, cfg_tiny, 'GL', 4096, 8,
        jnp.int32(0))
    n_over1 = int(np.asarray(meta_c['overflow'])[0])
    assert n_over1 > 0
    demand = (pipeline.launch_width(cfg_tiny, 4096) + n_over1) / 4096.0

    adapt = {'cfg': cfg_tiny}
    with caplog.at_level(logging.WARNING, logger='tc_risk'):
        yt = pipeline.run_tracks_year(key, pack, cfg_tiny, 'GL', 0,
                                      n_tracks=k0 + 5, adapt=adapt)
    falls = [r for r in caplog.records if 'falling back' in r.getMessage()]
    assert len(falls) == 1, 'exactly one uncapped launch before adaptation'
    new_cap = adapt['cfg'].integrate_cap
    assert new_cap in pipeline.INTEGRATE_CAP_BUCKETS
    assert new_cap >= demand        # bumped bucket covers measured demand

    # adaptation preserves exactness: identical to the all-uncapped run
    yt_full = pipeline.run_tracks_year(
        key, pack, cfg_tiny.replace(integrate_cap=1.0), 'GL', 0,
        n_tracks=k0 + 5)
    np.testing.assert_array_equal(yt.lon, yt_full.lon)
    np.testing.assert_array_equal(yt.month, yt_full.month)
    np.testing.assert_array_equal(yt.n_seeds, yt_full.n_seeds)
    assert yt.n_proposed == 2 * 4096


def test_stale_prefetch_rows_clamped():
    """A prefetched first batch dispatched BEFORE an adaptive cap bump can
    carry fewer materialized track rows than the re-tuned config's k_max
    (runtime.py prefetches year y+1's batch 0 before year y's adaptation
    lands).  run_tracks_year must clamp its per-batch `take` to the rows
    the batch actually materialized — otherwise `got` overcounts while the
    host slices silently come up short, and the year ships fewer tracks
    than its quota claims."""
    cfg = Namelist(seed_batch=4096)
    pack = synthetic_pack(cfg, n_planes=12, nlat=91, nlon=180, seed=0)
    key = jax.random.key(21)
    # per-batch survivor count so we can pick a quota needing >= 2 batches
    _, meta0 = pipeline._simulate_batch(
        jax.random.fold_in(key, 0), pack, cfg, 'GL', 4096, 256,
        jnp.int32(0))
    k0 = int(np.asarray(meta0['keep']).sum())
    assert k0 >= 4
    n_tracks = k0 + 3

    # the honest run: no prefetched batch
    ref = pipeline.run_tracks_year(key, pack, cfg, 'GL', 0,
                                   n_tracks=n_tracks)

    # stale prefetch: same batch 0, but materialized under an older cfg
    # whose launch width was smaller — keep only k0 - 2 rows while the
    # meta still reports k0 survivors
    tracks0, _ = pipeline._simulate_batch(
        jax.random.fold_in(key, 0), pack, cfg, 'GL', 4096, 256,
        jnp.int32(0))
    short = {k: v[:k0 - 2] for k, v in tracks0.items()}
    yt = pipeline.run_tracks_year(key, pack, cfg, 'GL', 0,
                                  n_tracks=n_tracks,
                                  first_batch=(short, meta0))
    # the quota is still met — the missing rows are re-drawn from batch 1+
    assert yt.lon.shape[0] == n_tracks
    # and the rows that WERE taken from batch 0 match the honest run
    np.testing.assert_array_equal(yt.lon[:k0 - 2], ref.lon[:k0 - 2])


def test_seed_drop_counter():
    """Slots whose every retry round misses the ocean are now counted:
    shrink the ocean to a narrow strip and the dropped count must surface
    in the launch metadata and YearTracks."""
    cfg = Namelist(seed_batch=2048)
    pack = synthetic_pack(cfg, n_planes=12, nlat=91, nlon=180, seed=0)
    rm_full = np.asarray(pack.run_mask)
    rm = np.zeros_like(rm_full)
    rm[:, :12] = rm_full[:, :12]            # ~7% of the longitude circle
    pack_small = pack._replace(run_mask=jnp.asarray(rm))
    _, meta = pipeline._simulate_batch(jax.random.key(3), pack_small, cfg,
                                       'GL', 2048, 8, jnp.int32(0))
    n_drop = int(np.asarray(meta['dropped']).sum())
    assert 0 < n_drop < 2048

    # the full-ocean pack drops (essentially) nothing and the counters
    # propagate through run_tracks_year
    yt = pipeline.run_tracks_year(jax.random.key(5), pack, cfg, 'GL', 0,
                                  n_tracks=2)
    assert yt.n_proposed >= 2048
    assert 0 <= yt.n_dropped < 0.001 * yt.n_proposed


def test_single_fetch_per_batch(monkeypatch):
    """The steady-state year loop is one launch program + exactly two host
    fetches per batch (the combined decision read and the survivor-track
    rows) — every per-batch decision rides the launch program itself, so
    no extra program or device_get round trip is paid per batch."""
    cfg = Namelist(seed_batch=4096)
    pack = synthetic_pack(cfg, n_planes=12, nlat=91, nlon=180, seed=0)
    key = jax.random.key(9)
    # warm every compile first so the counted run is pure steady state
    pipeline.run_tracks_year(key, pack, cfg, 'GL', 0, n_tracks=3)

    real_get = jax.device_get
    calls = []
    monkeypatch.setattr(jax, 'device_get',
                        lambda tree: calls.append(1) or real_get(tree))

    def boom(*a, **k):    # the dynamic-truncation count is a THIRD program
        raise AssertionError('_count_seeds_upto dispatched on the common '
                             'full-quota path')
    monkeypatch.setattr(pipeline, '_count_seeds_upto', boom)

    # quota (3) < survivors in batch 0 (>= 5, pinned by
    # test_survivor_cap_stopping_rule) -> one batch, take == bk_max, so the
    # truncated seeds-per-month table must come from the in-launch output
    yt = pipeline.run_tracks_year(key, pack, cfg, 'GL', 0, n_tracks=3)
    assert yt.lon.shape[0] == 3
    assert len(calls) == 2, f'expected 2 host fetches per batch, saw {calls}'


def test_alive_probe_covers_decay_drift(monkeypatch):
    """The recompaction-schedule pathfinder probes the alive-decay curve at
    BOTH endpoint years and sizes every boundary off the elementwise max —
    a climate trend that makes late-period storms live longer must widen
    the schedule, not overflow it (pipeline.auto_integrate_cap)."""
    cfg2 = Namelist(seed_batch=4096).replace(start_year=2016, end_year=2017)
    pack = synthetic_pack(cfg2, n_planes=24, nlat=91, nlon=180, seed=0)
    from tropical_cyclone_risk_tpu.models import fields as F
    env = np.array(pack.env)
    env[12:, ..., F.VPOT] = np.where(env[12:, ..., F.VPOT] > 0.0,
                                     np.maximum(env[12:, ..., F.VPOT], 200.0),
                                     env[12:, ..., F.VPOT])
    pack_hi = pack._replace(env=jnp.asarray(env))

    seen = []

    def fake_probe(key, pack_y, cfg_, basin_id, n):
        # identify the probed year by its (boosted) vpot planes; year 0 is
        # the flat environment, year 1 carries the long-lived storms
        hi = float(jnp.max(pack_y.env[..., F.VPOT])) >= 150.0
        seen.append(hi)
        w = pipeline.launch_width(cfg_, n)
        frac = 0.6 if hi else 0.05
        t = np.arange(cfg_.n_steps_output, dtype=np.float64)
        curve = frac * w * np.clip(1.0 - t / cfg_.n_steps_output, 0.0, 1.0)
        # (alive curve, survivor count) — the probe's round-4 contract
        return (jnp.asarray(np.round(curve).astype(np.int32)),
                jnp.int32(round(0.05 * w)))

    monkeypatch.setattr(pipeline, '_alive_curve_probe', fake_probe)
    tuned = pipeline.auto_integrate_cap(jax.random.key(3), pack_hi, cfg2,
                                        'GL')
    assert sorted(seen) == [False, True]       # both endpoint years probed
    assert tuned.recompact_schedule            # drift curve still schedules
    T = cfg2.n_steps_output
    for T1, cap in tuned.recompact_schedule:
        # every boundary cap must cover the HIGH year's alive fraction
        assert cap >= 0.6 * (1.0 - T1 / T)


def test_fused_batches_identical():
    """_simulate_batches (K launches scanned inside one program, the
    dispatch-amortizing variant) is bit-identical per batch to K separate
    _simulate_batch calls with the same keys."""
    cfg = Namelist(seed_batch=2048).replace(
        integrate_cap=0.375, recompact_schedule=((90, 0.25), (180, 0.125)))
    pack = synthetic_pack(cfg, n_planes=12, nlat=91, nlon=180, seed=0)
    K = 2
    keys = jax.random.split(jax.random.key(7), K)
    ftr, fme = pipeline._simulate_batches(keys, pack, cfg, 'GL', 2048, 16,
                                          jnp.int32(0))
    for k in range(K):
        tr, me = pipeline._simulate_batch(keys[k], pack, cfg, 'GL', 2048,
                                          16, jnp.int32(0))
        for name, a in tr.items():
            a, b = np.asarray(a), np.asarray(ftr[name][k])
            np.testing.assert_array_equal(np.isnan(a), np.isnan(b),
                                          err_msg=name)
            if name in ('vmax', 'wnds'):     # fusion-noise-tolerant, like
                # the segmented-launch identity pins
                np.testing.assert_allclose(np.nan_to_num(a),
                                           np.nan_to_num(b), atol=1e-4,
                                           err_msg=name)
            else:
                np.testing.assert_array_equal(np.nan_to_num(a),
                                              np.nan_to_num(b),
                                              err_msg=name)
        np.testing.assert_array_equal(np.asarray(me['scalars']),
                                      np.asarray(fme['scalars'][k]))
        np.testing.assert_array_equal(np.asarray(me['spm_all']),
                                      np.asarray(fme['spm_all'][k]))
        np.testing.assert_array_equal(np.asarray(me['spm_upto']),
                                      np.asarray(fme['spm_upto'][k]))


def _assert_year_equal(r, f):
    for name in ('lon', 'lat', 'v', 'm', 'month', 'basin_idx'):
        np.testing.assert_array_equal(getattr(r, name), getattr(f, name),
                                      err_msg=name)
    for name in ('vmax', 'wnds'):    # fusion-noise-tolerant, like the
        # segmented-launch identity pins
        a, b = getattr(r, name), getattr(f, name)
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b),
                                      err_msg=name)
        np.testing.assert_allclose(np.nan_to_num(a), np.nan_to_num(b),
                                   atol=1e-4, err_msg=name)
    np.testing.assert_array_equal(r.n_seeds, f.n_seeds)
    assert r.n_dropped == f.n_dropped
    assert r.n_proposed == f.n_proposed


def test_fused_years_identical(monkeypatch):
    """run_tracks_years_fused (batch 0 of K years scanned inside one
    device program) reproduces the per-year run_tracks_year loop
    bit-exactly, including an edge year whose out-of-range months ride the
    clamped-plane vpot zeroing (fields.year_plane_indices)."""
    cfg = Namelist(seed_batch=4096, end_year=2017, end_month=6,
                   tracks_per_year=5).replace(
        integrate_cap=0.375, recompact_schedule=((90, 0.75), (180, 0.5)))
    # 18 planes: 2016-01 .. 2017-06 (year 1 months 7-12 are padding)
    pack = synthetic_pack(cfg, n_planes=18, nlat=91, nlon=180, seed=0)
    key = jax.random.key(42)
    years = list(cfg.years())
    ref = [pipeline.run_tracks_year(jax.random.fold_in(key, yr), pack, cfg,
                                    'GL', yi)
           for yi, yr in enumerate(years)]

    calls = []
    orig = pipeline.run_tracks_year
    monkeypatch.setattr(pipeline, 'run_tracks_year',
                        lambda *a, **k: (calls.append(1), orig(*a, **k))[1])
    fused = pipeline.run_tracks_years_fused(key, pack, cfg, 'GL', years,
                                            k_fuse=2)
    assert not calls, 'steady-state years must settle on the fused path'
    for r, f in zip(ref, fused):
        _assert_year_equal(r, f)


def test_fused_years_fallback_identical(monkeypatch):
    """A year whose batch 0 overflows its compaction cap falls back to the
    per-year loop inside run_tracks_years_fused (reusing the fused launch
    as that year's batch 0) — results still match the plain per-year loop
    exactly (both replay the batch uncapped)."""
    cfg = Namelist(seed_batch=4096, end_year=2017, tracks_per_year=4
                   ).replace(integrate_cap=1.0 / 16.0)   # cap << demand
    pack = synthetic_pack(cfg, n_planes=24, nlat=91, nlon=180, seed=0)
    key = jax.random.key(7)
    years = list(cfg.years())
    ref = [pipeline.run_tracks_year(jax.random.fold_in(key, yr), pack, cfg,
                                    'GL', yi)
           for yi, yr in enumerate(years)]
    calls = []
    orig = pipeline.run_tracks_year
    monkeypatch.setattr(pipeline, 'run_tracks_year',
                        lambda *a, **k: (calls.append(k), orig(*a, **k))[1])
    fused = pipeline.run_tracks_years_fused(key, pack, cfg, 'GL', years,
                                            k_fuse=2)
    # the overflow must actually drive the fallback branch (with the fused
    # launch handed over as batch 0), or this test silently duplicates the
    # steady-state one
    assert len(calls) == len(years)
    assert all(k.get('first_batch') is not None for k in calls)
    for r, f in zip(ref, fused):
        _assert_year_equal(r, f)


def test_fused_years_short_circuit(monkeypatch):
    """When a launch materializes fewer track rows than the year quota
    (k_max < n_tracks), the steady-state condition can never hold: the
    driver must route straight to the pipelined per-year loop without
    dispatching (and discarding) any fused program."""
    cfg = Namelist(seed_batch=256, tracks_per_year=300, end_year=2017)
    pack = synthetic_pack(cfg, n_planes=24, nlat=91, nlon=180, seed=0)

    def boom(*a, **k):
        raise AssertionError('fused program dispatched')

    monkeypatch.setattr(pipeline, '_simulate_years', boom)
    monkeypatch.setattr(pipeline, 'prefetch_year_batch0',
                        lambda *a, **k: None)
    sentinel = object()
    seen = []
    monkeypatch.setattr(pipeline, 'run_tracks_year',
                        lambda *a, **k: (seen.append(k), sentinel)[1])
    out = pipeline.run_tracks_years_fused(jax.random.key(1), pack, cfg,
                                          'GL', list(cfg.years()), k_fuse=2)
    assert out == [sentinel, sentinel]
    assert len(seen) == 2


@pytest.mark.slow  # e2e twin of test_fused_years_identical through runtime+NetCDF (~3 min)
def test_run_downscaling_fused_matches_per_year(tmp_path):
    """runtime.run_downscaling with the fused multi-year program
    (years_per_program > 1) writes the same tracks file as the per-year
    loop (years_per_program = 1): every track variable identical, the
    diagnostic vmax/wnds to the usual fusion-noise atol."""
    from tropical_cyclone_risk_tpu import runtime
    from tropical_cyclone_risk_tpu.io import netcdf
    base = Namelist(seed_batch=4096, end_year=2018, tracks_per_year=3,
                    output_directory=str(tmp_path)).replace(
        integrate_cap=0.375, recompact_schedule=((90, 0.75), (180, 0.5)))
    pack = synthetic_pack(base, n_planes=36, nlat=91, nlon=180, seed=0)
    key = jax.random.key(11)
    fn_f = runtime.run_downscaling(
        base.replace(years_per_program=2, exp_name='fused'), 'GL', pack,
        key=key)
    fn_p = runtime.run_downscaling(
        base.replace(years_per_program=1, exp_name='plain'), 'GL', pack,
        key=key)
    df, dp = netcdf.read(fn_f), netcdf.read(fn_p)
    assert set(df.keys()) == set(dp.keys())
    for name in sorted(df.keys()):
        a, b = df[name].data, dp[name].data
        if name in ('vmax_trks', 'wnds_trks'):
            np.testing.assert_array_equal(np.isnan(a), np.isnan(b),
                                          err_msg=name)
            np.testing.assert_allclose(np.nan_to_num(a), np.nan_to_num(b),
                                       atol=1e-4, err_msg=name)
        else:
            np.testing.assert_array_equal(a, b, err_msg=name)


def _tuned_quota_cfg():
    """Auto-tuned cfg on the synthetic environment with the quota prefix
    resolvable (survivors_per_slot from the pathfinder probe)."""
    cfg = Namelist(seed_batch=4096, tracks_per_year=6, end_year=2016)
    pack = synthetic_pack(cfg, n_planes=12, nlat=91, nlon=180, seed=0)
    cfg = pipeline.auto_integrate_cap(jax.random.key(21), pack, cfg, 'GL')
    assert cfg.survivors_per_slot is not None
    return cfg, pack


def test_quota_prefix_identical():
    """The speculative quota prefix (quota_cfg: integrate only a prefix of
    the integrable slots sized for the year quota) must leave the year's
    tracks and seed accounting bit-identical to the full tuned launch —
    the compacted track axis is slot-ordered, so when the prefix holds at
    least `quota` survivors they ARE the first survivors of the full
    launch, and the stopping-rule cutoff slot lies inside the prefix."""
    cfg, pack = _tuned_quota_cfg()
    cq = pipeline.quota_cfg(cfg, cfg.tracks_per_year, cfg.seed_batch, 1)
    assert cq is not None, 'quota prefix must engage on the tuned cfg'
    assert pipeline.launch_width(cq, cfg.seed_batch) \
        < pipeline.launch_width(cfg, cfg.seed_batch)
    assert cq.recompact_schedule is None

    key = jax.random.key(31)
    yt_q = pipeline.run_tracks_year(key, pack, cfg, 'GL', 0)
    yt_f = pipeline.run_tracks_year(
        key, pack, cfg.replace(quota_prefix=False), 'GL', 0)
    _assert_year_equal(yt_f, yt_q)
    assert yt_q.lon.shape[0] == cfg.tracks_per_year

    # prefetch (the pipelined year loop's batch 0) applies the same
    # derivation: feeding it back must reproduce the same year
    fb = pipeline.prefetch_year_batch0(key, pack, cfg, 'GL', 0)
    yt_p = pipeline.run_tracks_year(key, pack, cfg, 'GL', 0,
                                    first_batch=fb)
    _assert_year_equal(yt_q, yt_p)


def test_quota_prefix_miss_falls_back():
    """A batch whose prefix cannot cover the remaining quota relaunches at
    the tuned width with the same key — outputs bit-identical to never
    having speculated (the fallback twin of the cap-overflow rule)."""
    cfg, pack = _tuned_quota_cfg()
    # an absurd survivor-rate estimate shrinks the prefix to the 256 floor,
    # where the quota below cannot fill from the prefix's survivors
    cfg_hi = cfg.replace(survivors_per_slot=0.9)
    quota = 64
    cq = pipeline.quota_cfg(cfg_hi, quota, cfg.seed_batch, 1)
    assert cq is not None and pipeline.launch_width(
        cq, cfg.seed_batch) == 256
    key = jax.random.key(33)
    yt_m = pipeline.run_tracks_year(key, pack, cfg_hi, 'GL', 0,
                                    n_tracks=quota)
    yt_f = pipeline.run_tracks_year(
        key, pack, cfg_hi.replace(quota_prefix=False), 'GL', 0,
        n_tracks=quota)
    _assert_year_equal(yt_f, yt_m)
    assert yt_m.lon.shape[0] == quota


@pytest.mark.slow  # multi-year quota sweep; the valid/miss/fused pieces are covered separately (~5 min)
def test_quota_prefix_fused_years_identical():
    """The fused multi-year driver under the quota prefix settles years by
    the leading-prefix survivor scalar and still matches the per-year
    loop (which itself runs quota-prefixed) AND the unspeculated loop."""
    cfg, pack = _tuned_quota_cfg()
    cfg = cfg.replace(end_year=2017)
    pack = synthetic_pack(cfg, n_planes=24, nlat=91, nlon=180, seed=0)
    key = jax.random.key(41)
    years = list(cfg.years())
    fused = pipeline.run_tracks_years_fused(key, pack, cfg, 'GL', years,
                                            k_fuse=2)
    for yi, yr in enumerate(years):
        ref_q = pipeline.run_tracks_year(jax.random.fold_in(key, yr), pack,
                                         cfg, 'GL', yi)
        ref_f = pipeline.run_tracks_year(
            jax.random.fold_in(key, yr), pack,
            cfg.replace(quota_prefix=False), 'GL', yi)
        _assert_year_equal(ref_f, ref_q)
        _assert_year_equal(ref_q, fused[yi])


@pytest.mark.parametrize('sched,stride,sub', [
    (None, 3, 1),                       # unsegmented, strided (defaults)
    (((60, 0.75), (180, 0.5)), 3, 1),   # multi-segment + stride
    (None, 1, 1),                       # per-step scan
    (((90, 0.5),), 1, 1),               # one boundary, per-step
    (None, 1, 2),                       # RK substeps path
])
def test_vmax_in_scan_identity(sched, stride, sub):
    """Namelist.vmax_in_scan computes the vmax diagnostic inside the
    integration scan (simulator._diag_step + diagnostics.fix_last_sample)
    instead of the standalone axi_to_max_wind_raw post-pass.  Both paths
    read the SAME neighbor positions (the post-pass re-reads from the
    frozen buffers what the scan carries), so trajectories and verdicts
    must be bit-identical and vmax equal to float32 fusion noise."""
    cfg0 = Namelist(seed_batch=2048).replace(
        recompact_schedule=sched, field_sample_stride=stride,
        rk_substeps=sub, integrate_cap=0.75)
    pack = synthetic_pack(cfg0, n_planes=12, nlat=46, nlon=90, seed=0)
    key = jax.random.key(7)
    out = {}
    for flag in (False, True):
        cfg = cfg0.replace(vmax_in_scan=flag)
        out[flag] = pipeline._simulate_batch(key, pack, cfg, 'GL',
                                             cfg0.seed_batch, 64,
                                             jnp.int32(0))
    (ta, ma), (tb, mb) = out[False], out[True]
    np.testing.assert_array_equal(np.asarray(ma['scalars']),
                                  np.asarray(mb['scalars']))
    np.testing.assert_array_equal(np.asarray(ma['keep']),
                                  np.asarray(mb['keep']))
    valid = np.asarray(ta['valid'])
    np.testing.assert_array_equal(np.asarray(tb['valid']), valid)
    kv = int(valid.sum())
    assert kv > 5
    for k in ('lon', 'lat', 'v', 'm', 'month', 'basin_idx'):
        a, b = np.asarray(ta[k])[:kv], np.asarray(tb[k])[:kv]
        np.testing.assert_array_equal(np.nan_to_num(a, nan=-9e9),
                                      np.nan_to_num(b, nan=-9e9),
                                      err_msg=k)
    a, b = np.asarray(ta['vmax'])[:kv], np.asarray(tb['vmax'])[:kv]
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
    fin = np.isfinite(a)
    np.testing.assert_allclose(a[fin], b[fin], rtol=0, atol=1e-4)
