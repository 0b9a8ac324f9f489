"""Adversarial-environment stress tests for the quota/stopping-rule
machinery.

The reference's rejection loop (util/compute.py:134-175) degrades
gracefully when genesis collapses — it just spins proposing seeds.  The
JAX pipeline layers three speculative mechanisms on top (integrate-cap
compaction, the recompaction schedule, the quota prefix), each with a
fallback chain; these tests drive the WHOLE chain in one run — prefix
miss -> tuned relaunch -> cap overflow -> uncapped fallback -> bump_caps —
and pin that seed accounting and survivor tracks stay bit-identical to a
never-speculated run, that a dead environment surfaces the max_batches
RuntimeError with actionable context, and that a mid-run survivor-rate
collapse recovers cleanly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tropical_cyclone_risk_tpu.config import Namelist
from tropical_cyclone_risk_tpu.models import fields as F
from tropical_cyclone_risk_tpu.models import pipeline
from tropical_cyclone_risk_tpu.models.fields import synthetic_pack

N = 4096
KEY = jax.random.key(77)


def _assert_year_equal(a, b, diag_noise=False):
    """Bit-equality; diag_noise=True relaxes ONLY the wnds/vmax diagnostics
    to float32 fusion noise — the documented width-dependent caveat when
    accepted tracks come from launches of different scan widths
    (trajectories and accounting stay exact either way)."""
    exact = ('lon', 'lat', 'v', 'm', 'month', 'basin_idx', 'n_seeds')
    diag = ('vmax', 'wnds')
    for f in exact + (() if diag_noise else diag):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)
    if diag_noise:
        for f in diag:
            np.testing.assert_allclose(getattr(a, f), getattr(b, f),
                                       rtol=1e-5, atol=1e-5, err_msg=f)
    assert a.n_dropped == b.n_dropped
    assert a.n_proposed == b.n_proposed


@pytest.fixture
def dispatch_log(monkeypatch):
    """Record (integrate_width, integrate_cap) of every launch dispatch."""
    log = []
    real = pipeline._dispatch_batch

    def spy(bkey, pack_y, cfg, basin_id, n, k_max, plane_off, mesh):
        log.append((cfg.integrate_width, cfg.integrate_cap))
        return real(bkey, pack_y, cfg, basin_id, n, k_max, plane_off, mesh)

    monkeypatch.setattr(pipeline, '_dispatch_batch', spy)
    return log


def test_full_fallback_chain_exact(dispatch_log, caplog):
    """Prefix miss -> tuned relaunch -> cap overflow -> uncapped fallback ->
    bump_caps, all in one batch — outputs bit-identical to a run that
    never speculated, and the dispatch sequence is exactly the documented
    chain (no double-dispatch, no skipped fallback).

    Numbers (probed once, deterministic at this key): batch 0 has 1045
    integrable seeds (25.5%), 74 survivors uncapped, 24 survivors in a
    256-slot prefix.  integrate_cap=0.1875 (m=768 < 1045) forces the
    overflow; survivors_per_slot=0.9 shrinks the prefix to the 256 floor;
    quota 40 sits between 24 (prefix must miss) and 74 (one batch fills
    after the fallback)."""
    import logging
    cfg = Namelist(seed_batch=N, end_year=2016).replace(
        integrate_cap=0.1875, survivors_per_slot=0.9)
    pack = synthetic_pack(cfg, n_planes=12, nlat=91, nlon=180, seed=0)
    quota = 40
    cq = pipeline.quota_cfg(cfg, quota, N, 1)
    assert cq is not None and cq.integrate_width == 256

    adapt = {'cfg': cfg}
    with caplog.at_level(logging.WARNING, logger='tc_risk'):
        yt = pipeline.run_tracks_year(KEY, pack, cfg, 'GL', 0,
                                      n_tracks=quota, adapt=adapt)

    # the chain, in order: prefix launch, tuned relaunch, uncapped fallback
    assert dispatch_log[:3] == [(256, 0.1875), (None, 0.1875), (None, 1.0)]
    assert len(dispatch_log) == 3, 'quota filled by the fallback launch'
    falls = [r for r in caplog.records if 'falling back' in r.getMessage()]
    assert len(falls) == 1
    # caps re-tuned to cover the measured demand (25.5% integrable)
    assert adapt['cfg'].integrate_cap in pipeline.INTEGRATE_CAP_BUCKETS
    assert adapt['cfg'].integrate_cap >= 1045 / N

    # exactness across the whole chain: bit-identical to never speculating
    dispatch_log.clear()
    yt_ref = pipeline.run_tracks_year(
        KEY, pack,
        cfg.replace(quota_prefix=False, integrate_cap=1.0,
                    survivors_per_slot=None),
        'GL', 0, n_tracks=quota)
    assert dispatch_log == [(None, 1.0)]
    _assert_year_equal(yt, yt_ref)
    assert yt.lon.shape[0] == quota
    assert yt.n_proposed == N


def test_dead_environment_raises_with_context(dispatch_log):
    """vpot == 0 everywhere: no seed ever integrates, the quota prefix
    misses every batch WITHOUT a relaunch (nothing truncated, so the
    prefix launch provably is the full launch), and the loop surfaces the
    max_batches RuntimeError naming the shortfall."""
    cfg = Namelist(seed_batch=N, end_year=2016).replace(
        integrate_cap=0.25, survivors_per_slot=0.1)
    pack = synthetic_pack(cfg, n_planes=12, nlat=91, nlon=180, seed=0)
    env = np.array(pack.env)
    env[..., F.VPOT] = 0.0
    pack_dead = pack._replace(env=jnp.asarray(env))
    assert pipeline.quota_cfg(cfg, 8, N, 1) is not None

    with pytest.raises(RuntimeError, match=r'after 3 batches \(0/8\).*genesis'):
        pipeline.run_tracks_year(KEY, pack_dead, cfg, 'GL', 0, n_tracks=8,
                                 max_batches=3)
    # every batch exactly ONE prefix dispatch: zero integrable slots means
    # zero truncation, so the miss needs no relaunch (a double-dispatch
    # here would also double-count n_proposed/n_seeds)
    assert [w for w, _ in dispatch_log] == [512] * 3


def test_midrun_survivor_collapse_recovers(dispatch_log):
    """Survivor rate collapses in year 1 of a 2-year run (vpot confined to
    a sliver of the tropics): the year-0-sized quota prefix misses, the
    fallback chain fills the quota from repeated batches, and both years
    stay bit-identical to never-speculated runs — seed accounting exact
    across the miss/relaunch boundary."""
    cfg = Namelist(seed_batch=N, end_year=2017)
    pack = synthetic_pack(cfg, n_planes=24, nlat=91, nlon=180, seed=0)
    env = np.array(pack.env)
    # year 1: keep vpot only in a 20-degree longitude window
    lon_ok = (np.arange(180) * 2.0 >= 150) & (np.arange(180) * 2.0 < 170)
    env[12:, :, ~lon_ok, F.VPOT] = 0.0
    pack2 = pack._replace(env=jnp.asarray(env))

    # caps + survivor rate tuned on healthy year 0 only (the production
    # tuner probes first/last years; confining it to year 0 models a
    # tuning done before the collapse)
    cfg_t = pipeline.auto_integrate_cap(
        jax.random.key(5), F.slice_pack_year(pack2, cfg, 0),
        cfg.replace(end_year=2016), 'GL').replace(end_year=2017)
    assert cfg_t.survivors_per_slot is not None
    quota = 6
    assert pipeline.quota_cfg(cfg_t, quota, N, 1) is not None

    adapt = {'cfg': cfg_t}
    years = [pipeline.run_tracks_year(jax.random.fold_in(KEY, yi), pack2,
                                      adapt['cfg'], 'GL', yi,
                                      n_tracks=quota, adapt=adapt)
             for yi in (0, 1)]
    assert any(w is not None for w, _ in dispatch_log), 'prefix engaged'
    # year 1 used more than one proposal batch (the collapse is real)
    assert years[1].n_proposed > N

    cfg_ref = cfg.replace(quota_prefix=False, integrate_cap=1.0)
    for yi in (0, 1):
        ref = pipeline.run_tracks_year(jax.random.fold_in(KEY, yi), pack2,
                                       cfg_ref, 'GL', yi, n_tracks=quota)
        _assert_year_equal(years[yi], ref, diag_noise=True)
        assert years[yi].lon.shape[0] == quota
