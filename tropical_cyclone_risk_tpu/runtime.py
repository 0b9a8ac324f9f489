"""Run orchestration and the track-output contract.

Reference equivalents: run.py (CLI), util/compute.py:40-58 (file naming and
ensemble suffixing), util/compute.py:216-270 (run_downscaling and the output
NetCDF schema).  The output schema is reproduced field for field so the
reference's analysis notebook reads our files unmodified.
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional

import jax
import numpy as np

from tropical_cyclone_risk_tpu.config import Namelist
from tropical_cyclone_risk_tpu.io import netcdf
from tropical_cyclone_risk_tpu.models import pipeline, seeding
from tropical_cyclone_risk_tpu.models.fields import FieldPack
from tropical_cyclone_risk_tpu.utils import basins as basins_mod
from tropical_cyclone_risk_tpu.utils import obs


def get_fn_tracks(cfg: Namelist, basin_id: str) -> str:
    """Track filename contract (util/compute.py:40-46)."""
    return ('%s/%s/tracks_%s_%s_%d%02d_%d%02d.nc' %
            (cfg.output_directory, cfg.exp_name, basin_id, cfg.exp_prefix,
             cfg.start_year, cfg.start_month, cfg.end_year, cfg.end_month))


def fn_tracks_duplicates(fn_trk: str) -> str:
    """Ensemble-member suffixing _eN (util/compute.py:52-58).

    The chosen name is CLAIMED atomically (O_CREAT|O_EXCL placeholder,
    later overwritten by the atomic publish in io.netcdf.write), so
    concurrently launched ensemble members cannot resolve the same path
    — the reference's check-then-write race, not replicated.

    A run that dies between the claim and the publish leaves a 0-byte
    placeholder: later runs move on to the next _eN suffix (correct — the
    slot is indeterminate), and analysis.open_tracks skips and reports
    zero-byte members; delete the placeholder to reclaim the slot."""
    f_int = 0
    fn_out = fn_trk
    while True:
        try:
            os.close(os.open(fn_out, os.O_CREAT | os.O_EXCL | os.O_WRONLY))
            return fn_out
        except FileExistsError:
            fn_out = fn_trk[:-3] + '_e%d.nc' % f_int
            f_int += 1


def write_tracks_nc(path: str, out: dict, cfg: Namelist) -> None:
    """Write the track dataset (schema: util/compute.py:250-264)."""
    basin_ids = list(cfg.basin_ids_sorted())
    n_steps = cfg.n_steps_output
    ts_output = np.linspace(0, cfg.total_track_time_s, n_steps)
    basin_strs = np.array([basin_ids[i] for i in out['basin_idx']],
                          dtype='U2')
    wnds = out['wnds']
    data_vars = {
        'lon_trks': (('n_trk', 'time'), out['lon'].astype(np.float32)),
        'lat_trks': (('n_trk', 'time'), out['lat'].astype(np.float32)),
        'v_trks': (('n_trk', 'time'), out['v'].astype(np.float32)),
        'm_trks': (('n_trk', 'time'), out['m'].astype(np.float32)),
        'vmax_trks': (('n_trk', 'time'), out['vmax'].astype(np.float32)),
        'tc_month': (('n_trk',), out['month'].astype(np.float64)),
        'tc_basins': (('n_trk',), basin_strs),
        'tc_years': (('n_trk',), out['year'].astype(np.int32)),
        'seeds_per_month': (('year', 'basin', 'month'),
                            out['n_seeds'].astype(np.float64)),
    }
    # per-steering-level wind channels named like the reference schema
    # (u250_trks, v250_trks, u850_trks, v850_trks for the default levels)
    for i, lvl in enumerate(cfg.steering_levels):
        data_vars[f'u{lvl}_trks'] = (('n_trk', 'time'),
                                     wnds[:, :, 2 * i].astype(np.float32))
        data_vars[f'v{lvl}_trks'] = (('n_trk', 'time'),
                                     wnds[:, :, 2 * i + 1].astype(np.float32))
    coords = {
        'n_trk': np.arange(out['lon'].shape[0], dtype=np.int32),
        'time': ts_output,
        'year': np.unique(out['year']).astype(np.int32),
        'basin': np.array(basin_ids, dtype='U2'),
        'month': np.arange(1, 13, dtype=np.int32),
    }
    # 'basin' is a coord of strings -> store as data var (char matrix) since
    # classic NetCDF coords must be numeric; xarray still reads it back.
    data_vars['basin'] = (('basin',), coords.pop('basin'))
    netcdf.write(path, data_vars, coords=coords,
                 attrs={'source': 'tropical_cyclone_risk_tpu'},
                 var_attrs={'time': {'units': 'seconds since genesis'}})


def run_downscaling(cfg: Namelist, basin_id: str, pack: FieldPack,
                    key: Optional[jax.Array] = None,
                    n_years: Optional[int] = None,
                    trace_dir: Optional[str] = None, mesh=None) -> str:
    """Simulate every configured year and write the tracks file
    (util/compute.py:216-270).  Returns the written path.

    trace_dir: write a jax.profiler timeline of the simulation phase.
    mesh: optional device mesh; shards every seed batch over it
    (parallel.sharding replaces the reference's per-year process pool,
    util/compute.py:223-230)."""
    basin_id = basins_mod.validate_basin_id(cfg, basin_id)
    if key is None:
        # all processes must agree on the (replicated) key: broadcast the
        # wall-clock draw from process 0 in multi-host runs
        seed = int(time.time_ns() % (2 ** 31))
        if jax.process_count() > 1:
            from jax.experimental import multihost_utils
            seed = int(multihost_utils.broadcast_one_to_all(
                np.int32(seed)))
        key = jax.random.key(seed)
    if n_years is not None and n_years < 1:
        raise ValueError(f'n_years must be >= 1, got {n_years}')
    years = cfg.years()[:n_years] if n_years is not None else cfg.years()
    if years and cfg.integrate_cap is None:
        # resolve the auto integrate-compaction cap by probing year 0 /
        # batch 0's proposal stream (pipeline.auto_integrate_cap)
        cfg = pipeline.auto_integrate_cap(
            jax.random.fold_in(key, years[0]), pack, cfg, basin_id)
        obs.log.info('integrate_cap auto-tuned to %.4f (scan width %d of '
                     '%d seeds); recompact schedule %s', cfg.integrate_cap,
                     pipeline.launch_width(cfg, cfg.seed_batch),
                     cfg.seed_batch,
                     cfg.recompact_schedule
                     if cfg.recompact_schedule is not None
                     else (cfg.recompact_step, cfg.recompact_cap))
    t0 = time.time()
    metrics = obs.Metrics()
    results = []
    with obs.maybe_profile(trace_dir):
        adapt = {'cfg': cfg}     # cap-overflow re-tuning persists across years
        if cfg.years_per_program > 1 and len(years) > 1:
            # steady-state path: batch 0 of years_per_program years fused
            # into one device program (pipeline._simulate_years, or its
            # SPMD twin under a mesh) — one program dispatch per group
            # instead of per year; abnormal years (cap overflow, unfilled
            # quota) replay on the per-year loop inside the driver with
            # bit-identical results
            with obs.phase('simulate', metrics):
                results = pipeline.run_tracks_years_fused(
                    key, pack, cfg, basin_id, list(years), adapt=adapt,
                    mesh=mesh)
            # per-group progress (tracks, elapsed) is logged by the fused
            # driver as each group drains; only the counters remain here
            for yi, year in enumerate(years):
                metrics.count('tracks', results[yi].lon.shape[0])
                metrics.count('seeds', float(results[yi].n_seeds.sum()))
                metrics.count('seeds_dropped', results[yi].n_dropped)
                metrics.count('seeds_proposed', results[yi].n_proposed)
        else:
            # per-year loop: keep one launch in flight across year
            # boundaries — year y+1's first batch is enqueued before year
            # y's results are drained, so the device never idles on the
            # host round-trip between years
            pending = pipeline.prefetch_year_batch0(
                jax.random.fold_in(key, years[0]), pack, cfg, basin_id, 0,
                mesh=mesh) if years else None
            for yi, year in enumerate(years):
                ykey = jax.random.fold_in(key, year)
                if yi + 1 < len(years):
                    nxt = pipeline.prefetch_year_batch0(
                        jax.random.fold_in(key, years[yi + 1]), pack,
                        adapt['cfg'], basin_id, yi + 1, mesh=mesh)
                else:
                    nxt = None
                with obs.phase(f'year {year}', metrics):
                    results.append(pipeline.run_tracks_year(
                        ykey, pack, cfg, basin_id, yi, mesh=mesh,
                        first_batch=pending, adapt=adapt))
                pending = nxt
                metrics.count('tracks', results[-1].lon.shape[0])
                metrics.count('seeds', float(results[-1].n_seeds.sum()))
                metrics.count('seeds_dropped', results[-1].n_dropped)
                metrics.count('seeds_proposed', results[-1].n_proposed)
                metrics.time('simulate',
                             metrics.timings.pop(f'year {year}'))
                obs.log.info('year %d: %d tracks, %d seeds, %.1f s elapsed',
                             year, results[-1].lon.shape[0],
                             int(results[-1].n_seeds.sum()),
                             time.time() - t0)
    obs.log.info('throughput: %.0f seeds/s, %.2f tracks/s',
                 metrics.rate('seeds', 'simulate'),
                 metrics.rate('tracks', 'simulate'))
    n_prop = metrics.counters.get('seeds_proposed', 0.0)
    n_drop = metrics.counters.get('seeds_dropped', 0.0)
    if n_prop and n_drop / n_prop > 1e-3:
        # all N_RETRY_ROUNDS proposal rounds missed the ocean mask for >0.1%
        # of slots: the basin's ocean fraction is far below the regime the
        # retry count was tuned on (seeding.N_RETRY_ROUNDS).  Thinning is
        # still statistically neutral, but the effective seed stream shrinks.
        obs.log.warning(
            'seeding drop rate %.2e (%d of %d slots exhausted all %d retry '
            'rounds) — consider raising seeding.N_RETRY_ROUNDS for this '
            'basin geometry', n_drop / n_prop, int(n_drop), int(n_prop),
            seeding.N_RETRY_ROUNDS)
    out = pipeline.concat_years(results, cfg)

    # ensemble-suffixed name claimed atomically by the primary BEFORE it
    # writes; multi-host runs broadcast the chosen suffix so every host
    # returns the same path without touching the filesystem themselves
    os.makedirs('%s/%s' % (cfg.output_directory, cfg.exp_name), exist_ok=True)
    fn_base = get_fn_tracks(cfg, basin_id)
    if jax.process_count() > 1:
        from jax.experimental import multihost_utils
        suffix = np.int32(-2)
        if jax.process_index() == 0:
            fn = fn_tracks_duplicates(fn_base)
            suffix = np.int32(-1 if fn == fn_base else
                              int(fn[:-3].rsplit('_e', 1)[1]))
        suffix = int(multihost_utils.broadcast_one_to_all(suffix))
        fn = fn_base if suffix < 0 else fn_base[:-3] + '_e%d.nc' % suffix
        if jax.process_index() != 0:
            # tracks are replicated; only the primary host publishes
            return fn
    else:
        fn = fn_tracks_duplicates(fn_base)
    write_tracks_nc(fn, out, cfg)
    # provenance snapshot (reference copies namelist.py, run.py:12)
    snap = fn[:-3] + '.config.json'
    with open(snap, 'w') as f:
        json.dump({k: v for k, v in cfg.__dict__.items()
                   if isinstance(v, (int, float, str, bool, tuple, list))},
                  f, indent=1, default=str)
    obs.log.info('Saved %s (%.1f s)', fn, time.time() - t0)
    return fn
