"""Throughput benchmark: synthetic-storm lifecycles integrated per minute per chip.

The benchmark unit is the fused downscaling launch (propose seeds ->
361-step coupled FAST/beta-advection integration -> TC filters -> survivor
compaction) on an ERA5-resolution (1-degree, 12-month) global environment —
the hot path of the reference's run_downscaling (util/compute.py:64-210),
which integrates one storm at a time with scipy.solve_ivp.

What each emitted number counts (round-3 clarification):

- storm_lifecycles_per_min_per_chip (headline, the BENCH metric): PROPOSED
  SEEDS processed per minute.  One seed = one iteration of the reference's
  rejection loop (util/compute.py:134-210) — proposal, all seeding gates,
  and, for gate-passing seeds, the full 361-step integration + TC filters.
  Integrate-compaction means only gate-passing slots physically enter the
  scan; trajectories and survivor verdicts are bit-identical to
  integrating every slot (diagnostics to float32 ULP fusion noise; pinned
  by tests), so a proposed seed is a completed unit of model work either
  way.
- detail.scan_rows_per_min: slot-steps actually integrated per minute
  (launch scan width x steps, summed over segments) — the raw integration
  throughput with no seeding-gate amplification.
- detail.surviving_tcs_per_min: storms passing every TC filter per minute
  (the survivors written to the output NetCDF).
- detail.sim_years_per_min: production steady state — simulated years per
  minute through the runtime.run_downscaling default (quota fill, seed
  accounting, stopping rule, host fetch of survivor tracks), the
  end-to-end rate a real run sustains.  The year driver integrates only a
  speculative quota-sized prefix of the integrable slots with an exact
  on-device validity check (pipeline.quota_cfg; bit-identical outputs)
  and fuses batch 0 of years_per_program years into one program.
  detail.seconds_per_sim_year_unfused_loop is the same work through the
  per-year pipelined loop (years_per_program=1).

Launch timings block on the launch outputs (jax.block_until_ready); the
year-driver timings end in host fetches of the tracks.  Runs only on a GPU
and names the device (JAX device_kind, nvidia-smi name and power limit).

Prints ONE JSON line.  vs_baseline is measured against the north star of
100k storm lifecycles/min/chip (BASELINE.json; the reference itself
publishes no numbers — BASELINE.md)."""

import json
import time

import jax
import jax.numpy as jnp

from tropical_cyclone_risk_tpu.config import Namelist
from tropical_cyclone_risk_tpu.models import pipeline
from tropical_cyclone_risk_tpu.models.fields import synthetic_pack
from tropical_cyclone_risk_tpu.utils import compile_cache, obs

NORTH_STAR_PER_MIN = 100_000.0


def scan_rows_per_launch(cfg: Namelist, n: int) -> int:
    """Slot-steps the integration scan actually executes per launch."""
    m = pipeline.launch_width(cfg, n)
    T = cfg.n_steps_output
    edges, widths = pipeline.seg_edges_widths(
        pipeline.seg_schedule(cfg, m), m, T)
    return sum(w * (edges[i + 1] - edges[i])
               for i, w in enumerate(widths))


def main():
    compile_cache.enable()
    dev = obs.require_gpu('bench.py')
    card = obs.gpu_name_and_power_limit()
    print(f'device_kind: {dev.device_kind}; nvidia-smi: {card}', flush=True)
    n_seeds = 131072
    cfg = Namelist().replace(seed_batch=n_seeds)
    pack = synthetic_pack(cfg, n_planes=12, nlat=181, nlon=360, seed=0)
    pack = jax.device_put(pack)
    # resolve the integrate-compaction cap exactly as a production run does
    cfg = pipeline.auto_integrate_cap(jax.random.key(0), pack, cfg, 'GL')

    launch = pipeline._simulate_batch
    k_max = 64

    # warm-up / compile
    jax.block_until_ready(launch(jax.random.key(0), pack, cfg, 'GL',
                                 n_seeds, k_max, jnp.int32(0)))

    # steady state: a block of launches with distinct keys (fresh RNG
    # each), all enqueued back to back and timed until every output is
    # ready, so dispatch overlaps device execution.  The block repeats;
    # the headline uses the MEDIAN block and min/max go to detail, so
    # every conclusion drawn from this record carries its spread.
    n_iter = 5
    n_rep = 3
    block_dts = []
    survivors = 0
    for r in range(n_rep):
        k0 = 1 + r * n_iter
        t0 = time.perf_counter()
        outs = [launch(jax.random.key(k0 + i), pack, cfg, 'GL', n_seeds,
                       k_max, jnp.int32(0)) for i in range(n_iter)]
        jax.block_until_ready(outs)
        block_dts.append(time.perf_counter() - t0)
        survivors += sum(int(meta['scalars'][0]) for _, meta in outs)
    dt = sorted(block_dts)[n_rep // 2]

    per_min = n_seeds * n_iter / dt * 60.0
    rows_min = scan_rows_per_launch(cfg, n_seeds) * n_iter / dt * 60.0
    tcs_min = survivors / (sum(block_dts)) * 60.0

    # production steady state: simulated years/min through the runtime
    # default — the fused multi-year driver at years_per_program=2 (batch
    # 0 of 2 years per device program, two group programs in flight).  An
    # 8-year synthetic pack (96 monthly planes) exercises real per-year
    # field slicing.
    n_years = 8
    pack_y = jax.device_put(synthetic_pack(cfg, n_planes=12 * n_years,
                                           nlat=181, nlon=360, seed=0))
    years = list(range(2016, 2016 + n_years))
    k_fuse = max(1, cfg.years_per_program)
    out_f = pipeline.run_tracks_years_fused(jax.random.key(99), pack_y,
                                            cfg, 'GL', years,
                                            k_fuse=k_fuse)       # warm
    assert all(y.lon.shape[0] == cfg.tracks_per_year for y in out_f)
    years_dts = []
    for r in range(3):                    # warm passes; median reported
        t1 = time.perf_counter()
        out_f = pipeline.run_tracks_years_fused(
            jax.random.key(100 + r), pack_y, cfg, 'GL', years,
            k_fuse=k_fuse)
        assert all(y.lon.shape[0] == cfg.tracks_per_year for y in out_f)
        years_dts.append(time.perf_counter() - t1)
    dt_years = sorted(years_dts)[len(years_dts) // 2]

    # the per-year pipelined loop (years_per_program=1)
    ykey = jax.random.key(100)
    pipeline.run_tracks_year(jax.random.fold_in(ykey, 9999), pack_y, cfg,
                             'GL', 0)                      # warm compiles
    loop_dts = []
    for _ in range(3):                    # warm passes; median reported
        pending = pipeline.prefetch_year_batch0(
            jax.random.fold_in(ykey, 0), pack_y, cfg, 'GL', 0)
        t1 = time.perf_counter()
        for yi in range(n_years):
            nxt = (pipeline.prefetch_year_batch0(
                jax.random.fold_in(ykey, yi + 1), pack_y, cfg, 'GL',
                yi + 1) if yi + 1 < n_years else None)
            out_y = pipeline.run_tracks_year(
                jax.random.fold_in(ykey, yi), pack_y, cfg, 'GL', yi,
                first_batch=pending)
            assert out_y.lon.shape[0] == cfg.tracks_per_year
            pending = nxt
        loop_dts.append(time.perf_counter() - t1)
    dt_loop = sorted(loop_dts)[len(loop_dts) // 2]

    print(json.dumps({
        'metric': 'storm_lifecycles_per_min_per_chip',
        'value': round(per_min, 1),
        'unit': 'storms/min/chip',
        'vs_baseline': round(per_min / NORTH_STAR_PER_MIN, 3),
        'detail': {
            'n_seeds_per_launch': n_seeds,
            'n_steps': cfg.n_steps_output,
            'launch_seconds': round(dt / n_iter, 4),
            'launch_seconds_spread': [round(d / n_iter, 4)
                                      for d in sorted(block_dts)],
            'scan_rows_per_min': round(rows_min, 1),
            'surviving_tcs_per_min': round(tcs_min, 1),
            'sim_years_per_min': round(n_years / dt_years * 60.0, 2),
            'seconds_per_sim_year': round(dt_years / n_years, 4),
            'seconds_per_sim_year_spread': [round(d / n_years, 4)
                                            for d in sorted(years_dts)],
            'seconds_per_sim_year_unfused_loop': round(dt_loop / n_years,
                                                       4),
            'seconds_per_sim_year_unfused_spread': [
                round(d / n_years, 4) for d in sorted(loop_dts)],
            'survivors_per_launch': round(survivors / (n_rep * n_iter), 1),
            'integrate_cap': cfg.integrate_cap,
            'recompact': (list(cfg.recompact_schedule)
                          if cfg.recompact_schedule is not None
                          else [cfg.recompact_step, cfg.recompact_cap]),
            'field_sample_stride': cfg.field_sample_stride,
            'units_note': ('storms/min counts proposed seeds (reference '
                           'rejection-loop iterations, bit-identical '
                           'outputs to integrating all slots); fields '
                           'sampled once per field_sample_stride steps '
                           '(240k-seed chain parity at this default: '
                           'docs/chain_parity.json, stride-insensitive '
                           'residual bias quantified in '
                           'docs/chain_parity_bias.md)'),
            'device': str(dev),
            'platform': dev.platform,
            'device_kind': dev.device_kind,
            'device_count': len(jax.devices()),
            'gpu_name_power_limit': card,
        },
    }))


if __name__ == '__main__':
    main()
