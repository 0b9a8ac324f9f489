"""A/B the production year drivers on the device.

Measures seconds/simulated-year for the per-year pipelined loop and for
run_tracks_years_fused at k_fuse in {2, 4, 8} on the same 8-year
synthetic pack bench.py uses (same program shapes -> warm compile cache
for k_fuse=8 and the unfused loop).  Run on a quiet host.

k trades per-program dispatch amortization (one program and one host
round trip per k years) against group-pipeline depth (an L-year run has
L/k groups; 2-deep pipelining needs several groups to hide the per-group
host fetch), so the best k grows with the run length.  Every timed pass
ends in host fetches of the track rows, so it times execution.

Usage: python tools/bench_fused_years.py [N_YEARS] [k ...] (defaults:
8 years, loop + k in {8, 4, 2}; pass 0 as a k to run the per-year loop).
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

from tropical_cyclone_risk_tpu.config import Namelist  # noqa: E402
from tropical_cyclone_risk_tpu.models import pipeline  # noqa: E402
from tropical_cyclone_risk_tpu.models.fields import synthetic_pack  # noqa: E402
from tropical_cyclone_risk_tpu.utils import compile_cache  # noqa: E402

N = 131072
N_YEARS = 8
REPS = 3


def time_fused(pack, cfg, years, k_fuse):
    out = pipeline.run_tracks_years_fused(jax.random.key(99), pack, cfg,
                                          'GL', years, k_fuse=k_fuse)
    assert all(y.lon.shape[0] == cfg.tracks_per_year for y in out)
    t0 = time.perf_counter()
    for r in range(REPS):
        pipeline.run_tracks_years_fused(jax.random.key(100 + r), pack, cfg,
                                        'GL', years, k_fuse=k_fuse)
    return (time.perf_counter() - t0) / (REPS * len(years))


def time_loop(pack, cfg, years):
    ykey = jax.random.key(100)
    pipeline.run_tracks_year(jax.random.fold_in(ykey, 9999), pack, cfg,
                             'GL', 0)  # warm
    t_all = 0.0
    for r in range(REPS):
        rkey = jax.random.key(100 + r)
        pending = pipeline.prefetch_year_batch0(
            jax.random.fold_in(rkey, 0), pack, cfg, 'GL', 0)
        t0 = time.perf_counter()
        for yi in range(len(years)):
            nxt = (pipeline.prefetch_year_batch0(
                jax.random.fold_in(rkey, yi + 1), pack, cfg, 'GL', yi + 1)
                if yi + 1 < len(years) else None)
            pipeline.run_tracks_year(jax.random.fold_in(rkey, yi), pack,
                                     cfg, 'GL', yi, first_batch=pending)
            pending = nxt
        t_all += time.perf_counter() - t0
    return t_all / (REPS * len(years))


def main():
    compile_cache.enable()
    print(f'device: {jax.devices()[0].device_kind}', flush=True)
    n_years = int(sys.argv[1]) if len(sys.argv) > 1 else N_YEARS
    ks = ([int(a) for a in sys.argv[2:]] if len(sys.argv) > 2
          else [0, 8, 4, 2])
    cfg = Namelist().replace(seed_batch=N)
    pack12 = jax.device_put(synthetic_pack(cfg, n_planes=12, nlat=181,
                                           nlon=360, seed=0))
    cfg = pipeline.auto_integrate_cap(jax.random.key(0), pack12, cfg, 'GL')
    print(f'caps: integrate={cfg.integrate_cap} '
          f'sched={cfg.recompact_schedule}', flush=True)
    t_p = time.perf_counter()
    pack = jax.device_put(synthetic_pack(cfg, n_planes=12 * n_years,
                                         nlat=181, nlon=360, seed=0))
    jax.block_until_ready(pack)
    print(f'pack: {12 * n_years} planes '
          f'[device_put {time.perf_counter() - t_p:.0f} s]', flush=True)
    years = list(range(2016, 2016 + n_years))

    for k_fuse in ks:
        t_c = time.perf_counter()
        if k_fuse == 0:
            s = time_loop(pack, cfg, years)
            name = 'per-year loop (2-deep pipelined)'
        else:
            s = time_fused(pack, cfg, years, k_fuse)
            name = f'fused k={k_fuse}'
        print(f'{name}: {s:.4f} s/sim-year '
              f'({60.0 / s:.0f} years/min) '
              f'[first call incl. compile {time.perf_counter() - t_c:.0f} s]',
              flush=True)


if __name__ == '__main__':
    main()
