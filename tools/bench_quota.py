"""On-device A/B of the speculative quota prefix (pipeline.quota_cfg).

Times the production steady-state year loop (run_tracks_year with the
2-deep prefetch pipelining, whose every year ends in a host fetch of its
tracks) with quota_prefix on vs off on the same auto-tuned config, plus
the raw widths.

Usage: python tools/bench_quota.py [n_years]
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


def time_years(cfg, pack, n_years, label):
    ykey = jax.random.key(100)
    pipeline.run_tracks_year(jax.random.fold_in(ykey, 9999), pack, cfg,
                             'GL', 0)                      # warm compiles
    dt = None
    for _ in range(2):                    # second pass: everything warm
        pending = pipeline.prefetch_year_batch0(
            jax.random.fold_in(ykey, 0), pack, cfg, 'GL', 0)
        t1 = time.perf_counter()
        for yi in range(n_years):
            nxt = (pipeline.prefetch_year_batch0(
                jax.random.fold_in(ykey, yi + 1), pack, cfg, 'GL',
                yi + 1) if yi + 1 < n_years else None)
            out_y = pipeline.run_tracks_year(
                jax.random.fold_in(ykey, yi), pack, cfg, 'GL', yi,
                first_batch=pending)
            assert out_y.lon.shape[0] == cfg.tracks_per_year
            pending = nxt
        dt = time.perf_counter() - t1
    print(f'{label}: {dt / n_years * 1000:.1f} ms/sim-year '
          f'({n_years / dt * 60:.0f} sim-years/min)', flush=True)
    return dt / n_years


def main():
    compile_cache.enable()
    print(f'device: {jax.devices()[0].device_kind}', flush=True)
    n_years = int(sys.argv[1]) if len(sys.argv) > 1 else 8
    cfg = Namelist().replace(seed_batch=131072)
    pack = jax.device_put(synthetic_pack(cfg, n_planes=12, nlat=181,
                                         nlon=360, seed=0))
    cfg = pipeline.auto_integrate_cap(jax.random.key(0), pack, cfg, 'GL')
    print('tuned: cap', cfg.integrate_cap, 'rate', cfg.survivors_per_slot,
          flush=True)
    cq = pipeline.quota_cfg(cfg, cfg.tracks_per_year, cfg.seed_batch, 1)
    m_full = pipeline.launch_width(cfg, cfg.seed_batch)
    print('quota width', None if cq is None else cq.integrate_width,
          'vs tuned m', m_full, flush=True)

    pack_y = jax.device_put(synthetic_pack(cfg, n_planes=12 * n_years,
                                           nlat=181, nlon=360, seed=0))
    t_off = time_years(cfg.replace(quota_prefix=False), pack_y, n_years,
                       'quota OFF')
    t_on = time_years(cfg, pack_y, n_years, 'quota ON ')
    print(f'speedup: {t_off / t_on:.2f}x', flush=True)


if __name__ == '__main__':
    main()
