"""Command-line entry point.

Reference equivalent: run.py (basin arg, provenance copy, land-mask
generation, preprocessing, per-basin downscaling) and
util/compute.py:24-35 (compute_downscaling_inputs).
"""

from __future__ import annotations

import argparse
import os
import sys
import time

from tropical_cyclone_risk_tpu import runtime
from tropical_cyclone_risk_tpu.config import Namelist, load_namelist_py
from tropical_cyclone_risk_tpu.models import pack_builder
from tropical_cyclone_risk_tpu.preprocess import land_masks, thermo_driver, winds
from tropical_cyclone_risk_tpu.utils import compile_cache


def compute_downscaling_inputs(cfg: Namelist, overlap: bool = True) -> None:
    """Wind statistics + thermodynamic preprocessing, timed and idempotent
    (util/compute.py:24-35).

    The two stages are independent (separate inputs, separate output
    files) with complementary bottlenecks: winds streams ~95% of the raw
    workspace bytes off disk while thermo's wall time is dominated by
    on-chip CAPE-PI dispatches over ~5% of the bytes.  The reference
    serializes the stages (util/compute.py:24-35) and fans processes
    WITHIN each; here thermo runs in a worker thread while winds streams
    in the calling thread — file IO and device execution both release the
    GIL, so the disk and the device work concurrently.  ``overlap=False``
    (or env TC_SERIAL_PREPROC=1) restores the serial order for A/B
    timing.  Both stages stay individually idempotent, so a crash in one
    leaves the other's finished file reusable."""
    overlap = overlap and os.environ.get('TC_SERIAL_PREPROC', '') != '1'
    t_all = time.time()
    if not overlap:
        t0 = time.time()
        print('Computing wind mean and covariance matrices...')
        winds.gen_wind_mean_cov(cfg)
        print('Finished computing wind statistics. Time elapsed: %f s'
              % (time.time() - t0))
        t0 = time.time()
        print('Computing thermodynamic variables...')
        thermo_driver.gen_thermo(cfg)
        print('Finished computing thermodynamic variables. '
              'Time elapsed: %f s' % (time.time() - t0))
        return

    import threading
    thermo_err: list = []

    def run_thermo():
        try:
            t0 = time.time()
            thermo_driver.gen_thermo(cfg)
            print('Finished computing thermodynamic variables. '
                  'Time elapsed: %f s' % (time.time() - t0))
        except BaseException as e:       # noqa: BLE001 — re-raised below
            thermo_err.append(e)

    print('Computing wind statistics and thermodynamic variables '
          '(overlapped)...')
    th = threading.Thread(target=run_thermo, name='thermo-preproc')
    th.start()
    try:
        t0 = time.time()
        winds.gen_wind_mean_cov(cfg)
        print('Finished computing wind statistics. Time elapsed: %f s'
              % (time.time() - t0))
    finally:
        th.join()
    if thermo_err:
        raise thermo_err[0]
    print('Finished downscaling inputs. Time elapsed: %f s'
          % (time.time() - t_all))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description='Tropical cyclone downscaling in JAX '
                    '(reference CLI: run.py BASIN)')
    ap.add_argument('basin', help='basin ID (e.g. GL, NA, WP, ...)')
    ap.add_argument('--namelist', default=None,
                    help='path to a reference-style namelist.py to load')
    ap.add_argument('--n-years', type=int, default=None,
                    help='limit the number of simulated years')
    ap.add_argument('--devices', type=int, default=None,
                    help='shard seed batches over this many devices '
                         '(default: single device)')
    ap.add_argument('--ensembles', type=int, default=1,
                    help='number of ensemble members to generate (reruns '
                         'append _eN suffixes, util/compute.py:52-58)')
    ap.add_argument('--seed', type=int, default=None,
                    help='PRNG seed for a reproducible run (default: '
                         'wall clock, like the reference)')
    ap.add_argument('--trace-dir', default=None,
                    help='write a jax.profiler trace of the simulation')
    args = ap.parse_args(argv)
    compile_cache.enable()

    cfg = load_namelist_py(args.namelist) if args.namelist else Namelist()

    # validate + case-normalize the basin BEFORE minutes of preprocessing
    # (runtime would only catch it after)
    from tropical_cyclone_risk_tpu.utils import basins as basins_mod
    args.basin = basins_mod.validate_basin_id(cfg, args.basin)

    out_dir = '%s/%s' % (cfg.output_directory, cfg.exp_name)
    os.makedirs(out_dir, exist_ok=True)
    print('Output directory: %s' % out_dir)

    land_masks.generate_land_masks(cfg.fn_land, cfg.mask_dir)
    compute_downscaling_inputs(cfg)

    pack = pack_builder.build_field_pack(cfg, args.basin)
    mesh = None
    if args.devices and args.devices > 1:
        from tropical_cyclone_risk_tpu.parallel import sharding
        mesh = sharding.make_mesh(args.devices)
        pack = sharding.replicate_pack(pack, mesh)
    import jax
    for e in range(max(1, args.ensembles)):
        key = (jax.random.fold_in(jax.random.key(args.seed), e)
               if args.seed is not None else None)
        runtime.run_downscaling(cfg, args.basin, pack, key=key,
                                n_years=args.n_years, mesh=mesh,
                                trace_dir=args.trace_dir)
    return 0


if __name__ == '__main__':
    sys.exit(main())
