"""Worker program for the two-process jax.distributed test (spawned by
tests/test_distributed.py).  Runs the real sharded pipeline over the global
8-device (2 process x 4 local CPU device) seed mesh and records what this
process observed, so the parent test can assert cross-process agreement and
the primary-only write contract.

The run is TWO years with years_per_program=2, so the FUSED multi-year SPMD
program (sharding._build_sharded_years via pipeline.run_tracks_years_fused)
and the multi-host ensemble-filename broadcast execute across coordinated
processes — previously they only ever ran on a single-process virtual mesh.

Usage: python distributed_worker.py PROC_ID TMPDIR PORT
"""

import os
import sys

proc_id = int(sys.argv[1])
tmpdir = sys.argv[2]
port = sys.argv[3]

os.environ['XLA_FLAGS'] = '--xla_force_host_platform_device_count=4'

import jax  # noqa: E402

jax.config.update('jax_platforms', 'cpu')
jax.config.update('jax_threefry_partitionable', True)
jax.config.update('jax_cpu_collectives_implementation', 'gloo')

import numpy as np  # noqa: E402

from jax.experimental import multihost_utils  # noqa: E402

from tropical_cyclone_risk_tpu import runtime  # noqa: E402
from tropical_cyclone_risk_tpu.config import Namelist  # noqa: E402
from tropical_cyclone_risk_tpu.models import pipeline  # noqa: E402
from tropical_cyclone_risk_tpu.models.fields import synthetic_pack  # noqa: E402
from tropical_cyclone_risk_tpu.parallel import distributed, sharding  # noqa: E402


def main():
    distributed.initialize(f'localhost:{port}', 2, proc_id)
    assert jax.process_count() == 2, jax.process_count()
    mesh = distributed.global_seed_mesh()
    assert mesh.devices.size == 8, mesh

    # same cfg/key as the parent's single-process identity run
    cfg = Namelist(seed_batch=512, tracks_per_year=2,
                   start_year=2016, end_year=2017, years_per_program=2,
                   output_directory=tmpdir, exp_name='dist')
    key = jax.random.key(11)
    pack = synthetic_pack(cfg, n_planes=24, nlat=46, nlon=90, seed=0)
    pack = sharding.replicate_pack(pack, mesh)

    # the wall-clock key broadcast contract (run_downscaling key=None path):
    # every process must see process 0's draw
    bseed = int(multihost_utils.broadcast_one_to_all(
        np.int32(1000 + 17 * proc_id)))

    # count local output writes (only the primary may write)
    writes = {'n': 0}
    orig_write = runtime.write_tracks_nc

    def counting_write(path, out, cfg_):
        writes['n'] += 1
        return orig_write(path, out, cfg_)
    runtime.write_tracks_nc = counting_write

    # full production driver: fused 2-year SPMD program, multi-host
    # filename broadcast, primary-only write
    fn = runtime.run_downscaling(cfg, 'GL', pack, key=key, mesh=mesh)

    # re-run the fused driver directly (identical cfg resolution to
    # run_downscaling) so THIS process's replicated per-year survivor
    # arrays are recorded for cross-process bit-identity checks — the
    # non-primary never writes the file, so its results are otherwise
    # invisible to the parent
    cfg_r = pipeline.auto_integrate_cap(
        jax.random.fold_in(key, 2016), pack, cfg, 'GL')
    yts = pipeline.run_tracks_years_fused(
        key, pack, cfg_r, 'GL', [2016, 2017], adapt={'cfg': cfg_r},
        mesh=mesh)

    np.savez(os.path.join(tmpdir, f'proc{proc_id}.npz'),
             fn=np.array(fn), writes=np.int32(writes['n']),
             process_index=np.int32(jax.process_index()),
             n_global_devices=np.int32(len(jax.devices())),
             bseed=np.int32(bseed),
             month=np.concatenate([y.month for y in yts]),
             vmax=np.nan_to_num(np.concatenate([y.vmax for y in yts])),
             lon=np.nan_to_num(np.concatenate([y.lon for y in yts])),
             n_seeds=np.stack([y.n_seeds for y in yts]))
    print(f'worker {proc_id} done', flush=True)


if __name__ == '__main__':
    main()
