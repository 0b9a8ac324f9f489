"""Two-process jax.distributed integration test, including fused
multi-year SPMD coverage.

Spawns two coordinated CPU processes (4 virtual devices each -> a global
8-device seed mesh over gloo collectives) running the real production driver
over a TWO-year run with years_per_program=2 — so the fused multi-year SPMD
program (sharding._build_sharded_years) and the multi-host ensemble-filename
broadcast execute multi-process — then asserts:

  - the key broadcast and global mesh assemble (worker-side asserts),
  - both processes compute identical replicated survivor populations,
  - both agree on the output path but only the primary writes it,
  - the written tracks are BIT-IDENTICAL to the same cfg/key run on a
    single-process 8-virtual-device mesh (this pytest process).

The reference has no distributed backend at all (SURVEY.md section 5); this
covers the repo's own multi-host commitment (parallel/distributed.py), which
otherwise only ever ran single-process.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

pytestmark = pytest.mark.slow  # two coordinated OS processes over gloo (~minutes)


WORKER = Path(__file__).parent / 'distributed_worker.py'
REPO = Path(__file__).parent.parent

TRACK_VARS = ('lon_trks', 'lat_trks', 'v_trks', 'm_trks', 'vmax_trks',
              'tc_month', 'tc_years', 'seeds_per_month')


def test_two_process_distributed(tmp_path):
    env = {k: v for k, v in os.environ.items()
           if k not in ('XLA_FLAGS', 'JAX_PLATFORMS')}
    env['PYTHONPATH'] = f"{REPO}{os.pathsep}" + env.get('PYTHONPATH', '')
    port = '29731'
    procs = [subprocess.Popen(
        [sys.executable, str(WORKER), str(i), str(tmp_path), port],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for i in range(2)]
    outs = [p.communicate(timeout=540)[0] for p in procs]
    for i, p in enumerate(procs):
        assert p.returncode == 0, f'worker {i} failed:\n{outs[i][-4000:]}'

    r0 = np.load(tmp_path / 'proc0.npz')
    r1 = np.load(tmp_path / 'proc1.npz')
    assert int(r0['n_global_devices']) == 8
    assert int(r0['process_index']) == 0 and int(r1['process_index']) == 1

    # key broadcast: both processes must see process 0's draw
    assert int(r0['bseed']) == 1000 and int(r1['bseed']) == 1000

    # same output path on both hosts; written exactly once, by the primary
    assert str(r0['fn']) == str(r1['fn'])
    assert os.path.exists(str(r0['fn']))
    assert int(r0['writes']) == 1, 'primary must write'
    assert int(r1['writes']) == 0, 'non-primary must not write'

    # replicated fused-driver survivor populations agree bit-for-bit
    np.testing.assert_array_equal(r0['month'], r1['month'])
    np.testing.assert_array_equal(r0['n_seeds'], r1['n_seeds'])
    np.testing.assert_array_equal(r0['vmax'], r1['vmax'])
    np.testing.assert_array_equal(r0['lon'], r1['lon'])
    assert r0['month'].shape[0] == 4          # 2 tracks/year x 2 years
    assert r0['n_seeds'].shape[0] == 2        # per-year stopping-rule rows

    # single-process identity: the same cfg/key on this process's own
    # 8-virtual-device mesh must write bit-identical tracks
    import jax
    from tropical_cyclone_risk_tpu import runtime
    from tropical_cyclone_risk_tpu.config import Namelist
    from tropical_cyclone_risk_tpu.io import netcdf
    from tropical_cyclone_risk_tpu.models.fields import synthetic_pack
    from tropical_cyclone_risk_tpu.parallel import sharding

    sp_dir = tmp_path / 'single_process'
    cfg = Namelist(seed_batch=512, tracks_per_year=2,
                   start_year=2016, end_year=2017, years_per_program=2,
                   output_directory=str(sp_dir), exp_name='dist')
    mesh = sharding.make_mesh(8)
    pack = sharding.replicate_pack(
        synthetic_pack(cfg, n_planes=24, nlat=46, nlon=90, seed=0), mesh)
    fn_sp = runtime.run_downscaling(cfg, 'GL', pack, key=jax.random.key(11),
                                    mesh=mesh)

    ds_mp = netcdf.read(str(r0['fn']))
    ds_sp = netcdf.read(fn_sp)
    for name in TRACK_VARS:
        np.testing.assert_array_equal(
            np.nan_to_num(ds_mp.variables[name].data),
            np.nan_to_num(ds_sp.variables[name].data),
            err_msg=f'{name} diverges between 2-process and single-process '
                    'mesh runs')
