"""Run the downscaling pipeline end to end on an NVIDIA GPU and check it.

    python chip_smoke.py              # one GPU
    python chip_smoke.py --four-gpus  # the seed-mesh path on four GPUs

One GPU runs five phases in order, each through the entry points a user
calls, and prints one line per phase (name, wall seconds, ``ok`` or the
error):

- ``device``: JAX's default device must be a GPU; prints its kind and the
  card's name and power limit from nvidia-smi.
- ``workspace``: a two-year global 1-degree synthetic ERA5 workspace
  (tools/make_synthetic_era5.py, fixed seed) in a temp directory.
- ``run``: ``cli.main(['GL', '--namelist', ...])``, the path of
  ``python run.py GL``: land masks, winds and thermo/CAPE-PI, pack build,
  the compaction-cap probes, the fused two-year driver and the NetCDF
  write; the file is read back and its schema and tracks are checked.
- ``launch``: one ``pipeline._simulate_batch`` at the benchmark width of
  131072 seeds with tuned caps; prints the compiled program's memory
  analysis and the device's peak memory.
- ``compare``: the same launch at 16384 seeds and one key on the GPU
  (twice, which must agree bit for bit) and on the CPU, whose XLA
  compilation is the reference the CPU test suite validates; the measures
  of :func:`compare_measures` must sit within ``LIMITS``.

``--four-gpus`` runs only the multi-device path and what it is compared
with: the sharded launch against its per-shard single-device emulation
(``__graft_entry__.dryrun_multichip``), then ``cli.main`` with
``--devices 4`` on a fresh workspace.

The last line of standard output is one JSON object, printed only when
every phase passed:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Any failure raises, so the exit code is non-zero.
"""

from __future__ import annotations

import argparse
import functools
import json
import re
import shutil
import sys
import tempfile
import time
from collections import Counter

import numpy as np

BASIN = 'GL'
YEARS = (2016, 2017)
TRACKS_PER_YEAR = 20
LAUNCH_SEEDS = 131072
COMPARE_SEEDS = 16384
TRACK_VARS = ('lon_trks', 'lat_trks', 'v_trks', 'm_trks', 'vmax_trks',
              'tc_month', 'tc_basins', 'tc_years', 'seeds_per_month',
              'u250_trks', 'v250_trks', 'u850_trks', 'v850_trks')
# GPU against the CPU reference: the proposal stream and the seed counts
# must be identical, the rest may differ by float32 transcendental ULPs,
# reduction order and autotuned fusions (never by TF32, which every
# contraction excludes with Precision.HIGHEST).
LIMITS = {'genesis_max_abs_deg': 1e-4,      # at most
          'jaccard_kept': 0.99,             # at least
          'median_max_abs_dv_ms': 0.1}      # at most


def require(cond, msg: str) -> None:
    """assert that survives ``python -O``."""
    if not cond:
        raise AssertionError(msg)


def phase(name: str, fn, *args, **kwargs):
    """Run one phase and print its line; a failure is printed and raised."""
    t0 = time.perf_counter()
    try:
        out = fn(*args, **kwargs)
    except BaseException as e:
        print(f'phase {name}: {time.perf_counter() - t0:.1f} s FAILED '
              f'{type(e).__name__}: {e}', flush=True)
        raise
    print(f'phase {name}: {time.perf_counter() - t0:.1f} s ok', flush=True)
    return out


# --------------------------------------------------------------- phases

def phase_device(n_devices: int = 1):
    """Require GPUs; print their kind and nvidia-smi's name and power
    limit.  Raises on any other platform: nothing runs on the CPU instead."""
    import jax
    from tropical_cyclone_risk_tpu.utils import obs
    dev = obs.require_gpu('this smoke test')
    devs = jax.devices()
    require(len(devs) >= n_devices,
            f'{n_devices} GPUs needed, JAX sees {len(devs)}')
    print(f'device_kind: {dev.device_kind} ({len(devs)} visible)')
    print(obs.gpu_name_and_power_limit(), flush=True)
    return dev


def phase_workspace(ws: str, years=YEARS,
                    tracks_per_year: int = TRACKS_PER_YEAR,
                    seed_batch: int = COMPARE_SEEDS) -> str:
    """Generate the synthetic raw workspace in-process; returns the
    namelist path."""
    from tools.make_synthetic_era5 import make_workspace
    return make_workspace(ws, years[0], years[-1],
                          tracks_per_year=tracks_per_year,
                          seed_batch=seed_batch)


def phase_run(namelist: str, extra_args=()):
    """``run.py GL`` on the workspace; checks the written file."""
    from tropical_cyclone_risk_tpu import cli, runtime
    from tropical_cyclone_risk_tpu.config import load_namelist_py
    rc = cli.main([BASIN, '--namelist', namelist, '--seed', '0',
                   *extra_args])
    require(rc == 0, f'cli.main returned {rc}')
    cfg = load_namelist_py(namelist)
    fn = runtime.get_fn_tracks(cfg, BASIN)
    check_tracks_file(fn, cfg.years(), cfg.tracks_per_year)
    return cfg


def check_tracks_file(fn: str, years, tracks_per_year: int) -> None:
    """Schema and sanity checks of a written tracks file."""
    from tropical_cyclone_risk_tpu.io import netcdf
    ds = netcdf.read(fn)
    missing = [v for v in TRACK_VARS if v not in ds]
    require(not missing, f'{fn}: missing variables {missing}')
    v = ds['v_trks'].data
    lat = ds['lat_trks'].data
    yrs = ds['tc_years'].data
    counts = {int(y): int((yrs == y).sum()) for y in years}
    require(all(c == tracks_per_year for c in counts.values())
            and v.shape[0] == tracks_per_year * len(years),
            f'tracks per year {counts}, expected {tracks_per_year}')
    peak = np.max(np.where(np.isnan(v), -np.inf, v), axis=1)
    require(peak.min() >= 15.0,
            f'peak v_trks {peak.min():.2f} m/s below 15 m/s')
    require(np.all(np.abs(lat[:, 0]) > 2.0),
            f'|lat| at genesis {np.abs(lat[:, 0]).min():.2f} not above 2')
    spm = ds['seeds_per_month'].data
    require(spm.shape[0] == len(years) and np.all(np.isfinite(spm))
            and spm.sum() > 0, f'seeds_per_month {spm.shape} invalid')
    print(f'{fn}: {v.shape[0]} tracks x {v.shape[1]} steps, tracks/year '
          f'{counts}, min peak v {peak.min():.2f} m/s, min |genesis lat| '
          f'{np.abs(lat[:, 0]).min():.2f}, seeds counted {int(spm.sum())}',
          flush=True)


def phase_launch(cfg, n: int = LAUNCH_SEEDS, k_max: int = 64):
    """One widest-width launch on the workspace pack with tuned caps.
    Returns the pack for the compare phase."""
    import jax
    import jax.numpy as jnp
    from tropical_cyclone_risk_tpu.models import fields, pack_builder, pipeline
    pack = pack_builder.build_field_pack(cfg, BASIN)
    cfg_b = pipeline.auto_integrate_cap(jax.random.key(1), pack,
                                        cfg.replace(seed_batch=n), BASIN)
    print(f'tuned caps at {n} seeds: integrate_cap={cfg_b.integrate_cap} '
          f'(width {pipeline.launch_width(cfg_b, n)}), recompact '
          f'{cfg_b.recompact_schedule}', flush=True)
    pack_y = fields.slice_pack_year(pack, cfg_b, 0)
    key = jax.random.key(2)
    off = jnp.int32(cfg_b.start_month - 1)
    t0 = time.perf_counter()
    compiled = pipeline._simulate_batch_jit.lower(
        key, pack_y, pipeline._strip_tuning(cfg_b), BASIN, n, k_max,
        off).compile()
    print(f'launch compile: {time.perf_counter() - t0:.1f} s', flush=True)
    print(f'memory_analysis: {compiled.memory_analysis()}', flush=True)
    hlo = compiled.as_text()
    calls = Counter(re.findall(r'custom_call_target="([^"]+)"', hlo))
    print(f'compiled HLO: {len(re.findall(r" dot[(]", hlo))} dot ops, '
          f'custom calls {dict(calls)}', flush=True)
    t0 = time.perf_counter()
    tracks, meta = jax.block_until_ready(compiled(key, pack_y, off))
    print(f'launch run: {time.perf_counter() - t0:.3f} s', flush=True)
    stats = jax.devices()[0].memory_stats() or {}
    print(f'peak_bytes_in_use: {stats.get("peak_bytes_in_use")} of '
          f'bytes_limit {stats.get("bytes_limit")}', flush=True)
    scal = np.asarray(meta['scalars'])
    n_keep = int(scal[0])
    require(n_keep > 0, 'widest launch kept no storm')
    lon = np.asarray(tracks['lon'])[:min(n_keep, k_max)]
    require(np.all(np.isfinite(lon[:, 0])), 'survivor genesis not finite')
    print(f'survivors {n_keep}, overflow {scal[1]}/{scal[2]}, dropped '
          f'{scal[3]}', flush=True)
    return pack


@functools.lru_cache(maxsize=None)
def _genesis_fn():
    import jax
    from tropical_cyclone_risk_tpu.models import seeding

    @functools.partial(jax.jit, static_argnames=('cfg', 'basin_id', 'n'))
    def genesis(key, pack, cfg, basin_id, n, plane_offset):
        # the proposal half of pipeline.launch_body's key split
        k_seed, _ = jax.random.split(key)
        prop = seeding.propose_seeds(k_seed, pack, cfg, basin_id, n,
                                     plane_offset)
        return prop.lon, prop.lat, prop.counted
    return genesis


def launch_on(device, key, pack, cfg, n: int, k_max: int,
              basin_id: str = BASIN) -> dict:
    """One ``_simulate_batch`` with every input placed on ``device``;
    returns the host arrays :func:`compare_measures` reads."""
    import jax
    import jax.numpy as jnp
    from tropical_cyclone_risk_tpu.models import pipeline
    with jax.default_device(device):
        key_d, pack_d = jax.device_put((key, pack), device)
        off = jnp.int32(cfg.start_month - 1)
        tracks, meta = pipeline._simulate_batch(key_d, pack_d, cfg, basin_id,
                                                n, k_max, off)
        lon0, lat0, counted = _genesis_fn()(
            key_d, pack_d, pipeline._strip_tuning(cfg), basin_id, n, off)
        tracks, meta, lon0, lat0, counted = jax.device_get(
            (tracks, meta, lon0, lat0, counted))
    valid = np.asarray(tracks['valid'])
    return {'device': str(device), 'spm_all': meta['spm_all'],
            'counted': counted, 'lon0': lon0, 'lat0': lat0,
            'keep': meta['keep'], 'v': tracks['v'][valid],
            'vmax': tracks['vmax'][valid]}


def compare_measures(test: dict, ref: dict) -> dict:
    """Agreement of two launches of the same key (see :func:`launch_on`):
    per-basin-month proposal counts, genesis positions of counted seeds,
    the kept-slot sets, intensity along tracks kept by both, and the LMI
    distributions (two-sample KS)."""
    from scipy.stats import ks_2samp
    both = test['counted'] & ref['counted']
    gen = max(np.max(np.abs(test['lon0'] - ref['lon0'])[both], initial=0.0),
              np.max(np.abs(test['lat0'] - ref['lat0'])[both], initial=0.0))
    ka, kb = np.flatnonzero(test['keep']), np.flatnonzero(ref['keep'])
    common = np.intersect1d(ka, kb)
    union = np.union1d(ka, kb)
    # survivor track rows are slot-ordered: row i is the i-th kept slot
    ra, rb = np.searchsorted(ka, common), np.searchsorted(kb, common)
    ok = (ra < len(test['v'])) & (rb < len(ref['v']))
    va, vb = test['v'][ra[ok]], ref['v'][rb[ok]]
    dv = np.abs(va - vb)
    max_dv = np.where(np.isnan(dv), 0.0, dv).max(axis=1, initial=0.0)
    lmi = lambda x: np.max(np.where(np.isnan(x), -np.inf, x), axis=1)
    la, lb = lmi(test['vmax']), lmi(ref['vmax'])
    ks = (float(ks_2samp(la, lb).statistic) if la.size and lb.size
          else float(la.size != lb.size))
    na, nb = max(la.size, 1), max(lb.size, 1)
    return {
        'proposal_counts_identical': bool(
            np.array_equal(test['spm_all'], ref['spm_all'])
            and np.array_equal(test['counted'], ref['counted'])),
        'genesis_max_abs_deg': float(gen),
        'jaccard_kept': float(common.size / union.size) if union.size
        else 1.0,
        'median_max_abs_dv_ms': float(np.median(max_dv)) if max_dv.size
        else 0.0,
        'lifetime_mismatches': int(np.sum(np.isnan(va) != np.isnan(vb),
                                          axis=1).astype(bool).sum()),
        'ks_lmi': ks,
        'ks_lmi_1pct_critical': float(1.628 * np.sqrt((na + nb) / (na * nb))),
        'n_kept_test': int(ka.size), 'n_kept_ref': int(kb.size),
        'n_kept_both': int(common.size),
    }


def check_measures(m: dict) -> None:
    """Raise when a :func:`compare_measures` result is past its limit."""
    bad = []
    if not m['proposal_counts_identical']:
        bad.append('proposal counts differ')
    if m['genesis_max_abs_deg'] > LIMITS['genesis_max_abs_deg']:
        bad.append('genesis_max_abs_deg')
    if m['jaccard_kept'] < LIMITS['jaccard_kept']:
        bad.append('jaccard_kept')
    if m['median_max_abs_dv_ms'] > LIMITS['median_max_abs_dv_ms']:
        bad.append('median_max_abs_dv_ms')
    if m['ks_lmi'] >= m['ks_lmi_1pct_critical']:
        bad.append('ks_lmi')
    if min(m['n_kept_test'], m['n_kept_ref']) == 0:
        bad.append('no survivors')
    require(not bad, f'compare past its limits: {bad} in {m}')


def same_bits(a: dict, b: dict) -> bool:
    return all(np.array_equal(a[k], b[k], equal_nan=a[k].dtype.kind == 'f')
               for k in a if k != 'device')


def phase_compare(cfg, pack, n: int = COMPARE_SEEDS):
    """GPU against the XLA-CPU reference at one key and width."""
    import jax
    from tropical_cyclone_risk_tpu.models import fields, pipeline
    cfg_c = pipeline.auto_integrate_cap(jax.random.key(3), pack,
                                        cfg.replace(seed_batch=n), BASIN)
    pack_y = jax.device_get(fields.slice_pack_year(pack, cfg_c, 0))
    k_max = pipeline.launch_width(cfg_c, n)     # room for every survivor
    key = jax.random.key(4)
    gpu, cpu = jax.devices()[0], jax.devices('cpu')[0]
    runs = {}
    for label, dev in (('gpu', gpu), ('gpu_again', gpu), ('cpu', cpu)):
        t0 = time.perf_counter()
        runs[label] = launch_on(dev, key, pack_y, cfg_c, n, k_max)
        print(f'compare {label} on {runs[label]["device"]}: '
              f'{time.perf_counter() - t0:.1f} s', flush=True)
    require(same_bits(runs['gpu'], runs['gpu_again']),
            'two GPU launches of one key differ within one process')
    m = compare_measures(runs['gpu'], runs['cpu'])
    print('compare gpu vs cpu: ' + json.dumps(m), flush=True)
    check_measures(m)
    return m


# ----------------------------------------------------------------- main

def _device_line() -> str:
    import jax
    dev = jax.devices()[0]
    return json.dumps({'ok': True, 'device': {
        'platform': dev.platform, 'kind': dev.device_kind,
        'count': len(jax.devices())}})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--four-gpus', action='store_true',
                    help='run only the four-GPU seed-mesh path')
    args = ap.parse_args(argv)
    from tropical_cyclone_risk_tpu.utils import compile_cache
    print(f'compile cache: {compile_cache.enable()}', flush=True)
    ws = tempfile.mkdtemp(prefix='tc_smoke_')
    try:
        if args.four_gpus:
            phase('device', phase_device, 4)
            from __graft_entry__ import dryrun_multichip
            phase('mesh_identity', dryrun_multichip, 4)
            nl = phase('workspace', phase_workspace, ws)
            phase('run_devices_4', phase_run, nl,
                  ('--devices', '4', '--n-years', str(len(YEARS))))
        else:
            phase('device', phase_device)
            nl = phase('workspace', phase_workspace, ws)
            cfg = phase('run', phase_run, nl)
            pack = phase('launch', phase_launch, cfg)
            phase('compare', phase_compare, cfg, pack)
    finally:
        shutil.rmtree(ws, ignore_errors=True)
    print(_device_line(), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
