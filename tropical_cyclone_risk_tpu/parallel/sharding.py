"""Multi-chip scaling: data parallelism over the seed axis.

The reference scales by forking one OS process per simulated year over a
16-worker dask pool (util/compute.py:223-230, namelist.py:34).  Here the
equivalent is a flat 1-D device mesh over the *seed* axis: seeds are fully
independent until the final survivor compaction, so the integration scan runs
communication-free on every device and only the tiny compaction step moves
data between devices (one all-gather of the keep mask + a cross-device take
of the few surviving tracks).

Environmental field packs are small (1-degree global monthly stacks, tens of
MB) and are replicated into every device's memory.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from tropical_cyclone_risk_tpu.config import Namelist
from tropical_cyclone_risk_tpu.models import pipeline
from tropical_cyclone_risk_tpu.models.fields import FieldPack

SEED_AXIS = 'seeds'


def make_mesh(n_devices: Optional[int] = None) -> Mesh:
    """A 1-D mesh over all (or the first n) local devices."""
    devs = jax.devices()
    if n_devices is not None:
        if len(devs) < n_devices:
            raise ValueError(f'requested {n_devices} devices, have {len(devs)}')
        devs = devs[:n_devices]
    return Mesh(np.asarray(devs), (SEED_AXIS,))


def replicate_pack(pack: FieldPack, mesh: Mesh) -> FieldPack:
    """Place every field array replicated on the mesh (fields are small;
    the seed axis carries all the scale)."""
    sh = NamedSharding(mesh, P())
    return jax.tree_util.tree_map(lambda x: jax.device_put(x, sh), pack)


@functools.lru_cache(maxsize=32)
def _build_sharded_batch(mesh: Mesh, cfg: Namelist, basin_id: str,
                         n: int, k_max: int):
    """Compile the fused propose->integrate->filter launch SPMD over the mesh.

    Layout: every [n, ...] per-seed array is sharded on axis 0; the field
    pack and the PRNG key are replicated.  The integration is embarrassingly
    parallel; compaction after the shard_map does the only collectives.
    """
    n_dev = mesh.devices.size
    if n % n_dev:
        raise ValueError(f'seed batch {n} not divisible by {n_dev} devices')
    n_local = n // n_dev

    m_local = pipeline.launch_width(cfg, n_local)
    seg = pipeline._seg_active(cfg, m_local)

    def local_shard(key, plane_offset, pack: FieldPack):
        # decorrelate shards: fold the device index into the key; the
        # shard index offsets each later segment's column indices so they
        # address that segment's concatenated global axis
        d = jax.lax.axis_index(SEED_AXIS)
        return pipeline.launch_body(jax.random.fold_in(key, d), pack, cfg,
                                    basin_id, n_local, plane_offset,
                                    shard_index=d)

    # per-seed arrays are sharded on axis 0; time-major track buffers on
    # axis 1 (launch_body's scan-native [T, m_local] layout).  The
    # integrate-compacted track axis concatenates shard-major, preserving
    # slot order within each shard — consistent with the shard-major full
    # seed axis the stopping rule counts over.
    m_total = n_dev * m_local
    out_specs = {'seed': P(SEED_AXIS), 'trk': P(SEED_AXIS),
                 'tm': P(None, SEED_AXIS), 'overflow': P(SEED_AXIS)}
    if seg:
        out_specs['tms'] = P(None, SEED_AXIS)
        out_specs['segs'] = P(SEED_AXIS)
    sharded = jax.shard_map(
        local_shard, mesh=mesh,
        in_specs=(P(), P(), P()),
        out_specs=out_specs,
        check_vma=False)

    def launch(key, plane_offset, pack: FieldPack):
        body = sharded(key, plane_offset, pack)
        # survivor compaction (slot order): the only cross-chip step
        rep = NamedSharding(mesh, P())
        constrain = lambda a: jax.lax.with_sharding_constraint(a, rep)
        return pipeline.compact_survivors(
            body, m_total, k_max, constrain,
            n_basins=len(cfg.basin_ids_sorted()), n_shards=n_dev)

    rep = NamedSharding(mesh, P())
    return jax.jit(launch, in_shardings=(rep, rep, rep))


def simulate_batch_sharded(mesh: Mesh, key: jax.Array, pack: FieldPack,
                           cfg: Namelist, basin_id: str, n: int, k_max: int,
                           plane_offset) -> Tuple[dict, dict]:
    """SPMD equivalent of pipeline._simulate_batch over a seed mesh."""
    fn = _build_sharded_batch(mesh, pipeline._strip_tuning(cfg), basin_id,
                              n, k_max)
    return fn(key, jnp.asarray(plane_offset, jnp.int32), pack)


@functools.lru_cache(maxsize=32)
def _build_sharded_years(mesh: Mesh, cfg: Namelist, basin_id: str,
                         n: int, k_max: int):
    """SPMD counterpart of pipeline._simulate_years: batch 0 of K simulated
    years scanned inside ONE device program, each iteration running the
    seed-sharded launch (same shard layout as _build_sharded_batch) — the
    multi-chip production path gets the same K-fold dispatch amortization
    as the single-chip one.  Per-year results are bit-identical to K
    separate simulate_batch_sharded calls with the per-year batch-0 keys
    (pinned by tests/test_sharding.py::test_sharded_fused_years_identical)."""
    n_dev = mesh.devices.size
    if n % n_dev:
        raise ValueError(f'seed batch {n} not divisible by {n_dev} devices')
    n_local = n // n_dev

    m_local = pipeline.launch_width(cfg, n_local)
    seg = pipeline._seg_active(cfg, m_local)

    def local_shard(key, pack: FieldPack):
        d = jax.lax.axis_index(SEED_AXIS)
        return pipeline.launch_body(jax.random.fold_in(key, d), pack, cfg,
                                    basin_id, n_local,
                                    jnp.int32(cfg.start_month - 1),
                                    shard_index=d)

    m_total = n_dev * m_local
    out_specs = {'seed': P(SEED_AXIS), 'trk': P(SEED_AXIS),
                 'tm': P(None, SEED_AXIS), 'overflow': P(SEED_AXIS)}
    if seg:
        out_specs['tms'] = P(None, SEED_AXIS)
        out_specs['segs'] = P(SEED_AXIS)
    sharded = jax.shard_map(
        local_shard, mesh=mesh,
        in_specs=(P(), P()),
        out_specs=out_specs,
        check_vma=False)

    rep = NamedSharding(mesh, P())
    constrain = lambda a: jax.lax.with_sharding_constraint(a, rep)
    n_basins = len(cfg.basin_ids_sorted())

    def launch(key, years, plane_idx, vpot_valid, pack: FieldPack):
        # year slicing / key derivation shared with the single-device
        # fused program — pipeline.years_scan is the only copy
        return pipeline.years_scan(
            key, years, plane_idx, vpot_valid, pack, sharded,
            lambda b: pipeline.compact_survivors(
                b, m_total, k_max, constrain, n_basins=n_basins,
                n_shards=n_dev))

    return jax.jit(launch, in_shardings=(rep, rep, rep, rep, rep))


def simulate_years_sharded(mesh: Mesh, key: jax.Array, years, plane_idx,
                           vpot_valid, pack: FieldPack, cfg: Namelist,
                           basin_id: str, n: int, k_max: int
                           ) -> Tuple[dict, dict]:
    """SPMD equivalent of pipeline._simulate_years over a seed mesh."""
    fn = _build_sharded_years(mesh, pipeline._strip_tuning(cfg), basin_id,
                              n, k_max)
    return fn(key, years, plane_idx, vpot_valid, pack)
