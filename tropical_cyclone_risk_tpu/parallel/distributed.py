"""Multi-host scaling over DCN.

The reference has no distributed backend at all (SURVEY.md section 5 —
dask 'processes' on one machine is its only parallelism).  Here multi-host
runs use jax.distributed: every host runs the same run_downscaling program,
the seed mesh spans all global devices, integration stays communication-free,
and the one compaction all-gather crosses the host network.
Host 0 writes the output file (tracks come back replicated).

Usage (same command on every host):

    from tropical_cyclone_risk_tpu.parallel import distributed, sharding
    distributed.initialize()             # env-driven, or pass explicit args
    mesh = distributed.global_seed_mesh()
    runtime.run_downscaling(cfg, basin, sharding.replicate_pack(pack, mesh),
                            mesh=mesh)
"""

from __future__ import annotations

import os
from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh

from tropical_cyclone_risk_tpu.parallel.sharding import SEED_AXIS

# Env vars that configure a coordinator when no explicit args are given
# (jax.distributed.initialize reads these; cluster auto-detection beyond
# them — SLURM, Open MPI and other cluster environments — is probed via
# _cluster_detectable).
_COORD_ENV_VARS = ('JAX_COORDINATOR_ADDRESS', 'COORDINATOR_ADDRESS')


def _already_initialized() -> bool:
    """Explicit client-state probe — never inspects exception text."""
    return bool(jax.distributed.is_initialized())


def _cluster_detectable() -> bool:
    """True when JAX's cluster auto-detection would resolve a coordinator
    (SLURM, Open MPI, ...) with no explicit args."""
    try:
        from jax._src.clusters import ClusterEnv
        return any(c.is_env_present() for c in ClusterEnv._cluster_types)
    except Exception:           # noqa: BLE001 — private API moved: assume no
        return False


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> None:
    """jax.distributed.initialize with env-var fallback (JAX reads
    COORDINATOR_ADDRESS or a detected cluster when args are None).
    Idempotent: a repeat call and a bare single-host call (no coordinator
    configured anywhere) are both no-ops, decided by explicit state and
    configuration probes — not by matching exception text, which JAX is
    free to reword (tests/test_distributed_init.py)."""
    if _already_initialized():
        return                  # repeat call: benign no-op
    configured = (coordinator_address is not None
                  or process_id is not None
                  or any(os.environ.get(v) for v in _COORD_ENV_VARS)
                  or _cluster_detectable())
    if not configured:
        return                  # bare single-host: nothing to set up
    jax.distributed.initialize(coordinator_address, num_processes,
                               process_id)


def global_seed_mesh() -> Mesh:
    """1-D seed mesh over every device of every host."""
    return Mesh(np.asarray(jax.devices()), (SEED_AXIS,))


def is_primary() -> bool:
    return jax.process_index() == 0
