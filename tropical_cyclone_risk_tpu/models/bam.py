"""Standalone (uncoupled) beta-advection track model.

Reference equivalent: BetaAdvectionTrack.gen_track (track/bam_track.py:
153-178) — a forward-Euler track integration with constant steering weights
and no intensity coupling, stopping on basin exit.  The reference keeps this
as a research mode alongside the coupled model (the main pipeline only calls
the coupled path, util/compute.py:176); here it is the same batched scan as
the coupled simulator with the intensity ODEs switched off.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from tropical_cyclone_risk_tpu import constants
from tropical_cyclone_risk_tpu.config import Namelist
from tropical_cyclone_risk_tpu.models import fast
from tropical_cyclone_risk_tpu.models.fields import FieldPack
from tropical_cyclone_risk_tpu.ops.fourier import FourierSeries
from tropical_cyclone_risk_tpu.utils import basins


class BamTracks(NamedTuple):
    lon: jnp.ndarray     # [N, T] NaN after basin exit
    lat: jnp.ndarray
    alive: jnp.ndarray   # [N, T]


@functools.partial(jax.jit, static_argnames=('cfg', 'basin_id'))
def gen_tracks(pack: FieldPack, cfg: Namelist, basin_id: str,
               lon0, lat0, plane, fourier: FourierSeries) -> BamTracks:
    """Batched uncoupled BAM tracks with constant steering coefficients
    (track/bam_track.py:147-178): forward Euler at the output interval,
    termination on basin exit (1-degree margin)."""
    bounds = basins.basin_bounds(cfg, basin_id)
    n_steps = cfg.n_steps_output
    dt = float(cfg.output_interval_s)
    coefs = jnp.asarray(cfg.steering_coefs, jnp.float32)

    def step(carry, k):
        lon, lat, alive = carry
        t = k.astype(jnp.float32) * dt
        wnds = fast.sample_env_winds(pack, cfg, lon, lat, plane, fourier, t)
        polar = jnp.abs(lat) >= 80.0
        wnds = jnp.where(polar[:, None], 0.0, wnds)
        w_lat = jnp.cos(jnp.deg2rad(lat))
        hi = jax.lax.Precision.HIGHEST
        u = (jnp.einsum('nl,l->n', wnds[:, 0::2], coefs, precision=hi)
             + cfg.u_beta * w_lat)
        v = jnp.einsum('nl,l->n', wnds[:, 1::2], coefs, precision=hi) \
            + jnp.sign(lat) * cfg.v_beta * w_lat
        u = jnp.where(polar, 0.0, u)
        v = jnp.where(polar, 0.0, v)
        # forward-Euler Cartesian step on the sphere (util/sphere.py:48-51)
        rad = 180.0 / jnp.pi / constants.earth_R
        lon1 = lon + dt * u * rad / w_lat
        lat1 = lat + dt * v * rad
        lon1 = jnp.where(alive, lon1, lon)
        lat1 = jnp.where(alive, lat1, lat)
        alive1 = alive & basins.in_basin(lon1, lat1, bounds, 1.0)
        return (lon1, lat1, alive1), (lon, lat, alive)

    init = (jnp.asarray(lon0, jnp.float32), jnp.asarray(lat0, jnp.float32),
            jnp.ones(jnp.shape(lon0), bool))
    _, (lon, lat, alive) = jax.lax.scan(step, init, jnp.arange(n_steps))
    tr = lambda x: jnp.swapaxes(x, 0, 1)
    lon, lat, alive = map(tr, (lon, lat, alive))
    nan = jnp.float32(jnp.nan)
    return BamTracks(jnp.where(alive, lon, nan), jnp.where(alive, lat, nan),
                     alive)
