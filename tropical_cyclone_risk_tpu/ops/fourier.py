"""Synthetic synoptic wind time series F(t) as an analytic Fourier synthesis.

Reference equivalent: ``gen_f`` (track/bam_track.py:23-31): a 15-component
sine series with random phases and amplitudes ~ n^-1.5 (geostrophic-turbulence
KE spectrum), evaluated on a precomputed hourly grid and then re-interpolated
with interp1d inside the RHS (track/bam_track.py:127,159).

Batched form: draw phases once per seed, precompute the phase-rotated
coefficients A = c_n cos(2 pi phi), B = c_n sin(2 pi phi), and evaluate

    F_i(t) = sum_n A_in sin(w_n t) + B_in cos(w_n t),    w_n = 2 pi n / T

exactly at any t.  Per integration step this is one [n_seeds, C, N] x [N]
contraction — no interpolation error, no per-seed transcendentals beyond the
shared sin/cos basis of 15 frequencies.  The contractions run at
``Precision.HIGHEST`` so they stay float32 on backends that would otherwise
use reduced-precision matrix units (TF32 on NVIDIA GPUs).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

N_FOURIER = 15     # number of sine components (track/bam_track.py:112)
HIGHEST = jax.lax.Precision.HIGHEST


class FourierSeries(NamedTuple):
    A: jnp.ndarray     # [..., C, N] sin coefficients
    B: jnp.ndarray     # [..., C, N] cos coefficients
    T_s: jnp.ndarray   # scalar period (seconds)

    def evaluate(self, t):
        """F(t) -> [..., C] for scalar t (or [..., C, Nt] for t of shape [Nt])."""
        w = 2.0 * jnp.pi * jnp.arange(1, N_FOURIER + 1,
                                      dtype=self.A.dtype) / self.T_s
        phase = w * t if jnp.ndim(t) == 0 else w[:, None] * t[None, :]
        s = jnp.sin(phase)
        c = jnp.cos(phase)
        return (jnp.matmul(self.A, s, precision=HIGHEST)
                + jnp.matmul(self.B, c, precision=HIGHEST))  # [..., C(, Nt)]

    def evaluate_grid(self, t):
        """F on a time grid t [T] -> [T, ..., C], evaluated as one matmul
        over the component axis.  The integration scan precomputes this and
        streams [..., C] slices per step (scan xs), so the A/B coefficient
        buffers are read once per launch instead of once per step."""
        w = 2.0 * jnp.pi * jnp.arange(1, N_FOURIER + 1,
                                      dtype=self.A.dtype) / self.T_s
        phase = t[:, None] * w[None, :]                     # [T, f]
        s = jnp.sin(phase)
        c = jnp.cos(phase)
        return (jnp.einsum('tf,...cf->t...c', s, self.A, precision=HIGHEST)
                + jnp.einsum('tf,...cf->t...c', c, self.B, precision=HIGHEST))


def take_leading(fs: FourierSeries, order: jnp.ndarray) -> FourierSeries:
    """Gather coefficient rows along the leading (seed) axis.

    The [n, C, F] operands are gathered as 2-D [n, C*F] rows
    (reshape-take-reshape): one contiguous row per seed instead of a
    gather over a small, padded [C, F] minor pair.  The launch re-gathers
    A/B at the integrate compaction and at every re-compaction boundary.
    Whether the 2-D form still pays on the H100 is not measured.  Values
    are identical (same rows, same bytes)."""
    n = fs.A.shape[0]
    tail = fs.A.shape[1:]
    g = lambda a: jnp.take(a.reshape(n, -1), order, axis=0).reshape(
        (order.shape[0],) + tail)
    return fs._replace(A=g(fs.A), B=g(fs.B))


def draw_fourier(key: jax.Array, shape, T_s: float,
                 dtype=jnp.float32) -> FourierSeries:
    """Draw random-phase Fourier coefficients.

    shape: leading batch shape + (C,) channel count, e.g. (n_seeds, 4).
    Matches the reference's normalization sqrt(2 / sum(n^-3)) and amplitude
    n^-1.5 (track/bam_track.py:28-30); phases uniform in [0, 1) cycles.
    """
    n = jnp.arange(1, N_FOURIER + 1, dtype=dtype)
    amp = jnp.sqrt(2.0 / jnp.sum(n ** -3.0)) * n ** -1.5
    phi = jax.random.uniform(key, tuple(shape) + (N_FOURIER,), dtype=dtype)
    # sin(w t + 2 pi phi) = sin(w t) cos(2 pi phi) + cos(w t) sin(2 pi phi)
    A = amp * jnp.cos(2 * jnp.pi * phi)
    B = amp * jnp.sin(2 * jnp.pi * phi)
    return FourierSeries(A, B, jnp.asarray(T_s, dtype))
