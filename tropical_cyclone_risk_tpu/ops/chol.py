"""Small-matrix Cholesky, unrolled and batched for the VPU.

The reference factors a 4x4 wind covariance per RHS evaluation with
np.linalg.cholesky and zeroes the winds when the interpolated covariance is
not positive definite (track/bam_track.py:121-126).  Here the factorization
is unrolled over the (static, tiny) matrix dimension so it vectorizes purely
elementwise over the seed batch — no batched-LAPACK dispatch, no data-
dependent control flow.  Failure (non-PD) is detected from non-positive
pivots and reported as a mask so callers can reproduce the reference's
zero-winds fallback without NaN-poisoning the batch.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp


def cholesky_unrolled(cov: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Batched lower-Cholesky of [..., n, n] (n small & static).

    Returns (L, ok) where ok is True iff all pivots were strictly positive
    (matching np.linalg.cholesky's success criterion).  Where ok is False, L
    contains garbage and must be masked by the caller.
    """
    n = cov.shape[-1]
    dtype = cov.dtype
    L = [[None] * n for _ in range(n)]
    ok = jnp.ones(cov.shape[:-2], dtype=bool)
    tiny = jnp.asarray(1e-30, dtype)
    for j in range(n):
        d = cov[..., j, j]
        for k in range(j):
            d = d - L[j][k] * L[j][k]
        ok = ok & (d > 0)
        Ljj = jnp.sqrt(jnp.maximum(d, tiny))
        L[j][j] = Ljj
        inv = 1.0 / Ljj
        for i in range(j + 1, n):
            s = cov[..., i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            L[i][j] = s * inv
    rows = [jnp.stack([L[i][j] if j <= i else jnp.zeros_like(cov[..., 0, 0])
                       for j in range(n)], axis=-1) for i in range(n)]
    return jnp.stack(rows, axis=-2), ok


def lower_tri_to_full(tri: jnp.ndarray, n: int) -> jnp.ndarray:
    """Expand packed lower-triangle channels [..., n(n+1)/2] (row-major:
    (0,0), (1,0), (1,1), (2,0), ...) into a symmetric [..., n, n] matrix.

    This is the packing order of the reference's covariance variable list
    (track/env_wind.py:31-42: var names enumerate i, then j <= i).
    """
    idx = {}
    k = 0
    for i in range(n):
        for j in range(i + 1):
            idx[(i, j)] = k
            k += 1
    rows = []
    for i in range(n):
        cols = [tri[..., idx[(i, j)] if j <= i else idx[(j, i)]]
                for j in range(n)]
        rows.append(jnp.stack(cols, axis=-1))
    return jnp.stack(rows, axis=-2)


def nearest_psd(cov: jnp.ndarray, jitter: float = 1e-8) -> jnp.ndarray:
    """Project symmetric [..., n, n] matrices onto the PSD cone by
    eigenvalue clipping (reference nearestPD, util/mat.py:185-223 — there a
    Higham-style iterative repair with no callers; here the direct spectral
    projection, available as an alternative to the zero-winds fallback)."""
    sym = 0.5 * (cov + jnp.swapaxes(cov, -1, -2))
    w, v = jnp.linalg.eigh(sym)
    w = jnp.maximum(w, jitter)
    return jnp.einsum('...ij,...j,...kj->...ik', v, w, v,
                      precision=jax.lax.Precision.HIGHEST)
