"""Batched symmetric-matrix packing (``vecm``/``mat``).

Vectorized replacement for the reference's scalar-loop ``mat``/``vecm``
(ConicIP.jl:87-151): pure gather/scatter with precomputed index maps, batched
over a leading axis of cones. The packing convention is identical: row-major
upper triangle with off-diagonal entries scaled by sqrt(2), so that
``dot(vecm(X), vecm(Y)) == tr(X @ Y)``.
"""

from __future__ import annotations

import jax.numpy as jnp

from .spec import tri_indices, tri_order

__all__ = ["vecm", "mat", "vecm_single", "mat_single"]


def vecm(Z: jnp.ndarray) -> jnp.ndarray:
    """Pack symmetric matrices ``Z`` of shape (..., d, d) into (..., d(d+1)/2)."""
    d = Z.shape[-1]
    rows, cols, scale = tri_indices(d)
    return Z[..., rows, cols] * jnp.asarray(scale, Z.dtype)


def mat(x: jnp.ndarray) -> jnp.ndarray:
    """Unpack (..., t) with t = d(d+1)/2 into symmetric (..., d, d)."""
    t = x.shape[-1]
    d = tri_order(t)
    rows, cols, scale = tri_indices(d)
    vals = x / jnp.asarray(scale, x.dtype)
    Z = jnp.zeros(x.shape[:-1] + (d, d), x.dtype)
    Z = Z.at[..., rows, cols].set(vals)
    Z = Z.at[..., cols, rows].set(vals)
    return Z


# Aliases emphasising the unbatched use (same implementation — shape polymorphic).
vecm_single = vecm
mat_single = mat
