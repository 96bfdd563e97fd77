"""Cholesky factorization and triangular solves — the solver's hot kernel.

Thin wrappers over XLA's native ops (cuSOLVER ``potrf``/``trsm`` on the
GPU, LAPACK on the CPU). ``factor_dtype=float32`` enables the
mixed-precision mode where the O(n³) factorization runs in f32 and the
IPM's iterative-refinement loop (a first-class mechanism here, promoted
from the reference's safety net at ConicIP.jl:907-921) restores f64
accuracy.
"""

from __future__ import annotations

import jax.numpy as jnp
from jax.scipy.linalg import solve_triangular

__all__ = ["cholesky", "tri_inv", "cho_solve", "CholFactor"]


def cholesky(M: jnp.ndarray, factor_dtype=None) -> jnp.ndarray:
    """Lower-triangular Cholesky factor, optionally in a lower precision."""
    if factor_dtype is not None and factor_dtype != M.dtype:
        M = M.astype(factor_dtype)
    return jnp.linalg.cholesky(M)


def tri_inv(L: jnp.ndarray) -> jnp.ndarray:
    """Explicit lower-triangular inverse L⁻¹ (the one-time per-factor
    inverse that turns every back-solve into two GEMVs — kkt/schur.py
    cost model)."""
    return solve_triangular(
        L, jnp.eye(L.shape[-1], dtype=L.dtype), lower=True
    )


def cho_solve(L: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Solve (L Lᵀ) x = b given the lower Cholesky factor L."""
    out_dtype = b.dtype
    b = b.astype(L.dtype)
    y = solve_triangular(L, b, lower=True)
    x = solve_triangular(L, y, lower=True, trans="T")
    return x.astype(out_dtype)


class CholFactor:
    """Tiny convenience wrapper bundling a factor with its solve."""

    def __init__(self, M: jnp.ndarray, factor_dtype=None):
        self.L = cholesky(M, factor_dtype)

    def solve(self, b: jnp.ndarray) -> jnp.ndarray:
        return cho_solve(self.L, b)
