"""Dense LU of the full 3x3 saddle system.

Robust analogue of the reference's sparse-LU backend
(``kktsolver_sparse``, kktsolvers.jl:180-270): factors the indefinite

    Z = ┌ Q   Gᵀ  -Aᵀ ┐
        │ G   0    0  │
        │ A   0   FᵀF │

directly with partial pivoting. This is the fallback for problems
where the Schur matrix ``Q + Aᵀ(FᵀF)⁻¹A`` is badly conditioned; the default
:func:`~conicip_tpu.kkt.schur.kktsolver_schur` is preferred. The reference's
sparse lift trick (expanding Woodbury blocks with auxiliary variables,
kktsolvers.jl:60-105) has no analogue here — the operands are dense, and
the structured Schur path already avoids materializing FᵀF.

The factorization runs in the working dtype unless ``factor_dtype`` asks
for another; the IPM's refinement loop then recovers accuracy, same as the
Schur path.
"""

from __future__ import annotations

import jax.numpy as jnp
from jax.scipy.linalg import lu_factor, lu_solve

from ..cones import scaling as sc
from ..cones.spec import ConeSpec

__all__ = ["kktsolver_lu"]


def kktsolver_lu(Q, A, G, spec: ConeSpec, *, factor_dtype=None):
    n = Q.shape[0]
    m = A.shape[0]
    p = G.shape[0]
    dtype = Q.dtype
    fd = dtype if factor_dtype is None else factor_dtype

    def solve3x3gen(F, FinvT):
        # FᵀF assembled block-diagonally from the structured scaling —
        # O(Σ k·d³), not the O(m³) dense square (scaling.dense_gram)
        W2 = sc.dense_gram(spec, F, dtype)
        Z = jnp.block(
            [
                [Q, G.T, -A.T],
                [G, jnp.zeros((p, p), dtype), jnp.zeros((p, m), dtype)],
                [A, jnp.zeros((m, p), dtype), W2],
            ]
        ).astype(fd)
        lu, piv = lu_factor(Z)

        def solve3x3(bx, by, bz):
            rhs = jnp.concatenate([bx, by, bz]).astype(fd)
            u = lu_solve((lu, piv), rhs).astype(dtype)
            return u[:n], u[n : n + p], u[n + p :]

        return solve3x3

    return solve3x3gen
