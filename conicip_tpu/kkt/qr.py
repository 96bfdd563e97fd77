"""CVXOPT §10.2 double-QR KKT solver.

Dense-QR analogue of the reference's ``kktsolver_qr`` (kktsolvers.jl:18-58):
a one-time full QR of Gᵀ splits the space into range/null parts of the
equality constraints; each iteration re-factors the reduced system
``Q₂ᵀ(Q + AᵀF⁻¹F⁻ᵀA)Q₂``. Works with rank-deficient ``Q`` (the
Schur solver needs ``Q + Aᵀ(FᵀF)⁻¹A ≻ 0``; this one only needs it on the
null space of G).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.scipy.linalg import solve_triangular

_HI = jax.lax.Precision.HIGHEST


def _mm(a, b):
    # HIGHEST: the GPU's default f32 matmul precision is TF32 (see
    # cones/scaling.py); exact for f64 operands
    return jnp.matmul(a, b, precision=_HI)

from ..cones import scaling as sc
from ..cones.spec import ConeSpec

__all__ = ["kktsolver_qr"]


def _qr_solve(Qf, Rf, b):
    """Least-squares solve via a reduced QR factorization."""
    return solve_triangular(Rf, _mm(Qf.T, b), lower=False)


def kktsolver_qr(Q, A, G, spec: ConeSpec):
    n = Q.shape[0]
    p = G.shape[0]

    if p:
        Q0, R = jnp.linalg.qr(G.T, mode="complete")  # (n,n), (n,p)
        Q1 = Q0[:, :p]
        Q2 = Q0[:, p:]
        R1 = R[:p, :p]
    else:
        Q2 = None  # whole space; no equality split needed

    def solve3x3gen(F, FinvT):
        Atil = sc.apply_mat(spec, FinvT, A)  # F⁻ᵀ A
        M = Q + _mm(Atil.T, Atil)  # Q + AᵀF⁻¹F⁻ᵀA

        if p:
            red = _mm(_mm(Q2.T, M), Q2)
        else:
            red = M
        Lq, Lr = jnp.linalg.qr(red)

        def solve3x3(bx, by, bz):
            Fz0 = sc.apply(spec, FinvT, bz)  # F⁻ᵀ bz
            rhs = bx + _mm(Atil.T, Fz0)
            if p:
                u1 = solve_triangular(R1.T, by, lower=True)  # Q1ᵀ a
                t = _mm(M, _mm(Q1, u1))
                u2 = _qr_solve(Lq, Lr, _mm(Q2.T, rhs) - _mm(Q2.T, t))  # Q2ᵀ a
                b = solve_triangular(
                    R1,
                    _mm(Q1.T, rhs) - _mm(Q1.T, t)
                    - _mm(Q1.T, _mm(M, _mm(Q2, u2))),
                    lower=False,
                )
                a = _mm(Q1, u1) + _mm(Q2, u2)
            else:
                a = _qr_solve(Lq, Lr, rhs)
                b = bx[:0]
            Fz = Fz0 - _mm(Atil, a)  # F⁻ᵀ(bz - A a)
            c = sc.apply_adjoint(spec, FinvT, Fz)  # F⁻¹ Fz = (FᵀF)⁻¹(bz - A a)
            return a, b, c

        return solve3x3

    return solve3x3gen
