"""Structured Nesterov-Todd scaling operators.

The reference materializes the NT scaling as a heterogeneous block-diagonal
``Block`` matrix of ``Diagonal`` / ``SymWoodbury`` / ``VecCongurance`` blocks
(ConicIP.jl:165-210, 589-605; blockmatrices.jl). This design keeps
the same three *structures* but stores them as flat batched arrays inside one
pytree and never materializes anything:

- R block:  ``F = diag(r_d)``
- Q group:  per cone ``F = diag(d) + alpha * u uᵀ``  (diag + rank-1, the
  SymWoodbury structure of ``nestod_soc``)
- S group:  per cone ``F x = vecm(Sᵀ mat(x) S)``  (the ``VecCongurance`` of
  ``nestod_sdc``)

Applying F (or Fᵀ, F⁻ᵀ) to a vector or to the rows of a matrix is a few
batched elementwise ops / matmuls, fully fused by XLA.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import jax
import jax.numpy as jnp

from .segment import (put_group, put_r, put_rows_group, put_rows_r,
                      take_group, take_r, take_rows_group, take_rows_r)
from .spec import ConeSpec
from .symm import mat, vecm

# Every matmul in the scaling path carries precision=HIGHEST. The KKT
# solvers apply these scalings on f32-cast copies (``cast()``), and the
# DEFAULT f32 matmul precision on the GPU is TF32 (10 mantissa bits) —
# enough to destroy the SDP congruences and the Schur assembly as the
# scaling's dynamic range grows with 1/μ. HIGHEST keeps f32 applies at
# f32 accuracy (and is exact for f64 operands).
_HI = jax.lax.Precision.HIGHEST


def _mm(a, b):
    return jnp.matmul(a, b, precision=_HI)

__all__ = [
    "NTScaling",
    "nt_scaling",
    "nt_identity",
    "nt_inv_adjoint",
    "apply",
    "apply_adjoint",
    "apply_mat",
    "apply_adjoint_mat",
    "dense_gram",
    "cast",
]


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class SocScaling:
    d: jnp.ndarray  # (k, dim) diagonal entries
    u: jnp.ndarray  # (k, dim) rank-1 factor
    alpha: jnp.ndarray  # (k,) rank-1 weight


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class SdpScaling:
    S: jnp.ndarray  # (k, d, d): F x = vecm(Sᵀ mat(x) S)
    # S⁻¹, carried alongside: available in closed form at construction
    # (R⁻¹ = diag(1/√λ)·Uᵀ·Lzᵀ), so no inverse is ever factored.
    Sinv: jnp.ndarray  # (k, d, d)
    # Eigenvalues of the NT-scaled point: mat(F z) = RᵀZR = Λ is DIAGONAL
    # in exact arithmetic (RᵀZR = Λ^½UᵀLz⁻¹(LzLzᵀ)Lz⁻ᵀUΛ^½ = Λ), so the
    # iteration's Lyapunov divisions against λ and λ-frame max-steps need
    # no eigendecomposition of mat(λ) at all — its spectral data is THIS
    # byproduct of the scaling construction (the CVXOPT-style spectral-λ
    # formulation). The IPM would otherwise decompose this matrix up to
    # ~7 times per iteration.
    lam: jnp.ndarray  # (k, d)


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class NTScaling:
    r_d: jnp.ndarray  # (nr,)
    soc: Tuple[SocScaling, ...]
    sdp: Tuple[SdpScaling, ...]


def _dot(a, b):
    return jnp.sum(a * b, axis=-1)


def _qf(x):
    return 2.0 * x[..., 0] * x[..., 0] - _dot(x, x)


def nt_scaling(spec: ConeSpec, z: jnp.ndarray, s: jnp.ndarray,
               eig_dtype=None) -> NTScaling:
    """NT scaling F with ``F z = F⁻ᵀ s = λ`` (ConicIP.jl:589-605).

    ``eig_dtype`` runs the S-cone factorizations (chol + svd) in a lower
    precision, returning the scaling upcast to the working dtype — the
    opt-in f32 fast phase; the IPM's last-mile slow branch reverts to full
    precision (solver/ipm.py).
    """
    r_d = jnp.sqrt(take_r(spec, s) / take_r(spec, z)) if spec.nr else z[:0]
    soc = []
    for g in spec.soc_groups:
        zg = take_group(g, z)
        sg = take_group(g, s)
        qz = _qf(zg)
        qs = _qf(sg)
        beta = (qs / qz) ** 0.25  # (k,)
        zb = zg / jnp.sqrt(qz)[:, None]
        sb = sg / jnp.sqrt(qs)[:, None]
        gam = jnp.sqrt((1.0 + _dot(zb, sb)) / 2.0)  # (k,)
        Jzb = jnp.concatenate([zb[:, :1], -zb[:, 1:]], axis=1)
        w = (sb + Jzb) / (2.0 * gam[:, None])
        w = w.at[:, 0].add(1.0)
        w = w * (jnp.sqrt(beta) / jnp.sqrt(w[:, 0]))[:, None]
        dvec = jnp.concatenate(
            [-beta[:, None], jnp.broadcast_to(beta[:, None], (g.count, g.dim - 1))],
            axis=1,
        )
        soc.append(SocScaling(d=dvec, u=w, alpha=jnp.ones_like(beta)))
    sdp = []
    wd = z.dtype
    ed = wd if eig_dtype is None else eig_dtype
    for g in spec.sdp_groups:
        Z = mat(take_group(g, z)).astype(ed)  # (k, d, d)
        Sm = mat(take_group(g, s)).astype(ed)
        Lz = jnp.linalg.cholesky(Z)
        LzT = jnp.swapaxes(Lz, -1, -2)
        Ls = jnp.linalg.cholesky(Sm)
        # σ(LzᵀLs) = Λ: RᵀZR = √Λ·UᵀLz⁻¹(LzLzᵀ)Lz⁻ᵀU·√Λ = Λ
        U, lam, _ = jnp.linalg.svd(_mm(LzT, Ls))
        # R = Lz⁻ᵀ U diag(sqrt(lam))  (nestod_sdc, ConicIP.jl:196-210)
        X = jax.scipy.linalg.solve_triangular(LzT, U, lower=False)
        sl = jnp.sqrt(lam)
        R = X * sl[..., None, :]
        # closed-form inverse: R⁻¹ = diag(1/√λ) Uᵀ Lzᵀ
        Rinv = _mm(jnp.swapaxes(U, -1, -2), LzT) / sl[..., :, None]
        sdp.append(SdpScaling(S=R.astype(wd), Sinv=Rinv.astype(wd),
                              lam=lam.astype(wd)))
    return NTScaling(r_d=r_d, soc=tuple(soc), sdp=tuple(sdp))


def nt_identity(spec: ConeSpec, dtype=jnp.float64) -> NTScaling:
    """Identity scaling, used for the cold-start KKT solve (ConicIP.jl:704-706)."""
    r_d = jnp.ones((spec.nr,), dtype)
    soc = tuple(
        SocScaling(
            d=jnp.ones((g.count, g.dim), dtype),
            u=jnp.zeros((g.count, g.dim), dtype),
            alpha=jnp.zeros((g.count,), dtype),
        )
        for g in spec.soc_groups
    )
    sdp = tuple(
        SdpScaling(
            S=jnp.broadcast_to(
                jnp.eye(g.order, dtype=dtype), (g.count, g.order, g.order)
            ),
            Sinv=jnp.broadcast_to(
                jnp.eye(g.order, dtype=dtype), (g.count, g.order, g.order)
            ),
            # the identity scaling is only ever used with the cone
            # identity as the scaled point (the cold-start solve,
            # ConicIP.jl:704-706): mat(e) = I, eigenvalues 1
            lam=jnp.ones((g.count, g.order), dtype),
        )
        for g in spec.sdp_groups
    )
    return NTScaling(r_d=r_d, soc=soc, sdp=sdp)


def nt_inv_adjoint(spec: ConeSpec, F: NTScaling) -> NTScaling:
    """F⁻ᵀ with the same structure (blockwise ``inv_adjoint!``,
    blockmatrices.jl:193-198). R and Q blocks are symmetric so F⁻ᵀ = F⁻¹
    (Sherman-Morrison keeps diag + rank-1); S blocks map S → S⁻ᵀ."""
    r_d = 1.0 / F.r_d
    soc = []
    for sc in F.soc:
        dinv = 1.0 / sc.d
        uh = sc.u * dinv
        denom = 1.0 + sc.alpha * _dot(sc.u, uh)
        soc.append(SocScaling(d=dinv, u=uh, alpha=-sc.alpha / denom))
    sdp = []
    for sd in F.sdp:
        # F⁻ᵀ maps S → S⁻ᵀ; the pair (S, S⁻¹) just swaps (+transpose).
        # The scaled point is the same λ (F z = F⁻ᵀ s = λ) — carry it.
        sdp.append(
            SdpScaling(
                S=jnp.swapaxes(sd.Sinv, -1, -2),
                Sinv=jnp.swapaxes(sd.S, -1, -2),
                lam=sd.lam,
            )
        )
    return NTScaling(r_d=r_d, soc=tuple(soc), sdp=tuple(sdp))


def cast(F: NTScaling, dtype) -> NTScaling:
    """All scaling fields converted to ``dtype`` (one-time cast so the KKT
    solve path can run entirely in the factorization precision)."""
    return jax.tree_util.tree_map(lambda x: x.astype(dtype), F)


# ──────────────────────────────────────────────────────────────
#  Application to vectors / matrix rows
# ──────────────────────────────────────────────────────────────


def _apply(spec: ConeSpec, F: NTScaling, x: jnp.ndarray, transpose_sdp: bool):
    if spec.only_r:
        return F.r_d * x
    o = jnp.zeros_like(x)
    if spec.nr:
        o = put_r(spec, o, F.r_d * take_r(spec, x))
    for g, sc in zip(spec.soc_groups, F.soc):
        xg = take_group(g, x)
        val = sc.d * xg + (sc.alpha * _dot(sc.u, xg))[:, None] * sc.u
        o = put_group(g, o, val)
    for g, sd in zip(spec.sdp_groups, F.sdp):
        X = mat(take_group(g, x))
        S = sd.S
        St = jnp.swapaxes(S, -1, -2)
        Y = _mm(_mm(S, X), St) if transpose_sdp else _mm(_mm(St, X), S)
        o = put_group(g, o, vecm(Y))
    return o


def apply(spec: ConeSpec, F: NTScaling, x: jnp.ndarray) -> jnp.ndarray:
    """F @ x."""
    return _apply(spec, F, x, transpose_sdp=False)


def apply_adjoint(spec: ConeSpec, F: NTScaling, x: jnp.ndarray) -> jnp.ndarray:
    """Fᵀ @ x (differs from F @ x only on S blocks)."""
    return _apply(spec, F, x, transpose_sdp=True)


def _apply_mat(spec: ConeSpec, F: NTScaling, A: jnp.ndarray, transpose_sdp: bool):
    """Apply F to every column of A, i.e. compute F @ A for A of shape (m, n).

    This is how the Schur assembly builds ``Atil = F⁻ᵀ A`` in one shot:
    row-scaling for R, batched rank-1 updates for Q, batched congruences for S
    — replacing the reference's dense ``Matrix(inv(F))' * A``
    (kktsolvers.jl:32-33) with structure-exploiting batched matmuls.
    """
    if spec.only_r:
        return F.r_d[:, None] * A
    o = jnp.zeros_like(A)
    if spec.nr:
        o = put_rows_r(spec, o, F.r_d[:, None] * take_rows_r(spec, A))
    for g, sc in zip(spec.soc_groups, F.soc):
        Ag = take_rows_group(g, A)  # (k, dim, n)
        uA = jnp.einsum("kd,kdn->kn", sc.u, Ag, precision=_HI)
        val = sc.d[:, :, None] * Ag + sc.alpha[:, None, None] * sc.u[:, :, None] * uA[:, None, :]
        o = put_rows_group(g, o, val)
    for g, sd in zip(spec.sdp_groups, F.sdp):
        Ag = take_rows_group(g, A)  # (k, t, n)
        X = mat(jnp.swapaxes(Ag, -1, -2))  # (k, n, d, d)
        S = sd.S
        if transpose_sdp:
            Y = jnp.einsum("kab,knbc,kdc->knad", S, X, S, precision=_HI)
        else:
            Y = jnp.einsum("kba,knbc,kcd->knad", S, X, S, precision=_HI)
        o = put_rows_group(g, o, jnp.swapaxes(vecm(Y), -1, -2))
    return o


def apply_mat(spec: ConeSpec, F: NTScaling, A: jnp.ndarray) -> jnp.ndarray:
    return _apply_mat(spec, F, A, transpose_sdp=False)


def apply_adjoint_mat(spec: ConeSpec, F: NTScaling, A: jnp.ndarray) -> jnp.ndarray:
    return _apply_mat(spec, F, A, transpose_sdp=True)


def dense_gram(spec: ConeSpec, F: NTScaling, dtype=None) -> jnp.ndarray:
    """Materialize ``FᵀF`` as an (m, m) block-diagonal matrix directly
    from the structured parts — O(Σ k·d³) instead of the O(m³) dense
    ``dense(F).T @ dense(F)`` the LU fallback previously paid per
    iteration (the reference's worst allocation pathology,
    benchmark/report.md:40-44).

    Per group: R rows square the diagonal; SOC blocks form the (dim, dim)
    factor and square it batched; SDP blocks use that the congruence
    operator ``X ↦ SᵀXS`` composed with its adjoint ``Y ↦ SYSᵀ`` is the
    congruence by the symmetric ``P = SSᵀ``."""
    dtype = dtype or (F.r_d.dtype if F.r_d.size else jnp.float64)
    M = jnp.zeros((spec.m, spec.m), dtype)
    if spec.nr:
        M = M.at[spec.r_idx, spec.r_idx].set(F.r_d * F.r_d)
    for g, sc in zip(spec.soc_groups, F.soc):
        blk = (
            jnp.eye(g.dim, dtype=dtype) * sc.d[:, None, :]
            + sc.alpha[:, None, None] * sc.u[:, :, None] * sc.u[:, None, :]
        )  # (k, dim, dim), symmetric
        blk2 = jnp.einsum("kab,kbc->kac", blk, blk, precision=_HI)
        M = M.at[g.idx[:, :, None], g.idx[:, None, :]].set(blk2)
    for g, sd in zip(spec.sdp_groups, F.sdp):
        t = g.tdim
        basis = mat(jnp.eye(t, dtype=dtype))  # (t, d, d)
        P = jnp.einsum("kab,kcb->kac", sd.S, sd.S, precision=_HI)  # S Sᵀ
        Y = jnp.einsum("kab,jbc,kcd->kjad", P, basis, P, precision=_HI)
        cols = vecm(Y)
        M = M.at[g.idx[:, :, None], g.idx[:, None, :]].set(
            jnp.swapaxes(cols, -1, -2))
    return M


def dense(spec: ConeSpec, F: NTScaling, dtype=None) -> jnp.ndarray:
    """Materialize F as an (m, m) block-diagonal matrix.

    Only used by solvers that need the full FᵀF (e.g. the dense-LU KKT
    solver, the analogue of the reference's sparse no-lift path,
    kktsolvers.jl:244-267). The hot Schur path never calls this.
    """
    dtype = dtype or (F.r_d.dtype if F.r_d.size else jnp.float64)
    M = jnp.zeros((spec.m, spec.m), dtype)
    if spec.nr:
        M = M.at[spec.r_idx, spec.r_idx].set(F.r_d)
    for g, sc in zip(spec.soc_groups, F.soc):
        blk = (
            jnp.eye(g.dim, dtype=dtype) * sc.d[:, None, :]
            + sc.alpha[:, None, None] * sc.u[:, :, None] * sc.u[:, None, :]
        )  # (k, dim, dim)
        M = M.at[g.idx[:, :, None], g.idx[:, None, :]].set(blk)
    for g, sd in zip(spec.sdp_groups, F.sdp):
        # Column j of the block is vecm(Sᵀ mat(e_j) S): build the mat(e_j)
        # basis once (t, d, d) and batch the congruence.
        t = g.tdim
        basis = mat(jnp.eye(t, dtype=dtype))  # (t, d, d)
        S = sd.S
        Y = jnp.einsum("kba,jbc,kcd->kjad", S, basis, S,
                       precision=_HI)  # (k, t, d, d)
        cols = vecm(Y)  # (k, t_in, t_out): cols[k, j] = W e_j
        blk = jnp.swapaxes(cols, -1, -2)
        M = M.at[g.idx[:, :, None], g.idx[:, None, :]].set(blk)
    return M
