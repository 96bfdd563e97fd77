"""Closed-form spectral KKT solver for PSD-projection structure.

Exploits the structure of the canonical batched-SDP workload — projection
onto the PSD cone under the trace metric (``Q = q·I``, ``A = I``,
``p = 0``, pure-S cone product; reference generator profile.jl:71-81) —
the same way the reference's sparse LU exploits bound structure on its
headline box QP (kktsolvers.jl:281-310) and this framework's
``kkt/diag.py`` does for separable R-cone problems.

For the 3x3 contract with A = I, G empty, Q = qI:

    q·a − c = x        (dual row)
    a + FᵀF c = z      (cone row)

the S-cone NT scaling applies as a congruence ``F x = vecm(Sᵀ mat(x) S)``
so ``FᵀF x = vecm(P mat(x) P)`` with ``P = S Sᵀ`` symmetric PD (d×d).
Eliminating c and diagonalizing ``P = V Θ Vᵀ`` turns the whole Newton
solve into an elementwise divide in the V basis:

    Ã = (Z̃ + θᵢθⱼ X̃) / (1 + q·θᵢθⱼ),   X̃ = Vᵀ mat(x) V  etc.
    a = vecm(V Ã Vᵀ),   c = q·a − x

— EXACT, with ONE batched d×d eigendecomposition per iteration and four
congruence matmuls per right-hand side. No t×t Schur assembly
(t = d(d+1)/2) and no factorization.

Applicability is checked host-side by :func:`spectral_applicable`
(mirroring ``kkt/diag.separable``); the traced solver trusts the caller.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..cones.spec import ConeSpec
from ..cones.symm import mat, vecm

__all__ = ["kktsolver_spectral", "spectral_applicable"]

_HI = jax.lax.Precision.HIGHEST


def _mm(a, b):
    return jnp.matmul(a, b, precision=_HI)


def spectral_applicable(Q, A, G, spec: ConeSpec) -> bool:
    """Host-side structure check: no equalities, ``A = I`` and
    ``Q = q·I`` (q ≥ 0) for every instance (leading batch dims allowed).
    Any cone mix qualifies: with A = I the operator ``I + q·FᵀF`` is
    block-diagonal per cone group and inverts in closed form — elementwise
    on R, Sherman-Morrison (rank-2) on SOC, eigenbasis of P = SSᵀ on S."""
    if G is not None and np.ndim(G) >= 2 and np.shape(G)[-2] > 0:
        return False
    Qh = np.asarray(Q)
    Ah = np.asarray(A)
    n = Qh.shape[-1]
    if spec.soc_groups and float(Qh.reshape(-1, n, n)[0, 0, 0]) <= 0:
        # the SOC Woodbury form needs q > 0 (its 2x2 uses (qC)^-1)
        return False
    if Ah.shape[-2] != n or Ah.shape[-1] != n:
        return False
    eye = np.eye(n)
    A2 = Ah.reshape(-1, n, n)
    if not all(np.array_equal(Ai, eye) for Ai in A2):
        return False
    Q2 = Qh.reshape(-1, n, n)
    for Qi in Q2:
        q = Qi[0, 0]
        if q < 0 or not np.array_equal(Qi, q * eye):
            return False
    return True


def kktsolver_spectral(Q, A, G, spec: ConeSpec, *, eig_dtype=None):
    """3-level KKT callback (module docstring). ``eig_dtype`` follows the
    cone layer's contract (None = stock at the working dtype)."""
    from ..cones.algebra import _eigh_d
    from ..cones.segment import (put_group, put_r, take_group, take_r)

    q = Q[0, 0]

    def _dot2(a, b):
        return jnp.sum(a * b, axis=-1)

    def solve3x3gen(F, FinvT):
        # Per-iteration decomposition: P = S Sᵀ per S group, diagonalized.
        eigs = []
        for sd in F.sdp:
            P = _mm(sd.S, jnp.swapaxes(sd.S, -1, -2))
            P = 0.5 * (P + jnp.swapaxes(P, -1, -2))
            theta, V = _eigh_d(P, eig_dtype)
            eigs.append((theta, V, P))
        # R rows: FᵀF = diag(r_d²)
        w_r = F.r_d * F.r_d if spec.nr else None
        # SOC cones: FᵀF = F² = diag(d²) + α(v₁uᵀ + uv₁ᵀ) + α²(uᵀu)uuᵀ
        # with v₁ = d∘u — rank-2 in span{u, v₁}; precompute the pieces of
        # the Woodbury inverse of D + q·(rank-2), D = diag(1 + q d²).
        socs = []
        for sc_ in F.soc:
            v1 = sc_.d * sc_.u
            s_uu = _dot2(sc_.u, sc_.u)
            socs.append((sc_, v1, s_uu))

        def _soc_ftf(sc_, v1, s_uu, xg):
            ux = _dot2(sc_.u, xg)[..., None]
            v1x = _dot2(v1, xg)[..., None]
            return (
                sc_.d * sc_.d * xg
                + sc_.alpha[..., None] * (v1 * ux + sc_.u * v1x)
                + (sc_.alpha * sc_.alpha * s_uu)[..., None] * sc_.u * ux
            )

        def _soc_solve(sc_, v1, s_uu, rhs):
            # (D + q·U C Uᵀ)⁻¹ rhs, U = [u, v₁], C = [[α²s, α], [α, 0]],
            # D = diag(1 + q d²): Woodbury with an explicit 2×2 inverse of
            # K = C⁻¹/q + UᵀD⁻¹U. With α → 0 the correction vanishes;
            # computed via the adjugate so the α=0 limit is exact (scale
            # K by α: α·K stays finite).
            D = 1.0 + q * sc_.d * sc_.d
            ir = rhs / D
            iu = sc_.u / D
            iv = v1 / D
            # UᵀD⁻¹U entries
            a11 = _dot2(sc_.u, iu)
            a12 = _dot2(sc_.u, iv)
            a22 = _dot2(v1, iv)
            al = sc_.alpha
            # C⁻¹ = [[0, 1/α], [1/α, −s]] ⇒ α·K = [[α a11, 1/q + α a12],
            # [1/q + α a12, −α s/q + α a22]] (finite at α = 0)
            k11 = al * a11
            k12 = 1.0 / q + al * a12
            k22 = -al * s_uu / q + al * a22
            det = k11 * k22 - k12 * k12
            # rhs of the 2×2: α·[uᵀD⁻¹r, v₁ᵀD⁻¹r] (the α from scaling K)
            r1 = al * _dot2(sc_.u, ir)
            r2 = al * _dot2(v1, ir)
            # solve (αK) y = α r ⇒ y = K⁻¹ r
            y1 = (k22 * r1 - k12 * r2) / det
            y2 = (k11 * r2 - k12 * r1) / det
            corr = iu * y1[..., None] + iv * y2[..., None]
            return ir - corr

        def base_solve(x, z):
            a = jnp.zeros_like(x)
            if spec.nr:
                xr, zr = take_r(spec, x), take_r(spec, z)
                a = put_r(spec, a, (zr + w_r * xr) / (1.0 + q * w_r))
            for g, (sc_, v1, s_uu) in zip(spec.soc_groups, socs):
                xg = take_group(g, x)
                zg = take_group(g, z)
                rhs = zg + _soc_ftf(sc_, v1, s_uu, xg)
                a = put_group(g, a, _soc_solve(sc_, v1, s_uu, rhs))
            for g, (theta, V, _P) in zip(spec.sdp_groups, eigs):
                X = mat(take_group(g, x))
                Z = mat(take_group(g, z))
                Vt = jnp.swapaxes(V, -1, -2)
                Xt = _mm(_mm(Vt, X), V)
                Zt = _mm(_mm(Vt, Z), V)
                tt = theta[..., :, None] * theta[..., None, :]
                At = (Zt + tt * Xt) / (1.0 + q * tt)
                a = put_group(g, a, vecm(_mm(_mm(V, At), Vt)))
            return a

        def cone_residual(a, c, z):
            # z − a − FᵀF c, with FᵀF applied EXACTLY per block —
            # independent of the eigendecomposition.
            r = z - a
            if spec.nr:
                r = put_r(spec, r,
                          take_r(spec, r) - w_r * take_r(spec, c))
            for g, (sc_, v1, s_uu) in zip(spec.soc_groups, socs):
                cg = take_group(g, c)
                r = put_group(
                    g, r, take_group(g, r) - _soc_ftf(sc_, v1, s_uu, cg))
            for g, (_theta, _V, P) in zip(spec.sdp_groups, eigs):
                C = mat(take_group(g, c))
                PCP = _mm(_mm(P, C), P)
                r = put_group(
                    g, r, take_group(g, r) - vecm(PCP))
            return r

        def solve3x3(x, y, z):
            # c = qa − x satisfies the dual row EXACTLY by construction;
            # all solve error lives in the cone row, where the exact
            # operator is cheap — so one defect-correction pass squares
            # the eigendecomposition error (κ(P) = κ(S)² can reach ~1e10+
            # near convergence, beyond what a single elementwise solve in
            # an approximate eigenbasis certifies to 1e-6).
            a = base_solve(x, z)
            c = q * a - x
            e = cone_residual(a, c, z)
            da = base_solve(jnp.zeros_like(x), e)
            a = a + da
            c = q * a - x
            return a, y[:0], c

        return solve3x3

    return solve3x3gen


@functools.lru_cache(maxsize=None)
def _spectral_kktsolver_cached(eig_dtype):
    def kkt(Q, A, G, spec):
        return kktsolver_spectral(Q, A, G, spec, eig_dtype=eig_dtype)

    return kkt


def spectral_kktsolver(eig_dtype=None):
    """Hashable cached factory (jit-static-arg friendly, like
    ``_default_kktsolver``)."""
    return _spectral_kktsolver_cached(eig_dtype)
