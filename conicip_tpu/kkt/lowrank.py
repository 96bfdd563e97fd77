"""Diagonal + low-rank Schur KKT solver — the dense form of the lift trick.

For problems whose inequality matrix is ``A = [I_n; A_s]`` — bound rows
for every R coordinate plus a SMALL block of general rows tied to SOC
cones — with diagonal ``Q``, the Schur matrix is diagonal plus low rank:

    M = diag(Q) + diag(1/r_d²) + A_sᵀ (F⁻²)_soc A_s + γ GᵀG
      = D + U Kb Uᵀ,   U = [A_sᵀ, Gᵀ]  (n, r),  r = m_s + p

with ``Kb = blockdiag((F⁻²)_soc, γI)`` — both blocks available in closed
form from the NT scaling's (d, u, α) parameters. Woodbury reduces every
``M⁻¹`` apply to diagonal scalings, thin matmuls against the CONSTANT U,
and one r×r factorization per iteration — replacing the dense (n, n)
f64 factorization that dominates the batched mixed R+Q+equality family
(n = 200, r = 61: a ~10x smaller factor).

This is the role the reference's sparse-LU ``lift`` plays
(kktsolvers.jl:60-105: it expands each Woodbury block into an augmented
sparse system for UMFPACK); here the low-rank structure is exploited
directly with dense batched algebra. Equalities use the same exact
augmented-saddle recovery as ``kkt/schur.kktsolver_2x2`` (γ-augmented M,
second Schur on G — no regularization error).

Full working-dtype only (it is the escalation-ladder finisher; the f32
warm-up tiers keep the dense path). Applicability is checked host-side
by :func:`lowrank_applicable`.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..cones.spec import ConeSpec
from ..ops.cholesky import cholesky, tri_inv
from .pivot import pivot

__all__ = ["kktsolver_lowrank", "lowrank_applicable"]

_HI = jax.lax.Precision.HIGHEST


def _mm(a, b):
    return jnp.matmul(a, b, precision=_HI)


def lowrank_applicable(Q, A, G, spec: ConeSpec, max_rank: int = 160) -> bool:
    """Host-side check: no SDP cones, ``nr == n`` with the R rows of A
    equal to I, diagonal Q, and small total low-rank dimension
    (SOC rows + equality rows ≤ ``max_rank``)."""
    if spec.sdp_groups or not spec.soc_groups or not spec.nr:
        return False
    Qh = np.asarray(Q)
    Ah = np.asarray(A)
    n = Qh.shape[-1]
    if spec.nr != n or Ah.shape[-1] != n:
        return False
    m_s = Ah.shape[-2] - n
    p = 0 if G is None else np.shape(G)[-2]
    if m_s <= 0 or m_s + p > max_rank:
        return False
    if p:
        # rank-deficient / inconsistent equality systems keep the
        # elimination path, whose host-side rank repair and consistency
        # check (preprocessor semantics) the direct saddle lacks
        Gh = np.asarray(G, np.float64)
        for Gi in Gh.reshape(-1, p, Gh.shape[-1]):
            if np.linalg.matrix_rank(Gi) < p:
                return False
    # R rows must come first and equal I (segment layout: R block leads)
    r_idx = np.asarray(spec.r_idx)
    if r_idx.size != n or not np.array_equal(r_idx, np.arange(n)):
        return False
    eye = np.eye(n)
    for Ai in Ah.reshape(-1, *Ah.shape[-2:]):
        if not np.array_equal(Ai[:n], eye):
            return False
    for Qi in Qh.reshape(-1, n, n):
        if not np.array_equal(Qi, np.diag(np.diagonal(Qi))):
            return False
        if np.any(np.diagonal(Qi) < 0):
            return False
    return True


def _soc_sq_dense(soc_params, groups, nr, m_s, dtype):
    """Materialize blockdiag(F²) (or F⁻² from the inverse scaling's
    params) over the SOC section as a dense (m_s, m_s) matrix:
    F² = diag(d²) + α(v₁uᵀ + uv₁ᵀ) + α²(uᵀu)uuᵀ, v₁ = d∘u."""
    K = jnp.zeros((m_s, m_s), dtype)
    for g, sc_ in zip(groups, soc_params):
        v1 = sc_.d * sc_.u
        s_uu = jnp.sum(sc_.u * sc_.u, axis=-1)
        blk = (
            jnp.eye(g.dim, dtype=dtype) * (sc_.d * sc_.d)[:, None, :]
            + sc_.alpha[:, None, None]
            * (v1[:, :, None] * sc_.u[:, None, :]
               + sc_.u[:, :, None] * v1[:, None, :])
            + (sc_.alpha * sc_.alpha * s_uu)[:, None, None]
            * sc_.u[:, :, None] * sc_.u[:, None, :]
        )  # (k, dim, dim)
        idx = g.idx - nr  # rows relative to the SOC section
        K = K.at[idx[:, :, None], idx[:, None, :]].set(blk)
    return K


def kktsolver_lowrank(Q, A, G, spec: ConeSpec):
    """2x2 solver factory (wrapped by :func:`pivot` in
    :func:`lowrank_kktsolver`); module docstring for the math."""
    n = Q.shape[-1]
    m_s = A.shape[0] - n
    p = G.shape[0]
    wd = Q.dtype
    qdiag = jnp.diagonal(Q)
    A_s = A[n:, :]  # (m_s, n), constant
    U = jnp.concatenate([A_s.T, G.T], axis=1) if p else A_s.T  # (n, r)
    r = m_s + p

    def solve2x2gen(F, FinvT):
        winv = 1.0 / (F.r_d * F.r_d)  # (n,)
        D = qdiag + winv
        if p:
            gamma = (jnp.sum(D) / n) / (
                jnp.sum(G * G) / p + jnp.finfo(wd).tiny
            )
            gamma = jnp.where(jnp.isfinite(gamma) & (gamma > 0), gamma, 1.0)
        else:
            gamma = jnp.ones((), wd)
        # Kb⁻¹ = blockdiag((F²)_soc, (1/γ) I_p)
        Kinv = jnp.zeros((r, r), wd)
        Kinv = Kinv.at[:m_s, :m_s].set(
            _soc_sq_dense(F.soc, spec.soc_groups, n, m_s, wd))
        if p:
            Kinv = Kinv.at[jnp.arange(m_s, r), jnp.arange(m_s, r)].set(
                1.0 / gamma)
        Dinv = 1.0 / D
        UD = U * Dinv[:, None]  # D⁻¹U  (n, r)
        T = Kinv + _mm(U.T, UD)  # (r, r), SPD
        T = 0.5 * (T + T.T)
        # equilibrated f64 factorization of the small inner system
        dscale = jax.lax.rsqrt(
            jnp.maximum(jnp.diagonal(T), jnp.finfo(wd).tiny))
        Ts = T * dscale[:, None] * dscale[None, :]
        ridge = 30.0 * jnp.finfo(wd).eps
        L = cholesky(Ts + ridge * jnp.eye(r, dtype=wd))
        Linv = tri_inv(L)

        def Tinv(x):
            # T⁻¹x = S Lⁱⁿᵛᵀ Linv S x (S = equilibration scale); x (r,)
            # or (r, k)
            if x.ndim == 1:
                t = _mm(Linv, dscale * x)
                return dscale * _mm(Linv.T, t)
            t = _mm(Linv, dscale[:, None] * x)
            return dscale[:, None] * _mm(Linv.T, t)

        def Minv(x):
            # Woodbury: M̃⁻¹x = D⁻¹x − D⁻¹U T⁻¹ UᵀD⁻¹x
            if x.ndim == 1:
                return Dinv * x - _mm(UD, Tinv(_mm(UD.T, x)))
            return Dinv[:, None] * x - _mm(UD, Tinv(_mm(UD.T, x)))

        if p:
            E = Minv(G.T)  # (n, p)
            S = _mm(G, E)  # p×p SPD
            S = 0.5 * (S + S.T)
            sscale = jax.lax.rsqrt(
                jnp.maximum(jnp.diagonal(S), jnp.finfo(wd).tiny))
            Ss = S * sscale[:, None] * sscale[None, :]
            Ls = cholesky(Ss + ridge * jnp.eye(p, dtype=wd))
            Lsinv = tri_inv(Ls)

            def Sinv(x):
                t = _mm(Lsinv, sscale * x)
                return sscale * _mm(Lsinv.T, t)

        def solve(by, bw):
            if p:
                t = Minv(by + gamma * _mm(G.T, bw))
                b2 = Sinv(_mm(G, t) - bw)
                a = t - Minv(_mm(G.T, b2))
                return a, b2
            return Minv(by), by[:0]

        return solve

    return solve2x2gen


@functools.lru_cache(maxsize=None)
def _lowrank_kktsolver_cached():
    return pivot(lambda Q, A, G, spec: kktsolver_lowrank(Q, A, G, spec))


def lowrank_kktsolver():
    """Hashable cached 3x3 factory (pivot-adapted), jit-static friendly."""
    return _lowrank_kktsolver_cached()
