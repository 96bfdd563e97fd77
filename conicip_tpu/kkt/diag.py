"""Structure-exploiting KKT solver for separable (bound-style) constraints.

The reference's fastest backend on its own headline problem is the sparse
LU (``kktsolver_2x2`` + UMFPACK, kktsolvers.jl:281-310), whose speed on box
QPs comes from the Schur matrix ``M = Q + Aᵀ(FᵀF)⁻¹A`` being effectively
diagonal. Sparse LU has no analogue here — but the *structure* does: when

- every cone is ``R`` (so ``(FᵀF)⁻¹`` is diagonal),
- every row of A has at most ONE nonzero (bound constraints ±s·yᵏ ≥ b),
- Q is diagonal,

then ``M`` is diagonal and the whole per-iteration factorization collapses
to one segment-sum plus elementwise math. The segment-sum is a matmul
against a 0/1 incidence matrix built once per solve (a dense product instead
of a scatter-add): ``diag(M) = diag(Q) + P @ (d ⊙ a²)``
with ``P[k, i] = 1`` iff row i of A touches column k.

Equalities use the same exact augmented-saddle recovery as the dense path
(``M̃ = M + γGᵀG``), with ``M̃⁻¹`` applied EXACTLY in one of two modes
(``eq_mode``):

- ``"disjoint"``: when every row of G has at most one nonzero, ``GᵀG`` is
  diagonal and ``M̃`` stays diagonal — the augmentation is a diagonal add.
- ``"woodbury"``: general G. ``M̃ = D + Gᵀ(γI)G`` with ``D = diag(M)``
  inverts in closed form, ``M̃⁻¹ = D⁻¹ − D⁻¹Gᵀ(γ⁻¹I + GD⁻¹Gᵀ)⁻¹GD⁻¹``
  — a (p, p) Cholesky plus thin matmuls, still O(n·p²) per iteration.
  Requires D bounded away from zero for stability (D⁻¹ appears on both
  sides of a cancellation), which :func:`equality_mode` guarantees by
  demanding a strictly positive diag(Q).

Applicability is NOT verified inside the (traced) solver — call
:func:`separable` on the concrete problem data first, as ``conic_ip`` users
choose backends explicitly (mirroring the reference, where picking
``kktsolver_sparse`` for the wrong problem is likewise on the caller).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..cones.spec import ConeSpec
from ..ops.cholesky import cholesky
from .pivot import pivot

__all__ = ["kktsolver_diag", "separable", "separable_batch", "equality_mode"]

_HI = jax.lax.Precision.HIGHEST


def _host(X):
    return np.asarray(X.toarray() if hasattr(X, "toarray") else X)


def equality_mode(Q, G):
    """Host-side choice of the exact equality-handling mode (module
    docstring), or ``None`` when no mode is exact AND stable — the caller
    must then fall back to the dense Schur backend. Works on single
    problems and on batches (leading batch axis); a batch must admit one
    common mode.

    - no equalities → ``"none"``
    - every row of G has at most one nonzero — the only pattern whose
      ``GᵀG = Σᵣ gᵣgᵣᵀ`` is diagonal → ``"disjoint"``
    - diag(Q) strictly positive (Woodbury's ``D⁻¹`` stays bounded even
      when a variable's every inequality goes inactive) → ``"woodbury"``
    """
    if G is None:
        return "none"
    Gh = _host(G)
    if Gh.size == 0 or Gh.shape[-2] == 0:
        return "none"
    if np.all(np.count_nonzero(Gh, axis=-1) <= 1):
        return "disjoint"
    qd = np.diagonal(_host(Q), axis1=-2, axis2=-1)
    if qd.size and np.min(qd) > 1e-10 * max(1.0, float(np.max(qd))):
        return "woodbury"
    return None


def separable(Q, A, G, spec: ConeSpec) -> bool:
    """Host-side applicability check (one-time, numpy, concrete data).

    Call it on the caller's HOST arrays: running it on device arrays pays
    a full device→host transfer of Q and A.
    """
    if spec.soc_groups or spec.sdp_groups:
        return False
    Qh = _host(Q)
    if Qh.ndim != 2 or np.count_nonzero(Qh - np.diag(np.diagonal(Qh))):
        return False
    Ah = _host(A)
    if not np.all(np.count_nonzero(Ah, axis=1) <= 1):
        return False
    return equality_mode(Q, G) is not None


def separable_batch(Q, A, G, spec: ConeSpec) -> bool:
    """Batched variant of :func:`separable`: the pattern must hold for
    EVERY instance (leading batch axis on Q and A; G batched or shared).
    Same host-array caveat."""
    if spec.soc_groups or spec.sdp_groups:
        return False
    Qh = np.asarray(Q)
    n = Qh.shape[-1]
    offdiag = ~np.eye(n, dtype=bool)
    if Qh.ndim != 3 or np.count_nonzero(Qh[:, offdiag]):
        return False
    Ah = np.asarray(A)
    if not np.all(np.count_nonzero(Ah, axis=2) <= 1):
        return False
    return equality_mode(Q, G) is not None


def kktsolver_2x2_diag(Q, A, G, spec: ConeSpec, *, factor_dtype=None,
                       eq_mode="woodbury"):
    """2x2 solver with a diagonal Schur matrix (module docstring).

    ``eq_mode`` selects how equalities are folded in — it must be chosen
    host-side (see :func:`equality_mode`); the traced solver cannot inspect
    G's pattern. Both modes are EXACT for their admissible problems.
    """
    n = Q.shape[0]
    p = G.shape[0]
    wd = Q.dtype
    fd = wd if factor_dtype is None else factor_dtype
    if p and eq_mode not in ("disjoint", "woodbury"):
        raise ValueError(f"unknown eq_mode {eq_mode!r}")

    # Traceable pattern extraction (runs once at setup, hoisted out of the
    # iterate loop): column index + coefficient of each row's single nonzero.
    absA = jnp.abs(A)
    cols = jnp.argmax(absA, axis=1)
    coef = jnp.take_along_axis(A, cols[:, None], axis=1)[:, 0].astype(fd)
    P = (
        jax.nn.one_hot(cols, n, dtype=fd).T
        * (coef != 0).astype(fd)[None, :]
    )  # (n, m) incidence
    asq = coef * coef
    qdiag = jnp.diagonal(Q).astype(fd)
    Gf = G.astype(fd)
    GfT = Gf.T
    ridge = 30 * jnp.finfo(fd).eps

    def _spd_inv_factor(S, k):
        Ls = cholesky(S + (ridge * jnp.trace(S) / k) * jnp.eye(k, dtype=fd))
        return jax.scipy.linalg.solve_triangular(
            Ls, jnp.eye(k, dtype=fd), lower=True
        )

    def solve2x2gen(F, FinvT):
        # (FᵀF)⁻¹ diagonal for R cones: F = diag(r_d) ⇒ rinv = r_d⁻²
        rinv = (1.0 / (F.r_d * F.r_d)).astype(fd)
        mdiag = qdiag + jnp.matmul(P, rinv * asq, precision=_HI)
        if p:
            gamma = (jnp.sum(mdiag) / n) / (
                jnp.sum(Gf * Gf) / p + jnp.finfo(fd).tiny
            )
            gamma = jnp.where(jnp.isfinite(gamma) & (gamma > 0), gamma, 1.0)
            if eq_mode == "disjoint":
                # GᵀG diagonal ⇒ M̃ = diag(mdiag + γ·colsq), exactly
                minv_d = 1.0 / (mdiag + gamma * jnp.sum(Gf * Gf, axis=0))

                def minv(x):
                    return minv_d * x

                ET = minv_d[:, None] * GfT  # M̃⁻¹Gᵀ  (n, p)
            else:
                # Woodbury: M̃ = D + Gᵀ(γI)G with D = diag(mdiag) ⇒
                # M̃⁻¹ = D⁻¹ − D⁻¹Gᵀ K⁻¹ G D⁻¹,  K = γ⁻¹I + G D⁻¹ Gᵀ
                dinv = 1.0 / jnp.maximum(mdiag, jnp.finfo(fd).tiny)
                GD = Gf * dinv[None, :]  # G D⁻¹  (p, n)
                GDGt = jnp.matmul(GD, GfT, precision=_HI)  # (p, p)
                K = GDGt + jnp.eye(p, dtype=fd) / gamma
                Lkinv = _spd_inv_factor(K, p)
                Kinv = jnp.matmul(Lkinv.T, Lkinv, precision=_HI)
                GDT = GD.T

                def minv(x):
                    t = dinv * x
                    return t - jnp.matmul(
                        GDT,
                        jnp.matmul(
                            Kinv, jnp.matmul(Gf, t, precision=_HI),
                            precision=_HI,
                        ),
                        precision=_HI,
                    )

                ET = GDT - jnp.matmul(
                    GDT, jnp.matmul(Kinv, GDGt, precision=_HI), precision=_HI
                )  # M̃⁻¹Gᵀ  (n, p)
            S = jnp.matmul(Gf, ET, precision=_HI)  # G M̃⁻¹ Gᵀ  (p, p)
            S = 0.5 * (S + S.T)
            Lsinv = _spd_inv_factor(S, p)
        else:
            minv_d = 1.0 / mdiag

        def solve2x2(by, bw):
            by = by.astype(fd)
            bw = bw.astype(fd)
            if p:
                t = minv(by + gamma * jnp.matmul(GfT, bw, precision=_HI))
                rhs = jnp.matmul(Gf, t, precision=_HI) - bw
                b2 = jnp.matmul(
                    Lsinv.T,
                    jnp.matmul(Lsinv, rhs, precision=_HI),
                    precision=_HI,
                )
                a = t - jnp.matmul(ET, b2, precision=_HI)
                return a.astype(wd), b2.astype(wd)
            return (minv_d * by).astype(wd), by[:0].astype(wd)

        return solve2x2

    return solve2x2gen


def kktsolver_diag(Q, A, G, spec: ConeSpec, *, factor_dtype=None,
                   eq_mode="woodbury"):
    """3x3 KKT solver exploiting separable structure. Verify applicability
    with :func:`separable` on concrete data first, and pick ``eq_mode``
    with :func:`equality_mode` when equalities are present."""
    if spec.soc_groups or spec.sdp_groups:
        raise ValueError("kktsolver_diag supports R cones only")
    inner = functools.partial(
        kktsolver_2x2_diag, factor_dtype=factor_dtype, eq_mode=eq_mode
    )
    return pivot(inner, factor_dtype=factor_dtype)(Q, A, G, spec)
