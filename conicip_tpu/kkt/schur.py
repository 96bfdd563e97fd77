"""Dense Schur-complement KKT solver — the default.

The reference's fastest backend eliminates the cone block and sparse-LU
factors the saddle system ``[[Q + Aᵀ(FᵀF)⁻¹A, Gᵀ], [G, 0]]``
(kktsolver_2x2, kktsolvers.jl:281-310). Here the operands are dense, and the
Schur matrix is assembled as ``M = Q + Atilᵀ Atil`` with ``Atil = F⁻ᵀA``
applied *structurally* (row scalings + batched rank-1 / congruence updates —
one big matmul, never materializing FᵀF, fixing the reference's worst
allocation pathology, report.md:148-151), and the saddle system is solved by
a second Schur complement on G:

    M = L Lᵀ  (Cholesky)
    S = G M⁻¹ Gᵀ = (L⁻¹Gᵀ)ᵀ(L⁻¹Gᵀ),   S = Ls Lsᵀ

Mixed-precision design (``factor_dtype=float32``): the whole inner solve
path — casts, assembly, factorization, AND every per-RHS application — runs
in f32; the IPM's iterative-refinement loop against higher-precision
residuals restores accuracy. Per-RHS triangular back-solves are replaced by
GEMVs against an explicitly formed ``L⁻¹`` computed once per iteration:
a vector triangular solve is a latency-bound sequential op while a GEMV is
one parallel pass, and the predictor + corrector + refinement steps perform
3-6 back-solves per factorization. Whether that trade pays on the GPU is
not measured yet (ROADMAP Speed 5). The explicit inverse's extra rounding is
bounded by κ(L)·eps per apply — exactly what refinement corrects.

Last-mile full-precision iterations (``lastmile=True``): near convergence
κ(M) ~ 1/μ exceeds what an f32 factorization can solve — refinement stalls
a factor ~2 above a 1e-6 tolerance while the final Newton step injects f32
noise into the dual residual (measured: duFeas jumps 1e-8 → 1e-4 on the
iteration after the stall). Rather than dying one iteration short and
paying a warm-started full-f64 ladder re-dispatch (solver/__init__.py), a
``lastmile`` generator exposes TWO static variants via
``solve3x3gen(F, FinvT, mode="fast"|"slow")`` — the f32 path and the
full-working-dtype path — and the IPM holds a single ``lax.cond`` per
iteration that picks one INSIDE the same while_loop (solver/ipm.py). Only
the final one or two iterations pay the f64 factorization. The variants
are straight-line code: an earlier design with per-RHS ``lax.cond``s paid
a large per-iteration control-flow overhead. Static f64 assembly alone (``assemble_dtype``) was measured NOT to rescue these
stalls; the factorization is the binding constraint.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.scipy.linalg import solve_triangular

from ..cones import scaling as sc
from ..cones.spec import ConeSpec
from ..ops.cholesky import cholesky, tri_inv
from ..ops.control import retry_while
from .pivot import pivot

__all__ = ["kktsolver_2x2", "kktsolver_schur"]

_HI = jax.lax.Precision.HIGHEST


def kktsolver_2x2(Q, A, G, spec: ConeSpec, *, factor_dtype=None,
                  assemble_dtype=None, lastmile=False):
    """Dense-Cholesky 2x2 solver for ``[[M, Gᵀ], [G, 0]]`` with
    ``M = Q + Aᵀ(FᵀF)⁻¹A``.

    With equalities present, ``M`` alone can be singular (e.g. Q = 0 and
    fewer cone rows than variables — the reference's sparse saddle LU
    tolerates this, a plain Schur-on-M does not). We factor the *augmented*
    matrix ``M̃ = M + γ GᵀG`` instead, which is SPD exactly when
    ``[Q; A; G]`` has full column rank — the condition the preprocessor
    guarantees (preprocessor.jl:31-38). The saddle solution is recovered
    exactly (no regularization error):

        M̃ a + Gᵀ b = r₁ + γ Gᵀ r₂,   G a = r₂
        →  a = t − E b̂,  S̃ b̂ = G t − r₂
        with t = M̃⁻¹(r₁ + γ Gᵀ r₂),  E = M̃⁻¹Gᵀ,  S̃ = G E  (SPD).

    γ balances the two terms' scales for conditioning.

    ``assemble_dtype`` pins a (possibly higher) static assembly precision;
    ``lastmile`` exposes the two-variant ``mode`` contract so the IPM can
    switch the whole solve path to the working dtype per iteration
    (module docstring).
    """
    n = Q.shape[0]
    p = G.shape[0]
    wd = Q.dtype  # working dtype of the IPM vectors
    fd = wd if factor_dtype is None else factor_dtype
    # Assembly precision can exceed factorization precision: SOC scalings
    # span ~16 decades near convergence and the Gram assembly cancels
    # catastrophically in f32 — assembling in f64 and factoring the
    # equilibrated result in f32 rescues a class of far-from-tolerance
    # stalls.
    ad = fd if assemble_dtype is None else assemble_dtype
    lastmile = bool(lastmile) and fd != wd

    def _factors(adt, odt, F, FinvT):
        """Assemble (precision ``adt``), equilibrate, and factor (precision
        ``odt``) the augmented Schur system. Returns a flat tuple of
        ``odt`` arrays: (Linv, dscale, gamma, Es, Lsinv, sscale)."""
        Qa = Q.astype(adt)
        Aa = A.astype(adt)
        Fa = sc.cast(FinvT, adt)
        Atil = sc.apply_mat(spec, Fa, Aa)  # F⁻ᵀ A, structure-exploiting
        M = Qa + jnp.matmul(Atil.T, Atil, precision=_HI)
        if p:
            Ga = G.astype(adt)
            gamma = (jnp.trace(M) / n) / (
                jnp.sum(Ga * Ga) / p + jnp.finfo(adt).tiny
            )
            gamma = jnp.where(jnp.isfinite(gamma) & (gamma > 0), gamma, 1.0)
            M = M + gamma * jnp.matmul(Ga.T, Ga, precision=_HI)
        else:
            gamma = jnp.ones((), adt)

        ridge = 30.0 * jnp.finfo(odt).eps

        def _equilibrate(Msym):
            dscale = jax.lax.rsqrt(
                jnp.maximum(jnp.diagonal(Msym), jnp.finfo(Msym.dtype).tiny)
            )
            Ms = (Msym * dscale[:, None] * dscale[None, :]).astype(odt)
            return Ms, dscale.astype(odt)

        def _factor_inv(Ms, k):
            # Late IPM iterations drive κ(M) toward 1/μ ≈ 1e10+, beyond
            # what a raw f32 Cholesky survives. Jacobi equilibration (unit
            # diagonal) plus a tiny relative ridge keeps the factorization
            # finite; the exact perturbation is corrected by refinement.
            Ik = jnp.eye(k, dtype=odt)
            # Escalating-ridge retries (boosts 1e3 then 1e6): SOC rank-1
            # scaling terms span ~16 decades near convergence and their
            # rounded assembly can leave Ms indefinite beyond the base
            # ridge — a NaN factor would otherwise poison the step.
            # retry_while, not a lax.cond chain: under vmap (the batched
            # solvers) conds become selects and every instance would pay
            # THREE factorizations per iteration unconditionally.
            L = retry_while(
                lambda L: ~jnp.all(jnp.isfinite(L)),
                lambda boost: cholesky(Ms + (boost * ridge) * Ik),
                cholesky(Ms + ridge * Ik),
                jnp.asarray(1e3, odt),
                1e3,
                1e7,
            )
            # One-time explicit triangular inverse: every subsequent
            # back-solve becomes two GEMVs (module docstring cost model).
            return tri_inv(L)

        Ms, dscale = _equilibrate(M)
        Linv = _factor_inv(Ms, n)
        if p:
            # S = G M̃⁻¹ Gᵀ = Ê Êᵀ with Ê = G D L⁻ᵀ in equilibrated space
            E = jnp.matmul(Linv, dscale[:, None] * G.T.astype(odt),
                           precision=_HI)
            S = jnp.matmul(E.T, E, precision=_HI)  # SPD
            Ss, sscale = _equilibrate(S)
            Lsinv = _factor_inv(Ss, p)
        else:
            Lsinv = jnp.zeros((0, 0), odt)
            sscale = jnp.zeros((0,), odt)
        return Linv, dscale, gamma.astype(odt), Lsinv, sscale

    def _make_solve(facts, Gd, GdT):
        Linv, dscale, gamma, Lsinv, sscale = facts
        td = Linv.dtype

        def inv2(Tinv, scale, x):
            # M⁻¹x = D L⁻ᵀ L⁻¹ D x with D the equilibration scale
            t = jnp.matmul(Tinv, scale * x, precision=_HI)
            return scale * jnp.matmul(Tinv.T, t, precision=_HI)

        def solve(by, bw):
            by = by.astype(td)
            bw = bw.astype(td)
            if p:
                t = inv2(Linv, dscale,
                         by + gamma * jnp.matmul(GdT, bw, precision=_HI))
                b2 = inv2(Lsinv, sscale,
                          jnp.matmul(Gd, t, precision=_HI) - bw)
                a = t - inv2(Linv, dscale,
                             jnp.matmul(GdT, b2, precision=_HI))
                return a.astype(wd), b2.astype(wd)
            return inv2(Linv, dscale, by).astype(wd), by[:0].astype(wd)

        return solve

    Gf = G.astype(fd)

    if not lastmile:

        def solve2x2gen(F, FinvT):
            return _make_solve(_factors(ad, fd, F, FinvT), Gf, Gf.T)

        return solve2x2gen

    # Two STATIC variants selected by the caller's ``mode`` (the IPM holds
    # one lax.cond per iteration around the whole step; no control flow
    # down here, so each variant stays straight-line fusable XLA code).
    def solve2x2gen_lm(F, FinvT, mode="fast"):
        if mode == "slow":
            return _make_solve(_factors(wd, wd, F, FinvT), G, G.T)
        return _make_solve(_factors(ad, fd, F, FinvT), Gf, Gf.T)

    return solve2x2gen_lm


def kktsolver_schur(Q, A, G, spec: ConeSpec, *, factor_dtype=None,
                    assemble_dtype=None, lastmile=False):
    """Default KKT solver: :func:`pivot` around :func:`kktsolver_2x2`."""
    inner = functools.partial(kktsolver_2x2, factor_dtype=factor_dtype,
                              assemble_dtype=assemble_dtype,
                              lastmile=lastmile)
    return pivot(inner, factor_dtype=factor_dtype,
                 lastmile=lastmile)(Q, A, G, spec)
