"""Mehrotra predictor-corrector interior-point core.

Re-implementation of the reference's ``conicIP`` iterate loop
(ConicIP.jl:364-939): the whole solve is one ``lax.while_loop`` under jit —
static shapes, no data-dependent Python control flow, every per-iteration
quantity a fused XLA computation. Termination/status logic is mask-based
(a scalar status code in the carry), which makes the solver ``jax.vmap``-safe
for batched problem instances: converged instances freeze their iterates
while the rest keep stepping.

Semantics preserved exactly (same initial point, residual normalizations,
CVXOPT+ECOS infeasibility certificates, best-iterate tracking, iterative
refinement, fraction-to-boundary step) so the reference's test suite carries
over; see inline citations.

Mixed-precision residuals (the opt-in f32 regime, ``factor_dtype=float32``):
the residual/certificate evaluations are the only place the IPM *needs*
more than f32: every product inside the KKT solve is corrected by
refinement anyway. So with ``mixedResiduals`` on, all residual mat-vecs run
in f32 each iteration, and a ``lax.cond`` recomputes them in full precision
only when the f32 estimates come within ``residualSwitch`` of a tolerance —
i.e. the last one or two iterations. Convergence and certificate decisions
are only ever taken on full-precision values (the f32 floor is ~1e-7,
well above the 50x-tolerance switch point, so a trigger can't be missed).
"""

from __future__ import annotations


from dataclasses import dataclass, replace
from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp

from ..cones import algebra as ca
from ..cones import scaling as sc
from ..cones.spec import ConeSpec
from ..ops.control import cond_once
from .state import SolState, Status, Vec4

__all__ = ["IPMOptions", "ipm_solve"]

_HI = jax.lax.Precision.HIGHEST


@dataclass(frozen=True)
class IPMOptions:
    """Solver options (kwarg-compatible with the reference, ConicIP.jl:498-510)."""

    optTol: float = 1e-6
    DTB: float = 0.01  # fraction-to-boundary
    verbose: bool = False
    maxRefinementSteps: int = 3
    maxIters: int = 100
    # accepted-but-unused in the reference too (ConicIP.jl:505 — grep shows
    # it is never read); kept for API parity
    cache_nestodd: bool = False
    infeasTol: Optional[float] = None
    refinementThreshold: Optional[float] = None
    # Mixed-precision residual mode (see module docstring). Enabled
    # automatically by conic_ip when factor_dtype=float32 and the working
    # dtype is float64.
    mixedResiduals: bool = False
    residualSwitch: float = 50.0
    # Gondzio multiple centrality correctors (EXTENDS the reference, which
    # runs plain Mehrotra): after the corrector step, up to this many extra
    # back-solves against the SAME factorization push outlier
    # complementarity products back into [0.1, 10]·σμ, enlarging the
    # steplength. A back-solve costs a small fraction of the O(n³)
    # refactorization it can save, so accepted correctors are cheap;
    # rejected ones keep the uncorrected direction (steplength never
    # decreases). 0 disables.
    centralityCorrectors: int = 0
    # Fast-phase low-precision S-cone decompositions (NT scaling,
    # max-step, Lyapunov division, corrector clip). None = auto: f32 in
    # the fast branch when the two-variant KKT generator provides an
    # in-loop full-precision escape (single-solve production path).
    # True = force f32 decompositions even WITHOUT the two-variant
    # generator — the batched fast tier uses this, with the fused rescue
    # ladder as the escape hatch (a breakdown ends Abandoned/Error and
    # the f64 tier re-solves warm). False = always full precision.
    fastEig: Optional[bool] = None
    # Two-variant KKT generator usage. None (default) = use the
    # fast/slow ``mode`` contract when the generator offers it — the
    # in-loop last-mile escalation, correct and cheap for SINGLE solves
    # where lax.cond executes one branch. False = force the single
    # fast-mode path even on a two-variant generator: under vmap (the
    # batched solvers) a lax.cond lowers to a select and BOTH variants'
    # factorizations execute for every instance every iteration — the
    # dead slow-mode factorization roughly doubles the batched
    # per-iteration cost. Batched callers set False and rely on their
    # rescue-ladder tiers (warm-started re-solves) for the escalation the
    # in-loop branch would have provided.
    twoModeKKT: Optional[bool] = None
    # Proactive last-mile: additionally switch the two-variant KKT
    # generator to its full-precision branch once the carried residual is
    # within this factor of tolerance (0 = reactive-only, the default:
    # fire on the first non-improving iteration near tolerance). Proactive
    # firing trades full-precision factorization cost for the 1-2
    # iterations a reactive trigger wastes detecting the stall.
    lastmileProactive: float = 0.0
    # Full-precision stall cutoff: end Abandoned (best iterate kept) after
    # this many consecutive non-improving iterations once the best
    # residual is near tolerance (< residualSwitch x optTol). For
    # full-precision runs there is no higher tier to escalate into, so a
    # near-tolerance plateau would otherwise loop to maxIters — under
    # vmap (batched solves) ONE such instance holds the whole batch's
    # while_loop open (~100 trips for ~7 of progress, the measured
    # batched-SDP tail). None disables (single-solve default; the mixed
    # f32 mode has its own exhaustion detectors).
    stallCutoff: Optional[int] = None

    @property
    def infeas_tol(self) -> float:
        return self.optTol if self.infeasTol is None else self.infeasTol

    @property
    def refinement_threshold(self) -> float:
        return (
            self.optTol / 1e7
            if self.refinementThreshold is None
            else self.refinementThreshold
        )


def _normsafe(x):
    return jnp.linalg.norm(x) if x.shape[0] else jnp.asarray(0.0, x.dtype)


def _dot(a, b):
    """Inner product as one fused multiply+reduce (one IPM iteration takes
    ~18 of them)."""
    return jnp.sum(a * b)


class _Products(NamedTuple):
    """The three stacked mat-vecs everything per-iteration derives from."""

    Qy: jnp.ndarray  # Q @ y                       (n,)
    GAy: jnp.ndarray  # [G; A] @ y                 (p+m,)
    GAtwv: jnp.ndarray  # [Gᵀ, -Aᵀ] @ [w; v]       (n,)


class _Resid(NamedTuple):
    rleft: Vec4
    r0: Vec4
    mu: jnp.ndarray
    mubar: jnp.ndarray
    cty: jnp.ndarray
    rDu: jnp.ndarray
    rPr: jnp.ndarray
    rCp: jnp.ndarray
    rmax: jnp.ndarray
    pobj: jnp.ndarray
    dobj: jnp.ndarray
    p_infeas: jnp.ndarray
    d_infeas: jnp.ndarray


def ipm_solve(
    Q: jnp.ndarray,
    c: jnp.ndarray,
    A: jnp.ndarray,
    b: jnp.ndarray,
    G: jnp.ndarray,
    d: jnp.ndarray,
    spec: ConeSpec,
    kktsolver: Callable,
    opts: IPMOptions,
    warm: Optional[Vec4] = None,
) -> SolState:
    n = c.shape[0]
    m = A.shape[0]
    p = G.shape[0]
    dtype = c.dtype

    # Sanity checks — static shapes, so these are Python-time errors
    # (reference ConicIP.jl:537-541 raises error()).
    if Q.shape != (n, n):
        raise ValueError("Q is not square / inconsistent with objective")
    if b.shape != (m,):
        raise ValueError("Inconsistency in inequalities")
    if A.shape != (m, n):
        raise ValueError("Inconsistency in inequalities/objective")
    if d.shape != (p,):
        raise ValueError("Inconsistency in equalities")
    if G.shape != (p, n):
        raise ValueError("Inconsistency in equalities/objective")
    if spec.m != m:
        raise ValueError("cone dimensions do not sum to size(A, 1)")

    e = jnp.asarray(spec.identity, dtype)
    conedim = spec.conedim
    normc = jnp.linalg.norm(c)
    normb = _normsafe(b)
    normd = jnp.asarray(-jnp.inf, dtype) if p == 0 else jnp.linalg.norm(d)

    # ── Stacked residual operators (module docstring). GA = [G; A] and
    #    GAt = [Gᵀ, -Aᵀ] so that rleft.y = Qy + GAt@[w;v], rleft.w = GAy[:p],
    #    rleft.v = GAy[p:] - s (ConicIP.jl:746-750 as three fused mat-vecs).
    GA = jnp.concatenate([G, A], axis=0)  # (p+m, n)
    GAt = jnp.concatenate([G.T, -A.T], axis=1)  # (n, p+m)

    mixed = bool(opts.mixedResiduals) and dtype != jnp.float32
    if mixed:
        f32 = jnp.float32
        Q32, GA32, GAt32 = Q.astype(f32), GA.astype(f32), GAt.astype(f32)
        eps32 = jnp.asarray(jnp.finfo(jnp.float32).eps, dtype)
        # Sliced operators for certified residual evaluations (~1e-11 of
        # the operand scale from f32 products, operands sliced once at
        # setup — ops/precise.py).
        from ..ops.precise import PreciseMatvec

        Qp, GAp, GAtp = PreciseMatvec(Q), PreciseMatvec(GA), PreciseMatvec(GAt)

    def products_full(y, w, v):
        if mixed:
            wv = jnp.concatenate([w, v])
            return _Products(Qp(y), GAp(y), GAtp(wv))
        wv = jnp.concatenate([w, v])
        return _Products(
            jnp.matmul(Q, y, precision=_HI),
            jnp.matmul(GA, y, precision=_HI),
            jnp.matmul(GAt, wv, precision=_HI),
        )

    def products_fast(y, w, v):
        if not mixed:
            return products_full(y, w, v)
        y32 = y.astype(f32)
        wv32 = jnp.concatenate([w, v]).astype(f32)
        return _Products(
            jnp.matmul(Q32, y32, precision=_HI).astype(dtype),
            jnp.matmul(GA32, y32, precision=_HI).astype(dtype),
            jnp.matmul(GAt32, wv32, precision=_HI).astype(dtype),
        )

    nan = jnp.asarray(jnp.nan, dtype)
    inf = jnp.asarray(jnp.inf, dtype)

    def residual_block(P: _Products, z: Vec4, lam) -> _Resid:
        """All residual / objective / certificate scalars from the three
        stacked products — pure vector work (ConicIP.jl:746-766, 786-850)."""
        rleft_s = ca.cone_prod(spec, lam, lam)
        rleft = Vec4(P.Qy + P.GAtwv, P.GAy[:p], P.GAy[p:] - z.s, rleft_s)
        r0 = Vec4(rleft.y - c, rleft.w - d, rleft.v - b, rleft.s)

        mubar = _dot(z.v, z.s)
        mu = mubar / conedim
        cty = _dot(c, z.y)
        rDu = jnp.linalg.norm(r0.y) / (1.0 + normc)
        rPr = _normsafe(r0.v) / (1.0 + normb)
        rCp = _normsafe(r0.s) / (1.0 + jnp.abs(cty))
        rmax = jnp.maximum(rDu, jnp.maximum(rPr, rCp))
        pobj = 0.5 * _dot(z.y, P.Qy) - cty
        dobj = pobj + _dot(z.w, r0.w) + _dot(z.v, r0.v) - mubar

        p_infeas = nan
        d_infeas = nan
        if not (p == 0 and m == 0):
            # Primal infeasibility (Farkas certificate, CVXOPT+ECOS scalings)
            dw_bv = _dot(d, z.w) - _dot(b, z.v)
            p_unscaled = jnp.linalg.norm(P.GAtwv)  # ‖Gᵀw − Aᵀv‖
            p_cvx = jnp.where(
                dw_bv < 0, p_unscaled / (_normsafe(z.y) + _normsafe(z.v)), nan
            )
            p_ecos = jnp.where(
                dw_bv < 0,
                p_unscaled / (jnp.maximum(1.0, normc) * jnp.abs(dw_bv)),
                nan,
            )
            p_infeas = jnp.maximum(p_cvx, p_ecos)

            # Dual infeasibility / unboundedness (ConicIP.jl:820-850)
            d1 = jnp.linalg.norm(rleft.v) if m else -inf  # ‖Ay − s‖
            d2 = jnp.linalg.norm(rleft.w) if p else -inf  # ‖Gy‖
            d3 = jnp.where(
                jnp.all(jnp.isfinite(z.y)), jnp.linalg.norm(P.Qy), nan
            )
            d_cvx = jnp.where(
                cty > 0,
                jnp.maximum(
                    d1 / jnp.maximum(1.0, normb),
                    jnp.maximum(
                        d2 / jnp.maximum(1.0, normd), d3 / jnp.maximum(1.0, normc)
                    ),
                )
                / jnp.abs(cty),
                nan,
            )
            d_ecos = jnp.where(
                cty > 0,
                jnp.maximum(d1, jnp.maximum(d2, d3)) / jnp.linalg.norm(z.y),
                nan,
            )
            d_infeas = jnp.abs(jnp.maximum(d_cvx, d_ecos))

        return _Resid(
            rleft, r0, mu, mubar, cty, rDu, rPr, rCp, rmax, pobj, dobj,
            p_infeas, d_infeas,
        )

    # LEVEL-1 plugin callback: one-time setup (runs at trace time, outside
    # the iterate loop — QR of Gᵀ etc. happen once, ConicIP.jl:667).
    solve3x3gen = kktsolver(Q, A, G, spec)
    # Optional contract extension: a generator accepting a ``mode`` keyword
    # exposes two static solve variants ("fast"/"slow") and the IPM holds
    # ONE lax.cond per iteration choosing between them — the last-mile
    # full-precision mechanism (kkt/schur.py docstring). Back-compatible:
    # plain (F, FinvT) generators are called exactly as before.
    import inspect as _inspect

    try:
        _gen_two_mode = "mode" in _inspect.signature(solve3x3gen).parameters
    except (TypeError, ValueError):  # pragma: no cover
        _gen_two_mode = False
    if _gen_two_mode and opts.twoModeKKT is False:
        # vmapped caller (see IPMOptions.twoModeKKT): pin the fast
        # variant so the loop body holds ONE factorization; the caller's
        # rescue ladder owns escalation.
        _gen = solve3x3gen
        solve3x3gen = lambda F, FinvT: _gen(F, FinvT, mode="fast")  # noqa: E731
        _gen_two_mode = False

    def make_solve4(lam, F, FinvT, solve3x3, eig_dtype=None, lam_eigs=None):
        """4x4 → 3x3 reduction (solve4x4gen, ConicIP.jl:669-694).

        ``lam_eigs`` shares one eigendecomposition of mat(λ) across every
        Lyapunov division this iteration (predictor, corrector, ≤3
        refinements — the same matrix each time; see ca.sdp_eighs)."""

        def solve4(r: Vec4) -> Vec4:
            t1 = sc.apply_adjoint(
                spec, F, ca.cone_div(spec, r.s, lam, eig_dtype,
                                     y_eigs=lam_eigs)
            )
            dy, dw, dv = solve3x3(r.y, r.w, r.v + t1)
            ds = t1 - sc.apply_adjoint(spec, F, sc.apply(spec, F, dv))
            return Vec4(dy, dw, dv, ds)

        return solve4

    # ── Initial point (ConicIP.jl:700-713): one KKT solve at F = I — or a
    #    warm start from a caller-provided iterate — then shift v, s
    #    strictly inside the cone.
    if warm is None:
        Fi = sc.nt_identity(spec, dtype)
        solve3_init = solve3x3gen(Fi, Fi)
        z0 = make_solve4(
            e, Fi, Fi, solve3_init,
            lam_eigs=(tuple((sd.lam, None) for sd in Fi.sdp)
                      if spec.sdp_groups else None),
        )(Vec4(c, d, b, jnp.zeros(m, dtype)))
    else:
        z0 = Vec4(
            warm.y.astype(dtype),
            warm.w.astype(dtype),
            warm.v.astype(dtype),
            warm.s.astype(dtype),
        )
    a_v = ca.maxstep_to_cone(spec, z0.v)
    a_s = ca.maxstep_to_cone(spec, z0.s)
    z0 = Vec4(z0.y, z0.w, z0.v - a_v * e, z0.s - a_s * e)

    sol0 = SolState(
        y=z0.y,
        w=z0.w,
        v=z0.v,
        status=jnp.asarray(Status.RUNNING, jnp.int32),
        Iter=jnp.asarray(0, jnp.int32),
        Mu=jnp.asarray(0.0, dtype),
        prFeas=inf,
        duFeas=inf,
        muFeas=inf,
        pobj=inf,
        dobj=-inf,
    )

    def fts(x1, a1, y1, x2, a2, y2):
        # (x1 - a1*y1)ᵀ(x2 - a2*y2) without forming the differences
        # (reference ``fts``, ConicIP.jl:162-163)
        return (
            _dot(x1, x2)
            - a2 * _dot(x1, y2)
            - a1 * _dot(y1, x2)
            + a1 * a2 * _dot(y1, y2)
        )

    sw = opts.residualSwitch

    # Fast-phase low-precision decompositions: when the in-loop escalation
    # contract is available AND the spec has S cones, the fast iterations
    # run every small-matrix eigh/chol/eigvals (NT scaling, max-step,
    # Lyapunov division) in f32. The slow branch reverts to full
    # precision, and a non-finite fast iteration escalates instead of
    # erroring (rescue below).
    if opts.fastEig is None:
        _fast_eig = _gen_two_mode and bool(spec.sdp_groups)
        _force_fast_eig = False
    elif opts.fastEig:
        _fast_eig = _gen_two_mode and bool(spec.sdp_groups)
        # no two-variant generator to escape into (e.g. the batched fast
        # tier): run f32 decompositions unconditionally; the caller's
        # rescue ladder is the escape hatch
        _force_fast_eig = not _gen_two_mode and bool(spec.sdp_groups)
    else:
        _fast_eig = False
        _force_fast_eig = False

    def body(carry):
        (z, sol, optBest, k, rnorm_prev, rstep_prev, P, drift, lm_on,
         stall) = carry
        lm_was = lm_on

        if _fast_eig:
            F = jax.lax.cond(
                lm_on,
                lambda: sc.nt_scaling(spec, z.v, z.s),
                lambda: sc.nt_scaling(spec, z.v, z.s,
                                      eig_dtype=jnp.float32),
            )
        elif _force_fast_eig:
            F = sc.nt_scaling(spec, z.v, z.s, eig_dtype=jnp.float32)
        else:
            F = sc.nt_scaling(spec, z.v, z.s)
        FinvT = sc.nt_inv_adjoint(spec, F)
        lam = sc.apply(spec, F, z.v)  # scaled point: = F⁻ᵀ z.s too

        # Residuals of the nonlinear KKT system (ConicIP.jl:746-757).
        # Mixed mode carries the three product vectors across iterations,
        # updating them incrementally after each step (P ← P − α·K·Δz, a
        # few f32 mat-vecs) with `drift` bounding the accumulated error in
        # relative-residual units. The certified recompute then fires only
        # when a tolerance decision is near AND the drift could affect it:
        # typically once per solve.
        if mixed:
            near = (
                (R_est := residual_block(P, z, lam)).rmax < sw * opts.optTol
            )
            near = (
                near
                | (R_est.p_infeas < sw * opts.infeas_tol)
                | (R_est.d_infeas < sw * opts.infeas_tol)
                | ~jnp.isfinite(R_est.rmax)
            )
            fire = near & (drift > 0.05 * opts.optTol)
            # Honesty guard: long runs that never approach tolerance still
            # accumulate drift; once it reaches 10% of the estimated
            # residual, the estimates (and hence the REPORTED residuals /
            # best-iterate choices) are no longer trustworthy — recertify.
            fire = fire | (drift > 0.1 * R_est.rmax)

            # cond_once, not lax.cond: under vmap (solve_batch) a cond
            # becomes a select and the certified recompute would run
            # for every instance EVERY iteration — cond_once keeps it one
            # batched pass on the (typically one) iteration where some
            # instance's tolerance decision actually needs certifying.
            P = cond_once(fire, lambda: products_full(z.y, z.w, z.v), P)
            drift = jnp.where(fire, 0.0, drift)
            R = residual_block(P, z, lam)
        else:
            P = products_full(z.y, z.w, z.v)
            R = residual_block(P, z, lam)

        # best-iterate tracking (ConicIP.jl:768-773)
        improved = R.rmax < optBest
        optBest = jnp.where(improved, R.rmax, optBest)
        stall = jnp.where(improved, 0, stall + 1).astype(jnp.int32)

        def upd(new, old):
            return jnp.where(improved, new, old)

        sol = SolState(
            y=upd(z.y, sol.y),
            w=upd(z.w, sol.w),
            v=upd(z.v, sol.v),
            status=sol.status,
            Iter=jnp.where(improved, k, sol.Iter),
            Mu=upd(R.mu, sol.Mu),
            prFeas=upd(R.rPr, sol.prFeas),
            duFeas=upd(R.rDu, sol.duFeas),
            muFeas=upd(R.rCp, sol.muFeas),
            pobj=R.pobj,  # always updated (reference quirk, ConicIP.jl:778-779)
            dobj=R.dobj,
        )

        # ── Convergence and certificates (ConicIP.jl:786-867)
        status = jnp.where(R.rmax < opts.optTol, Status.OPTIMAL, Status.RUNNING)

        if not (p == 0 and m == 0):
            infeas = R.p_infeas < opts.infeas_tol
            unbnd = R.d_infeas < opts.infeas_tol
            status = jnp.where(infeas, Status.INFEASIBLE, status)
            status = jnp.where(unbnd, Status.UNBOUNDED, status)

            # certificate normalizations overwrite the solution fields
            # (ConicIP.jl:816, :848)
            dw_bv = _dot(d, z.w) - _dot(b, z.v)
            sol = replace(
                sol,
                y=jnp.where(
                    infeas, nan, jnp.where(unbnd, z.y / jnp.abs(R.cty), sol.y)
                ),
                w=jnp.where(infeas, z.w / -dw_bv, jnp.where(unbnd, nan, sol.w)),
                v=jnp.where(infeas, z.v / -dw_bv, jnp.where(unbnd, nan, sol.v)),
            )

        # divergence of unknown cause (ConicIP.jl:870-873)
        bad = ~(
            jnp.isfinite(R.mu)
            & jnp.isfinite(R.rDu)
            & jnp.isfinite(R.rPr)
            & jnp.isfinite(R.rCp)
        )
        if _gen_two_mode:
            # rescuable in-loop: a non-finite fast-phase iteration (e.g. an
            # f32 chol of a near-singular Z) freezes this step (the dz_ok
            # guard) and escalates via lm_on; only a breakdown INSIDE the
            # full-precision branch is a terminal Error.
            bad = bad & lm_was
        status = jnp.where((status == Status.RUNNING) & bad, Status.ERROR, status)
        if mixed:
            # f32-factorization exhaustion: once the iterate has been near
            # to tolerance, a later 100x residual blow-up means the factor
            # can no longer produce descent — wandering to maxIters would
            # only waste time. Stop with the best iterate; the caller's
            # full-precision backstop finishes the job (solver/__init__.py).
            exhausted = (optBest < sw * opts.optTol) & (
                R.rmax > 100.0 * optBest
            )
            # Complementarity collapse: when the μ-residual has fallen
            # 1000x below the best (still above-tolerance) max-residual,
            # the corrector is shrinking μ while the factorization cannot
            # move the stuck dual/primal residual — continuing only walks
            # into the μ→0 scaling breakdown (NaN → Error). Observed on
            # R+Q+S mixes where rDu pins at the f32 floor around 3e-5.
            # The ~improved guard keeps a still-converging solve (which
            # betters its best residual almost every iteration) alive.
            exhausted = exhausted | (
                (optBest < sw * opts.optTol)
                & (R.rCp < 1e-3 * optBest)
                & ~improved
            )
            # ... and the sharper variant when complementarity is already
            # BELOW tolerance AND well below the stuck residual (the
            # relative gate keeps a single non-improving uptick on a
            # still-converging solve from firing):
            # every further f32 iteration just shrinks μ (observed to waste
            # 2-4 iterations before the collapse clause above fires). The
            # optBest gate keeps infeasibility detection unaffected.
            exhausted = exhausted | (
                (optBest < sw * opts.optTol)
                & (R.rCp < 0.1 * opts.optTol)
                & (R.rCp < 0.01 * optBest)
                & ~improved
            )
            if _gen_two_mode:
                # in-loop escalation available: a stall is only terminal
                # once the FULL-precision branch has had its shot — the
                # reactive trigger fires lm_on on the same signatures
                exhausted = exhausted & lm_was
            status = jnp.where(
                (status == Status.RUNNING) & exhausted, Status.ABANDONED, status
            )
        if opts.stallCutoff is not None:
            # full-precision near-tolerance plateau (IPMOptions docstring)
            plateau = (optBest < sw * opts.optTol) & (
                stall >= opts.stallCutoff
            )
            status = jnp.where(
                (status == Status.RUNNING) & plateau, Status.ABANDONED,
                status,
            )
        status = status.astype(jnp.int32)

        if opts.verbose:
            jax.debug.callback(
                _print_row,
                k,
                R.rPr,
                R.rDu,
                R.rCp,
                R.pobj,
                R.dobj,
                R.p_infeas,
                R.d_infeas,
                rstep_prev,
                rnorm_prev,
                ordered=True,
            )

        r0, rleft, mu, mubar = R.r0, R.rleft, R.mu, R.mubar

        # Last-mile trigger for the KKT generator: REACTIVE — fire only on
        # the stall signature (iterate near tolerance AND this iteration
        # failed to improve the best residual; healthy solves improve
        # every iteration, so they never pay the full-precision branch) or
        # a non-finite residual breakdown. Sticky (lm_on carried): once the
        # f32 path has demonstrably run out, every remaining iteration
        # runs the full-precision branch — no f32/f64 sawtooth.
        lm_on = lm_on | (
            ((optBest < sw * opts.optTol) & ~improved)
            | ~jnp.isfinite(R.rmax)
        )
        if opts.lastmileProactive > 0:
            # Proactive variant (see IPMOptions): enter the full-precision
            # branch as soon as the residual is near tolerance, before a
            # stall wastes iterations. Firing on still-improving iterations
            # is deliberate — near tolerance an f32 step achieves less
            # residual reduction than a full-precision one even when
            # healthy (a stagnation-gated variant was measured to cost +2
            # iterations on many_small_socs).
            lm_on = lm_on | (
                R.rmax < opts.lastmileProactive * opts.optTol
            )

        # ── Predictor / corrector / refinement / step — only while running.
        # λ-frame max-steps for S-cone specs: by congruence invariance
        # maxstep(z.v, d) = maxstep(λ, F d) and maxstep(z.s, d) =
        # maxstep(λ, F⁻ᵀ d) — the scaled directions are needed by the
        # corrector anyway, mat(λ) is decomposed ONCE per iteration
        # (sdp_eighs), and the two per-site eighs stack into one batched
        # call (maxstep_multi). Cuts the batched tiny-eigh count per
        # iteration from ~15 to ~4. R/Q-only specs keep the
        # original direct-frame path bit-for-bit.
        _lam_frame = bool(spec.sdp_groups)

        def _take_step_with(solve3x3, z, eig_dtype=None):
            # Spectral data of mat(λ) is a free byproduct of the NT
            # scaling (mat(λ) = RᵀZR = Λ exactly; SdpScaling.lam) — no
            # eigendecomposition, and the identity basis (U = None) turns
            # every Lyapunov division elementwise and every λ-frame
            # max-step M into a diagonal congruence.
            lam_eigs = (
                tuple((sd.lam, None) for sd in F.sdp)
                if _lam_frame else None
            )

            def steps2(dv_scaled, ds_scaled):
                av, as_ = ca.maxstep_multi(
                    spec, lam, (dv_scaled, ds_scaled), eig_dtype, lam_eigs
                )
                return jnp.minimum(
                    jnp.minimum(av, 1.0), jnp.minimum(as_, 1.0)
                )

            # LEVEL-2 plugin callback: per-iteration numeric refactorization
            solve4 = make_solve4(lam, F, FinvT, solve3x3, eig_dtype,
                                 lam_eigs)

            # Predictor (ConicIP.jl:879-887)
            d_aff = solve4(r0)
            FiTds = sc.apply(spec, FinvT, d_aff.s)
            Fdv = sc.apply(spec, F, d_aff.v)
            if _lam_frame:
                a_aff = steps2(Fdv, FiTds)
            else:
                a_aff = jnp.minimum(
                    jnp.minimum(
                        ca.maxstep(spec, z.v, d_aff.v, eig_dtype), 1.0),
                    jnp.minimum(
                        ca.maxstep(spec, z.s, d_aff.s, eig_dtype), 1.0),
                )
            rho = fts(z.v, a_aff, d_aff.v, z.s, a_aff, d_aff.s) / mubar
            sigma = jnp.clip(rho, 0.0, 1.0) ** 3

            # Corrector (ConicIP.jl:893-901)
            lc = -(ca.cone_prod(spec, FiTds, Fdv)) + sigma * mu * e
            r = Vec4(r0.y, r0.w, r0.v, rleft.s - lc)

            # Newton step + iterative refinement (ConicIP.jl:907-921).
            # This loop doubles as the mixed-precision recovery mechanism
            # for the f32 factorization. In mixed mode the K·Δz products
            # run through the fast (f32) stacked operators: refinement only
            # needs the residual accurately *relative to Δz*, and near
            # convergence ‖Δz‖ is small, so the f32 floor costs nothing.
            def K4(dz):
                Pd = products_fast(dz.y, dz.w, dz.v)
                return Vec4(
                    Pd.Qy + Pd.GAtwv,
                    Pd.GAy[:p],
                    Pd.GAy[p:] - dz.s,
                    ca.cone_prod(spec, lam, sc.apply(spec, F, dz.v))
                    + ca.cone_prod(spec, lam, sc.apply(spec, FinvT, dz.s)),
                )

            def resid(dz):
                rIr = r - K4(dz)
                return rIr, rIr.norm() / (n + 2 * m)

            dz = solve4(r)
            rIr, rnorm = resid(dz)

            def ref_cond(st):
                _, _, rn, rn_prev, j = st
                # Stall cutoff: stop when a step failed to halve the
                # residual (e.g. at the f32 noise floor) — refinement past
                # that point is a random walk.
                return (
                    (j < opts.maxRefinementSteps)
                    & (rn >= opts.refinement_threshold)
                    & (rn < 0.5 * rn_prev)
                )

            def ref_body(st):
                dz, rIr, rn, _, j = st
                dz = dz + solve4(rIr)
                rIr, rn_new = resid(dz)
                return dz, rIr, rn_new, rn, j + 1

            dz, rIr, rnorm, _, rstep = jax.lax.while_loop(
                ref_cond,
                ref_body,
                (dz, rIr, rnorm, inf, jnp.asarray(0, jnp.int32)),
            )

            # Step with fraction-to-boundary (ConicIP.jl:927-932)
            inv_dtb = 1.0 / (1.0 - opts.DTB)
            if _lam_frame:
                Fdzv = sc.apply(spec, F, dz.v)
                FiTdzs = sc.apply(spec, FinvT, dz.s)
                alpha = steps2(Fdzv * inv_dtb, FiTdzs * inv_dtb)
            else:
                alpha = jnp.minimum(
                    jnp.minimum(
                        ca.maxstep(spec, z.v, dz.v * inv_dtb, eig_dtype),
                        1.0),
                    jnp.minimum(
                        ca.maxstep(spec, z.s, dz.s * inv_dtb, eig_dtype),
                        1.0),
                )
            # A non-finite direction (e.g. a failed f32 factorization)
            # must not corrupt the iterate: freeze instead, so the solve
            # ends Abandoned with the best iterate intact rather than
            # Error-ing out (the full-precision backstop then takes over).
            dz_ok = (
                jnp.all(jnp.isfinite(dz.y))
                & jnp.all(jnp.isfinite(dz.v))
                & jnp.all(jnp.isfinite(dz.s))
                & (jnp.all(jnp.isfinite(dz.w)) if p else True)
            )
            alpha = jnp.where(dz_ok & jnp.isfinite(alpha), alpha, 0.0)
            # 0 * NaN is still NaN — scrub the direction too
            dz = jax.tree_util.tree_map(
                lambda u: jnp.where(dz_ok, u, jnp.zeros_like(u)), dz
            )

            # ── Gondzio multiple centrality correctors (IPMOptions field
            # doc). Static unroll; each round is mask-accepted, so the
            # loop stays vmap-safe and a rejected round costs steplength
            # nothing. `active` turns off after the first rejection
            # (Gondzio's stopping rule) and never starts on a scrubbed
            # (non-finite) direction.
            active = dz_ok
            smu = sigma * mu
            for _ in range(opts.centralityCorrectors):
                atil = jnp.minimum(1.0, 1.08 * alpha + 0.08)
                Fdv = sc.apply(spec, F, dz.v)
                FiTds_c = sc.apply(spec, FinvT, dz.s)
                w_trial = ca.cone_prod(
                    spec, lam - atil * Fdv, lam - atil * FiTds_c
                )
                q = ca.centrality_correction(
                    spec, w_trial, 0.1 * smu, 10.0 * smu, eig_dtype
                )
                ddz = solve4(
                    Vec4(
                        jnp.zeros_like(dz.y),
                        jnp.zeros_like(dz.w),
                        jnp.zeros_like(dz.v),
                        -q,
                    )
                )
                dz_c = dz + ddz
                if _lam_frame:
                    a_c = steps2(
                        (Fdv + sc.apply(spec, F, ddz.v)) * inv_dtb,
                        (FiTds_c + sc.apply(spec, FinvT, ddz.s)) * inv_dtb,
                    )
                else:
                    a_c = jnp.minimum(
                        jnp.minimum(
                            ca.maxstep(spec, z.v, dz_c.v * inv_dtb,
                                       eig_dtype),
                            1.0,
                        ),
                        jnp.minimum(
                            ca.maxstep(spec, z.s, dz_c.s * inv_dtb,
                                       eig_dtype),
                            1.0,
                        ),
                    )
                fin = (
                    jnp.all(jnp.isfinite(ddz.y))
                    & jnp.all(jnp.isfinite(ddz.v))
                    & jnp.all(jnp.isfinite(ddz.s))
                    & jnp.isfinite(a_c)
                )
                accept = (
                    active & fin & (a_c >= alpha + 0.1 * (atil - alpha))
                )
                dz = jax.tree_util.tree_map(
                    lambda new, old: jnp.where(accept, new, old), dz_c, dz
                )
                alpha = jnp.where(accept, a_c, alpha)
                active = accept

            # products of the taken step — used to update the carried P
            # (mixed mode only; otherwise P is recomputed fresh each body)
            if mixed:
                Pd = products_fast(dz.y, dz.w, dz.v)
            else:
                zero = jnp.zeros_like
                Pd = _Products(zero(P.Qy), zero(P.GAy), zero(P.GAtwv))
            return (
                z - dz.scale(alpha),
                rnorm,
                rstep + jnp.asarray(1, jnp.int32),
                Pd,
                alpha,
            )

        if _gen_two_mode:
            # The generator calls happen INSIDE the branches, so only the
            # selected variant's factorization executes each iteration.
            def take_step(z):
                return jax.lax.cond(
                    lm_on,
                    lambda z: _take_step_with(
                        solve3x3gen(F, FinvT, mode="slow"), z,
                    ),
                    lambda z: _take_step_with(
                        solve3x3gen(F, FinvT, mode="fast"), z,
                        eig_dtype=jnp.float32 if _fast_eig else None,
                    ),
                    z,
                )
        else:
            def take_step(z):
                return _take_step_with(
                    solve3x3gen(F, FinvT), z,
                    eig_dtype=jnp.float32 if _force_fast_eig else None,
                )

        def no_step(z):
            zero = jnp.zeros_like
            return (
                z,
                jnp.asarray(0.0, dtype),
                jnp.asarray(0, jnp.int32),
                _Products(zero(P.Qy), zero(P.GAy), zero(P.GAtwv)),
                jnp.asarray(0.0, dtype),
            )

        z_new, rnorm, rstep, Pd, alpha = jax.lax.cond(
            status == Status.RUNNING, take_step, no_step, z
        )

        # Incremental product update + drift bound (mixed mode).
        P = _Products(
            P.Qy - alpha * Pd.Qy,
            P.GAy - alpha * Pd.GAy,
            P.GAtwv - alpha * Pd.GAtwv,
        )
        if mixed:
            drift = drift + 10.0 * eps32 * alpha * (
                (jnp.linalg.norm(Pd.Qy) + jnp.linalg.norm(Pd.GAtwv))
                / (1.0 + normc)
                + _normsafe(Pd.GAy) / (1.0 + normb)
            )

        sol = replace(sol, status=status)
        return (z_new, sol, optBest, k + 1, rnorm, rstep, P, drift, lm_on,
                stall)

    def cond(carry):
        _, sol, _, k, _, _, _, _, _, _ = carry
        return (sol.status == Status.RUNNING) & (k <= opts.maxIters)

    if opts.verbose:
        jax.debug.callback(_print_banner, ordered=True)

    # Initial carried products: fast estimates with an infinite drift so the
    # first near-tolerance decision always fires a certified recompute.
    P0 = products_fast(z0.y, z0.w, z0.v)
    carry0 = (
        z0,
        sol0,
        inf,
        jnp.asarray(1, jnp.int32),
        jnp.asarray(0.0, dtype),
        jnp.asarray(0, jnp.int32),
        P0,
        inf,
        jnp.asarray(False),
        jnp.asarray(0, jnp.int32),
    )
    _, sol, _, _, _, _, _, _, _, _ = jax.lax.while_loop(cond, body, carry0)

    # loop exhausted without a status → Abandoned (ConicIP.jl:936)
    sol = replace(
        sol,
        status=jnp.where(
            sol.status == Status.RUNNING, Status.ABANDONED, sol.status
        ).astype(jnp.int32),
    )
    return sol


# ──────────────────────────────────────────────────────────────
#  Verbose output (host callbacks)
# ──────────────────────────────────────────────────────────────


def _print_banner():
    print("\n > CONICIP INTERIOR POINT SOLVER v0.1\n")
    print(
        "            Optimality                      Objective              "
        "Infeasibility       "
    )
    print()
    print(
        "\x1b[1m   Iter   │  prFeas    duFeas    muFeas   │  pobj      dobj      "
        "│  icertp    icertd   │  refine \x1b[0m"
    )


def _print_row(k, rPr, rDu, rCp, pobj, dobj, p_inf, d_inf, rstep, rnorm):
    hot = float(rnorm) > 0.001
    pre = "\x1b[1m\x1b[31m" if hot else ""
    post = "\x1b[0m" if hot else ""
    print(
        f"{pre} {int(k):6d}  │  {float(rPr):<8.1e}  {float(rDu):<8.1e}  "
        f"{float(rCp):<8.1e} │  {float(pobj):< 8.1e}  {float(dobj):< 8.1e}  │  "
        f"{float(p_inf):<8.1e}  {float(d_inf):<8.1e} │  {int(rstep)}{post}"
    )
