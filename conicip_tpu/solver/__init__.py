"""User-facing solver API."""

from __future__ import annotations

import functools
from typing import Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..cones.spec import ConeSpec
from .ipm import IPMOptions, ipm_solve
from .state import Solution, SolState, Status, Vec4

__all__ = [
    "conic_ip", "Solution", "SolState", "Status", "IPMOptions", "Vec4",
    "ipm_solve", "resolve_factor_dtype",
]


def _densify(X, dtype):
    if X is None:
        return None
    if hasattr(X, "toarray"):  # scipy.sparse
        X = X.toarray()
    return jnp.asarray(np.asarray(X), dtype)


def resolve_factor_dtype(factor_dtype):
    """Resolve the ``"auto"`` factorization-precision default.

    ``"auto"`` is full precision (``None``: factor in the working dtype) on
    every backend — the reference's LAPACK semantics, on hardware with
    native f64 units. ``jnp.float32`` opts into the f32 factorization with
    mixed residuals and the escalation ladder; a concrete dtype pins one.
    """
    if isinstance(factor_dtype, str):
        if factor_dtype != "auto":
            raise ValueError(f"unknown factor_dtype {factor_dtype!r}")
        return None
    return factor_dtype


@functools.partial(jax.jit, static_argnames=("spec", "kktsolver", "opts"))
def _solve_jit(Q, c, A, b, G, d, *, spec, kktsolver, opts):
    return ipm_solve(Q, c, A, b, G, d, spec, kktsolver, opts)


@functools.partial(jax.jit, static_argnames=("spec", "kktsolver", "opts"))
def _solve_warm_jit(Q, c, A, b, G, d, warm, *, spec, kktsolver, opts):
    return ipm_solve(Q, c, A, b, G, d, spec, kktsolver, opts, warm=warm)


def _default_kktsolver(factor_dtype, assemble_dtype=None, lastmile=False):
    # default-normalizing wrapper so every spelling of the same config
    # hits one cache entry (lru_cache keys on raw call args)
    return _default_kktsolver_cached(factor_dtype, assemble_dtype, lastmile)


@functools.lru_cache(maxsize=None)
def _default_kktsolver_cached(factor_dtype, assemble_dtype, lastmile):
    from ..kkt import kktsolver_schur

    if factor_dtype is None and assemble_dtype is None and not lastmile:
        return kktsolver_schur
    return functools.partial(
        kktsolver_schur, factor_dtype=factor_dtype,
        assemble_dtype=assemble_dtype, lastmile=lastmile,
    )


def _diag_kktsolver(factor_dtype, eq_mode="woodbury"):
    # default-normalizing wrapper so _diag_kktsolver(fd) and
    # _diag_kktsolver(fd, "woodbury") hit the same cache entry
    return _diag_kktsolver_cached(factor_dtype, eq_mode)


@functools.lru_cache(maxsize=None)
def _diag_kktsolver_cached(factor_dtype, eq_mode):
    from ..kkt import kktsolver_diag

    if factor_dtype is None and eq_mode == "woodbury":
        return kktsolver_diag
    return functools.partial(
        kktsolver_diag, factor_dtype=factor_dtype, eq_mode=eq_mode
    )


def _auto_kktsolver(Q, A, G, spec, factor_dtype):
    """Default-backend choice with automatic structure exploitation: a
    separable problem (diagonal Q, bound-style A, R cones) collapses the
    per-iteration factorization to a diagonal Schur solve
    (:mod:`conicip_tpu.kkt.diag`) — 2-3x the dense path on the headline
    box-QP family. The reference's analogue is picking its sparse-LU
    backend by hand; here the default does it (detection is a one-time
    host-side pattern check). Everything else takes the dense Schur
    path. Equalities only qualify when an EXACT diagonal-Schur mode
    exists for them (:func:`conicip_tpu.kkt.diag.equality_mode`)."""
    from ..kkt.diag import equality_mode, separable

    if separable(Q, A, G, spec):
        mode = equality_mode(Q, G)
        return _diag_kktsolver(
            factor_dtype, "woodbury" if mode in (None, "none") else mode
        )
    # PSD-projection structure (A = I, Q = qI, p = 0, pure-S): closed-form
    # spectral Newton solve in the NT congruence's eigenbasis — no Schur
    # assembly or factorization at all (kkt/spectral.py).
    from ..kkt.spectral import spectral_applicable, spectral_kktsolver

    if spectral_applicable(Q, A, G, spec):
        return spectral_kktsolver(None)
    # single-solve f32 mode gets the in-loop last-mile f64 factorization
    # (kkt/schur.py): a real lax.cond on one instance, so only the final
    # one or two near-tolerance iterations pay it, instead of a ladder
    # re-dispatch. Batched solves keep it off —
    # under vmap the cond becomes a select and EVERY instance would pay
    # f64 assembly every iteration.
    return _default_kktsolver(
        factor_dtype, lastmile=factor_dtype == jnp.float32
    )


def conic_ip(
    Q,
    c,
    A,
    b,
    cone_dims: Sequence[Tuple[str, int]],
    G=None,
    d=None,
    *,
    kktsolver=None,
    optTol: float = 1e-6,
    DTB: float = 0.01,
    verbose: bool = False,
    maxRefinementSteps: int = 3,
    maxIters: int = 100,
    cache_nestodd: bool = False,
    infeasTol: Optional[float] = None,
    refinementThreshold: Optional[float] = None,
    factor_dtype="auto",
    dtype=None,
    mixedResiduals: Optional[bool] = None,
    eliminateEqualities: Optional[bool] = None,
    lastmileProactive: Optional[float] = None,
    centralityCorrectors: Optional[int] = None,
    warm_start=None,
) -> Solution:
    """Interior point solver for

    .. code-block:: text

        minimize    ½ yᵀQy − cᵀy        (note the MINUS sign on cᵀy)
        subject to  Ay ≥_K b,  K given by cone_dims, e.g. [("R",2),("Q",4)]
                    Gy = d

    Signature- and semantics-compatible with the reference ``conicIP``
    (ConicIP.jl:400-510). ``kktsolver`` is the 3-level plugin callback
    (see :mod:`conicip_tpu.kkt`); ``factor_dtype=jnp.float32`` runs the
    per-iteration factorizations in f32 with iterative refinement
    recovering f64 accuracy (plus mixed residuals and an escalation
    ladder). The default ``"auto"`` is full precision on every backend
    (:func:`resolve_factor_dtype`).

    ``centralityCorrectors`` (EXTENDS the reference, which runs plain
    Mehrotra) adds up to K Gondzio centrality correctors per iteration,
    each one back-solve against the iteration's existing factorization —
    a small fraction of the O(n³) refactorization an avoided iteration
    saves. Default ``None`` = auto: 1 on the dense
    factorization paths (measured: −1 iteration on half the benchmark
    families, 14 → 10 on the equality-constrained mix, never worse),
    0 on the diagonal backend and for user KKT callbacks.

    ``warm_start`` (EXTENDS the reference, which always cold-starts) seeds
    the solver from a previous ``Solution`` — or a ``(y, w, v)`` tuple —
    instead of the cold-start KKT solve. The iterate is shifted strictly
    inside the cone exactly like the cold start, so any point is safe;
    for a sequence of nearby problems (re-solves with drifting data) this
    typically cuts iterations by 2-4x. Non-finite warm data silently falls
    back to a cold start.
    """
    dtype = dtype or jnp.float64
    factor_dtype = resolve_factor_dtype(factor_dtype)
    if lastmileProactive is None:
        # Default ON for the f32 single-solve path: entering the
        # full-precision KKT branch at 50x tolerance replaces the 1-2
        # wasted fast iterations a reactive stall detection pays with the
        # same number of productive full-precision ones — measured to
        # restore exact f64 iteration counts (many_small_socs 11 -> 9,
        # mixed_rq_eq 15 -> 14) at similar slow-branch iteration counts.
        lastmileProactive = (
            50.0 if factor_dtype == jnp.float32 and kktsolver is None
            else 0.0
        )
    Q_in, A_in, G_in = Q, A, G  # host-side originals for the auto-backend check
    c = _densify(c, dtype)
    n = c.shape[0]
    Q = _densify(Q, dtype)
    A = _densify(A, dtype)
    b = _densify(b, dtype)
    G = _densify(G, dtype) if G is not None else jnp.zeros((0, n), dtype)
    d = _densify(d, dtype) if d is not None else jnp.zeros((0,), dtype)

    if eliminateEqualities is None:
        # The double-Schur equality path squares the f32 factorization's
        # conditioning and stalls near convergence; the null-space transform
        # (reduce.py) restores the robust p = 0 path. Full-precision
        # factorizations keep the reference's direct saddle semantics.
        eliminateEqualities = (
            factor_dtype == jnp.float32 and G.shape[0] > 0 and kktsolver is None
        )
    if eliminateEqualities and G.shape[0] > 0:
        return _solve_eliminated(
            Q, c, A, b, cone_dims, G, d,
            kktsolver=kktsolver, optTol=optTol, DTB=DTB, verbose=verbose,
            maxRefinementSteps=maxRefinementSteps, maxIters=maxIters,
            infeasTol=infeasTol, refinementThreshold=refinementThreshold,
            factor_dtype=factor_dtype, dtype=dtype,
            mixedResiduals=mixedResiduals,
            lastmileProactive=lastmileProactive,
            centralityCorrectors=centralityCorrectors,
            warm_start=warm_start,
        )

    spec = ConeSpec(cone_dims)
    user_kktsolver = kktsolver is not None
    auto_diag = False
    if kktsolver is None:
        kktsolver = _auto_kktsolver(Q_in, A_in, G_in, spec, factor_dtype)
        from ..kkt.diag import kktsolver_diag as _kd

        auto_diag = kktsolver is _kd or (
            getattr(kktsolver, "func", None) is _kd
        )
    if centralityCorrectors is None:
        # Auto: 1 Gondzio corrector on the dense factorization paths — a
        # corrector back-solve costs a tiny fraction of the O(n^3)
        # refactorization it can save (measured -1 iteration on 4 of the
        # 8 profile families and 14 -> 10 on mixed_rq_eq, never worse);
        # 0 on the diag backend, whose O(n) factorization makes a
        # corrector relatively expensive (measured to save nothing on the
        # separable families), and 0 for user callbacks (reference-count
        # compatibility for custom-KKT users).
        centralityCorrectors = 0 if (user_kktsolver or auto_diag) else 1
    if mixedResiduals is None:
        # With an f32 factorization and f64 iterates, run the residual
        # mat-vecs in f32 too and recertify in f64 near tolerances (see
        # solver/ipm.py docstring).
        mixedResiduals = factor_dtype == jnp.float32 and dtype == jnp.float64
    opts = IPMOptions(
        optTol=optTol,
        DTB=DTB,
        verbose=verbose,
        maxRefinementSteps=maxRefinementSteps,
        maxIters=maxIters,
        cache_nestodd=cache_nestodd,
        infeasTol=infeasTol,
        refinementThreshold=refinementThreshold,
        mixedResiduals=mixedResiduals,
        lastmileProactive=lastmileProactive,
        centralityCorrectors=centralityCorrectors,
    )
    warm = _user_warm_vec(warm_start, A, b, G.shape[0], dtype)
    if warm is not None:
        st = _solve_warm_jit(
            Q, c, A, b, G, d, warm, spec=spec, kktsolver=kktsolver, opts=opts
        )
    else:
        st = _solve_jit(
            Q, c, A, b, G, d, spec=spec, kktsolver=kktsolver, opts=opts
        )
    st = jax.block_until_ready(st)
    sol = Solution.from_state(st)

    # Robustness backstop ladder: an f32 factorization stalls once
    # kappa(M) ~ 1/mu exceeds ~1/eps_f32 (ConicIP.jl's f64 LAPACK never
    # hits this). When the fast mode ends without a definitive status,
    # escalate — warm-started from the best (strictly interior) iterate
    # each time:
    #   1. f64-assembled / f32-factored (rescues assembly-cancellation
    #      stalls, seen on SOC mixes),
    #   2. full f64 (the factorization itself ran out of precision).
    def _stalled(s: Solution) -> bool:
        # Near-solution stalls AND far-from-solution non-statuses both
        # escalate: infeasible/unbounded problems never drive residuals
        # small — their certificates are what the f32 mode fails to
        # sharpen — so gating on small residuals would leave them
        # mis-reported as Abandoned (observed on the Miles-2 dataset).
        return s.status in ("Abandoned", "Error")

    def _warm_from(s: Solution):
        yb, vb, wb = np.asarray(s.y), np.asarray(s.v), np.asarray(s.w)
        # one device GEMV + a vector transfer — never pull A to host
        sb = np.asarray(
            jnp.matmul(A, jnp.asarray(yb),
                       precision=jax.lax.Precision.HIGHEST) - b
        )
        if not (
            np.all(np.isfinite(yb))
            and np.all(np.isfinite(vb))
            and np.all(np.isfinite(sb))
            and np.all(np.isfinite(wb))
        ):
            return None
        return Vec4(
            jnp.asarray(yb), jnp.asarray(wb), jnp.asarray(vb),
            jnp.asarray(sb),
        )

    # Only the default backend escalates — a user-supplied kktsolver is
    # the user's choice (reference semantics: the plugin is used, period).
    if factor_dtype == jnp.float32 and not user_kktsolver and _stalled(sol):
        # S-cone specs skip the f64-assembled middle tier: measured futile
        # there — the f32 factorization is the floor, not the assembly
        # (see parallel/batch.py ladder note). Rarely reached for singles
        # anyway (the in-loop last-mile handles the common stall).
        ladder = ([(_default_kktsolver(jnp.float32, jnp.float64), True)]
                  if not spec.sdp_groups else []) + [
            (_default_kktsolver(None), False),
        ]
        for kkt_next, mixed_next in ladder:
            opts_next = IPMOptions(
                optTol=optTol, DTB=DTB, verbose=verbose,
                maxRefinementSteps=maxRefinementSteps, maxIters=maxIters,
                cache_nestodd=cache_nestodd, infeasTol=infeasTol,
                refinementThreshold=refinementThreshold,
                mixedResiduals=mixed_next,
                centralityCorrectors=centralityCorrectors,
            )
            warm = _warm_from(sol)
            if warm is not None:
                st = _solve_warm_jit(
                    Q, c, A, b, G, d, warm, spec=spec,
                    kktsolver=kkt_next, opts=opts_next,
                )
            else:
                st = _solve_jit(
                    Q, c, A, b, G, d, spec=spec,
                    kktsolver=kkt_next, opts=opts_next,
                )
            cand = Solution.from_state(jax.block_until_ready(st))
            # keep whichever is better if the tier also stalled
            if max(cand.prFeas, cand.duFeas, cand.muFeas) <= max(
                sol.prFeas, sol.duFeas, sol.muFeas
            ) or cand.status not in ("Abandoned", "Error"):
                sol = cand
            if not _stalled(sol):
                break

    if verbose:
        _exit_banner(sol.status)
    return sol


def _user_warm_vec(warm_start, A, b, p, dtype) -> Optional[Vec4]:
    """Build the internal warm-start iterate from a user ``warm_start``
    (a previous :class:`Solution`, anything with ``y``/``w``/``v``
    attributes, or a ``(y, w, v)`` tuple). Returns None — a cold start —
    when absent or non-finite (e.g. a prior Infeasible certificate whose
    ``y`` is NaN)."""
    if warm_start is None:
        return None
    if hasattr(warm_start, "y"):
        y, w, v = warm_start.y, warm_start.w, warm_start.v
    else:
        y, w, v = warm_start
    y = np.asarray(y, float)
    v = np.asarray(v, float)
    w = np.zeros(p) if w is None else np.asarray(w, float)
    if (
        w.shape != (p,)
        or y.shape != (A.shape[1],)
        or v.shape != (A.shape[0],)
    ):
        raise ValueError("warm_start dimensions do not match the problem")
    if not (
        np.all(np.isfinite(y))
        and np.all(np.isfinite(w))
        and np.all(np.isfinite(v))
    ):
        return None
    yj = jnp.asarray(y, dtype)
    # shifted strictly into the cone by ipm_solve
    s = jnp.matmul(A, yj, precision=jax.lax.Precision.HIGHEST) - b
    return Vec4(yj, jnp.asarray(w, dtype), jnp.asarray(v, dtype), s)


def _solve_eliminated(
    Q, c, A, b, cone_dims, G, d, *, kktsolver, optTol, DTB, verbose,
    maxRefinementSteps, maxIters, infeasTol, refinementThreshold,
    factor_dtype, dtype, mixedResiduals, lastmileProactive=0.0,
    centralityCorrectors=None, warm_start=None,
) -> Solution:
    """Solve with equalities removed by the null-space transform
    (:mod:`conicip_tpu.reduce`), then recover the full-space solution."""
    from ..reduce import eliminate_equalities

    Qh, ch = np.asarray(Q), np.asarray(c)
    Ah, bh = np.asarray(A), np.asarray(b)
    Gh, dh = np.asarray(G), np.asarray(d)
    red = eliminate_equalities(Qh, ch, Ah, bh, Gh, dh)
    p = Gh.shape[0]
    n = ch.shape[0]
    if red is not None and red.consistent and red.Z.shape[1] == 0:
        # G pins y completely — a 0-variable reduced problem would crash
        # the IPM; the direct saddle path handles the degenerate case
        return conic_ip(
            Q, c, A, b, cone_dims, G, d,
            kktsolver=kktsolver, optTol=optTol, DTB=DTB, verbose=verbose,
            maxRefinementSteps=maxRefinementSteps, maxIters=maxIters,
            infeasTol=infeasTol, refinementThreshold=refinementThreshold,
            factor_dtype=factor_dtype, dtype=dtype,
            mixedResiduals=mixedResiduals, eliminateEqualities=False,
            centralityCorrectors=centralityCorrectors,
            warm_start=warm_start,
        )
    if not red.consistent:
        # Inconsistent equalities (preprocessor.jl:61-64 semantics)
        return Solution(
            y=np.full(n, np.nan), w=np.full(p, np.nan),
            v=np.full(Ah.shape[0], np.nan), status="Infeasible", Iter=0,
            Mu=np.nan, prFeas=np.nan, duFeas=np.nan, muFeas=np.nan,
            pobj=np.nan, dobj=np.nan,
        )

    # A user warm start maps into the reduced space: y = y0 + Zx with Z
    # orthonormal ⇒ x = Zᵀ(y − y0); the cone dual v carries over unchanged
    # (same cones, A_red = A Z rows).
    sub_warm = None
    if warm_start is not None:
        ws = warm_start
        y_w = np.asarray(ws.y if hasattr(ws, "y") else ws[0], float)
        v_w = np.asarray(ws.v if hasattr(ws, "v") else ws[2], float)
        if (
            y_w.shape == (n,)
            and np.all(np.isfinite(y_w))
            and np.all(np.isfinite(v_w))
        ):
            sub_warm = (red.Z.T @ (y_w - red.y0), None, v_w)

    # The least-squares dual recovery can amplify the reduced-space dual
    # residual by a modest factor; when the recovered full-space rDu misses
    # optTol, one retry at a tighter reduced tolerance closes the gap.
    if centralityCorrectors is None:
        # Reduced (equality-origin) problems measure one further saved
        # iteration at K=2 with zero regressions across seeds (mixed_rq_eq
        # sweep: 81 -> 76 total iters over 8 seeds, never worse) — unlike
        # the general dense path, where K=2 traded larger_sdp 4 -> 5.
        centralityCorrectors = 2
    sub_tol = optTol
    for _attempt in range(2):
        sub = conic_ip(
            red.Q, red.c, red.A, red.b, cone_dims,
            kktsolver=kktsolver, optTol=sub_tol, DTB=DTB, verbose=verbose,
            maxRefinementSteps=maxRefinementSteps, maxIters=maxIters,
            infeasTol=infeasTol, refinementThreshold=refinementThreshold,
            factor_dtype=factor_dtype, dtype=dtype,
            mixedResiduals=mixedResiduals, eliminateEqualities=False,
            lastmileProactive=lastmileProactive,
            centralityCorrectors=centralityCorrectors, warm_start=sub_warm,
        )
        if sub.status != "Optimal":
            break
        y_try = red.recover_y(sub.y)
        w_try = red.recover_w(y_try, sub.v)
        rDu_try = np.linalg.norm(
            Qh @ y_try + Gh.T @ w_try - (Ah.T @ sub.v if Ah.size else 0.0) - ch
        ) / (1.0 + np.linalg.norm(ch))
        if rDu_try < optTol:
            break
        sub_tol = optTol * 0.02

    if sub.status in ("Abandoned", "Error"):
        # The null-space transform can make some problems numerically
        # harder (Z mixes structure away; observed on the Miles-3 dataset
        # with f32 factors) — fall back to the direct saddle path, whose own
        # precision ladder handles f32 equality stalls.
        return conic_ip(
            Q, c, A, b, cone_dims, G, d,
            kktsolver=kktsolver, optTol=optTol, DTB=DTB, verbose=verbose,
            maxRefinementSteps=maxRefinementSteps, maxIters=maxIters,
            infeasTol=infeasTol, refinementThreshold=refinementThreshold,
            factor_dtype=factor_dtype, dtype=dtype,
            mixedResiduals=mixedResiduals, eliminateEqualities=False,
            lastmileProactive=lastmileProactive,
            centralityCorrectors=centralityCorrectors, warm_start=warm_start,
        )

    v = sub.v
    if sub.status == "Unbounded":
        # Reduced ray x: y = Zx is a full-space ray (Gy = 0 by construction)
        y = red.Z @ sub.y
        w = np.full(p, np.nan)
        return Solution(y=y, w=w, v=sub.v, status=sub.status, Iter=sub.Iter,
                        Mu=sub.Mu, prFeas=sub.prFeas, duFeas=sub.duFeas,
                        muFeas=sub.muFeas, pobj=sub.pobj, dobj=sub.dobj)
    if sub.status == "Infeasible":
        # Farkas pair: extend v with least-squares w solving Gᵀw = Aᵀv.
        # The reduced normalization −b̃ᵀv equals the full −(dᵀw − bᵀv).
        w = red.recover_w_cert(v)
        return Solution(y=np.full(n, np.nan), w=w, v=v, status=sub.status,
                        Iter=sub.Iter, Mu=sub.Mu, prFeas=sub.prFeas,
                        duFeas=sub.duFeas, muFeas=sub.muFeas,
                        pobj=sub.pobj, dobj=sub.dobj)

    y = red.recover_y(sub.y)
    w = red.recover_w(y, v)
    # Full-space dual residual with the recovered w (one-time host f64)
    rDu = np.linalg.norm(Qh @ y + Gh.T @ w - (Ah.T @ v if Ah.size else 0.0) - ch)
    rDu /= 1.0 + np.linalg.norm(ch)
    cty = float(ch @ y)
    pobj = 0.5 * float(y @ (Qh @ y)) - cty
    return Solution(
        y=y, w=w, v=v, status=sub.status, Iter=sub.Iter, Mu=sub.Mu,
        prFeas=sub.prFeas, duFeas=float(rDu), muFeas=sub.muFeas,
        pobj=pobj, dobj=pobj - (sub.pobj - sub.dobj),
    )


def _exit_banner(status: str) -> None:
    msgs = {
        "Infeasible": "\n > EXIT -- Certificate of Infeasibility Found!\n",
        "Unbounded": "\n > EXIT -- Certificate of Dual Infeasibility Found!\n",
        "Optimal": "\n > EXIT -- Below Tolerance!\n",
        "Error": "\n > EXIT -- Error!\n",
        "Abandoned": "\n > EXIT -- Maximum iterations reached.\n",
    }
    print(msgs.get(status, ""))
