"""Euclidean-Jordan-algebra kernels over a cone product, batched per group.

Vectorized rewrite of the reference's per-cone dispatch loops
(``∘``/``÷``/``maxstep``, ConicIP.jl:305-360 and 571-665): every cone *group*
(all R coordinates; all Q cones of one dim; all S cones of one order) is
processed by one vectorized kernel, so a product of hundreds of small cones
costs a handful of fused XLA ops instead of a Python/Julia loop.

All functions take 1-D ``(m,)`` vectors; batching over problem instances is
done with ``jax.vmap`` at a higher layer.

Semantics (matching the reference exactly):

- ``cone_prod(spec, x, y)``  = x ∘ y   (Jordan product)
- ``cone_div(spec, x, y)``   = o such that y ∘ o = x  (ConicIP.jl:607-620;
  note the reference's ``÷(x,y)`` divides x *by* y)
- ``maxstep(spec, x, d)``    = sup { α : x - α d ∈ K }  (ConicIP.jl:571-587)
- ``maxstep_to_cone(spec, x)`` = 0 if x strictly interior, else a negative
  shift magnitude, matching the reference's ``maxstep_*(x, nothing)``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .segment import put_group, put_r, take_group, take_r
from .spec import ConeSpec
from .symm import mat, vecm

# HIGHEST everywhere: the GPU's default f32 matmul precision is TF32
# (10 mantissa bits) — fatal for the congruences whose eigenvalues drive
# max-step and the Lyapunov division when these kernels run on f32 data
# (see cones/scaling.py); for f64 operands HIGHEST is exact, so it is
# always the right choice here.
_HI = jax.lax.Precision.HIGHEST


def _mm(a, b):
    return jnp.matmul(a, b, precision=_HI)

__all__ = [
    "cone_prod",
    "cone_div",
    "maxstep",
    "maxstep_multi",
    "sdp_eighs",
    "maxstep_to_cone",
    "lyap_solve",
    "centrality_correction",
]


def _dot(a, b):
    return jnp.sum(a * b, axis=-1)


# ──────────────────────────────────────────────────────────────
#  Jordan product x ∘ y
# ──────────────────────────────────────────────────────────────


def cone_prod(spec: ConeSpec, x: jnp.ndarray, y: jnp.ndarray) -> jnp.ndarray:
    if spec.only_r:
        return x * y
    o = jnp.zeros_like(x)
    if spec.nr:
        o = put_r(spec, o, take_r(spec, x) * take_r(spec, y))
    for g in spec.soc_groups:
        xg = take_group(g, x)  # (k, dim)
        yg = take_group(g, y)
        head = _dot(xg, yg)  # (k,)
        tail = xg[:, :1] * yg[:, 1:] + yg[:, :1] * xg[:, 1:]
        o = put_group(g, o, jnp.concatenate([head[:, None], tail], axis=1))
    for g in spec.sdp_groups:
        X = mat(take_group(g, x))  # (k, d, d)
        Y = mat(take_group(g, y))
        # symmetrized product (xsdc!, ConicIP.jl:355-360)
        P = _mm(X, Y) + _mm(Y, X)
        o = put_group(g, o, vecm(P))
    return o


# ──────────────────────────────────────────────────────────────
#  Jordan division: solve y ∘ o = x
# ──────────────────────────────────────────────────────────────


def _eigh_d(A: jnp.ndarray, eig_dtype):
    """Batched symmetric eigendecomposition honoring the ``eig_dtype``
    contract used throughout the cone layer:

    - ``None``  → stock ``eigh`` at the input dtype,
    - a dtype   → computed there, factors cast back (the opt-in f32 fast
                  phase).
    """
    if eig_dtype is not None and eig_dtype != A.dtype:
        w, U = jnp.linalg.eigh(A.astype(eig_dtype))
        return w.astype(A.dtype), U.astype(A.dtype)
    return jnp.linalg.eigh(A)


def _arith_dtype(wd, eig_dtype):
    """Dtype for the surrounding cone arithmetic: the working dtype unless
    an explicit lower eig_dtype asks the whole block to run there."""
    return wd if eig_dtype is None else eig_dtype


def sdp_eighs(spec: ConeSpec, x: jnp.ndarray, eig_dtype=None):
    """Per-S-group eigendecompositions of ``mat(x)`` — the shared
    once-per-iteration decomposition plan.

    One IPM iteration consumes eigh(mat(λ)) in up to ~7 places (every
    Lyapunov division against λ in solve4, and — via the congruence
    invariance ``maxstep(z.v, d) = maxstep(λ, F d)`` — every max-step
    call).  Computing it once here and threading the factors through
    :func:`cone_div`/:func:`maxstep_multi` removes ~10 decomposition calls
    per iteration.

    Returns a tuple over ``spec.sdp_groups`` of ``(w, U)`` at the
    ``eig_dtype`` discipline of :func:`_eigh_d` (factors in the group's
    arithmetic dtype).
    """
    out = []
    wd = x.dtype
    ed = _arith_dtype(wd, eig_dtype)
    for g in spec.sdp_groups:
        X = mat(take_group(g, x)).astype(ed)
        w, U = _eigh_d(X, eig_dtype)
        out.append((w.astype(wd), U.astype(wd)))
    return tuple(out)


def lyap_solve(Y: jnp.ndarray, X: jnp.ndarray, eig_dtype=None,
               y_eig=None) -> jnp.ndarray:
    """Solve ``Y O + O Y = X`` for symmetric Y, X, batched over leading dims.

    Replacement for the reference's LAPACK ``lyap`` call
    (dsdc!, ConicIP.jl:347-353): eigendecompose Y = U diag(w) Uᵀ, then
    O = U ( (Uᵀ X U)_{ij} / (w_i + w_j) ) Uᵀ — one batched eigh plus matmuls.

    ``eig_dtype`` runs the eigendecomposition in a lower precision, with
    the combination arithmetic kept in the working dtype. Used by the
    IPM's opt-in f32 fast-phase iterations (solver/ipm.py).
    ``y_eig`` supplies a precomputed ``(w, U)`` of Y (:func:`sdp_eighs`).
    """
    w, U = _eigh_d(Y, eig_dtype) if y_eig is None else y_eig
    if U is None:
        # Y is (numerically) diagonal with eigenvalues w in the standard
        # basis — the NT-scaled point case (scaling.SdpScaling.lam):
        # the Lyapunov solve is elementwise, no matmuls at all.
        denom = w[..., :, None] + w[..., None, :]
        return X / denom
    Ut = jnp.swapaxes(U, -1, -2)
    Xt = _mm(_mm(Ut, X), U)
    denom = w[..., :, None] + w[..., None, :]
    O = Xt / denom
    return _mm(_mm(U, O), Ut)


def cone_div(spec: ConeSpec, x: jnp.ndarray, y: jnp.ndarray,
             eig_dtype=None, y_eigs=None) -> jnp.ndarray:
    if spec.only_r:
        return x / y
    o = jnp.zeros_like(x)
    if spec.nr:
        o = put_r(spec, o, take_r(spec, x) / take_r(spec, y))
    for g in spec.soc_groups:
        # Arrow-matrix inverse applied to x, arrow built from y
        # (closed form, dsoc! ConicIP.jl:317-338).
        xg = take_group(g, x)
        yg = take_group(g, y)
        y1 = yg[:, :1]
        yb = yg[:, 1:]
        x1 = xg[:, :1]
        xb = xg[:, 1:]
        alpha = y1 * y1 - _dot(yb, yb)[:, None]  # (k, 1)
        ybxb = _dot(yb, xb)[:, None]
        head = (y1 * x1 - ybxb) / alpha
        beta1 = (-x1 / alpha) + ybxb / (y1 * alpha)
        beta2 = 1.0 / y1
        tail = yb * beta1 + xb * beta2
        o = put_group(g, o, jnp.concatenate([head, tail], axis=1))
    for gi, g in enumerate(spec.sdp_groups):
        X = mat(take_group(g, x))
        Y = mat(take_group(g, y))
        y_eig = None if y_eigs is None else y_eigs[gi]
        o = put_group(g, o, vecm(lyap_solve(Y, X, eig_dtype, y_eig=y_eig)))
    return o


# ──────────────────────────────────────────────────────────────
#  Max step to boundary: sup { α : x - α d ∈ K }
# ──────────────────────────────────────────────────────────────


def _qf(x):
    """SOC quadratic form x₁² - ‖x₂:‖² (reference ``QF``, ConicIP.jl:160)."""
    return 2.0 * x[..., 0] * x[..., 0] - _dot(x, x)


def maxstep(spec: ConeSpec, x: jnp.ndarray, d: jnp.ndarray,
            eig_dtype=None) -> jnp.ndarray:
    """``eig_dtype`` runs the S-cone eigendecompositions in a lower
    precision (latency argument: see :func:`lyap_solve`); the ~1e-7
    relative step-length error sits far inside the IPM's 1% DTB margin."""
    wd = x.dtype
    inf = jnp.asarray(jnp.inf, wd)
    steps = [inf]
    if spec.nr:
        xr, dr = take_r(spec, x), take_r(spec, d)
        steps.append(jnp.min(jnp.where(dr > 0, xr / dr, inf)))
    for g in spec.soc_groups:
        xg = take_group(g, x)
        dn = -take_group(g, d)
        gam = _qf(xg)  # (k,)
        sg = jnp.sqrt(gam)
        xbar = xg / sg[:, None]
        beta = 2.0 * xbar[:, 0] * dn[:, 0] - _dot(xbar, dn)
        rho1 = beta / sg
        mu = (beta + dn[:, 0]) / (xbar[:, 0] + 1.0)
        rho2 = dn[:, 1:] - mu[:, None] * xbar[:, 1:]
        a = jnp.linalg.norm(rho2, axis=-1) / sg - rho1
        steps.append(jnp.min(jnp.where(a < 0, inf, 1.0 / a)))
    ed = _arith_dtype(wd, eig_dtype)
    for g in spec.sdp_groups:
        X = mat(take_group(g, x)).astype(ed)
        D = mat(take_group(g, d)).astype(ed)
        wX, U = _eigh_d(X, eig_dtype)
        pd = jnp.all(wX > 0, axis=-1)  # (k,)
        w_safe = jnp.maximum(wX, jnp.finfo(ed).tiny)
        Xih = _mm(U * jax.lax.rsqrt(w_safe)[..., None, :],
                  jnp.swapaxes(U, -1, -2))
        M = _mm(_mm(Xih, D), Xih)
        M = 0.5 * (M + jnp.swapaxes(M, -1, -2))
        lam = _eigh_d(M, eig_dtype)[0].astype(wd)
        inf_e = jnp.asarray(jnp.inf, wd)
        all_neg = jnp.all(lam < 0, axis=-1)
        mx = jnp.max(jnp.where(lam < 0, -inf_e, lam), axis=-1)
        a = jnp.where(all_neg, inf_e, 1.0 / mx)
        a = jnp.where(pd, a, inf_e)  # X not PD ⇒ Inf (ConicIP.jl:277-280)
        steps.append(jnp.min(a))
    return jnp.min(jnp.stack(steps))


def maxstep_multi(spec: ConeSpec, x: jnp.ndarray, ds, eig_dtype=None,
                  x_eigs=None):
    """Max-step of ``x`` against SEVERAL directions ``ds`` at once.

    The IPM needs two max-steps per call site (against the v- and s-side
    directions); computed independently each costs one batched tiny eigh
    of ``M = X^{-1/2} D X^{-1/2}``.  Here the
    S-cone ``M`` matrices of ALL directions are stacked into ONE batched
    eigh per group, and ``x_eigs`` (:func:`sdp_eighs`) supplies the
    decomposition of ``mat(x)`` so it is never recomputed.  R/SOC parts
    are closed-form and evaluated per direction.

    Returns a tuple of per-direction step lengths (same semantics as
    :func:`maxstep`).
    """
    wd = x.dtype
    inf = jnp.asarray(jnp.inf, wd)
    nd = len(ds)
    steps = [[inf] for _ in range(nd)]
    if spec.nr:
        xr = take_r(spec, x)
        for i, d in enumerate(ds):
            dr = take_r(spec, d)
            steps[i].append(jnp.min(jnp.where(dr > 0, xr / dr, inf)))
    for g in spec.soc_groups:
        xg = take_group(g, x)
        gam = _qf(xg)  # (k,)
        sg = jnp.sqrt(gam)
        xbar = xg / sg[:, None]
        for i, d in enumerate(ds):
            dn = -take_group(g, d)
            beta = 2.0 * xbar[:, 0] * dn[:, 0] - _dot(xbar, dn)
            rho1 = beta / sg
            mu = (beta + dn[:, 0]) / (xbar[:, 0] + 1.0)
            rho2 = dn[:, 1:] - mu[:, None] * xbar[:, 1:]
            a = jnp.linalg.norm(rho2, axis=-1) / sg - rho1
            steps[i].append(jnp.min(jnp.where(a < 0, inf, 1.0 / a)))
    ed = _arith_dtype(wd, eig_dtype)
    for gi, g in enumerate(spec.sdp_groups):
        diag_x = False
        if x_eigs is None:
            X = mat(take_group(g, x)).astype(ed)
            wX, U = _eigh_d(X, eig_dtype)
        else:
            wX, U = x_eigs[gi]
            wX = wX.astype(ed)
            diag_x = U is None  # NT-scaled-point case: mat(x) ≈ diag(wX)
            if not diag_x:
                U = U.astype(ed)
        pd = jnp.all(wX > 0, axis=-1)  # (k,)
        w_safe = jnp.maximum(wX, jnp.finfo(ed).tiny)
        rs = jax.lax.rsqrt(w_safe)
        if not diag_x:
            Xih = _mm(U * rs[..., None, :], jnp.swapaxes(U, -1, -2))
        Ms = []
        for d in ds:
            D = mat(take_group(g, d)).astype(ed)
            if diag_x:
                M = D * rs[..., :, None] * rs[..., None, :]
            else:
                M = _mm(_mm(Xih, D), Xih)
            Ms.append(0.5 * (M + jnp.swapaxes(M, -1, -2)))
        # ONE batched eigh over (nd*k, d, d) instead of nd separate calls.
        # Step lengths only need λmax to ~1e-3 relative (the 1% DTB
        # fraction-to-boundary margin dominates), and f32 eigh computes
        # the LARGEST eigenvalue to ~1e-6 relative — so the step eigh
        # always runs in f32: the digits an f64 eigh adds are ones the
        # step cannot use.
        Mc = jnp.concatenate(Ms, axis=0)
        if Mc.dtype == jnp.float64:
            lam_all = jnp.linalg.eigvalsh(Mc.astype(jnp.float32))
        else:
            lam_all = _eigh_d(Mc, eig_dtype)[0]
        lam_all = lam_all.astype(wd)
        inf_e = jnp.asarray(jnp.inf, wd)
        k = g.count
        for i in range(nd):
            lam = lam_all[i * k:(i + 1) * k]
            all_neg = jnp.all(lam < 0, axis=-1)
            mx = jnp.max(jnp.where(lam < 0, -inf_e, lam), axis=-1)
            a = jnp.where(all_neg, inf_e, 1.0 / mx)
            a = jnp.where(pd, a, inf_e)
            steps[i].append(jnp.min(a))
    return tuple(jnp.min(jnp.stack(s)) for s in steps)


def centrality_correction(spec: ConeSpec, w: jnp.ndarray, lo, hi,
                          eig_dtype=None) -> jnp.ndarray:
    """Gondzio centrality-corrector term ``q = Π_{[lo,hi]}(w) − w`` applied
    to the *spectral values* of the trial complementarity product ``w``,
    with the standard floor clamp ``q ≥ −hi`` (Gondzio 1996, §4: outlier
    products are pushed toward the target box, never yanked by more than
    the upper bound).

    The reference has no corrector (ConicIP.jl runs plain Mehrotra); this
    EXTENDS it. The corrector reuses the iteration's factorization, so it
    trades one extra back-solve for a possibly saved O(n³)
    refactorization.

    Componentwise on R; closed-form two-eigenvalue Jordan frame on Q;
    batched ``eigh`` on S (``eig_dtype`` as in :func:`maxstep`).
    """

    def _clip(lmb):
        return jnp.maximum(jnp.clip(lmb, lo, hi) - lmb, -hi)

    if spec.only_r:
        return _clip(w)
    q = jnp.zeros_like(w)
    if spec.nr:
        q = put_r(spec, q, _clip(take_r(spec, w)))
    for g in spec.soc_groups:
        wg = take_group(g, w)  # (k, dim)
        w0 = wg[:, 0]
        nrm = jnp.linalg.norm(wg[:, 1:], axis=-1)
        dplus = _clip(w0 + nrm)  # (k,)
        dminus = _clip(w0 - nrm)
        # q = δ₊c₊ + δ₋c₋,  c± = ½(1, ±w̄/‖w̄‖);  ŵ := w̄/‖w̄‖ (0 if w̄ = 0,
        # in which case the two frames coincide and the tail cancels)
        what = wg[:, 1:] / jnp.maximum(nrm, jnp.finfo(w.dtype).tiny)[:, None]
        head = 0.5 * (dplus + dminus)
        tail = 0.5 * (dplus - dminus)[:, None] * what
        q = put_group(g, q, jnp.concatenate([head[:, None], tail], axis=1))
    ed = _arith_dtype(w.dtype, eig_dtype)
    for g in spec.sdp_groups:
        W = mat(take_group(g, w)).astype(ed)
        lmb, U = _eigh_d(W, eig_dtype)
        lmb, U = lmb.astype(w.dtype), U.astype(w.dtype)
        delta = _clip(lmb)  # (k, d)
        Qm = _mm(U * delta[..., None, :], jnp.swapaxes(U, -1, -2))
        q = put_group(g, q, vecm(Qm))
    return q


def maxstep_to_cone(spec: ConeSpec, x: jnp.ndarray) -> jnp.ndarray:
    """The reference's ``maxstep_*(x, nothing)`` variants (ConicIP.jl:227-303):
    0 if x is strictly in the cone, otherwise ``-1 - sup{α : -x + αe ≥ 0}``-style
    negative shift used to push the initial point inside."""
    zero = jnp.asarray(0.0, x.dtype)
    steps = [zero]
    if spec.nr:
        xr = take_r(spec, x)
        mn = jnp.min(xr)
        steps.append(jnp.where(mn > 0, 0.0, -1.0 + mn))
    for g in spec.soc_groups:
        xg = take_group(g, x)
        a = jnp.linalg.norm(xg[:, 1:], axis=-1) - xg[:, 0]
        steps.append(jnp.min(jnp.where(a < 0, 0.0, -1.0 - a)))
    for g in spec.sdp_groups:
        X = mat(take_group(g, x))
        mn = jnp.min(jnp.linalg.eigvalsh(X), axis=-1)
        steps.append(jnp.min(jnp.where(mn > 0, 0.0, -1.0 + mn)))
    return jnp.min(jnp.stack(steps))
