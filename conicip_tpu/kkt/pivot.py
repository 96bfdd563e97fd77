"""Adapter from 2x2 KKT solvers to the 3x3 interface.

Mirrors the reference's ``pivot``/``pivotgen`` (kktsolvers.jl:316-349) with
one deliberate fix: the reference applies ``F⁻ᵀF⁻ᵀ`` where the correct
operator is ``(FᵀF)⁻¹ = F⁻¹F⁻ᵀ`` — identical for the symmetric R/Q scalings
but wrong for SDP congruences (the documented cause of its pivot-solver
``PosDefException`` failure on mixed R+Q+S problems, benchmark/report.md:72).
We apply the correct ``F⁻¹F⁻ᵀ`` so the pivoted path works on all cones.

With ``factor_dtype`` set, the adapter's own matrix products (``Aᵀt₁`` and
``A·Δy``) run in that precision against a one-time-cast copy of A — the
IPM's refinement loop against full-precision residuals absorbs the error.

With ``lastmile`` additionally set, the adapter exposes the two-variant
``mode`` contract (kkt/schur.py): ``solve3x3gen(F, FinvT, mode="slow")``
returns a solver whose products and ``(FᵀF)⁻¹`` applies run in the working
dtype — ``t₁ = (FᵀF)⁻¹v`` is μ⁻¹-amplified near convergence, so an f32
``Aᵀt₁`` alone re-injects the noise the inner f64 factors just removed.
The IPM picks the variant with one ``lax.cond`` per iteration; both
variants are straight-line code with no control flow of their own.
"""

from __future__ import annotations

import inspect

import jax
import jax.numpy as jnp

from ..cones import scaling as sc
from ..cones.spec import ConeSpec

__all__ = ["pivot"]

_HI = jax.lax.Precision.HIGHEST


def pivot(kktsolver_2x2, factor_dtype=None, lastmile=False):
    """Wrap a 2x2 solver factory into a 3x3 one.

    The inner solver handles the Schur system::

        ┌                   ┐ ┌   ┐   ┌   ┐
        │ Q + Aᵀ(FᵀF)⁻¹A  Gᵀ │ │ a │ = │ y │
        │ G                 │ │ b │   │ w │
        └                   ┘ └   ┘   └   ┘
    """

    def kktsolver(Q, A, G, spec: ConeSpec):
        solve2x2gen = kktsolver_2x2(Q, A, G, spec)
        try:
            fwd_mode = "mode" in inspect.signature(solve2x2gen).parameters
        except (TypeError, ValueError):  # pragma: no cover
            fwd_mode = False
        wd = Q.dtype
        fd = wd if factor_dtype is None else factor_dtype
        Af = A.astype(fd)
        AfT = Af.T

        # (FᵀF)⁻¹ has κ ~ 1/μ near convergence. For pure-R specs it is
        # DIAGONAL: an f32 apply is eps32-accurate per component with no
        # cancellation, so the cheap cast path is exact enough (and the
        # extra f64 ops were measured to double the diag-backend
        # compile). SOC/SDP scalings MIX components — there
        # an f32 apply carries ~eps32/μ relative error that refinement
        # cannot contract once it exceeds 1 (the measured ~1e-5 stall
        # floor on R+Q+S mixes) — so those specs run w2inv in the working
        # dtype (elementwise / rank-1 / d×d congruences: cheap in f64);
        # only the big A GEMVs stay in factor dtype either way.
        amplified = bool(spec.soc_groups or spec.sdp_groups)
        lm = bool(lastmile) and fd != wd

        def _mk_solve3(solve2x2, Ax, AxT, Fi_x, td_x):
            pd = Ax.dtype  # product dtype of the big A GEMVs

            def w2inv(x):
                # (FᵀF)⁻¹ x = F⁻¹ (F⁻ᵀ x)
                return sc.apply_adjoint(spec, Fi_x, sc.apply(spec, Fi_x, x))

            def solve3x3(y, w, v):
                t1 = w2inv(v.astype(td_x))
                dy, dw = solve2x2(
                    y
                    + jnp.matmul(AxT, t1.astype(pd), precision=_HI).astype(wd),
                    w,
                )
                # Δv = (FᵀF)⁻¹ (v - A Δy)
                dv = t1 - w2inv(
                    jnp.matmul(Ax, dy.astype(pd), precision=_HI).astype(td_x)
                )
                return dy, dw, dv.astype(wd)

            return solve3x3

        def _inner(F, FinvT, mode):
            if fwd_mode:
                return solve2x2gen(F, FinvT, mode=mode)
            return solve2x2gen(F, FinvT)

        if not lm:

            def solve3x3gen(F, FinvT):
                Fi = FinvT if amplified else sc.cast(FinvT, fd)
                td = wd if amplified else fd
                return _mk_solve3(_inner(F, FinvT, "fast"), Af, AfT, Fi, td)

            return solve3x3gen

        def solve3x3gen_lm(F, FinvT, mode="fast"):
            if mode == "slow":
                return _mk_solve3(_inner(F, FinvT, "slow"), A, A.T, FinvT, wd)
            Fi = FinvT if amplified else sc.cast(FinvT, fd)
            td = wd if amplified else fd
            return _mk_solve3(_inner(F, FinvT, "fast"), Af, AfT, Fi, td)

        return solve3x3gen_lm

    return kktsolver
