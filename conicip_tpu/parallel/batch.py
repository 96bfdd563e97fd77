"""Batched problem solving — data parallelism over problem instances.

The reference solves one problem per call (ConicIP.jl:468); batching is the
first free parallelism axis here (SURVEY.md §2.3): the IPM core is
mask-based and therefore ``vmap``-safe — converged instances freeze their
iterates while the loop keeps stepping the rest — so a stack of problems is
one ``vmap`` + one jit, and sharding the batch axis over a device mesh makes
it multi-chip/multi-host data parallelism with zero cross-instance
communication.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..cones.spec import ConeSpec
from ..solver.ipm import IPMOptions, ipm_solve
from ..solver.state import STATUS_NAMES, SolState, to_host

__all__ = [
    "solve_batch",
    "BatchSolution",
    "make_batched_solver",
    "make_batched_warm_solver",
]


@dataclass
class BatchSolution:
    """Stacked solutions with numpy storage."""

    y: np.ndarray
    w: np.ndarray
    v: np.ndarray
    status: np.ndarray  # int codes
    Iter: np.ndarray
    Mu: np.ndarray
    prFeas: np.ndarray
    duFeas: np.ndarray
    muFeas: np.ndarray
    pobj: np.ndarray
    dobj: np.ndarray

    @property
    def statuses(self) -> List[str]:
        return [STATUS_NAMES[int(s)] for s in self.status]

    @classmethod
    def from_state(cls, st: SolState) -> "BatchSolution":
        return cls(**{k: to_host(getattr(st, k)) for k in cls.__dataclass_fields__
                      if k != "statuses"})


@functools.lru_cache(maxsize=None)
def make_batched_solver(spec: ConeSpec, kktsolver, opts: IPMOptions,
                        batch_G: bool = True):
    """jitted vmapped solver for a fixed (spec, kktsolver, opts)."""
    g_axis = 0 if batch_G else None

    def core(Q, c, A, b, G, d):
        return ipm_solve(Q, c, A, b, G, d, spec, kktsolver, opts)

    return jax.jit(jax.vmap(core, in_axes=(0, 0, 0, 0, g_axis, g_axis)))


@functools.lru_cache(maxsize=None)
def make_batched_warm_solver(spec: ConeSpec, kktsolver, opts: IPMOptions,
                             batch_G: bool = True):
    """jitted vmapped warm-started solver (warm iterate batched on axis 0)."""
    g_axis = 0 if batch_G else None

    def core(Q, c, A, b, G, d, warm):
        return ipm_solve(Q, c, A, b, G, d, spec, kktsolver, opts, warm=warm)

    return jax.jit(
        jax.vmap(core, in_axes=(0, 0, 0, 0, g_axis, g_axis, 0))
    )


@functools.lru_cache(maxsize=None)
def make_batched_ladder_solver(spec: ConeSpec, kktsolver, tiers,
                               opts: IPMOptions, with_warm: bool = False):
    """jitted vmapped solver with the escalation ladder FUSED into the
    program: after the fast tier, each ``(kktsolver, IPMOptions)`` in
    ``tiers`` runs under a batch-level ``lax.cond`` — executed only when
    some instance ended Abandoned/Error, warm-started from the stalled
    instances' best iterates, with per-instance acceptance (same policy as
    the host ladder). One device dispatch replaces the 2-3 the host
    ladder pays."""
    from ..solver.state import Status, Vec4

    _hi = jax.lax.Precision.HIGHEST

    def _vsolve(kkt, o, Q, c, A, b, G, d, warm=None):
        if warm is None:
            return jax.vmap(
                lambda Q, c, A, b, G, d: ipm_solve(Q, c, A, b, G, d, spec,
                                                   kkt, o)
            )(Q, c, A, b, G, d)
        return jax.vmap(
            lambda Q, c, A, b, G, d, w: ipm_solve(Q, c, A, b, G, d, spec,
                                                  kkt, o, warm=w)
        )(Q, c, A, b, G, d, warm)

    def _maxres(st):
        return jnp.maximum(st.prFeas, jnp.maximum(st.duFeas, st.muFeas))

    def run(Q, c, A, b, G, d, warm=None):
        st = _vsolve(kktsolver, opts, Q, c, A, b, G, d, warm)
        for kkt_t, opts_t in tiers:
            stalled = (st.status == Status.ABANDONED) | (
                st.status == Status.ERROR)

            def rescue(st=st, kkt_t=kkt_t, opts_t=opts_t, stalled=stalled):
                ok = (
                    jnp.all(jnp.isfinite(st.y), axis=1)
                    & jnp.all(jnp.isfinite(st.w), axis=1)
                    & jnp.all(jnp.isfinite(st.v), axis=1)
                )[:, None]
                y = jnp.where(ok, st.y, 0.0)
                w = jnp.where(ok, st.w, 0.0)
                v = jnp.where(ok, st.v, 1.0)
                s = jnp.einsum("bij,bj->bi", A, y, precision=_hi) - b
                st2 = _vsolve(kkt_t, opts_t, Q, c, A, b, G, d,
                              Vec4(y, w, v, s))
                definitive = (st2.status != Status.ABANDONED) & (
                    st2.status != Status.ERROR)
                accept = stalled & (definitive | (_maxres(st2) <= _maxres(st)))

                def merge(a, b_):
                    m = accept.reshape(accept.shape + (1,) * (a.ndim - 1))
                    return jnp.where(m, a, b_)

                return jax.tree_util.tree_map(merge, st2, st)

            st = jax.lax.cond(jnp.any(stalled), rescue, lambda st=st: st)
        return st

    if with_warm:
        return jax.jit(run)
    return jax.jit(lambda Q, c, A, b, G, d: run(Q, c, A, b, G, d))


def solve_batch(
    Q,
    c,
    A,
    b,
    cone_dims: Sequence[Tuple[str, int]],
    G=None,
    d=None,
    *,
    mesh: Optional[Mesh] = None,
    batch_axis: str = "batch",
    kktsolver=None,
    factor_dtype="auto",
    dtype=None,
    warm_start=None,
    backstop: bool = True,
    eliminate_equalities: Optional[bool] = None,
    **options,
) -> BatchSolution:
    """Solve a stack of independent conic QPs (leading batch axis on
    Q, c, A, b and optionally G, d).

    With ``mesh``, the batch axis is sharded over ``mesh[batch_axis]`` —
    per-problem work stays local to one device; XLA inserts no collectives.

    ``warm_start`` seeds every instance from a previous
    :class:`BatchSolution` (or a ``(y, w, v)`` tuple of stacked arrays) —
    the production pattern for periodic re-solves of drifting problem
    batches. Instances with non-finite warm data are scrubbed to a neutral
    start (the iterate is shifted strictly into the cone either way).

    ``backstop=False`` disables the per-instance full-precision re-solve
    of stalled f32 instances (used by the checkpoint loop, where an
    intermediate chunk's "Abandoned" just means "budget not yet spent").

    ``centralityCorrectors`` (via ``**options``) defaults to 1 Gondzio
    corrector on the auto dense-Schur path for R/Q specs (batched QP and
    reduced-equality families measure 1-4 saved iterations) and 0
    otherwise — SDP-spec batches run the corrector's eighs at full
    precision for zero measured savings, and the diag backend's O(n)
    factorization makes a corrector relatively expensive.
    """
    dtype = dtype or jnp.float64
    from ..solver import resolve_factor_dtype

    factor_dtype = resolve_factor_dtype(factor_dtype)
    Q_in, A_in = Q, A  # host-side originals for the pattern check below
    Q = jnp.asarray(Q, dtype)
    c = jnp.asarray(c, dtype)
    A = jnp.asarray(A, dtype)
    b = jnp.asarray(b, dtype)
    batch = c.shape[0]
    n = c.shape[-1]

    # Shared-G null-space elimination (same rationale as conic_ip's
    # default: the double-Schur equality path squares the f32
    # factorization's conditioning; eliminating once turns the whole batch
    # into the robust p = 0 path). One host QR of G amortizes over every
    # instance; per-instance d is fine (y0 is linear in d).
    # EXCEPTION (r5): when the DIRECT form has diag+low-rank Schur
    # structure (bound R rows + small SOC/equality blocks —
    # kkt/lowrank.py), elimination would DESTROY it (A·Z is dense);
    # the direct ladder with the lowrank f64 finisher is both exact on
    # equalities and ~10x cheaper per iteration than the dense f64
    # factorization of the reduced problem.
    g_is_shared = G is not None and np.ndim(G) == 2
    use_lowrank = False
    if kktsolver is None and factor_dtype == jnp.float32 and backstop:
        from ..kkt.lowrank import lowrank_applicable

        use_lowrank = lowrank_applicable(
            Q_in, A_in, G, ConeSpec(tuple(cone_dims)))
    if eliminate_equalities is None:
        eliminate_equalities = (
            factor_dtype == jnp.float32 and g_is_shared
            and np.shape(G)[0] > 0 and kktsolver is None
            and not use_lowrank
        )
    if eliminate_equalities and np.shape(G)[0] > 0:
        if not g_is_shared:
            raise ValueError(
                "eliminate_equalities=True requires a shared 2-D G "
                "(per-instance equality systems would need one QR each — "
                "solve those via the precision ladder instead)"
            )
        return _solve_batch_eliminated(
            Q, c, A, b, cone_dims, G, d, mesh=mesh, batch_axis=batch_axis,
            factor_dtype=factor_dtype, dtype=dtype, warm_start=warm_start,
            backstop=backstop, options=options,
        )

    if G is None:
        G = jnp.zeros((batch, 0, n), dtype)
        d = jnp.zeros((batch, 0), dtype)
    else:
        G = jnp.asarray(G, dtype)
        d = jnp.asarray(d, dtype)
        if G.ndim == 2:  # shared equality system (d batched or shared)
            G = jnp.broadcast_to(G, (batch,) + G.shape)
            if d.ndim == 1:
                d = jnp.broadcast_to(d, (batch,) + d.shape)

    spec = ConeSpec(cone_dims)
    auto_schur = False
    auto_kkt = kktsolver is None
    if kktsolver is None:
        # auto structure exploitation (same policy as conic_ip), but the
        # separability pattern must hold for EVERY instance in the batch.
        # The check runs on the caller's original (usually host) arrays —
        # checking the device copies would pull Q and A back to the host.
        from ..kkt.diag import equality_mode, separable_batch
        from ..solver import _default_kktsolver, _diag_kktsolver

        if separable_batch(Q_in, A_in, G, spec):
            mode = equality_mode(Q_in, G)
            kktsolver = _diag_kktsolver(
                factor_dtype, "woodbury" if mode in (None, "none") else mode
            )
        else:
            kktsolver = _default_kktsolver(factor_dtype)
            auto_schur = True
    if "centralityCorrectors" not in options:
        # Batched auto policy (same measurement base as conic_ip's): one
        # Gondzio corrector on the dense-Schur path for R/Q specs — the
        # batched QP-dense and reduced-equality families each save 1-4
        # iterations — but OFF when the spec has SDP groups: batched
        # solves run without the two-variant fast/slow KKT generator, so
        # the corrector's per-round eigh (clip + two max-steps) would run
        # in full precision every iteration while the batched SDP
        # families measure zero iteration savings.
        options = {
            **options,
            "centralityCorrectors": (
                1 if auto_schur and not spec.sdp_groups else 0
            ),
        }
    if "mixedResiduals" not in options:
        # same production policy as conic_ip: f32 factors + f64 iterates
        # run the per-iteration residual mat-vecs in f32 with certified
        # f64 re-evaluation near tolerance decisions
        options = {
            **options,
            "mixedResiduals": factor_dtype == jnp.float32
            and dtype == jnp.float64,
        }
    if ("twoModeKKT" not in options and factor_dtype == jnp.float32
            and backstop):
        # Under vmap the two-variant generator's lax.cond is a select:
        # the dead slow-mode factorization executes for EVERY instance
        # EVERY iteration (~2x the batched per-iteration cost). Pin the
        # fast variant; the fused rescue tiers below own escalation.
        # Without a backstop (checkpoint loops) keep the in-loop
        # escalation — correctness beats the 2x there.
        options = {**options, "twoModeKKT": False}
    opts = IPMOptions(**options)
    if opts.verbose:
        raise ValueError("verbose output is not supported in batched mode")

    warm = None
    if warm_start is not None:
        from ..solver.state import Vec4

        ws = warm_start
        wy = np.asarray(ws.y if hasattr(ws, "y") else ws[0], float)
        wv = np.asarray(ws.v if hasattr(ws, "v") else ws[2], float)
        ww = ws.w if hasattr(ws, "w") else ws[1]
        p = G.shape[1]
        ww = np.zeros((batch, p)) if ww is None else np.asarray(ww, float)
        if wy.shape != (batch, n) or wv.shape != A.shape[:2] or ww.shape != (batch, p):
            raise ValueError("warm_start dimensions do not match the batch")
        ok = (
            np.all(np.isfinite(wy), axis=1)
            & np.all(np.isfinite(ww), axis=1)
            & np.all(np.isfinite(wv), axis=1)
        )[:, None]
        wy = jnp.asarray(np.where(ok, wy, 0.0), dtype)
        ww = jnp.asarray(np.where(ok, ww, 0.0), dtype)
        wv = jnp.asarray(np.where(ok, wv, 1.0), dtype)
        ws_slack = jnp.einsum("bij,bj->bi", A, wy,
                              precision=jax.lax.Precision.HIGHEST) - b
        warm = Vec4(wy, ww, wv, ws_slack)

    # Fused in-jit escalation ladder (same tiers/policy as the host loop
    # below): one device dispatch covers fast tier + rescues; the rescue
    # while_loops sit behind a batch-level lax.cond and cost nothing when
    # every instance finishes in the fast tier. The host loop remains as
    # a safety net for instances all fused tiers leave stalled.
    fused_tiers = ()
    if factor_dtype == jnp.float32 and backstop:
        from ..solver import _default_kktsolver

        if not spec.sdp_groups:
            if use_lowrank:
                # direct diag+low-rank path: f32 dense warm-up tier is
                # the main solve; ONE exact-f64 lowrank finisher (the
                # middle f64-assembly tier was measured useless on this
                # structure — every stalled instance needs the full-f64
                # factor, which lowrank makes ~10x cheaper)
                from ..kkt.lowrank import lowrank_kktsolver

                fused_tiers = (
                    (lowrank_kktsolver(),
                     IPMOptions(**{**options, "mixedResiduals": False,
                                   "fastEig": False,
                                   "stallCutoff": options.get(
                                       "stallCutoff", 6)})),
                )
            else:
                fused_tiers = (
                    (_default_kktsolver(jnp.float32, jnp.float64),
                     IPMOptions(**{**options, "mixedResiduals": True,
                                   "fastEig": False})),
                    # full-precision final tier: no exhaustion detectors
                    # run without mixedResiduals, so a near-tolerance
                    # plateau would hold the vmapped loop open to
                    # maxIters — the stallCutoff ends it with the best
                    # iterate (host backstop owns the remainder)
                    (_default_kktsolver(None),
                     IPMOptions(**{**options, "mixedResiduals": False,
                                   "fastEig": False,
                                   "stallCutoff": options.get(
                                       "stallCutoff", 6)})),
                )
        else:
            # S-cone batched policy: the f32 tiers are a false economy
            # here. The f32-decomposition fast tier NaNs out for most
            # instances by iteration ~6 (the f32 eigh of the NT
            # congruence collapses once kappa ~ 1/mu passes ~1e7), and
            # every broken instance then re-pays a full rescue tier while
            # its vmapped stragglers hold the loop open to maxIters. So
            # the batched SDP path runs full-precision decompositions as
            # its single tier: the main solve below is switched to the
            # full-precision solver and no fused rescue is stacked on
            # top (the host backstop remains as the safety net).
            fused_tiers = ()
        if spec.sdp_groups and not fused_tiers and auto_kkt:
            # Structure exploitation first: the PSD-projection pattern
            # (A = I, Q = qI, p = 0) solves the whole Newton system in
            # closed form in the NT congruence's eigenbasis — one batched
            # d×d eigh per iteration instead of the (B, t, t) f64 Schur
            # factorization. Same role as kkt/diag.py
            # on separable R problems. A cond-gated dense-f64 rescue tier
            # backstops the rare instance whose certification exceeds the
            # spectral path's eigh accuracy (κ(P) = κ(S)² near
            # convergence); stallCutoff=4 ends near-tolerance plateaus as
            # Abandoned instead of letting one stuck instance hold the
            # vmapped loop open to maxIters.
            from ..kkt.spectral import spectral_applicable, spectral_kktsolver

            sdp_cfg = {**options, "mixedResiduals": False,
                       "fastEig": False,
                       "stallCutoff": options.get("stallCutoff", 4),
                       # 3 refinement passes (the default) measurably beat
                       # 1 here: with 1, a few instances per few hundred
                       # plateau just above 1e-6 and the rescue tiers fire
                       # — at batch scale the dense rescue costs far more
                       # than the two extra polish passes (measured B=256:
                       # ref3 certifies 256/256 primary-only)
                       "maxRefinementSteps": options.get(
                           "maxRefinementSteps", 3)}
            if spectral_applicable(Q_in, A_in, G, spec):
                kktsolver = spectral_kktsolver(None)
                # rescue order matters at batch scale: a stalled instance
                # first gets the SAME spectral solver with full polish
                # (3 refinement passes, patient stall cutoff) — warm, a
                # few cheap trips — and only then the dense f64 KKT tier,
                # whose (B, t, t) factorization at large B costs seconds
                # when it fires (measured: firing it at B=256 halved
                # throughput).
                polish_cfg = {**sdp_cfg, "maxRefinementSteps": 3,
                              "stallCutoff": 8}
                fused_tiers = (
                    (kktsolver, IPMOptions(**polish_cfg)),
                    (_default_kktsolver(None), IPMOptions(**polish_cfg)),
                )
            else:
                kktsolver = _default_kktsolver(None)
            opts = IPMOptions(**sdp_cfg)

    if fused_tiers:
        solver = make_batched_ladder_solver(
            spec, kktsolver, fused_tiers, opts, with_warm=warm is not None
        )
    else:
        solver = (
            make_batched_warm_solver(spec, kktsolver, opts)
            if warm is not None
            else make_batched_solver(spec, kktsolver, opts)
        )

    if mesh is not None:
        shard = NamedSharding(mesh, P(batch_axis))
        put = lambda x: jax.device_put(x, shard)  # noqa: E731
        Q, c, A, b, G, d = map(put, (Q, c, A, b, G, d))
        if warm is not None:
            warm = Vec4(*(jax.device_put(x, shard) for x in
                          (warm.y, warm.w, warm.v, warm.s)))

    if warm is not None:
        st = jax.block_until_ready(solver(Q, c, A, b, G, d, warm))
    else:
        st = jax.block_until_ready(solver(Q, c, A, b, G, d))
    out = BatchSolution.from_state(st)

    # Batched robustness backstop (same ladder as conic_ip): instances whose
    # f32 tier ended without a definitive status are re-solved AS A BATCH —
    # first f64-assembled/f32-factored (rescues assembly-cancellation stalls
    # at ~1/50 the full-f64 cost), then full f64 — warm-started from their
    # best iterates. Every Abandoned/Error instance escalates regardless of
    # its residual: infeasible/unbounded instances end with LARGE residuals
    # and only the full-precision tiers can sharpen their certificates
    # (the Miles-2 hazard; see conic_ip._stalled).
    if factor_dtype == jnp.float32 and backstop:
        from ..solver import Status, _default_kktsolver
        from ..solver.state import Vec4

        stalled = np.nonzero(
            np.isin(out.status, (Status.ABANDONED, Status.ERROR))
        )[0]
        # The f64-assembled/f32-factored middle tier rescues
        # assembly-cancellation stalls (measured on SOC mixes) but CANNOT
        # move an S-cone stall — there the f32 factorization itself is the
        # floor (measured: warm-started f64-assembly passes exit after one
        # non-improving iteration on stalled small-SDP batches). Skip the
        # futile dispatch and escalate S-cone specs straight to full f64.
        ladder = ([(_default_kktsolver(jnp.float32, jnp.float64), True)]
                  if not spec.sdp_groups else []) + [
            (_default_kktsolver(None), False),
        ]
        if stalled.size:
            # np.asarray of device arrays is read-only — make fields writable
            for field in BatchSolution.__dataclass_fields__:
                setattr(out, field, np.array(getattr(out, field)))
        for kkt_next, mixed_next in ladder:
            if not stalled.size:
                break
            idx = jnp.asarray(stalled)
            Qs, cs, As, bs, Gs, ds = (X[idx] for X in (Q, c, A, b, G, d))
            yb = np.array(out.y[stalled])
            wb = np.array(out.w[stalled])
            vb = np.array(out.v[stalled])
            ok = (
                np.all(np.isfinite(yb), axis=1)
                & np.all(np.isfinite(wb), axis=1)
                & np.all(np.isfinite(vb), axis=1)
            )[:, None]
            # non-finite best iterates restart from a neutral point (the
            # solver shifts it strictly into the cone either way)
            yj = jnp.asarray(np.where(ok, yb, 0.0), dtype)
            wj = jnp.asarray(np.where(ok, wb, 0.0), dtype)
            vj = jnp.asarray(np.where(ok, vb, 1.0), dtype)
            sj = jnp.einsum("bij,bj->bi", As, yj,
                            precision=jax.lax.Precision.HIGHEST) - bs
            # full-precision decompositions: the host ladder is the last
            # safety net (the fused in-jit tiers already tried fastEig)
            opts_next = IPMOptions(**{**options, "mixedResiduals": mixed_next})
            solver_next = make_batched_warm_solver(spec, kkt_next, opts_next)
            sti = jax.block_until_ready(
                solver_next(Qs, cs, As, bs, Gs, ds, Vec4(yj, wj, vj, sj))
            )
            cand = BatchSolution.from_state(sti)
            cand_res = np.maximum(cand.prFeas,
                                  np.maximum(cand.duFeas, cand.muFeas))
            out_res = np.maximum(out.prFeas, np.maximum(out.duFeas,
                                                        out.muFeas))[stalled]
            # accept a tier's answer if it reached a definitive status or
            # at least improved the residual (same policy as conic_ip)
            accept = (
                ~np.isin(cand.status, (Status.ABANDONED, Status.ERROR))
                | (cand_res <= out_res)
            )
            take = stalled[accept]
            sub = np.nonzero(accept)[0]
            for field in BatchSolution.__dataclass_fields__:
                getattr(out, field)[take] = np.asarray(
                    getattr(cand, field))[sub]
            # out.status now holds accepted tiers' statuses; rejected
            # instances keep their old (still stalled) status
            stalled = stalled[
                np.isin(out.status[stalled],
                        (Status.ABANDONED, Status.ERROR))
            ]
    return out


def _solve_batch_eliminated(
    Q, c, A, b, cone_dims, G, d, *, mesh, batch_axis, factor_dtype, dtype,
    warm_start, backstop, options,
) -> BatchSolution:
    """Batched null-space elimination of a SHARED equality system.

    Mirrors the single-problem ``_solve_eliminated``
    (solver/__init__.py) with the QR of G done ONCE on the host
    (:func:`conicip_tpu.reduce.equality_basis`) and every per-instance
    transform a batched matmul: the whole batch becomes the robust p = 0
    path and the double-Schur conditioning squaring never happens —
    so batched equality workloads no longer serialize through the
    per-instance full-f64 backstop.
    """
    from ..reduce import equality_basis
    from ..solver.state import Status

    _hi = jax.lax.Precision.HIGHEST
    optTol = options.get("optTol", 1e-6)
    batch = c.shape[0]
    n = c.shape[-1]

    Gh = np.asarray(G, np.float64)
    basis = equality_basis(Gh)
    if basis.rank >= n:
        # G determines y completely — nothing to reduce; the direct
        # saddle path handles the (degenerate) fully-pinned case
        return solve_batch(
            Q, c, A, b, cone_dims, G, d, mesh=mesh, batch_axis=batch_axis,
            factor_dtype=factor_dtype, dtype=dtype, warm_start=warm_start,
            backstop=backstop, eliminate_equalities=False, **options,
        )
    p = basis.p
    dh = np.asarray(d, np.float64)
    if dh.ndim == 1:
        dh = np.broadcast_to(dh, (batch, p))
    y0 = basis.particular(dh)  # (batch, n)
    # Per-instance consistency of G y0 = d (rank-deficient rows checked
    # exactly as preprocess_conicIP, preprocessor.jl:61-64)
    bad = np.linalg.norm(y0 @ Gh.T - dh, axis=-1) > 1e-8 * (
        1.0 + np.linalg.norm(dh, axis=-1)
    )

    # Reduced batch (device-side batched matmuls; Z is orthonormal)
    Z = jnp.asarray(basis.Z, dtype)  # (n, n - r)
    y0j = jnp.asarray(y0, dtype)
    Qy0 = jnp.einsum("bij,bj->bi", Q, y0j, precision=_hi)
    QZ = jnp.einsum("bij,jk->bik", Q, Z, precision=_hi)
    Q_red = jnp.einsum("ji,bjk->bik", Z, QZ, precision=_hi)
    c_red = jnp.einsum("ji,bj->bi", Z, c - Qy0, precision=_hi)
    A_red = jnp.einsum("bij,jk->bik", A, Z, precision=_hi)
    b_red = b - jnp.einsum("bij,bj->bi", A, y0j, precision=_hi)

    # A user warm start maps into the reduced space: x = Zᵀ(y − y0)
    sub_warm = None
    if warm_start is not None:
        ws = warm_start
        y_w = np.asarray(ws.y if hasattr(ws, "y") else ws[0], float)
        v_w = np.asarray(ws.v if hasattr(ws, "v") else ws[2], float)
        if y_w.shape == (batch, n) and v_w.shape[0] == batch:
            x_w = (y_w - y0) @ np.asarray(basis.Z)
            sub_warm = (x_w, None, v_w)

    if ("centralityCorrectors" not in options
            and not ConeSpec(tuple(cone_dims)).sdp_groups):
        # reduced (equality-origin) R/Q batches measure a further saved
        # iteration at K=2 with zero regressions (same sweep evidence as
        # conic_ip._solve_eliminated)
        options = {**options, "centralityCorrectors": 2}

    sub = solve_batch(
        Q_red, c_red, A_red, b_red, cone_dims, mesh=mesh,
        batch_axis=batch_axis, factor_dtype=factor_dtype, dtype=dtype,
        warm_start=sub_warm, backstop=backstop,
        eliminate_equalities=False, **options,
    )

    # ── full-space recovery (host f64, one pass over the batch) ──
    Qh = np.asarray(Q, np.float64)
    ch = np.asarray(c, np.float64)
    Ah = np.asarray(A, np.float64)
    Zh = np.asarray(basis.Z)
    x = np.asarray(sub.y, np.float64)
    v = np.asarray(sub.v, np.float64)

    y = y0 + x @ Zh.T
    # least-squares equality duals from Qy + Gᵀw − Aᵀv = c (batched)
    Av = np.einsum("bij,bi->bj", Ah, v)
    rhs = ch - np.einsum("bij,bj->bi", Qh, y) + Av
    w = basis.solve_gt(rhs)
    # recovered full-space dual residual replaces the reduced one
    rDu = np.linalg.norm(
        np.einsum("bij,bj->bi", Qh, y) + w @ Gh - Av - ch, axis=-1
    ) / (1.0 + np.linalg.norm(ch, axis=-1))
    Qy = np.einsum("bij,bj->bi", Qh, y)
    pobj = 0.5 * np.einsum("bi,bi->b", y, Qy) - np.einsum("bi,bi->b", ch, y)

    out = BatchSolution(**{  # writable host copies
        f: np.array(getattr(sub, f))
        for f in BatchSolution.__dataclass_fields__
    })
    opt = out.status == Status.OPTIMAL
    # y0 + Zx is the full-space iterate for EVERY status (for Abandoned
    # instances it is the best recovered iterate, used to seed fallbacks)
    out.y = y.copy()
    out.w = np.asarray(w)
    out.duFeas = np.where(opt, rDu, out.duFeas)
    out.dobj = np.where(opt, pobj - (out.pobj - out.dobj), out.dobj)
    out.pobj = np.where(opt, pobj, out.pobj)

    unb = out.status == Status.UNBOUNDED
    if unb.any():
        # reduced ray x → full-space ray Zx (G(Zx) = 0 by construction)
        out.y = np.where(unb[:, None], x @ Zh.T, out.y)
        out.w = np.where(unb[:, None], np.nan, out.w)
    infeas = out.status == Status.INFEASIBLE
    if infeas.any():
        # Farkas pair: extend v with least-squares w solving Gᵀw = Aᵀv
        out.w = np.where(infeas[:, None], basis.solve_gt(Av), out.w)
        out.y = np.where(infeas[:, None], np.nan, out.y)

    # Optimal-in-reduced-space instances whose RECOVERED dual residual
    # misses tolerance get one batched retry at a tighter reduced
    # tolerance (same policy as _solve_eliminated), warm-started.
    retry = np.nonzero(opt & (rDu >= optTol))[0]
    if retry.size:
        idx = jnp.asarray(retry)
        tight = {**options, "optTol": optTol * 0.02}
        sub2 = solve_batch(
            Q_red[idx], c_red[idx], A_red[idx], b_red[idx], cone_dims,
            factor_dtype=factor_dtype, dtype=dtype,
            warm_start=(x[retry], None, v[retry]), backstop=backstop,
            eliminate_equalities=False, **tight,
        )
        ok2 = sub2.status == Status.OPTIMAL
        x2 = np.asarray(sub2.y, np.float64)
        v2 = np.asarray(sub2.v, np.float64)
        y2 = y0[retry] + x2 @ Zh.T
        Av2 = np.einsum("bij,bi->bj", Ah[retry], v2)
        w2 = basis.solve_gt(
            ch[retry] - np.einsum("bij,bj->bi", Qh[retry], y2) + Av2
        )
        Qy2 = np.einsum("bij,bj->bi", Qh[retry], y2)
        rDu2 = np.linalg.norm(Qy2 + w2 @ Gh - Av2 - ch[retry], axis=-1) / (
            1.0 + np.linalg.norm(ch[retry], axis=-1)
        )
        pobj2 = 0.5 * np.einsum("bi,bi->b", y2, Qy2) - np.einsum(
            "bi,bi->b", ch[retry], y2
        )
        take = retry[ok2 & (rDu2 < rDu[retry])]
        sel = np.nonzero(ok2 & (rDu2 < rDu[retry]))[0]
        out.y[take] = y2[sel]
        out.w[take] = w2[sel]
        out.v[take] = v2[sel]
        out.duFeas[take] = rDu2[sel]
        out.prFeas[take] = sub2.prFeas[sel]
        out.muFeas[take] = sub2.muFeas[sel]
        out.dobj[take] = pobj2[sel] - (sub2.pobj[sel] - sub2.dobj[sel])
        out.pobj[take] = pobj2[sel]
        out.Iter[take] += sub2.Iter[sel]

    # Instances the reduced path (including ITS ladder) could not finish
    # fall back to the direct saddle path as one sub-batch — the
    # null-space transform can make some problems numerically harder
    # (Miles-3; see _solve_eliminated).
    stalled = np.nonzero(
        np.isin(out.status, (Status.ABANDONED, Status.ERROR)) & ~bad
    )[0]
    if stalled.size:
        idx = jnp.asarray(stalled)
        direct = solve_batch(
            Q[idx], c[idx], A[idx], b[idx], cone_dims,
            jnp.broadcast_to(jnp.asarray(Gh, dtype), (stalled.size, p, n)),
            jnp.asarray(dh[stalled], dtype),
            factor_dtype=factor_dtype, dtype=dtype, backstop=backstop,
            eliminate_equalities=False, **options,
        )
        for field in BatchSolution.__dataclass_fields__:
            getattr(out, field)[stalled] = np.asarray(getattr(direct, field))

    if bad.any():
        # inconsistent equalities: Infeasible with NaN primal/duals
        out.status[bad] = Status.INFEASIBLE
        out.y[bad] = np.nan
        out.w[bad] = np.nan
        out.v[bad] = np.nan
        for f in ("Mu", "prFeas", "duFeas", "muFeas", "pobj", "dobj"):
            getattr(out, f)[bad] = np.nan
        out.Iter[bad] = 0
    return out
