"""Intra-problem (tensor) parallelism: sharded Schur assembly + distributed
factorization.

For one large problem, the per-iteration Schur matrix

    M = Q + Atilᵀ Atil,     Atil = F⁻ᵀ A

is a sum over constraint-row blocks — the natural sharding axis
(SURVEY.md §2.3; semantics anchor: the Schur form the reference factors,
kktsolvers.jl:275-310). The design here shards BOTH O(·³) stages:

1. **Assembly** (O(mn²)): rows of ``Atil`` are partitioned over the mesh
   axis, each device computes its partial Gram ``Atil_kᵀ Atil_k``, and
   one ``psum_scatter`` reduces the partials *directly into block rows of
   M* — the full (n, n) Schur matrix is never materialized on any
   single device.
2. **Factorization** (O(n³)): a 1-D block-row panel Cholesky. Each of the
   ``ntp`` devices owns one block row of M; per panel, the current block
   column is ``all_gather``-ed (n·r numbers), the r×r diagonal block is
   factored replicated, and each device applies the trailing update to its
   own rows — O(n³/ntp) FLOPs per device, O(n²) total communication.
3. **Back-solves**: instead of distributed triangular solves (latency-bound
   chains), the factorization phase also computes the explicit inverse
   ``W = L⁻¹`` *column-sharded* by forward block substitution (same
   O(n³/ntp) scaling). Every per-RHS solve is then two sharded GEMVs:
   ``M̃⁻¹x = D·Wᵀ(W(D·x))`` — one ``psum`` and one ``all_gather`` of an
   n-vector each. This mirrors the replicated production path's
   explicit-L⁻¹ design (kkt/schur.py), which replaces sequential
   triangular solves with GEMVs.

Cone generality — and cone-block scaling parallelism (SURVEY.md §2.3):
the NT scaling application ``Atil = F⁻ᵀA`` is itself **sharded over the
cone blocks** (default ``shard_scaling=True``): the rows of A are grouped
per cone batch at setup (R rows; each SOC/SDP group's ``(k, d, n)``
tensor), each group's cone axis is sharded over the mesh, and every
device applies the structure-exploiting batched kernels
(cones/scaling.py semantics) to *its own cones only* — O(m·n·d / ntp)
per device, with the full (m, n) scaled matrix never materialized
anywhere. The Gram reduction is row-order-agnostic (Σ AtilᵀAtil over any
partition of the rows), so arbitrary R/Q/S mixes shard cleanly; groups
are zero-padded to mesh multiples (zero rows contribute nothing). The
(cheap, O(m·d²)) scaling *construction* from (z, s) stays replicated.
Rows (m) and columns (n) are zero/identity-padded to mesh multiples, so
no divisibility constraints apply either.

Equalities are handled exactly as in kkt/schur.py (augmented
``M̃ = M + γGᵀG``, second Schur complement on G): the p×p system is
replicated (p is small by the time intra-problem sharding pays), with the
two (n, p) couplings ``Y = W(DGᵀ)`` and ``Z = M̃⁻¹Gᵀ`` computed through the
sharded W.

Per-iteration communication: one psum_scatter of an (n, n) Gram, ntp
all_gathers of (n, r) panels, ntp psum-broadcasts of (r, n) L rows, and a
few n-vector collectives per RHS — all riding ICI, O(n²) total, light
relative to the O(mn²/ntp + n³/ntp) per-device FLOPs.

Stated limitation (scope: a few devices, not a pod): the panel loop is
Python-unrolled with ONE panel per device, so compile size grows linearly
in ntp and the block size r = n/ntp shrinks with it — the design is
intended for ntp ≤ ~8 (this environment's mesh sizes). A pod-scale
factorization wants a 2-D block-cyclic layout with multiple panels per
device (SURVEY.md §2.3); the 3-level solver contract here would host such
a kernel unchanged.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.scipy.linalg import solve_triangular
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from ..cones import scaling as sc
from ..cones.spec import ConeSpec
from ..cones.symm import mat as _mat, vecm as _vecm
from ..kkt.pivot import pivot

_HI = jax.lax.Precision.HIGHEST
_I0 = jnp.int32(0)  # axis_index/fori indices are int32; mixing with Python
# ints would trip dynamic_slice's same-dtype requirement under x64

__all__ = ["kktsolver_schur_tp", "distributed_normal_matrix"]


def _ceil_to(x: int, k: int) -> int:
    return -(-x // k) * k


def _psum_gather(x_loc, axis, me, r, n_total):
    """All-gather a per-device block into a REPLICATED result via psum of a
    zero-embedded block. Semantically identical to
    ``all_gather(tiled=True)`` but, unlike all_gather, psum's output is
    statically known-replicated to the VMA tracker — keeping
    ``check_vma=True`` on. Extra cost vs
    all-gather is ~2x the bytes of a small (n,) or (n, p) operand — noise
    next to the O(n³/ntp) compute these kernels do."""
    buf = jnp.zeros((n_total,) + x_loc.shape[1:], x_loc.dtype)
    buf = jax.lax.dynamic_update_slice(
        buf, x_loc, (me * r,) + (_I0,) * (x_loc.ndim - 1)
    )
    return jax.lax.psum(buf, axis)


def distributed_normal_matrix(Q, A, dinv, mesh: Mesh, axis: str):
    """Compute ``Q + (diag(dinv) A)ᵀ (diag(dinv) A)`` with rows of A sharded
    over ``mesh[axis]`` and a single psum reduction. (Kept as the simple
    R-cone building block / teaching kernel; the production TP path below
    generalizes it.)"""

    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(None, None), P(axis, None), P(axis)),
        out_specs=P(None, None),
    )
    def _assemble(Qr, A_blk, dinv_blk):
        Atil = A_blk * dinv_blk[:, None]
        # out_specs is replicated, so Q (already replicated) is added once
        # on every device to the identical psum result.
        return Qr + jax.lax.psum(jnp.matmul(Atil.T, Atil, precision=_HI), axis)

    return _assemble(Q, A, dinv)


# ──────────────────────────────────────────────────────────────────────
#  Distributed factorization kernel
# ──────────────────────────────────────────────────────────────────────


def _factor_body(M_blk, G_full, gamma, ridge, me, rowid, axis, ntp, r,
                 n_pad, p, dtype):
    """Shared factorization body: assembled block-row M (my r rows) →
    Jacobi equilibration → unrolled panel Cholesky → column-sharded
    explicit W = L⁻¹ → equality coupling Y. Used by both the
    replicated-Atil and the cone-sharded-Atil factor kernels."""
    # -- Jacobi equilibration (global dscale from the sharded diag;
    # psum-gathered so the result is tracker-visibly replicated) --
    d_loc = M_blk[jnp.arange(r), rowid]
    dscale = jax.lax.rsqrt(
        jnp.maximum(
            _psum_gather(d_loc, axis, me, r, n_pad),
            jnp.finfo(dtype).tiny,
        )
    )  # (n_pad,) replicated
    ds_loc = dscale[rowid]
    M_blk = M_blk * ds_loc[:, None] * dscale[None, :]
    M_blk = M_blk.at[jnp.arange(r), rowid].add(ridge)

    # -- Phase 1: right-looking panel Cholesky, L block-row sharded.
    # The panel loop is PYTHON-UNROLLED (ntp is static): panel j's
    # tri-solve and trailing update then operate on STATIC slices of
    # the trailing submatrix only, cutting total phase FLOPs from
    # n_pad³ (full-width updates under fori_loop, whose dynamic
    # trip index forces every panel to full size) to ~n_pad³/2 while
    # keeping the per-device balance (every device updates its r
    # rows; width shrinks uniformly with j).
    A_loc = M_blk
    L_loc = jnp.zeros_like(M_blk)
    for j in range(ntp):
        c0 = j * r
        pan_loc = A_loc[:, c0:c0 + r]  # (r, r)
        C = jax.lax.all_gather(pan_loc, axis, tiled=True)  # (n_pad, r)
        Ct = C[c0:]  # trailing rows only, (n_pad - c0, r)
        Ld = jnp.linalg.cholesky(Ct[:r])
        # trailing panel rows: Ct @ Ld⁻ᵀ; block row j reproduces Ld
        # (up to roundoff) — overwritten exactly below.
        Lp = solve_triangular(Ld, Ct.T, lower=True).T
        # my rows within the trailing range sit at trailing-local
        # offset (me - j)·r; devices above the panel (me < j) slice
        # clamped garbage that the mask zeroes.
        off = jnp.maximum(me - j, 0) * r
        Lp_loc = jax.lax.dynamic_slice(Lp, (off, _I0), (r, r))
        Lp_loc = jnp.where(me == j, jnp.tril(Ld), Lp_loc)
        Lp_loc = jnp.where(me >= j, Lp_loc, 0.0)
        # trailing update of my rows, trailing columns only (static
        # width; columns < c0 become garbage in A_loc and are never
        # read again — L lives in L_loc)
        A_loc = A_loc.at[:, c0:].add(
            -jnp.matmul(Lp_loc, Lp.T, precision=_HI)
        )
        L_loc = L_loc.at[:, c0:c0 + r].set(Lp_loc)

    # -- Phase 2: W = L⁻¹ column-sharded, by forward block rows.
    # Unrolled for the same reason: step i's substitution product
    # reads only the i·r already-computed rows of W (static slice),
    # halving the phase's FLOPs vs the masked full-height matmul a
    # fori_loop needs.
    W_loc = jnp.zeros((n_pad, r), dtype)
    for i in range(ntp):
        # psum-broadcast of L block row i (only device i contributes)
        Lrow = jax.lax.psum(
            jnp.where(me == i, L_loc, 0.0), axis
        )  # (r, n_pad)
        if i:
            S = jnp.matmul(
                Lrow[:, : i * r], W_loc[: i * r], precision=_HI
            )  # (r, r)
        else:
            S = jnp.zeros((r, r), dtype)
        Ldi = Lrow[:, i * r:(i + 1) * r]
        E = (
            (i * r + jnp.arange(r))[:, None] == rowid[None, :]
        ).astype(dtype)
        Wi = solve_triangular(Ldi, E - S, lower=True)
        W_loc = W_loc.at[i * r:(i + 1) * r, :].set(Wi)

    # -- equality coupling Y = W (D Gᵀ), replicated (p is small) --
    if p:
        X_loc = ds_loc[:, None] * jax.lax.dynamic_slice(
            G_full.T, (me * r, _I0), (r, p)
        )  # my rows of D Gᵀ
        Y = jax.lax.psum(jnp.matmul(W_loc, X_loc, precision=_HI), axis)
    else:
        Y = jnp.zeros((n_pad, 0), dtype)

    ok = jax.lax.psum(
        jnp.all(jnp.isfinite(W_loc)).astype(jnp.int32), axis
    ) == ntp
    return W_loc, dscale, Y, ok


def _make_factor_kernel(mesh: Mesh, axis: str, n_pad: int, p: int, dtype):
    """Build the one-shard_map factorization: sharded Gram reduction →
    block-row M → panel Cholesky → column-sharded explicit inverse.

    Returns ``factor(Atil_pad, Q_pad, G_pad, gamma, ridge) ->
    (W, dscale, Y, ok)`` where

    - ``W`` (n_pad, n_pad), column-sharded ``P(None, axis)``: L⁻¹ of the
      equilibrated augmented Schur matrix,
    - ``dscale`` (n_pad,) replicated: Jacobi equilibration scale,
    - ``Y`` (n_pad, p) replicated: ``W (D Gᵀ)`` (zero-width when p == 0),
    - ``ok`` scalar bool: factorization finite on every device.
    """
    ntp = mesh.shape[axis]
    r = n_pad // ntp

    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(axis, None), P(axis, None), P(None, None), P(), P()),
        out_specs=(P(None, axis), P(None), P(None, None), P()),
    )
    def factor(Atil_blk, Q_blk, G_full, gamma, ridge):
        me = jax.lax.axis_index(axis)
        rowid = me * r + jnp.arange(r)

        # -- sharded Gram, reduced straight into my block rows of M --
        part = jnp.matmul(Atil_blk.T, Atil_blk, precision=_HI)  # (n, n)
        M_blk = jax.lax.psum_scatter(
            part, axis, scatter_dimension=0, tiled=True
        )  # (r, n) = my rows of Σ_k partials
        M_blk = M_blk + Q_blk
        if p:
            Grows = jax.lax.dynamic_slice(
                G_full.T, (me * r, _I0), (r, p)
            )  # my rows of Gᵀ
            M_blk = M_blk + gamma * jnp.matmul(Grows, G_full, precision=_HI)

        return _factor_body(M_blk, G_full, gamma, ridge, me, rowid, axis,
                            ntp, r, n_pad, p, dtype)

    return factor


def _make_apply(mesh: Mesh, axis: str, n_pad: int):
    """``apply(W, dscale, x) = D Wᵀ W D x`` with W column-sharded — the
    distributed M̃⁻¹ application (two sharded GEMVs, one psum, one
    all_gather)."""
    ntp = mesh.shape[axis]
    r = n_pad // ntp

    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(None, axis), P(None), P(None)),
        out_specs=P(None),
    )
    def apply(W_loc, dscale, x):
        me = jax.lax.axis_index(axis)
        v = dscale * x
        v_loc = jax.lax.dynamic_slice(v, (me * r,), (r,))
        y = jax.lax.psum(
            jnp.matmul(W_loc, v_loc, precision=_HI), axis
        )  # W (D x), (n_pad,)
        u_loc = jnp.matmul(W_loc.T, y, precision=_HI)  # my rows of Wᵀ y
        u = _psum_gather(u_loc, axis, me, r, n_pad)
        return dscale * u

    return apply


def _make_matapply_T(mesh: Mesh, axis: str, n_pad: int, p: int):
    """``matapply(W, Y) = Wᵀ Y`` for the (n_pad, p) equality coupling —
    each device holds rows ``W_dᵀ Y``; all_gather assembles the result."""
    ntp = mesh.shape[axis]
    r = n_pad // ntp

    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(None, axis), P(None, None)),
        out_specs=P(None, None),
    )
    def matapply(W_loc, Y):
        me = jax.lax.axis_index(axis)
        u_loc = jnp.matmul(W_loc.T, Y, precision=_HI)  # (r, p)
        return _psum_gather(u_loc, axis, me, r, n_pad)  # (n_pad, p)

    return matapply


# ──────────────────────────────────────────────────────────────────────
#  Cone-block-sharded scaling application (SURVEY.md §2.3)
# ──────────────────────────────────────────────────────────────────────


def _pad_axis0(x, k_pad, fill=0.0):
    """Zero/constant-pad axis 0 of ``x`` to length ``k_pad``."""
    if x.shape[0] == k_pad:
        return x
    buf = jnp.full((k_pad,) + x.shape[1:], fill, x.dtype)
    return buf.at[: x.shape[0]].set(x)


def _shard_cone_rows(spec: ConeSpec, A, n, n_pad, ntp, fd, axis):
    """One-time setup: A's rows regrouped per cone batch, each group's
    cone axis padded to an ``ntp`` multiple (zero rows — they contribute
    nothing to the Gram). Returns the ``arows`` pytree consumed by
    :func:`_make_factor_kernel_sharded` and its matching in_specs.
    Empty parts are empty tuples so the spec pytrees always match."""
    Af = A.astype(fd)

    def cols_pad(x):  # (..., n) -> (..., n_pad)
        if n == n_pad:
            return x
        buf = jnp.zeros(x.shape[:-1] + (n_pad,), fd)
        return buf.at[..., :n].set(x)

    r_part = (
        (cols_pad(_pad_axis0(Af[jnp.asarray(spec.r_idx)],
                             _ceil_to(spec.nr, ntp))),)
        if spec.nr else ()
    )
    soc = tuple(
        cols_pad(
            _pad_axis0(Af[jnp.asarray(g.idx)], _ceil_to(g.count, ntp))
        )  # (k_pad, dim, n_pad)
        for g in spec.soc_groups
    )
    sdp = tuple(
        cols_pad(
            _pad_axis0(Af[jnp.asarray(g.idx)], _ceil_to(g.count, ntp))
        )  # (k_pad, tdim, n_pad)
        for g in spec.sdp_groups
    )
    arows = (r_part, soc, sdp)
    specs = (
        tuple(P(axis, None) for _ in r_part),
        tuple(P(axis, None, None) for _ in soc),
        tuple(P(axis, None, None) for _ in sdp),
    )
    return arows, specs


def _pad_scaling_shards(spec: ConeSpec, FinvT, fd, ntp, axis):
    """Per-iteration: the cast F⁻ᵀ scaling's group arrays padded along the
    cone axis to ntp multiples (identity-like fill — the matching A rows
    are zero, so padded cones produce zero scaled rows). Returns the
    ``scal`` pytree + in_specs for the sharded factor kernel."""
    Fi = sc.cast(FinvT, fd)
    r_part = (
        (_pad_axis0(Fi.r_d, _ceil_to(spec.nr, ntp), fill=1.0),)
        if spec.nr else ()
    )
    soc = tuple(
        (
            _pad_axis0(s.d, _ceil_to(g.count, ntp), fill=1.0),
            _pad_axis0(s.u, _ceil_to(g.count, ntp)),
            _pad_axis0(s.alpha, _ceil_to(g.count, ntp)),
        )
        for g, s in zip(spec.soc_groups, Fi.soc)
    )
    sdp = tuple(
        _pad_axis0(s.S, _ceil_to(g.count, ntp))
        .at[g.count:].set(jnp.eye(g.order, dtype=fd))
        if g.count % ntp
        else s.S  # identity fill keeps padded congruences finite
        for g, s in zip(spec.sdp_groups, Fi.sdp)
    )
    scal = (r_part, soc, sdp)
    specs = (
        tuple(P(axis) for _ in r_part),
        tuple((P(axis, None), P(axis, None), P(axis)) for _ in soc),
        tuple(P(axis, None, None) for _ in sdp),
    )
    return scal, specs


def _make_factor_kernel_sharded(mesh: Mesh, axis: str, n_pad: int, p: int,
                                dtype, scal_specs, arow_specs):
    """Sharded-scaling variant of :func:`_make_factor_kernel`: instead of
    consuming a replicated, pre-scaled ``Atil``, every device applies the
    NT scaling to ITS OWN cone blocks (cone axes sharded over the mesh)
    and feeds its locally-scaled rows straight into the Gram partial —
    the full (m, n) ``Atil`` never exists, and the O(m·n·d) scaling work
    is divided by ntp. Also computes ``gamma`` (the equality-augmentation
    balance, needing Σ‖Atil‖²) internally via one scalar psum.

    Returns ``factor(scal, arows, Q_blk, G_full, trQ, gG, ridge) ->
    (W, dscale, Y, gamma, ok)``.
    """
    ntp = mesh.shape[axis]
    r = n_pad // ntp

    in_specs = (
        scal_specs,
        arow_specs,
        P(axis, None),
        P(None, None),
        P(),
        P(),
        P(),
    )

    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=in_specs,
        out_specs=(P(None, axis), P(None), P(None, None), P(), P()),
    )
    def factor(scal, arows, Q_blk, G_full, trQ, gG, ridge):
        me = jax.lax.axis_index(axis)
        rowid = me * r + jnp.arange(r)

        rd_part, socs, sdps = scal
        Ar_part, Asoc, Asdp = arows

        part = jnp.zeros((n_pad, n_pad), dtype)
        sumsq = jnp.zeros((), dtype)

        def accum(rows, part, sumsq):
            part = part + jnp.matmul(rows.T, rows, precision=_HI)
            return part, sumsq + jnp.sum(rows * rows)

        for rd, A_r in zip(rd_part, Ar_part):
            rows = rd[:, None] * A_r  # my slice of the R rows
            part, sumsq = accum(rows, part, sumsq)
        for (d_, u_, al_), Ag in zip(socs, Asoc):
            # diag + rank-1 per cone (cones/scaling.py:_apply_mat)
            uA = jnp.einsum("kd,kdn->kn", u_, Ag, precision=_HI)
            val = (
                d_[:, :, None] * Ag
                + al_[:, None, None] * u_[:, :, None] * uA[:, None, :]
            )
            part, sumsq = accum(
                val.reshape(-1, n_pad), part, sumsq
            )
        for S, Ag in zip(sdps, Asdp):
            X = _mat(jnp.swapaxes(Ag, -1, -2))  # (k_loc, n_pad, d, d)
            Yc = jnp.einsum("kba,knbc,kcd->knad", S, X, S, precision=_HI)
            rows = jnp.swapaxes(_vecm(Yc), -1, -2).reshape(-1, n_pad)
            part, sumsq = accum(rows, part, sumsq)

        M_blk = jax.lax.psum_scatter(
            part, axis, scatter_dimension=0, tiled=True
        ) + Q_blk

        # γ balances the M and GᵀG scales (kkt/schur.py) — Σ‖Atil‖² is a
        # one-scalar psum over the sharded rows.
        if p:
            tr_est = (trQ + jax.lax.psum(sumsq, axis)) / n_pad
            gamma = tr_est / gG
            gamma = jnp.where(
                jnp.isfinite(gamma) & (gamma > 0), gamma, 1.0
            ).astype(dtype)
            Grows = jax.lax.dynamic_slice(
                G_full.T, (me * r, _I0), (r, p)
            )
            M_blk = M_blk + gamma * jnp.matmul(Grows, G_full, precision=_HI)
        else:
            gamma = jnp.ones((), dtype)

        W_loc, dscale, Y, ok = _factor_body(
            M_blk, G_full, gamma, ridge, me, rowid, axis, ntp, r, n_pad,
            p, dtype
        )
        return W_loc, dscale, Y, gamma, ok

    return factor


# ──────────────────────────────────────────────────────────────────────
#  The TP KKT solver (3-level plugin contract)
# ──────────────────────────────────────────────────────────────────────


def kktsolver_schur_tp(mesh: Mesh, axis: str = "tp", factor_dtype=None,
                       distributed_factor: bool = True,
                       shard_scaling: bool = True):
    """Sharded variant of :func:`~conicip_tpu.kkt.kktsolver_schur`.

    Returns a KKT solver (same 3-level protocol) whose Schur assembly —
    and, with ``distributed_factor=True`` (default), the Cholesky
    factorization and every back-solve — run under ``shard_map`` over
    ``mesh[axis]``. All cone specs are supported (module docstring); m and
    n are padded to mesh multiples internally.

    ``shard_scaling=True`` (default, requires ``distributed_factor``) also
    shards the NT-scaling application over the cone blocks: each device
    scales only its own cones' rows of A and feeds them straight into its
    Gram partial — the cone-block scaling parallelism of SURVEY.md §2.3.
    ``False`` restores the replicated ``Atil`` formation.

    ``factor_dtype=float32`` runs the sharded assembly + factorization in
    f32 (the IPM's iterative refinement restores accuracy, exactly as on
    the single-device production path).
    """
    ntp = mesh.shape[axis]

    def kktsolver(Q, A, G, spec: ConeSpec):
        n = Q.shape[0]
        m = A.shape[0]
        p = G.shape[0]
        wd = Q.dtype
        fd = wd if factor_dtype is None else factor_dtype

        m_pad = _ceil_to(max(m, 1), ntp)
        n_pad = _ceil_to(n, ntp)

        # Static padded operands (identity-extend Q so the padded Schur
        # matrix is [[M, 0], [0, I]]; its factor and inverse carry the
        # identity corner through every formula untouched).
        Q_pad = jnp.zeros((n_pad, n_pad), fd)
        Q_pad = Q_pad.at[:n, :n].set(Q.astype(fd))
        Q_pad = Q_pad.at[jnp.arange(n, n_pad), jnp.arange(n, n_pad)].set(1.0)
        G_pad = jnp.zeros((p, n_pad), fd).at[:, :n].set(G.astype(fd))
        Gf = G.astype(fd)

        ridge0 = 30.0 * jnp.finfo(fd).eps

        def kkt2x2(Q_, A_, G_, spec_):
            use_sharded = bool(distributed_factor and shard_scaling)
            if distributed_factor:
                factor = _make_factor_kernel(mesh, axis, n_pad, p, fd)
                minv_apply = _make_apply(mesh, axis, n_pad)
                matapply_T = _make_matapply_T(mesh, axis, n_pad, p)
            else:
                factor = minv_apply = matapply_T = None
            if use_sharded:
                # One-time regrouping of A's rows per cone batch, cone
                # axes padded to ntp multiples (zero rows are inert).
                arows, arow_specs = _shard_cone_rows(
                    spec_, A_, n, n_pad, ntp, fd, axis
                )
                trQ = jnp.trace(Q_pad).astype(fd)
                gG = (
                    (jnp.sum(Gf * Gf) / p + jnp.finfo(fd).tiny).astype(fd)
                    if p else jnp.ones((), fd)
                )

            def solve2x2gen(F, FinvT):
                if use_sharded:
                    # Cone-block-sharded scaling apply + Gram + factor:
                    # each device scales only its own cones (module
                    # docstring); γ comes back from the kernel (needs the
                    # global Σ‖Atil‖², a one-scalar psum inside).
                    scal, scal_specs = _pad_scaling_shards(
                        spec_, FinvT, fd, ntp, axis
                    )
                    factor_sh = _make_factor_kernel_sharded(
                        mesh, axis, n_pad, p, fd, scal_specs, arow_specs
                    )
                    W, dscale, Y, gamma, ok = factor_sh(
                        scal, arows, Q_pad, G_pad, trQ, gG,
                        jnp.asarray(ridge0, fd),
                    )
                    # Escalating-ridge retry (cf. kkt/schur.py).
                    W, dscale, Y, gamma, _ = jax.lax.cond(
                        ok,
                        lambda: (W, dscale, Y, gamma, ok),
                        lambda: factor_sh(
                            scal, arows, Q_pad, G_pad, trQ, gG,
                            jnp.asarray(1e5 * ridge0, fd),
                        ),
                    )
                    return _finish_gen(W, dscale, Y, gamma)

                # Structure-exploiting scaled rows (replicated: O(m·n·d),
                # ≪ the sharded O(mn²) Gram) — supports every cone spec.
                Fi = sc.cast(FinvT, fd)
                Atil = sc.apply_mat(spec_, Fi, A_.astype(fd))
                Atil_pad = jnp.zeros((m_pad, n_pad), fd).at[:m, :n].set(Atil)

                if p:
                    # γ balances the M and GᵀG scales (kkt/schur.py).
                    tr_est = (
                        jnp.trace(Q_pad)
                        + jnp.sum(Atil_pad * Atil_pad)
                    ) / n_pad
                    gamma = tr_est / (jnp.sum(Gf * Gf) / p + jnp.finfo(fd).tiny)
                    gamma = jnp.where(
                        jnp.isfinite(gamma) & (gamma > 0), gamma, 1.0
                    ).astype(fd)
                else:
                    gamma = jnp.ones((), fd)

                if not distributed_factor:
                    return _replicated_gen(
                        mesh, axis, spec_, Atil_pad, Q_pad, G_pad, Gf,
                        gamma, ridge0, n, n_pad, m_pad, p, wd, fd
                    )

                W, dscale, Y, ok = factor(
                    Atil_pad, Q_pad, G_pad, gamma, jnp.asarray(ridge0, fd)
                )
                # Escalating-ridge retry (cf. kkt/schur.py): a rounded f32
                # assembly can leave M̃ indefinite beyond the base ridge.
                W, dscale, Y, _ = jax.lax.cond(
                    ok,
                    lambda: (W, dscale, Y, ok),
                    lambda: factor(
                        Atil_pad, Q_pad, G_pad, gamma,
                        jnp.asarray(1e5 * ridge0, fd),
                    ),
                )
                return _finish_gen(W, dscale, Y, gamma)

            def _finish_gen(W, dscale, Y, gamma):
                """Second Schur complement on G + the per-RHS solve —
                common tail of both the sharded- and replicated-scaling
                factor paths."""
                if p:
                    S = jnp.matmul(Y.T, Y, precision=_HI)  # (p, p) SPD
                    ss = jax.lax.rsqrt(
                        jnp.maximum(jnp.diagonal(S), jnp.finfo(fd).tiny)
                    )
                    Ss = S * ss[:, None] * ss[None, :]
                    Ls = jnp.linalg.cholesky(
                        Ss + ridge0 * jnp.eye(p, dtype=fd)
                    )
                    Lsinv = solve_triangular(
                        Ls, jnp.eye(p, dtype=fd), lower=True
                    )
                    # Z = M̃⁻¹Gᵀ = D Wᵀ Y, precomputed once per iteration
                    Z = dscale[:, None] * matapply_T(W, Y)  # (n_pad, p)
                else:
                    Lsinv = jnp.zeros((0, 0), fd)
                    ss = jnp.zeros((0,), fd)
                    Z = jnp.zeros((n_pad, 0), fd)

                def sinv(x):
                    t = jnp.matmul(Lsinv, ss * x, precision=_HI)
                    return ss * jnp.matmul(Lsinv.T, t, precision=_HI)

                def solve2x2(by, bw):
                    by = by.astype(fd)
                    bw = bw.astype(fd)
                    rhs = jnp.zeros((n_pad,), fd).at[:n].set(
                        by + (gamma * jnp.matmul(Gf.T, bw, precision=_HI)
                              if p else 0.0)
                    )
                    t = minv_apply(W, dscale, rhs)
                    if p:
                        b2 = sinv(
                            jnp.matmul(G_pad, t, precision=_HI) - bw
                        )
                        a = t - jnp.matmul(Z, b2, precision=_HI)
                        return a[:n].astype(wd), b2.astype(wd)
                    return t[:n].astype(wd), by[:0].astype(wd)

                return solve2x2

            return solve2x2gen

        return pivot(kkt2x2, factor_dtype=factor_dtype)(Q, A, G, spec)

    return kktsolver


def _replicated_gen(mesh, axis, spec, Atil_pad, Q_pad, G_pad, Gf, gamma,
                    ridge0, n, n_pad, m_pad, p, wd, fd):
    """Sharded-assembly / replicated-factorization fallback
    (``distributed_factor=False``): the round-1 design, generalized to all
    cone specs via the pre-scaled ``Atil``."""

    @functools.partial(
        shard_map, mesh=mesh,
        in_specs=P(axis, None), out_specs=P(None, None),
    )
    def assemble(A_blk):
        return jax.lax.psum(jnp.matmul(A_blk.T, A_blk, precision=_HI), axis)

    M = Q_pad + assemble(Atil_pad)
    if p:
        M = M + gamma * jnp.matmul(G_pad.T, G_pad, precision=_HI)
    dscale = jax.lax.rsqrt(
        jnp.maximum(jnp.diagonal(M), jnp.finfo(fd).tiny)
    )
    Ms = M * dscale[:, None] * dscale[None, :]
    I = jnp.eye(n_pad, dtype=fd)
    L = jnp.linalg.cholesky(Ms + ridge0 * I)
    L = jax.lax.cond(
        jnp.all(jnp.isfinite(L)),
        lambda: L,
        lambda: jnp.linalg.cholesky(Ms + (1e5 * ridge0) * I),
    )
    Linv = solve_triangular(L, I, lower=True)

    def minv(x):
        t = jnp.matmul(Linv, dscale * x, precision=_HI)
        return dscale * jnp.matmul(Linv.T, t, precision=_HI)

    if p:
        E = jnp.matmul(Linv, dscale[:, None] * G_pad.T, precision=_HI)
        S = jnp.matmul(E.T, E, precision=_HI)
        ss = jax.lax.rsqrt(jnp.maximum(jnp.diagonal(S), jnp.finfo(fd).tiny))
        Ls = jnp.linalg.cholesky(
            S * ss[:, None] * ss[None, :] + ridge0 * jnp.eye(p, dtype=fd)
        )
        Lsinv = solve_triangular(Ls, jnp.eye(p, dtype=fd), lower=True)

        def sinv(x):
            t = jnp.matmul(Lsinv, ss * x, precision=_HI)
            return ss * jnp.matmul(Lsinv.T, t, precision=_HI)

    def solve2x2(by, bw):
        by = by.astype(fd)
        bw = bw.astype(fd)
        rhs = jnp.zeros((n_pad,), fd).at[:n].set(
            by + (gamma * jnp.matmul(Gf.T, bw, precision=_HI) if p else 0.0)
        )
        t = minv(rhs)
        if p:
            b2 = sinv(jnp.matmul(G_pad, t, precision=_HI) - bw)
            a = t - minv(jnp.matmul(G_pad.T, b2, precision=_HI))
            return a[:n].astype(wd), b2.astype(wd)
        return t[:n].astype(wd), by[:0].astype(wd)

    return solve2x2
