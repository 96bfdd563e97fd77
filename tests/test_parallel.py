"""Batched + sharded solving on the virtual 8-device CPU mesh."""

import numpy as np
import pytest

import jax

from conicip_tpu.models import batched_box_qp
from conicip_tpu.parallel import (
    distributed_normal_matrix,
    kktsolver_schur_tp,
    make_mesh,
    solve_batch,
)
import conicip_tpu as ct


def test_solve_batch_plain():
    Q, c, A, b, cones = batched_box_qp(batch=8, n=20)
    bs = solve_batch(Q, c, A, b, cones, optTol=1e-7)
    assert bs.statuses == ["Optimal"] * 8
    # every instance matches its individual solve
    for i in range(8):
        # both sides auto-select 1 centrality corrector on this dense
        # Schur batch — identical algorithm, so the trajectories and
        # endpoints match to refinement accuracy
        sol = ct.conic_ip(Q[i], c[i], A[i], b[i], cones, optTol=1e-7)
        np.testing.assert_allclose(bs.y[i], sol.y, atol=1e-5)


def test_solve_batch_sharded():
    assert len(jax.devices()) == 8, "conftest must provide 8 CPU devices"
    mesh = make_mesh((8,), ("batch",))
    Q, c, A, b, cones = batched_box_qp(batch=16, n=16)
    bs = solve_batch(Q, c, A, b, cones, mesh=mesh, optTol=1e-6)
    assert bs.statuses == ["Optimal"] * 16


def test_solve_batch_mixed_statuses():
    # one infeasible instance inside an otherwise-optimal batch must not
    # poison the others (SURVEY.md §7 hard part 6)
    n = 10
    rng = np.random.default_rng(1)
    Q = np.stack([np.eye(n)] * 4)
    c = rng.standard_normal((4, n))
    A0 = np.vstack([np.eye(n), -np.eye(n)])
    A = np.stack([A0] * 4)
    b = np.stack([-np.ones(2 * n)] * 4)
    b[2] = np.ones(2 * n)  # y ≥ 1 and −y ≥ 1 → infeasible
    bs = solve_batch(Q, c, A, b, [("R", 2 * n)], optTol=1e-7)
    st = bs.statuses
    assert st[2] == "Infeasible"
    assert st[0] == st[1] == st[3] == "Optimal"
    assert np.all(np.isfinite(bs.y[[0, 1, 3]]))


def test_solve_batch_f32_backstop_escalates_infeasible():
    # An f32-tier instance that ends Abandoned with a LARGE residual (the
    # signature of infeasibility, not of a near-solution stall) must still
    # escalate through the backstop ladder and come back certified
    # Infeasible (advisor round-1 medium finding).
    import jax.numpy as jnp

    n = 10
    rng = np.random.default_rng(3)
    Q = np.stack([np.eye(n)] * 4)
    c = rng.standard_normal((4, n))
    A0 = np.vstack([np.eye(n), -np.eye(n)])
    A = np.stack([A0] * 4)
    b = np.stack([-np.ones(2 * n)] * 4)
    b[1] = np.ones(2 * n)  # y ≥ 1 and −y ≥ 1 → infeasible
    bs = solve_batch(Q, c, A, b, [("R", 2 * n)],
                     factor_dtype=jnp.float32, mixedResiduals=True,
                     optTol=1e-7)
    st = bs.statuses
    assert st[1] == "Infeasible"
    assert st[0] == st[2] == st[3] == "Optimal"
    assert np.maximum(bs.prFeas, np.maximum(bs.duFeas, bs.muFeas))[
        [0, 2, 3]].max() < 1e-7


def test_distributed_normal_matrix():
    mesh = make_mesh((8,), ("tp",))
    rng = np.random.default_rng(0)
    n, m = 12, 32
    Q = np.eye(n)
    A = rng.standard_normal((m, n))
    dinv = rng.uniform(0.5, 2.0, m)
    M = distributed_normal_matrix(Q, A, dinv, mesh, "tp")
    At = A * dinv[:, None]
    np.testing.assert_allclose(np.asarray(M), Q + At.T @ At, atol=1e-10)


def test_kktsolver_schur_tp_full_solve():
    # full IPM solve with the row-sharded Schur assembly must agree with the
    # single-device solver
    mesh = make_mesh((8,), ("tp",))
    n = 16
    rng = np.random.default_rng(0)
    B = rng.standard_normal((n, n))
    Q = B.T @ B / n + np.eye(n)
    c = rng.standard_normal(n)
    A = np.vstack([np.eye(n), -np.eye(n)])
    b = -np.ones(2 * n)

    sol_tp = ct.conic_ip(Q, c, A, b, [("R", 2 * n)],
                         kktsolver=kktsolver_schur_tp(mesh, "tp"), optTol=1e-7)
    sol = ct.conic_ip(Q, c, A, b, [("R", 2 * n)], optTol=1e-7)
    assert sol_tp.status == "Optimal"
    np.testing.assert_allclose(sol_tp.y, sol.y, atol=1e-6)


def _tp_problem(n, cones, p=0, seed=1):
    rng = np.random.default_rng(seed)
    B = rng.standard_normal((n, n))
    Q = B.T @ B / n + np.eye(n)
    c = rng.standard_normal(n)
    m = sum(d for _, d in cones)
    A = rng.standard_normal((m, n)) * 0.3
    y0 = rng.standard_normal(n) * 0.1
    e = np.asarray(ct.ConeSpec(cones).identity)
    b = A @ y0 - e  # strictly feasible: A y0 - b = e (cone interior)
    G = rng.standard_normal((p, n)) if p else np.zeros((0, n))
    d = G @ y0 if p else np.zeros(0)
    return Q, c, A, b, G, d


@pytest.mark.parametrize(
    "cones,p",
    [
        ([("R", 21)], 0),  # m=21, n=19: nothing divisible by 8 — padding
        ([("R", 24)], 3),  # equalities through the sharded W couplings
        ([("R", 10), ("Q", 5), ("Q", 5)], 0),  # SOC groups
        ([("R", 8), ("Q", 4), ("S", 10)], 2),  # full R+Q+S mix + equalities
        ([("R", 24)], 5),  # p=5 > r=3: equality coupling wider than a panel
    ],
    ids=["pad", "eq", "soc", "rqs_eq", "wide_eq"],
)
def test_kktsolver_schur_tp_general_specs(cones, p):
    # the sharded path must support EVERY cone spec
    # and agree with the replicated production solver
    mesh = make_mesh((8,), ("tp",))
    n = 19
    Q, c, A, b, G, d = _tp_problem(n, cones, p)
    sol_tp = ct.conic_ip(Q, c, A, b, cones, G=G, d=d,
                         kktsolver=kktsolver_schur_tp(mesh, "tp"),
                         optTol=1e-7)
    # the TP path runs a user kktsolver (0 correctors) — pin the
    # reference to the same trajectory
    sol = ct.conic_ip(Q, c, A, b, cones, G=G, d=d, optTol=1e-7,
                      centralityCorrectors=0)
    assert sol_tp.status == "Optimal"
    np.testing.assert_allclose(sol_tp.y, sol.y, atol=1e-6)


def test_kktsolver_schur_tp_f32_distributed_factor():
    # mixed-precision sharded factorization + IPM refinement
    import jax.numpy as jnp

    mesh = make_mesh((8,), ("tp",))
    cones = [("R", 10), ("Q", 5), ("Q", 5)]
    Q, c, A, b, G, d = _tp_problem(19, cones, 0)
    kkt = kktsolver_schur_tp(mesh, "tp", factor_dtype=jnp.float32)
    sol = ct.conic_ip(Q, c, A, b, cones, kktsolver=kkt,
                      mixedResiduals=True, optTol=1e-7)
    assert sol.status == "Optimal"
    assert max(sol.prFeas, sol.duFeas, sol.muFeas) < 1e-7


def test_kktsolver_schur_tp_cone_sharded_scaling():
    # shard_scaling=True (default): each device applies the NT scaling to
    # its OWN cone blocks only (cone axes sharded over the mesh) — must
    # agree with the replicated-Atil variant and the single-device solver
    # on a full R+Q+S mix with equalities and non-divisible group counts
    # (3 SOCs, 1 SDP over 8 devices — heavy padding).
    mesh = make_mesh((8,), ("tp",))
    cones = [("R", 9), ("Q", 4), ("Q", 4), ("Q", 4), ("S", 6)]
    Q, c, A, b, G, d = _tp_problem(21, cones, 2)
    sol_sh = ct.conic_ip(Q, c, A, b, cones, G=G, d=d, optTol=1e-7,
                         kktsolver=kktsolver_schur_tp(mesh, "tp"))
    sol_rep = ct.conic_ip(
        Q, c, A, b, cones, G=G, d=d, optTol=1e-7,
        kktsolver=kktsolver_schur_tp(mesh, "tp", shard_scaling=False))
    ref = ct.conic_ip(Q, c, A, b, cones, G=G, d=d, optTol=1e-7,
                      centralityCorrectors=0)
    assert sol_sh.status == "Optimal"
    np.testing.assert_allclose(sol_sh.y, ref.y, atol=1e-6)
    np.testing.assert_allclose(sol_sh.y, sol_rep.y, atol=1e-8)


def test_kktsolver_schur_tp_replicated_fallback():
    # distributed_factor=False keeps the sharded assembly but factors
    # replicated — same answers
    mesh = make_mesh((8,), ("tp",))
    cones = [("R", 8), ("Q", 4), ("S", 10)]
    Q, c, A, b, G, d = _tp_problem(19, cones, 0)
    kkt = kktsolver_schur_tp(mesh, "tp", distributed_factor=False)
    sol = ct.conic_ip(Q, c, A, b, cones, kktsolver=kkt, optTol=1e-7)
    ref = ct.conic_ip(Q, c, A, b, cones, optTol=1e-7,
                      centralityCorrectors=0)
    assert sol.status == "Optimal"
    np.testing.assert_allclose(sol.y, ref.y, atol=1e-6)


def test_distributed_factor_kernel_exact():
    # the sharded Gram → panel-Cholesky → column-sharded L⁻¹ pipeline is
    # exact to machine precision against the numpy reference
    import jax.numpy as jnp

    from conicip_tpu.parallel.distributed import (_make_apply,
                                                  _make_factor_kernel)

    mesh = make_mesh((8,), ("tp",))
    n, p = 64, 3
    rng = np.random.default_rng(0)
    B = rng.standard_normal((n, n))
    Msym = B.T @ B + n * np.eye(n)
    Atil = np.linalg.cholesky(Msym - np.eye(n)).T  # AtilᵀAtil + I = Msym
    G = rng.standard_normal((p, n))
    ridge = 30 * np.finfo(np.float64).eps

    factor = _make_factor_kernel(mesh, "tp", n, p, jnp.float64)
    W, dscale, Y, ok = factor(jnp.asarray(Atil), jnp.eye(n),
                              jnp.asarray(G), jnp.asarray(1.0),
                              jnp.asarray(ridge))
    assert bool(np.asarray(ok))
    W, dscale, Y = map(np.asarray, (W, dscale, Y))
    Mtil = Msym + G.T @ G
    Ms = Mtil * dscale[:, None] * dscale[None, :]
    Wref = np.linalg.inv(np.linalg.cholesky(Ms + ridge * np.eye(n)))
    np.testing.assert_allclose(W, Wref, atol=1e-15 * n)
    np.testing.assert_allclose(Y, Wref @ (dscale[:, None] * G.T),
                               atol=1e-15 * n)

    app = _make_apply(mesh, "tp", n)
    x = rng.standard_normal(n)
    np.testing.assert_allclose(
        np.asarray(app(jnp.asarray(W), jnp.asarray(dscale),
                       jnp.asarray(x))),
        np.linalg.solve(Mtil, x), atol=1e-12)


def test_solve_batch_warm_start():
    Q, c, A, b, cones = batched_box_qp(batch=8, n=20)
    cold = solve_batch(Q, c, A, b, cones, optTol=1e-7)
    assert cold.statuses == ["Optimal"] * 8

    c2 = np.asarray(c) * 1.01
    cold2 = solve_batch(Q, c2, A, b, cones, optTol=1e-7)
    warm2 = solve_batch(Q, c2, A, b, cones, optTol=1e-7, warm_start=cold)
    assert warm2.statuses == ["Optimal"] * 8
    assert warm2.Iter.mean() < cold2.Iter.mean()
    # both are tol-accurate solutions; iterates agree to ~sqrt(tol) near
    # weakly-active bounds
    np.testing.assert_allclose(warm2.y, cold2.y, atol=2e-3)
    assert np.maximum(warm2.prFeas,
                      np.maximum(warm2.duFeas, warm2.muFeas)).max() < 1e-7


def test_solve_batch_warm_start_scrubs_nonfinite():
    Q, c, A, b, cones = batched_box_qp(batch=4, n=12)
    cold = solve_batch(Q, c, A, b, cones, optTol=1e-7)
    y = np.array(cold.y)
    y[2] = np.nan  # one corrupted instance must not poison the batch
    warm = solve_batch(Q, c, A, b, cones, optTol=1e-7,
                       warm_start=(y, np.array(cold.w), np.array(cold.v)))
    assert warm.statuses == ["Optimal"] * 4


def test_solve_batch_warm_start_sharded():
    mesh = make_mesh((8,), ("batch",))
    Q, c, A, b, cones = batched_box_qp(batch=16, n=16)
    cold = solve_batch(Q, c, A, b, cones, mesh=mesh, optTol=1e-7)
    warm = solve_batch(Q, c, A, b, cones, mesh=mesh, optTol=1e-7,
                       warm_start=cold)
    assert warm.statuses == ["Optimal"] * 16
    assert warm.Iter.max() <= cold.Iter.max()


def test_solve_batch_warm_start_bad_dims():
    Q, c, A, b, cones = batched_box_qp(batch=4, n=12)
    cold = solve_batch(Q, c, A, b, cones)
    with pytest.raises(ValueError):
        solve_batch(Q, c, A, b, cones,
                    warm_start=(np.array(cold.y)[:, :-1], None,
                                np.array(cold.v)))


# ── batched null-space equality elimination (shared G) ──


def test_solve_batch_eliminated_matches_single():
    import jax.numpy as jnp

    from conicip_tpu.models import batched_mixed_rq_eq

    Q, c, A, b, cones, G, d = batched_mixed_rq_eq(batch=6, n=40)
    # The eliminated path runs the whole batch through the p = 0 f32 tier;
    # near-tolerance stragglers escalate through ONE batched
    # f64-assembled re-solve (never per-instance serialization).
    bs = solve_batch(Q, c, A, b, cones, G, d, factor_dtype=jnp.float32,
                     optTol=1e-7)
    assert bs.statuses == ["Optimal"] * 6
    assert np.max(np.maximum(bs.prFeas,
                             np.maximum(bs.duFeas, bs.muFeas))) < 1e-7
    # equalities hold to elimination accuracy and answers match the
    # individual full-precision solves
    np.testing.assert_allclose(bs.y @ G.T, d, atol=1e-9)
    for i in range(6):
        sol = ct.conic_ip(Q[i], c[i], A[i], b[i], cones, G=G, d=d[i],
                          factor_dtype=None, optTol=1e-9,
                          eliminateEqualities=False)
        # both are tol-accurate; iterates agree to ~sqrt(tol) near
        # weakly-active bounds (same bound as the warm-start test)
        np.testing.assert_allclose(bs.y[i], sol.y, atol=2e-3)
        np.testing.assert_allclose(bs.w[i], sol.w, atol=2e-3)


def test_solve_batch_eliminated_inconsistent_instance():
    import jax.numpy as jnp

    from conicip_tpu.models import batched_mixed_rq_eq

    Q, c, A, b, cones, G, d = batched_mixed_rq_eq(batch=4, n=30)
    # duplicate an equality row with a contradictory rhs in instance 2 only
    G2 = np.vstack([G, G[0]])
    d2 = np.concatenate([d, d[:, :1]], axis=1)
    d2[2, -1] += 1.0  # same row, different rhs → inconsistent
    bs = solve_batch(Q, c, A, b, cones, G2, d2, factor_dtype=jnp.float32,
                     optTol=1e-7)
    st = bs.statuses
    assert st[2] == "Infeasible"
    assert st[0] == st[1] == st[3] == "Optimal"
    assert np.all(np.isnan(bs.y[2]))


def test_solve_batch_eliminated_sharded_and_warm():
    import jax.numpy as jnp

    from conicip_tpu.models import batched_mixed_rq_eq

    mesh = make_mesh((8,), ("batch",))
    Q, c, A, b, cones, G, d = batched_mixed_rq_eq(batch=8, n=32)
    cold = solve_batch(Q, c, A, b, cones, G, d, mesh=mesh,
                       factor_dtype=jnp.float32, optTol=1e-7)
    assert cold.statuses == ["Optimal"] * 8
    warm = solve_batch(Q, c, A, b, cones, G, d, mesh=mesh,
                       factor_dtype=jnp.float32, optTol=1e-7,
                       warm_start=cold)
    assert warm.statuses == ["Optimal"] * 8
    assert warm.Iter.mean() <= cold.Iter.mean()


def test_solve_batch_eliminate_requires_shared_G():
    from conicip_tpu.models import batched_mixed_rq_eq

    Q, c, A, b, cones, G, d = batched_mixed_rq_eq(batch=3, n=24)
    Gb = np.broadcast_to(G, (3,) + G.shape).copy()
    with pytest.raises(ValueError):
        solve_batch(Q, c, A, b, cones, Gb, d, eliminate_equalities=True)


def test_solve_batch_sdp_backstop_skips_futile_tier():
    # S-cone stalls cannot be rescued by the f64-assembled/f32-factored
    # tier (the f32 factorization is the floor); the ladder must escalate
    # SDP specs straight to full f64 and certify every instance.
    import jax.numpy as jnp

    from conicip_tpu.models import batched_small_sdp

    Q, c, A, b, cones = batched_small_sdp(6)
    bs = solve_batch(Q, c, A, b, cones, factor_dtype=jnp.float32,
                     optTol=1e-7)
    assert bs.statuses == ["Optimal"] * 6
    assert np.max(np.maximum(bs.prFeas,
                             np.maximum(bs.duFeas, bs.muFeas))) < 1e-7


def test_solve_batch_full_rank_G_degenerate():
    # G with rank n pins y completely — a 0-variable reduced problem must
    # fall back to the direct saddle path, not crash (single + batched)
    import jax.numpy as jnp

    n = 4
    Q = np.stack([np.eye(n)] * 3)
    c = np.zeros((3, n))
    A = Q.copy()
    b = np.zeros((3, n))
    d = 0.5 * np.ones((3, n))
    bs = solve_batch(Q, c, A, b, [("R", n)], np.eye(n), d,
                     factor_dtype=jnp.float32, optTol=1e-7)
    assert bs.statuses == ["Optimal"] * 3
    np.testing.assert_allclose(bs.y, d, atol=1e-6)
    s = ct.conic_ip(np.eye(n), np.zeros(n), np.eye(n), np.zeros(n),
                    [("R", n)], G=np.eye(n), d=0.5 * np.ones(n),
                    factor_dtype=jnp.float32, optTol=1e-7)
    assert s.status == "Optimal"
    np.testing.assert_allclose(s.y, 0.5 * np.ones(n), atol=1e-6)


def test_batched_sdp_fasteig_certifies():
    # Batched SDP fast tier runs all S-cone decompositions in f32
    # (fastEig=True auto); the fused full-f64 rescue tier is the escape
    # hatch. Every instance must still certify 1e-6, matching the
    # full-precision-decomposition run's statuses.
    import jax.numpy as jnp

    from conicip_tpu.models.generators import batched_small_sdp

    Q, c, A, b, cones = batched_small_sdp(6)
    fast = solve_batch(Q, c, A, b, cones, factor_dtype=jnp.float32)
    slow = solve_batch(Q, c, A, b, cones, factor_dtype=jnp.float32,
                       fastEig=False)
    for bs in (fast, slow):
        assert bs.statuses == ["Optimal"] * 6
        resid = np.maximum(bs.prFeas, np.maximum(bs.duFeas, bs.muFeas))
        assert float(np.max(resid)) < 1e-6
    np.testing.assert_allclose(fast.pobj, slow.pobj, rtol=1e-5, atol=1e-5)


def test_batched_sdp_fasteig_rescue_tier_certifies():
    # An SDP rescue ladder: first the f64-KKT tier with f32
    # decompositions (fastEig=True), then the full-precision-decomposition
    # final tier
    # backstopping instances whose 1e-6 certification needs the extra
    # decomposition digits (~1 in 6 on this family with fastEig alone).
    # Exercise that ladder directly (solve_batch does not build it by
    # default): every instance must certify 1e-6.
    import jax.numpy as jnp

    from conicip_tpu.models.generators import batched_small_sdp
    from conicip_tpu.parallel.batch import make_batched_ladder_solver
    from conicip_tpu.solver import _default_kktsolver
    from conicip_tpu.solver.ipm import IPMOptions

    Q, c, A, b, cones = batched_small_sdp(6)
    spec = ct.ConeSpec(cones)
    n = c.shape[-1]
    tiers = (
        (_default_kktsolver(None),
         IPMOptions(optTol=1e-6, mixedResiduals=False, fastEig=True)),
        (_default_kktsolver(None),
         IPMOptions(optTol=1e-6, mixedResiduals=False, fastEig=False)),
    )
    solver = make_batched_ladder_solver(
        spec, _default_kktsolver(jnp.float32), tiers,
        IPMOptions(optTol=1e-6, mixedResiduals=True, fastEig=True),
    )
    Gb = jnp.zeros((6, 0, n))
    db = jnp.zeros((6, 0))
    st = solver(jnp.asarray(Q), jnp.asarray(c), jnp.asarray(A),
                jnp.asarray(b), Gb, db)
    assert np.all(np.asarray(st.status) == 1)  # Optimal
    resid = np.maximum(np.asarray(st.prFeas),
                       np.maximum(np.asarray(st.duFeas),
                                  np.asarray(st.muFeas)))
    assert float(np.max(resid)) < 1e-6
