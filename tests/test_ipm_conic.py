"""End-to-end IPM tests on SOC and SDP cones and mixed products.

Mirrors the reference's conic integration tests (test/runtests.jl:137-206,
527-590) with analytic answers.
"""

import numpy as np
import pytest

import conicip_tpu as ct
from conicip_tpu import vecm
from conicip_tpu.kkt import kktsolver_lu, kktsolver_qr, kktsolver_schur

import jax.numpy as jnp

OPT_TOL = 1e-7
TOL = 1e-3

SOLVERS = {
    "schur": kktsolver_schur,
    "qr": kktsolver_qr,
    "lu": kktsolver_lu,
}


@pytest.mark.parametrize("solver", SOLVERS)
def test_projection_onto_sphere(solver):
    # min ½‖y−a‖² s.t. ‖y‖ ≤ 1 → y* = a/‖a‖ (test/runtests.jl:137-166)
    n = 2
    H = np.eye(n)
    a = np.ones(n)
    A = np.vstack([np.zeros((1, n)), np.eye(n)])
    b = np.concatenate([[-1.0], np.zeros(n)])

    sol = ct.conic_ip(H, H @ a, A, b, [("Q", n + 1)],
                      kktsolver=SOLVERS[solver], optTol=OPT_TOL)
    assert sol.status == "Optimal"
    np.testing.assert_allclose(sol.y, a / np.linalg.norm(a), atol=TOL)


@pytest.mark.parametrize("solver", SOLVERS)
def test_combined_r_and_q(solver):
    # min ½‖y−c‖² s.t. y ≥ 0, ‖y‖ ≤ 1 → y* = max(c,0)/‖max(c,0)‖
    # (test/runtests.jl:168-206)
    n = 10
    H = np.eye(n)
    c = np.arange(1.0, n + 1)
    A = np.vstack([np.eye(n), np.zeros((1, n)), np.eye(n)])
    b = np.concatenate([np.zeros(n), [-1.0], np.zeros(n)])

    sol = ct.conic_ip(H, H @ c, A, b, [("R", n), ("Q", n + 1)],
                      kktsolver=SOLVERS[solver], optTol=OPT_TOL)
    assert sol.status == "Optimal"
    y = np.maximum(c, 0)
    y = y / np.linalg.norm(y)
    np.testing.assert_allclose(sol.y, y, atol=TOL)


@pytest.mark.parametrize("solver", ["schur", "qr", "lu"])
def test_psd_projection(solver):
    # min ½‖Y − C‖² s.t. Y ⪰ 0 with C = diag(1,1,1,-1,-1,-1)
    # → Y* = diag(1,1,1,0,0,0) (test/runtests.jl:527-552)
    n = 21
    H = np.eye(n)
    C = np.diag([1.0, 1, 1, -1, -1, -1])
    c = np.asarray(vecm(jnp.asarray(C)))
    A = np.eye(n)
    b = np.zeros(n)

    sol = ct.conic_ip(H, c, A, b, [("S", n)],
                      kktsolver=SOLVERS[solver], optTol=OPT_TOL)
    assert sol.status == "Optimal"
    Y = np.asarray(ct.mat(jnp.asarray(sol.y)))
    np.testing.assert_allclose(Y, np.diag([1.0, 1, 1, 0, 0, 0]), atol=TOL)


@pytest.mark.parametrize("solver", SOLVERS)
def test_soc_nonneg_mix(solver):
    # min ½‖x‖² + 1ᵀx s.t. ‖x₁:₃‖ ≤ 1, x ≥ 0 → x* = 0
    # (test/runtests.jl:554-590); solver minimizes −cᵀy so c = −1.
    n = 4
    Q = np.eye(n)
    c_obj = -np.ones(n)
    A_soc = np.vstack([np.zeros((1, n)), np.eye(n)[:3]])
    b_soc = np.concatenate([[-1.0], np.zeros(3)])
    A_nn = np.eye(n)
    b_nn = np.zeros(n)
    A = np.vstack([A_soc, A_nn])
    b = np.concatenate([b_soc, b_nn])

    sol = ct.conic_ip(Q, c_obj, A, b, [("Q", 4), ("R", n)],
                      kktsolver=SOLVERS[solver], optTol=1e-6)
    assert sol.status == "Optimal"
    assert np.linalg.norm(sol.y) < TOL


@pytest.mark.parametrize("solver", SOLVERS)
def test_mixed_r_q_s(solver, rng):
    # Full three-cone-type mix with equalities — the configuration where
    # the reference's sparse and pivot solvers both FAIL
    # (profile_output.txt:54-56); ours must pass on every backend.
    n = 6 + 10 + tri(4)  # R(6) + Q(10) + S(10): m = 26, n matches A=I
    H = np.eye(n)
    y0 = interior(rng, n)
    A = np.eye(n)
    b = np.zeros(n)
    G = np.ones((1, n))
    d = np.array([1.0])

    c = rng.standard_normal(n) * 0.1
    sol = ct.conic_ip(H, c, A, b, [("R", 6), ("Q", 10), ("S", tri(4))], G, d,
                      kktsolver=SOLVERS[solver], optTol=1e-6)
    assert sol.status == "Optimal"
    assert max(sol.prFeas, sol.duFeas, sol.muFeas) < 1e-6


def tri(d):
    return d * (d + 1) // 2


def interior(rng, n):
    return rng.uniform(0.5, 1.5, n)


@pytest.mark.parametrize("solver", SOLVERS)
def test_many_small_socs(solver, rng):
    # The reference's stress case: 250 small SOC cones (profile.jl:53-69).
    k, dim = 50, 3
    n = k * dim
    H = np.eye(n)
    c = rng.standard_normal(n)
    A = np.eye(n)
    b = np.zeros(n)
    cones = [("Q", dim)] * k
    sol = ct.conic_ip(H, c, A, b, cones, kktsolver=SOLVERS[solver], optTol=1e-6)
    assert sol.status == "Optimal"
    # analytic answer: per-cone projection onto the SOC under identity metric
    for i in range(k):
        blk = c[i * dim : (i + 1) * dim]
        proj = soc_project(blk)
        np.testing.assert_allclose(sol.y[i * dim : (i + 1) * dim], proj, atol=5e-3)


def soc_project(x):
    t, u = x[0], x[1:]
    nu = np.linalg.norm(u)
    if nu <= t:
        return x
    if nu <= -t:
        return np.zeros_like(x)
    a = (t + nu) / 2
    return np.concatenate([[a], a * u / nu])


def test_lastmile_finishes_without_ladder():
    # The f32 fast path stalls a factor ~2 above a 1e-6 tolerance on SOC
    # mixes (the factorization, not the assembly, runs out of precision);
    # the in-loop last-mile switch must finish the solve INSIDE the same
    # while_loop. A user-supplied kktsolver disables the escalation ladder,
    # so reaching Optimal here proves no ladder dispatch was needed.
    import functools

    import jax.numpy as jnp

    from conicip_tpu.kkt import kktsolver_schur
    from conicip_tpu.models.generators import many_small_socs, mixed_rq_eq

    for prob in (many_small_socs(), mixed_rq_eq()):
        plain = ct.conic_ip(
            *prob.args(),
            kktsolver=functools.partial(kktsolver_schur,
                                        factor_dtype=jnp.float32),
            mixedResiduals=True, eliminateEqualities=False,
        )
        lm = ct.conic_ip(
            *prob.args(),
            kktsolver=functools.partial(kktsolver_schur,
                                        factor_dtype=jnp.float32,
                                        lastmile=True),
            mixedResiduals=True, eliminateEqualities=False,
        )
        f64 = ct.conic_ip(*prob.args(), factor_dtype=None,
                          eliminateEqualities=False,
                          centralityCorrectors=0)
        assert plain.status == "Abandoned"  # the stall this feature fixes
        assert lm.status == "Optimal"
        assert max(lm.prFeas, lm.duFeas, lm.muFeas) < 1e-6
        # reactive trigger: one stalled f32 iteration to detect, one or two
        # full-precision iterations to finish — at most +2 over the f64
        # trajectory, and no ladder dispatch
        assert lm.Iter <= f64.Iter + 2


def test_proactive_lastmile_restores_f64_iteration_counts():
    # Production default (factor_dtype=f32, auto backend): the proactive
    # last-mile (lastmileProactive=50) enters the full-precision KKT
    # branch at 50x tolerance, so the f32 path matches the f64
    # trajectory's iteration count exactly instead of paying 1-2 wasted
    # stall-detection iterations.
    import jax.numpy as jnp

    from conicip_tpu.models.generators import many_small_socs, mixed_rqs

    for prob in (many_small_socs(), mixed_rqs()):
        prod = ct.conic_ip(*prob.args(), factor_dtype=jnp.float32,
                           optTol=1e-6)
        f64 = ct.conic_ip(*prob.args(), factor_dtype=None, optTol=1e-6)
        assert prod.status == "Optimal"
        assert max(prod.prFeas, prod.duFeas, prod.muFeas) < 1e-6
        assert prod.Iter <= f64.Iter


def test_gondzio_correctors_cut_iterations():
    # Gondzio multiple centrality correctors (EXTENDS the reference's
    # plain Mehrotra; solver/ipm.py) must preserve Optimal status and
    # accuracy while never increasing — and on equality-constrained mixes
    # markedly decreasing — the iteration count. The acceptance rule only
    # ever keeps a corrector that enlarged the steplength, so K>0 is
    # iteration-wise monotone vs K=0 on these families (measured:
    # box_qp_dense 8->7, mixed_rq_eq 14->9 at K=2).
    import jax.numpy as jnp

    from conicip_tpu.models.generators import box_qp_dense, mixed_rq_eq

    for fd in (None, jnp.float32):
        for prob, min_save in ((box_qp_dense(n=120), 0),
                               (mixed_rq_eq(), 3)):
            base = ct.conic_ip(*prob.args(), factor_dtype=fd,
                               centralityCorrectors=0)
            corr = ct.conic_ip(*prob.args(), factor_dtype=fd,
                               centralityCorrectors=2)
            assert corr.status == "Optimal"
            assert max(corr.prFeas, corr.duFeas, corr.muFeas) < 1e-6
            assert corr.Iter <= base.Iter - min_save, (
                f"{prob.name} fd={fd}: {base.Iter} -> {corr.Iter}")
            # both runs certify resid < 1e-6; the iterates themselves may
            # differ more (different trajectory endpoints) — compare the
            # certified objective instead
            np.testing.assert_allclose(
                float(corr.pobj), float(base.pobj),
                rtol=1e-5, atol=1e-5)


def test_gondzio_correctors_preserve_certificates():
    # correctors must not disturb infeasibility/unboundedness detection:
    # the acceptance rule only ever modifies the direction within an
    # iteration, and certificate normalization happens on the residual
    # side — statuses must match the plain-Mehrotra run
    n = 10
    rng = np.random.default_rng(0)
    A = np.vstack([np.eye(n), -np.eye(n)])
    s_inf = ct.conic_ip(np.eye(n), rng.standard_normal(n), A, np.ones(2*n),
                        [("R", 2*n)], centralityCorrectors=2)
    assert s_inf.status == "Infeasible"
    s_unb = ct.conic_ip(np.zeros((n, n)), np.ones(n), np.eye(n),
                        np.zeros(n), [("R", n)], centralityCorrectors=2)
    assert s_unb.status == "Unbounded"
