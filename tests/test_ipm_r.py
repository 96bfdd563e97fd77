"""End-to-end IPM tests on R (nonnegative-orthant) cones — Phase 1.

Mirrors the reference's integration tests (test/runtests.jl:90-523) with
tolerance-based checks instead of Julia-RNG-specific golden residuals
(per SURVEY.md §4: golden dictionaries are trajectory-specific; analytic
answers + status + residual tolerances are the portable assets).
"""

import numpy as np
import pytest

import jax.numpy as jnp

import conicip_tpu as ct
from conicip_tpu.kkt import kktsolver_lu, kktsolver_qr, kktsolver_schur

OPT_TOL = 1e-7
TOL = 1e-3

SOLVERS = {
    "schur": kktsolver_schur,
    "qr": kktsolver_qr,
    "lu": kktsolver_lu,
}


def P_box(t, x):
    return np.sign(x) * np.minimum(np.abs(x), t)


def optcond(x, P, grad):
    return np.linalg.norm(x - P(x - grad(x))) / len(x)


@pytest.mark.parametrize("solver", SOLVERS)
def test_box_qp(solver):
    # Box-constrained QP (test/runtests.jl:90-131): min ½yᵀHy − (Hc)ᵀy
    # s.t. -1 ≤ y ≤ 1 — the projection of c onto the box under metric H.
    n = 100
    H = 0.5 * np.eye(n)
    c = np.arange(1.0, n + 1)
    A = np.vstack([np.eye(n), -np.eye(n)])
    b = -np.ones(2 * n)

    sol = ct.conic_ip(
        H, H @ c, A, b, [("R", 2 * n)],
        kktsolver=SOLVERS[solver], optTol=OPT_TOL,
    )
    assert sol.status == "Optimal"
    assert optcond(sol.y, lambda x: P_box(1, x), lambda x: H @ (x - c)) < TOL
    # c[0] == 1.0 sits exactly on the box boundary (degenerate coordinate,
    # converges only as sqrt(optTol)) — compare the non-degenerate rest.
    np.testing.assert_allclose(sol.y[1:], P_box(1, c)[1:], atol=TOL)
    assert max(sol.prFeas, sol.duFeas, sol.muFeas) < OPT_TOL


@pytest.mark.parametrize("solver", SOLVERS)
def test_simplex_projection(solver):
    # Projection onto the simplex (test/runtests.jl:208-244): answer e_n.
    n = 10
    H = np.eye(n)
    c = np.arange(1.0, n + 1)
    A = np.eye(n)
    b = np.zeros(n)
    G = np.ones((1, n))
    d = np.array([1.0])

    sol = ct.conic_ip(H, H @ c, A, b, [("R", n)], G, d,
                      kktsolver=SOLVERS[solver], optTol=OPT_TOL)
    assert sol.status == "Optimal"
    expect = np.zeros(n)
    expect[-1] = 1.0
    np.testing.assert_allclose(sol.y, expect, atol=TOL)


@pytest.mark.parametrize("solver", SOLVERS)
def test_simplex_dense_h(solver, rng):
    # Dense rank-1-plus-regularization H (test/runtests.jl:271-303)
    n = 10
    h = rng.standard_normal(n)
    H = np.outer(h, h) + 1e-8 * np.eye(n)
    c = np.arange(1.0, n + 1)
    sol = ct.conic_ip(H, H @ c, np.eye(n), np.zeros(n), [("R", n)],
                      np.ones((1, n)), np.array([1.0]),
                      kktsolver=SOLVERS[solver], optTol=OPT_TOL)
    assert sol.status == "Optimal"
    assert max(sol.prFeas, sol.muFeas) < OPT_TOL


@pytest.mark.parametrize("solver", SOLVERS)
def test_equality_folding_equivalence(solver, rng):
    # Metamorphic test (test/runtests.jl:328-356): equalities expressed as
    # paired inequalities must give the same solution.
    n = 10
    h = rng.standard_normal(n)
    H = np.outer(h, h) + 1e-6 * np.eye(n)
    c = np.arange(1.0, n + 1)
    A = np.eye(n)
    b = np.zeros(n)
    G = rng.random((6, n))
    d = np.zeros(6)

    y1 = ct.conic_ip(H, H @ c, A, b, [("R", n)], G, d,
                     kktsolver=SOLVERS[solver], optTol=OPT_TOL).y
    A2 = np.vstack([A, G, -G])
    b2 = np.concatenate([b, d, -d])
    y2 = ct.conic_ip(H, H @ c, A2, b2, [("R", n + 12)], G, d,
                     optTol=OPT_TOL).y
    np.testing.assert_allclose(y1, y2, atol=TOL)


@pytest.mark.parametrize("solver", SOLVERS)
def test_abandoned(solver):
    n = 10
    H = np.eye(n)
    c = np.arange(1.0, n + 1)
    sol = ct.conic_ip(H, H @ c, np.eye(n), np.zeros(n), [("R", n)],
                      np.ones((1, n)), np.array([1.0]),
                      kktsolver=SOLVERS[solver], optTol=OPT_TOL, maxIters=2)
    assert sol.status == "Abandoned"


@pytest.mark.parametrize("solver", SOLVERS)
def test_infeasible(solver, rng):
    # y ≥ 1 and -y ≥ 1 simultaneously (test/runtests.jl:441-459)
    n = 10
    h = rng.standard_normal(n)
    H = np.outer(h, h)
    c = np.arange(1.0, n + 1)
    A = np.vstack([np.eye(n), -np.eye(n)])
    b = np.ones(2 * n)
    sol = ct.conic_ip(H, H @ c, A, b, [("R", 2 * n)],
                      kktsolver=SOLVERS[solver], optTol=OPT_TOL)
    assert sol.status == "Infeasible"
    # Farkas certificate is returned in v with NaN primal
    assert np.all(np.isnan(sol.y))


@pytest.mark.parametrize("solver", SOLVERS)
def test_infeasible_equalities(solver, rng):
    # y₁ = -1 with y ≥ 0 (test/runtests.jl:462-485)
    n = 10
    h = rng.standard_normal(n)
    H = np.outer(h, h)
    c = np.arange(1.0, n + 1)
    G = np.zeros((1, n))
    G[0, 0] = 1.0
    sol = ct.conic_ip(H, H @ c, np.eye(n), np.zeros(n), [("R", n)],
                      G, np.array([-1.0]),
                      kktsolver=SOLVERS[solver], optTol=OPT_TOL)
    assert sol.status == "Infeasible"


@pytest.mark.parametrize("solver", SOLVERS)
def test_unbounded(solver):
    # min −cᵀy over y ≥ 0 with c > 0 (test/runtests.jl:487-505)
    n = 10
    H = np.zeros((n, n))
    c = np.arange(1.0, n + 1)
    sol = ct.conic_ip(H, c, np.eye(n), np.zeros(n), [("R", n)],
                      kktsolver=SOLVERS[solver], optTol=OPT_TOL)
    assert sol.status == "Unbounded"
    assert np.all(np.isnan(sol.v))


def test_bad_input():
    n = 10
    with pytest.raises(ValueError):
        ct.conic_ip(np.zeros((n, n)), np.arange(1.0, n + 1),
                    np.eye(n + 2), np.zeros(n), [("R", n)])


def test_custom_kktsolver_plugin():
    # The reference's signature capability: a problem-specific diagonal 2x2
    # solver injected through pivot() (test/runtests.jl:102-116).
    from conicip_tpu.kkt import pivot

    n = 200
    H = 0.5 * np.eye(n)
    Hj = jnp.asarray(H)
    c = np.arange(1.0, n + 1)
    A = np.vstack([np.eye(n), -np.eye(n)])
    b = -np.ones(2 * n)

    def kktsolver_2x2_box(Q, A_, G, spec):
        def solve2x2gen(F, FinvT):
            # F is diagonal here: (FᵀF)⁻¹ = diag(1/r_d²), split into the
            # two stacked identity blocks of A.
            vinv = 1.0 / (F.r_d * F.r_d)
            D = vinv[:n] + vinv[n:]
            invHD = 1.0 / (jnp.diag(Hj) + D)

            def solve2x2(rhs, rhs2):
                return invHD * rhs, rhs2[:0]

            return solve2x2

        return solve2x2gen

    sol = ct.conic_ip(H, H @ c, A, b, [("R", 2 * n)],
                      kktsolver=pivot(kktsolver_2x2_box), optTol=OPT_TOL)
    assert sol.status == "Optimal"
    assert optcond(sol.y, lambda x: P_box(1, x), lambda x: H @ (x - c)) < TOL


def test_factor_dtype_auto_resolution(monkeypatch):
    # "auto" is full precision on every backend: the backend is not
    # consulted at all. The f32 regime is an explicit opt-in.
    import jax
    import jax.numpy as jnp

    from conicip_tpu.solver import resolve_factor_dtype

    assert resolve_factor_dtype("auto") is None  # tests run on CPU
    for backend in ("gpu", "cuda", "cpu"):
        monkeypatch.setattr(jax, "default_backend", lambda: backend)
        assert resolve_factor_dtype("auto") is None
    assert resolve_factor_dtype(jnp.float32) == jnp.float32
    # explicit values pass through untouched
    assert resolve_factor_dtype(None) is None
    assert resolve_factor_dtype(jnp.float64) == jnp.float64
    import pytest as _pytest

    with _pytest.raises(ValueError):
        resolve_factor_dtype("fast")
