"""Structure-exploiting diagonal-Schur KKT solver (conicip_tpu/kkt/diag.py)
— the dense analogue of the reference's sparse-LU backend's role on
bound-constrained QPs (kktsolvers.jl:281-310)."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest

import conicip_tpu as ct
from conicip_tpu.cones.spec import ConeSpec
from conicip_tpu.kkt import kktsolver_diag, separable

OPT = 1e-6


@pytest.fixture
def box_qp(rng):
    n = 150
    Q = np.diag(1.0 + rng.random(n))
    c = rng.standard_normal(n)
    A = np.vstack([np.eye(n), -np.eye(n)])
    b = -np.ones(2 * n)
    return Q, c, A, b, [("R", 2 * n)]


def test_separable_detection(box_qp, rng):
    Q, c, A, b, cones = box_qp
    n = Q.shape[0]
    spec = ConeSpec(cones)
    assert separable(Q, A, np.zeros((0, n)), spec)
    # dense Q disqualifies
    Qd = Q + 0.01 * rng.standard_normal((n, n))
    assert not separable(Qd, A, np.zeros((0, n)), spec)
    # two nonzeros in a row disqualify
    A2 = A.copy()
    A2[0, 1] = 0.5
    assert not separable(Q, A2, np.zeros((0, n)), spec)
    # SOC cones disqualify
    assert not separable(Q, A, np.zeros((0, n)), ConeSpec([("R", n), ("Q", n)]))


@pytest.mark.parametrize("fd", [None, jnp.float32])
def test_matches_dense_backend(box_qp, fd):
    Q, c, A, b, cones = box_qp
    kkt = functools.partial(kktsolver_diag, factor_dtype=fd)
    sol = ct.conic_ip(Q, c, A, b, cones, kktsolver=kkt)
    ref = ct.conic_ip(Q, c, A, b, cones)
    assert sol.status == ref.status == "Optimal"
    assert max(sol.prFeas, sol.duFeas, sol.muFeas) < OPT
    assert np.linalg.norm(sol.y - ref.y) < 1e-5


def test_scaled_and_sparse_rows(rng):
    # rows with arbitrary single coefficients, some zero rows of A absent,
    # upper+lower bounds with mixed scales
    n = 60
    Q = np.diag(0.5 + rng.random(n))
    c = rng.standard_normal(n)
    scales = 1.0 + 2.0 * rng.random(n)
    A = np.vstack([np.diag(scales), -np.diag(scales[::-1])[::-1]])
    b = np.concatenate([-scales, -2 * np.ones(n)])
    kkt = functools.partial(kktsolver_diag, factor_dtype=jnp.float32)
    sol = ct.conic_ip(Q, c, A, b, [("R", 2 * n)], kktsolver=kkt)
    ref = ct.conic_ip(Q, c, A, b, [("R", 2 * n)])
    assert sol.status == "Optimal"
    assert np.linalg.norm(sol.y - ref.y) < 1e-5


def test_with_equalities(box_qp, rng):
    Q, c, A, b, cones = box_qp
    n = Q.shape[0]
    G = np.zeros((3, n))
    G[0, 0], G[1, 5], G[2, 7] = 1.0, 1.0, 2.0
    d = np.array([0.5, 0.25, 0.5])
    kkt = functools.partial(kktsolver_diag, factor_dtype=jnp.float32)
    sol = ct.conic_ip(Q, c, A, b, cones, G, d, kktsolver=kkt,
                      eliminateEqualities=False)
    assert sol.status == "Optimal"
    assert np.linalg.norm(G @ sol.y - d) < 1e-7
    ref = ct.conic_ip(Q, c, A, b, cones, G, d)
    assert np.linalg.norm(sol.y - ref.y) < 1e-4


def test_with_dense_equality_row(box_qp, rng):
    # A dense budget row sum(y) = 1 makes GᵀG dense: the diagonal-only
    # augmentation was measurably wrong here (advisor round-1 high finding);
    # the Woodbury mode must match the dense Schur backend exactly.
    Q, c, A, b, cones = box_qp
    n = Q.shape[0]
    G = np.vstack([np.ones(n), rng.standard_normal(n)])
    d = np.array([1.0, 0.3])
    ref = ct.conic_ip(Q, c, A, b, cones, G, d)
    assert ref.status == "Optimal"
    for fd in (None, jnp.float32):
        kkt = functools.partial(kktsolver_diag, factor_dtype=fd,
                                eq_mode="woodbury")
        sol = ct.conic_ip(Q, c, A, b, cones, G, d, kktsolver=kkt,
                          eliminateEqualities=False)
        assert sol.status == "Optimal"
        assert max(sol.prFeas, sol.duFeas, sol.muFeas) < OPT
        assert np.linalg.norm(G @ sol.y - d) < 1e-6
        # two Optimal-at-1e-6 trajectories agree to ~sqrt(mu) in y and
        # much tighter in objective
        assert np.linalg.norm(sol.y - ref.y) < 5e-3
        assert abs(sol.pobj - ref.pobj) < 1e-4 * (1 + abs(ref.pobj))


def test_auto_backend_dense_equality_correct(box_qp):
    # Default-path end-to-end repro of the advisor's round-1 high finding:
    # box QP + dense budget row under default settings must be Optimal.
    Q, c, A, b, cones = box_qp
    n = Q.shape[0]
    G = np.ones((1, n))
    d = np.array([1.0])
    sol = ct.conic_ip(Q, c, A, b, cones, G, d)
    assert sol.status == "Optimal"
    assert max(sol.prFeas, sol.duFeas, sol.muFeas) < OPT
    assert abs(float(np.sum(sol.y)) - 1.0) < 1e-6


def test_equality_mode_detection(box_qp):
    from conicip_tpu.kkt.diag import equality_mode

    Q, c, A, b, cones = box_qp
    n = Q.shape[0]
    assert equality_mode(Q, None) == "none"
    assert equality_mode(Q, np.zeros((0, n))) == "none"
    Gd = np.zeros((2, n))
    Gd[0, 0], Gd[1, 4] = 1.0, 2.0
    assert equality_mode(Q, Gd) == "disjoint"
    # a single dense row is NOT disjoint (GᵀG = ggᵀ is dense) but Q's
    # positive diagonal admits the Woodbury mode
    assert equality_mode(Q, np.ones((1, n))) == "woodbury"
    # rank-deficient diagonal disqualifies Woodbury -> dense fallback
    Q0 = Q.copy()
    Q0[0, 0] = 0.0
    assert equality_mode(Q0, np.ones((1, n))) is None
    from conicip_tpu.kkt import separable
    from conicip_tpu.cones.spec import ConeSpec

    assert not separable(Q0, A, np.ones((1, n)), ConeSpec(cones))


def test_rejects_soc():
    with pytest.raises(ValueError, match="R cones only"):
        kktsolver_diag(
            jnp.eye(4), jnp.eye(4), jnp.zeros((0, 4)), ConeSpec([("Q", 4)])
        )


def test_default_backend_auto_selects_diag(box_qp):
    # conic_ip with kktsolver=None must pick the diagonal-Schur backend on
    # separable problems and the dense Schur path otherwise
    import jax.numpy as jnp

    from conicip_tpu.cones.spec import ConeSpec
    from conicip_tpu.solver import (_auto_kktsolver, _default_kktsolver,
                                    _diag_kktsolver)

    Q, c, A, b, cones = box_qp
    spec = ConeSpec(cones)
    assert _auto_kktsolver(Q, A, np.zeros((0, len(c))), spec,
                           jnp.float32) is _diag_kktsolver(jnp.float32)

    rng = np.random.default_rng(0)
    Ad = rng.standard_normal(A.shape)  # dense rows -> not separable
    assert _auto_kktsolver(Q, Ad, np.zeros((0, len(c))), spec,
                           jnp.float32) is _default_kktsolver(
                               jnp.float32, lastmile=True)

    # end-to-end through the default path
    import conicip_tpu as ct
    sol = ct.conic_ip(Q, c, A, b, cones, factor_dtype=jnp.float32)
    assert sol.status == "Optimal"
    assert max(sol.prFeas, sol.duFeas, sol.muFeas) < 1e-6
