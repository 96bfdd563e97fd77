"""Unit tests for the cone algebra layer (Phase 0).

Property-tests the batched kernels against dense reference math, mirroring
the reference's operator-algebra unit tests (test/runtests.jl:27-87) without
relying on its Julia-RNG-specific golden values.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from conicip_tpu import ConeSpec, cone_div, cone_prod, mat, maxstep, maxstep_to_cone, vecm
from conicip_tpu.cones import nt_inv_adjoint, nt_scaling, scaling
from conicip_tpu.cones.algebra import lyap_solve
from conicip_tpu.cones.spec import tri_dim


def random_symmetric(rng, d):
    X = rng.standard_normal((d, d))
    return (X + X.T) / 2


def random_spd(rng, d):
    X = rng.standard_normal((d, d))
    return X @ X.T + d * np.eye(d)


def interior_point(rng, spec):
    """Random point strictly inside the cone product."""
    x = np.zeros(spec.m)
    x[spec.r_idx] = rng.uniform(0.5, 2.0, size=spec.nr)
    for g in spec.soc_groups:
        for i in range(g.count):
            tail = rng.standard_normal(g.dim - 1)
            head = np.linalg.norm(tail) + rng.uniform(0.5, 2.0)
            x[g.idx[i]] = np.concatenate([[head], tail])
    for g in spec.sdp_groups:
        for i in range(g.count):
            x[g.idx[i]] = np.asarray(vecm(jnp.asarray(random_spd(rng, g.order))))
    return x


MIXED = [("R", 4), ("Q", 3), ("Q", 5), ("Q", 3), ("S", tri_dim(3)), ("R", 2)]


def test_vecm_mat_roundtrip(rng):
    for d in [1, 2, 3, 6]:
        X = random_symmetric(rng, d)
        x = vecm(jnp.asarray(X))
        assert x.shape == (tri_dim(d),)
        np.testing.assert_allclose(np.asarray(mat(x)), X, atol=1e-12)
        # trace inner product identity: dot(vecm X, vecm Y) == tr(XY)
        Y = random_symmetric(rng, d)
        y = vecm(jnp.asarray(Y))
        np.testing.assert_allclose(float(jnp.dot(x, y)), np.trace(X @ Y), atol=1e-10)


def test_vecm_reference_example():
    # From the reference docstring (ConicIP.jl:128-133):
    # vecm([1 2 3; 2 4 5; 3 5 6]) = [1, 2√2, 3√2, 4, 5√2, 6]
    Z = jnp.asarray([[1.0, 2, 3], [2, 4, 5], [3, 5, 6]])
    expect = np.array([1, 2 * np.sqrt(2), 3 * np.sqrt(2), 4, 5 * np.sqrt(2), 6])
    np.testing.assert_allclose(np.asarray(vecm(Z)), expect, atol=1e-12)


def test_cone_prod_div_inverse(rng):
    spec = ConeSpec(MIXED)
    x = interior_point(rng, spec)
    y = interior_point(rng, spec)
    p = cone_prod(spec, jnp.asarray(x), jnp.asarray(y))
    # cone_div(p, y) solves y ∘ o = p, so o == x
    o = cone_div(spec, p, jnp.asarray(y))
    np.testing.assert_allclose(np.asarray(o), x, atol=1e-8)


def test_cone_prod_identity(rng):
    # NOTE reference quirk: the S-cone product is XY+YX *unscaled*
    # (xsdc!, ConicIP.jl:355-360), i.e. 2x the canonical Jordan product,
    # so e ∘ x = 2x on S blocks and = x on R/Q blocks. We mirror it exactly
    # (the IPM equations are self-consistent under this scaling).
    spec = ConeSpec(MIXED)
    x = interior_point(rng, spec)
    e = jnp.asarray(spec.identity)
    expect = x.copy()
    for g in spec.sdp_groups:
        expect[g.idx] *= 2.0
    np.testing.assert_allclose(
        np.asarray(cone_prod(spec, e, jnp.asarray(x))), expect, atol=1e-10
    )


def test_lyap_solve(rng):
    Y = jnp.asarray(random_spd(rng, 5))
    X = jnp.asarray(random_symmetric(rng, 5))
    O = lyap_solve(Y, X)
    np.testing.assert_allclose(np.asarray(Y @ O + O @ Y), np.asarray(X), atol=1e-9)


def test_maxstep_r():
    spec = ConeSpec([("R", 3)])
    x = jnp.asarray([1.0, 2.0, 3.0])
    d = jnp.asarray([0.5, -1.0, 3.0])
    # sup α : x - αd ≥ 0 → min over d>0 of x/d = min(2, 1) = 1
    assert float(maxstep(spec, x, d)) == pytest.approx(1.0)
    # no positive d → unbounded step
    assert float(maxstep(spec, x, -d + -1.0)) == np.inf


def test_maxstep_boundary_consistency(rng):
    # For each cone type: x - α*d must be (just) on the boundary at α = maxstep.
    for dims in [[("R", 5)], [("Q", 4)], [("S", tri_dim(4))], [*MIXED]]:
        spec = ConeSpec(dims)
        x = interior_point(rng, spec)
        d = rng.standard_normal(spec.m)
        a = float(maxstep(spec, jnp.asarray(x), jnp.asarray(d)))
        if np.isinf(a):
            continue
        xb = x - (a * (1 - 1e-9)) * d
        # strictly inside just before the boundary:
        assert float(maxstep_to_cone(spec, jnp.asarray(xb))) == pytest.approx(0.0)
        xa = x - (a * (1 + 1e-6)) * d
        assert float(maxstep_to_cone(spec, jnp.asarray(xa))) < 0.0


def test_maxstep_sdc_infinite():
    # Reference edge case (test/runtests.jl:79-82): X = -I is not PD → Inf.
    spec = ConeSpec([("S", tri_dim(3))])
    x = vecm(jnp.asarray(-np.eye(3)))
    d = vecm(jnp.asarray(np.eye(3)))
    assert float(maxstep(spec, x, d)) == np.inf


def test_nt_scaling_property(rng):
    # Defining property: F z = F⁻ᵀ s = λ  (ConicIP.jl:589-605)
    spec = ConeSpec(MIXED)
    z = interior_point(rng, spec)
    s = interior_point(rng, spec)
    F = nt_scaling(spec, jnp.asarray(z), jnp.asarray(s))
    FinvT = nt_inv_adjoint(spec, F)
    lam1 = scaling.apply(spec, F, jnp.asarray(z))
    lam2 = scaling.apply(spec, FinvT, jnp.asarray(s))
    np.testing.assert_allclose(np.asarray(lam1), np.asarray(lam2), atol=1e-8)
    # λ must be in the cone interior
    assert float(maxstep_to_cone(spec, lam1)) == pytest.approx(0.0)


@pytest.mark.parametrize("d", [2, 5, 10, 30])
def test_sdp_nt_scaling_svd_form(rng, d):
    # The S-cone scaling is built from chol(Z), chol(S) and the SVD of
    # LzᵀLs (nestod_sdc, ConicIP.jl:196-210): F z = F⁻ᵀ s = λ with mat(λ)
    # diagonal and equal to the carried singular values, and the carried
    # closed-form S⁻¹ inverting S.
    spec = ConeSpec([("S", tri_dim(d))])
    z = jnp.asarray(interior_point(rng, spec))
    s = jnp.asarray(interior_point(rng, spec))
    F = nt_scaling(spec, z, s)
    lam1 = np.asarray(scaling.apply(spec, F, z))
    lam2 = np.asarray(scaling.apply(spec, nt_inv_adjoint(spec, F), s))
    scale = np.linalg.norm(lam1)
    assert np.linalg.norm(lam1 - lam2) <= 1e-10 * scale
    lam = np.asarray(F.sdp[0].lam[0])
    assert np.all(lam > 0)
    np.testing.assert_allclose(np.asarray(mat(jnp.asarray(lam1))),
                               np.diag(lam), atol=1e-10 * scale)
    S, Sinv = np.asarray(F.sdp[0].S[0]), np.asarray(F.sdp[0].Sinv[0])
    np.testing.assert_allclose(S @ Sinv, np.eye(d), atol=1e-9)


def _dense(spec, apply_fn, F, m, dtype=jnp.float64):
    cols = [apply_fn(spec, F, jnp.eye(m, dtype=dtype)[:, i]) for i in range(m)]
    return np.stack([np.asarray(c) for c in cols], axis=1)


def test_scaling_apply_consistency(rng):
    spec = ConeSpec(MIXED)
    z = interior_point(rng, spec)
    s = interior_point(rng, spec)
    F = nt_scaling(spec, jnp.asarray(z), jnp.asarray(s))
    FinvT = nt_inv_adjoint(spec, F)

    Fd = _dense(spec, scaling.apply, F, spec.m)
    FdT = _dense(spec, scaling.apply_adjoint, F, spec.m)
    np.testing.assert_allclose(FdT, Fd.T, atol=1e-9)

    FinvTd = _dense(spec, scaling.apply, FinvT, spec.m)
    np.testing.assert_allclose(FinvTd, np.linalg.inv(Fd).T, atol=1e-8)

    # matrix application == columnwise application
    A = rng.standard_normal((spec.m, 7))
    np.testing.assert_allclose(
        np.asarray(scaling.apply_mat(spec, F, jnp.asarray(A))), Fd @ A, atol=1e-9
    )
    np.testing.assert_allclose(
        np.asarray(scaling.apply_adjoint_mat(spec, F, jnp.asarray(A))),
        Fd.T @ A,
        atol=1e-9,
    )


def test_identity_scaling(rng):
    from conicip_tpu.cones import nt_identity

    spec = ConeSpec(MIXED)
    F = nt_identity(spec)
    x = jnp.asarray(rng.standard_normal(spec.m))
    np.testing.assert_allclose(np.asarray(scaling.apply(spec, F, x)), np.asarray(x))
    np.testing.assert_allclose(
        np.asarray(scaling.apply_adjoint(spec, F, x)), np.asarray(x)
    )


def test_dense_gram_matches_dense_square():
    # FᵀF assembled block-diagonally (scaling.dense_gram) must equal the
    # dense square for a full R+Q+S mix
    import jax.numpy as jnp

    from conicip_tpu.cones import scaling as sc
    from conicip_tpu.cones.spec import ConeSpec

    spec = ConeSpec([("R", 5), ("Q", 4), ("Q", 4), ("S", 10), ("S", 6)])
    rng = np.random.default_rng(0)
    e = np.asarray(spec.identity)
    z = e + 0.1 * rng.standard_normal(spec.m)
    s = e + 0.1 * rng.standard_normal(spec.m)
    F = sc.nt_scaling(spec, jnp.asarray(z), jnp.asarray(s))
    Fd = np.asarray(sc.dense(spec, F))
    np.testing.assert_allclose(
        np.asarray(sc.dense_gram(spec, F)), Fd.T @ Fd, atol=1e-12,
        rtol=1e-10)


# ── Gondzio centrality correction (EXTENDS the reference; solver/ipm.py) ──


def test_centrality_correction_r():
    from conicip_tpu.cones.algebra import centrality_correction

    spec = ConeSpec([("R", 5)])
    w = jnp.asarray([0.05, 0.5, 1.0, 15.0, 200.0])
    q = np.asarray(centrality_correction(spec, w, 0.1, 10.0))
    # inside [lo, hi] -> 0; below -> lifted to lo; above -> pushed to hi,
    # floor-clamped at -hi
    np.testing.assert_allclose(q, [0.05, 0.0, 0.0, -5.0, -10.0], atol=1e-12)


def test_centrality_correction_spectral(rng):
    """Q and S corrections are the componentwise clip of the SPECTRAL
    values: eigenvalues of mat(w + q) must land where a scalar clip of
    mat(w)'s eigenvalues would (up to the -hi floor clamp)."""
    from conicip_tpu.cones.algebra import centrality_correction

    spec = ConeSpec([("Q", 4), ("S", tri_dim(3))])
    w = np.zeros(spec.m)
    w[:4] = [1.0, 0.3, -0.2, 0.6]  # SOC eigenvalues 1 ± 0.7
    S = random_symmetric(rng, 3) * 3.0
    w[4:] = np.asarray(vecm(jnp.asarray(S)))
    lo, hi = 0.5, 2.0
    q = np.asarray(centrality_correction(spec, jnp.asarray(w), lo, hi))

    def clipped(lmb):
        return lmb + np.maximum(np.clip(lmb, lo, hi) - lmb, -hi)

    # SOC block
    soc = w[:4] + q[:4]
    nrm = np.linalg.norm(w[1:4])
    got = np.array([soc[0] + np.linalg.norm(soc[1:]) * np.sign(
        np.dot(soc[1:], w[1:4])) if np.linalg.norm(soc[1:]) else soc[0],
        soc[0] - np.linalg.norm(soc[1:]) * np.sign(np.dot(soc[1:], w[1:4]))
        if np.linalg.norm(soc[1:]) else soc[0]])
    want = clipped(np.array([w[0] + nrm, w[0] - nrm]))
    np.testing.assert_allclose(np.sort(got), np.sort(want), atol=1e-10)
    # SDP block: eigenvalues of the corrected matrix = clipped eigenvalues
    M = np.asarray(mat(jnp.asarray(w[4:] + q[4:])))
    np.testing.assert_allclose(
        np.linalg.eigvalsh(M), clipped(np.linalg.eigvalsh(S)), atol=1e-10
    )


def test_centrality_correction_zero_inside(rng):
    from conicip_tpu.cones.algebra import centrality_correction

    spec = ConeSpec([("R", 3), ("Q", 3), ("S", tri_dim(2))])
    e = jnp.asarray(spec.identity)
    # w = e has all spectral values 1, inside [0.1, 10] -> q = 0
    q = np.asarray(centrality_correction(spec, e, 0.1, 10.0))
    np.testing.assert_allclose(q, 0.0, atol=1e-12)
