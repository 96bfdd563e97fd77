"""kkt/lu.py: the dense LU of the full 3x3 saddle system factors in the
working dtype (f64 unless ``factor_dtype`` asks for another)."""

import jax.numpy as jnp
import numpy as np
import pytest

from conicip_tpu.cones import nt_inv_adjoint, nt_scaling
from conicip_tpu.cones import scaling as sc
from conicip_tpu.cones.spec import ConeSpec, tri_dim
from conicip_tpu.kkt import kktsolver_lu

from test_cones import interior_point


@pytest.mark.parametrize("dims", [
    [("R", 6)],
    [("R", 4), ("Q", 3), ("S", tri_dim(3))],
])
def test_kktsolver_lu_solves_in_f64(rng, dims):
    spec = ConeSpec(dims)
    m, n, p = spec.m, 5, 2
    B = rng.standard_normal((n, n))
    Q = B @ B.T + np.eye(n)
    A = rng.standard_normal((m, n))
    G = rng.standard_normal((p, n))
    F = nt_scaling(spec, jnp.asarray(interior_point(rng, spec)),
                   jnp.asarray(interior_point(rng, spec)))
    solve = kktsolver_lu(jnp.asarray(Q), jnp.asarray(A), jnp.asarray(G),
                         spec)(F, nt_inv_adjoint(spec, F))
    x, y, z = (rng.standard_normal(k) for k in (n, p, m))
    a, b, c = solve(jnp.asarray(x), jnp.asarray(y), jnp.asarray(z))
    assert a.dtype == b.dtype == c.dtype == jnp.float64

    W2 = np.asarray(sc.dense_gram(spec, F))
    K = np.block([[Q, G.T, -A.T],
                  [G, np.zeros((p, p)), np.zeros((p, m))],
                  [A, np.zeros((m, p)), W2]])
    u = np.concatenate([np.asarray(a), np.asarray(b), np.asarray(c)])
    rhs = np.concatenate([x, y, z])
    # an f32 factorization would leave ~1e-7 of this residual
    assert np.linalg.norm(K @ u - rhs) <= 1e-12 * np.linalg.norm(K) * (
        np.linalg.norm(u))
