"""ops/cholesky: the factorization, explicit triangular inverse and solve
that the dense Schur path (kkt/schur.py) runs every iteration, against
numpy, in both precisions the solver uses."""

import jax.numpy as jnp
import numpy as np
import pytest

from conicip_tpu.ops.cholesky import CholFactor, cho_solve, cholesky, tri_inv

# relative accuracy expected of a well-conditioned factorization
_EPS = {"float32": 1e-5, "float64": 1e-13}


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("n", [1, 9, 96, 257, 512])
def test_cholesky_tri_inv_cho_solve_match_numpy(rng, n, dtype):
    B = rng.standard_normal((n, n))
    M = B @ B.T / n + np.eye(n)
    r = rng.standard_normal(n)
    eps = _EPS[dtype]

    L = cholesky(jnp.asarray(M, dtype))
    assert L.dtype == jnp.dtype(dtype)
    Lh = np.asarray(L, np.float64)
    assert np.allclose(np.triu(Lh, 1), 0.0)
    assert np.linalg.norm(Lh @ Lh.T - M) <= eps * np.linalg.norm(M)
    assert np.allclose(Lh, np.linalg.cholesky(M), atol=10 * eps)

    W = np.asarray(tri_inv(L), np.float64)
    assert np.linalg.norm(W @ Lh - np.eye(n)) <= eps * np.sqrt(n)

    x = np.asarray(cho_solve(L, jnp.asarray(r, dtype)), np.float64)
    assert np.linalg.norm(M @ x - r) <= eps * np.linalg.norm(M) * (
        np.linalg.norm(x))


def test_cholesky_factor_dtype_cast_and_cholfactor(rng):
    n = 40
    B = rng.standard_normal((n, n))
    M = jnp.asarray(B @ B.T / n + np.eye(n))
    f = CholFactor(M, factor_dtype=jnp.float32)
    assert f.L.dtype == jnp.float32
    r = jnp.asarray(rng.standard_normal(n))
    x = f.solve(r)
    assert x.dtype == r.dtype  # solves return the right-hand side's dtype
    assert np.allclose(np.asarray(M @ x), np.asarray(r), atol=1e-4)
