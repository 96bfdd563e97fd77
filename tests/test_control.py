"""vmap-safe conditional execution (ops/control.py).

Semantics tests for ``cond_once`` / ``retry_while``, and the per-element
behaviour under ``vmap`` of the factorizations that the escalating-ridge
retries in kkt/schur.py guard (a vmapped ``lax.cond`` executes BOTH
branches for every element, so each instance must stand on its own).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import conicip_tpu  # noqa: F401  (x64 on)
from conicip_tpu.ops.cholesky import cholesky, tri_inv
from conicip_tpu.ops.control import cond_once, retry_while


def _spd(n, rng, cond=None):
    B = rng.standard_normal((n, n))
    if cond is None:
        return B @ B.T / n + np.eye(n)
    U, _ = np.linalg.qr(B)
    w = np.logspace(0, -np.log10(cond), n)
    return (U * w) @ U.T


def test_cond_once_false_keeps_default():
    calls = []

    def fn():
        calls.append(1)
        return jnp.ones(3)

    out = cond_once(jnp.bool_(False), fn, jnp.zeros(3))
    # fn is traced (shape inference) but the runtime value is the default
    assert np.allclose(np.asarray(out), 0.0)


def test_cond_once_true_runs_branch():
    out = cond_once(jnp.bool_(True), lambda: jnp.ones(3), jnp.zeros(3))
    assert np.allclose(np.asarray(out), 1.0)


def test_cond_once_under_vmap_mixed_predicates():
    def f(pred, x):
        return cond_once(pred, lambda: x + 100.0, x)

    preds = jnp.asarray([True, False, True, False])
    xs = jnp.arange(4.0)
    out = np.asarray(jax.vmap(f)(preds, xs))
    assert np.allclose(out, [100.0, 1.0, 102.0, 3.0])


def test_cond_once_under_jit_and_pytree_default():
    @jax.jit
    def f(pred, x):
        return cond_once(pred, lambda: (x * 2, x * 3), (x, x))

    a, b = f(jnp.bool_(True), jnp.asarray(2.0))
    assert float(a) == 4.0 and float(b) == 6.0
    a, b = f(jnp.bool_(False), jnp.asarray(2.0))
    assert float(a) == 2.0 and float(b) == 2.0


def test_retry_while_escalates_until_good():
    # "factorization" that only succeeds once the scale reaches 1e6
    def step(scale):
        return jnp.where(scale >= 1e6, scale, jnp.nan)

    out = retry_while(
        lambda s: ~jnp.isfinite(s),
        step,
        jnp.asarray(jnp.nan),  # first attempt failed
        jnp.asarray(1e3),
        1e3,
        1e7,
    )
    assert float(out) == 1e6


def test_retry_while_healthy_path_keeps_first_attempt():
    out = retry_while(
        lambda s: ~jnp.isfinite(s),
        lambda scale: jnp.asarray(-1.0),
        jnp.asarray(7.0),
        jnp.asarray(1e3),
        1e3,
        1e7,
    )
    assert float(out) == 7.0


def test_retry_while_gives_up_at_cap():
    out = retry_while(
        lambda s: ~jnp.isfinite(s),
        lambda scale: jnp.asarray(jnp.nan),
        jnp.asarray(jnp.nan),
        jnp.asarray(1e3),
        1e3,
        1e7,
    )
    assert not np.isfinite(float(out))


@pytest.mark.parametrize("n", [55, 200])
def test_cholesky_under_vmap(rng, n):
    # the batched solvers vmap the factorization: each element must match
    # its own unbatched factor
    Ms = jnp.asarray(np.stack([_spd(n, rng) for _ in range(4)]))
    L = jax.vmap(cholesky)(Ms)
    for i in range(4):
        Lref = np.linalg.cholesky(np.asarray(Ms[i]))
        assert np.allclose(np.asarray(L[i]), Lref, atol=1e-11)


def test_tri_inv_under_vmap_mixed_conditioning(rng):
    # one well-conditioned + one κ(L)~1e5 instance in the same batch:
    # each element's inverse must be accurate to its own conditioning
    n = 160
    M0 = _spd(n, rng)
    M1 = _spd(n, rng, cond=1e10)
    Ls = jax.vmap(cholesky)(jnp.asarray(np.stack([M0, M1])))
    W = jax.vmap(tri_inv)(Ls)
    for i in range(2):
        resid = np.max(np.abs(
            np.asarray(W[i]) @ np.asarray(Ls[i]) - np.eye(n)
        ))
        assert resid < 1e-9, f"instance {i}: {resid}"


def test_cholesky_vmap_nan_isolation(rng):
    # an indefinite instance must NaN-poison ONLY itself — the ridge
    # retries in kkt/schur.py key off isfinite per instance
    n = 96
    good = _spd(n, rng)
    bad = good - 10.0 * np.eye(n)
    L = np.asarray(jax.vmap(cholesky)(jnp.asarray(np.stack([good, bad]))))
    assert np.allclose(L[0], np.linalg.cholesky(good), atol=1e-11)
    assert not np.isfinite(L[1]).all()


def test_family_names_static():
    # profile.py filters on the static attribute — it must match the
    # instance name each generator produces at its default parameters
    from conicip_tpu.models import ALL_GENERATORS

    for g in ALL_GENERATORS:
        assert g.family_name == g(seed=42).name, g.__name__
