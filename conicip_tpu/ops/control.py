"""vmap-safe conditional execution.

``lax.cond`` batches to ``select``: under ``vmap`` BOTH branches execute
for every element. That is the right lowering for cheap branches, but it
silently destroys the point of guarding an *expensive fallback* with a
cond — every vmapped caller pays the fallback unconditionally. The batched
escalation ladder (parallel/batch.py) runs ``ipm_solve`` under ``vmap``,
so every such guard on the solve path (the escalating-ridge
factorization retries in kkt/schur.py, the certified-residual recompute in
solver/ipm.py) was
re-paying the cost the guard exists to avoid.

A 0/1-trip ``lax.while_loop`` has the batching semantics we actually
want: vmap of ``while_loop`` runs the body only while ANY element's
predicate still holds (one batched pass, then a per-element select keeps
finished elements' carries), and a non-vmapped caller executes the body
zero or one time — exactly ``cond``. These helpers package that pattern.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = ["cond_once", "retry_while"]


def cond_once(pred, fn, default):
    """``lax.cond(pred, fn, lambda: default)`` that stays a real branch
    under ``vmap``.

    ``fn`` takes no arguments (close over operands) and must return a
    pytree matching ``default`` in structure, shapes, and dtypes. Under
    ``vmap``, ``fn`` executes as ONE batched pass iff any element's
    ``pred`` is True; elements with ``pred`` False keep ``default``.

    Not differentiable (``while_loop``); every current call site sits
    inside the IPM's ``while_loop`` already.
    """
    def _cond(carry):
        return carry[0]

    def _body(carry):
        return jnp.bool_(False), fn()

    _, out = jax.lax.while_loop(_cond, _body, (jnp.bool_(pred), default))
    return out


def retry_while(bad, step, state0, scale0, factor, cap):
    """Escalating retries that stay a real branch under ``vmap``.

    Repeats ``state = step(scale)`` with ``scale`` multiplied by
    ``factor`` after each attempt, while ``bad(state)`` holds and
    ``scale < cap``. ``state0`` is the already-computed first attempt, so
    the common (healthy) path costs one predicate evaluation and zero
    body passes. Replaces chains of ``lax.cond`` retries, which under
    ``vmap`` execute every retry for every element unconditionally.
    """
    def _cond(carry):
        state, scale = carry
        return bad(state) & (scale < cap)

    def _body(carry):
        state, scale = carry
        return step(scale), scale * factor

    state, _ = jax.lax.while_loop(_cond, _body, (state0, scale0))
    return state
