"""Semidefinite programs: projection onto the PSD cone.

    minimize   ½‖Y − C‖²_F
    subject to Y ⪰ 0

Symmetric matrices are passed in packed √2-scaled upper-triangle form
(``vecm``/``mat``, matching the reference's convention so that
dot(vecm X, vecm Y) = tr(XY); reference tutorial analogue:
/root/reference/docs/src/tutorials/sdp.jl). A d×d symmetric matrix packs
into t = d(d+1)/2 entries and a cone spec ("S", t).

Analytic answer: eigenvalue clipping — Y* = U max(Λ, 0) Uᵀ.

Run: python examples/sdp.py
"""

import numpy as np

import conicip_tpu as ct

d = 8
t = d * (d + 1) // 2
rng = np.random.default_rng(2)
C = rng.standard_normal((d, d))
C = (C + C.T) / 2  # symmetric, indefinite

c = np.asarray(ct.vecm(C))  # packed objective data

Q = np.eye(t)
A = np.eye(t)
b = np.zeros(t)
cone_dims = [("S", t)]

sol = ct.conic_ip(Q, c, A, b, cone_dims)
Y = np.asarray(ct.mat(sol.y))

w, U = np.linalg.eigh(C)
expected = U @ np.diag(np.maximum(w, 0.0)) @ U.T

print("status:", sol.status, " iterations:", sol.Iter)
print("min eigenvalue of Y:", float(np.linalg.eigvalsh(Y).min()))
assert sol.status == "Optimal"
assert np.max(np.abs(Y - expected)) < 1e-5
assert np.linalg.eigvalsh(Y).min() > -1e-7

# Batched variant — the production pattern for many small SDPs
# (covariance repair): stack instances and let vmap batch every
# per-iteration eigh/chol into one kernel. tools/bench_batched.py times
# it on a GPU.
from conicip_tpu.models import batched_small_sdp
from conicip_tpu.parallel import solve_batch

Qb, cb, Ab, bb, cones = batched_small_sdp(batch=4, k=6)
bs = solve_batch(Qb, cb, Ab, bb, cones, factor_dtype=None)
print("batched statuses:", bs.statuses)
assert bs.statuses == ["Optimal"] * 4
print("ok")
