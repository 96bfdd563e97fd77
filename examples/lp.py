"""Linear programs with conicip_tpu.

An LP is the conic problem with Q = 0 (reference tutorial analogue:
/root/reference/docs/src/tutorials/lp.jl):

    minimize    −cᵀy
    subject to  Ay ≥ b        (here: y ≥ 0)
                Gy = d        (here: Σ y = 4)

Note the sign convention: the solver MINIMIZES ½yᵀQy − cᵀy, so the cost
vector enters with a plus sign when you want to minimize −cᵀy.

Run: python examples/lp.py        (CPU or GPU; finishes in seconds)
"""

import numpy as np

import conicip_tpu as ct

n = 5
Q = np.zeros((n, n))
c = np.array([2.0, 3.0, 1.0, 1.0, 1.0])  # maximize 2y1+3y2+y3+y4+y5

# nonnegativity y >= 0 as one R cone
A = np.eye(n)
b = np.zeros(n)
cone_dims = [("R", n)]

# budget: sum(y) = 4
G = np.ones((1, n))
d = np.array([4.0])

sol = ct.conic_ip(Q, c, A, b, cone_dims, G, d, verbose=True)

print("status :", sol.status)
print("y      :", np.round(sol.y, 6))
print("objective (cᵀy):", float(c @ sol.y))

# The optimum puts the whole budget on the largest coefficient (y2 = 4).
assert sol.status == "Optimal"
assert abs(sol.y[1] - 4.0) < 1e-5
assert abs(float(c @ sol.y) - 12.0) < 1e-5

# Duals: w (equalities) and v (cone) certify optimality. For an LP the
# equality dual equals the marginal value of budget: 3 (the best c_i).
print("equality dual w:", np.round(sol.w, 6))
assert abs(sol.w[0] - (-3.0)) < 1e-4 or abs(sol.w[0] - 3.0) < 1e-4
print("ok")
