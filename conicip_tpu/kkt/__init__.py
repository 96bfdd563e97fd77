"""Pluggable KKT solvers — the reference's signature extension point.

The 3-level callback contract is preserved exactly (ConicIP.jl:432-466,
docs/src/guides/kkt_solvers.md):

    solve3x3gen = kktsolver(Q, A, G, spec)          # one-time setup
    solve3x3    = solve3x3gen(F, FinvT)             # per-iteration refactor
    (a, b, c)   = solve3x3(x, y, z)                 # per-RHS solve

solving::

    ┌             ┐ ┌   ┐   ┌   ┐
    │ Q   Gᵀ  -Aᵀ │ │ a │ = │ x │
    │ G           │ │ b │   │ y │
    │ A       FᵀF │ │ c │   │ z │
    └             ┘ └   ┘   └   ┘

Every level is a jittable pure closure; `F`/`FinvT` are structured
:class:`~conicip_tpu.cones.scaling.NTScaling` pytrees (never materialized on
the hot path). User-defined solvers plug in the same way as the reference's
(test/runtests.jl:102-116).

Solvers provided:

- :func:`kktsolver_schur` — default; dense Schur complement
  ``M = Q + Aᵀ(FᵀF)⁻¹A`` assembled as one matmul and factored by
  Cholesky. Dense analogue of the reference's fastest path
  ``pivot(kktsolver_2x2)`` (kktsolvers.jl:272-349).
- :func:`kktsolver_qr` — CVXOPT §10.2 double-QR (kktsolvers.jl:18-58);
  handles rank-deficient Q.
- :func:`kktsolver_lu` — dense LU of the full 3x3 saddle system; robust
  analogue of the reference's sparse-LU path (kktsolvers.jl:180-270).
- :func:`pivot` — adapter wrapping any 2x2 solver into the 3x3 interface.
"""

from .diag import kktsolver_diag, separable, separable_batch
from .pivot import pivot
from .schur import kktsolver_2x2, kktsolver_schur
from .qr import kktsolver_qr
from .lu import kktsolver_lu

__all__ = [
    "kktsolver_diag",
    "separable",
    "separable_batch",
    "pivot",
    "kktsolver_2x2",
    "kktsolver_schur",
    "kktsolver_qr",
    "kktsolver_lu",
]
