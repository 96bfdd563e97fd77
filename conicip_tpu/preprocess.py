"""Rank-repairing preprocessor.

Host-side (numpy/scipy) re-implementation of the reference's preprocessor
(preprocessor.jl:1-96). Rank detection is a one-time cost outside the hot
loop, so it runs on the host CPU — the design decision recorded in
SURVEY.md §2.2 (sparse rank-revealing QR has no XLA equivalent; a
column-pivoted dense QR does the same job here).

Guarantees enforced before calling the IPM core:

- primal equalities:  rank(G) == size(G, 1)  (redundant rows dropped)
- dual system:        rank([Q Aᵀ Gᵀ]) == n   (deficient coordinates get a
  unit diagonal regularizer added to Q)

Inconsistent systems short-circuit to an ``Infeasible`` solution with
NaN-filled fields, and dropped equality duals are re-inflated with zeros —
both matching the reference exactly.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
from scipy.linalg import qr as _pivoted_qr

from .solver.state import Solution

__all__ = ["imcols", "preprocess_conic_ip"]


def _to_dense_np(X) -> np.ndarray:
    if hasattr(X, "toarray"):
        X = X.toarray()
    return np.asarray(X, dtype=np.float64)


def imcols(A, b, eps: float = 1e-8) -> Tuple[np.ndarray, bool]:
    """Independent-row detection + consistency check for ``A x = b``.

    Returns ``(R, consistent)`` where ``R`` is a sorted index array of
    independent rows of A and ``consistent`` says whether the full system is
    solvable (preprocessor.jl:10-28). Uses column-pivoted QR of Aᵀ (the
    dense analogue of the reference's SPQR call).
    """
    A = _to_dense_np(A)
    b = np.asarray(b, dtype=np.float64)
    if A.size == 0:
        return np.zeros(0, dtype=int), True

    nA = np.linalg.norm(A)
    A = A / nA
    b = b / nA

    # Rank detection: native C++ column-pivoted QR (native/pivoted_qr.cpp,
    # the SPQR analogue) with a scipy fallback.
    from . import native

    res = native.pivoted_qr_rank(A.T)
    if res is not None:
        diag_R, piv = res
    else:
        _, Rm, piv = _pivoted_qr(A.T, mode="economic", pivoting=True)
        n_r = min(Rm.shape)
        diag_R = np.abs(np.diag(Rm)[:n_r])
    keep = piv[np.nonzero(diag_R > eps)[0]]
    R = np.sort(keep)

    if R.size == 0:
        return np.zeros(0, dtype=int), True

    x, *_ = np.linalg.lstsq(A[R, :], b[R], rcond=None)
    # The reference checks ‖Ax − b‖∞ < ϵ *absolutely* (preprocessor.jl:26),
    # which falsely flags consistent systems whose RHS is large after the
    # norm(A) normalization (e.g. its own κ-scaling sweep passes only by a
    # ~2x margin). We make the check relative to the RHS scale.
    scale = max(1.0, float(np.linalg.norm(b, ord=np.inf)))
    consistent = np.linalg.norm(A @ x - b, ord=np.inf) < eps * scale
    return R, bool(consistent)


def preprocess_conic_ip(
    Q,
    c,
    A,
    b,
    cone_dims: Sequence[Tuple[str, int]],
    G=None,
    d=None,
    *,
    verbose: bool = False,
    **options,
) -> Solution:
    """``conic_ip`` with rank repair (preprocessor.jl:40-96)."""
    from .solver import conic_ip

    Q = _to_dense_np(Q)
    c = np.asarray(c, dtype=np.float64)
    A = _to_dense_np(A)
    b = np.asarray(b, dtype=np.float64)
    n = c.shape[0]
    m = A.shape[0]
    G = _to_dense_np(G) if G is not None else np.zeros((0, n))
    d = np.asarray(d, dtype=np.float64) if d is not None else np.zeros(0)
    p = G.shape[0]

    if verbose:
        print("\n > CONICIP-TPU PREPROCESSOR v0.1\n")

    IP, pconsistent = imcols(G, d)
    ID, dconsistent = imcols(np.hstack([Q, A.T, G[IP, :].T]), c)

    if not (pconsistent and dconsistent):
        return Solution(
            y=np.full(n, np.nan),
            w=np.full(p, np.nan),
            v=np.full(m, np.nan),
            status="Infeasible",
            Iter=0,
            Mu=np.nan,
            prFeas=np.nan,
            duFeas=np.nan,
            muFeas=np.nan,
            pobj=np.nan,
            dobj=np.nan,
        )

    if verbose and len(IP) != p:
        print(f"   - Removing {p - len(IP)} redundant primal constraints")
    if verbose and len(ID) != n:
        print(f"   - Augmenting {n - len(ID)} dual constraints")
    if verbose and len(ID) == n and len(IP) == p:
        print("   - No changes made")

    z = np.ones(n)
    z[ID] = 0.0
    Qz = Q + np.diag(z)

    sol = conic_ip(
        Qz, c, A, b, cone_dims, G[IP, :], d[IP], verbose=verbose, **options
    )

    # re-inflate equality duals with zeros for the dropped rows
    # (preprocessor.jl:91)
    w = np.zeros(p)
    w[IP] = sol.w
    sol.w = w
    return sol
