"""CVXPY bridge — the Python analogue of the reference being a JuMP/MOI
backend (MOI_wrapper.jl:1-398, README.md:68-82).

CVXPY ≥ 1.3 accepts a *solver instance* in ``problem.solve(solver=...)``
("custom solvers"). :class:`ConicIPSolver` subclasses CVXPY's SCS conic
interface class because our standard-form data convention (``b − Ax ∈ K``,
scaled-lower-triangle PSD vectorization) is exactly SCS's — so CVXPY's own
``apply``/``invert`` machinery (cone ordering, PSD dual unscaling, dual
recovery per constraint) is inherited unchanged, and only the actual solve
is routed to :func:`conicip_tpu.frontend.conic_form.solve_conic_form`.

Usage::

    import cvxpy as cp
    from conicip_tpu.frontend.cvxpy_solver import ConicIPSolver

    x = cp.Variable(3)
    prob = cp.Problem(cp.Minimize(cp.sum(x)), [cp.norm(x, 2) <= 1, x >= -5])
    prob.solve(solver=ConicIPSolver())

This module imports lazily: it is importable without cvxpy installed (the
class constructor raises then), so the package carries no hard dependency.
"""

from __future__ import annotations

import numpy as np

__all__ = ["ConicIPSolver", "CONICIP_TPU"]

CONICIP_TPU = "CONICIP_TPU"

# Status values in the SCS result convention, which the inherited
# cvxpy STATUS_MAP translates (scs_conif): 1 → OPTIMAL, -1 → UNBOUNDED,
# -2 → INFEASIBLE, -4 → SOLVER_ERROR.
_SCS_STATUS_VAL = {
    "Optimal": 1,
    "Unbounded": -1,
    "Infeasible": -2,
    "Abandoned": -4,
    "Error": -4,
}


def _scs_base():
    from cvxpy.reductions.solvers.conic_solvers.scs_conif import SCS

    return SCS


def _make_class():
    import cvxpy.settings as cvx_s
    from cvxpy.constraints import PSD, SOC, NonNeg, Zero
    from cvxpy.reductions.solvers.conic_solvers.conic_solver import (
        ConicSolver,
    )

    SCS = _scs_base()

    class _ConicIPSolver(SCS):
        """CVXPY conic solver backed by :func:`conic_ip`."""

        # R/Q/S cones only (reference capability set, ConicIP.jl:411-417)
        SUPPORTED_CONSTRAINTS = [Zero, NonNeg, SOC, PSD]
        MIP_CAPABLE = False
        REQUIRES_CONSTR = True

        def __init__(self, **solver_options):
            self._options = solver_options

        def name(self):
            return CONICIP_TPU

        def import_solver(self) -> None:
            import conicip_tpu  # noqa: F401  (self-import: always present)

        def solve_via_data(self, data, warm_start, verbose, solver_opts,
                           solver_cache=None):
            from .conic_form import solve_conic_form

            opts = dict(self._options)
            opts.update(solver_opts or {})
            opts.setdefault("verbose", bool(verbose))
            A = data[cvx_s.A]
            b = data[cvx_s.B]
            c = data[cvx_s.C]
            P = data.get(cvx_s.P) if hasattr(cvx_s, "P") else None
            dims = data[ConicSolver.DIMS]
            res = solve_conic_form(c, A, b, dims, P=P, **opts)
            sval = _SCS_STATUS_VAL.get(res.status, -4)
            info = {
                "status_val": sval,
                "statusVal": sval,  # SCS-2.x key, for older cvxpy inverts
                "status": res.status,
                "pobj": res.obj,
                "dobj": getattr(res.solution, "dobj", np.nan),
                "iter": getattr(res.solution, "Iter", 0),
                "solve_time": 0.0,
                "setup_time": 0.0,
            }
            x = res.x
            y = res.y
            s_slack = res.s
            if not np.all(np.isfinite(x)):
                x = np.zeros_like(x)
            if not np.all(np.isfinite(y)):
                y = np.zeros_like(y)
            if not np.all(np.isfinite(s_slack)):
                s_slack = np.zeros_like(s_slack)
            return {"x": x, "y": y, "s": s_slack, "info": info}

    return _ConicIPSolver


_cls_cache = None


def ConicIPSolver(**solver_options):
    """Instantiate the CVXPY solver class (lazy — requires cvxpy).

    ``solver_options`` forward to :func:`conicip_tpu.conic_ip`
    (``optTol``, ``maxIters``, ``kktsolver``, ``factor_dtype``, …).
    """
    global _cls_cache
    if _cls_cache is None:
        try:
            _cls_cache = _make_class()
        except ImportError as e:  # pragma: no cover - env without cvxpy
            raise ImportError(
                "cvxpy is required for the CVXPY bridge; the standard-form "
                "entry point conicip_tpu.frontend.conic_form.solve_conic_form "
                "has no such dependency"
            ) from e
    return _cls_cache(**solver_options)
