"""conicip_tpu — a conic quadratic-program interior-point solver in JAX.

Brand-new JAX/XLA implementation with the capabilities of ConicIP.jl
(Mehrotra predictor-corrector, Nesterov-Todd scaling over products of
R/Q/S cones, equality constraints, infeasibility certificates, pluggable
KKT-solver callbacks, rank-repairing preprocessor), built from
static-shape cone groups, structured never-materialized scalings, a dense
Schur-complement KKT path, and vmap/shard_map batching over device meshes.

Problem solved (matching the reference's — note the MINUS sign on cᵀy):

    minimize    ½ yᵀQy − cᵀy
    subject to  Ay ≥_K b,   K = K₁ × … × K_j
                Gy = d
"""

import os

import jax

# The solver iterates in float64 (factorizations can optionally run in
# float32 with iterative refinement — see conicip_tpu.kkt). x64 must be
# enabled before any array is created.
if os.environ.get("CONICIP_TPU_NO_X64", "0") != "1":
    jax.config.update("jax_enable_x64", True)

from .cones import (  # noqa: E402
    ConeSpec,
    cone_div,
    cone_prod,
    mat,
    maxstep,
    maxstep_to_cone,
    nt_identity,
    nt_inv_adjoint,
    nt_scaling,
    vecm,
)

__version__ = "0.1.0"


def Id(n: int):
    """n-by-n identity (reference ``Id``, ConicIP.jl:14-18)."""
    import jax.numpy as jnp

    return jnp.eye(int(n))

__all__ = [
    "ConeSpec",
    "mat",
    "vecm",
    "cone_prod",
    "cone_div",
    "maxstep",
    "maxstep_to_cone",
    "nt_scaling",
    "nt_identity",
    "nt_inv_adjoint",
]


def __getattr__(name):
    # Lazy imports to keep `import conicip_tpu` light and avoid cycles.
    if name in ("conic_ip", "Solution", "IPMOptions"):
        from . import solver

        return getattr(solver, name)
    if name in ("kktsolver_schur", "kktsolver_qr", "kktsolver_lu", "pivot",
                "kktsolver_2x2", "kktsolver_diag", "separable"):
        from . import kkt

        return getattr(kkt, name)
    if name == "preprocess_conic_ip":
        from .preprocess import preprocess_conic_ip

        return preprocess_conic_ip
    if name == "imcols":
        from .preprocess import imcols

        return imcols
    if name == "Optimizer":
        from .frontend import Optimizer

        return Optimizer
    if name in ("solve_batch", "BatchSolution", "kktsolver_schur_tp", "make_mesh"):
        from . import parallel

        return getattr(parallel, name)
    raise AttributeError(f"module 'conicip_tpu' has no attribute {name!r}")
