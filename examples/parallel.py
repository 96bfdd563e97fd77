"""Data-parallel batched solving: vmap batches, device meshes, warm
re-solves, and checkpoint/resume.

The reference solves one problem per call (ConicIP.jl:400-510). On an
accelerator the first free parallelism axis is the PROBLEM BATCH: the IPM
core is mask-based and vmap-safe, so a stack of B independent conic QPs
compiles to ONE device program whose per-iteration work is batched
matmul/chol/eigh. This example walks the production workflow:

1. ``solve_batch`` on a stack of scenario QPs (one compile, B solves),
2. the same batch SHARDED over a device mesh (``jax.sharding`` — zero
   cross-instance collectives; scales to multi-chip/multi-host unchanged),
3. warm-started re-solves of a drifted batch (rolling re-optimization),
4. ``solve_batch_resumable`` — chunked solving with atomic checkpoints.

Run: python examples/parallel.py          (CPU: set JAX_PLATFORMS=cpu;
     the script forces a CPU mesh of 4 virtual devices when no
     accelerator platform is initialized, so it runs anywhere)
"""

import os

# must happen before jax initializes: give the CPU backend 4 virtual
# devices so the mesh leg is a real (if local) sharding demonstration
if "xla_force_host_platform_device_count" not in os.environ.get(
    "XLA_FLAGS", ""
):
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + " --xla_force_host_platform_device_count=4"
    ).strip()

import numpy as np

import conicip_tpu as ct
from conicip_tpu.parallel import make_mesh, solve_batch

# ── 1. a batch of scenario QPs: same structure, different data ──────
B, n = 8, 40
rng = np.random.default_rng(0)
Q = np.stack([np.diag(1.0 + rng.random(n)) for _ in range(B)])
c = rng.standard_normal((B, n))
A = np.stack([np.vstack([np.eye(n), -np.eye(n)])] * B)
b = np.stack([-np.ones(2 * n)] * B)
cones = [("R", 2 * n)]

bs = solve_batch(Q, c, A, b, cones)
assert bs.statuses == ["Optimal"] * B
resid = np.maximum(bs.prFeas, np.maximum(bs.duFeas, bs.muFeas))
print(f"batch of {B}: all Optimal, max resid {resid.max():.2e}, "
      f"iters {bs.Iter.tolist()}")

# ── 2. the same batch sharded over a device mesh ─────────────────────
# On several GPUs this is the data-parallel path; the solver inserts no
# cross-instance collectives (each instance's work is local to its
# device; only the loops' 1-bit termination consensus crosses devices).
import jax

ndev = len(jax.devices())
mesh = make_mesh((ndev,), ("batch",))
Bs = 2 * ndev
bs2 = solve_batch(
    np.broadcast_to(Q[0], (Bs, n, n)),
    rng.standard_normal((Bs, n)),
    np.broadcast_to(A[0], (Bs, 2 * n, n)),
    np.broadcast_to(b[0], (Bs, 2 * n)),
    cones, mesh=mesh, batch_axis="batch",
)
assert bs2.statuses == ["Optimal"] * Bs
print(f"mesh-sharded batch of {Bs} over {ndev} devices: all Optimal")

# ── 3. warm-started re-solve of a drifted batch ──────────────────────
# rolling re-optimization: the new batch seeds from the old solutions
c_drift = c + 0.01 * rng.standard_normal((B, n))
bs3 = solve_batch(Q, c_drift, A, b, cones, warm_start=bs)
assert bs3.statuses == ["Optimal"] * B
print(f"warm re-solve after drift: iters {bs3.Iter.tolist()} "
      f"(cold was {bs.Iter.tolist()})")
assert bs3.Iter.max() <= bs.Iter.max()

# ── 4. checkpoint/resume for long batched runs ───────────────────────
# chunked solving with atomic .npz snapshots: a preempted job re-runs the
# same call and continues from the last finished chunk (finished
# instances stay frozen; the data fingerprint guards against resuming
# onto different problems)
from conicip_tpu.parallel import solve_batch_resumable

ckpt = "/tmp/conicip_example_ckpt.npz"
if os.path.exists(ckpt):
    os.remove(ckpt)
bs4 = solve_batch_resumable(Q, c, A, b, cones, store=ckpt,
                            chunk_iters=4)
assert bs4.statuses == ["Optimal"] * B
bs5 = solve_batch_resumable(  # resumes: everything already finished
    Q, c, A, b, cones, store=ckpt, chunk_iters=4
)
assert bs5.statuses == ["Optimal"] * B
os.remove(ckpt)
print("checkpoint/resume: chunked solve + instant resume ok")
