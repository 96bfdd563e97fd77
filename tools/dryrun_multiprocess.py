#!/usr/bin/env python
"""Two-process ``jax.distributed`` dry run over the CPU Gloo backend.

The single-host virtual mesh (``xla_force_host_platform_device_count``)
never exercises the multi-*process* machinery: the coordination service,
cross-process device enumeration, and cross-host collectives (Gloo on CPU,
standing in for the network between hosts). This script launches two
worker processes, each with 4 virtual CPU devices, forms the 8-device
global mesh, and runs a dp-sharded ``solve_batch`` plus a tp-sharded
``conic_ip`` across the process boundary.

Run directly (``python tools/dryrun_multiprocess.py``) or via
``__graft_entry__.dryrun_multichip``, which invokes it as its second leg.
Exit code 0 = both processes solved everything Optimal.
"""

from __future__ import annotations

import os
import subprocess
import sys

PORT = int(os.environ.get("CONICIP_MP_PORT", "29517"))
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def worker(process_id: int) -> None:
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.distributed.initialize(
        coordinator_address=f"localhost:{PORT}",
        num_processes=2,
        process_id=process_id,
    )

    import numpy as np

    import conicip_tpu as ct
    from conicip_tpu.models import batched_box_qp
    from conicip_tpu.parallel import (kktsolver_schur_tp, make_mesh,
                                      solve_batch)

    ndev = len(jax.devices())
    assert ndev == 8, f"expected 8 global devices, got {ndev}"
    assert len(jax.local_devices()) == 4

    mesh = make_mesh((2, 4), ("dp", "tp"))

    # dp leg: batch sharded over all 8 devices, spanning both processes
    batch = 16
    Q, c, A, b, cones = batched_box_qp(batch=batch, n=16)
    bs = solve_batch(Q, c, A, b, cones, mesh=mesh, batch_axis=("dp", "tp"),
                     optTol=1e-6, maxIters=30)
    assert bs.statuses == ["Optimal"] * batch, bs.statuses

    # tp leg: one problem whose factorization collectives cross processes
    n = 24
    rng = np.random.default_rng(0)
    B = rng.standard_normal((n, n))
    Qs = B.T @ B / n + np.eye(n)
    cs = rng.standard_normal(n)
    As = np.vstack([np.eye(n), -np.eye(n)])
    bss = -np.ones(2 * n)
    sol = ct.conic_ip(Qs, cs, As, bss, [("R", 2 * n)],
                      kktsolver=kktsolver_schur_tp(mesh, "tp"), optTol=1e-6)
    assert sol.status == "Optimal", sol.status

    print(f"proc {process_id}: dp batch={batch} + tp n={n} all Optimal",
          flush=True)


def launch(timeout: int = 600) -> None:
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    # a fresh interpreter per worker: jax.distributed must initialize
    # before any backend is touched
    procs = [
        subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--worker", str(i)],
            env=env,
        )
        for i in range(2)
    ]
    codes = [p.wait(timeout=timeout) for p in procs]
    if any(codes):
        raise RuntimeError(f"multiprocess dryrun failed: exit codes {codes}")
    print("dryrun_multiprocess OK: 2 processes x 4 devices, dp + tp legs")


if __name__ == "__main__":
    if len(sys.argv) > 2 and sys.argv[1] == "--worker":
        worker(int(sys.argv[2]))
    else:
        launch()
