#!/usr/bin/env python
"""Batched-throughput benchmark: the accelerator's answer to tiny serial
problems.

The reference solves one problem per call (ConicIP.jl:400-510); its wins on
the small families (small_sdp 1.4 ms, mixed_rqs 4.5 ms on a local CPU —
BASELINE.md / profile_output.txt:36-56) are serial-latency wins that no
per-solve accelerator dispatch can beat. The counter is throughput: the
mask-based IPM core is vmap-safe, so B independent instances solve as ONE
device program whose per-iteration work is batched eigh/chol/matmul.

Problem shapes MATCH the reference profile families exactly (so the
solves/s comparison is honest): small_sdp k=10, mixed_rqs n=86, box QP
n=500 dense Q, mixed_rq_eq n=200/n_q=51/p=10. Large per-instance data
(the 64 dense 500×500 Qs) is generated ON DEVICE in one in-jit PRNG pass.

Measurement (same discipline as bench.py): each batched solve handles B
instances with DISTINCT data; K and 2K batched solves are chained inside
one jit via ``lax.fori_loop`` and the reported rate is the difference —
the fixed dispatch cost cancels, leaving the steady-state device
throughput. Residuals of every instance are verified
against 1e-6. For the equality family the chain times the REDUCED batched
solve — the device-resident part of production ``solve_batch`` (the one
host QR of the shared G and the full-space recovery amortize over batch
and chain); its residuals certify the reduced problem.

Needs a GPU and exits non-zero without one; the device is named on
stderr. Writes the rows to ``--out`` when given, and prints one JSON line
per family:

  {"family": ..., "solves_per_s": N, "iters_per_s": N,
   "ref_solves_per_s": N, "vs_ref_throughput": N, "tol_ok": true}

Reference sequential rates are 1 / (best-backend wall time) from
BASELINE.md (profile_output.txt:36,54,14,48).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# family -> (reference best s/solve, source line)
REF_S_PER_SOLVE = {
    "batched_small_sdp": (0.0014, "profile_output.txt:38 pivot(2x2)"),
    "batched_mixed_rqs": (0.0045, "profile_output.txt:54 kktsolver_qr"),
    "batched_box_qp": (0.0830, "profile_output.txt:14 pivot(2x2) n=500"),
    "batched_mixed_rq_eq": (0.0253, "profile_output.txt:48 kktsolver_qr"),
}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=64,
                    help="instances per batched solve (default 64)")
    ap.add_argument("--K", type=int, default=1,
                    help="chain length; rate = (2K-chain) - (K-chain)")
    ap.add_argument("--families", nargs="*", default=None,
                    help="subset of families (default: all)")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--out", default=None, help="output JSON path")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    import conicip_tpu  # noqa: F401  (x64 on)
    from conicip_tpu.cones.spec import ConeSpec
    from conicip_tpu.models import generators as gen
    from conicip_tpu.parallel.batch import make_batched_ladder_solver
    from conicip_tpu.runtime import (describe_devices, enable_compile_cache,
                                     gpu_card, require_gpu)
    from conicip_tpu.solver import _default_kktsolver as _dk
    from conicip_tpu.solver.ipm import IPMOptions

    devices = require_gpu()
    enable_compile_cache()
    print(f"# device {describe_devices(devices)} card: {gpu_card()}",
          file=sys.stderr)
    _HI = jax.lax.Precision.HIGHEST
    B = args.batch
    K = args.K
    rng = np.random.default_rng(0)

    # Each family returns a dict:
    #   Q, A, b : problem data — 3-D/2-D per-instance arrays, or lower-rank
    #             SHARED arrays broadcast to the batch on device in-chain
    #   cones   : cone_dims
    #   fresh_c : count -> (count, B, n) distinct linear terms per chain step
    #   Kc      : production centralityCorrectors for this configuration
    #   note    : measurement caveat recorded in the JSON row
    def family_small_sdp():
        Q, c, A, b, cones = gen.batched_small_sdp(B)

        def fresh_c(count):
            # distinct symmetric matrices to PSD-project per instance per step
            k = 10
            C = rng.standard_normal((count, B, k, k))
            C = (C + np.swapaxes(C, -1, -2)) / np.sqrt(2 * k)
            return gen._vecm_np(C)

        return dict(Q=Q, A=A, b=b, cones=cones, fresh_c=fresh_c, Kc=0,
                    note="")

    def family_mixed_rqs():
        Q, c, A, b, cones = gen.batched_mixed_rqs(B)
        n = c.shape[-1]
        return dict(Q=Q, A=A, b=b, cones=cones,
                    fresh_c=lambda count: rng.standard_normal((count, B, n)),
                    Kc=0, note="")

    def family_box_qp():
        # reference shape: n=500 dense-Q box QP (profile.jl:20-34) with
        # DISTINCT dense SPD Q per instance, generated on device (module
        # docstring); A = [I; -I] and b are shared and broadcast in-chain.
        n = 500

        @jax.jit
        def make_Q(key):
            Ms = jax.random.normal(key, (B, n, n), jnp.float32)
            Gm = jnp.einsum("bij,bik->bjk", Ms, Ms, precision=_HI) / n
            Gm = 0.5 * (Gm + jnp.swapaxes(Gm, -1, -2))
            return Gm.astype(jnp.float64) + jnp.eye(n, dtype=jnp.float64)

        Q = make_Q(jax.random.PRNGKey(0))
        A2 = jnp.asarray(np.vstack([np.eye(n), -np.eye(n)]))
        b2 = jnp.asarray(-np.ones(2 * n))
        return dict(Q=Q, A=A2, b=b2, cones=[("R", 2 * n)],
                    fresh_c=lambda count: rng.standard_normal((count, B, n)),
                    Kc=1, note="Q generated on device")

    def family_mixed_rq_eq():
        # reference shape (n=200, n_q=51, p=10; profile.jl:99-113).
        # Production (r5) solves the DIRECT form: the bound-R + small-SOC
        # + equality structure is diag+low-rank (kkt/lowrank.py), which
        # the null-space elimination would destroy (A Z is dense). The
        # ladder here mirrors solve_batch: f32 dense warm-up + ONE exact
        # lowrank f64 finisher.
        n, n_q, p = 200, 51, 10
        Q, c, A, b, cones, G, d = gen.batched_mixed_rq_eq(
            B, n=n, n_q=n_q, p=p)

        def fresh_c(count):
            return rng.standard_normal((count, B, n))

        return dict(Q=Q[0], A=A[0], b=b, cones=cones, G=np.asarray(G),
                    d=np.asarray(d), fresh_c=fresh_c, Kc=1,
                    note="direct ladder (f32 dense warm-up + lowrank f64 "
                         "finisher)")

    FAMILIES = {
        "batched_small_sdp": family_small_sdp,
        "batched_mixed_rqs": family_mixed_rqs,
        "batched_box_qp": family_box_qp,
        "batched_mixed_rq_eq": family_mixed_rq_eq,
    }
    picked = args.families or list(FAMILIES)

    def sync(x):
        return tuple(np.asarray(v) for v in x)

    def best_of(f, reps):
        out = sync(f())  # compile + warm
        best = np.inf
        for _ in range(reps):
            t0 = time.perf_counter()
            out = sync(f())
            best = min(best, time.perf_counter() - t0)
        return best, out

    from conicip_tpu.parallel.batch import make_batched_solver

    results = []
    for name in picked:
        fam = FAMILIES[name]()
        spec = ConeSpec(fam["cones"])
        n = np.shape(fam["Q"])[-1]
        Kc = fam["Kc"]

        # The f32-factor configuration, chained — mirrors solve_batch's
        # factor_dtype=float32 policy: S-cone specs run ONE f64-KKT tier
        # with full-precision decompositions (the f32 tiers NaN out for
        # most instances and re-pay rescue anyway). R/Q specs keep the
        # f32 fast tier + cond-gated rescue ladder.
        if spec.sdp_groups:
            from conicip_tpu.kkt.spectral import (spectral_applicable,
                                                  spectral_kktsolver)

            opts = IPMOptions(optTol=1e-6, mixedResiduals=False,
                              centralityCorrectors=Kc, fastEig=False,
                              twoModeKKT=False, stallCutoff=4)
            Qh, Ah = np.asarray(fam["Q"]), np.asarray(fam["A"])
            if spectral_applicable(Qh, Ah, None, spec):
                kkt_sdp = spectral_kktsolver(None)
                # production solve_batch rescue order: spectral-with-full-
                # polish first (cheap), dense f64 KKT last (expensive at
                # batch scale); both cond-gated — free when every
                # instance certifies in the primary tier
                import dataclasses as _dc
                polish = _dc.replace(opts, maxRefinementSteps=3,
                                     stallCutoff=8)
                ladder_solver = make_batched_ladder_solver(
                    spec, kkt_sdp,
                    ((kkt_sdp, polish), (_dk(None), polish)), opts)
            else:
                ladder_solver = make_batched_solver(spec, _dk(None), opts)
        else:
            from conicip_tpu.kkt.lowrank import (lowrank_applicable,
                                                  lowrank_kktsolver)

            kkt = _dk(jnp.float32)
            opts = IPMOptions(optTol=1e-6, mixedResiduals=True,
                              centralityCorrectors=Kc,
                              twoModeKKT=False)
            if lowrank_applicable(np.asarray(fam["Q"]),
                                  np.asarray(fam["A"]), fam.get("G"),
                                  spec):
                tiers = (
                    (lowrank_kktsolver(),
                     IPMOptions(optTol=1e-6, mixedResiduals=False,
                                centralityCorrectors=Kc, fastEig=False,
                                twoModeKKT=False, stallCutoff=6)),
                )
            else:
                tiers = (
                    (_dk(jnp.float32, jnp.float64),
                     IPMOptions(optTol=1e-6, mixedResiduals=True,
                                centralityCorrectors=Kc, fastEig=False,
                                twoModeKKT=False)),
                    (_dk(None),
                     IPMOptions(optTol=1e-6, mixedResiduals=False,
                                centralityCorrectors=Kc,
                                fastEig=False, twoModeKKT=False,
                                stallCutoff=6)),
                )
            ladder_solver = make_batched_ladder_solver(spec, kkt, tiers,
                                                       opts)
        if fam.get("G") is not None and np.shape(fam["G"])[0] > 0:
            pG = np.shape(fam["G"])[0]
            Gb = jnp.broadcast_to(jnp.asarray(fam["G"]), (B, pG, n))
            db = jnp.asarray(fam["d"])
        else:
            Gb = jnp.zeros((B, 0, n))
            db = jnp.zeros((B, 0))

        cs = jax.device_put(jnp.asarray(fam["fresh_c"](2 * K)))
        Qd = jax.device_put(jnp.asarray(fam["Q"]))
        Ad = jax.device_put(jnp.asarray(fam["A"]))
        bd = jax.device_put(jnp.asarray(fam["b"]))

        def bcast(X, nd):
            return X if X.ndim == nd else jnp.broadcast_to(
                X, (B,) + X.shape)

        def make_chain(count):
            @jax.jit
            def run(cs, Qd, Ad, bd):
                Qb = bcast(Qd, 3)
                Ab = bcast(Ad, 3)
                bb = bcast(bd, 2)

                def body(i, acc):
                    iters, resid, nbad = acc
                    st = ladder_solver(Qb, cs[i], Ab, bb, Gb, db)
                    r = jnp.maximum(st.prFeas,
                                    jnp.maximum(st.duFeas, st.muFeas))
                    return (
                        iters + jnp.sum(st.Iter),
                        jnp.maximum(resid, jnp.max(r)),
                        nbad + jnp.sum(jnp.where(r < 1e-6, 0, 1)),
                    )

                return jax.lax.fori_loop(
                    0, count, body,
                    (jnp.int64(0), jnp.float64(0.0), jnp.int64(0)),
                )

            return run

        chain_K = make_chain(K)
        chain_2K = make_chain(2 * K)
        tK, (itK, resK, badK) = best_of(
            lambda: chain_K(cs, Qd, Ad, bd), args.reps)
        t2K, (it2K, res2K, bad2K) = best_of(
            lambda: chain_2K(cs, Qd, Ad, bd), args.reps)
        elapsed = t2K - tK
        iters = int(it2K) - int(itK)
        solves = K * B
        tol_ok = int(bad2K) == 0 and float(res2K) < 1e-6
        method = "chain-differenced"
        if elapsed <= 0 or iters <= 0:
            raise SystemExit(f"{name}: the {2 * K}-chain was not slower "
                             f"than the {K}-chain; no rate")
        ref_s, ref_src = REF_S_PER_SOLVE[name]
        row = {
            "family": name,
            "batch": B,
            "chained_batched_solves": f"{K}->{2 * K}",
            "solves_per_s": round(solves / elapsed, 1),
            "iters_per_s": round(iters / elapsed, 1),
            "iters_per_solve": round(iters / solves, 2),
            "max_resid": float(res2K),
            "tol_ok": tol_ok,
            "ref_solves_per_s": round(1.0 / ref_s, 1),
            "ref_source": ref_src,
            "vs_ref_throughput": round(solves / elapsed * ref_s, 2),
            "method": method,
            "note": fam["note"],
            "device": describe_devices(devices),
        }
        results.append(row)
        print(json.dumps({k: row[k] for k in (
            "family", "solves_per_s", "iters_per_s", "ref_solves_per_s",
            "vs_ref_throughput", "tol_ok")}))
        print(f"#   {name}: B={B} {method} max_resid={float(res2K):.2e} "
              f"iters/solve={row['iters_per_solve']}", file=sys.stderr)

    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=2)
        print(f"# wrote {args.out}", file=sys.stderr)


if __name__ == "__main__":
    main()
