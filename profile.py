#!/usr/bin/env python
"""Macro profiling suite — the reference's benchmark/profile.jl analogue.

Runs the eight problem families (models/generators.py, mirroring
profile.jl:20-131) across KKT backends, reporting per-solve wall time
(median of trials with distinct problem instances, device-resident inputs),
IP iteration counts, statuses, and derived ms/iteration. Optionally emits a
JSON report and a profiler trace. Needs a GPU and exits non-zero without
one; the device is named on stderr.

Usage:
    python profile.py [--trials 3] [--json out.json] [--backends schur,qr,lu]
    python profile.py --trace /tmp/trace   # adds a jax.profiler trace
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

import numpy as np


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--trials", type=int, default=3)
    ap.add_argument("--json", type=str, default=None)
    ap.add_argument("--backends", type=str, default="schur,qr,lu")
    ap.add_argument("--trace", type=str, default=None)
    ap.add_argument("--factor-dtype", type=str, default="float32",
                    choices=["float32", "float64"])
    ap.add_argument("--families", type=str, default=None,
                    help="comma-separated substring filters on family "
                    "names (e.g. 'sdp,mixed'); default all")
    ap.add_argument(
        "--chained", type=int, default=0, metavar="K",
        help="chain K distinct full solves (fast path + in-jit escalation "
        "ladder) inside ONE jit per family and report the per-solve time "
        "from the K-vs-2K chain difference, which cancels the fixed "
        "per-dispatch cost")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    import conicip_tpu  # noqa: F401
    from conicip_tpu.runtime import (describe_devices, enable_compile_cache,
                                     gpu_card, require_gpu)

    devices = require_gpu()
    enable_compile_cache()
    print(f"# device {describe_devices(devices)} card: {gpu_card()}",
          file=sys.stderr)
    from conicip_tpu.cones.spec import ConeSpec
    from conicip_tpu.kkt import kktsolver_lu, kktsolver_qr, kktsolver_schur
    from conicip_tpu.solver import (_default_kktsolver, _solve_jit,
                                    _solve_warm_jit)
    from conicip_tpu.models import ALL_GENERATORS
    from conicip_tpu.solver.ipm import IPMOptions
    from conicip_tpu.solver.state import STATUS_NAMES, Status, Vec4

    factor_dtype = jnp.float32 if args.factor_dtype == "float32" else None
    backends = {}
    for name in args.backends.split(","):
        if name == "schur":
            backends[name] = _default_kktsolver(factor_dtype)
        elif name == "qr":
            backends[name] = kktsolver_qr
        elif name == "lu":
            backends[name] = kktsolver_lu
        else:
            raise SystemExit(f"unknown backend {name}")

    opts = IPMOptions(
        optTol=1e-6, mixedResiduals=args.factor_dtype == "float32",
        # production default (conic_ip): proactive full-precision
        # last-mile for f32 single solves — restores f64 iteration counts
        lastmileProactive=50.0 if args.factor_dtype == "float32" else 0.0,
    )
    opts64 = IPMOptions(optTol=1e-6)

    ladder = (
        (_default_kktsolver(jnp.float32, jnp.float64),
         IPMOptions(optTol=1e-6, mixedResiduals=True)),
        (_default_kktsolver(None), opts64),
    )

    if args.chained:
        _run_chained(args, opts, ladder)
        return

    def solve_like_conic_ip(staged_p, spec, kkt):
        """Mirror conic_ip's device path: fast solve + warm backstop
        ladder (f64-assembled/f32-factored, then full f64) when the f32
        factorization is exhausted near a solution (solver/__init__.py)."""
        st = _solve_jit(*staged_p, spec=spec, kktsolver=kkt, opts=opts)
        for kkt_next, opts_next in ladder:
            status = int(st.status)
            resid = float(
                jnp.maximum(st.prFeas, jnp.maximum(st.duFeas, st.muFeas))
            )
            if not (status in (Status.ABANDONED, Status.ERROR)
                    and resid < 1e-2):
                break
            Q, c, A, b, G, d = staged_p
            warm = Vec4(st.y, st.w, st.v,
                        jnp.matmul(A, st.y,
                                   precision=jax.lax.Precision.HIGHEST) - b)
            st = _solve_warm_jit(Q, c, A, b, G, d, warm, spec=spec,
                                 kktsolver=kkt_next, opts=opts_next)
        return st
    print(f"# trials={args.trials} factor_dtype={args.factor_dtype}",
          file=sys.stderr)

    results = []
    for gen in _pick_generators(args):
        # distinct instances per trial to defeat any execution caching
        probs = [gen(seed=42 + t) for t in range(args.trials + 1)]
        spec = ConeSpec(probs[0].cone_dims)
        name = probs[0].name

        def put(p):
            n = len(p.c)
            G = p.G if p.G is not None else np.zeros((0, n))
            d = p.d if p.d is not None else np.zeros(0)
            return tuple(
                jax.device_put(jnp.asarray(x))
                for x in (p.Q, p.c, p.A, p.b, G, d)
            )

        staged = [put(p) for p in probs]
        for bname, kkt in backends.items():
            times, iters, stat = [], [], []
            try:
                # warmup/compile on instance 0 — including the warm
                # full-precision backstop path, which otherwise compiles
                # inside a timed trial when only some instances trigger it
                st = _solve_jit(*staged[0], spec=spec, kktsolver=kkt,
                                opts=opts)
                Q0, c0, A0, b0, G0, d0 = staged[0]
                warm0 = Vec4(st.y, st.w, st.v, A0 @ st.y - b0)
                for kkt_next, opts_next in ladder:
                    stw = _solve_warm_jit(Q0, c0, A0, b0, G0, d0, warm0,
                                          spec=spec, kktsolver=kkt_next,
                                          opts=opts_next)
                    np.asarray(stw.Iter)
                np.asarray(st.Iter)
                for t in range(1, args.trials + 1):
                    t0 = time.perf_counter()
                    st = solve_like_conic_ip(staged[t], spec, kkt)
                    np.asarray(st.Iter)  # waits for the device
                    times.append(time.perf_counter() - t0)
                    iters.append(int(st.Iter))
                    stat.append(STATUS_NAMES[int(st.status)])
                med = statistics.median(times)
                it = iters[len(iters) // 2]
                row = dict(problem=name, backend=bname,
                           median_s=round(med, 6), iters=it,
                           ms_per_iter=round(med / max(it, 1) * 1e3, 4),
                           status=stat[0])
            except Exception as e:  # noqa: BLE001 — record and continue
                row = dict(problem=name, backend=bname, median_s=None,
                           iters=None, ms_per_iter=None,
                           status=f"failed: {type(e).__name__}")
            results.append(row)
            print(f"{name:34s} {bname:6s} "
                  f"{row['median_s'] if row['median_s'] is not None else '—':>10} s  "
                  f"iters={row['iters']}  status={row['status']}")

    if args.trace:
        import jax.profiler

        p = ALL_GENERATORS[1](seed=7)
        spec = ConeSpec(p.cone_dims)
        staged = tuple(jax.device_put(jnp.asarray(x)) for x in (
            p.Q, p.c, p.A, p.b,
            np.zeros((0, len(p.c))), np.zeros(0)))
        kkt = _default_kktsolver(factor_dtype)
        jax.block_until_ready(
            _solve_jit(*staged, spec=spec, kktsolver=kkt, opts=opts))
        with jax.profiler.trace(args.trace):
            jax.block_until_ready(
                _solve_jit(*staged, spec=spec, kktsolver=kkt, opts=opts))
        print(f"trace written to {args.trace}", file=sys.stderr)

    if args.json:
        with open(args.json, "w") as f:
            json.dump(results, f, indent=1)
        print(f"report written to {args.json}", file=sys.stderr)


def _pick_generators(args):
    from conicip_tpu.models import ALL_GENERATORS

    if not getattr(args, "families", None):
        return ALL_GENERATORS
    pats = [p.strip() for p in args.families.split(",") if p.strip()]
    # match on the static family_name attribute — instantiating every
    # family just to read .name builds full dense problem matrices for
    # nothing (and larger_sdp's instance name is "small_sdp(k=30)", so
    # the function __name__ alone cannot serve the battery's patterns)
    picked = [g for g in ALL_GENERATORS
              if any(p in g.family_name for p in pats)]
    if not picked:
        raise SystemExit(f"no family matches {pats}")
    return picked


def _run_chained(args, opts, ladder) -> None:
    """Per-family timing: chain K full solves — the fast path plus the
    escalation ladder as in-jit ``lax.cond`` branches (the same policy
    conic_ip applies on host) — inside ONE jit per family, and difference
    a K-solve and a 2K-solve chain so the fixed dispatch cost cancels."""
    import time as _time
    from dataclasses import replace as dc_replace

    import jax
    import jax.numpy as jnp

    from conicip_tpu.cones.spec import ConeSpec
    from conicip_tpu.models import ALL_GENERATORS
    from conicip_tpu.solver import _default_kktsolver
    from conicip_tpu.solver.ipm import ipm_solve
    from conicip_tpu.solver.state import Status, Vec4

    K = args.chained
    fast_fd = jnp.float32 if args.factor_dtype == "float32" else None
    (kkt_mid, opts_mid), (kkt_f64, opts_f64) = ladder

    print(f"# chained mode: per-family rate = DIFFERENCE between a "
          f"{2 * K}-solve and a {K}-solve chain (one jit each, full "
          f"solves: fast path + in-jit backstop ladder). "
          f"Equality-constrained families "
          + ("use the production null-space elimination (one-time host QR "
             "per instance, excluded like any other staging cost)"
             if args.factor_dtype == "float32"
             else "run the direct f64 saddle path (no elimination)"),
          file=sys.stderr)

    results = []
    for gen in _pick_generators(args):
        probs = [gen(seed=42 + t) for t in range(2 * K)]
        name = probs[0].name
        n = len(probs[0].c)

        # production equality handling under f32 factors: null-space
        # elimination (solver/__init__.py eliminateEqualities) — a
        # one-time host transform per instance, done at staging; the
        # chained jit then solves the reduced problems.
        eliminated = (
            fast_fd is not None
            and probs[0].G is not None
            and probs[0].G.shape[0] > 0
        )
        if eliminated:
            from conicip_tpu.reduce import eliminate_equalities

            reds = [
                eliminate_equalities(
                    np.asarray(p.Q), np.asarray(p.c), np.asarray(p.A),
                    np.asarray(p.b), np.asarray(p.G), np.asarray(p.d),
                )
                for p in probs
            ]
            probs = [
                type(p)(name=p.name, Q=r.Q, c=r.c, A=r.A, b=r.b,
                        cone_dims=p.cone_dims, G=None, d=None)
                for p, r in zip(probs, reds)
            ]
            n = len(probs[0].c)

        spec = ConeSpec(probs[0].cone_dims)

        def stk(get, fill):
            return jnp.asarray(np.stack([
                np.asarray(get(p)) if get(p) is not None else fill
                for p in probs
            ]))

        staged = tuple(jax.device_put(x) for x in (
            stk(lambda p: p.Q, None), stk(lambda p: p.c, None),
            stk(lambda p: p.A, None), stk(lambda p: p.b, None),
            stk(lambda p: p.G, np.zeros((0, n))),
            stk(lambda p: p.d, np.zeros(0)),
        ))
        # production default backend for this family (auto structure
        # exploitation, host-side check — solver/__init__.py)
        from conicip_tpu.solver import _auto_kktsolver

        G0 = probs[0].G if probs[0].G is not None else np.zeros((0, n))
        kkt_fast = _auto_kktsolver(probs[0].Q, probs[0].A, G0, spec, fast_fd)
        # mirror conic_ip's production auto: 1 Gondzio corrector on the
        # dense-Schur path, 0 on the diag backend
        from conicip_tpu.kkt.diag import kktsolver_diag as _kd

        _is_diag = kkt_fast is _kd or getattr(kkt_fast, "func", None) is _kd
        _Kc = 0 if _is_diag else 1
        opts = dc_replace(opts, centralityCorrectors=_Kc)
        opts_mid = dc_replace(opts_mid, centralityCorrectors=_Kc)
        opts_f64 = dc_replace(opts_f64, centralityCorrectors=_Kc)

        def max_resid(s):
            return jnp.maximum(s.prFeas, jnp.maximum(s.duFeas, s.muFeas))

        import functools as _ft

        @_ft.partial(jax.jit, static_argnames=("count",))
        def solve_all(Qs, cs, As, bs, Gs, ds, count, spec=spec):
            def one(i):
                Q, c, A, b, G, d = Qs[i], cs[i], As[i], bs[i], Gs[i], ds[i]
                st = ipm_solve(Q, c, A, b, G, d, spec, kkt_fast, opts)

                def tier(st0, kkt_next, opts_next):
                    need = (st0.status == Status.ABANDONED) | (
                        st0.status == Status.ERROR)

                    def go(s):
                        # warm start from the best iterate; scrub a
                        # non-finite one back to a cold-ish start (same
                        # policy as conic_ip's host ladder)
                        ok = (jnp.all(jnp.isfinite(s.y))
                              & jnp.all(jnp.isfinite(s.v))
                              & jnp.all(jnp.isfinite(s.w)))
                        y = jnp.where(ok, s.y, jnp.zeros_like(s.y))
                        w = jnp.where(ok, s.w, jnp.zeros_like(s.w))
                        v = jnp.where(ok, s.v, jnp.ones_like(s.v))
                        warm = Vec4(y, w, v,
                                    jnp.matmul(A, y, precision=jax.lax.Precision.HIGHEST) - b)
                        s1 = ipm_solve(Q, c, A, b, G, d, spec, kkt_next,
                                       opts_next, warm=warm)
                        better = (max_resid(s1) <= max_resid(s)) | (
                            (s1.status != Status.ABANDONED)
                            & (s1.status != Status.ERROR))
                        merged = jax.tree_util.tree_map(
                            lambda a_, b_: jnp.where(better, a_, b_), s1, s)
                        # report total IP iterations across tiers
                        return dc_replace(merged, Iter=s.Iter + s1.Iter)

                    return jax.lax.cond(need, go, lambda s: s, st0)

                st = tier(st, kkt_mid, opts_mid)
                st = tier(st, kkt_f64, opts_f64)
                return st

            def body(i, acc):
                iters, resid, nopt = acc
                st = one(i)
                return (iters + st.Iter,
                        jnp.maximum(resid, max_resid(st)),
                        nopt + jnp.where(st.status == Status.OPTIMAL, 1, 0))

            return jax.lax.fori_loop(
                0, count, body,
                (jnp.int32(0), jnp.float64(0.0), jnp.int32(0)))

        def timed(count):
            out = tuple(
                np.asarray(x) for x in solve_all(*staged, count=count)
            )  # warmup/compile
            best = np.inf
            for _ in range(args.trials):
                t0 = _time.perf_counter()
                out = tuple(
                    np.asarray(x) for x in solve_all(*staged, count=count)
                )
                best = min(best, _time.perf_counter() - t0)
            return best, out

        try:
            tK, outK = timed(K)
            t2K, out2K = timed(2 * K)
            elapsed = t2K - tK
            iters = int(out2K[0]) - int(outK[0])
            solves = K
            resid = float(out2K[1])
            nopt, nall = int(out2K[2]), 2 * K
            method = "chain-differenced"
            if elapsed <= 0 or iters <= 0:
                raise RuntimeError(
                    f"the {2 * K}-solve chain was not slower than the "
                    f"{K}-solve chain; no rate")
            row = dict(problem=name, backend="production(chained)",
                       solves=solves, n_optimal=nopt, n_solves_total=nall,
                       s_per_solve=round(elapsed / solves, 6),
                       iters_per_solve=round(iters / solves, 2),
                       ms_per_iter=round(elapsed / max(iters, 1) * 1e3, 4),
                       max_resid=resid, method=method,
                       status="Optimal" if nopt == nall else "mixed")
            print(f"{name:34s} {row['s_per_solve']:>10.6f} s/solve  "
                  f"iters/solve={row['iters_per_solve']}  "
                  f"optimal={nopt}/{nall}  max_resid={resid:.2e}")
        except Exception as e:  # noqa: BLE001 — record and continue
            row = dict(problem=name, backend="production(chained)",
                       solves=K, status=f"failed: {type(e).__name__}")
            print(f"{name:34s} failed: {type(e).__name__}: {e}")
        results.append(row)

    if args.json:
        with open(args.json, "w") as f:
            json.dump(results, f, indent=1)
        print(f"report written to {args.json}", file=sys.stderr)


if __name__ == "__main__":
    main()
