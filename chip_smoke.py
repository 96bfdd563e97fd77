#!/usr/bin/env python
"""Start-up proof of the solver on an NVIDIA GPU.

Drives the production entry points (``conic_ip``, ``solve_batch``,
``preprocess_conic_ip``) on one card and checks every answer by the
repository's own means:

  phase 0  the device: every JAX device is a GPU; card name and power limit
  phase 1  the reference's eight profile families at their default sizes,
           each compared with the same call on the CPU of this process
  phase 2  realistic sizes: box_qp_dense(n=4096) (dense Schur, ~1 GB of f64
           state), the README's n=1000 box QP (diagonal backend), and the
           opt-in f32-factor path on box_qp_dense(n=1000) and mixed_rq_eq
  phase 3  solve_batch on the four batched families at B=64, each compared
           with single conic_ip solves on the card
  phase 4  the Miles regression datasets 1-3 through preprocess_conic_ip
  phase 5  the kernels at real widths: the Ozaki-sliced products of
           ops/precise.py and the f64 Cholesky / triangular inverse /
           cho_solve of ops/cholesky.py, against numpy

Tolerances, and why:

- Optimal solves must report max(prFeas, duFeas, muFeas) < 1e-6 (the
  solver's optTol). The numpy f64 recomputation from the returned y, w, v
  must give primal cone distance, equality residual and dual residual
  < 1e-6 on the same normalisations, and a duality gap |vᵀ(Ay−b)| /
  (1+|cᵀy|) < √ν·1e-6 (ν the cone degree: the solver stops on ‖λ∘λ‖₂ and
  vᵀs = Σ(λ∘λ) ≤ √ν‖λ∘λ‖₂).
- Card against CPU (phase 1): the same algorithm on both, so the same
  status, objectives within 1e-6·(1+|obj|), ‖Δy‖ ≤ 1e-5·(1+‖y‖), and
  iterations within ±1 — summation order differs on the card.
- Batched against single solves (phase 3): the single solve gets the
  batched path's corrector count, so both run the same iteration up to
  rounding: the same status, objectives within 1e-6·(1+|obj|) and
  ‖Δy‖ ≤ 1e-5·(1+‖y‖). (Different corrector counts stop at different
  points of the central path, and y is fixed only to O(√μ) there.)
- Kernels (phase 5): sliced products equal to the CPU's within 1e-14 and
  to numpy's within 5e-14·√cols, each × row scale × ‖x‖∞ (see
  check_precise); ‖LLᵀ−M‖/‖M‖, ‖WL−I‖/‖I‖ and the cho_solve
  residual within 1e-13 on a well-conditioned SPD matrix.

``--cards 4`` runs only the multi-card path and what it is compared with:
solve_batch over a 4-card mesh against one card, and the tensor-parallel
Schur solver against the one-card default solve.

Run on the card:   python chip_smoke.py            (or --cards 4)
The last line of standard output is one JSON object,
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``;
any failed phase exits non-zero before it, as does a process without a GPU.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
TOL = 1e-6


class PhaseFailed(RuntimeError):
    pass


def log(*args):
    print(*args, flush=True)


def check(ok, msg):
    if not ok:
        raise PhaseFailed(msg)


# ─────────────────────────────────────────────────────────────────────
#  Independent certificate (numpy f64, from the cone list alone)
# ─────────────────────────────────────────────────────────────────────


def _unpack_sym(x):
    """Symmetric matrix from the packed √2-scaled row-major upper triangle."""
    d = int(round((math.isqrt(1 + 8 * len(x)) - 1) / 2))
    X = np.zeros((d, d))
    k = 0
    for i in range(d):
        for j in range(i, d):
            X[i, j] = X[j, i] = x[k] if i == j else x[k] / math.sqrt(2.0)
            k += 1
    return X


def cone_distance(x, cone_dims):
    """Euclidean distance from x to the cone product (self-dual cones)."""
    sq, pos = 0.0, 0
    for kind, dim in cone_dims:
        seg = np.asarray(x[pos:pos + dim], float)
        pos += dim
        if kind == "R":
            sq += float(np.sum(np.minimum(seg, 0.0) ** 2))
        elif kind == "Q":
            t, u = seg[0], np.linalg.norm(seg[1:])
            if u <= -t:
                sq += float(seg @ seg)
            elif u > t:
                sq += 0.5 * (u - t) ** 2
        elif kind == "S":
            w = np.linalg.eigvalsh(_unpack_sym(seg))
            sq += float(np.sum(np.minimum(w, 0.0) ** 2))
        else:
            raise ValueError(kind)
    return math.sqrt(sq)


def cone_degree(cone_dims):
    nu = 0
    for kind, dim in cone_dims:
        nu += dim if kind == "R" else 1 if kind == "Q" else int(
            round((math.isqrt(1 + 8 * dim) - 1) / 2))
    return nu


def certificate(Q, c, A, b, cone_dims, G, d, y, w, v):
    """Residuals of (y, w, v) recomputed in numpy f64; each is normalised
    like the solver's own (ConicIP.jl:757-766)."""
    Q, c, A, b = (np.asarray(x, float) for x in (Q, c, A, b))
    n = c.shape[0]
    G = np.zeros((0, n)) if G is None else np.asarray(G, float)
    d = np.zeros(0) if d is None else np.asarray(d, float)
    y, v = np.asarray(y, float), np.asarray(v, float)
    w = np.zeros(G.shape[0]) if w is None else np.asarray(w, float)
    s = A @ y - b
    r = {
        "primal": cone_distance(s, cone_dims) / (1 + np.linalg.norm(b)),
        "equality": (np.linalg.norm(G @ y - d) / (1 + np.linalg.norm(d))
                     if G.shape[0] else 0.0),
        "dual": np.linalg.norm(Q @ y + G.T @ w - A.T @ v - c)
        / (1 + np.linalg.norm(c)),
        "dual_cone": cone_distance(v, cone_dims) / (1 + np.linalg.norm(v)),
        "gap": abs(float(v @ s)) / (1 + abs(float(c @ y))),
    }
    r = {k: float(x) for k, x in r.items()}
    gap_bound = math.sqrt(cone_degree(cone_dims)) * TOL
    r["ok"] = bool(max(r["primal"], r["equality"], r["dual"],
                       r["dual_cone"]) < TOL and r["gap"] < gap_bound)
    return r


def certify(label, prob, sol):
    """Optimal, reported residuals < TOL, and the numpy certificate."""
    check(sol.status == "Optimal", f"{label}: status {sol.status}")
    rep = max(sol.prFeas, sol.duFeas, sol.muFeas)
    check(rep < TOL, f"{label}: reported residual {rep:.2e} >= {TOL:g}")
    cert = certificate(prob.Q, prob.c, prob.A, prob.b, prob.cone_dims,
                       prob.G, prob.d, sol.y, sol.w, sol.v)
    check(cert["ok"], f"{label}: numpy certificate failed {cert}")
    return rep, cert


def _maxres(c):
    return max(c["primal"], c["equality"], c["dual"], c["dual_cone"])


# ─────────────────────────────────────────────────────────────────────
#  Phases. Each takes the device(s) to run on and a size, so that the CPU
#  tests can call them at small sizes.
# ─────────────────────────────────────────────────────────────────────


def backend_name(prob):
    """The KKT backend conic_ip's auto selection picks for ``prob``."""
    from conicip_tpu.cones.spec import ConeSpec
    from conicip_tpu.solver import _auto_kktsolver, resolve_factor_dtype

    n = len(prob.c)
    G = prob.G if prob.G is not None else np.zeros((0, n))
    k = _auto_kktsolver(prob.Q, prob.A, G, ConeSpec(prob.cone_dims),
                        resolve_factor_dtype("auto"))
    name = getattr(getattr(k, "func", k), "__qualname__", repr(k))
    for tag in ("diag", "spectral", "schur", "lowrank"):
        if tag in name:
            return tag
    return name


def timed_solve(fn, device):
    """Run ``fn`` twice on ``device``; returns (result, warm seconds)."""
    import jax

    with jax.default_device(device):
        fn()
        t0 = time.perf_counter()
        out = fn()
        return out, time.perf_counter() - t0


FAMILY_SMALL = {
    "box_qp_dense": dict(n=20),
    "box_qp_sparse": dict(n=30),
    "single_soc": dict(n=20),
    "many_small_socs": dict(n=24, k=8),
    "small_sdp": dict(k=4),
    "larger_sdp": dict(k=6),
    "mixed_rq_eq": dict(),
    "mixed_rqs": dict(),
}


def family_problem(name, small=False, seed=42):
    from conicip_tpu.models import generators as gen

    return getattr(gen, name)(seed=seed,
                              **(FAMILY_SMALL[name] if small else {}))


def check_family(name, device, ref_device, small=False, verbose=False):
    """Phase 1 for one family: solve on ``device`` with every default,
    certify, and compare with the same call on ``ref_device``."""
    import jax

    import conicip_tpu as ct

    p = family_problem(name, small)
    sol, warm = timed_solve(lambda: ct.conic_ip(*p.args()), device)
    rep, cert = certify(name, p, sol)
    if verbose:  # the iteration table, through jax.debug.callback
        with jax.default_device(device):
            loud = ct.conic_ip(*p.args(), verbose=True)
        check(loud.status == sol.status and loud.Iter == sol.Iter,
              f"{name}: verbose solve differs ({loud.status}, {loud.Iter})")
    ref, _ = timed_solve(lambda: ct.conic_ip(*p.args()), ref_device)
    check(ref.status == sol.status,
          f"{name}: status {sol.status} vs reference {ref.status}")
    for o, oref in ((sol.pobj, ref.pobj), (sol.dobj, ref.dobj)):
        check(abs(o - oref) <= 1e-6 * (1 + abs(oref)),
              f"{name}: objective {o!r} vs reference {oref!r}")
    dy = float(np.linalg.norm(sol.y - ref.y))
    check(dy <= 1e-5 * (1 + np.linalg.norm(ref.y)),
          f"{name}: |dy| {dy:.2e} against the reference")
    check(abs(sol.Iter - ref.Iter) <= 1,
          f"{name}: {sol.Iter} iterations vs reference {ref.Iter}")
    return dict(family=p.name, backend=backend_name(p), iters=sol.Iter,
                ref_iters=ref.Iter, warm_s=warm, resid=rep,
                cert=_maxres(cert), dy=dy)


FAMILIES = ("box_qp_dense", "box_qp_sparse", "single_soc", "many_small_socs",
            "small_sdp", "larger_sdp", "mixed_rq_eq", "mixed_rqs")


def phase_families(device, ref_device, small=False):
    rows = []
    for name in FAMILIES:
        row = check_family(name, device, ref_device, small,
                           verbose=name == "mixed_rqs")
        rows.append(row)
        log(f"  {row['family']:30s} backend={row['backend']:8s} "
            f"iters={row['iters']} (cpu {row['ref_iters']}) "
            f"warm={row['warm_s'] * 1e3:.1f} ms resid={row['resid']:.1e} "
            f"cert={row['cert']:.1e} |dy|={row['dy']:.1e}")
    return rows


def phase_large(device, n_dense=4096, n_diag=1000, n_f32=1000, small=False):
    """Phase 2: realistic sizes, checked by the numpy certificate."""
    import jax.numpy as jnp

    import conicip_tpu as ct
    from conicip_tpu.models import generators as gen

    runs = [
        (f"box_qp_dense(n={n_dense})", gen.box_qp_dense(n=n_dense), {}),
        (f"box_qp_sparse(n={n_diag})", gen.box_qp_sparse(n=n_diag), {}),
        (f"box_qp_dense(n={n_f32}) f32", gen.box_qp_dense(n=n_f32),
         dict(factor_dtype=jnp.float32)),
        ("mixed_rq_eq f32", family_problem("mixed_rq_eq", small),
         dict(factor_dtype=jnp.float32)),
    ]
    rows = []
    for label, p, kw in runs:
        sol, warm = timed_solve(lambda: ct.conic_ip(*p.args(), **kw), device)
        rep, cert = certify(label, p, sol)
        rows.append(dict(run=label, backend=backend_name(p), iters=sol.Iter,
                         warm_s=warm, resid=rep, cert=_maxres(cert)))
        log(f"  {label:30s} backend={rows[-1]['backend']:8s} "
            f"iters={sol.Iter} warm={warm * 1e3:.1f} ms resid={rep:.1e} "
            f"cert={_maxres(cert):.1e}")
    stats = device.memory_stats() or {}
    log(f"  peak_bytes_in_use={stats.get('peak_bytes_in_use', 'n/a')}")
    return rows


class _Inst:
    """One instance of a stacked batch, shaped like a generator Problem."""

    def __init__(self, Q, c, A, b, cones, G, d):
        self.Q, self.c, self.A, self.b = Q, c, A, b
        self.cone_dims, self.G, self.d = cones, G, d

    def args(self):
        return (self.Q, self.c, self.A, self.b, self.cone_dims, self.G,
                self.d)


def batched_problem(name, batch, small=False):
    """Stacked data of the batched families at the benchmark's shapes
    (tools/bench_batched.py): returns (Q, c, A, b, cones, G, d)."""
    from conicip_tpu.models import generators as gen

    if name == "batched_box_qp":
        return gen.batched_box_qp(batch, n=20 if small else 500) + (None,
                                                                    None)
    if name == "batched_small_sdp":
        return gen.batched_small_sdp(batch, k=4 if small else 10) + (None,
                                                                     None)
    if name == "batched_mixed_rqs":
        return gen.batched_mixed_rqs(batch) + (None, None)
    if name == "batched_mixed_rq_eq":
        shape = dict(n=30, n_q=6, p=3) if small else dict(n=200, n_q=51,
                                                          p=10)
        return gen.batched_mixed_rq_eq(batch, **shape)
    raise ValueError(name)


def instance(data, i):
    Q, c, A, b, cones, G, d = data
    return _Inst(Q[i], c[i], A[i], b[i], cones, G,
                 None if d is None else d[i])


BATCHED = ("batched_box_qp", "batched_small_sdp", "batched_mixed_rqs",
           "batched_mixed_rq_eq")


def check_batched(name, device, batch=64, n_single=4, small=False):
    """Phase 3 for one family: solve_batch on ``device``, every instance
    certified, ``n_single`` of them compared with single conic_ip solves."""
    import conicip_tpu as ct

    data = batched_problem(name, batch, small)
    Q, c, A, b, cones, G, d = data
    bs, warm = timed_solve(lambda: ct.solve_batch(Q, c, A, b, cones, G, d),
                           device)
    worst = 0.0
    for i in range(batch):
        sol = _batch_row(bs, i)
        _, cert = certify(f"{name}[{i}]", instance(data, i), sol)
        worst = max(worst, _maxres(cert))
    # solve_batch runs no centrality corrector on S-cone specs; conic_ip
    # runs one wherever it factors a dense system
    kw = ({"centralityCorrectors": 0}
          if any(k == "S" for k, _ in cones) else {})
    worst_dy = 0.0
    for i in range(n_single):
        inst = instance(data, i)
        single, _ = timed_solve(lambda: ct.conic_ip(*inst.args(), **kw),
                                device)
        row = _batch_row(bs, i)
        check(single.status == row.status,
              f"{name}[{i}]: batched {row.status} vs single {single.status}")
        check(abs(row.pobj - single.pobj) <= 1e-6 * (1 + abs(single.pobj)),
              f"{name}[{i}]: pobj {row.pobj!r} vs single {single.pobj!r}")
        dy = float(np.linalg.norm(row.y - single.y))
        check(dy <= 1e-5 * (1 + np.linalg.norm(single.y)),
              f"{name}[{i}]: |dy| {dy:.2e} against the single solve")
        worst_dy = max(worst_dy, dy)
    return dict(family=name, batch=batch, iters_max=int(bs.Iter.max()),
                iters_mean=float(bs.Iter.mean()), warm_s=warm, cert=worst,
                dy=worst_dy)


def _batch_row(bs, i):
    from conicip_tpu.solver.state import Solution

    return Solution(y=bs.y[i], w=bs.w[i], v=bs.v[i],
                    status=bs.statuses[i], Iter=int(bs.Iter[i]),
                    Mu=float(bs.Mu[i]), prFeas=float(bs.prFeas[i]),
                    duFeas=float(bs.duFeas[i]), muFeas=float(bs.muFeas[i]),
                    pobj=float(bs.pobj[i]), dobj=float(bs.dobj[i]))


def phase_batched(device, batch=64, small=False):
    rows = []
    for name in BATCHED:
        row = check_batched(name, device, batch, small=small)
        rows.append(row)
        log(f"  {name:22s} B={batch} iters max={row['iters_max']} "
            f"mean={row['iters_mean']:.1f} warm={row['warm_s'] * 1e3:.1f} ms "
            f"({batch / row['warm_s']:.1f} solves/s) cert={row['cert']:.1e} "
            f"|dy| vs single={row['dy']:.1e}")
    return rows


def phase_miles(device, kappas=(1e-4, 1.0, 1e4)):
    """Phase 4: the reference's regression datasets; statuses must be
    Optimal / Infeasible / Optimal under every data scaling κ."""
    import jax

    sys.path.insert(0, os.path.join(REPO, "tests"))
    from miles import load_miles, mpb_to_conicip

    from conicip_tpu.preprocess import preprocess_conic_ip

    expected = {1: "Optimal", 2: "Infeasible", 3: "Optimal"}
    rows = []
    with jax.default_device(device):
        for idx, want in expected.items():
            c, A, b, con, var = load_miles(idx)
            for kappa in kappas:
                args = mpb_to_conicip(kappa * c, kappa * A, kappa * b, con,
                                      var)
                sol = preprocess_conic_ip(*args)
                check(sol.status == want,
                      f"miles{idx}(kappa={kappa:g}): {sol.status}, want {want}")
                if want == "Optimal":
                    rep = max(sol.prFeas, sol.duFeas, sol.muFeas)
                    check(rep < TOL, f"miles{idx}(kappa={kappa:g}): resid "
                          f"{rep:.2e}")
                rows.append((idx, kappa, sol.status, sol.Iter))
                log(f"  miles{idx}(kappa={kappa:g}) {sol.status} "
                    f"iters={sol.Iter}")
    return rows


def check_precise(device, rows, cols, seed=0):
    """Ozaki-sliced product (ops/precise.PreciseMatvec) on ``device``.

    Its slice products run at DEFAULT matmul precision (TF32 on the card's
    tensor cores) and are exact only because every slice is a small
    integer. So the result must match the same product on this process's
    CPU to 1e-14 of row scale × ‖x‖∞ (only the f64 combination order may
    differ), and a numpy f64 product to 5e-14·√cols of it: the dropped
    slice pairs weigh ≤ 2^-51 and the x remainder ≤ 2^-50 of the
    power-of-two scales (≤ 16 × row scale × ‖x‖∞), and with random signs
    they add up as √cols. Returns the worst error as a fraction of each
    bound."""
    import jax
    import jax.numpy as jnp

    from conicip_tpu.ops.precise import PreciseMatvec

    rng = np.random.default_rng(seed)
    # rows of widely different scales, as in a KKT operator
    A = rng.standard_normal((rows, cols)) * np.logspace(-3, 3, rows)[:, None]
    x = rng.standard_normal(cols)
    out = []
    for dev in (device, jax.devices("cpu")[0]):
        with jax.default_device(dev):
            f = jax.jit(lambda A, x: PreciseMatvec(A)(x))
            out.append(np.asarray(f(jnp.asarray(A), jnp.asarray(x))))
    scale = np.max(np.abs(A), axis=1) * np.max(np.abs(x))
    exact = float(np.max(np.abs(out[0] - out[1]) / (1e-14 * scale)))
    acc = float(np.max(np.abs(out[0] - A @ x) / (
        5e-14 * math.sqrt(cols) * scale)))
    check(exact <= 1.0, f"PreciseMatvec({rows}x{cols}): card and CPU differ "
          f"by {exact:.2f}x 1e-14 of scale: the slice products are not exact")
    check(acc <= 1.0, f"PreciseMatvec({rows}x{cols}): error {acc:.2f}x its "
          "bound")
    return exact, acc


def check_cholesky(device, n, seed=0):
    """ops/cholesky in f64 against numpy: ‖LLᵀ−M‖/‖M‖, ‖WL−I‖/‖I‖ and the
    cho_solve residual ‖Mx−r‖/(‖M‖‖x‖), each ≤ 1e-13. Returns them."""
    import jax
    import jax.numpy as jnp

    from conicip_tpu.ops.cholesky import cho_solve, cholesky, tri_inv

    rng = np.random.default_rng(seed)
    B = rng.standard_normal((n, n))
    M = B @ B.T / n + np.eye(n)
    r = rng.standard_normal(n)
    with jax.default_device(device):
        L, W, x = jax.jit(lambda M, r: (
            lambda L: (L, tri_inv(L), cho_solve(L, r)))(cholesky(M)))(
                jnp.asarray(M), jnp.asarray(r))
        L, W, x = np.asarray(L), np.asarray(W), np.asarray(x)
    nM = np.linalg.norm(M)
    errs = {
        "factor": float(np.linalg.norm(L @ L.T - M) / nM),
        "tri_inv": float(np.linalg.norm(W @ L - np.eye(n)) / math.sqrt(n)),
        "cho_solve": float(np.linalg.norm(M @ x - r)
                           / (nM * np.linalg.norm(x))),
    }
    check(max(errs.values()) <= 1e-13, f"cholesky(n={n}): {errs}")
    return errs


def phase_kernels(device, small=False):
    shapes = ((40, 20), (64, 2100)) if small else ((2000, 1000), (8192, 4096))
    for rows, cols in shapes:
        exact, acc = check_precise(device, rows, cols)
        log(f"  PreciseMatvec {rows}x{cols}: card vs CPU {exact:.3f} of its "
            f"bound, vs numpy {acc:.3f} of its bound")
    n = 64 if small else 4096
    errs = check_cholesky(device, n)
    log(f"  f64 cholesky/tri_inv/cho_solve n={n}: " + ", ".join(
        f"{k} {v:.1e}" for k, v in errs.items()))


# ─────────────────────────────────────────────────────────────────────
#  Four cards
# ─────────────────────────────────────────────────────────────────────


def check_batch_mesh(name, devices, batch, small=False):
    """solve_batch over a mesh of ``devices`` against the same batch on
    ``devices[0]`` alone: same statuses, y within 1e-8."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec

    import conicip_tpu as ct

    data = batched_problem(name, batch, small)
    Q, c, A, b, cones, G, d = data
    mesh = ct.make_mesh((len(devices),), ("batch",), devices=devices)
    shard = NamedSharding(mesh, PartitionSpec("batch"))
    rows = [s.data.shape[0] for s in jax.device_put(Q, shard).addressable_shards]
    log(f"  {name}: instances per card {rows}")
    check(rows == [batch // len(devices)] * len(devices),
          f"{name}: uneven shards {rows}")
    multi, warm = timed_solve(
        lambda: ct.solve_batch(Q, c, A, b, cones, G, d, mesh=mesh,
                               batch_axis="batch"), devices[0])
    # read before the one-card run, which adds to card 0 only
    peaks = [(dev.memory_stats() or {}).get("peak_bytes_in_use")
             for dev in devices]
    one, warm1 = timed_solve(
        lambda: ct.solve_batch(Q, c, A, b, cones, G, d), devices[0])
    check(multi.statuses == one.statuses, f"{name}: statuses differ")
    check(all(s == "Optimal" for s in multi.statuses),
          f"{name}: not all Optimal")
    dy = float(np.max(np.abs(multi.y - one.y)))
    check(dy <= 1e-8, f"{name}: max |dy| {dy:.2e} between mesh and one card")
    log(f"  {name} B={batch}: mesh {warm * 1e3:.1f} ms, one card "
        f"{warm1 * 1e3:.1f} ms, max|dy|={dy:.1e}, peak bytes per card "
        f"{peaks}")
    return dict(family=name, dy=dy, peaks=peaks)


def tp_problem(n, p=16, seed=0):
    """The R+Q+equality problem of the multi-device dry run
    (__graft_entry__.dryrun_multichip), at width n."""
    from conicip_tpu.cones.spec import ConeSpec

    cones = [("R", 2 * n), ("Q", 32), ("Q", 32)]
    m = sum(dim for _, dim in cones)
    rng = np.random.default_rng(seed)
    Q = np.diag(1.0 + rng.random(n))
    c = rng.standard_normal(n)
    A = np.vstack([np.eye(n), -np.eye(n),
                   rng.standard_normal((m - 2 * n, n)) * 0.1])
    y0 = rng.standard_normal(n) * 0.1
    b = A @ y0 - np.asarray(ConeSpec(cones).identity)  # strictly feasible
    G = rng.standard_normal((p, n))
    return _Inst(Q, c, A, b, cones, G, G @ y0)


def check_tp(devices, n):
    """kktsolver_schur_tp over a mesh of ``devices`` against the one-card
    solve with the options a user KKT solver gets (no centrality
    corrector): same status, objective within 1e-6·(1+|obj|),
    ‖Δy‖ ≤ 1e-5·(1+‖y‖)."""
    import conicip_tpu as ct

    p = tp_problem(n)
    mesh = ct.make_mesh((len(devices),), ("tp",), devices=devices)
    tp, warm = timed_solve(lambda: ct.conic_ip(
        *p.args(), kktsolver=ct.kktsolver_schur_tp(mesh, "tp")), devices[0])
    certify(f"tp(n={n})", p, tp)
    one, warm1 = timed_solve(
        lambda: ct.conic_ip(*p.args(), centralityCorrectors=0), devices[0])
    check(one.status == tp.status, f"tp: {tp.status} vs one card {one.status}")
    check(abs(tp.pobj - one.pobj) <= 1e-6 * (1 + abs(one.pobj)),
          f"tp: pobj {tp.pobj!r} vs one card {one.pobj!r}")
    dy = float(np.linalg.norm(tp.y - one.y))
    check(dy <= 1e-5 * (1 + np.linalg.norm(one.y)), f"tp: |dy| {dy:.2e}")
    log(f"  schur_tp n={n} m={len(p.b)} p={len(p.d)} over {len(devices)} "
        f"cards: {tp.Iter} iters {warm * 1e3:.1f} ms; one card {one.Iter} "
        f"iters {warm1 * 1e3:.1f} ms; |dy|={dy:.1e}")
    return dy


def phase_cards(devices, small=False):
    check_batch_mesh("batched_box_qp", devices, 16 if small else 256, small)
    check_batch_mesh("batched_mixed_rq_eq", devices, 8 if small else 64,
                     small)
    check_tp(devices, 64 if small else 4096)


# ─────────────────────────────────────────────────────────────────────


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cards", type=int, default=1, choices=(1, 4),
                    help="4: run only the multi-card phases")
    args = ap.parse_args(argv)

    import jax
    import jaxlib

    from conicip_tpu.runtime import (describe_devices, enable_compile_cache,
                                     gpu_card, require_gpu)

    # ── phase 0: the device ──
    try:
        devices = require_gpu(jax.devices())
    except RuntimeError as e:
        print(f"chip_smoke: {e}", file=sys.stderr)
        return 2
    if len(devices) < args.cards:
        print(f"chip_smoke: --cards {args.cards} needs {args.cards} GPUs, "
              f"JAX sees {len(devices)}", file=sys.stderr)
        return 2
    cache = enable_compile_cache()
    log("phase 0: device")
    log(gpu_card())
    log(f"  jax {jax.__version__} jaxlib {jaxlib.__version__} "
        f"x64={jax.config.jax_enable_x64} compile cache {cache}")
    log(f"  {len(devices)} x {devices[0].device_kind}")
    check(jax.config.jax_enable_x64, "x64 is off")
    t_start = time.perf_counter()

    def run(label, fn):
        t0 = time.perf_counter()
        log(label)
        fn()
        log(f"  ({time.perf_counter() - t0:.1f} s)")

    if args.cards == 4:
        cards = devices[:4]
        run("phase cards: solve_batch over a 4-card mesh, schur_tp",
            lambda: phase_cards(cards))
    else:
        dev, cpu = devices[0], jax.devices("cpu")[0]
        run("phase 1: profile families (card vs this process's CPU)",
            lambda: phase_families(dev, cpu))
        run("phase 2: realistic sizes", lambda: phase_large(dev))
        run("phase 3: solve_batch, B=64", lambda: phase_batched(dev))
        run("phase 4: Miles datasets", lambda: phase_miles(dev))
        run("phase 5: kernels at real widths", lambda: phase_kernels(dev))
    log(f"all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"ok": True, "device": describe_devices(
        devices[:args.cards])}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except PhaseFailed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
