"""Static-slice segment access for cone groups.

Gathers/scatters with explicit index arrays lower to real gather/scatter
HLOs, and the cone-algebra layer does several per Jordan op. Whenever a
segment is
a consecutive index run (always true for single-type cone products, and for
any ``cone_dims`` ordering that keeps same-typed cones adjacent), these
helpers use static slices and ``.at[a:b].set`` (→ dynamic-update-slice),
which are effectively free. The index-array path remains as the general
fallback for interleaved cone orders.

All helpers treat the LAST axis as the cone axis so they work for vectors
``(m,)`` and for matrices processed column-major as ``(m, n)`` via the
leading axis (see ``take_rows``/``put_rows``).
"""

from __future__ import annotations

import jax.numpy as jnp

from .spec import ConeSpec

__all__ = [
    "take_r",
    "put_r",
    "take_group",
    "put_group",
    "take_rows_r",
    "put_rows_r",
    "take_rows_group",
    "put_rows_group",
]

# Above this many runs, one gather beats a chain of slices.
_MAX_RUNS = 8


def take_r(spec: ConeSpec, x):
    """x restricted to the R coordinates, shape (nr,)."""
    runs = spec.r_runs
    if len(runs) == 1:
        a, b = runs[0]
        return x[a:b]
    if 1 < len(runs) <= _MAX_RUNS:
        return jnp.concatenate([x[a:b] for a, b in runs])
    return x[spec.r_idx]


def put_r(spec: ConeSpec, o, val):
    """o with the R coordinates replaced by val (aligned with take_r)."""
    runs = spec.r_runs
    if len(runs) <= _MAX_RUNS:
        pos = 0
        for a, b in runs:
            o = o.at[a:b].set(val[pos : pos + (b - a)])
            pos += b - a
        return o
    return o.at[spec.r_idx].set(val)


def take_group(g, x):
    """x restricted to one cone group, shape (count, dim)."""
    if g.contig is not None:
        k, t = g.idx.shape
        return x[g.contig : g.contig + k * t].reshape(k, t)
    return x[g.idx]


def put_group(g, o, val):
    if g.contig is not None:
        k, t = g.idx.shape
        return o.at[g.contig : g.contig + k * t].set(val.reshape(k * t))
    return o.at[g.idx].set(val)


# ── Row-indexed variants for (m, n) matrices (NT scaling applied to A) ──


def take_rows_r(spec: ConeSpec, X):
    runs = spec.r_runs
    if len(runs) == 1:
        a, b = runs[0]
        return X[a:b]
    if 1 < len(runs) <= _MAX_RUNS:
        return jnp.concatenate([X[a:b] for a, b in runs], axis=0)
    return X[spec.r_idx]


def put_rows_r(spec: ConeSpec, O, val):
    runs = spec.r_runs
    if len(runs) <= _MAX_RUNS:
        pos = 0
        for a, b in runs:
            O = O.at[a:b].set(val[pos : pos + (b - a)])
            pos += b - a
        return O
    return O.at[spec.r_idx].set(val)


def take_rows_group(g, X):
    """X rows restricted to one cone group, shape (count, dim, n)."""
    if g.contig is not None:
        k, t = g.idx.shape
        seg = X[g.contig : g.contig + k * t]
        return seg.reshape((k, t) + X.shape[1:])
    return X[g.idx]


def put_rows_group(g, O, val):
    if g.contig is not None:
        k, t = g.idx.shape
        return O.at[g.contig : g.contig + k * t].set(
            val.reshape((k * t,) + O.shape[1:])
        )
    return O.at[g.idx].set(val)
