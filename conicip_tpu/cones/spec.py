"""Static cone-product metadata.

The reference (``/root/reference/src/ConicIP.jl:519-565``) represents a cone
product ``K = K_1 x ... x K_j`` as a list of ``(type, dim)`` tuples and
dispatches on it with per-cone Julia loops. Under XLA we need *static shapes*
and *batched* kernels instead, so :class:`ConeSpec` precomputes, at trace time:

- the index set of all nonnegative-orthant (``R``) coordinates,
- second-order cones (``Q``) *grouped by dimension* so that every group is a
  dense ``(k, dim)`` batch (250 small SOCs of dim 3 become one ``(250, 3)``
  array — the reference's worst case, ConicIP.jl:571-665, becomes one fused
  batched kernel here),
- semidefinite cones (``S``) grouped by matrix order ``d`` as ``(k, d(d+1)/2)``
  batches, with packed-triangle index maps for ``mat``/``vecm``.

Everything in this module is plain numpy computed once in Python; the JAX
compute path only consumes the frozen index arrays as compile-time constants.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from functools import cached_property, lru_cache
from typing import Sequence, Tuple

import numpy as np

__all__ = ["ConeSpec", "SocGroup", "SdpGroup", "tri_dim", "tri_order"]


def tri_dim(d: int) -> int:
    """Packed dimension of a d x d symmetric matrix: d(d+1)/2."""
    return d * (d + 1) // 2


def tri_order(t: int) -> int:
    """Matrix order from packed length (reference ``ord``, ConicIP.jl:85)."""
    d = int(round((math.isqrt(1 + 8 * t) - 1) / 2))
    if tri_dim(d) != t:
        raise ValueError(f"{t} is not a triangular number d(d+1)/2")
    return d


@lru_cache(maxsize=None)
def tri_indices(d: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Row/col indices of the packed upper triangle in the reference's order.

    The reference ``vecm`` (ConicIP.jl:121-151) walks rows i=1..d and for each
    row the columns j>=i — i.e. row-major upper triangle — scaling off-diagonal
    entries by sqrt(2) so that ``dot(vecm(X), vecm(Y)) == tr(X @ Y)``.

    Returns (rows, cols, scale) as immutable numpy arrays of length d(d+1)/2.
    """
    rows, cols = [], []
    for i in range(d):
        for j in range(i, d):
            rows.append(i)
            cols.append(j)
    rows_a = np.asarray(rows, dtype=np.int32)
    cols_a = np.asarray(cols, dtype=np.int32)
    scale = np.where(rows_a == cols_a, 1.0, math.sqrt(2.0))
    rows_a.setflags(write=False)
    cols_a.setflags(write=False)
    scale.setflags(write=False)
    return rows_a, cols_a, scale


def _contig_start(idx: np.ndarray):
    """Start offset if ``idx.ravel()`` is one consecutive run, else None.

    Gathers/scatters with explicit index arrays lower to real
    gather/scatter HLOs; a consecutive run lowers to a static slice /
    dynamic-update-slice, which is nearly free. Cone groups are consecutive
    whenever same-typed cones are adjacent in ``cone_dims`` — in particular
    always for single-type cone products (the common case).
    """
    flat = idx.ravel()
    if flat.size == 0:
        return 0
    start = int(flat[0])
    if np.array_equal(flat, np.arange(start, start + flat.size, dtype=flat.dtype)):
        return start
    return None


def _runs(idx: np.ndarray) -> Tuple[Tuple[int, int], ...]:
    """Maximal consecutive runs of a sorted index vector as (start, stop)."""
    if idx.size == 0:
        return ()
    breaks = np.nonzero(np.diff(idx) != 1)[0]
    starts = np.concatenate([[0], breaks + 1])
    stops = np.concatenate([breaks + 1, [idx.size]])
    return tuple(
        (int(idx[a]), int(idx[b - 1]) + 1) for a, b in zip(starts, stops)
    )


@dataclass(frozen=True)
class SocGroup:
    """All second-order cones of one dimension, batched."""

    dim: int
    idx: np.ndarray = field(compare=False)  # (k, dim) int32 coordinates into the m-vector
    contig: "int | None" = field(default=None, compare=False)

    @property
    def count(self) -> int:
        return self.idx.shape[0]


@dataclass(frozen=True)
class SdpGroup:
    """All semidefinite cones of one matrix order, batched (packed storage)."""

    order: int
    idx: np.ndarray = field(compare=False)  # (k, order*(order+1)/2) int32
    contig: "int | None" = field(default=None, compare=False)

    @property
    def count(self) -> int:
        return self.idx.shape[0]

    @property
    def tdim(self) -> int:
        return tri_dim(self.order)


class ConeSpec:
    """Frozen, hashable description of a cone product.

    Parameters mirror the reference's ``cone_dims`` argument
    (ConicIP.jl:421-427): a sequence of ``("R"|"Q"|"S", dim)`` tuples, where
    for ``S`` the dim is the *packed* dimension d(d+1)/2.
    """

    def __init__(self, cone_dims: Sequence[Tuple[str, int]]):
        cone_dims = tuple((str(t), int(k)) for (t, k) in cone_dims)
        offset = 0
        r_idx = []
        soc: dict[int, list[np.ndarray]] = {}
        sdp: dict[int, list[np.ndarray]] = {}
        conedim = 0  # sum of barrier degrees (ConicIP.jl:547-552)
        for (ctype, k) in cone_dims:
            if k < 0:
                raise ValueError(f"negative cone dimension {k}")
            rng = np.arange(offset, offset + k, dtype=np.int32)
            if ctype == "R":
                r_idx.append(rng)
                conedim += k
            elif ctype == "Q":
                if k < 1:
                    raise ValueError("Q cone must have dim >= 1")
                soc.setdefault(k, []).append(rng)
                conedim += 1
            elif ctype == "S":
                d = tri_order(k)
                sdp.setdefault(d, []).append(rng)
                conedim += d
            else:
                raise ValueError(f"unknown cone type {ctype!r}")
            offset += k

        self.cone_dims = cone_dims
        self.m = offset
        self.conedim = conedim
        self.r_idx = (
            np.concatenate(r_idx).astype(np.int32) if r_idx else np.zeros(0, np.int32)
        )
        self.r_idx.setflags(write=False)
        self.r_runs = _runs(self.r_idx)
        self.soc_groups = tuple(
            SocGroup(dim=d, idx=_freeze(np.stack(v)),
                     contig=_contig_start(np.stack(v)))
            for d, v in sorted(soc.items())
        )
        self.sdp_groups = tuple(
            SdpGroup(order=d, idx=_freeze(np.stack(v)),
                     contig=_contig_start(np.stack(v)))
            for d, v in sorted(sdp.items())
        )

    # -- identity element -------------------------------------------------
    @cached_property
    def identity(self) -> np.ndarray:
        """The cone-product identity element ``e`` (ConicIP.jl:559-565):
        ones on R blocks, (1, 0, ...) per Q cone, vecm(I) per S cone."""
        e = np.zeros(self.m)
        e[self.r_idx] = 1.0
        for g in self.soc_groups:
            e[g.idx[:, 0]] = 1.0
        for g in self.sdp_groups:
            rows, cols, _ = tri_indices(g.order)
            diag = rows == cols
            e[g.idx[:, diag]] = 1.0
        e.setflags(write=False)
        return e

    @property
    def nr(self) -> int:
        return int(self.r_idx.shape[0])

    @property
    def only_r(self) -> bool:
        """True when the whole product is one contiguous R block — the
        LP/QP case. Cone ops then skip all segment machinery and become
        pure elementwise code (no zeros+dynamic-update-slice round trip on
        an (m, n) operand)."""
        return (
            self.nr == self.m
            and not self.soc_groups
            and not self.sdp_groups
            and len(self.r_runs) <= 1
        )

    # -- hashing / equality (for jit static args) --------------------------
    def __hash__(self) -> int:
        return hash(self.cone_dims)

    def __eq__(self, other) -> bool:
        return isinstance(other, ConeSpec) and self.cone_dims == other.cone_dims

    def __repr__(self) -> str:
        return f"ConeSpec({list(self.cone_dims)!r})"


def _freeze(a: np.ndarray) -> np.ndarray:
    a = a.astype(np.int32)
    a.setflags(write=False)
    return a
