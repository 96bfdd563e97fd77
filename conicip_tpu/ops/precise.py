"""Near-f64-accurate mat-vec products from precomputed f32 slices.

Why this exists: the opt-in f32 regime (``factor_dtype=float32``) runs the
IPM's per-iteration products in f32 and recertifies residuals near every
tolerance decision. Those certified residuals need near-f64 accuracy from
f32 arithmetic: this module slices the constant operands ONCE at setup
(Ozaki-style error-free splitting) and evaluates products with a handful of
f32 matmuls, reaching ~1e-12 relative-to-scale accuracy. Whether this beats
a plain f64 product on hardware with f64 units is an open question (ROADMAP
Design 1); ``PERF.md`` records both times.

Scheme (Ozaki et al., error-free transformation of dot products):

- Rows of A are scaled by powers of two ``tau_i = 2^ceil(log2 max_j|A_ij|)``
  (exact scaling), then split into ``NS`` slices of ``NBITS``-bit signed
  integers: ``A/tau = sum_k M_k 2^(-k*NBITS)`` with ``|M_k| <= 2^(NBITS-1)``.
  Slices are stored as small-integer-valued f32 matrices — exactly
  representable even in TF32 or bf16, so the DEFAULT-precision product
  (TF32 on the GPU's tensor cores) is exact.
- The vector is scaled by a global power of two and split the same way at
  apply time (cheap f64 vector ops).
- A slice-pair product ``M_k @ m_l`` accumulates integers bounded by
  ``~66*82 < 2^13`` (operands scaled with 2x headroom so the first slice
  stays ≤ 2^(NBITS-1)); with NBITS=7 a 2048-long f32 accumulation stays
  below 2^24 and is therefore EXACT. Pair columns are combined in f64 (a few
  tens of r-length fmas).
- Truncation tail: pairs with k+l > NSLICES+1 contribute ~2^(-47) of the
  row scale (NSLICES=7 at 7 bits, minus 2 headroom bits). Accuracy is absolute with respect to ``tau_i * sigma_x`` —
  exactly what residual evaluation needs.

Cost: ~7 small f32 matmuls plus a few tens of r-length f64 vector ops. The
one-time matrix slicing itself runs in f32 with a single exact-f64
re-remainder (:func:`_split_matrix`).
"""

from __future__ import annotations

import jax.numpy as jnp

__all__ = ["PreciseMatvec", "NBITS", "NSLICES"]

NBITS = 7  # slice mantissa bits; |m| <= 65 so 2048 products sum below 2^24
NSLICES = 7  # slices per operand: 7*7 - 2 headroom bits = 47 -> ~1e-14 tail
_MAX_EXACT_LEN = 2048  # f32 accumulation of slice products is exact up to this


def _split(x, nslices: int):
    """Split ``x`` (f64, scaled into [-1, 1]) into integer-valued f32 slices:
    ``x = sum_k out[k] * 2^(-(k+1)*NBITS)`` with ``|out[k]| <= 2^(NBITS-1)``."""
    out = []
    rem = x
    for k in range(1, nslices + 1):
        scale = jnp.asarray(2.0 ** (k * NBITS), x.dtype)
        mk = jnp.round(rem * scale)
        out.append(mk.astype(jnp.float32))
        rem = rem - mk / scale
    return out


def _split_matrix(x, nslices: int):
    """Same decomposition contract as :func:`_split`, but for the big
    one-time MATRIX split: the window arithmetic runs in f32, with ONE
    exact-f64 re-remainder halfway.

    The re-remainder keeps the decomposition sound: windows 1..h come from
    the f32 image of x (|w_k| ≤ 2^(NBITS-1)+1 as always); the exact f64
    remainder then differs from the f32-chain remainder by ≤ 2^-24, so
    window h+1 is bounded by 2^(NBITS-1) + 2^(h·NBITS+NBITS-24) + 1
    (= ≤ 81 for NBITS=7, h=3) — still far inside the exact-f32-accumulation
    budget (81·66·2048 < 2^24). Powers of two make every f32 scale/divide
    exact."""
    f32 = jnp.float32
    h = nslices // 2
    out = []
    rem32 = x.astype(f32)
    for k in range(1, h + 1):
        scale = jnp.asarray(2.0 ** (k * NBITS), f32)
        mk = jnp.round(rem32 * scale)
        out.append(mk)
        rem32 = rem32 - mk / scale
    # exact f64 remainder after the first h windows (h cheap fused passes)
    acc = x
    for k, mk in enumerate(out, start=1):
        acc = acc - mk.astype(x.dtype) / jnp.asarray(2.0 ** (k * NBITS), x.dtype)
    rem32 = acc.astype(f32)
    for k in range(h + 1, nslices + 1):
        scale = jnp.asarray(2.0 ** (k * NBITS), f32)
        mk = jnp.round(rem32 * scale)
        out.append(mk)
        rem32 = rem32 - mk / scale
    return out


def _pow2_ceil(x):
    """Smallest power of two >= x (exact), 1.0 where x is 0/non-finite."""
    ok = jnp.isfinite(x) & (x > 0)
    e = jnp.ceil(jnp.log2(jnp.where(ok, x, 1.0)))
    return jnp.where(ok, jnp.exp2(e), 1.0)


class PreciseMatvec:
    """``y = A @ x`` to ~1e-15 relative-to-scale accuracy, A sliced once.

    Built under jit (the slicing is traced jnp code, hoisted out of any
    loop); ``__call__`` takes and returns f64 vectors. Supports any (r, c)
    with c <= 2048 exactly; larger c falls back to chunked accumulation.
    """

    def __init__(self, A: jnp.ndarray):
        assert A.ndim == 2
        self.shape = A.shape
        r, c = A.shape
        rowmax = jnp.max(jnp.abs(A), axis=1) if c else jnp.zeros((r,), A.dtype)
        # 2x headroom: a row with max element exactly at a power of two
        # would otherwise put 2^NBITS (=128) in its first slice, pushing
        # the worst-case product sum past the exact-f32 budget
        self.tau = 2.0 * _pow2_ceil(rowmax)  # (r,)
        As = A / self.tau[:, None] if c else A
        self.slices = _split_matrix(As, NSLICES)  # list of (r, c) f32
        self.dtype = A.dtype
        if c > _MAX_EXACT_LEN:
            # chunked accumulation keeps per-chunk sums exact; cross-chunk
            # sums are combined in f64 (few chunks, cheap)
            self.nchunks = -(-c // _MAX_EXACT_LEN)
            pad = self.nchunks * _MAX_EXACT_LEN - c
            self.slices = [
                jnp.pad(S, ((0, 0), (0, pad))).reshape(
                    r, self.nchunks, _MAX_EXACT_LEN
                )
                for S in self.slices
            ]
        else:
            self.nchunks = 1

    def __call__(self, x: jnp.ndarray) -> jnp.ndarray:
        r, c = self.shape
        if c == 0:
            return jnp.zeros((r,), self.dtype)
        sigma = 2.0 * _pow2_ceil(jnp.max(jnp.abs(x)))
        xs = _split(x / sigma, NSLICES)  # list of (c,) f32 integer slices

        # One matmul per A-slice k with all needed x-slices as extra RHS
        # columns (pairs k+l <= NSLICES+1).
        # Each pair column is EXACT integers in f32; pairs are combined
        # directly in f64 (a few tens of r-length fmas) — cross-pair f32
        # sums could lose exactness in the adversarial all-max-sign case.
        L = NSLICES + 1
        out = jnp.zeros((r,), self.dtype)
        for k in range(1, NSLICES + 1):
            nl = min(NSLICES, L - k)
            if nl < 1:
                continue
            X = jnp.stack(xs[:nl], axis=-1)  # (c, nl) f32 integers
            Sk = self.slices[k - 1]
            if self.nchunks == 1:
                Y = jnp.matmul(Sk, X)  # (r, nl), exact
                Y64 = Y.astype(self.dtype)
            else:
                pad = self.nchunks * _MAX_EXACT_LEN - c
                Xc = jnp.pad(X, ((0, pad), (0, 0))).reshape(
                    self.nchunks, _MAX_EXACT_LEN, X.shape[-1]
                )
                Yc = jnp.einsum("rnc,ncl->nrl", Sk, Xc)  # (n, r, nl) exact
                Y64 = jnp.sum(Yc.astype(self.dtype), axis=0)
            w = jnp.asarray(
                [2.0 ** (-(k + l) * NBITS) for l in range(1, nl + 1)],
                self.dtype,
            )
            out = out + jnp.sum(Y64 * w, axis=-1)
        return out * (self.tau * sigma)
