"""Ozaki-scheme matrix products for double-double operands.

Problem: a float32 matmul carries ~2^-24 relative error, far short of the
fp64-class accuracy the MGRIT golden histories need (see ops/dd.py).  The
Ozaki splitting scheme (Ozaki, Ogita, Oishi, Rump 2012) fixes this with
low-precision matmuls themselves: slice each operand into pieces whose
significands are so short that every piece-pair product — including the f32
accumulation over the full contraction axis — is EXACT integer arithmetic,
then recombine the exact partial products in double-double elementwise.

Recipe for C = A @ B with A, B double-double (hi+lo float32 pairs):

1. Row-normalize A (column-normalize B) by exact powers of two so entries
   lie in (-1, 1).
2. Slice the hi components into ``NP`` pieces of ``W=7`` significand bits
   each (error-free magic-number rounding).  Piece quotients are integers
   |q| <= 2^7, so a bf16 cast is exact, a bf16*bf16 product (<= 2^14) is
   exact, and an f32 accumulation of K <= 2^(24-2W) = 1024 such products is
   exact: the matmul unit does pure integer arithmetic at bf16 speed.
3. The NP x NP piece-pair products run as ONE bf16 matmul of the
   block-stacked pieces ((NP*m, K) @ (K, NP*n)) — one large matmul in place
   of sixteen small ones.
4. Slice remainders fold into the lo components; the two tail products
   (tail_A @ B and A @ tail_B, both ~2^-24 relative) run as plain f32
   matmuls with HIGHEST precision — their own rounding lands at ~2^-48.
5. Partials are accumulated largest-first into a double-double.

Result: a ~2^-48-accurate matmul from NP^2=16 piece products (one stacked
bf16 matmul) plus 2 f32 matmuls, with no fp64 arithmetic.  Contractions
longer than 1024 are chunked.  The componentwise bound 2^-47 * (|A| |B|)
holds when the entries of each row of A (column of B) lie within about 2^8
of that row's (column's) largest; wider spreads inside one row fall back to
the f32 tail products and only a normwise bound holds.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from pymgrit_tpu.ops import dd as _dd
from pymgrit_tpu.ops.dd import DD

W = 7                      # bits per slice
NP = 4                     # slices of the 24-bit hi significand (W*NP >= 24)
K_MAX = 1 << (24 - 2 * W)  # contraction length with exact f32 accumulation


def _exp2_exact(e):
    """2^e for integer e as an exact float32, built from the exponent bits.
    (jnp.exp2 is an *approximation* on some backends — observed on XLA CPU,
    exp2(-26) != 2^-26 — which silently breaks the error-free scaling.)"""
    return jax.lax.bitcast_convert_type(
        ((e + 127) << 23).astype(jnp.int32), jnp.float32)


def _pow2_ceil_exponent(amax):
    """Integer e with 2^e strictly greater than amax (0 for amax == 0)."""
    _, e = jnp.frexp(amax)          # amax = m * 2^e, m in [0.5, 1)
    return jnp.clip(e, -100, 100).astype(jnp.int32)


def _slices(x_hi):
    """Error-free W-bit slices of |x| < 1; returns (pieces list, remainder).

    Piece s is an integer multiple of 2^(-W(s+1)) with |piece| <= 2^(-W*s);
    the remainder after NP pieces is |r| <= 2^(-W*NP - 1)."""
    pieces = []
    r = x_hi
    for s in range(NP):
        # Round r to the nearest multiple of delta = 2^(-W(s+1)).  NOTE: the
        # classic magic-number form fl((r + c) - c) is NOT safe under XLA:
        # the algebraic simplifier reassociates the two constant adds into
        # r + (c - c) = r, silently destroying the split (observed on the
        # CPU backend).  round(r/delta)*delta uses exact power-of-two
        # scalings around an un-simplifiable round and is bitwise equivalent.
        delta = np.float32(2.0 ** (-W * (s + 1)))
        inv_delta = np.float32(2.0 ** (W * (s + 1)))
        p = jnp.round(r * inv_delta) * delta
        r = r - p
        pieces.append(p)
    return pieces, r


def _matmul_chunk(a: DD, b: DD) -> DD:
    """One <=K_MAX contraction chunk; a (..., m, k), b (..., k, n)."""
    # 1. exact power-of-two normalization
    ea = _pow2_ceil_exponent(jnp.max(jnp.abs(a.hi), axis=-1, keepdims=True))  # (..., m, 1)
    eb = _pow2_ceil_exponent(jnp.max(jnp.abs(b.hi), axis=-2, keepdims=True))  # (..., 1, n)
    inv_a = _exp2_exact(-ea)
    inv_b = _exp2_exact(-eb)
    ah, al = a.hi * inv_a, a.lo * inv_a
    bh, bl = b.hi * inv_b, b.lo * inv_b

    # 2. slice hi parts; remainders join the lo tails
    pa, ra = _slices(ah)
    pb, rb = _slices(bh)
    ta = al + ra
    tb = bl + rb

    # 3. all NP x NP piece pairs in ONE bf16 matmul of stacked blocks
    astack = jnp.concatenate([p.astype(jnp.bfloat16) for p in pa], axis=-2)
    bstack = jnp.concatenate([p.astype(jnp.bfloat16) for p in pb], axis=-1)
    big = jnp.matmul(astack, bstack, preferred_element_type=jnp.float32)
    m = a.hi.shape[-2]
    n = b.hi.shape[-1]

    # 4. tail products at f32 (HIGHEST = full f32-equivalent emulation)
    bflat = bh + tb
    t1 = jnp.matmul(ta, bflat, precision=jax.lax.Precision.HIGHEST)
    t2 = jnp.matmul(ah, tb, precision=jax.lax.Precision.HIGHEST)

    # 5. accumulate partials largest-first into DD
    acc = _dd.zeros_like(t1)
    for s in range(2 * NP - 1):
        for sa_i in range(max(0, s - NP + 1), min(NP, s + 1)):
            sb_i = s - sa_i
            part = jax.lax.slice_in_dim(
                jax.lax.slice_in_dim(big, sa_i * m, (sa_i + 1) * m, axis=big.ndim - 2),
                sb_i * n, (sb_i + 1) * n, axis=big.ndim - 1)
            acc = _dd.add(acc, _dd._raw(part, jnp.zeros_like(part)))
    acc = _dd.add(acc, _dd._raw(t1, jnp.zeros_like(t1)))
    acc = _dd.add(acc, _dd._raw(t2, jnp.zeros_like(t2)))

    # 6. undo the exact scaling
    scale = _exp2_exact(ea + eb)
    return _dd._raw(acc.hi * scale, acc.lo * scale)


def matmul_dd(a, b) -> DD:
    """C = a @ b in double-double; a/b may be DD, numpy f64, or jax f32.

    Supports 1-D operands with numpy matmul promotion rules and arbitrary
    broadcastable leading batch dimensions.  Contractions longer than
    K_MAX=1024 are chunked with DD accumulation across chunks.
    """
    a = _dd.coerce(a)
    b = _dd.coerce(b)
    a_vec = a.ndim == 1
    b_vec = b.ndim == 1
    if a_vec:
        a = a.reshape(1, -1)
    if b_vec:
        b = b.reshape(-1, 1)

    k = a.shape[-1]
    if b.shape[-2] != k:
        raise ValueError(f"matmul_dd contraction mismatch: {a.shape} @ {b.shape}")

    if k <= K_MAX:
        out = _matmul_chunk(a, b)
    else:
        out = None
        for s in range(0, k, K_MAX):
            e = min(s + K_MAX, k)
            part = _matmul_chunk(a[..., :, s:e], b[..., s:e, :])
            out = part if out is None else _dd.add(out, part)

    if a_vec:
        out = _dd._raw(out.hi[..., 0, :], out.lo[..., 0, :])
    if b_vec:
        out = _dd._raw(out.hi[..., 0], out.lo[..., 0])
    return out
