"""Double-double ("DD") arithmetic: ~2^-48 precision from float32 pairs.

Why this exists: the reference PyMGRIT runs everything in fp64 and its
headline result is 5 MGRIT iterations to a residual of 3.975e-12
(reference: README.rst:105-109); every golden history assumes ~1e-10..1e-13
accurate arithmetic.  Plain f32 stalls the MGRIT residual at ~1e-5, so for
float32-only execution this module represents each number as an
*unevaluated sum of two float32s* ``hi + lo`` with ``|lo| <= ulp(hi)/2``,
giving ~49 bits of significand (relative accuracy ~3.6e-15), enough to
reproduce the reference's fp64 histories without fp64 arithmetic.

All algorithms are the classic error-free transforms (Dekker 1971, Knuth
TAOCP v2, and the QD library of Hida/Li/Bailey): TwoSum, QuickTwoSum,
Dekker split/TwoProd, and the accurate DD add/mul/div/sqrt built from them.
They are branch-free elementwise float ops, fully jit/vmap/scan-compatible.
Matrix products of DD operands are dispatched to the Ozaki-scheme matmul
(ops/ozaki.py).

``DD`` is a registered pytree node, so DD states flow through the solver's
tube machinery (gather/scatter/where/scan) untouched; the *algebraic* ops in
``core/vector.py`` dispatch on the DD type so sums and scalings stay
renormalized.

Design note: components are ALWAYS float32, even when jax_enable_x64 is on.
The error-free transforms need IEEE round-to-nearest f32 without fused
multiply-add contraction of the Dekker split; on the CPU and on an H100
(checked by chip_smoke.py: two_prod exact on 2^20 random pairs) XLA keeps
both, so the CPU tests exercise the device's semantics.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import jax
import jax.numpy as jnp

_F32 = jnp.float32
# Dekker split factor for float32 (24-bit significand -> 12+12 bits):
_SPLIT_FACTOR = np.float32(4097.0)  # 2**12 + 1


def _f32(x):
    return jnp.asarray(x, dtype=_F32)


# ---------------------------------------------------------------------------
# Error-free transforms (raw float32 arrays)
# ---------------------------------------------------------------------------


def two_sum(a, b):
    """s + e == a + b exactly, s = fl(a + b) (Knuth).

    The optimization barrier on s is load-bearing: XLA's algebraic
    simplifier reassociates float add/sub chains when literal constants are
    involved (e.g. fl((1 + b) - 1) -> b), which silently destroys the error
    term.  Observed on the XLA CPU backend for any DD op with a constant
    operand; the barrier makes s opaque to the rewriter on every backend.
    """
    s = jax.lax.optimization_barrier(a + b)
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e


def quick_two_sum(a, b):
    """TwoSum assuming |a| >= |b| (Dekker).  Barrier: see two_sum."""
    s = jax.lax.optimization_barrier(a + b)
    e = b - (s - a)
    return s, e


def split(a):
    """Dekker split: a == h + l with h, l having <= 12 significand bits."""
    c = _SPLIT_FACTOR * a
    h = c - (c - a)
    return h, a - h


def two_prod(a, b):
    """p + e == a * b exactly, p = fl(a * b) (Dekker)."""
    p = a * b
    ah, al = split(a)
    bh, bl = split(b)
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, e


# ---------------------------------------------------------------------------
# The DD type
# ---------------------------------------------------------------------------


class DD:
    """Unevaluated float32 sum hi + lo; elementwise broadcasting semantics.

    Supports the arithmetic operators (+, -, *, /, @, unary -) against DD,
    python scalars, numpy arrays (split exactly from f64), and jax arrays
    (taken at face value, lo = 0).  ``x.at[idx].set/add`` mirrors jax's
    scatter syntax with a renormalizing add.
    """

    __slots__ = ("hi", "lo")

    def __init__(self, hi, lo=None):
        self.hi = _f32(hi)
        self.lo = _f32(lo) if lo is not None else jnp.zeros_like(self.hi)

    # -- structure ---------------------------------------------------------

    @property
    def shape(self):
        return jnp.shape(self.hi)

    @property
    def ndim(self):
        return jnp.ndim(self.hi)

    @property
    def dtype(self):
        return self.hi.dtype

    def __getitem__(self, key):
        return DD(self.hi[key], self.lo[key])

    def reshape(self, *shape):
        return DD(self.hi.reshape(*shape), self.lo.reshape(*shape))

    @property
    def T(self):
        return DD(self.hi.T, self.lo.T)

    @property
    def at(self):
        return _DDAt(self)

    def __repr__(self):
        return f"DD(hi={self.hi!r}, lo={self.lo!r})"

    # -- value extraction ----------------------------------------------------

    def to_float(self):
        """Best float32 approximation of the value (for norms/reporting)."""
        return self.hi + self.lo

    def to_float64(self):
        """Exact value as float64 (host-side; requires concrete arrays)."""
        return np.asarray(self.hi, dtype=np.float64) + np.asarray(self.lo, dtype=np.float64)

    # -- operators ----------------------------------------------------------

    def __add__(self, other):
        return add(self, coerce(other))

    __radd__ = __add__

    def __sub__(self, other):
        return add(self, neg(coerce(other)))

    def __rsub__(self, other):
        return add(coerce(other), neg(self))

    def __mul__(self, other):
        return mul(self, coerce(other))

    __rmul__ = __mul__

    def __truediv__(self, other):
        return div(self, coerce(other))

    def __rtruediv__(self, other):
        return div(coerce(other), self)

    def __neg__(self):
        return neg(self)

    def __matmul__(self, other):
        from pymgrit_tpu.ops.ozaki import matmul_dd
        return matmul_dd(self, coerce(other))

    def __rmatmul__(self, other):
        from pymgrit_tpu.ops.ozaki import matmul_dd
        return matmul_dd(coerce(other), self)


class _DDAt:
    """``dd.at[idx].set(v)`` / ``.add(v)``; add renormalizes through DD add."""

    def __init__(self, ref: DD):
        self._ref = ref

    def __getitem__(self, idx):
        return _DDAtIndexed(self._ref, idx)


class _DDAtIndexed:
    def __init__(self, ref: DD, idx):
        self._ref = ref
        self._idx = idx

    def set(self, value):
        v = coerce(value)
        hi = jnp.broadcast_to(v.hi, jnp.shape(self._ref.hi[self._idx]))
        lo = jnp.broadcast_to(v.lo, hi.shape)
        return DD(self._ref.hi.at[self._idx].set(hi),
                  self._ref.lo.at[self._idx].set(lo))

    def add(self, value):
        new = add(self._ref[self._idx], coerce(value))
        return DD(self._ref.hi.at[self._idx].set(new.hi),
                  self._ref.lo.at[self._idx].set(new.lo))


jax.tree_util.register_pytree_node(
    DD,
    lambda d: ((d.hi, d.lo), None),
    lambda _, children: _raw(*children),
)


def _raw(hi, lo) -> DD:
    """Build a DD without dtype coercion (pytree unflatten must be able to
    carry tracers and abstract values straight through)."""
    obj = DD.__new__(DD)
    obj.hi = hi
    obj.lo = lo
    return obj


def is_dd(x: Any) -> bool:
    return isinstance(x, DD)


def coerce(x) -> DD:
    """Convert a scalar / numpy f64 array / jax f32 array to DD.

    Python scalars and numpy arrays are split *exactly* from float64 (two
    components capture 48 bits); traced jax arrays are taken at face value.
    """
    if isinstance(x, DD):
        return x
    if isinstance(x, (int, float)) or isinstance(x, np.ndarray) or np.isscalar(x):
        return from_f64(np.asarray(x, dtype=np.float64))
    return DD(x)


def from_f64(arr) -> DD:
    """Exact split of a float64 numpy array into (hi, lo) float32s."""
    a = np.asarray(arr, dtype=np.float64)
    hi = a.astype(np.float32)
    lo = (a - hi.astype(np.float64)).astype(np.float32)
    return _raw(jnp.asarray(hi), jnp.asarray(lo))


def zeros_like(x) -> DD:
    t = coerce(x)
    return _raw(jnp.zeros_like(t.hi), jnp.zeros_like(t.lo))


def ones_like(x) -> DD:
    t = coerce(x)
    return _raw(jnp.ones_like(t.hi), jnp.zeros_like(t.lo))


# ---------------------------------------------------------------------------
# DD arithmetic (accurate variants, QD-library style)
# ---------------------------------------------------------------------------


def add(x: DD, y: DD) -> DD:
    s1, s2 = two_sum(x.hi, y.hi)
    t1, t2 = two_sum(x.lo, y.lo)
    s2 = s2 + t1
    s1, s2 = quick_two_sum(s1, s2)
    s2 = s2 + t2
    s1, s2 = quick_two_sum(s1, s2)
    return _raw(s1, s2)


def neg(x: DD) -> DD:
    return _raw(-x.hi, -x.lo)


def sub(x: DD, y: DD) -> DD:
    return add(x, neg(y))


def mul(x: DD, y: DD) -> DD:
    p, e = two_prod(x.hi, y.hi)
    e = e + (x.hi * y.lo + x.lo * y.hi)
    return _raw(*quick_two_sum(p, e))


def div(x: DD, y: DD) -> DD:
    q1 = x.hi / y.hi
    r = sub(x, mul(y, _raw(q1, jnp.zeros_like(q1))))
    q2 = r.hi / y.hi
    r = sub(r, mul(y, _raw(q2, jnp.zeros_like(q2))))
    q3 = r.hi / y.hi
    s, e = quick_two_sum(q1, q2)
    return add(_raw(s, e), _raw(q3, jnp.zeros_like(q3)))


def sqrt(x: DD) -> DD:
    """DD square root via one Karp/Markstein refinement of the f32 sqrt.
    Zero-safe (sqrt(0) = 0)."""
    safe_hi = jnp.where(x.hi > 0, x.hi, 1.0)
    y = jnp.sqrt(safe_hi)
    ydd = _raw(y, jnp.zeros_like(y))
    e = sub(_raw(jnp.where(x.hi > 0, x.hi, 0.0), jnp.where(x.hi > 0, x.lo, 0.0)),
            mul(ydd, ydd))
    corr = e.hi * (0.5 / y)
    out = add(ydd, _raw(corr, jnp.zeros_like(corr)))
    zero = x.hi <= 0
    return _raw(jnp.where(zero, 0.0, out.hi), jnp.where(zero, 0.0, out.lo))


def scale_pow2(x: DD, p) -> DD:
    """Multiply by an exact power of two (error-free)."""
    return _raw(x.hi * p, x.lo * p)
