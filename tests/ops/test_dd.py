"""Double-double arithmetic accuracy vs float64 ground truth.

The DD layer (ops/dd.py, ops/ozaki.py) must deliver ~2^-48 relative accuracy
from float32 pairs — that is what lets float32-only execution reproduce the
reference's fp64 golden histories (reference README.rst:105-109 reaches
3.975e-12).  Every check here compares against numpy float64 computed from
the exact same inputs.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from pymgrit_tpu.ops import dd
from pymgrit_tpu.ops.ozaki import matmul_dd

RNG = np.random.default_rng(42)
DD_EPS = 2.0 ** -47  # one bit of headroom over the 2^-48 design point


def _rand(shape, scale=1.0):
    return (RNG.standard_normal(shape) * scale).astype(np.float64)


def _relerr(got_dd, want_f64):
    got = got_dd.to_float64()
    denom = np.maximum(np.abs(want_f64), 1e-30)
    return np.max(np.abs(got - want_f64) / denom)


def test_from_f64_split():
    """hi captures the f32 rounding of a, lo the remainder to f32 accuracy:
    a 53-bit f64 lands within 2^-48 of its 49-bit DD representation."""
    a = _rand((64,))
    x = dd.from_f64(a)
    np.testing.assert_allclose(x.to_float64(), a, rtol=DD_EPS, atol=0)
    assert np.all(np.abs(np.asarray(x.lo)) <= np.spacing(np.abs(np.asarray(x.hi))))


def test_two_sum_error_free():
    """TwoSum must capture the rounding error exactly — this is the one
    property that breaks if the compiler reassociates float math."""
    a = jnp.float32(1.0)
    b = jnp.float32(2.0 ** -30)
    s, e = jax.jit(dd.two_sum)(a, b)
    assert float(s) == 1.0
    assert float(e) == 2.0 ** -30


def test_two_prod_error_free():
    a = jnp.float32(1.0 + 2.0 ** -12)
    b = jnp.float32(1.0 + 2.0 ** -13)
    p, e = jax.jit(dd.two_prod)(a, b)
    exact = (1.0 + 2.0 ** -12) * (1.0 + 2.0 ** -13)
    assert float(p) + float(e) == exact


@pytest.mark.parametrize("op", ["add", "sub", "mul", "div"])
def test_elementwise_ops(op):
    x = dd.from_f64(_rand((256,)))
    y = dd.from_f64(_rand((256,)) + 3.0)  # keep divisors away from zero
    # ground truth from the exactly-representable DD inputs (otherwise the
    # f64->DD conversion error gets amplified by cancellation in add/sub)
    a, b = x.to_float64(), y.to_float64()
    got = jax.jit(getattr(dd, op))(x, y)
    want = {"add": a + b, "sub": a - b, "mul": a * b, "div": a / b}[op]
    assert _relerr(got, want) < 4 * DD_EPS


def test_operator_overloads_mixed_types():
    a = _rand((32,))
    x = dd.from_f64(a)
    # DD op python-scalar, numpy array, and DD
    got = ((x * 1.3 + 0.25) / (1.0 - x * x) - x).to_float64()
    want = (a * 1.3 + 0.25) / (1.0 - a * a) - a
    assert np.max(np.abs(got - want) / np.abs(want)) < 1e-12


def test_cancellation_keeps_low_bits():
    """(1 + tiny) - 1 == tiny exactly: the use case that pure f32 cannot do
    and that MGRIT residuals at 1e-12 depend on."""
    a = np.float64(1.0) + 3.975e-12
    tiny = float(a - 1.0)  # what the f64 input actually carries
    x = dd.from_f64(a)
    r = x - 1.0
    # the low part comes back to f32 relative accuracy of *itself*
    # (~1e-7 * 4e-12 = 4e-19) — 12 orders below what pure f32 keeps
    assert abs(float(r.to_float64()) - tiny) < 1e-18


def test_sqrt():
    a = np.abs(_rand((128,))) + 0.01
    got = jax.jit(dd.sqrt)(dd.from_f64(a))
    assert _relerr(got, np.sqrt(a)) < DD_EPS


def test_sqrt_zero_safe():
    got = dd.sqrt(dd.from_f64(np.array([0.0, 4.0])))
    np.testing.assert_allclose(got.to_float64(), [0.0, 2.0], rtol=1e-14)


def test_at_set_add():
    a = _rand((16,))
    x = dd.from_f64(a)
    y = x.at[3:7].add(dd.from_f64(np.float64(1e-9)))
    want = a.copy()
    want[3:7] += 1e-9
    np.testing.assert_allclose(y.to_float64(), want, rtol=1e-14, atol=0)


def test_pytree_registration_jit_vmap_scan():
    a = _rand((8, 16))
    x = dd.from_f64(a)

    def f(v):
        return v * 2.0 + 1.0

    got = jax.jit(jax.vmap(f))(x)
    np.testing.assert_allclose(got.to_float64(), a * 2.0 + 1.0,
                               rtol=1e-13, atol=1e-14)

    def body(carry, xi):
        nxt = carry + xi
        return nxt, nxt

    init = dd.zeros_like(x[0])
    _, ys = jax.lax.scan(body, init, x)
    np.testing.assert_allclose(ys.to_float64()[-1], a.sum(axis=0),
                               rtol=1e-12, atol=1e-13)


# ---------------------------------------------------------------------------
# Ozaki matmul
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("m,k,n", [(5, 7, 3), (64, 64, 64), (129, 127, 65),
                                   (1, 999, 1), (33, 1024, 17)])
def test_matmul_accuracy(m, k, n):
    a = _rand((m, k))
    b = _rand((k, n))
    got = jax.jit(matmul_dd)(dd.from_f64(a), dd.from_f64(b))
    want = a @ b
    # componentwise backward-error bound: |dC| <= eps_dd * (|A| @ |B|)
    bound = DD_EPS * (np.abs(a) @ np.abs(b)) + 1e-30
    assert np.max(np.abs(got.to_float64() - want) / bound) < 8.0


def test_matmul_chunked_long_contraction():
    a = _rand((4, 3000), scale=0.1)
    b = _rand((3000, 4), scale=0.1)
    got = matmul_dd(dd.from_f64(a), dd.from_f64(b))
    bound = DD_EPS * (np.abs(a) @ np.abs(b)) + 1e-30
    assert np.max(np.abs(got.to_float64() - a @ b) / bound) < 16.0


def test_matmul_wild_scales():
    """Rows/columns of wildly different magnitude must not contaminate each
    other (the per-row/column power-of-two normalization)."""
    a = _rand((16, 32)) * np.logspace(-8, 8, 16)[:, None]
    b = _rand((32, 16)) * np.logspace(8, -8, 16)[None, :]
    got = matmul_dd(dd.from_f64(a), dd.from_f64(b))
    bound = DD_EPS * (np.abs(a) @ np.abs(b)) + 1e-30
    assert np.max(np.abs(got.to_float64() - a @ b) / bound) < 8.0


@pytest.mark.gpu
def test_matmul_exact_pieces_on_gpu_k1024():
    """On the GPU the bf16 piece products must accumulate exactly in f32:
    all-ones mantissas make every 7-bit piece 127, so K=1024 piece products
    sum to just under 2^24, the edge of exact f32 accumulation.  The
    reference product is taken in 64-bit-significand arithmetic."""
    sign = np.where(RNG.standard_normal((256, 1024)) < 0, -1.0, 1.0)
    a = sign * (2.0 - 2.0 ** -23) * (1.0 + 2.0 ** -26)
    b = a.T.copy()
    x, y = dd.from_f64(a), dd.from_f64(b)
    got = jax.jit(matmul_dd)(x, y)
    ax = np.asarray(x.hi, np.longdouble) + np.asarray(x.lo, np.longdouble)
    bx = np.asarray(y.hi, np.longdouble) + np.asarray(y.lo, np.longdouble)
    gx = np.asarray(got.hi, np.longdouble) + np.asarray(got.lo, np.longdouble)
    bound = DD_EPS * (np.abs(ax) @ np.abs(bx))
    assert np.max(np.abs(gx - ax @ bx) / bound) <= 1.0


def test_matmul_vector_cases():
    a = _rand((24, 24))
    v = _rand((24,))
    got_mv = matmul_dd(dd.from_f64(a), dd.from_f64(v))
    np.testing.assert_allclose(got_mv.to_float64(), a @ v, rtol=1e-12)
    got_vm = matmul_dd(dd.from_f64(v), dd.from_f64(a))
    np.testing.assert_allclose(got_vm.to_float64(), v @ a, rtol=1e-12)


def test_matmul_under_vmap():
    a = _rand((6, 12, 12))
    s = _rand((12, 12))
    sd = dd.from_f64(s)
    got = jax.vmap(lambda x: matmul_dd(sd, x))(dd.from_f64(a))
    want = np.einsum('ij,bjk->bik', s, a)
    np.testing.assert_allclose(got.to_float64(), want, rtol=1e-11)


def test_matmul_operator():
    a, b = _rand((8, 8)), _rand((8, 8))
    got = dd.from_f64(a) @ dd.from_f64(b)
    np.testing.assert_allclose(got.to_float64(), a @ b, rtol=1e-12)


def test_spectral_solve_roundtrip_dd():
    """The heat-model use case end to end: sine-basis shifted solve at DD
    precision must hit ~1e-13, far below f32's 1e-7 floor."""
    from pymgrit_tpu.ops.dirichlet_spectral import sine_eigenbasis
    n = 127
    S, lam = sine_eigenbasis(n, 100.0)
    rng = np.random.default_rng(7)
    bvec = rng.standard_normal(n)
    shift = 1e-3
    want = np.linalg.solve(np.eye(n) + shift * (S @ np.diag(lam) @ S), bvec)

    Sd = dd.from_f64(S)
    bd = dd.from_f64(bvec)
    bh = Sd @ bd
    xh = bh / (1.0 + dd.from_f64(np.float64(shift)) * dd.from_f64(lam))
    got = (Sd @ xh).to_float64()
    assert np.max(np.abs(got - want)) / np.max(np.abs(want)) < 1e-12
