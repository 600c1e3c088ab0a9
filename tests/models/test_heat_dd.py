"""DD (double-double float32) precision mode for the heat models.

The spectral steppers dispatch their eigenbasis matmuls to the Ozaki-scheme
matmul when precision='dd'; these tests pin (a) step-level parity against
real fp64, (b) the reference 3-level heat_1d golden history (reference
tests/core/test_mgrit.py:59-70), and (c) full-history agreement between the
DD and fp64 solvers on a multi-iteration heat_2d hierarchy down to the
1e-12 tolerance class that plain f32 cannot reach.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from pymgrit_tpu import Mgrit
from pymgrit_tpu.models.heat_1d import Heat1D
from pymgrit_tpu.models.heat_2d import Heat2D
from pymgrit_tpu.ops import dd


def _rhs_1d(x, t):
    return -jnp.sin(jnp.pi * x) * (jnp.sin(t) - 1 * jnp.pi ** 2 * jnp.cos(t))


def _ic_1d(x):
    return np.sin(np.pi * x)


def test_heat1d_dd_three_level_golden():
    """3-level heat_1d, 2 iterations: [0.00267692, 0.00018053]
    (reference tests/core/test_mgrit.py:69-70) — in float32 pairs."""
    mk = lambda nt: Heat1D(x_start=0, x_end=2, nx=5, a=1, rhs=_rhs_1d,
                           init_cond=_ic_1d, t_start=0, t_stop=2, nt=nt,
                           precision='dd')
    mgrit = Mgrit(problem=[mk(65), mk(17), mk(5)], cf_iter=1, cycle_type='V',
                  max_iter=2, nested_iteration=True, logging_lvl=30)
    conv = mgrit.solve()['conv']
    np.testing.assert_allclose(conv, [0.00267692, 0.00018053], rtol=1e-3)


def test_heat1d_dd_step_parity():
    m64 = Heat1D(x_start=0, x_end=2, nx=33, a=1, rhs=lambda x, t: 0 * x,
                 init_cond=_ic_1d, t_start=0, t_stop=2, nt=17)
    mdd = Heat1D(x_start=0, x_end=2, nx=33, a=1, rhs=lambda x, t: 0 * x,
                 init_cond=_ic_1d, t_start=0, t_stop=2, nt=17, precision='dd')
    u0 = np.asarray(m64.vector_t_start, np.float64)
    got = mdd.step(dd.from_f64(u0), dd.from_f64(np.float64(0.0)),
                   dd.from_f64(np.float64(0.125))).to_float64()
    want = np.asarray(m64.step(jnp.asarray(u0), 0.0, 0.125), np.float64)
    assert np.max(np.abs(got - want)) < 1e-12


HEAT2D_KW = dict(x_start=0, x_end=1, y_start=3, y_end=5, nx=17, ny=21, a=3.5,
                 init_cond=lambda x, y: np.sin(np.pi * x) * np.cos(y),
                 bc_left=1.0, bc_right=lambda y: 0 * y + 2.0, bc_bottom=0.5,
                 bc_top=0.0, t_start=0, t_stop=1, nt=9)


@pytest.mark.parametrize("method,tol", [('BE', 1e-12), ('CN', 1e-12), ('FE', 5e-11)])
def test_heat2d_dd_step_parity(method, tol):
    """With exactly-representable data (rhs=0, constant/callable BCs) the DD
    step must match fp64 to ~1e-13 (FE amplifies by the stencil scale)."""
    m64 = Heat2D(method=method, **HEAT2D_KW)
    mdd = Heat2D(method=method, precision='dd', **HEAT2D_KW)
    u0 = np.asarray(m64.vector_t_start, np.float64)
    got = mdd.step(dd.from_f64(u0), dd.from_f64(np.float64(0.125)),
                   dd.from_f64(np.float64(0.25))).to_float64()
    want = np.asarray(m64.step(jnp.asarray(u0), 0.125, 0.25), np.float64)
    assert np.max(np.abs(got - want)) < tol


def test_heat2d_dd_full_history_vs_f64():
    """3-level heat_2d with a time-dependent rhs: the DD solver must walk the
    same residual history as real fp64 down to tol=1e-12 and stop at the
    same iteration (DD floor ~1e-14 vs f64's 1e-16)."""
    def mk(nt, precision=None):
        return Heat2D(x_start=0, x_end=1, y_start=0, y_end=1, nx=21, ny=17,
                      a=1.0,
                      rhs=lambda x, y, t: jnp.sin(jnp.pi * x) * jnp.sin(jnp.pi * y)
                      * jnp.ones_like(t * x * y),
                      init_cond=lambda x, y: np.sin(np.pi * x) * np.sin(np.pi * y),
                      t_start=0, t_stop=1, nt=nt, precision=precision)

    hist = {}
    for prec in (None, 'dd'):
        prob = [mk(33, prec), mk(9, prec), mk(3, prec)]
        mg = Mgrit(problem=prob, tol=1e-12, max_iter=12,
                   nested_iteration=False, logging_lvl=30)
        hist[prec] = mg.solve()['conv']
    assert len(hist['dd']) == len(hist[None])
    # all but the floor iteration match tightly; the final values are both
    # below tol (2.5e-16 vs ~7e-15)
    np.testing.assert_allclose(hist['dd'][:-1], hist[None][:-1], rtol=1e-6)
    assert hist['dd'][-1] < 1e-12


def test_spatial_coarsening_dd_golden():
    """The reference's 4-level spatial-coarsening example in DD: the 1D
    full-weighting transfer operates on DD states through the polymorphic
    scatter syntax (golden tests/mpi/results/spatial_coarsening)."""
    from pymgrit_tpu import GridTransferHeat, GridTransferCopy

    mk = lambda nx, t_interval=None, nt=None: Heat1D(
        x_start=0, x_end=2, nx=nx, a=1, rhs=_rhs_1d, init_cond=_ic_1d,
        precision='dd',
        **(dict(t_interval=t_interval) if t_interval is not None
           else dict(t_start=0, t_stop=2, nt=nt)))

    heat0 = mk(2 ** 4 + 1, nt=2 ** 7 + 1)
    heat1 = mk(2 ** 3 + 1, t_interval=heat0.t[::2])
    heat2 = mk(2 ** 2 + 1, t_interval=heat1.t[::2])
    heat3 = mk(2 ** 2 + 1, t_interval=heat2.t[::2])
    transfer = [GridTransferHeat(), GridTransferHeat(), GridTransferCopy()]
    mgrit = Mgrit(problem=[heat0, heat1, heat2, heat3], transfer=transfer,
                  logging_lvl=30)
    conv = mgrit.solve()['conv']
    expected = np.array([3.3795e-2, 2.9794e-3, 3.2555e-4, 4.0429e-5,
                         4.9316e-6, 6.1785e-7, 7.7088e-8])
    assert len(conv) == 7
    np.testing.assert_allclose(conv, expected, rtol=2e-3)
