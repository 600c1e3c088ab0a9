"""Golden-history tests for the double-double (float32-pair) solver path.

The whole point of ops/dd.py + ops/ozaki.py: residual histories that the
reference only reaches in fp64 (reference README.rst:105-109 — 5 iterations
to 3.975e-12 at tol=1e-10) must reproduce with float32-pair arithmetic
alone.  These tests run the DD path on the CPU backend; chip_smoke.py runs
the README golden on the GPU.
"""

import logging

import numpy as np
import pytest

from pymgrit_tpu import Mgrit, simple_setup_problem
from pymgrit_tpu.models.dahlquist import Dahlquist

README_GOLDEN = [7.186185937e-05, 1.2461067e-06, 2.1015566e-08,
                 3.1441273e-10, 3.975e-12]


def test_dahlquist_dd_reproduces_readme_history():
    d = Dahlquist(t_start=0, t_stop=5, nt=101, precision='dd')
    problem = simple_setup_problem(problem=d, level=2, coarsening=2)
    mgrit = Mgrit(problem=problem, tol=1e-10, logging_lvl=logging.WARNING)
    info = mgrit.solve()
    conv = np.asarray(info['conv'])
    assert len(conv) == 5, f"expected 5 iterations, got {conv}"
    np.testing.assert_allclose(conv, README_GOLDEN, rtol=2e-3)
    # the f32 floor is ~2.4e-5 (round-1 BENCH); DD must land 7 orders below
    assert conv[-1] < 1e-11


def test_dahlquist_dd_three_level_f_cycle():
    """Cross-check a deeper hierarchy + F-cycle in DD against the same
    solver in fp64 (CPU x64 is real): histories must agree to ~1e-4."""
    def build(precision):
        d = Dahlquist(t_start=0, t_stop=5, nt=101, precision=precision)
        return simple_setup_problem(problem=d, level=3, coarsening=2)

    kw = dict(tol=1e-10, cycle_type='F', logging_lvl=logging.WARNING)
    conv_dd = Mgrit(problem=build('dd'), **kw).solve()['conv']
    conv_64 = Mgrit(problem=build(None), **kw).solve()['conv']
    assert len(conv_dd) == len(conv_64)
    np.testing.assert_allclose(conv_dd, conv_64, rtol=2e-3)


def test_dahlquist_dd_all_integrators_step_parity():
    """Each integrator's DD step must match the fp64 step to ~1e-13."""
    for method in ('BE', 'FE', 'TR', 'MR'):
        ddm = Dahlquist(t_start=0, t_stop=5, nt=101, method=method, precision='dd')
        f64 = Dahlquist(t_start=0, t_stop=5, nt=101, method=method)
        from pymgrit_tpu.ops import dd
        u0 = dd.from_f64(np.float64(0.7371))
        got = ddm.step(u0, dd.from_f64(np.float64(0.1)),
                       dd.from_f64(np.float64(0.15))).to_float64()
        want = float(f64.step(np.float64(0.7371), 0.1, 0.15))
        assert abs(got - want) < 1e-13, method
