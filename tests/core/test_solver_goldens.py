"""Golden residual-history parity tests against the reference's published
numbers (BASELINE.md; reference tests/mpi/results/* and tests/core/test_mgrit.py).

The key invariant: our solver must reproduce the reference's
residual histories to ~4 decimals (the same tolerance the reference CI
enforces across rank counts, reference tests/mpi/mpi.py:49).
"""

import numpy as np
import pytest

from pymgrit_tpu import Mgrit, Dahlquist, Heat1D, Brusselator, simple_setup_problem


def test_dahlquist_readme_history():
    """README example: nt=101, 2-level, m=2, tol=1e-10 -> 5 iterations
    (reference README.rst:105-109; golden tests/mpi/results/dahlquist)."""
    dahlquist = Dahlquist(t_start=0, t_stop=5, nt=101)
    problem = simple_setup_problem(problem=dahlquist, level=2, coarsening=2)
    mgrit = Mgrit(problem=problem, tol=1e-10, logging_lvl=30)
    info = mgrit.solve()
    expected = np.array([7.186185937031941e-05, 1.2461067076355103e-06,
                         2.1015566145245807e-08, 3.144127445017594e-10,
                         3.975214076032893e-12])
    conv = info['conv']
    assert len(conv) == 5
    assert np.allclose(conv, expected, rtol=1e-4, atol=1e-14)


def test_dahlquist_three_level():
    """3-level (nt=101, m=2), tol=1e-10 -> 6 iterations (golden
    tests/mpi/results/multilevel_structure)."""
    dahlquist = Dahlquist(t_start=0, t_stop=5, nt=101)
    problem = simple_setup_problem(problem=dahlquist, level=3, coarsening=2)
    mgrit = Mgrit(problem=problem, tol=1e-10, logging_lvl=30)
    conv = mgrit.solve()['conv']
    expected = np.array([1.9402e-4, 7.9766e-6, 2.9930e-7, 8.8816e-9, 1.9390e-10, 3.0370e-12])
    assert len(conv) == 6
    assert np.allclose(conv, expected, rtol=2e-3)


def test_mixed_time_integrators():
    """MR fine level / BE coarse level -> 4 iterations (golden
    tests/mpi/results/time_integrators)."""
    lvl0 = Dahlquist(t_start=0, t_stop=5, nt=101, method='MR')
    lvl1 = Dahlquist(t_start=0, t_stop=5, nt=51, method='BE')
    mgrit = Mgrit(problem=[lvl0, lvl1], logging_lvl=30)
    conv = mgrit.solve()['conv']
    expected = np.array([3.079e-4, 1.104e-5, 3.849e-7, 1.191e-8])
    assert len(conv) == 4
    assert np.allclose(conv, expected, rtol=2e-3)


def test_heat1d_three_level_unit():
    """Reference unit test: 3-level heat_1d (nx=5 interior 3, nt=65/17/5),
    2 iterations: [0.00267692, 0.00018053] (reference
    tests/core/test_mgrit.py:59-70)."""
    import jax.numpy as jnp

    def rhs(x, t):
        # rhs callables are traced under jit/vmap -> must use jnp ops
        return -jnp.sin(jnp.pi * x) * (jnp.sin(t) - 1 * jnp.pi ** 2 * jnp.cos(t))

    def init_cond(x):
        return np.sin(np.pi * x)

    heat0 = Heat1D(x_start=0, x_end=2, nx=5, a=1, rhs=rhs, init_cond=init_cond,
                   t_start=0, t_stop=2, nt=65)
    heat1 = Heat1D(x_start=0, x_end=2, nx=5, a=1, rhs=rhs, init_cond=init_cond,
                   t_start=0, t_stop=2, nt=17)
    heat2 = Heat1D(x_start=0, x_end=2, nx=5, a=1, rhs=rhs, init_cond=init_cond,
                   t_start=0, t_stop=2, nt=5)
    problem = [heat0, heat1, heat2]
    mgrit = Mgrit(problem=problem, cf_iter=1, cycle_type='V', max_iter=2,
                  random_init_guess=False, nested_iteration=True, logging_lvl=30)
    res = mgrit.solve()
    expected = np.array([0.00267692, 0.00018053])
    assert np.allclose(res['conv'], expected, rtol=1e-3)


def test_heat1d_example_history():
    """heat_1d example: nx=1001, nt=65, 5-level F-cycle, tol=1e-8 -> 7 iters
    (golden tests/mpi/results/heat_1d; BASELINE.md row 4)."""

    import jax.numpy as jnp

    def rhs(x, t):
        return -jnp.sin(jnp.pi * x) * (jnp.sin(t) - 1 * jnp.pi ** 2 * jnp.cos(t))

    heat0 = Heat1D(x_start=0, x_end=1, nx=1001, a=1, rhs=rhs,
                   init_cond=lambda x: np.sin(np.pi * x), t_start=0, t_stop=2, nt=65)
    problem = simple_setup_problem(problem=heat0, level=5, coarsening=2)
    mgrit = Mgrit(problem=problem, cf_iter=1, cycle_type='F', nested_iteration=False,
                  max_iter=10, logging_lvl=30)
    conv = mgrit.solve()['conv']
    expected = np.array([1.674e0, 8.233e-2, 4.141e-3, 2.080e-4, 1.024e-5, 4.841e-7, 2.134e-8])
    assert len(conv) == 7
    assert np.allclose(conv, expected, rtol=2e-3)


def test_brusselator_history():
    """brusselator: nt=641, 2-level m=20, FCF (reference
    examples/example_brusselator.py) -> 4 iters (golden
    tests/mpi/results/brusselator)."""
    bruss = Brusselator(t_start=0, t_stop=12, nt=641)
    problem = simple_setup_problem(problem=bruss, level=2, coarsening=20)
    mgrit = Mgrit(problem=problem, cf_iter=1, logging_lvl=30)
    conv = mgrit.solve()['conv']
    expected = np.array([0.0142, 8.20e-5, 1.13e-7, 3.36e-10])
    assert len(conv) == 4
    assert np.allclose(conv, expected, rtol=5e-3)


def test_one_level_equals_sequential():
    """A 1-level MGRIT run must reproduce sequential time stepping exactly
    (reference tests/core/test_mgrit.py:72-84)."""
    import jax
    import jax.numpy as jnp

    heat = Heat1D(x_start=0, x_end=2, nx=33, a=1,
                  init_cond=lambda x: np.sin(np.pi * x), t_start=0, t_stop=2, nt=17)
    mgrit = Mgrit(problem=[heat], nested_iteration=False, max_iter=2, logging_lvl=30)
    mgrit.solve()

    u = np.asarray(mgrit.problem[0].vector_t_start)
    seq = [u]
    for i in range(1, 17):
        u = np.asarray(heat.step(jnp.asarray(u), heat.t[i - 1], heat.t[i]))
        seq.append(u)
    seq = np.stack(seq)
    assert np.allclose(np.asarray(mgrit.u[0]), seq, atol=1e-12)


def test_validation_errors():
    """Bad arguments raise (reference tests/core/test_mgrit.py:220-233)."""
    dahlquist = Dahlquist(t_start=0, t_stop=5, nt=101)
    problem = simple_setup_problem(problem=dahlquist, level=2, coarsening=2)
    with pytest.raises(Exception):
        Mgrit(problem=problem, cycle_type='X', logging_lvl=30)
    with pytest.raises(Exception):
        Mgrit(problem=problem, t_norm=4, logging_lvl=30)
    with pytest.raises(Exception):
        Mgrit(problem=problem, conv_crit=5, logging_lvl=30)
    with pytest.raises(Exception):
        Mgrit(problem=problem, output_lvl=7, logging_lvl=30)
    with pytest.raises(Exception):
        Mgrit(problem=problem, cf_iter=[], logging_lvl=30)
