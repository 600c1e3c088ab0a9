"""Mesh-shape invariance: the distributed solver must produce the same
residual history on any ('time', 'space') mesh shape — the SPMD analogue of
the reference's rank-count invariance CI (reference tests/mpi/mpi.py:49:
histories identical to 4 decimals for np=1..7)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from pymgrit_tpu import Mgrit, Dahlquist, Heat1D, Heat2D, simple_setup_problem
from pymgrit_tpu.parallel.sharding import make_time_space_mesh


def _dahlquist_conv(mesh):
    problem = simple_setup_problem(problem=Dahlquist(t_start=0, t_stop=5, nt=101),
                                   level=2, coarsening=2)
    return Mgrit(problem=problem, tol=1e-10, logging_lvl=30, mesh=mesh).solve()['conv']


def test_dahlquist_mesh_invariance():
    base = _dahlquist_conv(None)
    for n_time in (2, 4, 8):
        mesh = make_time_space_mesh(n_time=n_time, n_space=1)
        conv = _dahlquist_conv(mesh)
        assert len(conv) == len(base)
        np.testing.assert_allclose(conv, base, rtol=1e-6, atol=1e-15)


def test_heat2d_time_space_mesh():
    """2D heat on a (4, 2) time x space mesh — both axes active."""
    def build():
        x_end, y_end, a = 0.75, 1.5, 3.5

        def rhs(x, y, t):
            return 5 * x * (x_end - x) * y * (y_end - y) + \
                10 * a * t * (y * (y_end - y) + x * (x_end - x))

        heat0 = Heat2D(x_start=0, x_end=x_end, y_start=0, y_end=y_end, nx=17, ny=33,
                       a=a, rhs=rhs, t_start=0, t_stop=1, nt=33)
        heat1 = Heat2D(x_start=0, x_end=x_end, y_start=0, y_end=y_end, nx=17, ny=33,
                       a=a, rhs=rhs, t_interval=heat0.t[::2])
        return [heat0, heat1]

    base = Mgrit(problem=build(), logging_lvl=30, max_iter=3, tol=1e-12).solve()['conv']
    mesh = make_time_space_mesh(n_time=4, n_space=2)
    conv = Mgrit(problem=build(), logging_lvl=30, max_iter=3, tol=1e-12,
                 mesh=mesh).solve()['conv']
    assert len(conv) == len(base)
    np.testing.assert_allclose(conv, base, rtol=1e-6, atol=1e-15)


def test_heat1d_fcycle_mesh_invariance():
    """5-level F-cycle under an 8-way time mesh matches serial."""
    def rhs(x, t):
        return -jnp.sin(jnp.pi * x) * (jnp.sin(t) - 1 * jnp.pi ** 2 * jnp.cos(t))

    def build():
        return [Heat1D(x_start=0, x_end=1, nx=129, a=1, rhs=rhs,
                       init_cond=lambda x: np.sin(np.pi * x),
                       t_start=0, t_stop=2, nt=nt)
                for nt in (65, 33, 17, 9, 5)]

    kw = dict(tol=1e-8, cf_iter=1, cycle_type='F', nested_iteration=False,
              max_iter=10, logging_lvl=30)
    base = Mgrit(problem=build(), **kw).solve()['conv']
    mesh = make_time_space_mesh(n_time=8, n_space=1)
    conv = Mgrit(problem=build(), mesh=mesh, **kw).solve()['conv']
    np.testing.assert_allclose(conv, base, rtol=1e-6, atol=1e-15)


def test_mesh_too_big_raises():
    with pytest.raises(Exception):
        make_time_space_mesh(n_time=64, n_space=4)


def test_at_mgrit_mesh_invariance():
    """AT-MGRIT's batched truncated windows under a time mesh (the
    all_gather-based coarsest strategy, reference at_mgrit.py:45-76)."""
    from pymgrit_tpu import AtMgrit

    def build():
        return [Dahlquist(t_start=0, t_stop=5, nt=129),
                Dahlquist(t_start=0, t_stop=5, nt=33)]

    kw = dict(k=4, tol=1e-9, max_iter=10, logging_lvl=30)
    base = AtMgrit(problem=build(), **kw).solve()['conv']
    mesh = make_time_space_mesh(n_time=8, n_space=1)
    conv = AtMgrit(problem=build(), mesh=mesh, **kw).solve()['conv']
    assert len(conv) == len(base)
    np.testing.assert_allclose(conv, base, rtol=1e-6, atol=1e-15)
