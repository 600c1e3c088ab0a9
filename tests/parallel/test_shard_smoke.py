"""Fast distributed smoke for the core tier: both executors reproduce the
serial Dahlquist history on an 8-device mesh in seconds (the heavy parity
matrices live in the slow tier: test_shard_solver / test_shard_features /
test_shard_nonuniform / test_mesh_invariance)."""

import numpy as np
import jax
import pytest
from jax.sharding import Mesh

from pymgrit_tpu import Mgrit, Dahlquist, Heat2D, simple_setup_problem
from pymgrit_tpu.parallel.shard_solver import ShardedMgrit
from pymgrit_tpu.parallel.sharding import make_time_space_mesh


def _build():
    return simple_setup_problem(problem=Dahlquist(t_start=0, t_stop=5, nt=101),
                                level=3, coarsening=2)


def test_both_executors_match_serial():
    conv = Mgrit(problem=_build(), tol=1e-10, logging_lvl=30).solve()['conv']
    mesh8 = Mesh(np.array(jax.devices("cpu")[:8]).reshape(8, 1),
                 ("time", "space"))
    conv_g = Mgrit(problem=_build(), mesh=mesh8, tol=1e-10,
                   logging_lvl=30).solve()['conv']
    s = ShardedMgrit(problem=_build(),
                     mesh=Mesh(np.array(jax.devices("cpu")[:8]), ("time",)),
                     tol=1e-10, logging_lvl=30)
    conv_s = s.solve_compiled()['conv']
    assert len(conv) == len(conv_g) == len(conv_s)
    np.testing.assert_allclose(conv_g, conv, rtol=1e-9, atol=1e-13)
    np.testing.assert_allclose(conv_s, conv, rtol=1e-9, atol=1e-13)


@pytest.mark.parametrize("nx", [16, 17])
def test_heat2d_time_space_mesh(nx):
    """ShardedMgrit on a 2x2 (time, space) mesh: an even width splits over
    'space', an odd one stays replicated there; both match the serial
    solve and its fine solution."""
    def build():
        def rhs(x, y, t):
            return 5 * x * (1 - x) * y * (1 - y) + 0 * t

        h0 = Heat2D(x_start=0, x_end=1, y_start=0, y_end=1, nx=nx, ny=19,
                    a=1.0, rhs=rhs, t_start=0, t_stop=1, nt=65)
        h1 = Heat2D(x_start=0, x_end=1, y_start=0, y_end=1, nx=nx, ny=19,
                    a=1.0, rhs=rhs, t_interval=h0.t[::4])
        return [h0, h1]

    kw = dict(tol=1e-11, max_iter=6, logging_lvl=30)
    serial = Mgrit(problem=build(), **kw)
    base = serial.solve()['conv']
    mesh = make_time_space_mesh(n_time=2, n_space=2)
    sharded = ShardedMgrit(problem=build(), mesh=mesh, **kw)
    conv = sharded.solve()['conv']
    assert len(conv) == len(base)
    np.testing.assert_allclose(conv, base, rtol=1e-6, atol=1e-15)
    np.testing.assert_allclose(np.asarray(sharded.fine_solution()),
                               np.asarray(serial.u[0][:65]), rtol=0,
                               atol=1e-12)
