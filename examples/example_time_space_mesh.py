"""Space-time parallelism on a ('time','space') device mesh - the analogue
of the reference's split_communicator 2D process grid (reference
src/pymgrit/core/split.py, examples/petsc4py/example_heat_2d_petsc.py).

Run tests/CI style with 8 virtual CPU devices:
  JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
  python examples/example_time_space_mesh.py
"""

from pymgrit_tpu import Heat2D, Mgrit
from pymgrit_tpu.parallel.sharding import make_time_space_mesh


def main():
    import jax
    n = len(jax.devices())
    mesh = make_time_space_mesh(n_time=max(n // 2, 1), n_space=2 if n >= 4 else 1)

    def rhs(x, y, t):
        return 5 * x * (1 - x) * y * (1 - y) + 0 * t

    heat0 = Heat2D(x_start=0, x_end=1, y_start=0, y_end=1, nx=32, ny=33, a=1.0,
                   rhs=rhs, t_start=0, t_stop=1, nt=129)
    heat1 = Heat2D(x_start=0, x_end=1, y_start=0, y_end=1, nx=32, ny=33, a=1.0,
                   rhs=rhs, t_interval=heat0.t[::4])

    mgrit = Mgrit(problem=[heat0, heat1], mesh=mesh)
    return mgrit.solve()


if __name__ == '__main__':
    main()
