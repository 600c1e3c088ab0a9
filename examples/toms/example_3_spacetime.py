"""TOMS paper, example 3: space-time parallel 2D heat equation.

Parity target: reference examples/toms/example_3_petsc.py (1-377) — the
TOMS experiment runs a 129x129 2D heat problem with exact solution

    u(x, y, t) = sin(pi f x) sin(pi f y) cos(t)

over nt = 2^14+1 time points, comparing sequential time-stepping against
5-level MGRIT (coarsening 32/16/4/4, V- and F-cycles) on a space x time
process grid, with per-phase timing accumulators around the PETSc KSP solve.

Here the PETSc DMDA + GMRES space solve becomes the native
``Heat2D`` stepper (sharded over the mesh 'space' axis — spatial domain
decomposition without any hand-written communicator code), the
split_communicator 2D process grid becomes a ('time','space') device mesh,
and the per-phase accumulators become the solver's phase profiler.

Run with 8 virtual CPU devices:
  JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
  python examples/toms/example_3_spacetime.py
"""

import time

import numpy as np
import jax
import jax.numpy as jnp

from pymgrit_tpu import Heat2D, Mgrit
from pymgrit_tpu.parallel.sharding import make_time_space_mesh

# Default scale is CI-sized; the PAPER configuration (129x129, nt=2^14+1)
# runs with PYMGRIT_TPU_TOMS_FULL=1 (chip_smoke.py runs it on the GPU).
import os as _os
_FULL = _os.environ.get("PYMGRIT_TPU_TOMS_FULL", "") == "1"
NX = NY = 129 if _FULL else 65
NT = 2 ** 14 + 1 if _FULL else 2 ** 10 + 1
COARSENING = [32, 16, 4, 4]
FREQ = 1
A = 1.0


def build(nt=NT, coarsening=COARSENING, freq=FREQ, a=A, t_stop=1.0, nx=NX):
    """The TOMS problem hierarchy (reference example_3_petsc.py:340-352),
    nx x nx points in space."""

    def rhs(x, y, t):
        # manufactured so that u_exact solves u_t = a*Lap(u) + rhs
        return -jnp.sin(jnp.pi * freq * x) * jnp.sin(jnp.pi * freq * y) * (
            jnp.sin(t) - a * 2.0 * (jnp.pi * freq) ** 2 * jnp.cos(t))

    def init_cond(x, y):
        return np.sin(np.pi * freq * x) * np.sin(np.pi * freq * y)

    t_interval = np.linspace(0, t_stop, nt)
    problem = [Heat2D(x_start=0, x_end=1, y_start=0, y_end=1, nx=nx, ny=nx,
                      a=a, rhs=rhs, init_cond=init_cond,
                      t_interval=t_interval)]
    for i in range(len(coarsening)):
        problem.append(
            Heat2D(x_start=0, x_end=1, y_start=0, y_end=1, nx=nx, ny=nx,
                   a=a, rhs=rhs, init_cond=init_cond,
                   t_interval=t_interval[::np.prod(coarsening[:i + 1],
                                                   dtype=int)]))
    return problem


def u_exact(problem, t):
    x, y = np.meshgrid(problem.x, problem.y, indexing='ij')
    return (np.sin(np.pi * FREQ * x) * np.sin(np.pi * FREQ * y))[None] \
        * np.cos(t)[:, None, None]


def run_timestepping(nt=NT):
    """Sequential baseline (reference example_3_petsc.py:320-336), as one
    compiled lax.scan over the whole time grid."""
    problem = build(nt=nt, coarsening=[])
    p = problem[0]
    t = jnp.asarray(p.t)

    @jax.jit
    def sweep(u0):
        def body(u, i):
            return p.step(u, t[i - 1], t[i]), None

        u_final, _ = jax.lax.scan(body, u0, jnp.arange(1, len(p.t)))
        return u_final

    u0 = jnp.asarray(p.vector_t_start, dtype=jnp.float64)
    sweep(u0)  # compile
    start = time.time()
    u_final = jax.block_until_ready(sweep(u0))
    solve = time.time() - start
    err = float(np.max(np.abs(np.asarray(u_final)
                              - u_exact(p, np.array([p.t[-1]]))[0])))
    return {'time_setup': 0.0, 'time_solve': solve, 'error': err}


def run_mgrit(nt=NT, coarsening=COARSENING, cycle='V', n_time=None,
              n_space=None):
    """MGRIT on the ('time','space') mesh (reference
    example_3_petsc.py:339-363: V default, or F-cycle with cf_iter=0)."""
    n_dev = len(jax.devices())
    if n_time is None:
        n_space = n_space or (2 if n_dev >= 4 else 1)
        n_time = max(n_dev // n_space, 1)
    mesh = make_time_space_mesh(n_time=n_time, n_space=n_space)
    problem = build(nt=nt, coarsening=coarsening)
    kwargs = dict(problem=problem, mesh=mesh,
                  nested_iteration=len(coarsening) > 0)
    if cycle == 'F':
        kwargs.update(cycle_type='F', cf_iter=0)
    mgrit = Mgrit(**kwargs)
    info = mgrit.solve()
    u = np.asarray(mgrit.u[0])[:len(problem[0].t)]
    err = float(np.max(np.abs(u - u_exact(problem[0], problem[0].t))))
    return {'time_setup': mgrit.runtime_setup, 'time_solve': mgrit.runtime_solve,
            'iterations': len(info['conv']), 'error': err, 'conv': info['conv']}


def main():
    print(f"TOMS example 3 at {NX}x{NY}, nt={NT} "
          f"({'PAPER scale' if _FULL else 'CI scale; set PYMGRIT_TPU_TOMS_FULL=1 for 129x129, nt=2^14+1'})")
    seq = run_timestepping()
    print(f"time-stepping    : solve {seq['time_solve']:.3f}s "
          f"error {seq['error']:.3e}")
    for cycle in ('V', 'F'):
        res = run_mgrit(cycle=cycle)
        print(f"MGRIT {cycle}-cycle    : setup {res['time_setup']:.3f}s "
              f"solve {res['time_solve']:.3f}s "
              f"iters {res['iterations']} error {res['error']:.3e}")
    return seq


if __name__ == '__main__':
    main()
