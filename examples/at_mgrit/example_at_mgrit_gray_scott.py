"""AT-MGRIT on the 2D Gray-Scott reaction-diffusion system over a
space x time device mesh (mirrors reference
examples/at_mgrit/runme_grayscott.py, which couples PETSc DMDA space
parallelism with AT-MGRIT over MPI; here the state is space-sharded over
the mesh 'space' axis and time intervals batch on device).

Compares sequential time stepping, 2-level Parareal (cf_iter=0) and
3-level AT-MGRIT, as the reference script's run_ts/run_parareal/run_mgrit.
"""

import time

import jax
import jax.numpy as jnp

from pymgrit_tpu import Mgrit, AtMgrit
from pymgrit_tpu.models.gray_scott_2d import GrayScott2D
from pymgrit_tpu.parallel.sharding import make_time_space_mesh

NX = 64        # reference: 128
NT = 2 ** 9    # reference: 2**14 (cluster-scale)
M0, M1 = 16, 4


def build(n_levels):
    gs = [GrayScott2D(nx=NX, method='IMEX', t_start=0, t_stop=8.0, nt=NT)]
    if n_levels > 1:
        gs.append(GrayScott2D(nx=NX, method='IMEX', t_interval=gs[0].t[::M0]))
    if n_levels > 2:
        gs.append(GrayScott2D(nx=NX, method='IMEX', t_interval=gs[1].t[::M1]))
    return gs


def run_ts():
    """Sequential fine-grid stepping as one compiled scan (the reference's
    per-point loop, runme_grayscott.py:18-37)."""
    gs = build(1)[0]
    t = jnp.asarray(gs.t)

    @jax.jit
    def sweep(u0):
        def body(u, ts):
            return gs.step(u, ts[0], ts[1]), None

        u, _ = jax.lax.scan(body, u0, jnp.stack([t[:-1], t[1:]], axis=1))
        return u

    u0 = jax.tree_util.tree_map(jnp.asarray, gs.vector_t_start)
    sweep(u0)  # compile
    start = time.time()
    jax.block_until_ready(sweep(u0))
    print("time-stepping:", time.time() - start, "s")


def run_parareal():
    solver = Mgrit(problem=build(2), cf_iter=0, tol=1e-7, logging_lvl=30)
    info = solver.solve()
    print("parareal iterations:", len(info['conv']))


def run_at_mgrit(mesh=None):
    solver = AtMgrit(k=8, problem=build(3), tol=1e-7, logging_lvl=30,
                     **(dict(mesh=mesh) if mesh is not None else {}))
    info = solver.solve()
    print("AT-MGRIT iterations:", len(info['conv']))


def main():
    run_ts()
    run_parareal()
    n = len(jax.devices())
    # Space x time mesh on accelerators; the CPU backend's FFT thunk rejects
    # the non-major layouts GSPMD picks for the space-sharded spectral solve
    # (xla fft_thunk layout RET_CHECK), so virtual-device runs use a pure
    # time mesh.
    space_shardable_fft = jax.devices()[0].platform != 'cpu'
    if n > 1 and space_shardable_fft:
        mesh = make_time_space_mesh(n_time=max(n // 2, 1), n_space=2)
    elif n > 1:
        mesh = make_time_space_mesh(n_time=n, n_space=1)
    else:
        mesh = None
    run_at_mgrit(mesh)


if __name__ == '__main__':
    main()
