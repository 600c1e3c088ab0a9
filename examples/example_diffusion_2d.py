"""2D P1-DG interior-penalty diffusion, two-level MGRIT.

Parity target: reference examples/firedrake/
example_diffusion_2d_firedrake.py — PeriodicSquareMesh(20, 20, 10),
kappa=0.1, Gaussian blob initial condition, two-level V-cycles with
FCF-relaxation.

Here the Firedrake DG solve becomes a generalized-eigenbasis step
(two dense matmuls; models/diffusion_2d.py) — no external FEM stack,
fully jit/vmap-compatible, space-shardable over the DOF axis.
"""

from pymgrit_tpu import Diffusion2D, Mgrit


def main():
    n = 20           # 20 x 20 periodic cells on a 10 x 10 square
    diffusion0 = Diffusion2D(n=n, length=10.0, kappa=0.1,
                             t_start=0, t_stop=10, nt=17)
    diffusion1 = Diffusion2D(n=n, length=10.0, kappa=0.1,
                             t_start=0, t_stop=10, nt=9)

    mgrit = Mgrit(problem=[diffusion0, diffusion1])
    info = mgrit.solve()
    return info


if __name__ == '__main__':
    main()
