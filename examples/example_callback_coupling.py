"""Black-box stepper coupling: an external (host/CPU) solver driven by the
device-resident MGRIT solver via jax.pure_callback - the analogue
of the reference's PETSc/Firedrake/GetDP couplings (reference
src/pymgrit/petsc/heat_2D_petsc.py, induction_machine/induction_machine.py)."""

import numpy as np
import scipy.sparse as sp
from scipy.sparse.linalg import spsolve

from pymgrit_tpu import Mgrit
from pymgrit_tpu.coupling import CallbackApplication


def main():
    nx = 129
    x = np.linspace(0, 2, nx)[1:-1]
    n = nx - 2
    dx = x[1] - x[0]
    fac = 1.0 / dx ** 2
    L = sp.diags([2 * fac * np.ones(n), -fac * np.ones(n - 1), -fac * np.ones(n - 1)],
                 [0, -1, 1], format='csc')
    eye = sp.identity(n, format='csc')

    def host_step(u, t_start, t_stop):
        # Arbitrary external stack: scipy here; PETSc / a subprocess / an
        # FEM binary all fit the same signature.
        return spsolve((t_stop - t_start) * L + eye, u)

    apps = [CallbackApplication(host_step=host_step,
                                vector_template=np.zeros(n),
                                vector_t_start=np.sin(np.pi * x),
                                t_start=0, t_stop=2, nt=nt)
            for nt in (65, 17, 5)]

    mgrit = Mgrit(problem=apps, tol=1e-9)
    return mgrit.solve()


if __name__ == '__main__':
    main()
