"""1D advection with periodic BCs, first-order upwind + backward Euler.

Parity target: reference src/pymgrit/advection/advection_1d.py:70-143 —
periodic upwind matrix (101-120), BE step via sparse solve (129-143), IC
``exp(-x^2)`` (122-127).

Stepper: the matrix (I + dt*A) is *circulant* (first column
[1 + dt*c/dx, -dt*c/dx, 0, ...]) and diagonalizes in the Fourier basis, so
the implicit solve is one FFT, an elementwise divide, and an inverse FFT —
no sparse LU, fully batched under vmap.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from pymgrit_tpu.core.application import Application


class Advection1D(Application):
    """u_t + c*u_x = 0 with periodic BCs, upwind/BE discretization."""

    def __init__(self, c: float, x_start: float, x_end: float, nx: int, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.c = c
        x = np.linspace(x_start, x_end, nx)
        self.x = x[0:-1]          # periodic: drop duplicated endpoint
        self.nx = nx - 1
        self.dx = self.x[1] - self.x[0]
        self.fac = c / self.dx

        # Eigenvalues of the circulant shift: A = fac*(I - P) with P the
        # down-shift permutation; eig(P)_k = exp(-2i pi k/n).
        k = np.arange(self.nx)
        self._shift_eigs = np.exp(-2j * np.pi * k / self.nx)

        self.vector_template = np.zeros(self.nx)
        self.vector_t_start = np.exp(-self.x ** 2)

    def step(self, u_start, t_start, t_stop):
        dt = t_stop - t_start
        # (I + dt*A) u = u_start with A = fac*(I - P)
        denom = 1.0 + dt * self.fac * (1.0 - self._shift_eigs)
        uh = jnp.fft.fft(u_start)
        return jnp.real(jnp.fft.ifft(uh / denom))
