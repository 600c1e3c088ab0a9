"""Arenstorf orbit: restricted three-body problem.

Parity target: reference src/pymgrit/arenstorf_orbit/arenstorf_orbit.py:
79-117 — 4-component ODE with a = 0.012277471, b = 1 - a, ICs
(0.994, 0, 0, -2.00158510637908); the stepper is an *adaptive* RK45 per
MGRIT interval (scipy solve_ivp with default rtol=1e-3, atol=1e-6).

Stepper: a pure-JAX Dormand-Prince 5(4) integrator with scipy's
controller semantics (ops/runge_kutta.py) — jittable and vmapped over all
C-intervals simultaneously, with lane-masked adaptive stepping.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from pymgrit_tpu.core.application import Application
from pymgrit_tpu.ops.runge_kutta import dopri45_integrate


class ArenstorfOrbit(Application):
    """Restricted three-body problem integrated with adaptive DOPRI45."""

    def __init__(self, rtol: float = 1e-3, atol: float = 1e-6, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.a = 0.012277471
        self.b = 1 - self.a
        self.rtol = rtol
        self.atol = atol
        self.vector_template = np.zeros(4)
        self.vector_t_start = np.array([0.994, 0.0, 0.0, -2.00158510637908])

    def _f(self, t, y):
        a, b = self.a, self.b
        d1 = ((y[0] + a) ** 2 + y[1] ** 2) ** 1.5
        d2 = ((y[0] - b) ** 2 + y[1] ** 2) ** 1.5
        return jnp.array([
            y[2],
            y[3],
            y[0] + 2 * y[3] - b * (y[0] + a) / d1 - a * (y[0] - b) / d2,
            y[1] - 2 * y[2] - b * y[1] / d1 - a * y[1] / d2,
        ])

    def step(self, u_start, t_start, t_stop):
        return dopri45_integrate(self._f, u_start, t_start, t_stop,
                                 rtol=self.rtol, atol=self.atol)
