"""Dahlquist test equation u' = lambda*u.

Parity target: reference src/pymgrit/dahlquist/dahlquist.py:60-111 (BE/FE/TR
implicit-midpoint steppers, lambda configurable, IC u(0) = 1).  The state is
a 0-d jnp array; all four integrators are closed-form scalar updates, so the
batched relaxation sweeps reduce to pure elementwise math.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from pymgrit_tpu.core.application import Application


class Dahlquist(Application):
    """u' = lambda*u with lambda = -1 (default) and u(0) = 1.

    ``precision='dd'`` switches the state to double-double float32 pairs
    (ops/dd.py): the step body is unchanged — the DD operator overloads give
    it fp64-class accuracy from float32 arithmetic, reproducing the
    reference's 1e-10-tolerance golden history."""

    def __init__(self, constant_lambda: float = -1, method: str = 'BE',
                 precision: str = None, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.lambda_value = constant_lambda
        if method in ('BE', 'FE', 'TR', 'MR'):
            self.method = method
        else:
            raise Exception(
                'Unknown method. Choose BE (Backward Euler), FE (Forward Euler), TR (Trapezoidal rule) ' +
                'or MR (implicit mid-point rule)')
        if precision == 'dd':
            from pymgrit_tpu.ops import dd
            self.vector_template = dd.from_f64(np.zeros(()))
            self.vector_t_start = dd.from_f64(np.ones(()))
        else:
            self.vector_template = np.zeros(())
            self.vector_t_start = np.ones(())
            # all four integrators are affine (here: linear) scalar maps, so
            # the solver's parallel-prefix coarsest solve (ops/prefix.py,
            # Mgrit(coarsest_prefix=True)) applies; DD states keep the
            # sequential scan (the prefix combine is plain-float only)
            self.affine_coeffs = self._affine_coeffs

    def step(self, u_start, t_start, t_stop):
        z = (t_stop - t_start) * self.lambda_value
        if self.method == 'BE':
            return u_start / (1 - z)
        if self.method == 'FE':
            return (1 + z) * u_start
        if self.method == 'TR':
            return (1 + z / 2) / (1 - z / 2) * u_start
        # MR: implicit mid-point rule (reference dahlquist.py:107-109)
        k1 = -1 / (1 - z / 2) * u_start
        return u_start + (t_stop - t_start) * k1

    def _affine_coeffs(self, t_start, t_stop):
        """(A, b) with step(u, t0, t1) == A*u + b — the contract of the
        parallel-prefix coarsest solve (core/solver.py:_forward_solve)."""
        z = (t_stop - t_start) * self.lambda_value
        zero = jnp.zeros(())
        if self.method == 'BE':
            return 1 / (1 - z), zero
        if self.method == 'FE':
            return 1 + z, zero
        if self.method == 'TR':
            return (1 + z / 2) / (1 - z / 2), zero
        # MR keeps the reference's fixed -1 in k1 (dahlquist.py:107-109)
        return 1 + (t_stop - t_start) * (-1 / (1 - z / 2)), zero
