"""Black-box stepper escape hatch: drive arbitrary host code from the
device-resident MGRIT solver.

The reference couples to external solver stacks by wrapping their data in
Vector subclasses and calling into them from ``step`` — PETSc KSP solves
(reference src/pymgrit/petsc/heat_2D_petsc.py:54-81), Firedrake Newton
solves (firedrake/burgers_firedrake.py:36-75), and a GetDP FEM *binary* via
``subprocess.run`` with tempdir resolution files
(induction_machine/induction_machine.py:96-195).

The equivalent here is one mechanism: ``jax.pure_callback``.  The
solver's batched relaxation sweeps stay jitted on device; at a callback
site the (batched) states are shipped to the host, an arbitrary Python
``step`` runs per batch element (scipy, PETSc, a subprocess — anything),
and the results return to the device.  ``vmap`` over the callback is
expressed with ``vmap_method='sequential'`` so per-element host steppers
compose with the solver's interval batching.
"""

from __future__ import annotations

from typing import Callable

import jax
import numpy as np

from pymgrit_tpu.core.application import Application


class CallbackApplication(Application):
    """Application whose step runs on the host via jax.pure_callback.

    :param host_step: ``f(u: np-pytree, t_start: float, t_stop: float) -> np-pytree``
        executed outside the XLA program.  Must be pure (same inputs -> same
        outputs); called once per batched lane per relaxation sweep.
    :param vector_template: pytree of numpy arrays defining the state shape
    :param vector_t_start: initial state (pytree of numpy arrays)
    """

    def __init__(self, host_step: Callable, vector_template, vector_t_start,
                 *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.host_step = host_step
        self.vector_template = jax.tree_util.tree_map(np.asarray, vector_template)
        self.vector_t_start = jax.tree_util.tree_map(np.asarray, vector_t_start)
        self._result_shapes = jax.tree_util.tree_map(
            lambda x: jax.ShapeDtypeStruct(np.shape(x), np.asarray(x).dtype),
            self.vector_template)

    def step(self, u_start, t_start, t_stop):
        def _host(u, ts, tp):
            out = self.host_step(u, float(ts), float(tp))
            return jax.tree_util.tree_map(np.asarray, out)

        return jax.pure_callback(_host, self._result_shapes, u_start, t_start,
                                 t_stop, vmap_method="sequential")
