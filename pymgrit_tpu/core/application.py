"""Problem ("application") abstraction.

Mirrors the reference's ``Application`` ABC (reference:
src/pymgrit/core/application.py:32-107): a problem owns a time grid, an
initial state, a template state, and a time integrator ``step``.

Differences from the reference:
  * ``vector_template`` / ``vector_t_start`` are pytrees of jnp arrays, not
    Vector subclasses.
  * ``step(u, t_start, t_stop) -> u`` must be a *pure jittable* function of
    traced inputs; the solver calls it under ``jax.vmap`` (batched over many
    time intervals at once) and inside ``lax.scan``.  No data-dependent
    Python control flow; use lax primitives.
"""

from __future__ import annotations

import abc

import numpy as np

from pymgrit_tpu.core import vector


class MetaApplication(abc.ABCMeta):
    """Enforces presence of required attributes after construction
    (reference: MetaApplication, application.py:17-29)."""

    required_attributes = ["vector_template", "vector_t_start"]

    def __call__(cls, *args, **kwargs):
        obj = super().__call__(*args, **kwargs)
        for attr_name in MetaApplication.required_attributes:
            if getattr(obj, attr_name, None) is None:
                raise ValueError("required attribute (%s) not set" % attr_name)
        return obj


class Application(metaclass=MetaApplication):
    """Base class for user problems (reference: application.py:32-107).

    Subclasses must set ``self.vector_template`` (zero pytree state) and
    ``self.vector_t_start`` (initial-condition pytree state) in __init__ and
    implement ``step``.
    """

    required_attributes = ["vector_template", "vector_t_start"]

    def __init__(self, t_start: float = None, t_stop: float = None, nt: int = None,
                 t_interval: np.ndarray = None) -> None:
        # Time-grid construction semantics match reference application.py:45-68.
        if t_interval is None:
            if t_start is None or t_stop is None or nt is None:
                raise Exception('Specify an interval by t_start, t_stop and nt or by t_interval')
            self.t_start = t_start
            self.t_end = t_stop
            self.nt = nt
            self.t = np.linspace(self.t_start, self.t_end, nt)
        else:
            if not isinstance(t_interval, np.ndarray):
                raise Exception('t_interval has the wrong type. Should be a numpy array')
            self.t_start = t_interval[0]
            self.t_end = t_interval[-1]
            self.nt = len(t_interval)
            self.t = t_interval

        self.vector_template = None
        self.vector_t_start = None

    @abc.abstractmethod
    def step(self, u_start, t_start, t_stop):
        """Evolve state u_start from t_start to t_stop (pure, jittable).

        :param u_start: pytree state at t_start
        :param t_start: scalar (possibly traced)
        :param t_stop: scalar (possibly traced)
        :return: pytree state at t_stop
        """

    # ------------------------------------------------------------------
    # Optional hooks the solver will use when present.
    # ------------------------------------------------------------------

    def initial_tube(self, nt: int):
        """A zero tube of nt states (override for custom init)."""
        return vector.tube_of(self.vector_template, nt)

    # ------------------------------------------------------------------
    # Runtime-operand channel.  An application with large precomputed
    # tables (basis matrices, rhs tables, closed-form relaxation tables)
    # would otherwise have them BAKED into every jitted solver program as
    # MLIR constants — at the 257^2 TOMS scale that is tens of MB of
    # constants replicated across each of the ~6 traced relaxation sites,
    # which blows up compile memory/time (round-3 `toms257_error`).  The
    # solver instead calls `prepare_runtime` + `runtime_params` once at
    # setup and passes the returned pytree as a real argument into every
    # jitted entry point, rebinding it (as tracers) on the application
    # for the duration of each trace.  No reference analogue: the
    # reference's scipy steppers hold their CSR matrices host-side
    # (reference heat_2d.py:250-287).
    # ------------------------------------------------------------------

    _rt = None   # bound runtime params (tracers during a solver trace)

    def prepare_runtime(self, level_info) -> None:
        """Pre-build any level-structure-dependent tables (outside jit).

        Called by the solver with this level's static ``LevelInfo`` before
        ``runtime_params`` is collected.  Default: nothing to prepare.
        """

    def runtime_params(self):
        """Pytree of large device-array operands, or None.

        Whatever is returned is passed through the jit boundary and bound
        back onto the application (``self._rt``) while solver functions
        trace, so traced code can prefer ``self._rt[...]`` over baking
        host constants.
        """
        return None
