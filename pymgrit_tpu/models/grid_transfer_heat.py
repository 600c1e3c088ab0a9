"""1D and 2D spatial transfers between nested heat grids.

Parity targets:
  * 1D (``GridTransferHeat``): the documented spatial-coarsening example
    transfer (reference examples/example_spatial_coarsening.py:18-86 and
    docs/source/usage/advanced.rst): full-weighting restriction
    [1/4, 1/2, 1/4] and linear interpolation between nested Dirichlet
    interior-point grids (fine n -> coarse (n-1)/2).
  * 2D (``GridTransferHeat2D``): the PETSc DMDA transfer
    (reference src/pymgrit/petsc/heat_2D_petsc.py:196-232) —
    ``createInjection`` restriction (pick coincident vertices) and
    ``createInterpolation`` bilinear interpolation between nested
    vertex-centered grids (fine n -> coarse (n+1)/2, boundary included).

The reference delegates to PETSc mat-vecs / Python loops; here both
operators are vectorized slice arithmetic (pure elementwise ops, vmapped over the
time axis by the solver).
"""

from __future__ import annotations

import jax.numpy as jnp

from pymgrit_tpu.core.grid_transfer import GridTransfer


class GridTransferHeat(GridTransfer):
    """Full-weighting / linear-interpolation transfer for interior-point
    Dirichlet grids."""

    def restriction(self, u):
        # ret[i] = u[2i]/4 + u[2i+1]/2 + u[2i+2]/4
        return u[:-2:2] * 0.25 + u[1:-1:2] * 0.5 + u[2::2] * 0.25

    def interpolation(self, u):
        # ret[2i] += u[i]/2; ret[2i+1] = u[i]; ret[2i+2] += u[i]/2
        # Works for plain arrays and DD states (ops/dd.py): the scatter
        # syntax and operators are polymorphic, only the zero allocation
        # needs a branch.
        from pymgrit_tpu.ops.dd import DD, _raw
        n = u.shape[0]

        def zeros(m):
            if isinstance(u, DD):
                return _raw(jnp.zeros(m, dtype=u.dtype), jnp.zeros(m, dtype=u.dtype))
            return jnp.zeros(m, dtype=u.dtype)

        even = zeros(n + 1)
        even = even.at[:-1].add(0.5 * u)
        even = even.at[1:].add(0.5 * u)
        out = zeros(2 * n + 1)
        out = out.at[1::2].set(u)
        out = out.at[::2].set(even)
        return out


def _interp_1d_vertex(u, axis):
    """Linear interpolation along ``axis`` between nested vertex-centered
    grids: coarse n -> fine 2n-1.  Coincident points copy; midpoints
    average — exactly the 1D factor of DMDA ``createInterpolation``."""
    u = jnp.moveaxis(u, axis, 0)
    n = u.shape[0]
    out = jnp.zeros((2 * n - 1,) + u.shape[1:], dtype=u.dtype)
    out = out.at[::2].set(u)
    out = out.at[1::2].set(0.5 * (u[:-1] + u[1:]))
    return jnp.moveaxis(out, 0, axis)


class GridTransferHeat2D(GridTransfer):
    """Injection restriction / bilinear interpolation between nested 2D
    vertex-centered grids (boundary ring included), fine (2n-1) x (2m-1)
    <-> coarse n x m.

    This is the native analogue of the reference's ``GridTransferPetsc``
    (petsc/heat_2D_petsc.py:196-232): ``restriction`` = DMDA
    ``createInjection`` (sample the coincident fine vertices),
    ``interpolation`` = DMDA ``createInterpolation`` (tensor-product
    bilinear: copy coincident points, average edge midpoints, 4-point
    average for cell centers).  Matches the ``Heat2D`` state layout
    (models/heat_2d.py: full (nx, ny) array including the Dirichlet ring).
    """

    def __init__(self, nx_fine: int, ny_fine: int):
        if nx_fine % 2 == 0 or ny_fine % 2 == 0:
            raise Exception(
                "GridTransferHeat2D needs odd fine dimensions (nested "
                "vertex-centered grids: fine = 2*coarse - 1); got "
                f"({nx_fine}, {ny_fine})")
        self.nx_fine = nx_fine
        self.ny_fine = ny_fine
        self.nx_coarse = (nx_fine + 1) // 2
        self.ny_coarse = (ny_fine + 1) // 2

    def restriction(self, u):
        # DMDA injection: coarse[i, j] = fine[2i, 2j]
        return u[::2, ::2]

    def interpolation(self, u):
        return _interp_1d_vertex(_interp_1d_vertex(u, 0), 1)
