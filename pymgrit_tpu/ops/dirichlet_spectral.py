"""Fast Dirichlet-Laplacian solvers via sine-eigenbasis matmuls.

The reference applications solve ``(I + dt*theta*L) u = b`` with scipy's
sparse LU per time step (reference: src/pymgrit/heat/heat_1d.py:198-217,
heat_2d.py:322-366).  A sparse triangular solve is a sequential chain per
step; instead we diagonalize: the 1D Dirichlet stencil (a/dx^2)*[-1 2 -1] on n
interior points has the analytically known orthonormal eigenbasis

    S[j, k] = sqrt(2/(n+1)) * sin((j+1)(k+1) pi / (n+1)),
    lam_k   = (a/dx^2) * (2 - 2 cos((k+1) pi/(n+1))),

so the implicit solve becomes two dense matmuls and an elementwise scale,
batched over all C-points/intervals at once.  Accuracy is machine-roundoff (the basis is exactly orthogonal up to
fp rounding), matching spsolve to ~1e-13, far below MGRIT's 1e-10 tolerances.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp


def sine_eigenbasis(n: int, fac: float):
    """Orthonormal eigenbasis (S, lam) of the n-point Dirichlet stencil
    fac * [-1, 2, -1]. S is symmetric and orthogonal: S @ S == I."""
    j = np.arange(1, n + 1)
    S = np.sqrt(2.0 / (n + 1)) * np.sin(np.outer(j, j) * np.pi / (n + 1))
    lam = fac * (2.0 - 2.0 * np.cos(j * np.pi / (n + 1)))
    # numpy outputs: stored as model constants, folded in at trace time
    # (no eager device op per model construction).
    return S, lam


def solve_shifted_1d(S, lam, shift_scale, b):
    """Solve (I + shift_scale * L) x = b where L = S diag(lam) S.

    shift_scale is a traced scalar (dt or dt*theta); b has shape (n,).
    """
    bh = S @ b
    xh = bh / (1.0 + shift_scale * lam)
    return S @ xh


def solve_helmholtz_1d(S, lam, coeff, b):
    """Solve (L + coeff * I) x = b (used by BDF2, reference
    heat_1d_2pts_bdf2.py:113-133 solves (L + c I) x = rhs)."""
    bh = S @ b
    return S @ (bh / (lam + coeff))


def solve_shifted_2d(Sx, lamx, Sy, lamy, shift_scale, b):
    """Solve (I + shift_scale * (Lx (x) I + I (x) Ly)) x = b for b of shape
    (nx, ny): two-sided diagonalization, all matmuls."""
    bh = Sx @ b @ Sy
    denom = 1.0 + shift_scale * (lamx[:, None] + lamy[None, :])
    return Sx @ (bh / denom) @ Sy


def apply_laplacian_1d(S, lam, u):
    """L @ u via the eigenbasis (rarely needed; direct stencil is cheaper)."""
    return S @ ((S @ u) * lam)
