"""2D Allen-Cahn equation with periodic BCs.

Parity target: reference src/pymgrit/allen_cahn/allen_cahn.py:139-260 —
periodic 5-point Laplacian via kron (172-189), three steppers: IMEX
(201-205), fully implicit with inner Newton iteration (219-227), CN variant
(211-214); tanh circle initial condition (231-244); radius diagnostics
(246-260).

Steppers: the periodic Laplacian diagonalizes in the Fourier
basis, so the IMEX solve is FFT / elementwise / iFFT.  The Newton methods
solve the Jacobian system (I - fac*(L + (1/eps^2) diag(1-(nu+1)u^nu)))
with preconditioned CG — the preconditioner is the exact FFT inverse of the
constant-coefficient part, so CG converges in a handful of iterations; the
Laplacian matvec is a 5-point stencil of jnp.roll (elementwise, no sparse
structures).
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

from pymgrit_tpu.core.application import Application


class AllenCahn(Application):
    """u_t = Lap(u) + 1/eps^2 u(1-u^nu), periodic BCs on [-0.5, 0.5]^2."""

    def __init__(self, nx: int = 128, nu: int = 2, eps: float = 0.04,
                 newton_maxiter: int = 100, newton_tol: float = 1e-12,
                 lin_tol: float = 1e-12, lin_maxiter: int = 100,
                 radius: float = 0.25, method: str = 'IMPL', *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.nu = nu
        self.eps = eps
        self.newton_maxiter = newton_maxiter
        self.newton_tol = newton_tol
        self.lin_tol = lin_tol
        self.lin_maxiter = lin_maxiter
        self.radius = radius
        self.nx = nx
        self.ny = nx
        if method not in ('IMPL', 'IMEX', 'CN'):
            raise Exception("Unknown method. Choose IMPL (implicit), IMEX (implicit-explicit) or CN (Crank-Nicolson")
        self.method = method

        self.dx = 1.0 / nx
        self.x = np.linspace(start=-0.5, stop=0.5, num=nx)

        # Fourier eigenvalues of the periodic 1D stencil [1, -2, 1]/dx^2
        k = np.arange(nx)
        lam1d = (2.0 * np.cos(2.0 * np.pi * k / nx) - 2.0) / self.dx ** 2
        self.lap_eigs = lam1d[:, None] + lam1d[None, :]  # (nx, nx)
        # DFT as dense complex matmuls instead of jnp.fft: the same linear
        # map, GSPMD-partitionable over 'space' (XLA CPU's fft thunk
        # RET_CHECKs on the transposed layouts the partitioner feeds it when
        # the state is sharded).  Whether matmuls or an FFT are faster on a
        # given device is a measurement question.
        self._F = np.exp(-2j * np.pi * np.outer(k, k) / nx)
        self._Finv = np.conj(self._F) / nx

        # State axis 0 may be sharded over the mesh 'space' axis (GSPMD
        # inserts the DFT and roll collectives).
        self.space_sharding_axis = 0

        self.vector_template = np.zeros((nx, nx))
        r2 = self.x[:, None] ** 2 + self.x[None, :] ** 2
        self.vector_t_start = np.tanh((radius - np.sqrt(r2)) / (np.sqrt(2) * eps))

    # ------------------------------------------------------------------

    def _lap(self, u):
        """Periodic 5-point Laplacian via rolls (matches the kron matrix,
        reference allen_cahn.py:172-189)."""
        return (jnp.roll(u, 1, 0) + jnp.roll(u, -1, 0) +
                jnp.roll(u, 1, 1) + jnp.roll(u, -1, 1) - 4.0 * u) / self.dx ** 2

    def _fft_solve(self, shift, b):
        """Exact solve of (I - shift*L) x = b via Fourier diagonalization
        (dense DFT matmuls; see constructor note)."""
        bh = self._F @ (b + 0j) @ self._F.T
        xh = bh / (1.0 - shift * self.lap_eigs)
        return jnp.real(self._Finv @ xh @ self._Finv.T)

    def _nonlin(self, u):
        return 1.0 / self.eps ** 2 * u * (1.0 - u ** self.nu)

    def _newton_solve(self, rhs, fac, u0):
        """Solve u - fac*(L u + f(u)) = rhs by Newton + preconditioned CG
        (reference allen_cahn.py:216-227 uses Newton + sparse LU)."""
        eps2 = self.eps ** 2
        nu = self.nu

        def g_of(u):
            return u - fac * (self._lap(u) + self._nonlin(u)) - rhs

        def jac_mv(u, v):
            diag = 1.0 / eps2 * (1.0 - (nu + 1) * u ** nu)
            return v - fac * (self._lap(v) + diag * v)

        def precond(v):
            return self._fft_solve(fac, v)

        def newton_cond(state):
            u, n = state
            return (jnp.linalg.norm(g_of(u).ravel(), ord=jnp.inf) >= self.newton_tol) & \
                   (n < self.newton_maxiter)

        def newton_body(state):
            u, n = state
            gval = g_of(u)
            du, _ = jax.scipy.sparse.linalg.cg(
                functools.partial(jac_mv, u), gval, M=precond,
                tol=self.lin_tol, maxiter=self.lin_maxiter)
            return u - du, n + 1

        u, _ = jax.lax.while_loop(newton_cond, newton_body, (u0, jnp.array(0)))
        return u

    def step(self, u_start, t_start, t_stop):
        dt = t_stop - t_start
        if self.method == 'IMEX':
            rhs = u_start + dt * self._nonlin(u_start)
            return self._fft_solve(dt, rhs)
        if self.method == 'CN':
            fac = dt / 2
            rhs = u_start + fac * (self._lap(u_start) + self._nonlin(u_start))
        else:  # IMPL
            fac = dt
            rhs = u_start
        return self._newton_solve(rhs, fac, u_start)

    # ------------------------------------------------------------------
    # diagnostics (reference allen_cahn.py:246-260)
    # ------------------------------------------------------------------

    def exact_radius(self, t):
        return np.sqrt(max(self.radius ** 2 - 2.0 * t, 0))

    def compute_radius(self, u):
        return np.sqrt(np.count_nonzero(np.asarray(u) >= 0.0) / np.pi) * self.dx
