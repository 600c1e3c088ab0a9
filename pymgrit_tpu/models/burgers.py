"""Viscous Burgers equation, 1D and 2D, backward Euler + Newton.

Parity target: reference src/pymgrit/firedrake/burgers_firedrake.py:20-133 —
1D: u_t + u u_x = nu u_xx with IC sin(2 pi x) (P2 FEM + Newton LU there);
2D: velocity field u_t + (u . grad)u = nu Lap(u) with IC (sin(pi x), 0).

Periodic finite differences; the BE update solves the
nonlinear system with Newton.  1D assembles the (small) dense Jacobian and
solves directly (one batched dense solve); 2D uses Newton +
FFT-preconditioned BiCGStab with stencil matvecs.
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

from pymgrit_tpu.core.application import Application


class Burgers1D(Application):
    """1D viscous Burgers, periodic, BE + dense Newton."""

    def __init__(self, nx: int = 128, nu: float = 0.01, x_start: float = 0.0,
                 x_end: float = 1.0, newton_tol: float = 1e-12,
                 newton_maxiter: int = 30, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.nx = nx
        self.nu = nu
        self.x = np.linspace(x_start, x_end, nx, endpoint=False)
        self.dx = self.x[1] - self.x[0]
        self.newton_tol = newton_tol
        self.newton_maxiter = newton_maxiter

        n = nx
        main = np.zeros((n, n))
        idx = np.arange(n)
        # central first derivative and second derivative, periodic
        self.D1 = np.zeros((n, n))
        self.D1[idx, (idx + 1) % n] = 1.0 / (2 * self.dx)
        self.D1[idx, (idx - 1) % n] = -1.0 / (2 * self.dx)
        self.D2 = np.zeros((n, n))
        self.D2[idx, idx] = -2.0 / self.dx ** 2
        self.D2[idx, (idx + 1) % n] = 1.0 / self.dx ** 2
        self.D2[idx, (idx - 1) % n] = 1.0 / self.dx ** 2

        self.vector_template = np.zeros(nx)
        self.vector_t_start = np.sin(2 * np.pi * self.x)

    def step(self, u_start, t_start, t_stop):
        dt = t_stop - t_start
        D1 = jnp.asarray(self.D1)
        D2 = jnp.asarray(self.D2)
        eye = jnp.eye(self.nx)

        def g_of(u):
            return u - u_start + dt * (u * (D1 @ u) - self.nu * (D2 @ u))

        def body(carry):
            u, n = carry
            J = eye + dt * (jnp.diag(D1 @ u) + u[:, None] * D1 - self.nu * D2)
            du = jnp.linalg.solve(J, g_of(u))
            return u - du, n + 1

        def cond(carry):
            u, n = carry
            return (jnp.linalg.norm(g_of(u), ord=jnp.inf) >= self.newton_tol) & \
                   (n < self.newton_maxiter)

        u, _ = jax.lax.while_loop(cond, body, (u_start, jnp.array(0)))
        return u


class Burgers2D(Application):
    """2D viscous Burgers velocity field, periodic, BE + Newton-Krylov."""

    def __init__(self, nx: int = 64, nu: float = 0.02, newton_tol: float = 1e-10,
                 newton_maxiter: int = 30, lin_tol: float = 1e-12,
                 lin_maxiter: int = 200, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.nx = nx
        self.nu = nu
        self.dx = 1.0 / nx
        self.newton_tol = newton_tol
        self.newton_maxiter = newton_maxiter
        self.lin_tol = lin_tol
        self.lin_maxiter = lin_maxiter

        k = np.arange(nx)
        lam1d = (2.0 * np.cos(2.0 * np.pi * k / nx) - 2.0) / self.dx ** 2
        self.lap_eigs = lam1d[:, None] + lam1d[None, :]
        self.space_sharding_axis = 1

        x = np.linspace(0, 1, nx, endpoint=False)
        X, _ = np.meshgrid(x, x, indexing='ij')
        self.vector_template = np.zeros((2, nx, nx))
        self.vector_t_start = np.stack([np.sin(np.pi * X), np.zeros((nx, nx))])

    def _ddx(self, w):
        return (jnp.roll(w, -1, -2) - jnp.roll(w, 1, -2)) / (2 * self.dx)

    def _ddy(self, w):
        return (jnp.roll(w, -1, -1) - jnp.roll(w, 1, -1)) / (2 * self.dx)

    def _lap(self, w):
        return (jnp.roll(w, 1, -2) + jnp.roll(w, -1, -2) +
                jnp.roll(w, 1, -1) + jnp.roll(w, -1, -1) - 4.0 * w) / self.dx ** 2

    def _conv(self, s):
        u, v = s[0], s[1]
        return jnp.stack([u * self._ddx(u) + v * self._ddy(u),
                          u * self._ddx(v) + v * self._ddy(v)])

    def _fft_visc_solve(self, dt, rhs):
        eig = jnp.asarray(self.lap_eigs)
        return jnp.real(jnp.fft.ifft2(jnp.fft.fft2(rhs) / (1.0 - dt * self.nu * eig)))

    def step(self, u_start, t_start, t_stop):
        dt = t_stop - t_start

        def g_of(s):
            return s - u_start + dt * (self._conv(s) - self.nu * self._lap(s))

        def jac_mv(s, w):
            u, v = s[0], s[1]
            wu, wv = w[0], w[1]
            cu = u * self._ddx(wu) + wu * self._ddx(u) + v * self._ddy(wu) + wv * self._ddy(u)
            cv = u * self._ddx(wv) + wu * self._ddx(v) + v * self._ddy(wv) + wv * self._ddy(v)
            return w + dt * (jnp.stack([cu, cv]) - self.nu * self._lap(w))

        def precond(w):
            return self._fft_visc_solve(dt, w)

        def cond(carry):
            s, n = carry
            return (jnp.linalg.norm(g_of(s).ravel(), ord=jnp.inf) >= self.newton_tol) & \
                   (n < self.newton_maxiter)

        def body(carry):
            s, n = carry
            ds, _ = jax.scipy.sparse.linalg.bicgstab(
                functools.partial(jac_mv, s), g_of(s), M=precond,
                tol=self.lin_tol, maxiter=self.lin_maxiter)
            return s - ds, n + 1

        s, _ = jax.lax.while_loop(cond, body, (u_start, jnp.array(0)))
        return s
