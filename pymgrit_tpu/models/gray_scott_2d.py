"""2D Gray-Scott two-species reaction-diffusion.

Parity target: reference src/pymgrit/petsc/gray_scott_2d_petsc.py:26-325 —
species (u, v) on a periodic L x L grid with
    u_t = du*Lap(u) - u v^2 + a(1 - u)
    v_t = dv*Lap(v) + u v^2 - b v
and three steppers: IMEX (diffusion implicit / reaction explicit, KSP-CG in
the reference), IMPL (backward Euler + SNES Newton), EXPL (forward Euler).

Layout: state is a (2, nx, ny) array; the periodic diffusion operator
diagonalizes in Fourier space, so the IMEX solve is an FFT scale iFFT and
the Newton solve uses FFT-preconditioned CG per species block (the
reaction Jacobian is a pointwise 2x2 block handled in the matvec).  The
spatial axes may be sharded over the mesh 'space' axis.
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

from pymgrit_tpu.core.application import Application


class GrayScott2D(Application):
    """Gray-Scott reaction-diffusion with IMEX / IMPL / EXPL steppers."""

    def __init__(self, nx: int = 64, L: float = 2.0, du: float = 8e-5, dv: float = 4e-5,
                 a: float = 0.024, b: float = 0.06 + 0.024, method: str = 'IMEX',
                 nlsol_tol: float = 1e-10, nlsol_maxiter: int = 50,
                 lsol_tol: float = 1e-12, lsol_maxiter: int = 200, *args, **kwargs):
        super().__init__(*args, **kwargs)
        if method not in ('IMEX', 'IMPL', 'EXPL'):
            raise Exception("Unknown method. Choose IMPL (implicit) or IMEX (implicit-explicit)")
        self.method = method
        self.nx = nx
        self.ny = nx
        self.L = L
        self.dx = L / nx
        self.du = du
        self.dv = dv
        self.a = a
        self.b = b
        self.nlsol_tol = nlsol_tol
        self.nlsol_maxiter = nlsol_maxiter
        self.lsol_tol = lsol_tol
        self.lsol_maxiter = lsol_maxiter

        k = np.arange(nx)
        lam1d = (2.0 * np.cos(2.0 * np.pi * k / nx) - 2.0) / self.dx ** 2
        self.lap_eigs = lam1d[:, None] + lam1d[None, :]

        # spatial state axes may shard over 'space' (axis 1 = x)
        self.space_sharding_axis = 1

        self.vector_template = np.zeros((2, nx, nx))
        x = np.linspace(-L / 2, L / 2, nx, endpoint=False)
        X, Y = np.meshgrid(x, x, indexing='ij')
        # classic Gray-Scott seed: a perturbed square in the center
        u0 = 1.0 - 0.5 * np.power(np.sin(np.pi * (X + L / 2) / L), 100) * \
            np.power(np.sin(np.pi * (Y + L / 2) / L), 100)
        v0 = 0.25 * np.power(np.sin(np.pi * (X + L / 2) / L), 100) * \
            np.power(np.sin(np.pi * (Y + L / 2) / L), 100)
        self.vector_t_start = np.stack([u0, v0])

    # ------------------------------------------------------------------

    def _lap(self, w):
        return (jnp.roll(w, 1, -2) + jnp.roll(w, -1, -2) +
                jnp.roll(w, 1, -1) + jnp.roll(w, -1, -1) - 4.0 * w) / self.dx ** 2

    def _reaction(self, s):
        u, v = s[0], s[1]
        uv2 = u * v ** 2
        return jnp.stack([-uv2 + self.a * (1 - u), uv2 - self.b * v])

    def _diffuse(self, s):
        return jnp.stack([self.du * self._lap(s[0]), self.dv * self._lap(s[1])])

    def _fft_solve_diffusion(self, dt, rhs):
        """(I - dt*diag(du,dv)*Lap)^-1 rhs via per-species FFT."""
        eig = jnp.asarray(self.lap_eigs)
        uh = jnp.fft.fft2(rhs[0])
        vh = jnp.fft.fft2(rhs[1])
        un = jnp.real(jnp.fft.ifft2(uh / (1.0 - dt * self.du * eig)))
        vn = jnp.real(jnp.fft.ifft2(vh / (1.0 - dt * self.dv * eig)))
        return jnp.stack([un, vn])

    def step(self, u_start, t_start, t_stop):
        dt = t_stop - t_start
        if self.method == 'EXPL':
            return u_start + dt * (self._diffuse(u_start) + self._reaction(u_start))
        if self.method == 'IMEX':
            rhs = u_start + dt * self._reaction(u_start)
            return self._fft_solve_diffusion(dt, rhs)
        # IMPL: backward Euler, Newton with FFT-preconditioned CG
        return self._newton(u_start, dt)

    def _newton(self, s0, dt):
        a, b = self.a, self.b

        def g_of(s):
            return s - dt * (self._diffuse(s) + self._reaction(s)) - s0

        def jac_mv(s, w):
            u, v = s[0], s[1]
            wu, wv = w[0], w[1]
            # reaction Jacobian: [[-v^2 - a, -2uv], [v^2, 2uv - b]]
            ru = (-v ** 2 - a) * wu + (-2 * u * v) * wv
            rv = (v ** 2) * wu + (2 * u * v - b) * wv
            return w - dt * (self._diffuse(w) + jnp.stack([ru, rv]))

        def precond(w):
            return self._fft_solve_diffusion(dt, w)

        def cond(carry):
            s, n = carry
            return (jnp.linalg.norm(g_of(s).ravel(), ord=jnp.inf) >= self.nlsol_tol) & \
                   (n < self.nlsol_maxiter)

        def body(carry):
            s, n = carry
            gval = g_of(s)
            ds, _ = jax.scipy.sparse.linalg.bicgstab(
                functools.partial(jac_mv, s), gval, M=precond,
                tol=self.lsol_tol, maxiter=self.lsol_maxiter)
            return s - ds, n + 1

        s, _ = jax.lax.while_loop(cond, body, (s0, jnp.array(0)))
        return s
