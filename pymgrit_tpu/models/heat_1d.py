"""1D heat equation with homogeneous Dirichlet BCs.

Parity target: reference src/pymgrit/heat/heat_1d.py:131-217 — interior-point
grid (heat_1d.py:152-157), 3-point Laplacian, backward-Euler step
``u_i = (I + dt L)^-1 (u_{i-1} + dt b(x, t_i))`` (heat_1d.py:198-217).

Stepper: the sparse LU of the reference becomes a sine-eigenbasis
solve (two dense (nx,nx) matmuls), exact to roundoff and batched
over all C-intervals by vmap.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import jax
import jax.numpy as jnp

from pymgrit_tpu.core.application import Application
from pymgrit_tpu.ops.dirichlet_spectral import sine_eigenbasis, solve_shifted_1d


class Heat1D(Application):
    """u_t - a*u_xx = b(x,t) on [x_start, x_end], homogeneous Dirichlet BCs."""

    def __init__(self, x_start: float, x_end: float, nx: int, a: float,
                 init_cond: Callable = lambda x: x * 0, rhs: Callable = lambda x, t: x * 0,
                 precision: str = None, basis: str = 'physical',
                 *args, **kwargs):
        super().__init__(*args, **kwargs)
        # basis='spectral': state = sine-eigenbasis coefficients; the BE
        # step is elementwise (homogeneous Dirichlet -> no boundary lift)
        # and F-relaxation uses the closed-form interval map (see Heat2D).
        # Histories identical to the physical basis (orthonormal basis).
        if basis not in ('physical', 'spectral'):
            raise Exception("basis must be 'physical' or 'spectral'")
        self._spectral = basis == 'spectral'
        self.x_start = x_start
        self.x_end = x_end
        x = np.linspace(x_start, x_end, nx)
        self.x = x[1:-1]                      # interior points only
        self.nx = nx - 2
        self.dx = self.x[1] - self.x[0]
        self.a = a
        self.rhs = rhs
        self.init_cond = init_cond

        fac = self.a / self.dx ** 2
        self.S, self.lam = sine_eigenbasis(self.nx, fac)
        self._x_j = self.x

        # precision='dd': state and spectral constants become double-double
        # float32 pairs (ops/dd.py); the eigenbasis matmuls dispatch to the
        # Ozaki-scheme matmul (ops/ozaki.py), reaching fp64-class residual
        # floors from float32 arithmetic.  The step body is unchanged.
        self._dd = precision == 'dd'
        self._S_np = self.S                    # numpy copy (f64)
        self.vector_template = np.zeros(self.nx)
        self.vector_t_start = np.asarray(init_cond(self.x), dtype=np.float64)
        # eigen-space affine-step constants, used by BOTH bases (spectral
        # steps with them; physical uses them for the closed-form interval
        # relaxation — same affine map conjugated by the orthogonal basis)
        self._lam_np = self.lam
        self._itbl_cache = {}
        if self._spectral:
            self.vector_t_start = self._S_np @ self.vector_t_start
        if self._dd:
            from pymgrit_tpu.ops import dd
            if not self._spectral:
                self.S = dd.from_f64(self.S)
            self.lam = dd.from_f64(self.lam)
            self.vector_template = dd.from_f64(np.asarray(self.vector_template))
            self.vector_t_start = dd.from_f64(np.asarray(self.vector_t_start))
        # every basis builds the table (the physical basis needs the
        # time-independence check + rhs0 for the closed-form relaxation)
        self._build_rhs_table()
        if self._spectral and not self._dd:
            # the spectral BE step is the elementwise affine map
            # u -> u/(1+dt*lam) + dt*rhs_hat/(1+dt*lam): the solver's
            # parallel-prefix coarsest solve applies exactly
            # (ops/prefix.py, Mgrit(coarsest_prefix=True))
            self.affine_coeffs = self._affine_coeffs_spectral

    def _build_rhs_table(self):
        """Tabulate rhs(x, t) over this level's grid times in ONE batched
        jitted evaluation.  Needed for DD correctness: transcendentals like
        jnp.sin(t) round DIFFERENTLY in vectorized vs scalar XLA contexts
        (observed on CPU: f_relax's vmapped rhs vs forward_solve's scalar
        rhs differ by ~1 ulp), which de-synchronizes the solver phases and
        floors the DD residual at ~|u|*eps_f32.  A single evaluation context
        makes every phase consume bitwise-identical samples."""
        import jax
        if self._dd:
            ts = jnp.asarray(np.asarray(self.t, dtype=np.float32))
            one = jnp.ones(self.nx, dtype=jnp.float32)
        else:
            ts = jnp.asarray(self.t)
            one = jnp.ones(self.nx)
        S = jnp.asarray(self._S_np)

        def sample(tt):
            r = self.rhs(self._x_j, tt) * one
            if self._spectral:
                r = (S @ r).astype(one.dtype)
            return r

        tbl = jax.jit(jax.vmap(sample))(ts)
        if bool(jax.jit(lambda a: jnp.all(a == a[0:1]))(tbl)):
            # time-independent rhs: keep one slice (big-nt memory saver)
            self._rhs_tbl, self._rhs_tbl_times = tbl[:1], ts[:1]
        else:
            self._rhs_tbl, self._rhs_tbl_times = tbl, ts
        self._rhs_tbl0_np = np.asarray(self._rhs_tbl[0], dtype=np.float64)
        # eigen-space rhs0 for the closed-form tables (physical-mode table
        # stores raw samples; the spectral table is already transformed)
        self._rhs_tbl0_hat_np = (self._rhs_tbl0_np if self._spectral
                                 else self._S_np @ self._rhs_tbl0_np)

    def _rhs_at(self, t):
        """b(x, t) evaluated with jnp so traced t works.  User callables must
        be jnp-compatible (numpy ufuncs on jnp arrays trace fine).  In DD
        mode, grid times hit the precomputed table (see _build_rhs_table);
        off-grid times fall back to a runtime evaluation."""
        from pymgrit_tpu.ops.dd import DD
        if not (self._dd or self._spectral):
            return self.rhs(self._x_j, t)
        tv = t.to_float() if isinstance(t, DD) else t
        tv = jnp.asarray(tv, dtype=self._rhs_tbl_times.dtype)
        idx = jnp.clip(jnp.searchsorted(self._rhs_tbl_times, tv),
                       0, self._rhs_tbl.shape[0] - 1)
        idx = jnp.where((idx > 0) &
                        (jnp.abs(self._rhs_tbl_times[idx - 1] - tv) <
                         jnp.abs(self._rhs_tbl_times[idx] - tv)),
                        idx - 1, idx)
        on_grid = self._rhs_tbl_times[idx] == tv
        if self._rhs_tbl.shape[0] == 1:
            on_grid = jnp.asarray(True)   # time-independent rhs
        runtime = self.rhs(self._x_j, tv) * jnp.ones(self.nx,
                                                     dtype=self._rhs_tbl.dtype)
        if self._spectral:
            runtime = (jnp.asarray(self._S_np) @ runtime).astype(self._rhs_tbl.dtype)
        return jnp.where(on_grid, self._rhs_tbl[idx], runtime)

    def _interval_tables(self, dt, m1):
        """Closed-form relaxation tables (see Heat2D._interval_tables):
        BE in eigenspace is u -> A*u + c with A = 1/(1+dt*lam),
        c = dt*rhs0^/(1+dt*lam); cached as numpy per (dt, m-1)."""
        key = (float(dt), int(m1))
        if key in self._itbl_cache:
            return self._itbl_cache[key]
        lam = self._lam_np
        A = 1.0 / (1.0 + dt * lam)
        c = dt * self._rhs_tbl0_hat_np * A
        A_k = np.empty((m1,) + lam.shape)
        G_k = np.empty((m1,) + lam.shape)
        A_k[0], G_k[0] = A, c
        for k in range(1, m1):
            A_k[k] = A_k[k - 1] * A
            G_k[k] = A * G_k[k - 1] + c
        if self._dd:
            def split(a):
                hi = a.astype(np.float32)
                return hi, (a - hi.astype(np.float64)).astype(np.float32)
            out = (split(A_k), split(G_k))
        else:
            out = (A_k, G_k)
        self._itbl_cache[key] = out
        return out

    def relax_interval(self, seed, t_prev, t_curr, only_last=False,
                       interval_major=False):
        """Solver fast-path hook (core/solver.py:_f_relax_uniform): all m-1
        F-values per interval in one batched closed-form expression; with
        only_last, just row m-1 (lazy F-relaxation).  Works in both bases
        (see Heat2D.relax_interval); declines for non-uniform dt,
        time-dependent rhs, or DD-physical."""
        if not self._spectral and self._dd:
            return None
        dts = np.asarray(t_curr, np.float64) - np.asarray(t_prev, np.float64)
        if dts.size == 0:
            return None
        dt = float(dts.flat[0])
        if not np.allclose(dts, dt, rtol=1e-12, atol=0.0):
            return None
        if self._rhs_tbl.shape[0] != 1:
            return None
        m1 = t_prev.shape[0]
        A_t, G_t = self._interval_tables(dt, m1)
        sel = slice(m1 - 1, m1) if only_last else slice(None)
        if self._spectral:
            if self._dd:
                from pymgrit_tpu.ops.dd import _raw
                A_k = _raw(jnp.asarray(A_t[0][sel]), jnp.asarray(A_t[1][sel]))
                G_k = _raw(jnp.asarray(G_t[0][sel]), jnp.asarray(G_t[1][sel]))
                y = A_k[:, None] * seed[None] + G_k[:, None]
                if interval_major:
                    y = jax.tree_util.tree_map(
                        lambda a: jnp.swapaxes(a, 0, 1), y)
                return y
            if interval_major:
                return seed[:, None] * A_t[None, sel] + G_t[None, sel]
            return seed[None] * A_t[sel, None] + G_t[sel, None]
        # physical basis: transform seeds, apply tables, transform back in
        # one batched GEMM (homogeneous Dirichlet: no boundary ring terms)
        S = jnp.asarray(self._S_np).astype(seed.dtype)
        xhat = jnp.einsum('ij,bj->bi', S, seed)              # (J, nx)
        if interval_major:
            yhat = xhat[:, None] * A_t[None, sel] + G_t[None, sel]
            return jnp.einsum('bsj,jk->bsk', yhat, S)
        yhat = xhat[None] * A_t[sel, None] + G_t[sel, None]
        return jnp.einsum('sbj,jk->sbk', yhat, S)

    def to_physical(self, u_hat):
        """Spectral coefficients -> interior values (for output)."""
        from pymgrit_tpu.ops.dd import DD
        if isinstance(u_hat, DD):
            u_hat = u_hat.to_float()
        return jnp.einsum('ij,...j->...i', jnp.asarray(self._S_np), u_hat)

    def _affine_coeffs_spectral(self, t_start, t_stop):
        """(A, c) with step(u, t0, t1) == A*u + c — the contract of the
        parallel-prefix coarsest solve (core/solver.py:_forward_solve)."""
        dt = t_stop - t_start
        denom = 1.0 + dt * self.lam
        return 1.0 / denom, dt * self._rhs_at(t_stop) / denom

    def step(self, u_start, t_start, t_stop):
        dt = t_stop - t_start
        if self._spectral:
            return (u_start + dt * self._rhs_at(t_stop)) / (1.0 + dt * self.lam)
        b = u_start + dt * self._rhs_at(t_stop)
        return solve_shifted_1d(self.S, self.lam, dt, b)

    def step_batched(self, u_tube, t_starts, t_stops):
        """Batched BE step over a (B, nx) tube as two flat (B, nx)@(nx, nx)
        GEMMs (S is symmetric, so S @ b == b @ S) — the solver's relaxation
        sweeps use this instead of vmapped per-sample solves (see
        Heat2D._lx for the rationale)."""
        if self._spectral or self._dd:
            return jax.vmap(self.step, in_axes=(0, 0, 0))(u_tube, t_starts,
                                                          t_stops)
        dt = (t_stops - t_starts)[:, None]
        b = u_tube + dt * jax.vmap(self._rhs_at)(t_stops)
        S = jnp.asarray(self._S_np).astype(b.dtype)
        bh = b @ S
        xh = bh / (1.0 + dt * jnp.asarray(self._lam_np)[None])
        return xh @ S
