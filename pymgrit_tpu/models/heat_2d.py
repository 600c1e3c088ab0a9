"""2D heat equation with Dirichlet BCs and BE/FE/CN integrators.

Parity target: reference src/pymgrit/heat/heat_2d.py:139-366 — state of shape
(nx, ny) *including* the boundary ring, 5-point Laplacian whose boundary rows
are zeroed (heat_2d.py:250-287), theta-method with theta in {0, 1/2, 1}
(heat_2d.py:194-202), constant-or-callable Dirichlet data per edge
(heat_2d.py:204-231), rhs assembly (compute_rhs, heat_2d.py:289-320).

Stepper: the implicit solve on the interior block is a two-sided
sine-eigenbasis solve — four dense matmuls instead of a sparse LU —
with a boundary lift for the Dirichlet coupling.  Batched over C-points via
vmap, this is the framework's flagship benchmark problem (BASELINE.json:
heat_2d nt=4097).
"""

from __future__ import annotations

from typing import Callable, Union

import numpy as np
import jax
import jax.numpy as jnp

from pymgrit_tpu.core.application import Application
from pymgrit_tpu.ops.dirichlet_spectral import sine_eigenbasis


class Heat2D(Application):
    """u_t - a*(u_xx + u_yy) = b(x,y,t) with Dirichlet BCs."""

    def __init__(self, x_start: float, x_end: float, y_start: float, y_end: float,
                 nx: int, ny: int, a: float,
                 rhs: Callable = lambda x, y, t: 0 * x * y,
                 init_cond: Callable = lambda x, y: x * y * 0, method: str = 'BE',
                 bc_left: Union[int, float, Callable] = 0,
                 bc_right: Union[int, float, Callable] = 0,
                 bc_bottom: Union[int, float, Callable] = 0,
                 bc_top: Union[int, float, Callable] = 0,
                 precision: str = None, basis: str = 'physical',
                 *args, **kwargs):
        super().__init__(*args, **kwargs)
        # basis='spectral': the state IS the sine-eigenbasis coefficient
        # array of the interior — every step becomes a handful of
        # *elementwise* ops (no matmuls in the hot loop at all); see
        # the derivation at _step_spectral.  Residual histories are
        # identical to the physical basis because the basis is orthonormal
        # and all of MGRIT's algebra is orthogonally invariant.
        if basis not in ('physical', 'spectral'):
            raise Exception("basis must be 'physical' or 'spectral'")
        self._spectral = basis == 'spectral'
        if self._spectral and method == 'FE':
            # the reference's FE quirk accumulates bc data onto the carried
            # boundary ring (heat_2d.py:333-343) — there is no boundary ring
            # in coefficient space to carry it on
            raise Exception("basis='spectral' supports BE/CN (theta > 0) only")
        # precision='dd': double-double float32 state + Ozaki-scheme spectral
        # solves (ops/dd.py, ops/ozaki.py) — fp64-class residual floors
        # from float32 arithmetic.
        self._dd = precision == 'dd'
        self.x = np.linspace(x_start, x_end, nx)
        self.y = np.linspace(y_start, y_end, ny)
        self.x_2d = self.x[:, np.newaxis]
        self.y_2d = self.y[np.newaxis, :]
        self.nx = nx
        self.ny = ny
        self.dx = self.x[1] - self.x[0]
        self.dy = self.y[1] - self.y[0]
        self.a = a
        self.rhs = rhs

        if method == 'BE':
            self.theta = 1.0
        elif method == 'FE':
            self.theta = 0.0
        elif method == 'CN':
            self.theta = 0.5
        else:
            raise Exception("Unknown method. Choose BE (Backward Euler), FE (Forward Euler) or CN (Crank-Nicolson")

        def _bc_arr(bc, coords, name):
            if isinstance(bc, (float, int)):
                return np.full(len(coords), float(bc))
            if callable(bc):
                return np.asarray(bc(coords), dtype=np.float64) * np.ones(len(coords))
            raise Exception("Choose float, int or function for boundary condition " + name)

        # Edge conventions follow the reference exactly (heat_2d.py:243-248):
        # values[:, 0]=left(x), values[:, -1]=right(x), values[-1, :]=bottom(y),
        # values[0, :]=top(y).
        self.bc_left_arr = _bc_arr(bc_left, self.x, 'bc_left')
        self.bc_right_arr = _bc_arr(bc_right, self.x, 'bc_right')
        self.bc_bottom_arr = _bc_arr(bc_bottom, self.y, 'bc_bottom')
        self.bc_top_arr = _bc_arr(bc_top, self.y, 'bc_top')

        self.fx = a / self.dx ** 2
        self.fy = a / self.dy ** 2
        # Interior eigenbasis: axis 0 (x) couples with fx, axis 1 (y) with fy.
        self.Sx, self.lamx = sine_eigenbasis(nx - 2, self.fx)
        self.Sy, self.lamy = sine_eigenbasis(ny - 2, self.fy)
        self._Sx_np, self._Sy_np = self.Sx, self.Sy   # numpy copies (f64)

        self._xi = self.x_2d[1:-1]       # (nx-2, 1)
        self._yi = self.y_2d[:, 1:-1]    # (1, ny-2)

        # State axis 0 (x) may be sharded over the mesh 'space' axis.
        self.space_sharding_axis = 0

        self.vector_template = np.zeros((nx, ny))
        init = np.asarray(init_cond(self.x_2d, self.y_2d), dtype=np.float64) * np.ones((nx, ny))
        init[:, 0] = self.bc_left_arr
        init[:, -1] = self.bc_right_arr
        init[-1, :] = np.asarray(self.bc_bottom_arr)
        init[0, :] = np.asarray(self.bc_top_arr)
        self.vector_t_start = init

        # Eigen-space affine-step constants.  Derivation (theta-method on
        # the interior, boundary ring = the constant-in-time Dirichlet data,
        # which every solver state carries at the boundary — FAS
        # residuals/g have zero boundary):
        #   (I + th*dt*L_int) u' = u - th'*dt*(L_int u + E)
        #                          + dt*rhs_mix + th*dt*LIFT
        # with E = -LIFT (the bc coupling of the stencil), th' = theta
        # for CN (explicit half), absent for BE.  Diagonalizing by the
        # orthonormal sine basis makes every term elementwise:
        #   u'^ = (u^ (1 - th'*dt*Lam) + (th+th')*dt*lift^ + dt*rhs^ )
        #         / (1 + th*dt*Lam)
        # Built for BOTH bases: the spectral state steps with it directly;
        # the physical basis uses it for the closed-form interval
        # relaxation (relax_interval) since the physical step is the SAME
        # affine map conjugated by the orthogonal basis.
        lift = np.zeros((nx - 2, ny - 2))
        lift[:, 0] += self.fy * self.bc_left_arr[1:-1]
        lift[:, -1] += self.fy * self.bc_right_arr[1:-1]
        lift[0, :] += self.fx * self.bc_top_arr[1:-1]
        lift[-1, :] += self.fx * self.bc_bottom_arr[1:-1]
        self._lift_np = lift
        self._lift_hat_np = self._Sx_np @ lift @ self._Sy_np
        self._Lam_np = self.lamx[:, None] + self.lamy[None, :]
        self._itbl_cache = {}
        if self._spectral:
            self._lift_hat = self._lift_hat_np
            self._Lam = self._Lam_np
            self.vector_template = np.zeros((nx - 2, ny - 2))
            self.vector_t_start = self._Sx_np @ init[1:-1, 1:-1] @ self._Sy_np

        if self._dd:
            from pymgrit_tpu.ops import dd
            if self._spectral:
                self._lift_hat = dd.from_f64(self._lift_hat)
                self._Lam = dd.from_f64(self._Lam)
            else:
                self.Sx = dd.from_f64(self.Sx)
                self.Sy = dd.from_f64(self.Sy)
                self.lamx = dd.from_f64(self.lamx)
                self.lamy = dd.from_f64(self.lamy)
            self.vector_template = dd.from_f64(np.asarray(self.vector_template))
            self.vector_t_start = dd.from_f64(np.asarray(self.vector_t_start))
        if self._dd or self._spectral or self.theta > 0.0:
            # physical BE/CN builds the table too: the closed-form interval
            # relaxation needs the time-independence check + rhs0 samples
            self._build_rhs_table()
        if self._spectral and not self._dd:
            # the spectral theta-step is the elementwise affine map
            # u -> A*u + c (see _step_spectral / _interval_tables), so the
            # solver's parallel-prefix coarsest solve applies exactly
            # (ops/prefix.py, Mgrit(coarsest_prefix=True)); DD keeps the
            # sequential scan (the prefix combine is plain-float only)
            self.affine_coeffs = self._affine_coeffs_spectral

    # ------------------------------------------------------------------
    # Runtime-operand channel (core/application.py): hand the big tables
    # to the solver as device arrays so jitted programs receive them as
    # arguments instead of baked MLIR constants (the round-3 257^2
    # blocker: ~16 MB of closed-form tables x ~6 traced relaxation sites).
    # ------------------------------------------------------------------

    @staticmethod
    def _itbl_key_str(dt: float, m1: int) -> str:
        return f"{float(dt).hex()}:{int(m1)}"

    def _rtp(self, name, fallback):
        """Bound runtime param `name`, else fallback() (a host constant)."""
        rt = self._rt
        if rt is not None and name in rt:
            return rt[name]
        return fallback()

    def prepare_runtime(self, level_info) -> None:
        """Pre-build the closed-form interval tables for this level's
        uniform block structure (both m-1 rows — F-relaxation — and m rows
        — the condensed C-step) so runtime_params can export them.  Only
        level 0 consumes the hook (solver _f_relax_uniform / condensed
        paths), so coarse levels skip the build."""
        if getattr(level_info, "lvl", 0) != 0:
            return
        if self._dd and not self._spectral:
            return                      # hook declines DD-physical anyway
        if not self._spectral and self.theta == 0.0:
            return                      # FE: hook declines
        if not getattr(level_info, "uniform", False) or level_info.m <= 1:
            return
        t = np.asarray(level_info.t, dtype=np.float64)
        if t.size < 2:
            return
        dts = np.diff(t)
        if not np.allclose(dts, dts[0], rtol=1e-12, atol=0.0):
            return
        if getattr(self, "_rhs_tbl", None) is None or self._rhs_tbl.shape[0] != 1:
            return                      # time-dependent rhs: hook declines
        dt = float(dts.flat[0])
        for m1 in (level_info.m - 1, level_info.m):
            if m1 >= 1:
                self._interval_tables(dt, m1)

    def runtime_params(self):
        prm = {}
        if not self._dd:
            prm["Sx"] = jnp.asarray(self._Sx_np)
            prm["Sy"] = jnp.asarray(self._Sy_np)
            prm["Lam"] = jnp.asarray(self._Lam_np)
            prm["lift"] = jnp.asarray(self._lift_np)
            prm["lift_hat"] = jnp.asarray(self._lift_hat_np)
        if getattr(self, "_rhs_tbl", None) is not None:
            prm["rhs_tbl"] = self._rhs_tbl
            prm["rhs_tbl_times"] = self._rhs_tbl_times
        if self._itbl_cache:
            prm["itbl"] = {
                self._itbl_key_str(*k): jax.tree_util.tree_map(jnp.asarray, v)
                for k, v in self._itbl_cache.items()}
        return prm or None

    def _zeros_like(self, u):
        if self._dd:
            from pymgrit_tpu.ops import dd
            return dd.zeros_like(u)
        return jnp.zeros_like(u)

    def _build_rhs_table(self):
        """Tabulate rhs over this level's grid times in ONE batched jitted
        evaluation.  DD correctness requirement: transcendentals in user rhs
        callables (jnp.sin(t), ...) round differently in vectorized vs
        scalar XLA contexts, de-synchronizing the solver phases and flooring
        the DD residual at ~|u|*eps_f32; a single evaluation context makes
        every phase consume bitwise-identical samples.  In spectral-basis
        mode the samples are stored pre-transformed (rhs^ = Sx rhs Sy), so
        the hot loop never touches a matmul."""
        import jax
        shp = (self.nx - 2, self.ny - 2)
        if self._dd:
            ts = jnp.asarray(np.asarray(self.t, dtype=np.float32))
            one = jnp.ones(shp, dtype=jnp.float32)
        else:
            ts = jnp.asarray(self.t)
            one = jnp.ones(shp)
        Sx = jnp.asarray(self._Sx_np)
        Sy = jnp.asarray(self._Sy_np)

        def sample(tt):
            r = self.rhs(x=self._xi, y=self._yi, t=tt) * one
            if self._spectral:
                r = (Sx @ r @ Sy).astype(one.dtype)
            return r

        # Chunked evaluation: never materialize the full (nt, nxi, nyi)
        # table unless the rhs really is time-dependent (at the TOMS bench
        # scale the one-shot table is multi-GB transient memory).  The
        # common time-independent case touches one chunk and keeps 1 slice.
        vsample = jax.jit(jax.vmap(sample))
        vsame = jax.jit(lambda a, s0: jnp.all(a == s0[None]))
        chunk = 1024
        s0 = None
        chunks, time_dep = [], False
        for lo in range(0, ts.shape[0], chunk):
            part = vsample(ts[lo:lo + chunk])
            if s0 is None:
                s0 = part[0]
            if not time_dep and not bool(vsame(part, s0)):
                time_dep = True
            if not (self._dd or self._spectral):
                # physical basis consumes only the time-independence flag
                # and slice 0 (_rhs_at evaluates the callable directly)
                if time_dep:
                    break
                continue
            chunks.append(part)
        if time_dep and not (self._dd or self._spectral):
            self._rhs_tbl = jnp.stack([s0, s0])   # shape[0] != 1 => declines
            self._rhs_tbl_times = ts[:2]
        elif time_dep:
            self._rhs_tbl, self._rhs_tbl_times = jnp.concatenate(chunks), ts
        else:
            self._rhs_tbl, self._rhs_tbl_times = s0[None], ts[:1]
        # host copy of the first slice for the closed-form interval tables
        # (must be numpy: _interval_tables runs inside jit traces, where
        # indexing even a concrete device array yields a tracer)
        self._rhs_tbl0_np = np.asarray(self._rhs_tbl[0], dtype=np.float64)
        # eigen-space rhs0 for the closed-form interval tables: the
        # spectral table already stores transformed samples; the physical
        # table stores raw samples and transforms here
        self._rhs_tbl0_hat_np = (self._rhs_tbl0_np if self._spectral
                                 else self._Sx_np @ self._rhs_tbl0_np @ self._Sy_np)

    def _rhs_at(self, t):
        """rhs(x, y, t) for a (possibly DD) time value.  In DD or spectral
        mode, grid times hit the precomputed table (see _build_rhs_table);
        off-grid times fall back to a runtime evaluation (transformed in
        spectral mode)."""
        from pymgrit_tpu.ops.dd import DD
        if not (self._dd or self._spectral):
            return self.rhs(x=self._xi, y=self._yi, t=t)
        tbl = self._rtp("rhs_tbl", lambda: self._rhs_tbl)
        times = self._rtp("rhs_tbl_times", lambda: self._rhs_tbl_times)
        tv = t.to_float() if isinstance(t, DD) else t
        tv = jnp.asarray(tv, dtype=times.dtype)
        idx = jnp.clip(jnp.searchsorted(times, tv), 0, tbl.shape[0] - 1)
        idx = jnp.where((idx > 0) &
                        (jnp.abs(times[idx - 1] - tv) <
                         jnp.abs(times[idx] - tv)),
                        idx - 1, idx)
        on_grid = times[idx] == tv
        if tbl.shape[0] == 1:
            on_grid = jnp.asarray(True)
        runtime = self.rhs(x=self._xi, y=self._yi, t=tv) * \
            jnp.ones((self.nx - 2, self.ny - 2), dtype=tbl.dtype)
        if self._spectral:
            runtime = (self._rtp("Sx", lambda: jnp.asarray(self._Sx_np)) @ runtime @
                       self._rtp("Sy", lambda: jnp.asarray(self._Sy_np))).astype(tbl.dtype)
        return jnp.where(on_grid, tbl[idx], runtime)

    def _apply_L(self, u):
        """Apply the reference's zeroed-boundary-row 5-point operator
        (heat_2d.py:250-287): (L u) is zero on the boundary ring and the
        standard stencil on interior rows (using boundary neighbors)."""
        fx, fy = self.fx, self.fy
        interior = (2 * (fx + fy) * u[1:-1, 1:-1]
                    - fy * u[1:-1, :-2] - fy * u[1:-1, 2:]
                    - fx * u[:-2, 1:-1] - fx * u[2:, 1:-1])
        return self._zeros_like(u).at[1:-1, 1:-1].set(interior)

    def _set_bc(self, u):
        """Overwrite the boundary ring with the Dirichlet data."""
        u = u.at[:, 0].set(self.bc_left_arr)
        u = u.at[:, -1].set(self.bc_right_arr)
        u = u.at[-1, :].set(self.bc_bottom_arr)
        u = u.at[0, :].set(self.bc_top_arr)
        return u

    def _solve_interior(self, shift, b):
        """(I + shift*L_interior) x = b_int with boundary lift baked into b."""
        bh = self.Sx @ b @ self.Sy
        denom = 1.0 + shift * (self.lamx[:, None] + self.lamy[None, :])
        return self.Sx @ (bh / denom) @ self.Sy

    # -- flat batched transforms: a vmap of (n,n)@(n,n) matmuls lowers to
    # B small batched GEMMs; tensordot reshapes the batch into ONE
    # (n, B*n) GEMM with the same values.  Whether the flat form still pays
    # on a given device is a measurement question. --

    def _lx(self, S, b):
        """S @ b over axis -2 of a (..., n, m) batch, as one flat GEMM."""
        out = jnp.tensordot(S, b, axes=((1,), (b.ndim - 2,)))
        return jnp.moveaxis(out, 0, -2)

    def _rx(self, b, S):
        """b @ S over axis -1 (already flat: (B*n, n) @ (n, n))."""
        return jnp.tensordot(b, S, axes=((b.ndim - 1,), (0,)))

    def _solve_interior_batched(self, shift, b):
        """Batched (I + shift*L_int) x = b for b (B, nxi, nyi); shift
        broadcastable (B, 1, 1).  Same algebra as _solve_interior."""
        Sx = self._rtp("Sx", lambda: jnp.asarray(self._Sx_np)).astype(b.dtype)
        Sy = self._rtp("Sy", lambda: jnp.asarray(self._Sy_np)).astype(b.dtype)
        bh = self._rx(self._lx(Sx, b), Sy)
        denom = 1.0 + shift * self._rtp(
            "Lam", lambda: jnp.asarray(self._Lam_np))[None]
        return self._rx(self._lx(Sx, bh / denom), Sy)

    def step_batched(self, u_tube, t_starts, t_stops):
        """Batched theta-step over a (B, nx, ny) tube — the solver's
        relaxation sweeps call this instead of vmap(step) (core
        solver.py:_vstep).  Physical basis only; spectral steps are already
        elementwise and DD dispatches through the scalar path."""
        if self._spectral or self._dd or self.theta == 0.0:
            return jax.vmap(self.step, in_axes=(0, 0, 0))(u_tube, t_starts,
                                                          t_stops)
        dt = (t_stops - t_starts)[:, None, None]
        shift = self.theta * dt
        # rhs samples via vmap (keeps arbitrary user callables working)
        rhs_stop = jax.vmap(self._rhs_at)(t_stops)
        if self.theta == 1.0:
            b_int = u_tube[:, 1:-1, 1:-1] + dt * rhs_stop
        else:
            rhs_start = jax.vmap(self._rhs_at)(t_starts)
            Lu = jax.vmap(self._apply_L)(u_tube)
            b_full = u_tube - shift * Lu
            b_int = b_full[:, 1:-1, 1:-1] + dt * (
                self.theta * rhs_stop + (1 - self.theta) * rhs_start)
        # boundary lift: the ring of b is the Dirichlet data (set_bc)
        b_int = b_int.at[:, :, 0].add(
            shift[:, :, 0] * self.fy * self.bc_left_arr[1:-1])
        b_int = b_int.at[:, :, -1].add(
            shift[:, :, 0] * self.fy * self.bc_right_arr[1:-1])
        b_int = b_int.at[:, 0, :].add(
            shift[:, :, 0] * self.fx * self.bc_top_arr[1:-1])
        b_int = b_int.at[:, -1, :].add(
            shift[:, :, 0] * self.fx * self.bc_bottom_arr[1:-1])
        new_int = self._solve_interior_batched(shift, b_int)
        out = jnp.zeros_like(u_tube).at[:, 1:-1, 1:-1].set(new_int)
        out = out.at[:, :, 0].set(jnp.asarray(self.bc_left_arr))
        out = out.at[:, :, -1].set(jnp.asarray(self.bc_right_arr))
        out = out.at[:, -1, :].set(jnp.asarray(self.bc_bottom_arr))
        out = out.at[:, 0, :].set(jnp.asarray(self.bc_top_arr))
        return out

    def _step_spectral(self, u, t_start, t_stop):
        """Theta-method step entirely in eigen-coefficient space: a few
        elementwise ops, zero matmuls (see constructor derivation).
        Operator-polymorphic: works for f32/f64 arrays and DD pairs."""
        dt = t_stop - t_start
        shift = dt * self.theta
        if self._dd:
            lift_hat, Lam = self._lift_hat, self._Lam   # DD pairs, not routed
        else:
            lift_hat = self._rtp("lift_hat", lambda: self._lift_hat)
            Lam = self._rtp("Lam", lambda: self._Lam)
        if self.theta == 1.0:
            b = u + dt * self._rhs_at(t_stop) + shift * lift_hat
        else:
            b = (u - shift * (u * Lam)) \
                + (shift * 2.0) * lift_hat \
                + dt * (self.theta * self._rhs_at(t_stop)
                        + (1 - self.theta) * self._rhs_at(t_start))
        return b / (1.0 + shift * Lam)

    def _affine_coeffs_spectral(self, t_start, t_stop):
        """(A, c) with _step_spectral(u, t0, t1) == A*u + c — the contract
        of the parallel-prefix coarsest solve (core/solver.py:
        _forward_solve).  Same algebra as _interval_tables, but traced with
        runtime time operands so time-dependent rhs works."""
        dt = t_stop - t_start
        shift = dt * self.theta
        lift_hat = self._rtp("lift_hat", lambda: self._lift_hat)
        Lam = self._rtp("Lam", lambda: self._Lam)
        denom = 1.0 + shift * Lam
        if self.theta == 1.0:
            return 1.0 / denom, \
                (dt * self._rhs_at(t_stop) + shift * lift_hat) / denom
        A = (1.0 - shift * Lam) / denom
        c = ((shift * 2.0) * lift_hat
             + dt * (self.theta * self._rhs_at(t_stop)
                     + (1 - self.theta) * self._rhs_at(t_start))) / denom
        return A, c

    def _interval_tables(self, dt, m1):
        """Per-level closed-form relaxation tables: the spectral theta-step
        is the affine elementwise map u -> A*u + c, so the k-th F-point of
        an interval is A^k * seed + G_k with G_k = A*G_{k-1} + c.  Built in
        f64 on the host (the geometric recurrence is cancellation-prone in
        f32 for small dt*Lam), cached per (dt, m-1)."""
        key = (float(dt), int(m1))
        if key in self._itbl_cache:
            return self._itbl_cache[key]
        th = self.theta
        thp = 0.0 if th == 1.0 else th           # explicit half (CN)
        Lam = self._Lam_np
        denom = 1.0 + th * dt * Lam
        A = (1.0 - thp * dt * Lam) / denom
        rhs0 = self._rhs_tbl0_hat_np
        c = ((th + thp) * dt * self._lift_hat_np + dt * rhs0) / denom
        A_k = np.empty((m1,) + Lam.shape)
        G_k = np.empty((m1,) + Lam.shape)
        A_k[0], G_k[0] = A, c
        for k in range(1, m1):
            A_k[k] = A_k[k - 1] * A
            G_k[k] = A * G_k[k - 1] + c
        # Cache NUMPY only: this runs inside jit traces, where any jnp
        # construction returns a tracer — caching one across traces is a
        # leak.  numpy constants fold in at each trace harmlessly.
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
        F-values of every interval in ONE batched closed-form expression —
        no sequential scan.  Works in BOTH bases (the physical BE/CN step
        is the same elementwise affine map conjugated by the orthogonal
        sine basis): spectral applies the tables directly; physical
        transforms the J seeds (2 GEMMs), applies A^k x^ + G_k, and
        transforms all (m-1, J) results back in one batched GEMM pair —
        the sequential scan of small matmuls becomes two large matmuls.
        only_last=True returns just row m-1 (shape (1, J, ...)) — the lazy
        F-relaxation mode: during iterations only the last F-value of each
        interval is ever consumed, so the solver skips materializing the
        rest (solver.py:_f_relax_uniform).  interval_major=True returns
        (J, rows, ...) instead of (rows, J, ...) — the tube write-back
        order — so callers skip a full-size moveaxis copy (round-4; ~2 GB
        at the TOMS scale).  Declines (None) for non-uniform dt,
        time-dependent rhs, FE, or DD-physical."""
        if not self._spectral and (self._dd or self.theta == 0.0):
            return None
        dts = np.asarray(t_curr, np.float64) - np.asarray(t_prev, np.float64)
        if dts.size == 0:
            return None
        dt = float(dts.flat[0])
        if not np.allclose(dts, dt, rtol=1e-12, atol=0.0):
            return None
        if self._rhs_tbl.shape[0] != 1:
            return None                           # time-dependent rhs
        m1 = t_prev.shape[0]
        rt = self._rt
        tbls = None
        if rt is not None and "itbl" in rt:
            tbls = rt["itbl"].get(self._itbl_key_str(dt, m1))
        A_t, G_t = tbls if tbls is not None else self._interval_tables(dt, m1)
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
            # seed first so the traced operand drives the dtype/dispatch
            return seed[None] * A_t[sel, None] + G_t[sel, None]

        # ---- physical basis ----
        Sx = self._rtp("Sx", lambda: jnp.asarray(self._Sx_np)).astype(seed.dtype)
        Sy = self._rtp("Sy", lambda: jnp.asarray(self._Sy_np)).astype(seed.dtype)
        x_int = seed[:, 1:-1, 1:-1]                          # (J, nxi, nyi)
        xhat = self._rx(self._lx(Sx, x_int), Sy)
        delta_c, A_km1 = None, None
        if self.theta < 1.0:
            # CN's explicit half reads the seed's CARRIED boundary ring;
            # the tables assume ring == bc data.  First-step correction
            # (exact): delta_c = th*dt*(lift(ring_seed) - lift(bc))^/denom,
            # propagated as A^{k-1} * delta_c.
            nxi, nyi = self.nx - 2, self.ny - 2
            dl = jnp.zeros((seed.shape[0], nxi, nyi), seed.dtype)
            dl = dl.at[:, :, 0].add(self.fy * seed[:, 1:-1, 0])
            dl = dl.at[:, :, -1].add(self.fy * seed[:, 1:-1, -1])
            dl = dl.at[:, 0, :].add(self.fx * seed[:, 0, 1:-1])
            dl = dl.at[:, -1, :].add(self.fx * seed[:, -1, 1:-1])
            dl = dl - self._rtp(
                "lift", lambda: jnp.asarray(self._lift_np)).astype(seed.dtype)
            dhat = self._rx(self._lx(Sx, dl), Sy)
            shift = self.theta * dt
            denom = 1.0 + shift * self._rtp(
                "Lam", lambda: jnp.asarray(self._Lam_np))
            delta_c = dhat * (shift / denom)
            A_km1 = jnp.concatenate([jnp.ones_like(A_t[:1]), A_t[:-1]])
        A_rows = A_t[sel]
        G_rows = G_t[sel]
        A_km1_rows = A_km1[sel] if A_km1 is not None else None
        n_rows = A_rows.shape[0]

        def ring(out):
            out = out.at[:, :, :, 0].set(jnp.asarray(self.bc_left_arr))
            out = out.at[:, :, :, -1].set(jnp.asarray(self.bc_right_arr))
            out = out.at[:, :, -1, :].set(jnp.asarray(self.bc_bottom_arr))
            out = out.at[:, :, 0, :].set(jnp.asarray(self.bc_top_arr))
            return out

        def back(lo, hi):
            """F-values for selected table rows lo:hi — (hi-lo, J, nx, ny)."""
            yhat = xhat[None] * A_rows[lo:hi, None] + G_rows[lo:hi, None]
            if delta_c is not None:
                yhat = yhat + delta_c[None] * A_km1_rows[lo:hi, None]
            y_int = self._rx(self._lx(Sx, yhat), Sy)
            out = jnp.zeros(y_int.shape[:2] + (self.nx, self.ny), y_int.dtype)
            return ring(out.at[:, :, 1:-1, 1:-1].set(y_int))

        def back_im(lo, hi):
            """Same values, interval-major: seeds lo:hi — (hi-lo, rows, nx, ny)."""
            yhat = xhat[lo:hi, None] * A_rows[None] + G_rows[None]
            if delta_c is not None:
                yhat = yhat + delta_c[lo:hi, None] * A_km1_rows[None]
            y_int = self._rx(self._lx(Sx, yhat), Sy)
            out = jnp.zeros(y_int.shape[:2] + (self.nx, self.ny), y_int.dtype)
            return ring(out.at[:, :, 1:-1, 1:-1].set(y_int))

        # chunk the (rows, J, nxi, nyi) workspace to 2^27 elements so the
        # TOMS 257^2 scale fits device memory (the full fine tube alone is
        # ~4.3 GB in f32 there)
        J = seed.shape[0]
        elems = n_rows * J * (self.nx - 2) * (self.ny - 2)
        n_chunks = max(1, -(-elems // (128 * 1024 * 1024)))
        n_outer = J if interval_major else n_rows
        fn = back_im if interval_major else back
        if n_chunks == 1:
            return fn(0, n_outer)
        step_sz = -(-n_outer // min(n_chunks, n_outer))
        parts = [fn(lo, min(lo + step_sz, n_outer))
                 for lo in range(0, n_outer, step_sz)]
        return jnp.concatenate(parts, axis=0)

    def to_physical(self, u_hat):
        """Spectral coefficients -> full (..., nx, ny) field with the
        Dirichlet boundary ring (for output/plotting)."""
        from pymgrit_tpu.ops.dd import DD
        if isinstance(u_hat, DD):
            u_hat = u_hat.to_float()
        interior = jnp.einsum('ij,...jk,kl->...il', jnp.asarray(self._Sx_np),
                              u_hat, jnp.asarray(self._Sy_np))
        out = jnp.zeros(u_hat.shape[:-2] + (self.nx, self.ny),
                        dtype=interior.dtype)
        out = out.at[..., 1:-1, 1:-1].set(interior)
        out = out.at[..., :, 0].set(jnp.asarray(self.bc_left_arr))
        out = out.at[..., :, -1].set(jnp.asarray(self.bc_right_arr))
        out = out.at[..., -1, :].set(jnp.asarray(self.bc_bottom_arr))
        out = out.at[..., 0, :].set(jnp.asarray(self.bc_top_arr))
        return out

    def step(self, u_start, t_start, t_stop):
        if self._spectral:
            return self._step_spectral(u_start, t_start, t_stop)
        dt = t_stop - t_start
        if self.theta == 0.0:
            # FE (heat_2d.py:330-346).  Note the reference *adds* the BC data
            # onto the carried-over boundary values (new = bc_array + (I-dtL)u,
            # heat_2d.py:333-343) instead of overwriting — replicated here.
            bc_ring = self._set_bc(self._zeros_like(u_start))
            new = bc_ring + u_start - dt * self._apply_L(u_start)
            new = new.at[1:-1, 1:-1].add(dt * self._rhs_at(t_start))
            return new

        # Implicit rhs (compute_rhs, heat_2d.py:289-320)
        if self.theta == 1.0:
            b = self._zeros_like(u_start)
            b = b.at[1:-1, 1:-1].set(u_start[1:-1, 1:-1]
                                     + dt * self._rhs_at(t_stop))
        else:
            b = u_start - self.theta * dt * self._apply_L(u_start)
            b = b.at[1:-1, 1:-1].add(
                self.theta * dt * self._rhs_at(t_stop)
                + (1 - self.theta) * dt * self._rhs_at(t_start))
        b = self._set_bc(b)

        # Interior solve with Dirichlet boundary lift: the interior equations
        # couple to the (known) boundary values with -fx/-fy coefficients, so
        # move those terms to the rhs before diagonalizing.
        shift = dt * self.theta
        b_int = b[1:-1, 1:-1]
        b_int = b_int.at[:, 0].add(shift * self.fy * b[1:-1, 0])
        b_int = b_int.at[:, -1].add(shift * self.fy * b[1:-1, -1])
        b_int = b_int.at[0, :].add(shift * self.fx * b[0, 1:-1])
        b_int = b_int.at[-1, :].add(shift * self.fx * b[-1, 1:-1])
        new_int = self._solve_interior(shift, b_int)
        new = self._set_bc(self._zeros_like(u_start).at[1:-1, 1:-1].set(new_int))
        return new
