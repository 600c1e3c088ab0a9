"""Device-resident MGRIT solver in FAS formulation.

Re-implements the full algorithm of the reference ``Mgrit`` class (reference:
src/pymgrit/core/mgrit.py:20-858) with a fundamentally different execution
model:

* Solution state per level is a *tube*: a pytree whose leaves have a leading
  time axis (nt_lvl, ...).  There are no per-point Vector objects.
* F-relaxation (reference mgrit.py:292-333, a per-point Python loop with MPI
  halo messages) becomes ``lax.scan`` over the intra-interval position with a
  ``vmap`` over *all* C-intervals at once — every F-interval of the level
  relaxes simultaneously on the device.
* C-relaxation (mgrit.py:335-370), the FAS restriction (mgrit.py:488-549),
  the error correction (mgrit.py:715-726) and the residual (mgrit.py:387-413)
  are batched vmapped step evaluations at all C-points.
* The coarsest-level sequential solve (mgrit.py:459-486) is a ``lax.scan``.
* The MPI tag-ledger / isend machinery (mgrit.py:192-196, 648-713)
  disappears: in SPMD execution collectives are ordered by program order; the
  distributed version (pymgrit_tpu.parallel) shards the time axis of the same
  tubes over a device mesh.

The iteration structure (V-/F-cycles, FCF-relaxation counts, nested
iteration, convergence criteria 0-3, C-relaxation weight) matches the
reference exactly so that residual histories reproduce the published golden
values (BASELINE.md).
"""

from __future__ import annotations

import functools
import inspect
import logging
import sys
import time
from contextlib import contextmanager
from typing import Callable, List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from pymgrit_tpu.core import vector
from pymgrit_tpu.core.application import Application
from pymgrit_tpu.core.grid_transfer import GridTransfer, GridTransferCopy
from pymgrit_tpu.core.levels import LevelInfo, build_level_infos, validate_hierarchy


@contextmanager
def bind_runtime_params(problem, params):
    """Bind per-level runtime-operand pytrees (possibly tracers) onto the
    applications for the duration of a solver trace (see
    core/application.py `runtime_params`)."""
    olds = []
    for p, prm in zip(problem, params):
        olds.append((p, p._rt))
        p._rt = prm
    try:
        yield
    finally:
        for p, old in reversed(olds):
            p._rt = old


def scan_unroll(n: int) -> int:
    """lax.scan unroll factor for a length-n sequential chain.

    Unrolling multiplies compile time by the unroll factor, a catastrophe
    for applications whose step contains inner control flow (e.g. the
    induction-machine surrogate: the core test tier went from 4:54 to
    hung on the CPU).  So the unroll stays 1 until a device measurement
    shows the per-iteration loop overhead matters.
    """
    return 1


def hook_accepts_kwarg(hook, name: str) -> bool:
    """True iff `hook` declares `name` as an EXPLICIT keyword parameter.

    Capability detection by signature, not by catching TypeError: a hook
    with **kwargs would swallow an unknown kwarg and return the default
    layout — reshaped as if it were the requested one (silently transposed
    F-rows) — and a genuine TypeError raised inside a conforming hook
    would be masked."""
    try:
        sig = inspect.signature(hook)
    except (TypeError, ValueError):
        return False
    return name in sig.parameters


def collect_runtime_params(problem, levels):
    """prepare_runtime + runtime_params over a hierarchy (setup-time)."""
    for lvl, p in enumerate(problem):
        prep = getattr(p, "prepare_runtime", None)
        if prep is not None:
            prep(levels[lvl])
    return tuple(
        (p.runtime_params() if hasattr(p, "runtime_params") else None)
        for p in problem)


class Mgrit:
    """MGRIT solver (drop-in parity with reference mgrit.py:20, constructor
    parameters mirror mgrit.py:33-69 minus the MPI communicators, which are
    replaced by an optional device mesh — see pymgrit_tpu.parallel)."""

    def __init__(self, problem: List[Application], transfer: List[GridTransfer] = None,
                 weight_c: float = 1.0, max_iter: int = 100, tol: float = 1e-7,
                 nested_iteration: bool = True, cf_iter=1, cycle_type: str = 'V',
                 mesh=None, logging_lvl: int = logging.INFO, output_fcn=None,
                 output_lvl: int = 1, t_norm: int = 2, random_init_guess: bool = False,
                 conv_crit: int = 0, rng_seed: int = 0,
                 lazy_f_relax: bool = False, condensed: bool = True,
                 coarsest_prefix: bool = False) -> None:
        logging.basicConfig(format='%(levelname)s - %(asctime)s - %(message)s',
                            datefmt='%d-%m-%y %H:%M:%S', level=logging_lvl, stream=sys.stdout)

        if transfer is None:
            transfer = [GridTransferCopy() for _ in range(len(problem) - 1)]

        # ---- validation (messages mirror reference mgrit.py:75-120) ----
        if len(problem) != (len(transfer) + 1):
            raise Exception('There should be exactly one transfer operator for each level except the coarsest grid')
        validate_hierarchy([p.t for p in problem])
        if cycle_type not in ('V', 'F'):
            raise Exception("Cycle-type " + str(cycle_type) + " is not implemented. Choose 'V' or 'F'")
        if output_lvl not in [0, 1, 2]:
            raise Exception("Unknown output level. Choose 0, 1 or 2.")
        if t_norm not in [1, 2, 3]:
            raise Exception('Unknown norm. Please choose 1 (one norm), 2 (two-norm) or 3 (inf-norm)')
        if conv_crit not in [0, 1, 2, 3]:
            raise Exception(
                'Unknown convergence criterion. Please choose: '
                '0 (global space-time residual), '
                '1 (global jump)'
                '2 (local space-time residual)'
                '3 (local jump)')
        if isinstance(cf_iter, int):
            cf_iter = [cf_iter for _ in range(len(problem))]
        elif isinstance(cf_iter, list):
            if len(cf_iter) < len(problem) - 1:
                raise Exception(
                    'Too few cf_iter. '
                    'Specify a list of values for all but the coarsest level or an integer (used for all levels).')
        else:
            raise Exception(
                'Incorrect datatype cf_iter. '
                'Specify a list of values for all but the coarsest level or an integer ( used for all levels).')

        self.problem = problem
        self.transfer = transfer
        self.weight_c = weight_c
        self.lvl_max = len(problem)
        self.tol = tol
        self.cf_iter = cf_iter
        self.cycle_type = cycle_type
        self.random_init_guess = random_init_guess
        self.iter_max = max_iter
        self.nes_it = nested_iteration
        self.conv = np.zeros(max_iter + 1)
        self.conv_crit = conv_crit
        self.global_conv_crit = conv_crit in (0, 1)
        self.t_norm_ord = 1 if t_norm == 1 else (None if t_norm == 2 else jnp.inf)
        self.output_lvl = output_lvl
        self.output_fcn = output_fcn if (output_fcn is not None and callable(output_fcn)) else None
        self.solve_iter = 0
        self.runtime_solve = 0.0
        self.runtime_setup = 0.0
        self.mesh = mesh

        # ---- static level structure ----
        runtime_setup_start = time.time()
        self.log_info("Start setup")
        self.levels: List[LevelInfo] = build_level_infos([p.t for p in problem])
        self.m = [li.m for li in self.levels]
        # Warn on non-uniform coarsening (reference mgrit.py:215-217)
        for lvl in range(self.lvl_max - 1):
            d = np.diff(self.levels[lvl].cpts)
            if d.size and not np.all(d == d[0]):
                logging.warning('Non-uniform coarsening between level ' + str(lvl) + ' and ' + str(lvl + 1) +
                                '. Poorly tested.')

        self.step_fns: List[Callable] = [p.step for p in problem]
        # ---- parallel-prefix coarsest solve (ops/prefix.py): replace the
        # sequential coarsest-level scan with an O(log n)-depth
        # lax.associative_scan over composed affine maps.  Exact (same
        # math, different association order) — the exact counterpart
        # of the chain-breaking AT-MGRIT approximates with truncated
        # windows.  Opt-in: it requires the coarsest application to expose
        # affine_coeffs(t0, t1) -> (A, b) with step(u) == A*u + b.
        self._coarsest_prefix = bool(coarsest_prefix)
        if self._coarsest_prefix:
            if getattr(problem[-1], "affine_coeffs", None) is None:
                raise Exception(
                    "coarsest_prefix=True requires the coarsest-level "
                    "application to define affine_coeffs(t_start, t_stop) "
                    "-> (A, b) with step(u, t_start, t_stop) == A*u + b "
                    "(elementwise per state leaf); "
                    + type(problem[-1]).__name__ + " does not")
            logging.info("Coarsest level uses the parallel-prefix "
                         "(associative-scan) forward solve")
        # Double-double mode: states are float32 (hi, lo) pairs (ops/dd.py),
        # giving fp64-class residual floors on hardware without fp64.  Time
        # values must then also be DD-split: the grids are f64 on host and a
        # bare f32 cast would perturb every dt at the 1e-7 level.
        self._dd = vector.contains_dd(problem[0].vector_template)
        # Applications may define a custom per-state norm (e.g. the machine
        # state excludes its scalar outputs, reference
        # vector_machine.py:101-109); default is the flat 2-norm.
        self.state_norm: Callable = getattr(problem[0], "state_norm", vector.norm)
        self.restrict_fns: List[Callable] = [tr.restriction for tr in transfer]
        self.interp_fns: List[Callable] = [tr.interpolation for tr in transfer]

        # ---- condensed level-0 carry (round-4, the HBM attack): when the
        # fine application provides the closed-form interval hook
        # (relax_interval), every consumer of level-0 F-rows during the
        # iterations — C-relaxation, the FAS restriction, the residual —
        # reads only Phi^k applied to the owning C-seed, which the hook
        # computes directly.  So the level-0 carry is just the C-points
        # (nc rows instead of nt): F-relaxation becomes the identity,
        # C-relaxation/FAS/residual evaluate the closed-form "step to the
        # next C-point" (the hook with m rows of times, only_last=True),
        # and the full fine tube is materialized ONCE after convergence.
        # Mathematically identical to the full algorithm (an F-relaxation
        # always precedes every F-row read — reference mgrit.py:292-370's
        # sweep order), it cuts level-0 HBM traffic per iteration by ~2m/3
        # and sidesteps the sparse-carry copy that made lazy_f_relax lose
        # (round-3 A/B).
        self._condensed0 = False
        self._cnd_times = None
        # subclassed convergence criteria receive the raw level-0 state and
        # expect the full tube (documented pattern, reference
        # examples/example_convergence_criterion.py) — keep it for them
        custom_criteria = (
            type(self).convergence_criterion is not Mgrit.convergence_criterion
            or type(self).compiled_convergence_criterion is not None)
        # Track WHY the fast path declines (VERDICT r4 weak-#6: the 2x
        # condensed path must not silently fall back — e.g. a user grid
        # with ~1e-13 dt jitter loses it with no visible signal).
        self._cnd_decline_reason = None
        if condensed and self.lvl_max > 1:
            if lazy_f_relax:
                self._cnd_decline_reason = "lazy_f_relax=True keeps the full level-0 tube"
            elif custom_criteria:
                self._cnd_decline_reason = (
                    "a custom convergence criterion reads the raw level-0 state "
                    "and needs the full fine tube")
            elif self.output_fcn is not None and output_lvl == 2:
                self._cnd_decline_reason = (
                    "output_lvl=2 hands the full level-0 tube to output_fcn "
                    "every iteration")
            elif not self.levels[0].uniform:
                self._cnd_decline_reason = (
                    "level-0 C-points are not uniformly spaced "
                    "(index-non-uniform coarsening)")
            elif self.levels[0].m <= 1:
                self._cnd_decline_reason = "level-0 coarsening factor is 1"
            elif getattr(problem[0], "relax_interval", None) is None:
                self._cnd_decline_reason = (
                    "the fine application provides no relax_interval hook")
            else:
                self._condensed0 = self._probe_condensed0()
            if not self._condensed0 and self._cnd_decline_reason is not None:
                self.log_info(
                    "MGRIT: condensed level-0 fast path DISABLED: "
                    + self._cnd_decline_reason
                    + " (full-tube executor used)")
        # condensed carry size (padded to the mesh 'time' axis like the
        # full tubes; pad rows are never read — all condensed slices are
        # static and < nc)
        self._nc_store0 = 0
        if self._condensed0:
            nc = self.levels[0].cpts.size
            n_ta = mesh.shape["time"] if mesh is not None else 1
            if n_ta > 1 and nc >= n_ta and nc % n_ta != 0:
                self._nc_store0 = ((nc + n_ta - 1) // n_ta) * n_ta
            else:
                self._nc_store0 = nc

        # ---- storage sizes: pad the time axis to a multiple of the mesh
        # 'time' axis so tubes shard evenly; pad rows are never read (all
        # solver indices are static and < nt; masked scatters write row nt,
        # i.e. the first pad row, harmlessly). ----
        self.nt_store: List[int] = []
        n_time_axis = mesh.shape["time"] if mesh is not None else 1
        for lvl in range(self.lvl_max):
            nt = self.levels[lvl].nt
            if n_time_axis > 1 and nt >= n_time_axis and nt % n_time_axis != 0:
                self.nt_store.append(((nt + n_time_axis - 1) // n_time_axis) * n_time_axis)
            else:
                self.nt_store.append(nt)

        # ---- allocate tubes (reference create_u_v_g, mgrit.py:840-858) ----
        self.u: List = []
        self.v: List = []
        self.g: List = []
        key = jax.random.PRNGKey(rng_seed)
        for lvl in range(self.lvl_max):
            nt = self.nt_store[lvl]
            if lvl == 0 and self._condensed0:
                nt = self._nc_store0             # C-rows-only carry
            template = vector.as_f64(problem[lvl].vector_template)
            if lvl == 0 and random_init_guess:
                key, sub = jax.random.split(key)
                tube = jax.vmap(lambda k: vector.random_like(template, k))(
                    jax.random.split(sub, nt))
            else:
                tube = vector.tube_of(template, nt)
            # Seed u[lvl][0] with the level's initial condition (mgrit.py:857-858)
            tube = vector.set_at(tube, np.array([0]),
                                 jax.tree_util.tree_map(lambda x: jnp.asarray(x)[None],
                                                        vector.as_f64(problem[lvl].vector_t_start)))
            self.u.append(tube)
            if lvl == 0:
                self.v.append(None)
                self.g.append(None)
            else:
                self.v.append(vector.zeros_like(tube))
                self.g.append(vector.zeros_like(tube))

        # ---- optional device-mesh distribution (time x space GSPMD) ----
        self.space_axis = getattr(problem[0], "space_sharding_axis", None)
        self._shardings = None
        if mesh is not None:
            from pymgrit_tpu.parallel.sharding import state_shardings, shard_state
            self._shardings = state_shardings(self._get_state(), self.levels, mesh,
                                              self.space_axis)
            self._set_state(shard_state(self._get_state(), self._shardings))

        # Lazy level-0 F-relaxation (round-3): write only each interval's
        # last F-value per sweep (the only row iterations consume) and
        # materialize the rest after convergence.  OPT-IN: the sparse update
        # into the while_loop carry can force XLA to copy the full tube per
        # phase, which costs more than the dense write-back — kept as a knob
        # because the trade flips when the tube no longer fits device memory
        # (it cuts the F-sweep's working set by 1/(m-1)).
        self._lazy_f0 = (bool(lazy_f_relax) and mesh is None
                         and hasattr(problem[0], "relax_interval")
                         and not (self.output_fcn is not None and output_lvl == 2))

        # ---- runtime operands: big application tables enter every jitted
        # driver as ARGUMENTS (bound back as tracers while tracing), not as
        # baked MLIR constants (core/application.py runtime channel) ----
        self._rt_params = collect_runtime_params(self.problem, self.levels)
        self._has_rt = any(x is not None for x in self._rt_params)

        # ---- jitted drivers ----
        out_s = self._shardings
        self._jit_nested = self._pjit(self._nested_iteration_fn, out_shardings=out_s)
        self._jit_iter_first = self._pjit(lambda s: self._iteration_fn(s, lvl0_first_f=True),
                                          out_shardings=out_s)
        self._jit_iter_rest = self._pjit(lambda s: self._iteration_fn(s, lvl0_first_f=False),
                                         out_shardings=out_s)
        self._jit_residual_conv = self._pjit(self._residual_conv_fn)
        self._jit_jump_conv = self._pjit(self._jump_conv_fn)

        if nested_iteration:
            self._run_nested_iteration()

        self.save_values_last_iter = None
        if conv_crit in (1, 3):
            # condensed: the saved iterate mirrors the (padded) carry so the
            # compiled loop's u_save carry keeps one fixed shape; the jump
            # norm only reads rows 1..nc-1 either way
            self.save_values_last_iter = vector.take(
                self.u[0], np.arange(self._nc_store0)
                if self._condensed0 else self.levels[0].cpts)

        self._all_below = False

        # Convenience views for user output hooks (reference exposes self.t /
        # self.index_local / self.u to output_fcn, docs/source/usage/
        # parallelism.rst:29-83). Global serial view: every point is local.
        self.t = [li.t for li in self.levels]
        self.index_local = [np.arange(li.nt) for li in self.levels]

        self.runtime_setup = time.time() - runtime_setup_start
        if self.output_fcn is not None and self.output_lvl == 2:
            self.output_fcn(self)
        self.log_info(f"Setup took {self.runtime_setup} s")

    # ------------------------------------------------------------------
    # state helpers
    # ------------------------------------------------------------------

    def _get_state(self):
        return (tuple(self.u), tuple(self.v), tuple(self.g))

    def _set_state(self, state):
        u, v, g = state
        self.u = list(u)
        self.v = list(v)
        self.g = list(g)

    def log_info(self, message: str) -> None:
        logging.info(message)

    # ------------------------------------------------------------------
    # runtime-operand plumbing + condensed level-0 structure
    # ------------------------------------------------------------------

    def _pjit(self, fn, donate_fn_args=(), **jit_kwargs):
        """jax.jit with the applications' runtime params threaded through
        as a leading argument and bound (as tracers) during tracing.
        donate_fn_args: positions of fn's own arguments to donate (shifted
        past the params argument automatically)."""
        if not getattr(self, "_has_rt", False):
            if donate_fn_args:
                jit_kwargs["donate_argnums"] = tuple(donate_fn_args)
            return jax.jit(fn, **jit_kwargs)

        def wrapped(params, *args, **kw):
            with bind_runtime_params(self.problem, params):
                return fn(*args, **kw)

        if donate_fn_args:
            jit_kwargs["donate_argnums"] = tuple(i + 1 for i in donate_fn_args)
        jitted = jax.jit(wrapped, **jit_kwargs)
        return functools.partial(jitted, self._rt_params)

    def _cnd_block_times(self, rows: int):
        """Static (rows, J) intra-interval step times for the level-0 hook:
        rows = m-1 (F-relaxation sweep) or m (step to the next C-point)."""
        info = self.levels[0]
        nt, m, t = info.nt, info.m, info.t
        J = (nt - 1) // m
        tp = np.stack([t[j * m:j * m + rows] for j in range(J)], 1)
        tc = np.stack([t[j * m + 1:j * m + rows + 1] for j in range(J)], 1)
        return tp, tc

    def _probe_condensed0(self) -> bool:
        """Eagerly check (with a 1-interval dummy seed) that the level-0
        hook accepts this grid: it returns None for non-uniform dt,
        time-dependent rhs, or unsupported precision/method combos."""
        info = self.levels[0]
        m, t = info.m, info.t
        if len(t) < m + 1:
            self._cnd_decline_reason = "level-0 grid shorter than one interval"
            return False
        # global dt uniformity (the probe's single interval can be locally
        # uniform on a grid whose later intervals are not — the hook would
        # then decline at trace time, after condensed allocation)
        dts = np.diff(np.asarray(t, dtype=np.float64))
        if not np.allclose(dts, dts[0], rtol=1e-12, atol=0.0):
            self._cnd_decline_reason = (
                "level-0 dt is not globally uniform to rtol=1e-12 "
                f"(max |dt - dt0|/dt0 = {float(np.max(np.abs(dts / dts[0] - 1.0))):.2e}); "
                "regenerate t_interval with np.linspace to recover the fast path")
            return False
        tp = t[0:m][:, None]
        tc = t[1:m + 1][:, None]
        seed = vector.tube_of(vector.as_f64(self.problem[0].vector_template), 1)
        hook = self.problem[0].relax_interval
        if not hook_accepts_kwarg(hook, "only_last"):
            self._cnd_decline_reason = (
                "relax_interval hook does not accept only_last=")
            return False
        ys = hook(seed, tp, tc, only_last=True)
        if ys is None:
            self._cnd_decline_reason = (
                "relax_interval hook declined this configuration "
                "(time-dependent rhs, or unsupported precision/method "
                "for the closed form)")
            return False
        return True

    def _cnd_c_step(self, u_c):
        """Closed-form Phi^m of every owning C-seed: the value each C-point
        update / FAS residual / convergence residual consumes."""
        nc = self.levels[0].cpts.size
        seeds = jax.tree_util.tree_map(lambda a: a[:nc - 1], u_c)
        if self._cnd_times is None:
            self._cnd_times = {
                "m": self._cnd_block_times(self.levels[0].m),
                "m1": self._cnd_block_times(self.levels[0].m - 1)}
        tp, tc = self._cnd_times["m"]
        ys = self.problem[0].relax_interval(seeds, tp, tc, only_last=True)
        return jax.tree_util.tree_map(lambda y: y[0], ys)

    def _sync_condensed0(self) -> None:
        """Re-condense self.u[0] to C-rows-only if a previous solve left it
        materialized (the C rows of the full tube ARE the state).  If the
        materialized tube is untouched since _materialize_condensed0 built
        it, reuse the stashed condensed carry (no gather, no compile in a
        timed re-solve); a user-replaced tube falls back to a C-row gather."""
        if not self._condensed0:
            return
        if vector.length(self.u[0]) == self._nc_store0:
            return
        stash = getattr(self, "_cnd_stash", None)
        if stash is not None and all(
                a is b for a, b in zip(jax.tree_util.tree_leaves(self.u[0]),
                                       stash[0])):
            self.u[0] = stash[1]
            # drop the stashed full tube: keeping it alive through the next
            # solve would hold a dead ~4.3 GB buffer at 257^2 full-nt while
            # a second one materializes
            self._cnd_stash = None
            return
        if not hasattr(self, "_jit_sync_cnd"):
            nc = self.levels[0].cpts.size
            pad = self._nc_store0 - nc

            def sync(u):
                c = vector.take(u, jnp.asarray(self.levels[0].cpts))
                if pad:
                    c = jax.tree_util.tree_map(
                        lambda x: jnp.concatenate(
                            [x, jnp.zeros((pad,) + x.shape[1:], x.dtype)]), c)
                return c

            self._jit_sync_cnd = self._pjit(sync)
        self.u[0] = self._jit_sync_cnd(self.u[0])

    def _cnd_materialize_expr(self, u_c):
        """Pure expression: condensed C-rows -> full (nt, ...) level-0 tube
        via one closed-form F-sweep (jit-safe; also fused into the compiled
        solve loop's program so the whole solve is ONE device program).

        Chunked over intervals with in-place dynamic-update-slices into the
        preallocated tube: the peak transient is one ~256 MB chunk instead
        of 3x the full tube (the concat-of-concat form needs ~3x the tube
        in intermediates, ~13 GB beside a 4.3 GB tube at 257^2 full-nt)."""
        info = self.levels[0]
        m = info.m
        nc = info.cpts.size
        J = nc - 1
        nt = info.nt
        tp, tc = self._cnd_block_times(m - 1)
        hook = self.problem[0].relax_interval

        elems_pp = sum(int(np.prod(np.shape(l))) for l in
                       jax.tree_util.tree_leaves(
                           self.problem[0].vector_template))
        cj = max(1, int(64e6) // max(1, m * elems_pp))
        out = jax.tree_util.tree_map(
            lambda a: jnp.zeros((nt,) + a.shape[1:], a.dtype), u_c)
        hook_im = hook_accepts_kwarg(hook, "interval_major")
        for lo in range(0, J, cj):
            hi = min(lo + cj, J)
            seeds = jax.tree_util.tree_map(lambda a: a[lo:hi], u_c)
            if hook_im:                             # (hi-lo, m-1, ...)
                ys = hook(seeds, tp[:, lo:hi], tc[:, lo:hi],
                          interval_major=True)
                im = ys is not None
            else:
                ys, im = None, False
            if ys is None:                          # (m-1, hi-lo, ...)
                ys = hook(seeds, tp[:, lo:hi], tc[:, lo:hi])

            def put(o, a, y):
                y2 = y if im else jnp.moveaxis(y, 0, 1)
                blocks = jnp.concatenate([a[lo:hi, None], y2], axis=1)
                flat = blocks.reshape(((hi - lo) * m,) + a.shape[1:])
                return jax.lax.dynamic_update_slice_in_dim(o, flat, lo * m, 0)

            out = jax.tree_util.tree_map(put, out, u_c, ys)
        return jax.tree_util.tree_map(
            lambda o, a: o.at[nt - 1].set(a[J]), out, u_c)

    def _materialize_condensed0(self) -> None:
        """After convergence, build the full (nt, ...) level-0 tube from
        the condensed C-rows with one closed-form F-sweep."""
        if not self._condensed0:
            return
        if vector.length(self.u[0]) != self._nc_store0:
            return
        if not hasattr(self, "_jit_mat_cnd"):
            self._jit_mat_cnd = self._pjit(self._cnd_materialize_expr)
        u_c = self.u[0]
        self.u[0] = self._jit_mat_cnd(u_c)
        # identity-keyed stash: lets _sync_condensed0 restore the condensed
        # carry without a gather as long as u[0] is the tube built here
        self._cnd_stash = (jax.tree_util.tree_leaves(self.u[0]), u_c)

    # ------------------------------------------------------------------
    # batched kernels (pure; called under jit)
    # ------------------------------------------------------------------

    def _as_t(self, arr):
        """Host f64 time values -> step inputs (exact DD split in DD mode)."""
        if self._dd:
            from pymgrit_tpu.ops import dd as _ddm
            return _ddm.from_f64(np.asarray(arr))
        return jnp.asarray(arr)

    def _vstep(self, lvl):
        """Batched stepper: an application may provide step_batched(u_tube,
        t_starts, t_stops) — e.g. a Pallas kernel fusing the whole batched
        implicit solve — otherwise vmap the scalar step."""
        batched = getattr(self.problem[lvl], "step_batched", None)
        if batched is not None:
            return batched
        return jax.vmap(self.step_fns[lvl], in_axes=(0, 0, 0))

    def _pad_tube(self, tube, lvl):
        """Pad a freshly built (nt, ...) tube to the level's storage size."""
        store, nt = self.nt_store[lvl], self.levels[lvl].nt
        if store == nt:
            return tube
        return jax.tree_util.tree_map(
            lambda x: jnp.concatenate(
                [x, jnp.zeros((store - nt,) + x.shape[1:], x.dtype)]), tube)

    # -- uniform-level write-back strategy: with a GSPMD mesh,
    #    reshape/concat reassembly avoids scatters that would cross shard
    #    boundaries; WITHOUT a mesh, a direct indexed .at[].set into the tube
    #    lets XLA fuse the gather+step+scatter into one tube pass instead of
    #    a concat/reshape chain.  Same values either way; which is faster
    #    on a given device is a measurement question. --

    def _split_blocks(self, u, lvl):
        """(u0, blocks) with blocks leaf shape (J, m, ...)."""
        info = self.levels[lvl]
        nt, m = info.nt, info.m
        J = (nt - 1) // m
        u0 = jax.tree_util.tree_map(lambda x: x[0:1], u)
        blocks = jax.tree_util.tree_map(
            lambda x: x[1:nt].reshape((J, m) + x.shape[1:]), u)
        return u0, blocks

    def _join_blocks(self, u0, blocks, lvl):
        joined = jax.tree_util.tree_map(
            lambda a, b: jnp.concatenate(
                [a, b.reshape((-1,) + b.shape[2:])], axis=0), u0, blocks)
        return self._pad_tube(joined, lvl)

    def _f_relax_uniform(self, lvl, u, g, lazy=False):
        """F-relax via scan over the m-1 intra-interval positions with a
        (J, ...) batch.

        lazy=True (round-3; level 0 with an active relax_interval hook
        only): every consumer during the iteration — C-relaxation, the FAS
        residual, and the convergence residual — reads ONLY each interval's
        last F-value u[j*m + m-1], so the sweep writes just that one row
        per interval (A^{m-1} seed + G_{m-1}: 1/(m-1) of the HBM traffic
        and FLOPs); the remaining F-rows stay stale until _materialize_f0
        runs one full sweep after convergence."""
        info = self.levels[lvl]
        nt, m = info.nt, info.m
        J = (nt - 1) // m
        t = info.t
        # seeds: owning C-points u[0, m, 2m, ...] for each interval
        x = jax.tree_util.tree_map(lambda a: a[0:nt - 1:m], u)
        tp_np = np.stack([t[j * m:j * m + m - 1] for j in range(J)], 1)  # (m-1, J)
        tc_np = np.stack([t[j * m + 1:j * m + m] for j in range(J)], 1)
        vstep = self._vstep(lvl)
        im = False      # ys layout: (J, m-1, ...) if True else (m-1, J, ...)

        if lvl == 0:
            # Optional model fast path: a linear/affine stepper can produce
            # ALL m-1 intra-interval F-values from the seed in one closed-
            # form batched expression (e.g. Heat2D spectral mode: powers of
            # the elementwise update map), replacing the sequential scan.
            # The hook gets the STATIC numpy block times and returns the
            # (m-1, J, ...) pytree, or None to decline.
            hook = getattr(self.problem[lvl], "relax_interval", None)
            if hook is not None and lazy and m > 1 and self.mesh is None:
                ys_last = (hook(x, tp_np, tc_np, only_last=True)
                           if hook_accepts_kwarg(hook, "only_last") else None)
                if ys_last is not None:
                    vals = jax.tree_util.tree_map(lambda y: y[0], ys_last)
                    return jax.tree_util.tree_map(
                        lambda a, v: a.at[m - 1:nt:m].set(v), u, vals)
            ys = None
            if hook is not None:
                if hook_accepts_kwarg(hook, "interval_major"):
                    ys = hook(x, tp_np, tc_np, interval_major=True)
                    im = ys is not None     # (J, m-1, ...) write-back order
                else:
                    ys = hook(x, tp_np, tc_np)
            if ys is None:
                t_prev = self._as_t(tp_np)
                t_curr = self._as_t(tc_np)

                def body(carry, inp):
                    tp, tc = inp
                    stepped = vstep(carry, tp, tc)
                    return stepped, stepped

                _, ys = jax.lax.scan(body, x, (t_prev, t_curr),
                                     unroll=scan_unroll(m - 1))
        else:
            t_prev = self._as_t(tp_np)
            t_curr = self._as_t(tc_np)
            _, g_blocks = self._split_blocks(g, lvl)  # (J, m, ...)
            g_f = jax.tree_util.tree_map(lambda a: jnp.moveaxis(a[:, :m - 1], 1, 0),
                                         g_blocks)   # (m-1, J, ...)

            def body(carry, inp):
                tp, tc, gi = inp
                stepped = vector.add(gi, vstep(carry, tp, tc))
                return stepped, stepped

            _, ys = jax.lax.scan(body, x, (t_prev, t_curr, g_f),
                                 unroll=scan_unroll(m - 1))

        if self.mesh is None:
            f_idx = jnp.asarray(
                np.concatenate([np.arange(j * m + 1, (j + 1) * m)
                                for j in range(J)]))
            vals = jax.tree_util.tree_map(
                lambda y: (y if im else jnp.moveaxis(y, 0, 1))
                .reshape((-1,) + y.shape[2:]), ys)
            return jax.tree_util.tree_map(
                lambda a, v: a.at[f_idx].set(v), u, vals)
        u0, blocks = self._split_blocks(u, lvl)
        new_blocks = jax.tree_util.tree_map(
            lambda b, y: jnp.concatenate(
                [y if im else jnp.moveaxis(y, 0, 1), b[:, m - 1:m]], axis=1),
            blocks, ys)
        return self._join_blocks(u0, new_blocks, lvl)

    def _c_relax_uniform(self, lvl, u, g):
        info = self.levels[lvl]
        nt, m = info.nt, info.m
        t = self._as_t(info.t)
        prev = jax.tree_util.tree_map(lambda a: a[m - 1:nt:m], u)   # u[cm-1]
        tp = t[m - 1:nt:m]
        tc = t[m:nt:m]
        stepped = self._vstep(lvl)(prev, tp, tc)
        if lvl > 0:
            g_c = jax.tree_util.tree_map(lambda a: a[m:nt:m], g)
            stepped = vector.add(g_c, stepped)
        if self.weight_c != 1.0:
            u_c = jax.tree_util.tree_map(lambda a: a[m:nt:m], u)
            stepped = vector.add(vector.scale(stepped, self.weight_c),
                                 vector.scale(u_c, 1.0 - self.weight_c))
        if self.mesh is None:
            return jax.tree_util.tree_map(
                lambda a, c: a.at[m:nt:m].set(c), u, stepped)
        u0, blocks = self._split_blocks(u, lvl)
        new_blocks = jax.tree_util.tree_map(
            lambda b, c: jnp.concatenate([b[:, :m - 1], c[:, None]], axis=1),
            blocks, stepped)
        return self._join_blocks(u0, new_blocks, lvl)

    def _f_relax(self, lvl, u, g, lazy=False):
        """All F-intervals relax simultaneously (reference f_relax,
        mgrit.py:292-333: sequential within an interval, batched across)."""
        if lvl == 0 and self._condensed0:
            return u          # F-rows are implicit functions of the C-seeds
        info = self.levels[lvl]
        ch = info.chains
        if ch is None or ch.seed.size == 0 or ch.lmax == 0:
            return u
        if info.uniform:
            return self._f_relax_uniform(lvl, u, g, lazy=lazy)
        nt = info.nt
        x = vector.take(u, ch.seed)  # (J, ...) seeds: owning C-point states
        # Scan inputs laid out (Lmax, J)
        t_prev = self._as_t(ch.t_prev.T)
        t_curr = self._as_t(ch.t_curr.T)
        mask = jnp.asarray(ch.mask.T)
        f_idx_cl = jnp.asarray(np.minimum(ch.f_idx.T, nt - 1))  # clipped for g-gather
        vstep = self._vstep(lvl)

        if lvl == 0:
            def body(carry, inp):
                tp, tc, mk, _ = inp
                stepped = vstep(carry, tp, tc)
                carry = vector.where(mk, stepped, carry)
                return carry, carry
        else:
            def body(carry, inp):
                tp, tc, mk, gi = inp
                stepped = vector.add(vector.take(g, gi), vstep(carry, tp, tc))
                carry = vector.where(mk, stepped, carry)
                return carry, carry

        _, ys = jax.lax.scan(body, x, (t_prev, t_curr, mask, f_idx_cl),
                             unroll=scan_unroll(ch.lmax))
        # Scatter all (Lmax, J) results; padding lanes carry index nt -> dropped
        idx_flat = jnp.asarray(ch.f_idx.T.reshape(-1))
        vals_flat = jax.tree_util.tree_map(lambda a: a.reshape((-1,) + a.shape[2:]), ys)
        return vector.set_at(u, idx_flat, vals_flat, mode="drop")

    def _c_relax(self, lvl, u, g):
        """Weighted C-relaxation (reference c_relax, mgrit.py:335-370;
        weighted-Jacobi update mgrit.py:359-368).

        The reference sweeps C-points in ascending order, so *adjacent*
        C-points (non-uniform coarsening) chain Gauss-Seidel style.  Runs of
        adjacent C-points scan sequentially; with uniform m >= 2 every run
        has length 1 and this is a single fully batched step."""
        if lvl == 0 and self._condensed0:
            nc = self.levels[0].cpts.size
            stepped = self._cnd_c_step(u)
            if self.weight_c != 1.0:
                u_c = jax.tree_util.tree_map(lambda a: a[1:nc], u)
                stepped = vector.add(vector.scale(stepped, self.weight_c),
                                     vector.scale(u_c, 1.0 - self.weight_c))
            # contiguous rows: static-slice update (dynamic-update-slice),
            # NOT an index-array scatter (a scatter into a while-loop carry
            # can make XLA copy the carry)
            return jax.tree_util.tree_map(
                lambda a, c: a.at[1:nc].set(c), u, stepped)
        info = self.levels[lvl]
        cc = info.c_chains
        if cc is None or cc.c_idx.size == 0:
            return u
        if info.uniform:
            return self._c_relax_uniform(lvl, u, g)
        w = self.weight_c

        if cc.rmax == 1:
            ci = jnp.asarray(info.cpts[1:])
            t = self._as_t(info.t)
            prev = vector.take(u, ci - 1)
            stepped = self._vstep(lvl)(prev, t[ci - 1], t[ci])
            if lvl > 0:
                stepped = vector.add(vector.take(g, ci), stepped)
            if w == 1.0:
                unew = stepped
            else:
                unew = vector.add(vector.scale(stepped, w),
                                  vector.scale(vector.take(u, ci), 1.0 - w))
            return vector.set_at(u, ci, unew)

        nt = info.nt
        x = vector.take(u, jnp.asarray(cc.seed_prev))  # (K, ...)
        t_prev = self._as_t(cc.t_prev.T)
        t_curr = self._as_t(cc.t_curr.T)
        mask = jnp.asarray(cc.mask.T)
        idx_cl = jnp.asarray(np.minimum(cc.c_idx.T, nt - 1))
        vstep = self._vstep(lvl)

        def body(carry, inp):
            tp, tc, mk, ci = inp
            stepped = vstep(carry, tp, tc)
            if lvl > 0:
                stepped = vector.add(vector.take(g, ci), stepped)
            u_old = vector.take(u, ci)
            if w == 1.0:
                unew = stepped
            else:
                unew = vector.add(vector.scale(stepped, w),
                                  vector.scale(u_old, 1.0 - w))
            carry = vector.where(mk, unew, carry)
            return carry, carry

        _, ys = jax.lax.scan(body, x, (t_prev, t_curr, mask, idx_cl),
                             unroll=scan_unroll(cc.rmax))
        idx_flat = jnp.asarray(cc.c_idx.T.reshape(-1))
        vals_flat = jax.tree_util.tree_map(lambda a: a.reshape((-1,) + a.shape[2:]), ys)
        return vector.set_at(u, idx_flat, vals_flat, mode="drop")

    def _forward_solve(self, lvl, u, g):
        """Sequential time stepping as lax.scan (reference forward_solve,
        mgrit.py:459-486)."""
        info = self.levels[lvl]
        nt = info.nt
        if nt <= 1:
            return u
        t = self._as_t(info.t)
        u0 = vector.take(u, jnp.asarray([0]))
        x0 = jax.tree_util.tree_map(lambda a: a[0], u0)
        step = self.step_fns[lvl]
        if self._coarsest_prefix and lvl == self.lvl_max - 1:
            from pymgrit_tpu.ops.prefix import affine_prefix_states
            aff = self.problem[lvl].affine_coeffs
            A, b = jax.vmap(aff)(t[:-1], t[1:])
            c = vector.add(b, vector.take(g, jnp.arange(1, nt))) \
                if lvl > 0 else b
            rest = affine_prefix_states(A, c, x0)
            return self._pad_tube(vector.concat([u0, rest]), lvl)
        if lvl > 0:
            g_rest = vector.take(g, jnp.arange(1, nt))

            def body(carry, inp):
                t0, t1, gi = inp
                nxt = vector.add(gi, step(carry, t0, t1))
                return nxt, nxt

            _, rest = jax.lax.scan(body, x0, (t[:-1], t[1:], g_rest),
                                   unroll=scan_unroll(nt - 1))
        else:
            def body(carry, inp):
                t0, t1 = inp
                nxt = step(carry, t0, t1)
                return nxt, nxt

            _, rest = jax.lax.scan(body, x0, (t[:-1], t[1:]),
                                   unroll=scan_unroll(nt - 1))
        return self._pad_tube(vector.concat([u0, rest]), lvl)

    def _fas_residual(self, lvl, u_f, g_f, u_c_old, g_c_old):
        """Restriction + FAS right-hand side, batched over C-points
        (reference fas_residual, mgrit.py:488-549)."""
        info = self.levels[lvl]
        info_c = self.levels[lvl + 1]
        nc = info.cpts.size
        nt, m = info.nt, info.m
        t_f = self._as_t(info.t)
        t_c = self._as_t(info_c.t)
        vrestrict = jax.vmap(self.restrict_fns[lvl])

        if lvl == 0 and self._condensed0:
            # condensed carry: u_f IS the C-point tube (padded to the mesh
            # 'time' axis; restrict only the real nc rows); Phi(u[cm-1]) is
            # the closed-form step to the next C-point
            u_c = self._pad_tube(
                vrestrict(jax.tree_util.tree_map(lambda a: a[:nc], u_f)),
                lvl + 1)
            v_c = jax.tree_util.tree_map(lambda x: x, u_c)
            stepped_f = self._cnd_c_step(u_f)
            u_ci = jax.tree_util.tree_map(lambda a: a[1:nc], u_f)
            inner = vector.sub(stepped_f, u_ci)
            r = vrestrict(inner)
            v_prev = jax.tree_util.tree_map(lambda a: a[:nc - 1], v_c)
            stepped_c = self._vstep(lvl + 1)(v_prev, t_c[:-1], t_c[1:])
            v_tail = jax.tree_util.tree_map(lambda a: a[1:nc], v_c)
            g_tail = vector.add(r, vector.sub(v_tail, stepped_c))
            g_head = jax.tree_util.tree_map(lambda a: a[0:1], g_c_old)
            g_c = self._pad_tube(vector.concat([g_head, g_tail]), lvl + 1)
            return u_c, v_c, g_c

        if info.uniform:
            # strided slices instead of gathers; concat instead of scatter
            u_at_c = jax.tree_util.tree_map(lambda a: a[0:nt:m], u_f)
            u_c = self._pad_tube(vrestrict(u_at_c), lvl + 1)
            v_c = jax.tree_util.tree_map(lambda x: x, u_c)
            prev = jax.tree_util.tree_map(lambda a: a[m - 1:nt:m], u_f)
            stepped_f = self._vstep(lvl)(prev, t_f[m - 1:nt:m], t_f[m:nt:m])
            u_ci = jax.tree_util.tree_map(lambda a: a[m:nt:m], u_f)
            if lvl == 0:
                inner = vector.sub(stepped_f, u_ci)
            else:
                g_ci = jax.tree_util.tree_map(lambda a: a[m:nt:m], g_f)
                inner = vector.add(vector.sub(g_ci, u_ci), stepped_f)
            r = vrestrict(inner)
            v_prev = jax.tree_util.tree_map(lambda a: a[:nc - 1], v_c)
            stepped_c = self._vstep(lvl + 1)(v_prev, t_c[:-1], t_c[1:])
            v_tail = jax.tree_util.tree_map(lambda a: a[1:nc], v_c)
            g_tail = vector.add(r, vector.sub(v_tail, stepped_c))
            g_head = jax.tree_util.tree_map(lambda a: a[0:1], g_c_old)
            g_c = self._pad_tube(vector.concat([g_head, g_tail]), lvl + 1)
            return u_c, v_c, g_c

        cpts = jnp.asarray(info.cpts)
        u_c = self._pad_tube(vrestrict(vector.take(u_f, cpts)), lvl + 1)
        v_c = jax.tree_util.tree_map(lambda x: x, u_c)  # FAS saved iterate (mgrit.py:520)

        ci = cpts[1:]
        prev = vector.take(u_f, ci - 1)
        stepped_f = self._vstep(lvl)(prev, t_f[ci - 1], t_f[ci])
        if lvl == 0:
            inner = vector.sub(stepped_f, vector.take(u_f, ci))
        else:
            inner = vector.add(vector.sub(vector.take(g_f, ci), vector.take(u_f, ci)), stepped_f)
        r = vrestrict(inner)                            # (nc-1, ...)

        idx_prev = jnp.arange(0, nc - 1)
        stepped_c = self._vstep(lvl + 1)(vector.take(v_c, idx_prev), t_c[:-1], t_c[1:])
        g_tail = vector.add(r, vector.sub(vector.take(v_c, jnp.arange(1, nc)), stepped_c))
        g_c = vector.set_at(g_c_old, jnp.arange(1, nc), g_tail)  # g[lvl+1][0] never written
        return u_c, v_c, g_c

    def _error_correction(self, lvl, u_f, u_c, v_c):
        """Coarse-grid correction at C-points (reference error_correction,
        mgrit.py:715-726)."""
        info = self.levels[lvl]
        nc = info.cpts.size
        if nc <= 1:
            return u_f
        vinterp = jax.vmap(self.interp_fns[lvl])
        err = vinterp(vector.sub(vector.take(u_c, jnp.arange(1, nc)),
                                 vector.take(v_c, jnp.arange(1, nc))))
        if lvl == 0 and self._condensed0:
            c_new = vector.add(
                jax.tree_util.tree_map(lambda a: a[1:nc], u_f), err)
            return jax.tree_util.tree_map(
                lambda a, c: a.at[1:nc].set(c), u_f, c_new)
        if info.uniform:
            nt, m = info.nt, info.m
            if self.mesh is None:
                # vector.add (not .at[].add) so DD carries stay exact
                c_new = vector.add(
                    jax.tree_util.tree_map(lambda a: a[m:nt:m], u_f), err)
                return jax.tree_util.tree_map(
                    lambda a, c: a.at[m:nt:m].set(c), u_f, c_new)
            c_new = vector.add(jax.tree_util.tree_map(lambda a: a[m:nt:m], u_f), err)
            u0, blocks = self._split_blocks(u_f, lvl)
            new_blocks = jax.tree_util.tree_map(
                lambda b, c: jnp.concatenate([b[:, :m - 1], c[:, None]], axis=1),
                blocks, c_new)
            return self._join_blocks(u0, new_blocks, lvl)
        return vector.add_at(u_f, jnp.asarray(info.cpts[1:]), err)

    # ------------------------------------------------------------------
    # cycles
    # ------------------------------------------------------------------

    def _cycle(self, lvl, u, v, g, cycle_type, first_f, lvl0_first_f):
        """One recursive MGRIT cycle (reference iteration, mgrit.py:261-290).
        u, v, g are python lists mutated in place while tracing."""
        if lvl == self.lvl_max - 1:
            u[lvl] = self._forward_solve(lvl, u[lvl], g[lvl])
            return

        lazy = lvl == 0 and self._lazy_f0
        if (lvl > 0 or lvl0_first_f) and first_f:
            u[lvl] = self._f_relax(lvl, u[lvl], g[lvl], lazy=lazy)

        for _ in range(self.cf_iter[lvl]):
            u[lvl] = self._c_relax(lvl, u[lvl], g[lvl])
            u[lvl] = self._f_relax(lvl, u[lvl], g[lvl], lazy=lazy)

        u[lvl + 1], v[lvl + 1], g[lvl + 1] = self._fas_residual(
            lvl, u[lvl], g[lvl], u[lvl + 1], g[lvl + 1])

        self._cycle(lvl + 1, u, v, g, cycle_type, True, lvl0_first_f)

        u[lvl] = self._error_correction(lvl, u[lvl], u[lvl + 1], v[lvl + 1])

        u[lvl] = self._f_relax(lvl, u[lvl], g[lvl], lazy=lazy)

        if lvl != 0 and cycle_type == 'F':
            self._cycle(lvl, u, v, g, 'V', False, lvl0_first_f)

    def _iteration_fn(self, state, lvl0_first_f):
        u, v, g = list(state[0]), list(state[1]), list(state[2])
        self._cycle(0, u, v, g, self.cycle_type, True, lvl0_first_f)
        return (tuple(u), tuple(v), tuple(g))

    def _run_nested_iteration(self):
        """Overridable wrapper around the jitted nested iteration (the
        machine solver wraps it with a PWM->sin source switch)."""
        self._set_state(self._jit_nested(self._get_state()))

    def _nested_iteration_fn(self, state):
        """Nested iteration initialization (reference nested_iteration,
        mgrit.py:551-566)."""
        u, v, g = list(state[0]), list(state[1]), list(state[2])
        u[self.lvl_max - 1] = self._forward_solve(self.lvl_max - 1, u[self.lvl_max - 1],
                                                  g[self.lvl_max - 1])
        for lvl in range(self.lvl_max - 2, -1, -1):
            nc = self.levels[lvl].cpts.size
            vinterp = jax.vmap(self.interp_fns[lvl])
            interped = vinterp(vector.take(u[lvl + 1], jnp.arange(1, nc)))
            if lvl == 0 and self._condensed0:
                u[lvl] = jax.tree_util.tree_map(
                    lambda a, v: a.at[1:nc].set(v), u[lvl], interped)
            else:
                u[lvl] = vector.set_at(
                    u[lvl], jnp.asarray(self.levels[lvl].cpts[1:]), interped)
            if lvl > 0:
                self._cycle(lvl, u, v, g, 'V', True, True)
        return (tuple(u), tuple(v), tuple(g))

    # ------------------------------------------------------------------
    # convergence criteria (reference convergence_criterion, mgrit.py:415-457)
    # ------------------------------------------------------------------

    def _point_residual_norms(self, u0):
        info = self.levels[0]
        t = self._as_t(info.t)
        if self._condensed0:
            nc = info.cpts.size
            stepped = self._cnd_c_step(u0)
            r = vector.sub(stepped,
                           jax.tree_util.tree_map(lambda a: a[1:nc], u0))
            return jax.vmap(self.state_norm)(r)
        if info.uniform:
            nt, m = info.nt, info.m
            prev = jax.tree_util.tree_map(lambda a: a[m - 1:nt:m], u0)
            stepped = self._vstep(0)(prev, t[m - 1:nt:m], t[m:nt:m])
            r = vector.sub(stepped, jax.tree_util.tree_map(lambda a: a[m:nt:m], u0))
            return jax.vmap(self.state_norm)(r)
        cpts = info.cpts if self.lvl_max > 1 else np.arange(info.nt)
        ci = jnp.asarray(cpts[1:])
        prev = vector.take(u0, ci - 1)
        stepped = self._vstep(0)(prev, t[ci - 1], t[ci])
        r = vector.sub(stepped, vector.take(u0, ci))
        return jax.vmap(self.state_norm)(r)

    def _residual_conv_fn(self, state):
        norms = self._point_residual_norms(state[0][0])
        conv = jnp.linalg.norm(norms, ord=self.t_norm_ord)
        all_below = jnp.all(norms < self.tol)
        return conv, all_below

    def _jump_conv_fn(self, state, u_save):
        info = self.levels[0]
        if self._condensed0:
            u_c = state[0][0]                   # the carry IS the C-points
            n = info.cpts.size
        else:
            cpts = jnp.asarray(info.cpts if self.lvl_max > 1 else np.arange(info.nt))
            u_c = vector.take(state[0][0], cpts)
            n = cpts.shape[0]
        jump = vector.sub(jax.tree_util.tree_map(lambda a: a[1:n], u_c),
                          jax.tree_util.tree_map(lambda a: a[1:n], u_save))
        norms = jax.vmap(self.state_norm)(jump)
        conv = jnp.linalg.norm(norms, ord=self.t_norm_ord)
        all_below = jnp.all(norms < self.tol)
        return conv, all_below, u_c

    # ------------------------------------------------------------------
    # driver (reference solve, mgrit.py:590-646)
    # ------------------------------------------------------------------

    def convergence_criterion(self, iteration: int) -> None:
        """Compute self.conv[iteration].  Overridable, mirroring the
        documented subclassing pattern (reference
        examples/example_convergence_criterion.py:13-61)."""
        state = self._get_state()
        if self.conv_crit in (0, 2):
            conv, all_below = self._jit_residual_conv(state)
        else:
            conv, all_below, self.save_values_last_iter = self._jit_jump_conv(
                state, self.save_values_last_iter)
        self.conv[iteration] = float(conv)
        self._all_below = bool(all_below)

    def solve(self) -> dict:
        self.log_info("Start solve")
        self._sync_condensed0()
        state = self._get_state()
        runtime_solve_start = time.time()
        for iteration in range(self.iter_max):
            self.solve_iter = iteration + 1
            time_it_start = time.time()
            state = self._jit_iter_first(state) if iteration == 0 else self._jit_iter_rest(state)
            time_it_stop = time.time()

            self._set_state(state)
            self.convergence_criterion(iteration + 1)

            if iteration == 0:
                self.log_info('{0: <7}'.format(f"iter {iteration + 1}") +
                              '{0: <32}'.format(f" | conv: {self.conv[iteration + 1]}") +
                              '{0: <37}'.format(" | conv factor: -") +
                              '{0: <35}'.format(f" | runtime: {time_it_stop - time_it_start} s"))
            else:
                self.log_info('{0: <7}'.format(f"iter {iteration + 1}") +
                              '{0: <32}'.format(f" | conv: {self.conv[iteration + 1]}") +
                              '{0: <37}'.format(
                                  f" | conv factor: {self.conv[iteration + 1] / self.conv[iteration]}") +
                              '{0: <35}'.format(f" | runtime: {time_it_stop - time_it_start} s"))

            if self.output_fcn is not None and self.output_lvl == 2:
                self.output_fcn(self)

            if self.global_conv_crit:
                if self.conv[iteration + 1] < self.tol or iteration == self.iter_max - 1:
                    break
            else:
                # Local criteria stop when every point is below tol
                # (reference mgrit.py:447-448; the SPMD handshake protocol is
                # unnecessary — a reduced all() replaces it).
                if self._all_below or iteration == self.iter_max - 1:
                    break

        self._materialize_f0()
        self._materialize_condensed0()
        self.runtime_solve = time.time() - runtime_solve_start
        self.log_info(f"Solve took {self.runtime_solve} s")
        if self.output_fcn is not None and self.output_lvl == 1:
            self.output_fcn(self)
        self.ouput_run_information()
        return {'conv': self.conv[np.where(self.conv != 0)], 'time_setup': self.runtime_setup,
                'time_solve': self.runtime_solve}

    def _materialize_f0(self):
        """After a lazy-F solve, fill in the level-0 F-rows the iterations
        never needed (one full closed-form sweep)."""
        if not self._lazy_f0:
            return
        if not hasattr(self, "_jit_matf0"):
            self._jit_matf0 = self._pjit(
                lambda uu: self._f_relax(0, uu, self.g[0], lazy=False))
        self.u[0] = self._jit_matf0(self.u[0])

    # ------------------------------------------------------------------
    # fully-compiled driver: the whole iteration loop runs on device as a
    # lax.while_loop with the convergence check inline — zero host syncs
    # until the final history fetch.  A feature with no reference
    # analogue (the reference must return to Python for MPI collectives
    # every iteration).
    # ------------------------------------------------------------------

    # -- custom criteria in the fused loop (round-3, VERDICT r2 weak-#4):
    # subclasses override compiled_convergence_criterion (a PURE jittable
    # function of (state, aux) -> (conv, done, aux)) and, if they carry
    # cross-iteration data (e.g. the machine joule losses of the previous
    # iterate, reference mgrit_machine_conv_jl.py:98-118), also
    # compiled_conv_aux_init.  solve_compiled then runs the custom check
    # INSIDE the lax.while_loop — zero host syncs, unlike the reference,
    # whose custom criteria force an MPI round trip every iteration. --

    compiled_convergence_criterion = None   # override in subclasses

    def compiled_conv_aux_init(self):
        """Initial aux pytree for compiled_convergence_criterion."""
        cached = getattr(self, "_conv_aux0_cache", None)
        if cached is None:
            cached = self._conv_aux0_cache = jnp.zeros(())
        return cached

    def _solve_compiled_fn(self, state, u_save, conv_aux):
        max_iter = self.iter_max
        use_jump = self.conv_crit in (1, 3)
        custom = type(self).compiled_convergence_criterion

        def cond(carry):
            it, hist, state, u_save, aux, done = carry
            return jnp.logical_and(it < max_iter, jnp.logical_not(done))

        def body(carry):
            it, hist, state, u_save, aux, _ = carry
            # lvl0_first_f gates EXACTLY one initial level-0 F-relaxation
            # (reference mgrit.py:274: skipped for iterations > 0) — hoist
            # that sweep into the cond instead of cond-ing two copies of
            # the whole V-cycle: XLA's buffer assignment allocates both
            # cond branches, so the duplicated cycle nearly doubled the
            # body's transient footprint (round-5: the dd_toms129 row
            # OOM'd 15.85G/15.75G with the duplicated body; condensed
            # mode folds the cond away entirely since its level-0 F-relax
            # is the identity).
            def _init_f(s):
                u, v, g = list(s[0]), list(s[1]), list(s[2])
                u[0] = self._f_relax(0, u[0], g[0], lazy=self._lazy_f0)
                return (tuple(u), tuple(v), tuple(g))

            state = jax.lax.cond(it == 0, _init_f, lambda s: s, state)
            state = self._iteration_fn(state, lvl0_first_f=False)
            if custom is not None:
                conv, done, aux = custom(self, state, aux)
            elif use_jump:
                conv, all_below, u_save = self._jump_conv_fn(state, u_save)
                done = jnp.where(self.global_conv_crit, conv < self.tol, all_below)
            else:
                conv, all_below = self._residual_conv_fn(state)
                done = jnp.where(self.global_conv_crit, conv < self.tol, all_below)
            hist = hist.at[it].set(conv)
            return (it + 1, hist, state, u_save, aux, done)

        hist0 = jnp.zeros(max_iter, dtype=jnp.result_type(0.0))
        carry = (jnp.array(0), hist0, state, u_save, conv_aux, jnp.array(False))
        it, hist, state, u_save, aux, done = jax.lax.while_loop(cond, body, carry)
        # Fused post-solve materialization (condensed mode): the full fine
        # tube is produced by the SAME device program — one launch for the
        # whole solve, no second program launch and output transfer.
        u0_full = (self._cnd_materialize_expr(state[0][0])
                   if self._condensed0 else None)
        return it, hist, state, u_save, aux, u0_full

    def _solve_compiled_call(self):
        """(jitted fused solve, its arguments) for the current state."""
        self._sync_condensed0()
        if not hasattr(self, "_jit_solve_loop"):
            # donate the state and u_save carries (their outputs replace
            # them); skip donation on CPU (no-op there, noisy warnings)
            donate = (0, 1) if jax.default_backend() != "cpu" else ()
            self._jit_solve_loop = self._pjit(self._solve_compiled_fn,
                                              donate_fn_args=donate)
        u_save = self.save_values_last_iter
        if u_save is None:
            # dummy placeholder with the right structure for the carry
            # (cached: it is never read — building it each call would cost
            # an eager gather dispatch per solve)
            u_save = getattr(self, "_u_save_dummy", None)
            if u_save is None:
                if self._condensed0:
                    # distinct buffer: the state and u_save are both donated
                    u_save = jax.tree_util.tree_map(jnp.copy, self.u[0])
                elif self.lvl_max > 1:
                    u_save = vector.take(self.u[0],
                                         jnp.asarray(self.levels[0].cpts))
                else:
                    u_save = jax.tree_util.tree_map(jnp.copy, self.u[0])
                self._u_save_dummy = u_save
        return self._jit_solve_loop, (self._get_state(), u_save,
                                      self.compiled_conv_aux_init())

    def lower_solve_compiled(self):
        """The fused device program of solve_compiled(), lowered for the
        current state and not run; ``.compile().memory_analysis()`` on it
        gives the program's device memory plan."""
        fn, args = self._solve_compiled_call()
        if isinstance(fn, functools.partial):    # runtime params bound first
            fn, args = fn.func, fn.args + args
        return fn.lower(*args)

    def solve_compiled(self) -> dict:
        """Solve with the entire iteration loop jitted on device."""
        self.log_info("Start solve (compiled loop)")
        fn, args = self._solve_compiled_call()
        runtime_solve_start = time.time()
        it, hist, state, u_save_out, conv_aux, u0_full = fn(*args)
        it = int(it)
        hist = np.asarray(hist)
        self._set_state(state)
        self._materialize_f0()
        if u0_full is not None:
            # fused materialization: stash the condensed carry for re-entry
            self._cnd_stash = (jax.tree_util.tree_leaves(u0_full), self.u[0])
            self.u[0] = u0_full
        self._compiled_conv_aux = conv_aux
        if self.conv_crit in (1, 3):
            self.save_values_last_iter = u_save_out
        elif self.save_values_last_iter is None:
            # donated dummy: the passthrough output is the live buffer now
            self._u_save_dummy = u_save_out
        self.conv = np.zeros(self.iter_max + 1)
        self.conv[1:it + 1] = hist[:it]
        self.solve_iter = it
        self.runtime_solve = time.time() - runtime_solve_start
        for k in range(it):
            self.log_info('{0: <7}'.format(f"iter {k + 1}") +
                          '{0: <32}'.format(f" | conv: {hist[k]}"))
        self.log_info(f"Solve took {self.runtime_solve} s")
        if self.output_fcn is not None and self.output_lvl in (1, 2):
            self.output_fcn(self)
        self.ouput_run_information()
        return {'conv': self.conv[np.where(self.conv != 0)], 'time_setup': self.runtime_setup,
                'time_solve': self.runtime_solve}

    # ------------------------------------------------------------------
    # observability: per-phase timings + profiler traces.  The reference
    # logs per-phase wall times at logging_lvl=10 inside its loops
    # (mgrit.py:301,333,344,370,...); under jit the phases fuse, so the
    # equivalent here times each phase as its own jitted program and
    # exposes a jax.profiler trace hook for the fused solve.
    # ------------------------------------------------------------------

    def profile_phases(self, repeats: int = 5) -> dict:
        """Time each solver phase per level (separately jitted); returns
        {phase_name: seconds} and logs at debug level."""
        results = {}
        self._sync_condensed0()
        state = self._get_state()
        u, v, g = state

        def _time(tag, fn, *args):
            out = fn(*args)
            jax.block_until_ready(out)
            t0 = time.time()
            for _ in range(repeats):
                out = fn(*args)
            jax.block_until_ready(out)
            results[tag] = (time.time() - t0) / repeats
            logging.debug(f"{tag}: {results[tag]:.6f} s")
            return out

        for lvl in range(self.lvl_max - 1):
            _time(f"f_relax[{lvl}]", self._pjit(lambda uu, lvl=lvl: self._f_relax(lvl, uu, g[lvl])), u[lvl])
            _time(f"c_relax[{lvl}]", self._pjit(lambda uu, lvl=lvl: self._c_relax(lvl, uu, g[lvl])), u[lvl])
            _time(f"fas_residual[{lvl}]",
                  self._pjit(lambda uu, lvl=lvl: self._fas_residual(lvl, uu, g[lvl], u[lvl + 1], g[lvl + 1])),
                  u[lvl])
        lvl = self.lvl_max - 1
        _time(f"forward_solve[{lvl}]", self._pjit(lambda uu: self._forward_solve(lvl, uu, g[lvl])), u[lvl])
        _time("convergence", self._jit_residual_conv, state)
        _time("full_iteration", self._jit_iter_rest, state)
        return results

    def solve_profiled(self, trace_dir: str) -> dict:
        """Run solve() under a jax.profiler trace (view with TensorBoard or
        xprof)."""
        with jax.profiler.trace(trace_dir):
            return self.solve()

    # ------------------------------------------------------------------
    # checkpoint / resume.  The reference has no built-in mechanism (its
    # examples np.save from output_fcn, SURVEY.md §5); here solver state is
    # a pytree of arrays, so checkpointing is one savez.
    # ------------------------------------------------------------------

    def save_checkpoint(self, path: str) -> None:
        """Save all level tubes + convergence history to an .npz file."""
        flat, treedef = jax.tree_util.tree_flatten(self._get_state())
        arrays = {f"leaf_{i}": np.asarray(x) for i, x in enumerate(flat)}
        arrays["conv"] = self.conv
        arrays["solve_iter"] = np.asarray(self.solve_iter)
        np.savez(path, **arrays)

    def load_checkpoint(self, path: str) -> None:
        """Restore solver state saved by save_checkpoint."""
        data = np.load(path)
        flat, treedef = jax.tree_util.tree_flatten(self._get_state())
        new_flat = [jnp.asarray(data[f"leaf_{i}"]) for i in range(len(flat))]
        self._set_state(jax.tree_util.tree_unflatten(treedef, new_flat))
        self.conv = data["conv"]
        self.solve_iter = int(data["solve_iter"])

    # ------------------------------------------------------------------
    # reporting (reference ouput_run_information [sic], mgrit.py:568-588)
    # ------------------------------------------------------------------

    def ouput_run_information(self) -> None:
        msg = ['Run parameter overview',
               '  ' + '{0: <25}'.format('time interval') + ' : ' + '[' + str(self.problem[0].t[0]) + ', ' + str(
                   self.problem[0].t[-1]) + ']',
               '  ' + '{0: <25}'.format('number of time points ') + ' : ' + str(len(self.problem[0].t)),
               '  ' + '{0: <25}'.format('max dt ') + ' : ' + str(
                   np.max(self.problem[0].t[1:] - self.problem[0].t[:-1])),
               '  ' + '{0: <25}'.format('number of levels') + ' : ' + str(self.lvl_max),
               '  ' + '{0: <25}'.format('coarsening factors') + ' : ' + str(self.m[:-1]),
               '  ' + '{0: <25}'.format('relaxation weight') + ' : ' + str(self.weight_c),
               '  ' + '{0: <25}'.format('cf_iter') + ' : ' + str(self.cf_iter[:self.lvl_max - 1]),
               '  ' + '{0: <25}'.format('nested iteration') + ' : ' + str(self.nes_it),
               '  ' + '{0: <25}'.format('cycle type') + ' : ' + str(self.cycle_type),
               '  ' + '{0: <25}'.format('stopping tolerance') + ' : ' + str(self.tol),
               '  ' + '{0: <25}'.format('convergence criterion') + ' : ' + str(self.conv_crit)]
        self.log_info(message='\n'.join(msg))
