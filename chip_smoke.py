"""Run the MGRIT solver's main paths once on the GPU and check every result.

Usage (from the root of a checkout, on a machine with an NVIDIA GPU):

    python chip_smoke.py          # one GPU: every single-device phase
    python chip_smoke.py --four   # four GPUs: the sharded time-parallel paths

Every phase runs in native float64 (the package default) through the public
entry points (``Mgrit.solve`` / ``Mgrit.solve_compiled``, ``ShardedMgrit``,
``ShardedAtMgrit``) and prints each comparison on one line with its
tolerance and the reason for it.  The script exits non-zero, and prints no
result line, when JAX finds no GPU, when it does not run from a checkout, or
when any phase fails.  Its last line on success is

    {"ok": true, "device": {"platform": "gpu", "kind": "...", "count": N}}

with N the number of GPUs the phases drove: 1, or 4 under --four.

Phases (sizes are the defaults; the tests call each phase at a tiny size):

* goldens   -- README Dahlquist history via solve(); Heat2D base65 (65^2,
               nt=4097, 4 levels, m=4) via solve_compiled() against the
               reference's measured history in BENCH_BASELINE_CACHE.json.
* toms      -- TOMS example 3 as published: Heat2D 129^2, nt=2^14+1,
               5 levels 32/16/4/4, forced rhs, to tol=1e-10, against
               sequential time stepping of the same stepper on the GPU.
* executors -- time-independent-rhs Heat2D 129^2, nt=2^14+1, spectral
               basis: condensed level-0 carry, full tube, and ShardedMgrit
               on a one-device mesh must walk one residual history.
* nonlinear -- Allen-Cahn IMEX 128^2, nt=4097, 3 levels 8/8 (complex
               dense-DFT solves), plus a short fully implicit run (Newton
               with preconditioned CG), against sequential stepping.
* prefix    -- Dahlquist with a 65537-point coarsest level: the
               parallel-prefix coarsest solve against the sequential scan.
* dd        -- double-double: README Dahlquist golden, Ozaki matmul_dd
               against an extended-precision product, exact two_prod.
* four      -- (--four only) ShardedMgrit on 4x1 and 2x2 meshes,
               Mgrit(mesh=4x1) and ShardedAtMgrit(k=16) on the TOMS
               hierarchy, each against ShardedMgrit on one device.
"""

from __future__ import annotations

import argparse
import importlib
import io
import json
import logging
import os
import subprocess
import sys
import time
import traceback

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
QUIET = logging.WARNING

# README quickstart (Dahlquist nt=101, 2 levels, m=2, tol=1e-10): the
# reference's published history, README.md.
README_HISTORY = np.array([7.186185937031941e-05, 1.2461067076355103e-06,
                           2.1015566145245807e-08, 3.144127445017594e-10,
                           3.975214076032893e-12])

# Allen-Cahn MGRIT-vs-sequential max |diff| after the phase's iteration
# counts, measured with this script's nonlinear() at nx=32 on the CPU
# (float64).  The GPU run at full width must stay within 10x of it.
NONLINEAR_CPU_DIFF = {"IMEX": 3.8080551681973773e-06,
                      "IMPL": 1.683098949101236e-08}


class PhaseFailed(Exception):
    """One or more comparisons of a phase missed their tolerance."""


class Report:
    """Prints one line per comparison and collects the failures."""

    def __init__(self, phase: str):
        self.phase = phase
        self.failed = []

    def info(self, msg: str) -> None:
        print(f"[{self.phase}] {msg}", flush=True)

    def check(self, what: str, value: float, bound: float, reason: str) -> bool:
        ok = bool(np.isfinite(value) and value <= bound)
        self.info(f"{what}: {value:.3e} <= {bound:.3e} "
                  f"{'ok' if ok else 'FAILED'} ({reason})")
        if not ok:
            self.failed.append(what)
        return ok

    def done(self) -> None:
        if self.failed:
            raise PhaseFailed(f"{self.phase}: {', '.join(self.failed)}")


def max_rel(a, b) -> float:
    """max |a - b| / |b| over two histories; inf when the lengths differ."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    if a.shape != b.shape:
        return float("inf")
    return float(np.max(np.abs(a - b) / np.abs(b))) if b.size else 0.0


def fmt_hist(conv) -> str:
    return "[" + ", ".join(f"{c:.6e}" for c in conv) + "]"


def golden_check(rep: Report, what: str, conv, golden, rtol_tail: float,
                 rtol_head: float = None) -> None:
    """History against a golden one: rtol_head on iterations above 1e-10,
    rtol_tail below it (the rounding floor, where summation order differs
    between devices)."""
    conv, golden = np.asarray(conv), np.asarray(golden)
    rep.info(f"{what} history {fmt_hist(conv)}")
    rep.check(f"{what} iteration count difference",
              abs(len(conv) - len(golden)), 0, "same algorithm, same exit")
    if len(conv) != len(golden):
        return
    head = golden > 1e-10
    if rtol_head is not None and head.any():
        rep.check(f"{what} rel. diff, iterations > 1e-10",
                  max_rel(conv[head], golden[head]), rtol_head,
                  "f64 rounding only; far above the floor")
    tail = ~head if rtol_head is not None else np.ones_like(head)
    if tail.any():
        rep.check(f"{what} rel. diff" + (", tail < 1e-10" if rtol_head else ""),
                  max_rel(conv[tail], golden[tail]), rtol_tail,
                  "near the rounding floor / reference-measured history")


def history_check(rep: Report, what: str, conv, ref, floor: float = 0.0,
                  rtol: float = 1e-9) -> None:
    """Two runs of one algorithm that differ only in rounding: the same
    iteration count, and histories within rtol relative -- plus `floor`
    absolute, the rounding level of the residual (residual_floor), where a
    comparison of the solutions stands beside this one."""
    conv, ref = np.asarray(conv), np.asarray(ref)
    rep.check(f"{what} iteration count difference", abs(len(conv) - len(ref)),
              0, "same algorithm, same exit")
    if conv.shape != ref.shape:
        return
    if not floor:
        rep.check(f"{what} history max rel. diff", max_rel(conv, ref), rtol,
                  "same algorithm in f64, only rounding differs")
        return
    rep.info(f"{what} history max rel. diff {max_rel(conv, ref):.3e}")
    rep.check(f"{what} history max |diff| / ({rtol:g}*|conv| + "
              f"{floor:.2e})",
              float(np.max(np.abs(conv - ref) / (rtol * np.abs(ref) + floor))),
              1.0, "same algorithm in f64; rounding level of the residual")


def residual_floor(u_c, nx: int) -> float:
    """Rounding level of a Heat2D residual norm over the C-point values u_c:
    each residual entry subtracts two O(|u_i|) states, one from a step whose
    dense transforms sum nx terms per axis, so it rounds at about
    sqrt(nx) * eps * |u_i| (a random-walk sum); over the C-points that is
    sqrt(nx) * eps * ||u_c||_2."""
    u_c = np.asarray(u_c, np.float64)
    return float(np.sqrt(nx) * np.finfo(np.float64).eps
                 * np.linalg.norm(u_c.ravel()))


def sequential_tube(app):
    """All time points of plain sequential stepping of `app`'s stepper, as
    one compiled lax.scan: the reference MGRIT must reproduce."""
    import jax
    import jax.numpy as jnp

    t = jnp.asarray(app.t)

    @jax.jit
    def run(u0):
        def body(u, i):
            un = app.step(u, t[i - 1], t[i])
            return un, un

        _, ys = jax.lax.scan(body, u0, jnp.arange(1, t.shape[0]))
        return jnp.concatenate([u0[None], ys])

    return run(jnp.asarray(app.vector_t_start))


def fine_steps(solver, iterations: int) -> int:
    """Fine-level steps the algorithm performs (bench.py's accounting)."""
    import bench
    return sum(bench.count_fine_steps_per_iter(solver, k == 0)
               for k in range(iterations))


def toms_problem(nx, nt, coarsening):
    """TOMS example 3 hierarchy (examples/toms/example_3_spacetime.py)."""
    ex = importlib.import_module("examples.toms.example_3_spacetime")
    return ex, ex.build(nt=nt, coarsening=list(coarsening), nx=nx)


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def goldens(heat_nx=65, heat_nt=4097, heat_ms=(4, 4, 4)):
    from pymgrit_tpu import Dahlquist, Mgrit, simple_setup_problem
    import bench

    rep = Report("goldens")
    problem = simple_setup_problem(
        problem=Dahlquist(t_start=0, t_stop=5, nt=101), level=2, coarsening=2)
    info = Mgrit(problem=problem, tol=1e-10, logging_lvl=QUIET).solve()
    golden_check(rep, "Dahlquist README", info["conv"], README_HISTORY,
                 rtol_tail=1e-4, rtol_head=1e-6)

    with open(os.path.join(HERE, "BENCH_BASELINE_CACHE.json")) as f:
        ref = json.load(f)["base65"]
    problem = bench.build_problem(nx=heat_nx, ny=heat_nx, nt=heat_nt,
                                  ms=list(heat_ms))
    mgrit = Mgrit(problem=problem, tol=1e-7, max_iter=10, logging_lvl=QUIET)
    info = mgrit.solve_compiled()
    rep.info(f"base65 time_setup {info['time_setup']:.3f}s "
             f"time_solve {info['time_solve']:.3f}s (first call, with compile)")
    golden_check(rep, "Heat2D base65 vs reference", info["conv"], ref["conv"],
                 rtol_tail=1e-4)
    rep.done()


def toms(nx=129, nt=2 ** 14 + 1, coarsening=(32, 16, 4, 4), tol=1e-10):
    import jax
    import jax.numpy as jnp
    from pymgrit_tpu import Mgrit

    rep = Report("toms")
    ex, problem = toms_problem(nx, nt, coarsening)
    rep.info(f"Heat2D {nx}x{nx}, nt={nt}, {len(problem)} levels "
             f"{'/'.join(map(str, coarsening))}, tol={tol:g}, float64")
    mgrit = Mgrit(problem=problem, tol=tol, max_iter=50, logging_lvl=QUIET)
    initial = io.BytesIO()
    mgrit.save_checkpoint(initial)
    info = mgrit.solve_compiled()
    conv = info["conv"]
    rep.info(f"iterations {len(conv)}, history {fmt_hist(conv)}")
    rep.info(f"time_setup {info['time_setup']:.3f}s, time_solve "
             f"{info['time_solve']:.3f}s (first call, with compile)")
    t0 = time.time()
    mem = mgrit.lower_solve_compiled().compile().memory_analysis()
    rep.info(f"solve program memory_analysis ({time.time() - t0:.1f}s): {mem}")
    rep.check("final residual", conv[-1], tol, "solve must converge")

    u_mgrit = mgrit.u[0][:nt]
    t0 = time.time()
    u_seq = jax.block_until_ready(sequential_tube(problem[0]))
    rep.info(f"sequential stepping: {time.time() - t0:.3f}s (with compile)")
    diff = float(jnp.max(jnp.abs(u_mgrit - u_seq)))
    rep.check(f"max |MGRIT - sequential| over {nt} time points", diff, 1e-8,
              "residual tol 1e-10; |diff|/residual = 0.033 measured at "
              "65^2, nt=1025 on the CPU")
    x = jnp.asarray(problem[0].x)
    tt = jnp.asarray(problem[0].t)
    exact = (jnp.sin(jnp.pi * ex.FREQ * x)[:, None]
             * jnp.sin(jnp.pi * ex.FREQ * x)[None, :])[None] \
        * jnp.cos(tt)[:, None, None]
    err_m = float(jnp.max(jnp.abs(u_mgrit - exact)))
    err_s = float(jnp.max(jnp.abs(u_seq - exact)))
    rep.info(f"error vs u_exact: MGRIT {err_m:.6e}, sequential {err_s:.6e}")
    rep.check("|error(MGRIT) - error(sequential)|", abs(err_m - err_s), 1e-8,
              "both discretise the same problem; bounded by the diff above")
    del u_mgrit, u_seq, exact

    # warm re-solve from the same initial state: fine steps/s without compile
    initial.seek(0)
    mgrit.load_checkpoint(initial)
    del initial
    info2 = mgrit.solve_compiled()
    steps = fine_steps(mgrit, len(info2["conv"]))
    rep.info(f"warm re-solve: time_solve {info2['time_solve']:.4f}s, "
             f"{steps} fine steps, {steps / info2['time_solve']:.1f} fine "
             f"steps/s (information, not a benchmark)")
    rep.check("warm re-solve history rel. diff", max_rel(info2["conv"], conv),
              1e-9, "same program, same input")
    rep.done()


def executors(nx=129, nt=2 ** 14 + 1, ms=(32, 16, 4, 4), iterations=5):
    from pymgrit_tpu import Mgrit
    from pymgrit_tpu.parallel.shard_solver import ShardedMgrit
    from pymgrit_tpu.parallel.sharding import make_time_space_mesh
    import bench
    import jax

    rep = Report("executors")

    def build():
        return bench.build_problem(nx=nx, ny=nx, nt=nt, ms=list(ms),
                                   basis="spectral")

    kw = dict(tol=0.0, max_iter=iterations, logging_lvl=QUIET)
    runs = {}
    m = Mgrit(problem=build(), **kw)
    rep.check("condensed carry declined", float(not m._condensed0), 0.0,
              "the time-independent spectral problem takes the condensed path")
    runs["condensed"] = m.solve_compiled()
    del m
    runs["full tube"] = Mgrit(problem=build(), condensed=False,
                              **kw).solve_compiled()
    mesh = make_time_space_mesh(1, 1, devices=jax.devices()[:1])
    runs["ShardedMgrit 1 device"] = ShardedMgrit(
        problem=build(), mesh=mesh, **kw).solve_compiled()
    for name, info in runs.items():
        rep.info(f"{name}: time_setup {info['time_setup']:.3f}s, time_solve "
                 f"{info['time_solve']:.3f}s (with compile), history "
                 f"{fmt_hist(info['conv'])}")
    ref = runs["condensed"]["conv"]
    for name in ("full tube", "ShardedMgrit 1 device"):
        history_check(rep, f"{name} vs condensed", runs[name]["conv"], ref)
    rep.done()


def _allen_cahn(nx, nt, t_stop, ms, method):
    from pymgrit_tpu import AllenCahn

    a0 = AllenCahn(nx=nx, method=method, t_start=0, t_stop=t_stop, nt=nt)
    problem, stride = [a0], 1
    for m in ms:
        stride *= m
        problem.append(AllenCahn(nx=nx, method=method,
                                 t_interval=a0.t[::stride]))
    return problem


def nonlinear(nx=128, nt=4097, t_stop=0.032, ms=(8, 8), iterations=5,
              impl_nt=257, impl_t_stop=0.002, impl_ms=(8,), impl_iterations=3):
    import jax.numpy as jnp
    from pymgrit_tpu import Mgrit

    rep = Report("nonlinear")
    diffs = {}
    for method, size, stop, levels, iters in (
            ("IMEX", nt, t_stop, ms, iterations),
            ("IMPL", impl_nt, impl_t_stop, impl_ms, impl_iterations)):
        problem = _allen_cahn(nx, size, stop, levels, method)
        mgrit = Mgrit(problem=problem, tol=0.0, max_iter=iters,
                      logging_lvl=QUIET)
        info = mgrit.solve_compiled()
        rep.info(f"AllenCahn {method} {nx}^2 nt={size} levels "
                 f"{'/'.join(map(str, levels))}: time_setup "
                 f"{info['time_setup']:.3f}s, time_solve "
                 f"{info['time_solve']:.3f}s (with compile), history "
                 f"{fmt_hist(info['conv'])}")
        diff = float(jnp.max(jnp.abs(mgrit.u[0][:size]
                                     - sequential_tube(problem[0]))))
        diffs[method] = diff
        cpu = NONLINEAR_CPU_DIFF[method]
        rep.check(f"{method} max |MGRIT({iters} it) - sequential|", diff,
                  10 * cpu, f"10x the CPU value {cpu:.3e} at nx=32: "
                  "unconverged MGRIT error, not rounding")
    rep.done()
    return diffs


def prefix(nt=2 ** 19 + 1, t_stop=13107.2, iterations=3):
    from pymgrit_tpu import Dahlquist, Mgrit

    rep = Report("prefix")

    def build():
        d0 = Dahlquist(t_start=0, t_stop=t_stop, nt=nt)
        return [d0, Dahlquist(t_interval=d0.t[::8])]

    runs = {}
    for name, kw in (("scan", {}), ("prefix", {"coarsest_prefix": True})):
        info = Mgrit(problem=build(), tol=0.0, max_iter=iterations,
                     logging_lvl=QUIET, **kw).solve_compiled()
        runs[name] = info["conv"]
        rep.info(f"coarsest {name} (nt_c={(nt - 1) // 8 + 1}): time_solve "
                 f"{info['time_solve']:.3f}s (with compile), history "
                 f"{fmt_hist(info['conv'])}")
    rep.check("prefix vs scan history rel. diff",
              max_rel(runs["prefix"], runs["scan"]), 1e-9,
              "exact reassociation of the same affine chain")
    rep.done()


def _adversarial(rng, shape, row_scaled, spread=8):
    """DD operands with all-ones mantissas in hi and lo (every Ozaki piece
    is 127, so K=1024 piece products sum to just under 2^24) and mixed
    exponents: a scale of 2^-30..2^30 per row (row_scaled) or per column,
    times a spread of 2^-spread..1 inside it.  The componentwise bound
    holds for spreads up to 2^8 inside a row of A or a column of B; with
    2^40 it is missed (measured on the CPU), as the scheme normalises
    whole rows and columns."""
    outer = rng.integers(-30, 31, size=(shape[0], 1) if row_scaled
                         else (1, shape[1]))
    e = outer + rng.integers(-spread, 1, size=shape)
    hi = rng.choice([-1.0, 1.0], size=shape) * (2.0 - 2.0 ** -23) * np.exp2(e)
    lo = rng.choice([-1.0, 1.0], size=shape) * (2.0 - 2.0 ** -23) * np.exp2(e - 26)
    return hi + lo


def dd(ks=(127, 1024, 4096), mn=256, n_pairs=2 ** 20, seed=0):
    import jax
    from pymgrit_tpu import Dahlquist, Mgrit, simple_setup_problem
    from pymgrit_tpu.ops import dd as ddm
    from pymgrit_tpu.ops.ozaki import matmul_dd

    rep = Report("dd")
    problem = simple_setup_problem(
        problem=Dahlquist(t_start=0, t_stop=5, nt=101, precision="dd"),
        level=2, coarsening=2)
    info = Mgrit(problem=problem, tol=1e-10, logging_lvl=QUIET).solve()
    golden_check(rep, "Dahlquist DD README", info["conv"], README_HISTORY,
                 rtol_tail=1e-4)

    if np.finfo(np.longdouble).nmant < 63:
        raise PhaseFailed("numpy longdouble has no extended precision here")
    rng = np.random.default_rng(seed)
    mm = jax.jit(lambda a, b: matmul_dd(a, b))
    for k in ks:
        for kind in ("random", "adversarial"):
            if kind == "random":
                a64 = rng.standard_normal((mn, k))
                b64 = rng.standard_normal((k, mn))
            else:
                a64 = _adversarial(rng, (mn, k), row_scaled=True)
                b64 = _adversarial(rng, (k, mn), row_scaled=False)
            a, b = ddm.from_f64(a64), ddm.from_f64(b64)
            # the operands' exact values (hi + lo is exact in f64) and their
            # product in 64-bit-significand arithmetic: its own rounding,
            # ~k * 2^-64, stays far below the bound under test
            ax = np.asarray(a.hi, np.longdouble) + np.asarray(a.lo, np.longdouble)
            bx = np.asarray(b.hi, np.longdouble) + np.asarray(b.lo, np.longdouble)
            exact = ax @ bx
            scale = np.abs(ax) @ np.abs(bx)
            c = mm(a, b)
            got = np.asarray(c.hi, np.longdouble) + np.asarray(c.lo, np.longdouble)
            ratio = float(np.max(np.abs(got - exact) / scale)) / 2.0 ** -47
            rep.check(f"matmul_dd K={k} {kind} {mn}x{k}@{k}x{mn}: max "
                      "|C - AB| / (|A||B|) in units of 2^-47", ratio, 1.0,
                      "Ozaki componentwise bound, docs/precision.md")

    e = rng.integers(-20, 21, size=(2, n_pairs))
    x = (rng.uniform(1.0, 2.0, size=(2, n_pairs)) * np.exp2(e)
         * rng.choice([-1.0, 1.0], size=(2, n_pairs))).astype(np.float32)
    p, err = jax.jit(ddm.two_prod)(x[0], x[1])
    exact = x[0].astype(np.float64) * x[1].astype(np.float64)
    got = np.asarray(p, np.float64) + np.asarray(err, np.float64)
    rep.check(f"two_prod inexact pairs of {n_pairs}",
              float(np.count_nonzero(got != exact)), 0.0,
              "error-free transform: p + e == a*b exactly")
    rep.done()


def four(nx=129, nt=2 ** 14 + 1, coarsening=(32, 16, 4, 4), iterations=5,
         k=16, space_nx=128, devices=None):
    """The TOMS hierarchy on four devices, each solve against ShardedMgrit on
    one device at the same width.  The 2x2 (time x space) mesh runs at
    space_nx^2, an even width, so that Heat2D's space axis splits over
    'space' (an odd width stays replicated there).  Mgrit(mesh=...) is the
    same algorithm in the GSPMD executor, and k covers the coarsest level,
    so ShardedAtMgrit truncates nothing and walks ShardedMgrit's
    iterations."""
    import gc
    import jax
    from pymgrit_tpu import Mgrit
    from pymgrit_tpu.parallel.shard_solver import ShardedAtMgrit, ShardedMgrit
    from pymgrit_tpu.parallel.sharding import make_time_space_mesh

    rep = Report("four")
    coarsest = (nt - 1) // int(np.prod(coarsening)) + 1
    if k < coarsest:
        raise ValueError(f"k={k} truncates the {coarsest}-point coarsest "
                         "level; the one-device reference truncates nothing")
    devices = list(devices if devices is not None else jax.devices()[:4])
    kw = dict(tol=0.0, max_iter=iterations, logging_lvl=QUIET)

    def sharded(mesh, width=nx, at_k=None):
        problem = toms_problem(width, nt, coarsening)[1]
        s = (ShardedAtMgrit(at_k, problem=problem, mesh=mesh, **kw)
             if at_k else ShardedMgrit(problem=problem, mesh=mesh, **kw))
        return s.solve_compiled(), s.fine_solution()

    def gspmd(mesh):
        m = Mgrit(problem=toms_problem(nx, nt, coarsening)[1], mesh=mesh, **kw)
        return m.solve_compiled(), m.u[0][:nt]

    def run_host(name, run):
        t0 = time.time()
        info, u = run()
        rep.info(f"{name}: {time.time() - t0:.1f}s with set-up and compile, "
                 f"time_solve {info['time_solve']:.3f}s, history "
                 f"{fmt_hist(info['conv'])}")
        out = info["conv"], np.asarray(u)
        del u
        gc.collect()     # the solver's device state goes before the next one
        return out

    mesh41 = make_time_space_mesh(4, 1, devices=devices)
    mesh22 = make_time_space_mesh(2, 2, devices=devices)
    cases = (
        ("ShardedMgrit 4x1", nx, lambda: sharded(mesh41)),
        (f"ShardedMgrit 2x2 at {space_nx}^2", space_nx,
         lambda: sharded(mesh22, width=space_nx)),
        ("Mgrit(mesh=4x1)", nx, lambda: gspmd(mesh41)),
        (f"ShardedAtMgrit k={k} 4x1", nx, lambda: sharded(mesh41, at_k=k)),
    )
    # the multi-device solves first, so that each device's peak memory shows
    # what its own shard took before the one-device references run
    results = {name: run_host(name, run) for name, _, run in cases}
    stats = [d.memory_stats() for d in devices]
    if all(stats):
        rep.info("peak_bytes_in_use per device after the multi-device "
                 "solves: " + ", ".join(f"{d.id}: {s['peak_bytes_in_use']}"
                                        for d, s in zip(devices, stats)))
    mesh1 = make_time_space_mesh(1, 1, devices=devices[:1])
    refs = {}
    for name, width, _ in cases:
        ref_name = f"ShardedMgrit 1x1 at {width}^2"
        if width not in refs:
            refs[width] = run_host(ref_name,
                                   lambda: sharded(mesh1, width=width))
        conv_ref, u_ref = refs[width]
        conv, u = results[name]
        history_check(rep, f"{name} vs {ref_name}", conv, conv_ref,
                      residual_floor(u_ref[::coarsening[0]], width))
        rel = float(np.max(np.abs(u - u_ref)) / np.max(np.abs(u_ref)))
        rep.check(f"{name} vs {ref_name} fine tube max rel. diff", rel, 1e-12,
                  "same algorithm in f64; shards change rounding only")
    rep.done()


SINGLE_PHASES = (goldens, toms, executors, nonlinear, prefix, dd)


def _nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-GPU sharded paths")
    args = ap.parse_args(argv)

    if not os.path.isdir(os.path.join(HERE, "pymgrit_tpu")):
        print("chip_smoke: run from a checkout of the repository "
              "(pymgrit_tpu/ not found beside this script)", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import jax

    devices = jax.devices()
    dev = devices[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: needs a GPU; JAX found {dev.platform} devices",
              file=sys.stderr)
        return 2
    need = 4 if args.four else 1
    if len(devices) < need:
        print(f"chip_smoke: needs {need} GPUs, found {len(devices)}",
              file=sys.stderr)
        return 2

    import pymgrit_tpu  # noqa: F401  (enables float64)
    from pymgrit_tpu.utils.compile_cache import configure_compile_cache

    if not jax.config.jax_enable_x64:
        print("chip_smoke: float64 is disabled (PYMGRIT_TPU_NO_X64 is set)",
              file=sys.stderr)
        return 2
    cache_dir = configure_compile_cache()
    print(_nvidia_smi())
    print(f"device_kind: {dev.device_kind}")
    print(f"device count: {len(devices)}")
    print(f"jax {jax.__version__}")
    print(f"compile cache: {cache_dir}")

    phases = (four,) if args.four else SINGLE_PHASES
    failed = []
    for phase in phases:
        t0 = time.time()
        try:
            phase()
            status = "ok"
        except Exception:
            traceback.print_exc()
            failed.append(phase.__name__)
            status = "FAILED"
        peak = dev.memory_stats()["peak_bytes_in_use"]
        print(f"[{phase.__name__}] {status} in {time.time() - t0:.1f}s; "
              f"peak_bytes_in_use so far {peak}", flush=True)
        jax.clear_caches()
    if failed:
        print(f"chip_smoke: failed phases: {', '.join(failed)}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind, "count": need}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
