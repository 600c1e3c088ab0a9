"""Benchmark: MGRIT throughput + precision on one device vs the reference.

Primary metric (publication scale): the TOMS example-3 configuration —
2D heat 129x129, nt = 2^14+1 = 16385, 5-level hierarchy with coarsening
32/16/4/4 (reference examples/toms/example_3_petsc.py) — fine-level Phi
evaluations per second during the solve, on one chip.

vs_baseline = our steps/sec divided by the reference PyMGRIT's steps/sec on
this machine's CPU, DIRECTLY MEASURED at the full TOMS scale (nt=16385,
5-level 32/16/4/4, 1 iteration = 49k fine steps in 79 min; cached as
toms129_fullnt in BENCH_BASELINE_CACHE.json).  The nt-extrapolated
measurement (reduced nt, per-step spsolve cost is nt-independent) is kept
as a cross-check — it predicted 10.94 vs 10.37 measured, 5% conservative.

Secondary rows (extras):
  base65     — round-1 comparable config (65x65, nt=4097, 4-level m=4)
  spatial65  — BASELINE.json config 3: same but with 2D spatial coarsening
               65^2 -> 33^2 -> 17^2 -> 9^2 (GridTransferHeat2D)
  dd65       — double-double precision mode on the SAME chip: iterations &
               residual tail at tol=1e-10 (fp64-class floors from f32
               hardware; ops/dd.py + ops/ozaki.py) + its throughput cost
  atmgrit    — distance-k coarsest-level wall-clock vs the sequential scan
               in BOTH regimes (round-4): an equal-accuracy config where the
               truncated window reproduces the sequential histories (the
               algorithm's design regime) and the round-3 truncation-limited
               heat config kept as an honest negative
  toms257    — 257^2 physical-basis row at the FULL nt=16385 (round-4:
               tables as runtime operands un-broke the AOT compile)
  allen_cahn — nonlinear (IMEX) at-scale row vs measured reference
  ragged     — non-uniform-coarsening hierarchy at a non-toy nt: shard_map
               general path vs global-view executor
  hbm        — measured copy bandwidth + algorithmic-minimum bytes moved
               per solve -> achieved GB/s and % of the copy roofline

Measurement protocol:

* every timed row = warm `solve_compiled()` + N_TIMED timed re-solves;
  rows report the MEDIAN plus [min, max] spread.
* the HEADLINE is the steady-state device-amortized rate: median time of
  a K2=205-iteration solve minus median time of the K1=5-iteration
  solve, divided into the fine steps of the extra 200 iterations, taken
  as the MEDIAN of 3 interleaved timing rounds (see AMORT_K2/AMORT_ROUNDS).
  The fixed launch/output cost and the one-time materialization cancel in
  the difference, so the number measures what the device sustains.
  End-to-end medians are reported alongside.
* dd_toms129 (round-5): the equal-accuracy row — precision='dd' at the
  FULL TOMS config to tol=1e-10, the only apples-to-apples column
  against the reference's fp64 runs (reference heat/heat_2d.py:322-366,
  README.rst:105-109 tolerance class).

Writes the full result to results/bench.json; the FINAL stdout line is
a compact driver-parseable summary JSON:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N, ...}
"""

import json
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
CACHE = os.path.join(REPO, "BENCH_BASELINE_CACHE.json")

CONFIGS = {
    "toms129": dict(nx=129, ny=129, nt=2 ** 14 + 1, ms=[32, 16, 4, 4],
                    max_iter=5),
    "base65": dict(nx=65, ny=65, nt=4097, ms=[4, 4, 4], max_iter=5),
}

N_TIMED = 5          # timed re-solves per row (median + spread reported)
# Long-solve iteration count for the amortized diff.  The headline is
# (steps(K2)-steps(K1)) / (t_median(K2)-t_median(K1)); K2=205 makes the
# time difference long against timing jitter, and the headline takes the
# MEDIAN of AMORT_ROUNDS interleaved (K1, K2) timing rounds, which rejects
# a round that lands in a slow phase of the machine.
AMORT_K2 = 205
AMORT_ROUNDS = 3


def timed_median(m, fetch_leaf, n=N_TIMED):
    """Warm solver `m` is re-solved n times; returns (median, min, max,
    times).  Each re-solve resets the recorded history and blocks on a
    result leaf (whole-program end-to-end timing)."""
    import jax
    import numpy as _np
    times = []
    for _ in range(n):
        m.conv = _np.zeros(m.iter_max + 1)
        t0 = time.time()
        m.solve_compiled()
        jax.block_until_ready(fetch_leaf())
        times.append(time.time() - t0)
    return statistics.median(times), min(times), max(times), times


def amortized_pair(row1, row2):
    """Steady-state device rate from two rows of the same config at
    different iteration counts: the fixed launch/output cost and the
    one-time materialization/setup cancel in the difference."""
    d_steps = row2["steps"] - row1["steps"]
    d_t = row2["solve_time_s"] - row1["solve_time_s"]
    if d_t <= 0:
        return None
    out = {
        "iters": [row1["iterations"], row2["iterations"]],
        "delta_steps": d_steps,
        "delta_time_s": round(d_t, 4),
        "device_steps_per_sec": round(d_steps / d_t, 2),
        "device_time_per_iteration_ms": round(
            1e3 * d_t / (row2["iterations"] - row1["iterations"]), 3),
    }
    b1, b2 = (r.get("hbm_gbps_achieved") for r in (row1, row2))
    if b1 and b2:
        d_b = (b2 * row2["solve_time_s"] - b1 * row1["solve_time_s"])
        out["device_hbm_gbps_achieved"] = round(d_b / d_t, 1)
    return out


def amortized_robust(row1, mg1, row2, mg2, rounds=None, gap_s=45):
    """Median-of-rounds amortized rate for the HEADLINE pair.

    Re-times both warm solvers in `rounds` interleaved timing rounds with
    `gap_s` seconds between them (round 0 reuses the rows' own medians)
    and returns the round with the MEDIAN device rate, annotated with all
    per-round rates.  The temporal spread is the point: a slow phase of the
    machine inflates every sample taken inside it, which back-to-back
    medians cannot reject."""
    rounds = rounds or AMORT_ROUNDS
    pairs = []
    first = amortized_pair(row1, row2)
    if first:
        pairs.append(first)
    for _ in range(rounds - 1):
        time.sleep(gap_s)
        r1 = dict(row1, solve_time_s=timed_median(mg1, lambda: mg1.u[0])[0])
        r2 = dict(row2, solve_time_s=timed_median(mg2, lambda: mg2.u[0])[0])
        p = amortized_pair(r1, r2)
        if p:
            pairs.append(p)
    if not pairs:
        return None
    pairs.sort(key=lambda p: p["device_steps_per_sec"])
    med = dict(pairs[len(pairs) // 2])
    med["rounds_device_steps_per_sec"] = [
        p["device_steps_per_sec"] for p in pairs]
    return med


def build_problem(nx, ny, nt, ms, precision=None, spatial=None, basis='physical'):
    """Heat2D hierarchy; ms = per-level-pair time coarsening factors;
    spatial = optional list of per-level (nx, ny) for spatial coarsening."""
    import numpy as np
    import jax.numpy as jnp
    from pymgrit_tpu import Heat2D

    def rhs(x, y, t):
        return jnp.sin(jnp.pi * x) * jnp.sin(jnp.pi * y) * jnp.ones_like(t * x * y)

    def init_cond(x, y):
        return np.sin(np.pi * x) * np.sin(np.pi * y)

    t = np.linspace(0, 1, nt)
    problem = []
    stride = 1
    for lvl in range(len(ms) + 1):
        nxl, nyl = (spatial[lvl] if spatial is not None else (nx, ny))
        problem.append(Heat2D(x_start=0, x_end=1, y_start=0, y_end=1,
                              nx=nxl, ny=nyl, a=1.0, rhs=rhs,
                              init_cond=init_cond, t_interval=t[::stride],
                              precision=precision, basis=basis))
        if lvl < len(ms):
            stride *= ms[lvl]
    return problem


def count_fine_steps_per_iter(mgrit, first):
    """Fine-level Phi evaluations per MGRIT iteration (same accounting as the
    instrumented reference run in tools/bench_reference.py).

    METRIC SEMANTICS: this counts the fine steps the ALGORITHM performs —
    the work a user gets done per second — independent of how an executor
    realizes them.  Closed-form paths (the relax_interval hook, the
    condensed carry) produce the same mathematical updates without
    evaluating each Phi individually; their rows therefore divide the same
    step count by a smaller wall-clock.  Executor-vs-executor columns (e.g.
    toms129_fulltube_* vs the condensed headline) compare delivery speed
    of identical results, not identical instruction streams."""
    info = mgrit.levels[0]
    nf = info.fpts.size
    nc1 = info.cpts.size - 1
    steps = 0
    if first:
        steps += nf                      # initial F-relax (iteration 1 only)
    steps += mgrit.cf_iter[0] * (nc1 + nf)   # CF-relaxations
    steps += nc1                         # FAS residual restriction
    steps += nf                          # post-correction F-relax
    steps += nc1                         # convergence residual
    return steps


def measure_copy_bw_gbps():
    """Achievable device-memory copy bandwidth, measured differentially
    (R2 - R1 chained 1 GB elementwise passes inside one program, so the
    fixed per-launch/output overhead cancels)."""
    import jax
    import jax.numpy as jnp

    a = jnp.ones((256, 1024, 1024))          # 1 GB f32

    def chain(reps):
        @jax.jit
        def f(x):
            def body(i, b):
                return b + (1.0 + i * 1e-12)   # i-dependent: not foldable
            return jax.lax.fori_loop(0, reps, body, x)
        f(a).block_until_ready()
        t0 = time.time()
        float(f(a)[0, 0, 0])                  # value fetch forces completion
        return time.time() - t0

    r1, r2 = 8, 40
    t1 = min(chain(r1) for _ in range(2))
    t2 = min(chain(r2) for _ in range(2))
    moved = 2.0 * a.size * 4 * (r2 - r1)      # read + write per pass
    return moved / max(t2 - t1, 1e-9) / 1e9


def min_hbm_bytes_per_solve(mgrit, iters):
    """Algorithmic-minimum HBM bytes (reads+writes) the solve must move,
    from the static level structure — uniform hierarchies, identity
    transfer.  Counts tube traffic only (time-value/table traffic is
    O(levels * state) smaller); intermediates XLA can fuse away are NOT
    counted, so achieved/minimum <= 1 measures executor efficiency against
    the HBM roofline (VERDICT r3 weak-#1).
    """
    import numpy as _np

    def leaf_bytes(app):
        tmpl = app.vector_template
        return sum(_np.asarray(l).size * 4
                   for l in jax.tree_util.tree_leaves(tmpl))
    import jax

    L = mgrit.lvl_max
    total = 0.0
    cond = getattr(mgrit, "_condensed0", False)
    for it in range(iters):
        for lvl in range(L - 1):
            info = mgrit.levels[lvl]
            S = leaf_bytes(mgrit.problem[lvl])
            m = info.m
            J = (info.nt - 1) // m
            cf = mgrit.cf_iter[lvl]
            n_f_sweeps = (1 if (it == 0 and lvl == 0) else (0 if lvl == 0 else 1)) + cf + 1
            if lvl == 0 and cond:
                # C-relax sweeps + FAS + conv: read J seeds + write/read J
                total += (cf + 2) * (2 * J) * S
                total += 2 * J * S            # error correction
            else:
                total += n_f_sweeps * (J + J * (m - 1)) * S   # F-relax
                total += cf * 2 * J * S                        # C-relax
                total += 2 * J * S                             # FAS reads
                total += 2 * J * S                             # correction
                if lvl == 0:
                    total += 2 * J * S                         # conv residual
            total += 3 * (J + 1) * leaf_bytes(mgrit.problem[lvl + 1])  # coarse writes
        # coarsest forward solve: read g + write u
        SL = leaf_bytes(mgrit.problem[L - 1])
        total += 2 * mgrit.levels[L - 1].nt * SL
    if cond:
        info = mgrit.levels[0]
        S = leaf_bytes(mgrit.problem[0])
        total += (info.nt + (info.nt - 1) // info.m) * S       # materialize
    return total


def run_ours(name, max_iter, tol=1e-300, precision=None, transfer=None,
             spatial=None, basis='physical', condensed=True,
             n_timed=None, return_solver=False, **cfg):
    import jax
    import numpy as _np
    from pymgrit_tpu import Mgrit

    # drop prior rows' executables + their baked constants from HBM —
    # without this the accumulated rows OOM the 257^2 config that runs
    # fine standalone
    jax.clear_caches()

    problem = build_problem(precision=precision, spatial=spatial, basis=basis,
                            **cfg)
    mgrit = Mgrit(problem=problem, transfer=transfer, tol=tol,
                  max_iter=max_iter, logging_lvl=30, condensed=condensed)

    # Warm-up run compiles the full device-resident solve loop; the timed
    # runs then measure pure execution (with tol below reach the loop runs
    # max_iter iterations regardless of state, so re-solving from the
    # converged state performs identical work).  Median of N timed runs.
    info_first = mgrit.solve_compiled()
    first_conv = [float(c) for c in info_first["conv"]]

    solve_time, t_min, t_max, times = timed_median(
        mgrit, lambda: mgrit.u[0], n=n_timed or N_TIMED)

    iters = len(first_conv)
    steps = sum(count_fine_steps_per_iter(mgrit, it == 0) for it in range(iters))
    out = {
        "config": name,
        "steps": steps,
        "iterations": iters,
        "conv": first_conv,
        "solve_time_s": solve_time,
        "solve_time_spread_s": [round(t_min, 4), round(t_max, 4)],
        "solve_times_s": [round(t, 4) for t in times],
        "steps_per_sec": steps / solve_time,
        "backend": jax.devices()[0].platform,
        "device": str(jax.devices()[0]),
    }
    out["condensed"] = bool(getattr(mgrit, "_condensed0", False))
    if all(li.uniform for li in mgrit.levels[:-1]) and spatial is None \
            and precision is None:
        bts = min_hbm_bytes_per_solve(mgrit, iters)
        out["min_hbm_bytes_moved"] = bts
        out["hbm_gbps_achieved"] = bts / solve_time / 1e9
    if return_solver:
        return out, mgrit
    return out


def run_dd_row():
    """DD precision mode on the same chip: convergence to tol=1e-10 (the
    reference's fp64 tolerance class) + throughput at the base65 config."""
    from pymgrit_tpu import Mgrit

    cfg = CONFIGS["base65"]
    # (a) convergence: fresh solver to tol=1e-10 (first-call timing includes
    # compilation, so throughput comes from (b))
    problem = build_problem(nx=cfg["nx"], ny=cfg["ny"], nt=cfg["nt"],
                            ms=cfg["ms"], precision='dd')
    mgrit = Mgrit(problem=problem, tol=1e-10, max_iter=14, logging_lvl=30)
    info = mgrit.solve_compiled()
    # (b) throughput: warm + timed fixed-iteration run, same protocol as f32
    perf = run_ours("dd65", max_iter=3, precision='dd',
                    nx=cfg["nx"], ny=cfg["ny"], nt=cfg["nt"], ms=cfg["ms"])
    return {
        "iterations_to_1e-10": len(info["conv"]),
        "conv": [float(f"{c:.4e}") for c in info["conv"]],
        "residual_tail": float(info["conv"][-1]),
        "steps_per_sec": perf["steps_per_sec"],
    }


def run_dahlquist_dd_row():
    """README golden config in DD on chip (reference README.rst:105-109)."""
    from pymgrit_tpu import Mgrit, simple_setup_problem
    from pymgrit_tpu.models.dahlquist import Dahlquist
    d = Dahlquist(t_start=0, t_stop=5, nt=101, precision='dd')
    problem = simple_setup_problem(problem=d, level=2, coarsening=2)
    mgrit = Mgrit(problem=problem, tol=1e-10, logging_lvl=30)
    info = mgrit.solve_compiled()
    return {"iterations": len(info["conv"]),
            "conv": [float(f"{c:.4e}") for c in info["conv"]]}


def run_dd_toms_row(ref_full_sps):
    """Equal-accuracy headline row (round-5, VERDICT r4 missing-#1): DD
    precision at the FULL TOMS config (129^2, nt=16385, 5-level 32/16/4/4)
    to tol=1e-10 — the fp64 tolerance class the reference's published
    numbers live in (reference heat/heat_2d.py:322-366 fp64 spsolve;
    README.rst:105-109), so the vs-reference factor here has an
    equal-accuracy column.  Reports the convergence history (tail <=
    1e-10) and the median-of-N steps/s of the same config re-run at the
    converged iteration count (run_ours protocol)."""
    cfg = CONFIGS["toms129"]
    geom = dict(nx=cfg["nx"], ny=cfg["ny"], nt=cfg["nt"], ms=cfg["ms"])
    # ONE build (DD setup at this scale costs minutes of table/probe work):
    # a fixed-14-iteration solve whose deterministic history yields the
    # iterations-to-1e-10 count, and whose median-of-N re-solves give the
    # sustained DD steps/s — the same per-iteration rate a tol=1e-10 run
    # sees (tol only changes the exit point).
    # basis='spectral': the closed-form interval hook supports DD only in
    # eigen-coefficient state (heat_2d.relax_interval declines DD-physical),
    # and without it the condensed level-0 carry declines too — the full
    # 16385-row DD tube is then the carried state at this scale.
    # Histories equal the physical basis in exact arithmetic (the
    # f64-pinned spectral/physical equivalence test); DD-physical itself is
    # benched at 65^2 (dd_heat2d row).
    perf = run_ours("dd_toms129", max_iter=14, precision='dd', n_timed=3,
                    basis='spectral', **geom)
    conv = perf["conv"]
    n10 = next((i + 1 for i, c in enumerate(conv) if c <= 1e-10), None)
    out = {
        "config": "129^2 nt=16385 5-level 32/16/4/4, precision='dd', "
                  "basis='spectral', fp64 tolerance class (equal accuracy "
                  "vs the reference)",
        "iterations_to_1e-10": n10,
        "conv": [float(f"{c:.4e}") for c in conv],
        "residual_at_1e-10": (float(f"{conv[n10 - 1]:.4e}")
                              if n10 else None),
        "residual_tail": conv[-1],
        "solve_time_s": round(perf["solve_time_s"], 3),
        "solve_time_spread_s": perf["solve_time_spread_s"],
        "steps_per_sec": round(perf["steps_per_sec"], 2),
    }
    if ref_full_sps:
        out["vs_reference_fullnt"] = round(
            perf["steps_per_sec"] / ref_full_sps, 1)
    return out


def run_xl_row(nm, basis):
    """One 257^2 full-nt row (quarter-nt fallback on OOM); returns the
    flat dict of artifact keys the row contributes."""
    out = {}
    try:
        xl = run_ours(nm, nx=257, ny=257, nt=2 ** 14 + 1,
                      ms=[32, 16, 4, 4], max_iter=5, basis=basis)
    except Exception as e:                          # OOM etc.: report + retry
        out[nm + "_error"] = repr(e)[:200]
        try:                                        # quarter-nt fallback row
            xl = run_ours(nm + "_nt4097", nx=257, ny=257, nt=4097,
                          ms=[32, 16, 4], max_iter=5, basis=basis)
            nm = nm + "_nt4097"
        except Exception as e2:
            out[nm + "_nt4097_error"] = repr(e2)[:200]
            return out
    if nm.startswith("toms257") and "nt4097" not in nm:
        nm = (nm.replace("toms257_spectral", "toms257_spectral_fullnt")
              if "spectral" in nm else nm.replace("toms257", "toms257_fullnt"))
    out[nm + "_steps_per_sec"] = round(xl["steps_per_sec"], 2)
    out[nm + "_conv"] = [float(f"{c:.4e}") for c in xl["conv"]]
    out[nm + "_solve_time_s"] = round(xl["solve_time_s"], 3)
    out[nm + "_spread_s"] = xl["solve_time_spread_s"]
    if "hbm_gbps_achieved" in xl:
        out[nm + "_hbm_gbps_achieved"] = round(xl["hbm_gbps_achieved"], 1)
    return out


def run_spatial_row():
    """BASELINE.json config 3: 4-level heat_2d WITH 2D spatial coarsening."""
    from pymgrit_tpu.models.grid_transfer_heat import GridTransferHeat2D
    cfg = CONFIGS["base65"]
    spatial = [(65, 65), (33, 33), (17, 17), (9, 9)]
    transfer = [GridTransferHeat2D(nx_fine=spatial[i][0], ny_fine=spatial[i][1])
                for i in range(3)]
    return run_ours("spatial65", max_iter=cfg["max_iter"], transfer=transfer,
                    spatial=spatial, nx=cfg["nx"], ny=cfg["ny"],
                    nt=cfg["nt"], ms=cfg["ms"])


def run_sharded(name, max_iter, tol=1e-300, basis='physical', **cfg):
    """The PRODUCTION executor (shard_map, interval-major blocks) on a
    1-device mesh: its blocked layout avoids the strided tube access of
    the global-view solver."""
    import jax
    import numpy as _np
    from jax.sharding import Mesh
    from pymgrit_tpu.parallel.shard_solver import ShardedMgrit

    jax.clear_caches()
    p = build_problem(basis=basis, **cfg)
    mesh = Mesh(_np.array(jax.devices()[:1]), ("time",))
    s = ShardedMgrit(problem=p, mesh=mesh, tol=tol, max_iter=max_iter,
                     logging_lvl=30)
    info_first = s.solve_compiled()
    first_conv = [float(c) for c in info_first["conv"]]
    solve_time, t_min, t_max, times = timed_median(
        s, lambda: s.state[0]["blocks"])

    class _Acct:
        levels = s.levels
        cf_iter = s.cf_iter

    iters = len(first_conv)
    steps = sum(count_fine_steps_per_iter(_Acct, it == 0) for it in range(iters))
    return {"config": name, "steps": steps, "iterations": iters,
            "conv": first_conv, "solve_time_s": solve_time,
            "solve_time_spread_s": [round(t_min, 4), round(t_max, 4)],
            "solve_times_s": [round(t, 4) for t in times],
            "steps_per_sec": steps / solve_time}


def run_atmgrit_coarsest_row():
    """Distance-k coarsest-level strategy on the device: a 2-level
    hierarchy with a deliberately LARGE coarsest level (nt_c = 2049).  Plain
    MGRIT lax.scans 2048 sequential coarse steps per iteration; AtMgrit(k)
    replaces the chain with k batched window steps (reference
    at_mgrit.py:37-88's algorithmic claim, measured here as wall-clock).
    Conv histories differ by algorithm (AT-MGRIT is an approximation for
    k < nt_c), so both are reported alongside the times."""
    import jax
    import numpy as _np
    from pymgrit_tpu import Mgrit
    from pymgrit_tpu.core.at_mgrit import AtMgrit

    cfg = dict(nx=65, ny=65, nt=2 ** 14 + 1, ms=[8])
    out = {"config": "heat_2d 65x65 nt=16385 2-level m=8 (coarsest nt=2049)"}
    for nm, mk in (("scan", lambda p: Mgrit(problem=p, tol=1e-300, max_iter=3,
                                            logging_lvl=30)),
                   ("atmgrit_k64", lambda p: AtMgrit(64, problem=p, tol=1e-300,
                                                     max_iter=3, logging_lvl=30))):
        m = mk(build_problem(**cfg))
        info_first = m.solve_compiled()
        dt, dmin, dmax, _ = timed_median(m, lambda: m.u[0])
        out[nm + "_solve_time_s"] = round(dt, 3)
        out[nm + "_solve_time_spread_s"] = [round(dmin, 4), round(dmax, 4)]
        out[nm + "_conv"] = [float(f"{c:.4e}") for c in info_first["conv"]]
    out["wallclock_speedup"] = round(
        out["scan_solve_time_s"] / out["atmgrit_k64_solve_time_s"], 3)
    return out


def run_atmgrit_equal_accuracy_row():
    """Equal-accuracy distance-k comparison (round-4, VERDICT r3 weak-#2):
    a config in the algorithm's DESIGN regime, where the truncated window
    reproduces the sequential coarse solve to the tolerance class and the
    wall-clock comparison is therefore apples-to-apples.

    k-scaling: one coarse BE step damps the oldest window information by
    q = 1/(1+dt_c*|lambda|); the truncation error of a k-window scales as
    q^k.  Here dt_c = 0.2, so q^128 ~ 7e-11 — far below the f32 floor —
    and the histories must MATCH.  (The round-3 heat config had
    q^64 ~ 0.5 per window — truncation-limited, histories legitimately
    diverge; kept below as atmgrit_truncation_regime.)
    """
    import jax
    import numpy as _np
    from pymgrit_tpu import Mgrit, Dahlquist
    from pymgrit_tpu.core.at_mgrit import AtMgrit

    nt = 2 ** 19 + 1                       # coarsest nt_c = 65537
    t_stop = 13107.2                       # dt_c = 0.2
    k = 128

    def build():
        d0 = Dahlquist(t_start=0, t_stop=t_stop, nt=nt)
        d1 = Dahlquist(t_interval=d0.t[::8])
        return [d0, d1]

    out = {"config": f"dahlquist nt={nt} 2-level m=8 (coarsest nt=65537), "
                     f"dt_c=0.2, k={k}",
           "k_scaling": "window truncation ~ (1/(1+dt_c))^k = "
                        f"{(1/1.2)**k:.1e} << f32 floor -> equal accuracy"}
    for nm, mk in (("scan", lambda p: Mgrit(problem=p, tol=1e-300, max_iter=3,
                                            logging_lvl=30)),
                   (f"atmgrit_k{k}", lambda p: AtMgrit(k, problem=p, tol=1e-300,
                                                       max_iter=3,
                                                       logging_lvl=30)),
                   # round-5: the EXACT chain-breaker — O(log n)-depth
                   # associative-scan coarse solve (ops/prefix.py), same
                   # histories as the sequential scan by construction
                   ("prefix", lambda p: Mgrit(problem=p, tol=1e-300,
                                              max_iter=3, logging_lvl=30,
                                              coarsest_prefix=True))):
        jax.clear_caches()
        m = mk(build())
        info_first = m.solve_compiled()
        dt, dmin, dmax, _ = timed_median(m, lambda: m.u[0])
        out[nm + "_solve_time_s"] = round(dt, 4)
        out[nm + "_solve_time_spread_s"] = [round(dmin, 4), round(dmax, 4)]
        out[nm + "_conv"] = [float(f"{c:.4e}") for c in info_first["conv"]]
    out["histories_match"] = bool(
        max(abs(a - b) / max(abs(a), 1e-30) for a, b in
            zip(out["scan_conv"], out[f"atmgrit_k{k}_conv"])) < 1e-3)
    out["prefix_histories_match"] = bool(
        max(abs(a - b) / max(abs(a), 1e-30) for a, b in
            zip(out["scan_conv"], out["prefix_conv"])) < 1e-3)
    out["wallclock_speedup"] = round(
        out["scan_solve_time_s"] / out[f"atmgrit_k{k}_solve_time_s"], 3)
    out["prefix_wallclock_speedup"] = round(
        out["scan_solve_time_s"] / out["prefix_solve_time_s"], 3)
    out["prefix_vs_atmgrit"] = round(
        out[f"atmgrit_k{k}_solve_time_s"] / out["prefix_solve_time_s"], 3)
    return out


def run_allen_cahn_row():
    """Nonlinear at-scale row (round-4, VERDICT r3 weak-#3): 2D Allen-Cahn
    (IMEX: FFT-diagonal implicit half + explicit reaction, reference
    allen_cahn.py:201-205) at nt=4097, 3-level 8/8, vs the measured
    reference baseline (tools/bench_reference.py allen_cahn mode)."""
    import jax
    import numpy as _np
    from pymgrit_tpu import Mgrit, AllenCahn

    nt, nx, ms, t_stop = 4097, 128, [8, 8], 0.032

    def build():
        p, stride = [], 1
        a0 = AllenCahn(nx=nx, method='IMEX', t_start=0, t_stop=t_stop, nt=nt)
        p.append(a0)
        for mm in ms:
            stride *= mm
            p.append(AllenCahn(nx=nx, method='IMEX', t_interval=a0.t[::stride]))
        return p

    jax.clear_caches()
    m = Mgrit(problem=build(), tol=1e-300, max_iter=5, logging_lvl=30)
    info = m.solve_compiled()
    conv = [float(c) for c in info["conv"]]
    dt, dmin, dmax, _ = timed_median(m, lambda: m.u[0])
    steps = sum(count_fine_steps_per_iter(m, it == 0)
                for it in range(len(conv)))
    out = {"config": f"allen_cahn 128^2 nt={nt} 3-level 8/8 IMEX",
           "iterations": len(conv),
           "conv": [float(f"{c:.4e}") for c in conv],
           "solve_time_s": round(dt, 4),
           "solve_time_spread_s": [round(dmin, 4), round(dmax, 4)],
           "steps_per_sec": round(steps / dt, 2)}
    # measured out-of-band (37 min of reference CPU: 12288 spsolve steps);
    # cache_only so the bench run never re-measures inline
    ref = reference_baseline(
        "allen_cahn4097",
        ["allen_cahn", nt, nx, 1, ",".join(str(x) for x in ms), t_stop],
        cache_only=True)
    if ref:
        out["reference_steps_per_sec"] = round(ref["steps_per_sec"], 3)
        out["vs_reference"] = round(out["steps_per_sec"] /
                                    ref["steps_per_sec"], 1)
    return out


def run_ragged_row():
    """Non-uniform-coarsening perf row (round-4, VERDICT r3 missing-#7):
    a varying_coarsening-style hierarchy (reference
    tests/core/test_mgrit.py time_setup goldens use irregular grids) at
    nt=4097 on heat_2d 65^2 — the general ragged shard_map executor
    (Gauss-Seidel chains, masked lanes) vs the global-view executor.
    Level-1 C-points: stride-8 with +-3 jitter."""
    import jax
    import numpy as _np
    from jax.sharding import Mesh
    from pymgrit_tpu import Mgrit
    from pymgrit_tpu.parallel.shard_solver import ShardedMgrit

    nt = 4097
    rng = _np.random.default_rng(0)
    base = _np.arange(0, nt, 8)
    jit = _np.clip(base + rng.integers(-3, 4, size=base.size), 0, nt - 1)
    idx1 = _np.unique(_np.concatenate([[0, nt - 1], jit]))

    def build():
        probs = build_problem(nx=65, ny=65, nt=nt, ms=[])
        t = probs[0].t
        from pymgrit_tpu import Heat2D
        lvls = [t, t[idx1], t[idx1][::4], t[idx1][::4][::4]]
        return [Heat2D(x_start=0, x_end=1, y_start=0, y_end=1, nx=65, ny=65,
                       a=1.0, rhs=probs[0].rhs, init_cond=lambda x, y: 0 * x * y,
                       t_interval=g.copy()) for g in lvls]

    out = {"config": "heat_2d 65^2 nt=4097, irregular level-1 (stride-8 "
                     "+-3 jitter), 4-level"}
    for nm, mk in (
            ("global_view", lambda p: Mgrit(problem=p, tol=1e-300, max_iter=3,
                                            logging_lvl=40)),
            ("shard_map_general", lambda p: ShardedMgrit(
                problem=p, mesh=Mesh(_np.array(jax.devices()[:1]), ("time",)),
                tol=1e-300, max_iter=3, logging_lvl=40))):
        jax.clear_caches()
        m = mk(build())
        info = m.solve_compiled()
        conv = [float(c) for c in info["conv"]]
        dt, dmin, dmax, _ = timed_median(
            m, lambda: m.u[0] if hasattr(m, "u") else m.state[0]["blocks"])
        out[nm + "_solve_time_s"] = round(dt, 4)
        out[nm + "_solve_time_spread_s"] = [round(dmin, 4), round(dmax, 4)]
        out[nm + "_conv"] = [float(f"{c:.4e}") for c in conv]
    out["histories_match"] = bool(_np.allclose(
        out["global_view_conv"], out["shard_map_general_conv"], rtol=1e-3))
    return out


def parity_iters_cpu():
    """Iterations to tol=1e-10 in fp64 on the CPU, in a subprocess that
    never opens the accelerator (the cross-check of the device's f64)."""
    code = (
        "import json\n"
        "import bench\n"
        "from pymgrit_tpu import Mgrit\n"
        "cfg = bench.CONFIGS['base65']\n"
        "p = bench.build_problem(nx=cfg['nx'], ny=cfg['ny'], nt=cfg['nt'], ms=cfg['ms'])\n"
        "m = Mgrit(problem=p, tol=1e-10, max_iter=20, logging_lvl=30)\n"
        "info = m.solve()\n"
        "print('PARITY' + json.dumps({'iterations': len(info['conv']),"
        " 'conv': [float(c) for c in info['conv']]}))\n"
    )
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYMGRIT_TPU_NO_X64="")
    try:
        out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                             capture_output=True, text=True, timeout=1800)
        for line in out.stdout.splitlines():
            if line.startswith("PARITY"):
                return json.loads(line[len("PARITY"):])
    except Exception:
        pass
    return None


def _load_cache():
    if os.path.exists(CACHE):
        with open(CACHE) as f:
            data = json.load(f)
        if "steps_per_sec" in data:        # round-1 layout: bare 65^2 result
            data = {"base65": data}
        return data
    return {}


def reference_baseline(key, argv, cache_only=False):
    """Reference steps/s, measured live once and cached per config.
    cache_only: never measure inside the bench run (used for the full-nt
    TOMS measurement, ~75 min of reference CPU time, produced out-of-band
    by `tools/bench_reference.py 16385 129 129 5 4 1 32,16,4,4`)."""
    cache = _load_cache()
    if key in cache:
        return cache[key]
    if cache_only:
        return None
    env = dict(os.environ,
               PYTHONPATH=os.path.join(REPO, "tools", "mpi4py_stub") + ":" +
               "/root/reference/src")
    try:
        out = subprocess.run(
            [sys.executable, os.path.join(REPO, "tools", "bench_reference.py")]
            + [str(a) for a in argv],
            env=env, capture_output=True, text=True, timeout=3600)
        data = json.loads(out.stdout.strip().splitlines()[-1])
        cache[key] = data
        with open(CACHE, "w") as f:
            json.dump(cache, f)
        return data
    except Exception:
        return None


def main():
    # Throughput rows run in f32 (full-precision matmuls; see the package's
    # matmul-precision pin).  The dd rows verify the 1e-10 tolerance class
    # from float32 pairs; CPU-f64 parity is kept as cross-check.
    os.environ.setdefault("PYMGRIT_TPU_NO_X64", "1")
    from pymgrit_tpu.utils.compile_cache import configure_compile_cache
    configure_compile_cache()

    # Headline: spectral-state mode with the condensed level-0 carry.
    # Residual histories equal the
    # physical basis in exact arithmetic (pinned by an f64 test,
    # tests/models/test_heat2d_spectral.py); the f32 roundoff FLOORS differ
    # (spectral's is lower) — both are reported below.  The timed solve
    # INCLUDES the final F-row materialization (the fused device program
    # returns the full fine tube); recovering physical solutions from
    # spectral state needs one final basis transform (2 GEMMs), not counted.
    geomT = {k: CONFIGS["toms129"][k] for k in ("nx", "ny", "nt", "ms")}
    toms, toms_mg = run_ours("toms129", basis='spectral', return_solver=True,
                             **CONFIGS["toms129"])
    toms_k2, toms_k2_mg = run_ours("toms129_kamort", basis='spectral',
                                   max_iter=AMORT_K2, return_solver=True,
                                   **geomT)
    amort_core = amortized_robust(toms, toms_mg, toms_k2, toms_k2_mg)
    del toms_mg, toms_k2_mg                  # free HBM before later rows
    fulltube = run_ours("toms129_fulltube", basis='spectral',
                        condensed=False, **CONFIGS["toms129"])
    physical = run_ours("toms129_physical", **CONFIGS["toms129"])
    physical_k2 = run_ours("toms129_physical_kamort", max_iter=AMORT_K2, **geomT)
    amort_physical = amortized_pair(physical, physical_k2)
    # shard_map executor on a 1-device mesh (round-3 headline); headline
    # takes the fastest executor BY THE AMORTIZED DEVICE RATE (stable),
    # not the noisy single-shot wall-clock
    sharded_sp = run_sharded("toms129_sharded", basis='spectral',
                             **CONFIGS["toms129"])
    sharded_k2 = run_sharded("toms129_sharded_kamort", basis='spectral',
                             max_iter=AMORT_K2, **geomT)
    amort_sharded = amortized_pair(sharded_sp, sharded_k2)

    headline, headline_amort = toms, amort_core
    headline_exec = "Mgrit (global-view, condensed level-0)"
    if (amort_sharded and amort_core and
            amort_sharded["device_steps_per_sec"]
            > amort_core["device_steps_per_sec"]):
        headline, headline_amort = sharded_sp, amort_sharded
        headline_exec = "ShardedMgrit (shard_map, 1-device mesh)"
    base = run_ours("base65", **CONFIGS["base65"])
    spatial = run_spatial_row()
    dd = run_dd_row()
    dd_dahl = run_dahlquist_dd_row()
    atm = run_atmgrit_coarsest_row()
    atm_eq = run_atmgrit_equal_accuracy_row()
    ac = run_allen_cahn_row()
    ragged = run_ragged_row()
    copy_bw = measure_copy_bw_gbps()

    # reference baselines: extrapolated (nt=1025; per-step spsolve cost is
    # nt-independent) + the DIRECT full-nt measurement when cached
    ref_toms = reference_baseline("toms129", [1025, 129, 129, 3, 4])
    ref_full = reference_baseline("toms129_fullnt",
                                  [16385, 129, 129, 5, 4, 1, "32,16,4,4"],
                                  cache_only=True)
    ref_base = reference_baseline("base65", [4097])
    parity = parity_iters_cpu()

    ref_sps = (ref_full or ref_toms or {}).get("steps_per_sec")

    value = (headline_amort or {}).get(
        "device_steps_per_sec", headline["steps_per_sec"])
    vs = (value / ref_sps) if ref_sps else -1.0
    result = {
        "metric": "heat_2d 129x129 nt=16385 5-level (TOMS ex.3) MGRIT fine time-steps/sec/chip",
        "value": round(value, 2),
        "unit": "steps/s",
        "value_definition": (
            f"steady-state device-amortized rate: (steps({AMORT_K2} iter) "
            f"- steps(5 iter)) / (median time({AMORT_K2}) - median "
            f"time(5)), median of {AMORT_ROUNDS} interleaved timing "
            "rounds; fixed launch/output cost and one-time "
            "materialization cancel in the diff — the stable, portable "
            "figure (see bench.py docstring).  End-to-end medians + "
            "spreads reported below."),
        "vs_baseline": round(vs, 3) if vs > 0 else None,
        "vs_baseline_source": ("full-nt reference measurement" if ref_full
                               else "nt-extrapolated reference measurement"),
        "executor": headline_exec,
        "backend": toms["backend"],
        "iterations_measured": headline["iterations"],
        "endtoend_median_solve_time_s": round(headline["solve_time_s"], 3),
        "endtoend_median_steps_per_sec": round(headline["steps_per_sec"], 2),
        "endtoend_solve_time_spread_s": headline["solve_time_spread_s"],
        "conv": [float(f"{c:.4e}") for c in headline["conv"]],
        "amortized_core": amort_core,
        "amortized_sharded": amort_sharded,
        "amortized_physical": amort_physical,
        "toms129_core_executor_steps_per_sec": round(toms["steps_per_sec"], 2),
        "toms129_core_executor_spread_s": toms["solve_time_spread_s"],
        "toms129_fulltube_steps_per_sec": round(fulltube["steps_per_sec"], 2),
        "toms129_sharded_steps_per_sec": round(sharded_sp["steps_per_sec"], 2),
        "toms129_sharded_spread_s": sharded_sp["solve_time_spread_s"],
        "basis": ("spectral (eigen-coefficient state; histories identical to "
                  "physical in exact arithmetic — f64-pinned; f32 floors "
                  "differ, spectral lower; physical output needs one final "
                  "basis transform)"),
        "spectral_f32_floor": float(f"{toms['conv'][-1]:.4e}"),
        "physical_f32_floor": float(f"{physical['conv'][-1]:.4e}"),
        "toms129_physical_steps_per_sec": round(physical["steps_per_sec"], 2),
        "toms129_physical_conv": [float(f"{c:.4e}") for c in physical["conv"]],
        "hbm_copy_bw_gbps_measured": round(copy_bw, 1),
        "toms129_hbm_gbps_achieved": round(toms.get("hbm_gbps_achieved", 0), 1),
        "toms129_pct_of_hbm_copy_roofline": round(
            toms.get("hbm_gbps_achieved", 0) / copy_bw, 4),
        "toms129_fulltube_hbm_gbps_achieved": round(
            fulltube.get("hbm_gbps_achieved", 0), 1),
        "toms129_fulltube_pct_of_hbm_copy_roofline": round(
            fulltube.get("hbm_gbps_achieved", 0) / copy_bw, 4),
        "toms129_physical_hbm_gbps_achieved": round(
            physical.get("hbm_gbps_achieved", 0), 1),
        "base65_steps_per_sec": round(base["steps_per_sec"], 2),
        "base65_vs_reference": round(
            base["steps_per_sec"] / ref_base["steps_per_sec"], 3) if ref_base else None,
        "spatial65_steps_per_sec": round(spatial["steps_per_sec"], 2),
        "spatial65_conv": [float(f"{c:.4e}") for c in spatial["conv"]],
        "dd_heat2d": dd,
        "dd_dahlquist": dd_dahl,
        "atmgrit_truncation_regime": atm,
        "atmgrit_equal_accuracy": atm_eq,
        "allen_cahn": ac,
        "ragged_nonuniform": ragged,
        "parity_iters_to_1e-10_cpu_f64": parity["iterations"] if parity else None,
        "reference_toms_steps_per_sec": round(ref_toms["steps_per_sec"], 2) if ref_toms else None,
        "reference_toms_fullnt_steps_per_sec": round(
            ref_full["steps_per_sec"], 2) if ref_full else None,
    }

    # XL + DD rows, last, in this process (one process holds the device):
    # 257^2 at the FULL nt=16385, and the equal-accuracy full-TOMS DD row.
    xl_names = [("toms257", 'physical'), ("toms257_spectral", 'spectral')]
    for nm, basis in xl_names:
        result.update(run_xl_row(nm, basis))
    for key in (k for k in list(result) if k.endswith("_hbm_gbps_achieved")
                and k.startswith("toms257")):
        result[key[:-len("_hbm_gbps_achieved")] + "_pct_of_hbm_copy_roofline"] \
            = round(result[key] / copy_bw, 4)
    dd_toms = run_dd_toms_row(ref_sps)
    result["dd_toms129"] = dd_toms

    # durable artifact: the full key set, beside the compact last line
    os.makedirs(os.path.join(REPO, "results"), exist_ok=True)
    with open(os.path.join(REPO, "results", "bench.json"), "w") as f:
        json.dump(result, f, indent=1)
    # FINAL stdout line: one compact driver-parseable summary (VERDICT r4
    # weak-#2: the full blob overflowed the driver's stdout tail and
    # parsed as null; full detail lives in the artifact above)
    compact = {
        "metric": result["metric"],
        "value": result["value"],
        "unit": "steps/s",
        "vs_baseline": result["vs_baseline"],
        "definition": "device-amortized steady-state rate",
        "executor": result["executor"],
        "endtoend_median_steps_per_sec": result["endtoend_median_steps_per_sec"],
        "endtoend_spread_s": result["endtoend_solve_time_spread_s"],
        "dd_toms129_steps_per_sec": dd_toms.get("steps_per_sec"),
        "dd_toms129_residual_tail": dd_toms.get("residual_tail"),
        "artifact": "results/bench.json",
    }
    print(json.dumps(compact))


if __name__ == "__main__":
    main()
