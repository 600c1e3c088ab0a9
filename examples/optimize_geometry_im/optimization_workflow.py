"""Geometry optimization of the im_3kW induction machine driven by AT-MGRIT.

Parity target: reference examples/optimize_geometry_im/optimization_workflow.py
(1-247) — a derivative-free optimizer (Py-BOBYQA) varies the rotor slot
geometry (width ``Rsl``, height ``h2``); each evaluation re-meshes the
machine with gmsh, rebuilds the GetDP pre-file, runs an AT-MGRIT simulation,
and scores the design by an efficiency-like objective built from the mean
torque and joule losses over the final part of the time interval.

Differences from the reference:

* The reference splits MPI_COMM_WORLD into a master (optimizer) and a worker
  group (MGRIT ranks) and moves objectives around with bcast.  Here the
  solver is device-parallel on its own, so the optimizer simply calls it
  in-process — the master/worker protocol disappears.
* Py-BOBYQA is used when installed; otherwise the workflow falls back to
  scipy's bounded Powell search (same derivative-free, bound-constrained
  class of method).
* GetDP/gmsh and the im_3kW model are external; point PYMGRIT_TPU_GETDP,
  PYMGRIT_TPU_GMSH and PYMGRIT_TPU_IM3KW at a local installation.  Without
  them, ``--demo`` runs the identical optimization loop on a bundled
  synthetic machine surrogate, so the workflow itself is executable
  anywhere (and is exercised by the test suite).

Run:
    python3 optimization_workflow.py --demo
    PYMGRIT_TPU_IM3KW=... PYMGRIT_TPU_GETDP=... python3 optimization_workflow.py
"""

import argparse
import os
import subprocess
import sys

import numpy as np
import jax.numpy as jnp

from pymgrit_tpu.core.application import Application
from pymgrit_tpu.core.at_mgrit import AtMgrit


class AtMgritCustomized(AtMgrit):
    """AT-MGRIT with the machine objective as convergence criterion.

    Mirrors the reference's AtMgritCustomized (optimization_workflow.py:28-109):
    convergence is the maximum relative change (percent) of the joule losses
    over the last ``region_from_end`` seconds of the interval, and ``solve``
    returns the torque/joule-loss traces plus their means over that region.
    """

    def __init__(self, region_from_end, *args, **kwargs):
        self.optimization_region = region_from_end
        self.last_it = np.array([])
        super().__init__(*args, **kwargs)
        self.last_it = np.zeros_like(np.asarray(self.problem[0].t))
        self.convergence_criterion(0)

    def _region_start(self):
        t = np.asarray(self.problem[0].t)
        return int(np.abs(t - (t[-1] - self.optimization_region)).argmin())

    def _traces(self):
        # scalars leaf ordering: [jl, ia, ib, ic, ua, ub, uc, tr]
        scalars = np.asarray(self.u[0]["scalars"])
        return scalars[:, 7], scalars[:, 0]          # tr, jl

    def convergence_criterion(self, iteration: int) -> None:
        tr, jl = self._traces()
        idx = self._region_start()
        rel = np.divide(jl[idx:] - self.last_it[idx:], jl[idx:],
                        out=np.zeros_like(self.last_it[idx:]),
                        where=jl[idx:] != 0)
        tmp = 100 * np.max(np.abs(rel))
        self.conv[iteration] = tmp
        self._all_below = bool(tmp < self.tol)
        self.last_it = np.copy(jl)

    def solve(self):
        super().solve()
        tr, jl = self._traces()
        idx = self._region_start()
        return tr, jl, float(np.mean(tr[idx:])), float(np.mean(jl[idx:]))


class SyntheticMachine(Application):
    """Surrogate machine for the --demo path: torque and joule losses relax
    (backward Euler, closed form) toward geometry-dependent steady states
    with an interior optimum, standing in for the GetDP FEM solve so the
    optimization loop runs without external binaries."""

    def __init__(self, rsl: float, h2: float, *args, **kwargs):
        super().__init__(*args, **kwargs)
        # steady states: ~19 Nm torque; losses minimal near (0.0025, 0.012)
        self.tr_ss = 19.0 - 300.0 * abs(rsl - 0.0025)
        self.jl_ss = 250.0 + 4e7 * (rsl - 0.0025) ** 2 + 1e7 * (h2 - 0.012) ** 2
        self.rate = 120.0                     # electrical time-constant-ish
        self.vector_template = np.zeros(2)    # [tr, jl]
        self.vector_t_start = np.zeros(2)

    def step(self, u_start, t_start, t_stop):
        dt = t_stop - t_start
        ss = jnp.array([self.tr_ss, self.jl_ss])
        return (u_start + dt * self.rate * ss) / (1.0 + dt * self.rate)


class SyntheticAtMgrit(AtMgritCustomized):
    """The customized solver on the surrogate state layout ((2,) array
    instead of the machine pytree)."""

    def _traces(self):
        u = np.asarray(self.u[0])
        return u[:, 0], u[:, 1]               # tr, jl


def create_mesh(exe_path, model_path, rsl=0.00213, h2=0.01425):
    """Re-mesh the machine with gmsh and rebuild the GetDP pre-file
    (reference optimization_workflow.py:133-153)."""
    gmsh = os.environ.get("PYMGRIT_TPU_GMSH", exe_path + "gmsh")
    subprocess.run(
        [gmsh, model_path + "im_3kW.geo", "-2",
         "-setnumber", "Rsl", str(rsl), "-setnumber", "h2", str(h2),
         "-o", model_path + "im_3kW.msh"],
        check=True, stdout=subprocess.PIPE)
    subprocess.run(
        [exe_path + "getdp", model_path + "im_3kW.pro", "-pre", "#1",
         "-msh", model_path + "im_3kW.msh", "-name", model_path + "im_3kW",
         "-res", model_path + "im_3kW.res",
         "-setstring", "ResDir", model_path + "res/",
         "-setnumber", "Flag_AnalysisType", "1", "-setnumber", "Flag_NL", "0",
         "-setnumber", "Flag_ImposedSpeed", "2",
         "-setnumber", "Nb_max_iter", "60",
         "-setnumber", "relaxation_factor", "0.5",
         "-setnumber", "stop_criterion", "1e-06",
         "-setnumber", "NbTrelax", "2", "-setnumber", "Flag_PWM", "0"],
        check=True, stdout=subprocess.PIPE)


def run_mgrit(exe_path, model_path, t_stop, nt):
    """Two-level AT-MGRIT on the machine (reference
    optimization_workflow.py:112-127: k=100, cf_iter=0, tol=1%)."""
    from pymgrit_tpu.models.induction_machine import InductionMachine
    machine_0 = InductionMachine(nonlinear=True, pwm=False, grid='im_3kW',
                                 t_start=0, t_stop=t_stop, nt=nt,
                                 path_getdp=exe_path + 'getdp',
                                 path_im3kw=model_path, imposed_speed=2,
                                 stop_criterion=1e-6)
    machine_1 = InductionMachine(nonlinear=True, pwm=False, grid='im_3kW',
                                 t_interval=machine_0.t[::64],
                                 path_getdp=exe_path + 'getdp',
                                 path_im3kw=model_path, imposed_speed=2,
                                 stop_criterion=1e-6)
    mgrit = AtMgritCustomized(region_from_end=0.02, k=100,
                              problem=[machine_0, machine_1],
                              nested_iteration=True, tol=1, cf_iter=0)
    return mgrit.solve()


def run_mgrit_demo(rsl, h2):
    """Surrogate evaluation: same hierarchy/solver settings, tiny surrogate
    dynamics instead of the FEM solve."""
    machine_0 = SyntheticMachine(rsl, h2, t_start=0, t_stop=0.2, nt=2 ** 8 + 1)
    machine_1 = SyntheticMachine(rsl, h2, t_interval=machine_0.t[::64])
    mgrit = SyntheticAtMgrit(region_from_end=0.02, k=100,
                             problem=[machine_0, machine_1],
                             nested_iteration=True, tol=1, cf_iter=0,
                             logging_lvl=30)
    return mgrit.solve()


def objective_function(tr, jl):
    """Negative machine efficiency at 148.7 rad/s rated speed
    (reference optimization_workflow.py:155-156)."""
    return -((tr * 148.7) / ((tr * 148.7) + jl))


def make_objx(exe_path, model_path, t_stop, nt, demo):
    evaluations = []

    def objx(x):
        print("evaluating geometry", x)
        if demo:
            _, _, tr, jl = run_mgrit_demo(rsl=x[0], h2=x[1])
        else:
            create_mesh(rsl=x[0], h2=x[1], exe_path=exe_path,
                        model_path=model_path)
            _, _, tr, jl = run_mgrit(exe_path, model_path, t_stop, nt)
        val = objective_function(tr=tr, jl=jl)
        evaluations.append((np.array(x), val))
        print("objective", val)
        return val

    return objx, evaluations


def optimize(objx, x0, lower, upper):
    """Py-BOBYQA when installed, else scipy bounded Powell."""
    try:
        import pybobyqa
    except ImportError:
        pybobyqa = None
    if pybobyqa is not None:
        soln = pybobyqa.solve(objx, x0, bounds=(lower, upper),
                              rhobeg=1e-4, rhoend=1e-6)
        return np.asarray(soln.x), float(soln.f)
    from scipy.optimize import minimize
    res = minimize(objx, x0, method='Powell',
                   bounds=list(zip(lower, upper)),
                   options={'xtol': 1e-6, 'maxfev': 60})
    return np.asarray(res.x), float(res.fun)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--demo", action="store_true",
                        help="run on the synthetic machine surrogate "
                             "(no GetDP/gmsh needed)")
    args = parser.parse_args(argv)

    # rotor slot width Rsl and height h2, reference bounds
    x0 = np.array([0.002, 0.01425])
    lower = np.array([0.0015, 0.007])
    upper = np.array([0.0035, 0.015])

    exe_path = os.environ.get("PYMGRIT_TPU_GETDP_DIR", "")
    model_path = os.environ.get("PYMGRIT_TPU_IM3KW", "")
    demo = args.demo or not (model_path and os.path.isdir(model_path))
    if demo and not args.demo:
        print("im_3kW model/GetDP not found - running the surrogate demo "
              "(set PYMGRIT_TPU_IM3KW / PYMGRIT_TPU_GETDP_DIR for the real "
              "machine)")

    objx, evaluations = make_objx(exe_path, model_path,
                                  t_stop=0.2, nt=2 ** 14 + 1, demo=demo)
    x_opt, f_opt = optimize(objx, x0, lower, upper)
    print(f"optimum geometry Rsl={x_opt[0]:.6f} h2={x_opt[1]:.6f} "
          f"efficiency={-f_opt:.4f} after {len(evaluations)} evaluations")
    return x_opt, f_opt


if __name__ == '__main__':
    main()
