"""Strong/weak scaling harness over ('time', 'space') mesh shapes.

The reference's scaling study (docs/source/usage/parallelism.rst:86-142,
2D heat 101x51x8193 over 2-128 time procs) maps here to mesh shapes over
however many devices are visible: by default the accelerators JAX finds
(an error if there are fewer than --devices), or with --virtual-cpu that
many virtual CPU devices, whose times are CPU times.

Usage:
  python tools/scaling.py --devices 4 --mode strong
  python tools/scaling.py --virtual-cpu --devices 8 --mode strong
"""

import argparse
import json
import os
import time


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--devices", type=int, default=8)
    ap.add_argument("--mode", choices=["strong", "weak"], default="strong")
    ap.add_argument("--nt", type=int, default=1025)
    ap.add_argument("--nx", type=int, default=33)
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--executor", choices=["gspmd", "shard_map",
                                           "at_shard_map"],
                    default="shard_map")
    ap.add_argument("--k", type=int, default=16,
                    help="distance-k window for --executor at_shard_map")
    ap.add_argument("--out", default=None,
                    help="write the results JSON to this path")
    ap.add_argument("--virtual-cpu", action="store_true",
                    help="run on --devices virtual CPU devices (CPU times)")
    args = ap.parse_args()

    if args.virtual_cpu:
        os.environ["JAX_PLATFORMS"] = "cpu"
        flags = os.environ.get("XLA_FLAGS", "")
        if "host_platform_device_count" not in flags:
            os.environ["XLA_FLAGS"] = flags + f" --xla_force_host_platform_device_count={args.devices}"
        print("scaling: virtual CPU devices; the times below are CPU times")

    import numpy as np
    import jax
    if len(jax.devices()) < args.devices:
        raise SystemExit(f"scaling: needs {args.devices} devices, JAX found "
                         f"{len(jax.devices())} {jax.devices()[0].platform} "
                         "device(s); pass --virtual-cpu for a CPU run")

    from pymgrit_tpu import Heat2D, Mgrit
    from pymgrit_tpu.parallel.shard_solver import ShardedAtMgrit, ShardedMgrit
    from pymgrit_tpu.parallel.sharding import make_time_space_mesh

    def build(nt):
        def rhs(x, y, t):
            return 5 * x * (1 - x) * y * (1 - y) + 0 * t

        t = np.linspace(0, 1, nt)
        return [Heat2D(x_start=0, x_end=1, y_start=0, y_end=1, nx=args.nx,
                       ny=args.nx, a=1.0, rhs=rhs, t_interval=t[:: 4 ** lvl])
                for lvl in range(3)]

    results = []
    n = 1
    while n <= args.devices:
        nt = args.nt if args.mode == "strong" else (args.nt - 1) * n + 1
        if args.executor == "shard_map":
            # same executor at every point (a 1-device mesh degenerates to
            # serial) so the curve isolates scaling, not executor choice
            mesh = make_time_space_mesh(n_time=n, n_space=1)
            m = ShardedMgrit(problem=build(nt), mesh=mesh, tol=1e-300,
                             max_iter=args.iters, logging_lvl=30)
        elif args.executor == "at_shard_map":
            mesh = make_time_space_mesh(n_time=n, n_space=1)
            m = ShardedAtMgrit(args.k, problem=build(nt), mesh=mesh,
                               tol=1e-300, max_iter=args.iters, logging_lvl=30)
        else:
            mesh = make_time_space_mesh(n_time=n, n_space=1) if n > 1 else None
            m = Mgrit(problem=build(nt), tol=1e-300, max_iter=args.iters,
                      logging_lvl=30, mesh=mesh)
        m.solve_compiled()                     # compile + warm
        m.conv = np.zeros(m.iter_max + 1)
        t0 = time.time()
        m.solve_compiled()
        dt = time.time() - t0
        results.append({"n_time": n, "nt": nt, "solve_s": round(dt, 4)})
        print(json.dumps(results[-1]))
        n *= 2

    base = results[0]["solve_s"]
    for r in results:
        if args.mode == "strong":
            r["speedup"] = round(base / r["solve_s"], 3)
            r["efficiency"] = round(base / r["solve_s"] / r["n_time"], 3)
        else:
            r["efficiency"] = round(base / r["solve_s"], 3)
    summary = {"mode": args.mode, "executor": args.executor,
               "devices": args.devices,
               "platform": jax.devices()[0].platform,
               "note": ("virtual CPU devices measure the collective-program "
                        "SHAPE (comm/compute structure), not device "
                        "speedup" if args.virtual_cpu else
                        f"{jax.devices()[0].device_kind} devices"),
               "results": results}
    print(json.dumps(summary))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(summary, f, indent=2)
        try:                      # companion figure (reference analogue:
            import matplotlib     # docs/source/usage/parallelism.rst:86-142)
            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
            ns = [r["n_time"] for r in results]
            ts = [r["solve_s"] for r in results]
            fig, ax = plt.subplots(figsize=(5, 3.5))
            ax.plot(ns, ts, "o-", label=f"{args.executor} executor")
            ax.plot(ns, [ts[0] / n for n in ns], "k--", alpha=0.5,
                    label="ideal")
            ax.set_xscale("log", base=2)
            ax.set_yscale("log")
            ax.set_xlabel("time-axis shards")
            ax.set_ylabel("solve wall-clock [s]")
            ax.set_title(f"strong scaling ({summary['platform']}, "
                         f"virtual devices)" if summary["platform"] == "cpu"
                         else "strong scaling")
            ax.legend(fontsize=8)
            fig.tight_layout()
            fig.savefig(os.path.splitext(args.out)[0] + ".png", dpi=120)
        except Exception as e:
            print(f"(plot skipped: {e})")


if __name__ == "__main__":
    main()
