"""Run every example script and report pass/fail — the serial analogue of
the reference's tests/mpi/test_examples.sh (which mpiexec-runs each example
at several rank counts and diff-checks the logs).

Usage:
  python tools/run_examples.py            # all examples, CPU backend
  python tools/run_examples.py example_heat_1d.py   # subset by substring

Examples that need absent external pieces (the GetDP binary for the
induction machine) detect that themselves and exit 0 with a skip message.
"""

import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(REPO, "examples")

# Examples excluded from the sweep by default.  (The induction-machine
# driver now skips itself with exit 0 when PYMGRIT_TPU_IM3KW is unset, so
# nothing needs a hard exclusion; keep the set for future gating.)
SKIP = set()


def find_examples(patterns):
    out = []
    for root, _dirs, files in os.walk(EXAMPLES):
        for f in sorted(files):
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(root, f), EXAMPLES)
                if not patterns or any(p in rel for p in patterns):
                    out.append(rel)
    return out


def main():
    patterns = sys.argv[1:]
    env = dict(os.environ)
    # CPU backend with virtual devices: the sweep checks correctness, and
    # runs with no accelerator attached.
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    # The sharded examples adapt to len(jax.devices()); give them a real
    # multi-device CPU mesh to exercise the collective paths.
    if "xla_force_host_platform_device_count" not in env.get("XLA_FLAGS", ""):
        env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "")
                            + " --xla_force_host_platform_device_count=8").strip()
    failures = []
    for rel in find_examples(patterns):
        if rel in SKIP:
            print(f"SKIP  {rel}")
            continue
        t0 = time.time()
        proc = subprocess.run([sys.executable, os.path.join(EXAMPLES, rel)],
                              cwd=REPO, env=env, capture_output=True,
                              text=True, timeout=1800)
        status = "ok" if proc.returncode == 0 else "FAIL"
        print(f"{status:5} {rel}  ({time.time() - t0:.1f}s)")
        if proc.returncode != 0:
            failures.append(rel)
            print(proc.stdout[-2000:])
            print(proc.stderr[-2000:])
    if failures:
        print(f"\n{len(failures)} failing: {failures}")
        sys.exit(1)
    print("\nall examples passed")


if __name__ == "__main__":
    main()
