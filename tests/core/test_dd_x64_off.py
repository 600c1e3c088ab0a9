"""DD correctness with x64 DISABLED — float32-only execution.

The suite normally runs with jax_enable_x64 (package default on import),
which can mask silent f64 dependencies in the DD path: with x64 off, any
stray jnp.asarray(f64_host_array) demotes to f32 and quietly costs 7 digits.
This test re-runs the core DD goldens in a subprocess with
PYMGRIT_TPU_NO_X64=1, so every number the solver touches is float32 or a
float32 pair.
"""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

CODE = r"""
import numpy as np
from pymgrit_tpu import Mgrit, simple_setup_problem
from pymgrit_tpu.models.dahlquist import Dahlquist
from pymgrit_tpu.core.at_mgrit import AtMgrit

# README golden in DD with x64 off
d = Dahlquist(t_start=0, t_stop=5, nt=101, precision='dd')
mgrit = Mgrit(problem=simple_setup_problem(d, 2, 2), tol=1e-10, logging_lvl=30)
conv = mgrit.solve()['conv']
assert len(conv) == 5, conv
assert np.allclose(conv, [7.186e-5, 1.246e-6, 2.102e-8, 3.144e-10, 3.975e-12],
                   rtol=2e-3), conv

# AT-MGRIT coarsest path in DD with x64 off
mk = lambda nts: [Dahlquist(t_start=0, t_stop=5, nt=nt, precision='dd')
                  for nt in nts]
conv = AtMgrit(k=6, problem=mk((129, 65)), tol=1e-10,
               logging_lvl=30).solve()['conv']
assert conv[-1] < 1e-10, conv
print("X64OFF_OK")
"""


def test_dd_goldens_with_x64_disabled():
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYMGRIT_TPU_NO_X64="1")
    out = subprocess.run([sys.executable, "-c", CODE], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=900)
    assert "X64OFF_OK" in out.stdout, (out.stdout[-2000:], out.stderr[-2000:])
