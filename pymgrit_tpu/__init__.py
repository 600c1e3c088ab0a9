"""pymgrit_tpu — a JAX-native Multigrid-Reduction-in-Time (MGRIT) framework.

A from-scratch JAX/XLA implementation of the capabilities of PyMGRIT
(reference: pymgrit v1.0.6).  Not a port: states are pytrees
of jnp arrays with a leading *time* axis, time steppers are pure jittable
functions, relaxation sweeps are batched (vmap over coarse intervals,
lax.scan within an interval), and distribution happens over a
``jax.sharding.Mesh`` with ('time', 'space') axes instead of MPI ranks.

Public API mirrors the reference surface (reference: src/pymgrit/__init__.py:1-17):
``Mgrit``, ``Application``, ``GridTransfer``, ``GridTransferCopy``,
``simple_setup_problem``, plus the application ("model") zoo.
"""

import os

# MGRIT parity with the reference's numpy-double math (residual histories to
# 1e-10 tolerances) requires fp64.  Enable by default; opt out with
# PYMGRIT_TPU_NO_X64=1 before the first import.
import jax

if not os.environ.get("PYMGRIT_TPU_NO_X64"):
    jax.config.update("jax_enable_x64", True)

# At the default precision a GPU may run float32 matmuls in TF32, which keeps
# about 1e-3 relative accuracy: the spectral implicit solves then carry that
# error into every step and the FAS iteration stalls far above its
# tolerance.  'highest' keeps float32 products in IEEE float32 and float64
# products in float64 (no effect on the CPU).
jax.config.update("jax_default_matmul_precision", "highest")

from pymgrit_tpu.core.application import Application
from pymgrit_tpu.core.grid_transfer import GridTransfer, GridTransferCopy
from pymgrit_tpu.core.hierarchy import simple_setup_problem
from pymgrit_tpu.core.solver import Mgrit
from pymgrit_tpu.core.at_mgrit import AtMgrit
from pymgrit_tpu.core import vector

from pymgrit_tpu.models.dahlquist import Dahlquist
from pymgrit_tpu.models.heat_1d import Heat1D
from pymgrit_tpu.models.heat_2d import Heat2D
from pymgrit_tpu.models.advection_1d import Advection1D
from pymgrit_tpu.models.brusselator import Brusselator
from pymgrit_tpu.models.arenstorf_orbit import ArenstorfOrbit
from pymgrit_tpu.models.allen_cahn import AllenCahn
from pymgrit_tpu.models.heat_1d_2pts import Heat1DBDF1, Heat1DBDF2, PairState
from pymgrit_tpu.models.grid_transfer_heat import GridTransferHeat, GridTransferHeat2D
from pymgrit_tpu.models.diffusion_2d import Diffusion2D

__all__ = [
    "Mgrit",
    "AtMgrit",
    "Application",
    "GridTransfer",
    "GridTransferCopy",
    "simple_setup_problem",
    "vector",
    "Dahlquist",
    "Heat1D",
    "Heat2D",
    "Advection1D",
    "Brusselator",
    "ArenstorfOrbit",
    "AllenCahn",
    "Heat1DBDF1",
    "Heat1DBDF2",
    "PairState",
    "GridTransferHeat",
    "GridTransferHeat2D",
    "Diffusion2D",
]

__version__ = "0.1.0"
