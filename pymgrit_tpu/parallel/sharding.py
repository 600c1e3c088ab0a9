"""Device-mesh distribution of the MGRIT solver state.

Replaces the reference's MPI machinery (reference: src/pymgrit/core/split.py
splits COMM_WORLD into a space x time process grid; mgrit.py:693-713 moves
halo states with tagged isend/recv) with the SPMD model:

* A ``jax.sharding.Mesh`` with axes ('time', 'space') — the analogue of the
  reference's 2D process grid (split.py:10-30).
* Every solver tube's leading (time) axis is sharded over 'time'; optionally
  one spatial axis of the state is sharded over 'space'.
* The batched solver kernels are pure global-view array programs, so XLA
  GSPMD inserts the halo collective-permutes for the +-1 gathers
  (u[cpts-1]) and the psum for residual norms automatically — the entire
  tag-ledger/op_id protocol of the reference (mgrit.py:192-196) has no
  equivalent here; SPMD program order replaces it.

Levels too small to fill the 'time' axis are replicated (the analogue of the
reference's ranks-without-points on coarse levels, mgrit.py:764,
tests/mpi/procs_without_points.py).
"""

from __future__ import annotations

from typing import List, Optional

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_time_space_mesh(n_time: Optional[int] = None, n_space: int = 1,
                         devices=None) -> Mesh:
    """Build a ('time', 'space') device mesh (reference split_communicator,
    split.py:10-30)."""
    devices = list(devices if devices is not None else jax.devices())
    if n_time is None:
        n_time = len(devices) // n_space
    if n_time * n_space > len(devices):
        raise Exception(f"Mesh {n_time}x{n_space} needs more than the "
                        f"{len(devices)} available devices")
    arr = np.array(devices[: n_time * n_space]).reshape(n_time, n_space)
    return Mesh(arr, ("time", "space"))


def leaf_spec(shape, mesh: Mesh, space_axis: Optional[int]) -> P:
    """PartitionSpec for one tube leaf, from its (padded) global shape:
    shard the leading time axis when it divides evenly; optionally one state
    axis over 'space'."""
    n_time = mesh.shape["time"]
    n_space = mesh.shape["space"]
    ndim = len(shape)
    time_part = "time" if (n_time > 1 and shape[0] >= n_time and shape[0] % n_time == 0) else None
    parts = [time_part] + [None] * (ndim - 1)
    if (space_axis is not None and n_space > 1 and ndim >= space_axis + 2
            and shape[space_axis + 1] % n_space == 0):
        parts[space_axis + 1] = "space"
    return P(*parts)


def state_shardings(state, levels, mesh: Mesh, space_axis: Optional[int]):
    """Build a sharding pytree matching the solver state (u, v, g tuples)."""

    def shard_level(tube, lvl):
        if tube is None:
            return None
        return jax.tree_util.tree_map(
            lambda x: NamedSharding(mesh, leaf_spec(np.shape(x), mesh, space_axis)),
            tube)

    u, v, g = state
    su = tuple(shard_level(t, l) for l, t in enumerate(u))
    sv = tuple(shard_level(t, l) for l, t in enumerate(v))
    sg = tuple(shard_level(t, l) for l, t in enumerate(g))
    return (su, sv, sg)


def shard_state(state, shardings):
    """device_put every tube onto its sharding."""

    def put(x, s):
        return jax.device_put(x, s) if s is not None else x

    return jax.tree_util.tree_map(put, state, shardings,
                                  is_leaf=lambda x: x is None)
