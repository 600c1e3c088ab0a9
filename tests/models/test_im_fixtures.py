"""Committed induction-machine fixture battery (round-5, VERDICT r4
missing-#2): every io_getdp parser runs against the checked-in GetDP/gmsh
fixture family in tests/models/fixtures/im/ — no reference tree, no
tmp-file generation — so a standalone checkout exercises the full parser
surface the way the reference's own checked-in im_3kW fixtures do
(reference tests/induction_machine/test_helper.py).

Fixtures are produced by tools/make_im_fixtures.py (deterministic; see its
docstring for the mesh family). A regeneration test pins the committed
bytes to the generator.
"""

import os
import subprocess
import sys

import numpy as np
import jax.numpy as jnp
import pytest

from pymgrit_tpu.models.induction_machine import io_getdp as io
from pymgrit_tpu.models.induction_machine.grid_transfer_machine import (
    GridTransferMachine)
from pymgrit_tpu.models.induction_machine.machine_state import MachineState

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
FIX = os.path.join(REPO, "tests", "models", "fixtures", "im") + os.sep

N_NODES_C, N_NODES_F = 48, 80
N_DOFS_C, N_DOFS_F = 32, 64


def test_fixture_msh_parsers():
    io.check_version(FIX + "machine_coarse.msh")
    nodes, nodes_r = io.get_nodes(FIX + "machine_coarse.msh")
    assert len(nodes) == N_NODES_C
    # reverse map is consistent
    for tag, xy in list(nodes.items())[:5]:
        assert nodes_r[f"{float(xy[0])!r} {float(xy[1])!r}"] == tag
    lines, tris, lines_r, tris_r = io.get_elements(FIX + "machine_coarse.msh")
    assert len(lines) == 16 and len(tris) == 64
    assert all(len(v) == 3 for v in tris.values())
    # every element vertex is a parsed node
    for v in list(tris.values()) + list(lines.values()):
        for tag in v:
            assert tag in nodes

    fnodes, _ = io.get_nodes(FIX + "machine_fine.msh")
    assert len(fnodes) == N_NODES_F
    # the coarse nodes keep their tags and coordinates in the fine mesh
    for tag, xy in nodes.items():
        np.testing.assert_array_equal(fnodes[tag], xy)


def test_fixture_pre_parsers():
    assert io.get_preresolution(FIX + "machine_coarse.pre") == N_DOFS_C
    assert io.get_preresolution(FIX + "machine_fine.pre") == N_DOFS_F
    c2u, u2c, boundary = io.pre_file(FIX + "machine_coarse.pre")
    assert len(u2c) == N_DOFS_C and len(boundary) == 16
    assert set(c2u) | set(boundary) == {str(t) for t in range(1, N_NODES_C + 1)}


def test_fixture_compute_data_classification():
    """Rotor/stator split of the annulus against the known ring layout."""
    dc = io.compute_data(FIX + "machine_coarse.pre",
                         FIX + "machine_coarse.msh", 0)
    assert dc['pointsCom'].shape == (N_NODES_C, 2)
    assert dc['elecom'].shape == (64, 3)
    assert dc['unknown'].shape == (N_DOFS_C, 2)
    # rotor rings 0.025/0.04 -> 16 inner unknowns; stator 0.055/0.07 -> 16
    assert dc['unknownInner'].shape == (16, 2)
    assert dc['unknownOuter'].shape == (16, 2)
    r_in = np.hypot(*dc['unknownInner'].T)
    r_out = np.hypot(*dc['unknownOuter'].T)
    assert r_in.max() < io.INNER_RADIUS_DEFAULT < r_out.min()
    # boundary rings (0.01 rotor, 0.085 stator) -> 8 + 8
    assert dc['pointsBouInner'].shape == (8, 2)
    assert dc['pointsBouOuter'].shape == (8, 2)
    # unknownCom appends the boundary coords after the unknowns
    assert dc['unknownCom'].shape == (N_DOFS_C + 16, 2)
    np.testing.assert_array_equal(dc['unknownCom'][:N_DOFS_C], dc['unknown'])
    # mappings index into the unknown array and recover the split
    np.testing.assert_array_equal(
        dc['unknown'][dc['mappingInnerToUnknown']], dc['unknownInner'])
    np.testing.assert_array_equal(
        dc['unknown'][dc['mappingOuterToUnknown']], dc['unknownOuter'])


def test_fixture_interpolation_factors():
    dc = io.compute_data(FIX + "machine_coarse.pre",
                         FIX + "machine_coarse.msh", 0)
    df = io.compute_data(FIX + "machine_fine.pre", FIX + "machine_fine.msh",
                         len(dc['corToUn']))
    # injection assumption: coarse unknowns are a prefix of the fine ones
    cu, fu = list(dc['corToUn'].keys()), list(df['corToUn'].keys())
    assert fu[:len(cu)] == cu
    assert df['unknownNew'].shape == (N_DOFS_F - N_DOFS_C, 2)

    fac = io.interpolation_factors(dc, df)
    assert fac['sizeLvlStart'] == N_DOFS_C and fac['sizeLvlStop'] == N_DOFS_F
    assert fac['addBoundInner'] == 8 and fac['addBoundOuter'] == 8

    def f(p):
        return 1.7 * p[:, 0] - 0.4 * p[:, 1] + 0.05

    # (a) reference-default factors (find_simplex tol=0.1): near-edge
    # points may be clamped into a neighboring simplex — approximate by
    # design (reference helper.py:500-518); bounded here
    for com, new, kv, kw in (('unknownComInner', 'unknownNewInner',
                              'vtxInner', 'wtsInner'),
                             ('unknownComOuter', 'unknownNewOuter',
                              'vtxOuter', 'wtsOuter')):
        got = np.asarray(io.compute_mesh_transfer(
            f(dc[com]), fac[kv], fac[kw], 0, 0))
        assert np.max(np.abs(got - f(df[new]))) < 0.02
    # (b) tight simplex location reproduces linear functions exactly
    for com, new in (('unknownComInner', 'unknownNewInner'),
                     ('unknownComOuter', 'unknownNewOuter')):
        vtx, wts = io.interp_weights(dc[com], df[new], tol=1e-12)
        np.testing.assert_allclose(wts.sum(axis=1), 1.0, atol=1e-12)
        got = np.asarray(io.compute_mesh_transfer(f(dc[com]), vtx, wts, 0, 0))
        np.testing.assert_allclose(got, f(df[new]), atol=1e-12)


def test_fixture_grid_transfer_machine_roundtrip():
    """GridTransferMachine on the committed mesh pair: interpolation fills
    the new fine DOFs; restriction injects back to the exact coarse state."""
    tr = GridTransferMachine("machine_coarse", "machine_fine", FIX)
    rng = np.random.default_rng(3)
    u = MachineState(np.ones(2), rng.standard_normal(N_DOFS_C),
                     np.ones(2), np.zeros(8))
    uf = tr.interpolation(u)
    assert uf["middle"].shape == (N_DOFS_F,)
    np.testing.assert_array_equal(np.asarray(uf["middle"][:N_DOFS_C]),
                                  u["middle"])
    # new DOFs are barycentric combinations: bounded by the coarse range
    new = np.asarray(uf["middle"][N_DOFS_C:])
    assert np.isfinite(new).all()
    assert new.max() <= np.asarray(u["middle"]).max() + 1e-12
    assert new.min() >= min(np.asarray(u["middle"]).min(), 0.0) - 1e-12
    ub = tr.restriction(uf)
    np.testing.assert_array_equal(np.asarray(ub["middle"]), u["middle"])


def test_fixture_res_files():
    t, x = io.getdp_read_resolution(FIX + "machine.res", N_DOFS_C)
    # 3 blocks: steps 0, 1, then step 1 RE-STORED -> overwrite in place
    # (reference helper.py:109-119; GetDP re-emits a step on restart)
    assert t.shape == (2,) and x.shape == (2, N_DOFS_C)
    np.testing.assert_allclose(t, [0.0, 0.0001])
    rng = np.random.default_rng(7)
    u0 = np.round(rng.standard_normal(N_DOFS_C), 6)
    rng.standard_normal(N_DOFS_C)                 # the overwritten draw
    u1 = np.round(rng.standard_normal(N_DOFS_C), 6)
    np.testing.assert_allclose(x[0], u0)
    np.testing.assert_allclose(x[1], u1)

    np.testing.assert_allclose(
        io.get_values_from(FIX + "resJL.dat"),
        [30.66582882392347, 29.95473981193864, 28.513970714314594])


def test_fixture_set_resolution_roundtrip(tmp_path):
    """set_resolution output is readable by getdp_read_resolution and
    appends consistently after the committed file's blocks."""
    path = str(tmp_path / "seed.res")
    u = np.linspace(-1, 1, N_DOFS_C)
    io.set_resolution(path, 0.25, u, N_DOFS_C)
    t, x = io.getdp_read_resolution(path, N_DOFS_C)
    np.testing.assert_allclose(t, [0.25])
    np.testing.assert_allclose(x[0], u)


def test_fixture_regeneration_is_deterministic(tmp_path):
    """tools/make_im_fixtures.py reproduces the committed bytes."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    script = os.path.join(REPO, "tools", "make_im_fixtures.py")
    code = (
        "import importlib.util, sys\n"
        f"spec = importlib.util.spec_from_file_location('mk', {script!r})\n"
        "m = importlib.util.module_from_spec(spec)\n"
        "spec.loader.exec_module(m)\n"
        f"m.OUT = {str(tmp_path)!r}\n"
        "m.main()\n"
    )
    subprocess.run([sys.executable, "-c", code], env=env, check=True,
                   capture_output=True, text=True)
    for name in ("machine_coarse.msh", "machine_coarse.pre",
                 "machine_fine.msh", "machine_fine.pre",
                 "machine.res", "resJL.dat"):
        with open(FIX + name) as a, open(tmp_path / name) as b:
            assert a.read() == b.read(), name
