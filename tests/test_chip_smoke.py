"""chip_smoke.py on the CPU: it refuses to report a result without a GPU,
and every phase runs here at a tiny size with the comparisons it makes on
the card."""

import os
import shutil
import subprocess
import sys

import jax
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402
from pymgrit_tpu.utils import compile_cache  # noqa: E402


def _run_script(script, cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, script], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_refuses_without_gpu():
    p = _run_script(os.path.join(REPO, "chip_smoke.py"), REPO)
    assert p.returncode != 0
    assert '"ok": true' not in p.stdout
    assert "needs a GPU" in p.stderr


def test_refuses_outside_a_checkout(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    p = _run_script(str(tmp_path / "chip_smoke.py"), str(tmp_path))
    assert p.returncode != 0
    assert '"ok": true' not in p.stdout


TINY = {
    "goldens": {},
    "toms": dict(nx=17, nt=257, coarsening=(4, 4, 4, 2)),
    "executors": dict(nx=17, nt=257, ms=(4, 4, 4, 2)),
    # the width at which NONLINEAR_CPU_DIFF was measured
    "nonlinear": dict(nx=32),
    "prefix": dict(nt=4097, t_stop=102.4),
    "dd": dict(ks=(127, 1100), mn=16, n_pairs=4096),
}


@pytest.mark.parametrize("phase", list(TINY))
def test_phase_tiny(phase):
    getattr(chip_smoke, phase)(**TINY[phase])


def test_phases_are_all_covered():
    assert [p.__name__ for p in chip_smoke.SINGLE_PHASES] == list(TINY)


def test_four_on_virtual_cpus():
    chip_smoke.four(nx=9, nt=65, coarsening=(4, 4), k=8, space_nx=8,
                    devices=jax.devices()[:4])


def test_four_refuses_a_truncating_window():
    with pytest.raises(ValueError, match="truncates"):
        chip_smoke.four(nx=9, nt=65, coarsening=(4, 4), k=2,
                        devices=jax.devices()[:4])


def test_report_fails_on_missed_bound():
    rep = chip_smoke.Report("unit")
    assert rep.check("inside", 1.0, 1.0, "equal is inside")
    assert not rep.check("nan", float("nan"), 1.0, "nan never passes")
    with pytest.raises(chip_smoke.PhaseFailed, match="nan"):
        rep.done()


def test_history_check_rounding_unit():
    """rtol governs histories; a floor, where given, admits absolute
    differences of the residual's rounding level, and a length mismatch
    always fails."""
    rep = chip_smoke.Report("unit")
    chip_smoke.history_check(rep, "equal", [1e-3, 1e-6], [1e-3, 1e-6])
    floor = chip_smoke.residual_floor([[3.0, 4.0]], nx=100)
    assert floor == 10 * 5 * 2.0 ** -52
    chip_smoke.history_check(rep, "near floor", [1e-3, 1e-12 + floor],
                             [1e-3, 1e-12], floor)
    assert not rep.failed
    chip_smoke.history_check(rep, "no floor", [1e-3, 1e-12 + floor],
                             [1e-3, 1e-12])
    chip_smoke.history_check(rep, "rtol", [1e-3 * (1 + 1e-6)], [1e-3], floor)
    chip_smoke.history_check(rep, "length", [1e-3], [1e-3, 1e-6])
    assert len(rep.failed) == 3


@pytest.mark.parametrize("env_dir", [None, "custom"])
def test_compile_cache_dir(monkeypatch, tmp_path, env_dir):
    """JAX_COMPILATION_CACHE_DIR wins when set; otherwise the fixed
    <checkout>/.jax_cache."""
    updates = []
    monkeypatch.setattr(jax.config, "update",
                        lambda name, value: updates.append((name, value)))
    if env_dir:
        want = str(tmp_path / env_dir)
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", want)
        assert compile_cache.configure_compile_cache() == want
        assert updates == []
    else:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        want = os.path.join(REPO, ".jax_cache")
        assert compile_cache.configure_compile_cache() == want
        assert updates == [("jax_compilation_cache_dir", want)]
