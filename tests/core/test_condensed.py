"""Condensed level-0 carry (round-4): mathematical identity with the
full-tube solver.

The condensed mode (core/solver.py, `Mgrit(condensed=True)`, default when
the fine application provides `relax_interval`) stores only the level-0
C-points and evaluates every F-row consumer through the closed-form hook.
An F-relaxation always precedes every F-row read in the reference's sweep
order (reference mgrit.py:261-290), so the histories and the materialized
solution must equal the full algorithm's to roundoff.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from pymgrit_tpu import Mgrit, Heat2D, Heat1D


def _rhs(x, y, t):
    return jnp.sin(jnp.pi * x) * jnp.sin(jnp.pi * y) * jnp.ones_like(t * x * y)


def _ic(x, y):
    return np.sin(np.pi * x) * np.sin(np.pi * y)


def _build(nx=17, nt=129, ms=(4, 4), basis='physical', method='BE'):
    t = np.linspace(0, 1, nt)
    out, s = [], 1
    for lvl in range(len(ms) + 1):
        out.append(Heat2D(x_start=0, x_end=1, y_start=0, y_end=1, nx=nx,
                          ny=nx, a=1.0, rhs=_rhs, init_cond=_ic,
                          t_interval=t[::s], basis=basis, method=method))
        if lvl < len(ms):
            s *= ms[lvl]
    return out


def _pair(kw_build=None, **kw):
    kwb = kw_build or {}
    full = Mgrit(problem=_build(**kwb), tol=1e-300, max_iter=4,
                 logging_lvl=40, condensed=False, **kw)
    rf = full.solve_compiled()['conv']
    cnd = Mgrit(problem=_build(**kwb), tol=1e-300, max_iter=4,
                logging_lvl=40, **kw)
    assert cnd._condensed0
    rc = cnd.solve_compiled()['conv']
    return full, rf, cnd, rc


@pytest.mark.core
@pytest.mark.parametrize("basis,method", [
    ("physical", "BE"),
    pytest.param("physical", "CN", marks=pytest.mark.slow),
    pytest.param("spectral", "BE", marks=pytest.mark.slow),
    ("spectral", "CN"),
])
def test_condensed_matches_full_tube(basis, method):
    full, rf, cnd, rc = _pair(dict(basis=basis, method=method))
    # rtol at the residual floor: histories agree to f64 roundoff in
    # ABSOLUTE terms; the CN tail sits at ~2e-9 where 1e-16 abs noise is
    # ~5e-8 relative
    np.testing.assert_allclose(rc, rf, rtol=1e-6, atol=1e-14)
    du = np.max(np.abs(np.asarray(full.u[0]) - np.asarray(cnd.u[0])))
    assert du < 1e-9, du


@pytest.mark.core
@pytest.mark.parametrize("kw", [
    dict(conv_crit=1),
    pytest.param(dict(conv_crit=2), marks=pytest.mark.slow),
    pytest.param(dict(conv_crit=3), marks=pytest.mark.slow),
    dict(weight_c=1.3),
    dict(cycle_type='F'),
    pytest.param(dict(cf_iter=2), marks=pytest.mark.slow),
    pytest.param(dict(nested_iteration=False), marks=pytest.mark.slow),
])
def test_condensed_solver_options(kw):
    full, rf, cnd, rc = _pair(**kw)
    np.testing.assert_allclose(rc, rf, rtol=1e-9)
    du = np.max(np.abs(np.asarray(full.u[0]) - np.asarray(cnd.u[0])))
    assert du < 1e-9, (kw, du)


@pytest.mark.core
def test_condensed_reentry_and_solve():
    """solve_compiled re-entry (stash restore) and the eager solve() path."""
    full, rf, cnd, rc = _pair()
    rf2 = full.solve_compiled()['conv']
    rc2 = cnd.solve_compiled()['conv']
    np.testing.assert_allclose(rc2, rf2, rtol=1e-6)
    m = Mgrit(problem=_build(), tol=1e-300, max_iter=4, logging_lvl=40)
    np.testing.assert_allclose(m.solve()['conv'], rf, rtol=1e-9)


@pytest.mark.core
def test_condensed_gspmd_mesh():
    """The condensed carry time-shards over a ('time','space') mesh (padded
    to the mesh; dryrun path 8) with serial-equal histories and tube."""
    from pymgrit_tpu.parallel.sharding import make_time_space_mesh
    mesh = make_time_space_mesh(n_time=4, n_space=2)
    full = Mgrit(problem=_build(), tol=1e-300, max_iter=4, logging_lvl=40,
                 condensed=False)
    rf = full.solve_compiled()['conv']
    m = Mgrit(problem=_build(), mesh=mesh, tol=1e-300, max_iter=4,
              logging_lvl=40)
    assert m._condensed0 and m._nc_store0 == 36   # nc=33 padded to 36
    rc = m.solve_compiled()['conv']
    np.testing.assert_allclose(rc, rf, rtol=1e-9)
    du = np.max(np.abs(np.asarray(full.u[0]) - np.asarray(m.u[0])))
    assert du < 1e-9, du


@pytest.mark.core
@pytest.mark.parametrize("crit", [1, pytest.param(3, marks=pytest.mark.slow)])
def test_condensed_gspmd_mesh_jump_criteria(crit):
    """Jump criteria with a PADDED condensed carry: the saved iterate must
    mirror the padded shape for a fixed while-loop carry type (regression:
    round-4 shape mismatch)."""
    from pymgrit_tpu.parallel.sharding import make_time_space_mesh
    mesh = make_time_space_mesh(n_time=4, n_space=2)
    base = Mgrit(problem=_build(), tol=1e-300, max_iter=4, logging_lvl=40,
                 condensed=False, conv_crit=crit).solve_compiled()['conv']
    m = Mgrit(problem=_build(), mesh=mesh, tol=1e-300, max_iter=4,
              logging_lvl=40, conv_crit=crit)
    rc = m.solve_compiled()['conv']
    m.solve_compiled()                     # re-entry with the carried save
    np.testing.assert_allclose(rc, base, rtol=1e-9)


@pytest.mark.core
def test_condensed_heat1d_and_decline():
    """Heat1D engages condensed; a non-uniform grid declines it."""
    def b1(nt, ms):
        t = np.linspace(0, 3, nt)
        out, s = [], 1
        for lvl in range(len(ms) + 1):
            out.append(Heat1D(x_start=0, x_end=2, nx=17, a=1.0,
                              init_cond=lambda x: np.sin(np.pi * x / 2),
                              t_interval=t[::s]))
            if lvl < len(ms):
                s *= ms[lvl]
        return out

    full = Mgrit(problem=b1(129, [4, 4]), tol=1e-300, max_iter=4,
                 logging_lvl=40, condensed=False)
    rf = full.solve_compiled()['conv']
    cnd = Mgrit(problem=b1(129, [4, 4]), tol=1e-300, max_iter=4,
                logging_lvl=40)
    assert cnd._condensed0
    np.testing.assert_allclose(cnd.solve_compiled()['conv'], rf, rtol=1e-9)

    # non-uniform level-0 grid: hook declines -> full-tube path
    t = np.concatenate([np.linspace(0, 1, 65), 1 + 0.7 * np.arange(1, 17)])
    d0 = Heat1D(x_start=0, x_end=2, nx=17, a=1.0, t_interval=t)
    d1 = Heat1D(x_start=0, x_end=2, nx=17, a=1.0, t_interval=t[::4])
    m = Mgrit(problem=[d0, d1], tol=1e-300, max_iter=2, logging_lvl=40)
    assert not m._condensed0
    m.solve_compiled()


@pytest.mark.core
def test_condensed_runtime_params_bound():
    """The jitted drivers receive the application tables as runtime
    operands: the lowered iteration contains no large dense constants."""
    import re
    m = Mgrit(problem=_build(nx=33, nt=257, ms=(8, 4)), tol=1e-300,
              max_iter=2, logging_lvl=40, condensed=False)
    assert m._has_rt

    from pymgrit_tpu.core.solver import bind_runtime_params

    def fn(params, state):
        with bind_runtime_params(m.problem, params):
            return m._iteration_fn(state, lvl0_first_f=True)

    txt = jax.jit(fn).lower(m._rt_params, m._get_state()).as_text()
    dense = sum(len(x) for x in re.findall(r"dense<[^>]*>", txt))
    # the closed-form tables alone would be >1 MB of literals if baked
    assert dense < 400_000, dense


@pytest.mark.core
@pytest.mark.slow   # 12 s history-equality solve; construction-time decline
                    # behavior stays core via test_condensed_decline_warns
def test_condensed_disabled_for_custom_criteria():
    """Subclassed convergence criteria receive the raw level-0 state and
    expect the full tube — condensed must auto-disable for them
    (round-4 review finding)."""
    class CustomCompiled(Mgrit):
        def compiled_convergence_criterion(self, state, aux):
            import jax.numpy as jnp
            norms = self._point_residual_norms(state[0][0])
            conv = jnp.linalg.norm(norms)
            return conv, conv < self.tol, aux

    class CustomEager(Mgrit):
        def convergence_criterion(self, iteration):
            super().convergence_criterion(iteration)

    for cls in (CustomCompiled, CustomEager):
        m = cls(problem=_build(), tol=1e-300, max_iter=2, logging_lvl=40)
        assert not m._condensed0, cls.__name__
        m.solve_compiled()
    # the plain class still condenses
    assert Mgrit(problem=_build(), tol=1e-300, max_iter=1,
                 logging_lvl=40)._condensed0


@pytest.mark.core
def test_hook_kwargs_capability_by_signature():
    """A hook accepting **kwargs (but not interval_major explicitly) must
    NOT be treated as interval-major capable (silent transpose hazard)."""
    from pymgrit_tpu.core.solver import hook_accepts_kwarg

    class Loose(Heat2D):
        def relax_interval(self, seed, t_prev, t_curr, only_last=False, **kw):
            return super().relax_interval(seed, t_prev, t_curr,
                                          only_last=only_last)

    assert not hook_accepts_kwarg(Loose.relax_interval, "interval_major")
    assert hook_accepts_kwarg(Heat2D.relax_interval, "interval_major")

    t = np.linspace(0, 1, 65)
    probs = [Loose(x_start=0, x_end=1, y_start=0, y_end=1, nx=9, ny=9, a=1.0,
                   rhs=_rhs, init_cond=_ic, t_interval=t[::s])
             for s in (1, 4, 16)]
    base = Mgrit(problem=_build(nx=9, nt=65, ms=(4, 4)), tol=1e-300,
                 max_iter=3, logging_lvl=40, condensed=False)
    rf = base.solve_compiled()['conv']
    m = Mgrit(problem=probs, tol=1e-300, max_iter=3, logging_lvl=40)
    rc = m.solve_compiled()['conv']
    np.testing.assert_allclose(rc, rf, rtol=1e-9)
    du = np.max(np.abs(np.asarray(base.u[0]) - np.asarray(m.u[0])))
    assert du < 1e-9, du


@pytest.mark.core
def test_condensed_decline_warns_with_reason(caplog):
    """VERDICT r4 weak-#6: when condensed is requested but declines, ONE
    log line names the reason — most importantly for a user t_interval
    with ~1e-13 dt jitter, which silently lost the 2x fast path before."""
    import logging

    t = np.linspace(0, 1, 129)
    rng = np.random.default_rng(0)
    t_j = t.copy()
    t_j[1:-1] += 1e-13 * rng.standard_normal(127)   # ~1e-11 relative dt jitter
    with caplog.at_level(logging.INFO):
        m = Mgrit(problem=[
            Heat2D(x_start=0, x_end=1, y_start=0, y_end=1, nx=9, ny=9,
                   a=1.0, rhs=_rhs, init_cond=_ic, t_interval=t_j),
            Heat2D(x_start=0, x_end=1, y_start=0, y_end=1, nx=9, ny=9,
                   a=1.0, rhs=_rhs, init_cond=_ic, t_interval=t_j[::4])],
            tol=1e-300, max_iter=1, logging_lvl=40)
    assert not m._condensed0
    assert "not globally uniform" in (m._cnd_decline_reason or "")
    joined = "\n".join(r.message for r in caplog.records)
    assert "condensed level-0 fast path DISABLED" in joined
    assert "np.linspace" in joined

    # custom criterion: a different, named reason
    class Custom(Mgrit):
        def convergence_criterion(self, iteration):
            return super().convergence_criterion(iteration)

    caplog.clear()
    with caplog.at_level(logging.INFO):
        mc = Custom(problem=_build(nx=9, nt=65, ms=(4,)), tol=1e-300,
                    max_iter=1, logging_lvl=40)
    assert not mc._condensed0
    assert "custom convergence criterion" in (mc._cnd_decline_reason or "")
    assert "condensed level-0 fast path DISABLED" in "\n".join(
        r.message for r in caplog.records)

    # engaged path: no decline line
    caplog.clear()
    with caplog.at_level(logging.INFO):
        ok = Mgrit(problem=_build(nx=9, nt=65, ms=(4,)), tol=1e-300,
                   max_iter=1, logging_lvl=40)
    assert ok._condensed0 and ok._cnd_decline_reason is None
    assert "DISABLED" not in "\n".join(r.message for r in caplog.records)

    # condensed=False is an explicit opt-out, not a decline: stays silent
    caplog.clear()
    with caplog.at_level(logging.INFO):
        off = Mgrit(problem=_build(nx=9, nt=65, ms=(4,)), tol=1e-300,
                    max_iter=1, logging_lvl=40, condensed=False)
    assert not off._condensed0
    assert "DISABLED" not in "\n".join(r.message for r in caplog.records)


@pytest.mark.core
def test_condensed_dd_spectral_active_and_matches():
    """The equal-accuracy bench row (dd_toms129) depends on this pairing:
    the closed-form interval hook supports DD in SPECTRAL state, so the
    condensed level-0 carry engages; DD-physical declines (named reason).
    Losing it makes the full 16385-row DD tube the carried state at the
    TOMS scale, with ~3x its size in transients."""
    def build(basis):
        t = np.linspace(0, 1, 129)
        out, s = [], 1
        for _ in range(3):
            out.append(Heat2D(x_start=0, x_end=1, y_start=0, y_end=1, nx=9,
                              ny=9, a=1.0, rhs=_rhs, init_cond=_ic,
                              t_interval=t[::s], basis=basis,
                              precision='dd'))
            s *= 4
        return out

    full = Mgrit(problem=build('spectral'), tol=1e-300, max_iter=4,
                 logging_lvl=40, condensed=False)
    rf = full.solve_compiled()['conv']
    cnd = Mgrit(problem=build('spectral'), tol=1e-300, max_iter=4,
                logging_lvl=40)
    assert cnd._condensed0
    rc = cnd.solve_compiled()['conv']
    # same algorithm, different carry layout/summation order: agreement to
    # DD roundoff (abs ~1e-13 pair floor), not bit equality
    np.testing.assert_allclose(rc, rf, rtol=1e-3, atol=1e-12)

    phys = Mgrit(problem=build('physical'), tol=1e-300, max_iter=1,
                 logging_lvl=40)
    assert not phys._condensed0
    assert "declined this configuration" in (phys._cnd_decline_reason or "")
