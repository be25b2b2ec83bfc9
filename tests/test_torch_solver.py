"""The whole slice: the port's NavierStokesSolver against JAX's, in float64.

Same mesh, same config (windowed operator, Cahouet-Chabard preconditioner,
a non-zero inflow), plain versions on the CPU.  Per-step Newton residuals
agree to 1e-10 relative and every tangent solve takes the same number of
FGMRES iterations; so does a forced Newton step at a seeded state.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from navier_stokes_tpu.config import SolverConfig as JConfig
from navier_stokes_tpu.mesh.generate import unit_square as j_unit_square
from navier_stokes_tpu.models.navier_stokes import NavierStokesSolver as JSolver
from navier_stokes_tpu.utils.logging import RunLog as JLog
from navier_stokes_tpu_torch.config import SolverConfig
from navier_stokes_tpu_torch.mesh.generate import unit_square
from navier_stokes_tpu_torch.models.navier_stokes import NavierStokesSolver
from navier_stokes_tpu_torch.utils.logging import RunLog


def _config(cls, scheme, corrected=False, **krylov):
    cfg = cls()
    if corrected:  # consistent tangent: the formulation flags off their quirks
        cfg.convection_form = "standard"
        cfg.include_continuity_residual = True
        cfg.jacobian_mass_rho = True
        cfg.rho = 1.2
    cfg.dtype = "float64"
    cfg.T, cfg.dt = 0.1, 0.05  # 2 steps
    cfg.time_scheme = scheme
    cfg.inlet_tags, cfg.neumann_tags, cfg.wall_tags = (0,), (1,), (2, 3)
    cfg.inlet.freeze_time, cfg.inlet.H, cfg.inlet.u_m = False, 1.0, 30.0
    cfg.krylov.matvec = "windowed"
    cfg.krylov.preconditioner = "cahouet_chabard"
    cfg.krylov.cells_per_block = 16
    cfg.krylov.max_iters = 500
    for k, v in krylov.items():
        setattr(cfg.krylov, k, v)
    return cfg


def _trajectory(log):
    out, step = [], 0
    for r in log.records:
        if r.get("event") == "time_step":
            step = r["step"]
        elif r.get("event") in ("newton", "gmres"):
            out.append((step, r["event"], r.get("residual", r.get("iters"))))
    return out


@functools.lru_cache(maxsize=None)
def _runs(scheme, corrected=False, **krylov):
    jlog, tlog = JLog(verbose=False), RunLog(verbose=False)
    js = JSolver(j_unit_square(6), _config(JConfig, scheme, corrected, **krylov), log=jlog)
    ts = NavierStokesSolver(
        unit_square(6), _config(SolverConfig, scheme, corrected, **krylov), log=tlog,
        device="cpu",
    )
    js.solve()
    ts.solve()
    return js, ts, _trajectory(jlog), _trajectory(tlog)


def _compare(jt, tt):
    assert [(s, e) for s, e, _ in jt] == [(s, e) for s, e, _ in tt]
    for (s, e, jv), (_, _, tv) in zip(jt, tt):
        if e == "gmres":
            assert jv == tv, (s, jv, tv)
        else:
            assert abs(jv - tv) <= 1e-10 * abs(jv), (s, jv, tv)


@pytest.mark.parametrize("scheme, corrected", [("bdf1", False), ("bdf2", False), ("bdf2", True)])
def test_slice_matches_jax_f64(scheme, corrected):
    js, ts, jt, tt = _runs(scheme, corrected)
    assert sum(e == "gmres" for _, e, _ in tt) >= 2  # real tangent solves ran
    _compare(jt, tt)
    np.testing.assert_allclose(ts.velocity(), js.velocity(), rtol=0, atol=1e-9)
    np.testing.assert_allclose(ts.pressure(), js.pressure(), rtol=0, atol=1e-8)


def test_slice_vcycle_and_gmres_sweeps_match_jax_f64():
    """The cc_cycle_* and a00_solver knobs of the CC preconditioner."""
    _, _, jt, tt = _runs(
        "bdf1", cc_cycle_a00="vcycle", cc_cycle_ap="vcycle", a00_solver="gmres"
    )
    _compare(jt, tt)


def test_forced_newton_step_matches_jax_f64():
    """The benchmark's forced Newton step at a seeded state (numpy seed 0,
    0.05 * standard normal): residual norm, GMRES count and the update."""
    js, ts, _, _ = _runs("bdf1")
    n = ts.dofs.n_total
    state = 0.05 * np.random.default_rng(0).standard_normal(n)
    u_old = np.zeros(n)
    cfg = ts.cfg
    jout = js._newton_iteration(
        jnp.asarray(state), jnp.asarray(u_old),
        jnp.asarray(js.dirichlet.values(cfg.dt)), cfg.dt, True,
    )
    tout = ts._newton_iteration(
        torch.as_tensor(state), torch.as_tensor(u_old),
        torch.as_tensor(ts.dirichlet.values(cfg.dt)), cfg.dt, True,
    )
    assert int(jout[2]) == tout[2] and bool(jout[3]) and tout[3]
    assert abs(float(jout[1]) - tout[1]) <= 1e-10 * float(jout[1])
    np.testing.assert_allclose(tout[0].numpy(), np.asarray(jout[0]), rtol=0, atol=1e-9)


def _forcing_xt(x, t):
    """A body force that changes in time and space."""
    f = np.zeros_like(x)
    f[:, 0] = 2.0 * np.sin(3.0 * t + x[:, 1])
    f[:, 1] = t * x[:, 0]
    return f


@pytest.mark.parametrize("matvec", ["windowed", "flat"])
def test_time_dependent_forcing_matches_jax_f64(matvec):
    """f(x, t) re-evaluated at every new time level (the windowed path's
    r_const, the flat path's f_q): per-step Newton residuals within 1e-10
    relative, the same FGMRES counts, and the same final state (1e-9)."""
    def config(cls):
        cfg = _config(cls, "bdf1", corrected=True)
        cfg.inlet.u_m = 1.0  # the flat path's inner CG stays short
        cfg.krylov.matvec = matvec
        return cfg

    jlog, tlog = JLog(verbose=False), RunLog(verbose=False)
    js = JSolver(j_unit_square(4), config(JConfig), log=jlog, forcing=_forcing_xt)
    ts = NavierStokesSolver(unit_square(4), config(SolverConfig), log=tlog,
                            forcing=_forcing_xt, device="cpu")
    js.solve()
    ts.solve()
    assert ts._forcing_time_dep and ts._matvec == matvec
    jt, tt = _trajectory(jlog), _trajectory(tlog)
    assert sum(e == "gmres" for _, e, _ in tt) >= 2
    _compare(jt, tt)
    np.testing.assert_allclose(ts.solution.numpy(), np.asarray(js.solution), rtol=0, atol=1e-9)
    # the forcing at the last time level is the one in use
    np.testing.assert_allclose(ts.ctx.f_q.numpy(), np.asarray(js.ctx.f_q), rtol=0, atol=1e-14)


@pytest.mark.parametrize(
    "change, solver_kw, match",
    [
        ({}, dict(n_devices=2), "multi-device"),
        (dict(kp_deflate=2), {}, "kp_deflate"),
    ],
)
def test_unported_options_raise(change, solver_kw, match):
    cfg = _config(SolverConfig, "bdf1", **change)
    with pytest.raises(NotImplementedError, match=match):
        NavierStokesSolver(unit_square(3), cfg, log=RunLog(verbose=False), device="cpu",
                           **solver_kw).setup()
