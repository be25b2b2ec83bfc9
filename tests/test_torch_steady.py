"""solve_steady: the port's steady Newton solve against the JAX package's,
in float64, on the CPU (plain versions of the kernels).

Mirrors ``tests/test_steady.py``: the FGMRES path from the Stokes guess (a
plug inflow into ``unit_square(3)``, so the steady flow is not the Stokes
flow) and the SuperLU path from a rough seeded state, where the line search
backtracks.  Both take the same number of Newton iterations and FGMRES
iterations as JAX, the same step lengths alpha, update norms within 1e-10
relative and the same final state within 1e-9.  The runs stop (tol 1e-7)
before the update reaches the float64 rounding floor, where the two
packages' updates are rounding noise (~1e-14 / n) and agree to no digit.
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
from navier_stokes_tpu_torch.fem.windowed_assembly import assemble_windowed
from navier_stokes_tpu_torch.mesh.generate import unit_square
from navier_stokes_tpu_torch.models.navier_stokes import NavierStokesSolver
from navier_stokes_tpu_torch.utils.logging import RunLog

UPDATE_RTOL = 1e-10  # update norms, relative
STATE_ATOL = 1e-9  # final states


def plug_inflow(x, t=0.0):
    v = np.zeros_like(x)
    v[:, 0] = 1.0
    return v


def _config(cls, nu=0.02, matvec="windowed"):
    cfg = cls(inlet_tags=(0,), neumann_tags=(1,), wall_tags=(2, 3), nu=nu, p_out=0.0)
    cfg.dtype = "float64"
    cfg.convection_form = "standard"
    cfg.include_continuity_residual = True
    cfg.jacobian_mass_rho = True
    cfg.krylov.matvec = matvec
    cfg.krylov.cells_per_block = 16
    cfg.krylov.preconditioner = "cahouet_chabard"
    cfg.krylov.rel_tol = 1e-8
    cfg.krylov.max_iters = 800
    return cfg


def _records(log):
    return [r for r in log.records if r.get("event") == "steady_newton"]


@functools.lru_cache(maxsize=None)
def _runs(tangent_solver, rough):
    """(JAX solver, port solver, JAX records, port records, results)."""
    jlog, tlog = JLog(verbose=False), RunLog(verbose=False)
    js = JSolver(j_unit_square(3), _config(JConfig), log=jlog, inlet=plug_inflow).setup()
    ts = NavierStokesSolver(unit_square(3), _config(SolverConfig), log=tlog, inlet=plug_inflow,
                            device="cpu").setup()
    kw = dict(tol=1e-7, max_iters=15, tangent_solver=tangent_solver)
    if rough:  # a rough seeded start: the full Newton step overshoots
        state = np.random.default_rng(0).standard_normal(ts.dofs.n_total)
        js.solution, ts.solution = jnp.asarray(state), torch.as_tensor(state)
        kw["initial_guess"] = "current"
    jout, tout = js.solve_steady(**kw), ts.solve_steady(**kw)
    return js, ts, _records(jlog), _records(tlog), jout, tout


def _compare(tangent_solver, rough):
    js, ts, jr, tr, jout, tout = _runs(tangent_solver, rough)
    assert jout[0] == tout[0] == len(jr) == len(tr)
    assert [r["gmres_iters"] for r in tr] == [r["gmres_iters"] for r in jr]
    assert [r["alpha"] for r in tr] == [r["alpha"] for r in jr]
    for a, b in zip(jr, tr):
        assert abs(a["update"] - b["update"]) <= UPDATE_RTOL * a["update"], (a, b)
        assert abs(a["res_norm"] - b["res_norm"]) <= 1e-8 * a["res_norm"], (a, b)
    assert tout[1] <= 1e-7
    np.testing.assert_allclose(ts.solution.numpy(), np.asarray(js.solution), rtol=0,
                               atol=STATE_ATOL)
    return jr, tr


def test_solve_steady_fgmres_matches_jax_f64():
    """From the Stokes guess: 3 Newton iterations of real size (updates
    ~7e-4, 3e-5, 4e-8 of the state per dof), FGMRES tangents."""
    _, tr = _compare("fgmres", rough=False)
    assert len(tr) == 3 and all(r["gmres_iters"] > 1 for r in tr)


def test_solve_steady_lu_line_search_matches_jax_f64():
    """SuperLU tangents from a rough state: the backtracking line search
    takes shorter steps first (the same alphas as JAX), then full ones."""
    _, tr = _compare("lu", rough=True)
    alphas = [r["alpha"] for r in tr]
    assert min(alphas) < 1.0 and alphas[-1] == 1.0
    assert all(r["gmres_iters"] == 1 for r in tr)


def test_solve_steady_lu_and_fgmres_reach_one_state():
    """The exact (SuperLU) and the Krylov tangent converge to the same
    steady state, and its steady residual is small."""
    _, ts_f, *_ = _runs("fgmres", False)
    _, ts_l, *_ = _runs("lu", True)
    # real dofs: the padding holes of the blocked numbering keep the rough
    # start's values (their rows are identity rows with zero residual)
    for field in ("velocity", "pressure"):
        np.testing.assert_allclose(getattr(ts_l, field)(real_only=True),
                                   getattr(ts_f, field)(real_only=True), rtol=0, atol=1e-8)
    assert np.abs(ts_f.velocity(real_only=True)[:, 0]).max() > 0.5


def test_residual_only_assembly_equals_full():
    """The line search's trial residuals (residual_only=True) equal the
    full assembly's residual, bit for bit; no tangent, no diagonal."""
    _, ts, *_ = _runs("fgmres", False)
    lay = ts._win_layout
    wa = ts._wassembly
    u = ts.solution
    form = dict(dt=1.0, nu=ts.cfg.nu, rho=ts.cfg.rho, convection_form="standard",
                include_continuity_residual=True, include_time_term=False)
    A_t, r_full, diag0 = assemble_windowed(wa, lay, u, u, **form)
    none_a, r_only, none_d = assemble_windowed(wa, lay, u, u, residual_only=True, **form)
    assert none_a is None and none_d is None and A_t is not None and diag0 is not None
    assert torch.equal(r_only, r_full)


def test_solve_steady_refusals():
    cfg = _config(SolverConfig, matvec="flat")
    s = NavierStokesSolver(unit_square(2), cfg, log=RunLog(verbose=False), device="cpu")
    with pytest.raises(NotImplementedError, match="windowed"):
        s.solve_steady()
    s = NavierStokesSolver(unit_square(2), _config(SolverConfig), log=RunLog(verbose=False),
                           device="cpu")
    with pytest.raises(ValueError, match="tangent_solver"):
        s.solve_steady(tangent_solver="umfpack")
