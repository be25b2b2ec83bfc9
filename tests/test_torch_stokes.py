"""Stokes, the Stokes initial guess and the block preconditioners: the port
against the JAX package, in float64.

* ``StokesSolver`` flat and windowed, with both block preconditioners (and
  the windowed inner FGMRES on A00): the same FGMRES count, solutions within
  1e-9, and the exact Poiseuille flow within the bounds of
  ``tests/test_stokes.py``.
* ``stokes_initial_guess`` flat and windowed, and a run started from it.
* 3 BDF1 steps with ``block_diagonal`` and ``block_triangular``, flat and
  windowed: the same Newton residuals, within 1e-10 of each step's entry
  residual, and the same FGMRES counts.
* A mesh whose windowed layout is infeasible falls back to the flat path in
  both packages (the layout function is made to refuse).
"""

import functools

import numpy as np
import pytest

from navier_stokes_tpu.config import SolverConfig as JConfig
from navier_stokes_tpu.mesh.generate import unit_square as j_unit_square
from navier_stokes_tpu.models.navier_stokes import NavierStokesSolver as JSolver
from navier_stokes_tpu.models.stokes import StokesSolver as JStokes
from navier_stokes_tpu.utils.logging import RunLog as JLog
from navier_stokes_tpu_torch.config import SolverConfig
from navier_stokes_tpu_torch.mesh.generate import unit_square
from navier_stokes_tpu_torch.models.navier_stokes import NavierStokesSolver
from navier_stokes_tpu_torch.models.stokes import StokesSolver
from navier_stokes_tpu_torch.utils.logging import RunLog

NU, RHO, POUT = 0.04, 1.0, 10.0


def poiseuille_inlet(x, t=0.0):
    v = np.zeros_like(x)
    v[:, 0] = x[:, 1] * (1.0 - x[:, 1])
    return v


def _stokes_config(cls, matvec, precond, a00_solver="cg"):
    cfg = cls(inlet_tags=(0,), neumann_tags=(1,), wall_tags=(2, 3), nu=NU, rho=RHO, p_out=POUT)
    cfg.dtype = "float64"
    cfg.krylov.matvec = matvec
    cfg.krylov.cells_per_block = 16
    cfg.krylov.preconditioner = precond
    cfg.krylov.a00_solver = a00_solver
    cfg.krylov.max_iters = 4000
    return cfg


def _gmres(log):
    return [r["iters"] for r in log.records if r.get("event") == "gmres"]


@pytest.mark.parametrize(
    "matvec, precond, a00_solver",
    [("flat", "block_triangular", "cg"), ("flat", "block_diagonal", "cg"),
     ("windowed", "block_triangular", "cg"), ("windowed", "block_diagonal", "cg"),
     ("windowed", "block_triangular", "gmres")],
)
def test_stokes_solver_matches_jax_f64(matvec, precond, a00_solver):
    js = JStokes(j_unit_square(4), _stokes_config(JConfig, matvec, precond, a00_solver),
                 log=JLog(verbose=False), inlet=poiseuille_inlet)
    ts = StokesSolver(unit_square(4), _stokes_config(SolverConfig, matvec, precond, a00_solver),
                      log=RunLog(verbose=False), inlet=poiseuille_inlet, device="cpu")
    js.solve()
    ts.solve()
    assert (ts._ns is not None) == (matvec == "windowed")
    assert _gmres(ts.log) == _gmres(js.log) and len(_gmres(ts.log)) == 1
    assert ts.result.converged
    np.testing.assert_allclose(ts.velocity(), js.velocity(), rtol=0, atol=1e-9)
    np.testing.assert_allclose(ts.pressure(), js.pressure(), rtol=0, atol=1e-9)
    # the exact Poiseuille flow, within tests/test_stokes.py's bounds
    real = matvec == "windowed"
    vmask = ts.dofs.v_mask if real else slice(None)
    pmask = ts.dofs.p_mask if real else slice(None)
    vc, pc = ts.dofs.v_coords[vmask], ts.dofs.p_coords[pmask]
    ue = np.stack([vc[:, 1] * (1 - vc[:, 1]), np.zeros(len(vc))], axis=1)
    pe = POUT + 2 * NU * RHO * (1 - pc[:, 0])
    u_tol, p_tol = (3e-5, 3e-4) if real else (5e-5, 5e-3)
    assert np.abs(ts.velocity(real_only=real) - ue).max() < u_tol
    assert np.abs(ts.pressure(real_only=real) - pe).max() < p_tol


def _forcing_xt(x, t):
    """A body force that changes in time and space."""
    f = np.zeros_like(x)
    f[:, 0] = np.cos(2.0 * t) * x[:, 1]
    f[:, 1] = 0.5 + t * x[:, 0]
    return f


@pytest.mark.parametrize("matvec", ["flat", "windowed"])
def test_stokes_time_dependent_forcing_matches_jax_f64(matvec):
    """StokesSolver with f(x, t): the flat path evaluates it at the solve's
    time, the windowed path at its setup (t = 0), as in the original; the
    same FGMRES count and solutions within 1e-9."""
    cfg = functools.partial(_stokes_config, matvec=matvec, precond="block_triangular")
    js = JStokes(j_unit_square(4), cfg(JConfig), log=JLog(verbose=False),
                 inlet=poiseuille_inlet, forcing=_forcing_xt)
    ts = StokesSolver(unit_square(4), cfg(SolverConfig), log=RunLog(verbose=False),
                      inlet=poiseuille_inlet, forcing=_forcing_xt, device="cpu")
    js.solve(0.7)
    ts.solve(0.7)
    assert _gmres(ts.log) == _gmres(js.log) and ts.result.converged
    np.testing.assert_allclose(ts.velocity(), js.velocity(), rtol=0, atol=1e-9)
    np.testing.assert_allclose(ts.pressure(), js.pressure(), rtol=0, atol=1e-9)
    # the forcing moved the flow off Poiseuille
    vc = ts.dofs.v_coords
    assert np.abs(ts.velocity()[:, 0] - vc[:, 1] * (1 - vc[:, 1])).max() > 1e-3


def _ns_config(cls, matvec, precond, T=0.15, initial_guess="zero"):
    cfg = cls()
    cfg.dtype = "float64"
    cfg.T, cfg.dt = T, 0.05
    cfg.initial_guess = initial_guess
    cfg.inlet_tags, cfg.neumann_tags, cfg.wall_tags = (0,), (1,), (2, 3)
    cfg.inlet.freeze_time, cfg.inlet.H, cfg.inlet.u_m = False, 1.0, 1.0
    cfg.krylov.matvec = matvec
    cfg.krylov.preconditioner = precond
    cfg.krylov.cells_per_block = 16
    cfg.krylov.max_iters = 500
    return cfg


def _trajectory(log):
    out, step = [], 0
    for r in log.records:
        if r.get("event") == "time_step":
            step = r["step"]
        elif r.get("event") in ("newton", "gmres", "krylov_failure"):
            out.append((step, r["event"], r.get("residual", r.get("iters"))))
    return out


def _compare(jt, tt):
    """Same events; FGMRES counts equal; each Newton residual within 1e-10
    of its step's entry residual (a converged row is 1e-4 of the entry, so
    float64 rounding through the inner solves shows at ~1e-13 absolute)."""
    assert [(s, e) for s, e, _ in jt] == [(s, e) for s, e, _ in tt]
    entry = {}
    for (s, e, jv), (_, _, tv) in zip(jt, tt):
        if e == "gmres":
            assert jv == tv, (s, jv, tv)
        else:
            entry.setdefault(s, abs(jv))
            assert abs(jv - tv) <= 1e-10 * entry[s], (s, jv, tv)


@functools.lru_cache(maxsize=None)
def _runs(matvec, precond, T=0.15, initial_guess="zero", n=6):
    jlog, tlog = JLog(verbose=False), RunLog(verbose=False)
    js = JSolver(j_unit_square(n), _ns_config(JConfig, matvec, precond, T, initial_guess),
                 log=jlog)
    ts = NavierStokesSolver(
        unit_square(n), _ns_config(SolverConfig, matvec, precond, T, initial_guess),
        log=tlog, device="cpu",
    )
    js.solve()
    ts.solve()
    return js, ts, _trajectory(jlog), _trajectory(tlog)


@pytest.mark.parametrize("matvec", ["flat", "windowed"])
@pytest.mark.parametrize("precond", ["block_diagonal", "block_triangular"])
def test_block_preconditioners_match_jax_f64(matvec, precond):
    js, ts, jt, tt = _runs(matvec, precond)
    assert ts._matvec == matvec and (ts._win_layout is not None) == (matvec == "windowed")
    assert sum(e == "gmres" for _, e, _ in tt) >= 3  # real tangent solves ran
    assert not any(e == "krylov_failure" for _, e, _ in tt)
    _compare(jt, tt)
    np.testing.assert_allclose(ts.velocity(), js.velocity(), rtol=0, atol=1e-9)


@pytest.mark.parametrize(
    "matvec, precond",
    [("flat", "cahouet_chabard"), ("windowed", "cahouet_chabard"), ("windowed", "block_diagonal")],
)
def test_stokes_initial_guess_matches_jax_f64(matvec, precond):
    """A run from the Stokes initial guess: the guess itself (its FGMRES
    count and vector) and the Newton trajectory after it.  On the flat path
    cahouet_chabard degrades to block_triangular in both packages."""
    js, ts, jt, tt = _runs(matvec, precond, T=0.1, initial_guess="stokes")
    jg = [r for r in js.log.records if r.get("system") == "stokes"]
    tg = [r for r in ts.log.records if r.get("system") == "stokes"]
    assert len(tg) == 1 and tg == jg
    assert ts.stokes_result.converged
    _compare(jt, tt)
    x_j = np.asarray(js.stokes_initial_guess(0.0))
    x_t = ts.stokes_initial_guess(0.0).numpy()
    np.testing.assert_allclose(x_t, x_j, rtol=0, atol=1e-9)


def test_infeasible_layout_falls_back_to_flat(monkeypatch):
    """Both packages take the flat path, where cahouet_chabard becomes
    block_triangular; the runs then agree."""
    import navier_stokes_tpu.ops.windowed as j_windowed
    import navier_stokes_tpu_torch.models.navier_stokes as t_ns

    def refuse(*args, **kwargs):
        raise ValueError("halo too wide")

    monkeypatch.setattr(j_windowed, "build_windowed_layout", refuse)
    monkeypatch.setattr(t_ns, "build_windowed_layout", refuse)
    jlog, tlog = JLog(verbose=False), RunLog(verbose=False)
    js = JSolver(j_unit_square(4), _ns_config(JConfig, "windowed", "cahouet_chabard", T=0.1),
                 log=jlog)
    ts = NavierStokesSolver(
        unit_square(4), _ns_config(SolverConfig, "windowed", "cahouet_chabard", T=0.1),
        log=tlog, device="cpu",
    )
    js.solve()
    ts.solve()
    assert js._matvec == ts._matvec == "flat" and ts._win_layout is None
    assert ts._precond == "block_triangular"
    _compare(_trajectory(jlog), _trajectory(tlog))
