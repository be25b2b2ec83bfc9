"""solve_scanned: the port's chunked time loop against the JAX package's
scanned loop, and against the port's own host loop, in float64 on the CPU.

Mirrors ``tests/test_scanned.py``.  Tolerances: the port's scanned run and
JAX's agree to 1e-9 (state, per-step functionals and reactions; the same
FGMRES counts), the port's scanned run and its ``solve()`` to 1e-6 (the
original's bound: the two loops take different Newton sweeps); a run
resumed from a checkpoint file equals the run without a break bit for bit.
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
from navier_stokes_tpu_torch.models.functionals import BoundaryReaction
from navier_stokes_tpu_torch.models.navier_stokes import NavierStokesSolver
from navier_stokes_tpu_torch.utils.logging import RunLog

JAX_ATOL = 1e-9
HOST_LOOP_ATOL = 1e-6


def _config(cls, scheme="bdf2", T=0.25):
    cfg = cls(inlet_tags=(0,), neumann_tags=(1,), wall_tags=(2, 3),
              nu=0.04, p_out=10.0, dt=0.05, T=T)
    cfg.dtype = "float64"
    cfg.include_continuity_residual = True
    cfg.convection_form = "standard"
    cfg.jacobian_mass_rho = True
    cfg.time_scheme = scheme
    cfg.newton.tol = 1e-10
    cfg.krylov.rel_tol = 1e-6
    cfg.krylov.matvec = "windowed"
    cfg.krylov.cells_per_block = 16
    cfg.krylov.preconditioner = "cahouet_chabard"
    return cfg


def _mk(scheme="bdf2", T=0.25, **kw):
    return NavierStokesSolver(unit_square(3), _config(SolverConfig, scheme, T),
                              log=RunLog(verbose=False), device="cpu", **kw)


def _jax_functional(u):
    return jnp.stack([jnp.linalg.norm(u), u.sum()])


def _functional(u):
    return torch.stack([torch.linalg.vector_norm(u), u.sum()])


@functools.lru_cache(maxsize=None)
def _runs(scheme):
    """JAX's scanned run, the port's scanned run and the port's host loop:
    5 steps, 4 Newton sweeps a step, a functional and the reaction on tag 2."""
    js = JSolver(j_unit_square(3), _config(JConfig, scheme), log=JLog(verbose=False))
    kw = dict(newton_iters=4, chunk=5, reaction_tags=(2,))
    jout = js.solve_scanned(functional=_jax_functional, **kw)
    ts = _mk(scheme)
    tout = ts.solve_scanned(functional=_functional, **kw)
    host = _mk(scheme)
    host.solve()
    return js, jout, ts, tout, host


@pytest.mark.parametrize("scheme", ["bdf1", "bdf2"])
def test_scanned_matches_jax_and_host_loop(scheme):
    js, jout, ts, tout, host = _runs(scheme)
    np.testing.assert_allclose(ts.solution.numpy(), np.asarray(js.solution), rtol=0,
                               atol=JAX_ATOL)
    d = float((ts.solution - host.solution).abs().max())
    assert d < HOST_LOOP_ATOL, d
    assert tout["residual"].shape == (5,) and tout["gmres_iters"].shape == (5,)
    np.testing.assert_array_equal(tout["gmres_iters"], np.asarray(jout["gmres_iters"]))
    # every step after the first Newton-converged far below tol
    assert np.all(tout["residual"][1:] < 1e-8)
    # the post-Newton residuals: 1e-6 relative above the float64 rounding
    # floor (~1e-13 here), where they are rounding noise
    np.testing.assert_allclose(tout["residual"], np.asarray(jout["residual"]), rtol=1e-6,
                               atol=1e-12)
    assert tout["functional"].shape == (5, 2)
    np.testing.assert_allclose(tout["functional"], np.asarray(jout["functional"]),
                               rtol=JAX_ATOL, atol=0)
    np.testing.assert_allclose(tout["reaction"], np.asarray(jout["reaction"]), rtol=0,
                               atol=JAX_ATOL)
    assert ts._step == js._step == host._step == 5 and abs(ts.time - js.time) < 1e-12


@pytest.mark.parametrize("scheme", ["bdf1", "bdf2"])
def test_scanned_reaction_functional(scheme):
    """The in-loop boundary reaction equals BoundaryReaction on the final
    state with the history the last step used (BDF2: u_old_eff, dt/1.5)."""
    _, _, s, out, _ = _runs(scheme)
    rx = BoundaryReaction(s, tags=(2,))
    assert out["reaction"].shape == (5, 2)
    u, uo, uo2 = s.solution, s.solution_old, s.solution_old2
    dt = s.cfg.dt
    if scheme == "bdf2":
        expect = rx.force(u, (4.0 * uo - uo2) / 3.0, dt / 1.5)
    else:
        expect = rx.force(u, uo, dt)
    np.testing.assert_allclose(out["reaction"][-1], expect, rtol=1e-9, atol=1e-11)


def test_scanned_functional_and_progress():
    """A legacy 3-argument callback once a chunk; a functional of
    (u, u_old_eff, dt_res) sees the history the residual used."""
    s = _mk(T=0.15)
    calls = []
    out = s.solve_scanned(
        functional=lambda u, uo, dt: torch.stack([(u - uo).abs().max() / dt]),
        functional_args="u_uold_dt", newton_iters=2, chunk=2,
        progress=lambda step, t, f: calls.append((step, round(t, 12), f.shape)),
    )
    assert out["functional"].shape == (3, 1) and np.all(np.isfinite(out["functional"]))
    assert out["functional"][0, 0] > 0
    assert calls == [(2, 0.1, (2, 1)), (3, 0.15, (1, 1))]
    assert out["reaction"] is None


def test_scanned_progress_modern_callback_not_reinvoked():
    """A progress(step, t, f, res=, iters=) callback that raises TypeError
    itself propagates; it is not called again as a legacy callback."""
    s = _mk(T=0.15)
    calls = []

    def progress(step, t, f, res=None, iters=None):
        calls.append(step)
        raise TypeError("internal bug in the callback")

    with pytest.raises(TypeError, match="internal bug"):
        s.solve_scanned(newton_iters=1, chunk=2, progress=progress)
    assert calls == [2]


def test_scanned_progress_explicit_style_flag():
    """progress_takes_diagnostics overrides the signature: a (*args, **kw)
    callback reads as modern (VAR_KEYWORD); False makes it legacy."""
    for flag, n_args in ((False, 3), (True, 5)):
        calls = []
        _mk(T=0.1).solve_scanned(
            newton_iters=1, chunk=1,
            progress=lambda *args, **kw: calls.append(len(args) + len(kw)),
            progress_takes_diagnostics=flag,
        )
        assert calls == [n_args, n_args]


def _forcing_xt(x, t):
    out = np.zeros_like(x)
    out[:, 0] = 0.1 * t
    return out


def test_forcing_time_dependent_explicit_flag():
    """forcing_time_dependent=True/False overrides the signature; a
    time-dependent forcing is refused by solve_scanned, as in the original."""
    import functools as ft

    s = _mk(forcing=lambda *args: _forcing_xt(*args), forcing_time_dependent=True).setup()
    assert s._forcing_time_dep is True
    with pytest.raises(NotImplementedError, match="static forcing"):
        s.solve_scanned(newton_iters=1)
    s2 = _mk(forcing=ft.partial(_forcing_xt, t=0.0), forcing_time_dependent=False).setup()
    assert s2._forcing_time_dep is False


def test_scanned_checkpoint_resume_bit_identical(tmp_path):
    """A BDF2 run stopped at a chunk edge, written to a checkpoint file and
    resumed in a new solver equals the run without a break, bit for bit
    (BDF2's second history level is in the file)."""
    ck = str(tmp_path / "ck.h5")
    ref = _mk(T=0.30)  # 6 steps
    ref.solve_scanned(chunk=2, newton_iters=2)

    a = _mk(T=0.20)  # 4 steps: 2 whole chunks
    a.solve_scanned(chunk=2, newton_iters=2)
    a.save_checkpoint(ck)

    b = _mk(T=0.30)
    b.restore_checkpoint(ck)
    assert b.solution_old2 is not None and b._step == 4
    b.solve_scanned(chunk=2, newton_iters=2, resume=True)
    assert torch.equal(b.solution, ref.solution)
    assert b._step == 6 and abs(b.time - 0.30) < 1e-12
