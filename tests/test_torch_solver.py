"""The whole slice: the port's NavierStokesSolver against JAX's, in float64.

Same mesh, same config (windowed operator, Cahouet-Chabard preconditioner,
a non-zero inflow), plain versions on the CPU.  Per-step Newton residuals
agree to 1e-10 relative and every tangent solve takes the same number of
FGMRES iterations; so does a forced Newton step at a seeded state.  The
same holds at Taylor-Hood P3/P2 without a preconditioner; there both
packages' lumped pressure mass is wrong for P2 pressure (a test pins it).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from navier_stokes_tpu.config import SolverConfig as JConfig
from navier_stokes_tpu.mesh.generate import box as j_box
from navier_stokes_tpu.mesh.generate import unit_square as j_unit_square
from navier_stokes_tpu.models.navier_stokes import NavierStokesSolver as JSolver
from navier_stokes_tpu.utils.logging import RunLog as JLog
from navier_stokes_tpu_torch.config import SolverConfig
from navier_stokes_tpu_torch.fem.dofs import make_dofs, renumber_blocked
from navier_stokes_tpu_torch.mesh.generate import box, unit_square
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


def _p3_config(cls):
    """Taylor-Hood P3/P2, the corrected formulation, BDF1, 2 steps, no
    preconditioner (the configuration's default: Cahouet-Chabard scales by
    the lumped pressure mass, wrong at P2 pressure), a gentle inflow
    (u_m 1) and FGMRES(200) capped at 200: every tangent solve of the
    unit_square(4) run converges below the cap (102, 140 and 41 iterations;
    with u_m 30 or restarts of 60 the second solve of a step stalls)."""
    cfg = _config(cls, "bdf1", corrected=True, preconditioner="identity", restart=200,
                  max_iters=200)
    cfg.degree_velocity, cfg.degree_pressure = 3, 2
    cfg.inlet.u_m = 1.0
    return cfg


@functools.lru_cache(maxsize=None)
def _p3_runs():
    jlog, tlog = JLog(verbose=False), RunLog(verbose=False)
    js = JSolver(j_unit_square(4), _p3_config(JConfig), log=jlog)
    ts = NavierStokesSolver(unit_square(4), _p3_config(SolverConfig), log=tlog, device="cpu")
    js.solve()
    ts.solve()
    return js, ts, _trajectory(jlog), _trajectory(tlog), tlog


def test_p3_slice_matches_jax_f64():
    """The slice at P3/P2 (k_v 10, k_p 6) without a preconditioner: the
    same Newton residuals (1e-10 relative) and FGMRES counts, every tangent
    solve converged, the same velocity and pressure (1e-8)."""
    js, ts, jt, tt, tlog = _p3_runs()
    assert (ts._win_layout.k_v, ts._win_layout.k_p) == (10, 6)
    assert sum(e == "gmres" for _, e, _ in tt) >= 3
    assert not [r for r in tlog.records if r.get("event") == "krylov_failure"]
    _compare(jt, tt)
    np.testing.assert_allclose(ts.velocity(), js.velocity(), rtol=0, atol=1e-8)
    np.testing.assert_allclose(ts.pressure(), js.pressure(), rtol=0, atol=1e-8)


def test_p3_forced_newton_step_matches_jax_f64():
    """The forced Newton step at a seeded state at P3/P2: residual norm,
    FGMRES count and the update."""
    js, ts, _, _, _ = _p3_runs()
    _forced_step_matches(js, ts)


def _forced_step_matches(js, ts):
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


def _vertex_pdofs(mesh, dofs):
    """The real pressure dofs that sit on a mesh vertex."""
    key = {tuple(c) for c in np.round(mesh.coords, 9).tolist()}
    real = np.ones(dofs.n_ps, bool) if dofs.p_mask is None else dofs.p_mask
    at = np.array([tuple(c) in key for c in np.round(dofs.p_coords, 9).tolist()])
    return at & real, ~at & real


@pytest.mark.parametrize("dim", [2, 3])
def test_p3_lumped_pressure_mass_matches_jax_and_pins_its_p2_fault(dim):
    """Both packages lump the pressure mass by row sums and keep 1/lumped
    where lumped > 0, else 1.0 (JAX fem/windowed_assembly.py, the port's
    copy).  At P3/P2 the port's inv_mp equals JAX's bit for bit, and both
    carry the fault of that lumping for P2 pressure: the integral of a P2
    vertex function over a triangle is 0, so every vertex entry is 1 over
    a rounding residue (above 1e6) or the 1.0 fallback; over a tetrahedron
    it is -|T|/20 < 0, so every vertex entry takes the 1.0 fallback.  The
    edge (and face) functions lump to positive masses.  This test fails the
    day either package changes its lumping (ROADMAP.md Queue 3)."""
    def cfg(cls):
        c = _p3_config(cls)
        if dim == 3:
            c.inlet_tags, c.neumann_tags, c.wall_tags = (0,), (1,), (2, 3, 4, 5)
        return c

    jmesh, mesh = (j_box(2, 2, 2), box(2, 2, 2)) if dim == 3 else (j_unit_square(6),
                                                                   unit_square(6))
    js = JSolver(jmesh, cfg(JConfig), log=JLog(verbose=False))
    ts = NavierStokesSolver(mesh, cfg(SolverConfig), log=RunLog(verbose=False), device="cpu")
    js.setup()
    ts.setup()
    got, want = ts._wassembly.inv_mp.numpy(), np.asarray(js._wassembly.inv_mp)
    assert got.dtype == want.dtype == np.float64 and np.array_equal(got, want)
    vertex, other = _vertex_pdofs(mesh, ts.dofs)
    assert vertex.sum() == mesh.coords.shape[0] and other.any()
    assert (got[other] > 0).all() and (got[other] < 1e6).all() and (got[other] != 1.0).all()
    if dim == 2:
        assert ((got[vertex] > 1e6) | (got[vertex] == 1.0)).all() and got[vertex].max() > 1e12
    else:
        assert (got[vertex] == 1.0).all()


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
    "change, solver_kw, exc, match",
    [
        (dict(matvec="flat"), dict(n_devices=2), ValueError, "process group has 1 rank"),
        (dict(kp_deflate=2), {}, NotImplementedError, "kp_deflate"),
    ],
)
def test_unported_options_raise(change, solver_kw, exc, match):
    """FGMRES deflation raises NotImplementedError.  Multi-device with the
    flat operator is served (its replicated design, parallel/spmd.py): in a
    process alone it meets the world-size check, as the windowed operator
    does (test_n_devices_must_equal_the_world_size)."""
    cfg = _config(SolverConfig, "bdf1", **change)
    with pytest.raises(exc, match=match):
        NavierStokesSolver(unit_square(3), cfg, log=RunLog(verbose=False), device="cpu",
                           **solver_kw).setup()


def test_n_devices_must_equal_the_world_size():
    """A process alone is a world of one: n_devices 2 or 4 raise, and
    n_devices 1 runs as one device does."""
    cfg = _config(SolverConfig, "bdf1")
    for n in (2, 4):
        with pytest.raises(ValueError, match="process group has 1 rank"):
            NavierStokesSolver(unit_square(3), cfg, log=RunLog(verbose=False), device="cpu",
                               n_devices=n)
    s = NavierStokesSolver(unit_square(3), cfg, log=RunLog(verbose=False), device="cpu",
                           n_devices=1).setup()
    assert s._dist is None and s._group is None


@pytest.mark.parametrize("n", [2, 4])
def test_nb_multiple_gives_one_device_the_ranks_numbering(n):
    """nb_multiple=n on one device takes an n-rank run's numbering: the
    block count rounded up to a multiple of n (unit_square(6) at 16 cells a
    block has 5 blocks alone), the dofs of renumber_blocked(nb_multiple=n);
    the state stays whole (no process group)."""
    cfg = _config(SolverConfig, "bdf1")
    mesh = unit_square(6)
    s = NavierStokesSolver(mesh, cfg, log=RunLog(verbose=False), device="cpu",
                           nb_multiple=n).setup()
    want, _ = renumber_blocked(make_dofs(mesh), cells_per_block=16, nb_multiple=n)
    assert s._win_layout.nb == -(-5 // n) * n and s._dist is None
    np.testing.assert_array_equal(s.dofs.cell_vdofs, want.cell_vdofs)
    np.testing.assert_array_equal(s.dofs.cell_pdofs, want.cell_pdofs)
    assert s._n_state == s.dofs.n_total == want.n_total
