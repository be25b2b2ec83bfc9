"""FGMRES deflation (``deflate=``) and ``kp_deflate``'s Schur-paired Kp modes:
the port against JAX's, in float64 on the CPU.

* ``fgmres(deflate=...)`` on one seeded dense system with a near-null
  direction, k_d 1, 2 and 4 at restart 8 (the solve restarts): equal
  iteration counts and converged flags, x within 1e-10 of its size.  The
  rows include the near-null direction and, at k_d 2 and 4, a row whose
  image is already spanned (the skipped slot).
* The weakly pinned channel of tests/test_kp_deflation.py (576 cells, the
  outlet one short edge): JAX's four checks of the probe and the pairing,
  mirrored; the port's rows against JAX's up to sign (ARPACK's random start
  carries over from call to call, so JAX's sign is the eigensolver's
  choice, while the port fixes its own: |cos| >= 1 - 1e-8), the port's
  repeated from build to build; none on a 3D box.
* Two BDF1 steps on that channel with kp_deflate 2 (Cahouet-Chabard, no
  Kp coarse space), the port's rows given JAX's signs: equal FGMRES
  counts, Newton rows within 1e-9 relative; kp_deflate 0 is the control
  whose counts must differ.  The Stokes guess and a steady Newton
  iteration, deflated, likewise.
* Two gloo ranks (tests/torch_spmd_ranks.py ``deflation``): a deflated
  forced step equal to one device's at the ranks' numbering (equal counts,
  the update within 1e-10).
"""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from navier_stokes_tpu.config import SolverConfig as JConfig
from navier_stokes_tpu.la.gmres import fgmres as j_fgmres
from navier_stokes_tpu.mesh.generate import rectangle as j_rectangle
from navier_stokes_tpu.models.navier_stokes import NavierStokesSolver as JSolver
from navier_stokes_tpu.utils.logging import RunLog as JLog
from navier_stokes_tpu_torch import convert
from navier_stokes_tpu_torch.config import SolverConfig
from navier_stokes_tpu_torch.la.gmres import fgmres as t_fgmres
from navier_stokes_tpu_torch.mesh.generate import box, rectangle
from navier_stokes_tpu_torch.models.navier_stokes import NavierStokesSolver
from navier_stokes_tpu_torch.utils.logging import RunLog

import torch_spmd_ranks as ranks

N = 60
RESTART = 8


def _system():
    """(A, b, rows): A = 2 I + N(0, 1/N) with one direction v squeezed to a
    1e-5 image (near-null), a seeded right-hand side, and unit rows."""
    rng = np.random.default_rng(11)
    A = 2.0 * np.eye(N) + rng.standard_normal((N, N)) / np.sqrt(N)
    v, r1, r2 = (x / np.linalg.norm(x) for x in rng.standard_normal((3, N)))
    A = A - (1.0 - 1e-5) * np.outer(A @ v, v)
    b = rng.standard_normal(N)
    spanned = (v - r1) / np.linalg.norm(v - r1)
    return A, b, {1: [v], 2: [v, -v], 4: [v, r1, spanned, r2]}


@pytest.mark.parametrize("k_d", [1, 2, 4])
def test_fgmres_deflation_matches_jax(k_d):
    A, b, rows = _system()
    D = np.stack(rows[k_d])
    dinv = 1.0 / np.diag(A)
    atol = 1e-10 * np.linalg.norm(b)
    jr = j_fgmres(lambda v: jnp.asarray(A) @ v, jnp.asarray(b), atol=atol, restart=RESTART,
                  maxiter=400, precond=lambda v: jnp.asarray(dinv) * v,
                  deflate=jnp.asarray(D))
    tA, tdinv = torch.as_tensor(A), torch.as_tensor(dinv)
    tr = t_fgmres(lambda v: tA @ v, torch.as_tensor(b), atol=atol, restart=RESTART,
                  maxiter=400, precond=lambda v: tdinv * v, deflate=torch.as_tensor(D))
    assert bool(jr.converged) and tr.converged
    assert int(jr.iters) == tr.iters > RESTART  # restarted cycles
    jx = np.asarray(jr.x)
    np.testing.assert_allclose(tr.x.numpy(), jx, rtol=0, atol=1e-10 * np.abs(jx).max())


def test_fgmres_deflation_space_must_fit_the_restart():
    A, b, rows = _system()
    with pytest.raises(ValueError, match="restart window"):
        t_fgmres(lambda v: torch.as_tensor(A) @ v, torch.as_tensor(b), atol=1e-8, restart=4,
                 deflate=torch.as_tensor(np.stack(rows[4])))


# ---- the probe and the pairing (tests/test_kp_deflation.py) ----------------


def _solver(neumann, inlet=(0,), walls=(2, 3), nx=48, ny=6, x1=4.0, y1=0.4, verbose=False,
            **kryl):
    cfg = SolverConfig(inlet_tags=inlet, neumann_tags=neumann, wall_tags=walls,
                       nu=0.001, dt=0.05)
    cfg.krylov.matvec = "windowed"
    cfg.krylov.cells_per_block = 64
    cfg.krylov.preconditioner = "cahouet_chabard"
    for k, v in kryl.items():
        setattr(cfg.krylov, k, v)
    return NavierStokesSolver(rectangle(nx, ny, 0, x1, 0, y1), cfg, log=RunLog(verbose=verbose),
                              device="cpu").setup()


def test_weakly_pinned_channel_gets_paired_modes(capsys):
    """Kept modes, each followed by its velocity-response row; set-up says
    how many."""
    s = _solver(neumann=(1,), kp_deflate=2, verbose=True)
    rows = s._wassembly.kp_modes.shape[0]
    assert f"Kp deflation: {rows} near-null mode(s)" in capsys.readouterr().out
    m = s._wassembly.kp_modes
    assert m is not None and m.dtype == torch.float32  # the ctx dtype
    m = m.double().numpy()
    assert m.shape[0] in (2, 4) and m.shape[0] % 2 == 0
    n_u = s.dofs.n_u
    for i in range(0, m.shape[0], 2):  # rows alternate (0, w) / (u_w, 0)
        assert np.linalg.norm(m[i, :n_u]) == 0.0
        assert np.linalg.norm(m[i, n_u:]) > 0.9
        assert np.linalg.norm(m[i + 1, n_u:]) == 0.0
        assert np.linalg.norm(m[i + 1, :n_u]) > 0.9
    np.testing.assert_allclose(np.linalg.norm(m, axis=1), 1.0, rtol=1e-5)


def test_unpinned_cavity_skips_deflation_and_coarse():
    s = _solver(neumann=(), inlet=(), walls=(0, 1, 2, 3), nx=12, ny=12, x1=1.0, y1=1.0,
                kp_deflate=2, cc_coarse_agg=-1)
    assert s._wassembly.kp_modes is None
    assert s._wassembly.coarse_inv is None


def test_kp_deflate_zero_disables_rows():
    s = _solver(neumann=(1,), kp_deflate=0, cc_coarse_agg=0)
    assert s._wassembly.kp_modes is None


def test_explicit_coarse_agg_overrides_auto():
    s = _solver(neumann=(1,), kp_deflate=0, cc_coarse_agg=16)
    assert s._wassembly.coarse_inv is not None


@functools.lru_cache(maxsize=None)
def _pair(kp_deflate):
    """(JAX solver, port solver, JAX log, port log) after 2 BDF1 steps of
    ``ranks.channel_config``."""
    jlog, tlog = JLog(verbose=False), RunLog(verbose=False)
    js = JSolver(ranks.channel_mesh(j_rectangle), ranks.channel_config(JConfig, kp_deflate),
                 log=jlog).setup()
    ts = NavierStokesSolver(ranks.channel_mesh(), ranks.channel_config(SolverConfig, kp_deflate),
                            log=tlog, device="cpu").setup()
    _signs_of_jax(js, ts)
    js.solve()
    ts.solve()
    return js, ts, jlog, tlog


def _cos(a, b):
    return abs(a @ b) / (np.linalg.norm(a) * np.linalg.norm(b))


def _signs_of_jax(js, ts):
    """Give the port's rows JAX's signs (JAX keeps ARPACK's, whose random
    start carries over from call to call; the port fixes its own), so that
    both solves run on one set of rows."""
    jm, wa = js._wassembly.kp_modes, ts._wassembly
    if jm is None:
        return
    tm = wa.kp_modes.double().numpy()
    flip = np.where(np.einsum("ij,ij->i", np.asarray(jm), tm) < 0, -1.0, 1.0)
    ts._wassembly = dataclasses.replace(
        wa, kp_modes=wa.kp_modes * torch.as_tensor(flip, dtype=wa.kp_modes.dtype)[:, None])


def test_kp_modes_match_jax_up_to_sign():
    js, ts, _, _ = _pair(2)
    jm, tm = np.asarray(js._wassembly.kp_modes), ts._wassembly.kp_modes.numpy()
    assert jm.shape == tm.shape == (4, ts.dofs.n_total)
    for i in range(4):
        assert _cos(jm[i], tm[i]) >= 1 - 1e-8, i
    # convert carries the rows across
    back = convert.assembly_from_arrays(convert.arrays_of(js._wassembly))
    np.testing.assert_array_equal(back.kp_modes.numpy(), jm)


def test_kp_modes_repeat_from_build_to_build():
    """The probe fixes each mode's sign: a second set-up in this process
    (ARPACK's start vector drawn anew) gives the same rows."""
    rows = [_solver(neumann=(1,), kp_deflate=2, cc_coarse_agg=0)._wassembly.kp_modes
            for _ in range(2)]
    assert rows[0].shape[0] == 4
    torch.testing.assert_close(rows[1], rows[0], rtol=0, atol=1e-6)


def test_kp_modes_none_in_3d():
    cfg = ranks.box_config("cahouet_chabard", kp_deflate=2)
    s = NavierStokesSolver(box(2, 2, 2), cfg, log=RunLog(verbose=False), device="cpu").setup()
    assert s._win_layout is not None and s._wassembly.kp_modes is None


def _rows(log):
    """[(event, value)] of the Newton rows and FGMRES counts in a log."""
    return [(r["event"], r.get("residual", r.get("iters"))) for r in log.records
            if r.get("event") in ("newton", "gmres")]


def _same(jrows, trows, rel=1e-9):
    assert [e for e, _ in jrows] == [e for e, _ in trows]
    for (e, jv), (_, tv) in zip(jrows, trows):
        if e == "gmres":
            assert jv == tv, (jv, tv)
        else:
            assert abs(jv - tv) <= rel * abs(jv), (jv, tv)


@pytest.mark.parametrize("kp_deflate", [2, 0])
def test_deflated_steps_match_jax(kp_deflate):
    """Two BDF1 steps: FGMRES counts equal to JAX's, Newton rows within
    1e-9; the deflated counts differ from the control's."""
    js, ts, jlog, tlog = _pair(kp_deflate)
    _same(_rows(jlog), _rows(tlog))
    np.testing.assert_allclose(ts.velocity(), js.velocity(), rtol=0, atol=1e-9)
    counts = [[v for e, v in _rows(_pair(k)[3]) if e == "gmres"] for k in (2, 0)]
    assert counts[0] != counts[1]


def test_deflated_stokes_guess_and_solve_steady_match_jax():
    """At nu 0.05 with the inflow switched on (u_m 0.1 at t = 4, a peak of
    the ramp), the Stokes guess (block_triangular, deflated as the
    solver's Cahouet-Chabard configuration asks), then one steady Newton
    iteration from it: the Stokes count and the steady FGMRES count and
    line-search step equal to JAX's; the Stokes vector within 1e-9 of its
    size, the steady entry ||r|| and the update's norm within 1e-9
    relative.  (At nu 1e-3 the steady tangent solve stalls, as the
    weakly pinned channel's solves do in both packages.)"""
    out = []
    for cls, solver, mesh, log, kw, to in (
            (JConfig, JSolver, ranks.channel_mesh(j_rectangle), JLog(verbose=False), {},
             jnp.asarray),
            (SolverConfig, NavierStokesSolver, ranks.channel_mesh(), RunLog(verbose=False),
             dict(device="cpu"), torch.as_tensor)):
        cfg = ranks.channel_config(cls)
        cfg.nu = 0.05
        cfg.inlet.freeze_time, cfg.inlet.H, cfg.inlet.u_m = False, 0.4, 0.1
        s = solver(mesh, cfg, log=log, **kw)
        s.setup()
        if out:
            _signs_of_jax(out[0][3], s)
        s.time = 4.0
        guess = np.asarray(s.stokes_initial_guess(s.time))
        s.solution = to(guess)
        s.solve_steady(max_iters=1, initial_guess="current")
        assert s._wassembly.kp_modes.shape[0] == 4
        stokes = [r["iters"] for r in log.records if r.get("system") == "stokes"]
        steady = [r for r in log.records if r.get("event") == "steady_newton"]
        out.append((guess, stokes, steady, s))
    (jg, jstokes, jsteady, _), (tg, tstokes, tsteady, _) = out
    assert jstokes == tstokes and len(tstokes) == 1
    np.testing.assert_allclose(tg, jg, rtol=0, atol=1e-9 * np.abs(jg).max())
    assert len(jsteady) == len(tsteady) == 1
    j, t = jsteady[0], tsteady[0]
    assert j["gmres_iters"] == t["gmres_iters"] and j["alpha"] == t["alpha"]
    for key in ("res_norm", "update"):
        assert abs(j[key] - t[key]) <= 1e-9 * j[key], key


def test_two_ranks_deflated_step_matches_one_device(tmp_path):
    ranks.spawn(ranks.deflation, 2, f"file://{tmp_path}/store", str(tmp_path))
    got = torch.load(tmp_path / "deflation.pt", weights_only=False)
    want = ranks.deflated_step(None, nb_multiple=2)
    assert got["rows"] == want["rows"] == 4
    assert got["converged"] and want["converged"]
    assert got["iters"] == want["iters"]
    assert abs(got["entry"] - want["entry"]) <= 1e-12 * want["entry"]
    scale = np.abs(want["update"]).max()
    np.testing.assert_allclose(got["update"], want["update"], rtol=0, atol=1e-10 * scale)
