"""FGMRES deflation (``deflate=``) and ``kp_deflate``'s Schur-paired Kp modes:
the port against JAX's, in float64 on the CPU.

* ``fgmres(deflate=...)`` on one seeded dense system with a near-null
  direction, k_d 1, 2 and 4 at restart 8 (the solve restarts): equal
  iteration counts and converged flags, x within 1e-10 of its size.  The
  rows include the near-null direction and, at k_d 2 and 4, a row whose
  image is already spanned (the skipped slot).
* The weakly pinned channel of tests/test_kp_deflation.py (576 cells, the
  outlet one short edge): JAX's four checks of the probe and the pairing,
  mirrored; the port's rows repeated from build to build (the port fixes
  each mode's sign); none on a 3D box.
* Two gloo ranks (tests/torch_spmd_ranks.py ``deflation``): a deflated
  forced step equal to one device's at the ranks' numbering (equal counts,
  the update within 1e-10).

The solves against JAX's (the rows up to sign, two BDF1 steps, the Stokes
guess and a steady Newton iteration): tests/test_torch_deflation_pair.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from navier_stokes_tpu.la.gmres import fgmres as j_fgmres
from navier_stokes_tpu_torch.config import SolverConfig
from navier_stokes_tpu_torch.la.gmres import fgmres as t_fgmres
from navier_stokes_tpu_torch.mesh.generate import box, rectangle
from navier_stokes_tpu_torch.models.navier_stokes import NavierStokesSolver
from navier_stokes_tpu_torch.utils.logging import RunLog

import torch_spmd_ranks as ranks

N = 60
RESTART = 8


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Eager torch on these small systems runs fastest on one thread, and
    under other processes' load (a test run's workers) many threads each
    slow it most."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


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
