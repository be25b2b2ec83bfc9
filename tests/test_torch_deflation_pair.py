"""The deflated solves of the port against JAX's, in float64 on the CPU, on
the weakly pinned channel of tests/test_kp_deflation.py (576 cells, the
outlet one short edge; ``torch_spmd_ranks.channel_config``).

* The port's rows against JAX's up to sign (ARPACK's random start carries
  over from call to call, so JAX's sign is the eigensolver's choice, while
  the port fixes its own: |cos| >= 1 - 1e-8).
* Two BDF1 steps with kp_deflate 2 (Cahouet-Chabard, no Kp coarse space),
  the port's rows given JAX's signs: equal FGMRES counts, Newton rows
  within 1e-9 relative; kp_deflate 0 is the control whose counts must
  differ.  The Stokes guess and a steady Newton iteration, deflated,
  likewise.

The probe, the pairing and the ranks: tests/test_torch_deflation.py.
"""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from navier_stokes_tpu.config import SolverConfig as JConfig
from navier_stokes_tpu.mesh.generate import rectangle as j_rectangle
from navier_stokes_tpu.models.navier_stokes import NavierStokesSolver as JSolver
from navier_stokes_tpu.utils.logging import RunLog as JLog
from navier_stokes_tpu_torch import convert
from navier_stokes_tpu_torch.config import SolverConfig
from navier_stokes_tpu_torch.models.navier_stokes import NavierStokesSolver
from navier_stokes_tpu_torch.utils.logging import RunLog

import torch_spmd_ranks as ranks


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Eager torch on these small systems runs fastest on one thread, and
    under other processes' load (a test run's workers) many threads each
    slow it most: the Stokes guess below took 19.5 s on 8 threads of an idle
    host, 6.0 s on one, and did not end in minutes on 8 threads beside five
    busy processes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


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


