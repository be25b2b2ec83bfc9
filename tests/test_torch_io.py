"""Checkpoints and XDMF/HDF5 output: the port's io/ and the solver's
save_checkpoint / restore_checkpoint against the JAX package's, in float64.

Mirrors ``tests/test_io_and_functionals.py`` (XDMF write, checkpoint round
trip, restart) and ``tests/test_robustness.py`` (a checkpoint of another
layout is refused).  The two writers' files hold equal datasets and equal
XDMF text; each package reads the other's checkpoints; a solver's
checkpoint holds the same arrays as JAX's for the same run (1e-10).
Without h5py, writing raises an ImportError that names it.
"""

import sys

import h5py
import numpy as np
import pytest
import torch

from navier_stokes_tpu.config import SolverConfig as JConfig
from navier_stokes_tpu.fem.dofs import make_dofs as j_make_dofs
from navier_stokes_tpu.io.checkpoint import load_checkpoint as j_load
from navier_stokes_tpu.io.checkpoint import save_checkpoint as j_save
from navier_stokes_tpu.io.xdmf import XdmfWriter as JWriter
from navier_stokes_tpu.mesh.generate import unit_square as j_unit_square
from navier_stokes_tpu.models.navier_stokes import NavierStokesSolver as JSolver
from navier_stokes_tpu.utils.logging import RunLog as JLog
from navier_stokes_tpu_torch.config import SolverConfig
from navier_stokes_tpu_torch.io.checkpoint import load_checkpoint, save_checkpoint
from navier_stokes_tpu_torch.io.xdmf import XdmfWriter
from navier_stokes_tpu_torch.mesh.generate import unit_square
from navier_stokes_tpu_torch.models.navier_stokes import NavierStokesSolver
from navier_stokes_tpu_torch.models.stokes import StokesSolver
from navier_stokes_tpu_torch.utils.logging import RunLog

NU, RHO, POUT = 0.04, 1.0, 10.0


def square_cfg(cls, T=0.1, matvec="flat"):
    cfg = cls(inlet_tags=(0,), neumann_tags=(1,), wall_tags=(2, 3),
              nu=NU, rho=RHO, p_out=POUT, dt=0.05, T=T)
    cfg.dtype = "float64"
    cfg.krylov.max_iters = 1000
    cfg.krylov.matvec = matvec
    cfg.krylov.cells_per_block = 16
    return cfg


def poiseuille_inlet(x, t=0.0):
    v = np.zeros_like(x)
    v[:, 0] = x[:, 1] * (1.0 - x[:, 1])
    return v


def _datasets(path):
    with h5py.File(path) as f:
        return {k: f[k][:] for k in f}


def test_xdmf_write_matches_jax(tmp_path):
    """A Stokes solution written by both writers: the same files, the same
    datasets (dtypes and values), the same XDMF text; the vertex velocities
    are the dof values."""
    cfg = square_cfg(SolverConfig)
    cfg.krylov.preconditioner = "block_triangular"
    s = StokesSolver(unit_square(4), cfg, log=RunLog(verbose=False), inlet=poiseuille_inlet,
                     device="cpu")
    sol = s.solve()
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    w = XdmfWriter(s.dofs, output_dir=str(tmp_path / "port"))
    jw = JWriter(j_make_dofs(j_unit_square(4)), output_dir=str(tmp_path / "jax"))
    for step, t in ((0, 0.0), (1, 0.05)):
        assert w.write(step, t, sol) == jw.write(step, t, sol.numpy()) == f"output-{step:04d}.h5"
    assert w.write_series() == jw.write_series()
    names = sorted(p.name for p in (tmp_path / "port").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert "output-series.xdmf" in names and "output-0001.xdmf" in names
    for name in names:
        mine, theirs = tmp_path / "port" / name, tmp_path / "jax" / name
        if name.endswith(".h5"):
            a, b = _datasets(mine), _datasets(theirs)
            assert a.keys() == b.keys()
            for k in a:
                assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), (name, k)
        else:
            assert mine.read_text() == theirs.read_text()
    vel = _datasets(tmp_path / "port" / "output-0000.h5")["velocity"]
    np.testing.assert_allclose(vel[:, 0], sol.numpy()[s.dofs.vertex_vdofs], rtol=1e-12)


def test_checkpoint_roundtrip_and_cross_package(tmp_path):
    sol = np.random.default_rng(0).standard_normal(100)
    kw = dict(solution=sol, solution_old=sol * 2, time=0.3, step=6, config={"dt": 0.05})
    for save, load, name in ((save_checkpoint, load_checkpoint, "port.h5"),
                             (save_checkpoint, j_load, "port_for_jax.h5"),
                             (j_save, load_checkpoint, "jax_for_port.h5")):
        path = str(tmp_path / name)
        save(path, **kw, solution_old2=sol * 3)
        d = load(path)
        np.testing.assert_array_equal(d["solution"], sol)
        np.testing.assert_array_equal(d["solution_old"], sol * 2)
        np.testing.assert_array_equal(d["solution_old2"], sol * 3)
        assert d["time"] == 0.3 and d["step"] == 6 and d["config"]["dt"] == 0.05
    save_checkpoint(str(tmp_path / "bdf1.h5"), **kw)
    assert "solution_old2" not in load_checkpoint(str(tmp_path / "bdf1.h5"))


def test_solver_checkpoint_matches_jax(tmp_path):
    """The same 2-step run in both packages: their checkpoint files hold
    the same state (1e-10), the same time and step, the same layout record
    and the same solver config."""
    for matvec in ("flat", "windowed"):
        js = JSolver(j_unit_square(3), square_cfg(JConfig, matvec=matvec), log=JLog(verbose=False))
        ts = NavierStokesSolver(unit_square(3), square_cfg(SolverConfig, matvec=matvec),
                                log=RunLog(verbose=False), device="cpu")
        js.solve()
        ts.solve()
        jp, tp = str(tmp_path / f"jax_{matvec}.h5"), str(tmp_path / f"port_{matvec}.h5")
        js.save_checkpoint(jp)
        ts.save_checkpoint(tp)
        a, b = load_checkpoint(tp), j_load(jp)
        for k in ("solution", "solution_old", "solution_old2"):
            np.testing.assert_allclose(a[k], b[k], rtol=0, atol=1e-10)
        assert (a["time"], a["step"]) == (b["time"], b["step"]) == (pytest.approx(0.1), 2)
        assert a["config"] == b["config"]


def test_restart_continues_identically(tmp_path):
    """T=0.1, checkpoint, resume to T=0.2 == a direct T=0.2 run."""
    def make(T):
        return NavierStokesSolver(unit_square(3), square_cfg(SolverConfig, T=T),
                                  log=RunLog(verbose=False), device="cpu")

    direct = make(0.2)
    direct.solve()
    first = make(0.1)
    first.solve()
    ck = str(tmp_path / "resume.h5")
    first.save_checkpoint(ck)
    second = make(0.2)
    second.restore_checkpoint(ck)
    assert second.solution.dtype == torch.float64 and second._step == 2
    second.solve(resume=True)
    np.testing.assert_allclose(second.solution.numpy(), direct.solution.numpy(), rtol=0,
                               atol=1e-12)


def test_checkpoint_layout_mismatch_rejected(tmp_path):
    """A checkpoint of another DoF numbering (windowed vs flat) is refused;
    one of the same layout restores exactly."""
    def make(matvec):
        cfg = SolverConfig(inlet_tags=(0,), neumann_tags=(1,), wall_tags=(2, 3), T=0.05)
        cfg.dtype = "float64"
        cfg.krylov.matvec = matvec
        cfg.krylov.cells_per_block = 16
        return NavierStokesSolver(unit_square(3), cfg, log=RunLog(verbose=False),
                                  device="cpu").setup()

    s_win = make("windowed")
    s_win.solution = torch.as_tensor(np.random.default_rng(1).standard_normal(s_win.dofs.n_total))
    path = str(tmp_path / "ck.h5")
    s_win.save_checkpoint(path, step=3)
    with pytest.raises(ValueError, match="layout mismatch|vector length"):
        make("flat").restore_checkpoint(path)
    s_win2 = make("windowed").restore_checkpoint(path)
    assert torch.equal(s_win2.solution, s_win.solution) and s_win2._step == 3


def test_writing_without_h5py_names_it(tmp_path, monkeypatch):
    """Where h5py cannot be imported, the writer and the checkpoint raise an
    ImportError that names it (the run has not written anything)."""
    monkeypatch.setitem(sys.modules, "h5py", None)
    s = NavierStokesSolver(unit_square(2), square_cfg(SolverConfig), log=RunLog(verbose=False),
                           device="cpu").setup()
    with pytest.raises(ImportError, match="h5py"):
        s.save_checkpoint(str(tmp_path / "ck.h5"))
    with pytest.raises(ImportError, match="h5py"):
        XdmfWriter(s.dofs, output_dir=str(tmp_path / "out"))
    assert not any(tmp_path.iterdir())
