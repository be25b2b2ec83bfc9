"""The port's mesh reader, command line, functionals and solver surface
against the JAX package's, in float64.

* ``read_msh`` (native and python backends) and ``read_msh_bytes`` on gmsh
  v2.2 and v4.1 texts written here from generated meshes.
* ``info``; ``run --log-json`` and ``stokes --log-json`` on a ``.msh`` in
  ``tmp_path``: the port's records equal the JAX CLI's (residuals to 1e-10
  relative, counts exactly).
* ``BoundaryForce``, ``BoundaryReaction``, ``divergence_l2`` and
  ``strouhal_number`` at a seeded state.
* What the command line refuses: ``--output-dir`` (h5py), ``--devices 2``
  in a process alone, ``--devices 2`` with the flat operator, and
  ``--device cuda`` without a card.
* ``run --devices 2 --distributed`` on 2 spawned ranks (no torchrun: each
  joins a gloo group through a ``file://`` store first) against
  ``--devices 1``, record for record.
* The solver surface: a mesh given as a path, output hooks, ``solve(resume=
  True)`` and ``velocity_coords``.
"""

import json
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from navier_stokes_tpu.__main__ import main as j_main
from navier_stokes_tpu.config import SolverConfig as JConfig
from navier_stokes_tpu.mesh import msh_io as j_msh
from navier_stokes_tpu.mesh.generate import box as j_box
from navier_stokes_tpu.mesh.generate import unit_square as j_unit_square
from navier_stokes_tpu.models import functionals as jf
from navier_stokes_tpu.models.navier_stokes import NavierStokesSolver as JSolver
from navier_stokes_tpu.utils.logging import RunLog as JLog
from navier_stokes_tpu_torch.__main__ import main as t_main
from navier_stokes_tpu_torch.config import SolverConfig
from navier_stokes_tpu_torch.mesh import msh_io as t_msh
from navier_stokes_tpu_torch.mesh.generate import unit_square
from navier_stokes_tpu_torch.models import functionals as tf
from navier_stokes_tpu_torch.models.navier_stokes import NavierStokesSolver
from navier_stokes_tpu_torch.utils.logging import RunLog
import torch_spmd_ranks as ranks

MESH_FIELDS = ("coords", "cells", "boundary_facets", "boundary_tags", "cell_tags")


def _msh_v2(mesh) -> str:
    """gmsh 2.2 ASCII with sparse node ids, a point element, the boundary
    facets (physical tag = boundary tag) and the cells (physical tag 7)."""
    dim = mesh.dim
    ids = 1 + 2 * np.arange(len(mesh.coords))
    xyz = np.zeros((len(mesh.coords), 3))
    xyz[:, :dim] = mesh.coords
    out = ["$MeshFormat", "2.2 0 8", "$EndMeshFormat", "$Nodes", str(len(ids))]
    out += [f"{i} {x!r} {y!r} {z!r}" for i, (x, y, z) in zip(ids, xyz.tolist())]
    out += ["$EndNodes", "$Elements"]
    facet_type, cell_type = (1, 2) if dim == 2 else (2, 4)
    elems = [(15, 99, [ids[0]])]
    elems += [(facet_type, int(t), ids[f]) for f, t in zip(mesh.boundary_facets, mesh.boundary_tags)]
    elems += [(cell_type, 7, ids[c]) for c in mesh.cells]
    out.append(str(len(elems)))
    out += [f"{k + 1} {et} 2 {tag} {tag + 100} " + " ".join(map(str, nodes))
            for k, (et, tag, nodes) in enumerate(elems)]
    out.append("$EndElements")
    return "\n".join(out) + "\n"


def _msh_v4(mesh) -> str:
    """gmsh 4.1 ASCII: one curve entity per boundary tag, one surface."""
    tags = sorted(set(int(t) for t in mesh.boundary_tags))
    n = len(mesh.coords)
    out = ["$MeshFormat", "4.1 0 8", "$EndMeshFormat", "$Entities", f"0 {len(tags)} 1 0"]
    bbox = "0 0 0 1 1 0"
    out += [f"{t + 1} {bbox} 1 {t} 0" for t in tags]
    out += [f"1 {bbox} 1 7 {len(tags)} " + " ".join(str(t + 1) for t in tags)]
    out += ["$EndEntities", "$Nodes", f"1 {n} 1 {n}", f"2 1 0 {n}"]
    out += [str(i + 1) for i in range(n)]
    out += [f"{x!r} {y!r} 0" for x, y in mesh.coords.tolist()]
    out += ["$EndNodes", "$Elements"]
    blocks = [(1, t + 1, 1, mesh.boundary_facets[mesh.boundary_tags == t]) for t in tags]
    blocks.append((2, 1, 2, mesh.cells))
    n_el = sum(len(b[3]) for b in blocks)
    out.append(f"{len(blocks)} {n_el} 1 {n_el}")
    k = 1
    for edim, etag, etype, conn in blocks:
        out.append(f"{edim} {etag} {etype} {len(conn)}")
        for row in conn:
            out.append(f"{k} " + " ".join(str(v + 1) for v in row))
            k += 1
    out.append("$EndElements")
    return "\n".join(out) + "\n"


def _write(tmp_path, name, text):
    path = tmp_path / name
    path.write_text(text)
    return str(path)


def _same_mesh(got, want):
    for f in MESH_FIELDS:
        g, w = getattr(got, f), getattr(want, f)
        assert g.shape == w.shape and np.array_equal(g, w), f


@pytest.mark.parametrize(
    "fmt, make",
    [("v2", lambda: j_unit_square(3)), ("v2", lambda: j_box(2, 2, 2)),
     ("v4", lambda: j_unit_square(3))],
)
def test_read_msh_matches_jax(fmt, make, tmp_path):
    text = (_msh_v2 if fmt == "v2" else _msh_v4)(make())
    path = _write(tmp_path, "m.msh", text)
    want = j_msh.read_msh(path, backend="python")
    _same_mesh(t_msh.read_msh_bytes(text.encode()), j_msh.read_msh_bytes(text.encode()))
    for backend in ("python", "auto"):
        _same_mesh(t_msh.read_msh(path, backend=backend), want)


def _run_config(tmp_path, **extra):
    raw = {
        "dtype": "float64", "T": 0.1, "dt": 0.05,
        "inlet_tags": [0], "neumann_tags": [1], "wall_tags": [2, 3],
        "inlet": {"freeze_time": False, "H": 1.0, "u_m": 1.0},
        "krylov": {"cells_per_block": 16, "max_iters": 500},
    }
    raw.update(extra)
    return _write(tmp_path, "config.json", json.dumps(raw))


def _same_records(got, want):
    assert [sorted(r) for r in got] == [sorted(r) for r in want]
    for g, w in zip(got, want):
        for key, wv in w.items():
            if key == "residual":
                assert abs(g[key] - wv) <= 1e-10 * abs(wv), (g, w)
            else:
                assert g[key] == wv, (g, w)


def _cli_records(main, argv, out):
    assert main([*argv, "--log-json", out]) == 0
    with open(out) as f:
        return json.load(f)


@pytest.mark.parametrize(
    "cmd, flags",
    [
        ("run", ["--preconditioner", "block_triangular", "--initial-guess", "stokes"]),
        ("stokes", ["--dtype", "float64"]),
    ],
)
def test_cli_matches_jax(cmd, flags, tmp_path, capsys):
    mesh = _write(tmp_path, "sq.msh", _msh_v2(j_unit_square(4)))
    argv = [cmd, "--mesh", mesh, *flags]
    if cmd == "run":
        argv += ["--config", _run_config(tmp_path)]
    want = _cli_records(j_main, argv, str(tmp_path / "jax.json"))
    got = _cli_records(t_main, [*argv, "--device", "cpu"], str(tmp_path / "port.json"))
    assert any(r.get("event") == "gmres" and r.get("system") == "stokes" for r in got)
    if cmd == "run":
        assert sum(r.get("event") == "time_step" for r in got) == 2
    _same_records(got, want)
    assert "GMRES iterations" in capsys.readouterr().out


def test_cli_info_matches_jax(tmp_path, capsys):
    mesh = _write(tmp_path, "sq.msh", _msh_v2(j_unit_square(4)))
    assert j_main(["info", "--mesh", mesh]) == 0
    want = capsys.readouterr().out
    assert t_main(["info", "--mesh", mesh]) == 0
    assert capsys.readouterr().out == want and '"n_total"' in want


@pytest.mark.parametrize(
    "cmd, flags",
    [
        ("run", ["--matvec", "windowed", "--preconditioner", "cahouet_chabard"]),
        ("stokes", ["--dtype", "float64"]),
    ],
)
def test_cli_output_dir_matches_jax(cmd, flags, tmp_path):
    """--output-dir: the port's CLI writes the files the JAX CLI writes (a
    step's .h5 and .xdmf, the run's series), with the same mesh, cells and
    partitioning datasets and XDMF text, and fields within 1e-9."""
    import h5py

    mesh = _write(tmp_path, "sq.msh", _msh_v2(j_unit_square(3)))
    argv = [cmd, "--mesh", mesh, *flags]
    if cmd == "run":
        argv += ["--config", _run_config(tmp_path)]
    out = {"jax": tmp_path / "jax_out", "port": tmp_path / "port_out"}
    assert j_main([*argv, "--output-dir", str(out["jax"])]) == 0
    assert t_main([*argv, "--output-dir", str(out["port"]), "--device", "cpu"]) == 0
    names = sorted(p.name for p in out["port"].iterdir())
    assert names == sorted(p.name for p in out["jax"].iterdir())
    assert ("output-series.xdmf" in names) == (cmd == "run")
    assert len([n for n in names if n.endswith(".h5")]) == (3 if cmd == "run" else 1)
    for name in names:
        mine, theirs = out["port"] / name, out["jax"] / name
        if not name.endswith(".h5"):
            assert mine.read_text() == theirs.read_text()
            continue
        with h5py.File(mine) as a, h5py.File(theirs) as b:
            assert sorted(a) == sorted(b)
            for k in a:
                assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
                if k in ("velocity", "pressure"):
                    np.testing.assert_allclose(a[k][:], b[k][:], rtol=0, atol=1e-9)
                else:
                    assert np.array_equal(a[k][:], b[k][:]), (name, k)


@pytest.mark.parametrize("cmd", ["run", "stokes"])
def test_cli_output_dir_names_h5py_when_missing(cmd, tmp_path, monkeypatch):
    """Where h5py cannot be imported (a GPU host may lack it),
    --output-dir raises an ImportError that names h5py before any solve:
    nothing is logged and no directory is made."""
    monkeypatch.setitem(sys.modules, "h5py", None)
    mesh = _write(tmp_path, "sq.msh", _msh_v2(j_unit_square(2)))
    log = tmp_path / "log.json"
    with pytest.raises(ImportError, match="h5py"):
        t_main([cmd, "--mesh", mesh, "--device", "cpu", "--output-dir", str(tmp_path / "out"),
                "--log-json", str(log)])
    assert not (tmp_path / "out").exists() and not log.exists()


@pytest.mark.parametrize(
    "flags, exc, match",
    [
        (["--devices", "2", "--matvec", "windowed"], ValueError, "process group has 1 rank"),
        (["--devices", "2"], ValueError, "process group has 1 rank"),  # the default: flat
        (["--device", "cuda"], RuntimeError, "no CUDA device"),
    ],
)
def test_cli_refuses_what_is_not_ported(flags, exc, match, tmp_path):
    if flags[0] == "--device" and torch.cuda.is_available():
        pytest.skip("a card is visible")
    mesh = _write(tmp_path, "sq.msh", _msh_v2(j_unit_square(2)))
    device = [] if flags[0] == "--device" else ["--device", "cpu"]
    for cmd in ("run", "stokes"):
        with pytest.raises(exc, match=match):
            t_main([cmd, "--mesh", mesh, *flags, *device])


def test_cli_two_ranks_match_one(tmp_path):
    """``--devices 2 --distributed`` on 2 ranks, the windowed operator
    sharded, against ``--devices 1``: the same records (residuals to 1e-10
    relative, counts exactly); rank 0 alone writes the log."""
    mesh = _write(tmp_path, "sq.msh", _msh_v2(j_unit_square(4)))
    argv = ["run", "--mesh", mesh, "--config", _run_config(tmp_path), "--matvec", "windowed",
            "--preconditioner", "cahouet_chabard", "--device", "cpu"]
    want = _cli_records(t_main, [*argv, "--devices", "1"], str(tmp_path / "one.json"))
    two = tmp_path / "two.json"
    ranks.spawn(ranks.cli, 2, f"file://{tmp_path}/store",
                [*argv, "--devices", "2", "--distributed", "--log-json", str(two)])
    got = json.loads(two.read_text())
    assert sum(r.get("event") == "gmres" for r in got) >= 2
    _same_records(got, want)


def test_cli_two_ranks_match_one_flat(tmp_path):
    """``--devices 2 --distributed`` on 2 ranks with the default (flat)
    operator, its cells split over the ranks and its vectors replicated,
    against ``--devices 1``: the same records (residuals to 1e-10 relative,
    counts exactly), the Stokes guess included; rank 0 alone writes the
    log."""
    mesh = _write(tmp_path, "sq.msh", _msh_v2(j_unit_square(4)))
    # one forced Newton update a step: the Stokes guess leaves the entry
    # residuals below newton.tol, and each step then still solves a tangent
    argv = ["run", "--mesh", mesh, "--config", _run_config(tmp_path, newton={"min_iters": 1}),
            "--preconditioner", "block_triangular", "--initial-guess", "stokes", "--device",
            "cpu"]
    want = _cli_records(t_main, [*argv, "--devices", "1"], str(tmp_path / "one.json"))
    two = tmp_path / "two.json"
    ranks.spawn(ranks.cli, 2, f"file://{tmp_path}/store",
                [*argv, "--devices", "2", "--distributed", "--log-json", str(two)])
    got = json.loads(two.read_text())
    assert sum(r.get("event") == "gmres" for r in got) >= 2
    assert any(r.get("system") == "stokes" for r in got)
    _same_records(got, want)


def _flat_config(cls, T):
    cfg = cls()
    cfg.dtype = "float64"
    cfg.T, cfg.dt = T, 0.05
    cfg.inlet_tags, cfg.neumann_tags, cfg.wall_tags = (0,), (1,), (2, 3)
    cfg.inlet.freeze_time, cfg.inlet.H, cfg.inlet.u_m = False, 1.0, 1.0
    return cfg


def _as_numpy(sol):
    return sol.detach().cpu().numpy() if isinstance(sol, torch.Tensor) else np.asarray(sol)


def test_functionals_match_jax():
    js = JSolver(j_unit_square(4), _flat_config(JConfig, 0.05), log=JLog(verbose=False))
    ts = NavierStokesSolver(unit_square(4), _flat_config(SolverConfig, 0.05),
                            log=RunLog(verbose=False), device="cpu")
    js.setup()
    ts.setup()
    rng = np.random.default_rng(4)
    u, uo = rng.standard_normal(ts.dofs.n_total), rng.standard_normal(ts.dofs.n_total)
    ju, juo, tu, tuo = jnp.asarray(u), jnp.asarray(uo), torch.as_tensor(u), torch.as_tensor(uo)

    def close(got, want):
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12 * np.abs(want).max())

    for tags in ((2,), (2, 3)):
        jr, tr = jf.BoundaryReaction(js, tags), tf.BoundaryReaction(ts, tags)
        close(tr.force(tu), jr.force(ju))
        close(tr.force(tu, tuo, 0.1), jr.force(ju, juo, 0.1))
        close(tr.coefficients(tu, 1.5, 0.1), jr.coefficients(ju, 1.5, 0.1))
        jb = jf.BoundaryForce(js.dofs, tags, nu=0.3, rho=1.2)
        tb = tf.BoundaryForce(ts.dofs, tags, nu=0.3, rho=1.2)
        close(tb.force(tu), jb.force(ju))
        close(tb.force(u), jb.force(u))
        close(tb.coefficients(tu, 1.5, 0.1), jb.coefficients(ju, 1.5, 0.1))
    close(tf.divergence_l2(ts.ctx, tu), jf.divergence_l2(js.ctx, ju))
    lift = np.sin(2 * np.pi * 3.1 * 0.01 * np.arange(200)) + 0.1 * rng.standard_normal(200)
    assert tf.strouhal_number(lift, 0.01, 0.1, 1.0) == jf.strouhal_number(lift, 0.01, 0.1, 1.0)


def test_mesh_path_hooks_resume_and_coords_match_jax(tmp_path):
    """The port takes a .msh path, calls its output hooks at step 0 and
    after each step, and resumes from its current state, as JAX does."""
    path = _write(tmp_path, "sq.msh", _msh_v2(j_unit_square(4)))
    runs = {}
    for key, Solver, Config, Log, kw, mesh in (
        ("jax", JSolver, JConfig, JLog, {}, j_msh.read_msh(path, backend="python")),
        ("port", NavierStokesSolver, SolverConfig, RunLog, dict(device="cpu"), path),
    ):
        log = Log(verbose=False)
        s = Solver(mesh, _flat_config(Config, 0.05), log=log, **kw)
        seen = []
        s.output_hooks.append(
            lambda step, t, sol, seen=seen: seen.append((step, t, _as_numpy(sol).copy()))
        )
        s.solve()
        s.cfg.T = 0.15
        s.solve(resume=True)
        runs[key] = (s, log, seen)
    (js, jlog, jseen), (ts, tlog, tseen) = runs["jax"], runs["port"]
    assert [(st, t) for st, t, _ in tseen] == [(st, t) for st, t, _ in jseen]
    assert [st for st, _, _ in tseen] == [0, 1, 2, 3]
    for (_, _, g), (_, _, w) in zip(tseen, jseen):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-9)
    steps = [r["step"] for r in tlog.records if r.get("event") == "time_step"]
    assert steps == [1, 2, 3]
    _same_records(tlog.records, jlog.records)
    np.testing.assert_array_equal(ts.velocity_coords(), js.velocity_coords())
    np.testing.assert_array_equal(ts.velocity_coords(real_only=True),
                                  js.velocity_coords(real_only=True))
