"""The command line: `python -m navier_stokes_tpu_torch <command>`.

Port of ``navier_stokes_tpu/__main__.py`` with the same commands and flags:

  run     unsteady Navier-Stokes
  stokes  steady Stokes
  info    parse a mesh and print its stats

and one more flag, ``--device`` (default ``cuda``): where the solver runs,
the counterpart of the original's ``JAX_PLATFORMS``.  With ``cuda`` and no
card visible the command raises; it never carries on on the CPU.  ``--mesh``
names a gmsh .msh file.  ``--output-dir`` writes the XDMF/HDF5 files of
io/xdmf.py, which need h5py: without it the command raises before it
solves anything.

Not ported, and refused with NotImplementedError: ``--devices`` above 1 and
``--distributed`` (multi-GPU).
"""

from __future__ import annotations

import argparse
import json
import sys


def _add_common(p):
    p.add_argument("--mesh", required=True, help="gmsh .msh file (v2.2 or v4.1)")
    p.add_argument("--config", help="JSON/TOML SolverConfig file")
    p.add_argument("--nu", type=float)
    p.add_argument("--rho", type=float)
    p.add_argument("--p-out", dest="p_out", type=float)
    p.add_argument(
        "--preconditioner",
        choices=["identity", "block_diagonal", "block_triangular", "cahouet_chabard"],
    )
    p.add_argument("--distributed", action="store_true",
                   help="multi-process runs (not ported: raises)")
    p.add_argument("--matvec", choices=["flat", "windowed"])
    p.add_argument("--time-scheme", dest="time_scheme", choices=["bdf1", "bdf2"])
    p.add_argument(
        "--initial-guess", dest="initial_guess", choices=["zero", "stokes"],
        help="'stokes' = the reference's designed initial-guess path (cpp:636-644)",
    )
    p.add_argument("--dtype", choices=["auto", "float32", "float64"])
    p.add_argument("--devices", type=int, help="shard over N devices (not ported above 1)")
    p.add_argument("--output-dir", help="write XDMF/HDF5 output here (needs h5py)")
    p.add_argument("--log-json", help="dump the structured run log to this file")
    p.add_argument("--device", default="cuda",
                   help="torch device of the solve (default cuda; cpu runs the "
                   "kernels' plain versions)")


def _check_args(args):
    if getattr(args, "distributed", False) or (args.devices or 1) > 1:
        raise NotImplementedError(
            "--devices > 1 / --distributed: multi-GPU solves are not ported"
        )
    if args.output_dir:
        from .io import h5py

        h5py()  # --output-dir without h5py raises here, before any solve


def _device(args):
    import torch

    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"--device {args.device}: no CUDA device visible to torch "
            "(pass --device cpu to run the plain versions on the CPU)"
        )
    return dev


def _build_config(args):
    from .config import SolverConfig

    cfg = SolverConfig.from_file(args.config) if args.config else SolverConfig()
    for field, attr in (("nu", "nu"), ("rho", "rho"), ("p_out", "p_out"), ("dtype", "dtype")):
        v = getattr(args, attr, None)
        if v is not None:
            setattr(cfg, field, v)
    if getattr(args, "preconditioner", None):
        cfg.krylov.preconditioner = args.preconditioner
    if getattr(args, "matvec", None):
        cfg.krylov.matvec = args.matvec
    if getattr(args, "T", None) is not None:
        cfg.T = args.T
    if getattr(args, "dt", None) is not None:
        cfg.dt = args.dt
    if getattr(args, "time_scheme", None):
        cfg.time_scheme = args.time_scheme
    if getattr(args, "initial_guess", None):
        cfg.initial_guess = args.initial_guess
    return cfg


def cmd_run(args):
    from .models.navier_stokes import NavierStokesSolver
    from .utils.logging import RunLog

    _check_args(args)
    dev = _device(args)
    cfg = _build_config(args)
    log = RunLog()
    solver = NavierStokesSolver(args.mesh, cfg, log=log, device=dev)
    solver.setup()
    if args.output_dir:
        from .io.xdmf import XdmfWriter

        writer = XdmfWriter(solver.dofs, output_dir=args.output_dir,
                            partitioning=solver.cell_owner)  # cpp:702-705
        solver.output_hooks.append(lambda s, t, sol: writer.write(s, t, sol))
    solver.solve()
    if args.output_dir:
        writer.write_series()
    if args.log_json:
        log.dump_json(args.log_json)
    return 0


def cmd_stokes(args):
    from .models.stokes import StokesSolver
    from .utils.logging import RunLog

    _check_args(args)
    dev = _device(args)
    cfg = _build_config(args)
    if not args.config:
        # the reference Stokes path's tag set (mesh-square, cpp:472,511)
        cfg.inlet_tags, cfg.neumann_tags, cfg.wall_tags = (0,), (1,), (2, 3)
        if not args.preconditioner:
            cfg.krylov.preconditioner = "block_triangular"  # cpp:546
    log = RunLog()
    solver = StokesSolver(args.mesh, cfg, log=log, device=dev)
    solver.solve()
    if args.output_dir:
        from .io.xdmf import XdmfWriter

        writer = XdmfWriter(solver.dofs, output_dir=args.output_dir)
        writer.write(0, 0.0, solver.solution)
    if args.log_json:
        log.dump_json(args.log_json)
    return 0


def cmd_info(args):
    from .fem.dofs import make_dofs
    from .mesh.msh_io import read_msh

    mesh = read_msh(args.mesh)
    dofs = make_dofs(mesh)
    print(mesh.summary())
    print(json.dumps({"n_u": dofs.n_u, "n_p": dofs.n_p, "n_total": dofs.n_total}))
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser(prog="navier_stokes_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p_run = sub.add_parser("run", help="unsteady Navier-Stokes (reference main.cpp run)")
    _add_common(p_run)
    p_run.add_argument("--T", type=float, help="final time (default 1.0, main.cpp:12)")
    p_run.add_argument("--dt", type=float, help="time step (default 0.05, main.cpp:13)")
    p_run.set_defaults(fn=cmd_run)

    p_st = sub.add_parser("stokes", help="steady Stokes (reference dead path, cpp:380-559)")
    _add_common(p_st)
    p_st.set_defaults(fn=cmd_stokes)

    p_info = sub.add_parser("info", help="mesh statistics")
    p_info.add_argument("--mesh", required=True)
    p_info.set_defaults(fn=cmd_info)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
