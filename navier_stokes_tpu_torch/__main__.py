"""The command line: `python -m navier_stokes_tpu_torch <command>`.

Port of ``navier_stokes_tpu/__main__.py`` with the same commands and flags:

  run     unsteady Navier-Stokes
  stokes  steady Stokes
  info    parse a mesh and print its stats

and two more flags: ``--device`` (default ``cuda``), where the solver
runs, the counterpart of the original's ``JAX_PLATFORMS`` (with ``cuda`` and
no card visible the command raises; it never carries on on the CPU), and
``--backend``, the process group's (default NCCL on GPUs, gloo on the CPU).
``--mesh`` names a gmsh .msh file.  ``--output-dir`` writes the XDMF/HDF5
files of io/xdmf.py, which need h5py: without it the command raises before
it solves anything.

Multi-rank runs: one process a rank under torchrun, with ``--distributed``
(join the process group from torchrun's environment) and ``--devices N``
(N ranks).  The default (flat) operator splits the cells over the ranks
and replicates the vectors; ``--matvec windowed`` shards the windowed
operator by owned block ranges (parallel/spmd.py, parallel/windowed_spmd.py)::

    torchrun --nproc-per-node 2 -m navier_stokes_tpu_torch run --mesh m.msh \\
        --devices 2 --distributed --device cpu
    torchrun --nproc-per-node 2 -m navier_stokes_tpu_torch run --mesh m.msh \\
        --matvec windowed --devices 2 --distributed --device cpu

Rank 0 prints, writes the output files and the ``--log-json`` file.  Ranks
that share one GPU need ``--backend gloo`` (NCCL refuses two ranks on one
device).
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
                   help="join the process group of a torchrun launch (one process a rank)")
    p.add_argument("--matvec", choices=["flat", "windowed"])
    p.add_argument("--time-scheme", dest="time_scheme", choices=["bdf1", "bdf2"])
    p.add_argument(
        "--initial-guess", dest="initial_guess", choices=["zero", "stokes"],
        help="'stokes' = the reference's designed initial-guess path (cpp:636-644)",
    )
    p.add_argument("--dtype", choices=["auto", "float32", "float64"])
    p.add_argument("--devices", type=int,
                   help="split the solve over N ranks (the process group's size): the flat "
                   "operator's cells, or the windowed operator's blocks")
    p.add_argument("--backend", choices=["nccl", "gloo"],
                   help="the process group's backend (default nccl on cuda, gloo on cpu)")
    p.add_argument("--output-dir", help="write XDMF/HDF5 output here (needs h5py)")
    p.add_argument("--log-json", help="dump the structured run log to this file")
    p.add_argument("--device", default="cuda",
                   help="torch device of the solve (default cuda; cpu runs the "
                   "kernels' plain versions)")


def _check_args(args):
    if args.output_dir:
        from .io import h5py

        h5py()  # --output-dir without h5py raises here, before any solve


def _start(args):
    """Join the process group under --distributed (rank 0 then prints), and
    return (device, run log)."""
    from .parallel.bootstrap import initialize_distributed
    from .utils.logging import coordinator_log

    _check_args(args)
    if args.distributed:
        import torch

        cuda = torch.device(args.device).type == "cuda"
        initialize_distributed(backend=args.backend or ("nccl" if cuda else "gloo"))
    return _device(args), coordinator_log()


def _finish(args, log):
    from .parallel.bootstrap import is_coordinator, shutdown_distributed

    if args.log_json and is_coordinator():
        log.dump_json(args.log_json)
    shutdown_distributed()
    return 0


def _device(args):
    import torch

    from .parallel.bootstrap import local_device

    dev = local_device(args.device) if (args.devices or 1) > 1 else torch.device(args.device)
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

    dev, log = _start(args)
    cfg = _build_config(args)
    solver = NavierStokesSolver(args.mesh, cfg, log=log, n_devices=args.devices, device=dev)
    solver.setup()
    if args.output_dir:
        from .io.xdmf import XdmfWriter

        writer = XdmfWriter(solver.dofs, output_dir=args.output_dir,
                            partitioning=solver.cell_owner)  # cpp:702-705
        solver.output_hooks.append(lambda s, t, sol: writer.write(s, t, sol))
    solver.solve()
    if args.output_dir:
        writer.write_series()
    return _finish(args, log)


def cmd_stokes(args):
    from .models.stokes import StokesSolver

    dev, log = _start(args)
    cfg = _build_config(args)
    if not args.config:
        # the reference Stokes path's tag set (mesh-square, cpp:472,511)
        cfg.inlet_tags, cfg.neumann_tags, cfg.wall_tags = (0,), (1,), (2, 3)
        if not args.preconditioner:
            cfg.krylov.preconditioner = "block_triangular"  # cpp:546
    solver = StokesSolver(args.mesh, cfg, log=log, n_devices=args.devices, device=dev)
    solver.solve()
    if args.output_dir:
        from .io.xdmf import XdmfWriter

        writer = XdmfWriter(solver.dofs, output_dir=args.output_dir)
        writer.write(0, 0.0, solver._planar())
    return _finish(args, log)


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
