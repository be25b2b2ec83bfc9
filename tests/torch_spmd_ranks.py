"""What each rank of tests/test_torch_spmd.py runs (a module of its own, so
that the spawned ranks import torch and the port but not JAX).

Every entry point is ``fn(rank, n_ranks, init_method, out_dir)``: it joins a
gloo process group through ``initialize_distributed`` as a torchrun rank
would (``RANK``, ``WORLD_SIZE`` and ``LOCAL_RANK`` in its environment; the
``init_method`` a ``file://`` store in the test's temporary directory, so
concurrent test workers never share a port), runs the port's sharded plain
versions in float64 on the CPU, and saves what the test compares with
``torch.save`` under ``out_dir``.
"""

import os
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from navier_stokes_tpu_torch.config import SolverConfig
from navier_stokes_tpu_torch.fem.dofs import make_dofs, renumber_blocked
from navier_stokes_tpu_torch.mesh.generate import unit_square
from navier_stokes_tpu_torch.models.navier_stokes import NavierStokesSolver
from navier_stokes_tpu_torch.models.stokes import StokesSolver
from navier_stokes_tpu_torch.ops import windowed as W
from navier_stokes_tpu_torch.parallel import bootstrap
from navier_stokes_tpu_torch.parallel import windowed_spmd as ws
from navier_stokes_tpu_torch.utils.logging import RunLog

BLOCKS = [("v", "v"), ("v", "p"), ("p", "p")]
SPAWN_TIMEOUT_S = 300


def spawn(fn, n, init, *args):
    """Run fn(rank, n, init, *args) on n spawned ranks and wait: a rank's
    exception fails the caller, and so does a group that outlasts
    SPAWN_TIMEOUT_S (its ranks are killed)."""
    ctx = mp.start_processes(fn, args=(n, init, *args), nprocs=n, join=False,
                             start_method="spawn")
    deadline = time.monotonic() + SPAWN_TIMEOUT_S
    while not ctx.join(timeout=5):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"{fn.__name__} on {n} ranks outlasted {SPAWN_TIMEOUT_S} s")


def join(rank, n, init):
    """Join through the port's entry point, the rank and the world size read
    from torchrun's variables.  Returns what the process sees of the group,
    before and after a second call (a no-op)."""
    torch.set_num_threads(1)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(n), LOCAL_RANK=str(rank))
    first = bootstrap.initialize_distributed(backend="gloo", init_method=init)
    return dict(first=first, again=bootstrap.initialize_distributed(backend="gloo"),
                index=bootstrap.process_index(), count=bootstrap.process_count(),
                coordinator=bootstrap.is_coordinator(), backend=dist.get_backend())


def kernel_problem(n_dev, refine=6):
    """tests/test_windowed_spmd.py's ``_problem`` with the port's layout
    and seeded inputs: (dofs, layout, A_t, x, R), numpy arrays."""
    dofs, bi = renumber_blocked(make_dofs(unit_square(refine)), cells_per_block=16,
                                nb_multiple=n_dev)
    lay = W.build_windowed_layout(dofs.cell_vdofs, dofs.cell_pdofs, dofs.n_vs, dofs.n_ps, 2,
                                  block_info=bi)
    rng = np.random.default_rng(3)
    A = rng.standard_normal((lay.nl, lay.nli, lay.ncd))
    x = rng.standard_normal(dofs.n_total)
    R = rng.standard_normal((lay.nli, lay.ncd))
    return dofs, lay, A, x, R


def segment(v, dl, spaces):
    """The ``spaces`` segment of a rank's owned chunk."""
    n_u = dl.dim * dl.nvs_loc
    return {"v": v[:n_u], "p": v[n_u:], "vp": v}[spaces]


def kernels(rank, n, init, out):
    """Every plain version at this rank's framed layout, on its shard of
    the global inputs; and the exchange one product makes."""
    joined = join(rank, n, init)
    g = dist.group.WORLD
    dofs, lay, A, x, R = kernel_problem(n)
    dl = ws.make_dist_layout(lay, n)
    loc = ws.local_layout(lay, dl, rank)
    F, Bm = loc.frame * lay.Bmax, lay.Bmax
    cols = slice(rank * dl.nb_loc * Bm, (rank + 1) * dl.nb_loc * Bm)

    def framed_cols(a):
        return torch.nn.functional.pad(torch.as_tensor(a[..., cols]), (F, F))

    def own_cols(a):
        return a[:, F : F + dl.nb_loc * Bm].numpy()

    def chunk(v):
        return torch.as_tensor(ws.to_dist(v, dl)[rank * dl.llen : (rank + 1) * dl.llen])

    A_l, R_l, x_l = framed_cols(A), framed_cols(R), chunk(x)
    res = {
        "matvec": W.windowed_matvec_reference(loc, A_l, x_l, g).numpy(),
        "matvec_wrapper": W.windowed_matvec(loc, A_l, x_l, g).numpy(),
        "gather": own_cols(W._gather_reference(loc, x_l, g)),
        "gather_pair": np.stack([own_cols(t) for t in W.windowed_gather_pair(loc, x_l, 0.5 * x_l, g)]),
        "scatter": W._scatter_reference(loc, R_l, g).numpy(),
        # the kernels' route: the framed layout's result, then the edges
        "scatter_unframed": W._unframe(loc, W._scatter_reference(loc, R_l), "vp", g).numpy(),
    }
    At = torch.as_tensor(A)
    for i, o in BLOCKS:
        sub = W.slice_block(lay, At, i, o).numpy()
        xi = segment(x_l, dl, i)
        res[f"block {i}->{o}"] = W._block_reference(loc, framed_cols(sub), xi, i, o, g).numpy()
        res[f"block {i}->{o} wrapper"] = W.windowed_matvec_block(
            loc, framed_cols(sub), xi, in_spaces=i, out_spaces=o, group=g).numpy()
    if n == 2:
        res["volume"] = {refine: exchange_of_one_matvec(rank, n, refine)
                         for refine in (6, 12)}
    bootstrap.shutdown_distributed()
    res["joined"] = dict(joined, left=not dist.is_initialized())
    torch.save(res, Path(out) / f"kernels{n}_{rank}.pt")


def exchange_of_one_matvec(rank, n, refine):
    """Floats sent, the largest single send and the all-reduces of one
    sharded windowed_matvec on unit_square(refine), against the rank's
    vector length and the layout's halo constants."""
    dofs, lay, A, x, _ = kernel_problem(n, refine)
    dl = ws.make_dist_layout(lay, n)
    loc = ws.local_layout(lay, dl, rank)
    Bm, F = lay.Bmax, loc.frame * lay.Bmax
    cols = slice(rank * dl.nb_loc * Bm, (rank + 1) * dl.nb_loc * Bm)
    A_l = torch.nn.functional.pad(torch.as_tensor(A[..., cols]), (F, F))
    x_l = torch.as_tensor(ws.to_dist(x, dl)[rank * dl.llen : (rank + 1) * dl.llen])
    sends, reduces = [], []
    batch, all_reduce = dist.batch_isend_irecv, dist.all_reduce

    def record_batch(ops):
        sends.extend(op.tensor.numel() for op in ops if op.op is dist.isend)
        return batch(ops)

    def record_reduce(*args, **kw):
        reduces.append(1)
        return all_reduce(*args, **kw)

    dist.batch_isend_irecv, dist.all_reduce = record_batch, record_reduce
    try:
        W.reset_launch_counts()
        W.windowed_matvec(loc, A_l, x_l, dist.group.WORLD)
    finally:
        dist.batch_isend_irecv, dist.all_reduce = batch, all_reduce
    return dict(floats=W.exchange_floats(), sends=sends, all_reduces=len(reduces),
                llen=dl.llen, n_total=dofs.n_total,
                edge=max(lay.hv * lay.OWv, lay.hp * lay.OWp))


# ---- whole solves (tests/test_windowed_spmd.py, tests/test_steady.py) ------


def unsteady_config(precond, T=0.1, **krylov):
    cfg = SolverConfig(inlet_tags=(0,), neumann_tags=(1,), wall_tags=(2, 3),
                       nu=0.04, p_out=10.0, dt=0.05, T=T)
    cfg.dtype = "float64"
    cfg.krylov.max_iters = 500
    cfg.krylov.matvec = "windowed"
    cfg.krylov.cells_per_block = 16
    cfg.krylov.preconditioner = precond
    for k, v in krylov.items():
        setattr(cfg.krylov, k, v)
    return cfg


def steady_inflow(x, t=0.0):
    v = np.zeros_like(x)
    v[:, 0] = 4.0 * x[:, 1] * (1.0 - x[:, 1])
    return v


def steady_config(nu=0.1):
    cfg = SolverConfig(inlet_tags=(0,), neumann_tags=(1,), wall_tags=(2, 3), nu=nu, p_out=0.0)
    cfg.dtype = "float64"
    cfg.convection_form = "standard"
    cfg.include_continuity_residual = True
    cfg.jacobian_mass_rho = True
    cfg.krylov.matvec = "windowed"
    cfg.krylov.cells_per_block = 16
    cfg.krylov.preconditioner = "cahouet_chabard"
    cfg.krylov.rel_tol = 1e-8
    cfg.krylov.max_iters = 800
    return cfg


def stokes_config():
    """tests/test_stokes.py's windowed Poiseuille case, in float64."""
    cfg = SolverConfig(inlet_tags=(0,), neumann_tags=(1,), wall_tags=(2, 3), nu=0.04, rho=1.0,
                       p_out=10.0)
    cfg.dtype = "float64"
    cfg.krylov.matvec = "windowed"
    cfg.krylov.cells_per_block = 16
    cfg.krylov.preconditioner = "block_triangular"
    cfg.krylov.max_iters = 4000
    return cfg


def poiseuille_inlet(x, t=0.0):
    v = np.zeros_like(x)
    v[:, 0] = x[:, 1] * (1.0 - x[:, 1])
    return v


def forcing_xt(pts, t):
    out = np.zeros_like(pts)
    out[:, 0] = np.sin(2 * np.pi * t) * pts[:, 1]
    out[:, 1] = np.cos(pts[:, 0]) * t
    return out


def scan_functional(u):
    return torch.stack([torch.linalg.vector_norm(u), u.sum()])


def by_node(s):
    """{rounded coordinate: velocity} of solver s over its real dofs (the
    state is gathered: every rank calls this)."""
    v = s.velocity(real_only=True)
    return {tuple(np.round(c, 10)): row for c, row in zip(s.velocity_coords(real_only=True), v)}


def trajectory(log):
    return [(r["event"], r.get("residual", r.get("iters"))) for r in log.records
            if r.get("event") in ("newton", "gmres")]


def run_case(name, n_devices, out=None):
    """One whole solve of the named case; returns what the test compares."""
    log = RunLog(verbose=False)
    kw = dict(log=log, n_devices=n_devices, device="cpu")
    if name == "stokes":
        s = StokesSolver(unit_square(4), stokes_config(), inlet=poiseuille_inlet, **kw)
        s.solve()
        coords = s.dofs.v_coords[s.dofs.v_mask]
        return dict(nodes={tuple(np.round(c, 10)): v
                           for c, v in zip(coords, s.velocity(real_only=True))},
                    log=trajectory(log))
    if name == "steady":
        s = NavierStokesSolver(unit_square(4), steady_config(), inlet=steady_inflow, **kw)
        s.solve_steady(tol=1e-12, max_iters=12)
        return dict(nodes=by_node(s), log=trajectory(log))
    if name == "scanned":
        cfg = unsteady_config("cahouet_chabard", T=0.2)
        cfg.time_scheme = "bdf2"
        s = NavierStokesSolver(unit_square(4), cfg, **kw)
        got = s.solve_scanned(functional=scan_functional, newton_iters=3, chunk=2)
        return dict(nodes=by_node(s), functional=got["functional"], iters=got["gmres_iters"])
    if name == "forcing":
        cfg = unsteady_config("cahouet_chabard", T=0.15)
        cfg.initial_guess = "stokes"
        s = NavierStokesSolver(unit_square(4), cfg, forcing=forcing_xt, **kw)
    elif name == "cc_coarse":
        s = NavierStokesSolver(unit_square(4),
                               unsteady_config("cahouet_chabard", cc_coarse_agg=128), **kw)
    else:  # "block_triangular", with the XDMF writer's partitioning
        s = NavierStokesSolver(unit_square(4), unsteady_config("block_triangular"), **kw)
        if out is not None:
            from navier_stokes_tpu_torch.io.xdmf import XdmfWriter

            s.setup()
            w = XdmfWriter(s.dofs, output_dir=str(Path(out) / "xdmf"),
                           partitioning=s.cell_owner)
            s.output_hooks.append(lambda st, t, sol: w.write(st, t, sol))
    s.solve()
    got = dict(nodes=by_node(s), log=trajectory(log), cell_owner=s.cell_owner)
    if name == "block_triangular" and out is not None:
        # a checkpoint written by rank 0 and restored by every rank of a
        # new solver gives each rank its chunk back, bit for bit
        path = str(Path(out) / "checkpoint.h5")
        s.save_checkpoint(path)
        s2 = NavierStokesSolver(unit_square(4), unsteady_config("block_triangular"),
                                log=RunLog(verbose=False), n_devices=n_devices, device="cpu")
        s2.restore_checkpoint(path)
        got["restored"] = all(torch.equal(getattr(s2, k), getattr(s, k))
                              for k in ("solution", "solution_old", "solution_old2"))
        got["planar"] = s._planar(s.solution)
    if name == "forcing":
        got["stokes_iters"] = int(s.stokes_result.iters)
    return got


CASES = ("block_triangular", "cc_coarse", "steady", "scanned", "forcing", "stokes")


def solves(rank, n, init, out):
    join(rank, n, init)
    res = {name: run_case(name, n, out) for name in CASES}
    if rank == 0:
        torch.save(res, Path(out) / "solves.pt")
    bootstrap.shutdown_distributed()


def cli(rank, n, init, argv):
    """The command line on this rank, its process group joined first (as
    torchrun's environment would have it joined)."""
    from navier_stokes_tpu_torch.__main__ import main

    join(rank, n, init)
    if main(argv) != 0:
        raise RuntimeError("the command line failed")
