"""What each rank of tests/test_torch_spmd.py, tests/test_torch_spmd_3d.py,
tests/test_torch_spmd_flat.py, tests/test_torch_spmd_p3.py,
tests/test_torch_capacity.py and tests/test_torch_deflation.py runs (a module of its own, so that the spawned
ranks import torch and the port but not JAX).

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
from navier_stokes_tpu_torch.mesh.generate import box, rectangle, unit_square
from navier_stokes_tpu_torch.models.navier_stokes import NavierStokesSolver
from navier_stokes_tpu_torch.models.stokes import StokesSolver
from navier_stokes_tpu_torch.ops import windowed as W
from navier_stokes_tpu_torch.parallel import bootstrap
from navier_stokes_tpu_torch.parallel import windowed_spmd as ws
from navier_stokes_tpu_torch.utils.logging import RunLog

BLOCKS = [("v", "v"), ("v", "p"), ("p", "p")]
SPAWN_TIMEOUT_S = 300


def start(fn, n, init, *args):
    """Start fn(rank, n, init, *args) on n spawned ranks; ``wait`` joins
    them (the caller may work meanwhile)."""
    return mp.start_processes(fn, args=(n, init, *args), nprocs=n, join=False,
                              start_method="spawn")


def wait(ctx, name="the ranks"):
    """Join the ranks of ``start``: a rank's exception fails the caller, and
    so does a group that outlasts SPAWN_TIMEOUT_S (its ranks are killed)."""
    deadline = time.monotonic() + SPAWN_TIMEOUT_S
    while not ctx.join(timeout=5):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"{name} outlasted {SPAWN_TIMEOUT_S} s")


def spawn(fn, n, init, *args):
    """Run fn(rank, n, init, *args) on n spawned ranks and wait (``wait``)."""
    wait(start(fn, n, init, *args), f"{fn.__name__} on {n} ranks")


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


# the P3/P2 kernel problems (tests/test_torch_spmd_p3.py): name: (mesh, cells
# a block).  At 2 and 4 ranks unit_square(6) at 8 cells a block has 10 / 12
# blocks and halos hv = hp = 2; box(6, 6, 6) at 28 cells a block 48 blocks
# and hv = hp = 6, the widest halo a layout takes
P3_MESHES = {"square-p3": (lambda: unit_square(6), 8), "box-p3": (lambda: box(6, 6, 6), 28)}


def kernel_problem(n_dev, refine=6, mesh="square"):
    """tests/test_windowed_spmd.py's ``_problem`` with the port's layout
    and seeded inputs: (dofs, layout, A_t, x, R), numpy arrays.  The mesh
    is unit_square(refine), or for mesh "box" box(4, 4, 4), whose 384
    tetrahedra at 16 cells a block give 24 blocks and halos hv = hp = 4, or
    a P3/P2 problem of ``P3_MESHES``."""
    if mesh in P3_MESHES:
        make, cpb = P3_MESHES[mesh]
        m = make()
        dofs, bi = renumber_blocked(make_dofs(m, 3, 2), cells_per_block=cpb, nb_multiple=n_dev)
    else:
        m = box(4, 4, 4) if mesh == "box" else unit_square(refine)
        dofs, bi = renumber_blocked(make_dofs(m), cells_per_block=16, nb_multiple=n_dev)
    lay = W.build_windowed_layout(dofs.cell_vdofs, dofs.cell_pdofs, dofs.n_vs, dofs.n_ps, m.dim,
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


def kernels(rank, n, init, out, mesh="square"):
    """``kernel_results`` on this rank, saved, after joining the group (and
    a record of the join)."""
    joined = join(rank, n, init)
    res = kernel_results(rank, n, mesh)
    bootstrap.shutdown_distributed()
    res["joined"] = dict(joined, left=not dist.is_initialized())
    torch.save(res, Path(out) / f"kernels{n}_{rank}.pt")


def kernel_results(rank, n, mesh="square"):
    """Every plain version at this rank's framed layout of the ``mesh``
    problem, on its shard of the global inputs; and the exchange one
    product makes."""
    g = dist.group.WORLD
    dofs, lay, A, x, R = kernel_problem(n, mesh=mesh)
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
    if mesh != "square":
        res["volume"] = exchange_of_one_matvec(rank, n, problem=(dofs, lay, A, x, R))
    elif n == 2:
        res["volume"] = {refine: exchange_of_one_matvec(rank, n, refine)
                         for refine in (6, 12)}
    return res


def exchange_of_one_matvec(rank, n, refine=6, problem=None):
    """Floats sent, each send's length and the all-reduces of one sharded
    windowed_matvec on ``kernel_problem``'s mesh (or on ``problem``, one
    it made), against the rank's vector length and the layout's halo
    constants."""
    dofs, lay, A, x, _ = problem or kernel_problem(n, refine)
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
                edge=max(lay.hv * lay.OWv, lay.hp * lay.OWp), dim=lay.dim, hv=lay.hv,
                hp=lay.hp, OWv=lay.OWv, OWp=lay.OWp)


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


# ---- the sharded 3D path (tests/test_torch_spmd_3d.py) -----------------------

BOX_REL_TOL = 1e-4  # the tangent solves' tolerance


def box_inlet(x, t=0.0):
    """tests/test_torch_3d.py's ``_convection_inlet``: kernel_bench.box_inlet's
    profile (peak 1.5) ramped over t 0-0.4."""
    v = np.zeros_like(x)
    y, z = x[:, 1], x[:, 2]
    v[:, 0] = 24.0 * y * (1.0 - y) * z * (1.0 - z) * min(1.0, t / 0.4)
    return v


def box_stokes_inlet(x, t=0.0):
    """Plane Poiseuille flow u = (y(1 - y), 0, 0) on the box's inlet (tag 0)
    and z faces (tags 4, 5); with no-slip walls at y = 0, 1 (tags 2, 3)
    and p_out on the outlet it is the exact Stokes flow, in P2/P1 too."""
    v = np.zeros_like(x)
    v[:, 0] = x[:, 1] * (1.0 - x[:, 1])
    return v


def box_config(precond, cls=SolverConfig, **krylov):
    """tests/test_torch_3d.py's convection-dominated box(4, 4, 4) (the box
    configuration of kernel_bench.box_config at nu 4e-3, dt 0.2: 2 BDF1
    steps, p_out 10, the corrected formulation, 6 FGMRES sweeps of A00)
    with 16 cells a block (nb 24, hv = hp = 4) and tangents solved to
    BOX_REL_TOL, in float64; ``cls`` is either package's SolverConfig."""
    cfg = cls(inlet_tags=(0,), neumann_tags=(1,), wall_tags=(2, 3, 4, 5), nu=4e-3, rho=1.0,
              p_out=10.0, dt=0.2, T=0.4)
    if cls is SolverConfig:
        cfg.dtype = "float64"
    cfg.convection_form = "standard"
    cfg.include_continuity_residual = True
    cfg.jacobian_mass_rho = True
    cfg.krylov.max_iters = 2000
    cfg.krylov.matvec = "windowed"
    cfg.krylov.cells_per_block = 16
    cfg.krylov.preconditioner = precond
    cfg.krylov.cc_iters_a00 = 6
    cfg.krylov.a00_solver = "gmres"
    cfg.krylov.rel_tol = BOX_REL_TOL
    for k, v in krylov.items():
        setattr(cfg.krylov, k, v)
    return cfg


def box_stokes_config(cls=SolverConfig):
    """``box_config``'s windowed block_triangular Stokes solve with the
    plane Poiseuille boundaries of ``box_stokes_inlet``, at nu 0.04.  (On
    the duct of ``box_config``'s boundaries the solve's result moves by
    1e-5 between any two orders of float64 sums, JAX's 1- and 2-device runs
    alike: its Krylov iterates are that sensitive.)"""
    cfg = box_config("block_triangular", cls)
    cfg.inlet_tags, cfg.wall_tags, cfg.nu = (0, 4, 5), (2, 3), 0.04
    return cfg


BOX_CASES = {  # name: (preconditioner, krylov options)
    "cc_coarse": ("cahouet_chabard", dict(cc_coarse_agg=128)),
    "block_triangular": ("block_triangular", {}),
    "stokes": ("block_triangular", {}),
}


def run_box_case(name, n_devices):
    """One whole solve of the named box case; returns what the test
    compares."""
    log = RunLog(verbose=False)
    precond, krylov = BOX_CASES[name]
    kw = dict(log=log, n_devices=n_devices, device="cpu")
    if name == "stokes":
        s = StokesSolver(box(4, 4, 4), box_stokes_config(), inlet=box_stokes_inlet, **kw)
        s.solve()
        coords = s.dofs.v_coords[s.dofs.v_mask]
        return dict(nodes={tuple(np.round(c, 10)): v
                           for c, v in zip(coords, s.velocity(real_only=True))},
                    log=trajectory(log), frame=s._ns._win_layout.frame)
    s = NavierStokesSolver(box(4, 4, 4), box_config(precond, **krylov), inlet=box_inlet, **kw)
    s.solve()
    wa = s._wassembly
    return dict(nodes=by_node(s), log=trajectory(log), frame=s._win_layout.frame,
                coarse=(wa.coarse_inv is not None, wa.coarse_inv_v is not None))


def solves3d(rank, n, init, out):
    join(rank, n, init)
    res = {name: run_box_case(name, n) for name in BOX_CASES}
    if rank == 0:
        torch.save(res, Path(out) / "solves3d.pt")
    bootstrap.shutdown_distributed()


# ---- capacity (tests/test_torch_capacity.py) -----------------------------------


def capacity_solver(mesh, n_devices, nb_multiple=None):
    """A set-up solver on the capacity meshes: "channel", rectangle(24, 8)
    of 7 x 4 (tags 0/1 inlet/outlet, 2/3 walls), or "box", the box(4, 4, 4)
    of ``box_config``; windowed + Cahouet-Chabard at 16 cells a block, in
    float64 on the CPU."""
    if mesh == "box":
        m, cfg, inlet = box(4, 4, 4), box_config("cahouet_chabard"), box_inlet
    else:
        m, cfg, inlet = rectangle(24, 8, 0, 7, 0, 4), unsteady_config("cahouet_chabard"), None
        cfg.inlet.freeze_time, cfg.inlet.H = False, 4.0
    return NavierStokesSolver(m, cfg, log=RunLog(verbose=False), inlet=inlet,
                              n_devices=n_devices, device="cpu", nb_multiple=nb_multiple).setup()


def held_bytes(s):
    """{buffer: bytes this rank holds} of the solve state's large buffers,
    the replicated leaves' bytes, and (tetrahedra) the entries of the
    rank's compact tables: their count and each chunk's first."""
    wa, lay = s._wassembly, s._win_layout
    big = {name: getattr(wa, name) for name in ("A_const", "invJT_t", "W_t", "Kp_t",
                                                 "r_const", "inv_mp", "diag_kp")}
    big.update({name: getattr(lay, name) for name in ("cell_ids", "loc_v_hi", "loc_v_lo",
                                                      "loc_p_hi", "loc_p_lo")})
    out = dict(big={k: t.numel() * t.element_size() for k, t in big.items()})
    rep = [wa.N_v, wa.N_p, wa.NN, wa.G_v, wa.coarse_inv, wa.coarse_inv_v]
    out["replicated"] = sum(t.numel() * t.element_size() for t in rep if t is not None)
    if lay.dim == 3:
        tabs = W.compact_tables(lay)
        out["compact"] = {k: dict(E=t.E, off=t.off.numpy()) for k, t in tabs.items()}
    return out


def newton_step(s, seed=7):
    """One sharded Newton step at the seeded state 0.05 * standard_normal of
    the planar vector (this rank's chunk): (finite, FGMRES count,
    converged, entry ||r||)."""
    y = 0.05 * np.random.default_rng(seed).standard_normal(s.dofs.n_total)
    if s._dist is not None:
        y = ws.to_dist(y, s._dist)[s._rank * s._n_state:][: s._n_state]
    u = torch.as_tensor(y)
    u_new, res, iters, conv, _ = s._newton_iteration(u, s.solution_old, s._bc_values(s.cfg.dt),
                                                     s.cfg.dt, True)
    return dict(finite=bool(torch.isfinite(u_new).all()), iters=int(iters), converged=bool(conv),
                entry=float(res))


def capacity(rank, n, init, out):
    join(rank, n, init)
    res = {}
    for mesh in ("channel", "box"):
        s = capacity_solver(mesh, n)
        res[mesh] = dict(held_bytes(s), step=newton_step(s), nb=s._dist.nb,
                         nb_loc=s._dist.nb_loc, frame=s._win_layout.frame, n_state=s._n_state)
    torch.save(res, Path(out) / f"capacity_{rank}.pt")
    bootstrap.shutdown_distributed()


# ---- the flat operator's multi-device design (tests/test_torch_spmd_flat.py) ---


def flat_forcing(pts):
    """A static body force that varies from cell to cell (so each rank's
    f_q differs)."""
    out = np.zeros_like(pts)
    out[:, 0] = np.sin(3.0 * pts[:, 1])
    out[:, 1] = pts[:, 0] * pts[:, 1]
    return out


def flat_assembly_mesh():
    """rectangle(5, 3): 30 cells (padded to 32 at 4 ranks) and 3 outlet
    facets (padded to 4 at 2 and 4 ranks)."""
    return rectangle(5, 3)


def flat_assembly_inputs(n_total):
    """Seeded u, u_old and a direction w, numpy arrays."""
    rng = np.random.default_rng(11)
    return rng.standard_normal(n_total), rng.standard_normal(n_total), rng.standard_normal(n_total)


FLAT_FORM = dict(dt=0.05, nu=0.04, rho=1.0, p_out=10.0)


def flat_assembly(rank, n, init, out):
    """The flat assembly on this rank's shard of the context, summed over
    the group: the residual, the tangent's action on w (the whole operator,
    its velocity block, B and the pressure mass), its raw diagonal and the
    Stokes rhs; and the rank's shard itself."""
    from navier_stokes_tpu_torch.fem.assembly import (assemble_navier_stokes, assemble_stokes,
                                                      build_context)
    from navier_stokes_tpu_torch.la import operators as ops
    from navier_stokes_tpu_torch.la.preconditioners import rect_matvec
    from navier_stokes_tpu_torch.parallel import spmd

    join(rank, n, init)
    g = dist.group.WORLD
    m = flat_assembly_mesh()
    dofs = make_dofs(m)
    ctx = build_context(dofs, neumann_tags=(1,), forcing=flat_forcing, dtype=torch.float64)
    order = spmd.morton_order(m.coords[m.cells].mean(axis=1))
    sc = spmd.shard_context(ctx, rank, n, order, "cpu", g)
    u, uo, w = (torch.as_tensor(a) for a in flat_assembly_inputs(dofs.n_total))
    cell_mat, cell_pmass, res = assemble_navier_stokes(sc, u, uo, **FLAT_FORM)
    empty = torch.zeros(0, dtype=torch.int64)
    op = ops.ElementOperator(cell_mat=cell_mat, cell_dofs=sc.cell_dofs, bc_rows=empty,
                             bc_diag=res.new_zeros(0), scatter_idx=sc.scatter_full,
                             n=dofs.n_total, group=g)
    nvl, n_u = sc.dim * sc.nb_v, dofs.n_u
    A00 = ops.velocity_block(op, sc.dim, sc.nb_v, n_u, scatter_idx=sc.scatter_vel)
    cell_pdofs = torch.clamp(sc.cell_dofs[:, nvl:] - n_u, min=0)
    Mp = ops.pressure_mass_block(cell_pmass, cell_pdofs, dofs.n_p, sc.scatter_p, g)
    got = dict(
        residual=res.numpy(),
        jw=ops.matvec(op, w).numpy(),
        a00w=ops.matvec(A00, w[:n_u]).numpy(),
        bw=rect_matvec(cell_mat[:, nvl:, :nvl], sc.cell_dofs[:, :nvl], cell_pdofs, dofs.n_p,
                       w[:n_u], sc.scatter_p, g).numpy(),
        mpw=ops.matvec(Mp, w[n_u:]).numpy(),
        diag=ops.raw_diagonal(cell_mat, sc.cell_dofs, dofs.n_total, sc.scatter_full, g).numpy(),
        stokes_rhs=assemble_stokes(sc, nu=0.04, rho=1.0, p_out=10.0)[2].numpy(),
    )
    torch.save(got, Path(out) / f"flat_assembly{n}_{rank}.pt")
    bootstrap.shutdown_distributed()


def flat_config(precond="identity", T=0.1, cls=SolverConfig, matvec="flat", guess="zero"):
    """tests/test_sharding.py's ``square_cfg``, float64, with the
    preconditioner, operator and initial guess named."""
    cfg = cls(inlet_tags=(0,), neumann_tags=(1,), wall_tags=(2, 3), nu=0.04, rho=1.0,
              p_out=10.0, dt=0.05, T=T)
    if cls is SolverConfig:
        cfg.dtype = "float64"
    cfg.krylov.max_iters = 400
    cfg.krylov.restart = 40
    cfg.krylov.inner_max_iters = 200
    cfg.krylov.preconditioner = precond
    cfg.krylov.matvec = matvec
    cfg.krylov.cells_per_block = 16
    cfg.initial_guess = guess
    return cfg


def flat_forcing_xt(pts, t):
    """tests/test_sharding.py's time-dependent forcing."""
    out = np.zeros_like(pts)
    out[:, 0] = t * pts[:, 1]
    return out


FLAT_CASES = {  # name: (mesh, config options, solver options)
    "identity": ((3,), {}, {}),
    "block_triangular": ((3,), dict(precond="block_triangular"), {}),
    "fallback": ((2,), dict(matvec="windowed"), {}),
    "scanned": ((3,), dict(T=0.15), {}),
    "forcing": ((4,), dict(precond="block_triangular", guess="stokes"),
                dict(forcing=flat_forcing_xt)),
    # the Stokes guess on the fallback, against the same run asked flat
    "fallback_stokes": ((2,), dict(matvec="windowed", guess="stokes"), {}),
    "flat_stokes": ((2,), dict(guess="stokes"), {}),
}


def run_flat_case(name, n_devices):
    """One whole solve of the named flat case on the CPU; returns what the
    test compares (this rank's own state, bit for bit)."""
    (refine,), ckw, skw = FLAT_CASES[name]
    cfg = flat_config(**ckw)
    if name == "forcing":  # one forced Newton update a step: a tangent solve each
        cfg.newton.min_iters = 1
    log = RunLog(verbose=False)
    s = NavierStokesSolver(unit_square(refine), cfg, log=log, n_devices=n_devices,
                           device="cpu", **skw)
    if name == "scanned":
        got = s.solve_scanned(functional=scan_functional, newton_iters=3, chunk=2,
                              reaction_tags=(2,))
        res = dict(functional=got["functional"], reaction=got["reaction"],
                   iters=got["gmres_iters"], residual=got["residual"])
    else:
        s.solve()
        res = dict(log=trajectory(log))
    res.update(solution=s.solution.numpy(), matvec=s._matvec, cell_owner=s.cell_owner,
               n_cells=s.ctx.n_cells)
    return res


def flat_solves(rank, n, init, out, names):
    """The named flat cases on n ranks; every rank saves its results."""
    join(rank, n, init)
    res = {name: run_flat_case(name, n) for name in names}
    torch.save(res, Path(out) / f"flat_solves{n}_{rank}.pt")
    bootstrap.shutdown_distributed()


# ---- sharded P3/P2 (tests/test_torch_spmd_p3.py) --------------------------------


def p3_config(cls=SolverConfig):
    """tests/test_torch_solver.py's P3/P2 slice (the corrected formulation,
    BDF1, 2 steps, no preconditioner, u_m 1, FGMRES(200) capped at 200) on
    the windowed operator at 8 cells a block, float64."""
    cfg = cls()
    cfg.convection_form = "standard"
    cfg.include_continuity_residual = True
    cfg.jacobian_mass_rho = True
    cfg.rho = 1.2
    if cls is SolverConfig:
        cfg.dtype = "float64"
    cfg.T, cfg.dt = 0.1, 0.05
    cfg.degree_velocity, cfg.degree_pressure = 3, 2
    cfg.inlet_tags, cfg.neumann_tags, cfg.wall_tags = (0,), (1,), (2, 3)
    cfg.inlet.freeze_time, cfg.inlet.H, cfg.inlet.u_m = False, 1.0, 1.0
    cfg.krylov.matvec = "windowed"
    cfg.krylov.preconditioner = "identity"
    cfg.krylov.cells_per_block = 8
    cfg.krylov.restart = cfg.krylov.max_iters = 200
    return cfg


def p3_box_config(cls=SolverConfig):
    """``box_config``'s box at P3/P2 with no preconditioner, one BDF1 step,
    the tangent solved to 1e-8 (at ``BOX_REL_TOL`` the unpreconditioned
    restarted FGMRES lets the order of float64 sums move the update by
    ~1e-7 of its max, one device against another)."""
    cfg = box_config("identity", cls, rel_tol=1e-8)
    cfg.degree_velocity, cfg.degree_pressure = 3, 2
    cfg.T = cfg.dt
    return cfg


def p3_solve(n_devices):
    """The P3/P2 slice of ``p3_config`` on unit_square(6): this rank's
    results (velocity by node, the trajectory, the frame)."""
    log = RunLog(verbose=False)
    s = NavierStokesSolver(unit_square(6), p3_config(), log=log, n_devices=n_devices,
                           device="cpu")
    s.solve()
    lay = s._win_layout
    return dict(nodes=by_node(s), log=trajectory(log), frame=lay.frame, nb=s._lay_global.nb,
                hv=lay.hv, k=(lay.k_v, lay.k_p))


def p3_box_fallback(n_devices):
    """``p3_box_config`` on box(3, 3, 3), where no windowed layout fits 4
    ranks: the path taken and one BDF1 step (this rank's state whole); and
    the path box(4, 4, 4) takes (set up only: its layout's block count and
    halo, or None on the flat path)."""
    log = RunLog(verbose=False)
    s = NavierStokesSolver(box(3, 3, 3), p3_box_config(), log=log, inlet=box_inlet,
                           n_devices=n_devices, device="cpu")
    s.solve()
    s4 = NavierStokesSolver(box(4, 4, 4), p3_box_config(), log=RunLog(verbose=False),
                            inlet=box_inlet, n_devices=n_devices, device="cpu").setup()
    lay4 = s4._lay_global
    return dict(matvec=s._matvec, solution=s.solution.numpy(), log=trajectory(log),
                cell_owner=s.cell_owner, box4=(s4._matvec, lay4 and (lay4.nb, lay4.hv)))


def p3(rank, n, init, out):
    """Sharded P3/P2 on n ranks: ``kernel_results`` on every problem of
    P3_MESHES; at 2 ranks the P3/P2 slice, at 4 the box that falls through
    to the flat design.  Every rank saves its results."""
    join(rank, n, init)
    res = {mesh: kernel_results(rank, n, mesh) for mesh in P3_MESHES}
    res["solve"] = p3_solve(n) if n == 2 else p3_box_fallback(n)
    torch.save(res, Path(out) / f"p3_{n}_{rank}.pt")
    bootstrap.shutdown_distributed()


# ---- FGMRES deflation (tests/test_torch_deflation.py) ---------------------------


def channel_config(cls=SolverConfig, kp_deflate=2, **krylov):
    """The weakly pinned channel of tests/test_kp_deflation.py
    (``channel_mesh``: the outlet, tag 1, one short edge), windowed +
    Cahouet-Chabard at 64 cells a block without the Kp coarse space, 2 BDF1
    steps in float64; ``cls`` is either package's SolverConfig."""
    cfg = cls(inlet_tags=(0,), neumann_tags=(1,), wall_tags=(2, 3), nu=0.001, dt=0.05)
    cfg.dtype = "float64"
    cfg.T, cfg.time_scheme = 0.1, "bdf1"
    cfg.krylov.matvec = "windowed"
    cfg.krylov.cells_per_block = 64
    cfg.krylov.preconditioner = "cahouet_chabard"
    cfg.krylov.cc_coarse_agg = 0
    cfg.krylov.kp_deflate = kp_deflate
    for k, v in krylov.items():
        setattr(cfg.krylov, k, v)
    return cfg


def channel_mesh(rect=rectangle):
    return rect(48, 6, 0, 4, 0, 0.4)


def deflated_step(n_devices, nb_multiple=None, seed=7):
    """A forced Newton step of ``channel_config``'s deflated solver at the
    seeded state 0.05 * standard_normal of the planar vector: the entry
    ||r||, FGMRES count, convergence, the planar update (gathered from every
    rank) and the deflation rows' count."""
    s = NavierStokesSolver(channel_mesh(), channel_config(), log=RunLog(verbose=False),
                           n_devices=n_devices, device="cpu", nb_multiple=nb_multiple).setup()
    y = 0.05 * np.random.default_rng(seed).standard_normal(s.dofs.n_total)
    if s._dist is not None:
        y = ws.to_dist(y, s._dist)[s._rank * s._n_state:][: s._n_state]
    u = torch.as_tensor(y)
    u_new, res, iters, conv, _ = s._newton_iteration(u, torch.zeros_like(u),
                                                     s._bc_values(s.cfg.dt), s.cfg.dt, True)
    return dict(entry=float(res), iters=int(iters), converged=bool(conv),
                update=s._planar(u_new - u), rows=s._wassembly.kp_modes.shape[0])


def deflation(rank, n, init, out):
    join(rank, n, init)
    got = deflated_step(n)
    if rank == 0:
        torch.save(got, Path(out) / "deflation.pt")
    bootstrap.shutdown_distributed()
