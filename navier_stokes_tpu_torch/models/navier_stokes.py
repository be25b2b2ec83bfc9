"""Unsteady incompressible Navier-Stokes solver: BDF1/BDF2 + Newton + FGMRES.

Port of the single-device paths of ``navier_stokes_tpu/models/navier_stokes.py``:

  * setup()   DoFs, the operator layout and the assembly precompute.  With
              ``krylov.matvec="windowed"`` a blocked renumbering and the
              windowed layout; where no feasible layout exists (or with
              "flat") the flat element operator of la/operators.py.
  * one Newton iteration: assembly (windowed: K3 gather + K4 scatter; flat:
              fem/assembly.py through the gather maps), Dirichlet rows, the
              residual norm, and the preconditioned FGMRES tangent solve.
  * preconditioners: identity, block_diagonal, block_triangular (flat and
              windowed), cahouet_chabard (windowed; on the flat path it
              degrades to block_triangular, as in the original).
  * stokes_initial_guess(), solve_newton(), solve(resume=...), output hooks,
              time-dependent forcing f(x, t) (re-evaluated at each new time
              level).
  * solve_steady(): Newton on the steady residual from the Stokes guess,
              with a backtracking line search; the tangent solved by FGMRES
              on the windowed kernels or, with tangent_solver="lu", by
              SuperLU on the host.
  * solve_scanned(): the time loop in chunks of steps with a fixed number of
              Newton sweeps a step, per-step functionals and boundary
              reactions, and the solver's state rebound at every chunk edge.
  * save_checkpoint() / restore_checkpoint() (io/checkpoint.py, needs h5py).

The JAX version compiles one Newton iteration into one device program (and
solve_scanned a whole chunk of steps into one lax.scan); here it is eager
torch with one host read of the residual norm per Newton iteration, one per
FGMRES step, and one per iteration of an inner solve that stops at a
tolerance.

Dirichlet semantics match ``apply_boundary_values(..., false)``: constrained
rows are replaced by ``diag * x`` with the pre-constraint assembled diagonal
and the residual rows by ``diag * target``.

Several ranks (``n_devices`` > 1, one process a rank, the process group
joined first: parallel/bootstrap.py) run one of the original's two domain
decompositions.  The windowed operator runs the owned-range design of
parallel/windowed_spmd.py: each rank builds the host structures in full,
then keeps on its device its framed local layout, its shard of the assembly
precompute and the owned chunks of every state and Krylov vector.  The
kernels exchange edge blocks with the ring neighbours (ops/windowed.py),
dots and norms all-reduce, and the planar state is gathered only for
output, checkpoints and functionals.  The flat operator (asked for, or where
no windowed layout fits at that rank count) runs the replicated design of
parallel/spmd.py: each rank holds a Morton chunk of the cells, every
assembly and operator product is all-reduced, and the state and Krylov
vectors are whole and equal on every rank, so dots need no collective and
output needs no gather.
"""

from __future__ import annotations

import copy
import dataclasses

import numpy as np
import torch

from ..config import SolverConfig
from ..fem.assembly import assemble_navier_stokes, build_context
from ..fem.bcs import DirichletBC, build_dirichlet
from ..fem.dofs import make_dofs, renumber_blocked
from ..fem.functions import InletVelocity, ZeroForcing
from ..fem.geometry import cell_geometry
from ..fem.quadrature import gauss_simplex
from ..fem.windowed_assembly import (
    assemble_windowed, build_windowed_assembly, compute_r_const)
from ..la import operators as ops
from ..la.cg import cg
from ..la.operators import vnorm
from ..la.gmres import fgmres
from ..la.preconditioners import (
    block_diagonal, block_triangular, coarse_correction, identity, inner_cg, jacobi,
    two_level_vcycle)
from ..mesh.mesh import Mesh
from ..mesh.msh_io import read_msh
from ..ops.windowed import (
    build_windowed_layout, slice_block, windowed_matvec, windowed_matvec_block,
    windowed_scatter)
from ..parallel import spmd
from ..parallel import windowed_spmd as wspmd
from ..parallel.bootstrap import local_device, process_count, process_index
from ..utils.logging import RunLog
from ..utils.timers import PhaseTimers

__all__ = ["NavierStokesSolver"]

PRECONDITIONERS = ("identity", "block_diagonal", "block_triangular", "cahouet_chabard")


def _takes_time(forcing) -> bool:
    """True if the forcing callable is f(x, t) rather than f(x) (see the
    original: uninspectable or ``*args`` signatures raise)."""
    import inspect

    try:
        try:
            sig = inspect.signature(forcing)
        except (TypeError, ValueError):
            sig = inspect.signature(forcing.__call__)
    except (TypeError, ValueError, AttributeError) as e:
        raise TypeError(
            f"cannot infer whether forcing {forcing!r} takes a time "
            "argument (uninspectable signature); pass "
            "forcing_time_dependent=True/False explicitly"
        ) from e
    params = list(sig.parameters.values())
    if any(p.kind == p.VAR_POSITIONAL for p in params):
        raise TypeError(
            f"forcing {forcing!r} has a *args signature — ambiguous arity; "
            "pass forcing_time_dependent=True/False explicitly"
        )
    positional = [
        p for p in params if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)
    ]
    return len(positional) >= 2


def _norm(v: torch.Tensor, group=None) -> float:
    return float(vnorm(v, group))


def _check_devices(n_devices):
    """Raise unless n_devices is one this port runs: None, or the size of
    the joined process group."""
    if n_devices is None:
        return
    world = process_count()
    if n_devices != world:
        raise ValueError(
            f"n_devices={n_devices}, but the process group has {world} rank(s): "
            "start one process a rank (torchrun) and join the group first "
            "(parallel.bootstrap.initialize_distributed)")


def _resolve_dtype(name: str) -> torch.dtype:
    return {
        "auto": torch.get_default_dtype(),
        "float32": torch.float32,
        "float64": torch.float64,
    }[name]


class NavierStokesSolver:
    def __init__(
        self,
        mesh: Mesh | str,
        config: SolverConfig | None = None,
        log: RunLog | None = None,
        forcing=None,
        inlet=None,
        n_devices: int | None = None,
        forcing_time_dependent: bool | None = None,
        device="cuda",
        nb_multiple: int | None = None,
    ):
        """mesh: a Mesh or the path of a gmsh .msh file.  device: where the
        state, the operator and the kernels live ("cuda" runs the
        hand-written kernels; "cpu" their plain versions; in a sharded run
        a bare "cuda" is the rank's ``cuda:LOCAL_RANK``).  n_devices: the
        number of ranks of a sharded run, which must be the size of the
        joined process group (None: this process alone).  nb_multiple: the
        windowed layout's block count is rounded up to a multiple of it
        (default n_devices): one device at an n-rank run's numbering, so
        the two runs share blocks and coarse aggregates."""
        self.cfg = config or SolverConfig()
        self.mesh = read_msh(mesh) if isinstance(mesh, str) else mesh
        _check_devices(n_devices)
        self.n_devices = n_devices
        self.nb_multiple = nb_multiple or n_devices or 1
        if self.nb_multiple % (n_devices or 1):
            raise ValueError(f"nb_multiple={nb_multiple} is not a multiple of "
                             f"n_devices={n_devices}")
        self.log = log or RunLog()
        self.device = local_device(device) if (n_devices or 1) > 1 else torch.device(device)
        self.forcing = forcing or ZeroForcing()
        self._forcing_time_dep_override = forcing_time_dependent
        self.inlet = inlet or InletVelocity(
            u_m=self.cfg.inlet.u_m, H=self.cfg.inlet.H, freeze_time=self.cfg.inlet.freeze_time
        )
        self.time = 0.0
        self._step = 0
        self._is_setup = False
        self.output_hooks = []  # callables (step, t, solution)
        self.timers = PhaseTimers(device=self.device)

    # ------------------------------------------------------------------
    def setup(self):
        """Build DoFs, layout, assembly precompute and BC structure."""
        cfg, log = self.cfg, self.log
        k = cfg.krylov
        if k.preconditioner not in PRECONDITIONERS:
            raise ValueError(f"unknown preconditioner {k.preconditioner!r}")
        if cfg.initial_guess not in ("zero", "stokes"):
            raise ValueError(f"unknown initial_guess {cfg.initial_guess!r}")
        log.print("Initializing the mesh")
        log.print(f"  Number of elements = {self.mesh.n_cells}")
        log.rule()

        log.print("Initializing the finite element space")
        if cfg.time_scheme not in ("bdf1", "bdf2"):
            raise ValueError(f"unknown time_scheme {cfg.time_scheme!r}")
        # the tangent's time-term step: BDF2's mass coefficient is 3/(2 dt)
        self._dt_tangent = cfg.dt / 1.5 if cfg.time_scheme == "bdf2" else cfg.dt
        self.dofs = make_dofs(self.mesh, cfg.degree_velocity, cfg.degree_pressure)
        self._win_layout = None
        self._wassembly = None
        # a sharded run: the process group and the rank; the windowed
        # operator's distributed vector layout and the global layout beside
        # the rank's framed one; the flat operator's Morton cell order
        # (None on one device)
        self._group = torch.distributed.group.WORLD if (self.n_devices or 1) > 1 else None
        self._rank = process_index()
        self._dist = None
        self._cell_order = None
        self._lay_global = None
        # the resolved operator mode lives on the solver, not in the config
        self._matvec = k.matvec
        if self._matvec == "windowed":
            self._setup_windowed_layout()
        self._precond = k.preconditioner
        if self._matvec == "flat" and self._precond == "cahouet_chabard":
            # the CC Schur sweep is built on the windowed block kernels
            log.print(
                "  (cahouet_chabard requires the windowed operator: "
                "using block_triangular on the flat path)"
            )
            self._precond = "block_triangular"

        elem = self.dofs.element
        log.print(f"  Velocity degree:           = {cfg.degree_velocity}")
        log.print(f"  Pressure degree:           = {cfg.degree_pressure}")
        log.print(f"  DoFs per cell              = {elem.dofs_per_cell}")
        log.rule()

        log.print("Initializing the DoF handler")
        log.print("  Number of DoFs: ")
        log.print(f"    velocity = {self.dofs.n_u}")
        log.print(f"    pressure = {self.dofs.n_p}")
        log.print(f"    total    = {self.dofs.n_total}")
        log.rule()

        log.print("  Initializing the linear system")
        self._dtype = _resolve_dtype(cfg.dtype)
        self._forcing_time_dep = (
            self._forcing_time_dep_override
            if self._forcing_time_dep_override is not None
            else _takes_time(self.forcing)
        )
        self._f_qpts = None  # quadrature points of a time-dependent forcing
        # a sharded run builds the flat context on the host: it feeds the
        # windowed host precompute, whose shards go to the device, or gives
        # the rank its chunk of the cells (the flat operator)
        self.ctx = build_context(
            self.dofs,
            neumann_tags=cfg.neumann_tags,
            forcing=(lambda pts: self.forcing(pts, 0.0))
            if self._forcing_time_dep
            else self.forcing,
            quadrature_degree=cfg.quadrature_degree,
            dtype=self._dtype,
            device=self.device if self._group is None else "cpu",
        )
        # the output writer's per-cell partitioning: the rank owning each
        # cell's home block, or its Morton chunk (one device owns all)
        self.cell_owner = np.zeros(self.mesh.n_cells, dtype=np.int32)
        if self._group is not None and self._dist is None:
            # the flat operator's multi-device design (parallel/spmd.py)
            n_dev = self.n_devices
            self._cell_order = spmd.morton_order(self.mesh.coords[self.mesh.cells].mean(axis=1))
            self.ctx = spmd.shard_context(self.ctx, self._rank, n_dev, self._cell_order,
                                          self.device, self._group)
            self.cell_owner = spmd.cell_owner(self.mesh.n_cells, n_dev, self._cell_order)
            log.print(f"  Domain decomposition: {n_dev} devices, "
                      f"{spmd.padded_count(self.mesh.n_cells, n_dev)} padded cells")
        if self._dist is not None:
            lay = self._lay_global
            ids = lay.cell_ids.numpy()  # [nb, Bmax], padded slots repeat ids
            valid = lay.loc_p_hi.numpy()[:, 0, :] < lay.RVp
            block_of = np.broadcast_to(np.arange(lay.nb)[:, None], ids.shape)
            self.cell_owner[ids[valid]] = block_of[valid] // self._dist.nb_loc
        if self._win_layout is not None:
            self._setup_windowed_assembly()

        # Dirichlet: inlet first, walls override on shared DoFs
        specs = [
            DirichletBC(tags=tuple(cfg.inlet_tags), value=self.inlet),
            DirichletBC(tags=tuple(cfg.wall_tags)),
        ]
        self.dirichlet = build_dirichlet(self.dofs, specs)
        rows = np.asarray(self.dirichlet.rows, np.int64)
        if self._dist is not None:
            # this rank's rows, in its owned vector (the sentinel-padded
            # table's real entries come first)
            local, self._bc_dev, self._bc_slot = wspmd.localize_rows(rows, self._dist)
            self._bc_m = local.shape[1]
            rows = local[self._rank][local[self._rank] < self._dist.llen].astype(np.int64)
        self._bc_rows = torch.as_tensor(rows, device=self.device)
        self._n_state = self.dofs.n_total if self._dist is None else self._dist.llen
        self.solution = torch.zeros(self._n_state, dtype=self._dtype, device=self.device)
        self.solution_old = self.solution
        self.solution_old2 = None
        self._is_setup = True
        return self

    def _setup_windowed_layout(self):
        """Blocked renumbering + windowed layout; falls back to the flat
        path (and says so) when the halo stays too wide.  In a sharded run
        the blocks come in a multiple of the rank count, the global layout
        stays on the host and the rank's framed layout goes to its device."""
        k, log = self.cfg.krylov, self.log
        n_dev = self.n_devices or 1
        base_dofs = self.dofs
        cpb = k.cells_per_block
        while -(-self.mesh.n_cells // cpb) > 16384:
            cpb *= 2
        if cpb != k.cells_per_block:
            log.print(
                f"  cells_per_block {k.cells_per_block} -> {cpb} "
                "(block-count backstop: <=16384 blocks)"
            )
        for _ in range(4):
            try:
                dofs_r, block_info = renumber_blocked(base_dofs, cells_per_block=cpb,
                                                      nb_multiple=self.nb_multiple)
                lay = build_windowed_layout(
                    dofs_r.cell_vdofs, dofs_r.cell_pdofs, dofs_r.n_vs, dofs_r.n_ps,
                    self.mesh.dim, block_info=block_info, Bc=k.chunk_cells,
                    device=self.device if n_dev == 1 else "cpu",
                )
                if n_dev > 1:
                    self._dist = wspmd.make_dist_layout(lay, n_dev)
                self._lay_global = self._win_layout = lay
                self.dofs = dofs_r
                break
            except ValueError:
                cpb *= 2  # halo too wide (or too few blocks a rank)
        if self._win_layout is None:
            log.print("  (windowed layout infeasible for this mesh: flat path)")
            self._matvec = "flat"
            return
        log.print(
            f"  Windowed operator: {lay.nb} blocks "
            f"(cells/block {cpb}), pad {lay.pad_factor:.2f}"
            + (f", {self._dist.nb_loc} blocks/device" if self._dist else "")
        )
        if self._dist is not None:
            self._win_layout = wspmd.local_layout(lay, self._dist, self._rank).to(self.device)
            log.print(
                f"  Domain decomposition: {n_dev} devices x {self._dist.nb_loc} blocks, "
                f"halo {self._win_layout.frame}"
            )

    def _setup_windowed_assembly(self):
        cfg, k, log = self.cfg, self.cfg.krylov, self.log
        if k.tangent_store_dtype not in ("float32", "bfloat16"):
            raise ValueError(
                "krylov.tangent_store_dtype must be 'float32' or "
                f"'bfloat16', got {k.tangent_store_dtype!r}"
            )
        f32 = self._dtype == torch.float32
        if k.tangent_store_dtype == "bfloat16" and k.operator_dtype == "float32" and f32:
            log.print(
                "  note: operator_dtype='float32' is ineffective with a "
                "bfloat16 tangent store (the operator streams the bf16 "
                "store); set tangent_store_dtype='float32' for an exact "
                "outer operator"
            )
        store = torch.bfloat16 if (k.tangent_store_dtype == "bfloat16" and f32) else None
        self._wassembly = self._build_wa(
            dt=self._dt_tangent,
            nu=cfg.nu,
            rho=cfg.rho,
            p_out=cfg.p_out,
            store_dtype=store,
            jacobian_mass_rho=cfg.jacobian_mass_rho,
            pin_pdofs=self.dofs.boundary_scalar_pdofs(cfg.neumann_tags),
            coarse_agg=k.cc_coarse_agg,
            coarse_agg_v=k.cc_coarse_agg_v,
            pin_vdofs=self.dofs.boundary_scalar_vdofs(
                tuple(cfg.inlet_tags) + tuple(cfg.wall_tags)
            ),
            coarse_cond_cap=k.cc_coarse_cond_cap,
            kp_deflate=k.kp_deflate,
            kp_deflate_min_amp=k.kp_deflate_min_amp,
        )

    def _build_wa(self, **kw):
        """``build_windowed_assembly`` on the global layout; in a sharded run
        the rank's shard of it on its device (``shard_wa``)."""
        wa = build_windowed_assembly(self.ctx, self._lay_global, self.dofs, **kw)
        if self._dist is None:
            return wa
        return wspmd.shard_wa(wa, self._dist, self._win_layout, self._rank, self.device)

    def _bc_values(self, t: float) -> torch.Tensor:
        """The Dirichlet values at time t of this rank's rows (``_bc_rows``),
        in the working dtype on the device."""
        vals = np.asarray(self.dirichlet.values(t))
        if self._dist is not None:
            vals = wspmd.localize_values(vals, self._bc_dev, self._bc_slot, self._dist.n_dev,
                                         self._bc_m)[self._rank][: len(self._bc_rows)]
        return torch.as_tensor(vals, device=self.device).to(self._dtype)

    # ------------------------------------------------------------------
    def _make_preconditioner(self, op: ops.ElementOperator, cell_pmass):
        """The configured preconditioner on the flat element operators."""
        cfg, ctx = self.cfg, self.ctx
        kind = self._precond
        if kind == "identity":
            return identity()
        dim, nb_v, nb_p = ctx.dim, ctx.nb_v, ctx.nb_p
        nvl = dim * nb_v
        A00 = ops.velocity_block(
            op, dim, nb_v, self.dofs.n_u,
            bc_mask=np.asarray(self.dirichlet.rows) < self.dofs.n_u,
            scatter_idx=ctx.scatter_vel,
        )
        # pressure-space cell dofs; a sharded context's padded cells carry
        # dof 0, clamped to pressure dof 0 (their values are exact zeros)
        cell_pdofs = torch.clamp(ctx.cell_dofs[:, -nb_p:] - self.dofs.n_u, min=0)
        Mp = ops.pressure_mass_block(cell_pmass, cell_pdofs, self.dofs.n_p,
                                     scatter_idx=ctx.scatter_p, group=ctx.group)
        if kind == "block_diagonal":
            return block_diagonal(
                A00, Mp, inner_tol=cfg.krylov.inner_tol,
                inner_maxiter=min(cfg.krylov.inner_max_iters, 1000),
            )
        if kind == "block_triangular":
            return block_triangular(
                A00, Mp, op.cell_mat[:, nvl:, :nvl], op.cell_dofs[:, :nvl], cell_pdofs,
                inner_tol=cfg.krylov.inner_tol, inner_maxiter=cfg.krylov.inner_max_iters,
                B_scatter_idx=ctx.scatter_p,
            )
        raise ValueError(f"unknown preconditioner {kind!r}")

    def _make_windowed_preconditioner(self, lay, A_t, wa, bc_diag, diag0, bc_rows,
                                      mass_coef=None, kind=None, a00_solver=None):
        """Schur preconditioners on the windowed operator.

        block_diagonal / block_triangular mirror the reference classes
        (hpp:520-639) with the lumped pressure-mass inverse as the Schur
        surrogate; their inner solves run on the whole-system kernel (K1).
        cahouet_chabard: S^-1 ~ nu*rho*Mp^-1 + mass_coef*Kp^-1, with
        fixed-length coarse-corrected Jacobi-CG sweeps on A00 and on the
        pressure Laplacian Kp through the block kernel (K2).  mass_coef None
        is the time-stepping tangent's coefficient; the steady solve passes
        0.0.  a00_solver None is ``krylov.a00_solver``.  In a sharded run
        every vector is the rank's owned chunk, bc_rows its local rows, and
        the products and dots run over the process group."""
        cfg = self.cfg
        k = cfg.krylov
        kind = kind or self._precond
        a00_solver = a00_solver or k.a00_solver
        if kind == "identity":
            return identity()
        g = self._group
        n_u = lay.dim * lay.nvs_own
        n = n_u + lay.nps_own
        inv_mp = wa.inv_mp
        has_bc = bc_rows.shape[0] > 0

        # Jacobi diagonal of A00 with symmetric-BC replacement, plus the
        # two-level velocity coarse correction when built
        diag_u = diag0[:n_u].clone()
        if has_bc:
            diag_u[bc_rows] = bc_diag
        pA = jacobi(diag_u)
        coarse_v = None
        if wa.coarse_inv_v is not None:
            jac_u = pA
            coarse_v = coarse_correction(
                wa.agg_v, wa.coarse_inv_v, wa.coarse_agg_size_v, ncomp=lay.dim, group=g
            )
            pA = lambda r: jac_u(r) + coarse_v(r)

        if kind == "cahouet_chabard":
            return self._cahouet_chabard(lay, A_t, wa, bc_diag, bc_rows, diag_u, pA, coarse_v,
                                         mass_coef, a00_solver)

        def apply_full(xu, zero_bc):
            x = xu.new_zeros(n)
            x[:n_u] = xu
            if zero_bc and has_bc:
                x[bc_rows] = 0.0
            return windowed_matvec(lay, A_t, x, g)

        def A00_mv(v):  # SPD-consistent (symmetric BC elimination)
            y = apply_full(v, zero_bc=True)[:n_u]
            if has_bc:
                y[bc_rows] = bc_diag * v[bc_rows]
            return y

        inner_maxiter = min(k.inner_max_iters, 60)
        if a00_solver == "gmres":
            def a00_solve(vu):
                return fgmres(
                    A00_mv, vu, atol=k.inner_tol * _norm(vu, g),
                    restart=min(inner_maxiter, 30), maxiter=inner_maxiter, precond=pA, group=g,
                ).x
        else:  # "cg": reference parity (hpp:598)

            def a00_solve(vu):
                return inner_cg(A00_mv, vu, k.inner_tol * _norm(vu, g), inner_maxiter, pA, g)

        def apply(v):
            vu, vp = v[:n_u], v[n_u:]
            du = a00_solve(vu)
            if kind == "block_diagonal":
                dp = inv_mp * vp
            else:  # block_triangular Schur sweep (hpp:594-619)
                B_du = apply_full(du, zero_bc=False)[n_u:]
                dp = inv_mp * (vp - B_du)
            return torch.cat([du, dp])

        return apply

    def _cahouet_chabard(self, lay, A_t, wa, bc_diag, bc_rows, diag_u, pA, coarse_v,
                         mass_coef, a00_solver):
        cfg = self.cfg
        k = cfg.krylov
        g = self._group
        n_u = lay.dim * lay.nvs_own
        has_bc = bc_rows.shape[0] > 0
        # preconditioner blocks are stored narrower (precond_block_dtype) and
        # widened on read; the outer operator keeps its own storage
        bdt = (
            torch.bfloat16
            if (k.precond_block_dtype == "bfloat16" and A_t.dtype == torch.float32)
            else A_t.dtype
        )
        inv_mp = wa.inv_mp
        A00_blk = slice_block(lay, A_t, "v", "v").to(bdt)
        B_blk = slice_block(lay, A_t, "v", "p").to(bdt)
        Kp_blk = wa.Kp_t.to(bdt)

        def A00_mv(v):
            if has_bc:
                v = v.clone()
                v[bc_rows] = 0.0  # BC columns
            return windowed_matvec_block(lay, A00_blk, v, in_spaces="v", out_spaces="v", group=g)

        def A00_bc(v):  # SPD-consistent (symmetric BC elimination)
            y = A00_mv(v)
            if has_bc:
                y[bc_rows] = bc_diag * v[bc_rows]
            return y

        def Kp_mv(p):
            return windowed_matvec_block(lay, Kp_blk, p, in_spaces="p", out_spaces="p", group=g)

        if coarse_v is not None and k.cc_cycle_a00 == "vcycle":
            pA = two_level_vcycle(A00_bc, diag_u, coarse_v, omega=k.cc_vcycle_omega)

        pKp = jacobi(wa.diag_kp)
        if wa.coarse_inv is not None:
            jac_kp = pKp
            coarse_p = coarse_correction(wa.agg_p, wa.coarse_inv, wa.coarse_agg_size, group=g)
            pKp = lambda r: jac_kp(r) + coarse_p(r)
            if k.cc_cycle_ap == "vcycle":
                pKp = two_level_vcycle(Kp_mv, wa.diag_kp, coarse_p, omega=k.cc_vcycle_omega)
        if mass_coef is None:
            # the Laplacian term carries the tangent's time coefficient (BDF2
            # folds its 3/2 into _dt_tangent); the steady solve passes 0.0
            mass_coef = (cfg.rho if cfg.jacobian_mass_rho else 1.0) / self._dt_tangent

        if a00_solver == "gmres":
            # convection-robust inner sweep for nonsymmetric A00
            def a00_sweep(vu):
                return fgmres(
                    A00_bc, vu, atol=0.0, restart=k.cc_iters_a00,
                    maxiter=k.cc_iters_a00, precond=pA, group=g,
                ).x
        else:  # "cg": mass-dominated tangents (small dt)

            def a00_sweep(vu):
                return cg(A00_bc, vu, atol=0.0, maxiter=k.cc_iters_a00, precond=pA, group=g).x

        def apply(v):
            vu, vp = v[:n_u], v[n_u:]
            du = a00_sweep(vu)
            B_du = windowed_matvec_block(lay, B_blk, du, in_spaces="v", out_spaces="p", group=g)
            rp = vp - B_du
            dp = cfg.rho * inv_mp * rp
            if mass_coef:
                dp_lap = cg(Kp_mv, rp, atol=0.0, maxiter=k.cc_iters_ap, precond=pKp, group=g).x
                dp = dp + mass_coef * dp_lap
            return torch.cat([du, dp])

        return apply

    def _newton_iteration(self, u, u_old, bc_vals, dt_res, force_solve=False):
        """One Newton iteration: assembly, Dirichlet rows, residual norm, and
        (when above tol or forced) the preconditioned FGMRES tangent solve.
        Returns (u_new, res_norm, gmres_iters, converged, gmres_residual)."""
        cfg = self.cfg
        k = cfg.krylov
        lay, wa, bc_rows = self._win_layout, self._wassembly, self._bc_rows
        # the group of the dots: the windowed operator's vectors are split
        # over the ranks; the flat operator's are whole on every rank, and
        # its context and operators sum over the group themselves
        g = self._group if lay is not None else None
        has_bc = bc_rows.shape[0] > 0
        if lay is not None:
            A_t, residual, diag0 = assemble_windowed(
                wa, lay, u, u_old, dt=dt_res, nu=cfg.nu, rho=cfg.rho,
                convection_form=cfg.convection_form,
                include_continuity_residual=cfg.include_continuity_residual, group=g,
            )
        else:
            ctx = self.ctx
            cell_mat, cell_pmass, residual = assemble_navier_stokes(
                ctx, u, u_old, dt=dt_res, nu=cfg.nu, rho=cfg.rho, p_out=cfg.p_out,
                convection_form=cfg.convection_form,
                include_continuity_residual=cfg.include_continuity_residual,
                jacobian_mass_rho=cfg.jacobian_mass_rho,
            )
            diag0 = ops.raw_diagonal(cell_mat, ctx.cell_dofs, ctx.n_total, ctx.scatter_full,
                                     ctx.group)
        bc_diag = diag0[bc_rows]
        if cfg.dirichlet_mode == "increment":
            bc_target = bc_vals - u[bc_rows]
        else:  # "reference": delta = g verbatim
            bc_target = bc_vals
        residual[bc_rows] = bc_diag * bc_target
        res_norm = _norm(residual, g)  # host read
        if not (force_solve or res_norm > cfg.newton.tol):
            return u, res_norm, 0, True, 0.0

        if lay is not None:
            # operator_dtype "auto": a bf16-stored outer operator on the f32
            # path when the tangent tolerance is loose (widened on read)
            od = k.operator_dtype
            if od == "auto":
                od = "bfloat16" if (A_t.dtype == torch.float32 and k.rel_tol >= 5e-3) else "float32"
            A_op = (A_t.to(torch.bfloat16)
                    if (od == "bfloat16" and A_t.dtype == torch.float32) else A_t)

            def apply_op(v):
                y = windowed_matvec(lay, A_op, v, g)
                if has_bc:
                    y[bc_rows] = bc_diag * v[bc_rows]
                return y

            precond = self._make_windowed_preconditioner(lay, A_t, wa, bc_diag, diag0, bc_rows)
        else:
            op = ops.ElementOperator(
                cell_mat=cell_mat, cell_dofs=self.ctx.cell_dofs, bc_rows=bc_rows,
                bc_diag=bc_diag, scatter_idx=self.ctx.scatter_full, n=self.ctx.n_total,
                group=self.ctx.group,
            )

            def apply_op(v):
                return ops.matvec(op, v)

            precond = self._make_preconditioner(op, cell_pmass)
        f = np.float64 if u.dtype == torch.float64 else np.float32
        sol = fgmres(
            apply_op, residual, atol=f(k.rel_tol) * f(res_norm),
            restart=k.restart, maxiter=k.max_iters, precond=precond, group=g,
        )
        return u + cfg.newton.damping * sol.x, res_norm, sol.iters, sol.converged, sol.residual

    # ------------------------------------------------------------------
    def stokes_initial_guess(self, t: float | None = None) -> torch.Tensor:
        """Solve steady Stokes on this solver's DoF layout (the reference's
        designed initial-guess path, cpp:636-644; GMRES tol
        ``stokes_rel_tol`` with a block preconditioner, cpp:533-559).
        Returns the solution vector; ``self.stokes_result`` keeps the
        FGMRES result."""
        cfg, log = self.cfg, self.log
        t = self.time if t is None else t
        log.banner()
        log.print("Assembling the Stokes system")
        if self._win_layout is None:
            # flat path: a single-device flat StokesSolver shares the natural
            # dof numbering; a sharded run's ranks each solve it whole (the
            # flat design splits cells only and replicates vectors, so the
            # solution is the same vector on every rank)
            from .stokes import StokesSolver

            st_cfg = copy.deepcopy(cfg)
            st_cfg.krylov.matvec = "flat"  # a windowed layout would renumber
            st = StokesSolver(
                self.mesh, st_cfg, log=RunLog(verbose=False),
                forcing=self.forcing, inlet=self.inlet, device=self.device,
            )
            x = st.solve(t)
            self._log_stokes(st.result)
            return x.to(self._dtype)

        lay, g = self._win_layout, self._group
        wa = self._build_wa(
            dt=1.0, nu=cfg.nu, rho=cfg.rho, p_out=cfg.p_out, terms="stokes",
            pin_pdofs=self.dofs.boundary_scalar_pdofs(cfg.neumann_tags),
            kp_deflate=cfg.krylov.kp_deflate,
            kp_deflate_min_amp=cfg.krylov.kp_deflate_min_amp,
        )
        bc_rows = self._bc_rows
        has_bc = bc_rows.shape[0] > 0
        bc_vals = self._bc_values(t)
        A_t = wa.A_const  # the Stokes operator is u-independent
        nl = lay.nl
        ar = torch.arange(nl, device=A_t.device)
        Dv = A_t.new_zeros((lay.nli, lay.ncd))
        Dv[:nl] = A_t[ar, ar, :]
        diag0 = windowed_scatter(lay, Dv, g)  # K4
        bc_diag = diag0[bc_rows]
        rhs = wa.r_const.clone()
        rhs[bc_rows] = bc_diag * bc_vals

        def apply_op(v):
            y = windowed_matvec(lay, A_t, v, g)  # K1
            if has_bc:
                y[bc_rows] = bc_diag * v[bc_rows]
            return y

        # real inner solves (the reference's PreconditionBlockTriangular,
        # cpp:546-552): CC's fixed micro-sweeps on the pure-viscous A00 are
        # far too weak for the 1e-6 Stokes tolerance
        precond = self._make_windowed_preconditioner(
            lay, A_t, wa, bc_diag, diag0, bc_rows,
            kind="block_triangular"
            if cfg.krylov.preconditioner in ("identity", "cahouet_chabard") else None,
        )
        x0 = torch.zeros_like(rhs)
        x0[bc_rows] = bc_vals
        sol = fgmres(
            apply_op, rhs, x0=x0,
            atol=cfg.krylov.stokes_rel_tol * _norm(rhs, g),  # cpp:538
            restart=cfg.krylov.restart, maxiter=cfg.krylov.max_iters, precond=precond, group=g,
        )
        self._log_stokes(sol)
        return sol.x

    def _log_stokes(self, sol):
        """Keep the Stokes solve's FGMRES result in ``stokes_result`` and log
        its count; a solve that stops short of its tolerance (which the
        original does not log) adds a ``krylov_failure`` record."""
        self.stokes_result = sol
        self.log.print("Solving the Stokes system")
        self.log.gmres_iters(int(sol.iters), system="stokes")
        if not sol.converged:
            self.log.krylov_failure(int(sol.iters), float(sol.residual), system="stokes")

    # ------------------------------------------------------------------
    def solve_steady(
        self,
        *,
        tol: float = 1e-8,
        max_iters: int = 10,
        damping: float = 1.0,
        line_search: bool = True,
        initial_guess: str = "stokes",
        tangent_solver: str = "fgmres",
    ):
        """Steady Navier-Stokes: Newton on the steady residual (no mass
        term), stopping on the relative update ``alpha ||delta|| / n_dofs
        <= tol`` (the reference's legacy loop, cpp:811-833; legacy defaults
        tol 1e-8, 10 iterations), with optional damping and a backtracking
        line search on the residual norm.

        The tangent's A00 inner sweeps run FGMRES (the steady tangent is
        convection-dominated and nonsymmetric) and the Schur surrogate has
        mass_coef 0.  tangent_solver "fgmres" solves on the windowed kernels;
        "lu" assembles the flat tangent at dt = 1e30 and solves it exactly
        with scipy's SuperLU on the host (the verification path, meant for
        float64).  initial_guess "stokes" starts from
        ``stokes_initial_guess(self.time)``, "current" from
        ``self.solution``.  Dirichlet values are read at ``self.time``.

        Returns (n_iters, update_norm).  Requires the windowed operator."""
        if not self._is_setup:
            self.setup()
        cfg, log = self.cfg, self.log
        if self._win_layout is None:
            raise NotImplementedError(
                "solve_steady requires the windowed operator "
                "(cfg.krylov.matvec='windowed')"
            )
        if tangent_solver not in ("fgmres", "lu"):
            raise ValueError(f"unknown tangent_solver {tangent_solver!r}")
        if initial_guess not in ("stokes", "current"):
            raise ValueError(f"unknown initial_guess {initial_guess!r}")
        if tangent_solver == "lu" and self._dist is not None:
            raise NotImplementedError("tangent_solver='lu' is single-device")
        k = cfg.krylov
        lay, g = self._win_layout, self._group
        wa = self._build_wa(
            dt=1.0, nu=cfg.nu, rho=cfg.rho, p_out=cfg.p_out,
            terms="stokes",  # constant tangent part without the mass block
            pin_pdofs=self.dofs.boundary_scalar_pdofs(cfg.neumann_tags),
            coarse_agg=k.cc_coarse_agg,
            coarse_agg_v=k.cc_coarse_agg_v,
            pin_vdofs=self.dofs.boundary_scalar_vdofs(
                tuple(cfg.inlet_tags) + tuple(cfg.wall_tags)
            ),
            coarse_cond_cap=k.cc_coarse_cond_cap,
            kp_deflate=k.kp_deflate,
            kp_deflate_min_amp=k.kp_deflate_min_amp,
        )
        bc_rows = self._bc_rows
        has_bc = bc_rows.shape[0] > 0
        bc_vals = self._bc_values(self.time)
        form = dict(dt=1.0, nu=cfg.nu, rho=cfg.rho, convection_form=cfg.convection_form,
                    include_continuity_residual=cfg.include_continuity_residual,
                    include_time_term=False, group=g)
        f = np.float64 if self._dtype == torch.float64 else np.float32

        def fgmres_iteration(u):
            A_t, residual, diag0 = assemble_windowed(wa, lay, u, u, **form)
            bc_diag = diag0[bc_rows]
            residual[bc_rows] = bc_diag * (bc_vals - u[bc_rows])
            res_norm = _norm(residual, g)

            def apply_op(v):
                y = windowed_matvec(lay, A_t, v, g)
                if has_bc:
                    y[bc_rows] = bc_diag * v[bc_rows]
                return y

            precond = self._make_windowed_preconditioner(
                lay, A_t, wa, bc_diag, diag0, bc_rows, mass_coef=0.0, a00_solver="gmres",
            )
            sol = fgmres(
                apply_op, residual, atol=f(k.rel_tol) * f(res_norm),
                restart=k.restart, maxiter=k.max_iters, precond=precond, group=g,
            )
            return sol.x, bc_diag, res_norm, sol.iters, sol.converged, sol.residual

        _ALPHAS = (1.0, 0.5, 0.25, 0.125)

        def trial_norms(u, delta, bc_diag):
            # residual norms along the backtracking ladder: each trial
            # assembles the residual alone (no tangent, no diagonal)
            norms = []
            for a in _ALPHAS:
                ut = u + (a * damping) * delta
                _, r, _ = assemble_windowed(wa, lay, ut, ut, residual_only=True, **form)
                r[bc_rows] = bc_diag * (bc_vals - ut[bc_rows])
                norms.append(_norm(r, g))
            return np.asarray(norms)

        do_iter = fgmres_iteration
        if tangent_solver == "lu":
            do_iter = self._steady_lu_iteration(bc_rows, bc_vals)

        log.banner()
        if initial_guess == "stokes":
            u = self.stokes_initial_guess(self.time).to(self._dtype)
        else:  # "current": continuation from the solver's state
            u = self.solution
        n_scale = float(self.dofs.n_total)
        upd = tol + 1.0
        it = 0
        while it == 0 or (upd > tol and it < max_iters):  # cpp:820
            delta, bc_diag, res_norm, kiters, kconv, kres = do_iter(u)
            log.print("Assembling the system")
            log.gmres_iters(int(kiters))
            if not kconv:
                log.krylov_failure(int(kiters), float(kres))
                if k.on_failure == "raise":
                    raise RuntimeError(
                        f"steady tangent solve did not converge: residual "
                        f"{float(kres):.6e} after {int(kiters)} iterations"
                    )
            alpha = damping
            if line_search:
                norms = trial_norms(u, delta, bc_diag)
                r0 = float(res_norm)
                # largest step with sufficient decrease; fall back to the
                # best trial (classic backtracking on ||r||)
                ok = norms <= (1.0 - 1e-4 * np.asarray(_ALPHAS)) * r0
                pick = int(np.argmax(ok)) if ok.any() else int(np.argmin(norms))
                alpha = _ALPHAS[pick] * damping
            u = u + alpha * delta
            # the distributed layout is a permutation of the planar vector,
            # so one norm covers both
            upd = float(alpha) * _norm(delta, g) / n_scale
            it += 1
            log.print(f"Residual = {upd:.6f}")  # cpp:829 legacy format
            log.records.append({
                "event": "steady_newton", "iter": it, "update": upd,
                "res_norm": float(res_norm), "gmres_iters": int(kiters),
                "alpha": float(alpha),
            })
        if it >= max_iters and upd > tol:
            log.print("WARNING: Newton's method failed to converge\n")  # cpp:831
        self.solution = u
        self.solution_old = u.clone()
        return it, upd

    def _steady_lu_iteration(self, bc_rows, bc_vals):
        """One exact steady-Newton iteration via host sparse LU (SuperLU).

        The steady tangent is assembled on the flat path with u_old = u and
        dt = 1e30: the residual's time term vanishes identically and the
        Jacobian's mass perturbation is ~1e-30 relative.  Dirichlet rows are
        eliminated with the pre-constraint diagonal (apply_boundary_values
        semantics, cpp:349-377), in SPEC order: a boolean mask would re-sort
        the rows and put inlet values on wrong rows (the original measured
        Cd 0.30 instead of 5.56 that way).  The padding holes of a blocked
        numbering get unit diagonals (their rows and columns are zero, and
        their residual is zero, so their update stays zero).  Refused on
        more than one device (this port serves one)."""
        import scipy.sparse as sp
        import scipy.sparse.linalg as spla

        cfg, ctx, dofs = self.cfg, self.ctx, self.dofs
        n = dofs.n_total
        nl = ctx.cell_dofs.shape[1]
        cd = ctx.cell_dofs.cpu().numpy().astype(np.int64)
        ii = np.broadcast_to(cd[:, :, None], (cd.shape[0], nl, nl))
        jj = np.broadcast_to(cd[:, None, :], (cd.shape[0], nl, nl))
        br = bc_rows.cpu().numpy().astype(np.int64)  # spec order
        rows_mask = np.zeros(n, dtype=bool)
        rows_mask[br] = True
        bc_vals_np = bc_vals.cpu().numpy().astype(np.float64)
        real = np.ones(n, dtype=bool)
        if dofs.v_mask is not None:
            vm = np.asarray(dofs.v_mask, bool)
            for a in range(dofs.dim):
                real[a * dofs.n_vs : (a + 1) * dofs.n_vs] = vm
        if dofs.p_mask is not None:
            real[dofs.n_u :] = np.asarray(dofs.p_mask, bool)
        hole_diag = sp.diags((~real).astype(np.float64))

        def do_iter(u):
            cell_mat, _, residual = assemble_navier_stokes(
                ctx, u, u, dt=1e30, nu=cfg.nu, rho=cfg.rho, p_out=cfg.p_out,
                convection_form=cfg.convection_form,
                include_continuity_residual=cfg.include_continuity_residual,
                jacobian_mass_rho=cfg.jacobian_mass_rho,
            )
            cm = cell_mat.cpu().numpy().astype(np.float64)
            r = residual.cpu().numpy().astype(np.float64)
            A = sp.coo_matrix((cm.ravel(), (ii.ravel(), jj.ravel())), shape=(n, n)).tocsr()
            diag0 = np.asarray(A.diagonal())
            bc_diag = np.where(diag0[br] != 0.0, diag0[br], 1.0)  # spec order
            # row elimination, unsymmetric (apply_boundary_values semantics)
            un = u.cpu().numpy().astype(np.float64)
            keep = sp.diags((~rows_mask).astype(np.float64))
            A = keep @ A + sp.diags(
                np.where(rows_mask, np.where(diag0 != 0.0, diag0, 1.0), 0.0)
            ) + hole_diag
            r[br] = bc_diag * (bc_vals_np - un[br])
            r[~real] = 0.0
            res_norm = float(np.linalg.norm(r))
            delta = spla.splu(A.tocsc()).solve(r)
            as_t = lambda a: torch.as_tensor(a, device=self.device).to(self._dtype)  # noqa: E731
            return as_t(delta), as_t(bc_diag), res_norm, 1, True, 0.0

        return do_iter

    # ------------------------------------------------------------------
    def _layout_meta(self) -> dict:
        """Layout identifiers stored in checkpoints: a checkpoint written
        under one DoF numbering (flat vs windowed, another block size) must
        not restore into another with a coincidentally equal length."""
        lay = self._lay_global
        return {
            "n_total": int(self.dofs.n_total),
            "n_vs": int(self.dofs.n_vs),
            "n_ps": int(self.dofs.n_ps),
            "matvec": self._matvec,
            "blocks": None if lay is None else [lay.nb, lay.OWv, lay.OWp],
            "mesh_cells": int(self.mesh.n_cells),
        }

    def _planar_tensor(self, x: torch.Tensor) -> torch.Tensor:
        """A state vector in the planar layout, on its device: in a sharded
        run every rank's owned chunk gathered (a collective: every rank
        calls it); on one device the vector itself."""
        if self._dist is None:
            return x
        return wspmd.gather_planar(x, self._dist, self._group)

    def _planar(self, x) -> np.ndarray:
        """A state vector in the planar layout on the host (a collective in
        a sharded run, as ``_planar_tensor``)."""
        return self._planar_tensor(x).detach().cpu().numpy()

    def save_checkpoint(self, path, step: int | None = None):
        """Full restart state (solution, previous steps, time, step) in an
        HDF5 file (io/checkpoint.py; needs h5py).  In a sharded run every
        rank calls it (the state is gathered), rank 0 writes, and no rank
        returns before the file is written."""
        from ..io.checkpoint import save_checkpoint

        old2 = self.solution_old2
        out = save_checkpoint(
            path,
            solution=np.asarray(self._planar(self.solution), np.float64),
            solution_old=np.asarray(self._planar(self.solution_old), np.float64),
            solution_old2=(
                None if old2 is None else np.asarray(self._planar(old2), np.float64)
            ),
            time=self.time,
            step=step if step is not None else self._step,
            config={"solver": self.cfg.to_dict(), "layout": self._layout_meta()},
        )
        if self._group is not None:
            torch.distributed.barrier(group=self._group)
        return out

    def restore_checkpoint(self, path):
        """Restore what ``save_checkpoint`` wrote; a checkpoint of another
        DoF layout raises ValueError.  In a sharded run every rank reads the
        file and keeps its owned chunk."""
        from ..io.checkpoint import load_checkpoint

        if not self._is_setup:
            self.setup()
        d = load_checkpoint(path)
        meta = d.get("config", {}).get("layout")
        if meta is not None and meta != self._layout_meta():
            mine = self._layout_meta()
            diff = {k: (meta.get(k), mine.get(k)) for k in mine if meta.get(k) != mine.get(k)}
            raise ValueError(
                f"checkpoint layout mismatch (stored vs current): {diff} — "
                "restoring would silently permute the solution field"
            )
        if len(d["solution"]) != self.dofs.n_total:
            raise ValueError(
                f"checkpoint vector length {len(d['solution'])} != solver "
                f"n_total {self.dofs.n_total}"
            )

        def as_state(a):
            if self._dist is not None:
                a = wspmd.to_dist(a, self._dist)[self._rank * self._n_state :][: self._n_state]
            return torch.as_tensor(a, device=self.device).to(self._dtype)

        self.solution = as_state(d["solution"])
        self.solution_old = as_state(d["solution_old"])
        # BDF2 second history level: restored when present so a resumed run
        # continues second-order without a BDF1 bootstrap step
        old2 = d.get("solution_old2")
        self.solution_old2 = None if old2 is None else as_state(old2)
        self.time = d["time"]
        self._step = d["step"]
        return self

    # ------------------------------------------------------------------
    def solve_newton(self):
        """Newton loop with parity logging (cpp:590-627)."""
        cfg, log = self.cfg, self.log
        # residual time-term: BDF1 always; BDF2 once two history levels exist
        u_old_arg = self.solution_old
        dt_res = cfg.dt
        if cfg.time_scheme == "bdf2" and getattr(self, "solution_old2", None) is not None:
            u_old_arg = (4.0 * self.solution_old - self.solution_old2) / 3.0
            dt_res = cfg.dt / 1.5
        bc_vals = self._bc_values(self.time)
        n_iter, res_norm = 0, cfg.newton.tol + 1
        while n_iter < cfg.newton.max_iters and (
            res_norm > cfg.newton.tol or n_iter < cfg.newton.min_iters
        ):
            log.banner()
            log.print("Assembling the system")
            forced = n_iter < cfg.newton.min_iters
            with self.timers("newton_iteration"):
                self.solution, res_norm, gmres_iters, kconv, kres = self._newton_iteration(
                    self.solution, u_old_arg, bc_vals, dt_res, forced,
                )
            log.banner()
            log.newton_residual(n_iter, cfg.newton.max_iters, res_norm)
            if res_norm > cfg.newton.tol or forced:
                log.print("Solving system...")
                log.gmres_iters(int(gmres_iters))
                if not kconv:
                    log.krylov_failure(int(gmres_iters), float(kres))
                    if cfg.krylov.on_failure == "raise":
                        raise RuntimeError(
                            f"GMRES tangent solve did not converge: residual "
                            f"{float(kres):.6e} after {int(gmres_iters)} iterations "
                            f"(deal.II SolverControl::NoConvergence equivalent)"
                        )
                log.print("System solved!")
            if res_norm <= cfg.newton.tol:
                log.newton_converged()
            n_iter += 1
        return n_iter, res_norm

    # ------------------------------------------------------------------
    def solve(self, resume: bool = False):
        """Time loop (cpp:629-679).  resume=True continues from the current
        state (time, step, history: e.g. after ``restore_checkpoint``)
        instead of applying the initial condition."""
        if not self._is_setup:
            self.setup()
        cfg, log = self.cfg, self.log
        log.banner()
        if not resume:
            self.time = 0.0
            self._step = 0
            if cfg.initial_guess == "stokes":
                # the reference's designed path (cpp:636-644): start from Stokes
                self.solution = self.stokes_initial_guess(0.0).to(self._dtype)
            else:
                log.print("Applying the initial condition")
                self.solution = torch.zeros(
                    self._n_state, dtype=self._dtype, device=self.device
                )
            self._output(0, 0.0)
            log.rule()

        step = self._step
        while self.time < cfg.T - 0.5 * cfg.dt:
            self.time += cfg.dt
            step += 1
            self._step = step
            self.solution_old2 = self.solution_old if step > 1 else None
            self.solution_old = self.solution.clone()
            log.time_step(step, self.time)
            if self._forcing_time_dep:
                # implicit Euler: the residual lives at the new time level
                self._update_forcing(self.time)
            self.solve_newton()
            self._output(step, self.time)
            log.print()
        return self.solution

    def solve_scanned(
        self,
        *,
        functional=None,
        functional_args: str = "u",
        reaction_tags=None,
        chunk: int = 100,
        newton_iters: int = 3,
        resume: bool = False,
        progress=None,
        progress_takes_diagnostics: bool | None = None,
    ):
        """The time loop in chunks of ``chunk`` steps, each step a fixed
        number of Newton sweeps (JAX: one ``lax.scan`` a chunk; here a host
        loop).

        The Dirichlet schedule is computed on the host for the whole run.
        Each step runs ``newton_iters`` sweeps: forced while the sweep index
        is below ``newton.min_iters``, the tangent solve skipped once the
        residual is below ``newton.tol``.  BDF2 steps after the run's first
        use u_old_eff = (4u - u_old)/3 with dt/1.5.  After every chunk the
        solver's state (solution, solution_old, solution_old2, time, _step)
        is rebound, so a progress callback can ``save_checkpoint()``.

        functional: f(solution) -> tensor, after each step (with
        functional_args "u_uold_dt": f(solution, u_old_eff, dt_res), the
        history the Newton residual used).  reaction_tags: the boundary
        reaction on those tags each step (the unconstrained residual rows
        summed over their velocity dofs, per component; the windowed solver
        assembles the residual alone).  progress:
        progress(step, t, fvals_chunk) or, if it takes ``res``/``iters``
        (or ``progress_takes_diagnostics`` says so), progress(step, t,
        fvals_chunk, res=..., iters=...[, reaction=...]), once a chunk.

        Returns {"functional": [n_steps, ...] or None, "reaction": [n_steps,
        dim] or None, "residual": [n_steps] (the last sweep's entry
        residual), "gmres_iters": [n_steps]}, numpy arrays.  Static forcing
        only; no per-step output hooks.  In a sharded run the functional
        sees the gathered planar vectors (an all-gather a step, only with a
        functional); reaction_tags raise there, as in the original."""
        if not self._is_setup:
            self.setup()
        cfg, log = self.cfg, self.log
        if self._forcing_time_dep:
            raise NotImplementedError("solve_scanned needs static forcing")
        if reaction_tags is not None and self._dist is not None:
            raise NotImplementedError(
                "reaction_tags in a sharded run: evaluate the boundary reaction on "
                "checkpointed states instead")
        if not resume:
            self.time = 0.0
            self._step = 0
            if cfg.initial_guess == "stokes":
                self.solution = self.stokes_initial_guess(0.0).to(self._dtype)
            else:
                self.solution = torch.zeros(
                    self._n_state, dtype=self._dtype, device=self.device
                )
            self.solution_old = self.solution.clone()
            self.solution_old2 = None

        n_steps = int(round((cfg.T - self.time) / cfg.dt))
        t0 = self.time
        # the Dirichlet schedule of this rank's rows, made on the host once
        bc_sched = [self._bc_values(t0 + (k + 1) * cfg.dt) for k in range(n_steps)]
        bdf2 = cfg.time_scheme == "bdf2"
        K = int(newton_iters)
        planar = self._planar_tensor

        rx_idx = rx_kw = None
        if reaction_tags is not None:
            sdofs = self.dofs.boundary_scalar_vdofs(list(np.atleast_1d(reaction_tags)))
            rx_idx = torch.as_tensor(
                sdofs[None, :] + np.arange(self.dofs.dim)[:, None] * self.dofs.n_vs,
                dtype=torch.int64, device=self.device,
            )
            rx_kw = dict(
                nu=cfg.nu, rho=cfg.rho, convection_form=cfg.convection_form,
                include_continuity_residual=cfg.include_continuity_residual,
            )

        def step(u, uo, kstep, bc_vals):
            if bdf2 and kstep >= 1:  # step 0 of the run bootstraps with BDF1
                u_old_eff, dt_res = (4.0 * u - uo) / 3.0, cfg.dt / 1.5
            else:
                u_old_eff, dt_res = u, cfg.dt
            uu, res, iters = u, 0.0, 0
            for k in range(K):
                uu, res, it, _, _ = self._newton_iteration(
                    uu, u_old_eff, bc_vals, dt_res,
                    k < cfg.newton.min_iters,  # anti-freeze forced sweeps
                )
                iters += int(it)
            if functional is None:
                f = torch.zeros(1, dtype=self._dtype, device=self.device)
            elif functional_args == "u_uold_dt":
                # the history the Newton residual used: under BDF2,
                # (3u - 4uo + uo2)/(2 dt) == (u - u_old_eff)/dt_res
                f = functional(planar(uu), planar(u_old_eff), dt_res)
            else:
                f = functional(planar(uu))
            if rx_idx is not None:
                if self._win_layout is not None:  # the residual alone, no tangent
                    _, r_unc, _ = assemble_windowed(
                        self._wassembly, self._win_layout, uu, u_old_eff, dt=dt_res,
                        residual_only=True, **rx_kw,
                    )
                else:
                    _, _, r_unc = assemble_navier_stokes(
                        self.ctx, uu, u_old_eff, dt=dt_res, p_out=cfg.p_out,
                        jacobian_mass_rho=cfg.jacobian_mass_rho, **rx_kw,
                    )
                # residual = -R_weak: the force BY the fluid ON the boundary
                # is +the sum of its reaction rows
                fr = torch.stack([r_unc[rx_idx[d]].sum() for d in range(self.dofs.dim)])
            else:
                fr = torch.zeros((), dtype=self._dtype, device=self.device)
            return uu, (f, fr, res, iters)

        u, uo = self.solution, self.solution_old
        uo2 = self.solution_old2 if self.solution_old2 is not None else uo
        kstep = self._step
        fs, rxs, rs, its = [], [], [], []
        log.banner()
        log.print(
            f"Scanned time loop: {n_steps} steps x {K} Newton its, "
            f"chunk {chunk} ({cfg.time_scheme})"
        )
        # the progress callback's arity, decided once: catching TypeError
        # around the call would re-invoke (and repeat the side effects of) a
        # callback that raised TypeError itself
        prog_legacy = False
        if progress is not None and progress_takes_diagnostics is not None:
            prog_legacy = not progress_takes_diagnostics
        elif progress is not None:
            import inspect

            try:
                sig = inspect.signature(progress)
                prog_legacy = not any(
                    p.name in ("res", "iters") or p.kind == p.VAR_KEYWORD
                    for p in sig.parameters.values()
                )
            except (TypeError, ValueError):
                prog_legacy = False
        done = 0
        while done < n_steps:
            m = min(chunk, n_steps - done)
            out = []
            for i in range(m):
                u_new, ys = step(u, uo, kstep, bc_sched[done + i])
                u, uo, uo2, kstep = u_new, u, uo, kstep + 1
                out.append(ys)
            done += m
            self.time = t0 + done * cfg.dt
            self._step = self._step + m
            # the solver's state at every chunk edge, so that a progress
            # callback can save_checkpoint() mid-run
            self.solution, self.solution_old, self.solution_old2 = u, uo, uo2
            fs.append(torch.stack([y[0] for y in out]).cpu().numpy())
            rxs.append(torch.stack([y[1] for y in out]).cpu().numpy())
            rs.append(np.asarray([y[2] for y in out]))
            its.append(np.asarray([y[3] for y in out]))
            log.print(
                f"  step {self._step:6d}  t = {self.time:.4f}  "
                f"||r|| = {float(rs[-1][-1]):.3e}  gmres/step ~ {float(np.mean(its[-1])):.0f}"
            )
            if progress is not None:
                if prog_legacy:  # legacy 3-arg callback
                    progress(self._step, self.time, fs[-1])
                else:
                    kwargs = dict(res=rs[-1], iters=its[-1])
                    if reaction_tags is not None:
                        kwargs["reaction"] = rxs[-1]
                    progress(self._step, self.time, fs[-1], **kwargs)
        self.solution, self.solution_old = u, uo
        self.solution_old2 = uo2
        return {
            "functional": np.concatenate(fs) if functional is not None else None,
            "reaction": np.concatenate(rxs) if reaction_tags is not None else None,
            "residual": np.concatenate(rs) if rs else np.zeros(0),
            "gmres_iters": np.concatenate(its) if its else np.zeros(0, np.int64),
        }

    def _update_forcing(self, t: float):
        """Re-evaluate a time-dependent forcing f(x, t) at time t: ctx.f_q
        for the flat path and, on the windowed path, wa.r_const (the
        forcing's residual, recomputed on the host by compute_r_const).
        The reference's equivalent is ForcingTerm::set_time (never
        exercised there: its forcing is constant, hpp:414-439).  In a
        sharded run the rank keeps its chunk of the new r_const (windowed)
        or of the Morton-ordered padded cells' f_q (flat)."""
        if self._f_qpts is None:
            deg = self.cfg.quadrature_degree or (
                2 * (self.dofs.element.velocity.degree + 1) - 1
            )
            geo = cell_geometry(self.mesh, gauss_simplex(self.mesh.dim, deg))
            self._f_qpts = geo.qpts  # [nc, nq, dim] natural cell order
        nc, nq, dim = self._f_qpts.shape
        f_q = np.asarray(self.forcing(self._f_qpts.reshape(-1, dim), t)).reshape(nc, nq, dim)
        if self._cell_order is not None:
            f_q = spmd.shard_rows(f_q, self.n_devices, self._rank, self._cell_order)
        self.ctx = dataclasses.replace(
            self.ctx, f_q=torch.as_tensor(f_q, device=self.ctx.f_q.device).to(self._dtype)
        )
        if self._wassembly is not None:
            r = compute_r_const(self.ctx, self.cfg.p_out)
            if self._dist is not None:
                r = wspmd.to_dist(r, self._dist)[self._rank * self._n_state :][: self._n_state]
            self._wassembly = dataclasses.replace(
                self._wassembly,
                r_const=torch.as_tensor(r, device=self.device).to(self._dtype),
            )

    def _output(self, step: int, t: float):
        """Call the output hooks with the planar state (in a sharded run
        gathered: every rank must have the same hooks)."""
        if not self.output_hooks:
            return
        sol = self._planar_tensor(self.solution)
        for hook in self.output_hooks:
            hook(step, t, sol)

    # ------------------------------------------------------------------
    # convenience views
    def velocity(self, solution=None, real_only: bool = False) -> np.ndarray:
        """[n_vs, dim] nodal velocity (P2 scalar nodes); real_only drops the
        padding hole dofs of the blocked renumbering.  In a sharded run a
        collective: the state is gathered."""
        s = self._planar(self.solution if solution is None else solution)
        v = s[: self.dofs.n_u].reshape(self.dofs.dim, self.dofs.n_vs).T
        if real_only and self.dofs.v_mask is not None:
            v = v[self.dofs.v_mask]
        return v

    def velocity_coords(self, real_only: bool = False) -> np.ndarray:
        c = self.dofs.v_coords
        if real_only and self.dofs.v_mask is not None:
            c = c[self.dofs.v_mask]
        return c

    def pressure(self, solution=None, real_only: bool = False) -> np.ndarray:
        s = self._planar(self.solution if solution is None else solution)
        p = s[self.dofs.n_u :]
        if real_only and self.dofs.p_mask is not None:
            p = p[self.dofs.p_mask]
        return p
