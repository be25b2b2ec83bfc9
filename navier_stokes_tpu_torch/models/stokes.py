"""Steady Stokes solver — the reference's initial-guess path made first-class.

Port of ``navier_stokes_tpu/models/stokes.py``.  The
reference's Stokes pipeline (``assemble_stokes_system`` cpp:380-531,
``solve_stokes_system`` cpp:533-559: GMRES tol 1e-6 with the
block-triangular preconditioner) runs here flat (fem/assembly.py on the
element operators of la/operators.py) or, with ``krylov.matvec="windowed"``,
through ``NavierStokesSolver.stokes_initial_guess`` on the windowed kernels.

Default boundary ids follow the reference's Stokes path (mesh-square tag set):
0 = inlet Dirichlet, 1 = outlet Neumann, 2/3 = walls (cpp:472,511,518-526).

``n_devices`` > 1 runs the windowed path sharded over the ranks of the
joined process group, as NavierStokesSolver does; ``solution`` is then the
rank's owned chunk, and ``velocity()`` / ``pressure()`` gather the planar
state (every rank calls them).  The flat path, asked for or where no
windowed layout fits at that rank count, solves on each rank alone, the
whole system on its device, as the original does (it ignores the count
there): every rank holds the same solution.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import SolverConfig
from ..fem.assembly import assemble_stokes, build_context
from ..fem.bcs import DirichletBC, build_dirichlet
from ..fem.dofs import make_dofs
from ..fem.functions import InletVelocity, ZeroForcing
from ..fem.geometry import cell_geometry
from ..fem.quadrature import gauss_simplex
from ..la import operators as ops
from ..la.gmres import fgmres
from ..la.preconditioners import block_diagonal, block_triangular, identity
from ..mesh.mesh import Mesh
from ..mesh.msh_io import read_msh
from ..parallel.bootstrap import local_device
from ..utils.logging import RunLog

__all__ = ["StokesSolver"]


class StokesSolver:
    def __init__(
        self,
        mesh: Mesh | str,
        config: SolverConfig | None = None,
        log: RunLog | None = None,
        forcing=None,
        inlet=None,
        n_devices: int | None = None,
        device="cuda",
    ):
        from .navier_stokes import _check_devices

        if config is None:
            # reference Stokes-path defaults: mesh-square tags, tol 1e-6,
            # block-triangular preconditioner (cpp:472,511,538,546)
            config = SolverConfig(inlet_tags=(0,), neumann_tags=(1,), wall_tags=(2, 3))
            config.krylov.preconditioner = "block_triangular"
        self.mesh = read_msh(mesh) if isinstance(mesh, str) else mesh
        _check_devices(n_devices)
        self.n_devices = n_devices
        self.cfg = cfg = config
        self.log = log or RunLog()
        self.forcing = forcing or ZeroForcing()
        self.inlet = inlet or InletVelocity(
            u_m=cfg.inlet.u_m, H=cfg.inlet.H, freeze_time=cfg.inlet.freeze_time
        )
        self.device = local_device(device) if (n_devices or 1) > 1 else torch.device(device)
        self._is_setup = False

    def setup(self):
        from .navier_stokes import NavierStokesSolver, _resolve_dtype, _takes_time

        cfg = self.cfg
        self._ns = None
        if cfg.krylov.matvec == "windowed":
            # windowed Stokes rides the NavierStokesSolver's machinery:
            # blocked renumbering, windowed Stokes operator
            ns = NavierStokesSolver(
                self.mesh, cfg, log=RunLog(verbose=False), forcing=self.forcing,
                inlet=self.inlet, n_devices=self.n_devices, device=self.device,
            )
            ns.setup()
            if ns._win_layout is not None:
                self._ns = ns
                self.dofs, self._dtype, self.dirichlet = ns.dofs, ns._dtype, ns.dirichlet
                self._is_setup = True
                return self
            # layout infeasible: the flat path below
        self.dofs = make_dofs(self.mesh, cfg.degree_velocity, cfg.degree_pressure)
        self._dtype = _resolve_dtype(cfg.dtype)
        self._forcing_time_dep = _takes_time(self.forcing)
        self._forcing_t = 0.0
        self.ctx = build_context(
            self.dofs, neumann_tags=cfg.neumann_tags,
            forcing=(lambda pts: self.forcing(pts, 0.0))
            if self._forcing_time_dep
            else self.forcing,
            quadrature_degree=cfg.quadrature_degree, dtype=self._dtype, device=self.device,
        )
        specs = [
            DirichletBC(tags=tuple(cfg.inlet_tags), value=self.inlet),
            DirichletBC(tags=tuple(cfg.wall_tags)),
        ]
        self.dirichlet = build_dirichlet(self.dofs, specs)
        self._bc_rows = torch.as_tensor(
            np.asarray(self.dirichlet.rows, np.int64), device=self.device
        )
        self._is_setup = True
        return self

    def _refresh_forcing(self, t: float):
        """Re-evaluate a time-dependent forcing f(x, t) at t and swap in
        ctx.f_q (the flat path; the windowed one keeps the forcing of its
        solver's setup, at t = 0, as the original does)."""
        if not self._forcing_time_dep or t == self._forcing_t:
            return
        deg = self.cfg.quadrature_degree or (
            2 * (self.dofs.element.velocity.degree + 1) - 1
        )
        geo = cell_geometry(self.mesh, gauss_simplex(self.mesh.dim, deg))
        nc, nq, dim = geo.qpts.shape
        f_q = np.asarray(self.forcing(geo.qpts.reshape(-1, dim), t)).reshape(nc, nq, dim)
        self.ctx = dataclasses.replace(
            self.ctx, f_q=torch.as_tensor(f_q, device=self.device).to(self._dtype)
        )
        self._forcing_t = t

    def _solve_flat(self, bc_vals: torch.Tensor):
        cfg, ctx = self.cfg, self.ctx
        n = self.dofs.n_total
        bc_rows = self._bc_rows
        dim, nb_v = ctx.dim, ctx.nb_v
        nvl = dim * nb_v
        cell_mat, cell_pmass, rhs = assemble_stokes(ctx, nu=cfg.nu, rho=cfg.rho, p_out=cfg.p_out)
        diag0 = ops.raw_diagonal(cell_mat, ctx.cell_dofs, n, ctx.scatter_full)
        bc_diag = diag0[bc_rows]
        rhs[bc_rows] = bc_diag * bc_vals
        op = ops.ElementOperator(
            cell_mat=cell_mat, cell_dofs=ctx.cell_dofs, bc_rows=bc_rows, bc_diag=bc_diag,
            scatter_idx=ctx.scatter_full, n=n,
        )
        kind = cfg.krylov.preconditioner
        if kind == "identity":
            precond = identity()
        else:
            A00 = ops.velocity_block(
                op, dim, nb_v, self.dofs.n_u,
                bc_mask=np.asarray(self.dirichlet.rows) < self.dofs.n_u,
                scatter_idx=ctx.scatter_vel,
            )
            cell_pdofs = torch.as_tensor(self.dofs.cell_pdofs, dtype=torch.int32,
                                         device=self.device)
            Mp = ops.pressure_mass_block(cell_pmass, cell_pdofs, self.dofs.n_p,
                                         scatter_idx=ctx.scatter_p)
            if kind == "block_diagonal":
                precond = block_diagonal(A00, Mp, inner_tol=cfg.krylov.inner_tol)
            else:
                precond = block_triangular(
                    A00, Mp, cell_mat[:, nvl:, :nvl], ctx.cell_dofs[:, :nvl], cell_pdofs,
                    inner_tol=cfg.krylov.inner_tol, inner_maxiter=cfg.krylov.inner_max_iters,
                    B_scatter_idx=ctx.scatter_p,
                )
        # x0 satisfying the BCs so constrained rows are solved exactly
        x0 = torch.zeros(n, dtype=rhs.dtype, device=self.device)
        x0[bc_rows] = bc_vals
        return fgmres(
            lambda v: ops.matvec(op, v), rhs, x0=x0,
            atol=cfg.krylov.stokes_rel_tol * float(torch.linalg.vector_norm(rhs)),  # cpp:538
            restart=cfg.krylov.restart, maxiter=cfg.krylov.max_iters, precond=precond,
        )

    def solve(self, t: float = 0.0) -> torch.Tensor:
        """Assemble + solve (cpp:533-559); returns the solution vector.
        ``self.result`` keeps the FGMRES result (iterations, residual,
        convergence)."""
        if not self._is_setup:
            self.setup()
        if self._ns is not None:
            self.solution = self._ns.stokes_initial_guess(t).to(self._dtype)
            self.result = self._ns.stokes_result
        else:
            self.log.banner()
            self.log.print("Assembling the Stokes system")
            self._refresh_forcing(t)
            bc_vals = torch.as_tensor(
                np.asarray(self.dirichlet.values(t)), device=self.device
            ).to(self._dtype)
            self.result = self._solve_flat(bc_vals)
            self.log.print("Solving the Stokes system")
            self.solution = self.result.x
        self.log.gmres_iters(int(self.result.iters), system="stokes")
        if not self.result.converged:  # not logged by the original
            self.log.krylov_failure(int(self.result.iters), float(self.result.residual),
                                    system="stokes")
        return self.solution

    def _planar(self) -> np.ndarray:
        if self._ns is not None:
            return self._ns._planar(self.solution)
        return self.solution.detach().cpu().numpy()

    def velocity(self, real_only: bool = False) -> np.ndarray:
        s = self._planar()
        v = s[: self.dofs.n_u].reshape(self.dofs.dim, self.dofs.n_vs).T
        if real_only and self.dofs.v_mask is not None:
            v = v[self.dofs.v_mask]
        return v

    def pressure(self, real_only: bool = False) -> np.ndarray:
        p = self._planar()[self.dofs.n_u :]
        if real_only and self.dofs.p_mask is not None:
            p = p[self.dofs.p_mask]
        return p
