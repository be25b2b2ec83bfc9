"""Batched Navier-Stokes / Stokes assembly as tensor contractions.

Port of ``navier_stokes_tpu/fem/assembly.py``: ``FEMContext`` and
``build_context`` (per-mesh geometry, tabulations and the transpose gather
maps of ops/scatter.py), and the flat ``assemble_navier_stokes`` and
``assemble_stokes``, every cell at once in one einsum chain.  The windowed
assembly (fem/windowed_assembly.py) builds its constant terms from the same
context.  The einsums are dimension-generic, as the original's are.

The reference's quirks keep their flags (see the original's docstring):
``convection_form`` ("reference": the residual's convection is u^T grad u,
the Jacobian linearizes (u . grad) u), ``include_continuity_residual`` and
``jacobian_mass_rho``.  The global residual is reduced through the gather
map ``scatter_full`` and the outlet traction through its own gather map
(``FEMContext._neu_gather``): a fixed summation order on every device, where the
original's ``segment_sum`` is an ``index_add_`` whose float32 order on the
card changes from run to run.  A context that holds one rank's cells (the
flat multi-device design, parallel/spmd.py) carries its process group, and
the residual and the Stokes rhs are all-reduced over it, as the original
psums over ``axis_name``.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import cached_property
from typing import Callable

import numpy as np
import torch

from ..la.operators import all_reduce
from .dofs import TaylorHoodDofs
from .geometry import cell_geometry, facet_geometry
from .quadrature import gauss_simplex

__all__ = ["FEMContext", "build_context", "assemble_navier_stokes", "assemble_stokes"]


@dataclass(frozen=True)
class FEMContext:
    """Static per-mesh arrays (natural or blocked dof numbering)."""

    # tabulations
    N_v: torch.Tensor  # [nb_v, nq]
    G_v: torch.Tensor  # [nb_v, nq, dim] reference gradients
    N_p: torch.Tensor  # [nb_p, nq]
    # geometry, cell-indexed
    invJT: torch.Tensor  # [nc, dim, dim]
    jxw: torch.Tensor  # [nc, nq]
    # connectivity, cell-indexed
    cell_vdofs: torch.Tensor  # [nc, nb_v] scalar velocity dof ids
    cell_dofs: torch.Tensor  # [nc, nl] full-system dof ids
    # forcing values at quadrature points
    f_q: torch.Tensor  # [nc, nq, dim]
    # Neumann (outlet do-nothing) facet group
    neu_cell_vdofs: torch.Tensor  # [nf, nb_v] scalar velocity dofs of owner cell
    neu_N_v: torch.Tensor  # [nf, nb_v, nqf] velocity basis at face quad pts
    neu_normal: torch.Tensor  # [nf, dim]
    neu_jxw: torch.Tensor  # [nf, nqf]
    # transpose gather maps (ops/scatter.py): [n_total, K] / [n_u, Kv] /
    # [n_p, Kp] positions into the flattened [nc, nl] / [nc, dim*nb_v] /
    # [nc, nb_p] cell-value arrays
    scatter_full: torch.Tensor
    scatter_vel: torch.Tensor
    scatter_p: torch.Tensor
    dim: int
    n_vs: int
    n_u: int
    n_total: int
    # the process group of the flat multi-device design (parallel/spmd.py):
    # the context holds one rank's cells, and the residual or rhs it
    # assembles is all-reduced over the group (None: one device)
    group: object = None

    @property
    def nb_v(self) -> int:
        return self.N_v.shape[0]

    @property
    def nb_p(self) -> int:
        return self.N_p.shape[0]

    @property
    def n_cells(self) -> int:
        return self.cell_dofs.shape[0]

    @cached_property
    def _neu_gather(self) -> tuple[torch.Tensor, torch.Tensor]:
        """The outlet traction's rows [m] (its unique dofs) and the
        transpose gather map [m, Kf] from each row to its positions in the
        flattened [nf, dim, nb_v] face values (ops/scatter.py), made on the
        host at first use."""
        from ..ops.scatter import build_gather_map

        gdofs = (self.neu_cell_vdofs.cpu().numpy().astype(np.int64)[:, None, :]
                 + np.arange(self.dim)[None, :, None] * self.n_vs).ravel()
        rows, local = np.unique(gdofs, return_inverse=True)
        dev = self.neu_cell_vdofs.device
        return (torch.as_tensor(rows, device=dev),
                torch.as_tensor(build_gather_map(local, len(rows)), device=dev))


def build_context(
    dofs: TaylorHoodDofs,
    neumann_tags=(),
    forcing: Callable[[np.ndarray], np.ndarray] | None = None,
    quadrature_degree: int | None = None,
    dtype=None,
    device="cpu",
) -> FEMContext:
    """Precompute geometry/tabulations on the host and place them on
    ``device``.  dtype defaults to torch's default float type.

    quadrature_degree defaults to the reference's ``QGaussSimplex<dim>(fe->
    degree + 1)``: with P2 velocity, a rule exact to degree 5.
    """
    mesh, elem = dofs.mesh, dofs.element
    dim = mesh.dim
    dtype = dtype or torch.get_default_dtype()
    deg = quadrature_degree or (2 * (elem.velocity.degree + 1) - 1)
    quad = gauss_simplex(dim, deg)
    geo = cell_geometry(mesh, quad)

    N_v, G_v = elem.velocity.tabulate(quad.points)
    N_p, _ = elem.pressure.tabulate(quad.points)

    if forcing is None:
        f_q = np.zeros((mesh.n_cells, quad.n_points, dim))
    else:
        f_q = np.asarray(forcing(geo.qpts.reshape(-1, dim))).reshape(
            mesh.n_cells, quad.n_points, dim
        )

    # Neumann facet group (possibly empty: 0-size arrays)
    if len(neumann_tags):
        fids = np.nonzero(np.isin(mesh.boundary_tags, np.atleast_1d(neumann_tags)))[0]
    else:
        fids = np.zeros(0, dtype=np.int64)
    fgeo = facet_geometry(mesh, fids, deg) if len(fids) else None
    if fgeo is not None:
        nf, nqf = fgeo.jxw.shape
        vals, _ = elem.velocity.tabulate(fgeo.ref_qpts.reshape(-1, dim))
        neu_N_v = vals.reshape(elem.n_v, nf, nqf).transpose(1, 0, 2)
        neu_cell_vdofs = dofs.cell_vdofs[fgeo.cell]
        neu_normal, neu_jxw = fgeo.normal, fgeo.jxw
    else:
        nqf = 1
        neu_N_v = np.zeros((0, elem.n_v, nqf))
        neu_cell_vdofs = np.zeros((0, elem.n_v), dtype=np.int32)
        neu_normal = np.zeros((0, dim))
        neu_jxw = np.zeros((0, nqf))

    from ..ops.scatter import build_gather_map

    nvl = dim * elem.n_v
    scatter_full = build_gather_map(dofs.cell_dofs, dofs.n_total)
    scatter_vel = build_gather_map(dofs.cell_dofs[:, :nvl], dofs.n_u)
    scatter_p = build_gather_map(dofs.cell_pdofs, dofs.n_p)

    def as_f(a):
        return torch.as_tensor(np.asarray(a, np.float64), device=device).to(dtype)

    def as_i(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.int32, device=device)

    return FEMContext(
        N_v=as_f(N_v),
        G_v=as_f(G_v),
        N_p=as_f(N_p),
        invJT=as_f(geo.invJT),
        jxw=as_f(geo.jxw),
        cell_vdofs=as_i(dofs.cell_vdofs),
        cell_dofs=as_i(dofs.cell_dofs),
        f_q=as_f(f_q),
        neu_cell_vdofs=as_i(neu_cell_vdofs),
        neu_N_v=as_f(neu_N_v),
        neu_normal=as_f(neu_normal),
        neu_jxw=as_f(neu_jxw),
        scatter_full=as_i(scatter_full),
        scatter_vel=as_i(scatter_vel),
        scatter_p=as_i(scatter_p),
        dim=dim,
        n_vs=dofs.n_vs,
        n_u=dofs.n_u,
        n_total=dofs.n_total,
    )


def _neumann_residual(ctx: FEMContext, p_out: float) -> torch.Tensor:
    """Scattered outlet traction residual contribution r_i += -p_out n.phi_i
    (the reference's outlet Neumann term, cpp:314-336), summed through the
    gather map of ``FEMContext._neu_gather`` in a fixed order."""
    from ..ops.scatter import gather_scatter

    face_r = -p_out * torch.einsum(
        "fd,fbq,fq->fdb", ctx.neu_normal, ctx.neu_N_v, ctx.neu_jxw
    )  # [nf, dim, nb_v]
    rows, gmap = ctx._neu_gather
    r = face_r.new_zeros(ctx.n_total)
    r[rows] = gather_scatter(face_r.reshape(-1), gmap)
    return r


# ---------------------------------------------------------------------------
# field evaluation helpers
# ---------------------------------------------------------------------------


def _gather_velocity(ctx: FEMContext, x: torch.Tensor) -> torch.Tensor:
    """[nc, dim, nb_v] local velocity coefficients from the planar layout."""
    comp = torch.arange(ctx.dim, dtype=torch.int32, device=x.device)[None, :, None] * ctx.n_vs
    return x[ctx.cell_vdofs[:, None, :] + comp]


def _gather_pressure(ctx: FEMContext, x: torch.Tensor) -> torch.Tensor:
    return x[ctx.cell_dofs[:, -ctx.nb_p :]]  # [nc, nb_p]


def _phys_grads(ctx: FEMContext) -> torch.Tensor:
    """Physical velocity-basis gradients Gp [nc, nb_v, nq, dim]."""
    return torch.einsum("cda,bqa->cbqd", ctx.invJT, ctx.G_v)


def _cell_matrix(blocks_vv, D: torch.Tensor, nb_p: int) -> torch.Tensor:
    """[nc, nl, nl] from the velocity blocks ``blocks_vv[a][b]`` [nc, nb_v,
    nb_v] and the divergence coupling D [nc, dim, nb_v, nb_p]: rows
    (velocity a) = [A_a0 .. A_a(dim-1), -D_a], pressure row = [-D_0^T ..
    -D_(dim-1)^T, 0]."""
    dim = len(blocks_vv)
    rows = [torch.cat(list(blocks_vv[a]) + [-D[:, a]], dim=2) for a in range(dim)]
    nc = D.shape[0]
    p_row = torch.cat(
        [-D[:, a].transpose(1, 2) for a in range(dim)] + [D.new_zeros((nc, nb_p, nb_p))],
        dim=2,
    )
    return torch.cat(rows + [p_row], dim=1)


# ---------------------------------------------------------------------------
# Newton tangent system (cpp:178-378)
# ---------------------------------------------------------------------------


def assemble_navier_stokes(
    ctx: FEMContext,
    u: torch.Tensor,
    u_old: torch.Tensor,
    *,
    dt: float,
    nu: float,
    rho: float,
    p_out: float,
    convection_form: str = "reference",
    include_continuity_residual: bool = False,
    jacobian_mass_rho: bool = False,
):
    """One batched Newton-tangent assembly.

    Returns (cell_mat [nc, nl, nl], cell_pmass [nc, nb_p, nb_p],
    residual [n_total]).  Dirichlet rows are NOT yet applied.
    """
    ein = torch.einsum
    dim, nb_v, nb_p = ctx.dim, ctx.nb_v, ctx.nb_p
    W = ctx.jxw  # [nc, nq]
    Nv, Np = ctx.N_v, ctx.N_p
    Gp = _phys_grads(ctx)  # [nc, b, q, d]

    uc = _gather_velocity(ctx, u)  # [nc, dim, nb_v]
    uoc = _gather_velocity(ctx, u_old)
    pc = _gather_pressure(ctx, u)

    u_q = ein("cdb,bq->cqd", uc, Nv)  # [nc, nq, dim]
    uo_q = ein("cdb,bq->cqd", uoc, Nv)
    # grad u[c,q,d,a] = d u_d / d x_a
    gu_q = ein("cdb,cbqa->cqda", uc, Gp)
    p_q = ein("cb,bq->cq", pc, Np)

    NvW = ein("iq,cq->ciq", Nv, W)  # test functions pre-weighted
    M = ein("ciq,jq->cij", NvW, Nv)
    K = ein("ciqa,cjqa,cq->cij", Gp, Gp, W)
    # conv1[c,a,b,i,j] = grad u_ab N_i N_j W ; conv2[c,i,j] = (u . grad N_j) N_i W
    C1 = ein("cqab,ciq,jq->cabij", gu_q, NvW, Nv)
    adv = ein("cqd,cjqd->cqj", u_q, Gp)
    C2 = ein("cqj,ciq->cij", adv, NvW)
    # D[c,a,i,jp] = dN_i/dx_a P_j W   (divergence coupling)
    D = ein("ciqa,jq,cq->caij", Gp, Np, W)
    Mp = ein("iq,jq,cq->cij", Np, Np, W) / nu

    mass_coef = (rho if jacobian_mass_rho else 1.0) / dt
    Avv_diag = mass_coef * M + (nu * rho) * K + rho * C2  # same for each comp
    blocks = [
        [rho * C1[:, a, b] + (Avv_diag if a == b else 0.0) for b in range(dim)]
        for a in range(dim)
    ]
    cell_mat = _cell_matrix(blocks, D, nb_p)

    # ---- residual (cpp:287-311) ----
    if convection_form == "reference":
        conv = ein("cqd,cqda->cqa", u_q, gu_q)  # u^T grad u
    elif convection_form == "standard":
        conv = ein("cqa,cqda->cqd", u_q, gu_q)  # (u . grad) u
    else:
        raise ValueError(convection_form)

    # momentum rows: [nc, dim(a), nb_v(i)]
    r_mom = (
        -ein("cqa,ciq->cai", rho / dt * (u_q - uo_q), NvW)
        - (nu * rho) * ein("cqab,ciqb,cq->cai", gu_q, Gp, W)
        - rho * ein("cqa,ciq->cai", conv, NvW)
        + ein("cq,ciqa->cai", p_q * W, Gp)
        + ein("cqa,ciq->cai", ctx.f_q, NvW)
    )
    nc = W.shape[0]
    if include_continuity_residual:
        div_u = ein("cqdd->cq", gu_q)
        r_p = ein("cq,iq,cq->ci", div_u, Np, W)
    else:
        r_p = W.new_zeros((nc, nb_p))

    from ..ops.scatter import gather_scatter

    cell_res = torch.cat([r_mom.reshape(nc, dim * nb_v), r_p], dim=1)
    residual = gather_scatter(cell_res.reshape(-1), ctx.scatter_full)
    return cell_mat, Mp, all_reduce(residual + _neumann_residual(ctx, p_out), ctx.group)


# ---------------------------------------------------------------------------
# Stokes system (cpp:380-531)
# ---------------------------------------------------------------------------


def assemble_stokes(ctx: FEMContext, *, nu: float, rho: float, p_out: float):
    """Batched Stokes assembly: (cell_mat, cell_pmass, rhs [n_total])."""
    ein = torch.einsum
    dim, nb_v, nb_p = ctx.dim, ctx.nb_v, ctx.nb_p
    W = ctx.jxw
    Nv, Np = ctx.N_v, ctx.N_p
    Gp = _phys_grads(ctx)

    NvW = ein("iq,cq->ciq", Nv, W)
    K = ein("ciqa,cjqa,cq->cij", Gp, Gp, W)
    D = ein("ciqa,jq,cq->caij", Gp, Np, W)
    Mp = ein("iq,jq,cq->cij", Np, Np, W) / nu

    nc = W.shape[0]
    zero = W.new_zeros((nc, nb_v, nb_v))
    blocks = [[(nu * rho) * K if a == b else zero for b in range(dim)] for a in range(dim)]
    cell_mat = _cell_matrix(blocks, D, nb_p)

    from ..ops.scatter import gather_scatter

    r_mom = ein("cqa,ciq->cai", ctx.f_q, NvW)
    cell_rhs = torch.cat([r_mom.reshape(nc, dim * nb_v), W.new_zeros((nc, nb_p))], dim=1)
    rhs = gather_scatter(cell_rhs.reshape(-1), ctx.scatter_full)
    return cell_mat, Mp, all_reduce(rhs + _neumann_residual(ctx, p_out), ctx.group)
