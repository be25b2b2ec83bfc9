"""Matrix-free linear operators built from element matrices (the flat path).

Port of ``navier_stokes_tpu/la/operators.py``.  The global
operator stays in unassembled element form

    y = sum_cells  P_c^T  A_c  P_c x      (gather -> batched matvec -> reduce)

and constrained (Dirichlet) rows are replaced by ``diag * x``, the
reference's ``apply_boundary_values(..., false)`` row elimination.  The
reduction goes through a transpose gather map (ops/scatter.py): the
context's when one is given, else one built from ``cell_dofs`` on the host
for the call.  Either way each row sums its contributions in a fixed order
on every device (``index_add_`` on the card would not).

Block views are static slices of the element matrices: the local dof
layout is component-planar, so the velocity block is
``cell_mat[:, :dim*nb_v, :dim*nb_v]`` acting on the velocity segment.

``all_reduce``, ``vdot`` and ``vnorm`` are the reductions of a sharded run
(the original's ``axis_name`` psums, the reference's Epetra all-reduce):
with a process group, each rank's partial sum is summed over the ranks, so
every rank holds the same value and takes the same decisions from it;
without one they are the single-device dot and norm, unchanged.  In the
flat multi-device design (parallel/spmd.py) an operator holds one rank's
cells and its ``group``: every product and diagonal is all-reduced over
it, and the vectors, replicated, take their dots without one.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

__all__ = [
    "all_reduce",
    "vdot",
    "vnorm",
    "ElementOperator",
    "matvec",
    "diagonal",
    "raw_diagonal",
    "velocity_block",
    "pressure_mass_block",
]


def all_reduce(t: torch.Tensor, group=None) -> torch.Tensor:
    """t summed over the ranks of ``group`` (in place); t itself without.
    Under gloo a CUDA tensor is summed through a host copy."""
    if group is not None:
        import torch.distributed as dist

        if t.is_cuda and dist.get_backend(group) == "gloo":
            host = t.cpu()
            dist.all_reduce(host, group=group)
            t.copy_(host)
        else:
            dist.all_reduce(t, group=group)
    return t


def vdot(a: torch.Tensor, b: torch.Tensor, group=None) -> torch.Tensor:
    """a . b over every rank's entries."""
    return all_reduce(torch.dot(a, b), group)


def vnorm(v: torch.Tensor, group=None) -> torch.Tensor:
    """||v||_2 over every rank's entries."""
    if group is None:
        return torch.linalg.vector_norm(v)
    return torch.sqrt(vdot(v, v, group))


@dataclass(frozen=True)
class ElementOperator:
    """Unassembled element-matrix operator on R^n with Dirichlet row fixes."""

    cell_mat: torch.Tensor  # [nc, nl, nl]
    cell_dofs: torch.Tensor  # [nc, nl] int32 global ids
    bc_rows: torch.Tensor  # [nbc] int (may be empty)
    bc_diag: torch.Tensor  # [nbc] replacement diagonal for constrained rows
    # transpose gather map [n, K] (ops/scatter.py); None builds one per call
    scatter_idx: torch.Tensor | None
    n: int
    # symmetric Dirichlet elimination: also zero constrained COLUMNS, keeping
    # the operator SPD for inner CG solves (preconditioner blocks); the outer
    # tangent operator uses False (eliminate_columns=false parity, cpp:376)
    bc_symmetric: bool = False
    # the process group the cells are split over (flat multi-device design):
    # every reduction is all-reduced over it (None: one device)
    group: object = None


def _reduce(values_flat, cell_dofs, scatter_idx, n):
    from ..ops.scatter import build_gather_map, gather_scatter

    if scatter_idx is None:
        scatter_idx = torch.as_tensor(
            build_gather_map(cell_dofs.cpu().numpy(), n), device=values_flat.device
        )
    return gather_scatter(values_flat, scatter_idx)


def matvec(op: ElementOperator, x: torch.Tensor) -> torch.Tensor:
    """y = A x with constrained rows y_i = diag_i * x_i."""
    x_in = x
    has_bc = op.bc_rows.shape[0] > 0
    if op.bc_symmetric and has_bc:
        x_in = x.clone()
        x_in[op.bc_rows] = 0.0
    xl = x_in[op.cell_dofs]  # [nc, nl]
    yl = torch.einsum("cij,cj->ci", op.cell_mat, xl)
    y = all_reduce(_reduce(yl.reshape(-1), op.cell_dofs, op.scatter_idx, op.n), op.group)
    if has_bc:
        y[op.bc_rows] = op.bc_diag * x[op.bc_rows]
    return y


def diagonal(op: ElementOperator) -> torch.Tensor:
    """Assembled main diagonal (for Jacobi preconditioning)."""
    d = raw_diagonal(op.cell_mat, op.cell_dofs, op.n, op.scatter_idx, op.group)
    if op.bc_rows.shape[0]:
        d[op.bc_rows] = op.bc_diag
    return d


def raw_diagonal(
    cell_mat: torch.Tensor,
    cell_dofs: torch.Tensor,
    n: int,
    scatter_idx: torch.Tensor | None = None,
    group=None,
) -> torch.Tensor:
    """Assembled diagonal BEFORE boundary conditions — the diagonal value
    deal.II's apply_boundary_values keeps on constrained rows (all-reduced
    over ``group``)."""
    dl = torch.diagonal(cell_mat, dim1=1, dim2=2)  # [nc, nl]
    return all_reduce(_reduce(dl.reshape(-1), cell_dofs, scatter_idx, n), group)


def velocity_block(
    op: ElementOperator, dim: int, nb_v: int, n_u: int, bc_mask=None, scatter_idx=None
) -> ElementOperator:
    """A00 (velocity-velocity) sub-operator on the velocity segment [0, n_u),
    the reference's ``jacobian_matrix.block(0, 0)`` (hpp:526, 581).

    bc_mask: host boolean array selecting op.bc_rows < n_u (computed from
    op.bc_rows when None)."""
    nvl = dim * nb_v
    if bc_mask is None:
        bc_mask = op.bc_rows.cpu().numpy() < n_u
    sel = torch.as_tensor(np.asarray(bc_mask, bool), device=op.bc_rows.device)
    return ElementOperator(
        cell_mat=op.cell_mat[:, :nvl, :nvl],
        cell_dofs=op.cell_dofs[:, :nvl],
        bc_rows=op.bc_rows[sel],
        bc_diag=op.bc_diag[sel],
        scatter_idx=scatter_idx,
        n=n_u,
        bc_symmetric=True,
        group=op.group,
    )


def pressure_mass_block(
    cell_pmass: torch.Tensor,
    cell_pdofs: torch.Tensor,
    n_p: int,
    scatter_idx: torch.Tensor | None = None,
    group=None,
) -> ElementOperator:
    """Mp operator on the pressure segment (the reference's
    pressure_mass.block(1,1), cpp:163, hpp:527)."""
    return ElementOperator(
        cell_mat=cell_pmass,
        cell_dofs=cell_pdofs,
        bc_rows=torch.zeros(0, dtype=torch.int64, device=cell_pmass.device),
        bc_diag=cell_pmass.new_zeros(0),
        scatter_idx=scatter_idx,
        n=n_p,
        group=group,
    )
