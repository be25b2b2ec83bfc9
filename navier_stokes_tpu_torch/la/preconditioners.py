"""Preconditioners for the [A B^T; B 0] saddle-point system.

Port of ``navier_stokes_tpu/la/preconditioners.py`` (single device):

  * identity, jacobi, coarse_correction, two_level_vcycle: the inner pieces
    of the windowed Schur sweeps;
  * block_diagonal (the reference's PreconditionBlockDiagonal, hpp:520-572):
    inner FGMRES on A00 and on the pressure mass Mp;
  * block_triangular (PreconditionBlockTriangular, hpp:575-639): inner CG
    on A00, then tmp = src_p - B dst_u, inner CG on Mp;

both on the flat element operators of la/operators.py, with Jacobi in place
of the reference's ILU(0) (see the original's docstring).  The inner solves
stop at an absolute tolerance and read their stop test from the device once
per iteration; a zero right-hand side (tolerance 0) has the zero solution
and runs no iteration, as the original's while loop does.
"""

from __future__ import annotations

from typing import Callable

import torch

from .cg import cg
from .gmres import fgmres
from .operators import ElementOperator, _reduce, all_reduce, diagonal, matvec, vnorm

__all__ = [
    "identity",
    "jacobi",
    "coarse_correction",
    "two_level_vcycle",
    "block_diagonal",
    "block_triangular",
    "inner_cg",
    "rect_matvec",
]


def identity() -> Callable:
    return lambda v: v


def _safe_inverse(diag: torch.Tensor) -> torch.Tensor:
    nz = diag != 0
    return torch.where(nz, 1.0 / torch.where(nz, diag, torch.ones_like(diag)), 1.0)


def jacobi(diag: torch.Tensor) -> Callable:
    """Pointwise inverse-diagonal (safe at zeros)."""
    inv = _safe_inverse(diag)
    return lambda v: inv * v


def coarse_correction(
    agg: torch.Tensor,
    coarse_inv: torch.Tensor,
    agg_size: int,
    ncomp: int = 1,
    group=None,
) -> Callable:
    """Two-level aggregation correction ``r -> Z Kc^-1 Zt r``.

    agg:        [n_s] aggregate id per scalar dof (sentinel ``m`` marks
                padding holes, dropped).
    coarse_inv: [m, m] dense inverse of the coarse Galerkin matrix.
    agg_size:   contiguous run length of the aggregates (> 0; the windowed
                assembly fits it to the window, ``_fit_agg_to_ow``):
                restriction and prolongation are a reshape-sum and a
                broadcast.  The original's segment-sum path for irregular
                aggregates (agg_size 0) is not ported: no solver reaches it.
    ncomp:      vector components sharing one scalar coarse space (input is
                component-major [ncomp * n_s]).
    group:      a sharded run's process group: agg and r are the rank's owned
                chunks, whole aggregates (agg_size divides the owned length),
                and rank k's aggregates are [k*m_loc, (k+1)*m_loc) of the
                global [m]; the coarse residual is summed locally, placed in
                the global [ncomp, m] and all-reduced, the solve replicated
                (the original's ``axis_name`` path).
    """
    m_c = coarse_inv.shape[0]
    n_s = agg.shape[0]
    hole = agg >= m_c  # [n_s]

    def _solve(seg):  # [ncomp, m] coarse residual -> [ncomp, m] correction
        return torch.einsum("mk,ck->cm", coarse_inv, seg)

    if group is not None:
        import torch.distributed as dist

        rank, m_loc = dist.get_rank(group), n_s // int(agg_size)
        if n_s % int(agg_size) or m_loc * dist.get_world_size(group) != m_c:
            raise ValueError(
                f"a rank's {n_s} dofs are not whole aggregates of {agg_size} "
                f"({m_c} in all)")
        own = slice(rank * m_loc, (rank + 1) * m_loc)

        def coarse_sharded(r):
            r2 = r.reshape(ncomp, n_s)
            rm = torch.where(hole, 0.0, r2).to(coarse_inv.dtype)
            seg = rm.new_zeros((ncomp, m_c))
            seg[:, own] = rm.reshape(ncomp, m_loc, -1).sum(-1)
            y = _solve(all_reduce(seg, group))[:, own]
            corr = y[:, :, None].expand(ncomp, m_loc, n_s // m_loc).reshape(ncomp, -1)
            return torch.where(hole, 0.0, corr).to(r.dtype).reshape(-1)

        return coarse_sharded

    sa = int(agg_size)
    mm = -(-n_s // sa)
    npad = mm * sa - n_s

    def coarse(r):
        r2 = r.reshape(ncomp, n_s)
        rm = torch.where(hole, 0.0, r2).to(coarse_inv.dtype)
        seg = torch.nn.functional.pad(rm, (0, npad)).reshape(ncomp, mm, sa).sum(-1)
        y = _solve(seg)
        corr = y[:, :, None].expand(ncomp, mm, sa).reshape(ncomp, -1)[:, :n_s]
        return torch.where(hole, 0.0, corr).to(r.dtype).reshape(-1)

    return coarse


def two_level_vcycle(
    matvec: Callable,
    diag: torch.Tensor,
    coarse: Callable,
    omega: float = 0.7,
) -> Callable:
    """Symmetric multiplicative two-level V(1,1) cycle as a linear operator:

        x1 = w D^-1 r;  x2 = x1 + C (r - A x1);  x  = x2 + w D^-1 (r - A x2)
    """
    w_inv = omega * _safe_inverse(diag)

    def apply(r):
        x1 = w_inv * r
        x2 = x1 + coarse(r - matvec(x1))
        return x2 + w_inv * (r - matvec(x2))

    return apply


def _norm(v: torch.Tensor, group=None) -> float:
    return float(vnorm(v, group))


def inner_cg(matvec: Callable, b: torch.Tensor, atol: float, maxiter: int,
             precond: Callable, group=None) -> torch.Tensor:
    """An inner CG solve to ``atol`` (> 0 reads the stop flag each
    iteration); atol 0 means b = 0, whose solution is zero."""
    if atol == 0:
        return torch.zeros_like(b)
    return cg(matvec, b, atol=atol, maxiter=maxiter, precond=precond, group=group).x


def rect_matvec(
    cell_block: torch.Tensor,
    in_dofs: torch.Tensor,
    out_dofs: torch.Tensor,
    n_out: int,
    x: torch.Tensor,
    scatter_idx: torch.Tensor | None = None,
) -> torch.Tensor:
    """Rectangular element-form matvec (e.g. the divergence block B)."""
    yl = torch.einsum("cij,cj->ci", cell_block, x[in_dofs])
    return _reduce(yl.reshape(-1), out_dofs, scatter_idx, n_out)


def block_diagonal(
    A00: ElementOperator,
    Mp: ElementOperator,
    *,
    inner_tol: float = 1e-2,
    inner_maxiter: int = 1000,
    inner_restart: int = 50,
) -> Callable:
    """diag(A00, Mp)^{-1} via inner FGMRES solves (hpp:537-558)."""
    n_u = A00.n
    pA = jacobi(diagonal(A00))
    pM = jacobi(diagonal(Mp))

    def apply(v):
        vu, vp = v[:n_u], v[n_u:]
        du = fgmres(
            lambda y: matvec(A00, y), vu, atol=inner_tol * _norm(vu),
            restart=inner_restart, maxiter=inner_maxiter, precond=pA,
        ).x
        dp = fgmres(
            lambda y: matvec(Mp, y), vp, atol=inner_tol * _norm(vp),
            restart=inner_restart, maxiter=inner_maxiter, precond=pM,
        ).x
        return torch.cat([du, dp])

    return apply


def block_triangular(
    A00: ElementOperator,
    Mp: ElementOperator,
    B_block: torch.Tensor,  # [nc, nb_p, nvl] pressure-row/velocity-col cells
    B_in_dofs: torch.Tensor,  # [nc, nvl] velocity-space ids
    B_out_dofs: torch.Tensor,  # [nc, nb_p] pressure-space ids
    *,
    inner_tol: float = 1e-2,
    inner_maxiter: int = 2000,
    B_scatter_idx: torch.Tensor | None = None,
) -> Callable:
    """Lower-triangular Schur sweep (hpp:594-619):
    dst_u = A00^{-1} src_u;  dst_p = Mp^{-1} (src_p - B dst_u)."""
    n_u, n_p = A00.n, Mp.n
    pA = jacobi(diagonal(A00))
    pM = jacobi(diagonal(Mp))

    def apply(v):
        vu, vp = v[:n_u], v[n_u:]
        du = inner_cg(lambda y: matvec(A00, y), vu, inner_tol * _norm(vu), inner_maxiter, pA)
        tmp = vp - rect_matvec(B_block, B_in_dofs, B_out_dofs, n_p, du,
                               scatter_idx=B_scatter_idx)
        # tolerance floored relative to the actual rhs of this solve: the
        # reference's bare 1e-2*||src_p|| is unreachable when src_p = 0 (the
        # first Krylov vector's pressure block vanishes)
        atol_p = max(inner_tol * _norm(vp), 1e-10 * _norm(tmp))
        dp = inner_cg(lambda y: matvec(Mp, y), tmp, atol_p, inner_maxiter, pM)
        return torch.cat([du, dp])

    return apply
