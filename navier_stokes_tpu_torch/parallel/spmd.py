"""The flat operator's multi-device design: cells split over the ranks,
vectors replicated.

Port of ``navier_stokes_tpu/parallel/spmd.py`` (the original's round-1
domain decomposition, and its fallback wherever the windowed operator is
not sharded):

  * cells are put in Morton order (``morton_order``) and split into equal
    contiguous chunks, one a rank, padded to a multiple of the rank count
    with zero-measure cells: jxw 0, an identity inverse Jacobian (finite
    everywhere) and dof 0, so everything they add is an exact zero.  The
    Neumann facets are padded and split the same way (in their own order).
  * solution, residual and Krylov vectors are REPLICATED: each rank
    assembles its cells into a full-length vector through its own gather
    maps (``scatter_full``, ``scatter_vel``, ``scatter_p``), and one
    all-reduce over the process group sums them, the original's ``psum``
    (``FEMContext.group``, ``ElementOperator.group``).  Dots and norms need
    no collective, and must not all-reduce: that would sum n equal copies.

``shard_context`` hands a rank its slice of a host ``FEMContext`` on its
device.  The original's ``device_mesh``, ``context_pspecs`` and
``shard_map`` have no counterpart: the process group (parallel/bootstrap.py)
is the mesh, one process a rank runs the same eager code on its slice, and
the group in the context says where to sum.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..fem.assembly import FEMContext
from ..ops.scatter import build_gather_map

__all__ = ["morton_order", "padded_count", "shard_rows", "shard_context", "cell_owner"]


def morton_order(centroids: np.ndarray, bits: int = 16) -> np.ndarray:
    """Space-filling-curve cell ordering for partition locality (the
    original's, index for index)."""
    x = centroids - centroids.min(axis=0)
    span = x.max(axis=0)
    span[span == 0] = 1.0
    q = np.minimum((x / span * (2**bits - 1)).astype(np.uint64), 2**bits - 1)
    dim = centroids.shape[1]
    key = np.zeros(len(centroids), dtype=np.uint64)
    for b in range(bits):
        for d in range(dim):
            key |= ((q[:, d] >> np.uint64(b)) & np.uint64(1)) << np.uint64(b * dim + d)
    return np.argsort(key, kind="stable")


def padded_count(m: int, n: int) -> int:
    """m rows (at least one) rounded up to a multiple of n ranks."""
    return -(-max(m, 1) // n) * n


def shard_rows(a, n: int, rank: int, order=None, fill=0) -> np.ndarray:
    """Rank ``rank``'s chunk of the rows of a (in ``order``, padded with
    ``fill`` to ``padded_count(len(a), n)``)."""
    a = np.asarray(a)
    if order is not None:
        a = a[order]
    m = padded_count(a.shape[0], n)
    if m > a.shape[0]:
        a = np.concatenate([a, np.full((m - a.shape[0],) + a.shape[1:], fill, a.dtype)])
    per = m // n
    return a[rank * per : (rank + 1) * per].copy()


def shard_context(ctx: FEMContext, rank: int, n: int, cell_order=None, device="cpu",
                  group=None) -> FEMContext:
    """Rank ``rank`` of n's slice of the flat context ``ctx`` (on any
    device), placed on ``device`` with ``group`` to sum over: its chunk of
    the Morton-ordered padded cells and of the padded Neumann facets, the
    tabulations whole, and the gather maps of its own cells (positions in
    its [per, nl] cell values; ``per * nl`` is the zero sentinel)."""
    dim, nb_p = ctx.dim, ctx.nb_p
    nvl = dim * ctx.nb_v

    def cells(t):
        return shard_rows(t.cpu().numpy(), n, rank, cell_order)

    invJT = cells(ctx.invJT)
    # padded cells keep a finite geometry: an identity inverse Jacobian
    invJT[max(ctx.n_cells - rank * invJT.shape[0], 0):] = np.eye(dim)
    cd = cells(ctx.cell_dofs)
    n_p = ctx.n_total - ctx.n_u

    def facets(t):
        return shard_rows(t.cpu().numpy(), n, rank)

    def as_dev(a, like):
        return torch.as_tensor(a, dtype=like.dtype, device=device)

    return dataclasses.replace(
        ctx,
        N_v=ctx.N_v.to(device), G_v=ctx.G_v.to(device), N_p=ctx.N_p.to(device),
        invJT=as_dev(invJT, ctx.invJT),
        jxw=as_dev(cells(ctx.jxw), ctx.jxw),
        cell_vdofs=as_dev(cells(ctx.cell_vdofs), ctx.cell_vdofs),
        cell_dofs=as_dev(cd, ctx.cell_dofs),
        f_q=as_dev(cells(ctx.f_q), ctx.f_q),
        neu_cell_vdofs=as_dev(facets(ctx.neu_cell_vdofs), ctx.neu_cell_vdofs),
        neu_N_v=as_dev(facets(ctx.neu_N_v), ctx.neu_N_v),
        neu_normal=as_dev(facets(ctx.neu_normal), ctx.neu_normal),
        neu_jxw=as_dev(facets(ctx.neu_jxw), ctx.neu_jxw),
        scatter_full=as_dev(build_gather_map(cd, ctx.n_total), ctx.scatter_full),
        scatter_vel=as_dev(build_gather_map(cd[:, :nvl], ctx.n_u), ctx.scatter_vel),
        scatter_p=as_dev(build_gather_map(np.maximum(cd[:, -nb_p:] - ctx.n_u, 0), n_p),
                         ctx.scatter_p),
        group=group,
    )


def cell_owner(n_cells: int, n: int, cell_order) -> np.ndarray:
    """The rank of each cell (natural order): contiguous Morton chunks of
    the padded cells, as ``shard_context`` splits them."""
    owner = np.empty(n_cells, dtype=np.int32)
    owner[cell_order] = np.arange(n_cells) // (padded_count(n_cells, n) // n)
    return owner
