"""Owned-range domain decomposition of the windowed operator.

Port of ``navier_stokes_tpu/parallel/windowed_spmd.py`` (the counterpart of
the reference's Epetra owned/ghost split, ``NavierStokesSolver.hpp:785-794``).
Every array here is made on the host; each rank builds the global layout and
assembly precompute in full, then keeps its shard:

  * rank r owns blocks [r*nb_loc, (r+1)*nb_loc) of every scalar space, so
    its slice of the planar vector is [ux_r | uy_r | (uz_r) | p_r], the
    "device-major" distributed layout.  ``to_dist`` / ``from_dist`` convert
    (pure reshapes).  Krylov vectors hold the owned entries only.
  * the kernels run on the rank's LOCAL layout (``local_layout``): its
    nb_loc owned blocks framed by ``frame`` = max(hv, hp) empty blocks on
    each side, so K1-K4 launch on nb_loc + 2*frame blocks exactly as on one
    device and never read past the framed vector.  A wrapper called with a
    process group fills the frame from the ring neighbours' edge blocks and
    sends the frame's sums back (ops/windowed.py ``_halo_edges`` /
    ``_combine_edges``): O(halo) a product.
  * dots and norms all-reduce (la/operators.py ``vdot``).
  * Dirichlet rows are localized per rank (``localize_rows``, sentinel-
    padded as in the original; a rank keeps its rows before the sentinel).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..fem.windowed_assembly import WindowedAssembly
from ..ops.windowed import FramedLayout, WindowedLayout

__all__ = [
    "DistLayout",
    "make_dist_layout",
    "to_dist",
    "from_dist",
    "local_layout",
    "shard_wa",
    "localize_rows",
    "localize_values",
    "gather_planar",
]


@dataclasses.dataclass(frozen=True)
class DistLayout:
    """Static facts of the device-major distributed vector layout."""

    n_dev: int
    dim: int
    nb: int  # global blocks (divisible by n_dev)
    nb_loc: int
    OWv: int
    OWp: int
    n_vs: int  # global scalar velocity dofs (= nb * OWv)
    n_ps: int

    @property
    def nvs_loc(self) -> int:
        return self.nb_loc * self.OWv

    @property
    def nps_loc(self) -> int:
        return self.nb_loc * self.OWp

    @property
    def llen(self) -> int:
        return self.dim * self.nvs_loc + self.nps_loc

    @property
    def n_total(self) -> int:
        return self.n_dev * self.llen


def make_dist_layout(lay: WindowedLayout, n_dev: int) -> DistLayout:
    if lay.nb % n_dev:
        raise ValueError(
            f"nb={lay.nb} not divisible by {n_dev} devices "
            "(renumber_blocked(nb_multiple=n_dev) enforces this)"
        )
    nb_loc = lay.nb // n_dev
    if nb_loc < max(lay.hv, lay.hp, 1):
        raise ValueError(
            f"{nb_loc} blocks/device < halo {max(lay.hv, lay.hp)}: "
            "problem too small for this device count"
        )
    return DistLayout(
        n_dev=n_dev, dim=lay.dim, nb=lay.nb, nb_loc=nb_loc,
        OWv=lay.OWv, OWp=lay.OWp, n_vs=lay.n_vs, n_ps=lay.n_ps,
    )


def to_dist(x, dl: DistLayout):
    """Planar [n_total] -> device-major [n_dev * llen] (a pure permutation);
    numpy arrays and torch tensors alike."""
    cat = torch.cat if isinstance(x, torch.Tensor) else np.concatenate
    comps = [
        x[c * dl.n_vs : (c + 1) * dl.n_vs].reshape(dl.n_dev, dl.nvs_loc)
        for c in range(dl.dim)
    ]
    p = x[dl.dim * dl.n_vs :].reshape(dl.n_dev, dl.nps_loc)
    return cat(comps + [p], 1).reshape(-1)


def from_dist(xd, dl: DistLayout):
    """Device-major [n_dev * llen] -> planar [n_total]."""
    cat = torch.cat if isinstance(xd, torch.Tensor) else np.concatenate
    chunks = xd.reshape(dl.n_dev, dl.llen)
    comps = [
        chunks[:, c * dl.nvs_loc : (c + 1) * dl.nvs_loc].reshape(-1)
        for c in range(dl.dim)
    ]
    p = chunks[:, dl.dim * dl.nvs_loc :].reshape(-1)
    return cat(comps + [p])


def local_layout(lay: WindowedLayout, dl: DistLayout, rank: int) -> FramedLayout:
    """Rank ``rank``'s framed layout: the global tables of its nb_loc blocks
    (the rows [rank*nb_loc, (rank+1)*nb_loc) of every block-axis table; a
    block's window positions are relative to its own window, so they carry
    over as they are) between ``frame`` = max(hv, hp) empty blocks on each
    side.  An empty block has padded slots only (cell 0, sentinel positions,
    subwindow offset 0), so the kernels give it no work.  Its spaces are the
    framed ones (n_vs = (nb_loc + 2*frame) * OWv); the rank's owned vector
    is the middle nb_loc blocks of each (``nvs_own``, ``nps_own``)."""
    F = max(lay.hv, lay.hp)
    rows = slice(rank * dl.nb_loc, (rank + 1) * dl.nb_loc)

    def framed(t, fill):
        t = t[rows]
        pad = t.new_full((F, *t.shape[1:]), fill)
        return torch.cat([pad, t, pad])

    cell_ids = framed(lay.cell_ids, 0)
    loc_p_hi = framed(lay.loc_p_hi, lay.RVp)
    n_cells = int((loc_p_hi[:, 0, :] < lay.RVp).sum())  # occupied slots
    nb = dl.nb_loc + 2 * F
    fields = {f.name: getattr(lay, f.name) for f in dataclasses.fields(WindowedLayout)}
    return FramedLayout(**{
        **fields,
        "cell_ids": cell_ids,
        "loc_v_hi": framed(lay.loc_v_hi, lay.RVv),
        "loc_v_lo": framed(lay.loc_v_lo, 128),
        "loc_p_hi": loc_p_hi,
        "loc_p_lo": framed(lay.loc_p_lo, 128),
        "offs_v": framed(lay.offs_v, 0),
        "offs_p": framed(lay.offs_p, 0),
        "nb": nb,
        "n_vs": nb * lay.OWv,
        "n_ps": nb * lay.OWp,
        "pad_factor": float(nb * lay.Bmax) / max(n_cells, 1),
        "frame": F,
    })


def shard_wa(wa: WindowedAssembly, dl: DistLayout, lay_loc: WindowedLayout, rank: int,
             device) -> WindowedAssembly:
    """Rank ``rank``'s part of a global ``WindowedAssembly``, on ``device``.

    Cell-axis arrays (invJT_t, W_t, A_const, Kp_t) keep the rank's nb_loc
    blocks of slots, framed by lay_loc.frame empty blocks each side whose
    slots carry zero quadrature weights, identity invJT and zero matrices,
    so their contributions vanish identically.  r_const and each row of
    kp_modes are the rank's chunk of ``to_dist``; inv_mp, diag_kp, agg_p and agg_v (block-contiguous)
    their owned ranges, the aggregates keeping their global ids; the
    tabulations and the dense coarse inverses are replicated."""
    F, Bmax = lay_loc.frame, lay_loc.Bmax
    cols = slice(rank * dl.nb_loc * Bmax, (rank + 1) * dl.nb_loc * Bmax)

    def framed(t, fill=None):  # [..., ncd] -> the rank's framed columns
        t = t[..., cols]
        pad = t.new_zeros((*t.shape[:-1], F * Bmax))
        if fill is not None:
            pad += fill[..., None]
        return torch.cat([pad, t, pad], -1).to(device)

    def owned(t, n_loc):
        return None if t is None else t[rank * n_loc : (rank + 1) * n_loc].to(device)

    eye = torch.eye(dl.dim, dtype=wa.invJT_t.dtype, device=wa.invJT_t.device)
    own = slice(rank * dl.llen, (rank + 1) * dl.llen)
    r_loc = to_dist(wa.r_const, dl)[own]
    km = None if wa.kp_modes is None else torch.stack(
        [to_dist(row, dl)[own] for row in wa.kp_modes]).to(device)

    def rep(t):
        return None if t is None else t.to(device)

    return dataclasses.replace(
        wa,
        N_v=rep(wa.N_v), N_p=rep(wa.N_p), NN=rep(wa.NN), G_v=rep(wa.G_v),
        invJT_t=framed(wa.invJT_t, eye),
        W_t=framed(wa.W_t),
        A_const=framed(wa.A_const),
        r_const=r_loc.to(device),
        inv_mp=owned(wa.inv_mp, dl.nps_loc),
        Kp_t=framed(wa.Kp_t),
        diag_kp=owned(wa.diag_kp, dl.nps_loc),
        agg_p=owned(wa.agg_p, dl.nps_loc),
        coarse_inv=rep(wa.coarse_inv),
        agg_v=owned(wa.agg_v, dl.nvs_loc),
        coarse_inv_v=rep(wa.coarse_inv_v),
        kp_modes=km,
    )


def localize_rows(rows: np.ndarray, dl: DistLayout) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Global PLANAR dof rows -> per-device local rows, sentinel-padded.

    Returns (local_rows [n_dev, m] int32 with sentinel=llen for padding,
    slot_dev [n_rows], slot_idx [n_rows]) -- the slot arrays place per-row
    VALUES (e.g. time-dependent Dirichlet data) into the same [n_dev, m]
    shape (localize_values).  A device's real rows come first, in the
    order of ``rows``."""
    rows = np.asarray(rows, dtype=np.int64)
    dev = np.empty(len(rows), dtype=np.int64)
    loc = np.empty(len(rows), dtype=np.int64)
    nu = dl.dim * dl.n_vs
    vel = rows < nu
    c = rows[vel] // dl.n_vs
    s = rows[vel] % dl.n_vs
    dev[vel] = s // dl.nvs_loc
    loc[vel] = c * dl.nvs_loc + s % dl.nvs_loc
    sp = rows[~vel] - nu
    dev[~vel] = sp // dl.nps_loc
    loc[~vel] = dl.dim * dl.nvs_loc + sp % dl.nps_loc

    counts = np.bincount(dev, minlength=dl.n_dev)
    m = max(int(counts.max()), 1)
    local_rows = np.full((dl.n_dev, m), dl.llen, dtype=np.int32)  # sentinel
    order = np.argsort(dev, kind="stable")
    slot_idx = np.empty(len(rows), dtype=np.int64)
    slot_idx[order] = np.arange(len(rows)) - np.concatenate(
        [[0], np.cumsum(counts[:-1])]
    )[dev[order]]
    local_rows[dev, slot_idx] = loc
    return local_rows, dev, slot_idx


def localize_values(values: np.ndarray, dev, slot_idx, n_dev: int, m: int) -> np.ndarray:
    """Per-row values -> the [n_dev, m] shape matching localize_rows."""
    out = np.zeros((n_dev, m), dtype=np.asarray(values).dtype)
    out[dev, slot_idx] = values
    return out


def gather_planar(x: torch.Tensor, dl: DistLayout, group) -> torch.Tensor:
    """The planar global vector from every rank's owned chunk x (an
    all-gather, then ``from_dist``), on x's device.  Under gloo, CUDA chunks
    travel through host memory (gloo gathers host tensors)."""
    import torch.distributed as dist

    staged = x.is_cuda and dist.get_backend(group) == "gloo"
    xs = x.cpu() if staged else x
    parts = [torch.empty_like(xs) for _ in range(dl.n_dev)]
    dist.all_gather(parts, xs, group=group)
    return from_dist(torch.cat(parts), dl).to(x.device)
