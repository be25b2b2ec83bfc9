"""Windowed matrix-free operator: layout, plain torch versions, CUDA kernels.

Port of ``navier_stokes_tpu/ops/windowed.py``.  The host layout build is the
original's numpy code, copied; the device side is torch.  The layout puts
every cell in exactly one home block (cells-last "slot" axis, nb blocks of
Bmax slots) and gives each block a WINDOW of (2h+1) owned ranges of every
space around its own; see the original's module docstring for the design.

Four operations carry the solver's main path.  Each has a plain torch
version in this module and a CUDA kernel in ``csrc/windowed.cu``; the
wrapper picks by the device of the tensor it is given:

  ==========================  =============================  ===============
  wrapper                     plain version                  CUDA kernel
  ==========================  =============================  ===============
  ``windowed_matvec``         ``windowed_matvec_reference``  K1 ``ns_matvec``
  ``windowed_matvec_block``   ``_block_reference``           K2 ``ns_matvec``
  ``windowed_gather``         ``_gather_reference``          K3 ``ns_gather``
  ``windowed_gather_pair``    ``_gather_reference`` twice    K3 ``ns_gather``
  ``windowed_scatter``        ``_scatter_reference``         K4 ``ns_scatter``
  ==========================  =============================  ===============

A CPU tensor goes to the plain version; a CUDA tensor launches the kernel
(and raises if the kernel cannot take it).  Each wrapper counts its kernel
launches in ``<wrapper>.launches`` (``reset_launch_counts`` zeroes them);
``windowed_gather_pair`` gathers two vectors in one K3 launch and counts it
in ``windowed_gather.launches``.
The kernels compute in float32 and read A in float32 or bfloat16.  They
are built for Taylor-Hood P2/P1 and P3/P2 on triangles and tetrahedra
(``_ELEMENTS``); on the card any other layout raises NotImplementedError.

The kernels read window positions from one packed table per space
(``pack_positions``: absolute positions, 16 bits wide where the windows
allow), derived once per layout from the JAX-shaped ``loc_*_hi``/``loc_*_lo``/
``offs_*`` tables and cached on it.  K1, K2 and K4 run one CUDA block per
(layout block, chunk), sum into the chunk's subwindows and end in a merge
kernel launched by the same C call (plain version of that order:
``_scatter_chunked_reference`` through ``_merge_reference``), so a wrapper
call is one C call and does no torch arithmetic after it.  On tetrahedra
K1, K2 and K4 sum each chunk's slots at the distinct positions they touch
instead, and merge through a list of each row's sums (``compact_tables``;
plain versions of that order: ``_compact_matvec_reference`` and
``_compact_scatter_reference``).

In a sharded run (``group``, parallel/windowed_spmd.py) a rank's layout is
a ``FramedLayout``: its owned blocks between empty ones.  Every wrapper and
plain version then takes the rank's owned vectors, copies them into the
frame with the ring neighbours' edge blocks (``_frame``: ``_halo_edges``),
runs as above on the framed layout, and folds the frame's sums back to the
neighbours (``_unframe``: ``_combine_edges``).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import time
from dataclasses import dataclass
from functools import cached_property
from pathlib import Path

import numpy as np
import torch

__all__ = [
    "WindowedLayout",
    "FramedLayout",
    "build_windowed_layout",
    "build_windows",
    "to_block_form",
    "windowed_matvec",
    "windowed_matvec_block",
    "windowed_matvec_reference",
    "windowed_gather",
    "windowed_gather_pair",
    "windowed_scatter",
    "slice_block",
    "block_shape",
    "build_kernels",
    "build_library",
    "reset_launch_counts",
    "launch_counts",
    "pack_positions",
    "unpack_positions",
    "CompactSpace",
    "compact_tables",
    "exchange_floats",
]

_ALIGN_ROWS = 8  # subwindow offsets in whole 8-row groups (layout compatibility)


@dataclass(frozen=True)
class WindowedLayout:
    cell_ids: torch.Tensor  # [nb, Bmax] int32 original cell index (pad: 0)
    # per-chunk REBASED window-local positions [nb, kpad, Bmax] (cells last)
    # split into 128-row / in-row parts (sentinel: hi = RVc, lo = 128)
    loc_v_hi: torch.Tensor
    loc_v_lo: torch.Tensor
    loc_p_hi: torch.Tensor
    loc_p_lo: torch.Tensor
    # per-chunk subwindow ROW offsets into the full window [nb, nchunks]
    offs_v: torch.Tensor
    offs_p: torch.Tensor
    nb: int
    Bmax: int
    Bc: int  # cells per chunk
    nchunks: int
    OWv: int
    OWp: int
    hv: int  # halo blocks each side (v)
    hp: int
    RWv: int  # full window rows (padded)
    RWp: int
    RVv: int  # subwindow rows (v)
    RVp: int
    k_v: int  # true scalar dofs/cell (v)
    k_p: int
    dim: int
    n_vs: int
    n_ps: int
    pad_factor: float  # ncd / n_cells

    # the empty blocks framing the owned ones on each side: 0 here, set by
    # a rank's local layout (``FramedLayout``)
    frame = 0

    @property
    def n_u(self) -> int:
        return self.dim * self.n_vs

    @property
    def nvs_own(self) -> int:
        """Length of one velocity component of the vectors the solver holds:
        the owned blocks' (n_vs less the frame's; n_vs on one device)."""
        return self.n_vs - 2 * self.frame * self.OWv

    @property
    def nps_own(self) -> int:
        return self.n_ps - 2 * self.frame * self.OWp

    @property
    def nl(self) -> int:
        return self.dim * self.k_v + self.k_p

    @property
    def nli(self) -> int:
        return _round_up(self.nl, 8)

    @property
    def ncd(self) -> int:
        """Flat padded cell count (last axis of A_t)."""
        return self.nb * self.Bmax

    @property
    def device(self) -> torch.device:
        return self.cell_ids.device

    def to(self, device) -> "WindowedLayout":
        tensors = {
            k: getattr(self, k).to(device)
            for k in ("cell_ids", "loc_v_hi", "loc_v_lo", "loc_p_hi",
                      "loc_p_lo", "offs_v", "offs_p")
        }
        return dataclasses.replace(self, **tensors)

    @cached_property
    def _packed(self) -> "_Packed":
        """The kernels' tables and argument pack, derived at first use."""
        return _Packed(self)


@dataclass(frozen=True)
class FramedLayout(WindowedLayout):
    """A rank's local layout in a sharded run (built by
    ``parallel/windowed_spmd.local_layout``): a WindowedLayout whose nb
    blocks are the rank's owned ones between ``frame`` empty blocks on each
    side, and whose spaces are the framed ones (n_vs = nb * OWv)."""

    frame: int = 0


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


# ---------------------------------------------------------------------------
# host side (numpy, copied from the original)
# ---------------------------------------------------------------------------


def build_windowed_layout(
    cell_vdofs: np.ndarray,
    cell_pdofs: np.ndarray,
    n_vs: int,
    n_ps: int,
    dim: int,
    block_info: dict | None = None,
    target_ow: int = 1024,
    Bc: int = 128,
    device="cpu",
) -> WindowedLayout:
    """Host-side layout construction (see the original's docstring); the
    tables are placed on ``device``."""
    if block_info is not None:
        nb, OWv, OWp = block_info["nb"], block_info["OWv"], block_info["OWp"]
        if nb * OWv != n_vs or nb * OWp != n_ps:
            raise ValueError("block_info mismatch")
    else:
        nb = max(1, int(round(n_vs / target_ow)))
        OWv = _round_up(-(-n_vs // nb), 128)
        OWp = _round_up(-(-n_ps // nb), 128)
    return _build(cell_vdofs, cell_pdofs, n_vs, n_ps, dim, nb, OWv, OWp, Bc, device)


def _halo_and_loc(cell_space_dofs, cell_ids, valid, OW, nb, max_halo=6):
    """Halo width (whole blocks) from the ACTUAL reach of the listed cells,
    plus absolute window-local positions [nb, Bmax, k]."""
    dofs_b = cell_space_dofs[cell_ids].astype(np.int64)  # [nb, Bmax, k]
    owned_lo = (np.arange(nb) * OW)[:, None, None]
    reach_lo = np.where(valid[:, :, None], owned_lo - dofs_b, 0).max()
    reach_hi = np.where(valid[:, :, None], dofs_b - (owned_lo + OW) + 1, 0).max()
    h = int(max(0, -(-max(reach_lo, reach_hi) // OW)))
    if h > max_halo:
        raise ValueError(
            f"halo {h} blocks exceeds limit (OW={OW}); ordering not local enough"
        )
    W = (2 * h + 1) * OW
    loc = dofs_b - (owned_lo - h * OW)
    loc[~valid] = -1  # sentinel marker (replaced after chunk rebasing)
    if valid.any():
        assert loc[valid].min() >= 0 and loc[valid].max() < W
    return h, loc


def _chunk_offsets(loc, valid, RW, Bc):
    """Per-chunk subwindow row offsets + static subwindow row count.

    loc: [nb, Bmax, k] absolute window positions (-1 invalid).
    Returns (offs_rows [nb, nchunks] int32, RVc rows, loc_rebased)."""
    nb, Bmax, k = loc.shape
    nchunks = Bmax // Bc
    lc = loc.reshape(nb, nchunks, Bc, k)
    vc = valid.reshape(nb, nchunks, Bc)[:, :, :, None]
    big = RW * 128
    lo = np.where(vc, lc, big).min(axis=(2, 3))  # [nb, nchunks]
    hi = np.where(vc, lc, -1).max(axis=(2, 3))
    lo = np.where(lo == big, 0, lo)
    off = (lo // (128 * _ALIGN_ROWS)) * (128 * _ALIGN_ROWS)
    need = np.maximum(hi + 1 - off, 1)
    Wc = min(int(_round_up(int(need.max()), 128 * _ALIGN_ROWS)), big)
    off = np.minimum(off, big - Wc)  # clamp: both multiples of ALIGN
    loc_r = np.where(loc >= 0, loc - off[:, :, None, None].repeat(Bc, 2).reshape(
        nb, Bmax, 1), -1)
    RVc = Wc // 128
    if valid.any():
        v3 = valid[:, :, None] & (loc >= 0)
        assert loc_r[v3].min() >= 0 and loc_r[v3].max() < Wc
    return (off // 128).astype(np.int32), RVc, loc_r


def _split_hilo(loc_r, RVc, nb, Bmax):
    """Split rebased positions into (hi, lo) with sentinel rows; pad the dof
    axis to a multiple of 8; transpose to [nb, kpad, Bmax]."""
    k = loc_r.shape[2]
    kp = _round_up(k, 8)
    out = np.full((nb, Bmax, kp), -1, dtype=np.int64)
    out[:, :, :k] = loc_r
    hi = np.where(out < 0, RVc, out // 128)
    lo = np.where(out < 0, 128, out % 128)
    return (
        hi.astype(np.int32).transpose(0, 2, 1),
        lo.astype(np.int32).transpose(0, 2, 1),
    )


def _build(cell_vdofs, cell_pdofs, n_vs, n_ps, dim, nb, OWv, OWp, Bc=128,
           device="cpu") -> WindowedLayout:
    nc, k_v = cell_vdofs.shape
    k_p = cell_pdofs.shape[1]

    # home block of each cell: block containing the midpoint of its v-dof
    # span (each cell appears exactly ONCE; halo rows it writes outside its
    # home block's owned range are merged by _combine_windows)
    cv = cell_vdofs.astype(np.int64)
    mid = (cv.min(axis=1) + cv.max(axis=1)) // 2
    home = np.clip(mid // OWv, 0, nb - 1)

    counts = np.bincount(home, minlength=nb)
    Bc = max(128, Bc)
    Bmax = _round_up(max(int(counts.max()), 1), Bc)

    order = np.argsort(home, kind="stable")
    cell_ids = np.zeros((nb, Bmax), dtype=np.int64)
    valid = np.zeros((nb, Bmax), dtype=bool)
    starts = np.concatenate([[0], np.cumsum(counts[:-1])])
    within = np.arange(nc) - starts[home[order]]
    cell_ids[home[order], within] = order
    valid[home[order], within] = True

    hv, loc_v = _halo_and_loc(cell_vdofs, cell_ids, valid, OWv, nb)
    hp, loc_p = _halo_and_loc(cell_pdofs, cell_ids, valid, OWp, nb)

    # sort cells WITHIN each block by window position so chunks of Bc
    # consecutive cells span narrow subwindows (invalid slots pushed last)
    big = (2 * hv + 1) * OWv + 1
    key = np.where(valid, np.where(loc_v >= 0, loc_v, big).min(axis=2), big)
    perm = np.argsort(key, axis=1, kind="stable")  # [nb, Bmax]
    rows = np.arange(nb)[:, None]
    cell_ids = cell_ids[rows, perm]
    valid = valid[rows, perm]
    loc_v = loc_v[rows, perm]
    loc_p = loc_p[rows, perm]

    nchunks = Bmax // Bc

    RWv = _round_up((2 * hv + 1) * OWv // 128, _ALIGN_ROWS)
    RWp = _round_up((2 * hp + 1) * OWp // 128, _ALIGN_ROWS)
    offs_v, RVv, loc_v_r = _chunk_offsets(loc_v, valid, RWv, Bc)
    offs_p, RVp, loc_p_r = _chunk_offsets(loc_p, valid, RWp, Bc)
    lv_hi, lv_lo = _split_hilo(loc_v_r, RVv, nb, Bmax)
    lp_hi, lp_lo = _split_hilo(loc_p_r, RVp, nb, Bmax)

    def as_i(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=torch.int32, device=device)

    return WindowedLayout(
        cell_ids=as_i(cell_ids),
        loc_v_hi=as_i(lv_hi),
        loc_v_lo=as_i(lv_lo),
        loc_p_hi=as_i(lp_hi),
        loc_p_lo=as_i(lp_lo),
        offs_v=as_i(offs_v),
        offs_p=as_i(offs_p),
        nb=nb,
        Bmax=Bmax,
        Bc=Bc,
        nchunks=nchunks,
        OWv=OWv,
        OWp=OWp,
        hv=hv,
        hp=hp,
        RWv=RWv,
        RWp=RWp,
        RVv=RVv,
        RVp=RVp,
        k_v=k_v,
        k_p=k_p,
        dim=dim,
        n_vs=n_vs,
        n_ps=n_ps,
        pad_factor=float(nb * Bmax) / max(nc, 1),
    )


# ---------------------------------------------------------------------------
# device side: windows and their merge (torch)
# ---------------------------------------------------------------------------


def build_windows(x_space: torch.Tensor, nb: int, OW: int, h: int = 1) -> torch.Tensor:
    """[nb, (2h+1)*OW/128, 128] sliding windows of one space's vector."""
    xp = x_space.new_zeros(nb * OW)
    xp[: x_space.shape[0]] = x_space
    return _windows_from_ext(_pad_edges(xp.reshape(nb, OW), h), nb, OW, h)


def _pad_edges(r: torch.Tensor, h: int) -> torch.Tensor:
    """[nb, OW] -> [nb + 2h, OW] with zero edge blocks."""
    if h == 0:
        return r
    z = r.new_zeros((h, r.shape[1]))
    return torch.cat([z, r, z], dim=0)


def _windows_from_ext(x_ext: torch.Tensor, nb: int, OW: int, h: int) -> torch.Tensor:
    """[nb + 2h, OW] edge-extended blocks -> [nb, (2h+1)*OW/128, 128]."""
    shifts = [x_ext[s : s + nb] for s in range(2 * h + 1)]
    W = (2 * h + 1) * OW
    return torch.cat(shifts, dim=1).reshape(nb, W // 128, 128)


def _combine_windows(win: torch.Tensor, nb: int, OW: int, h: int, n: int) -> torch.Tensor:
    """Merge per-block window accumulators into the space's vector.

    win: [..., nb, L >= (2h+1)*OW] — window entry j*OW + r of block b is
    global row (b - h + j)*OW + r; entries past (2h+1)*OW are dropped.
    (2h+1) shifted adds in a fixed order; leading axes (vector components)
    are batched."""
    lead = win.shape[:-2]
    W = (2 * h + 1) * OW
    seg = win[..., :W].reshape(*lead, nb, 2 * h + 1, OW)
    acc = win.new_zeros((*lead, nb + 2 * h, OW))
    for j in range(2 * h + 1):
        acc[..., j : j + nb, :] += seg[..., j, :]
    return acc[..., h : h + nb, :].reshape(*lead, -1)[..., :n]


def _split_spaces(x: torch.Tensor, lay: WindowedLayout):
    comps = [x[c * lay.n_vs : (c + 1) * lay.n_vs] for c in range(lay.dim)]
    p = x[lay.n_u : lay.n_u + lay.n_ps]
    return comps, p


def _all_windows(lay: WindowedLayout, x: torch.Tensor):
    """Padded per-space windows [nb, RW, 128] (the plain versions' input)."""
    comps, p = _split_spaces(x, lay)
    xw = [build_windows(c, lay.nb, lay.OWv, lay.hv) for c in comps] + [
        build_windows(p, lay.nb, lay.OWp, lay.hp)
    ]
    out = []
    for w, RW in zip(xw, [lay.RWv] * lay.dim + [lay.RWp]):
        if w.shape[1] != RW:
            wp = w.new_zeros((lay.nb, RW, 128))
            wp[:, : w.shape[1], :] = w
            w = wp
        out.append(w)
    return out


# ---------------------------------------------------------------------------
# sharded runs: the edge blocks a rank trades with its ring neighbours
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=16)
def _pinned(numel: int, dtype: torch.dtype) -> torch.Tensor:
    """A page-locked host buffer of ``numel`` entries, reused by every
    exchange of that size: an exchange waits for its stream before the
    network touches the buffer, which orders it after the previous
    exchange's copies out of it."""
    return torch.empty(numel, dtype=dtype, pin_memory=True)


def _exchange(sends, group):
    """One ``batch_isend_irecv`` with ranks r-1 and r+1 of ``group``: each
    pair (to_left, to_right) of flat tensors in ``sends`` goes to the left
    and right neighbour, and the pairs (from_left, from_right) received come
    back in the same order, zeros where rank r is at an end of the line.
    Under gloo, CUDA tensors travel through one pinned host buffer; under
    NCCL, device to device.  ``exchange_floats`` counts the floats sent."""
    import torch.distributed as dist

    rank, size = dist.get_rank(group), dist.get_world_size(group)
    left = dist.get_global_rank(group, rank - 1) if rank > 0 else None
    right = dist.get_global_rank(group, rank + 1) if rank + 1 < size else None
    recvs = [(torch.zeros_like(tr), torch.zeros_like(tl)) for tl, tr in sends]
    wire_s, wire_r = sends, recvs
    stage = sends[0][0].is_cuda and dist.get_backend(group) == "gloo"
    if stage:
        flat = [t for pair in sends + recvs for t in pair]
        host = _pinned(sum(t.numel() for t in flat), flat[0].dtype)
        views = iter(host.split([t.numel() for t in flat]))
        wire_s = [(next(views), next(views)) for _ in sends]
        wire_r = [(next(views), next(views)) for _ in recvs]
        for (hl, hr), (tl, tr) in zip(wire_s, sends):
            hl.copy_(tl, non_blocking=True)
            hr.copy_(tr, non_blocking=True)
        torch.cuda.current_stream(sends[0][0].device).synchronize()
    ops = []
    for i, ((tl, tr), (fl, fr)) in enumerate(zip(wire_s, wire_r)):
        # tag 2i: sent leftwards; 2i + 1: sent rightwards
        if left is not None:
            ops += [dist.P2POp(dist.isend, tl, left, group, 2 * i),
                    dist.P2POp(dist.irecv, fl, left, group, 2 * i + 1)]
            _exchange.floats += tl.numel()
        if right is not None:
            ops += [dist.P2POp(dist.isend, tr, right, group, 2 * i + 1),
                    dist.P2POp(dist.irecv, fr, right, group, 2 * i)]
            _exchange.floats += tr.numel()
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    if stage:
        for (hl, hr), (fl, fr) in zip(wire_r, recvs):
            if left is not None:
                fl.copy_(hl, non_blocking=True)
            if right is not None:
                fr.copy_(hr, non_blocking=True)
    return recvs


def exchange_floats() -> int:
    """Floats this rank has sent to its neighbours since the last
    ``reset_launch_counts``."""
    return _exchange.floats


def _halo_edges(rs, hs, group):
    """Owned blocks [nb, OW] of each space -> [nb + 2h, OW]: the left
    neighbour's last h blocks, the owned ones, the right neighbour's first
    h blocks (zeros at the ends of the line), all spaces in one exchange.
    The ghost import of the reference's Epetra SpMV (cpp:345-347): O(h*OW)
    floats a space, not O(n)."""
    got = _exchange([(r[:h].reshape(-1), r[len(r) - h :].reshape(-1)) for r, h in zip(rs, hs)],
                    group)
    return [torch.cat([fl.view(h, r.shape[1]), r, fr.view(h, r.shape[1])])
            for r, h, (fl, fr) in zip(rs, hs, got)]


def _combine_edges(accs, hs, group):
    """Sums [nb + 2h, OW] over a rank's owned blocks and h blocks on each
    side of them -> the owned blocks' sums [nb, OW]: the first h rows are
    sums into the left neighbour's last blocks and go there, the last h
    into the right neighbour's first blocks; what the neighbours send back
    is added to the owned edge blocks (left's first, then right's).  The
    exchange half of the original's ``_combine_windows``, all spaces in
    one exchange (the reference's ``compress(add)``)."""
    got = _exchange([(a[:h].reshape(-1), a[len(a) - h :].reshape(-1)) for a, h in zip(accs, hs)],
                    group)
    out = []
    for a, h, (fl, fr) in zip(accs, hs, got):
        nb = len(a) - 2 * h
        mid = a[h : h + nb].clone()
        mid[:h] += fl.view(h, a.shape[1])
        mid[nb - h :] += fr.view(h, a.shape[1])
        out.append(mid)
    return out


def _space_list(lay: WindowedLayout, spaces: str):
    """(OW, h) of each scalar space of ``spaces``, velocity components first."""
    return ([(lay.OWv, lay.hv)] * lay.dim if "v" in spaces else []) + (
        [(lay.OWp, lay.hp)] if "p" in spaces else [])


def _frame(lay: WindowedLayout, spaces: str, group, *xs):
    """A rank's owned vectors (the ``spaces`` segments: [dim*nvs_own +
    nps_own] for "vp") -> its framed layout's vectors: each space's owned
    blocks between the neighbours' h edge blocks, then zeros to the frame's
    edge.  Every vector in one exchange."""
    sp = _space_list(lay, spaces)
    nb = lay.nb - 2 * lay.frame
    rs = [r for x in xs for r in x.split([nb * OW for OW, _ in sp])]
    hs = [h for _ in xs for _, h in sp]
    ext = _halo_edges([r.view(nb, -1) for r in rs], hs, group)
    pads = [torch.nn.functional.pad(e, (0, 0, lay.frame - h, lay.frame - h))
            for e, h in zip(ext, hs)]
    k = len(sp)
    return [torch.cat([e.reshape(-1) for e in pads[i * k : (i + 1) * k]])
            for i in range(len(xs))]


def _unframe(lay: WindowedLayout, y: torch.Tensor, spaces: str, group):
    """A framed layout's result (the ``spaces`` segments) -> the rank's owned
    vector: each space's sums over its owned blocks and the h blocks either
    side, merged with the neighbours' (``_combine_edges``)."""
    sp = _space_list(lay, spaces)
    F, nb = lay.frame, lay.nb - 2 * lay.frame
    accs = [seg.view(lay.nb, -1)[F - h : F + nb + h]
            for seg, (OW, h) in zip(y.split([lay.nb * OW for OW, _ in sp]), sp)]
    return torch.cat([m.reshape(-1) for m in _combine_edges(accs, [h for _, h in sp], group)])


def to_block_form(lay: WindowedLayout, cell_mat: torch.Tensor) -> torch.Tensor:
    """Natural cell matrices [nc, nl, nl] -> A_t [nl, nli, nb*Bmax].

    A_t[j, i, s] = cell_mat[cell_ids_flat[s], i, j] (row axis i padded to nli).
    """
    nl = cell_mat.shape[1]
    g = cell_mat[lay.cell_ids.reshape(-1).long()]  # [ncd, nl, nl]
    A_t = cell_mat.new_zeros((nl, lay.nli, lay.ncd))
    A_t[:, :nl, :] = g.permute(2, 1, 0)
    return A_t


def block_shape(lay: WindowedLayout, in_spaces: str, out_spaces: str) -> tuple[int, int]:
    """(n_in, n_out_padded) of a sub-block operator A_sub[j_in, i_out, ncd]."""
    n_in = (lay.dim * lay.k_v if "v" in in_spaces else 0) + (
        lay.k_p if "p" in in_spaces else 0
    )
    n_out = (lay.dim * lay.k_v if "v" in out_spaces else 0) + (
        lay.k_p if "p" in out_spaces else 0
    )
    return n_in, _round_up(n_out, 8)


def _space_slices(lay: WindowedLayout) -> dict:
    nvl = lay.dim * lay.k_v
    return {"v": slice(0, nvl), "p": slice(nvl, lay.nl), "vp": slice(0, lay.nl)}


def slice_block(lay: WindowedLayout, A_t: torch.Tensor, in_spaces: str, out_spaces: str) -> torch.Tensor:
    """Cut a sub-block operator [n_in, n_out_pad, ncd] out of A_t: the
    velocity block A00 (in="v", out="v"), the divergence B (in="v",
    out="p"), ..."""
    jsl = _space_slices(lay)
    isl = jsl[out_spaces]
    n_in, n_out_pad = block_shape(lay, in_spaces, out_spaces)
    out = A_t.new_zeros((n_in, n_out_pad, A_t.shape[2]))
    out[:, : isl.stop - isl.start, :] = A_t[jsl[in_spaces], isl, :]
    return out


# ---------------------------------------------------------------------------
# plain torch versions (the CPU path, and what the kernels are held against)
# ---------------------------------------------------------------------------


def _abs_loc(lay: WindowedLayout, hi, lo, offs, RVc, RW, k):
    """Absolute window positions [nb, Bmax, k] from rebased (hi, lo) + offs;
    sentinel slots map to RW*128 (one past the padded window)."""
    h = hi.transpose(1, 2)[:, :, :k].long()
    l = lo.transpose(1, 2)[:, :, :k].long()
    off = offs.long().repeat_interleave(lay.Bc, dim=1)[:, :, None]  # [nb, Bmax, 1]
    loc = (off + h) * 128 + l
    return torch.where((h >= RVc) | (l >= 128), torch.full_like(loc, RW * 128), loc)


def _locs(lay: WindowedLayout):
    lv = _abs_loc(lay, lay.loc_v_hi, lay.loc_v_lo, lay.offs_v, lay.RVv, lay.RWv, lay.k_v)
    lp = _abs_loc(lay, lay.loc_p_hi, lay.loc_p_lo, lay.offs_p, lay.RVp, lay.RWp, lay.k_p)
    return lv, lp


_POS16_SENTINEL = 0xFFFF  # a padded slot in a 16-bit packed table (int32: -1)


def pack_positions(lay: WindowedLayout):
    """The kernels' position tables: (pos_v [nb, k_v, Bmax], pos_p [nb, k_p,
    Bmax], cnt [nb] int32).

    pos holds the absolute window position of every local dof of every slot
    (``_abs_loc``'s arithmetic: (offs + hi)*128 + lo), or a sentinel for a
    padded slot.  Both tables are int16 holding the bits of a uint16
    (sentinel 0xFFFF) when both windows are shorter than 65,535 entries,
    else int32 (sentinel -1); ``unpack_positions`` undoes either.  cnt[b] is
    one past the last slot of block b with a position: the layout sorts
    padded slots last, so no slot from cnt[b] on has work."""
    Ws = ((2 * lay.hv + 1) * lay.OWv, (2 * lay.hp + 1) * lay.OWp)
    wide = max(Ws) >= _POS16_SENTINEL
    tables = []
    for (loc, RW), W in zip(zip(_locs(lay), (lay.RWv, lay.RWp)), Ws):
        pos = loc.transpose(1, 2)  # [nb, k, Bmax]
        pos = torch.where((pos >= RW * 128) | (pos >= W), torch.full_like(pos, -1), pos)
        tables.append(pos)
    filled = (tables[0] >= 0).any(dim=1) | (tables[1] >= 0).any(dim=1)  # [nb, Bmax]
    slots = torch.arange(1, lay.Bmax + 1, device=filled.device)
    cnt = (filled * slots).amax(dim=1).to(torch.int32)
    if wide:
        return (*(t.to(torch.int32).contiguous() for t in tables), cnt)
    # the bits of a uint16 in an int16: 0xFFFF for -1, p - 65536 from 32768 on
    return (*(t.to(torch.int16).contiguous() for t in tables), cnt)


def slot_colours(lay: WindowedLayout, pos_v: torch.Tensor, pos_p: torch.Tensor):
    """The round of every slot's sums in the kernels K1, K2 and K4, in 2D
    only (the 3D kernels sum through ``compact_tables``): (colour [nb, Bmax]
    uint8, ncolors).

    A greedy colouring of each chunk's occupied slots in slot order: a slot
    takes the least colour that no earlier slot of its chunk sharing a
    window position with it (velocity or pressure) has.  So no two slots of
    one colour in a chunk touch the same entry of its subwindows, and the
    kernels add one colour at a time with plain adds, in a fixed order (at
    most 256 colours).  Padded slots get colour 0 and are never summed.
    Cells that share a vertex share a P1 dof, so a P2/P1 triangle mesh needs
    about 8-14 colours and a tetrahedral one about 33-36.  numpy on the
    host, all chunks at once (slot j of every chunk in one step), in batches
    of chunks that keep the masks under ~64 MB."""
    nb, Bc, nch = lay.nb, lay.Bc, lay.nchunks
    Wv = (2 * lay.hv + 1) * lay.OWv
    Wp = (2 * lay.hp + 1) * lay.OWp
    pv = unpack_positions(pos_v).cpu().numpy()  # [nb, k_v, Bmax]
    pp = unpack_positions(pos_p).cpu().numpy()
    dump = Wv + Wp  # the column of every missing position, cleared each step
    keys = np.concatenate(
        [np.where(pv >= 0, pv, dump), np.where(pp >= 0, pp + Wv, dump)], axis=1
    )  # [nb, k, Bmax]
    k = keys.shape[1]
    keys = keys.reshape(nb, k, nch, Bc).transpose(0, 2, 3, 1).reshape(nb * nch, Bc, k)
    colour = np.zeros((nb * nch, Bc), dtype=np.uint8)
    words = 4  # colours taken at a position: 4 x 64 bits, as many as uint8 holds
    batch = max(1, (64 << 20) // (8 * words * (dump + 1)))
    full = np.uint64(0xFFFFFFFFFFFFFFFF)
    for lo in range(0, nb * nch, batch):
        kb = keys[lo : lo + batch]
        n = kb.shape[0]
        rows, first = np.arange(n)[:, None], np.arange(n)
        used = np.zeros((n, dump + 1, words), dtype=np.uint64)
        for j in range(Bc):
            kj = kb[:, j, :]
            taken = np.bitwise_or.reduce(used[rows, kj], axis=1)  # [n, words]
            w = np.argmin(taken == full, axis=1)  # the first word with a clear bit
            tw = taken[first, w]
            if (tw == full).any():
                raise ValueError("a chunk needs more than 256 slot colours")
            free = ~tw & (tw + np.uint64(1))  # its least clear bit
            colour[lo + first, j] = 64 * w + np.frexp(free.astype(np.float64))[1] - 1
            used[rows, kj, w[:, None]] |= free[:, None]
            used[:, dump] = 0
    colour = colour.reshape(nb, lay.Bmax)
    filled = (pv >= 0).any(axis=1) | (pp >= 0).any(axis=1)
    colour[~filled] = 0
    ncolors = int(colour.max()) + 1 if filled.any() else 0
    return torch.as_tensor(colour, device=pos_v.device), ncolors


def unpack_positions(pos: torch.Tensor) -> torch.Tensor:
    """int64 window positions of a packed table, -1 for padded slots."""
    if pos.dtype == torch.int16:
        p = pos.long() & 0xFFFF
        return torch.where(p == _POS16_SENTINEL, torch.full_like(p, -1), p)
    return pos.long()


# a block's shared memory on Hopper (windowed.cu kMaxSmemBytes)
_MAX_SMEM_BYTES = 232448
_SPAN_BASE_STAGES = 2  # windowed.cu kBaseStages


def span_smem_bytes(lay: WindowedLayout) -> int:
    """The shared memory of the 2D subwindow kernels' largest call at this
    layout (windowed.cu launch_matvec: K1 with float32 A): the chunk's
    subwindows of every component (dim*RVv + RVp rows of 128 floats) and
    the ring's two stages of its own (nl rows of Bc values of A).  K4
    (launch_scatter) takes the subwindows alone."""
    sub = 4 * 128 * (lay.dim * lay.RVv + lay.RVp)
    return sub + _SPAN_BASE_STAGES * 4 * (lay.dim * lay.k_v + lay.k_p) * lay.Bc


def check_span_smem(lay: WindowedLayout, meta) -> int:
    """``span_smem_bytes(lay)``, held against the library's own figure for
    the geometry record ``meta`` (windowed.cu ns_span_smem_bytes, the
    formula launch_matvec allocates by); raises where the two differ, so
    that the route is never chosen by a formula the kernels do not share."""
    host, card = span_smem_bytes(lay), _lib().ns_span_smem_bytes(meta)
    if card != host:
        raise RuntimeError(f"span_smem_bytes gives {host} bytes at this layout, windowed.cu's "
                           f"launch_matvec {card}: the route's formula has drifted")
    return card


def compact_layout(lay: WindowedLayout) -> bool:
    """Whether a 2D P2/P1 layout runs K1, K2 and K4 on the compact kernels
    (windowed.cu Geo.compact: matvec3_kernel + merge3_kernel, and
    scatter_rows_kernel): where the subwindow kernels' shared memory
    (``span_smem_bytes``) exceeds a block's, as along a Morton curve, whose
    chunks span most of their windows.  From the layout alone, before any
    launch; False on every other element (their kernels are fixed)."""
    return ((lay.dim, lay.k_v, lay.k_p) == (2, 6, 3)
            and span_smem_bytes(lay) > _MAX_SMEM_BYTES)


@dataclass(frozen=True)
class CompactSpace:
    """One space's tables of the 3D kernels (K1, K2 and K4 on tetrahedra).

    A chunk's ENTRIES are the distinct window positions its slots touch,
    sorted; the chunks' lists lie one after another, chunk (b, c) at piece
    b*nchunks + c.  A kernel sums a chunk's slots' values into its entries
    (``tr``: each entry's (slot, dof) pairs, slots ascending) and writes each
    entry's sum to its place ``dst`` in a scratch vector ordered by row; the
    merge sums a row's places ``row_ptr[r]:row_ptr[r+1]`` in order.  A row's
    places are its entries by block descending (the windows j = 0..2h of
    ``_combine_windows``), then chunk ascending.  int16 tables hold the bits
    of a uint16 (sentinel 0xFFFF)."""

    off: torch.Tensor  # [nb*nchunks + 1] int32: a chunk's first entry
    row: torch.Tensor  # [E] int32: the space's vector row of each entry
    dst: torch.Tensor  # [E] int32: its place in the row-ordered scratch
    idx: torch.Tensor  # [nb, k, Bmax] int16: a slot's dof's entry in its chunk's list
    tr_off: torch.Tensor  # [E + 1] int32: an entry's first (slot, dof) pair in tr
    tr: torch.Tensor  # [T] int16: the pairs, l*Bc + j (j: slot in its chunk)
    row_ptr: torch.Tensor  # [n + 1] int32: a row's first place in the scratch
    tr_rel: torch.Tensor  # [E] int16: an entry's first pair counted from its chunk's first
    at: torch.Tensor  # [E] int32: the entry at each place of the scratch (dst's inverse)
    max_entries: int  # the most entries of one chunk
    max_pairs: int  # the most (slot, dof) pairs of one chunk

    @property
    def E(self) -> int:
        return int(self.row.numel())

    def to(self, device) -> "CompactSpace":
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self) if not f.name.startswith("max_")})


def _compact_space(lay: WindowedLayout, pos: np.ndarray, k: int, OW: int, h: int,
                   n: int) -> CompactSpace:
    """``CompactSpace`` of one space from its window positions pos [nb, k,
    Bmax] (-1 for none), numpy on the host."""
    nb, nch, Bc = lay.nb, lay.nchunks, lay.Bc
    W = (2 * h + 1) * OW
    q = pos.reshape(nb, k, nch, Bc).transpose(0, 2, 3, 1)  # [nb, nchunks, Bc, k]
    b, c, j, l = np.nonzero(q >= 0)  # every (slot, dof) pair: by chunk, slot, dof
    piece = b * nch + c
    uniq, inv = np.unique(piece * np.int64(W) + q[b, c, j, l], return_inverse=True)
    inv = inv.reshape(-1)
    E = len(uniq)
    ent_piece, ent_pos = uniq // W, uniq % W
    off = np.searchsorted(ent_piece, np.arange(nb * nch + 1))
    max_e = int(np.diff(off).max()) if E else 0
    if max_e >= 0xFFFF or k * Bc > 0x10000:
        raise ValueError(f"a chunk's list ({max_e} entries, {k} x {Bc} slot dofs) does not "
                         "fit the compact kernels' 16-bit indices")
    idx = np.full((nb, nch, Bc, k), -1, dtype=np.int64)
    idx[b, c, j, l] = inv - off[piece]
    idx = idx.transpose(0, 3, 1, 2).reshape(nb, k, nch * Bc)
    # an entry's pairs in np.nonzero's order: slots ascending (a slot
    # touches a position once)
    by_entry = np.argsort(inv, kind="stable")
    tr = (l * Bc + j)[by_entry]
    tr_off = np.concatenate([[0], np.cumsum(np.bincount(inv, minlength=E))])
    eb, ec = ent_piece // nch, ent_piece % nch
    row = (eb - h) * OW + ent_pos
    if E and (row.min() < 0 or row.max() >= n):
        raise ValueError("a window position of an occupied slot lies off the vector")
    dst = np.empty(E, dtype=np.int64)
    dst[np.lexsort((ec, -eb, row))] = np.arange(E)
    row_ptr = np.concatenate([[0], np.cumsum(np.bincount(row, minlength=n))])

    def i32(a):
        return torch.as_tensor(np.ascontiguousarray(a, dtype=np.int32))

    def u16(a):
        return torch.as_tensor(np.ascontiguousarray(a.astype(np.uint16).view(np.int16)))

    tr_rel = tr_off[:-1] - tr_off[off[ent_piece]]
    at = np.empty(E, dtype=np.int64)
    at[dst] = np.arange(E)
    return CompactSpace(off=i32(off), row=i32(row), dst=i32(dst), idx=u16(idx),
                        tr_off=i32(tr_off), tr=u16(tr), row_ptr=i32(row_ptr), tr_rel=u16(tr_rel),
                        at=i32(at), max_entries=max_e,
                        max_pairs=int(np.diff(tr_off[off]).max()) if E else 0)


def compact_smem_bytes(lay: WindowedLayout, tabs: dict) -> int:
    """The least shared memory of the compact block kernel's largest call
    (windowed.cu launch_matvec_compact: K1 at P2/P1, K2 v->v on P3/P2
    tetrahedra, float32 A): the slots' outputs (nl rows of Bc floats, which
    the smallest ring of A also takes on tetrahedra; on triangles, whose
    15-row columns take the narrow rings, two stages of a column), and a
    region that holds x at the chunk's entries (dim rows of the velocity's,
    the pressure's) and later the chunk's (slot, dof) pairs with each
    entry's first pair (uint16s).  K4 (launch_scatter_3d) takes the rows and
    the pairs, so no more; on triangles it needs none (scatter_rows_kernel)."""
    v, p = tabs["v"], tabs["p"]
    xs = 4 * (lay.dim * v.max_entries + p.max_entries)
    pairs = 2 * (v.max_pairs + v.max_entries + 1 + p.max_pairs + p.max_entries + 1)
    rows = 4 * lay.nl * lay.Bc * (1 if lay.dim == 3 else 2)
    return rows + _round_up(max(xs, pairs), 16)


# the products (in_spaces, out_spaces) that the streaming kernel serves
# (windowed.cu stream_matvec_kernel, ``streams``), by element (dim, k_v,
# k_p): on P3/P2 triangles K1 and K2 v->v (their v->p and p->p stay on the
# 2D block kernel), on P3/P2 tetrahedra K1, K2 v->p and p->p (their v->v
# stays on the 3D block kernel)
_STREAM_PRODUCTS = {
    (2, 10, 6): (("vp", "vp"), ("v", "v")),
    (3, 20, 10): (("vp", "vp"), ("v", "p"), ("p", "p")),
}
_MAX_STREAM_STAGES = 16  # windowed.cu kMaxStreamStages
_STAGE_ROW_BYTES = 52  # windowed.cu kStageRowBytes


def streamed_products(lay: WindowedLayout) -> tuple:
    """The (in_spaces, out_spaces) products the streaming kernel serves at
    this layout's element (none at P2/P1)."""
    return _STREAM_PRODUCTS.get((lay.dim, lay.k_v, lay.k_p), ())


def streams(lay: WindowedLayout, in_spaces: str, out_spaces: str) -> bool:
    """Whether the product runs on the streaming kernel at this layout."""
    return (in_spaces, out_spaces) in streamed_products(lay)


def streams_k1(lay: WindowedLayout) -> bool:
    """Whether the layout's K1 is the streaming kernel (P3/P2)."""
    return streams(lay, "vp", "vp")


# the products (in_spaces, out_spaces) that the narrow kernels serve
# (windowed.cu narrow_product_kernel + narrow_merge_kernel, ``narrow``): K2
# v->p and p->p on P3/P2 triangles
_NARROW_PRODUCTS = {(2, 10, 6): (("v", "p"), ("p", "p"))}


def narrow_products(lay: WindowedLayout) -> tuple:
    """The (in_spaces, out_spaces) products the narrow kernels serve at this
    layout's element (none but on P3/P2 triangles)."""
    return _NARROW_PRODUCTS.get((lay.dim, lay.k_v, lay.k_p), ())


def narrow(lay: WindowedLayout, in_spaces: str, out_spaces: str) -> bool:
    """Whether the product runs on the narrow kernels at this layout."""
    return (in_spaces, out_spaces) in narrow_products(lay)


# the elements whose K4 is the row-ordered sum over R (windowed.cu
# scatter_rows_kernel, ``scatter_rows``): P3/P2 triangles and tetrahedra;
# P2/P1 keeps the chunk kernels and their merge but on compact 2D layouts
_SCATTER_ROWS = ((2, 10, 6), (3, 20, 10))


def scatter_rows(lay: WindowedLayout) -> bool:
    """Whether the layout's K4 is the row-ordered sum over R."""
    return (lay.dim, lay.k_v, lay.k_p) in _SCATTER_ROWS or compact_layout(lay)


def scatter_design(lay: WindowedLayout) -> str:
    """The CUDA kernels that serve K4 at this layout (windowed.cu
    scatter_any): the row-ordered sum at P3/P2 and on compact 2D P2/P1
    layouts (``compact_layout``)."""
    if scatter_rows(lay):
        return "scatter_rows_kernel"
    if lay.dim == 3:
        return "scatter3_kernel + merge3_kernel"
    return "scatter_kernel + merge_kernel<., true>"


def row_list(lay: WindowedLayout, tab: CompactSpace) -> tuple[torch.Tensor, torch.Tensor]:
    """One space's row list (windowed.cu narrow_merge_kernel: the
    pressure's; scatter_rows_kernel: both spaces'): ``compact_tables``'
    chain row_ptr -> at -> tr_off -> tr flattened once on the host.  (ptr
    [n + 1], list [T]) int32 on the host: row r's (slot, dof) pairs are
    list[ptr[r] : ptr[r + 1]], its places in order and each place's pairs in
    order (slots ascending), each as its index l*ncd + s into rows [k, ncd]
    of per-slot values (l < k, the space's dofs a cell: the narrow
    products' sums Y, or one component's rows of R), a place's first pair
    with bit 31 set: the order of ``_compact_scatter_reference``.  Raises
    ValueError where an index does not fit 31 bits."""
    nch, Bc = lay.nchunks, lay.Bc
    off, tr_off = (getattr(tab, f).cpu().numpy().astype(np.int64) for f in ("off", "tr_off"))
    at, row_ptr = (getattr(tab, f).cpu().numpy().astype(np.int64) for f in ("at", "row_ptr"))
    code = tab.tr.cpu().numpy().astype(np.int64) & 0xFFFF
    piece = np.repeat(np.arange(len(off) - 1), np.diff(off))[at]  # each place's chunk
    count = np.diff(tr_off)[at]  # each place's pairs
    start = np.concatenate([[0], np.cumsum(count)])  # each place's first pair in the list
    place = np.repeat(np.arange(len(at)), count)
    pair = tr_off[at][place] + np.arange(start[-1]) - start[place]
    slot = (piece // nch)[place] * lay.Bmax + (piece % nch)[place] * Bc + code[pair] % Bc
    index = (code[pair] // Bc) * lay.ncd + slot
    if index.size and index.max() >= 1 << 31:
        raise ValueError("a row list's indices into the per-slot rows do not fit 31 bits")
    index[start[:-1]] -= 1 << 31  # bit 31 of an int32: a place's first pair
    return (torch.as_tensor(start[row_ptr].astype(np.int32)),
            torch.as_tensor(index.astype(np.int32)))


def _rows(lay: WindowedLayout, spaces: str) -> int:
    return (lay.dim * lay.k_v if "v" in spaces else 0) + (lay.k_p if "p" in spaces else 0)


def stream_split(lay: WindowedLayout, elt: int, in_spaces: str = "vp",
                 out_spaces: str = "vp") -> int:
    """Stages a column of A takes in the streaming kernel (windowed.cu
    Streamed::SPLIT): two for K1 on tetrahedra with float32 A (elt 4), else
    one."""
    k1 = (in_spaces, out_spaces) == ("vp", "vp")
    return 2 if k1 and lay.dim == 3 and elt == 4 else 1


def stream_group(lay: WindowedLayout, elt: int, in_spaces: str = "vp",
                 out_spaces: str = "vp") -> int:
    """Columns of A a stage of the streaming kernel holds (windowed.cu
    Streamed::G): one for K1; for a block product the most that divide its
    in-rows and keep a slot's part of a stage within 52 bytes."""
    if (in_spaces, out_spaces) == ("vp", "vp"):
        return 1
    n_in, n_out = _rows(lay, in_spaces), _rows(lay, out_spaces)
    return max(g for g in range(1, n_in + 1)
               if n_in % g == 0 and (g == 1 or g * n_out * elt <= _STAGE_ROW_BYTES))


def stream_smem_bytes(lay: WindowedLayout, tabs: dict, elt: int, stages: int,
                      in_spaces: str = "vp", out_spaces: str = "vp") -> int:
    """The shared memory of a block of the streaming kernel (windowed.cu
    stream_smem) for a product with A of elt bytes a value and a ring of
    ``stages`` stages: the ring's mbarriers; x (K1: the slots' x values, nl
    rows of Bc floats; a block product: x at a chunk's entries of the
    in-spaces, dim floats a velocity entry and one a pressure entry, then
    the entries' rows, one int32 each); one output component's values (k_v
    rows of Bc floats where the velocity is an out-space, else k_p); the
    chunk's (slot, dof) pairs and entry offsets of each out-space (uint16,
    one spare each; two buffers of them for a block product, which stages
    the next chunk's while it sums one); each part rounded up to 128 bytes;
    then the stages of G columns of the out-spaces' rows (half of them:
    ``stream_split``) of Bc values of A."""
    k1 = (in_spaces, out_spaces) == ("vp", "vp")
    ents = {s: tabs[s].max_entries if s in in_spaces else 0 for s in "vp"}
    parts = [2 * 8 * _MAX_STREAM_STAGES]
    if k1:
        parts.append(4 * lay.nl * lay.Bc)
    else:
        parts += [4 * (lay.dim * ents["v"] + ents["p"]), 4 * (ents["v"] + ents["p"])]
    parts.append(4 * (lay.k_v if "v" in out_spaces else lay.k_p) * lay.Bc)
    pairs = [b for s in "vp" if s in out_spaces
             for b in (2 * (tabs[s].max_pairs + 2), 2 * (tabs[s].max_entries + 2))]
    fixed = sum(_round_up(b, 128) for b in parts + (1 if k1 else 2) * pairs)
    rows = (stream_group(lay, elt, in_spaces, out_spaces) * _rows(lay, out_spaces)
            // stream_split(lay, elt, in_spaces, out_spaces))
    return fixed + stages * rows * lay.Bc * elt


def stream_work(lay: WindowedLayout, cnt: torch.Tensor) -> torch.Tensor:
    """The streaming kernel's work list: the occupied chunks (pieces b*nchunks
    + c with a slot below cnt[b]), most occupied slots first, then by
    piece; int32 on the host."""
    nv = (cnt.cpu().long()[:, None] - lay.Bc * torch.arange(lay.nchunks)[None, :]).clamp(0, lay.Bc)
    nv = nv.reshape(-1).numpy()
    piece = np.nonzero(nv)[0]
    order = np.lexsort((piece, -nv[piece]))
    return torch.as_tensor(piece[order].astype(np.int32))


def stream_records(lay: WindowedLayout, cnt: torch.Tensor, tabs: dict,
                   work: torch.Tensor | None = None) -> torch.Tensor:
    """The streaming kernel's work records (windowed.cu WorkRec): for each
    chunk of the work list (``stream_work``), in its order, the piece, its
    occupied slots, then per space (velocity, pressure) the chunk's first
    entry, its entries, its first (slot, dof) pair and its pairs, then each
    space's pairs in all; int32 [n_work, 12] on the host."""
    work = stream_work(lay, cnt) if work is None else work
    piece = work.cpu().numpy().astype(np.int64)
    nv = np.clip(cnt.cpu().numpy().astype(np.int64)[piece // lay.nchunks]
                 - (piece % lay.nchunks) * lay.Bc, 0, lay.Bc)
    cols = [piece, nv]
    totals = []
    for key in "vp":
        off, tr_off = (getattr(tabs[key], f).cpu().numpy().astype(np.int64)
                       for f in ("off", "tr_off"))
        e0, e1 = off[piece], off[piece + 1]
        cols += [e0, e1 - e0, tr_off[e0], tr_off[e1] - tr_off[e0]]
        totals.append(np.full_like(piece, tr_off[-1]))
    return torch.as_tensor(np.stack(cols + totals, axis=1).astype(np.int32))


def compact_tables(lay: WindowedLayout) -> dict:
    """{"v": CompactSpace, "p": CompactSpace}: the compact kernels' tables
    (K1, K2 and K4 on tetrahedra, on P3/P2 triangles and on compact 2D
    P2/P1 layouts), made once per layout with numpy (on the layout's
    device).  Raises ValueError where a chunk's lists exceed what the
    kernels take: 16-bit indices, and a block's shared memory
    (``compact_smem_bytes`` on tetrahedra and compact 2D P2/P1 layouts; on
    the P3/P2 elements also ``stream_smem_bytes`` of every streamed product
    with a 2-stage ring of float32 A)."""
    pos_v, pos_p, _ = pack_positions(lay)
    tabs = {
        key: _compact_space(lay, unpack_positions(pos).cpu().numpy(), k, OW, h, n)
        for key, pos, k, OW, h, n in (("v", pos_v, lay.k_v, lay.OWv, lay.hv, lay.n_vs),
                                      ("p", pos_p, lay.k_p, lay.OWp, lay.hp, lay.n_ps))
    }
    needs = [compact_smem_bytes(lay, tabs)] if lay.dim == 3 or compact_layout(lay) else []
    needs += [stream_smem_bytes(lay, tabs, 4, 2, i, o) for i, o in streamed_products(lay)]
    need = max(needs, default=0)
    if need > _MAX_SMEM_BYTES:
        v, p = tabs["v"], tabs["p"]
        raise ValueError(
            f"the compact kernels cannot take this layout: a chunk of {lay.Bc} slots touches up "
            f"to {v.max_entries} velocity and {p.max_entries} pressure positions through up to "
            f"{v.max_pairs} and {p.max_pairs} (slot, dof) pairs, so a block needs {need} bytes "
            f"of shared memory against the {_MAX_SMEM_BYTES} it may use")
    return {key: t.to(lay.device) for key, t in tabs.items()}


def _gather_reference(lay: WindowedLayout, x: torch.Tensor, group=None) -> torch.Tensor:
    """X[l, s] = x[dof_l of slot s] through real gathers.  With ``group``,
    x is the rank's owned vector and lay its framed layout (``_frame``)."""
    if group is not None:
        (x,) = _frame(lay, "vp", group, x)
    xw = _all_windows(lay, x)
    lv, lp = _locs(lay)

    def take(w, loc):
        w = w.reshape(lay.nb, -1)
        w = torch.cat([w, w.new_zeros((lay.nb, 1))], dim=1)  # sentinel column
        return torch.gather(w, 1, loc.reshape(lay.nb, -1)).reshape(loc.shape)

    cols = [take(xw[c], lv) for c in range(lay.dim)] + [take(xw[-1], lp)]
    X = torch.cat(cols, dim=2)  # [nb, Bmax, nl]
    Xp = x.new_zeros((lay.nli, lay.ncd))
    Xp[: lay.nl, :] = X.reshape(lay.ncd, lay.nl).T
    return Xp


def _scatter_reference(lay: WindowedLayout, R: torch.Tensor, group=None) -> torch.Tensor:
    """y = sum_cells P_c^T R_c through per-block windows and their merge.
    With ``group``, lay is the rank's framed layout and y its owned vector
    (``_unframe``)."""
    lv, lp = _locs(lay)
    Rn = R[: lay.nl].T.reshape(lay.nb, lay.Bmax, lay.nl)

    def scatter_space(loc, vals, OW, h, n, RW):
        # accumulate per-block WINDOWS (one extra dump column absorbs the
        # sentinel positions RW*128), then merge the overlaps
        flat = torch.arange(lay.nb, device=loc.device)[:, None, None] * (
            RW * 128 + 1
        ) + loc.clamp(max=RW * 128)
        win = vals.new_zeros(lay.nb * (RW * 128 + 1))
        win.index_add_(0, flat.reshape(-1), vals.reshape(-1))
        win = win.reshape(lay.nb, RW * 128 + 1)[:, : RW * 128]
        return _combine_windows(win, lay.nb, OW, h, n)

    ys = [
        scatter_space(
            lv, Rn[:, :, c * lay.k_v : (c + 1) * lay.k_v], lay.OWv, lay.hv,
            lay.n_vs, lay.RWv,
        )
        for c in range(lay.dim)
    ]
    yp = scatter_space(
        lp, Rn[:, :, lay.dim * lay.k_v :], lay.OWp, lay.hp, lay.n_ps, lay.RWp
    )
    y = torch.cat(ys + [yp])
    return y if group is None else _unframe(lay, y, "vp", group)


def _merge_reference(sub, offs, cnt, Bc, nb, OW, h, n):
    """Plain version of the merge kernel: accumulators sub [..., nb, nsub,
    len] -> the space's vector [..., n].

    Entry d of piece c of block b is window position offs[b, c]*128 + d
    (offs None: whole windows, one piece from 0); piece c of block b counts
    only if cnt[b] > c*Bc (cnt None: always).  Row r = b*OW + o is, for j =
    0..2h in turn, the entry at window position j*OW + o of block b + h - j,
    itself the sum of that window's pieces in order.  For whole windows this
    is ``_combine_windows``."""
    nsub, length = sub.shape[-2:]
    r = torch.arange(n, device=sub.device)
    b, o = r // OW, r % OW
    acc = sub.new_zeros((*sub.shape[:-3], n))
    for j in range(2 * h + 1):
        bp = b + h - j
        ok = (bp >= 0) & (bp < nb)
        bpc = bp.clamp(0, nb - 1)
        pos = j * OW + o
        s = torch.zeros_like(acc)
        for c in range(nsub):
            d = pos if offs is None else pos - offs[bpc, c].long() * 128
            take = ok & (d >= 0) & (d < length)
            if cnt is not None:
                take = take & (cnt[bpc] > c * Bc)
            val = sub[..., bpc, c, d.clamp(0, length - 1)]
            s = s + torch.where(take, val, torch.zeros_like(val))
        acc = acc + s
    return acc


def _scatter_chunked_reference(lay: WindowedLayout, R: torch.Tensor) -> torch.Tensor:
    """``_scatter_reference`` in the kernels' order: every chunk sums its
    slots' rows into its own subwindow (packed positions less the chunk's
    offset), then ``_merge_reference`` sums the subwindows that cover each
    row.  This is the plain version of K4 in 2D, and of what K1 and K2 do
    there after their contraction."""
    pos_v, pos_p, cnt = pack_positions(lay)
    Rn = R[: lay.nl].reshape(lay.nl, lay.nb, lay.nchunks, lay.Bc)
    nv = lay.dim * lay.k_v

    def space(pos, offs, rows, RVc, OW, h, n):
        # rows [ncomp, k, nb, nchunks, Bc] -> sub [ncomp, nb, nchunks, RVc*128]
        length = RVc * 128
        p = unpack_positions(pos).reshape(lay.nb, -1, lay.nchunks, lay.Bc).permute(1, 0, 2, 3)
        d = p - offs.long()[None, :, :, None] * 128
        d = torch.where((p >= 0) & (d >= 0) & (d < length), d, torch.full_like(d, length))
        piece = torch.arange(lay.nb * lay.nchunks, device=d.device).reshape(1, lay.nb, lay.nchunks, 1)
        flat = (piece * (length + 1) + d).reshape(-1)  # one dump entry a piece
        subs = []
        for vals in rows:
            sub = vals.new_zeros(lay.nb * lay.nchunks * (length + 1))
            sub.index_add_(0, flat, vals.reshape(-1))
            subs.append(sub.reshape(lay.nb, lay.nchunks, length + 1)[:, :, :length])
        return _merge_reference(torch.stack(subs), offs, cnt, lay.Bc, lay.nb, OW, h, n)

    yv = space(pos_v, lay.offs_v, Rn[:nv].reshape(lay.dim, lay.k_v, *Rn.shape[1:]),
               lay.RVv, lay.OWv, lay.hv, lay.n_vs)
    yp = space(pos_p, lay.offs_p, Rn[nv:][None], lay.RVp, lay.OWp, lay.hp, lay.n_ps)
    return torch.cat([yv.reshape(-1), yp.reshape(-1)])


def _compact_matvec_reference(lay: WindowedLayout, A_sub: torch.Tensor, x: torch.Tensor,
                              in_spaces: str, out_spaces: str, tables=None) -> torch.Tensor:
    """``windowed_matvec_reference`` / ``_block_reference`` in the 3D matvec
    kernel's order, through ``compact_tables``: x at every chunk's entries,
    each slot's values through its entry indices, the contraction, then each
    chunk's sums at its entries (their (slot, dof) pairs in order) written
    to their places in the row-ordered scratch, then the merge of each
    row's places in order (``_compact_scatter_reference``).  The plain
    version of K1 and K2 in 3D and of K1 and K2 at P3/P2 on triangles too
    (the streaming kernel gathers x a slot at a time for K1 and at the
    chunk's entries for K2 v->v, the narrow kernels a slot at a time for
    K2 v->p and p->p: the same values; ``_narrow_product_reference`` and
    ``_row_walk_reference`` give its bits there); x and the result are
    the in- and out-spaces' planar segments."""
    tabs = compact_tables(lay) if tables is None else tables
    nb, nch, Bc, Bmax = lay.nb, lay.nchunks, lay.Bc, lay.Bmax
    k = {"v": lay.k_v, "p": lay.k_p}
    ncomp = {"v": lay.dim, "p": 1}
    n = {"v": lay.n_vs, "p": lay.n_ps}
    dev = x.device
    piece = (torch.arange(nb, device=dev)[:, None] * nch
             + torch.arange(Bmax, device=dev)[None, :] // Bc)  # [nb, Bmax]
    cols, at = [], 0
    for s in (s for s in "vp" if s in in_spaces):
        t = tabs[s]
        seg = x[at : at + ncomp[s] * n[s]].reshape(ncomp[s], n[s])
        at += ncomp[s] * n[s]
        xe = seg[:, t.row.long()]  # [ncomp, E]: x at every chunk's entries
        local = t.idx.long() & 0xFFFF  # [nb, k, Bmax]
        ok = local != 0xFFFF
        ent = torch.where(ok, t.off.long()[piece][:, None, :] + local, 0)
        for cc in range(ncomp[s]):
            v = torch.where(ok, xe[cc][ent], torch.zeros((), dtype=x.dtype, device=dev))
            cols.append(v.permute(1, 0, 2).reshape(k[s], lay.ncd))
    X = torch.cat(cols)
    outs = [s for s in "vp" if s in out_spaces]
    n_out = sum(ncomp[s] * k[s] for s in outs)
    Y = _contract(A_sub[:, :n_out], X)  # [n_out, ncd]
    return _compact_scatter_reference(lay, Y, tabs, out_spaces)


def _compact_scatter_reference(lay: WindowedLayout, R: torch.Tensor, tables=None,
                               out_spaces: str = "vp") -> torch.Tensor:
    """``_scatter_reference`` in the 3D kernels' order, through
    ``compact_tables``: each chunk's sums at its entries (their (slot, dof)
    pairs in order, slots ascending) written to their places in the
    row-ordered scratch, then each row's places summed in order.  R holds
    the out-spaces' rows (velocity components, then pressure; [>= nl, ncd]
    for "vp"); the result is their planar segment.  The plain version of K4
    in 3D, and of what K1 and K2 do there after their contraction."""
    tabs = compact_tables(lay) if tables is None else tables
    nch, Bc, Bmax = lay.nchunks, lay.Bc, lay.Bmax
    dev = R.device
    ys, r0 = [], 0
    for s in (s for s in "vp" if s in out_spaces):
        t = tabs[s]
        k, ncomp, n = (lay.k_v, lay.dim, lay.n_vs) if s == "v" else (lay.k_p, 1, lay.n_ps)
        ent_of = torch.repeat_interleave(torch.arange(t.E, device=dev), torch.diff(t.tr_off.long()))
        ent_piece = torch.searchsorted(t.off.long(), torch.arange(t.E, device=dev), right=True) - 1
        code = t.tr.long() & 0xFFFF
        p = ent_piece[ent_of]
        col = (p // nch) * Bmax + (p % nch) * Bc + code % Bc  # the pair's slot
        place_row = torch.repeat_interleave(torch.arange(n, device=dev),
                                            torch.diff(t.row_ptr.long()))
        for cc in range(ncomp):
            sums = R.new_zeros(t.E).index_add_(0, ent_of, R[r0 + cc * k + code // Bc, col])
            scratch = torch.empty_like(sums)
            scratch[t.dst.long()] = sums
            ys.append(R.new_zeros(n).index_add_(0, place_row, scratch))
        r0 += ncomp * k
    return torch.cat(ys)


def _narrow_product_reference(lay: WindowedLayout, A_sub: torch.Tensor, x: torch.Tensor,
                              in_spaces: str) -> torch.Tensor:
    """Plain version of narrow_product_kernel (K2 v->p or p->p): the
    slots' pressure sums Y [k_p, ncd] of A_sub [n_in, n_out_pad, ncd], x
    (the in-space's planar segment) gathered at each slot's positions, the
    columns q ascending (``_contract``); zero in padded slots."""
    xf = x.new_zeros(lay.n_u + lay.n_ps)
    if in_spaces == "v":
        xf[: lay.n_u] = x
    else:
        xf[lay.n_u :] = x
    X = _gather_reference(lay, xf)[_space_slices(lay)[in_spaces]]
    return _contract(A_sub[:, : lay.k_p], X)


def _row_walk_reference(ptr: torch.Tensor, lst: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
    """Plain version of a thread's walk of its row list in
    narrow_merge_kernel and scatter_rows_kernel, all rows at once, one pair
    at a time: a place's sum starts at 0 and adds its pairs in order; at
    the next place's first pair (bit 31) the row's sum takes it; the row is
    its sum plus the last place's.  Over the row list (ptr, lst) of
    ``row_list`` and Y [k, ncd] (the narrow products' sums, or one
    component's rows of R).  The same float32 additions in the same order
    on any device: ``_compact_scatter_reference``'s bits."""
    dev = Y.device
    ptr, code = ptr.to(dev).long(), lst.to(dev).long()
    start, count = ptr[:-1], torch.diff(ptr)
    flat = Y.reshape(-1)
    acc, s = Y.new_zeros(count.numel()), Y.new_zeros(count.numel())
    for k in range(int(count.max()) if count.numel() else 0):
        live = count > k
        c = code[torch.where(live, start + k, 0)]
        nxt = live & (c < 0) & (k > 0)  # the next place's first pair
        acc = torch.where(nxt, acc + s, acc)
        s = torch.where(nxt, torch.zeros_like(s), s)
        s = torch.where(live, s + flat[c & 0x7FFFFFFF], s)
    return acc + s


def _scatter_rows_reference(lay: WindowedLayout, R: torch.Tensor, rows: dict) -> torch.Tensor:
    """Plain version of scatter_rows_kernel (K4 on the P3/P2 elements): each
    velocity component's rows of R [>= nl, ncd] walked through the
    velocity's row list, then the pressure's rows through the pressure's
    (rows: {"v": (ptr, list), "p": (ptr, list)} of ``row_list``;
    ``_row_walk_reference``).  The planar vector, ``_compact_scatter_reference``'s
    bits."""
    nv = lay.dim * lay.k_v
    ys = [_row_walk_reference(*rows["v"], R[cc * lay.k_v : (cc + 1) * lay.k_v])
          for cc in range(lay.dim)]
    return torch.cat(ys + [_row_walk_reference(*rows["p"], R[nv : nv + lay.k_p])])


def _contract(A: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """y[i, s] = sum_j A[j, i, s] X[j, s], j in order, A widened to X's
    dtype on read (a bf16 operator).  One multiply-add a j: torch.einsum's
    batched products of one slot each are ten times slower on the CPU."""
    y = A[0].to(X.dtype) * X[0]
    for j in range(1, A.shape[0]):
        y = y.addcmul(A[j].to(X.dtype), X[j])
    return y


def windowed_matvec_reference(
    lay: WindowedLayout, A_t: torch.Tensor, x: torch.Tensor, group=None
) -> torch.Tensor:
    """Plain same-math version of the windowed matvec (real gathers)."""
    X = _gather_reference(lay, x, group)  # [nli, ncd]
    # A_t may be stored narrower than x (bf16 operator): widen like the kernel
    yl = _contract(A_t[:, : lay.nl, :], X[: lay.nl])
    return _scatter_reference(lay, yl, group)


def _block_reference(lay, A_sub, x, in_spaces, out_spaces, group=None):
    """Plain same-math version of the block matvec (x and the result: the
    in- and out-spaces' segments of the layout's vector, or with ``group``
    of the rank's owned vector)."""
    own = group is not None
    n_u = lay.dim * (lay.nvs_own if own else lay.n_vs)
    n_loc = n_u + (lay.nps_own if own else lay.n_ps)
    if in_spaces == "v":
        xf = x.new_zeros(n_loc)
        xf[:n_u] = x
    elif in_spaces == "p":
        xf = x.new_zeros(n_loc)
        xf[n_u:] = x
    else:
        xf = x
    X = _gather_reference(lay, xf, group)  # [nli, ncd]
    jsl = _space_slices(lay)
    yl = _contract(A_sub, X[jsl[in_spaces]])
    R = yl.new_zeros((lay.nli, lay.ncd))
    osl = jsl[out_spaces]
    R[osl] = yl[: osl.stop - osl.start]
    yf = _scatter_reference(lay, R, group)
    if out_spaces == "v":
        return yf[:n_u]
    if out_spaces == "p":
        return yf[n_u:]
    return yf


# ---------------------------------------------------------------------------
# the CUDA kernels (csrc/windowed.cu), built with nvcc at first use
# ---------------------------------------------------------------------------

_PKG = Path(__file__).resolve().parents[1]
_SOURCE = _PKG / "csrc" / "windowed.cu"
_BUILD_DIR = _PKG.parent / "build" / "kernels"
_NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
_SPACE_CODE = {"v": 1, "p": 2, "vp": 3}
# the elements the kernels are instantiated for: (dim, k_v, k_p) of
# Taylor-Hood P2/P1 and P3/P2 on triangles and on tetrahedra
_ELEMENTS = ((2, 6, 3), (2, 10, 6), (3, 10, 4), (3, 20, 10))
# what the entry points return besides 0 and cudaError_t values (windowed.cu)
_KERNEL_ERRORS = {
    -1: "the layout is not one the kernels are built for (P2/P1 or P3/P2 on "
        "triangles or tetrahedra, chunks of at most 1024 slots for P2/P1 "
        "triangles, 512 for P3/P2 triangles and P2/P1 tetrahedra and 256 for "
        "P3/P2 tetrahedra, whose rows of A are 16-byte multiples; the gather, "
        "the scatter, the 3D products and the P3/P2 K1 and K2 take whole warps: a "
        "multiple of 32 slots)",
    -2: "a block would need more shared memory than it may use",
    -3: "the operand's storage (A, X, or R in 3D) is not 16-byte aligned",
}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = shutil.which("nvcc") or os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(f"nvcc not found (looked on PATH and under {home})")
    return path


def build_library(source: Path, stem: str) -> dict:
    """Compile one CUDA source of ``csrc/`` into ``build/kernels/`` unless a
    library built from the same source and flags is there.  Returns the
    library path, the nvcc command and output, and the build time in seconds
    (``cmd`` None and 0 s when the library was already built).  Builds of
    different sources may run at the same time (each is one nvcc process)."""
    tag = hashlib.sha1(source.read_bytes() + " ".join(_NVCC_FLAGS).encode())
    lib = _BUILD_DIR / f"lib{stem}_{tag.hexdigest()[:16]}.so"
    info = {"path": str(lib), "cmd": None, "log": "", "seconds": 0.0}
    if not lib.exists():
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *_NVCC_FLAGS, "-o", str(tmp), str(source)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        info.update(cmd=cmd, log=proc.stdout + proc.stderr,
                    seconds=time.perf_counter() - t0)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{info['log']}")
        os.replace(tmp, lib)
    return info


def build_kernels() -> dict:
    """Build ``csrc/windowed.cu`` (``build_library``) and load it."""
    info = build_library(_SOURCE, "ns_windowed")
    _load(info["path"])
    return info


@functools.lru_cache(maxsize=1)
def _lib():
    """The loaded kernel library, built at first use."""
    return _load(build_kernels()["path"])


@functools.lru_cache(maxsize=None)
def _load(path: str):
    lib = ctypes.CDLL(path)
    p, i = ctypes.c_void_p, ctypes.c_int
    meta = ctypes.POINTER(ctypes.c_int)
    tables = [p] * 6
    lib.ns_scratch_floats.argtypes = [meta, p]
    lib.ns_scratch_floats.restype = ctypes.c_long
    lib.ns_span_smem_bytes.argtypes = [meta]
    lib.ns_span_smem_bytes.restype = ctypes.c_long
    lib.ns_gather.argtypes = [meta, *tables, p, p, p, i, i, p]
    lib.ns_scatter.argtypes = [meta, *tables, p, p, p, p, p]
    lib.ns_matvec.argtypes = [meta, *tables, p, p, i, i, i, i, p, p, p, p]
    lib.ns_stream_config.argtypes = [meta, p, i, i, i, p]
    for fn in (lib.ns_gather, lib.ns_scatter, lib.ns_matvec, lib.ns_stream_config):
        fn.restype = i
    return lib


class _Packed:
    """What the CUDA entry points take of one layout, made once: the geometry
    record (struct Geo, windowed.cu; its last value ``compact_layout``),
    the packed tables of ``pack_positions``, in 2D the slot colours of
    ``slot_colours`` (``colour`` None and ``ncolors`` 0 in 3D and on compact
    2D P2/P1 layouts, whose kernels sum in the order of
    ``compact_tables``: a null table), the leading arguments of every call
    and, for the 3D K1, K2 and K4, the P3/P2 K1 and K2 and every K1, K2 and
    K4 of a compact 2D P2/P1 layout, the tables of ``compact_tables`` (made
    at the first call of one of them; at P3/P2 and on compact layouts with
    the row lists of the narrow merge and of K4).
    Scratch is kept per stream (calls on one stream run in turn, so they
    can share it; CUDA graphs captured on one capture stream share theirs,
    so replay them on one stream at a time): in 2D the chunk subwindows and
    K4's span tables (on P3/P2 triangles, whose K4 needs none, the larger
    of the compact vector, which K1 and K2 v->v write there, and the narrow
    products' sums Y, k_p*ncd floats), in 3D and on compact 2D P2/P1
    layouts the row-ordered compact vector, dim*E_v + E_p floats."""

    def __init__(self, lay: WindowedLayout):
        self._lay = lay
        self.compact_layout = compact_layout(lay)
        self.pos_v, self.pos_p, self.cnt = pack_positions(lay)
        self.colour, self.ncolors = (slot_colours(lay, self.pos_v, self.pos_p)
                                     if lay.dim == 2 and not self.compact_layout else (None, 0))
        vals = [
            lay.nb, lay.Bmax, lay.Bc, lay.nchunks,
            lay.dim, lay.k_v, lay.k_p,
            lay.OWv, lay.OWp, lay.hv, lay.hp, lay.RVv, lay.RVp,
            lay.n_vs, lay.n_ps, lay.ncd,
            int(self.pos_v.dtype == torch.int32), self.ncolors, int(self.compact_layout),
        ]
        self.meta = (ctypes.c_int * (len(vals) + 1))(len(vals), *vals)
        self.args = (
            self.meta, self.pos_v.data_ptr(), self.pos_p.data_ptr(),
            lay.offs_v.data_ptr(), lay.offs_p.data_ptr(), self.cnt.data_ptr(),
            None if self.colour is None else self.colour.data_ptr(),
        )
        self._device = lay.device
        self._scratch = {}

    @cached_property
    def compact_args(self):
        """The ``compact`` argument of ns_matvec, ns_scatter and
        ns_scratch_floats: per space (velocity, then pressure) the addresses
        of the 9 tables of ``compact_tables`` (kept in ``self.compact``), E
        and the most entries and pairs of a chunk (struct Compact,
        windowed.cu), then the streaming kernel's work records
        (``stream_records`` of ``stream_work``'s list, kept in
        ``self.records``; the list in ``self.work``): their address and
        number; then the row lists (``row_list``, kept in ``self.rows``,
        {"v": (ptr, list) or None, "p": ...}) of the pressure, where the
        narrow merge or K4 reads it, and of the velocity, where K4 reads it
        (``scatter_rows``): their two addresses each, two zeros for a list
        the layout has none of.  Made for every 3D layout, for P3/P2
        triangles and for compact 2D P2/P1 layouts; None on other P2/P1
        triangle layouts."""
        if self._lay.dim != 3 and not streams_k1(self._lay) and not self.compact_layout:
            return None
        self.compact = compact_tables(self._lay)
        self.work = stream_work(self._lay, self.cnt)
        self.records = stream_records(self._lay, self.cnt, self.compact,
                                      self.work).to(self._device)
        lists = {"v": scatter_rows(self._lay),
                 "p": scatter_rows(self._lay) or bool(narrow_products(self._lay))}
        self.rows = {key: tuple(t.to(self._device) for t in row_list(self._lay, self.compact[key]))
                     if want else None for key, want in lists.items()}
        vals = []
        for t in (self.compact["v"], self.compact["p"]):
            vals += [getattr(t, name).data_ptr()
                     for name in ("off", "row", "dst", "idx", "tr_off", "tr", "row_ptr", "tr_rel",
                                  "at")]
            vals += [t.E, t.max_entries, t.max_pairs]
        vals += [self.records.data_ptr(), self.records.shape[0]]
        for key in "pv":
            vals += [t.data_ptr() for t in self.rows[key]] if self.rows[key] else [0, 0]
        return (ctypes.c_int64 * len(vals))(*vals)

    def scratch(self, stream: int) -> int:
        """Address of this stream's scratch (allocated at first use, of the
        size the library asks for)."""
        buf = self._scratch.get(stream)
        if buf is None:
            if self._lay.dim == 2:
                check_span_smem(self._lay, self.meta)
            n = _lib().ns_scratch_floats(self.meta, self.compact_args)
            if n < 0:
                _raise_on(n, "ns_scratch_floats")
            buf = torch.empty(n, dtype=torch.float32, device=self._device)
            self._scratch[stream] = buf
        return buf.data_ptr()


def _check_cuda(lay: WindowedLayout, *tensors):
    """Raise unless the kernels can take these tensors as they are."""
    dev = tensors[0].device
    if lay.device != dev:
        raise ValueError(f"layout on {lay.device}, tensors on {dev}")
    if (lay.dim, lay.k_v, lay.k_p) not in _ELEMENTS:
        raise NotImplementedError(
            "the CUDA windowed kernels are built for Taylor-Hood P2/P1 and P3/P2 "
            f"on triangles and tetrahedra, (dim, k_v, k_p) in {_ELEMENTS}; got "
            f"{(lay.dim, lay.k_v, lay.k_p)}"
        )
    for t in tensors:
        if t.device != dev or not t.is_contiguous():
            raise ValueError("kernel operands must be contiguous and on one device")


def _check_vec(x: torch.Tensor, n: int):
    if x.dtype != torch.float32 or x.shape != (n,):
        raise TypeError(
            f"kernel vector must be float32 of shape ({n},); got {x.dtype} {tuple(x.shape)}"
        )


def _raise_on(err: int, name: str):
    if err != 0:
        what = _KERNEL_ERRORS.get(err, f"cudaError {err}")
        raise RuntimeError(f"CUDA kernel {name} failed: {what}")


def _launch_matvec(lay, A, x, in_spaces, out_spaces, n_out_pad):
    _check_cuda(lay, A, x)
    if A.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"kernel operator must be float32 or bfloat16; got {A.dtype}")
    n_in = block_shape(lay, in_spaces, out_spaces)[0]
    if tuple(A.shape) != (n_in, n_out_pad, lay.ncd):
        raise ValueError(f"operator shape {tuple(A.shape)} != {(n_in, n_out_pad, lay.ncd)}")
    n_x = (lay.n_u if "v" in in_spaces else 0) + (lay.n_ps if "p" in in_spaces else 0)
    _check_vec(x, n_x)
    n_y = (lay.n_u if "v" in out_spaces else 0) + (lay.n_ps if "p" in out_spaces else 0)
    y = torch.empty(n_y, dtype=torch.float32, device=x.device)
    pk = lay._packed
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _lib().ns_matvec(
        *pk.args, pk.compact_args, A.data_ptr(), int(A.dtype == torch.bfloat16),
        _SPACE_CODE[in_spaces], _SPACE_CODE[out_spaces], n_out_pad,
        x.data_ptr(), pk.scratch(stream), y.data_ptr(), stream,
    )
    _raise_on(err, f"ns_matvec({in_spaces}->{out_spaces})")
    return y


def stream_config(lay: WindowedLayout, dtype: torch.dtype, in_spaces: str = "vp",
                  out_spaces: str = "vp") -> dict:
    """How the streaming kernel launches a product at this P3/P2 layout (on
    the card) with A of ``dtype`` (bfloat16 or float32): its ring (stages,
    bytes a stage), the shared memory a block takes, the resident blocks an
    SM and the persistent grid (windowed.cu ns_stream_config), and the
    occupied chunks the grid walks."""
    if not streams(lay, in_spaces, out_spaces):
        raise ValueError(f"no streaming {in_spaces}->{out_spaces} product for (dim, k_v, k_p) "
                         f"{(lay.dim, lay.k_v, lay.k_p)}")
    pk = lay._packed
    out = (ctypes.c_int * 5)()
    _raise_on(_lib().ns_stream_config(pk.meta, pk.compact_args, int(dtype == torch.bfloat16),
                                      _SPACE_CODE[in_spaces], _SPACE_CODE[out_spaces], out),
              "ns_stream_config")
    keys = ("stages", "stage_bytes", "smem_bytes", "blocks_per_sm", "grid")
    return dict(zip(keys, list(out)), chunks=int(pk.work.numel()))


def matvec_design(lay: WindowedLayout, in_spaces: str, out_spaces: str) -> str:
    """The CUDA kernels that serve a product (K1: "vp"->"vp"; K2) at this
    layout (windowed.cu launch_matvec_any): the compact block kernel on
    tetrahedra and on compact 2D P2/P1 layouts (``compact_layout``)."""
    if narrow(lay, in_spaces, out_spaces):
        return "narrow_product_kernel + narrow_merge_kernel"
    if streams(lay, in_spaces, out_spaces):
        return "stream_matvec_kernel + merge3_kernel<true>"
    if lay.dim == 3 or compact_layout(lay):
        return "matvec3_kernel + merge3_kernel"
    return "matvec_kernel + merge_kernel"


def _plain_or_raise(t: torch.Tensor) -> bool:
    """True for the plain (CPU) path; False for the kernel; raise otherwise."""
    if t.device.type == "cpu":
        return True
    if t.device.type == "cuda":
        return False
    raise ValueError(f"no windowed kernel for device {t.device}")


# ---------------------------------------------------------------------------
# the wrappers
# ---------------------------------------------------------------------------


def windowed_matvec(lay: WindowedLayout, A_t: torch.Tensor, x: torch.Tensor,
                    group=None) -> torch.Tensor:
    """y = A x over the whole system (no Dirichlet handling here).

    A_t: [nl, nli, nb*Bmax] cells-last block-ordered matrices (float32 or
    bfloat16 storage; the kernel widens on read and accumulates in float32).
    group: a process group of a sharded run, lay the rank's framed layout
    and x, y its owned vectors; the neighbours' edge blocks fill the frame
    (``_frame``), the call runs on the framed vector, and the frame's sums
    go back to them (``_unframe``).  Every wrapper takes ``group`` alike.
    """
    if group is not None:
        (xf,) = _frame(lay, "vp", group, x)
        return _unframe(lay, windowed_matvec(lay, A_t, xf), "vp", group)
    if _plain_or_raise(x):
        return windowed_matvec_reference(lay, A_t, x)
    y = _launch_matvec(lay, A_t, x, "vp", "vp", lay.nli)
    windowed_matvec.launches += 1
    return y


def _launch_gather(lay: WindowedLayout, *xs: torch.Tensor) -> torch.Tensor:
    """One K3 launch for one or two vectors: [len(xs), nli, ncd] (one
    vector: [nli, ncd])."""
    _check_cuda(lay, *xs)
    n = lay.n_u + lay.n_ps
    for x in xs:
        _check_vec(x, n)
    lead = (2,) if len(xs) == 2 else ()
    X = torch.empty((*lead, lay.nli, lay.ncd), dtype=torch.float32, device=xs[0].device)
    pk = lay._packed
    err = _lib().ns_gather(
        *pk.args, xs[0].data_ptr(), xs[-1].data_ptr(), X.data_ptr(), len(xs), lay.nli,
        torch.cuda.current_stream(X.device).cuda_stream,
    )
    _raise_on(err, "ns_gather")
    windowed_gather.launches += 1
    return X


def windowed_gather(lay: WindowedLayout, x: torch.Tensor, group=None) -> torch.Tensor:
    """X[l, s] = x[dof_l of cell s] — [nli, nb*Bmax]; rows l >= nl are zero."""
    if group is not None:
        (x,) = _frame(lay, "vp", group, x)
    if _plain_or_raise(x):
        return _gather_reference(lay, x)
    return _launch_gather(lay, x)


def windowed_gather_pair(
    lay: WindowedLayout, u: torch.Tensor, u_old: torch.Tensor, group=None
) -> tuple[torch.Tensor, torch.Tensor]:
    """(windowed_gather(lay, u), windowed_gather(lay, u_old)); on the card
    one K3 launch that reads the tables once (u and u_old may be one
    tensor).  The two results are views of one [2, nli, nb*Bmax] tensor.
    With ``group`` both vectors are framed in one exchange."""
    if group is not None:
        u, u_old = _frame(lay, "vp", group, u, u_old)
    plain = _plain_or_raise(u)
    if _plain_or_raise(u_old) != plain:
        raise ValueError(f"u on {u.device}, u_old on {u_old.device}")
    if plain:
        return _gather_reference(lay, u), _gather_reference(lay, u_old)
    return _launch_gather(lay, u, u_old).unbind(0)


def windowed_scatter(lay: WindowedLayout, R: torch.Tensor, group=None) -> torch.Tensor:
    """y = sum_cells P_c^T R_c for per-cell row values R [>=nl, nb*Bmax]:
    per-block window accumulation, then the overlaps merge.  On the card,
    in one C call (``scatter_design`` names the kernels): at P2/P1
    per-chunk subwindow accumulation, then the merge, in 2D (in the order
    of ``_scatter_chunked_reference``), per-chunk sums at the chunk's
    entries, then the row-list merge, in 3D; on the P3/P2 elements and on
    compact 2D P2/P1 layouts (``compact_layout``) one kernel that sums each
    row's (slot, dof) pairs of R through the row lists
    (``_scatter_rows_reference``).  All but the 2D subwindow kernels sum in
    the order of ``_compact_scatter_reference``."""
    if group is not None:
        return _unframe(lay, windowed_scatter(lay, R), "vp", group)
    if _plain_or_raise(R):
        return _scatter_reference(lay, R)
    _check_cuda(lay, R)
    if R.dtype != torch.float32 or R.dim() != 2 or R.shape[0] < lay.nl or R.shape[1] != lay.ncd:
        raise TypeError(f"scatter rows must be float32 [>= {lay.nl}, {lay.ncd}]")
    y = torch.empty(lay.n_u + lay.n_ps, dtype=torch.float32, device=R.device)
    pk = lay._packed
    stream = torch.cuda.current_stream(R.device).cuda_stream
    err = _lib().ns_scatter(
        *pk.args, pk.compact_args, R.data_ptr(), pk.scratch(stream), y.data_ptr(), stream
    )
    _raise_on(err, "ns_scatter")
    windowed_scatter.launches += 1
    return y


def windowed_matvec_block(
    lay: WindowedLayout,
    A_sub: torch.Tensor,
    x: torch.Tensor,
    *,
    in_spaces: str = "vp",
    out_spaces: str = "vp",
    group=None,
) -> torch.Tensor:
    """y = A_sub x for a sub-block operator at proportional cost.

    A_sub: [n_in, n_out_pad, ncd] (``slice_block`` of the tangent, or the
    pressure Laplacian Kp_t), float32 or bfloat16.  x: planar segment of the
    in-spaces ("v" -> [dim*n_vs], "p" -> [n_ps], "vp" -> full).  Returns the
    out-spaces segment.  The kernel serves v->v, v->p and p->p
    (``matvec_design`` names the CUDA kernels of each at a layout).
    """
    if in_spaces not in ("v", "p", "vp") or out_spaces not in ("v", "p", "vp"):
        raise ValueError(f"spaces {in_spaces!r}->{out_spaces!r}")
    if in_spaces == "vp" and out_spaces == "vp":
        if A_sub.dtype != x.dtype:
            raise TypeError("full-system matvec needs matching dtypes")
        return windowed_matvec(lay, A_sub, x, group)
    if group is not None:
        (xf,) = _frame(lay, in_spaces, group, x)
        y = windowed_matvec_block(lay, A_sub, xf, in_spaces=in_spaces, out_spaces=out_spaces)
        return _unframe(lay, y, out_spaces, group)
    if _plain_or_raise(x):
        return _block_reference(lay, A_sub, x, in_spaces, out_spaces)
    if (in_spaces, out_spaces) not in (("v", "v"), ("v", "p"), ("p", "p")):
        raise NotImplementedError(
            f"the block kernel serves v->v, v->p and p->p; got {in_spaces}->{out_spaces}"
        )
    n_out_pad = block_shape(lay, in_spaces, out_spaces)[1]
    y = _launch_matvec(lay, A_sub, x, in_spaces, out_spaces, n_out_pad)
    windowed_matvec_block.launches += 1
    windowed_matvec_block.pairs[f"{in_spaces}->{out_spaces}"] += 1
    return y


_WRAPPERS = {
    "K1 windowed_matvec": windowed_matvec,
    "K2 windowed_matvec_block": windowed_matvec_block,
    "K3 windowed_gather": windowed_gather,
    "K4 windowed_scatter": windowed_scatter,
}


def reset_launch_counts():
    """Zero every wrapper's launch count (and K2's by space pair,
    ``windowed_matvec_block.pairs``) and ``exchange_floats``."""
    for fn in _WRAPPERS.values():
        fn.launches = 0
    windowed_matvec_block.pairs = dict.fromkeys(("v->v", "v->p", "p->p"), 0)
    _exchange.floats = 0


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in _WRAPPERS.items()}


reset_launch_counts()
