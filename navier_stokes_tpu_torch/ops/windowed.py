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
The kernels compute in float32 and read A in float32 or bfloat16.

The kernels read window positions from one packed table per space
(``pack_positions``: absolute positions, 16 bits wide where the windows
allow), derived once per layout from the JAX-shaped ``loc_*_hi``/``loc_*_lo``/
``offs_*`` tables and cached on it.  K1, K2 and K4 run one CUDA block per
(layout block, chunk), sum into the chunk's subwindows and end in a merge
kernel launched by the same C call (plain version of that order:
``_scatter_chunked_reference`` through ``_merge_reference``), so a wrapper
call is one C call and does no torch arithmetic after it.
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

    @property
    def n_u(self) -> int:
        return self.dim * self.n_vs

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
    """The round of every slot's sums in the kernels K1, K2 and K4: (colour
    [nb, Bmax] uint8, ncolors).

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


def _gather_reference(lay: WindowedLayout, x: torch.Tensor) -> torch.Tensor:
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


def _scatter_reference(lay: WindowedLayout, R: torch.Tensor) -> torch.Tensor:
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
    return torch.cat(ys + [yp])


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
    row.  This is the plain version of K4, and of what K1 and K2 do after
    their contraction."""
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


def windowed_matvec_reference(
    lay: WindowedLayout, A_t: torch.Tensor, x: torch.Tensor
) -> torch.Tensor:
    """Plain same-math version of the windowed matvec (real gathers)."""
    X = _gather_reference(lay, x)  # [nli, ncd]
    # A_t may be stored narrower than x (bf16 operator): widen like the kernel
    yl = torch.einsum("jis,js->is", A_t[:, : lay.nl, :].to(x.dtype), X[: lay.nl])
    return _scatter_reference(lay, yl)


def _block_reference(lay, A_sub, x, in_spaces, out_spaces):
    """Plain same-math version of the block matvec."""
    n_loc = lay.dim * lay.n_vs + lay.n_ps
    if in_spaces == "v":
        xf = x.new_zeros(n_loc)
        xf[: lay.dim * lay.n_vs] = x
    elif in_spaces == "p":
        xf = x.new_zeros(n_loc)
        xf[lay.dim * lay.n_vs :] = x
    else:
        xf = x
    X = _gather_reference(lay, xf)  # [nli, ncd]
    jsl = _space_slices(lay)
    # A_sub may be stored narrower than x (bf16 precond blocks): widen
    yl = torch.einsum("jis,js->is", A_sub.to(x.dtype), X[jsl[in_spaces]])
    R = yl.new_zeros((lay.nli, lay.ncd))
    osl = jsl[out_spaces]
    R[osl] = yl[: osl.stop - osl.start]
    yf = _scatter_reference(lay, R)
    if out_spaces == "v":
        return yf[: lay.dim * lay.n_vs]
    if out_spaces == "p":
        return yf[lay.dim * lay.n_vs :]
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
# the elements the kernels are instantiated for: (dim, k_v, k_p) of P2/P1
_ELEMENTS = ((2, 6, 3), (3, 10, 4))
# what the entry points return besides 0 and cudaError_t values (windowed.cu)
_KERNEL_ERRORS = {
    -1: "the layout is not one the kernels are built for (P2/P1 on triangles or "
        "tetrahedra, chunks of at most 1024 slots in 2D and 512 in 3D whose rows "
        "of A are 16-byte multiples; the gather, the scatter and the 3D products "
        "take whole warps: a multiple of 32 slots)",
    -2: "a block would need more shared memory than it may use",
    -3: "the operator's storage is not 16-byte aligned",
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
    lib.ns_scratch_floats.argtypes = [meta]
    lib.ns_scratch_floats.restype = ctypes.c_long
    lib.ns_gather.argtypes = [meta, *tables, p, p, p, i, i, p]
    lib.ns_scatter.argtypes = [meta, *tables, p, p, p, p]
    lib.ns_matvec.argtypes = [meta, *tables, p, i, i, i, i, p, p, p, p]
    for fn in (lib.ns_gather, lib.ns_scatter, lib.ns_matvec):
        fn.restype = i
    return lib


class _Packed:
    """What the CUDA entry points take of one layout, made once: the geometry
    record (struct Geo, windowed.cu), the packed tables of ``pack_positions``,
    the slot colours of ``slot_colours`` and the leading arguments of every
    call.  Scratch for the window
    accumulators is kept per stream (calls on one stream run in turn, so
    they can share it; CUDA graphs captured on one capture stream share
    theirs, so replay them on one stream at a time)."""

    def __init__(self, lay: WindowedLayout):
        self.pos_v, self.pos_p, self.cnt = pack_positions(lay)
        self.colour, self.ncolors = slot_colours(lay, self.pos_v, self.pos_p)
        vals = [
            lay.nb, lay.Bmax, lay.Bc, lay.nchunks,
            lay.dim, lay.k_v, lay.k_p,
            lay.OWv, lay.OWp, lay.hv, lay.hp, lay.RVv, lay.RVp,
            lay.n_vs, lay.n_ps, lay.ncd,
            int(self.pos_v.dtype == torch.int32), self.ncolors,
        ]
        self.meta = (ctypes.c_int * (len(vals) + 1))(len(vals), *vals)
        self.args = (
            self.meta, self.pos_v.data_ptr(), self.pos_p.data_ptr(),
            lay.offs_v.data_ptr(), lay.offs_p.data_ptr(), self.cnt.data_ptr(),
            self.colour.data_ptr(),
        )
        self._device = lay.device
        self._scratch = {}

    def scratch(self, stream: int) -> int:
        """Address of this stream's scratch (allocated at first use, of the
        size the library asks for)."""
        buf = self._scratch.get(stream)
        if buf is None:
            n = _lib().ns_scratch_floats(self.meta)
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
            "the CUDA windowed kernels are built for Taylor-Hood P2/P1 on "
            f"triangles and tetrahedra (dim, k_v, k_p) in {_ELEMENTS}; got "
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
        *pk.args, A.data_ptr(), int(A.dtype == torch.bfloat16),
        _SPACE_CODE[in_spaces], _SPACE_CODE[out_spaces], n_out_pad,
        x.data_ptr(), pk.scratch(stream), y.data_ptr(), stream,
    )
    _raise_on(err, f"ns_matvec({in_spaces}->{out_spaces})")
    return y


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


def windowed_matvec(lay: WindowedLayout, A_t: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """y = A x over the whole system (no Dirichlet handling here).

    A_t: [nl, nli, nb*Bmax] cells-last block-ordered matrices (float32 or
    bfloat16 storage; the kernel widens on read and accumulates in float32).
    """
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


def windowed_gather(lay: WindowedLayout, x: torch.Tensor) -> torch.Tensor:
    """X[l, s] = x[dof_l of cell s] — [nli, nb*Bmax]; rows l >= nl are zero."""
    if _plain_or_raise(x):
        return _gather_reference(lay, x)
    return _launch_gather(lay, x)


def windowed_gather_pair(
    lay: WindowedLayout, u: torch.Tensor, u_old: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """(windowed_gather(lay, u), windowed_gather(lay, u_old)); on the card
    one K3 launch that reads the tables once (u and u_old may be one
    tensor).  The two results are views of one [2, nli, nb*Bmax] tensor."""
    plain = _plain_or_raise(u)
    if _plain_or_raise(u_old) != plain:
        raise ValueError(f"u on {u.device}, u_old on {u_old.device}")
    if plain:
        return _gather_reference(lay, u), _gather_reference(lay, u_old)
    return _launch_gather(lay, u, u_old).unbind(0)


def windowed_scatter(lay: WindowedLayout, R: torch.Tensor) -> torch.Tensor:
    """y = sum_cells P_c^T R_c for per-cell row values R [>=nl, nb*Bmax]:
    per-block window accumulation, then the overlaps merge.  On the card:
    per-chunk subwindow accumulation, then the merge, in one C call (in the
    order of ``_scatter_chunked_reference``)."""
    if _plain_or_raise(R):
        return _scatter_reference(lay, R)
    _check_cuda(lay, R)
    if R.dtype != torch.float32 or R.dim() != 2 or R.shape[0] < lay.nl or R.shape[1] != lay.ncd:
        raise TypeError(f"scatter rows must be float32 [>= {lay.nl}, {lay.ncd}]")
    y = torch.empty(lay.n_u + lay.n_ps, dtype=torch.float32, device=R.device)
    pk = lay._packed
    stream = torch.cuda.current_stream(R.device).cuda_stream
    err = _lib().ns_scatter(
        *pk.args, R.data_ptr(), pk.scratch(stream), y.data_ptr(), stream
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
) -> torch.Tensor:
    """y = A_sub x for a sub-block operator at proportional cost.

    A_sub: [n_in, n_out_pad, ncd] (``slice_block`` of the tangent, or the
    pressure Laplacian Kp_t), float32 or bfloat16.  x: planar segment of the
    in-spaces ("v" -> [dim*n_vs], "p" -> [n_ps], "vp" -> full).  Returns the
    out-spaces segment.  The kernel serves v->v, v->p and p->p.
    """
    if in_spaces not in ("v", "p", "vp") or out_spaces not in ("v", "p", "vp"):
        raise ValueError(f"spaces {in_spaces!r}->{out_spaces!r}")
    if in_spaces == "vp" and out_spaces == "vp":
        if A_sub.dtype != x.dtype:
            raise TypeError("full-system matvec needs matching dtypes")
        return windowed_matvec(lay, A_sub, x)
    if _plain_or_raise(x):
        return _block_reference(lay, A_sub, x, in_spaces, out_spaces)
    if (in_spaces, out_spaces) not in (("v", "v"), ("v", "p"), ("p", "p")):
        raise NotImplementedError(
            f"the block kernel serves v->v, v->p and p->p; got {in_spaces}->{out_spaces}"
        )
    n_out_pad = block_shape(lay, in_spaces, out_spaces)[1]
    y = _launch_matvec(lay, A_sub, x, in_spaces, out_spaces, n_out_pad)
    windowed_matvec_block.launches += 1
    return y


_WRAPPERS = {
    "K1 windowed_matvec": windowed_matvec,
    "K2 windowed_matvec_block": windowed_matvec_block,
    "K3 windowed_gather": windowed_gather,
    "K4 windowed_scatter": windowed_scatter,
}


def reset_launch_counts():
    for fn in _WRAPPERS.values():
        fn.launches = 0


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in _WRAPPERS.items()}


reset_launch_counts()
