"""Bytes a windowed kernel call must move, and the card's peak bandwidth.

A frozen copy of ``kernel_bench.bound_bytes_of`` without the 2D slot-colour
table: of A the used rows' values in the occupied slots; of the packed
position tables the occupied slots' entries of the spaces the call touches,
their subwindow offsets and the slot counts; every vector read or written
once.  It counts what the mathematics of a call needs at a layout and no
table of one route, so it reads the same whichever kernel serves the call.
"""

from __future__ import annotations

import torch

PEAK_BYTES_PER_S = 3.35e12  # NVIDIA H100 SXM, HBM3 (data sheet)
_POS16 = 0xFFFF  # a 16-bit position table holds windows shorter than this


def _valid(lay, hi, lo, offs, RVc, RW, k, W):
    """[nb, Bmax, k] True where a slot's local dof has a window position."""
    h = hi.transpose(1, 2)[:, :, :k].long()
    l = lo.transpose(1, 2)[:, :, :k].long()
    off = offs.long().repeat_interleave(lay.Bc, dim=1)[:, :, None]
    loc = (off + h) * 128 + l
    return (h < RVc) & (l < 128) & (loc < RW * 128) & (loc < W)


def layout_counts(lay) -> dict:
    """The layout's occupied slots (each block's up to its last slot with a
    position), the bytes of a packed position and the table sizes."""
    Ws = ((2 * lay.hv + 1) * lay.OWv, (2 * lay.hp + 1) * lay.OWp)
    vv = _valid(lay, lay.loc_v_hi, lay.loc_v_lo, lay.offs_v, lay.RVv, lay.RWv, lay.k_v, Ws[0])
    vp = _valid(lay, lay.loc_p_hi, lay.loc_p_lo, lay.offs_p, lay.RVp, lay.RWp, lay.k_p, Ws[1])
    filled = vv.any(2) | vp.any(2)  # [nb, Bmax]
    slots = torch.arange(1, lay.Bmax + 1, device=filled.device)
    n_occ = int((filled * slots).amax(dim=1).sum())
    return {"n_occ": n_occ, "idx": 4 if max(Ws) >= _POS16 else 2, "nb": lay.nb,
            "offs": {"v": lay.offs_v.numel(), "p": lay.offs_p.numel()},
            "k": {"v": lay.k_v, "p": lay.k_p}, "rows": {"v": lay.dim * lay.k_v, "p": lay.k_p},
            "size": {"v": lay.dim * lay.n_vs, "p": lay.n_ps}, "nl": lay.nl, "nli": lay.nli,
            "ncd": lay.nb * lay.Bmax}


def _tables(c, space):
    return c["k"][space] * c["n_occ"] * c["idx"] + c["offs"][space] * 4


def matvec_bytes(c, ins: str, outs: str, elt: int) -> int:
    """K1 (ins = outs = "vp") or a K2 product, A stored in ``elt`` bytes."""
    spaces = set(ins) | set(outs)
    return (sum(c["rows"][a] for a in ins) * sum(c["rows"][a] for a in outs) * c["n_occ"] * elt
            + sum(_tables(c, a) for a in spaces) + c["nb"] * 4
            + 4 * sum(c["size"][a] for a in ins) + 4 * sum(c["size"][a] for a in outs))


def gather_pair_bytes(c) -> int:
    """K3 gathering u and u_old in one call: both vectors read and both
    [nli, ncd] outputs written, the tables read once."""
    n = c["size"]["v"] + c["size"]["p"]
    both = _tables(c, "v") + _tables(c, "p") + c["nb"] * 4
    return 2 * (4 * n + 4 * c["nli"] * c["ncd"]) + both


def scatter_bytes(c) -> int:
    """K4: the used rows of R in the occupied slots read, y written."""
    n = c["size"]["v"] + c["size"]["p"]
    both = _tables(c, "v") + _tables(c, "p") + c["nb"] * 4
    return 4 * c["nl"] * c["n_occ"] + both + 4 * n
