"""K4 on the P3/P2 elements: the row-ordered sum over R, on the host.

On P3/P2 triangles and tetrahedra K4 (y = sum_cells P_c^T R_c) runs one
kernel of its own (csrc/windowed.cu ``scatter_rows_kernel``): a thread a
row of a space walks the row's (slot, dof) pairs of R through a row list
flattened once on the host from the compact tables (``ops/windowed.py``
``row_list``), a place's pairs in order, then the row's places in order;
a velocity row reads all its components from one walk.  Here, on the CPU:

* the row lists of both spaces: every (slot, dof) pair of an occupied slot
  once, in the order of ``_compact_scatter_reference`` (a row's places by
  window and chunk, an entry's pairs slots ascending), each place's first
  pair flagged, int32; an index past 31 bits raises;
* the Python mirror of the kernel's walk (``_scatter_rows_reference``,
  ``_row_walk_reference``) against ``_compact_scatter_reference`` bit for
  bit in float32 (the same sums in the same order), and against the plain
  scatter and the JAX package's ``windowed_scatter`` (its plain path on the
  CPU) in float64 to 1e-12 of ||y||_inf (the same sums in another order);
* which elements take the route (``scatter_design``; P2/P1 keeps its
  kernels), that a CPU tensor takes the plain path and launches nothing,
  and kernel_bench's count of the bytes the route moves.

Layouts (P3/P2: 10 velocity and 6 pressure dofs a triangle, 20 and 10 a
tetrahedron): unit_square(6) at 16 cells a block (halo 1), unit_square(12)
refined once at 448 cells a block in chunks of 256 (3 blocks of 2
chunks), rank 0 of 2 of unit_square(8)'s framed layout, box(2, 2, 2) (one
chunk) and box(4, 4, 4) refined once in chunks of 256 (3 chunks a block).
The kernel on the card: tests/test_torch_kernels.py.
"""

import functools
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from navier_stokes_tpu.ops import windowed as jw
from navier_stokes_tpu_torch import convert
from navier_stokes_tpu_torch.fem.dofs import make_dofs, renumber_blocked
from navier_stokes_tpu_torch.mesh.generate import box, unit_square
from navier_stokes_tpu_torch.mesh.mesh import refine_uniform
from navier_stokes_tpu_torch.ops import windowed as tw
from navier_stokes_tpu_torch.parallel import windowed_spmd as ws

LAYOUTS = {
    "p3-square-blocked": dict(n=6, cpb=16, Bc=128),
    "p3-square-chunks": dict(n=12, refine=1, cpb=448, Bc=256),
    "p3-square-framed-r0of2": dict(n=8, cpb=16, Bc=128, rank=0, ranks=2),
    "p3-box-h1": dict(box=2, cpb=16, Bc=128),
    "p3-box-refined-Bc256": dict(box=4, refine=1, cpb=448, Bc=256),
}
UNFRAMED = [name for name in sorted(LAYOUTS) if "ranks" not in LAYOUTS[name]]


def _build(c):
    mesh = box(c["box"], c["box"], c["box"]) if "box" in c else unit_square(c["n"])
    if c.get("refine"):
        mesh = refine_uniform(mesh, c["refine"])
    dofs, bi = renumber_blocked(make_dofs(mesh, 3, 2), cells_per_block=c["cpb"],
                                nb_multiple=c.get("ranks", 1))
    return (dofs.cell_vdofs, dofs.cell_pdofs, dofs.n_vs, dofs.n_ps, mesh.dim), dict(
        block_info=bi, Bc=c["Bc"])


@functools.lru_cache(maxsize=None)
def _layout(name):
    c = LAYOUTS[name]
    args, kw = _build(c)
    lay = tw.build_windowed_layout(*args, **kw)
    if "ranks" in c:
        lay = ws.local_layout(lay, ws.make_dist_layout(lay, c["ranks"]), c["rank"])
    return lay


@functools.lru_cache(maxsize=None)
def _tables(name):
    return tw.compact_tables(_layout(name))


@functools.lru_cache(maxsize=None)
def _rows(name):
    lay, tabs = _layout(name), _tables(name)
    return {key: tw.row_list(lay, tabs[key]) for key in "vp"}


def _R(lay, seed, dtype):
    """Seeded per-slot rows R [nli, ncd], the scatter's input."""
    return torch.as_tensor(np.random.default_rng(seed).standard_normal((lay.nli, lay.ncd)),
                           dtype=dtype)


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()


def test_layouts_reach_both_elements_chunks_and_a_frame():
    """The layouts are P3/P2 triangles and tetrahedra, whose K4 is the
    row-ordered sum; they reach one chunk and several blocks of several
    chunks on both elements, and a framed layout."""
    lays = [_layout(name) for name in LAYOUTS]
    assert {(lay.dim, lay.k_v, lay.k_p) for lay in lays} == {(2, 10, 6), (3, 20, 10)}
    assert all(tw.scatter_rows(lay) for lay in lays)
    for dim in (2, 3):
        mine = [lay for lay in lays if lay.dim == dim]
        assert {lay.nchunks > 1 for lay in mine} == {True, False}
        assert any(lay.nb > 1 and lay.nchunks > 1 for lay in mine)
    assert any(lay.frame for lay in lays)


@pytest.mark.parametrize("space", ["v", "p"])
@pytest.mark.parametrize("name", sorted(LAYOUTS))
def test_row_lists_hold_every_pair_once_in_compact_order(name, space):
    """``row_list`` of each space: row r's pairs are its places (the entries
    at row_ptr[r]:row_ptr[r + 1] through ``at``) in order, each place's
    (slot, dof) pairs in the order of ``tr`` (slots ascending), as indices
    l*ncd + s (l < the space's dofs a cell) with bit 31 set on a place's
    first pair; every pair of an occupied slot appears once; int32."""
    lay, t = _layout(name), _tables(name)[space]
    k, n = (lay.k_v, lay.n_vs) if space == "v" else (lay.k_p, lay.n_ps)
    ptr, lst = _rows(name)[space]
    assert ptr.dtype == torch.int32 and lst.dtype == torch.int32
    ptr, lst = ptr.numpy().astype(np.int64), lst.numpy().astype(np.int64)
    assert len(ptr) == n + 1 and ptr[0] == 0 and ptr[-1] == len(lst) == t.tr.numel()
    off, tr_off = t.off.numpy().astype(np.int64), t.tr_off.numpy().astype(np.int64)
    code = t.tr.numpy().astype(np.int64) & 0xFFFF
    piece = np.repeat(np.arange(len(off) - 1), np.diff(off))
    at, row_ptr = t.at.numpy(), t.row_ptr.numpy()
    want, first = [], []
    for r in range(n):
        for e in at[row_ptr[r] : row_ptr[r + 1]]:
            p = piece[e]
            for i in range(tr_off[e], tr_off[e + 1]):
                s = (p // lay.nchunks) * lay.Bmax + (p % lay.nchunks) * lay.Bc + code[i] % lay.Bc
                want.append((code[i] // lay.Bc) * lay.ncd + s)
                first.append(i == tr_off[e])
        assert len(want) == ptr[r + 1]
    assert np.array_equal(lst & 0x7FFFFFFF, want)
    assert np.array_equal(lst < 0, first)
    assert (lst & 0x7FFFFFFF).max() < k * lay.ncd
    pos = tw.unpack_positions(tw.pack_positions(lay)[0 if space == "v" else 1]).numpy()
    b, l, j = np.nonzero(pos >= 0)  # [nb, k, Bmax]: every occupied (slot, dof) pair
    assert np.array_equal(np.sort(lst & 0x7FFFFFFF), np.sort(l * lay.ncd + b * lay.Bmax + j))


@pytest.mark.parametrize("name", sorted(LAYOUTS))
def test_row_walk_mirror_gives_the_compact_scatter_bits(name):
    """The kernel's mirror, each velocity component and the pressure walked
    through their row lists, gives ``_compact_scatter_reference``'s bits in
    float32 (the same sums in the same order)."""
    lay, tabs = _layout(name), _tables(name)
    R = _R(lay, 3, torch.float32)
    got = tw._scatter_rows_reference(lay, R, _rows(name))
    assert got.dtype == torch.float32 and got.shape == (lay.n_u + lay.n_ps,)
    assert torch.equal(got, tw._compact_scatter_reference(lay, R, tabs))


@pytest.mark.parametrize("name", sorted(LAYOUTS))
def test_row_walk_mirror_matches_plain_f64(name):
    """The mirror equals the plain scatter (per-block windows and their
    merge) in float64 to 1e-12 of ||y||_inf; on the framed layout the
    frame's rows take the owned blocks' sums too."""
    lay = _layout(name)
    R = _R(lay, 4, torch.float64)
    _close(tw._scatter_rows_reference(lay, R, _rows(name)), tw._scatter_reference(lay, R))


@pytest.mark.parametrize("name", UNFRAMED)
def test_row_walk_mirror_and_compact_model_match_jax_f64(name):
    """On the port's copy of the JAX package's layout (``convert``), the
    mirror and ``_compact_scatter_reference`` equal the JAX package's
    windowed_scatter (its plain path on the CPU) in float64."""
    args, kw = _build(LAYOUTS[name])
    jlay = jw.build_windowed_layout(*args, **kw)
    lay = convert.layout_from_arrays(convert.arrays_of(jlay))
    R = _R(lay, 5, torch.float64)
    want = jw.windowed_scatter(jlay, jnp.asarray(R.numpy()))
    tabs = tw.compact_tables(lay)
    rows = {key: tw.row_list(lay, tabs[key]) for key in "vp"}
    _close(tw._scatter_rows_reference(lay, R, rows), want)
    _close(tw._compact_scatter_reference(lay, R, tabs), want)


@pytest.mark.parametrize("element", [(2, 6, 3), (2, 10, 6), (3, 10, 4), (3, 20, 10)])
def test_scatter_design_names_the_route(element):
    """K4 is the row-ordered sum on the P3/P2 elements alone; P2/P1 keeps
    the chunk kernels and their merge (windowed.cu ``scatter_rows``)."""
    dim, k_v, k_p = element
    lay = SimpleNamespace(dim=dim, k_v=k_v, k_p=k_p)
    rows = k_v in (10, 20) and element != (3, 10, 4)
    assert tw.scatter_rows(lay) == rows
    want = ("scatter_rows_kernel" if rows else
            "scatter3_kernel + merge3_kernel" if dim == 3 else
            "scatter_kernel + merge_kernel<., true>")
    assert tw.scatter_design(lay) == want


@pytest.mark.parametrize("name", ["p3-square-chunks", "p3-box-refined-Bc256"])
def test_cpu_wrapper_is_the_plain_version(name):
    """On the CPU the K4 wrapper takes its plain version and launches
    nothing: within 1e-12 of the row walk's mirror in float64."""
    lay = _layout(name)
    R = _R(lay, 6, torch.float64)
    tw.reset_launch_counts()
    got = tw.windowed_scatter(lay, R)
    assert tw.windowed_scatter.launches == 0
    _close(got, tw._scatter_rows_reference(lay, R, _rows(name)))


def test_row_list_refuses_indices_past_31_bits():
    """An index l*ncd + s that does not fit 31 bits raises: one chunk of
    one slot whose dof 2 lies at 2**31 with ncd 2**30."""
    lay = SimpleNamespace(nchunks=1, Bc=32, Bmax=32, ncd=1 << 30)
    i32 = functools.partial(torch.tensor, dtype=torch.int32)
    tab = SimpleNamespace(off=i32([0, 2]), tr_off=i32([0, 1, 2]), at=i32([0, 1]),
                          row_ptr=i32([0, 1, 2]), tr=torch.tensor([0, 64], dtype=torch.int16))
    with pytest.raises(ValueError, match="31 bits"):
        tw.row_list(lay, tab)
    tab.tr = torch.tensor([0, 32], dtype=torch.int16)  # dof 1 at 2**30: fits
    ptr, lst = tw.row_list(lay, tab)
    assert ptr.tolist() == [0, 1, 2] and (lst & 0x7FFFFFFF).tolist() == [0, 1 << 30]


@pytest.mark.parametrize("name", ["p3-square-chunks", "p3-box-refined-Bc256"])
def test_moved_bytes_compact_counts_the_row_scatter(name):
    """kernel_bench counts the bytes the row-ordered K4 moves on both
    elements: R's occupied (slot, dof) values, the row lists with their
    offsets, and y: more than R's values and y alone."""
    from navier_stokes_tpu_torch.scripts import kernel_bench as kb

    lay, tabs = _layout(name), _tables(name)
    _, operands = kb.seeded_operands(lay, seed=2)
    moved = kb.moved_bytes_compact(lay, operands)["K4"]
    Tv, Tp = tabs["v"].tr.numel(), tabs["p"].tr.numel()
    n = lay.n_u + lay.n_ps
    want = (4 * (lay.dim * Tv + Tp) + 4 * (Tv + Tp) + 4 * (lay.n_vs + 1 + lay.n_ps + 1)
            + 4 * n)
    assert moved == want
    assert moved > 4 * (lay.dim * Tv + Tp) + 4 * n
