"""The compact kernels' host tables and their plain two-stage models.

On tetrahedra K1 and K2 (csrc/windowed.cu ``matvec3_kernel`` and
``merge3_kernel``) and K4 (``scatter3_kernel`` and the same merge), and at
P3/P2 K1 on both elements, K2 v->v on triangles and K2 v->p and p->p on
tetrahedra (``stream_matvec_kernel``, the same merge), sum each chunk's
slots at the distinct window positions the chunk touches (its entries),
write every sum to its place in a scratch vector ordered by row, and merge
each row's places in order (``ops/windowed.py`` ``compact_tables``).
Here, on the CPU:

* the tables: each chunk's list sorted and distinct and equal to the
  positions its slots touch; every occupied (slot, dof) pair listed exactly
  once, under the entry its index names, slots ascending; each row's places
  its entries by window (j = 0..2h, as ``_combine_windows``) and then chunk;
  the 16-bit indices fit; max_entries and max_pairs are the longest lists;
  a layout whose chunk lists do not fit a block's shared memory raises;
* ``_compact_matvec_reference`` (the kernels' order in plain torch) against
  ``windowed_matvec_reference`` and ``_block_reference`` in float64, to
  1e-12 of ||y||_inf (the same sums in another order), for vp->vp, v->v,
  v->p and p->p; and on one layout against the JAX package's references;
* ``_compact_scatter_reference`` (K4's order) against ``_scatter_reference``
  in float64 to 1e-12 of ||y||_inf, and on one layout against the JAX
  package's ``windowed_scatter`` (its plain path on the CPU);
* the streaming kernel's host side: the products it serves, its work list
  (every occupied chunk once, under any persistent grid) and each chunk's
  record of table offsets, each entry's first pair counted from its
  chunk's, its shared memory for each product at the P3/P2 layouts, and
  kernel_bench's count of the bytes it moves.

Layouts: the card tests' three P2/P1 tetrahedral ones
(tests/test_torch_kernels.py ``TETS``: one chunk at halo 1; 3 chunks of
256; halo 2) and two of its P3/P2 ones ("p3-": 20 velocity and 10 pressure
dofs a tetrahedron; one chunk, and 3 chunks of 256), box(2, 2, 2) on
the default (unblocked) layout, one block with no halo, and three ranks'
framed layouts of a sharded run (parallel/windowed_spmd.py ``local_layout``)
of box(4, 4, 4) at 16 cells a block, halo 4: rank 0 and rank 1 of 2 (the
ends of the line) and rank 1 of 4 (an inner rank).  P3/P2 triangles ("p3-
square", 10 velocity and 6 pressure dofs a triangle): unit_square(6) at
halo 1, unit_square(8) at halo 2, rank 0 of 2 of unit_square(8)'s framed
layout, and unit_square(12) refined once at 448 cells a block in chunks of
256 (3 blocks of 2 chunks).  A framed layout's rows
run over its framed spaces, so the frame's rows receive the owned blocks'
sums (which the sharded wrappers then send to the neighbours).  Of the
generated boxes tried, none gives hv != hp.  The kernels on the card:
tests/test_torch_kernels.py.
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
    "box-h1": dict(box=2, cpb=16, Bc=128),
    "box-refined-Bc256": dict(box=4, refine=1, cpb=448, Bc=256),
    "box-refined-h2": dict(box=8, refine=1, cpb=448, Bc=256),
    "box2-unblocked": dict(box=2, target_ow=1024, Bc=128),
    # framed layouts of a sharded run: (rank, ranks)
    "box4-framed-r0of2": dict(box=4, cpb=16, Bc=128, rank=0, ranks=2),
    "box4-framed-r1of2": dict(box=4, cpb=16, Bc=128, rank=1, ranks=2),
    "box4-framed-r1of4": dict(box=4, cpb=16, Bc=128, rank=1, ranks=4),
    "p3-box-h1": dict(box=2, cpb=16, Bc=128, deg=3),
    "p3-box-refined-Bc256": dict(box=4, refine=1, cpb=448, Bc=256, deg=3),
    # P3/P2 triangles: halo 1, halo 2, a framed layout of 2 ranks, and 3
    # blocks of 2 chunks
    "p3-square-h1": dict(n=6, cpb=16, Bc=128, deg=3),
    "p3-square-chunks": dict(n=12, refine=1, cpb=448, Bc=256, deg=3),
    "p3-square-h2": dict(n=8, cpb=8, Bc=128, deg=3),
    "p3-square-framed-r0of2": dict(n=8, cpb=16, Bc=128, deg=3, rank=0, ranks=2),
}
PRODUCTS = [("vp", "vp"), ("v", "v"), ("v", "p"), ("p", "p")]


def _build(c):
    mesh = box(c["box"], c["box"], c["box"]) if "box" in c else unit_square(c["n"])
    if c.get("refine"):
        mesh = refine_uniform(mesh, c["refine"])
    dofs = make_dofs(mesh, c.get("deg", 2), c.get("deg", 2) - 1)
    if "cpb" in c:
        dofs, bi = renumber_blocked(dofs, cells_per_block=c["cpb"],
                                    nb_multiple=c.get("ranks", 1))
        kw = dict(block_info=bi, Bc=c["Bc"])
    else:
        kw = dict(target_ow=c["target_ow"], Bc=c["Bc"])
    return (dofs.cell_vdofs, dofs.cell_pdofs, dofs.n_vs, dofs.n_ps, mesh.dim), kw


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


def _spaces(lay):
    """(key, packed positions [nb, k, Bmax], k, OW, h, n) of each space."""
    pos_v, pos_p, _ = tw.pack_positions(lay)
    return (("v", tw.unpack_positions(pos_v).numpy(), lay.k_v, lay.OWv, lay.hv, lay.n_vs),
            ("p", tw.unpack_positions(pos_p).numpy(), lay.k_p, lay.OWp, lay.hp, lay.n_ps))


def _entry_chunks(lay, t):
    """(block, chunk) of every entry of a space's tables."""
    off = t.off.numpy()
    piece = np.repeat(np.arange(len(off) - 1), np.diff(off))
    return piece // lay.nchunks, piece % lay.nchunks


def test_layouts_cover_the_kernel_paths():
    """Tetrahedra: one chunk and several, halos 0, 1, 2 and 4; framed
    layouts of both ends of a line of ranks and of an inner rank, with
    frame = halo.  P3/P2 triangles: halos 1 and 2 and a framed layout."""
    lays = [_layout(name) for name in LAYOUTS]
    tets = [lay for lay in lays if lay.dim == 3]
    assert {lay.nchunks > 1 for lay in tets} == {True, False}
    assert {lay.hv for lay in tets} == {0, 1, 2, 4}
    framed = [lay for lay in tets if lay.frame]
    assert len(framed) == 3 and all(lay.frame == lay.hv == lay.hp == 4 for lay in framed)
    assert [lay.nb for lay in framed] == [12 + 8, 12 + 8, 6 + 8]
    p3 = [lay for lay in tets if (lay.k_v, lay.k_p) == (20, 10)]
    assert len(p3) == 2 and {lay.nchunks > 1 for lay in p3} == {True, False}
    tris = [lay for lay in lays if lay.dim == 2]
    assert {(lay.k_v, lay.k_p) for lay in tris} == {(10, 6)}
    assert {lay.hv for lay in tris} == {1, 2} and any(lay.frame for lay in tris)


@pytest.mark.parametrize("name", ["p3-box-h1", "p3-box-refined-Bc256"])
def test_p3_chunk_limits(name):
    """At P3/P2 a chunk's lists are longer (20 and 10 dofs a slot), and
    still within what the kernels take: entry indices below 0xFFFF, (slot,
    dof) codes below 20 x Bc, and the shared memory of the largest call and
    of K4 (R's 70 rows of a chunk and both spaces' pairs) within a block's
    limit."""
    lay, tabs = _layout(name), _tables(name)
    v, p = tabs["v"], tabs["p"]
    assert lay.nl == 70 and lay.nli == 72
    assert v.max_entries < 0xFFFF and p.max_entries < 0xFFFF
    assert v.max_pairs <= lay.k_v * lay.Bc and p.max_pairs <= lay.k_p * lay.Bc
    k4 = 4 * lay.nl * lay.Bc + 2 * (v.max_pairs + v.max_entries + 1
                                    + p.max_pairs + p.max_entries + 1)
    assert k4 <= tw.compact_smem_bytes(lay, tabs) <= tw._MAX_SMEM_BYTES


@pytest.mark.parametrize("name", sorted(LAYOUTS))
def test_chunk_lists_sorted_distinct_and_complete(name):
    """A chunk's entries are the window positions its slots touch, sorted
    and distinct; max_entries is the longest list."""
    lay, tabs = _layout(name), _tables(name)
    for key, pos, k, OW, h, n in _spaces(lay):
        t = tabs[key]
        off, row = t.off.numpy(), t.row.numpy().astype(np.int64)
        assert off[0] == 0 and off[-1] == t.E and np.all(np.diff(off) >= 0)
        assert t.max_entries == np.diff(off).max()
        eb, _ = _entry_chunks(lay, t)
        wpos = row - (eb - h) * OW  # the entries' window positions
        for b in range(lay.nb):
            for c in range(lay.nchunks):
                p = b * lay.nchunks + c
                got = wpos[off[p] : off[p + 1]]
                want = np.unique(pos[b, :, c * lay.Bc : (c + 1) * lay.Bc])
                assert np.array_equal(got, want[want >= 0]), (key, b, c)
                assert np.all(np.diff(got) > 0)


@pytest.mark.parametrize("name", sorted(LAYOUTS))
def test_every_slot_dof_listed_once_under_its_entry(name):
    """The (slot, dof) pairs of all entries are the occupied slots' dofs,
    each once; a pair sits under the entry that its slot's index names and
    at that entry's window position; an entry's pairs have slots
    ascending; max_pairs is the most pairs of a chunk."""
    lay, tabs = _layout(name), _tables(name)
    Bc, nch = lay.Bc, lay.nchunks
    for key, pos, k, OW, h, n in _spaces(lay):
        t = tabs[key]
        off, tr_off = t.off.numpy(), t.tr_off.numpy()
        code = t.tr.numpy().astype(np.int64) & 0xFFFF
        idx = t.idx.numpy().astype(np.int64) & 0xFFFF  # [nb, k, Bmax]
        assert tr_off[0] == 0 and tr_off[-1] == len(code) and np.all(np.diff(tr_off) > 0)
        assert t.max_pairs == np.diff(tr_off[off]).max()
        eb, ec = _entry_chunks(lay, t)
        ent = np.repeat(np.arange(t.E), np.diff(tr_off))  # the entry of every pair
        l, j = code // Bc, code % Bc
        assert l.max() < k
        b, slot = eb[ent], ec[ent] * Bc + j
        assert np.all(idx[b, l, slot] == ent - off[b * nch + ec[ent]])
        wpos = t.row.numpy()[ent] - (b - h) * OW
        assert np.all(pos[b, l, slot] == wpos)
        listed = np.zeros(pos.shape, dtype=np.int64)
        np.add.at(listed, (b, l, slot), 1)
        assert np.array_equal(listed, (pos >= 0).astype(np.int64))
        assert np.all(idx[pos < 0] == 0xFFFF)
        same = ent[1:] == ent[:-1]
        assert np.all(j[1:][same] > j[:-1][same])


@pytest.mark.parametrize("name", sorted(LAYOUTS))
def test_row_lists_follow_window_then_chunk_order(name):
    """Every entry has one place; row r's places hold the entries of row r,
    by window j = 0..2h (the block b_r + h - j descending) and then chunk
    ascending; a row with no entry has no place."""
    lay, tabs = _layout(name), _tables(name)
    for key, pos, k, OW, h, n in _spaces(lay):
        t = tabs[key]
        dst, row_ptr = t.dst.numpy(), t.row_ptr.numpy()
        assert row_ptr[0] == 0 and row_ptr[-1] == t.E and len(row_ptr) == n + 1
        assert np.array_equal(np.sort(dst), np.arange(t.E))
        at = np.empty(t.E, dtype=np.int64)
        at[dst] = np.arange(t.E)  # the entry at each place
        eb, ec = _entry_chunks(lay, t)
        rows = t.row.numpy()[at]
        assert np.array_equal(rows, np.repeat(np.arange(n), np.diff(row_ptr)))
        window = rows // OW + h - eb[at]
        assert window.min() >= 0 and window.max() <= 2 * h
        same = rows[1:] == rows[:-1]
        later = (window[1:] > window[:-1]) | ((window[1:] == window[:-1])
                                              & (ec[at][1:] > ec[at][:-1]))
        assert np.all(later[same])


@pytest.mark.parametrize("name", sorted(LAYOUTS))
def test_indices_fit_16_bits(name):
    """Entry indices and (slot, dof) codes are stored as uint16 bits in
    int16, 0xFFFF only for a padded slot; rows, places and offsets are
    int32."""
    lay, tabs = _layout(name), _tables(name)
    for key, pos, k, OW, h, n in _spaces(lay):
        t = tabs[key]
        assert t.idx.dtype == torch.int16 and t.tr.dtype == torch.int16
        assert tuple(t.idx.shape) == (lay.nb, k, lay.Bmax)
        idx = t.idx.numpy().astype(np.int64) & 0xFFFF
        assert idx[pos >= 0].max() < t.max_entries < 0xFFFF
        assert (t.tr.numpy().astype(np.int64) & 0xFFFF).max() < k * lay.Bc <= 0x10000
        for name_ in ("off", "row", "dst", "tr_off", "row_ptr"):
            assert getattr(t, name_).dtype == torch.int32


def test_chunk_lists_too_large_raise(monkeypatch):
    """A layout whose chunk lists need more shared memory than a block may
    use raises ValueError naming the numbers: here the smallest layout
    against a limit 4 bytes short of its need; and at P3/P2, on triangles
    and on tetrahedra, a limit 4 bytes short of the largest need of the
    streaming kernel's products (2 stages of float32 A) and, on
    tetrahedra, of the block kernel's."""
    p3 = {name: (_layout(name), _tables(name)) for name in ("p3-square-h1", "p3-box-h1")}
    lay = _layout("box-h1")
    need = tw.compact_smem_bytes(lay, _tables("box-h1"))
    assert need <= tw._MAX_SMEM_BYTES
    monkeypatch.setattr(tw, "_MAX_SMEM_BYTES", need - 4)
    with pytest.raises(ValueError, match=f"a chunk of 128 slots .* needs {need} bytes"):
        tw.compact_tables(lay)
    for lay, tabs in p3.values():
        needs = {pair: tw.stream_smem_bytes(lay, tabs, 4, 2, *pair)
                 for pair in tw.streamed_products(lay)}
        need = max([*needs.values()] + ([tw.compact_smem_bytes(lay, tabs)] if lay.dim == 3
                                        else []))
        if lay.dim == 2:
            assert need == max(needs.values())
        monkeypatch.setattr(tw, "_MAX_SMEM_BYTES", need)
        tw.compact_tables(lay)
        monkeypatch.setattr(tw, "_MAX_SMEM_BYTES", need - 4)
        with pytest.raises(ValueError, match=f"a chunk of 128 slots .* needs {need} bytes"):
            tw.compact_tables(lay)


def _operands(lay, ins, outs, seed):
    rng = np.random.default_rng(seed)
    A = torch.as_tensor(rng.standard_normal((lay.nl, lay.nli, lay.ncd)))
    x = torch.as_tensor(rng.standard_normal(lay.n_u + lay.n_ps))
    if ins == "vp":
        return A, x
    xs = x[: lay.n_u] if ins == "v" else x[lay.n_u :]
    return tw.slice_block(lay, A, ins, outs), xs


def _close(got, want, rel=1e-12):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= rel * np.abs(want).max(), (
        np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("ins, outs", PRODUCTS)
@pytest.mark.parametrize("name", sorted(LAYOUTS))
def test_compact_model_matches_plain_f64(name, ins, outs):
    """The two-stage model through the tables equals the plain versions of
    K1 (vp->vp) and K2 (v->v, v->p, p->p) in float64."""
    lay = _layout(name)
    A, x = _operands(lay, ins, outs, 3)
    got = tw._compact_matvec_reference(lay, A, x, ins, outs, _tables(name))
    if ins == "vp":
        want = tw.windowed_matvec_reference(lay, A, x)
    else:
        want = tw._block_reference(lay, A, x, ins, outs)
    _close(got, want)


@pytest.mark.parametrize("ins, outs", PRODUCTS)
def test_compact_model_matches_jax_f64(ins, outs):
    """On box-refined-Bc256 the model, on the port's copy of the JAX
    package's layout (``convert``), equals the JAX package's plain
    windowed_matvec_reference / _block_reference in float64."""
    _model_matches_jax("box-refined-Bc256", ins, outs)


@pytest.mark.parametrize("ins, outs", PRODUCTS)
def test_compact_model_matches_jax_f64_p3(ins, outs):
    """The same at P3/P2, on p3-box-h1."""
    _model_matches_jax("p3-box-h1", ins, outs)


@pytest.mark.parametrize("ins, outs", PRODUCTS)
def test_compact_model_matches_jax_f64_p3_triangles(ins, outs):
    """The same on P3/P2 triangles, p3-square-h2 (halo 2): the JAX
    package's windowed_matvec_reference / _block_reference in float64."""
    _model_matches_jax("p3-square-h2", ins, outs)


@pytest.mark.parametrize("ins, outs", PRODUCTS)
def test_compact_model_matches_jax_f64_p3_triangle_chunks(ins, outs):
    """The same on P3/P2 triangles of several blocks of several chunks,
    p3-square-chunks (K2 v->p and p->p there: the narrow kernels' order)."""
    lay = _layout("p3-square-chunks")
    assert lay.nb > 1 and lay.nchunks > 1
    _model_matches_jax("p3-square-chunks", ins, outs)


def _model_matches_jax(name, ins, outs):
    args, kw = _build(LAYOUTS[name])
    jlay = jw.build_windowed_layout(*args, **kw)
    lay = convert.layout_from_arrays(convert.arrays_of(jlay))
    A, x = _operands(lay, ins, outs, 4)
    got = tw._compact_matvec_reference(lay, A, x, ins, outs)
    if ins == "vp":
        want = jw.windowed_matvec_reference(jlay, jnp.asarray(A.numpy()), jnp.asarray(x.numpy()))
    else:
        want = jw._block_reference(jlay, jnp.asarray(A.numpy()), jnp.asarray(x.numpy()), ins,
                                   outs, None)
    _close(got, want)


def _rows(lay, seed):
    """Seeded per-slot rows R [nli, ncd], the scatter's input."""
    return torch.as_tensor(np.random.default_rng(seed).standard_normal((lay.nli, lay.ncd)))


@pytest.mark.parametrize("name", sorted(LAYOUTS))
def test_compact_scatter_model_matches_plain_f64(name):
    """K4's two-stage model through the tables (per-chunk entry sums, the
    row-list merge) equals the plain scatter in float64."""
    lay = _layout(name)
    R = _rows(lay, 5)
    _close(tw._compact_scatter_reference(lay, R, _tables(name)), tw._scatter_reference(lay, R))


def test_compact_scatter_model_matches_jax_f64():
    """On box-refined-Bc256 K4's model, on the port's copy of the JAX
    package's layout (``convert``), equals the JAX package's
    windowed_scatter (its plain path on the CPU) in float64."""
    _scatter_model_matches_jax("box-refined-Bc256")


def test_compact_scatter_model_matches_jax_f64_p3():
    """The same at P3/P2, on p3-box-h1."""
    _scatter_model_matches_jax("p3-box-h1")


def _scatter_model_matches_jax(name):
    args, kw = _build(LAYOUTS[name])
    jlay = jw.build_windowed_layout(*args, **kw)
    lay = convert.layout_from_arrays(convert.arrays_of(jlay))
    R = _rows(lay, 6)
    _close(tw._compact_scatter_reference(lay, R), jw.windowed_scatter(jlay, jnp.asarray(R.numpy())))


def _occupied_pieces(lay):
    """{piece b*nchunks + c: occupied slots of the chunk} of a layout."""
    _, _, cnt = tw.pack_positions(lay)
    out = {}
    for b, n in enumerate(cnt.tolist()):
        for c in range(lay.nchunks):
            if n > c * lay.Bc:
                out[b * lay.nchunks + c] = min(n - c * lay.Bc, lay.Bc)
    return out


@pytest.mark.parametrize("name", sorted(LAYOUTS))
def test_stream_work_takes_every_occupied_chunk_once(name):
    """The streaming K1's work list, the host's model of its persistent
    schedule (block k of the grid takes entries k, k + grid, ...), holds
    every chunk with an occupied slot exactly once, most occupied first
    (ties by piece), as int32."""
    lay = _layout(name)
    _, _, cnt = tw.pack_positions(lay)
    work = tw.stream_work(lay, cnt)
    assert work.dtype == torch.int32
    occ = _occupied_pieces(lay)
    got = work.tolist()
    assert sorted(got) == sorted(occ)
    assert got == sorted(occ, key=lambda p: (-occ[p], p))


@pytest.mark.parametrize("name", sorted(LAYOUTS))
def test_stream_records_hold_each_chunks_offsets(name):
    """The streaming kernel's work records (``stream_records``, windowed.cu
    WorkRec), one a chunk of ``stream_work``'s list in its order: the
    piece, its occupied slots, each space's first entry, entries, first
    (slot, dof) pair and pairs of the chunk, and each space's pairs in all,
    as int32 [n_work, 12]."""
    lay, tabs = _layout(name), _tables(name)
    _, _, cnt = tw.pack_positions(lay)
    work = tw.stream_work(lay, cnt)
    rec = tw.stream_records(lay, cnt, tabs)
    assert rec.dtype == torch.int32 and tuple(rec.shape) == (len(work), 12)
    assert torch.equal(rec, tw.stream_records(lay, cnt, tabs, work))
    occ = _occupied_pieces(lay)
    rec = rec.numpy().astype(np.int64)
    assert rec[:, 0].tolist() == work.tolist()
    assert rec[:, 1].tolist() == [occ[p] for p in work.tolist()]
    for k, key in enumerate("vp"):
        t = tabs[key]
        off, tr_off = t.off.numpy().astype(np.int64), t.tr_off.numpy().astype(np.int64)
        e0, e1 = off[rec[:, 0]], off[rec[:, 0] + 1]
        got = rec[:, 2 + 4 * k: 6 + 4 * k]
        assert np.array_equal(got, np.stack([e0, e1 - e0, tr_off[e0], tr_off[e1] - tr_off[e0]], 1))
        assert np.all(rec[:, 10 + k] == t.tr.numel())


@pytest.mark.parametrize("name", sorted(LAYOUTS))
def test_entry_first_pairs_count_from_their_chunk(name):
    """tr_rel[e], the table the streaming K1 stages an entry's pairs by, is
    the entry's first pair counted from its chunk's first: below the
    chunk's pair count, uint16 bits in int16, one a chunk's entry."""
    lay, tabs = _layout(name), _tables(name)
    for key in "vp":
        t = tabs[key]
        off, tr_off = t.off.numpy(), t.tr_off.numpy().astype(np.int64)
        rel = t.tr_rel.numpy().astype(np.int64) & 0xFFFF
        assert t.tr_rel.dtype == torch.int16 and rel.shape == (t.E,)
        eb, ec = _entry_chunks(lay, t)
        first = off[eb * lay.nchunks + ec]  # each entry's chunk's first entry
        assert np.array_equal(rel, tr_off[:-1] - tr_off[first])
        assert np.all(rel < tr_off[first + np.diff(off)[eb * lay.nchunks + ec]] - tr_off[first])


@pytest.mark.parametrize("name", sorted(n for n in LAYOUTS if n.startswith("p3-")))
def test_stream_smem_fits_the_p3_layouts(name):
    """The streaming kernel's shared memory (``stream_smem_bytes``, the
    mirror of windowed.cu stream_smem): at every P3/P2 layout, for each
    product it serves, a ring of two stages, the least the kernel runs
    with, fits a block with bfloat16 and with float32 A (what
    ``compact_tables`` checks).  K1's stage is a column of A (nl rows of
    Bc values), half a column on tetrahedra with float32 A; a block
    product's is G columns of its out-rows, the most that divide its
    in-rows within 52 bytes a slot (one where none fits)."""
    lay, tabs = _layout(name), _tables(name)
    assert tw.streams_k1(lay)
    rows = {"v": lay.dim * lay.k_v, "p": lay.k_p, "vp": lay.nl}
    for ins, outs in tw.streamed_products(lay):
        for elt in (2, 4):
            def smem(stages):
                return tw.stream_smem_bytes(lay, tabs, elt, stages, ins, outs)

            stage = smem(1) - smem(0)
            if ins == outs == "vp":
                split = 2 if (lay.dim, elt) == (3, 4) else 1
                assert stage == lay.nl // split * lay.Bc * elt
            else:
                g = tw.stream_group(lay, elt, ins, outs)
                assert rows[ins] % g == 0 and (g == 1 or g * rows[outs] * elt <= 52)
                assert all(rows[ins] % h or h * rows[outs] * elt > 52
                           for h in range(g + 1, rows[ins] + 1))
                assert stage == g * rows[outs] * lay.Bc * elt
            assert smem(2) <= tw._MAX_SMEM_BYTES


@pytest.mark.parametrize("name", sorted(LAYOUTS))
def test_at_is_the_inverse_of_dst(name):
    """``at`` (the entry at each place, through which the streaming K1's
    merge reads its entry-ordered scratch) is dst's inverse."""
    tabs = _tables(name)
    for key in "vp":
        t = tabs[key]
        at, dst = t.at.numpy(), t.dst.numpy()
        assert t.at.dtype == torch.int32 and at.shape == (t.E,)
        assert np.array_equal(at[dst], np.arange(t.E)) and np.array_equal(dst[at], np.arange(t.E))


@pytest.mark.parametrize("name", ["p3-square-h1", "p3-box-h1"])
def test_kernel_bench_bit_equal_holds_saved_outputs(name, tmp_path):
    """kernel_bench's ``--save`` / ``--compare`` (``_host_outputs``,
    ``bit_equal``): every wrapper's output at the seeded operands of a bare
    layout, saved and loaded, equals a second run's bit for bit; one bit
    flipped in one output, or a name missing, reads False for that name
    alone."""
    from navier_stokes_tpu_torch.scripts import kernel_bench as kb

    lay = _layout(name)
    runs = []
    for _ in range(2):
        calls, _ = kb.seeded_operands(lay, seed=3)
        runs.append({key: kb._host_outputs(call()) for key, (call, _) in calls.items()})
    torch.save(runs[0], tmp_path / "ref.pt")
    ref = torch.load(tmp_path / "ref.pt")
    assert set(ref) >= {"K1", "K1 f32", "K3", "K3 pair", "K4"}
    assert all(kb.bit_equal(runs[1], ref).values())
    flipped = dict(runs[1])
    y = flipped["K1"][0].clone()
    y.view(torch.int32)[0] ^= 1
    flipped["K1"] = (y,)
    del flipped["K4"]
    got = kb.bit_equal(flipped, ref)
    assert not got["K1"] and not got["K4"]
    assert all(v for key, v in got.items() if key not in ("K1", "K4"))


@pytest.mark.parametrize("ins, outs", PRODUCTS)
@pytest.mark.parametrize("element", [(2, 6, 3), (2, 10, 6), (3, 10, 4), (3, 20, 10)])
def test_streamed_products_are_the_p3_pairs(element, ins, outs):
    """The streaming kernel serves K1 and K2 v->v on P3/P2 triangles (their
    v->p and p->p run on the narrow kernels), K1, v->p and p->p on P3/P2
    tetrahedra (their v->v stays on the 3D block kernel), and nothing at
    P2/P1: the three K2 pairs and the two K1s of windowed.cu ``streams``."""
    dim, k_v, k_p = element
    lay = SimpleNamespace(dim=dim, k_v=k_v, k_p=k_p, RVv=1, RVp=1, Bc=128)  # subwindows that fit
    want = ((element == (2, 10, 6) and (ins, outs) in (("vp", "vp"), ("v", "v")))
            or (element == (3, 20, 10) and (ins, outs) != ("v", "v")))
    assert tw.streams(lay, ins, outs) == want
    assert ((ins, outs) in tw.streamed_products(lay)) == want
    assert tw.streams_k1(lay) == (k_v in (10, 20) and (dim, k_v) != (3, 10))
    narrow = element == (2, 10, 6) and (ins, outs) in (("v", "p"), ("p", "p"))
    design = tw.matvec_design(lay, ins, outs)
    assert design.startswith("stream_matvec_kernel" if want else
                             "narrow_product_kernel" if narrow else
                             ("matvec3_kernel" if dim == 3 else "matvec_kernel"))


@pytest.mark.parametrize("name", ["p3-square-h1", "p3-box-h1", "square-p2"])
def test_moved_bytes_compact_counts_the_streamed_products(name):
    """``kernel_bench.moved_bytes_compact`` gives rows for K1, every
    compact K2 product and K4: on P3/P2 tetrahedra all three products, on
    P3/P2 triangles all three too (the streamed v->v, the narrow v->p and
    p->p) and K4 (the row-ordered sum), on P2/P1 triangles none.  A
    product moves A's used
    rows in occupied slots and more (tables, x, the scratch each way, y);
    a product that moves fewer rows of A moves fewer bytes."""
    from navier_stokes_tpu_torch.scripts import kernel_bench as kb

    if name == "square-p2":
        args, kw = _build(dict(n=6, cpb=16, Bc=128))
        lay = tw.build_windowed_layout(*args, **kw)
    else:
        lay = _layout(name)
    _, operands = kb.seeded_operands(lay, seed=2)
    moved = kb.moved_bytes_compact(lay, operands)
    if lay.k_v == 6:
        assert moved == {}
        return
    k2 = {"K2 v->v", "K2 v->p", "K2 p->p"}
    assert set(moved) == {"K1", "K1 f32", "K4"} | k2
    _, _, cnt = tw.pack_positions(lay)
    rows = {"v": lay.dim * lay.k_v, "p": lay.k_p, "vp": lay.nl}
    for key in k2:
        ins, outs = key.split()[1].split("->")
        a = rows[ins] * rows[outs] * int(cnt.sum()) * 2
        assert moved[key] > a
    order = [key for key in ("K2 p->p", "K2 v->p", "K2 v->v", "K1", "K1 f32") if key in moved]
    assert all(moved[a] < moved[b] for a, b in zip(order, order[1:]))
