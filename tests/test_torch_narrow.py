"""K2's narrow products on P3/P2 triangles (v->p and p->p) on the host.

On P3/P2 triangles K2 v->p and p->p run on two kernels of their own
(csrc/windowed.cu ``narrow_product_kernel`` and ``narrow_merge_kernel``): a
thread a slot writes its 6 pressure sums to Y [k_p, ncd], then a thread a
pressure row sums the row's places in order, each place its (slot, dof)
pairs in order, through a row list flattened once on the host from the
compact tables (``ops/windowed.py`` ``row_list``).  Here, on the CPU:

* the row list: every (slot, dof) pair of an occupied slot once, in the
  order of ``_compact_matvec_reference`` (a row's places by window and
  chunk, an entry's pairs slots ascending), each place's first pair
  flagged, int32;
* the Python mirrors of the two kernels (``_narrow_product_reference``,
  ``_row_walk_reference``) against ``_compact_matvec_reference`` bit
  for bit in float32 (the same sums in the same order), and against the
  JAX package's ``_block_reference`` in float64 to 1e-12 of ||y||_inf (the
  same sums in another order) on a layout of several blocks of several
  chunks;
* which products the narrow kernels serve (``kernel_design``), and that a
  CPU tensor takes the plain path and launches nothing.

Layouts (P3/P2: 10 velocity and 6 pressure dofs a triangle): unit_square(12)
refined once at 448 cells a block in chunks of 256 (3 blocks of 2 chunks),
unit_square(8) at halo 2, and rank 0 of 2 of unit_square(8)'s framed
layout.  The kernels on the card: tests/test_torch_kernels.py.
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
from navier_stokes_tpu_torch.mesh.generate import unit_square
from navier_stokes_tpu_torch.mesh.mesh import refine_uniform
from navier_stokes_tpu_torch.ops import windowed as tw
from navier_stokes_tpu_torch.parallel import windowed_spmd as ws

LAYOUTS = {
    "p3-square-chunks": dict(n=12, refine=1, cpb=448, Bc=256),
    "p3-square-h2": dict(n=8, cpb=8, Bc=128),
    "p3-square-framed-r0of2": dict(n=8, cpb=16, Bc=128, rank=0, ranks=2),
}
NARROW = [("v", "p"), ("p", "p")]


def _build(c):
    mesh = unit_square(c["n"])
    if c.get("refine"):
        mesh = refine_uniform(mesh, c["refine"])
    dofs, bi = renumber_blocked(make_dofs(mesh, 3, 2), cells_per_block=c["cpb"],
                                nb_multiple=c.get("ranks", 1))
    return (dofs.cell_vdofs, dofs.cell_pdofs, dofs.n_vs, dofs.n_ps, 2), dict(block_info=bi,
                                                                              Bc=c["Bc"])


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


def _operands(lay, ins, seed, dtype):
    rng = np.random.default_rng(seed)
    A = torch.as_tensor(rng.standard_normal((lay.nl, lay.nli, lay.ncd)), dtype=dtype)
    x = torch.as_tensor(rng.standard_normal(lay.n_u + lay.n_ps), dtype=dtype)
    return tw.slice_block(lay, A, ins, "p"), x[: lay.n_u] if ins == "v" else x[lay.n_u :]


def test_layouts_reach_several_blocks_chunks_and_a_frame():
    """The layouts reach several blocks of several chunks, halos 1 and 2
    and a framed layout; each is P3/P2 on triangles, where K2 v->p and
    p->p are narrow."""
    lays = [_layout(name) for name in LAYOUTS]
    assert {(lay.dim, lay.k_v, lay.k_p) for lay in lays} == {(2, 10, 6)}
    assert all(tw.narrow_products(lay) == tuple(NARROW) for lay in lays)
    assert any(lay.nb > 1 and lay.nchunks > 1 for lay in lays)
    assert {lay.hv for lay in lays} == {1, 2}
    assert any(lay.frame for lay in lays)


@pytest.mark.parametrize("name", sorted(LAYOUTS))
def test_row_list_holds_every_pair_once_in_compact_order(name):
    """``row_list`` of the pressure: row r's pairs are its places (the
    entries at row_ptr[r]:row_ptr[r + 1] through ``at``) in order, each
    place's (slot, dof) pairs in the order of ``tr`` (slots ascending), as
    indices l*ncd + s into Y with bit 31 set on a place's first pair; every
    pair of an occupied slot appears once; int32 tables."""
    lay, t = _layout(name), _tables(name)["p"]
    ptr, lst = tw.row_list(lay, t)
    assert ptr.dtype == torch.int32 and lst.dtype == torch.int32
    ptr, lst = ptr.numpy().astype(np.int64), lst.numpy().astype(np.int64)
    assert len(ptr) == lay.n_ps + 1 and ptr[0] == 0 and ptr[-1] == len(lst) == t.tr.numel()
    # the sequence the compact order gives, place by place
    off, tr_off = t.off.numpy().astype(np.int64), t.tr_off.numpy().astype(np.int64)
    code = t.tr.numpy().astype(np.int64) & 0xFFFF
    piece = np.repeat(np.arange(len(off) - 1), np.diff(off))
    want, first, row_pairs = [], [], np.zeros(lay.n_ps, dtype=np.int64)
    row_ptr = t.row_ptr.numpy()
    for r in range(lay.n_ps):
        for e in t.at.numpy()[row_ptr[r] : row_ptr[r + 1]]:
            p = piece[e]
            for k in range(tr_off[e], tr_off[e + 1]):
                s = (p // lay.nchunks) * lay.Bmax + (p % lay.nchunks) * lay.Bc + code[k] % lay.Bc
                want.append((code[k] // lay.Bc) * lay.ncd + s)
                first.append(k == tr_off[e])
                row_pairs[r] += 1
    assert np.array_equal(lst & 0x7FFFFFFF, want)
    assert np.array_equal(lst < 0, first)
    assert np.array_equal(np.diff(ptr), row_pairs)
    # every (slot, dof) pair of an occupied slot once
    pos = tw.unpack_positions(tw.pack_positions(lay)[1]).numpy()  # [nb, k_p, Bmax]
    b, l, j = np.nonzero(pos >= 0)
    occupied = np.sort(l * lay.ncd + b * lay.Bmax + j)
    assert np.array_equal(np.sort(lst & 0x7FFFFFFF), occupied)


@pytest.mark.parametrize("name", sorted(LAYOUTS))
def test_narrow_merge_mirror_is_the_compact_scatter(name):
    """The merge's mirror over the row list gives
    ``_compact_scatter_reference``'s bits for the pressure (float32 sums
    in the same order)."""
    lay, tabs = _layout(name), _tables(name)
    Y = torch.as_tensor(np.random.default_rng(7).standard_normal((lay.k_p, lay.ncd)),
                        dtype=torch.float32)
    ptr, lst = tw.row_list(lay, tabs["p"])
    got = tw._row_walk_reference(ptr, lst, Y)
    assert got.dtype == torch.float32 and got.shape == (lay.n_ps,)
    assert torch.equal(got, tw._compact_scatter_reference(lay, Y, tabs, "p"))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ins", ["v", "p"])
@pytest.mark.parametrize("name", sorted(LAYOUTS))
def test_narrow_mirrors_give_the_compact_model_bits(name, ins, dtype):
    """The two kernels' mirrors, the product (x gathered at each slot's
    positions, columns ascending) and then the merge through the row list,
    give ``_compact_matvec_reference``'s bits for K2 ins->p, with float32 x
    and A stored in float32 or bfloat16 (widened on read)."""
    lay, tabs = _layout(name), _tables(name)
    A_sub, xs = _operands(lay, ins, 8, torch.float32)
    A_sub = A_sub.to(dtype)
    Y = tw._narrow_product_reference(lay, A_sub, xs, ins)
    assert Y.shape == (lay.k_p, lay.ncd) and Y.dtype == torch.float32
    got = tw._row_walk_reference(*tw.row_list(lay, tabs["p"]), Y)
    assert torch.equal(got, tw._compact_matvec_reference(lay, A_sub, xs, ins, "p", tabs))


@pytest.mark.parametrize("ins", ["v", "p"])
def test_narrow_mirrors_match_jax_f64(ins):
    """On the layout of several blocks of several chunks, built by the JAX
    package and copied (``convert``), the mirrors' chain equals the JAX
    package's plain ``_block_reference`` for K2 ins->p in float64, to 1e-12
    of ||y||_inf."""
    args, kw = _build(LAYOUTS["p3-square-chunks"])
    jlay = jw.build_windowed_layout(*args, **kw)
    lay = convert.layout_from_arrays(convert.arrays_of(jlay))
    assert lay.nb > 1 and lay.nchunks > 1
    A_sub, xs = _operands(lay, ins, 9, torch.float64)
    Y = tw._narrow_product_reference(lay, A_sub, xs, ins)
    got = tw._row_walk_reference(*tw.row_list(lay, tw.compact_tables(lay)["p"]), Y)
    want = np.asarray(jw._block_reference(jlay, jnp.asarray(A_sub.numpy()),
                                          jnp.asarray(xs.numpy()), ins, "p", None))
    got = got.numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()


@pytest.mark.parametrize("ins, outs", [("vp", "vp"), ("v", "v"), ("v", "p"), ("p", "p")])
@pytest.mark.parametrize("element", [(2, 6, 3), (2, 10, 6), (3, 10, 4), (3, 20, 10)])
def test_kernel_design_names_the_narrow_route(element, ins, outs):
    """The narrow kernels serve K2 v->p and p->p on P3/P2 triangles and no
    other product (windowed.cu ``narrow``): ``kernel_design`` names them
    there alone, and those two products are not streamed."""
    dim, k_v, k_p = element
    lay = SimpleNamespace(dim=dim, k_v=k_v, k_p=k_p)
    want = element == (2, 10, 6) and (ins, outs) in NARROW
    assert tw.narrow(lay, ins, outs) == want
    assert ((ins, outs) in tw.narrow_products(lay)) == want
    assert (tw.kernel_design(lay, ins, outs) ==
            "narrow_product_kernel + narrow_merge_kernel") == want
    if want:
        assert not tw.streams(lay, ins, outs)


@pytest.mark.parametrize("ins", ["v", "p"])
def test_cpu_wrapper_is_the_plain_version(ins):
    """On the CPU the K2 wrapper takes its plain version and launches
    nothing: within 1e-12 of the narrow mirrors' chain in float64."""
    lay, tabs = _layout("p3-square-chunks"), _tables("p3-square-chunks")
    A_sub, xs = _operands(lay, ins, 10, torch.float64)
    tw.reset_launch_counts()
    got = tw.windowed_matvec_block(lay, A_sub, xs, in_spaces=ins, out_spaces="p")
    assert tw.windowed_matvec_block.launches == 0
    want = tw._row_walk_reference(*tw.row_list(lay, tabs["p"]),
                                      tw._narrow_product_reference(lay, A_sub, xs, ins))
    assert (got - want).abs().max() <= 1e-12 * want.abs().max()
