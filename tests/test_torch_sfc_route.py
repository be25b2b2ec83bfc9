"""The compact route of the 2D P2/P1 kernels on Morton-ordered layouts.

Along a Morton curve (``renumber_blocked(order="sfc")``) a chunk's cells
spread over most of their window, so the 2D subwindow kernels' shared
memory outgrows a block's; such a layout runs K1, K2 and K4 on the compact
kernels (csrc/windowed.cu ``matvec3_kernel<2, 6, 3>`` + ``merge3_kernel``
and ``scatter_rows_kernel<2, 6>``).  Here, on the CPU:

* at a small channel's Morton layout (the port's and JAX's layouts equal),
  the compact plain versions of K1, K2 v->v / v->p / p->p
  (``_compact_matvec_reference``) and K4 (``_compact_scatter_reference``)
  against JAX's ``windowed_matvec_reference`` / ``_block_reference`` /
  ``_scatter_reference`` in float64, within 1e-12 of ||y||_inf (the same
  sums in another order);
* the host's route (``compact_layout``, ``matvec_design``,
  ``scatter_design``) from the layout alone, built on the CPU: the compact
  kernels at the 25,600-cell channel's Morton layout, the subwindow kernels
  at its RCM layout (the solver's), and the packed record that tells the
  kernels so;
* the 2D P2/P1 row lists (``row_list``) walked by the kernel's mirror
  (``_scatter_rows_reference``) give ``_compact_scatter_reference``'s bits
  in float32.

The kernels on the card: chip_smoke.py phase 17(e).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from navier_stokes_tpu.fem.dofs import make_dofs as j_make_dofs
from navier_stokes_tpu.fem.dofs import renumber_blocked as j_renumber_blocked
from navier_stokes_tpu.mesh.generate import rectangle as j_rectangle
from navier_stokes_tpu.ops import windowed as jw
from navier_stokes_tpu_torch import convert
from navier_stokes_tpu_torch.fem.dofs import make_dofs, renumber_blocked
from navier_stokes_tpu_torch.mesh.generate import rectangle
from navier_stokes_tpu_torch.mesh.mesh import refine_uniform
from navier_stokes_tpu_torch.ops import windowed as tw
from navier_stokes_tpu_torch.scripts import kernel_bench as kb

SMALL = dict(nx=40, ny=20, cpb=200, Bc=128)  # 800 cells: 8 blocks of 2 chunks, halo 3
PRODUCTS = [("vp", "vp"), ("v", "v"), ("v", "p"), ("p", "p")]


def _layout(make_dofs_, renumber, build, rect, order):
    c = SMALL
    mesh = rect(c["nx"], c["ny"], 0, 7, 0, 4)
    dofs, bi = renumber(make_dofs_(mesh, 2, 1), cells_per_block=c["cpb"], order=order)
    return build(dofs.cell_vdofs, dofs.cell_pdofs, dofs.n_vs, dofs.n_ps, mesh.dim,
                 block_info=bi, Bc=c["Bc"])


@functools.lru_cache(maxsize=None)
def _small():
    """The small channel's Morton layouts of both packages and seeded
    float64 operands."""
    jlay = _layout(j_make_dofs, j_renumber_blocked, jw.build_windowed_layout, j_rectangle, "sfc")
    tlay = _layout(make_dofs, renumber_blocked, tw.build_windowed_layout, rectangle, "sfc")
    rng = np.random.default_rng(19)
    n = tlay.n_u + tlay.n_ps
    return dict(jlay=jlay, tlay=tlay, x=rng.standard_normal(n),
                A=rng.standard_normal((tlay.nl, tlay.nli, tlay.ncd)),
                R=rng.standard_normal((tlay.nli, tlay.ncd)))


def _close(got, want, rel=1e-12):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= rel * np.abs(want).max()


def test_small_morton_layout_is_jax_s_and_spans_windows():
    """The port's Morton layout is JAX's, table for table, and it is a
    layout of the kind the route is for: halos past 1 block, several chunks
    a block."""
    case = _small()
    j, t = convert.arrays_of(case["jlay"]), convert.arrays_of(case["tlay"])
    assert j.keys() == t.keys()
    for k, v in j.items():
        assert (np.array_equal(v, t[k]) if isinstance(v, np.ndarray) else v == t[k]), k
    lay = case["tlay"]
    assert lay.hv >= 2 and lay.nchunks >= 2 and lay.nb >= 8


@pytest.mark.parametrize("ins, outs", PRODUCTS)
def test_compact_matvec_plain_matches_jax_f64(ins, outs):
    """K1 (vp->vp) and each K2 product in the compact kernels' order against
    JAX's plain references."""
    case = _small()
    jlay, tlay = case["jlay"], case["tlay"]
    A, x, n_u = case["A"], case["x"], tlay.n_u
    xs = {"vp": x, "v": x[:n_u], "p": x[n_u:]}[ins]
    if (ins, outs) == ("vp", "vp"):
        want = jw.windowed_matvec_reference(jlay, jnp.asarray(A), jnp.asarray(x))
        A_sub = torch.as_tensor(A)
    else:
        A_sub = tw.slice_block(tlay, torch.as_tensor(A), ins, outs)
        want = jw._block_reference(jlay, jw.slice_block(jlay, jnp.asarray(A), ins, outs),
                                   jnp.asarray(xs), ins, outs, None)
    got = tw._compact_matvec_reference(tlay, A_sub, torch.as_tensor(xs), ins, outs)
    _close(got, want)


def test_compact_scatter_plain_matches_jax_f64():
    case = _small()
    want = jw._scatter_reference(case["jlay"], jnp.asarray(case["R"]))
    _close(tw._compact_scatter_reference(case["tlay"], torch.as_tensor(case["R"])), want)


def test_row_lists_give_the_compact_scatter_bits():
    """K4's mirror over both spaces' row lists is ``_compact_scatter_reference``
    bit for bit in float32 (the same additions in the same order)."""
    lay = _small()["tlay"]
    tabs = tw.compact_tables(lay)
    rows = {s: tw.row_list(lay, tabs[s]) for s in "vp"}
    R = torch.as_tensor(_small()["R"], dtype=torch.float32)
    got = tw._scatter_rows_reference(lay, R, rows)
    assert torch.equal(got, tw._compact_scatter_reference(lay, R, tabs))


@pytest.mark.parametrize("order", ["sfc", "rcm"])
def test_route_is_chosen_from_the_layout(order):
    """The 25,600-cell channel (``refine_uniform(rectangle(80, 40, 0, 7, 0,
    4), 1)``) at the solver's 448 cells a block (doubled until the halo
    fits, as ``kernel_bench.bare_layout`` does): along the Morton curve the
    subwindows outgrow a block's shared memory and the layout takes the
    compact kernels, whose tables fit; the RCM layout keeps the subwindow
    kernels and its slot colours.  The layout is built on the CPU, no
    kernel is launched."""
    mesh = refine_uniform(rectangle(80, 40, 0, 7, 0, 4), 1)
    lay, _ = kb.bare_layout(mesh, kb.channel_config(), device="cpu", order=order)
    compact = order == "sfc"
    assert (tw.span_smem_bytes(lay) > tw._MAX_SMEM_BYTES) == compact
    assert tw.compact_layout(lay) == compact
    pk = lay._packed
    assert pk.meta[19] == int(compact)
    if compact:
        assert [tw.matvec_design(lay, *p) for p in PRODUCTS] == (
            ["matvec3_kernel + merge3_kernel"] * 4)
        assert tw.scatter_design(lay) == "scatter_rows_kernel"
        assert pk.colour is None and pk.ncolors == 0
        tabs = tw.compact_tables(lay)  # raises where the compact kernels cannot take it
        assert tw.compact_smem_bytes(lay, tabs) <= tw._MAX_SMEM_BYTES
        assert pk.compact_args is not None
        assert pk.rows["v"] is not None and pk.rows["p"] is not None
    else:
        assert [tw.matvec_design(lay, *p) for p in PRODUCTS] == (
            ["matvec_kernel + merge_kernel"] * 4)
        assert tw.scatter_design(lay) == "scatter_kernel + merge_kernel<., true>"
        assert pk.ncolors > 0 and pk.compact_args is None
