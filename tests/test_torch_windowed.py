"""The port's windowed operator against the JAX package's.

* The layout: every table and static field equal to JAX's.
* The plain torch versions (the CPU path) against the JAX pure-jnp
  references in float64, to 1e-12 of ||y||_inf: the same sums in another
  order.  Cases cover halos of 1 and 2 blocks, several chunks per block,
  padded slots, and a vector shorter than nb*OW (the legacy layout path).
* In float32, against the JAX Pallas kernels run in interpret mode with
  passes=3 (an exact f32 split), to 1e-5 of ||y||_inf: float32 sums taken in
  another order (one-hot MXU dots there, direct gathers here).
* The kernels' packed position tables against ``_abs_loc``, and the plain
  version of their merge kernel against ``_combine_windows``.
* The cases are P2/P1 on triangles (unit squares) and on tetrahedra (unit
  cubes cut into 6 tetrahedra a cube: box(2, 2, 2), and
  refine_uniform(box(4, 4, 4), 1) at the solver's default block and chunk
  sizes, 3 chunks a block), and P3/P2 ("p3-": 10 + 6 dofs a triangle at
  halos of 1 and 2 blocks, 20 + 10 a tetrahedron).
* The CUDA kernels against the plain versions: tests/test_torch_kernels.py.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from navier_stokes_tpu.fem.dofs import make_dofs, renumber_blocked
from navier_stokes_tpu.mesh.generate import box, unit_square
from navier_stokes_tpu.mesh.mesh import refine_uniform
from navier_stokes_tpu.ops import windowed as jw
from navier_stokes_tpu_torch import convert
from navier_stokes_tpu_torch.ops import windowed as tw

CASES = {
    "blocked-h1": dict(n=6, cpb=16, Bc=128),
    "blocked-h2": dict(n=8, cpb=8, Bc=128),
    "legacy-h2-short": dict(n=12, target_ow=128, Bc=128),
    "legacy-3chunks": dict(n=12, target_ow=256, Bc=128),
    "blocked-Bc256": dict(n=12, cpb=16, Bc=256),
    "box-h1": dict(box=2, cpb=16, Bc=128),
    "box-refined-Bc256": dict(box=4, refine=1, cpb=448, Bc=256),
    "p3-blocked-h1": dict(n=6, cpb=16, Bc=128, deg=3),
    "p3-blocked-h2": dict(n=8, cpb=8, Bc=128, deg=3),
    "p3-box-h1": dict(box=2, cpb=16, Bc=128, deg=3),
}
BLOCKS = [("v", "v"), ("v", "p"), ("p", "p"), ("p", "v"), ("vp", "p")]


def _layouts(case):
    c = CASES[case]
    mesh = box(c["box"], c["box"], c["box"]) if "box" in c else unit_square(c["n"])
    if c.get("refine"):
        mesh = refine_uniform(mesh, c["refine"])
    dofs = make_dofs(mesh, c.get("deg", 2), c.get("deg", 2) - 1)
    if "cpb" in c:
        dofs, bi = renumber_blocked(dofs, cells_per_block=c["cpb"])
        kw = dict(block_info=bi, Bc=c["Bc"])
    else:
        kw = dict(target_ow=c["target_ow"], Bc=c["Bc"])
    args = (dofs.cell_vdofs, dofs.cell_pdofs, dofs.n_vs, dofs.n_ps, mesh.dim)
    return dofs, jw.build_windowed_layout(*args, **kw), tw.build_windowed_layout(*args, **kw)


@functools.lru_cache(maxsize=None)
def _case(name):
    dofs, jlay, tlay = _layouts(name)
    rng = np.random.default_rng(11)
    n = tlay.n_u + tlay.n_ps
    return dict(
        jlay=jlay,
        tlay=tlay,
        x=rng.standard_normal(n),
        A=rng.standard_normal((tlay.nl, tlay.nli, tlay.ncd)),
        R=rng.standard_normal((tlay.nli, tlay.ncd)),
    )


@pytest.fixture(params=sorted(CASES))
def case(request):
    return _case(request.param)


def _close(got, want, rel):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(np.abs(want).max(), 1e-300)
    assert np.abs(got - want).max() <= rel * scale, np.abs(got - want).max() / scale


def test_layout_equal(case):
    j = convert.arrays_of(case["jlay"])
    # convert rebuilds the same layout from the JAX object's arrays
    for tlay in (case["tlay"], convert.layout_from_arrays(j)):
        t = convert.arrays_of(tlay)
        assert j.keys() == t.keys()
        for k, v in j.items():
            if isinstance(v, np.ndarray):
                assert t[k].dtype == np.int32 and np.array_equal(v, t[k]), k
            else:
                assert v == t[k], k


@pytest.mark.parametrize("op", ["gather", "scatter", "matvec"])
def test_plain_matches_jax_reference_f64(case, op):
    jlay, tlay = case["jlay"], case["tlay"]
    x, A, R = case["x"], case["A"], case["R"]
    if op == "gather":
        want = jw._gather_reference(jlay, jnp.asarray(x))
        got = tw._gather_reference(tlay, torch.as_tensor(x))
    elif op == "scatter":
        want = jw._scatter_reference(jlay, jnp.asarray(R))
        got = tw._scatter_reference(tlay, torch.as_tensor(R))
    else:
        want = jw.windowed_matvec_reference(jlay, jnp.asarray(A), jnp.asarray(x))
        got = tw.windowed_matvec_reference(tlay, torch.as_tensor(A), torch.as_tensor(x))
    _close(got, want, 1e-12)


@pytest.mark.parametrize("ins,outs", BLOCKS)
def test_block_plain_matches_jax_reference_f64(case, ins, outs):
    jlay, tlay = case["jlay"], case["tlay"]
    A_sub = tw.slice_block(tlay, torch.as_tensor(case["A"]), ins, outs)
    jA_sub = jw.slice_block(jlay, jnp.asarray(case["A"]), ins, outs)
    assert tw.block_shape(tlay, ins, outs) == jw.block_shape(jlay, ins, outs)
    assert np.array_equal(A_sub.numpy(), np.asarray(jA_sub))
    n_u = tlay.n_u
    xs = case["x"][:n_u] if ins == "v" else case["x"][n_u:] if ins == "p" else case["x"]
    want = jw._block_reference(jlay, jA_sub, jnp.asarray(xs), ins, outs, None)
    got = tw.windowed_matvec_block(
        tlay, A_sub, torch.as_tensor(xs), in_spaces=ins, out_spaces=outs
    )
    _close(got, want, 1e-12)


def test_windows_and_block_form_match_jax(case):
    jlay, tlay = case["jlay"], case["tlay"]
    x = case["x"]
    for c in range(tlay.dim):
        seg = x[c * tlay.n_vs : (c + 1) * tlay.n_vs]
        want = jw.build_windows(jnp.asarray(seg), jlay.nb, jlay.OWv, jlay.hv)
        got = tw.build_windows(torch.as_tensor(seg), tlay.nb, tlay.OWv, tlay.hv)
        assert np.array_equal(got.numpy(), np.asarray(want))
    nc = int(tlay.cell_ids.max()) + 1
    cm = np.random.default_rng(2).standard_normal((nc, tlay.nl, tlay.nl))
    want = jw.to_block_form(jlay, jnp.asarray(cm))
    got = tw.to_block_form(tlay, torch.as_tensor(cm))
    assert np.array_equal(got.numpy(), np.asarray(want))


KERNEL_OPS = ["gather", "scatter", "matvec", "matvec-bf16A", "v->v", "v->p", "p->p"]


@pytest.mark.parametrize("name", ["blocked-h1", "blocked-h2", "box-h1", "p3-blocked-h1"])
@pytest.mark.parametrize("op", KERNEL_OPS)
def test_plain_matches_pallas_interpret_f32(name, op):
    """float32: the port's plain versions against the Pallas kernels in
    interpret mode (passes=3), 1e-5 of ||y||_inf (summation order)."""
    case = _case(name)
    jlay, tlay = case["jlay"], case["tlay"]
    x = case["x"].astype(np.float32)
    A = case["A"].astype(np.float32)
    kw = dict(passes=3, interpret=True)
    if op == "gather":
        want = jw.windowed_gather(jlay, jnp.asarray(x), **kw)
        got = tw.windowed_gather(tlay, torch.as_tensor(x))
    elif op == "scatter":
        R = case["R"].astype(np.float32)
        want = jw.windowed_scatter(jlay, jnp.asarray(R), **kw)
        got = tw.windowed_scatter(tlay, torch.as_tensor(R))
    elif op.startswith("matvec"):
        if op == "matvec-bf16A":
            jA = jnp.asarray(A).astype(jnp.bfloat16)
            tA = convert.to_tensor(np.asarray(jA))
        else:
            jA, tA = jnp.asarray(A), torch.as_tensor(A)
        want = jw.windowed_matvec(jlay, jA, jnp.asarray(x), **kw)
        got = tw.windowed_matvec(tlay, tA, torch.as_tensor(x))
    else:
        ins, outs = op.split("->")
        jA = jw.slice_block(jlay, jnp.asarray(A), ins, outs).astype(jnp.bfloat16)
        tA = convert.to_tensor(np.asarray(jA))
        xs = x[: tlay.n_u] if ins == "v" else x[tlay.n_u :]
        want = jw.windowed_matvec_block(
            jlay, jA, jnp.asarray(xs), in_spaces=ins, out_spaces=outs, **kw
        )
        got = tw.windowed_matvec_block(
            tlay, tA, torch.as_tensor(xs), in_spaces=ins, out_spaces=outs
        )
    _close(got, want, 1e-5)


@pytest.mark.parametrize("same", [False, True], ids=["u-u_old", "one-tensor"])
@pytest.mark.parametrize("name", ["blocked-h1", "blocked-h2", "box-h1"])
def test_gather_pair_matches_two_gathers(name, same):
    """The pair (the assembly's gathers of u and u_old) is two
    ``_gather_reference`` calls bit for bit, and, in float32, JAX's
    ``windowed_gather`` run twice in interpret mode (passes=3): a copy, so
    exactly.  u and u_old may be one tensor."""
    case = _case(name)
    jlay, tlay = case["jlay"], case["tlay"]
    x = case["x"].astype(np.float32)
    x_old = x if same else np.random.default_rng(12).standard_normal(x.shape).astype(np.float32)
    u = torch.as_tensor(x)
    u_old = u if same else torch.as_tensor(x_old)
    tw.reset_launch_counts()
    got = tw.windowed_gather_pair(tlay, u, u_old)
    assert isinstance(got, tuple) and len(got) == 2
    for g, v, xv in zip(got, (u, u_old), (x, x_old)):
        assert g.shape == (tlay.nli, tlay.ncd) and g.dtype == torch.float32
        assert torch.equal(g, tw._gather_reference(tlay, v))
        want = jw.windowed_gather(jlay, jnp.asarray(xv), passes=3, interpret=True)
        assert np.array_equal(g.numpy(), np.asarray(want))
    assert tw.windowed_gather.launches == 0  # the CPU path launches nothing


def test_wrappers_count_no_launch_on_cpu(case):
    """The CPU path is the plain version: no kernel launch is counted."""
    tw.reset_launch_counts()
    tlay = case["tlay"]
    x = torch.as_tensor(case["x"])
    tw.windowed_gather(tlay, x)
    tw.windowed_gather_pair(tlay, x, x)
    tw.windowed_matvec(tlay, torch.as_tensor(case["A"]), x)
    assert all(v == 0 for v in tw.launch_counts().values())


def _wide_halo_layout(build=tw.build_windowed_layout):
    """A layout with a 3-block halo, several chunks and padded slots (no
    mesh behind it: cell i touches dofs around i); ``build`` is either
    package's layout builder."""
    rng = np.random.default_rng(5)
    n_vs, n_ps, nc = 2048, 2048, 3000
    centre = np.sort(rng.integers(0, n_vs, nc))
    vd = np.clip(centre[:, None] + rng.integers(-200, 201, (nc, 6)), 0, n_vs - 1)
    pd = np.clip(centre[:, None] + rng.integers(-150, 151, (nc, 3)), 0, n_ps - 1)
    return build(vd, pd, n_vs, n_ps, 2, target_ow=128, Bc=128)


def _packed_cases():
    return {**{k: (lambda k=k: _case(k)["tlay"]) for k in sorted(CASES)},
            "wide-halo": _wide_halo_layout}


@pytest.mark.parametrize("name", sorted(CASES) + ["wide-halo"])
def test_packed_positions_equal_abs_loc(name):
    """The one table the kernels read holds ``_abs_loc``'s positions, with
    one sentinel for the padded slots, and gathers what ``_gather_reference``
    gathers."""
    lay = _packed_cases()[name]()
    if name == "wide-halo":
        assert lay.hv > 1 and lay.nchunks > 1 and lay.pad_factor > 1
    pos_v, pos_p, cnt = tw.pack_positions(lay)
    assert pos_v.dtype == pos_p.dtype == torch.int16 and cnt.dtype == torch.int32
    x = torch.as_tensor(np.random.default_rng(3).standard_normal(lay.n_u + lay.n_ps))
    cols = []
    spaces = [(pos_v, lay.loc_v_hi, lay.loc_v_lo, lay.offs_v, lay.RVv, lay.RWv, lay.k_v,
               lay.OWv, lay.hv, lay.n_vs, lay.dim),
              (pos_p, lay.loc_p_hi, lay.loc_p_lo, lay.offs_p, lay.RVp, lay.RWp, lay.k_p,
               lay.OWp, lay.hp, lay.n_ps, 1)]
    seg = 0
    for pos, hi, lo, offs, RV, RW, k, OW, h, n, ncomp in spaces:
        assert pos.shape == (lay.nb, k, lay.Bmax)
        got = tw.unpack_positions(pos).transpose(1, 2)  # [nb, Bmax, k]
        want = tw._abs_loc(lay, hi, lo, offs, RV, RW, k)
        want = torch.where(want >= min(RW * 128, (2 * h + 1) * OW), -1, want)
        assert torch.equal(got, want)
        # a gather straight through the table: window position -> global row
        row = (torch.arange(lay.nb)[:, None, None] - h) * OW + got
        ok = (got >= 0) & (row >= 0) & (row < n)
        for c in range(ncomp):
            xs = x[seg : seg + n]
            cols.append(torch.where(ok, xs[row.clamp(0, n - 1)], 0.0))
            seg += n
    X = torch.cat(cols, dim=2).reshape(lay.ncd, lay.nl).T
    assert torch.equal(X, tw._gather_reference(lay, x)[: lay.nl])
    # no slot from cnt[b] on holds a cell
    filled = (tw.unpack_positions(pos_v) >= 0).any(dim=1)
    slots = torch.arange(lay.Bmax)[None, :]
    assert not bool((filled & (slots >= cnt[:, None])).any())
    assert bool((cnt <= lay.Bmax).all()) and int(cnt.max()) > lay.Bmax - lay.Bc


def test_packed_positions_widen_to_int32():
    """Windows of 65,535 entries or more do not fit 16 bits."""
    lay = _case("blocked-h1")["tlay"]
    import dataclasses
    big = dataclasses.replace(lay, OWv=32768)  # only the width decides the type
    pos_v, pos_p, _ = tw.pack_positions(big)
    assert pos_v.dtype == pos_p.dtype == torch.int32
    narrow = tw.unpack_positions(tw.pack_positions(lay)[0])
    assert torch.equal(tw.unpack_positions(pos_v), narrow)


@pytest.mark.parametrize("h", [0, 1, 3, 5])
@pytest.mark.parametrize("n_short", [0, 37])
def test_merge_reference_equals_combine_windows(h, n_short):
    """Whole windows: the merge kernel's plain version is the fixed-order
    shifted adds of ``_combine_windows``, bit for bit (h 5: the halo of the
    196,608-tet box, which the merge kernel's general path sums)."""
    nb, OW = 7, 128
    n = nb * OW - n_short
    rng = np.random.default_rng(h)
    win = torch.as_tensor(rng.standard_normal((2, nb, (2 * h + 1) * OW)), dtype=torch.float32)
    want = tw._combine_windows(win, nb, OW, h, n)
    got = tw._merge_reference(win[:, :, None, :], None, None, 0, nb, OW, h, n)
    assert torch.equal(got, want)


@pytest.mark.parametrize("name", sorted(CASES) + ["wide-halo"])
def test_merge_of_chunk_subwindows(name):
    """Chunk subwindows placed into their windows and merged by
    ``_combine_windows`` equal ``_merge_reference`` of the subwindows."""
    lay = _packed_cases()[name]()
    rng = np.random.default_rng(9)
    cnt = tw.pack_positions(lay)[2]
    for offs, RV, RW, OW, h, n in ((lay.offs_v, lay.RVv, lay.RWv, lay.OWv, lay.hv, lay.n_vs),
                                   (lay.offs_p, lay.RVp, lay.RWp, lay.OWp, lay.hp, lay.n_ps)):
        sub = torch.as_tensor(rng.standard_normal((2, lay.nb, lay.nchunks, RV * 128)))
        win = sub.new_zeros((2, lay.nb, RW * 128))
        for b in range(lay.nb):
            for c in range(lay.nchunks):
                if int(cnt[b]) > c * lay.Bc:
                    o = int(offs[b, c]) * 128
                    win[:, b, o : o + RV * 128] += sub[:, b, c]
        want = tw._combine_windows(win, lay.nb, OW, h, n)
        got = tw._merge_reference(sub, offs, cnt, lay.Bc, lay.nb, OW, h, n)
        _close(got, want, 1e-14)


@pytest.mark.parametrize("name", sorted(CASES) + ["wide-halo"])
def test_chunked_scatter_matches_plain(name):
    lay = _packed_cases()[name]()
    R = torch.as_tensor(np.random.default_rng(4).standard_normal((lay.nli, lay.ncd)))
    _close(tw._scatter_chunked_reference(lay, R), tw._scatter_reference(lay, R), 1e-12)


@pytest.mark.parametrize("name", sorted(CASES) + ["wide-halo"])
def test_chunked_scatter_matches_jax_reference_f64(name):
    """K4's order of sums (chunk subwindows, then the fixed-order merge)
    against JAX's plain scatter, float64, 1e-12 of ||y||_inf."""
    if name == "wide-halo":
        tlay, jlay = _wide_halo_layout(), _wide_halo_layout(jw.build_windowed_layout)
    else:
        tlay, jlay = _case(name)["tlay"], _case(name)["jlay"]
    R = np.random.default_rng(6).standard_normal((tlay.nli, tlay.ncd))
    want = jw._scatter_reference(jlay, jnp.asarray(R))
    _close(tw._scatter_chunked_reference(tlay, torch.as_tensor(R)), want, 1e-12)


def test_matvec_through_chunked_merge_matches_jax_reference_f64(case):
    """The kernels' order of sums (chunk subwindows, then the fixed-order
    merge) against JAX's plain matvec, float64, 1e-12 of ||y||_inf."""
    jlay, tlay = case["jlay"], case["tlay"]
    A, x = torch.as_tensor(case["A"]), torch.as_tensor(case["x"])
    X = tw._gather_reference(tlay, x)
    yl = torch.einsum("jis,js->is", A[:, : tlay.nl, :], X[: tlay.nl])
    got = tw._scatter_chunked_reference(tlay, yl)
    want = jw.windowed_matvec_reference(jlay, jnp.asarray(case["A"]), jnp.asarray(case["x"]))
    _close(got, want, 1e-12)


@pytest.mark.parametrize("name", sorted(CASES) + ["wide-halo"])
def test_kernel_geometry_record(name):
    """What the CUDA entry points are told about a layout (struct Geo of
    csrc/windowed.cu): 19 integers, the last three the tables' index width,
    the number of slot colours (the rounds of a chunk's sums in 2D; 0 in 3D,
    where the colour table is null) and whether a 2D P2/P1 layout runs on
    the compact kernels (``compact_layout``; none of these small layouts
    does); and the occupied chunks of a block are a prefix (the kernels
    skip the rest by the slot counts alone)."""
    lay = _packed_cases()[name]()
    pk = lay._packed
    assert pk is lay._packed  # made once
    meta = list(pk.meta)
    assert meta[0] == 19 and len(meta) == 20
    assert meta[1:5] == [lay.nb, lay.Bmax, lay.Bc, lay.nchunks]
    assert meta[5:8] == [lay.dim, lay.k_v, lay.k_p]
    assert meta[8:14] == [lay.OWv, lay.OWp, lay.hv, lay.hp, lay.RVv, lay.RVp]
    assert meta[14:17] == [lay.n_vs, lay.n_ps, lay.ncd]
    assert meta[17] == 0  # 16-bit tables
    if lay.dim == 2:
        assert meta[18] == pk.ncolors == int(pk.colour.max()) + 1
    else:
        assert meta[18] == pk.ncolors == 0 and pk.colour is None
    assert meta[19] == int(tw.compact_layout(lay)) == 0
    filled = (tw.unpack_positions(pk.pos_v) >= 0).any(dim=1)  # [nb, Bmax]
    chunks = filled.reshape(lay.nb, lay.nchunks, lay.Bc).any(dim=2)
    assert bool((chunks.int().diff(dim=1) <= 0).all())
    assert torch.equal(chunks, pk.cnt[:, None] > torch.arange(lay.nchunks) * lay.Bc)
    assert len(pk.args) == 7 and pk.args[1] == pk.pos_v.data_ptr()
    assert pk.args[6] == (None if lay.dim == 3 else pk.colour.data_ptr())


@pytest.mark.parametrize("name", ["blocked-h1", "p3-blocked-h1", "box-h1", "p3-box-h1"])
def test_slot_colours_only_in_2d(name):
    """Only the 2D kernels sum in slot-colour rounds: a triangle layout's
    packed record carries its colour table (a proper colouring: the 2D
    sums' rounds), a tetrahedral one a null table and no colour count, and
    its kernels sum in the order of ``compact_tables``."""
    lay = _case(name)["tlay"]
    pk = lay._packed
    if lay.dim == 2:
        colour, ncolors = tw.slot_colours(lay, pk.pos_v, pk.pos_p)
        assert torch.equal(pk.colour, colour) and pk.ncolors == ncolors > 0
        assert pk.args[6] == pk.colour.data_ptr() and pk.meta[18] == ncolors
    else:
        assert pk.colour is None and pk.ncolors == 0
        assert pk.args[6] is None and pk.meta[18] == 0
