"""The CUDA kernels against their plain torch versions, on a card.

This file imports no JAX, so it runs on a machine with a GPU and no JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py

Without a visible GPU every test skips but the slot colouring's, which
checks a host table.  The layouts are Taylor-Hood P2/P1 and P3/P2 on
triangles (2D) and on tetrahedra (3D, the kernels' other design: K1, K2 and
K4 sum each chunk at the distinct positions it touches and merge through
per-row lists); an element the kernels are not built for raises.
Tolerances: K3 (gather, one vector or the pair u, u_old in one launch) is a
copy and must be bit-equal; the others agree to 1e-5 of ||y||_inf (float32
sums in another order: the 2D kernels sum a chunk's slots in colour order,
the 3D ones, the P3/P2 K1 on both elements, K2 on P3/P2 triangles and K1,
K2 and K4 on a compact 2D P2/P1 layout (the 25,600-cell channel's Morton
order) in the order of ``compact_tables``).  K1, K2 and K4 sum in a fixed order, so a repeated
call and a CUDA-graph replay give the same bits as an eager call.  K5, the
tensor-core probe, is held to 1e-5 of its output's largest entry (bf16
products summed in float32 in groups, in another order).
"""

import functools
import re

import numpy as np
import pytest
import torch

from navier_stokes_tpu_torch.fem.dofs import make_dofs, renumber_blocked
from navier_stokes_tpu_torch.mesh.generate import box, rectangle, unit_square
from navier_stokes_tpu_torch.mesh.mesh import refine_uniform
from navier_stokes_tpu_torch.ops import windowed as tw
from navier_stokes_tpu_torch.parallel import windowed_spmd as ws
from navier_stokes_tpu_torch.scripts import kernel_bench as kb
from navier_stokes_tpu_torch.scripts import mxu_probe as mxu
from navier_stokes_tpu_torch.scripts import stream_variants as sv

LAYOUTS = {
    "blocked-h1": dict(n=6, cpb=16, Bc=128),
    "blocked-h2": dict(n=8, cpb=8, Bc=128),
    "legacy-h2-short": dict(n=12, target_ow=128, Bc=128),
    "refined-Bc256": dict(n=12, refine=1, cpb=448, Bc=256),
    # several chunks a block; more layout blocks than the card has SMs
    "legacy-3chunks": dict(n=12, target_ow=256, Bc=128),
    "blocked-nb144": dict(n=24, cpb=8, Bc=128),
    # more than 4 chunks a block: the merge's general path (as a halo > 1 is)
    "legacy-6chunks": dict(n=20, target_ow=1024, Bc=128),
    # tetrahedra: one chunk; 3 chunks of 256 (hv 1, 33 colours); hv 2 and
    # RVv 40 (35 colours)
    "box-h1": dict(box=2, cpb=16, Bc=128),
    "box-refined-Bc256": dict(box=4, refine=1, cpb=448, Bc=256),
    "box-refined-h2": dict(box=8, refine=1, cpb=448, Bc=256),
    # a rank's framed layout of a sharded run (rank 1 of 2, halo 4): owned
    # blocks between 4 empty ones a side, rows over the framed spaces
    "box4-framed": dict(box=4, cpb=16, Bc=128, rank=1, ranks=2),
}
# P3/P2 (cubic velocity): 2D halos 1 and 2, 2 chunks a block and a rank's
# framed layout (rank 0 of 2); tetrahedra with one chunk, 3 chunks of 256
# and a halo of 2
P3_LAYOUTS = {
    "p3-blocked-h1": dict(n=6, cpb=16, Bc=128, deg=3),
    "p3-blocked-h2": dict(n=8, cpb=8, Bc=128, deg=3),
    "p3-refined-Bc256": dict(n=12, refine=1, cpb=448, Bc=256, deg=3),
    "p3-framed-r0of2": dict(n=8, cpb=16, Bc=128, deg=3, rank=0, ranks=2),
    "p3-box-h1": dict(box=2, cpb=16, Bc=128, deg=3),
    "p3-box-refined-Bc256": dict(box=4, refine=1, cpb=448, Bc=256, deg=3),
    "p3-box-h2": dict(box=4, cpb=64, Bc=128, deg=3),
}
OPS = ["gather", "gather-pair", "scatter", "matvec", "matvec-bf16A", "v->v", "v->p", "p->p",
       "v->v-f32A", "v->p-f32A", "p->p-f32A"]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@functools.lru_cache(maxsize=None)
def _layout(name):
    c = {**LAYOUTS, **P3_LAYOUTS}[name]
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
    lay = tw.build_windowed_layout(
        dofs.cell_vdofs, dofs.cell_pdofs, dofs.n_vs, dofs.n_ps, mesh.dim, **kw
    )
    if "ranks" in c:
        lay = ws.local_layout(lay, ws.make_dist_layout(lay, c["ranks"]), c["rank"])
    return lay


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(LAYOUTS) + sorted(P3_LAYOUTS))
@pytest.mark.parametrize("op", OPS)
def test_kernel_matches_plain(name, op, cuda_device):
    lay = _layout(name).to(cuda_device)
    rand = _rand_on(cuda_device, 11)
    x, A = rand(lay.n_u + lay.n_ps), rand(lay.nl, lay.nli, lay.ncd)
    tw.reset_launch_counts()
    if op == "gather":
        got, want = tw.windowed_gather(lay, x), tw._gather_reference(lay, x)
        assert torch.equal(got, want)
        assert tw.windowed_gather.launches == 1
        _assert_zero_padding(lay, got)
        return
    if op == "gather-pair":
        x_old = rand(lay.n_u + lay.n_ps)
        got = tw.windowed_gather_pair(lay, x, x_old)
        assert tw.windowed_gather.launches == 1  # one launch for both
        for g, v in zip(got, (x, x_old)):
            assert torch.equal(g, tw._gather_reference(lay, v))
            _assert_zero_padding(lay, g)
        same = tw.windowed_gather_pair(lay, x, x)  # one tensor as u and u_old
        assert torch.equal(same[0], same[1]) and torch.equal(same[0], got[0])
        return
    if op == "scatter":
        R = rand(lay.nli, lay.ncd)
        got, want = tw.windowed_scatter(lay, R), tw._scatter_reference(lay, R)
        launched = tw.windowed_scatter
    elif op.startswith("matvec"):
        if op == "matvec-bf16A":
            A = A.to(torch.bfloat16)
        got, want = tw.windowed_matvec(lay, A, x), tw.windowed_matvec_reference(lay, A, x)
        launched = tw.windowed_matvec
    else:
        ins, outs = op.removesuffix("-f32A").split("->")
        A_sub = tw.slice_block(lay, A, ins, outs)
        if not op.endswith("-f32A"):
            A_sub = A_sub.to(torch.bfloat16)
        xs = x[: lay.n_u] if ins == "v" else x[lay.n_u :]
        got = tw.windowed_matvec_block(lay, A_sub, xs, in_spaces=ins, out_spaces=outs)
        want = tw._block_reference(lay, A_sub, xs, ins, outs)
        launched = tw.windowed_matvec_block
    torch.cuda.synchronize()
    assert launched.launches == 1
    err = (got.double() - want.double()).abs().max().item()
    assert err <= 1e-5 * want.double().abs().max().item(), err


def _assert_zero_padding(lay, X):
    """Rows l >= nl and the columns of padded slots of a gather are 0."""
    assert not bool(X[lay.nl :].any())
    pos_v, pos_p, _ = tw.pack_positions(lay)
    filled = ((tw.unpack_positions(pos_v) >= 0).any(dim=1)
              | (tw.unpack_positions(pos_p) >= 0).any(dim=1)).reshape(-1)
    assert not bool(X[:, ~filled].any())


@pytest.mark.cuda
def test_layouts_cover_the_kernel_paths():
    """The layouts above reach one chunk, several and more than 4, a halo of
    2 blocks, and fewer and more layout blocks than an H100 has SMs (132);
    the tetrahedral ones one chunk and several, and a halo of 2 blocks."""
    lays = [_layout(name) for name in LAYOUTS]
    assert {lay.nchunks == 1 for lay in lays} == {True, False}
    assert any(lay.nchunks > 4 for lay in lays)
    assert any(lay.hv == 2 for lay in lays)
    assert min(lay.nb for lay in lays) < 132 < max(lay.nb for lay in lays)
    tets = [lay for lay in lays if lay.dim == 3]
    assert {lay.nchunks == 1 for lay in tets} == {True, False}
    assert any(lay.hv == 2 for lay in tets)
    p3 = [_layout(name) for name in P3_LAYOUTS]
    elements = {(lay.dim, lay.k_v, lay.k_p) for lay in lays + p3}
    assert elements == set(tw._ELEMENTS)
    for dim in (2, 3):
        mine = [lay for lay in p3 if lay.dim == dim]
        assert {lay.nchunks == 1 for lay in mine} == {True, False}
        assert {lay.hv for lay in mine} == {1, 2}
    # the narrow kernels (K2 v->p and p->p on P3/P2 triangles): several
    # blocks of more than one chunk, and a framed layout
    narrow = [lay for lay in p3 if all(tw.narrow(lay, i, "p") for i in "vp")]
    assert narrow == [lay for lay in p3 if lay.dim == 2]
    assert any(lay.nb > 1 and lay.nchunks > 1 for lay in narrow)
    assert any(lay.frame for lay in narrow)
    # K4 is the row-ordered sum on every P3/P2 layout, the chunk kernels at P2/P1
    assert all(tw.scatter_rows(lay) for lay in p3)
    assert not any(tw.scatter_rows(lay) for lay in lays)


TETS = ["box-h1", "box-refined-Bc256", "box-refined-h2", "box4-framed",
        "p3-box-h1", "p3-box-refined-Bc256", "p3-box-h2"]


def _op_call(lay, op, rand):
    """(call, its input that a graph replay writes new values into) for one
    op of OPS on random operands at layout lay."""
    n = lay.n_u + lay.n_ps
    A = rand(lay.nl, lay.nli, lay.ncd)
    if op == "gather":
        x = rand(n)
        return (lambda: tw.windowed_gather(lay, x)), x
    if op == "gather-pair":
        x, x_old = rand(n), rand(n)
        return (lambda: torch.stack(tw.windowed_gather_pair(lay, x, x_old))), x
    if op == "scatter":
        R = rand(lay.nli, lay.ncd)  # the rows R: K4's input
        return (lambda: tw.windowed_scatter(lay, R)), R
    if op.startswith("matvec"):
        x = rand(n)
        A_op = A.to(torch.bfloat16) if op == "matvec-bf16A" else A
        return (lambda: tw.windowed_matvec(lay, A_op, x)), x
    ins, outs = op.removesuffix("-f32A").split("->")
    A_sub = tw.slice_block(lay, A, ins, outs)
    if not op.endswith("-f32A"):
        A_sub = A_sub.to(torch.bfloat16)
    xs = rand(lay.n_u if ins == "v" else lay.n_ps)
    return (lambda: tw.windowed_matvec_block(lay, A_sub, xs, in_spaces=ins, out_spaces=outs)), xs


def _rand_on(device, seed):
    rng = np.random.default_rng(seed)

    def rand(*shape):
        return torch.as_tensor(rng.standard_normal(shape), dtype=torch.float32, device=device)

    return rand


@pytest.mark.cuda
@pytest.mark.parametrize(
    "name, op",
    [(name, op) for name in ["refined-Bc256", "legacy-3chunks", "p3-refined-Bc256"]
     for op in ["matvec-bf16A", "v->v", "scatter", "gather", "gather-pair"]]
    + [(name, op) for name in TETS for op in OPS]
    # P3/P2 triangles: K2 v->v on the streaming kernel, v->p and p->p on the narrow kernels
    + [("p3-refined-Bc256", op) for op in ["v->p", "p->p", "v->v-f32A", "v->p-f32A", "p->p-f32A"]]
    + [(name, op) for name in ["p3-blocked-h1", "p3-blocked-h2", "p3-framed-r0of2"]
       for op in ["v->v", "v->p", "p->p", "v->v-f32A", "v->p-f32A", "p->p-f32A"]])
def test_graph_replay_matches_eager(name, op, cuda_device):
    """A wrapper call is one C call with no host read, so a CUDA graph can
    capture it; the replay, on new inputs written into the captured tensors,
    gives the same bits as an eager call (every sum has a fixed order)."""
    lay = _layout(name).to(cuda_device)
    rand = _rand_on(cuda_device, 12)
    call, x = _op_call(lay, op, rand)
    _assert_replay_matches_eager(call, x, lambda: rand(*x.shape), exact=True)


def _assert_replay_matches_eager(call, x, fresh, exact=False):
    """Capture call() in a CUDA graph, write fresh() into its input x,
    replay, and hold the output against an eager call (``exact``: the same
    bits)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # the capture stream's scratch, before the capture
        call()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        y = call()
    x.copy_(fresh())
    graph.replay()
    torch.cuda.synchronize()
    want = call()
    if exact:
        assert torch.equal(y, want)
        return
    err = (y.double() - want.double()).abs().max().item()
    assert err <= 1e-5 * want.double().abs().max().item(), err


@pytest.mark.cuda
@pytest.mark.parametrize(
    "name, op",
    [(name, op) for name in ["refined-Bc256", "legacy-3chunks", "blocked-h2",
                             "p3-refined-Bc256", "p3-blocked-h2"]
     for op in ["matvec-bf16A", "matvec", "v->v", "v->p", "p->p", "scatter"]]
    + [(name, op) for name in TETS for op in OPS]
    + [(name, op) for name in ["p3-refined-Bc256", "p3-blocked-h2", "p3-blocked-h1"]
       for op in ["v->v-f32A", "v->p-f32A", "p->p-f32A"]]
    + [("p3-framed-r0of2", op) for op in ["v->p", "p->p", "v->p-f32A", "p->p-f32A"]])
def test_repeat_calls_are_bit_equal(name, op, cuda_device):
    """K1 (bf16 and float32 A), each K2 product and K4 sum in a fixed
    order (and K3 copies): two calls on the same inputs give the same
    bits."""
    lay = _layout(name).to(cuda_device)
    call, _ = _op_call(lay, op, _rand_on(cuda_device, 13))
    first, second = call(), call()
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.cuda
@pytest.mark.parametrize("name", TETS)
def test_tet_merge_counts_every_window(name, cuda_device):
    """With A the identity on every cell and x all ones, K1 (bf16 and
    float32 A) and K2 v->v and p->p, and K4 with R = 1 on every occupied
    slot's nl rows, give each row the number of cells that touch it,
    exactly: every (slot, dof) pair reaches its row through the chunk sums
    and the row-list merge.  On the halo-2 layout some rows take entries
    from blocks 2 away from their own (the merge's outermost windows, j = 0
    and 2h); on the framed layout (halo 4) the frame's rows take the owned
    blocks' sums, and its frame blocks none of their own."""
    lay = _layout(name)
    pos_v, pos_p, _ = tw.pack_positions(lay)
    filled = ((tw.unpack_positions(pos_v) >= 0).any(dim=1)
              | (tw.unpack_positions(pos_p) >= 0).any(dim=1)).reshape(-1)
    counts = []
    for pos, OW, h, n in ((pos_v, lay.OWv, lay.hv, lay.n_vs), (pos_p, lay.OWp, lay.hp, lay.n_ps)):
        p = tw.unpack_positions(pos)  # [nb, k, Bmax]
        rows = (torch.arange(lay.nb)[:, None, None] - h) * OW + p
        counts.append(torch.bincount(rows[p >= 0], minlength=n).float())
    t = tw.compact_tables(lay)["v"]
    block = torch.repeat_interleave(torch.arange(lay.nb * lay.nchunks), torch.diff(t.off.long()))
    reach = (t.row.long() // lay.OWv - block // lay.nchunks).abs()
    assert int(reach.max()) == lay.hv
    lay = lay.to(cuda_device)
    A = torch.zeros((lay.nl, lay.nli, lay.ncd), device=cuda_device)
    A[torch.arange(lay.nl), torch.arange(lay.nl)] = 1.0
    x = torch.ones(lay.n_u + lay.n_ps, device=cuda_device)
    want = torch.cat([counts[0].repeat(lay.dim), counts[1]]).to(cuda_device)
    for A_op in (A, A.to(torch.bfloat16)):
        assert torch.equal(tw.windowed_matvec(lay, A_op, x), want)
    A_bf = A.to(torch.bfloat16)
    assert torch.equal(tw.windowed_matvec_block(lay, tw.slice_block(lay, A_bf, "v", "v"),
                                                x[: lay.n_u], in_spaces="v", out_spaces="v"),
                       want[: lay.n_u])
    assert torch.equal(tw.windowed_matvec_block(lay, tw.slice_block(lay, A_bf, "p", "p"),
                                                x[lay.n_u :], in_spaces="p", out_spaces="p"),
                       want[lay.n_u :])
    R = torch.zeros((lay.nli, lay.ncd), device=cuda_device)
    R[: lay.nl, filled.to(cuda_device)] = 1.0
    assert torch.equal(tw.windowed_scatter(lay, R), want)


P3_TRIANGLES = ["p3-blocked-h1", "p3-blocked-h2", "p3-refined-Bc256", "p3-framed-r0of2"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", P3_TRIANGLES)
def test_narrow_merge_counts_every_pair(name, cuda_device):
    """With A the identity on every cell and x all ones, K2 p->p and v->p
    on the narrow kernels (bf16 and float32 A; v->p: A's pressure row i
    takes velocity column i) give each pressure row the number of cells
    that touch it, exactly: every (slot, dof) pair reaches its row through
    the slot product, Y and the row list.  On the framed layout the frame's
    rows take the owned blocks' sums."""
    lay = _layout(name)
    p = tw.unpack_positions(tw.pack_positions(lay)[1])  # [nb, k_p, Bmax]
    rows = (torch.arange(lay.nb)[:, None, None] - lay.hp) * lay.OWp + p
    want = torch.bincount(rows[p >= 0], minlength=lay.n_ps).float().to(cuda_device)
    lay = lay.to(cuda_device)
    A = torch.zeros((lay.nl, lay.nli, lay.ncd), device=cuda_device)
    nv = lay.dim * lay.k_v
    A[nv + torch.arange(lay.k_p), nv + torch.arange(lay.k_p)] = 1.0  # p->p
    A[torch.arange(lay.k_p), nv + torch.arange(lay.k_p)] = 1.0       # v->p: column i
    for A_op in (A, A.to(torch.bfloat16)):
        for ins, xs in (("p", torch.ones(lay.n_ps, device=cuda_device)),
                        ("v", torch.ones(lay.n_u, device=cuda_device))):
            assert tw.matvec_design(lay, ins, "p").startswith("narrow_product_kernel")
            got = tw.windowed_matvec_block(lay, tw.slice_block(lay, A_op, ins, "p"), xs,
                                           in_spaces=ins, out_spaces="p")
            assert torch.equal(got, want), (ins, A_op.dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("name", TETS + P3_TRIANGLES)
def test_tet_scratch_is_the_compact_vector(name, cuda_device):
    """A tetrahedral layout's scratch (one buffer a stream, shared by K1
    and K2) is the row-ordered compact vector: dim*E_v + E_p floats,
    whichever of K4 and K1 makes it first.  On P3/P2 triangles K1 writes
    that vector and K2 v->p and p->p their slots' sums Y (k_p x ncd
    floats) into the same buffer, which holds the larger of the two; K4
    (the row-ordered sum over R, on both elements) writes none."""
    rand = _rand_on(cuda_device, 16)
    for first in ("scatter", "matvec"):
        lay = _layout(name).to(cuda_device)  # a new layout: its own tables and scratch
        call, _ = _op_call(lay, first, rand)
        call()
        call, _ = _op_call(lay, "matvec" if first == "scatter" else "scatter", rand)
        call()
        torch.cuda.synchronize()
        tabs = lay._packed.compact
        scratch = list(lay._packed._scratch.values())
        assert len(scratch) == 1 and scratch[0].dtype == torch.float32
        want = lay.dim * tabs["v"].E + tabs["p"].E
        if lay.dim == 2:
            want = max(want, lay.k_p * lay.ncd)
        assert scratch[0].numel() == want


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(P3_LAYOUTS))
def test_scatter_rows_kernel_is_its_mirror(name, cuda_device):
    """K4 on the P3/P2 elements (scatter_rows_kernel, one launch) gives
    the bits of its plain mirror (``_scatter_rows_reference`` over the row
    lists the layout carries, run on the card: the same float32 additions
    in the same order), and a repeated call and a CUDA-graph replay on new
    rows give the same bits again."""
    lay = _layout(name).to(cuda_device)
    assert tw.scatter_design(lay) == "scatter_rows_kernel"
    rand = _rand_on(cuda_device, 17)
    call, R = _op_call(lay, "scatter", rand)
    tw.reset_launch_counts()
    got = call()
    assert tw.windowed_scatter.launches == 1
    want = tw._scatter_rows_reference(lay, R, lay._packed.rows)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert torch.equal(call(), got)
    _assert_replay_matches_eager(call, R, lambda: rand(*R.shape), exact=True)


@functools.lru_cache(maxsize=None)
def _morton_channel():
    """The 25,600-cell channel's Morton layout (``renumber_blocked(order=
    "sfc")`` at 448 cells a block, doubled until the halo fits): its chunk
    subwindows outgrow a block's shared memory, so its 2D P2/P1 K1, K2 and
    K4 take the compact kernels."""
    mesh = refine_uniform(rectangle(80, 40, 0, 7, 0, 4), 1)
    return kb.bare_layout(mesh, kb.channel_config(), device="cpu", order="sfc")[0]


@pytest.mark.cuda
@pytest.mark.parametrize("op", ["matvec", "matvec-bf16A", "v->v", "v->p", "p->p", "scatter"])
def test_compact_p2p1_route_matches_its_order(op, cuda_device):
    """On a compact 2D P2/P1 layout K1 and K2 (``matvec3_kernel<2, 6, 3>``
    + ``merge3_kernel``) agree with ``_compact_matvec_reference`` to 1e-5 of
    ||y||_inf, K4 (``scatter_rows_kernel<2, 6>``) gives its mirror's bits;
    a repeated call gives the same bits; one launch a call; the scratch is
    the compact vector."""
    lay = _morton_channel().to(cuda_device)
    assert tw.compact_layout(lay)
    rand = _rand_on(cuda_device, 19)
    tw.reset_launch_counts()
    if op == "scatter":
        R = rand(lay.nli, lay.ncd)

        def call():
            return tw.windowed_scatter(lay, R)

        got = call()
        assert tw.scatter_design(lay) == "scatter_rows_kernel"
        want = tw._scatter_rows_reference(lay, R, lay._packed.rows)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
    else:
        A, x = rand(lay.nl, lay.nli, lay.ncd), rand(lay.n_u + lay.n_ps)
        if op.startswith("matvec"):
            ins, outs = "vp", "vp"
            A_op = A.to(torch.bfloat16) if op == "matvec-bf16A" else A
        else:
            ins, outs = op.split("->")
            A_op = tw.slice_block(lay, A, ins, outs).to(torch.bfloat16)
            x = x[: lay.n_u] if ins == "v" else x[lay.n_u :]

        def call():
            if ins == "vp":
                return tw.windowed_matvec(lay, A_op, x)
            return tw.windowed_matvec_block(lay, A_op, x, in_spaces=ins, out_spaces=outs)

        got = call()
        assert tw.matvec_design(lay, ins, outs) == "matvec3_kernel + merge3_kernel"
        want = tw._compact_matvec_reference(lay, A_op, x, ins, outs, lay._packed.compact)
        err = (got.double() - want.double()).abs().max().item()
        assert err <= 1e-5 * want.double().abs().max().item(), err
        tabs = lay._packed.compact
        (scratch,) = lay._packed._scratch.values()
        assert scratch.numel() == lay.dim * tabs["v"].E + tabs["p"].E
    assert sum(tw.launch_counts().values()) == 1
    assert torch.equal(call(), got)


@pytest.mark.cuda
@pytest.mark.parametrize("nx, compact", [(128, False), (140, True)])
def test_span_smem_bytes_is_the_library_s(nx, compact, cuda_device):
    """The route's two sides of a block's shared memory: the Morton layouts
    of rectangle(128, 64) (210,944 bytes, 91 % of a block's) and
    rectangle(140, 70) (239,616, over it).  The host's ``span_smem_bytes``
    is windowed.cu's own (ns_span_smem_bytes, launch_matvec's formula), and
    K1 with float32 A launches on the route the host chose and agrees with
    its plain version to 1e-5 of ||y||_inf."""
    mesh = rectangle(nx, nx // 2, 0, 7, 0, 4)
    lay = kb.bare_layout(mesh, kb.channel_config(), device="cpu", order="sfc")[0]
    lay = lay.to(cuda_device)
    assert tw.compact_layout(lay) is compact
    assert tw.check_span_smem(lay, lay._packed.meta) == tw.span_smem_bytes(lay)
    assert (tw.span_smem_bytes(lay) > tw._MAX_SMEM_BYTES) is compact
    rand = _rand_on(cuda_device, 23)
    A, x = rand(lay.nl, lay.nli, lay.ncd), rand(lay.n_u + lay.n_ps)
    tw.reset_launch_counts()
    got = tw.windowed_matvec(lay, A, x)
    assert tw.windowed_matvec.launches == 1
    want = (tw._compact_matvec_reference(lay, A, x, "vp", "vp", lay._packed.compact) if compact
            else tw.windowed_matvec_reference(lay, A, x))
    err = (got.double() - want.double()).abs().max().item()
    assert err <= 1e-5 * want.double().abs().max().item(), err


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(P3_LAYOUTS))
def test_stream_config_fits_stream_smem_bytes(name, cuda_device):
    """The streaming kernel's launch (windowed.cu ns_stream_config) at
    every P3/P2 layout, for each product it serves (K1; K2 v->v on
    triangles, v->p and p->p on tetrahedra), bfloat16 and float32 A: a ring
    of 2 to 16 stages whose shared memory is ``stream_smem_bytes`` of the
    product at that ring and fits a block, one or two blocks resident an SM
    for K1 and one to four for a block product, and a persistent grid of
    min(occupied chunks, resident blocks x SMs) over ``stream_work``'s
    list.  That the grid's walk takes every chunk shows in
    test_kernel_matches_plain, whose products sum each chunk's cells.  A
    product the kernel does not serve raises."""
    lay = _layout(name).to(cuda_device)
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    for ins, outs in tw.streamed_products(lay):
        for dtype, elt in ((torch.bfloat16, 2), (torch.float32, 4)):
            cfg = tw.stream_config(lay, dtype, ins, outs)
            tabs = lay._packed.compact
            k1 = ins == outs == "vp"
            assert 2 <= cfg["stages"] <= 16
            assert cfg["blocks_per_sm"] in ((1, 2) if k1 else (1, 2, 3, 4))
            assert cfg["smem_bytes"] == tw.stream_smem_bytes(lay, tabs, elt, cfg["stages"],
                                                             ins, outs)
            assert cfg["smem_bytes"] <= tw._MAX_SMEM_BYTES
            assert cfg["chunks"] == len(tw.stream_work(lay, lay._packed.cnt))
            assert cfg["grid"] == min(cfg["chunks"], cfg["blocks_per_sm"] * sms)
    for ins, outs in [("v", "v")] if lay.dim == 3 else [("v", "p"), ("p", "p")]:
        with pytest.raises(ValueError, match=f"no streaming {ins}->{outs} product"):
            tw.stream_config(lay, torch.bfloat16, ins, outs)


@pytest.mark.parametrize("name", sorted(LAYOUTS))
def test_slot_colours_are_a_proper_colouring(name):
    """The host table the kernels sum by: in every chunk, no two occupied
    slots of one colour share a window position of the velocity or the
    pressure space; padded slots have colour 0; ncolors is one past the
    largest colour, and greedy colouring stays small (triangles: at most
    16; tetrahedra, whose vertices each have some 20-30 cells: at most
    48)."""
    lay = _layout(name)
    pos_v, pos_p, cnt = tw.pack_positions(lay)
    colour, ncolors = tw.slot_colours(lay, pos_v, pos_p)
    assert colour.dtype == torch.uint8 and tuple(colour.shape) == (lay.nb, lay.Bmax)
    colour = colour.numpy().astype(np.int64)
    pv = tw.unpack_positions(pos_v).numpy()  # [nb, k_v, Bmax]
    pp = tw.unpack_positions(pos_p).numpy()
    filled = (pv >= 0).any(axis=1) | (pp >= 0).any(axis=1)
    assert not colour[~filled].any()
    assert ncolors == colour[filled].max() + 1
    assert ncolors <= (16 if lay.dim == 2 else 48)
    for b in range(lay.nb):
        for c in range(lay.nchunks):
            sl = slice(c * lay.Bc, (c + 1) * lay.Bc)
            for space in (pv, pp):
                pos, col = space[b, :, sl], colour[b, sl]  # [k, Bc], [Bc]
                key = pos + col[None, :] * (1 << 20)  # one position of one colour
                key = key[pos >= 0]
                assert len(np.unique(key)) == len(key), (b, c)


def _probe_operands(M, device, seed=None):
    g = torch.Generator().manual_seed(M if seed is None else seed)
    a = torch.randn((8 * M, mxu.K), generator=g).to(torch.bfloat16).to(device)
    b = torch.randn((mxu.K, mxu.N), generator=g).to(torch.bfloat16).to(device)
    return a, b


def _close_to_max(got, want, rel=1e-5):
    err = (got - want).abs().max().item()
    assert err <= rel * want.abs().max().item(), err


@pytest.mark.cuda
@pytest.mark.parametrize("iters", [1, 7, 64, 200])
@pytest.mark.parametrize("M", mxu.M_VALUES)
def test_mxu_probe_kernel_matches_plain(M, iters, cuda_device):
    """K5, the tensor-core probe: bf16 products accumulated in float32 in
    groups, within 1e-5 of the plain output's largest entry; also against
    the plain version of its own order of sums."""
    a, b = _probe_operands(M, cuda_device)
    before = mxu.mxu_probe.launches
    got = mxu.mxu_probe(a, b, M, iters)
    want = mxu.mxu_probe_reference(a, b, M, iters)
    torch.cuda.synchronize()
    assert mxu.mxu_probe.launches == before + 1
    assert got.shape == (M, mxu.N) and bool(torch.isfinite(got).all())
    _close_to_max(got, want)
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    assert mxu.mxu_probe.grid == mxu.probe_grid(M, mxu.N, iters, sms)
    groups = mxu.mxu_probe.grid["groups"]
    _close_to_max(got, mxu.mxu_probe_grouped_reference(a, b, M, iters, groups))


@pytest.mark.cuda
@pytest.mark.parametrize("M", [8, 256])
def test_mxu_probe_one_call_yardstick(M, cuda_device):
    """K5's library yardstick, one torch.mm of the probe's products laid side
    by side along K (bf16 operands, float32 output), is K5's function."""
    a, b = _probe_operands(M, cuda_device)
    iters = 64
    a_cat = torch.cat([a[(i % 8) * M:(i % 8 + 1) * M] for i in range(iters)], dim=1)
    b_stack = b.repeat(iters, 1)
    got = torch.mm(a_cat, b_stack, out_dtype=torch.float32)
    assert got.dtype == torch.float32
    _close_to_max(got, mxu.mxu_probe_reference(a, b, M, iters))


@pytest.mark.cuda
@pytest.mark.parametrize("M", [16, 144])
def test_mxu_probe_graph_replay_matches_eager(M, cuda_device):
    """The probe's call (tensor map, scratch, the group reduction) captured
    in a CUDA graph and replayed on new operands agrees with an eager call."""
    a, b = _probe_operands(M, cuda_device)
    fresh_a = _probe_operands(M, cuda_device, seed=M + 1)[0]
    _assert_replay_matches_eager(lambda: mxu.mxu_probe(a, b, M, 64), a, lambda: fresh_a)


@pytest.mark.cuda
def test_kernel_rejects_what_it_cannot_take(cuda_device):
    """A CUDA tensor launches the kernel or raises: float64 raises."""
    lay = _layout("blocked-h1").to(cuda_device)
    x = torch.zeros(lay.n_u + lay.n_ps, dtype=torch.float64, device=cuda_device)
    with pytest.raises(TypeError):
        tw.windowed_gather(lay, x)


@pytest.mark.cuda
def test_kernel_rejects_misaligned_operator(cuda_device):
    """A is streamed in 16-byte pieces: storage that starts off a 16-byte
    boundary raises instead of launching."""
    lay = _layout("blocked-h1").to(cuda_device)
    n = lay.nl * lay.nli * lay.ncd
    flat = torch.zeros(n + 1, dtype=torch.bfloat16, device=cuda_device)
    A = flat[1:].view(lay.nl, lay.nli, lay.ncd)
    x = torch.zeros(lay.n_u + lay.n_ps, dtype=torch.float32, device=cuda_device)
    assert A.is_contiguous() and A.data_ptr() % 16 != 0
    with pytest.raises(RuntimeError, match="16-byte aligned"):
        tw.windowed_matvec(lay, A, x)


@pytest.mark.cuda
@pytest.mark.parametrize("name", TETS)
def test_tet_scatter_rejects_misaligned_rows(name, cuda_device):
    """The 3D K4 at P2/P1 copies R's rows in 16-byte pieces: rows whose
    storage starts off a 16-byte boundary raise instead of launching.  At
    P3/P2 (the row-ordered sum over R, a value at a time) such rows are
    taken, with the bits of the same rows stored aligned."""
    lay = _layout(name).to(cuda_device)
    flat = _rand_on(cuda_device, 18)(lay.nli * lay.ncd + 1)
    R = flat[1:].view(lay.nli, lay.ncd)
    assert R.is_contiguous() and R.data_ptr() % 16 != 0
    tw.reset_launch_counts()
    if tw.scatter_rows(lay):
        assert torch.equal(tw.windowed_scatter(lay, R), tw.windowed_scatter(lay, R.clone()))
        return
    with pytest.raises(RuntimeError, match="16-byte aligned"):
        tw.windowed_scatter(lay, R)
    assert all(v == 0 for v in tw.launch_counts().values())


@pytest.mark.cuda
def test_tet_chunk_of_partial_warps_raises(cuda_device):
    """The 3D kernels, the gather and the scatter run one thread a slot and
    take whole warps: a tetrahedral layout whose chunk is 136 slots (rows of
    A still 16-byte multiples) raises from every wrapper and launches
    nothing."""
    mesh = box(2, 2, 2)
    dofs, bi = renumber_blocked(make_dofs(mesh), cells_per_block=16)
    lay = tw.build_windowed_layout(dofs.cell_vdofs, dofs.cell_pdofs, dofs.n_vs, dofs.n_ps,
                                   3, block_info=bi, Bc=136).to(cuda_device)
    assert lay.Bc % 32 != 0 and lay.Bc * 2 % 16 == 0
    rand = _rand_on(cuda_device, 15)
    x, R, A = rand(lay.n_u + lay.n_ps), rand(lay.nli, lay.ncd), rand(lay.nl, lay.nli, lay.ncd)
    tw.reset_launch_counts()
    for A_op in (A, A.to(torch.bfloat16)):
        A_vv = tw.slice_block(lay, A_op, "v", "v")
        for call in (lambda: tw.windowed_matvec(lay, A_op, x),
                     lambda: tw.windowed_matvec_block(lay, A_vv, x[: lay.n_u],
                                                      in_spaces="v", out_spaces="v")):
            with pytest.raises(RuntimeError, match="multiple of 32 slots"):
                call()
    for call in (lambda: tw.windowed_gather(lay, x), lambda: tw.windowed_scatter(lay, R)):
        with pytest.raises(RuntimeError, match="multiple of 32 slots"):
            call()
    assert all(v == 0 for v in tw.launch_counts().values())


@pytest.mark.cuda
@pytest.mark.parametrize("dim", [2, 3])
def test_unbuilt_element_raises(dim, cuda_device):
    """The kernels are built for Taylor-Hood P2/P1 and P3/P2 on triangles and
    tetrahedra: on the card a layout of another element, equal-order P2/P2
    (k_v = k_p), raises NotImplementedError from every wrapper and launches
    nothing (no fall-back to the plain versions)."""
    mesh = box(2, 2, 2) if dim == 3 else unit_square(4)
    dofs, bi = renumber_blocked(make_dofs(mesh, 2, 2), cells_per_block=16)
    lay = tw.build_windowed_layout(dofs.cell_vdofs, dofs.cell_pdofs, dofs.n_vs, dofs.n_ps,
                                   dim, block_info=bi, Bc=128).to(cuda_device)
    assert lay.k_v == lay.k_p and (lay.dim, lay.k_v, lay.k_p) not in tw._ELEMENTS
    rand = _rand_on(cuda_device, 14)
    x, R, A = rand(lay.n_u + lay.n_ps), rand(lay.nli, lay.ncd), rand(lay.nl, lay.nli, lay.ncd)
    A_vv = tw.slice_block(lay, A, "v", "v")
    tw.reset_launch_counts()
    for call in (lambda: tw.windowed_gather(lay, x), lambda: tw.windowed_gather_pair(lay, x, x),
                 lambda: tw.windowed_scatter(lay, R), lambda: tw.windowed_matvec(lay, A, x),
                 lambda: tw.windowed_matvec_block(lay, A_vv, x[: lay.n_u], in_spaces="v",
                                                  out_spaces="v")):
        with pytest.raises(NotImplementedError, match="P2/P1 and P3/P2"):
            call()
    assert all(v == 0 for v in tw.launch_counts().values())


@pytest.mark.parametrize("case", ["constant", "line", "unknown constant", "missing line"])
def test_stream_variants_edit_the_source(case):
    """``scripts/stream_variants.py`` makes a variant of windowed.cu by
    setting a ``constexpr int`` or replacing a line, and raises where the
    source has no such constant or line (a host check: no card)."""
    src = tw._SOURCE.read_text()
    if case == "constant":
        out = sv.variant_source(src, {"kStageRowBytes": 104, "noeq": True})
        assert "constexpr int kStageRowBytes = 104;" in out
        assert out.replace("kStageRowBytes = 104;", "") == re.sub(
            r"kStageRowBytes = \d+;", "", src)
    elif case == "line":
        old = "constexpr int kMaxStreamBlocks = 4;"
        out = sv.variant_source(src, {"subs": [[old, "constexpr int kMaxStreamBlocks = 2;"]]})
        assert old in src and old not in out and "kMaxStreamBlocks = 2;" in out
    elif case == "unknown constant":
        with pytest.raises(ValueError, match="kNoSuchConstant"):
            sv.variant_source(src, {"kNoSuchConstant": 1})
    else:
        with pytest.raises(ValueError, match="not in the source"):
            sv.variant_source(src, {"subs": [["no such line;", ""]]})
