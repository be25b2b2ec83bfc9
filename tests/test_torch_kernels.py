"""The CUDA kernels against their plain torch versions, on a card.

This file imports no JAX, so it runs on a machine with a GPU and no JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py

Without a visible GPU every test skips but the slot colouring's, which
checks a host table.  The layouts are P2/P1 on triangles (2D) and on
tetrahedra (3D, the kernels' other design: one component's subwindow in
shared memory at a time).  Tolerances: K3 (gather, one vector or the pair u,
u_old in one launch) is a copy and must be bit-equal; the others agree to
1e-5 of ||y||_inf (float32 sums in another order: the kernels sum a chunk's
slots in colour order).  K1, K2 and K4 sum in a fixed order, so a repeated
call and a CUDA-graph replay give the same bits as an eager call.  K5, the
tensor-core probe, is held to 1e-5 of its output's largest entry (bf16
products summed in float32 in groups, in another order).
"""

import functools

import numpy as np
import pytest
import torch

from navier_stokes_tpu_torch.fem.dofs import make_dofs, renumber_blocked
from navier_stokes_tpu_torch.mesh.generate import box, unit_square
from navier_stokes_tpu_torch.mesh.mesh import refine_uniform
from navier_stokes_tpu_torch.ops import windowed as tw
from navier_stokes_tpu_torch.scripts import mxu_probe as mxu

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
    c = LAYOUTS[name]
    mesh = box(c["box"], c["box"], c["box"]) if "box" in c else unit_square(c["n"])
    if c.get("refine"):
        mesh = refine_uniform(mesh, c["refine"])
    dofs = make_dofs(mesh)
    if "cpb" in c:
        dofs, bi = renumber_blocked(dofs, cells_per_block=c["cpb"])
        kw = dict(block_info=bi, Bc=c["Bc"])
    else:
        kw = dict(target_ow=c["target_ow"], Bc=c["Bc"])
    return tw.build_windowed_layout(
        dofs.cell_vdofs, dofs.cell_pdofs, dofs.n_vs, dofs.n_ps, mesh.dim, **kw
    )


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(LAYOUTS))
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


TETS = ["box-h1", "box-refined-Bc256", "box-refined-h2"]


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
    [(name, op) for name in ["refined-Bc256", "legacy-3chunks"]
     for op in ["matvec-bf16A", "v->v", "scatter", "gather", "gather-pair"]]
    + [(name, op) for name in TETS for op in OPS])
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
    [(name, op) for name in ["refined-Bc256", "legacy-3chunks", "blocked-h2"]
     for op in ["matvec-bf16A", "matvec", "v->v", "v->p", "p->p", "scatter"]]
    + [(name, op) for name in TETS for op in OPS])
def test_repeat_calls_are_bit_equal(name, op, cuda_device):
    """K1 (bf16 and float32 A), each K2 product and K4 sum in a fixed
    order (and K3 copies): two calls on the same inputs give the same
    bits."""
    lay = _layout(name).to(cuda_device)
    call, _ = _op_call(lay, op, _rand_on(cuda_device, 13))
    first, second = call(), call()
    torch.cuda.synchronize()
    assert torch.equal(first, second)


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
def test_p3_layout_raises(dim, cuda_device):
    """The kernels are built for P2/P1 on triangles and tetrahedra: on the
    card a P3/P2 layout raises NotImplementedError from every wrapper and
    launches nothing (no fall-back to the plain versions)."""
    mesh = box(2, 2, 2) if dim == 3 else unit_square(4)
    dofs, bi = renumber_blocked(make_dofs(mesh, 3, 2), cells_per_block=16)
    lay = tw.build_windowed_layout(dofs.cell_vdofs, dofs.cell_pdofs, dofs.n_vs, dofs.n_ps,
                                   dim, block_info=bi, Bc=128).to(cuda_device)
    rand = _rand_on(cuda_device, 14)
    x, R, A = rand(lay.n_u + lay.n_ps), rand(lay.nli, lay.ncd), rand(lay.nl, lay.nli, lay.ncd)
    A_vv = tw.slice_block(lay, A, "v", "v")
    tw.reset_launch_counts()
    for call in (lambda: tw.windowed_gather(lay, x), lambda: tw.windowed_gather_pair(lay, x, x),
                 lambda: tw.windowed_scatter(lay, R), lambda: tw.windowed_matvec(lay, A, x),
                 lambda: tw.windowed_matvec_block(lay, A_vv, x[: lay.n_u], in_spaces="v",
                                                  out_spaces="v")):
        with pytest.raises(NotImplementedError, match="P2/P1"):
            call()
    assert all(v == 0 for v in tw.launch_counts().values())
