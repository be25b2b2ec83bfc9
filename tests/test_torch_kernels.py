"""The CUDA kernels against their plain torch versions, on a card.

This file imports no JAX, so it runs on a machine with a GPU and no JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py

Without a visible GPU every test skips.  Tolerances: K3 (gather) is a copy
and must be bit-equal; the others agree to 1e-5 of ||y||_inf (float32 sums
in another order, and shared-memory atomics in a run-dependent order).
K5, the tensor-core probe, is held to 1e-5 of its output's largest entry.
"""

import functools

import numpy as np
import pytest
import torch

from navier_stokes_tpu_torch.fem.dofs import make_dofs, renumber_blocked
from navier_stokes_tpu_torch.mesh.generate import unit_square
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
}
OPS = ["gather", "scatter", "matvec", "matvec-bf16A", "v->v", "v->p", "p->p",
       "v->v-f32A", "v->p-f32A", "p->p-f32A"]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@functools.lru_cache(maxsize=None)
def _layout(name):
    c = LAYOUTS[name]
    mesh = unit_square(c["n"])
    if c.get("refine"):
        mesh = refine_uniform(mesh, c["refine"])
    dofs = make_dofs(mesh)
    if "cpb" in c:
        dofs, bi = renumber_blocked(dofs, cells_per_block=c["cpb"])
        kw = dict(block_info=bi, Bc=c["Bc"])
    else:
        kw = dict(target_ow=c["target_ow"], Bc=c["Bc"])
    return tw.build_windowed_layout(
        dofs.cell_vdofs, dofs.cell_pdofs, dofs.n_vs, dofs.n_ps, 2, **kw
    )


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(LAYOUTS))
@pytest.mark.parametrize("op", OPS)
def test_kernel_matches_plain(name, op, cuda_device):
    lay = _layout(name).to(cuda_device)
    rng = np.random.default_rng(11)

    def rand(*shape):
        return torch.as_tensor(rng.standard_normal(shape), dtype=torch.float32,
                               device=cuda_device)

    x, A = rand(lay.n_u + lay.n_ps), rand(lay.nl, lay.nli, lay.ncd)
    tw.reset_launch_counts()
    if op == "gather":
        got, want = tw.windowed_gather(lay, x), tw._gather_reference(lay, x)
        assert torch.equal(got, want)
        assert tw.windowed_gather.launches == 1
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


@pytest.mark.cuda
def test_layouts_cover_the_kernel_paths():
    """The layouts above reach one chunk and several, a halo of 2 blocks, and
    fewer and more layout blocks than an H100 has SMs (132)."""
    lays = [_layout(name) for name in LAYOUTS]
    assert {lay.nchunks == 1 for lay in lays} == {True, False}
    assert any(lay.hv == 2 for lay in lays)
    assert min(lay.nb for lay in lays) < 132 < max(lay.nb for lay in lays)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["refined-Bc256", "legacy-3chunks"])
@pytest.mark.parametrize("op", ["matvec-bf16A", "v->v"])
def test_graph_replay_matches_eager(name, op, cuda_device):
    """A wrapper call is one C call with no host read, so a CUDA graph can
    capture it; the replay, on new inputs written into the captured tensors,
    agrees with an eager call (1e-5 of ||y||_inf: atomics reorder sums)."""
    lay = _layout(name).to(cuda_device)
    rng = np.random.default_rng(12)

    def rand(*shape):
        return torch.as_tensor(rng.standard_normal(shape), dtype=torch.float32,
                               device=cuda_device)

    A = rand(lay.nl, lay.nli, lay.ncd)
    if op == "v->v":
        A = tw.slice_block(lay, A, "v", "v")
        x = rand(lay.n_u)
        call = lambda: tw.windowed_matvec_block(lay, A, x, in_spaces="v", out_spaces="v")
    else:
        x = rand(lay.n_u + lay.n_ps)
        call = lambda: tw.windowed_matvec(lay, A, x)
    A = A.to(torch.bfloat16)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # the capture stream's scratch, before the capture
        call()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        y = call()
    x.copy_(rand(*x.shape))
    graph.replay()
    torch.cuda.synchronize()
    want = call()
    err = (y.double() - want.double()).abs().max().item()
    assert err <= 1e-5 * want.double().abs().max().item(), err


@pytest.mark.cuda
@pytest.mark.parametrize("M", mxu.M_VALUES)
def test_mxu_probe_kernel_matches_plain(M, cuda_device):
    """K5, the tensor-core probe: bf16 products accumulated in float32 in
    another order, within 1e-5 of the plain output's largest entry."""
    g = torch.Generator().manual_seed(M)
    a = torch.randn((8 * M, mxu.K), generator=g).to(torch.bfloat16).to(cuda_device)
    b = torch.randn((mxu.K, mxu.N), generator=g).to(torch.bfloat16).to(cuda_device)
    before = mxu.mxu_probe.launches
    got = mxu.mxu_probe(a, b, M, 64)
    want = mxu.mxu_probe_reference(a, b, M, 64)
    torch.cuda.synchronize()
    assert mxu.mxu_probe.launches == before + 1
    err = (got - want).abs().max().item()
    assert err <= 1e-5 * want.abs().max().item(), err


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
