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
}
OPS = ["gather", "scatter", "matvec", "matvec-bf16A", "v->v", "v->p", "p->p"]


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
        ins, outs = op.split("->")
        A_sub = tw.slice_block(lay, A, ins, outs).to(torch.bfloat16)
        xs = x[: lay.n_u] if ins == "v" else x[lay.n_u :]
        got = tw.windowed_matvec_block(lay, A_sub, xs, in_spaces=ins, out_spaces=outs)
        want = tw._block_reference(lay, A_sub, xs, ins, outs)
        launched = tw.windowed_matvec_block
    torch.cuda.synchronize()
    assert launched.launches == 1
    err = (got.double() - want.double()).abs().max().item()
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
