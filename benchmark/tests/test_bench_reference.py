"""The plain reference against the port's flat assembly, in float64 on a
tiny generated DFG mesh: the Navier-Stokes residual (BDF1 and BDF2) and the
Stokes residual, within 1e-10 relative.  The test imports both; the
reference module imports nothing of the port."""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark.meshes import dfg_ogrid
from benchmark.reference import Reference, match, simplex_rule
from navier_stokes_tpu_torch import Mesh
from navier_stokes_tpu_torch.fem.assembly import (assemble_navier_stokes, assemble_stokes,
                                                  build_context)
from navier_stokes_tpu_torch.fem.dofs import make_dofs

TAGS = {"inlet": 1, "outlet": 2, "walls": 3, "cylinder": 4}
RECIPES = {
    2: dict(L=2.2, H=0.41, cx=0.2, cy=0.2, r=0.05, n_side=4, n_radial=3, n_down=8),
    3: dict(L=2.5, H=0.41, cx=0.5, cy=0.2, r=0.05, n_side=4, n_radial=2, n_up=2, n_down=6,
            n_z=2),
}


@pytest.fixture(params=[2, 3], scope="module")
def pair(request):
    dim = request.param
    m = dfg_ogrid.build(dict(RECIPES[dim], tags=TAGS))
    dofs = make_dofs(Mesh(m["coords"], m["cells"], m["facets"], m["tags"]), 2, 1)
    ctx = build_context(dofs, neumann_tags=(TAGS["outlet"],), dtype=torch.float64)
    ref = Reference(m["coords"], m["cells"], m["facets"], m["tags"], {})
    vperm = match(ref.nodes, dofs.v_coords, 1.0)
    pperm = match(ref.nodes[: ref.nv], dofs.p_coords, 1.0)

    def to_ref(x):
        return x[: dofs.n_u].reshape(dim, dofs.n_vs).T[vperm], x[dofs.n_u :][pperm]

    return dofs, ctx, ref, to_ref


def rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


@pytest.mark.parametrize("order", [1, 2])
def test_navier_stokes_residual(pair, order):
    dofs, ctx, ref, to_ref = pair
    g = torch.Generator().manual_seed(7)
    u, uo, uo2 = (torch.randn(dofs.n_total, generator=g, dtype=torch.float64) for _ in range(3))
    dt, nu = 0.0025, 1e-3
    # the port's BDF2: the BDF1 residual at (4 u_old - u_old2) / 3 with dt / 1.5
    uo_arg, dt_res = (uo, dt) if order == 1 else ((4 * uo - uo2) / 3, dt / 1.5)
    _, _, r = assemble_navier_stokes(
        ctx, u, uo_arg, dt=dt_res, nu=nu, rho=1.0, p_out=0.0, convection_form="standard",
        include_continuity_residual=True, jacobian_mass_rho=True)
    ru, rp = to_ref(r)
    a, ap = to_ref(u)
    su, sp = ref.residual(a, ap, to_ref(uo)[0], to_ref(uo2)[0], dt=dt, nu=nu, order=order)
    assert rel(su, ru) < 1e-10 and rel(sp, rp) < 1e-10


def test_stokes_residual(pair):
    dofs, ctx, ref, to_ref = pair
    g = torch.Generator().manual_seed(8)
    x = torch.randn(dofs.n_total, generator=g, dtype=torch.float64)
    cell_mat, _, rhs = assemble_stokes(ctx, nu=1e-3, rho=1.0, p_out=0.0)
    cd = ctx.cell_dofs.long()
    Ax = torch.zeros(dofs.n_total, dtype=torch.float64).index_add_(
        0, cd.reshape(-1), torch.einsum("cij,cj->ci", cell_mat, x[cd]).reshape(-1))
    ru, rp = to_ref(rhs - Ax)
    su, sp = ref.residual(*to_ref(x), nu=1e-3, stokes=True)
    assert rel(su, ru) < 1e-10 and rel(sp, rp) < 1e-10


@pytest.mark.parametrize("dim", [2, 3])
def test_rule_is_exact_to_degree_5(dim):
    pts, w = simplex_rule(dim)
    from math import factorial

    for powers in np.ndindex(*(6,) * dim):
        if sum(powers) > 5:
            continue
        # the integral of x^a y^b (z^c) over the unit simplex
        exact = np.prod([factorial(p) for p in powers]) / factorial(sum(powers) + dim)
        assert w @ np.prod(pts ** np.array(powers), axis=1) == pytest.approx(exact, rel=1e-13)


def test_reference_imports_nothing_of_the_port():
    src = (Path(__file__).resolve().parent.parent / "reference.py").read_text()
    names = set()
    for node in ast.walk(ast.parse(src)):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module.split(".")[0])
    assert names <= {"__future__", "numpy", "torch"}
