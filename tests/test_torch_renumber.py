"""The port's locality renumberings against the JAX package's, index for index.

``_morton_cell_order``, ``renumber_sfc`` (along that order),
``renumber_bandwidth`` and ``renumber_blocked(order="sfc")`` on triangles at
P2/P1 and P3/P2 and on a small box: every array bit-identical
(``np.array_equal``).  Then tests/test_windowed.py's check on the port: a
solve on Morton-renumbered dofs gives the base run's velocity, node by
node, within 1e-8.
"""

import numpy as np
import pytest
import torch

import navier_stokes_tpu.fem.dofs as j_dofs
import navier_stokes_tpu.mesh.generate as j_gen
import navier_stokes_tpu.mesh.mesh as j_mesh
import navier_stokes_tpu_torch.fem.dofs as t_dofs
import navier_stokes_tpu_torch.mesh.generate as t_gen
import navier_stokes_tpu_torch.mesh.mesh as t_mesh
from navier_stokes_tpu_torch.config import SolverConfig
from navier_stokes_tpu_torch.fem.assembly import build_context
from navier_stokes_tpu_torch.fem.bcs import DirichletBC, build_dirichlet
from navier_stokes_tpu_torch.models.navier_stokes import NavierStokesSolver
from navier_stokes_tpu_torch.parallel.spmd import morton_order
from navier_stokes_tpu_torch.utils.logging import RunLog

from test_torch_host import DOF_FIELDS, _equal_fields

CASES = {  # name: (mesh from (generate, mesh) modules, degrees)
    "square-p2": (lambda g, m: m.refine_uniform(g.rectangle(6, 3, 0, 7, 0, 4), 1), (2, 1)),
    "square-p3": (lambda g, m: g.unit_square(5), (3, 2)),
    "box-p2": (lambda g, m: g.box(3, 3, 3), (2, 1)),
}


def _dofs(case):
    build, degrees = CASES[case]
    jm, tm = build(j_gen, j_mesh), build(t_gen, t_mesh)
    return j_dofs.make_dofs(jm, *degrees), t_dofs.make_dofs(tm, *degrees)


def _same_dofs(jd, td):
    _equal_fields(jd, td, DOF_FIELDS)
    assert np.array_equal(jd.cell_dofs, td.cell_dofs)


@pytest.mark.parametrize("case", sorted(CASES))
def test_morton_cell_order_matches_jax(case):
    jd, td = _dofs(case)
    jo, to = j_dofs._morton_cell_order(jd.mesh), t_dofs._morton_cell_order(td.mesh)
    assert jo.dtype == to.dtype and np.array_equal(jo, to)
    assert np.array_equal(np.sort(to), np.arange(td.mesh.n_cells))


@pytest.mark.parametrize("case", sorted(CASES))
def test_renumber_sfc_matches_jax(case):
    jd, td = _dofs(case)
    order = t_dofs._morton_cell_order(td.mesh)
    _same_dofs(j_dofs.renumber_sfc(jd, order), t_dofs.renumber_sfc(td, order))


@pytest.mark.parametrize("case", sorted(CASES))
def test_renumber_bandwidth_matches_jax(case):
    jd, td = _dofs(case)
    (jr, jo), (tr, to) = j_dofs.renumber_bandwidth(jd), t_dofs.renumber_bandwidth(td)
    assert jo.dtype == to.dtype and np.array_equal(jo, to)
    _same_dofs(jr, tr)


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("order", ["sfc", "rcm"])
def test_renumber_blocked_order_matches_jax(case, order):
    jd, td = _dofs(case)
    (jr, jbi), (tr, tbi) = (j_dofs.renumber_blocked(jd, cells_per_block=16, order=order),
                            t_dofs.renumber_blocked(td, cells_per_block=16, order=order))
    assert jbi == tbi
    _same_dofs(jr, tr)


def test_sfc_renumbered_solve_equivalent():
    """tests/test_windowed.py's test_renumbered_solution_equivalent on the
    port: the same 2 steps on the natural and on Morton-renumbered dofs
    (float64, the flat operator), velocity node by node within 1e-8."""
    cfg = SolverConfig(inlet_tags=(0,), neumann_tags=(1,), wall_tags=(2, 3),
                       nu=0.04, p_out=10.0, dt=0.05, T=0.1)
    cfg.dtype = "float64"
    cfg.krylov.max_iters = 500
    base = NavierStokesSolver(t_gen.unit_square(3), cfg, log=RunLog(verbose=False), device="cpu")
    base.solve()

    ren = NavierStokesSolver(t_gen.unit_square(3), cfg, log=RunLog(verbose=False), device="cpu")
    ren.setup()
    order = morton_order(ren.mesh.coords[ren.mesh.cells].mean(axis=1))
    ren.dofs = t_dofs.renumber_sfc(t_dofs.make_dofs(ren.mesh), order)
    ren.ctx = build_context(ren.dofs, neumann_tags=cfg.neumann_tags, dtype=ren._dtype)
    ren.dirichlet = build_dirichlet(ren.dofs, [DirichletBC(tags=tuple(cfg.inlet_tags),
                                                           value=ren.inlet),
                                               DirichletBC(tags=tuple(cfg.wall_tags))])
    ren._bc_rows = torch.as_tensor(np.asarray(ren.dirichlet.rows, np.int64))
    ren.solution = torch.zeros(ren.dofs.n_total, dtype=ren._dtype)
    ren.solution_old = ren.solution
    assert not np.array_equal(ren.dofs.cell_vdofs, base.dofs.cell_vdofs)
    ren.solve()

    def field(s):
        return {tuple(np.round(c, 10)): v for c, v in zip(s.dofs.v_coords, s.velocity())}

    fb, fr = field(base), field(ren)
    assert fb.keys() == fr.keys()
    assert np.abs(np.concatenate([fb[k] for k in fb])).max() > 0.1  # a real flow
    err = max(np.max(np.abs(fb[k] - fr[k])) for k in fb)
    assert err < 1e-8
