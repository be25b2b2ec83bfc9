"""The 3D (tetrahedral) path: the port against the JAX package, in float64.

The cases of tests/test_3d.py and one of the 3D box configuration
(chip_smoke.py phase 14), run through both packages on the same box meshes,
the port on the CPU (plain versions):

* hydrostatic Stokes on box(2, 2, 2) (zero inlet, p_out on the outlet);
* unsteady Navier-Stokes, flat operator, 2 BDF1 steps;
* the windowed matvec against the flat element operator;
* Cahouet-Chabard on a windowed layout against the flat run;
* Cahouet-Chabard with CG and with FGMRES sweeps of A00 on a
  convection-dominated box(4, 4, 4), the box configuration's 2 steps;
* the P3 tetrahedron's dof map (a global cubic interpolated exactly) and its
  boundary dofs;
* P3/P2 Stokes with a cubic manufactured solution.

Solutions agree to 1e-10 and every Newton residual to 1e-10 of the run's
largest; Newton and FGMRES counts are equal.  One case's state is held
looser, with its reason: unpreconditioned GMRES (the flat run's default
identity preconditioner) on this mesh's weakly determined pressure turns
rounding into solution changes of ~1e-6, which JAX's own flat and windowed
runs show against each other (8.95e-7 in velocity).  The CUDA kernels on tetrahedral
layouts: tests/test_torch_kernels.py, on a card.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from navier_stokes_tpu.config import SolverConfig as JConfig
from navier_stokes_tpu.fem.assembly import assemble_navier_stokes as j_assemble
from navier_stokes_tpu.fem.assembly import build_context as j_build_context
from navier_stokes_tpu.fem.dofs import make_dofs as j_make_dofs
from navier_stokes_tpu.fem.dofs import renumber_blocked as j_renumber_blocked
from navier_stokes_tpu.fem.dofs import scalar_dof_map as j_scalar_dof_map
from navier_stokes_tpu.mesh.generate import box as j_box
from navier_stokes_tpu.models.navier_stokes import NavierStokesSolver as JSolver
from navier_stokes_tpu.models.stokes import StokesSolver as JStokes
from navier_stokes_tpu.ops import windowed as jw
from navier_stokes_tpu.utils.logging import RunLog as JLog
from navier_stokes_tpu_torch.config import SolverConfig
from navier_stokes_tpu_torch.fem.assembly import assemble_navier_stokes, build_context
from navier_stokes_tpu_torch.fem.dofs import make_dofs, renumber_blocked, scalar_dof_map
from navier_stokes_tpu_torch.fem.quadrature import gauss_simplex
from navier_stokes_tpu_torch.fem.reference_element import p_element
from navier_stokes_tpu_torch.la import operators as ops
from navier_stokes_tpu_torch.mesh.generate import box
from navier_stokes_tpu_torch.models.navier_stokes import NavierStokesSolver
from navier_stokes_tpu_torch.models.stokes import StokesSolver
from navier_stokes_tpu_torch.ops import windowed as tw
from navier_stokes_tpu_torch.utils.logging import RunLog

NU, RHO, POUT = 0.1, 1.0, 5.0
TOL = 1e-10


def _box_cfg(cls, **krylov):
    """tests/test_3d.py's configuration, float64: inlet tag 0, outlet 1,
    walls 2-5, dt 0.1, 2 steps."""
    cfg = cls(inlet_tags=(0,), neumann_tags=(1,), wall_tags=(2, 3, 4, 5),
              nu=NU, rho=RHO, p_out=POUT, dt=0.1, T=0.2)
    cfg.dtype = "float64"
    cfg.krylov.max_iters = 2000
    for k, v in krylov.items():
        setattr(cfg.krylov, k, v)
    return cfg


def _trajectory(log):
    """[(step, event, Newton residual or FGMRES count)] of a run's log."""
    out, step = [], 0
    for r in log.records:
        if r.get("event") == "time_step":
            step = r["step"]
        elif r.get("event") in ("newton", "gmres"):
            out.append((step, r["event"], r.get("residual", r.get("iters"))))
    return out


def _compare(jt, tt):
    """Equal FGMRES counts, and each Newton residual within TOL of the
    run's largest (a residual at the solver's floor carries its rounding)."""
    assert [(s, e) for s, e, _ in jt] == [(s, e) for s, e, _ in tt]
    scale = max(abs(v) for _, e, v in jt if e == "newton")
    for (s, e, jv), (_, _, tv) in zip(jt, tt):
        if e == "gmres":
            assert jv == tv, (s, jv, tv)
        else:
            assert abs(jv - tv) <= TOL * scale, (s, jv, tv)


def _gmres(log):
    return [r["iters"] for r in log.records if r.get("event") == "gmres"]


def _same_solution(ts, js, tol_u=TOL, tol_p=TOL, free_p=False):
    """Velocities within tol_u, pressures within tol_p (free_p: up to a
    constant, the pressure of an all-Dirichlet problem)."""
    np.testing.assert_allclose(ts.velocity(), js.velocity(), rtol=0, atol=tol_u)
    tp, jp = ts.pressure(), js.pressure()
    if free_p:
        tp, jp = tp - tp.mean(), jp - jp.mean()
    np.testing.assert_allclose(tp, jp, rtol=0, atol=tol_p)


def test_stokes_hydrostatic_3d_matches_jax_f64():
    """Zero inlet and p_out on the outlet: u = 0, p = p_out (P2 does not
    hold the 3D Poiseuille profile, tests/test_3d.py).  Solved to 1e-10 of
    ||b||: at the default 1e-6 the velocity is solver noise (~4e-7), which
    the two packages' orders of sums move by ~1e-9."""
    kw = dict(preconditioner="block_triangular", stokes_rel_tol=1e-10)
    js = JStokes(j_box(2, 2, 2), _box_cfg(JConfig, **kw), log=JLog(verbose=False))
    ts = StokesSolver(box(2, 2, 2), _box_cfg(SolverConfig, **kw), log=RunLog(verbose=False),
                      device="cpu")
    js.solve()
    ts.solve()
    assert _gmres(ts.log) == _gmres(js.log) and len(_gmres(ts.log)) == 1
    _same_solution(ts, js)
    assert np.max(np.abs(ts.velocity())) < 1e-4
    assert np.allclose(ts.pressure(), POUT, atol=1e-3)


@functools.lru_cache(maxsize=None)
def _ns_runs(matvec, precond="identity"):
    """Both packages' 2-step runs on box(2, 2, 2): "flat" is
    tests/test_3d.py's unsteady case (with its default identity
    preconditioner, or another), "windowed" and "flat-cc" its
    Cahouet-Chabard case and the flat run it is held against (continuity
    residual, Newton tol 1e-8, FGMRES rel_tol 1e-5)."""
    kw = dict(preconditioner=precond)
    if matvec != "flat":
        kw = dict(rel_tol=1e-5, matvec=matvec.removesuffix("-cc"), cells_per_block=16,
                  preconditioner="cahouet_chabard")

    def config(cls):
        cfg = _box_cfg(cls, **kw)
        if matvec != "flat":
            cfg.include_continuity_residual = True
            cfg.newton.tol = 1e-8
        return cfg

    jlog, tlog = JLog(verbose=False), RunLog(verbose=False)
    js = JSolver(j_box(2, 2, 2), config(JConfig), log=jlog)
    ts = NavierStokesSolver(box(2, 2, 2), config(SolverConfig), log=tlog, device="cpu")
    js.solve()
    ts.solve()
    return js, ts, _trajectory(jlog), _trajectory(tlog)


def _by_coords(s):
    """{velocity node: velocity} of a solver, holes dropped: two DoF
    numberings of one mesh line up by node."""
    return {tuple(np.round(c, 10)): v for c, v in
            zip(s.velocity_coords(real_only=True), s.velocity(real_only=True))}


@pytest.mark.parametrize("precond", ["identity", "block_triangular", "block_diagonal"])
def test_unsteady_ns_3d_flat_matches_jax_f64(precond):
    """Identity: the state within 1e-5 (velocity, max |u| 0.17) and 5e-5
    (pressure, ~5), where JAX's own windowed run of the same steps lies
    more than 1e-7 from its flat one (see the module's note).  The block
    preconditioners: 1e-10."""
    js, ts, jt, tt = _ns_runs("flat", precond)
    assert ts._matvec == "flat" and sum(e == "gmres" for _, e, _ in tt) >= 2
    _compare(jt, tt)
    if precond != "identity":
        _same_solution(ts, js)
        return
    _same_solution(ts, js, 1e-5, 5e-5)
    cfg = _box_cfg(JConfig, matvec="windowed", cells_per_block=16)
    jwin = JSolver(j_box(2, 2, 2), cfg, log=JLog(verbose=False))
    jwin.solve()
    flat, win = _by_coords(js), _by_coords(jwin)
    assert max(np.max(np.abs(flat[k] - win[k])) for k in flat) > 1e-7
    assert np.all(np.isfinite(ts.solution.numpy()))
    bd = ts.dofs.boundary_scalar_vdofs([0, 2, 3, 4, 5])
    assert np.max(np.abs(ts.velocity()[bd])) < 1e-8


def test_windowed_matvec_3d_matches_flat_and_jax_f64():
    """The windowed plain matvec on a blocked box layout against the flat
    element operator (the port's and JAX's) and JAX's windowed reference."""
    mesh = box(2, 2, 2)
    dofs, bi = renumber_blocked(make_dofs(mesh), cells_per_block=16)
    jdofs, jbi = j_renumber_blocked(j_make_dofs(j_box(2, 2, 2)), cells_per_block=16)
    assert np.array_equal(dofs.cell_dofs, jdofs.cell_dofs)
    ctx = build_context(dofs, neumann_tags=(1,), dtype=torch.float64, device="cpu")
    jctx = j_build_context(jdofs, neumann_tags=(1,))
    args = (dofs.cell_vdofs, dofs.cell_pdofs, dofs.n_vs, dofs.n_ps, 3)
    lay = tw.build_windowed_layout(*args, block_info=bi)
    jlay = jw.build_windowed_layout(*args, block_info=jbi)
    rng = np.random.default_rng(2)
    u = rng.standard_normal(dofs.n_total)
    x = rng.standard_normal(dofs.n_total)
    cell_mat, _, _ = assemble_navier_stokes(ctx, torch.as_tensor(u), torch.as_tensor(u),
                                            dt=0.1, nu=NU, rho=RHO, p_out=POUT)
    jcell_mat, _, _ = j_assemble(jctx, jnp.asarray(u), jnp.asarray(u), dt=0.1, nu=NU, rho=RHO,
                                 p_out=POUT)
    np.testing.assert_allclose(cell_mat.numpy(), np.asarray(jcell_mat), rtol=0, atol=1e-12)
    op = ops.ElementOperator(cell_mat, ctx.cell_dofs, torch.zeros(0, dtype=torch.int64),
                             cell_mat.new_zeros(0), ctx.scatter_full, ctx.n_total)
    y_flat = ops.matvec(op, torch.as_tensor(x)).numpy()
    y_win = tw.windowed_matvec_reference(lay, tw.to_block_form(lay, cell_mat),
                                         torch.as_tensor(x)).numpy()
    jy_win = np.asarray(jw.windowed_matvec_reference(
        jlay, jw.to_block_form(jlay, jcell_mat), jnp.asarray(x)))
    np.testing.assert_allclose(y_win, y_flat, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(y_win, jy_win, rtol=0, atol=TOL * np.abs(jy_win).max())


def test_cahouet_chabard_3d_windowed_matches_jax_f64():
    """CC on a windowed tetrahedral layout (Kp and the outflow pinning are
    dim-generic; the Kp pinning probe is 2D only): the same run as JAX's,
    and within 1e-5 of the flat run node by node (tests/test_3d.py)."""
    js, ts, jt, tt = _ns_runs("windowed")
    assert ts._matvec == "windowed" and ts._win_layout.dim == 3
    assert ts._wassembly.coarse_inv is None  # no Kp coarse term in 3D
    _compare(jt, tt)
    _same_solution(ts, js)
    _, flat, _, _ = _ns_runs("flat-cc")
    assert flat._matvec == "flat"
    v1, v2 = _by_coords(ts), _by_coords(flat)
    assert v1.keys() == v2.keys()
    assert max(np.max(np.abs(v1[k] - v2[k])) for k in v1) < 1e-5


def _convection_inlet(x, t=0.0):
    """kernel_bench.box_inlet's profile (peak 1.5) ramped over t 0-0.4."""
    v = np.zeros_like(x)
    y, z = x[:, 1], x[:, 2]
    v[:, 0] = 24.0 * y * (1.0 - y) * z * (1.0 - z) * min(1.0, t / 0.4)
    return v


@functools.lru_cache(maxsize=None)
def _convection_runs(a00_solver):
    """Both packages' 2 BDF1 steps on box(4, 4, 4) from rest in the box's
    configuration (kernel_bench.box_config: p_out 10, the corrected
    formulation, windowed + CC with 6 A00 sweeps, FGMRES to 1e-2) at nu 4e-3
    and dt 0.2, with these A00 sweeps.  Step 2 is convection-dominated, as
    the 196,608-tet box's is: u dt / h is 1.2 here (2.4 there), u h / nu
    94 (47 there)."""
    def config(cls):
        cfg = _box_cfg(cls, matvec="windowed", preconditioner="cahouet_chabard",
                       cc_iters_a00=6, a00_solver=a00_solver, rel_tol=1e-2)
        cfg.nu, cfg.p_out, cfg.dt, cfg.T = 4e-3, 10.0, 0.2, 0.4
        cfg.convection_form = "standard"
        cfg.include_continuity_residual = True
        cfg.jacobian_mass_rho = True
        return cfg

    jlog, tlog = JLog(verbose=False), RunLog(verbose=False)
    js = JSolver(j_box(4, 4, 4), config(JConfig), log=jlog, inlet=_convection_inlet)
    ts = NavierStokesSolver(box(4, 4, 4), config(SolverConfig), log=tlog,
                            inlet=_convection_inlet, device="cpu")
    js.solve()
    ts.solve()
    return js, ts, _trajectory(jlog), _trajectory(tlog)


@pytest.mark.parametrize("a00_solver", ["cg", "gmres"])
def test_cc_a00_sweeps_on_convection_dominated_box_match_jax_f64(a00_solver):
    """With CG sweeps of A00 (bench.py's 3D leg) the step-2 tangent solve
    takes more than ten times the FGMRES sweeps' count, in JAX as in the
    port: the reference's CG sweeps lose to convection (PERF.md, the 3D
    box).  Both sweeps: the same run as JAX's."""
    js, ts, jt, tt = _convection_runs(a00_solver)
    _compare(jt, tt)
    _same_solution(ts, js)
    counts = [v for s, e, v in tt if e == "gmres" and s == 2]
    if a00_solver == "cg":
        fgmres_swept = [v for s, e, v in _convection_runs("gmres")[3] if e == "gmres" and s == 2]
        assert counts[0] > 10 * fgmres_swept[0], (counts, fgmres_swept)


def _cubic(p):
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    return x**3 - 2 * y**3 + 0.5 * z**3 + x * y * z + x**2 * z - y


def test_p3_tet_dof_map_matches_jax_and_is_cubic_exact():
    """P3 tetrahedra: the dof map equals JAX's, and nodal interpolation of a
    global cubic is exact at interior quadrature points (the 20-node
    tabulation, the edge-dof orientation across cells, the face bubbles)."""
    mesh = box(2, 3, 2)
    n, cd, coords = scalar_dof_map(mesh, 3)
    jn, jcd, jcoords = j_scalar_dof_map(j_box(2, 3, 2), 3)
    assert n == jn and np.array_equal(cd, jcd)
    np.testing.assert_array_equal(coords, jcoords)
    assert n == mesh.n_nodes + 2 * mesh.n_edges + mesh.n_faces
    assert cd.shape == (mesh.n_cells, 20)
    q = gauss_simplex(3, 4)
    N, _ = p_element(3, 3).tabulate(q.points)  # [20, nq]
    lam = np.concatenate([(1 - q.points.sum(1))[:, None], q.points], axis=1)
    xq = np.einsum("qv,cvd->cqd", lam, mesh.coords[mesh.cells])
    u_h = np.einsum("cb,bq->cq", _cubic(coords)[cd], N)
    np.testing.assert_allclose(u_h, _cubic(xq), rtol=0, atol=1e-11)


def test_p3_tet_boundary_dofs_match_jax_and_geometry():
    """The P3 velocity dofs on the box's boundary: JAX's set, and every dof
    whose support point lies on a face of the unit cube."""
    mesh = box(2, 2, 3)
    dofs = make_dofs(mesh, degree_velocity=3, degree_pressure=2)
    jdofs = j_make_dofs(j_box(2, 2, 3), degree_velocity=3, degree_pressure=2)
    got = np.sort(dofs.boundary_scalar_vdofs(tuple(mesh.tags)))
    assert np.array_equal(got, np.sort(jdofs.boundary_scalar_vdofs(tuple(mesh.tags))))
    c = dofs.v_coords
    on_b = np.nonzero((np.abs(c) < 1e-12).any(axis=1) | (np.abs(c - 1.0) < 1e-12).any(axis=1))[0]
    np.testing.assert_array_equal(got, np.sort(on_b))


P3_NU = 0.7


def _u_cubic(p):
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    return np.stack([y**3 + z**2, z**3 + x**2, x**3 + y**2], axis=-1)


def _f_cubic(p):
    x, y, z = p[:, 0], p[:, 1], p[:, 2]
    return np.stack([-P3_NU * (6 * y + 2) + 2 * x,
                     -P3_NU * (6 * z + 2) + 2 * y,
                     -P3_NU * (6 * x + 2) + 2 * z], axis=1)


def test_stokes_p3_p2_3d_cubic_exact_matches_jax_f64():
    """P3/P2 Taylor-Hood on tetrahedra holds a divergence-free cubic flow
    (and its quadratic pressure) exactly: the same FGMRES count and solution
    as JAX's, and the exact flow to solver precision.  Solved to 1e-13 with
    the inner CG to 1e-10: at tests/test_3d.py's 1e-11 and 1e-4 the
    pressure is determined only to ~1e-7, and the two packages' rounding
    moves it by 1.3e-7."""
    def config(cls):
        cfg = cls(inlet_tags=(0, 1, 2, 3, 4, 5), neumann_tags=(), wall_tags=(),
                  nu=P3_NU, rho=1.0, p_out=0.0)
        cfg.dtype = "float64"
        cfg.degree_velocity, cfg.degree_pressure, cfg.quadrature_degree = 3, 2, 6
        cfg.krylov.preconditioner = "block_triangular"
        cfg.krylov.stokes_rel_tol = 1e-13
        cfg.krylov.inner_tol = 1e-10
        cfg.krylov.max_iters = 8000
        return cfg

    def inlet(x, t=0.0):
        return _u_cubic(x)

    js = JStokes(j_box(2, 2, 2), config(JConfig), log=JLog(verbose=False), forcing=_f_cubic,
                 inlet=inlet)
    ts = StokesSolver(box(2, 2, 2), config(SolverConfig), log=RunLog(verbose=False),
                      forcing=_f_cubic, inlet=inlet, device="cpu")
    js.solve()
    ts.solve()
    assert _gmres(ts.log) == _gmres(js.log) and len(_gmres(ts.log)) == 1
    _same_solution(ts, js, free_p=True)
    sol = ts.solution.numpy()
    d = ts.dofs
    ue = _u_cubic(d.v_coords)  # exact at every P3 support point
    err = max(float(np.max(np.abs(sol[c * d.n_vs:(c + 1) * d.n_vs] - ue[:, c])))
              for c in range(3))
    assert err < 1e-6, err
    dp = sol[d.n_u:] - np.sum(d.p_coords**2, axis=1)  # quadratic, up to a constant
    assert float(np.max(np.abs(dp - dp.mean()))) < 1e-5
