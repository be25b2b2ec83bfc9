"""The manufactured-solution tests of the JAX package, on the port, in
float64 on the CPU.

The port's counterparts of tests/test_mms_convergence.py (the steady Stokes
spatial orders: Taylor-Hood P2/P1, velocity L2 order 3 and pressure order
2; P3/P2, orders 4 and 3) and tests/test_ns_mms_time.py (the time-dependent
manufactured solution through the whole Newton / BDF path: BDF1 temporal
order 1, BDF2 order 2, BDF2 more accurate than BDF1, and the error against
the exact solution), with the same fields (imported from those files), the
same configurations and the same bounds, marked slow as they are there.
The Newton/BDF runs use the flat operator without a preconditioner, as
JAX's do.

Not slow, one case per order family: the port's error norms on the two
coarsest meshes (Stokes P2/P1 and P3/P2) and at the two coarsest steps
(BDF1 and BDF2, the error against the exact solution on unit_square(4))
against JAX's within 1e-9 relative.
"""

import numpy as np
import pytest
import torch

import test_mms_convergence as jm
import test_ns_mms_time as jt
from navier_stokes_tpu_torch.config import SolverConfig
from navier_stokes_tpu_torch.fem.geometry import cell_geometry
from navier_stokes_tpu_torch.fem.quadrature import gauss_simplex
from navier_stokes_tpu_torch.mesh.generate import unit_square
from navier_stokes_tpu_torch.models.navier_stokes import NavierStokesSolver
from navier_stokes_tpu_torch.models.stokes import StokesSolver
from navier_stokes_tpu_torch.utils.logging import RunLog


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Eager torch on these small meshes runs fastest, and least disturbed
    by other processes, on one thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _solution(solver) -> np.ndarray:
    return solver.solution.double().cpu().numpy()


def l2_errors(solver):
    """tests/test_mms_convergence.py ``l2_errors`` on the port's solver:
    quadrature L2 errors of (velocity, pressure), the pressure's free
    constant removed."""
    dofs = solver.dofs
    quad = gauss_simplex(2, 7)
    geo = cell_geometry(dofs.mesh, quad)
    Nv, _ = dofs.element.velocity.tabulate(quad.points)
    Np, _ = dofs.element.pressure.tabulate(quad.points)
    sol = _solution(solver)
    uc = sol[dofs.cell_vdofs[:, None, :] + np.arange(2)[None, :, None] * dofs.n_vs]
    u_h = np.einsum("cdb,bq->cqd", uc, Nv)
    p_h = np.einsum("cb,bq->cq", sol[dofs.n_u + dofs.cell_pdofs], Np)
    xq, W = geo.qpts, geo.jxw
    ue1, ue2 = jm.u_exact(xq[..., 0], xq[..., 1])
    pe = jm.p_exact(xq[..., 0], xq[..., 1])
    shift = ((p_h - pe) * W).sum() / W.sum()
    err_u = np.sqrt((((u_h[..., 0] - ue1) ** 2 + (u_h[..., 1] - ue2) ** 2) * W).sum())
    err_p = np.sqrt((((p_h - pe - shift) ** 2) * W).sum())
    return err_u, err_p


def solve_on(n, deg_v=2, deg_p=1):
    """tests/test_mms_convergence.py ``solve_on``: steady Stokes with the
    manufactured forcing, every side Dirichlet, block_triangular to 1e-10."""
    cfg = SolverConfig(inlet_tags=(0, 1, 2, 3), neumann_tags=(), wall_tags=(), nu=jm.NU,
                       rho=jm.RHO, p_out=0.0)
    cfg.dtype = "float64"
    cfg.degree_velocity, cfg.degree_pressure = deg_v, deg_p
    cfg.quadrature_degree = 2 * deg_v
    cfg.krylov.preconditioner = "block_triangular"
    cfg.krylov.stokes_rel_tol = 1e-10
    cfg.krylov.inner_tol = 1e-3
    cfg.krylov.max_iters = 6000
    solver = StokesSolver(unit_square(n), cfg, log=RunLog(verbose=False), forcing=jm.forcing,
                          inlet=jm.zero_inlet, device="cpu")
    solver.solve()
    return solver


def solve_ns(n, dt, T, scheme="bdf1"):
    """tests/test_ns_mms_time.py ``solve_ns``: the Newton / BDF path with
    the time-dependent forcing and boundary values."""
    cfg = SolverConfig(inlet_tags=(0, 1, 2, 3), neumann_tags=(), wall_tags=(), nu=jt.NU,
                       rho=jt.RHO, p_out=0.0, dt=dt, T=T)
    cfg.dtype = "float64"
    cfg.time_scheme = scheme
    cfg.convection_form = "standard"
    cfg.include_continuity_residual = True
    cfg.jacobian_mass_rho = True
    cfg.newton.tol = 1e-9
    cfg.newton.max_iters = 20
    cfg.krylov.rel_tol = 1e-8
    cfg.krylov.max_iters = 4000
    s = NavierStokesSolver(unit_square(n), cfg, log=RunLog(verbose=False), forcing=jt.forcing,
                           inlet=jt.inlet, device="cpu")
    s.solve()
    return s


def u_l2_error(solver, t):
    """tests/test_ns_mms_time.py ``u_l2_error`` on the port's solver."""
    dofs = solver.dofs
    quad = gauss_simplex(2, 7)
    geo = cell_geometry(dofs.mesh, quad)
    Nv, _ = dofs.element.velocity.tabulate(quad.points)
    sol = _solution(solver)
    uc = sol[dofs.cell_vdofs[:, None, :] + np.arange(2)[None, :, None] * dofs.n_vs]
    u_h = np.einsum("cdb,bq->cqd", uc, Nv)
    ue1, ue2 = jt.u_exact(geo.qpts[..., 0], geo.qpts[..., 1], t)
    W = geo.jxw
    return float(np.sqrt((((u_h[..., 0] - ue1) ** 2 + (u_h[..., 1] - ue2) ** 2) * W).sum()))


def _close(got, want, rel=1e-9):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert np.all(np.abs(got - want) <= rel * np.abs(want)), (got, want)


# ---- not slow: the error norms against JAX's ------------------------------


@pytest.mark.parametrize("degrees, sizes", [((2, 1), (4, 8)), ((3, 2), (2, 4))],
                         ids=["p2p1", "p3p2"])
def test_spatial_errors_match_jax(degrees, sizes):
    """The Stokes velocity and pressure L2 errors on the two coarsest meshes
    of each spatial-order test."""
    got = [l2_errors(solve_on(n, *degrees)) for n in sizes]
    want = [jm.l2_errors(jm.solve_on(n, *degrees)) for n in sizes]
    _close(got, want)


@pytest.mark.parametrize("scheme", ["bdf1", "bdf2"])
def test_temporal_errors_match_jax(scheme):
    """The velocity's L2 error against the exact solution at T 0.2 after
    steps of 0.1 and 0.05 on unit_square(4), BDF1 or BDF2 (its first step
    BDF1)."""
    T = 0.2
    got = [u_l2_error(solve_ns(4, dt, T, scheme), T) for dt in (0.1, 0.05)]
    want = [jt.u_l2_error(jt.solve_ns(4, dt, T, scheme), T) for dt in (0.1, 0.05)]
    _close(got, want)
    assert got[1] < got[0]


# ---- slow: the JAX package's bounds ----------------------------------------


@pytest.mark.slow
def test_taylor_hood_convergence_orders():
    errors = [l2_errors(solve_on(n)) for n in (4, 8, 16)]
    eu = [e[0] for e in errors]
    ep = [e[1] for e in errors]
    rate_u = np.log2(eu[0] / eu[1]), np.log2(eu[1] / eu[2])
    rate_p = np.log2(ep[0] / ep[1]), np.log2(ep[1] / ep[2])
    print(f"P2/P1 errors u {eu} p {ep}; rates u {rate_u} p {rate_p}")
    assert rate_u[1] > 2.6, (eu, rate_u)
    assert rate_p[1] > 1.6, (ep, rate_p)
    assert eu[-1] < 2e-3 and ep[-1] < 2e-2


@pytest.mark.slow
def test_p3_p2_convergence_orders():
    errors = [l2_errors(solve_on(n, deg_v=3, deg_p=2)) for n in (2, 4, 8)]
    eu = [e[0] for e in errors]
    ep = [e[1] for e in errors]
    rate_u = np.log2(eu[1] / eu[2])
    rate_p = np.log2(ep[1] / ep[2])
    print(f"P3/P2 errors u {eu} p {ep}; rates u {rate_u} p {rate_p}")
    assert rate_u > 3.5, (eu, rate_u)
    assert rate_p > 2.5, (ep, rate_p)
    assert eu[-1] < 5e-4 and ep[-1] < 5e-3


def _difference_rate(scheme):
    T = 0.4
    sols = {dt: _solution(solve_ns(8, dt, T, scheme)) for dt in (0.1, 0.05, 0.025)}
    d1 = np.linalg.norm(sols[0.1] - sols[0.05])
    d2 = np.linalg.norm(sols[0.05] - sols[0.025])
    print(f"{scheme}: differences {d1} {d2}, rate {np.log2(d1 / d2)}")
    return d1, d2, np.log2(d1 / d2)


@pytest.mark.slow
def test_implicit_euler_temporal_order():
    d1, d2, rate = _difference_rate("bdf1")
    assert 0.7 < rate < 1.4, (d1, d2, rate)


@pytest.mark.slow
def test_bdf2_temporal_order():
    d1, d2, rate = _difference_rate("bdf2")
    assert 1.6 < rate < 2.6, (d1, d2, rate)


@pytest.mark.slow
def test_bdf2_beats_bdf1_accuracy():
    T = 0.4
    ref = _solution(solve_ns(8, 0.00625, T, scheme="bdf2"))
    e1 = np.linalg.norm(_solution(solve_ns(8, 0.05, T, scheme="bdf1")) - ref)
    e2 = np.linalg.norm(_solution(solve_ns(8, 0.05, T, scheme="bdf2")) - ref)
    print(f"errors against dt 0.00625: bdf1 {e1}, bdf2 {e2}")
    assert e2 < 0.25 * e1, (e1, e2)


@pytest.mark.slow
def test_ns_accuracy_vs_exact():
    T = 0.2
    s = solve_ns(12, 0.0125, T)
    err = u_l2_error(s, T)
    print(f"L2 error against the exact solution {err}")
    assert err < 5e-3, err
    fails = [r for r in s.log.records if r.get("event") == "krylov_failure"]
    assert not fails
