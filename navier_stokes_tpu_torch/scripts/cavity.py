"""The lid-driven cavity (Ghia, Ghia & Shin 1982, Re 100): configuration and
checks, the port's counterpart of ``examples/lid_cavity.py``.

Enclosed flow on [0, 1]^2: the lid (tag 3 of ``rectangle``) moves with
u = (1, 0), the other three sides (tags 0, 1, 2) are no-slip walls, and
there is no Neumann boundary, so the pressure is defined up to a constant.
``chip_smoke.py`` runs it at n = 128 (32,768 cells) steady
(``solve_steady``) and in time (``solve_scanned``, BDF2).  The reference
values are Ghia et al.'s Table I (u on the vertical centreline x = 0.5) and
Table II (v on the horizontal centreline y = 0.5) from their 129 x 129
grid.
"""

from __future__ import annotations

import numpy as np

__all__ = ["GHIA_RE100_U", "GHIA_RE100_V", "lid", "cavity_config", "ghia_errors"]

GHIA_RE100_U = [  # (y, u) at x = 0.5
    (1.0000, 1.00000), (0.9766, 0.84123), (0.9688, 0.78871),
    (0.9609, 0.73722), (0.9531, 0.68717), (0.8516, 0.23151),
    (0.7344, 0.00332), (0.6172, -0.13641), (0.5000, -0.20581),
    (0.4531, -0.21090), (0.2813, -0.15662), (0.1719, -0.10150),
    (0.1016, -0.06434), (0.0703, -0.04775), (0.0625, -0.04192),
    (0.0547, -0.03717), (0.0000, 0.00000),
]
GHIA_RE100_V = [  # (x, v) at y = 0.5
    (1.0000, 0.00000), (0.9688, -0.05906), (0.9609, -0.07391),
    (0.9531, -0.08864), (0.9453, -0.10313), (0.9063, -0.16914),
    (0.8594, -0.22445), (0.8047, -0.24533), (0.5000, 0.05454),
    (0.2344, 0.17527), (0.2266, 0.17507), (0.1563, 0.16077),
    (0.0938, 0.12317), (0.0781, 0.10890), (0.0703, 0.10091),
    (0.0625, 0.09233), (0.0000, 0.00000),
]


def lid(x, t=0.0):
    """Unit lid velocity; the walls' zero wins where they meet the lid."""
    v = np.zeros_like(x)
    v[:, 0] = 1.0
    return v


RE, DT = 100.0, 0.05  # Ghia et al.'s Re 100 (the tables above); the example's step


def cavity_config(dtype="float32", T=12.0):
    """The cavity at Re 100: ``examples/lid_cavity.py``'s formulation (BDF2
    at dt 0.05, the corrected convection form with the continuity residual,
    windowed operator with Cahouet-Chabard, tangent solves to 1e-4, Newton
    to 1e-6 with one forced sweep) with a stronger tangent solve.

    The example's solve (4 FGMRES or CG iterations of Jacobi plus the
    additive coarse correction per A00 apply, FGMRES(60), at most 300
    iterations) suits its n = 32: on an H100 no steady tangent solve at n =
    128 or 256 reached 1e-4 in 1,500 iterations, and no BDF2 one at n = 256
    in 300.  Here each A00 apply takes 16 iterations of the two-level
    V-cycle, the outer solve FGMRES(200) with at most 1,500 iterations
    (PERF.md gives the counts this reaches)."""
    from ..config import SolverConfig

    cfg = SolverConfig(T=T, dt=DT, nu=1.0 / RE, rho=1.0, p_out=0.0,
                       inlet_tags=(3,), wall_tags=(0, 1, 2), neumann_tags=())
    cfg.dtype = dtype
    cfg.convection_form = "standard"
    cfg.include_continuity_residual = True
    cfg.jacobian_mass_rho = True
    cfg.time_scheme = "bdf2"
    cfg.krylov.matvec = "windowed"
    cfg.krylov.preconditioner = "cahouet_chabard"
    cfg.krylov.cc_iters_a00, cfg.krylov.cc_cycle_a00 = 16, "vcycle"
    cfg.krylov.rel_tol = 1e-4
    cfg.krylov.restart, cfg.krylov.max_iters = 200, 1500
    cfg.newton.tol = 1e-6
    cfg.newton.min_iters = 1
    cfg.newton.max_iters = 6
    return cfg


def centerline(coords, values, axis):
    """(positions, values) of a P2 nodal field on the line x = 0.5 (axis 0)
    or y = 0.5 (axis 1); even n puts nodes exactly on it."""
    on = np.isclose(coords[:, axis], 0.5, atol=1e-9)
    order = np.argsort(coords[on, 1 - axis])
    return coords[on][order, 1 - axis], values[on][order]


def ghia_errors(solver) -> tuple[float, float]:
    """Largest |u - u_Ghia| on the vertical centreline and |v - v_Ghia| on
    the horizontal one, the solution interpolated linearly between nodes to
    Ghia's points."""
    vc = solver.velocity_coords(real_only=True)
    vv = np.asarray(solver.velocity(real_only=True), np.float64)
    y_u, u_c = centerline(vc, vv[:, 0], axis=0)
    x_v, v_c = centerline(vc, vv[:, 1], axis=1)
    ref_u, ref_v = np.array(GHIA_RE100_U), np.array(GHIA_RE100_V)
    err_u = np.abs(np.interp(ref_u[:, 0], y_u, u_c) - ref_u[:, 1]).max()
    err_v = np.abs(np.interp(ref_v[:, 0], x_v, v_c) - ref_v[:, 1]).max()
    return float(err_u), float(err_v)
