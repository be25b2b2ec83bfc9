"""Flow functionals: boundary forces (Cd/Cl), Strouhal number, divergence norms.

Port of ``navier_stokes_tpu/models/functionals.py``.  Force on a boundary =
integral of sigma . n with the gradient-form stress sigma = -p I + nu rho
grad u, consistent with the reference's weak form ((nu rho grad u, grad v),
cpp:254-257).  The evaluators run on the device of the solution they are
given.
"""

from __future__ import annotations

import numpy as np
import torch

from ..fem.dofs import TaylorHoodDofs
from ..fem.geometry import facet_geometry

__all__ = ["BoundaryForce", "BoundaryReaction", "strouhal_number", "divergence_l2"]


class BoundaryReaction:
    """Superconvergent boundary force via the reaction functional.

    The force exerted BY the fluid ON a Dirichlet boundary equals the
    UNCONSTRAINED weak residual summed over that boundary's velocity dofs
    (see the original for the accuracy and the caveat on boundaries that
    touch other boundary types).  For unsteady runs pass (u, u_old, dt) so
    the reaction includes the inertial term; force(u) evaluates it steady.
    """

    def __init__(self, solver, tags):
        from ..fem.assembly import assemble_navier_stokes

        dofs = solver.dofs
        sdofs = dofs.boundary_scalar_vdofs(list(np.atleast_1d(tags)))
        if len(sdofs) == 0:
            raise ValueError(f"no boundary velocity dofs with tags {tags}")
        dim = dofs.dim
        ctx = solver.ctx
        self.idx = torch.as_tensor(
            sdofs[None, :] + np.arange(dim)[:, None] * dofs.n_vs, dtype=torch.int64,
            device=ctx.jxw.device,
        )  # [dim, m]
        cfg = solver.cfg
        kw = dict(
            nu=cfg.nu, rho=cfg.rho, p_out=cfg.p_out,
            convection_form=cfg.convection_form,
            include_continuity_residual=cfg.include_continuity_residual,
            jacobian_mass_rho=cfg.jacobian_mass_rho,
        )

        def _force(u, u_old, dt):
            # framework residual = -R_weak (the Newton RHS, cpp:287-310), so
            # force BY fluid ON boundary = +sum of residual rows (reaction)
            _, _, r = assemble_navier_stokes(ctx, u, u_old, dt=dt, **kw)
            return torch.stack([r[self.idx[d]].sum() for d in range(dim)])

        self._eval = _force
        self._dt = cfg.dt
        self.rho = cfg.rho

    def force(self, u, u_old=None, dt=None) -> np.ndarray:
        uo = u if u_old is None else u_old
        return self._eval(u, uo, self._dt if dt is None else dt).cpu().numpy()

    def coefficients(self, u, u_mean, length, u_old=None, dt=None):
        f = self.force(u, u_old, dt)
        scale = 2.0 / (self.rho * u_mean**2 * length)
        return float(f[0] * scale), float(f[1] * scale)


class BoundaryForce:
    """Precomputed evaluator for the traction integral over one boundary tag
    group (e.g. the cylinder, tag 13)."""

    def __init__(self, dofs: TaylorHoodDofs, tags, nu: float, rho: float, degree: int = 5):
        from ..fem.geometry import cell_geometry
        from ..fem.quadrature import gauss_simplex

        mesh = dofs.mesh
        fids = np.nonzero(np.isin(mesh.boundary_tags, np.atleast_1d(tags)))[0]
        if len(fids) == 0:
            raise ValueError(f"no boundary facets with tags {tags}")
        fg = facet_geometry(mesh, fids, degree)
        elem = dofs.element
        dim = mesh.dim
        vals, grads = elem.velocity.tabulate(fg.ref_qpts.reshape(-1, dim))
        nqf = fg.jxw.shape[1]
        nf = len(fids)
        pvals, _ = elem.pressure.tabulate(fg.ref_qpts.reshape(-1, dim))

        self.dofs = dofs
        self.nu, self.rho = nu, rho
        self.dim = dim
        f64 = lambda a: torch.as_tensor(np.asarray(a, np.float64))  # noqa: E731
        # [nf, nb, nqf] / [nf, nb, nqf, dim]
        self.N_v = f64(vals.reshape(elem.n_v, nf, nqf).transpose(1, 0, 2))
        self.G_ref = f64(grads.reshape(elem.n_v, nf, nqf, dim).transpose(1, 0, 2, 3))
        self.N_p = f64(pvals.reshape(elem.n_p, nf, nqf).transpose(1, 0, 2))
        self.normal = f64(fg.normal)
        self.jxw = f64(fg.jxw)
        self.cell_vdofs = torch.as_tensor(dofs.cell_vdofs[fg.cell], dtype=torch.int64)
        self.cell_pdofs = torch.as_tensor(dofs.cell_pdofs[fg.cell], dtype=torch.int64)
        # owning-cell inverse Jacobians for physical gradients
        geo = cell_geometry(mesh, gauss_simplex(dim, 1))
        self.invJT = f64(geo.invJT[fg.cell])

    def _force(self, solution: torch.Tensor) -> torch.Tensor:
        dim = self.dim
        n_vs, n_u = self.dofs.n_vs, self.dofs.n_u
        dev, dt = solution.device, solution.dtype
        to = lambda t: t.to(device=dev, dtype=dt)  # noqa: E731
        comp = torch.arange(dim, device=dev)[None, :, None] * n_vs
        uc = solution[self.cell_vdofs.to(dev)[:, None, :] + comp]  # [nf, dim, nb_v]
        pc = solution[n_u + self.cell_pdofs.to(dev)]  # [nf, nb_p]
        # physical gradients of basis at face qpts: [nf, nb, q, d]
        Gp = torch.einsum("fda,fbqa->fbqd", to(self.invJT), to(self.G_ref))
        gradu = torch.einsum("fcb,fbqd->fqcd", uc, Gp)  # du_c/dx_d at face qpts
        p_q = torch.einsum("fb,fbq->fq", pc, to(self.N_p))
        normal = to(self.normal)
        # traction on the fluid; the force BY the fluid ON the boundary is
        # its negative (DFG convention)
        tr = -p_q[:, :, None] * normal[:, None, :] + (self.nu * self.rho) * torch.einsum(
            "fqcd,fd->fqc", gradu, normal
        )
        return -torch.einsum("fqc,fq->c", tr, to(self.jxw))

    def force(self, solution) -> np.ndarray:
        """Total force vector exerted BY the fluid ON the boundary (DFG sign:
        drag of forward flow on an obstacle is positive)."""
        if not isinstance(solution, torch.Tensor):
            solution = torch.as_tensor(np.asarray(solution))
        return self._force(solution).cpu().numpy()

    def coefficients(self, solution, u_mean: float, length: float) -> tuple[float, float]:
        """(Cd, Cl) with the DFG normalization 2 F / (rho u_mean^2 L)."""
        f = self.force(solution)
        scale = 2.0 / (self.rho * u_mean**2 * length)
        return float(f[0] * scale), float(f[1] * scale)


def strouhal_number(lift_series, dt: float, D: float, U: float) -> float:
    """Dominant shedding frequency from the lift time series: St = f D / U,
    the FFT peak refined by quadratic interpolation of the windowed
    log-magnitude spectrum (numpy, copied from the original)."""
    y = np.asarray(lift_series, dtype=np.float64)
    y = y - y.mean()
    if len(y) < 8 or np.allclose(y, 0):
        return 0.0
    spec = np.abs(np.fft.rfft(y * np.hanning(len(y))))
    freqs = np.fft.rfftfreq(len(y), d=dt)
    k = int(np.argmax(spec[1:]) + 1)
    f = freqs[k]
    if 1 <= k < len(spec) - 1 and spec[k - 1] > 0 and spec[k + 1] > 0:
        la, lb, lc = np.log(spec[k - 1]), np.log(spec[k]), np.log(spec[k + 1])
        den = la - 2.0 * lb + lc
        if den < 0:  # genuine local max
            f = (k + 0.5 * (la - lc) / den) * (freqs[1] - freqs[0])
    return float(f * D / U)


def divergence_l2(ctx, solution: torch.Tensor) -> float:
    """|| div u ||_L2 over the mesh — the quantity whose residual the
    reference never assembles; useful as a diagnostic."""
    from ..fem.assembly import _gather_velocity, _phys_grads

    uc = _gather_velocity(ctx, solution)
    Gp = _phys_grads(ctx)
    gu = torch.einsum("cdb,cbqa->cqda", uc, Gp)
    div = torch.einsum("cqdd->cq", gu)
    return float(torch.sqrt(torch.sum(div**2 * ctx.jxw)))
