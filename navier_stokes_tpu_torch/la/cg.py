"""Preconditioned conjugate gradients.

Port of ``navier_stokes_tpu/la/cg.py`` with the same masking: a breakdown
(pAp not finite or <= 0) freezes the state and ends the loop, and an
iteration runs only while ||r|| > atol, ||r|| is finite and k < maxiter.

With ``atol=0`` (the fixed-length sweeps of the Cahouet-Chabard
preconditioner) the loop runs ``maxiter`` masked iterations and never reads
the device from the host; with ``atol > 0`` it reads the stop flag once per
iteration and leaves the loop early.  With a process group every dot is
all-reduced (la/operators.py ``vdot``), so every rank steps alike.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from .operators import vdot as _vdot

__all__ = ["CgResult", "cg"]


class CgResult(NamedTuple):
    x: torch.Tensor
    iters: torch.Tensor
    residual: torch.Tensor
    converged: torch.Tensor


def cg(
    matvec: Callable,
    b: torch.Tensor,
    x0: torch.Tensor | None = None,
    *,
    atol: float,
    maxiter: int = 2000,
    precond: Callable | None = None,
    group=None,
) -> CgResult:
    """Solve an SPD system to the ABSOLUTE tolerance ||b - A x|| <= atol
    (group: the process group of a sharded run)."""
    M = precond or (lambda v: v)

    def vdot(a, c):
        return _vdot(a, c, group)

    if x0 is None:
        # linear operator: r(0) = b exactly, no A@0 matvec
        x, r = torch.zeros_like(b), b
    else:
        x, r = x0, b - matvec(x0)
    z = M(r)
    p = z
    rz = vdot(r, z)
    k = torch.zeros((), dtype=torch.int32, device=b.device)
    atol_t = torch.as_tensor(atol, dtype=b.dtype, device=b.device)
    sync_free = float(atol) == 0.0

    for _ in range(maxiter):
        nrm = torch.sqrt(vdot(r, r))
        active = (nrm > atol_t) & torch.isfinite(nrm) & (k < maxiter)
        if not sync_free and not bool(active):
            break
        Ap = matvec(p)
        pAp = vdot(p, Ap)
        # breakdown: freeze the state and leave the loop
        ok = torch.isfinite(pAp) & (pAp > 0)
        alpha = torch.where(ok, rz / torch.where(ok, pAp, torch.ones_like(pAp)), 0.0)
        x_n = torch.where(ok, x + alpha * p, x)
        r_n = torch.where(ok, r - alpha * Ap, r)
        z_n = M(r_n)
        rz_new = vdot(r_n, z_n)
        nz = rz != 0
        beta = torch.where(ok & nz, rz_new / torch.where(nz, rz, torch.ones_like(rz)), 0.0)
        p_n = torch.where(ok, z_n + beta * p, p)
        k_n = torch.where(ok, k + 1, torch.full_like(k, maxiter))
        # masked update: an inactive iteration leaves the state as it was
        x = torch.where(active, x_n, x)
        r = torch.where(active, r_n, r)
        p = torch.where(active, p_n, p)
        rz = torch.where(active, rz_new, rz)
        k = torch.where(active, k_n, k)
    res = torch.sqrt(vdot(r, r))
    return CgResult(x=x, iters=k, residual=res, converged=res <= atol_t)
