"""Restarted flexible GMRES (right preconditioning), CGS2 orthogonalization.

Port of ``navier_stokes_tpu/la/gmres.py``: the same Arnoldi recurrence,
breakdown guards, early exit, and true-residual restarts (each cycle ends by
computing b - A x and keeps the better iterate; no headway ends the solve).
The basis lives on the device; the small Hessenberg column, the Givens
rotations and the least-squares solve live on the host in the working
precision.  Each Arnoldi step therefore reads the device once: the new
column of H (its projections, ||w|| and ||A z||), from which the host
decides acceptance and convergence.  The original's tile loop over the
filled prefix of V is plain ``V[:k+1]`` slicing here.

With a process group (a sharded run: every vector is the rank's owned
chunk), the projections and norms are all-reduced before the host reads
them, so every rank builds the same Hessenberg column and takes the same
decisions (the original's ``axis_name`` psums).

``deflate`` is the original's GCRO-style augmentation: fixed directions
enter every restart cycle as its first flexible (Z) slots, bypassing the
preconditioner, each scaled to a unit image; a slot whose image is already
spanned is skipped, and the first regular step chains from the residual
direction V[0].
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch
from scipy.linalg import solve_triangular

from .operators import all_reduce, vnorm

__all__ = ["GmresResult", "fgmres"]


class GmresResult(NamedTuple):
    x: torch.Tensor
    iters: int  # accepted Arnoldi iterations
    residual: float  # final residual norm
    converged: bool


def _np_dtype(dtype: torch.dtype):
    return np.float64 if dtype == torch.float64 else np.float32


def fgmres(
    matvec: Callable,
    b: torch.Tensor,
    x0: torch.Tensor | None = None,
    *,
    atol: float,
    restart: int = 60,
    maxiter: int = 1000,
    precond: Callable | None = None,
    deflate: torch.Tensor | None = None,
    group=None,
) -> GmresResult:
    """Right-preconditioned flexible GMRES; stops at ||r||_2 <= atol.

    A solve converging at k iterations costs k + ceil(k/restart) matvecs
    (+1 when x0 is given) and k preconditioner applications.  group: the
    process group of a sharded run (dots and norms over every rank).

    deflate: optional [k_d, n] fixed solution-space directions (the rank's
    chunk of each on a sharded run), cast to b's dtype and device, forced
    into every cycle as its first k_d Z slots; rows should be ~unit.
    ``iters`` counts the accepted positions of each cycle, accepted
    deflation slots included, as the original does."""
    n = b.shape[0]
    m = restart
    M = precond or (lambda v: v)
    D = None if deflate is None else deflate.to(device=b.device, dtype=b.dtype)
    k_d = 0 if D is None else D.shape[0]
    if k_d >= restart:
        raise ValueError(f"deflation space ({k_d} rows) must be smaller than the restart "
                         f"window ({restart})")
    f = _np_dtype(b.dtype)
    atol = f(atol)
    eps_break = f(1e-30 if f is np.float64 else 1e-18)
    eps_rel = f(1e-12 if f is np.float64 else 1e-6)
    V = torch.empty((m + 1, n), dtype=b.dtype, device=b.device)
    Z = torch.empty((m, n), dtype=b.dtype, device=b.device)

    def norm(v):
        return vnorm(v, group)

    def cycle(x, r, prev_res):
        beta_d = norm(r)
        beta = f(beta_d.item())
        done = bool(beta <= atol)
        V[0] = torch.zeros_like(r) if done else r / beta_d
        g = np.zeros(m + 1, f)
        g[0] = beta
        cs = np.ones(m, f)
        sn = np.zeros(m, f)
        R = np.eye(m, dtype=f)  # unused columns stay identity
        k = jd = nreg = t = 0  # accepted positions, deflation slots, regular steps, trips
        while k < m and t < m + k_d and not done:
            j = k
            t += 1
            use_defl = jd < k_d
            if use_defl:  # an augmentation slot: the fixed direction bypasses M
                z = D[jd]
                jd += 1
            else:
                # the first regular step chains from the residual direction
                # V[0], not from a deflation slot's image
                z = M(V[k if nreg else 0])
            w = matvec(z)
            w0n = norm(w)  # pre-orthogonalization magnitude
            if use_defl:
                # unit image: a near-null direction's tiny ||A d|| would put
                # a tiny diagonal into R; scaling (z, w) keeps the H column
                # O(1) and leaves the least-squares solution unchanged
                s = torch.where(w0n > eps_break, 1.0 / w0n, torch.ones_like(w0n))
                z, w, w0n = z * s, w * s, w0n * s
            # CGS2 against the filled prefix V[0..k]
            Vk = V[: k + 1]
            h1 = all_reduce(Vk @ w, group)
            w = w - h1 @ Vk
            h2 = all_reduce(Vk @ w, group)
            w = w - h2 @ Vk
            # the one device read of the step: H column, ||w||, ||A z||
            hv = torch.cat([h1 + h2, torch.stack([norm(w), w0n])]).cpu().numpy()
            hw, w0n = hv[k + 1], hv[k + 2]
            h = np.zeros(m + 1, f)
            h[: k + 1] = hv[: k + 1]
            hw_ok = bool(hw > max(eps_rel * w0n, eps_break))
            h[j + 1] = hw
            for i in range(j):  # previous rotations
                hi, hi1 = h[i], h[i + 1]
                h[i] = cs[i] * hi + sn[i] * hi1
                h[i + 1] = -sn[i] * hi + cs[i] * hi1
            denom = f(np.sqrt(h[j] ** 2 + h[j + 1] ** 2))
            safe = denom > eps_break
            c_new = h[j] / denom if safe else f(1.0)
            s_new = h[j + 1] / denom if safe else f(0.0)
            h[j], h[j + 1] = denom, 0.0
            g_new = g.copy()
            g_new[j + 1] = -s_new * g[j]
            g_new[j] = c_new * g[j]
            apply_it = bool(np.isfinite(hw) and hw_ok and np.all(np.isfinite(h)))
            if apply_it:
                V[j + 1] = w * (1.0 / float(hw))
                Z[j] = z
                R[:, j] = h[:m]
                g, cs[j], sn[j] = g_new, c_new, s_new
                k += 1
                nreg += not use_defl
                done = bool(abs(g[j + 1]) <= atol)
            elif not use_defl:
                done = True  # breakdown: end the cycle on the accepted prefix
            # a deflation slot whose image is already spanned is skipped
        # solve R y = g on the accepted prefix
        y = solve_triangular(R[:k, :k], g[:k], lower=False) if k else np.zeros(0, f)
        x_new = x + torch.as_tensor(y.astype(f), device=b.device) @ Z[:k] if k else x
        r_new = b - matvec(x_new)
        res_true = f(norm(r_new).item())
        better = bool(res_true < prev_res)
        if better:
            x, r = x_new, r_new
        return x, r, min(res_true, prev_res), k, (k == 0 or not better)

    if x0 is None:
        x, r = torch.zeros_like(b), b  # linear operator: r(0) = b exactly
    else:
        x, r = x0, b - matvec(x0)
    res = f(norm(r).item())
    iters, stalled = 0, bool(res <= atol)
    while res > atol and np.isfinite(res) and iters < maxiter and not stalled:
        x, r, res, k, stalled = cycle(x, r, res)
        iters += k
    return GmresResult(x=x, iters=iters, residual=float(res), converged=bool(res <= atol))
