"""The port's CG and FGMRES against JAX's, on the windowed operators, in f64.

Same tangent (assembled at a seeded state on the same mesh by both
packages), same right-hand side: the iteration counts and converged flags
must be equal, and the solutions agree to 1e-9 of their size.  Cases cover
restarts (a short window), the Cahouet-Chabard preconditioner, the CC
preconditioner's fixed-length CG sweeps (atol=0), and a maxiter cap.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from navier_stokes_tpu.la.cg import cg as j_cg
from navier_stokes_tpu.la.gmres import fgmres as j_fgmres
from navier_stokes_tpu.ops import windowed as jw
from navier_stokes_tpu_torch.la.cg import cg as t_cg
from navier_stokes_tpu_torch.la.gmres import fgmres as t_fgmres
from navier_stokes_tpu_torch.ops import windowed as tw

import test_torch_solver as ts_mod


@functools.lru_cache(maxsize=None)
def _ops():
    """(jax side, port side) of: the Dirichlet-row tangent operator, the CC
    preconditioner, the pinned pressure Laplacian, a residual vector."""
    from navier_stokes_tpu.fem.windowed_assembly import assemble_windowed as j_asm
    from navier_stokes_tpu_torch.fem.windowed_assembly import assemble_windowed as t_asm

    js, ts, _, _ = ts_mod._runs("bdf1")
    n = ts.dofs.n_total
    u = 0.05 * np.random.default_rng(7).standard_normal(n)
    kw = dict(dt=0.05, nu=ts.cfg.nu, rho=ts.cfg.rho)
    sides = []
    for s, asm, xp, to in (
        (js, j_asm, jnp, jnp.asarray),
        (ts, t_asm, torch, torch.as_tensor),
    ):
        A_t, res, diag0 = asm(s._wassembly, s._win_layout, to(u), to(0 * u), **kw)
        rows = np.asarray(s.dirichlet.rows)
        bc_diag = np.asarray(diag0)[rows]
        res = np.asarray(res).copy()
        res[rows] = 0.0
        lay, wa = s._win_layout, s._wassembly
        mv = jw.windowed_matvec if xp is jnp else tw.windowed_matvec

        def op(v, lay=lay, A_t=A_t, mv=mv, rows=rows, bc_diag=bc_diag, xp=xp, to=to):
            y = mv(lay, A_t, v)
            if xp is jnp:
                return y.at[rows].set(to(bc_diag) * v[rows])
            y[rows] = to(bc_diag) * v[rows]
            return y

        args = (lay, A_t, wa, to(bc_diag), diag0, to(rows))
        if xp is torch:
            pc = s._make_windowed_preconditioner(*args)
            kp = lambda p, lay=lay, K=wa.Kp_t: tw.windowed_matvec_block(
                lay, K, p, in_spaces="p", out_spaces="p")
        else:
            pc = s._make_windowed_preconditioner(*args[:-1], jnp.asarray(rows, jnp.int32))
            kp = lambda p, lay=lay, K=wa.Kp_t: jw.windowed_matvec_block(
                lay, K, p, in_spaces="p", out_spaces="p")
        sides.append(dict(op=op, pc=pc, kp=kp, b=to(res), diag_kp=wa.diag_kp,
                          n_u=s.dofs.n_u, p_mask=s.dofs.p_mask))
    return sides


@pytest.mark.parametrize(
    "precond, restart, maxiter, rel",
    [
        (False, 60, 400, 1e-6),  # identity, one long cycle
        (False, 7, 400, 1e-6),  # restarts every 7 iterations
        (True, 60, 400, 1e-8),  # Cahouet-Chabard, tight
        (True, 4, 400, 1e-6),  # Cahouet-Chabard with restarts
        (False, 7, 12, 1e-10),  # capped: not converged
    ],
)
def test_fgmres_matches_jax(precond, restart, maxiter, rel):
    j, t = _ops()
    bn = float(np.linalg.norm(np.asarray(j["b"])))
    jr = j_fgmres(j["op"], j["b"], atol=rel * bn, restart=restart, maxiter=maxiter,
                  precond=j["pc"] if precond else None)
    tr = t_fgmres(t["op"], t["b"], atol=rel * bn, restart=restart, maxiter=maxiter,
                  precond=t["pc"] if precond else None)
    assert (int(jr.iters), bool(jr.converged)) == (tr.iters, tr.converged)
    assert abs(float(jr.residual) - tr.residual) <= 1e-6 * float(jr.residual)
    jx = np.asarray(jr.x)
    np.testing.assert_allclose(tr.x.numpy(), jx, rtol=0, atol=1e-9 * np.abs(jx).max())


def test_fgmres_with_x0_and_zero_rhs():
    j, t = _ops()
    x0 = np.random.default_rng(1).standard_normal(np.asarray(j["b"]).shape[0])
    jr = j_fgmres(j["op"], j["b"], jnp.asarray(x0), atol=1e-6, restart=10, maxiter=300)
    tr = t_fgmres(t["op"], t["b"], torch.as_tensor(x0), atol=1e-6, restart=10, maxiter=300)
    assert (int(jr.iters), bool(jr.converged)) == (tr.iters, tr.converged)
    z = t_fgmres(t["op"], torch.zeros_like(t["b"]), atol=0.0, restart=5, maxiter=5)
    assert z.iters == 0 and z.converged and not z.x.any()


@pytest.mark.parametrize("atol, maxiter", [(1e-8, 500), (0.0, 6), (1e-3, 3)])
def test_cg_matches_jax(atol, maxiter):
    """CG on the pinned pressure Laplacian with Jacobi: counts, flags and x."""
    j, t = _ops()
    n_u = t["n_u"]
    # a pressure right-hand side off the padding holes (zero rows of Kp)
    bp = (np.asarray(j["b"])[n_u:] + 0.1) * t["p_mask"]
    jdk, tdk = np.asarray(j["diag_kp"]), t["diag_kp"]
    jr = j_cg(j["kp"], jnp.asarray(bp), atol=atol, maxiter=maxiter,
              precond=lambda r: r / jnp.asarray(jdk))
    tr = t_cg(t["kp"], torch.as_tensor(bp), atol=atol, maxiter=maxiter,
              precond=lambda r: r / tdk)
    assert int(jr.iters) == int(tr.iters)
    assert bool(jr.converged) == bool(tr.converged)
    jx = np.asarray(jr.x)
    np.testing.assert_allclose(tr.x.numpy(), jx, rtol=0, atol=1e-10 * np.abs(jx).max())
