"""Blocked (windowed) Navier-Stokes assembly: cells last, zero flat gathers.

Port of ``navier_stokes_tpu/fem/windowed_assembly.py``.  The precompute
(``build_windowed_assembly``: constant tangent terms, lumped pressure mass,
pressure Laplacian, coarse spaces, and the pinning probe behind
``cc_coarse_agg=-1`` and the outer-FGMRES deflation modes ``kp_deflate``) is
the original's numpy/scipy code, copied; it returns a ``WindowedAssembly`` of
tensors.  ``assemble_windowed`` is torch einsums on the windowed gather (K3)
and scatter (K4).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..ops.windowed import (
    WindowedLayout,
    windowed_gather,
    windowed_gather_pair,
    windowed_scatter,
)

__all__ = ["WindowedAssembly", "build_windowed_assembly", "assemble_windowed"]


@dataclass(frozen=True)
class WindowedAssembly:
    """Precomputed device tensors for blocked assembly (cells last).

    See the original for the meaning of each field: physical gradients are
    recontracted per cell from the replicated reference table ``G_v`` and the
    9-floats-per-cell ``invJT_t``."""

    N_v: torch.Tensor  # [k_v, nq]
    N_p: torch.Tensor  # [k_p, nq]
    NN: torch.Tensor  # [k_v, k_v, nq]  N_i N_j products
    G_v: torch.Tensor  # [k_v, nq, dim]  reference velocity-basis gradients
    invJT_t: torch.Tensor  # [dim, dim, ncd]
    W_t: torch.Tensor  # [nq, ncd] quadrature jxw
    A_const: torch.Tensor  # [nl, nli, ncd] u-independent tangent terms
    r_const: torch.Tensor  # [n_total] outlet traction + forcing
    inv_mp: torch.Tensor  # [n_ps] lumped inverse pressure mass
    Kp_t: torch.Tensor  # [k_p, roundup(k_p, 8), ncd] pressure Laplacian
    diag_kp: torch.Tensor  # [n_ps]
    dim: int
    # two-level coarse space of the Kp sweeps (None when disabled)
    agg_p: torch.Tensor | None = None  # [n_ps] int32, values in [0, m]
    coarse_inv: torch.Tensor | None = None  # [m, m]
    coarse_agg_size: int = 0
    # two-level coarse space of the A00 (velocity) sweeps
    agg_v: torch.Tensor | None = None  # [n_vs] int32, values in [0, m_v]
    coarse_inv_v: torch.Tensor | None = None  # [m_v, m_v]
    coarse_agg_size_v: int = 0
    # the outer FGMRES deflation rows (kp_deflate): each near-null mode w of
    # the pinned pressure Laplacian as (0, w), then its constant-A00
    # velocity response as (u_w / ||u_w||, 0); None when off
    kp_modes: torch.Tensor | None = None  # [k_d, n_total]


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


# ---- host precompute (copied from the original) ----------------------------


def _capped_spd_inverse(Kc: np.ndarray, cond_cap: float) -> np.ndarray:
    """Spectral-floored SPD inverse: eigenvalues floored at max_eig/cond_cap
    (retry with a diagonal shift if eigh fails; degenerate coarse spaces
    floor against a trace-scaled tiny positive value)."""
    m = Kc.shape[0]
    try:
        w, V = np.linalg.eigh(Kc)
    except np.linalg.LinAlgError:
        shift = 1e-8 * max(float(np.trace(Kc)) / max(m, 1), 1.0)
        w, V = np.linalg.eigh(Kc + shift * np.eye(m))
    tiny = 1e-12 * max(abs(float(np.trace(Kc))) / max(m, 1), 1.0)
    w_max = max(float(w[-1]), tiny)
    w = np.maximum(w, w_max / float(cond_cap))
    return (V / w) @ V.T


def _fit_agg_to_ow(s: int, OW: int) -> int:
    """Smallest multiple of 128 dividing OW that is >= s (OW qualifies)."""
    for d in range(1, OW // 128 + 1):
        c = d * 128
        if OW % c == 0 and c >= s:
            return c
    return OW


def _pin_cell_mats(M: np.ndarray, cell_dofs: np.ndarray, pinned: np.ndarray) -> np.ndarray:
    """Decouple pinned dofs in per-cell matrices: zero their off-diagonal
    rows/cols in every copy, keep each copy's own diagonal entry.

    M: [k, k, nv]; cell_dofs: [nv, k]; pinned: [n_dofs] bool."""
    k = M.shape[0]
    alive = ~pinned[cell_dofs]  # [nv, k]
    out = M.copy()
    diag_save = out[np.arange(k), np.arange(k), :].copy()
    out *= alive.T[:, None, :]
    out *= alive.T[None, :, :]
    out[np.arange(k), np.arange(k), :] = diag_save
    return out


def _coarse_space(
    cell_mats: np.ndarray,
    cell_dofs: np.ndarray,
    n_dofs: int,
    mask: np.ndarray | None,
    s_agg: int,
    cond_cap: float,
    shift_nullspace: bool = False,
) -> tuple[np.ndarray, np.ndarray]:
    """Aggregation coarse space: contiguous runs of ``s_agg`` dofs, Galerkin
    coarse matrix Kc = Zt A Z from the SAME (pinned) cell copies the windowed
    operator scatters, dense spectrally-capped inverse.

    Returns (agg [n_dofs] int64 in [0, m], coarse_inv [m, m])."""
    m = -(-n_dofs // s_agg)
    agg = np.arange(n_dofs, dtype=np.int64) // s_agg
    if mask is not None:
        agg = np.where(np.asarray(mask, bool), agg, m)
    a_cell = agg[np.asarray(cell_dofs, np.int64)]
    nv, k = a_cell.shape
    ii = np.broadcast_to(a_cell[:, :, None], (nv, k, k))
    jj = np.broadcast_to(a_cell[:, None, :], (nv, k, k))
    Kc = np.zeros((m + 1, m + 1))
    np.add.at(Kc, (ii.ravel(), jj.ravel()), cell_mats.transpose(2, 0, 1).ravel())
    Kc = Kc[:m, :m]
    d = np.diagonal(Kc).copy()
    Kc[np.arange(m), np.arange(m)] = np.where(d > 0, d, 1.0)  # all-hole aggs
    if shift_nullspace:
        # pure-Neumann operator: shift off the constant nullspace
        Kc[np.arange(m), np.arange(m)] += 1e-6 * (np.trace(Kc) / m)
    Kc = 0.5 * (Kc + Kc.T)
    return agg, _capped_spd_inverse(Kc, cond_cap)


def _kp_near_null_modes(
    Kp_cells: np.ndarray,
    cell_pdofs: np.ndarray,
    n_ps: int,
    p_mask,
    k_req: int,
    min_amp: float,
) -> tuple[np.ndarray, np.ndarray] | None:
    """Smallest eigenmodes of the assembled pinned pressure Laplacian with
    amplification ``median(diag)/lambda > min_amp`` (f64 shift-invert Lanczos
    on the host).  Returns ([k_kept, n_ps] unit rows, [k_kept] amplifications),
    k_kept possibly 0 (well pinned), or None when the probe itself failed."""
    try:
        import scipy.sparse as sp
        import scipy.sparse.linalg as spla

        k_p, _, nv = Kp_cells.shape
        cd = np.asarray(cell_pdofs, np.int64)
        ii = np.broadcast_to(cd[:, :, None], (nv, k_p, k_p))
        jj = np.broadcast_to(cd[:, None, :], (nv, k_p, k_p))
        A = sp.coo_matrix(
            (Kp_cells.transpose(2, 0, 1).ravel(), (ii.ravel(), jj.ravel())),
            shape=(n_ps, n_ps),
        ).tocsr()
        # decouple padding holes at the median diagonal scale
        d = np.asarray(A.diagonal())
        scale = float(np.median(d[d > 0])) if np.any(d > 0) else 1.0
        hole = d <= 0
        if p_mask is not None:
            hole |= ~np.asarray(p_mask, bool)
        if hole.any():
            A = A + sp.diags(np.where(hole, scale, 0.0))
        A = 0.5 * (A + A.T)
        k = min(int(k_req), n_ps - 2)
        w, V = spla.eigsh(A.tocsc(), k=k, sigma=0.0, which="LM")
        # keep only WEAKLY-pinned modes (an exact nullspace is handled by the
        # preconditioner's shift machinery)
        keep = (w < scale / float(min_amp)) & (w > scale * 1e-10)
        if not keep.any():
            return np.zeros((0, n_ps)), np.zeros(0)
        V, w = V[:, keep], w[keep]
        order = np.argsort(w)
        V, w = V[:, order], w[order]
        V = V / np.linalg.norm(V, axis=0, keepdims=True)
        # ARPACK's random start vector carries its seed over from call to
        # call within a process, so a mode's sign is the eigensolver's
        # choice: fix it (the first entry of at least half the largest
        # magnitude is positive), so that the rows, and the solves they
        # deflate, repeat from build to build and from process to process
        mag = np.abs(V)
        lead = np.argmax(mag >= 0.5 * mag.max(axis=0, keepdims=True), axis=0)
        V = V * np.sign(V[lead, np.arange(V.shape[1])])
        if p_mask is not None:
            V = V * np.asarray(p_mask, float)[:, None]
        return V.T, scale / w
    except Exception as e:  # scipy/convergence failures disable the coarse term
        import warnings

        warnings.warn(f"Kp pinning probe: eigsh failed ({e}); deflation and coarse space off")
        return None


def _kp_mode_velocity_responses(
    blk_v: np.ndarray,
    cvd: np.ndarray,
    D_valid: np.ndarray,
    modes: np.ndarray,
    cpd: np.ndarray,
    n_vs: int,
    v_mask,
) -> np.ndarray | None:
    """u_w = A00c^-1 (B^T w) for each near-null Kp mode w: the velocity half
    of the Schur pair (f64 host CG with a Jacobi preconditioner, once at
    set-up).  With (u_w, 0) beside (0, w) in the space, A applied to their
    difference is (0, -S w), near-null for a weakly pinned w, so the pair
    spans an approximate invariant subspace of the tangent; the raw mode
    alone does not.

    blk_v: [k_v, k_v, nv] pinned constant velocity block (per valid cell);
    D_valid: [dim, k_p, k_v, nv] divergence coupling on the same cells;
    modes: [k_m, n_ps].  Returns [k_m, dim, n_vs] responses, or None (with a
    warning) when a solve fails."""
    try:
        import scipy.sparse as sp
        import scipy.sparse.linalg as spla

        k_v = blk_v.shape[0]
        cd = np.asarray(cvd, np.int64)
        ii = np.broadcast_to(cd.T[:, None, :], (k_v, k_v, cd.shape[0]))
        jj = np.broadcast_to(cd.T[None, :, :], (k_v, k_v, cd.shape[0]))
        A = sp.coo_matrix(
            (blk_v.ravel(), (ii.ravel(), jj.ravel())), shape=(n_vs, n_vs)
        ).tocsr()
        d = np.asarray(A.diagonal())
        scale = float(np.median(d[d > 0])) if np.any(d > 0) else 1.0
        dead = d <= 0
        if v_mask is not None:
            dead |= ~np.asarray(v_mask, bool)
        if dead.any():
            A = A + sp.diags(np.where(dead, scale, 0.0))
        A = (0.5 * (A + A.T)).tocsr()
        dinv = 1.0 / np.asarray(A.diagonal())
        M = spla.LinearOperator(A.shape, matvec=lambda r: dinv * r)

        dim = D_valid.shape[0]
        out = np.zeros((modes.shape[0], dim, n_vs))
        for m_i, w in enumerate(modes):
            wc = w[np.asarray(cpd, np.int64)]  # [nv, k_p]
            for a in range(dim):
                # velocity-row image of (0, w): rows a of A_const carry -D
                r_cells = -np.einsum("pic,cp->ci", D_valid[a], wc)
                rhs = np.zeros(n_vs)
                np.add.at(rhs, cd.ravel(), r_cells.ravel())
                rhs[dead] = 0.0
                u, info = spla.cg(A, rhs, M=M, rtol=1e-10, maxiter=5000)
                if info != 0:
                    raise RuntimeError(f"A00 CG info={info}")
                out[m_i, a] = u
        return out
    except Exception as e:  # scipy/convergence failures drop the pairs
        import warnings

        warnings.warn(f"kp_deflate pairing: velocity response failed ({e})")
        return None


def compute_r_const(ctx, p_out, f_q=None) -> np.ndarray:
    """Solution-independent residual terms (outlet Neumann traction +
    forcing) in the ctx's numbering, float64 on the host."""
    from .assembly import _neumann_residual

    r = _np(_neumann_residual(ctx, p_out)).astype(np.float64)
    f_q = np.asarray(_np(ctx.f_q) if f_q is None else f_q, np.float64)
    if np.any(f_q):
        N_v = _np(ctx.N_v).astype(np.float64)
        NvW = np.einsum("iq,cq->ciq", N_v, _np(ctx.jxw).astype(np.float64))
        r_f = np.einsum("cqa,ciq->cai", f_q, NvW)
        nc = r_f.shape[0]
        flat = np.zeros(ctx.n_total)
        cd = _np(ctx.cell_dofs).astype(np.int64)[:, : ctx.dim * ctx.nb_v]
        np.add.at(flat, cd.ravel(), r_f.reshape(nc, -1).ravel())
        r = r + flat
    return r


def build_windowed_assembly(ctx, lay: WindowedLayout, dofs, *, dt, nu, rho, p_out,
                            jacobian_mass_rho=False, terms="navier_stokes",
                            pin_pdofs=None, coarse_agg=0, coarse_agg_v=0,
                            pin_vdofs=None, coarse_cond_cap=1e4,
                            kp_deflate=0, kp_deflate_min_amp=100.0,
                            store_dtype=None):
    """Precompute geometry + constant terms from a FEMContext (same blocked
    dofs as ``lay``); tensors go to the layout's device.

    terms: "navier_stokes" (mass/dt + viscous + divergence) or "stokes".
    pin_pdofs: pressure dofs where the Cahouet-Chabard Laplacian Kp is
    decoupled (outflow pinning).  coarse_agg / coarse_agg_v: aggregate run
    lengths of the Kp and A00 coarse spaces (0 disables, -1 = AUTO for Kp:
    on only if the f64 pinning probe finds the mesh well pinned).
    pin_vdofs: velocity dofs decoupled in the A00 coarse matrix.
    store_dtype: storage dtype of A_const (None = ctx dtype).
    kp_deflate: how many near-null Kp modes (amplification over
    kp_deflate_min_amp) become Schur-paired deflation rows ``kp_modes``; the
    probe runs in 2D with pinned Kp only, so 3D and enclosed domains get
    none.
    """
    dtype = ctx.jxw.dtype
    device = lay.device
    dim, k_v, k_p = ctx.dim, ctx.nb_v, ctx.nb_p
    nl = dim * k_v + k_p
    nli = lay.nli
    ids = _np(lay.cell_ids).reshape(-1).astype(np.int64)  # [ncd]
    ncd = len(ids)

    N_v = _np(ctx.N_v).astype(np.float64)  # [k_v, nq]
    G_v = _np(ctx.G_v).astype(np.float64)  # [k_v, nq, dim]
    N_p = _np(ctx.N_p).astype(np.float64)
    invJT = _np(ctx.invJT).astype(np.float64)[ids]  # [ncd, dim, dim]
    jxw_nat = _np(ctx.jxw).astype(np.float64)
    W_t = jxw_nat[ids].T  # [nq, ncd]
    NN = np.einsum("iq,jq->ijq", N_v, N_v)

    # pressure-basis reference gradients at a matching quadrature (P1
    # gradients are constant, so only the point count matters)
    from .quadrature import gauss_simplex

    nq = N_p.shape[1]
    for deg in range(1, 12):
        quad = gauss_simplex(dim, deg)
        if quad.n_points == nq:
            break
    else:
        raise ValueError(f"no simplex rule with {nq} points for Kp tabulation")
    _, G_p = dofs.element.pressure.tabulate(quad.points)  # [k_p, nq, dim]
    G_p = np.asarray(G_p, np.float64)

    # ---- constant tangent terms (A_t[j, i, c] = cell_mat[i, j]), in cell chunks
    if terms == "navier_stokes":
        mass_coef = (rho if jacobian_mass_rho else 1.0) / dt
    elif terms == "stokes":
        mass_coef = 0.0
    else:
        raise ValueError(terms)
    A_const = np.zeros((nl, nli, ncd))
    diag_blk = np.empty((k_v, k_v, ncd))  # constant velocity block
    D = np.empty((dim, k_p, k_v, ncd))  # divergence coupling
    Kp = np.empty((k_p, k_p, ncd))  # pressure Laplacian (CC Schur term)
    CHUNK = 1 << 16
    for lo in range(0, ncd, CHUNK):
        sl = slice(lo, min(lo + CHUNK, ncd))
        Gp = np.einsum("cda,bqa->bqdc", invJT[sl], G_v, optimize=True)
        Wc = W_t[:, sl]
        K_c = np.einsum("iqbc,jqbc,qc->ijc", Gp, Gp, Wc, optimize=True)
        if mass_coef:
            M_c = np.einsum("ijq,qc->ijc", NN, Wc, optimize=True)
            diag_blk[:, :, sl] = mass_coef * M_c + (nu * rho) * K_c
        else:
            diag_blk[:, :, sl] = (nu * rho) * K_c
        D[:, :, :, sl] = np.einsum("iqac,jq,qc->ajic", Gp, N_p, Wc,
                                   optimize=True)
        Gpp = np.einsum("cda,bqa->bqdc", invJT[sl], G_p, optimize=True)
        Kp[:, :, sl] = np.einsum("iqbc,jqbc,qc->ijc", Gpp, Gpp, Wc,
                                 optimize=True)
    for a in range(dim):
        sl = slice(a * k_v, (a + 1) * k_v)
        A_const[sl, sl, :] = diag_blk
        A_const[dim * k_v : nl, sl, :] = -D[a]  # B^T
        A_const[sl, dim * k_v : nl, :] = -D[a].transpose(1, 0, 2)  # B

    # ---- constant residual: Neumann traction + forcing -------------------
    r_const = compute_r_const(ctx, p_out)

    # ---- lumped inverse pressure mass (Mp = psi_i psi_j / nu) ------------
    mp_rows = np.einsum("iq,cq->ci", N_p, jxw_nat) / nu  # row sums per cell
    lumped = np.zeros(dofs.n_ps)
    cp = np.asarray(dofs.cell_dofs[:, -k_p:], np.int64) - dofs.n_u
    np.add.at(lumped, cp.ravel(), mp_rows.ravel())
    inv_mp = np.where(lumped > 0, 1.0 / np.where(lumped > 0, lumped, 1.0), 1.0)

    # ---- pressure Laplacian Kp and its assembled diagonal -----------------
    k_p8 = -(-k_p // 8) * 8
    Kp_t = np.zeros((k_p, k_p8, len(ids)))
    Kp_t[:, :k_p, :] = Kp
    diag_kp = np.zeros(dofs.n_ps)
    hi0 = _np(lay.loc_p_hi)[:, 0, :].reshape(-1)  # sentinel = RVp
    valid = hi0 < lay.RVp
    cpd = np.asarray(dofs.cell_pdofs, np.int64)[ids[valid]]
    np.add.at(diag_kp, cpd.ravel(), Kp[np.arange(k_p), np.arange(k_p)].T[valid].ravel())
    diag_kp = np.where(diag_kp > 0, diag_kp, 1.0)

    # outflow pinning: decouple pinned pressure dofs (diag_kp unchanged)
    if pin_pdofs is not None and len(pin_pdofs):
        pinned = np.zeros(dofs.n_ps, dtype=bool)
        pinned[np.asarray(pin_pdofs, np.int64)] = True
        alive = ~pinned[np.asarray(dofs.cell_pdofs, np.int64)[ids]]  # [ncd, k_p]
        diag_save = Kp_t[np.arange(k_p), np.arange(k_p), :].copy()
        Kp_t[:k_p] *= alive.T[:, None, :]
        Kp_t[:, :k_p] *= alive.T[None, :, :]
        Kp_t[np.arange(k_p), np.arange(k_p), :] = diag_save

    # ---- pinning probe: AUTO Kp coarse space and the deflation modes ------
    # one f64 eigsh of the pinned Kp serves both: the AUTO coarse term
    # (coarse_agg < 0) stays on only while the worst amplification is below
    # ~5e5 (the original's calibration), and kp_deflate's rows are its
    # weakly pinned modes; unpinned domains and 3D skip the probe
    AMP_COARSE_CUTOFF = 5e5
    pinned_kp = pin_pdofs is not None and len(pin_pdofs) > 0
    probe = None
    if pinned_kp and dim == 2 and (
        (kp_deflate and kp_deflate > 0) or (coarse_agg is not None and coarse_agg < 0)
    ):
        probe = _kp_near_null_modes(
            Kp_t[:, :k_p, :][:, :, valid], cpd, dofs.n_ps, dofs.p_mask,
            max(int(kp_deflate), 2), kp_deflate_min_amp,
        )
    if coarse_agg is not None and coarse_agg < 0:
        coarse_safe = probe is not None and (
            probe[0].shape[0] == 0 or float(probe[1].max()) < AMP_COARSE_CUTOFF
        )
        coarse_agg = 128 if coarse_safe else 0

    kp_modes = None
    if kp_deflate and kp_deflate > 0 and probe is not None and probe[0].shape[0]:
        # Schur pairs: each mode w as (0, w), then its velocity response
        modes = probe[0][: int(kp_deflate)]
        cvd_d = np.asarray(dofs.cell_vdofs, np.int64)[ids[valid]]
        blk_d = diag_blk[:, :, valid]
        if pin_vdofs is not None and len(pin_vdofs):
            pv = np.zeros(dofs.n_vs, dtype=bool)
            pv[np.asarray(pin_vdofs, np.int64)] = True
            blk_d = _pin_cell_mats(blk_d, cvd_d, pv)
        resp = _kp_mode_velocity_responses(
            blk_d, cvd_d, D[:, :, :, valid], modes, cpd, dofs.n_vs, dofs.v_mask,
        )
        rows = []
        for m_i, w in enumerate(modes):
            z1 = np.zeros(dofs.n_total)
            z1[dofs.n_u:] = w
            rows.append(z1)
            if resp is not None:
                z2 = np.zeros(dofs.n_total)
                z2[: dofs.n_u] = resp[m_i].reshape(-1)
                nrm = np.linalg.norm(z2)
                if nrm > 0:
                    rows.append(z2 / nrm)
        kp_modes = np.stack(rows)

    agg_p = None
    coarse_inv = None
    if coarse_agg and coarse_agg > 0:
        s_agg = _fit_agg_to_ow(
            max(int(coarse_agg), -(-dofs.n_ps // 4096)), lay.OWp
        )
        agg_p, coarse_inv = _coarse_space(
            Kp_t[:, :k_p, :][:, :, valid],  # pinned cell matrices
            cpd,
            dofs.n_ps,
            dofs.p_mask,
            s_agg,
            coarse_cond_cap,
            shift_nullspace=(pin_pdofs is None or not len(pin_pdofs)),
        )

    # ---- two-level coarse space for the A00 (velocity) sweeps -------------
    agg_v = None
    coarse_inv_v = None
    s_agg_v = 0
    if coarse_agg_v and coarse_agg_v > 0:
        s_agg_v = _fit_agg_to_ow(
            max(int(coarse_agg_v), -(-dofs.n_vs // 4096)), lay.OWv
        )
        cvd = np.asarray(dofs.cell_vdofs, np.int64)[ids[valid]]  # [nv, k_v]
        blk_v = diag_blk[:, :, valid]
        if pin_vdofs is not None and len(pin_vdofs):
            pinned_v = np.zeros(dofs.n_vs, dtype=bool)
            pinned_v[np.asarray(pin_vdofs, np.int64)] = True
            blk_v = _pin_cell_mats(blk_v, cvd, pinned_v)
        agg_v, coarse_inv_v = _coarse_space(
            blk_v,
            cvd,
            dofs.n_vs,
            dofs.v_mask,
            s_agg_v,
            coarse_cond_cap,
            shift_nullspace=(pin_vdofs is None or not len(pin_vdofs)),
        )

    def as_f(a, dt_=dtype):
        return torch.as_tensor(np.ascontiguousarray(a), device=device).to(dt_)

    def as_i(a):
        return None if a is None else torch.as_tensor(a, dtype=torch.int32, device=device)

    return WindowedAssembly(
        N_v=as_f(N_v),
        N_p=as_f(N_p),
        NN=as_f(NN),
        G_v=as_f(G_v),
        # invJT_t[d, a, c] pairs with G_v[b, q, a]: Gp[b,q,d,c] = sum_a
        invJT_t=as_f(invJT.transpose(1, 2, 0)),
        W_t=as_f(W_t),
        A_const=as_f(A_const, store_dtype or dtype),
        r_const=as_f(r_const),
        inv_mp=as_f(inv_mp),
        Kp_t=as_f(Kp_t),
        diag_kp=as_f(diag_kp),
        dim=dim,
        agg_p=as_i(agg_p),
        coarse_inv=None if coarse_inv is None else as_f(coarse_inv),
        coarse_agg_size=0 if coarse_inv is None else s_agg,
        agg_v=as_i(agg_v),
        coarse_inv_v=None if coarse_inv_v is None else as_f(coarse_inv_v),
        coarse_agg_size_v=0 if coarse_inv_v is None else s_agg_v,
        kp_modes=None if kp_modes is None else as_f(kp_modes),
    )


# ---- device assembly (torch) -----------------------------------------------


def _tangent(wa, lay, u_q, guW, rho):
    """A_t: the constant terms plus the convection blocks of the tangent
    (cpp:259-269), in A_const's storage dtype."""
    dim, k_v = wa.dim, lay.k_v
    Nv, W, Gr, iJ = wa.N_v, wa.W_t, wa.G_v, wa.invJT_t
    ein = torch.einsum
    # guW: grad u W [dim, dim, nq, ncd]
    # C2[(a,j) col, (a,i) row] = rho (u . grad N_j) N_i W
    u_ref = ein("dqc,dec->eqc", u_q, iJ)
    adv = ein("jqe,eqc->jqc", Gr, u_ref)
    C2 = ein("jqc,iq->jic", adv * W, rho * Nv)

    st = wa.A_const.dtype  # tangent STORE dtype (bf16 capacity mode)
    A_t = wa.A_const.clone()
    for b in range(dim):  # column component (A_t dim 0)
        for a in range(dim):  # row component (A_t dim 1)
            # C1 block [(b,j), (a,i)] = rho gu[a,b] N_i N_j W
            blk = rho * ein("qc,ijq->jic", guW[a, b], wa.NN)
            if a == b:
                blk = blk + C2
            A_t[b * k_v : (b + 1) * k_v, a * k_v : (a + 1) * k_v, :] += blk.to(st)
    return A_t


def assemble_windowed(
    wa: WindowedAssembly,
    lay: WindowedLayout,
    u: torch.Tensor,
    u_old: torch.Tensor,
    *,
    dt: float,
    nu: float,
    rho: float,
    convection_form: str = "reference",
    include_continuity_residual: bool = False,
    include_time_term: bool = True,
    residual_only: bool = False,
    group=None,
):
    """One Newton-tangent assembly in the windowed layout.

    Returns (A_t [nl, nli, ncd], residual [n_total], diag0 [n_total]), the
    same values as the original.  Dirichlet rows are NOT applied here.
    include_time_term=False drops the residual's -(rho/dt)(u - u_old) term.
    A_t is a new tensor in A_const's storage dtype.  residual_only=True
    computes the residual alone and returns (None, residual, None): the
    steady line search's trial residuals (in JAX the compiler drops the
    unused tangent; in eager torch it would be built).

    group: a sharded run's process group, with lay the rank's framed layout,
    wa its shard (``parallel/windowed_spmd.shard_wa``) and u, u_old, the
    residual and diag0 its owned vectors.  Every contraction stays local to
    the rank's slots; only the gather (K3) and the scatters (K4) exchange
    edge blocks with the neighbours.
    """
    dim, k_v, k_p = wa.dim, lay.k_v, lay.k_p
    nl = lay.nl
    Nv, Np, W = wa.N_v, wa.N_p, wa.W_t
    Gr = wa.G_v  # [k_v, nq, dim] reference gradients
    iJ = wa.invJT_t  # [dim, dim, ncd]; Gp[b,q,d,c] = sum_a iJ[d,a,c] Gr[b,q,a]
    ein = torch.einsum

    # [nli, ncd] each; u and u_old in one kernel launch on the card
    if include_time_term:
        X, Xo = windowed_gather_pair(lay, u, u_old, group)
    else:
        X = windowed_gather(lay, u, group)
    Xv = X[: dim * k_v].reshape(dim, k_v, -1)
    Xp = X[dim * k_v : nl]

    # fields at quadrature points; gradients contract the reference table
    # first and apply invJT per cell afterwards
    u_q = ein("bq,dbc->dqc", Nv, Xv)
    if include_time_term:
        Xov = Xo[: dim * k_v].reshape(dim, k_v, -1)
        uo_q = ein("bq,dbc->dqc", Nv, Xov)
    gu_ref = ein("dbc,bqe->dqec", Xv, Gr)
    gu_q = ein("dqec,aec->daqc", gu_ref, iJ)
    p_q = ein("bq,bc->qc", Np, Xp)

    guW = gu_q * W  # [dim, dim, nq, ncd]
    if not residual_only:
        A_t = _tangent(wa, lay, u_q, guW, rho)

    # ---- residual (cpp:287-311), momentum rows [dim, k_v, ncd] ------------
    if convection_form == "reference":
        conv = ein("dqc,daqc->aqc", u_q, gu_q)  # u^T grad u
    elif convection_form == "standard":
        conv = ein("dqc,adqc->aqc", u_q, gu_q)
    else:
        raise ValueError(convection_form)
    src = -rho * conv  # [dim, nq, ncd]
    if include_time_term:
        src = src - (rho / dt) * (u_q - uo_q)
    r_mom = ein("aqc,iq->aic", src * W, Nv)
    guW_ref = ein("abqc,bec->aeqc", guW, iJ)
    r_mom = r_mom - (nu * rho) * ein("aeqc,iqe->aic", guW_ref, Gr)
    pW_ref = ein("qc,iqe->iec", p_q * W, Gr)
    r_mom = r_mom + ein("iec,aec->aic", pW_ref, iJ)

    R = r_mom.new_zeros((lay.nli, lay.ncd))
    R[: dim * k_v] = r_mom.reshape(dim * k_v, -1)
    if include_continuity_residual:
        div_u = ein("ddqc->qc", gu_q)
        R[dim * k_v : nl] = ein("qc,iq->ic", div_u * W, Np)
    residual = windowed_scatter(lay, R, group) + wa.r_const
    if residual_only:
        return None, residual, None

    # ---- raw diagonal (pre-BC), widened before the cross-cell sum ----------
    ar = torch.arange(nl, device=A_t.device)
    Dv = r_mom.new_zeros((lay.nli, lay.ncd))
    Dv[:nl] = A_t[ar, ar, :].to(r_mom.dtype)
    diag0 = windowed_scatter(lay, Dv, group)

    return A_t, residual, diag0
