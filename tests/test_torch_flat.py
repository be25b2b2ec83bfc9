"""The port's flat path against the JAX package's, in float64.

Assembly (``assemble_navier_stokes`` for both convection forms and every
quirk flag, ``assemble_stokes``; 2D and one 3D case) agrees to 1e-12 of
each output's largest entry; the element operators (matvec, diagonal, the
velocity and pressure-mass blocks) likewise; the transpose gather maps are
equal to JAX's, and the gather reduction equals ``index_add_``.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from navier_stokes_tpu.fem import assembly as ja
from navier_stokes_tpu.fem.dofs import make_dofs as j_make_dofs
from navier_stokes_tpu.la import operators as jops
from navier_stokes_tpu.mesh import generate as j_gen
from navier_stokes_tpu_torch.fem import assembly as ta
from navier_stokes_tpu_torch.fem.dofs import make_dofs as t_make_dofs
from navier_stokes_tpu_torch.la import operators as tops
from navier_stokes_tpu_torch.mesh import generate as t_gen
from navier_stokes_tpu_torch.ops.scatter import build_gather_map, gather_scatter

TOL = 1e-12
MESHES = {"square": lambda g: g.unit_square(3), "box": lambda g: g.box(2, 2, 2)}


def forcing(x):
    """A smooth non-zero forcing, so the f_q terms take part."""
    f = np.zeros_like(x)
    f[:, 0] = np.sin(3.0 * x[:, 0]) + x[:, 1]
    f[:, 1] = np.cos(2.0 * x[:, 1]) * x[:, 0]
    return f


@functools.lru_cache(maxsize=None)
def _contexts(name):
    jd = j_make_dofs(MESHES[name](j_gen))
    td = t_make_dofs(MESHES[name](t_gen))
    kw = dict(neumann_tags=(1,), forcing=forcing)
    jc = ja.build_context(jd, dtype=jnp.float64, **kw)
    tc = ta.build_context(td, dtype=torch.float64, **kw)
    return jd, td, jc, tc


def _close(got, want, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    scale = max(np.abs(want).max(), 1e-300)
    assert np.abs(got - want).max() <= tol * scale, np.abs(got - want).max() / scale


def _states(n, seed=3):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(n), rng.standard_normal(n)


@pytest.mark.parametrize("name", sorted(MESHES))
def test_gather_maps_equal_jax(name):
    _, td, jc, tc = _contexts(name)
    for field in ("scatter_full", "scatter_vel", "scatter_p"):
        assert np.array_equal(np.asarray(getattr(jc, field)), getattr(tc, field).numpy()), field
    nvl = td.dim * td.element.n_v
    got = build_gather_map(td.cell_dofs[:, :nvl], td.n_u)
    assert np.array_equal(got, np.asarray(jc.scatter_vel))


@pytest.mark.parametrize("name", sorted(MESHES))
def test_gather_scatter_equals_index_add(name):
    _, td, _, tc = _contexts(name)
    vals = torch.as_tensor(np.random.default_rng(5).standard_normal(tc.cell_dofs.numel()))
    want = torch.zeros(td.n_total, dtype=torch.float64).index_add_(
        0, tc.cell_dofs.reshape(-1).long(), vals)
    _close(gather_scatter(vals, tc.scatter_full), want.numpy(), 1e-14)


@pytest.mark.parametrize(
    "name, conv, cont, mass_rho",
    [("square", c, i, m) for c in ("reference", "standard") for i in (False, True)
     for m in (False, True)] + [("box", "standard", True, True)],
)
def test_assemble_navier_stokes_matches_jax(name, conv, cont, mass_rho):
    jd, td, jc, tc = _contexts(name)
    u, uo = _states(td.n_total)
    kw = dict(dt=0.05, nu=0.3, rho=1.3, p_out=2.0, convection_form=conv,
              include_continuity_residual=cont, jacobian_mass_rho=mass_rho)
    jout = ja.assemble_navier_stokes(jc, jnp.asarray(u), jnp.asarray(uo), **kw)
    tout = ta.assemble_navier_stokes(tc, torch.as_tensor(u), torch.as_tensor(uo), **kw)
    for g, w in zip(tout, jout):
        _close(g, w)


@pytest.mark.parametrize("name", sorted(MESHES))
def test_assemble_stokes_matches_jax(name):
    _, _, jc, tc = _contexts(name)
    kw = dict(nu=0.3, rho=1.3, p_out=2.0)
    for g, w in zip(ta.assemble_stokes(tc, **kw), ja.assemble_stokes(jc, **kw)):
        _close(g, w)


@pytest.mark.parametrize("name", sorted(MESHES))
def test_element_operators_match_jax(name):
    jd, td, jc, tc = _contexts(name)
    u, uo = _states(td.n_total, seed=7)
    kw = dict(dt=0.05, nu=0.3, rho=1.3, p_out=2.0)
    jmat, jpm, _ = ja.assemble_navier_stokes(jc, jnp.asarray(u), jnp.asarray(uo), **kw)
    tmat, tpm, _ = ta.assemble_navier_stokes(tc, torch.as_tensor(u), torch.as_tensor(uo), **kw)
    rows = np.unique(np.concatenate([td.boundary_scalar_vdofs([0, 2]),
                                     td.boundary_scalar_vdofs([3]) + td.n_vs]))
    n = td.n_total
    jdiag0 = jops.raw_diagonal(jmat, jc.cell_dofs, n, None, jc.scatter_full)
    tdiag0 = tops.raw_diagonal(tmat, tc.cell_dofs, n, tc.scatter_full)
    _close(tdiag0, jdiag0)
    jop = jops.ElementOperator(
        cell_mat=jmat, cell_dofs=jc.cell_dofs, bc_rows=jnp.asarray(rows, jnp.int32),
        bc_diag=jdiag0[rows], scatter_idx=jc.scatter_full, n=n)
    top = tops.ElementOperator(
        cell_mat=tmat, cell_dofs=tc.cell_dofs, bc_rows=torch.as_tensor(rows),
        bc_diag=tdiag0[rows], scatter_idx=tc.scatter_full, n=n)
    x = np.random.default_rng(9).standard_normal(n)
    _close(tops.matvec(top, torch.as_tensor(x)), jops.matvec(jop, jnp.asarray(x)))
    _close(tops.diagonal(top), jops.diagonal(jop))
    # the velocity block (symmetric BC elimination), with and without a map
    mask = rows < td.n_u
    nb_v = tc.nb_v
    for jmap, tmap in ((jc.scatter_vel, tc.scatter_vel), (None, None)):
        ja00 = jops.velocity_block(jop, td.dim, nb_v, td.n_u, bc_mask=mask, scatter_idx=jmap)
        ta00 = tops.velocity_block(top, td.dim, nb_v, td.n_u, bc_mask=mask, scatter_idx=tmap)
        _close(tops.matvec(ta00, torch.as_tensor(x[: td.n_u])),
               jops.matvec(ja00, jnp.asarray(x[: td.n_u])))
        _close(tops.diagonal(ta00), jops.diagonal(ja00))
    cpd = td.cell_pdofs
    jmp = jops.pressure_mass_block(jpm, jnp.asarray(cpd), td.n_p, scatter_idx=jc.scatter_p)
    tmp = tops.pressure_mass_block(tpm, torch.as_tensor(cpd), td.n_p, scatter_idx=tc.scatter_p)
    _close(tops.matvec(tmp, torch.as_tensor(x[td.n_u:])), jops.matvec(jmp, jnp.asarray(x[td.n_u:])))
    _close(tops.diagonal(tmp), jops.diagonal(jmp))
