"""The port's assembly against the JAX package's, in float64 to 1e-12.

Both packages build from the same mesh and dofs; the port's ``build_context``,
``_neumann_residual``, ``build_windowed_assembly`` leaves and
``assemble_windowed`` outputs (A_t, residual, diag0) are held against JAX's.
The bf16 tangent store is checked in float32.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from navier_stokes_tpu.fem import assembly as ja
from navier_stokes_tpu.fem import windowed_assembly as jwa
from navier_stokes_tpu.fem.dofs import make_dofs, renumber_blocked
from navier_stokes_tpu.mesh.generate import unit_square
from navier_stokes_tpu.ops.windowed import build_windowed_layout as j_layout
from navier_stokes_tpu_torch import convert
from navier_stokes_tpu_torch.fem import assembly as ta
from navier_stokes_tpu_torch.fem import windowed_assembly as twa
from navier_stokes_tpu_torch.fem.dofs import make_dofs as t_make_dofs
from navier_stokes_tpu_torch.fem.dofs import renumber_blocked as t_renumber
from navier_stokes_tpu_torch.mesh.generate import unit_square as t_unit_square
from navier_stokes_tpu_torch.ops.windowed import build_windowed_layout as t_layout

PHYS = dict(dt=0.1, nu=0.01, rho=1.0, p_out=2.0)
# coarse_agg=-1 runs the f64 pinning probe; both coarse spaces are built
WA_KW = dict(coarse_agg=-1, coarse_agg_v=128)


def _forcing(x):
    return np.stack([np.sin(x[:, 0]), x[:, 0] * x[:, 1]], axis=1)


@functools.lru_cache(maxsize=None)
def _setup(n=6, cpb=16, forcing=False, dtype="float64"):
    f = _forcing if forcing else None
    jd, bi = renumber_blocked(make_dofs(unit_square(n)), cells_per_block=cpb)
    td, tbi = t_renumber(t_make_dofs(t_unit_square(n)), cells_per_block=cpb)
    assert bi == tbi
    jdt, tdt = (jnp.float64, torch.float64) if dtype == "float64" else (jnp.float32, torch.float32)
    jctx = ja.build_context(jd, neumann_tags=(1,), forcing=f, dtype=jdt)
    tctx = ta.build_context(td, neumann_tags=(1,), forcing=f, dtype=tdt)
    largs = lambda d: (d.cell_vdofs, d.cell_pdofs, d.n_vs, d.n_ps, 2)
    jlay = j_layout(*largs(jd), block_info=bi, Bc=128)
    tlay = t_layout(*largs(td), block_info=tbi, Bc=128)
    pins = dict(
        pin_pdofs=td.boundary_scalar_pdofs((1,)),
        pin_vdofs=td.boundary_scalar_vdofs((0, 2, 3)),
    )
    return jd, td, jctx, tctx, jlay, tlay, pins


def _close(got, want, rel=1e-12):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(np.abs(want).max(), 1e-300)
    err = np.abs(got - want).max() / scale
    assert err <= rel, err


@pytest.mark.parametrize("forcing", [False, True])
def test_context_matches(forcing):
    _, _, jctx, tctx, *_ = _setup(forcing=forcing)
    j, t = convert.arrays_of(jctx), convert.arrays_of(tctx)
    for k, v in t.items():
        if k == "group":  # the port's process group, the original's axis_name
            assert v is None and j["axis_name"] is None
        elif isinstance(v, np.ndarray):
            assert v.dtype == j[k].dtype, k
            assert np.array_equal(v, j[k]), k
        else:
            assert v == j[k], k
    # convert rebuilds the port's context from the JAX arrays
    back = convert.arrays_of(convert.context_from_arrays(j))
    assert all(np.array_equal(back[k], t[k]) for k in t if isinstance(t[k], np.ndarray))
    _close(ta._neumann_residual(tctx, 2.0), ja._neumann_residual(jctx, 2.0))


@functools.lru_cache(maxsize=None)
def _assemblies(forcing=False):
    jd, td, jctx, tctx, jlay, tlay, pins = _setup(forcing=forcing)
    jwa_ = jwa.build_windowed_assembly(jctx, jlay, jd, **PHYS, **WA_KW, **pins)
    twa_ = twa.build_windowed_assembly(tctx, tlay, td, **PHYS, **WA_KW, **pins)
    return jwa_, twa_


@pytest.mark.parametrize("forcing", [False, True])
def test_windowed_assembly_leaves_match(forcing):
    jwa_, twa_ = _assemblies(forcing)
    j = convert.arrays_of(jwa_)
    assert twa_.coarse_inv is not None and twa_.coarse_inv_v is not None
    # convert rebuilds the port's assembly from the JAX arrays (minus the
    # deflation modes the port does not have)
    for obj in (twa_, convert.assembly_from_arrays(j)):
        t = convert.arrays_of(obj)
        for k, v in t.items():
            if isinstance(v, np.ndarray):
                assert v.dtype == j[k].dtype, k
                _close(v, j[k])
            else:
                assert v == j[k], k


def _states(td, seed=3):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(td.n_total), rng.standard_normal(td.n_total)


@pytest.mark.parametrize("convection_form", ["reference", "standard"])
@pytest.mark.parametrize("continuity", [False, True])
def test_assemble_windowed_matches(convection_form, continuity, monkeypatch):
    """With the time term, u and u_old are gathered by one call of the pair
    (one kernel launch on the card)."""
    jd, td, jctx, tctx, jlay, tlay, pins = _setup()
    jwa_, twa_ = _assemblies()
    u, uo = _states(td)
    pairs = []
    real_pair = twa.windowed_gather_pair
    monkeypatch.setattr(twa, "windowed_gather_pair",
                        lambda *a: pairs.append(a) or real_pair(*a))
    kw = dict(dt=0.1, nu=0.01, rho=1.3, convection_form=convection_form,
              include_continuity_residual=continuity)
    want = jwa.assemble_windowed(jwa_, jlay, jnp.asarray(u), jnp.asarray(uo), **kw)
    got = twa.assemble_windowed(twa_, tlay, torch.as_tensor(u), torch.as_tensor(uo), **kw)
    assert len(pairs) == 1
    for g, w in zip(got, want):
        _close(g, w)


def test_assemble_windowed_steady_residual_matches():
    jd, td, jctx, tctx, jlay, tlay, pins = _setup()
    jwa_, twa_ = _assemblies()
    u, uo = _states(td, seed=4)
    kw = dict(dt=0.1, nu=0.01, rho=1.0, include_time_term=False)
    want = jwa.assemble_windowed(jwa_, jlay, jnp.asarray(u), jnp.asarray(uo), **kw)
    got = twa.assemble_windowed(twa_, tlay, torch.as_tensor(u), torch.as_tensor(uo), **kw)
    for g, w in zip(got, want):
        _close(g, w)


def test_bf16_store_matches_in_f32():
    """float32 with a bfloat16 tangent store: A_t is stored bf16 on both
    sides.  Each side rounds the same f32 sums to bf16, so entries agree to
    one bf16 ulp (2^-7 of the largest entry) where the f32 sums differ in
    their last bits; the residual is f32 on both sides (summation order:
    1e-5) and the diagonal sums those bf16 entries (1e-2)."""
    jd, td, jctx, tctx, jlay, tlay, pins = _setup(dtype="float32")
    kw = dict(**PHYS, **pins, store_dtype=None)
    jw_ = jwa.build_windowed_assembly(jctx, jlay, jd, **{**kw, "store_dtype": jnp.bfloat16})
    tw_ = twa.build_windowed_assembly(tctx, tlay, td, **{**kw, "store_dtype": torch.bfloat16})
    assert tw_.A_const.dtype == torch.bfloat16
    assert np.array_equal(
        tw_.A_const.float().numpy(), np.asarray(jw_.A_const.astype(jnp.float32))
    )
    u, uo = (a.astype(np.float32) for a in _states(td))
    akw = dict(dt=0.1, nu=0.01, rho=1.0)
    jA, jr, jdg = jwa.assemble_windowed(jw_, jlay, jnp.asarray(u), jnp.asarray(uo), **akw)
    tA, tr, tdg = twa.assemble_windowed(tw_, tlay, torch.as_tensor(u), torch.as_tensor(uo), **akw)
    assert tA.dtype == torch.bfloat16
    jA = np.asarray(jA.astype(jnp.float32))
    tA = tA.float().numpy()
    assert np.abs(tA - jA).max() <= 2.0 ** -7 * np.abs(jA).max()
    _close(tr, jr, 1e-5)
    _close(tdg, jdg, 1e-2)
