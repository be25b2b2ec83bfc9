"""The host side of the port's sharded runs against the JAX package's.

On ``unit_square(6)`` with 16 cells a block (the JAX tests' ``_problem``,
tests/test_windowed_spmd.py), and on the tetrahedra of ``box(4, 4, 4)``
with 16 cells a block (nb 24, halos hv = hp = 4), exactly, in one process:

* ``renumber_blocked(nb_multiple=n)``: dof maps, permutations, masks,
  coordinates and ``block_info`` for n in 1, 2 and 4;
* ``make_dist_layout``, ``to_dist`` / ``from_dist`` (round trips, and both
  directions against JAX's arrays), ``localize_rows`` / ``localize_values``;
* the framed local layout of every rank: its owned blocks' tables are the
  global layout's tables sliced on the block axis, its frame blocks are
  empty (padded slots only), its spaces the framed ones;
* ``shard_wa``: the rank's slots and owned rows of the global precompute,
  the frame's slots with zero weights, identity invJT and zero matrices.
"""

import functools

import numpy as np
import pytest
import torch

from navier_stokes_tpu.fem.dofs import make_dofs as j_make_dofs
from navier_stokes_tpu.fem.dofs import renumber_blocked as j_renumber
from navier_stokes_tpu.mesh.generate import box as j_box
from navier_stokes_tpu.mesh.generate import unit_square as j_unit_square
from navier_stokes_tpu.ops.windowed import build_windowed_layout as j_build
from navier_stokes_tpu.parallel import windowed_spmd as jws
from navier_stokes_tpu_torch.fem.assembly import build_context
from navier_stokes_tpu_torch.fem.dofs import make_dofs, renumber_blocked
from navier_stokes_tpu_torch.fem.windowed_assembly import build_windowed_assembly
from navier_stokes_tpu_torch.mesh.generate import box, unit_square
from navier_stokes_tpu_torch.ops.windowed import build_windowed_layout
from navier_stokes_tpu_torch.parallel import windowed_spmd as ws

# (mesh, ranks); the square's cases keep the ids of the ranks alone
N_DEV = pytest.mark.parametrize("mesh, n_dev", [("square", n) for n in (1, 2, 4)]
                                + [("box", n) for n in (1, 2, 4)],
                                ids=["1", "2", "4", "box-1", "box-2", "box-4"])
SHARDED = pytest.mark.parametrize("mesh, n_dev", [("square", 2), ("square", 4), ("box", 2),
                                                  ("box", 4)],
                                  ids=["2", "4", "box-2", "box-4"])
MESHES = {"square": (unit_square, j_unit_square, (6,)), "box": (box, j_box, (4, 4, 4))}


@functools.lru_cache(maxsize=None)
def _problem(n_dev, mesh="square"):
    make, j_make, args = MESHES[mesh]
    jd, jbi = j_renumber(j_make_dofs(j_make(*args)), cells_per_block=16, nb_multiple=n_dev)
    td, tbi = renumber_blocked(make_dofs(make(*args)), cells_per_block=16, nb_multiple=n_dev)
    args = (td.cell_vdofs, td.cell_pdofs, td.n_vs, td.n_ps, td.dim)
    return jd, jbi, td, tbi, j_build(*args, block_info=tbi), build_windowed_layout(
        *args, block_info=tbi)


@N_DEV
def test_renumber_blocked_nb_multiple_equals_jax(mesh, n_dev):
    jd, jbi, td, tbi, _, _ = _problem(n_dev, mesh)
    assert tbi == jbi and tbi["nb"] % n_dev == 0
    for name in ("n_vs", "n_ps"):
        assert getattr(td, name) == getattr(jd, name)
    for name in ("cell_vdofs", "cell_pdofs", "v_perm", "p_perm", "v_mask", "p_mask",
                 "v_coords", "p_coords"):
        np.testing.assert_array_equal(getattr(td, name), np.asarray(getattr(jd, name)), name)


@SHARDED
def test_dist_layout_and_vector_maps_equal_jax(mesh, n_dev):
    _, _, td, _, jlay, tlay = _problem(n_dev, mesh)
    dl, jdl = ws.make_dist_layout(tlay, n_dev), jws.make_dist_layout(jlay, n_dev)
    for f in ("n_dev", "dim", "nb", "nb_loc", "OWv", "OWp", "n_vs", "n_ps", "nvs_loc",
              "nps_loc", "llen", "n_total"):
        assert getattr(dl, f) == getattr(jdl, f), f
    x = np.random.default_rng(5).standard_normal(td.n_total)
    xd = ws.to_dist(x, dl)
    np.testing.assert_array_equal(xd, jws.to_dist(x, jdl))
    np.testing.assert_array_equal(ws.from_dist(x, dl), jws.from_dist(x, jdl))
    np.testing.assert_array_equal(ws.from_dist(xd, dl), x)
    # torch tensors take the same maps
    np.testing.assert_array_equal(ws.to_dist(torch.as_tensor(x), dl).numpy(), xd)
    np.testing.assert_array_equal(ws.from_dist(torch.as_tensor(xd), dl).numpy(), x)


@SHARDED
def test_localize_rows_and_values_equal_jax(mesh, n_dev):
    _, _, td, _, jlay, tlay = _problem(n_dev, mesh)
    dl, jdl = ws.make_dist_layout(tlay, n_dev), jws.make_dist_layout(jlay, n_dev)
    rng = np.random.default_rng(11)
    rows = np.unique(rng.integers(0, td.n_total, size=60))
    got, want = ws.localize_rows(rows, dl), jws.localize_rows(rows, jdl)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    local, dev, slot = got
    vals = rng.standard_normal(len(rows))
    lv = ws.localize_values(vals, dev, slot, n_dev, local.shape[1])
    np.testing.assert_array_equal(lv, jws.localize_values(vals, dev, slot, n_dev, local.shape[1]))
    # a rank's real rows come first; setting them on its chunk sets the
    # global rows of the planar vector
    x = rng.standard_normal(td.n_total)
    xd = ws.to_dist(x, dl).reshape(n_dev, dl.llen).copy()
    for r in range(n_dev):
        k = int((local[r] < dl.llen).sum())
        assert (local[r, k:] == dl.llen).all()
        xd[r, local[r, :k]] = lv[r, :k]
    want = x.copy()
    want[rows] = vals
    np.testing.assert_array_equal(ws.from_dist(xd.reshape(-1), dl), want)


@SHARDED
def test_local_layout_is_the_global_sliced_in_a_frame(mesh, n_dev):
    _, _, _, _, _, lay = _problem(n_dev, mesh)
    dl = ws.make_dist_layout(lay, n_dev)
    F = max(lay.hv, lay.hp)
    seen = 0
    for r in range(n_dev):
        loc = ws.local_layout(lay, dl, r)
        assert loc.frame == F and loc.nb == dl.nb_loc + 2 * F
        assert (loc.n_vs, loc.n_ps) == (loc.nb * lay.OWv, loc.nb * lay.OWp)
        assert (loc.nvs_own, loc.nps_own) == (dl.nvs_loc, dl.nps_loc)
        for f in ("Bmax", "Bc", "nchunks", "OWv", "OWp", "hv", "hp", "RWv", "RWp", "RVv",
                  "RVp", "k_v", "k_p", "dim"):
            assert getattr(loc, f) == getattr(lay, f), f
        own = slice(r * dl.nb_loc, (r + 1) * dl.nb_loc)
        for name, fill in (("cell_ids", 0), ("loc_v_hi", lay.RVv), ("loc_v_lo", 128),
                           ("loc_p_hi", lay.RVp), ("loc_p_lo", 128), ("offs_v", 0),
                           ("offs_p", 0)):
            t, g = getattr(loc, name), getattr(lay, name)
            assert torch.equal(t[F : F + dl.nb_loc], g[own]), name
            assert (t[:F] == fill).all() and (t[F + dl.nb_loc :] == fill).all(), name
        seen += int((loc.loc_p_hi[:, 0, :] < lay.RVp).sum())
    assert seen == MESHES[mesh][0](*MESHES[mesh][2]).n_cells  # every cell once


@SHARDED
def test_shard_wa_slices_the_global_precompute(mesh, n_dev):
    _, _, td, _, _, lay = _problem(n_dev, mesh)
    ctx = build_context(td, neumann_tags=(1,), dtype=torch.float64)
    wa = build_windowed_assembly(ctx, lay, td, dt=0.1, nu=0.01, rho=1.0, p_out=2.0,
                                 coarse_agg=128, coarse_agg_v=128)
    dl = ws.make_dist_layout(lay, n_dev)
    Bm = lay.Bmax
    for r in range(n_dev):
        loc = ws.local_layout(lay, dl, r)
        sh = ws.shard_wa(wa, dl, loc, r, "cpu")
        F = loc.frame * Bm
        cols = slice(r * dl.nb_loc * Bm, (r + 1) * dl.nb_loc * Bm)
        for name in ("invJT_t", "W_t", "A_const", "Kp_t"):
            t, g = getattr(sh, name), getattr(wa, name)
            assert t.shape[-1] == loc.ncd, name
            assert torch.equal(t[..., F : F + dl.nb_loc * Bm], g[..., cols]), name
        frame = torch.cat([torch.arange(F), torch.arange(loc.ncd - F, loc.ncd)])
        assert (sh.W_t[:, frame] == 0).all() and (sh.A_const[..., frame] == 0).all()
        assert (sh.Kp_t[..., frame] == 0).all()
        d = td.dim
        assert torch.equal(sh.invJT_t[..., frame],
                           torch.eye(d, dtype=torch.float64)[..., None].expand(d, d, len(frame)))
        np.testing.assert_array_equal(
            sh.r_const.numpy(), ws.to_dist(wa.r_const.numpy(), dl)[r * dl.llen : (r + 1) * dl.llen])
        for name, n_loc in (("inv_mp", dl.nps_loc), ("diag_kp", dl.nps_loc),
                            ("agg_p", dl.nps_loc), ("agg_v", dl.nvs_loc)):
            assert torch.equal(getattr(sh, name), getattr(wa, name)[r * n_loc : (r + 1) * n_loc])
        assert torch.equal(sh.coarse_inv, wa.coarse_inv)
        assert torch.equal(sh.coarse_inv_v, wa.coarse_inv_v)
