"""The port's sharded 3D path against the JAX package's, in float64 on the CPU.

P2/P1 tetrahedra on ``box(4, 4, 4)`` at 16 cells a block: nb 24 and halos
hv = hp = 4, so a rank's framed layout holds 4 empty blocks on each side of
its owned ones (12 at 2 ranks, 6 at 4) and every product trades 4 blocks of
each space with each neighbour.  The port's ranks are spawned processes in a
gloo group (tests/torch_spmd_ranks.py); the JAX side runs here, sharded
over the virtual CPU devices conftest.py makes.  Each group of ranks is
spawned once (module fixtures):

* every plain kernel version (K1; K2 v->v, v->p, p->p; K3, the pair; K4)
  at 2 and 4 ranks against JAX's ``shard_map`` results, to 1e-12 of the
  largest entry; the wrappers' CPU path and the kernels' route (framed
  result, then ``_unframe``) equal to the plain versions;
* the exchange of one K1 product: no all-reduce, each send at most one
  space's h*OW floats, and at a rank with one neighbour 2 x (3 hv OWv +
  hp OWp) floats in all (the frame's edges out, the frame's sums back);
* whole solves at 2 ranks against JAX at 2 devices, node by node to 1e-10,
  with equal Newton and FGMRES counts and Newton residuals to 1e-10: 2
  BDF1 steps of the convection-dominated box of tests/test_torch_3d.py
  (the ramped parabolic inlet, u dt / h 1.2) with Cahouet-Chabard and its
  coarse corrections, the same with block_triangular, and StokesSolver's
  windowed solve on plane Poiseuille boundaries (on the duct's, the
  solution moves by 1e-5 with the order of float64 sums, in JAX's 1- and
  2-device runs alike).  Tangents to rel_tol 1e-4 (``ranks.BOX_REL_TOL``),
  Newton to its default absolute 1e-2, Stokes to its 1e-6; the JAX runs go
  while the ranks do.
"""

import functools

import numpy as np
import pytest
import torch

import torch_spmd_ranks as ranks
from navier_stokes_tpu.config import SolverConfig as JConfig
from navier_stokes_tpu.mesh.generate import box as j_box
from navier_stokes_tpu.models.navier_stokes import NavierStokesSolver as JSolver
from navier_stokes_tpu.models.stokes import StokesSolver as JStokes
from navier_stokes_tpu.ops import windowed as jw
from navier_stokes_tpu.utils.logging import RunLog as JLog
from test_torch_spmd import _close, _jax_sharded, _same_log, _same_nodes


def _load(path):
    return torch.load(path, weights_only=False)


@functools.lru_cache(maxsize=None)
def _kernels_out(n, out):
    ranks.spawn(ranks.kernels, n, f"file://{out}/store", out, "box")
    return [_load(f"{out}/kernels{n}_{r}.pt") for r in range(n)]


@pytest.fixture(scope="module")
def kernels_out(tmp_path_factory):
    def get(n):
        return _kernels_out(n, str(tmp_path_factory.mktemp(f"box_kernels{n}")))
    return get


def _jax_case(name):
    """The JAX package's 2-device run of the box case: (solver, log)."""
    log = JLog(verbose=False)
    precond, krylov = ranks.BOX_CASES[name]
    if name == "stokes":
        s = JStokes(j_box(4, 4, 4), ranks.box_stokes_config(JConfig),
                    inlet=ranks.box_stokes_inlet, log=log, n_devices=2)
    else:
        s = JSolver(j_box(4, 4, 4), ranks.box_config(precond, JConfig, **krylov),
                    inlet=ranks.box_inlet, log=log, n_devices=2)
    s.solve()
    return s, log


@pytest.fixture(scope="module")
def solves(tmp_path_factory):
    """The port's 2-rank runs of every box case and JAX's 2-device runs,
    made at the same time."""
    out = tmp_path_factory.mktemp("solves3d")
    ctx = ranks.start(ranks.solves3d, 2, f"file://{out}/store", str(out))
    try:
        jax_runs = {name: _jax_case(name) for name in ranks.BOX_CASES}
    finally:
        ranks.wait(ctx, "solves3d on 2 ranks")
    return _load(out / "solves3d.pt"), jax_runs


@pytest.mark.parametrize("n", [2, 4])
def test_sharded_plain_kernels_match_jax_on_box(n, kernels_out):
    got = kernels_out(n)
    dofs, lay, A, x, R = ranks.kernel_problem(n, mesh="box")
    assert (lay.dim, lay.nb, lay.hv, lay.hp) == (3, 24, 4, 4)
    jlay = jw.build_windowed_layout(dofs.cell_vdofs, dofs.cell_pdofs, dofs.n_vs, dofs.n_ps, 3,
                                    block_info={"nb": lay.nb, "OWv": lay.OWv, "OWp": lay.OWp})
    want = _jax_sharded(n, jlay, A, x, R)
    for key in ("matvec", "scatter", *(f"block {i}->{o}" for i, o in ranks.BLOCKS)):
        cat = np.concatenate([g[key] for g in got])
        _close(cat, want[key])
        wrapper = "matvec_wrapper" if key == "matvec" else (
            "scatter_unframed" if key == "scatter" else f"{key} wrapper")
        np.testing.assert_array_equal(np.concatenate([g[wrapper] for g in got]), cat)
    gather = np.concatenate([g["gather"] for g in got], axis=1)
    _close(gather, want["gather"])
    pair = np.concatenate([g["gather_pair"] for g in got], axis=2)
    np.testing.assert_array_equal(pair[0], gather)
    _close(pair[1], 0.5 * want["gather"])


@pytest.mark.parametrize("n", [2, 4])
def test_box_exchange_is_the_halo_edges(n, kernels_out):
    """One sharded K1 product all-reduces nothing and sends each space's h
    edge blocks at most (h*OW floats a send); an end rank, with one
    neighbour, sends the frame's edges and the frame's sums once each:
    2 x (3 hv OWv + hp OWp) floats; an inner rank twice that."""
    for rank, res in enumerate(kernels_out(n)):
        v = res["volume"]
        assert v["all_reduces"] == 0, v
        assert max(v["sends"]) <= v["edge"] and v["floats"] == sum(v["sends"]), v
        one_side = 2 * (v["dim"] * v["hv"] * v["OWv"] + v["hp"] * v["OWp"])
        assert v["floats"] == one_side * (1 if rank in (0, n - 1) else 2), (rank, v)


@pytest.mark.parametrize("name", list(ranks.BOX_CASES))
def test_sharded_box_solve_matches_jax(name, solves):
    got, jax_runs = solves
    got = got[name]
    js, jlog = jax_runs[name]
    coords = (js.dofs.v_coords[js.dofs.v_mask] if name == "stokes"
              else js.velocity_coords(real_only=True))
    want = {tuple(np.round(c, 10)): v for c, v in zip(coords, js.velocity(real_only=True))}
    _same_nodes(got["nodes"], want)
    _same_log(got["log"], ranks.trajectory(jlog))
    assert got["frame"] == 4
    assert sum(e == "gmres" for e, _ in got["log"]) >= (1 if name == "stokes" else 2)
    if name == "cc_coarse":  # both coarse corrections ran, in both packages
        assert got["coarse"] == (True, True)
        assert js._wassembly.coarse_inv is not None and js._wassembly.coarse_inv_v is not None
