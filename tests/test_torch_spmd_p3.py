"""The port's sharded P3/P2 (cubic velocity, quadratic pressure) runs
against the JAX package's, in float64 on the CPU.

The ranks are spawned processes in a gloo group (tests/torch_spmd_ranks.py,
``p3``), once at 2 and once at 4 ranks; the JAX side runs here, sharded
over the virtual CPU devices conftest.py makes, while they run.

* every plain kernel version (K1; K2 v->v, v->p, p->p; K3, the pair; K4)
  at each rank's framed P3/P2 layout, against JAX's ``shard_map`` results
  to 1e-12 of the largest entry, on unit_square(6) at 8 cells a block
  (k_v 10, k_p 6; hv = hp = 2) and on box(6, 6, 6) at 28 cells a block
  (k_v 20, k_p 10; hv = hp = 6, the widest halo a layout takes: 24 owned
  blocks a rank at 2 ranks, 12 at 4, each framed by 6 empty ones a side);
  the wrappers' CPU path and the kernels' route equal to the plain
  versions;
* the exchange of one K1 product there: no all-reduce, each send at most
  one space's h*OW floats, 2 x (dim hv OWv + hp OWp) floats in all at an
  end rank and twice that at an inner one;
* the P3/P2 slice of tests/test_torch_solver.py (no preconditioner,
  FGMRES(200)) on unit_square(6) at 2 ranks against JAX at 2 devices,
  node by node to 1e-10, equal FGMRES counts and Newton residuals to
  1e-10, and against the port on one device at the ranks' numbering;
* the P3/P2 box at 4 ranks: on box(3, 3, 3) no windowed layout fits (1
  block a rank < halo 2 at every block size tried), and the port takes the
  flat design as JAX does, one BDF1 step without a preconditioner matching
  JAX's, every rank's state bit-equal; box(4, 4, 4) fits once the block
  size has doubled to 128 cells (4 blocks, halo 1) in both packages.
"""

import numpy as np
import pytest
import torch

import torch_spmd_ranks as ranks
from navier_stokes_tpu.config import SolverConfig as JConfig
from navier_stokes_tpu.mesh.generate import box as j_box
from navier_stokes_tpu.mesh.generate import unit_square as j_unit_square
from navier_stokes_tpu.models.navier_stokes import NavierStokesSolver as JSolver
from navier_stokes_tpu.ops import windowed as jw
from navier_stokes_tpu.utils.logging import RunLog as JLog
from test_torch_spmd import _close, _jax_sharded, _same_log, _same_nodes


# The P3/P2 box's step: 1,273 unpreconditioned FGMRES(60) iterations to
# rel_tol 1e-8 steer float64 rounding.  JAX's own flat runs on 1, 2 and 4
# devices spread by 4.5e-10 to 1.4e-9 of the state's max, the port's one
# device sits 5.2e-9 to 6.5e-9 from them and its 4 ranks 4.1e-9 from JAX's 4
# devices; the last Newton residuals part by 1.3e-9 relative, and the
# solve's count by 2 (1,271 on the port's 4 ranks, 1,273 on JAX's devices and
# the port's one).  The bounds sit 3x, 8x and 2.5x above the widest.
BOX_STATE_TOL = 2e-8
BOX_RESIDUAL_TOL = 1e-8
BOX_ITERS_SLACK = 5


def _load(path):
    return torch.load(path, weights_only=False)


def _jax_solve(n):
    """JAX's n-device run: the P3/P2 slice at 2, the P3/P2 boxes at 4."""
    log = JLog(verbose=False)
    if n == 2:
        s = JSolver(j_unit_square(6), ranks.p3_config(JConfig), log=log, n_devices=2)
        s.solve()
        return dict(solver=s, log=log)
    s = JSolver(j_box(3, 3, 3), ranks.p3_box_config(JConfig), log=log, inlet=ranks.box_inlet,
                n_devices=4)
    s.solve()
    s4 = JSolver(j_box(4, 4, 4), ranks.p3_box_config(JConfig), log=JLog(verbose=False),
                 inlet=ranks.box_inlet, n_devices=4)
    s4.setup()
    return dict(solver=s, log=log, box4=s4)


@pytest.fixture(scope="module")
def p3_out(tmp_path_factory):
    """{n: (each rank's results, JAX's run)}, the ranks and JAX at once."""
    res = {}
    for n in (2, 4):
        out = tmp_path_factory.mktemp(f"p3_{n}")
        ctx = ranks.start(ranks.p3, n, f"file://{out}/store", str(out))
        try:
            want = _jax_solve(n)
        finally:
            ranks.wait(ctx, f"p3 on {n} ranks")
        res[n] = ([_load(out / f"p3_{n}_{r}.pt") for r in range(n)], want)
    return res


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("mesh", list(ranks.P3_MESHES))
def test_sharded_p3_plain_kernels_match_jax(mesh, n, p3_out):
    got = [g[mesh] for g in p3_out[n][0]]
    dofs, lay, A, x, R = ranks.kernel_problem(n, mesh=mesh)
    dim = 3 if mesh == "box-p3" else 2
    assert (lay.k_v, lay.k_p) == ((20, 10) if dim == 3 else (10, 6))
    assert (lay.nb, lay.hv, lay.hp) == ((48, 6, 6) if dim == 3 else (10 if n == 2 else 12, 2, 2))
    jlay = jw.build_windowed_layout(dofs.cell_vdofs, dofs.cell_pdofs, dofs.n_vs, dofs.n_ps, dim,
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
@pytest.mark.parametrize("mesh", list(ranks.P3_MESHES))
def test_p3_exchange_is_the_halo_edges(mesh, n, p3_out):
    """One sharded K1 product at P3/P2 all-reduces nothing and sends each
    space's h edge blocks at most; an end rank, with one neighbour, sends
    2 x (dim hv OWv + hp OWp) floats, an inner rank twice that."""
    for rank, res in enumerate(p3_out[n][0]):
        v = res[mesh]["volume"]
        assert v["all_reduces"] == 0, v
        assert max(v["sends"]) <= v["edge"] and v["floats"] == sum(v["sends"]), v
        one_side = 2 * (v["dim"] * v["hv"] * v["OWv"] + v["hp"] * v["OWp"])
        assert v["floats"] == one_side * (1 if rank in (0, n - 1) else 2), (rank, v)
        assert (v["hv"], v["hp"]) == ((6, 6) if mesh == "box-p3" else (2, 2))


def test_sharded_p3_solve_matches_jax(p3_out):
    got, want = p3_out[2]
    g = got[0]["solve"]
    js, jlog = want["solver"], want["log"]
    assert g["k"] == (10, 6) and g["frame"] == g["hv"] == 2 and g["nb"] == js._win_layout.nb
    jnodes = {tuple(np.round(c, 10)): v
              for c, v in zip(js.velocity_coords(real_only=True), js.velocity(real_only=True))}
    _same_nodes(g["nodes"], jnodes)
    _same_log(g["log"], ranks.trajectory(jlog))
    assert sum(e == "gmres" for e, _ in g["log"]) >= 3
    one = ranks.p3_solve(None)  # the port on one device at the ranks' numbering
    _same_nodes(g["nodes"], one["nodes"])
    _same_log(g["log"], one["log"])


def test_p3_box_falls_through_to_flat_as_jax(p3_out):
    got, want = p3_out[4]
    g = got[0]["solve"]
    js, jlog = want["solver"], want["log"]
    assert g["matvec"] == js._matvec == "flat" and js.cfg.krylov.matvec == "windowed"
    _close(g["solution"], np.asarray(js.solution), rel=BOX_STATE_TOL)
    jt = ranks.trajectory(jlog)
    assert [e for e, _ in g["log"]] == [e for e, _ in jt]
    for (e, a), (_, b) in zip(g["log"], jt):
        assert abs(a - b) <= (BOX_ITERS_SLACK if e == "gmres" else BOX_RESIDUAL_TOL * b), (a, b)
    assert sum(e == "gmres" for e, _ in g["log"]) >= 1
    for r in got[1:]:
        np.testing.assert_array_equal(r["solve"]["solution"], g["solution"])
    np.testing.assert_array_equal(g["cell_owner"], np.asarray(js.cell_owner))
    s4 = want["box4"]
    assert g["box4"] == (s4._matvec, (s4._win_layout.nb, s4._win_layout.hv)) == (
        "windowed", (4, 1))
