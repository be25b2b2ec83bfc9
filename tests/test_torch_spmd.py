"""The port's sharded runs against the JAX package's, in float64 on the CPU.

The port's ranks are processes (``torch.multiprocessing``, spawn) joined in
a gloo group through a ``file://`` store under the test's temporary
directory; what they run is tests/torch_spmd_ranks.py.  The JAX side runs
here, sharded over the virtual CPU devices conftest.py makes.  Each group of
ranks is spawned once (module fixtures) and serves several tests:

* every plain kernel version (K1; K2 v->v, v->p, p->p; K3, the pair; K4)
  at 2 and 4 ranks on ``unit_square(6)`` against JAX's ``shard_map``
  results, to 1e-12 of the largest entry; the wrappers' CPU path and the
  kernels' route (framed result, then ``_unframe``) equal to the plain
  versions;
* the exchange: a product all-reduces nothing, each send is at most one
  space's h*OW floats, and the halo's share of the vector shrinks from
  ``unit_square(6)`` to ``unit_square(12)`` (JAX's
  ``test_sharded_matvec_collective_volume_is_o_halo``);
* whole solves at 2 ranks against JAX at 2 devices, node by node to 1e-10,
  with equal Newton and FGMRES counts: unsteady with block_triangular (also
  against the port's single-device run), Cahouet-Chabard with its coarse
  corrections, ``solve_steady``, ``solve_scanned`` with a functional, a
  time-dependent forcing from the Stokes guess, and StokesSolver's
  windowed Poiseuille flow (also against the exact flow);
* the per-cell ``partitioning`` output (the real owner rank, equal to
  JAX's ``cell_owner``) and a checkpoint, written by rank 0 alone, the
  checkpoint restored by every rank of a new solver;
* ``initialize_distributed()`` joins each spawned rank from torchrun's
  variables, and in a single process does nothing;
* the command line with ``--devices 2 --distributed`` on 2 ranks against
  ``--devices 1``, record for record (tests/test_torch_cli.py).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import torch_spmd_ranks as ranks
from navier_stokes_tpu.config import SolverConfig as JConfig
from navier_stokes_tpu.mesh.generate import unit_square as j_unit_square
from navier_stokes_tpu.models.navier_stokes import NavierStokesSolver as JSolver
from navier_stokes_tpu.models.stokes import StokesSolver as JStokes
from navier_stokes_tpu.ops import windowed as jw
from navier_stokes_tpu.parallel import windowed_spmd as jws
from navier_stokes_tpu.parallel.spmd import device_mesh, shard_map
from navier_stokes_tpu.utils.logging import RunLog as JLog
from navier_stokes_tpu_torch.parallel import bootstrap
from navier_stokes_tpu_torch.parallel import windowed_spmd as ws


def _load(path):
    return torch.load(path, weights_only=False)


@functools.lru_cache(maxsize=None)
def _kernels_out(n, out):
    ranks.spawn(ranks.kernels, n, f"file://{out}/store", out)
    return [_load(f"{out}/kernels{n}_{r}.pt") for r in range(n)]


@pytest.fixture(scope="module")
def kernels_out(tmp_path_factory):
    def get(n):
        return _kernels_out(n, str(tmp_path_factory.mktemp(f"kernels{n}")))
    return get


@pytest.fixture(scope="module")
def solves_out(tmp_path_factory):
    out = tmp_path_factory.mktemp("solves")
    ranks.spawn(ranks.solves, 2, f"file://{out}/store", str(out))
    return out, _load(out / "solves.pt")


# ---- the kernels' plain versions ------------------------------------------


def _jax_sharded(n, jlay, A, x, R):
    """JAX's sharded results, in the device-major layout (vectors) or the
    global slot order (gathers)."""
    jdl = jws.make_dist_layout(jlay, n)
    mesh = device_mesh(n, axis=jws.AXIS)
    lay_s = jws.shard_layout(jlay, jdl, mesh)
    ls = jws.layout_pspecs(lay_s)
    ax, sh = jws.AXIS, P(jws.AXIS)
    xd = jnp.asarray(jws.to_dist(x, jdl))

    def run(f, in_specs, out_specs, *args):
        return np.asarray(jax.jit(shard_map(f, mesh, in_specs=(ls, *in_specs),
                                            out_specs=out_specs))(lay_s, *args))

    out = {
        "matvec": run(lambda la, a, v: jw.windowed_matvec(la, a, v, axis_name=ax),
                      (P(None, None, ax), sh), sh, jnp.asarray(A), xd),
        "gather": run(lambda la, v: jw.windowed_gather(la, v, axis_name=ax),
                      (sh,), P(None, ax), xd),
        "scatter": run(lambda la, r: jw.windowed_scatter(la, r, axis_name=ax),
                       (P(None, ax),), sh, jnp.asarray(R)),
    }
    for i, o in ranks.BLOCKS:
        sub = jw.slice_block(jlay, jnp.asarray(A), i, o)
        xi = np.concatenate([ranks.segment(c, jdl, i) for c in np.split(np.asarray(xd), n)])
        out[f"block {i}->{o}"] = run(
            lambda la, a, v, i=i, o=o: jw.windowed_matvec_block(
                la, a, v, in_spaces=i, out_spaces=o, axis_name=ax),
            (P(None, None, ax), sh), sh, sub, jnp.asarray(xi))
    return out


def _close(got, want, rel=1e-12):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    scale = max(np.abs(want).max(), 1e-300)
    assert np.abs(got - want).max() <= rel * scale, np.abs(got - want).max() / scale


@pytest.mark.parametrize("n", [2, 4])
def test_sharded_plain_kernels_match_jax(n, kernels_out):
    got = kernels_out(n)
    dofs, lay, A, x, R = ranks.kernel_problem(n)
    jlay = jw.build_windowed_layout(dofs.cell_vdofs, dofs.cell_pdofs, dofs.n_vs, dofs.n_ps, 2,
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


def test_exchange_volume_is_o_halo(kernels_out):
    vols = [g["volume"] for g in kernels_out(2)]
    for vol in vols:
        for refine, v in vol.items():
            assert v["all_reduces"] == 0, (refine, v)  # a product sums no dot
            assert v["sends"] and max(v["sends"]) <= v["edge"], (refine, v)
            assert v["floats"] == sum(v["sends"])
    small, big = vols[0][6], vols[0][12]
    assert big["n_total"] >= 3 * small["n_total"]  # the problem really grew
    assert big["floats"] / big["llen"] < small["floats"] / small["llen"]
    assert big["floats"] < big["llen"] // 2


# ---- whole solves -------------------------------------------------------------


def _jconfig(precond, T=0.1, **krylov):
    cfg = JConfig(inlet_tags=(0,), neumann_tags=(1,), wall_tags=(2, 3),
                  nu=0.04, p_out=10.0, dt=0.05, T=T)
    cfg.krylov.max_iters = 500
    cfg.krylov.matvec = "windowed"
    cfg.krylov.cells_per_block = 16
    cfg.krylov.preconditioner = precond
    for k, v in krylov.items():
        setattr(cfg.krylov, k, v)
    return cfg


def _jsteady_config():
    cfg = JConfig(inlet_tags=(0,), neumann_tags=(1,), wall_tags=(2, 3), nu=0.1, p_out=0.0)
    cfg.convection_form = "standard"
    cfg.include_continuity_residual = True
    cfg.jacobian_mass_rho = True
    cfg.krylov.matvec = "windowed"
    cfg.krylov.cells_per_block = 16
    cfg.krylov.preconditioner = "cahouet_chabard"
    cfg.krylov.rel_tol = 1e-8
    cfg.krylov.max_iters = 800
    return cfg


def _jax_case(name):
    """The JAX package's 2-device run of the case."""
    log = JLog(verbose=False)
    kw = dict(log=log, n_devices=2)
    if name == "stokes":
        cfg = JConfig(inlet_tags=(0,), neumann_tags=(1,), wall_tags=(2, 3), nu=0.04, rho=1.0,
                      p_out=10.0)
        cfg.krylov.matvec = "windowed"
        cfg.krylov.cells_per_block = 16
        cfg.krylov.preconditioner = "block_triangular"
        cfg.krylov.max_iters = 4000
        s = JStokes(j_unit_square(4), cfg, inlet=ranks.poiseuille_inlet, **kw)
        s.solve()
        return s, None, log
    if name == "steady":
        s = JSolver(j_unit_square(4), _jsteady_config(), inlet=ranks.steady_inflow, **kw)
        s.solve_steady(tol=1e-12, max_iters=12)
        return s, None, log
    if name == "scanned":
        cfg = _jconfig("cahouet_chabard", T=0.2)
        cfg.time_scheme = "bdf2"
        s = JSolver(j_unit_square(4), cfg, **kw)
        out = s.solve_scanned(functional=lambda u: jnp.stack([jnp.linalg.norm(u), u.sum()]),
                              newton_iters=3, chunk=2)
        return s, out, log
    if name == "forcing":
        cfg = _jconfig("cahouet_chabard", T=0.15)
        cfg.initial_guess = "stokes"
        s = JSolver(j_unit_square(4), cfg, forcing=ranks.forcing_xt, **kw)
    elif name == "cc_coarse":
        s = JSolver(j_unit_square(4), _jconfig("cahouet_chabard", cc_coarse_agg=128), **kw)
    else:
        s = JSolver(j_unit_square(4), _jconfig("block_triangular"), **kw)
    s.solve()
    return s, None, log


def _same_nodes(got, want, tol=1e-10):
    assert got.keys() == want.keys()
    err = max(np.abs(got[k] - want[k]).max() for k in want)
    assert err < tol, err
    assert max(np.abs(v).max() for v in want.values()) > 1e-3  # a non-trivial flow


def _same_log(got, want, rel=1e-10):
    assert [e for e, _ in got] == [e for e, _ in want]
    for (e, g), (_, w) in zip(got, want):
        if e == "gmres":
            assert g == w
        else:
            assert abs(g - w) <= rel * abs(w) + 1e-300, (g, w)


@pytest.mark.parametrize("name", ["block_triangular", "cc_coarse", "steady", "forcing", "stokes"])
def test_sharded_solve_matches_jax(name, solves_out):
    got = solves_out[1][name]
    js, _, jlog = _jax_case(name)
    coords = (js.dofs.v_coords[js.dofs.v_mask] if name == "stokes"
              else js.velocity_coords(real_only=True))
    want = {tuple(np.round(c, 10)): v for c, v in zip(coords, js.velocity(real_only=True))}
    _same_nodes(got["nodes"], want)
    _same_log(got["log"], ranks.trajectory(jlog))
    assert sum(e == "gmres" for e, _ in got["log"]) >= (1 if name == "stokes" else 2)
    if name == "stokes":  # and Poiseuille flow, exact in P2/P1
        y = np.array([c[1] for c in got["nodes"]])
        u = np.array([v[0] for v in got["nodes"].values()])
        np.testing.assert_allclose(u, y * (1 - y), atol=3e-5)
    if name == "cc_coarse":
        assert js._wassembly.coarse_inv is not None  # the coarse correction ran
    if name == "block_triangular":  # and against the port on one device
        single = ranks.run_case(name, None)
        _same_nodes(got["nodes"], single["nodes"])
        _same_log(got["log"], single["log"])
        np.testing.assert_array_equal(got["cell_owner"], np.asarray(js.cell_owner))
    if name == "forcing":
        stokes = [r["iters"] for r in jlog.records
                  if r.get("event") == "gmres" and r.get("system") == "stokes"]
        assert stokes == [got["stokes_iters"]]


def test_sharded_scanned_matches_jax(solves_out):
    got = solves_out[1]["scanned"]
    js, jout, _ = _jax_case("scanned")
    want = {tuple(np.round(c, 10)): v for c, v in
            zip(js.velocity_coords(real_only=True), js.velocity(real_only=True))}
    _same_nodes(got["nodes"], want)
    np.testing.assert_allclose(got["functional"], np.asarray(jout["functional"]), rtol=1e-10)
    np.testing.assert_array_equal(got["iters"], np.asarray(jout["gmres_iters"]))


def test_sharded_partitioning_output_and_checkpoint(solves_out):
    """Rank 0 writes the XDMF/HDF5 files; their per-cell partitioning is the
    real owner rank (cpp:702-705), both ranks owning about half the cells.
    Rank 0 writes the checkpoint of the gathered planar state, and every
    rank of a new solver restores its own chunk of it bit for bit."""
    import h5py

    out, res = solves_out
    bt = res["block_triangular"]
    assert bt["restored"]
    with h5py.File(out / "checkpoint.h5", "r") as f:
        np.testing.assert_array_equal(f["solution"][:], bt["planar"])
    owner = bt["cell_owner"]
    assert set(np.unique(owner)) == {0, 1} and 0.25 < np.mean(owner == 0) < 0.75
    files = sorted(p.name for p in (out / "xdmf").iterdir())
    assert files == ["output-0000.h5", "output-0000.xdmf", "output-0001.h5",
                     "output-0001.xdmf", "output-0002.h5", "output-0002.xdmf"]
    with h5py.File(out / "xdmf" / "output-0001.h5", "r") as f:
        np.testing.assert_array_equal(np.asarray(f["partitioning"]).ravel(),
                                      owner.astype(np.float64))


@pytest.mark.parametrize("n", [2, 4])
def test_initialize_distributed_joins_from_torchrun_env(n, kernels_out):
    """Each spawned rank joined through initialize_distributed with only
    RANK / WORLD_SIZE / LOCAL_RANK set (and a file:// store): the group it
    sees, a second call that joins nothing new, and shutdown_distributed
    leaving the group."""
    for rank, res in enumerate(kernels_out(n)):
        assert res["joined"] == dict(first=True, again=True, index=rank, count=n,
                                     coordinator=rank == 0, backend="gloo", left=True)


def test_initialize_distributed_single_process_is_noop(monkeypatch):
    for var in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    assert bootstrap.initialize_distributed() is False
    assert not torch.distributed.is_initialized()
    assert bootstrap.process_index() == 0 and bootstrap.process_count() == 1
    assert bootstrap.is_coordinator()
    assert bootstrap.local_device("cpu") == torch.device("cpu")
    bootstrap.shutdown_distributed()  # nothing to leave
    # the port's maps are pure permutations at any rank count
    dofs, lay, _, x, _ = ranks.kernel_problem(4)
    dl = ws.make_dist_layout(lay, 4)
    np.testing.assert_array_equal(ws.from_dist(ws.to_dist(x, dl), dl), x)
