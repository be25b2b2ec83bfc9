"""The port's flat multi-device design against the JAX package's, in float64
on the CPU (the counterparts of tests/test_sharding.py).

The flat operator splits Morton-ordered cells over the ranks and
replicates the vectors (parallel/spmd.py): every assembly and operator
product is all-reduced, dots are not.  The port's ranks are spawned
processes in a gloo group (tests/torch_spmd_ranks.py); the JAX side runs
here, sharded over the virtual CPU devices conftest.py makes, while the
ranks run.  Each group of ranks is spawned once (module fixtures):

* ``morton_order`` equal to the original's, index for index;
* each rank's shard of the context (``shard_context``: padded cells with
  jxw 0, identity inverse Jacobians and dof 0; padded Neumann facets; the
  rank's own gather maps) equal to its shard of ``pad_and_shard_context``
  at 2 and 4;
* the sharded assembly at 2 and 4 ranks on rectangle(5, 3) (30 cells, 32
  padded at 4 ranks; 3 outlet facets, 4 padded) against JAX's
  ``shard_map`` at the same n, to 1e-12 of the largest entry: the
  residual, the tangent's action, its velocity block's, B's and the
  pressure mass's, the raw diagonal and the Stokes rhs;
* whole solves against JAX at the same device count (node by node to
  1e-10, equal FGMRES counts, Newton residuals to 1e-10): unit_square(3)
  at 2 ranks with no preconditioner (also within 1e-8 of the port on one
  device) and with block_triangular; ``solve_scanned`` with a functional
  and the boundary reaction; at 4 ranks a time-dependent forcing from the
  Stokes guess (block_triangular, unit_square(4)) and the fallback: the
  windowed operator asked for on unit_square(2), where no layout fits 4
  ranks (1 block a rank < halo 2), takes the flat design as JAX does;
* ``cell_owner`` (the Morton chunks) equal to JAX's, and every rank's
  replicated solution bit-equal to rank 0's;
* the fallback from the Stokes guess: the guess is the flat Stokes solve
  in the flat numbering, the run bit-equal to the one asked flat (JAX's
  fallback solves its guess on one device's windowed layout, in another
  numbering, and is not run here: ROADMAP.md Queue 3).
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
from navier_stokes_tpu.fem import assembly as ja
from navier_stokes_tpu.fem.dofs import make_dofs as j_make_dofs
from navier_stokes_tpu.la import operators as jops
from navier_stokes_tpu.la.preconditioners import rect_matvec as j_rect_matvec
from navier_stokes_tpu.mesh.generate import box as j_box
from navier_stokes_tpu.mesh.generate import rectangle as j_rectangle
from navier_stokes_tpu.mesh.generate import unit_square as j_unit_square
from navier_stokes_tpu.models.navier_stokes import NavierStokesSolver as JSolver
from navier_stokes_tpu.parallel import spmd as jspmd
from navier_stokes_tpu.utils.logging import RunLog as JLog
from navier_stokes_tpu_torch.fem.assembly import build_context
from navier_stokes_tpu_torch.fem.dofs import make_dofs
from navier_stokes_tpu_torch.mesh.generate import box, rectangle
from navier_stokes_tpu_torch.parallel import spmd
from test_torch_spmd import _close, _same_log

SOLVES = {2: ("identity", "block_triangular", "scanned"), 4: ("fallback", "forcing")}
# cases the ranks run and JAX does not: its flat fallback's Stokes guess is a
# single-device windowed solve, in another DoF numbering (ROADMAP.md Queue 3)
PORT_ONLY = {4: ("fallback_stokes", "flat_stokes")}


def _load(path):
    return torch.load(path, weights_only=False)


def _centroids(m):
    return m.coords[m.cells].mean(axis=1)


# ---- Morton order and the shards --------------------------------------------


@pytest.mark.parametrize("mesh", ["channel", "box"])
def test_morton_order_matches_jax(mesh):
    tm, jm = ((rectangle(40, 20, 0, 7, 0, 4), j_rectangle(40, 20, 0, 7, 0, 4)) if mesh == "channel"
              else (box(4, 3, 5), j_box(4, 3, 5)))
    np.testing.assert_array_equal(tm.coords, jm.coords)
    got = spmd.morton_order(_centroids(tm))
    np.testing.assert_array_equal(got, jspmd.morton_order(_centroids(jm)))
    assert sorted(got) == list(range(tm.n_cells))


def _jax_context(n):
    m = j_rectangle(5, 3)
    ctx = ja.build_context(j_make_dofs(m), neumann_tags=(1,), forcing=ranks.flat_forcing)
    dm = jspmd.device_mesh(n)
    return ctx, dm, jspmd.pad_and_shard_context(ctx, dm,
                                                cell_order=jspmd.morton_order(_centroids(m)))


@pytest.mark.parametrize("n", [2, 4])
def test_shard_context_matches_jax(n):
    m = ranks.flat_assembly_mesh()
    ctx = build_context(make_dofs(m), neumann_tags=(1,), forcing=ranks.flat_forcing,
                        dtype=torch.float64)
    order = spmd.morton_order(_centroids(m))
    _, _, jctx = _jax_context(n)
    nc_pad, nf_pad = jctx.cell_dofs.shape[0], jctx.neu_jxw.shape[0]
    assert (nc_pad, nf_pad) == ((30, 4) if n == 2 else (32, 4))
    for rank in range(n):
        sc = spmd.shard_context(ctx, rank, n, order, "cpu")
        per, fper = nc_pad // n, nf_pad // n
        for name in ("invJT", "jxw", "cell_vdofs", "cell_dofs", "f_q"):
            np.testing.assert_array_equal(getattr(sc, name).numpy(),
                                          np.asarray(getattr(jctx, name))[rank * per:][:per])
        for name in ("neu_cell_vdofs", "neu_N_v", "neu_normal", "neu_jxw"):
            np.testing.assert_array_equal(getattr(sc, name).numpy(),
                                          np.asarray(getattr(jctx, name))[rank * fper:][:fper])
        for name, rows in (("scatter_full", ctx.n_total), ("scatter_vel", ctx.n_u),
                           ("scatter_p", ctx.n_total - ctx.n_u)):
            want = np.asarray(getattr(jctx, name))[rank * rows:][:rows]
            got = getattr(sc, name).numpy()
            sentinel = per * sc.cell_dofs.shape[1] if name == "scatter_full" else (
                per * sc.dim * sc.nb_v if name == "scatter_vel" else per * sc.nb_p)
            assert got.shape[0] == rows and got.shape[1] <= want.shape[1]
            got = np.pad(got, ((0, 0), (0, want.shape[1] - got.shape[1])),
                         constant_values=sentinel)
            np.testing.assert_array_equal(got, want)
        for name in ("N_v", "G_v", "N_p"):
            np.testing.assert_array_equal(getattr(sc, name).numpy(), getattr(ctx, name).numpy())
    # every padded cell adds nothing and keeps a finite geometry
    last = spmd.shard_context(ctx, n - 1, n, order, "cpu")
    pad = nc_pad - m.n_cells
    if pad:
        assert float(last.jxw[-pad:].abs().max()) == 0 and int(last.cell_dofs[-pad:].max()) == 0
        np.testing.assert_array_equal(last.invJT[-pad:].numpy(), np.broadcast_to(np.eye(2),
                                                                                  (pad, 2, 2)))


# ---- the sharded assembly ----------------------------------------------------


@functools.lru_cache(maxsize=None)
def _assembly_out(n, out):
    ranks.spawn(ranks.flat_assembly, n, f"file://{out}/store", out)
    return [_load(f"{out}/flat_assembly{n}_{r}.pt") for r in range(n)]


def _jax_assembly(n):
    ctx, dm, sctx = _jax_context(n)
    dim, nb_v, nb_p = ctx.dim, ctx.nb_v, ctx.nb_p
    nvl, n_u, n_total = dim * nb_v, ctx.n_u, ctx.n_total
    n_p = n_total - n_u
    ax = jspmd.AXIS

    def body(c, u, uo, w):
        cell_mat, cell_pmass, res = ja.assemble_navier_stokes(c, u, uo, **ranks.FLAT_FORM)
        op = jops.ElementOperator(cell_mat=cell_mat, cell_dofs=c.cell_dofs,
                                  bc_rows=jnp.zeros(0, jnp.int32), bc_diag=jnp.zeros(0),
                                  scatter_idx=c.scatter_full, n=n_total, axis_name=ax)
        A00 = jops.velocity_block(op, dim, nb_v, n_u, bc_mask=np.zeros(0, bool),
                                  scatter_idx=c.scatter_vel)
        cell_pdofs = jnp.maximum(c.cell_dofs[:, -nb_p:] - n_u, 0)
        Mp = jops.pressure_mass_block(cell_pmass, cell_pdofs, n_p, axis_name=ax,
                                      scatter_idx=c.scatter_p)
        return dict(
            residual=res, jw=jops.matvec(op, w), a00w=jops.matvec(A00, w[:n_u]),
            bw=j_rect_matvec(cell_mat[:, nvl:, :nvl], c.cell_dofs[:, :nvl], cell_pdofs, n_p,
                             w[:n_u], axis_name=ax, scatter_idx=c.scatter_p),
            mpw=jops.matvec(Mp, w[n_u:]),
            diag=jops.raw_diagonal(cell_mat, c.cell_dofs, n_total, ax, c.scatter_full),
            stokes_rhs=ja.assemble_stokes(c, nu=0.04, rho=1.0, p_out=10.0)[2])

    keys = ("residual", "jw", "a00w", "bw", "mpw", "diag", "stokes_rhs")
    fn = jspmd.shard_map(lambda *a: tuple(body(*a)[k] for k in keys), dm,
                         in_specs=(jspmd.context_pspecs(sctx), P(), P(), P()),
                         out_specs=tuple(P() for _ in keys))
    u, uo, w = (jnp.asarray(a) for a in ranks.flat_assembly_inputs(n_total))
    return dict(zip(keys, (np.asarray(a) for a in jax.jit(fn)(sctx, u, uo, w))))


@pytest.mark.parametrize("n", [2, 4])
def test_sharded_flat_assembly_matches_jax(n, tmp_path_factory):
    got = _assembly_out(n, str(tmp_path_factory.mktemp(f"flat_assembly{n}")))
    want = _jax_assembly(n)
    for key, w in want.items():
        for rank, g in enumerate(got):
            _close(g[key], w)
            # replicated: every rank holds the same sum, bit for bit
            np.testing.assert_array_equal(g[key], got[0][key])
        assert np.abs(w).max() > 1e-3, key


# ---- whole solves --------------------------------------------------------------


def _jax_flat_case(name, n):
    """The JAX package's n-device run of the named case: (solver, log,
    scanned output or None)."""
    (refine,), ckw, skw = ranks.FLAT_CASES[name]
    cfg = ranks.flat_config(cls=JConfig, **ckw)
    if name == "forcing":
        cfg.newton.min_iters = 1
    log = JLog(verbose=False)
    s = JSolver(j_unit_square(refine), cfg, log=log, n_devices=n, **skw)
    out = None
    if name == "scanned":
        out = s.solve_scanned(functional=lambda u: jnp.stack([jnp.linalg.norm(u), u.sum()]),
                              newton_iters=3, chunk=2, reaction_tags=(2,))
    else:
        s.solve()
    return s, log, out


@pytest.fixture(scope="module")
def flat_solves(tmp_path_factory):
    """{n: (each rank's results, {name: JAX's n-device run})}: the port's
    ranks and JAX's runs made at the same time."""
    res = {}
    for n, names in SOLVES.items():
        out = tmp_path_factory.mktemp(f"flat_solves{n}")
        ctx = ranks.start(ranks.flat_solves, n, f"file://{out}/store", str(out),
                          names + PORT_ONLY.get(n, ()))
        try:
            jax_runs = {name: _jax_flat_case(name, n) for name in names}
        finally:
            ranks.wait(ctx, f"flat_solves on {n} ranks")
        res[n] = ([_load(out / f"flat_solves{n}_{r}.pt") for r in range(n)], jax_runs)
    return res


def _case(flat_solves, name):
    n = next(n for n, names in SOLVES.items() if name in names)
    got, jax_runs = flat_solves[n]
    return n, [g[name] for g in got], jax_runs[name]


@pytest.mark.parametrize("name", ["identity", "block_triangular", "fallback", "forcing"])
def test_flat_solve_matches_jax(name, flat_solves):
    n, got, (js, jlog, _) = _case(flat_solves, name)
    g = got[0]
    assert g["matvec"] == js._matvec == "flat" and js._dist is None
    assert g["n_cells"] == spmd.padded_count(js.mesh.n_cells, n) // n
    want = np.asarray(js.solution)
    _close(g["solution"], want, rel=1e-10)
    _same_log(g["log"], ranks.trajectory(jlog))
    assert sum(e == "gmres" for e, _ in g["log"]) >= 2
    if name == "identity":  # and the port on one device, to 1e-8
        one = ranks.run_flat_case(name, None)
        np.testing.assert_allclose(g["solution"], one["solution"], rtol=0, atol=1e-8)
        _same_log(g["log"], one["log"])
    if name == "fallback":  # the windowed layout was asked for and did not fit
        assert js.cfg.krylov.matvec == "windowed"
    if name == "forcing":  # the Stokes guess's count leads the compared log
        assert js._forcing_time_dep
        assert any(r.get("system") == "stokes" for r in jlog.records)


def test_flat_scanned_matches_jax(flat_solves):
    n, got, (js, _, jout) = _case(flat_solves, "scanned")
    g = got[0]
    _close(g["solution"], np.asarray(js.solution), rel=1e-10)
    np.testing.assert_allclose(g["functional"], np.asarray(jout["functional"]), rtol=1e-10)
    np.testing.assert_allclose(g["reaction"], np.asarray(jout["reaction"]), rtol=1e-9,
                               atol=1e-10 * np.abs(jout["reaction"]).max())
    np.testing.assert_array_equal(g["iters"], np.asarray(jout["gmres_iters"]))
    np.testing.assert_allclose(g["residual"], np.asarray(jout["residual"]), rtol=1e-10)


@pytest.mark.parametrize("n", [2, 4])
def test_flat_ranks_bit_equal_and_owners_match_jax(n, flat_solves):
    """Every rank's replicated state is rank 0's, bit for bit, after every
    case; the per-cell owner is JAX's (contiguous Morton chunks), every
    rank owning cells."""
    got, jax_runs = flat_solves[n]
    for name, (js, _, _) in jax_runs.items():
        for g in got[1:]:
            np.testing.assert_array_equal(g[name]["solution"], got[0][name]["solution"])
        owner = got[0][name]["cell_owner"]
        np.testing.assert_array_equal(owner, np.asarray(js.cell_owner))
        assert set(np.unique(owner)) == set(range(n))


def test_flat_fallback_stokes_guess_is_the_flat_one(flat_solves):
    """The windowed operator asked for where no layout fits 4 ranks, with the
    Stokes guess: the guess is the flat Stokes solve in the flat DoF
    numbering, and the run is the one asked flat, bit for bit."""
    got = flat_solves[4][0]
    for g in got:
        fb, flat = g["fallback_stokes"], g["flat_stokes"]
        assert fb["matvec"] == flat["matvec"] == "flat"
        np.testing.assert_array_equal(fb["solution"], flat["solution"])
        assert fb["log"] == flat["log"]
    # the Stokes guess's solve leads the log, before any Newton record
    assert got[0]["fallback_stokes"]["log"][0][0] == "gmres"
