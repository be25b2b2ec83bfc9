"""What each rank of a sharded run holds, in float64 on the CPU.

The port's counterpart of tests/test_capacity.py, whose cylinder mesh the
repo does not hold: 2 gloo ranks (tests/torch_spmd_ranks.py ``capacity``,
spawned once) set up a generated channel (rectangle(24, 8) of 7 x 4) and
box(4, 4, 4), each at 16 cells a block with the windowed operator and
Cahouet-Chabard, against one device at the ranks' numbering (nb_multiple
2), here:

* each large buffer of the solve state a rank holds (A_const, invJT_t, W_t,
  Kp_t, r_const, inv_mp, diag_kp, and the layout's tables) is at most a
  1/n share of one device's plus its frame's (2 * frame blocks of slots
  or rows; the owned vectors have no frame: exactly 1/n);
* on the box, each rank's compact tables are its owned blocks' chunk lists
  of one device's and its frame blocks have none, so the ranks' entries
  sum to one device's;
* the replicated leaves (tabulations, coarse inverses) are small: under
  5 % of a rank's share of the large buffers plus 4 MiB (the bound of
  tests/test_capacity.py);
* one sharded Newton step at a seeded state converges, finite, with one
  device's entry ||r|| (to 1e-12) and FGMRES count.
"""

import functools

import numpy as np
import pytest
import torch

import torch_spmd_ranks as ranks

N = 2
MESHES = ["channel", "box"]


@pytest.fixture(scope="module")
def held(tmp_path_factory):
    out = tmp_path_factory.mktemp("capacity")
    ranks.spawn(ranks.capacity, N, f"file://{out}/store", str(out))
    return [torch.load(out / f"capacity_{r}.pt", weights_only=False) for r in range(N)]


@functools.lru_cache(maxsize=None)
def _one_device(mesh):
    """One device's run, on one thread as each rank's (many small torch
    calls: more threads only contend with the other test workers)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        s = ranks.capacity_solver(mesh, None, nb_multiple=N)
        return s, ranks.held_bytes(s), ranks.newton_step(s)
    finally:
        torch.set_num_threads(threads)


@pytest.mark.parametrize("mesh", MESHES)
def test_large_buffers_hold_a_share_plus_the_frame(mesh, held):
    s, one, _ = _one_device(mesh)
    nb = s._win_layout.nb
    for res in held:
        got = res[mesh]
        assert got["nb"] == nb and got["nb_loc"] == nb // N and got["frame"] > 0
        frame_blocks = 2 * got["frame"]
        for name, total in one["big"].items():
            share = got["big"][name]
            if name in ("r_const", "inv_mp", "diag_kp"):  # owned rows only
                assert share * N == total, name
            else:  # blocks of slots or rows: the owned ones and the frame's
                assert share == total // nb * (nb // N + frame_blocks), name
                assert share <= total / N + total / nb * frame_blocks, name
    assert sum(res[mesh]["n_state"] for res in held) == s._n_state


def test_box_compact_tables_are_the_owned_blocks_lists(held):
    s, one, _ = _one_device("box")
    lay = s._win_layout
    nch = lay.nchunks
    for key in ("v", "p"):
        g_counts = np.diff(one["compact"][key]["off"])  # entries a chunk, one device
        total = 0
        for r, res in enumerate(held):
            got = res["box"]
            counts = np.diff(got["compact"][key]["off"])
            F, nb_loc = got["frame"], got["nb_loc"]
            assert not counts[: F * nch].any() and not counts[(F + nb_loc) * nch :].any()
            np.testing.assert_array_equal(counts[F * nch : (F + nb_loc) * nch],
                                          g_counts[r * nb_loc * nch : (r + 1) * nb_loc * nch])
            total += got["compact"][key]["E"]
        assert total == one["compact"][key]["E"]


@pytest.mark.parametrize("mesh", MESHES)
def test_replicated_leaves_are_small(mesh, held):
    for res in held:
        got = res[mesh]
        share = sum(got["big"].values())
        assert 0 < got["replicated"] < 0.05 * share + 2**22, (got["replicated"], share)


@pytest.mark.parametrize("mesh", MESHES)
def test_sharded_newton_step_converges(mesh, held):
    _, _, want = _one_device(mesh)
    for res in held:
        step = res[mesh]["step"]
        assert step["finite"] and step["converged"] and step["iters"] > 0
        assert step["iters"] == want["iters"]
        assert abs(step["entry"] - want["entry"]) <= 1e-12 * want["entry"]
