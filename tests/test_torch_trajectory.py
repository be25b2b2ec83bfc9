"""The port's float32 trajectory check (``scripts/trajectory_parity.py``
of the port) against the JAX package, in float64 on the CPU.

* A run of the dynamic case on ``rectangle(20, 10, 0, 7, 0, 4)`` (200
  cells), 2 BDF1 steps in float64: the port's script gives the Newton rows
  of the JAX solver built with the same configuration and inflow (the JAX
  script cannot open its mesh here) within 1e-9 relative (a floor row,
  float64 rounding after a 1e-9 tangent solve, within 1e-9 of its step's
  entry row), and its FGMRES counts exactly.
* ``compare`` on synthetic trajectories: the original protocol's digits
  (entry rows, dynamic rows, the floor rows' bound), a ValueError where the
  shapes differ, and ``--compare`` writing its JSON.
* Where a leg runs: float64 on the CPU, float32 on the card unless the
  caller names a device (without one a float32 leg raises); ``compare``
  names each leg's own dtype and device.
"""

import json

import numpy as np
import pytest
import torch

from navier_stokes_tpu.config import SolverConfig as JConfig
from navier_stokes_tpu.mesh.generate import rectangle as j_rectangle
from navier_stokes_tpu.models.navier_stokes import NavierStokesSolver as JSolver
from navier_stokes_tpu.utils.logging import RunLog as JLog
from navier_stokes_tpu_torch.scripts import trajectory_parity as tp

STEPS = 2


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Eager torch on small meshes runs fastest, and least disturbed by
    other processes, on one thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_run_matches_jax_newton_rows_and_fgmres_counts():
    got = tp.run("float64", "cpu", cells=200, steps=STEPS)
    jlog = JLog(verbose=False)
    cfg = tp.trajectory_config("float64", T=0.05 * STEPS, cls=JConfig)
    JSolver(tp.channel(200, j_rectangle), cfg, log=jlog, inlet=tp.inflow()).solve()
    jrows, jiters, jfloors = tp.rows_of(jlog.records)
    assert got["note"] == "completed" and got["tangent_floors"] == jfloors == []
    assert [(r["step"], r["iter"]) for r in got["trajectory"]] == [
        (r["step"], r["iter"]) for r in jrows]
    assert len(jrows) >= 2 * STEPS and {r["step"] for r in jrows} == {1, 2}
    # rows above the protocol's floor (FLOOR_REL of the largest) within 1e-9
    # relative; a floor row (~1e-11, the float64 residual's rounding after a
    # 1e-9 tangent solve) within 1e-9 of its step's entry row
    floor = tp.FLOOR_REL * max(r["residual"] for r in jrows)
    entry = {r["step"]: r["residual"] for r in jrows if r["iter"] == 0}
    for t, j in zip(got["trajectory"], jrows):
        scale = j["residual"] if j["residual"] > floor else entry[j["step"]]
        assert abs(t["residual"] - j["residual"]) <= 1e-9 * scale, (t, j)
    assert sum(r["residual"] > floor for r in jrows) >= STEPS
    assert got["fgmres_iters"] == jiters and len(jiters) >= STEPS


def _leg(residuals, floors=()):
    """A leg's dict: rows (step, iter) of 2 steps of 3 Newton rows."""
    rows = [{"step": 1 + i // 3, "iter": i % 3, "residual": r} for i, r in enumerate(residuals)]
    return {"config": "synthetic", "inlet": "dynamic", "trajectory": rows,
            "tangent_floors": list(floors)}


A = [1e-3, 1e-5, 1e-11, 5e-2, 2e-5, 3e-11]


def test_compare_reports_the_protocol_s_digits(tmp_path):
    b = [r * (1 + d) for r, d in zip(A, (2e-7, 1e-3, 0, -4e-7, 2e-2, 0))]
    b[2], b[5] = 5e-7, 4e-7  # float32's floor rows
    c = tp.compare(_leg(A), _leg(b, [{"step": 2, "iter": 1, "rel": 2e-6}]))
    assert c["identical_stopping_decisions"]
    assert c["entry_rows"] == 2 and np.isclose(c["max_rel_diff_entry"], 4e-7)
    assert c["agreement_digits_entry"] == round(-np.log10(4e-7), 2)
    assert c["dynamic_rows"] == 4 and np.isclose(c["max_rel_diff_dynamic"], 2e-2)
    assert c["floor_rows"] == 2 and c["floor_rows_within_bound"]
    assert np.isclose(c["f32_floor_bound"], tp.FLOOR_REL * 5e-2)
    assert len(c["f32_tangent_floors"]) == 1
    b[5] = 1e-4  # a floor row above the bound
    assert not tp.compare(_leg(A), _leg(b))["floor_rows_within_bound"]
    paths = [tmp_path / n for n in ("a.json", "b.json", "out.json")]
    for p, leg in zip(paths, (_leg(A), _leg(A))):
        p.write_text(json.dumps(leg))
    assert tp.main(["--compare", *map(str, paths)]) == 0
    assert json.loads(paths[2].read_text())["agreement_digits_entry"] == 16.0


def test_compare_raises_on_another_shape():
    short = _leg(A)
    short["trajectory"] = short["trajectory"][:5]  # step 2 stopped one row earlier
    with pytest.raises(ValueError, match="shapes differ"):
        tp.compare(_leg(A), short)
    other = _leg(A)
    other["trajectory"][3]["step"] = 1
    with pytest.raises(ValueError, match="first at row 3"):
        tp.compare(_leg(A), other)


def test_legs_run_where_the_protocol_puts_them(tmp_path):
    """float64, the oracle, on the CPU and float32 on the card, unless the
    caller names a device: without a card a float32 leg raises rather than
    run on the CPU, from ``run`` and from the CLI; ``compare``'s
    description names each leg's dtype and device as the leg states them."""
    assert tp.default_device("float64") == "cpu" and tp.default_device("float32") == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tp.run("float32", cells=200, steps=1)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tp.main(["run", str(tmp_path / "f32.json"), "--dtype", "float32"])
    a, b = _leg(A), _leg(A)
    a.update(dtype="float64", device="cpu")
    b.update(dtype="float32", device="cpu")
    assert "float64 on cpu against float32 on cpu," in tp.compare(a, b)["description"]
    assert "unstated" in tp.compare(_leg(A), _leg(A))["description"]
