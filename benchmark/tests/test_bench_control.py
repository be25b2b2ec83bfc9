"""The control of ``correct`` on the card: the program's answer carried in
bfloat16 (each step's state and the Stokes start rounded where they are
produced) fails the cell's checks on three seeds, the start's check among
them, where the sound program passes them, on the 3D const-inflow cell
with half its layers in z (the size a test run holds).  Skips without a
card."""

import copy

import pytest

from benchmark import harness as H
from benchmark.readings import read_seeds

pytestmark = pytest.mark.card


def test_bf16_control_fails_where_sound_runs_pass(card):
    spec = H.load_json(H.HERE.parent / "BENCHMARK.json")
    _, cfg, traffic = H.cell(spec, "dfg3d2z-re100")
    cfg = copy.deepcopy(cfg)
    cfg["mesh"]["n_z"] //= 2
    limits = H.load_json(H.HERE / "limits" / "dfg3d2z-re100.json")
    bench = H.setup(cfg, traffic, card)
    judge = H.Judge(cfg, bench.mesh, bench.inflow, H.program_points(bench), card)
    sound = read_seeds(bench, judge, [1, 2, 3], 0.0, "sound", limits)
    control = read_seeds(bench, judge, [4, 5, 6], 0.0, "bf16", limits)
    assert all(H.passed(r["checks"]) for r in sound)
    assert not any(H.passed(r["checks"]) for r in control)
    assert not any(H.passed({"stokes": r["checks"]["stokes"]}) for r in control)
