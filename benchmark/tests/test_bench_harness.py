"""The harness on the CPU: the command line, the files it finds by name, a
cell added by files alone, the import check, and a run driven with the
timed path broken underneath (``correct`` must come out false)."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from benchmark import harness as H
from benchmark.tests.tiny import tiny

ROOT = Path(__file__).resolve().parents[2]
SPEC = H.load_json(ROOT / "BENCHMARK.json")
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def run_tiny(workload, trace=False, seed=2**31 + 7):
    _, cfg, traffic = H.cell(SPEC, workload)
    cfg, traffic = tiny(cfg, traffic)
    return H.run_cell(SPEC, workload, seed, 0.0, trace, "cpu", cfg=cfg, traffic=traffic)


def test_command_refuses_without_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal is for machines without one")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", "dfg3d2z-re100",
                        "--seed", str(2**31 + 3), "--seconds", "10", "--trace", "0"],
                       cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert p.returncode == 2 and p.stdout == "" and "CUDA" in p.stderr


def test_command_needs_its_arguments():
    p = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", "dfg3d2z-re100"],
                       cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout == ""


def test_every_file_loads():
    names = {"configs": set(), "traffic": set()}
    for w in SPEC["workloads"]:
        _, cfg, traffic = H.cell(SPEC, w["name"])
        assert set(cfg) >= {"source", "geometry", "physics", "mesh", "solver", "assumed",
                            "reduced"} and len(cfg["source"]) <= 200
        assert {"dt", "scheme", "start", "law", "steps", "perturbation"} <= set(traffic)
        assert callable(H.Inflow(cfg, traffic).shape) and callable(H.Inflow(cfg, traffic).law)
        assert callable(H.start_kind(traffic).make)
        names["configs"].add(w["config"])
        names["traffic"].add(w["traffic"])
    assert names["configs"] == {c["name"] for c in SPEC["configs"]}
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert callable(H.load_module(ROOT / "benchmark" / "metrics" / f"{m['name']}.py").read)
    for c in SPEC["configs"]:
        assert H.load_json(ROOT / c["file"])["source"] == c["source"]


def test_import_check_compares_whole_names(monkeypatch):
    for name in ("navier_stokes_tpu_torch.models", "jaxtyping", "flaxen"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert H.forbidden_modules() == [] or "jax" in sys.modules
    monkeypatch.setitem(sys.modules, "navier_stokes_tpu.fem", sys)
    monkeypatch.setitem(sys.modules, "jax", sys)
    assert {"navier_stokes_tpu", "jax"} <= set(H.forbidden_modules())


def test_added_cell_needs_only_new_files(tmp_path):
    """A configuration with an inflow profile of its own, a traffic mix with
    its own time law and start state (judged by a check of its own), a
    metric and a cell dropped into a copy: found by name and run, with no
    file of the copy edited."""
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copytree(ROOT / "navier_stokes_tpu_torch", tmp_path / "navier_stokes_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in (tmp_path / "benchmark").rglob("*") if p.is_file()}
    b = tmp_path / "benchmark"
    ramp, cfg, traffic = H.cell(SPEC, "dfg2d3-ramp")
    cfg, traffic = tiny(cfg, traffic)
    cfg["physics"]["profile"] = "half2d"
    (b / "configs" / "dfg2d-tiny.json").write_text(json.dumps(cfg))
    (b / "profiles" / "half2d.py").write_text(
        "import numpy as np\n\ndef shape(x, geometry):\n    v = np.zeros_like(x)\n"
        "    v[:, 0] = 2 * x[:, 1] * (geometry['H'] - x[:, 1]) / geometry['H'] ** 2\n"
        "    return v\n")
    (b / "laws" / "linear.py").write_text("def amplitude(t, traffic):\n    return t / 8\n")
    (b / "starts" / "still.py").write_text(
        "import torch\n\ndef make(solver, traffic):\n    return torch.zeros_like(solver.solution)"
        "\n\ndef check(judge, state):\n    return float(abs(state[0]).max())\n")
    (b / "traffic" / "ramp-short.json").write_text(
        json.dumps(dict(traffic, steps=1, law="linear", start="still")))
    (b / "metrics" / "loop.steps_run.py").write_text("def read(run):\n    return run['steps']\n")
    (b / "limits" / "tiny-ramp.json").write_text(json.dumps({"residual": 1e-3, "still": 0.0}))
    spec = dict(SPEC, configs=SPEC["configs"] + [dict(SPEC["configs"][0], name="dfg2d-tiny")],
                workloads=SPEC["workloads"] + [dict(ramp, name="tiny-ramp",
                                                    config="dfg2d-tiny", traffic="ramp-short")],
                end_to_end=SPEC["end_to_end"] + [dict(
                    name="loop.steps_run", unit="steps", better="higher", bound=0.25,
                    source="host_clock", workloads=["tiny-ramp"])])
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    code = ("import json, torch; torch.set_num_threads(2); from benchmark import harness as H;"
            "r, _ = H.run_cell(H.load_json('BENCHMARK.json'), 'tiny-ramp', 11, 0.0, False, 'cpu');"
            "print(json.dumps(r))")
    p = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                       text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    r = json.loads(p.stdout.strip().splitlines()[-1])
    assert r["attempted"] == 1 and r["metrics"]["loop.steps_run"]["value"] == 1
    assert r["checks"]["still"] == {"value": 0.0, "limit": 0.0} and r["correct"], r
    for path, data in before.items():
        assert path.read_bytes() == data, path


@pytest.fixture(scope="module")
def sound():
    return run_tiny("dfg3d2z-re100", trace=True)


def test_result_keys_and_checks_last(sound):
    result, diag = sound
    assert list(result)[: len(KEYS)] == KEYS and list(result)[-1] == "checks"
    assert result["correct"] and result["failed"] == 0 and result["attempted"] >= 2
    per_layer = {m["name"] for m in H.metrics_of(SPEC, "dfg3d2z-re100", "per_layer")}
    # on the CPU the counters and spans read; the device trace finds no kernels
    assert set(result["metrics"]) <= per_layer
    assert {"loop.newton_iters_per_step", "krylov.tangent_solve_ms",
            "assembly.assemble_ms"} <= set(result["metrics"])
    assert set(result["checks"]) == {"residual", "stokes"}
    json.dumps(result)


def test_byte_tally_gap_is_loud(monkeypatch):
    """A windowed product that the wrappers count but the byte tally does
    not see stops the traced run instead of leaving its bytes out."""
    from navier_stokes_tpu_torch.ops import windowed as ow

    counts = ow.launch_counts
    monkeypatch.setattr(ow, "launch_counts",
                        lambda: dict(counts(), **{"K1 windowed_matvec": 1}))
    with pytest.raises(RuntimeError, match="byte tally"):
        run_tiny("dfg2d3-ramp", trace=True)


def _broken(monkeypatch, fault):
    from navier_stokes_tpu_torch.models import navier_stokes as nsm

    solve_newton = nsm.NavierStokesSolver.solve_newton

    def broken(self):
        if fault == "unchanged":  # the step returns its state as it came
            return 0, 0.0
        out = solve_newton(self)
        # the answer altered where it is made: every velocity 1 % of u_m more
        self.solution = self.solution + 0.01 * self.inlet.u_m * (
            torch.arange(self.solution.numel(), device=self.solution.device) < self.dofs.n_u
        ).to(self.solution.dtype)
        return out

    monkeypatch.setattr(nsm.NavierStokesSolver, "solve_newton", broken)


@pytest.mark.parametrize("fault", ["unchanged", "altered"])
@pytest.mark.parametrize("workload", ["dfg3d2z-re100", "dfg2d3-ramp"])
def test_broken_step_is_not_correct(monkeypatch, fault, workload):
    _broken(monkeypatch, fault)
    result, _ = run_tiny(workload)
    assert not result["correct"], result["checks"]
