"""Readings for the limits of ``correct``: the checked numbers of sound runs
on many seeds and of the control on a few, in one process (one set-up).

    python3 -m benchmark.readings --workload <cell> --seeds 1,2,3 \
        [--control-seeds 4,5,6] [--seconds 0]

Each seed runs the window (``--seconds``; 0: one segment) from its own
perturbed start and is judged by the reference as a run is.  The control is
the program's answer carried in bfloat16, the nearest precision below the
float32 the configuration states: each time step's state is rounded to
bfloat16 where the step produces it, and the start state where set-up
produces it, as a program that kept its solution in bfloat16 would.  (TF32 matrix products change nothing here: the
program's contractions run as cuBLAS gemv and FFMA gemm kernels, which
TF32 does not touch, and its Newton loop checks its residual in float32.)
One JSON line a seed; the benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

import torch

from .harness import (Bench, Judge, bench_host, cell, checks, load_json, perturbed,
                      program_points, setup, states_for_check, window)


def bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(x.dtype)

ROOT = Path(__file__).resolve().parent.parent


@contextlib.contextmanager
def bf16_state(solver):
    """Within the block, every time step's state rounded to bfloat16."""
    solve_newton = solver.solve_newton

    def rounded():
        out = solve_newton()
        solver.solution = bf16(solver.solution)
        return out

    solver.solve_newton = rounded
    try:
        yield
    finally:
        del solver.solve_newton


def read_seeds(bench: Bench, judge: Judge, seeds, seconds: float, mode: str, limits: dict):
    """One line a seed: the checked numbers, the steps' Newton and FGMRES
    counts, the window's step time."""
    out = []
    for seed in seeds:
        start = perturbed(bench, seed)
        with bf16_state(bench.solver) if mode == "bf16" else contextlib.nullcontext():
            win = window(bench, start, seconds)
        jobs = states_for_check(bench, start, win, seed)
        start_state = bench_host(bench, bf16(bench.start) if mode == "bf16" else bench.start)
        ch = checks(judge, bench.traffic, jobs, start_state, limits)
        rec = {"seed": seed, "mode": mode, "checks": ch,
               "step_ms": win["wall_s"] / len(win["steps"]) * 1e3,
               "steps": [[r["k"], r["newton"], r["solves"], r["last_residual"]]
                         for r in win["steps"]]}
        print(json.dumps(rec), flush=True)
        out.append(rec)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="", help="seeds of the bfloat16 control")
    ap.add_argument("--seconds", type=float, default=0.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    spec = load_json(ROOT / "BENCHMARK.json")
    _, cfg, traffic = cell(spec, args.workload)
    lim_path = Path(__file__).resolve().parent / "limits" / f"{args.workload}.json"
    limits = load_json(lim_path) if lim_path.exists() else {}
    seeds = [int(s) for s in args.seeds.split(",") if s]
    control = [int(s) for s in args.control_seeds.split(",") if s]
    t0 = time.perf_counter()
    bench = setup(cfg, traffic, args.device)
    st = getattr(bench.solver, "stokes_result", None)
    print(json.dumps({"setup": bench.times, "s": time.perf_counter() - t0,
                      "stokes_fgmres": None if st is None else
                      {"iters": int(st.iters), "residual": float(st.residual),
                       "converged": bool(st.converged)}}), flush=True)
    judge = Judge(cfg, bench.mesh, bench.inflow, program_points(bench), args.device)
    read_seeds(bench, judge, seeds, args.seconds, "sound", limits)
    read_seeds(bench, judge, control, args.seconds, "bf16", limits)
    return 0


if __name__ == "__main__":
    sys.exit(main())
