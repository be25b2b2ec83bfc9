"""The 196,608-tet box's two BDF1 steps from rest under each sweep of A00
and each tangent store, on one GPU.

    python -m navier_stokes_tpu_torch.scripts.box_a00

Solves ``kernel_bench.box_config`` (chip_smoke.py phase 14's configuration)
from rest three times, each on a solver of its own: with bench.py's CG
sweeps of A00 and the tangent stored in bf16 (bench.py's 3D leg), with the
same CG sweeps and the tangent stored in float32 (does the store or the
sweep stall the tangent solve?), and with FGMRES sweeps and the bf16 store
(phase 14's setting).  For each it prints, per step, the Newton residuals,
the FGMRES counts and the tangent solves that missed ``rel_tol`` (their
final ||r||, against the step's Newton residual ||b||), and the host
seconds of the two steps; then one JSON line of it all.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import torch

from .kernel_bench import box_config, box_inlet, box_mesh

RUNS = (("cg", "bfloat16"), ("cg", "float32"), ("gmres", "bfloat16"))


def steps_from_rest(mesh, a00_solver, store):
    """Two BDF1 steps of box_config from rest with these A00 sweeps and
    this tangent store: host seconds and, per step, the Newton residuals,
    the FGMRES counts and the missed tangent solves' final ||r||."""
    import navier_stokes_tpu_torch as nt

    cfg = box_config()
    cfg.krylov.a00_solver, cfg.krylov.tangent_store_dtype = a00_solver, store
    log = nt.RunLog(verbose=False)
    solver = nt.NavierStokesSolver(mesh, cfg, log=log, inlet=box_inlet,
                                   device=torch.device("cuda:0"))
    solver.setup()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    solver.solve()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    steps = []
    for r in log.records:
        if r.get("event") == "time_step":
            steps.append(dict(step=r["step"], residuals=[], fgmres=[], missed=[]))
        elif steps and r.get("event") == "newton":
            steps[-1]["residuals"].append(r["residual"])
        elif steps and r.get("event") == "gmres":
            steps[-1]["fgmres"].append(r["iters"])
        elif steps and r.get("event") == "krylov_failure":
            steps[-1]["missed"].append(r["residual"])
    return dict(a00_solver=a00_solver, store=store, seconds=seconds, steps=steps)


def main():
    if not torch.cuda.is_available():
        print("box_a00: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"  {smi}", flush=True)
    mesh = box_mesh()
    runs = []
    for a00_solver, store in RUNS:
        run = steps_from_rest(mesh, a00_solver, store)
        runs.append(run)
        print(f"  A00 sweeps {a00_solver}, tangent {store}: {run['seconds']:.2f} s", flush=True)
        for s in run["steps"]:
            print(f"    step {s['step']}: ||r|| {['%.6e' % v for v in s['residuals']]}; "
                  f"FGMRES {s['fgmres']}; missed rel_tol at ||r|| {s['missed']}", flush=True)
        torch.cuda.empty_cache()
    print(json.dumps(dict(card=smi, cells=mesh.n_cells, runs=runs)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
