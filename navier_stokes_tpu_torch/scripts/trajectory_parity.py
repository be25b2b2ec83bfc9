"""The float32 Newton-trajectory check on a generated channel: the port's
counterpart of ``scripts/trajectory_parity.py``, with its protocol and its
JSON.

The Newton residuals that a run logs (``RunLog.newton_residual``, the
reference's ``Newton iteration k/N - ||r||`` lines) are held row by row
between a float64 run on the CPU (the oracle) and a float32 run on the card,
both with their linear-solver error removed: tangents solved to rel_tol 1e-9
(float64) and 1e-6 (float32), so each Newton iterate, and each logged
||r||, is set by the discretization.  The case is the original script's
dynamic one: BDF1, dt 0.05, T 1.0 (20 steps), the corrected formulation
(``convection_form="standard"``, the continuity residual, rho in the mass
term), a ramped parabolic inflow ``u_m * 4 y (4 - y) / 16 * sin(pi t / 8)``
(u_m 0.6) that keeps every step away from equilibrium, a neutral outlet
(``p_out`` 0), Newton to the absolute 3e-6 (at most 8 iterations), FGMRES(100)
with at most 3,000 iterations, windowed + Cahouet-Chabard with
``cc_coarse_agg`` 128.  The outer operator is stored in float32 in both
legs (``operator_dtype``): a bf16 operator sets a Newton floor of its own
(``--operator-dtype bfloat16`` runs one, a control that must fail).

The original runs on the reference's ``correct_mesh_yt.msh``, a mesh this
repository does not hold; this one on generated channels, ``rectangle(80, 40, 0, 7, 0, 4)`` (6,400 cells, the
default) or ``rectangle(160, 80, 0, 7, 0, 4)`` (``--cells 25600``), with the
inlet on tag 0, the outlet on tag 1 and walls on tags 2 and 3, y in [0, 4].

Where a float32 tangent solve stops short of its 1e-6 (a float32 floor),
its last ||r||/||b|| goes into the JSON's ``tangent_floors``: a finding,
not a reason to loosen a tolerance.

    python -m navier_stokes_tpu_torch.scripts.trajectory_parity run f64.json \\
        --dtype float64
    python -m navier_stokes_tpu_torch.scripts.trajectory_parity run f32.json \\
        --dtype float32
    python -m navier_stokes_tpu_torch.scripts.trajectory_parity --compare f64.json f32.json \\
        [out.json]

A float64 leg runs on the CPU (the oracle) and a float32 leg on the card,
unless ``--device`` names another.

``--compare`` raises where the two trajectories' shapes differ (other
Newton stopping decisions) and otherwise prints the entry rows' worst
relative difference and its digits, the dynamic rows' digits and whether
the floor rows lie within the float32 floor bound.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time

import numpy as np

__all__ = ["CELLS", "trajectory_config", "default_device", "inflow", "channel", "run", "compare",
           "main"]

CELLS = {6400: (80, 40), 25600: (160, 80), 1600: (40, 20), 200: (20, 10)}
U_M = 0.6
NEWTON_TOL = 3e-6
# the float32 residual-evaluation floor of the original protocol: rows of
# the float64 run below FLOOR_REL of the largest are floor rows
FLOOR_REL = 1e-4


def trajectory_config(dtype: str = "float64", T: float = 1.0, cls=None,
                      operator_dtype: str = "float32"):
    """The dynamic case's SolverConfig, float64 or float32 (``cls``: either
    package's SolverConfig, the port's by default; ``operator_dtype``: the
    outer operator's storage, bfloat16 only for a control)."""
    if cls is None:
        from ..config import SolverConfig as cls

    cfg = cls(inlet_tags=(0,), neumann_tags=(1,), wall_tags=(2, 3))
    cfg.dtype = dtype
    cfg.T, cfg.dt, cfg.time_scheme = T, 0.05, "bdf1"
    cfg.p_out = 0.0
    cfg.inlet.freeze_time = False
    cfg.convection_form = "standard"
    cfg.include_continuity_residual = True
    cfg.jacobian_mass_rho = True
    cfg.newton.tol, cfg.newton.max_iters = NEWTON_TOL, 8
    k = cfg.krylov
    k.rel_tol = 1e-9 if dtype == "float64" else 1e-6
    k.max_iters, k.restart = 3000, 100
    k.matvec, k.preconditioner = "windowed", "cahouet_chabard"
    k.cc_coarse_agg = 128
    k.operator_dtype = operator_dtype
    return cfg


def default_device(dtype: str) -> str:
    """Where a leg runs unless the caller says otherwise: float64, the
    oracle, on the CPU; float32 on the card."""
    return "cpu" if dtype == "float64" else "cuda"


def inflow(u_m: float = U_M):
    """The ramped parabola on y in [0, 4]: u = u_m 4 y (4 - y) / 16 sin(pi t / 8)."""

    def inlet(x, t=0.0):
        v = np.zeros_like(x)
        y = x[:, 1]
        v[:, 0] = u_m * 4.0 * y * (4.0 - y) / 16.0 * np.sin(np.pi * t / 8.0)
        return v

    return inlet


def channel(cells: int, rect=None):
    """The generated channel of ``cells`` cells on [0, 7] x [0, 4] (``rect``:
    another package's ``rectangle``)."""
    if rect is None:
        from ..mesh.generate import rectangle as rect
    nx, ny = CELLS[cells]
    return rect(nx, ny, 0, 7, 0, 4)


def _card() -> str | None:
    """The card's name and power limit as nvidia-smi gives them, or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return None


def rows_of(records) -> tuple[list, list, list]:
    """(the Newton rows [{step, iter, residual}], each tangent solve's
    FGMRES iterations, the tangent solves that stopped short [{step, iter,
    iters, residual, rel}]) of a run's log records; a short solve's rel is
    its last ||r|| over ||b||, the row's ||r||."""
    rows, iters, floors, step = [], [], [], 0
    for r in records:
        if r.get("event") == "time_step":
            step = r["step"]
        elif r.get("event") == "newton":
            rows.append({"step": step, "iter": r["iter"], "residual": r["residual"]})
        elif r.get("event") == "gmres" and r.get("system") == "tangent":
            iters.append(r["iters"])
        elif r.get("event") == "krylov_failure" and r.get("system") == "tangent":
            row = rows[-1]
            floors.append({"step": step, "iter": row["iter"], "iters": r["iters"],
                           "residual": r["residual"], "rel": r["residual"] / row["residual"]})
    return rows, iters, floors


def run(dtype: str = "float64", device: str | None = None, cells: int = 6400,
        steps: int = 20, u_m: float = U_M, verbose: bool = False,
        operator_dtype: str = "float32") -> dict:
    """One leg: the dynamic case on the channel for ``steps`` steps of dt
    0.05 on ``device`` (``default_device(dtype)`` if None); the JSON's
    dict."""
    import torch

    from ..models.navier_stokes import NavierStokesSolver
    from ..utils.logging import RunLog

    device = str(device or default_device(dtype))
    if device.startswith("cuda") and not torch.cuda.is_available():
        raise RuntimeError("trajectory_parity: no CUDA device visible to torch")
    cfg = trajectory_config(dtype, T=0.05 * steps, operator_dtype=operator_dtype)
    log = RunLog(verbose=verbose)
    t0 = time.perf_counter()
    s = NavierStokesSolver(channel(cells), cfg, log=log, inlet=inflow(u_m), device=device)
    s.setup()
    try:
        s.solve()
        note = "completed"
    except FloatingPointError as e:  # a blow-up is a result too
        note = f"aborted: {e}"
    if device.startswith("cuda"):
        torch.cuda.synchronize()
    rows, iters, floors = rows_of(log.records)
    return {
        "config": (f"generated channel rectangle{(*CELLS[cells], 0, 7, 0, 4)} ({cells} cells), "
                   f"dynamic inlet (u_m {u_m:g}, sin(pi t / 8)), corrected formulation, p_out 0, "
                   f"BDF1 dt 0.05 x {steps} steps, tight tangents (rel_tol "
                   f"{cfg.krylov.rel_tol:g}), windowed + Cahouet-Chabard (cc_coarse_agg 128), "
                   f"outer operator {operator_dtype}, {dtype} on {device}, Newton to {NEWTON_TOL:g} "
                   f"capped at 8"),
        "inlet": "dynamic",
        "note": note,
        "cells": cells,
        "n_total": s.dofs.n_total,
        "dtype": dtype,
        "device": device,
        "operator_dtype": operator_dtype,
        "card": _card(),
        "seconds": time.perf_counter() - t0,
        "fgmres_iters": iters,
        "tangent_floors": floors,
        "trajectory": rows,
    }


def compare(a: dict, b: dict) -> dict:
    """The original protocol on two legs' dicts (a: the float64 oracle, b:
    the float32 run).  Raises ValueError where the trajectories' shapes
    differ: another count of rows, or a row of another (step, iter), i.e.
    other Newton stopping decisions.  Entry rows (iter 0) integrate every
    earlier step's solves: the trajectory-level signal.  Dynamic rows lie
    above FLOOR_REL of the largest row of a; the others are floor rows,
    which b must keep below that bound.  The description names each leg's
    dtype and device as the leg states them."""
    ta, tb = a["trajectory"], b["trajectory"]
    shape_a = [(r["step"], r["iter"]) for r in ta]
    shape_b = [(r["step"], r["iter"]) for r in tb]
    if shape_a != shape_b:
        first = next((i for i, (p, q) in enumerate(zip(shape_a, shape_b)) if p != q),
                     min(len(ta), len(tb)))
        raise ValueError(f"the trajectories' shapes differ ({len(ta)} and {len(tb)} rows; "
                         f"first at row {first}): other Newton stopping decisions")
    floor = FLOOR_REL * max(r["residual"] for r in ta)
    rows, worst_dyn, worst_entry, n_dyn, n_entry, floor_ok = [], 0.0, 0.0, 0, 0, True
    for ra, rb in zip(ta, tb):
        rel = abs(rb["residual"] - ra["residual"]) / max(abs(ra["residual"]), 1e-300)
        dynamic = ra["residual"] > floor
        rows.append({**ra, "residual_f32": rb["residual"], "rel_diff": rel, "dynamic": dynamic})
        if ra["iter"] == 0:
            worst_entry, n_entry = max(worst_entry, rel), n_entry + 1
        if dynamic:
            worst_dyn, n_dyn = max(worst_dyn, rel), n_dyn + 1
        else:
            floor_ok &= rb["residual"] < floor

    def digits(x):
        return round(-math.log10(x), 2) if x > 0 else 16.0

    def leg(x):
        return f"{x.get('dtype', 'unstated dtype')} on {x.get('device', 'an unstated device')}"

    return {
        "description": (f"Newton residual trajectory, the dynamic inlet, {leg(a)} against "
                        f"{leg(b)}, both with tight tangent solves; entry rows (iter 0) are "
                        "the trajectory-level signal, later rows carry the float32 tangent "
                        "solves' forward error"),
        "inlet": a.get("inlet"),
        "f64_config": a["config"],
        "f32_config": b["config"],
        "card": b.get("card"),
        "identical_stopping_decisions": True,
        "dynamic_rows": n_dyn,
        "floor_rows": len(rows) - n_dyn,
        "f32_floor_bound": floor,
        "floor_rows_within_bound": bool(floor_ok),
        "max_rel_diff_dynamic": worst_dyn,
        "agreement_digits_dynamic": digits(worst_dyn),
        "entry_rows": n_entry,
        "max_rel_diff_entry": worst_entry,
        "agreement_digits_entry": digits(worst_entry),
        "f32_tangent_floors": b.get("tangent_floors", []),
        "rows": rows,
    }


def summary(c: dict) -> str:
    return (f"same shape (Newton stopping decisions): {c['identical_stopping_decisions']}; "
            f"entry rows: max rel {c['max_rel_diff_entry']:.3e}, "
            f"{c['agreement_digits_entry']:.2f} digits over {c['entry_rows']} rows; dynamic rows: "
            f"{c['agreement_digits_dynamic']:.2f} digits over {c['dynamic_rows']} rows; "
            f"{c['floor_rows']} floor rows within {c['f32_floor_bound']:.3e}: "
            f"{c['floor_rows_within_bound']}; float32 tangent solves short of 1e-6: "
            f"{len(c['f32_tangent_floors'])}")


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv and argv[0] == "--compare":
        if len(argv) not in (3, 4):
            sys.exit("usage: trajectory_parity --compare f64.json f32.json [out.json]")
        a, b = (json.load(open(p)) for p in argv[1:3])
        c = compare(a, b)
        print(summary(c))
        if len(argv) == 4:
            with open(argv[3], "w") as f:
                json.dump(c, f, indent=1)
        return 0
    ap = argparse.ArgumentParser(prog="navier_stokes_tpu_torch.scripts.trajectory_parity")
    ap.add_argument("mode", choices=("run",))
    ap.add_argument("out", help="the JSON to write")
    ap.add_argument("--dtype", choices=("float64", "float32"), default="float64")
    ap.add_argument("--device", default=None,
                    help="cpu or cuda (default: float64 on the CPU, float32 on the card)")
    ap.add_argument("--operator-dtype", choices=("float32", "bfloat16"), default="float32",
                    help="the outer operator's storage (bfloat16: a control)")
    ap.add_argument("--cells", type=int, choices=sorted(CELLS), default=6400)
    ap.add_argument("--steps", type=int, default=20, help="BDF1 steps of dt 0.05")
    ap.add_argument("--verbose", action="store_true", help="print the solver's log")
    args = ap.parse_args(argv)
    out = run(args.dtype, args.device, args.cells, args.steps, verbose=args.verbose,
              operator_dtype=args.operator_dtype)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(f"wrote {args.out}: {len(out['trajectory'])} residual rows, "
          f"{len(out['tangent_floors'])} tangent solves short of rel_tol, {out['seconds']:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
