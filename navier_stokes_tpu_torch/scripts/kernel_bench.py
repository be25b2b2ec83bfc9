"""Time the windowed kernels' wrappers and the Newton step on one GPU.

    python -m navier_stokes_tpu_torch.scripts.kernel_bench [--label NAME]

Run from a directory that holds the package (the repository root, or an
unpacked copy of another commit: the script uses only the package's public
functions, so one file times two trees in one run on one card).  On the
102,400-cell channel of chip_smoke.py (float32, windowed, Cahouet-Chabard)
it prints one JSON object with, for each wrapper call (K1 with bf16 and
float32 A, the three K2 products with bf16 A, K3, K4):

  warm_ms   CUDA-event time of a call in a loop of calls on the same inputs
            (what fits the 50 MB L2 stays there)
  cold_ms   CUDA-event time of a call made after a 256 MB write has pushed
            its inputs out of L2: what a caller inside the solver sees, and
            the time to hold against a bound in bytes from device memory
  host_us   host time a call, 200 calls queued with no synchronisation

and the median host-clock time of a forced Newton step at a seeded state
and of the 3-step BDF1 solve.  The timing helpers are chip_smoke.py's too.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

FLUSH_BYTES = 256 << 20  # five times the H100's 50 MB L2
REPS = 30  # timed calls behind every warm and cold figure of main()


def channel_config(dtype="float32", rel_tol=1e-2, cells_per_block=448):
    """chip_smoke.py's solver configuration: 3 BDF1 steps, windowed matvec,
    Cahouet-Chabard, the corrected formulation (with the reference's quirks
    the tangent is not the residual's derivative, and the channel's Newton
    loop diverges from step 2 on, in float64 with the plain versions too)."""
    from .. import SolverConfig

    cfg = SolverConfig()
    cfg.dtype = dtype
    cfg.T = 0.15  # 3 BDF1 steps at dt = 0.05
    cfg.inlet_tags, cfg.neumann_tags, cfg.wall_tags = (0,), (1,), (2, 3)
    cfg.inlet.freeze_time, cfg.inlet.H = False, 4.0  # non-zero inflow
    cfg.krylov.matvec = "windowed"
    cfg.krylov.preconditioner = "cahouet_chabard"
    cfg.krylov.max_iters = 2000
    cfg.krylov.rel_tol = rel_tol
    cfg.krylov.cells_per_block = cells_per_block
    cfg.convection_form = "standard"
    cfg.include_continuity_residual = True
    cfg.jacobian_mass_rho = True
    cfg.newton.max_iters = 20
    return cfg


def cuda_ms(fn, reps=20):
    """Warm time of fn() in ms: one pair of events around ``reps`` calls."""
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


@torch.no_grad()
def cuda_ms_cold(fn, reps=20):
    """Time of fn() in ms with its inputs out of L2: before every call a
    write of FLUSH_BYTES evicts them; each call has its own pair of events
    (the flush also keeps the host ahead of the device, so no launch gap
    falls between the events)."""
    fn()  # first-call work (library handles, scratch) is not the call's time
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    pairs = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
             for _ in range(reps)]
    torch.cuda.synchronize()
    for t0, t1 in pairs:
        flush.zero_()
        t0.record()
        fn()
        t1.record()
    torch.cuda.synchronize()
    return sum(t0.elapsed_time(t1) for t0, t1 in pairs) / reps


def host_us(fn, calls=200):
    """Host time of one fn() in us: ``calls`` calls queued back to back with
    no synchronisation, host clock over the loop."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt * 1e6 / calls


def device_time_by_kernel(fn, reps=10):
    """{CUDA kernel name: device us a call} of fn(), from a torch.profiler
    trace of ``reps`` warm calls."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        t = getattr(ev, "device_time_total", None)
        if t is None:
            t = getattr(ev, "cuda_time_total", 0.0)
        if t > 0 and ev.device_type == torch.autograd.DeviceType.CUDA:
            out[ev.key[:90]] = t / reps
    return out


def channel_operands(solver, seed=1):
    """Seeded operands of every wrapper at solver's layout: {name: (call,
    plain call)} for K1 (float32 and bf16 A), K2 (bf16 A), K3, K4."""
    from ..fem.windowed_assembly import assemble_windowed
    from ..ops import windowed as W

    lay, wa = solver._win_layout, solver._wassembly
    dev = lay.device
    rng = np.random.default_rng(seed)
    n = solver.dofs.n_total

    def vec():
        return torch.as_tensor(rng.standard_normal(n), dtype=torch.float32, device=dev)

    x, u = vec(), 0.05 * vec()
    A_t, _, _ = assemble_windowed(wa, lay, u, torch.zeros_like(u), dt=0.05, nu=1e-3, rho=1.0)
    R = torch.as_tensor(rng.standard_normal((lay.nli, lay.ncd)), dtype=torch.float32,
                        device=dev)
    A_bf = A_t.to(torch.bfloat16)
    n_u = lay.n_u
    calls = {
        "K3": (lambda: W.windowed_gather(lay, x), lambda: W._gather_reference(lay, x)),
        "K4": (lambda: W.windowed_scatter(lay, R), lambda: W._scatter_reference(lay, R)),
        "K1 f32": (lambda: W.windowed_matvec(lay, A_t, x),
                   lambda: W.windowed_matvec_reference(lay, A_t, x)),
        "K1": (lambda: W.windowed_matvec(lay, A_bf, x),
               lambda: W.windowed_matvec_reference(lay, A_bf, x)),
    }
    blocks = {
        "v->v": (W.slice_block(lay, A_t, "v", "v").to(torch.bfloat16), x[:n_u]),
        "v->p": (W.slice_block(lay, A_t, "v", "p").to(torch.bfloat16), x[:n_u]),
        "p->p": (wa.Kp_t.to(torch.bfloat16), x[n_u:]),
    }
    for key, (A_sub, xs) in blocks.items():
        i, o = key.split("->")
        calls[f"K2 {key}"] = (
            lambda A_sub=A_sub, xs=xs, i=i, o=o: W.windowed_matvec_block(
                lay, A_sub, xs, in_spaces=i, out_spaces=o),
            lambda A_sub=A_sub, xs=xs, i=i, o=o: W._block_reference(lay, A_sub, xs, i, o),
        )
    operands = dict(x=x, R=R, A_t=A_t, A_bf=A_bf, blocks=blocks)
    return calls, operands


def forced_newton_step(solver, reps=3, seed=0):
    """Host-clock seconds of ``reps`` forced Newton steps at a seeded state,
    and the last step's (residual, FGMRES iterations, converged)."""
    n = solver.dofs.n_total
    dev = solver._win_layout.device
    state = torch.as_tensor(0.05 * np.random.default_rng(seed).standard_normal(n),
                            dtype=torch.float32, device=dev)
    bc = torch.as_tensor(solver.dirichlet.values(solver.cfg.dt), dtype=torch.float32,
                         device=dev)
    times, out = [], None
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = solver._newton_iteration(state, torch.zeros_like(state), bc, solver.cfg.dt, True)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return times, out[1:4]


def main(argv=None):
    ap = argparse.ArgumentParser(prog="navier_stokes_tpu_torch.scripts.kernel_bench")
    ap.add_argument("--label", default="", help="a name for this tree in the record")
    ap.add_argument("--kernels-only", action="store_true",
                    help="skip the Newton step and the solve")
    ap.add_argument("--only", default="", help="comma-separated wrapper names to time")
    ap.add_argument("--profile", action="store_true",
                    help="also print each call's device time by CUDA kernel (torch.profiler)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("kernel_bench: no CUDA device visible to torch")
    import navier_stokes_tpu_torch as nt

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    mesh = nt.refine_uniform(nt.rectangle(80, 40, 0, 7, 0, 4), 2)
    solver = nt.NavierStokesSolver(mesh, channel_config(), log=nt.RunLog(verbose=False),
                                   device=torch.device("cuda:0"))
    solver.setup()
    calls, operands = channel_operands(solver)
    lay = solver._win_layout
    print(f"  layout: nb {lay.nb} Bmax {lay.Bmax} Bc {lay.Bc} nchunks {lay.nchunks} "
          f"RVv/RVp {lay.RVv}/{lay.RVp} hv/hp {lay.hv}/{lay.hp}", flush=True)
    rec = {"label": args.label, "card": smi, "cells": mesh.n_cells, "kernels": {}}
    only = [k.strip() for k in args.only.split(",") if k.strip()]
    for name, (call, _) in calls.items():
        if only and name not in only:
            continue
        call()  # build, tables, scratch
        w1, c1, c2, w2 = (cuda_ms(call, REPS), cuda_ms_cold(call, REPS),
                          cuda_ms_cold(call, REPS), cuda_ms(call, REPS))
        rec["kernels"][name] = dict(warm_ms=(w1 + w2) / 2, cold_ms=(c1 + c2) / 2,
                                    host_us=host_us(call))
        print(f"  {name:<8} warm {w1:.4f}/{w2:.4f} ms  cold {c1:.4f}/{c2:.4f} ms  "
              f"host {rec['kernels'][name]['host_us']:.1f} us", flush=True)
        if args.profile:
            for kname, us in device_time_by_kernel(call).items():
                print(f"           {us:8.2f} us  {kname}", flush=True)
    del calls, operands
    if args.kernels_only:
        print(json.dumps(rec))
        return 0
    times, (res, iters, ok) = forced_newton_step(solver, reps=5)
    rec["newton_step_ms"] = [t * 1e3 for t in times]
    rec["newton_step_median_ms"] = float(np.median(times) * 1e3)
    rec["newton_step"] = dict(residual=float(res), fgmres_iters=int(iters), converged=bool(ok))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    solver.solve()
    torch.cuda.synchronize()
    rec["solve_3_steps_s"] = time.perf_counter() - t0
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())
