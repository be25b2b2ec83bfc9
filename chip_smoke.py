"""Drive the PyTorch + CUDA port of the Navier-Stokes solver once on one GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero; there is no CPU fallback):
  1. device     the card's name and power limit
  2. build      nvcc builds navier_stokes_tpu_torch/csrc/windowed.cu and
                csrc/mxu_probe.cu for sm_90a, both at once; each kernel's
                registers and spills as ptxas reports them
  3. kernels    each windowed kernel (K1-K4, and K3 on the pair u, u_old in
                one launch) against its plain torch version at the shapes of
                the 102,400-cell channel; CUDA-event times with the inputs
                out of L2 (and warm), host time a call, the bound in bytes
                and the share of it reached, one PyTorch call of the same
                function (K1 and each K2 product: a CSR product with the
                assembled matrix; K3 index_select, the pair's of the two
                vectors stacked; K4 index_add_), the packed position tables
                against _abs_loc; each kernel called twice on the same
                inputs (equal bits: K1, K2 and K4 sum in a fixed order), and
                K1 / K2 / K3 (single and pair) / K4 replayed from a CUDA
                graph (equal bits to an eager call)
  4. slice      NavierStokesSolver on that channel in float32: 3 BDF1 steps of
                the windowed, Cahouet-Chabard-preconditioned Newton solve;
                every Newton loop and every tangent solve must converge
  5. newton     three forced Newton steps at a seeded state: equal FGMRES
                counts and bit-equal updates; each kernel's launches in one
  6. launches   each kernel's launch count during phase 4 (all must be > 0)
  7. parity     unit_square(6): float32 on the GPU (kernels) against float64
                on the CPU (plain versions), Newton residuals per step; then
                the same with a time-dependent forcing f(x, t)
  8. probe      K5, the tensor-core probe, against its plain version at
                every M of the probe, replayed from a CUDA graph, beside one
                torch.mm of its products, then its entry point's table
                (python -m navier_stokes_tpu_torch.scripts.mxu_probe)
  9. cli        python -m navier_stokes_tpu_torch run on the 6,400-cell
                channel written as a gmsh .msh: windowed, Cahouet-Chabard,
                Stokes initial guess (must converge), 2 steps; K1-K4 must all
                launch
 10. stokes     StokesSolver flat and windowed against the exact Poiseuille
                flow; the stokes command on a .msh
 11. flat       the 25,600-cell channel, flat against windowed: residual and
                tangent action at one smooth state, compared node by node;
                one forced Newton step each (block_triangular, Cahouet-Chabard)
 12. steady     the lid-driven cavity at Re 100 on rectangle(256, 256)
                (131,072 cells), float32: solve_steady from the Stokes guess
                with FGMRES tangents must converge, its centrelines within
                0.01 of Ghia et al.'s; K1-K4 must all launch.  At n = 32 the
                float32 FGMRES solve against a float64 SuperLU one
 13. scanned    the same cavity, BDF2, dt 0.05: 6 steps of solve_scanned
                (chunks of 2, 2 Newton sweeps, a functional, a progress
                callback, the lid's reaction) against the same 6 steps of
                solve(); 4 steps in a second solver, its state handed to a
                third that resumes for 2: bit-equal to the 6-step run
 14. 3d         P2/P1 tetrahedra on refine_uniform(box(8, 8, 8), 2)
                (196,608 cells; kernel_bench.box_config, box_inlet: a ramped
                parabolic inflow), windowed + Cahouet-Chabard, float32 with
                the tangent stored in bf16: (a) phase 3's checks of every
                kernel at the box's layout (halo 5, 36 slot colours);
                (b) 2 BDF1 steps from rest, every Newton loop converging,
                K1-K4 all launched; (c) three forced Newton steps at a
                seeded state, as phase 5; (d) refine_uniform(box(4, 4, 4), 1):
                float32 on the GPU against float64 on the CPU over 2 steps,
                with the tangent stored in float32 and in bf16

Each phase prints its wall time.
Files the phases write (.msh, configs, run logs) go to build/chip_smoke/.
The next-to-last line is the kernels' JSON record, and the last line is
{"ok": true, "device": {...}}.  The record has K1-K4 twice, at the
channel (phases 3-5) and at the box (", 3D": phase 14), and K5.  Per
kernel: ``launches`` on the main path (phase 4, 14(b); K5: its entry
point), ``launches_per_newton_step`` (phase 5, 14(c)), ``max_abs_err``
against the plain version, ``ms`` the wrapper's CUDA-event time with its
inputs out of L2 (``cold_clean_ms`` the same with L2 left holding no dirty
line, ``warm_ms`` in a loop on the same inputs, ``host_us`` the host's time
to queue a call, ``replay_ms`` a warm replay from a CUDA graph where phase
3 or 14 makes one), ``plain_ms`` the plain version's, ``bound_ms`` the least time the card could take (the bytes
that must move over 3.35 TB/s, or the operations over 989 TFLOP/s:
``bound_by``), ``library_ms`` one PyTorch call computing the same function
(null where there is none; never used by the package; ``library`` says
which call: for K5 one torch.mm of the products laid side by side along K
with a float32 output, and ``library_graph_ms`` the products as bf16
torch.matmul calls replayed from a CUDA graph; K5's ``grid`` is the launch's
tiles and groups of iterations).  K3's ``also`` holds the pair's record.
"""

import contextlib
import copy
import json
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

if not torch.cuda.is_available():
    sys.exit("chip_smoke: no CUDA device visible to torch")

import navier_stokes_tpu_torch as nt  # noqa: E402
from navier_stokes_tpu_torch.__main__ import main as cli  # noqa: E402
from navier_stokes_tpu_torch.fem.assembly import assemble_navier_stokes  # noqa: E402
from navier_stokes_tpu_torch.fem.windowed_assembly import assemble_windowed  # noqa: E402
from navier_stokes_tpu_torch.la import operators as ops  # noqa: E402
from navier_stokes_tpu_torch.ops import windowed as W  # noqa: E402
from navier_stokes_tpu_torch.scripts import cavity  # noqa: E402
from navier_stokes_tpu_torch.scripts import kernel_bench as kb  # noqa: E402
from navier_stokes_tpu_torch.scripts import mxu_probe as mxu  # noqa: E402
from navier_stokes_tpu_torch.scripts.kernel_bench import (  # noqa: E402
    channel_config as config, cuda_ms, cuda_ms_cold, host_us)

DEV = torch.device("cuda:0")
KERNEL_SOURCE = "navier_stokes_tpu_torch/csrc/windowed.cu"
PROBE_SOURCE = "navier_stokes_tpu_torch/csrc/mxu_probe.cu"
OUT = Path(__file__).resolve().parent / "build" / "chip_smoke"
# The TPU kernels replaced: the pl.pallas_call of each Pallas function
REPLACES = {
    "K1": "navier_stokes_tpu/ops/windowed.py:1228 (_pallas_run, mode matvec)",
    "K2": "navier_stokes_tpu/ops/windowed.py:946 (_pallas_block)",
    "K3": "navier_stokes_tpu/ops/windowed.py:1228 (_pallas_run, mode gather)",
    "K4": "navier_stokes_tpu/ops/windowed.py:1228 (_pallas_run, mode scatter)",
    "K5": "scripts/mxu_probe.py:32 (make_bench.kernel)",
}
# the probe's comparison and its entry point's timing run
PROBE_CHECK_ITERS, PROBE_ITERS = 64, 20000
# Poiseuille flow in the unit square (tests/test_stokes.py): exact in P2/P1
NU, RHO, POUT = 0.04, 1.0, 10.0
STOKES_U_TOL, STOKES_P_TOL = 5e-5, 5e-3
# flat vs windowed, node by node: residual and tangent action at one smooth
# state, each block within 1e-5 of its max (float32 sums in another order
# over another DoF numbering; 3e-7 to 6e-7 in float32 on the CPU); the
# entry residual norms of a forced Newton step from zero within 1e-5
FLAT_TOL = 1e-5
# float32 sums in another order: 1e-5 of ||y||_inf (K3 is a pure copy: exact)
REL_TOL = 1e-5
# small-mesh parity: every Newton residual of the float32 GPU run within
# 1e-4 of its step's entry residual of the float64 CPU run (tangents solved
# to 1e-6 / 1e-9, so the rows are set by the discretization, and float32
# rounding through the solve stays near 1e-6 of the entry row)
PARITY_TOL = 1e-4
# the box's parity (phase 14(d)): tangents solved to 1e-6 in both runs (the
# float64 CPU run's plain versions take ~60 s at 1e-6, more than twice that
# at 1e-9); on the CPU the float32 run with a float32 tangent store meets
# the float64 rows to 1e-7 of the entry row.  A bf16 tangent store (the
# main path's) perturbs every Newton update by the store's rounding: up to
# 4.8e-3 of the entry row on the CPU, so it is held to 1e-2
BOX_PARITY_REL_TOL = 1e-6
BOX_BF16_PARITY_TOL = 1e-2
# the lid-driven cavity (phases 12-13): n x n squares cut in two triangles
CAVITY_N, CAVITY_SMALL_N = 256, 32
# Ghia et al.'s centreline values, largest gap of u and of v (their own grid
# is 129 x 129; the n = 32 float32 run of examples/lid_cavity.py reached
# 0.0054 / 0.0089 after time marching on the CPU)
GHIA_TOL = 0.01
# solve_steady's own stopping rule (its default): alpha ||delta|| / n_dofs
STEADY_TOL = 1e-8


# n = 32: float32 FGMRES against float64 SuperLU, both assembled on the card.
# The cavity's pressure is defined up to a constant, which the exact tangent
# leaves free: SuperLU's updates carry an arbitrary pressure constant, so the
# float64 run is held to its residual (it reaches the float64 floor in ~6
# exact Newton steps; LU_ITERS of them) and the pressures are compared with
# their means removed.  float32 rounding through the tangent solves leaves
# ~1e-7 of max|u| = 1 (8e-8 at n = 16 on the CPU); the bounds allow 100x
LU_ITERS, LU_RES_TOL = 8, 1e-10
SMALL_U_TOL, SMALL_P_TOL = 1e-5, 1e-4
# scanned vs solve(): the same sweeps in the same order (newton.max_iters is
# the scanned loop's 2), so bit-equal is expected; the bound is JAX's test's
SCAN_HOST_TOL = 1e-6
# the card's published peaks (H100 SXM): device memory and dense bf16
PEAK_BYTES_PER_S, PEAK_BF16_FLOPS = 3.35e12, 989e12


class Phases:
    """Prints each phase's title and, when the next one starts (or at
    ``end()``), its wall time."""

    def __init__(self):
        self.name, self.t0 = None, 0.0

    def __call__(self, name):
        self.end()
        print(f"\n== {name}", flush=True)
        self.name, self.t0 = name, time.perf_counter()

    def end(self):
        if self.name is not None:
            print(f"  [phase {self.name.split()[0]}: {time.perf_counter() - self.t0:.1f} s]",
                  flush=True)
        self.name = None


phase = Phases()


def forcing_xt(x, t):
    """A body force that changes in time and space (phase 7)."""
    f = np.zeros_like(x)
    f[:, 0] = 2.0 * np.sin(3.0 * t + x[:, 1])
    f[:, 1] = t * x[:, 0]
    return f


def trajectory(records):
    """[(step, [newton residuals], [gmres counts], failures)] from the
    records of a RunLog; what comes before the first time step (the Stokes
    initial guess) is left out."""
    steps = []
    for r in records:
        ev = r.get("event")
        if ev != "time_step" and not steps:
            continue
        if ev == "time_step":
            steps.append((r["step"], [], [], []))
        elif ev == "newton":
            steps[-1][1].append(r["residual"])
        elif ev == "gmres":
            steps[-1][2].append(r["iters"])
        elif ev == "krylov_failure":
            steps[-1][3].append(r)
    return steps


def check_converged(steps, tol):
    for step, res, its, fails in steps:
        print(f"  step {step}: ||r|| = {', '.join(f'{x:.6e}' for x in res)}; "
              f"GMRES iterations {its}", flush=True)
        if not res or res[-1] > tol:
            raise RuntimeError(f"step {step}: Newton loop did not converge ({res})")
        if fails:
            raise RuntimeError(f"step {step}: tangent solve did not converge: {fails}")


def write_msh_v2(mesh, path):
    """A 2D Mesh as gmsh 2.2 ASCII: boundary lines with their tags as
    physical tags, triangles with physical tag 0."""
    lines = ["$MeshFormat", "2.2 0 8", "$EndMeshFormat", "$Nodes", str(len(mesh.coords))]
    lines += [f"{i + 1} {x!r} {y!r} 0" for i, (x, y) in enumerate(mesh.coords.tolist())]
    lines += ["$EndNodes", "$Elements",
              str(len(mesh.boundary_facets) + len(mesh.cells))]
    k = 0
    for (a, b), tag in zip(mesh.boundary_facets.tolist(), mesh.boundary_tags.tolist()):
        k += 1
        lines.append(f"{k} 1 2 {tag} {tag} {a + 1} {b + 1}")
    for a, b, c in mesh.cells.tolist():
        k += 1
        lines.append(f"{k} 2 2 0 0 {a + 1} {b + 1} {c + 1}")
    lines.append("$EndElements")
    path.write_text("\n".join(lines) + "\n")
    return path


def run_cli(argv, name):
    """python -m navier_stokes_tpu_torch <argv> in this process (so the
    launch counters can be read), its printed log sent to OUT/<name>.out;
    returns the structured records of its --log-json file."""
    records = OUT / f"{name}.json"
    with open(OUT / f"{name}.out", "w") as f, contextlib.redirect_stdout(f):
        rc = cli([*argv, "--log-json", str(records)])
    if rc != 0:
        raise RuntimeError(f"{' '.join(argv)}: exit code {rc}")
    return json.loads(records.read_text())


def poiseuille_inlet(x, t=0.0):
    v = np.zeros_like(x)
    v[:, 0] = x[:, 1] * (1.0 - x[:, 1])
    return v


def stokes_solve(records):
    """(GMRES iterations, failure record or None) of the one Stokes solve
    in a run's records."""
    its = [r["iters"] for r in records if r.get("event") == "gmres" and r.get("system") == "stokes"]
    fails = [r for r in records
             if r.get("event") == "krylov_failure" and r.get("system") == "stokes"]
    if len(its) != 1:
        raise RuntimeError(f"expected one Stokes solve, found GMRES counts {its}")
    return its[0], (fails[0] if fails else None)


def smooth_state(s, seed):
    """A smooth state vector in solver s's DoF numbering (0 on the padding
    holes of a blocked one): the same function of the coordinates for every
    numbering, with seeded amplitudes."""
    d = s.dofs
    a = np.random.default_rng(seed).uniform(0.5, 1.5, 3)
    vx, vy = d.v_coords[:, 0], d.v_coords[:, 1]
    u = np.concatenate([a[0] * np.sin(vx) * np.cos(vy), a[1] * np.cos(vx) * np.sin(vy)])
    p = s.cfg.p_out + a[2] * d.p_coords[:, 0] * d.p_coords[:, 1] / 28
    if d.v_mask is not None:
        u = np.where(np.tile(d.v_mask, d.dim), u, 0.0)
    if d.p_mask is not None:
        p = np.where(d.p_mask, p, 0.0)
    return torch.as_tensor(np.concatenate([u, p]), dtype=torch.float32, device=DEV)


def by_node(s, y):
    """(coordinates, velocity rows, pressure rows) of a state-sized vector
    of solver s, holes dropped and nodes ordered by (x, y), so that two DoF
    numberings of one mesh line up entry by entry."""
    d = s.dofs
    y = y.double().cpu().numpy()
    v, p = y[: d.n_u].reshape(d.dim, d.n_vs).T, y[d.n_u:]
    vc, pc = d.v_coords, d.p_coords
    if d.v_mask is not None:
        v, vc = v[d.v_mask], vc[d.v_mask]
    if d.p_mask is not None:
        p, pc = p[d.p_mask], pc[d.p_mask]
    iv, ip = (np.lexsort(np.round(c, 9).T[::-1]) for c in (vc, pc))
    return np.concatenate([vc[iv].ravel(), pc[ip].ravel()]), v[iv], p[ip]


def assembled(s, u, w):
    """The residual at state u (previous state 0) and the tangent action
    J w, before Dirichlet rows, through solver s's own path: the flat
    element operators, or the windowed kernels K3/K4 and K1."""
    cfg = s.cfg
    zero = torch.zeros_like(u)
    form = dict(dt=cfg.dt, nu=cfg.nu, rho=cfg.rho, convection_form=cfg.convection_form,
                include_continuity_residual=cfg.include_continuity_residual)
    if s._matvec == "windowed":
        A_t, r, _ = assemble_windowed(s._wassembly, s._win_layout, u, zero, **form)
        return r, W.windowed_matvec(s._win_layout, A_t, w)
    ctx = s.ctx
    cell_mat, _, r = assemble_navier_stokes(ctx, u, zero, p_out=cfg.p_out,
                                            jacobian_mass_rho=cfg.jacobian_mass_rho, **form)
    op = ops.ElementOperator(cell_mat, ctx.cell_dofs, torch.zeros(0, dtype=torch.int64, device=DEV),
                             r.new_zeros(0), ctx.scatter_full, ctx.n_total)
    return r, ops.matvec(op, w)


def stacked(out):
    """A call's output as one tensor (the pair's two outputs stacked)."""
    return torch.stack(out) if isinstance(out, tuple) else out


def compare(name, kernel, plain, exact=False, bound_bytes=None, library=None):
    """Kernel vs plain on the same inputs, then times in turns (plain,
    kernel, kernel, plain) with the inputs out of L2, the kernel's time with
    L2 holding no dirty line, its warm time and host time a call, and
    ``library`` (one PyTorch call of the same function) if given.  With
    ``bound_bytes`` the share of the bound reached is checked: over 1.0 the
    count of bytes or the timing is wrong."""
    got, want = stacked(kernel()), stacked(plain())
    torch.cuda.synchronize()
    err = float((got.double() - want.double()).abs().max())
    scale = float(want.double().abs().max())
    ok = torch.equal(got, want) if exact else err <= REL_TOL * scale
    p1, k1, k2, p2 = (cuda_ms_cold(plain), cuda_ms_cold(kernel), cuda_ms_cold(kernel),
                      cuda_ms_cold(plain))
    rec = dict(max_abs_err=err, rel_err=err / max(scale, 1e-300),
               ms=(k1 + k2) / 2, plain_ms=(p1 + p2) / 2,
               cold_clean_ms=cuda_ms_cold(kernel, clean=True), warm_ms=cuda_ms(kernel),
               host_us=host_us(kernel), library_ms=None)
    line = (f"  {name:<30} max|err| {err:.3e} (rel {rec['rel_err']:.2e}, "
            f"{'bit-equal required' if exact else f'tol {REL_TOL:g}'}) "
            f"kernel {rec['ms']:.4f} ms (clean {rec['cold_clean_ms']:.4f}, warm "
            f"{rec['warm_ms']:.4f}, host {rec['host_us']:.1f} us a call)  "
            f"plain {rec['plain_ms']:.4f} ms")
    if library is not None:
        lib = library()
        lib_err = float((lib.double() - want.double()).abs().max())
        if not (torch.equal(lib, want) if exact else lib_err <= REL_TOL * scale):
            raise RuntimeError(f"{name}: the library call does not compute the same function "
                               f"(max|err| {lib_err:.3e})")
        rec["library_ms"] = cuda_ms_cold(library)
        line += f"  library {rec['library_ms']:.4f} ms"
    if bound_bytes is not None:
        rec.update(bound_ms=bound_bytes / PEAK_BYTES_PER_S * 1e3, bound_by="bytes",
                   bound_bytes=bound_bytes)
        rec["share"] = rec["bound_ms"] / rec["ms"]
        line += (f"  bound {rec['bound_ms']:.4f} ms ({bound_bytes / 1e6:.1f} MB), "
                 f"share {rec['share']:.3f}")
    print(line, flush=True)
    if not ok:
        raise RuntimeError(f"{name}: kernel disagrees with its plain version")
    if bound_bytes is not None and rec["share"] > 1.0:
        raise RuntimeError(f"{name}: faster than its bound; the bytes or the timing are wrong")
    return rec


def check_packed_tables(lay):
    """The packed position tables on the card against _abs_loc."""
    pos_v, pos_p, cnt = lay._packed.pos_v, lay._packed.pos_p, lay._packed.cnt
    for pos, hi, lo, offs, RV, RW, k, OW, h in (
            (pos_v, lay.loc_v_hi, lay.loc_v_lo, lay.offs_v, lay.RVv, lay.RWv, lay.k_v,
             lay.OWv, lay.hv),
            (pos_p, lay.loc_p_hi, lay.loc_p_lo, lay.offs_p, lay.RVp, lay.RWp, lay.k_p,
             lay.OWp, lay.hp)):
        want = W._abs_loc(lay, hi, lo, offs, RV, RW, k)
        want = torch.where(want >= min(RW * 128, (2 * h + 1) * OW), -1, want)
        if not torch.equal(W.unpack_positions(pos).transpose(1, 2), want):
            raise RuntimeError("packed position table differs from _abs_loc")
    print(f"  packed position tables equal _abs_loc ({pos_v.dtype}, "
          f"{(pos_v.numel() + pos_p.numel()) * pos_v.element_size() / 1e6:.1f} MB; "
          f"occupied slots {int(cnt.sum())} of {lay.ncd})", flush=True)


def matmul_graph_ms(a, b, M, iters):
    """Warm CUDA-event time in ms of ``iters`` bf16 torch.matmul calls
    a_panel(i % 8) @ b, the products of one probe launch (each overwrites one
    bf16 output: nothing accumulates), replayed from a CUDA graph."""
    panels = [a[p * M:(p + 1) * M] for p in range(8)]
    out = torch.empty((M, b.shape[1]), dtype=torch.bfloat16, device=a.device)

    def loop():
        for i in range(iters):
            torch.matmul(panels[i % 8], b, out=out)

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # the library's handle and workspace, before the capture
        loop()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        loop()
    graph.replay()
    return cuda_ms(graph.replay)


def probe_one_call(a, b, M, iters):
    """(call, what it is): K5's function as one PyTorch call, torch.mm of the
    panels a_(i % 8), i < iters, side by side along K [M, iters*128] with b
    stacked iters times [iters*128, N], bf16 operands, float32 output."""
    a_cat = torch.cat([a[(i % 8) * M:(i % 8 + 1) * M] for i in range(iters)], dim=1)
    b_stack = b.repeat(iters, 1)
    return (lambda: torch.mm(a_cat, b_stack, out_dtype=torch.float32),
            f"one torch.mm [{M}, {iters * mxu.K}] @ [{iters * mxu.K}, {b.shape[1]}], "
            "bf16 operands, out_dtype float32")


def ptxas_summary(log):
    """One line per kernel of a build's ptxas output: its registers, and its
    spills where there are any."""
    names = {}
    mangled = re.findall(r"Compiling entry function '([^']+)'", log)
    if mangled:
        try:
            out = subprocess.run(["c++filt"], input="\n".join(mangled), capture_output=True,
                                 text=True, timeout=30).stdout.splitlines()
            names = dict(zip(mangled, out))
        except (OSError, subprocess.SubprocessError):
            pass
    lines, name = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = names.get(m.group(1), m.group(1))
        elif name and "registers" in line:
            lines.append(f"{name[:110]}: {line.split(':', 1)[-1].strip()}")
        elif name and "spill" in line and " 0 bytes spill stores" not in line:
            lines.append(f"{name[:110]}: {line.strip()}")
    return list(dict.fromkeys(lines))  # ptxas reports some kernels twice


def check_repeat(name, call):
    """Two calls on the same inputs must give the same bits (every sum of
    K1-K4 has a fixed order)."""
    first, second = stacked(call()), stacked(call())
    torch.cuda.synchronize()
    same = torch.equal(first, second)
    print(f"  {name}: two calls on the same inputs bit-equal: {same}", flush=True)
    if not same:
        raise RuntimeError(f"{name}: a repeated call changed the result")


def check_graph_replay(name, call, x, exact=False):
    """Capture one wrapper call in a CUDA graph, write new values into its
    input x, replay, and hold the output against an eager call (``exact``:
    bit-equal).  Returns the replay's warm time in ms."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # the capture stream's scratch, before the capture
        call()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        y = call()
    x.copy_(torch.roll(x, 1))
    graph.replay()
    torch.cuda.synchronize()
    y, want = stacked(y), stacked(call())
    torch.cuda.synchronize()
    err = float((y.double() - want.double()).abs().max())
    scale = float(want.double().abs().max())
    replay_ms = cuda_ms(graph.replay)
    print(f"  {name}: graph replay vs eager max|err| {err:.3e} (rel {err / scale:.2e}, "
          f"{'bit-equal required' if exact else f'tol {REL_TOL:g}'}); replay "
          f"{replay_ms:.4f} ms warm", flush=True)
    if not (torch.equal(y, want) if exact else err <= REL_TOL * scale):
        raise RuntimeError(f"{name}: graph replay disagrees with an eager call")
    return replay_ms


TITLES = {"K3": "K3 gather", "K3 pair": "K3 gather, u and u_old in one launch",
          "K4": "K4 scatter", "K1 f32": "K1 matvec, f32 A", "K1": "K1 matvec, bf16 A (main path)"}


def kernels_vs_plain(solver):
    """Every wrapper call of ``kb.wrapper_operands`` at solver's layout
    against its plain version (``compare``: errors, times, the bound and one
    PyTorch call of the same function, built outside the timing: K3, K4
    through the flat dof index, K1 and each K2 product a CSR product), then
    each called twice on the same inputs (equal bits) and replayed from a
    CUDA graph (equal bits to an eager call).  Returns the records by call."""
    lay = solver._win_layout
    calls, ops_ = kb.wrapper_operands(solver)
    check_packed_tables(lay)
    bounds = kb.bound_bytes_of(lay, ops_)
    recs = {}
    for key, (kernel, plain) in calls.items():
        lib_call, lib_what = kb.library_call(lay, ops_, key)
        print(f"  {key} yardstick: {lib_what}", flush=True)
        recs[key] = compare(TITLES.get(key, f"{key}, bf16 A"), kernel, plain,
                            exact=key.startswith("K3"), bound_bytes=bounds[key], library=lib_call)
        recs[key]["library"] = lib_what
        del lib_call  # a CSR matrix holds gigabytes at the box's size
    for key, (kernel, _) in calls.items():
        check_repeat(key, kernel)
    blocks, x = ops_["blocks"], ops_["x"]
    replays = (("K2 v->v", blocks["v->v"][1]), ("K2 v->p", blocks["v->p"][1]),
               ("K2 p->p", blocks["p->p"][1]), ("K1", x), ("K1 f32", x), ("K3", x),
               ("K3 pair", x), ("K4", ops_["R"]))
    for key, inp in replays:
        recs[key]["replay_ms"] = check_graph_replay(key, calls[key][0], inp, exact=True)
    return recs


def steady_phase():
    """Phase 12: solve_steady on the n = CAVITY_N cavity (FGMRES, float32),
    Ghia's centrelines, and float32 FGMRES against float64 SuperLU at n =
    CAVITY_SMALL_N."""
    phase(f"12 steady: the lid-driven cavity at Re 100, n = {CAVITY_N}, float32 (solve_steady)")
    cmesh = nt.rectangle(CAVITY_N, CAVITY_N)
    ccfg = cavity.cavity_config()
    clog = nt.RunLog(verbose=False)
    t0 = time.perf_counter()
    cs = nt.NavierStokesSolver(cmesh, ccfg, log=clog, inlet=cavity.lid, device=DEV)
    cs.setup()
    torch.cuda.synchronize()
    t_setup = time.perf_counter() - t0
    clay = cs._win_layout
    pk = clay._packed
    print(f"  cells {cmesh.n_cells}  n_total {cs.dofs.n_total}  nb {clay.nb}  Bmax {clay.Bmax}  "
          f"Bc {clay.Bc}  nchunks {clay.nchunks}  ncd {clay.ncd}  occupied chunks "
          f"{int((pk.cnt[:, None] > torch.arange(clay.nchunks, device=DEV) * clay.Bc).sum())}  "
          f"slot colours {pk.ncolors}  setup {t_setup:.2f} s", flush=True)
    W.reset_launch_counts()
    t0 = time.perf_counter()
    iters, upd = cs.solve_steady(initial_guess="stokes", tangent_solver="fgmres", tol=STEADY_TOL)
    torch.cuda.synchronize()
    t_steady = time.perf_counter() - t0
    steady_launches = W.launch_counts()
    its, fail = stokes_solve(clog.records)
    print(f"  Stokes initial guess: {its} GMRES iterations, "
          + (f"stopped at ||r|| {fail['residual']:.6e}" if fail else "converged"))
    # a tangent solve that misses rel_tol logs krylov_failure (its final
    # ||r||) just before its iteration's steady_newton record (||b||)
    short, fail = 0, None
    kt = ccfg.krylov
    for r in clog.records:
        if r.get("event") == "krylov_failure" and r.get("system") == "tangent":
            fail = r
        elif r.get("event") == "steady_newton":
            reached = "reached rel_tol"
            if fail is not None:
                short += 1
                how = "capped" if fail["iters"] >= kt.max_iters else "stalled"
                reached = (f"did not reach rel_tol ({how}): ||r||/||b|| "
                           f"{fail['residual'] / r['res_norm']:.3e}")
            print(f"  iteration {r['iter']}: update {r['update']:.6e}, ||r|| {r['res_norm']:.6e}, "
                  f"GMRES iterations {r['gmres_iters']}, alpha {r['alpha']}; tangent solve "
                  f"{reached} (rel_tol {kt.rel_tol:g})")
            fail = None
    print(f"  {iters} Newton iterations, update {upd:.3e} (tol {STEADY_TOL:g}); "
          f"{short} tangent solves did not reach rel_tol (stalled or capped); wall "
          f"{t_steady:.2f} s; launches {steady_launches}", flush=True)
    if upd > STEADY_TOL:
        raise RuntimeError("the steady cavity did not converge by its own criterion")
    if not bool(torch.isfinite(cs.solution).all()):
        raise RuntimeError("the steady cavity's solution is not finite")
    err_u, err_v = cavity.ghia_errors(cs)
    print(f"  centrelines against Ghia et al. (Re 100): max|u - u_Ghia| {err_u:.5f}, "
          f"max|v - v_Ghia| {err_v:.5f} (tol {GHIA_TOL})", flush=True)
    if max(err_u, err_v) > GHIA_TOL:
        raise RuntimeError("the steady cavity misses Ghia et al.'s centrelines")
    if min(steady_launches.values()) == 0:
        raise RuntimeError(f"a kernel was never launched by solve_steady: {steady_launches}")
    small = {}
    for dtype, tangent in (("float32", "fgmres"), ("float64", "lu")):
        scfg = cavity.cavity_config(dtype)
        slog = nt.RunLog(verbose=False)
        s = nt.NavierStokesSolver(nt.rectangle(CAVITY_SMALL_N, CAVITY_SMALL_N), scfg, log=slog,
                                  inlet=cavity.lid, device=DEV)
        t0 = time.perf_counter()
        if tangent == "lu":
            # from rest, exact tangents, full steps: the first solves Stokes
            out = s.solve_steady(tangent_solver="lu", initial_guess="current",
                                 line_search=False, max_iters=LU_ITERS)
        else:
            out = s.solve_steady(tangent_solver="fgmres", tol=STEADY_TOL)
        torch.cuda.synchronize()
        recs = [r for r in slog.records if r.get("event") == "steady_newton"]
        print(f"  n = {CAVITY_SMALL_N}, {dtype}, {tangent}: {out[0]} iterations, "
              f"{time.perf_counter() - t0:.2f} s; ||r|| per iteration "
              f"{['%.3e' % r['res_norm'] for r in recs]}; Ghia {cavity.ghia_errors(s)}",
              flush=True)
        small[tangent] = (s, recs)
    (s32, r32), (s64, r64) = small["fgmres"], small["lu"]
    if r32[-1]["update"] > STEADY_TOL or r64[-1]["res_norm"] > LU_RES_TOL:
        raise RuntimeError("a small cavity solve did not converge")
    du = np.abs(s32.velocity(real_only=True) - s64.velocity(real_only=True)).max()
    p32, p64 = s32.pressure(real_only=True), s64.pressure(real_only=True)
    dp = np.abs((p32 - p32.mean()) - (p64 - p64.mean())).max()
    print(f"  float32 FGMRES vs float64 SuperLU: max|du| {du:.3e} (tol {SMALL_U_TOL:g}), "
          f"max|dp| with means removed {dp:.3e} (tol {SMALL_P_TOL:g})", flush=True)
    if du > SMALL_U_TOL or dp > SMALL_P_TOL:
        raise RuntimeError("float32 FGMRES and float64 SuperLU cavities disagree")


def scanned_phase():
    """Phase 13: solve_scanned on the n = CAVITY_N cavity against solve(),
    and a run resumed in a new solver against the run without a break."""
    cmesh = nt.rectangle(CAVITY_N, CAVITY_N)
    phase(f"13 scanned: the cavity, n = {CAVITY_N}, BDF2, solve_scanned against solve(), "
          "and a resume")
    scan_cfg = cavity.cavity_config(T=0.3)
    scan_cfg.newton.max_iters = 2  # solve() then takes the scanned loop's 2 sweeps a step

    def cavity_solver(T):
        cfg = copy.deepcopy(scan_cfg)
        cfg.T = T
        s = nt.NavierStokesSolver(cmesh, cfg, log=nt.RunLog(verbose=False), inlet=cavity.lid,
                                  device=DEV)
        return s.setup()

    sa = cavity_solver(0.3)
    n_u = sa.dofs.n_u

    def functional(u):  # ||u||_2 and max|u| of the velocity
        return torch.stack([torch.linalg.vector_norm(u[:n_u]), u[:n_u].abs().max()])

    seen = []

    def progress(step, t, f, res=None, iters=None, reaction=None):
        seen.append(step)
        print(f"  progress: step {step}, t {t:.2f}, ||u|| {f[-1][0]:.6f}, max|u| {f[-1][1]:.6f}, "
              f"||r|| {res[-1]:.3e}, GMRES {[int(i) for i in iters]}, lid reaction {reaction[-1]}",
              flush=True)

    W.reset_launch_counts()
    t0 = time.perf_counter()
    out = sa.solve_scanned(chunk=2, newton_iters=2, functional=functional, reaction_tags=(3,),
                           progress=progress)
    torch.cuda.synchronize()
    t_scan = time.perf_counter() - t0
    scan_launches = W.launch_counts()
    u6 = sa.solution.clone()
    shapes = {k: None if v is None else v.shape for k, v in out.items()}
    print(f"  solve_scanned: 6 steps in {t_scan:.2f} s; per step ||r|| "
          f"{['%.3e' % r for r in out['residual']]}, GMRES {[int(i) for i in out['gmres_iters']]}; "
          f"shapes {shapes}; launches {scan_launches}", flush=True)
    if (seen != [2, 4, 6] or shapes != {"functional": (6, 2), "reaction": (6, 2),
                                        "residual": (6,), "gmres_iters": (6,)}
            or not all(np.isfinite(v).all() for v in out.values())
            or not bool(torch.isfinite(u6).all())):
        raise RuntimeError("solve_scanned's outputs are not what was asked for")
    if min(scan_launches.values()) == 0:
        raise RuntimeError(f"a kernel was never launched by solve_scanned: {scan_launches}")
    t0 = time.perf_counter()
    sa.solve()
    torch.cuda.synchronize()
    gap = float((sa.solution - u6).abs().max())
    print(f"  solve(), the same 6 steps: {time.perf_counter() - t0:.2f} s; max|u_scanned - "
          f"u_solve| {gap:.3e} (tol {SCAN_HOST_TOL:g}), bit-equal "
          f"{torch.equal(sa.solution, u6)}", flush=True)
    if gap > SCAN_HOST_TOL:
        raise RuntimeError("solve_scanned and solve() disagree")
    # solve() logs what the scanned loop does not: each tangent solve that
    # missed rel_tol (krylov_failure, its final ||r||) after its Newton
    # iteration's entry residual (||b||)
    b_norm, short = None, []
    for r in sa.log.records:
        if r.get("event") == "newton":
            b_norm = r["residual"]
        elif r.get("event") == "krylov_failure" and r.get("system") == "tangent":
            short.append(f"{r['iters']} iterations, ||r||/||b|| {r['residual'] / b_norm:.3e}")
    print(f"  solve()'s tangent solves that did not reach rel_tol "
          f"{scan_cfg.krylov.rel_tol:g} (stalled or capped): {len(short)} {short}", flush=True)
    sb = cavity_solver(0.2)
    sb.solve_scanned(chunk=2, newton_iters=2)
    sc = cavity_solver(0.3)
    # what restore_checkpoint sets, handed over on the card (no h5py there)
    for key in ("solution", "solution_old", "solution_old2"):
        setattr(sc, key, getattr(sb, key).clone())
    sc.time, sc._step = sb.time, sb._step
    sc.solve_scanned(chunk=2, newton_iters=2, resume=True)
    torch.cuda.synchronize()
    same = torch.equal(sc.solution, u6)
    print(f"  4 steps, state handed to a new solver at step {sb._step}, 2 more steps: "
          f"bit-equal to the 6-step run {same} (max|diff| "
          f"{float((sc.solution - u6).abs().max()):.3e})", flush=True)
    if not same or sc._step != 6:
        raise RuntimeError("the resumed cavity run differs from the run without a break")


def forced_step(solver, seed=0, reps=3):
    """``reps`` forced Newton steps at the seeded state 0.05 *
    standard_normal (numpy seed): each one's wall time, output and kernel
    launches; the steps must converge, take equal FGMRES counts and give
    bit-equal updates."""
    n = solver.dofs.n_total
    state = torch.as_tensor(0.05 * np.random.default_rng(seed).standard_normal(n),
                            dtype=torch.float32, device=DEV)
    bc_vals = torch.as_tensor(solver.dirichlet.values(solver.cfg.dt), dtype=torch.float32,
                              device=DEV)
    times, outs = [], []
    for _ in range(reps):
        W.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = solver._newton_iteration(state, torch.zeros_like(state), bc_vals,
                                       solver.cfg.dt, True)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        outs.append(out)
        step_launches = {k.split()[0]: v for k, v in W.launch_counts().items()}
        print(f"  forced Newton step: {times[-1] * 1e3:.1f} ms, ||r|| {out[1]:.6e}, "
              f"GMRES iterations {out[2]}, converged {out[3]}", flush=True)
        if not out[3]:
            raise RuntimeError("forced Newton step: tangent solve did not converge")
    same_iters = len({o[2] for o in outs}) == 1
    same_update = all(torch.equal(o[0], outs[0][0]) for o in outs[1:])
    print(f"  median {np.median(times) * 1e3:.1f} ms; launches in one step: {step_launches}\n"
          f"  the {reps} steps: equal FGMRES counts {same_iters} ({[o[2] for o in outs]}), "
          f"bit-equal u_new {same_update}", flush=True)
    if not (same_iters and same_update):
        raise RuntimeError("forced Newton steps from one state differ from run to run")
    return step_launches


def box_parity():
    """Phase 14(d): refine_uniform(box(4, 4, 4), 1), 2 BDF1 steps: float32
    on the card (the kernels) against float64 on the CPU (the plain
    versions), tangents solved to 1e-6 in both; the card's run with the
    tangent stored in float32 (rows within PARITY_TOL of each step's entry
    residual) and in bf16 as on the main path (BOX_BF16_PARITY_TOL)."""
    mesh = nt.refine_uniform(nt.box(4, 4, 4), 1)
    runs = {}
    for key, dtype, device, store in (("float64 CPU", "float64", "cpu", "float32"),
                                      ("float32 GPU, f32 tangent", "float32", DEV, "float32"),
                                      ("float32 GPU, bf16 tangent", "float32", DEV, "bfloat16")):
        cfg = kb.box_config(dtype, BOX_PARITY_REL_TOL)
        cfg.krylov.tangent_store_dtype = store
        plog = nt.RunLog(verbose=False)
        s = nt.NavierStokesSolver(mesh, cfg, log=plog, inlet=kb.box_inlet, device=device)
        t0 = time.perf_counter()
        s.solve()
        runs[key] = trajectory(plog.records)
        print(f"  {key}: {mesh.n_cells} cells, n_total {s.dofs.n_total}, "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    ref = runs.pop("float64 CPU")
    if len(ref) != 2:
        raise RuntimeError("the parity run did not take 2 steps")
    for key, tol in (("float32 GPU, f32 tangent", PARITY_TOL),
                     ("float32 GPU, bf16 tangent", BOX_BF16_PARITY_TOL)):
        for (step, r64, _, f64), (_, r32, _, f32) in zip(ref, runs[key]):
            worst = max(abs(a - b) for a, b in zip(r64, r32)) / r64[0]
            print(f"  step {step}: f64 {['%.6e' % v for v in r64]}\n"
                  f"          {key} {['%.6e' % v for v in r32]}  worst |diff|/entry "
                  f"{worst:.2e} (tol {tol:g})", flush=True)
            if len(r64) != len(r32) or worst > tol or f64 or f32:
                raise RuntimeError(f"step {step}: {key} departs from the float64 CPU run")


def box_phase():
    """Phase 14: the 3D path (P2/P1 tetrahedra) on the 196,608-tet box:
    (a) the kernels against their plain versions at its layout, (b) two
    BDF1 steps from rest with the ramped inlet, (c) a forced Newton step,
    (d) small-mesh parity.  Returns (a)'s records, (b)'s launches and (c)'s
    launches in one step."""
    phase("14 3D: P2/P1 tetrahedra, refine_uniform(box(8, 8, 8), 2), windowed + "
          "Cahouet-Chabard, float32")
    mesh = kb.box_mesh()
    log = nt.RunLog(verbose=False)
    t0 = time.perf_counter()
    solver = nt.NavierStokesSolver(mesh, kb.box_config(), log=log, inlet=kb.box_inlet,
                                   device=DEV)
    solver.setup()
    torch.cuda.synchronize()
    t_setup = time.perf_counter() - t0
    lay, pk = solver._win_layout, solver._win_layout._packed
    if lay.dim != 3 or solver._matvec != "windowed":
        raise RuntimeError("the box did not take the 3D windowed path")
    print(f"  cells {mesh.n_cells}  n_total {solver.dofs.n_total}  nb {lay.nb}  Bmax {lay.Bmax}  "
          f"Bc {lay.Bc}  nchunks {lay.nchunks}  ncd {lay.ncd} (pad {lay.pad_factor:.2f})  "
          f"OWv/OWp {lay.OWv}/{lay.OWp}  hv/hp {lay.hv}/{lay.hp}  RVv/RVp {lay.RVv}/{lay.RVp}  "
          f"nl/nli {lay.nl}/{lay.nli}  tables {pk.pos_v.dtype}  slot colours {pk.ncolors}  "
          f"A_t {tuple(solver._wassembly.A_const.shape)} {solver._wassembly.A_const.dtype}  "
          f"setup {t_setup:.2f} s; device memory {torch.cuda.memory_allocated() / 1e9:.2f} GB",
          flush=True)
    print("  (a) kernels vs plain at the box's layout", flush=True)
    recs = kernels_vs_plain(solver)

    print("  (b) 2 BDF1 steps from rest, ramped inlet", flush=True)
    marks = []

    def mark(step, t, sol):
        torch.cuda.synchronize()
        marks.append(time.perf_counter())

    solver.output_hooks.append(mark)
    W.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    solver.solve()
    torch.cuda.synchronize()
    t_solve = time.perf_counter() - t0
    launches = W.launch_counts()
    solver.output_hooks.remove(mark)
    steps = trajectory(log.records)
    check_converged(steps, solver.cfg.newton.tol)
    if len(steps) != 2 or not bool(torch.isfinite(solver.solution).all()):
        raise RuntimeError("the box run did not take 2 finite steps")
    step_s = np.diff([t0, *marks])
    vel = solver.velocity(real_only=True)
    print(f"  solve {t_solve:.2f} s; step times {['%.2f s' % t for t in step_s]}; max |u| "
          f"{np.abs(vel).max():.4e}; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; launches {launches}", flush=True)
    if min(launches.values()) == 0:
        raise RuntimeError(f"a kernel of the 3D path was never launched: {launches}")

    print("  (c) forced Newton step at a seeded state", flush=True)
    step_launches = forced_step(solver)
    if min(step_launches.values()) == 0:
        raise RuntimeError(f"a kernel was not launched by the 3D Newton step: {step_launches}")
    del solver

    print("  (d) small-mesh parity: float32 GPU kernels vs float64 CPU plain versions",
          flush=True)
    box_parity()
    return recs, launches, step_launches


MEASURED = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "library",
            "cold_clean_ms", "warm_ms", "host_us")


def kernel_entries(recs, launches, step_launches, suffix):
    """The kernels line's entries of K1-K4 from ``kernels_vs_plain``'s
    records: the launches of a main-path run and of one forced Newton step,
    the largest error over a kernel's calls, the measured numbers of its
    timed call, and the others' under ``also``."""
    names = {"K1": "K1 windowed_matvec", "K2": "K2 windowed_matvec_block",
             "K3": "K3 windowed_gather", "K4": "K4 windowed_scatter"}
    counts = {k.split()[0]: v for k, v in launches.items()}
    timed = {"K1": "K1", "K2": "K2 v->v", "K3": "K3", "K4": "K4"}
    out = []
    for k in ("K1", "K2", "K3", "K4"):
        mine = {key: r for key, r in recs.items() if key.split()[0] == k}
        entry = dict(
            name=names[k] + suffix, route="cuda", source=KERNEL_SOURCE, replaces=REPLACES[k],
            launches=counts[k], launches_per_newton_step=step_launches[k],
            max_abs_err=max(r["max_abs_err"] for r in mine.values()), timed=timed[k],
            **{key: recs[timed[k]][key] for key in MEASURED},
            replay_ms=recs[timed[k]].get("replay_ms"),
        )
        if len(mine) > 1:  # the other operands of the same kernel
            entry["also"] = {key: {m: r.get(m) for m in (*MEASURED, "replay_ms")}
                             for key, r in mine.items() if key != timed[k]}
        out.append(entry)
    return out


def main():
    phase("1 device")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"  torch {torch.__version__} CUDA {torch.version.cuda}; device 0: {name}")
    print(f"  nvidia-smi: {smi}", flush=True)

    phase("2 build")
    with ThreadPoolExecutor(2) as pool:  # one nvcc per source, started together
        builds = list(pool.map(lambda build: build(), (W.build_kernels, mxu.build_kernel)))
    for info in builds:
        print(f"  {' '.join(info['cmd'] or ['(library already built)'])}")
        print(f"  built {info['path']} in {info['seconds']:.1f} s")
        for line in ptxas_summary(info["log"]):
            print(f"  ptxas: {line}")

    phase("3 kernels vs plain at the channel's shapes")
    mesh = nt.refine_uniform(nt.rectangle(80, 40, 0, 7, 0, 4), 2)
    log = nt.RunLog(verbose=False)
    solver = nt.NavierStokesSolver(mesh, config(), log=log, device=DEV)
    t0 = time.perf_counter()
    solver.setup()
    torch.cuda.synchronize()
    t_setup = time.perf_counter() - t0
    lay = solver._win_layout
    print(f"  cells {mesh.n_cells}  n_total {solver.dofs.n_total}  nb {lay.nb}  "
          f"Bmax {lay.Bmax}  nchunks {lay.nchunks}  ncd {lay.ncd}  OWv/OWp {lay.OWv}/"
          f"{lay.OWp}  hv/hp {lay.hv}/{lay.hp}  nl/nli {lay.nl}/{lay.nli}  "
          f"setup {t_setup:.2f} s", flush=True)
    n = solver.dofs.n_total
    recs = kernels_vs_plain(solver)

    phase("4 slice: 3 BDF1 steps, float32, windowed + Cahouet-Chabard")
    W.reset_launch_counts()
    t0 = time.perf_counter()
    solver.solve()
    torch.cuda.synchronize()
    t_solve = time.perf_counter() - t0
    launches = W.launch_counts()
    steps = trajectory(log.records)
    check_converged(steps, solver.cfg.newton.tol)
    sol = solver.solution
    if sol.shape != (n,) or not bool(torch.isfinite(sol).all()):
        raise RuntimeError("solution is not a finite vector of the system's size")
    vel = solver.velocity(real_only=True)
    print(f"  solve {t_solve:.2f} s; newton_iteration phase: "
          f"{solver.timers.totals['newton_iteration']:.2f} s over "
          f"{solver.timers.counts['newton_iteration']} iterations; "
          f"max |u| {np.abs(vel).max():.4e}", flush=True)

    phase("5 forced Newton step at a seeded state")
    step_launches = forced_step(solver)

    phase("6 kernel launches during phase 4")
    for k, v in launches.items():
        print(f"  {k}: {v}")
    if min(launches.values()) == 0:
        raise RuntimeError(f"a kernel of the main path was never launched: {launches}")

    phase("7 small-mesh parity: float32 GPU kernels vs float64 CPU plain versions")
    for forcing in (None, forcing_xt):
        runs = {}
        for dtype, device, rel in (("float64", "cpu", 1e-9), ("float32", DEV, 1e-6)):
            plog = nt.RunLog(verbose=False)
            s = nt.NavierStokesSolver(nt.unit_square(6), config(dtype, rel, cells_per_block=16),
                                      log=plog, forcing=forcing, device=device)
            s.solve()
            runs[dtype] = trajectory(plog.records)
        if forcing is not None:
            print("  with the time-dependent forcing f(x, t) "
                  f"(re-evaluated each step: {s._forcing_time_dep}):")
        for (step, r64, _, f64), (_, r32, _, f32) in zip(runs["float64"], runs["float32"]):
            worst = max(abs(a - b) for a, b in zip(r64, r32)) / r64[0]
            print(f"  step {step}: f64 {['%.6e' % v for v in r64]}\n"
                  f"          f32 {['%.6e' % v for v in r32]}  worst |diff|/entry {worst:.2e}")
            if len(r64) != len(r32) or worst > PARITY_TOL or f64 or f32:
                raise RuntimeError(f"step {step}: float32 GPU run departs from float64 CPU run")
        if len(runs["float64"]) != 3 or len(runs["float32"]) != 3:
            raise RuntimeError("parity runs did not take 3 steps")

    phase("8 probe: K5 against its plain version, then the probe's entry point")
    gen = torch.Generator().manual_seed(5)
    probe_recs = {}
    for M in mxu.M_VALUES:
        a = torch.randn((8 * M, mxu.K), generator=gen).to(torch.bfloat16).to(DEV)
        b = torch.randn((mxu.K, mxu.N), generator=gen).to(torch.bfloat16).to(DEV)
        probe_recs[M] = compare(
            f"K5 probe M={M}, {PROBE_CHECK_ITERS} products",
            lambda: mxu.mxu_probe(a, b, M, PROBE_CHECK_ITERS),
            lambda: mxu.mxu_probe_reference(a, b, M, PROBE_CHECK_ITERS),
        )
        probe_recs[M]["grid"] = mxu.mxu_probe.grid  # what the timed launches used
    # K5's bound and yardsticks at the largest M: the products' operations
    # over the tensor cores' peak (or the operands' bytes, if that took
    # longer); one torch.mm of the same products; the same products as bf16
    # torch.matmul calls replayed from a CUDA graph (a and b are the last M's
    # operands)
    m_max = max(mxu.M_VALUES)
    k5 = probe_recs[m_max]
    sms = torch.cuda.get_device_properties(DEV).multi_processor_count
    k5["replay_ms"] = check_graph_replay(
        f"K5 M={m_max}", lambda: mxu.mxu_probe(a, b, m_max, PROBE_CHECK_ITERS), a)
    flops = 2.0 * m_max * mxu.K * mxu.N * PROBE_CHECK_ITERS
    moved = a.numel() * 2 + b.numel() * 2 + m_max * mxu.N * 4
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, moved / PEAK_BYTES_PER_S * 1e3
    k5.update(bound_ms=max(t_ops, t_bytes), bound_by="operations" if t_ops >= t_bytes else "bytes")
    k5["share"] = k5["bound_ms"] / k5["ms"]
    k5["library_graph_ms"] = matmul_graph_ms(a, b, m_max, PROBE_CHECK_ITERS)
    one_call, k5["library"] = probe_one_call(a, b, m_max, PROBE_CHECK_ITERS)
    want = mxu.mxu_probe_reference(a, b, m_max, PROBE_CHECK_ITERS)
    err = float((one_call() - want).abs().max())
    if err > 1e-5 * float(want.abs().max()):
        raise RuntimeError(f"K5's one-call yardstick is not K5's function ({err:.3e})")
    k5["library_ms"] = cuda_ms_cold(one_call)
    g = k5["grid"]
    print(f"  K5 M={m_max}: grid {g['m_tiles']} x {g['n_tiles']} tiles x {g['groups']} groups "
          f"= {g['ctas']} CTAs on {sms} SMs; bound {k5['bound_ms']:.5f} ms by "
          f"{k5['bound_by']} ({flops / 1e9:.2f} GFLOP), kernel {k5['ms']:.4f} ms cold "
          f"(warm {k5['warm_ms']:.4f}), share {k5['share']:.4f}; library: {k5['library']}: "
          f"{k5['library_ms']:.4f} ms cold; {PROBE_CHECK_ITERS} bf16 torch.matmul calls "
          f"replayed from a CUDA graph {k5['library_graph_ms']:.4f} ms", flush=True)
    if k5["share"] > 1.0:
        raise RuntimeError("K5: faster than its bound; the count or the timing is wrong")
    mxu.mxu_probe.launches = 0
    print(f"  python -m navier_stokes_tpu_torch.scripts.mxu_probe --iters {PROBE_ITERS}",
          flush=True)
    if mxu.main(["--iters", str(PROBE_ITERS)]) != 0:
        raise RuntimeError("mxu_probe entry point failed")
    probe_launches = mxu.mxu_probe.launches
    print(f"  K5 launches by the entry point: {probe_launches}")
    if probe_launches == 0:
        raise RuntimeError("the probe's entry point never launched K5")

    phase("9 cli: run on the 6,400-cell channel's .msh (windowed, Cahouet-Chabard, "
          "Stokes guess)")
    # at t = 0 the inlet is zero, so the Stokes guess is u = 0, p = p_out.
    # Near p = p_out = 10, float32 evaluation of its residual b - A x carries
    # ~3.8e-6 of rounding: 0.8 of its 1e-6 relative tolerance on this
    # channel, 1.15 of it on the 25,600-cell one, where no float32 run can
    # meet the tolerance (PERF.md)
    mesh0 = nt.rectangle(80, 40, 0, 7, 0, 4)
    OUT.mkdir(parents=True, exist_ok=True)
    msh = write_msh_v2(mesh0, OUT / "channel.msh")
    cfg_path = OUT / "channel_config.json"
    cli_cfg = config()
    # the Stokes guess leaves step 1's entry residual below newton.tol; one
    # Newton update a step makes each step solve its tangent system (K2)
    cli_cfg.newton.min_iters = 1
    cfg_path.write_text(json.dumps(cli_cfg.to_dict()))
    W.reset_launch_counts()
    t0 = time.perf_counter()
    records = run_cli(
        ["run", "--mesh", str(msh), "--config", str(cfg_path), "--matvec", "windowed",
         "--preconditioner", "cahouet_chabard", "--initial-guess", "stokes", "--T", "0.1",
         "--dtype", "float32"], "cli_run",
    )
    torch.cuda.synchronize()
    t_cli = time.perf_counter() - t0
    cli_launches = W.launch_counts()
    its, fail = stokes_solve(records)
    print(f"  {mesh0.n_cells} cells read from {msh.name}; {t_cli:.2f} s; "
          f"Stokes initial guess: {its} GMRES iterations, "
          + (f"stopped at ||r|| {fail['residual']:.6e} short of its tolerance"
             if fail else "converged"), flush=True)
    if fail:
        raise RuntimeError(f"the Stokes initial guess did not converge: {fail}")
    steps = trajectory(records)
    check_converged(steps, config().newton.tol)
    if len(steps) != 2:
        raise RuntimeError(f"cli run took {len(steps)} steps, not 2")
    print(f"  launches: {cli_launches}")
    if min(cli_launches.values()) == 0:
        raise RuntimeError(f"a kernel was never launched by the cli run: {cli_launches}")

    phase("10 stokes: Poiseuille flow in the unit square, flat and windowed")
    for matvec in ("flat", "windowed"):
        cfg = nt.SolverConfig(inlet_tags=(0,), neumann_tags=(1,), wall_tags=(2, 3),
                              nu=NU, rho=RHO, p_out=POUT)
        cfg.dtype = "float32"
        cfg.krylov.matvec = matvec
        cfg.krylov.preconditioner = "block_triangular"
        cfg.krylov.cells_per_block = 16
        cfg.krylov.max_iters = 1000
        st = nt.StokesSolver(nt.unit_square(8), cfg, log=nt.RunLog(verbose=False),
                             inlet=poiseuille_inlet, device=DEV)
        t0 = time.perf_counter()
        st.solve()
        torch.cuda.synchronize()
        real = st.dofs.v_mask is not None
        vc = st.dofs.v_coords[st.dofs.v_mask] if real else st.dofs.v_coords
        pc = st.dofs.p_coords[st.dofs.p_mask] if real else st.dofs.p_coords
        u_err = np.abs(st.velocity(real_only=True)[:, 0] - vc[:, 1] * (1 - vc[:, 1])).max()
        u_err = max(u_err, np.abs(st.velocity(real_only=True)[:, 1]).max())
        p_err = np.abs(st.pressure(real_only=True) - (POUT + 2 * NU * RHO * (1 - pc[:, 0]))).max()
        print(f"  {matvec}: {int(st.result.iters)} GMRES iterations, converged "
              f"{bool(st.result.converged)} (||r|| {st.result.residual:.3e}), "
              f"{time.perf_counter() - t0:.2f} s; "
              f"max|u - u_exact| {u_err:.3e} (< {STOKES_U_TOL:g}), "
              f"max|p - p_exact| {p_err:.3e} (< {STOKES_P_TOL:g})", flush=True)
        if (st._ns is not None) != (matvec == "windowed"):
            raise RuntimeError(f"StokesSolver did not take the {matvec} path")
        if u_err >= STOKES_U_TOL or p_err >= STOKES_P_TOL:
            raise RuntimeError(f"{matvec} Stokes solve misses the Poiseuille flow")
    sq = write_msh_v2(nt.unit_square(16), OUT / "square.msh")
    records = run_cli(["stokes", "--mesh", str(sq), "--matvec", "windowed"], "cli_stokes")
    its, fail = stokes_solve(records)
    print(f"  stokes command on {sq.name} (windowed): {its} GMRES iterations, "
          f"converged {fail is None}", flush=True)
    if fail:
        raise RuntimeError(f"stokes command did not converge: {fail}")

    phase("11 flat vs windowed on the 25,600-cell channel")
    mesh1 = nt.refine_uniform(nt.rectangle(80, 40, 0, 7, 0, 4), 1)
    entry, nodes = {}, {}
    for matvec, precond in (("flat", "block_triangular"), ("windowed", "cahouet_chabard")):
        cfg = config()
        cfg.krylov.matvec, cfg.krylov.preconditioner = matvec, precond
        s = nt.NavierStokesSolver(mesh1, cfg, log=nt.RunLog(verbose=False), device=DEV)
        s.setup()
        if s._matvec != matvec:
            raise RuntimeError(f"solver took the {s._matvec} path, not {matvec}")
        r, jw = assembled(s, smooth_state(s, 0), smooth_state(s, 1))
        nodes[matvec] = (by_node(s, r), by_node(s, jw))
        zero = torch.zeros(s.dofs.n_total, dtype=torch.float32, device=DEV)
        bc = torch.as_tensor(s.dirichlet.values(cfg.dt), dtype=torch.float32, device=DEV)
        times = []
        for _ in range(2):  # the first call warms the allocator
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = s._newton_iteration(zero, zero, bc, cfg.dt, True)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            if not out[3]:
                raise RuntimeError(f"{matvec}: forced Newton step's tangent solve failed")
        entry[matvec] = out[1]
        print(f"  {matvec} ({precond}): n_total {s.dofs.n_total}, forced Newton step from "
              f"zero: entry ||r|| {out[1]:.7e}, GMRES iterations {out[2]}, "
              f"{times[0] * 1e3:.1f} ms cold, {times[1] * 1e3:.1f} ms warm", flush=True)
    for i, what in enumerate(("residual at a smooth state", "tangent action J w")):
        (cf, vf, pf), (cw, vw, pw) = nodes["flat"][i], nodes["windowed"][i]
        if cf.shape != cw.shape or np.abs(cf - cw).max() > 1e-9:
            raise RuntimeError("flat and windowed DoF nodes do not line up")
        gaps = [np.abs(a - b).max() / np.abs(b).max() for a, b in ((vf, vw), (pf, pw))]
        print(f"  {what}, node by node: velocity rows {gaps[0]:.2e}, pressure rows "
              f"{gaps[1]:.2e} of their max (tol {FLAT_TOL:g})", flush=True)
        if max(gaps) > FLAT_TOL:
            raise RuntimeError(f"flat and windowed {what} disagree")
    gap = abs(entry["flat"] - entry["windowed"]) / entry["windowed"]
    print(f"  entry residuals of the forced step: relative gap {gap:.2e} (tol {FLAT_TOL:g})")
    if gap > FLAT_TOL:
        raise RuntimeError("flat and windowed entry residuals disagree")

    steady_phase()
    scanned_phase()
    recs3, launches3, step_launches3 = box_phase()
    phase.end()

    kernels = (kernel_entries(recs, launches, step_launches, "")
               + kernel_entries(recs3, launches3, step_launches3, ", 3D"))
    kernels.append(dict(
        name="K5 mxu_probe", route="cuda", source=PROBE_SOURCE, replaces=REPLACES["K5"],
        launches=probe_launches, launches_per_newton_step=0,
        max_abs_err=max(r["max_abs_err"] for r in probe_recs.values()),
        timed=f"M={m_max}, {PROBE_CHECK_ITERS} products",
        library_graph_ms=k5["library_graph_ms"], grid=k5["grid"], replay_ms=k5["replay_ms"],
        **{key: k5[key] for key in MEASURED},
    ))
    print()
    print(smi)  # the card's name and power limit, as nvidia-smi gives them
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                              "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
