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
 12. steady     the lid-driven cavity at Re 100 on rectangle(128, 128)
                (32,768 cells), float32: solve_steady from the Stokes guess
                with FGMRES tangents must converge, its centrelines within
                0.01 of Ghia et al.'s; K1-K4 must all launch.  At n = 32 the
                float32 FGMRES solve against a float64 SuperLU one
 13. scanned    the cavity at n = SCAN_N (32: 2,048 cells), BDF2, dt
                0.05: 6 steps of solve_scanned
                (chunks of 2, 2 Newton sweeps, a functional, a progress
                callback, the lid's reaction) against the same 6 steps of
                solve(); 4 steps in a second solver, its state handed to a
                third that resumes for 2: bit-equal to the 6-step run
 14. 3d         P2/P1 tetrahedra on refine_uniform(box(8, 8, 8), 2)
                (196,608 cells; kernel_bench.box_config, box_inlet: a ramped
                parabolic inflow), windowed + Cahouet-Chabard, float32 with
                the tangent stored in bf16: (a) phase 3's checks of every
                kernel at the box's layout (halo 5), with the bytes K1, K2
                and K4 really move and the size of the compact scratch;
                (b) 2 BDF1 steps from rest, every Newton loop converging,
                K1-K4 all launched, the peak device memory; (c) three
                forced Newton steps at a seeded state, as phase 5;
                (d) refine_uniform(box(4, 4, 4), 1): float32 on the GPU
                against float64 on the CPU over 2 steps, with the tangent
                stored in float32 and in bf16; (e) phase 15's one-device
                runs of the box: a forced step at (c)'s state and the 2
                steps, at the 2-rank numbering and at another (nb_multiple
                3, the control)
 15. multi-rank the channel of phases 3-6 on 2 and then 4 ranks of the one
                card, each rank a process (spawned, joined through
                initialize_distributed) in a gloo group (NCCL refuses two
                ranks on one device; the edge blocks go through pinned host
                buffers), the windowed operator sharded by owned block
                ranges, against one device at the ranks' numbering
                (nb_multiple) and phase 4-5: per rank, (a) K1-K4 against
                their plain versions at its framed local layout, the
                sharded wrappers against theirs with the group and the
                sharded gather and scatter against one device's, and the
                floats one K1 product sends; (b) two forced Newton steps at
                phase 5's state (bit-equal; entry ||r|| within 1e-6 of
                phase 5's, FGMRES count within 2, the update node by node
                within MULTI_UPDATE_TOL, K1-K4 launched on every rank); the
                forced step's wall time at 1, 2 and 4 ranks (the sharded
                BDF1 steps run on the tight leg and the box).  The tight
                leg: phase 11's channel on 2 ranks against one device at
                their numbering, 2 BDF1 steps with every solve tightened
                (TIGHT_REL_TOL, TIGHT_NEWTON_TOL), the velocity node by node within
                TIGHT_VEL_TOL, a control with the inflow scaled by 1 +
                TIGHT_INLET_CONTROL failing it.  The box of phase 14 on 2
                and 4 ranks: per rank its framed layout's compact tables,
                (a) as above, and at 2 ranks (b) and (c) against phase
                14(e)'s runs (the BOX_* bounds, each with the control at
                another numbering failing it); launches, floats a K1
                product, the frame's share of slot columns and the peak
                device memory per rank; the forced step's wall time at 1
                and 2 ranks.  The flat operator's design (parallel/spmd.py:
                Morton chunks of the cells a rank, vectors whole on every
                rank, each assembly and product all-reduced) on 2 and 4
                ranks against one device: (f) the 102,400-cell channel's
                flat residual and J w at phase 11's smooth state, node by
                node within FLAT_TOL; (g) phase 11's 25,600-cell channel
                (block_triangular): a forced Newton step from zero (entry
                ||r||, FGMRES count, the update within FLAT_UPDATE_TOL, a
                start nudged FLAT_NUDGE a dof printed beside it; its time
                at 1, 2 and 4 ranks) and, at FLAT_STEP_RANKS ranks (2), 2
                BDF1 steps from the Stokes guess; every rank's update (and
                state) bit-equal to rank 0's.  At 4 ranks the box's kernels
                run on the bare
                framed layout with seeded operands (no solver set-up: cut
                for time).  Sharded P3/P2: (h) K1-K4 at every rank's framed
                layout of the P3/P2 channel (halo 1) and of the 196,608-tet
                P3/P2 box (halo 6) on seeded operands, each against its
                plain version, a repeat bit-equal, the sharded wrappers
                against theirs and one device's; (i) at P3_RANKS ranks
                against one device at their numbering, the P3/P2
                channel's forced step (no preconditioner) and box(6, 6,
                6) at P3_BOX_CPB cells a block (halo 6, Cahouet-Chabard):
                a forced step and 2 BDF1 steps, held to the BOX_* bounds
 16. p3         Taylor-Hood P3/P2 (cubic velocity, quadratic pressure:
                kernel_bench.channel_config / box_config with degree=3, no
                preconditioner), float32: (a) phase 3's checks of every
                kernel at the 102,400-cell channel's P3/P2 layout, with the
                launch of each product on the streaming kernel (K1, and K2
                v->v on triangles, v->p and p->p on tetrahedra: ring,
                shared memory, resident blocks, grid, share of the bound),
                the sizes of K2 v->p and p->p on triangles on the narrow
                kernels (the slots, Y, the row list), K4's route (the
                row-ordered sum over R) with its rows and row lists, and
                the bytes each really moves; (b) there,
                three forced Newton steps at a seeded state (bit-equal, equal
                FGMRES counts) and 2 BDF1 steps from rest (K1, K3 and K4
                launched; a tangent solve may stop at its cap, printed with
                its last ||r||/||b||); (c) three Cahouet-Chabard forced steps
                capped at P3_CC_CAP FGMRES iterations (bit-equal; K2 launched
                in each space pair); (d) unit_square(4): float32 on the GPU
                against float64 on the CPU as phase 7; (e) (a) at the
                196,608-tet box's P3/P2 layout (halo 6, int32 position
                tables) on seeded operands, without the solver's ~200 s
                set-up there, and (b)-(c) on the box refined once (24,576
                tets), with the peak device memory
 17. deflation  FGMRES deflation (krylov.kp_deflate 2: the pinned Kp's
                near-null modes, each paired with its velocity response),
                float32, windowed + Cahouet-Chabard without the Kp coarse
                space, the outer operator in float32: (a) the weakly pinned
                channel refine_uniform(rectangle(160, 16, 0, 4, 0, 0.4), 2)
                (81,920 cells, the outlet one short edge): 4 unit rows on the
                card, alternating pressure and velocity, and the host time
                of the Kp probe and of the responses; (b) three deflated
                forced Newton steps at a seeded state (bit-equal, equal
                counts, converged; K1 and K2 launched) and one undeflated;
                (c) 2 BDF1 steps from rest, deflated: every Newton loop
                converges (a tangent solve that stalls, capped at
                DEFL_MAX_ITERS, is printed); (d) rectangle(48, 6, 0, 4, 0, 0.4) (576 cells):
                the card's rows equal the CPU's (sign included), and a
                forced Newton step whose tangent solve is one FGMRES cycle
                of DEFL_CYCLE steps, deflated with the CPU's rows, float32
                on the card within DEFL_STEP_TOL of float64 on the CPU; the
                card's cycle without rows, the control, outside it;
                (e) K1-K4
                against their plain versions at Morton-ordered layouts
                (renumber_blocked(order="sfc"), SFC_LAYOUTS): the 6,400-,
                25,600- and 102,400-cell channels at P2/P1, the
                102,400-cell channel at P3/P2 and the box refined once; at
                2D P2/P1 the route each layout took (the larger channels'
                subwindows outgrow a block's shared memory, so their K1, K2
                and K4 run the compact kernels, held against the compact
                order's plain versions; the profiler names the kernels that
                ran); at the 102,400-cell one phase 3's times, bound and
                library calls (the kernels line's ", 2D P2/P1 Morton layout
                (compact route)" entries)
 18. trajectory the float32 trajectory check of
                navier_stokes_tpu_torch/scripts/trajectory_parity.py on
                rectangle(40, 20, 0, 7, 0, 4) (1,600 cells), TRAJ_STEPS
                BDF1 steps of the dynamic inlet with tight tangents: float64
                on the CPU against float32 on the card, the same Newton
                stopping decisions and every entry row within
                TRAJ_ENTRY_TOL; two controls outside it, the float32 run
                with u_m 1 % larger and with its outer operator in bf16

Each phase prints its wall time.
Files the phases write (.msh, configs, run logs) go to build/chip_smoke/.
The next-to-last line is the kernels' JSON record, and the last line is
{"ok": true, "device": {...}}.  The record has K1-K4 five times, at the
channel (phases 3-5) and at the box (", 3D": phase 14) at P2/P1, at both
at P3/P2 (", P3" and ", 3D P3": phase 16), at the 102,400-cell channel's
Morton layout on the compact route (phase 17(e)), and K5.  Per
kernel: ``launches`` on the main path (phase 4, 14(b); 16(b)'s steps, K2
16(c)'s Cahouet-Chabard steps; the compact route: 17(e)'s one call of each
wrapper, 0 a Newton step, since the solver orders by RCM; K5: its entry
point), ``launches_per_newton_step`` (phase 5, 14(c), 16(b) and (c)), ``max_abs_err``
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
The K1-K4 entries, at P2/P1 and at P3/P2, also carry phase 15's sharded
runs: ``sharded_launches`` (each rank's launches in its run at 2 ranks: at
both channels the forced step, at the box its 2 BDF1 steps, at the P3/P2
box box(6, 6, 6)'s forced step and steps) and ``sharded_max_abs_err`` /
``sharded_max_abs_err_4`` (the largest error at the ranks' framed layouts,
alone and sharded, against the plain versions and one device's, at 2 / 4
ranks); null for K5.
"""

import contextlib
import copy
import dataclasses
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
from navier_stokes_tpu_torch.parallel import windowed_spmd as wspmd  # noqa: E402
from navier_stokes_tpu_torch.scripts import cavity  # noqa: E402
from navier_stokes_tpu_torch.scripts import kernel_bench as kb  # noqa: E402
from navier_stokes_tpu_torch.scripts import mxu_probe as mxu  # noqa: E402
from navier_stokes_tpu_torch.scripts import trajectory_parity as tp  # noqa: E402
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
# the lid-driven cavity (phases 12-13): n x n squares cut in two triangles,
# at Ghia's own grid width (129 x 129 points); at 256 phase 12 took 184 s
# of the script's 1,200 on an H100 whose host ran slow, and the script went
# over its limit.  Phase 13 compares solve_scanned with solve() bit for bit,
# which no size changes: at 128 it took 73.9-100.3 s of a run that reached
# 1,195.4 s on a slow host, so it runs at 32
CAVITY_N, CAVITY_SMALL_N, SCAN_N = 128, 32, 32
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
    ``end()``), its wall time; ``end()`` also the time since the first."""

    def __init__(self):
        self.name, self.t0, self.start = None, 0.0, None

    def __call__(self, name):
        self.end()
        if self.start is None:
            self.start = time.perf_counter()
        print(f"\n== {name}", flush=True)
        self.name, self.t0 = name, time.perf_counter()

    def end(self):
        if self.name is not None:
            print(f"  [phase {self.name.split()[0]}: {time.perf_counter() - self.t0:.1f} s]",
                  flush=True)
        self.name = None

    def total(self):
        self.end()
        print(f"  [all phases: {time.perf_counter() - self.start:.1f} s]", flush=True)


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
    element operators (all-reduced over a sharded run's ranks), or the
    windowed kernels K3/K4 and K1."""
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
                             r.new_zeros(0), ctx.scatter_full, ctx.n_total, group=ctx.group)
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


def kernels_vs_plain(lay, operands):
    """Every wrapper call of ``operands`` (``kb.wrapper_operands`` of a
    solver, or ``kb.seeded_operands`` of a bare layout) at layout lay
    against its plain version (``compare``: errors, times, the bound and one
    PyTorch call of the same function, built outside the timing: K3, K4
    through the flat dof index, K1 and each K2 product a CSR product), then
    each called twice on the same inputs (equal bits) and replayed from a
    CUDA graph (equal bits to an eager call).  Returns the records by call."""
    calls, ops_ = operands
    check_packed_tables(lay)
    bounds = kb.bound_bytes_of(lay, ops_)
    moved = kb.moved_bytes_compact(lay, ops_)
    recs = {}
    for key, (kernel, plain) in calls.items():
        lib_call, lib_what = kb.library_call(lay, ops_, key)
        print(f"  {key} yardstick: {lib_what}", flush=True)
        recs[key] = compare(TITLES.get(key, f"{key}, bf16 A"), kernel, plain,
                            exact=key.startswith("K3"), bound_bytes=bounds[key], library=lib_call)
        recs[key]["library"] = lib_what
        if key.startswith(("K1", "K2")):  # the CUDA kernels that served it
            spaces = ("vp", "vp") if key.startswith("K1") else key.split()[1].split("->")
            recs[key]["design"] = W.matvec_design(lay, *spaces)
        elif key == "K4":
            recs[key]["design"] = W.scatter_design(lay)
        if key in moved:  # a host count from the tables, printed and not in the kernels line
            print(f"  {key} really moves {moved[key] / 1e6:.1f} MB "
                  "(kernel_bench.moved_bytes_compact)", flush=True)
        del lib_call  # a CSR matrix holds gigabytes at the box's size
    for key in calls:  # P3/P2: the products on the streaming kernel; how each launched
        spaces = kb.stream_spaces(lay, key, ops_)
        if spaces:
            cfg = recs[key]["stream"] = W.stream_config(lay, *spaces)
            print(f"  {key}: streaming kernel, a ring of {cfg['stages']} stages of "
                  f"{cfg['stage_bytes']} bytes, {cfg['smem_bytes']} bytes of shared memory a "
                  f"block, {cfg['blocks_per_sm']} resident block(s) an SM, a persistent grid of "
                  f"{cfg['grid']} blocks over {cfg['chunks']} occupied chunks; share "
                  f"{recs[key]['share']:.3f} of the bound", flush=True)
        elif key == "K4" and W.scatter_rows(lay):
            rows = lay._packed.rows
            pairs = {s: rows[s][1].numel() for s in "vp"}
            mb = 4 * sum(t.numel() for s in "vp" for t in rows[s]) / 1e6
            print(f"  K4: {recs[key]['design']}, a thread a row over {lay.n_vs} velocity rows "
                  f"({lay.dim} components a walk) and {lay.n_ps} pressure rows, row lists of "
                  f"{pairs['v']} and {pairs['p']} (slot, dof) pairs ({mb:.1f} MB with their "
                  f"offsets), no scratch; share {recs[key]['share']:.3f} of the bound",
                  flush=True)
        elif key.startswith("K2 ") and W.narrow(lay, *key.split()[1].split("->")):
            ptr, lst = lay._packed.rows["p"]
            print(f"  {key}: narrow kernels, a thread a slot over {lay.ncd} slots into Y "
                  f"[{lay.k_p}, {lay.ncd}], a row list of {lst.numel()} (slot, dof) pairs over "
                  f"{ptr.numel() - 1} rows; share {recs[key]['share']:.3f} of the bound",
                  flush=True)
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
          f"slot colours {pk.ncolors} (2D sums' rounds)  setup {t_setup:.2f} s", flush=True)
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
    """Phase 13: solve_scanned on the n = SCAN_N cavity against solve(),
    and a run resumed in a new solver against the run without a break."""
    cmesh = nt.rectangle(SCAN_N, SCAN_N)
    phase(f"13 scanned: the cavity, n = {SCAN_N}, BDF2, solve_scanned against solve(), "
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


def forced_step(solver, seed=0, reps=3, converge=True):
    """``reps`` forced Newton steps at the seeded state 0.05 *
    standard_normal (numpy seed): each one's wall time, output and kernel
    launches; the steps must take equal FGMRES counts and give bit-equal
    updates, and (``converge``) their tangent solves must converge; a
    solve that stops at its cap prints its last ||r||/||b||.  Returns (one
    step's launches, {the state, its entry ||r||, FGMRES count, median ms,
    whether the solve converged, its last ||r||/||b||})."""
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
              f"GMRES iterations {out[2]}, converged {out[3]}, last ||r||/||b|| "
              f"{out[4] / out[1]:.3e}", flush=True)
        if converge and not out[3]:
            raise RuntimeError("forced Newton step: tangent solve did not converge")
    same_iters = len({o[2] for o in outs}) == 1
    same_update = all(torch.equal(o[0], outs[0][0]) for o in outs[1:])
    print(f"  median {np.median(times) * 1e3:.1f} ms; launches in one step: {step_launches}\n"
          f"  the {reps} steps: equal FGMRES counts {same_iters} ({[o[2] for o in outs]}), "
          f"bit-equal u_new {same_update}", flush=True)
    if not (same_iters and same_update):
        raise RuntimeError("forced Newton steps from one state differ from run to run")
    return step_launches, dict(state=state, u_new=outs[0][0], entry=outs[0][1],
                               iters=outs[0][2], ms=float(np.median(times)) * 1e3,
                               converged=outs[0][3], final_rel=outs[0][4] / outs[0][1])


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
    (d) small-mesh parity; (e) phase 15's one-device references
    (``box_references``).  Returns (a)'s records, (b)'s launches, (c)'s
    launches in one step and (e)."""
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
          f"nl/nli {lay.nl}/{lay.nli}  tables {pk.pos_v.dtype}  no slot colours (3D)  "
          f"A_t {tuple(solver._wassembly.A_const.shape)} {solver._wassembly.A_const.dtype}  "
          f"setup {t_setup:.2f} s; device memory {torch.cuda.memory_allocated() / 1e9:.2f} GB",
          flush=True)
    print("  (a) kernels vs plain at the box's layout", flush=True)
    recs = kernels_vs_plain(solver._win_layout, kb.wrapper_operands(solver))
    tabs = pk.compact
    scratch = [buf.numel() * buf.element_size() for buf in pk._scratch.values()]
    print(f"  scratch: {len(scratch)} buffer(s) (one a stream) of {max(scratch) / 1e6:.1f} MB, "
          f"dim*E_v + E_p = {lay.dim} x {tabs['v'].E} + {tabs['p'].E} floats; peak device "
          f"memory so far {torch.cuda.max_memory_allocated() / 1e9:.2f} GB", flush=True)
    if any(b != 4 * (lay.dim * tabs["v"].E + tabs["p"].E) for b in scratch):
        raise RuntimeError("the 3D scratch is not the compact vector's size")

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
    step_launches, forced = forced_step(solver)
    if min(step_launches.values()) == 0:
        raise RuntimeError(f"a kernel was not launched by the 3D Newton step: {step_launches}")
    t0 = time.perf_counter()
    box_ref = box_references(solver, forced["state"])
    print(f"  (e) phase 15's one-device runs of the box: at the {BOX_RANKS}-rank numbering (nb "
          f"{box_ref['same']['nb']}; phase 14's nb {lay.nb} = {BOX_RANKS} x "
          f"{lay.nb / BOX_RANKS:g}) and, the control, at nb {box_ref['control']['nb']}: "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    del solver

    print("  (d) small-mesh parity: float32 GPU kernels vs float64 CPU plain versions",
          flush=True)
    box_parity()
    return recs, launches, step_launches, box_ref


# ---- phase 15: the windowed path on 2 and 4 ranks ---------------------------

MULTI_RANKS = (2, 4)
# The ranks are held to one device at their own numbering (nb_multiple =
# the rank count: the same blocks, windows and coarse aggregates), so that
# what differs is only the order of float32 sums at halo rows and in the
# all-reduced dots.  Phase 4-5's run has another block count (nb 229
# against 230 and 232), so other Cahouet-Chabard aggregates: it is the
# control that the update and first-residual bounds must tell apart.
# Readings on an NVIDIA H100 80GB HBM3 at 700 W, 2 / 4 ranks (PERF.md):
#
# the entry ||r|| of the forced step at phase 5's state: the same state in
# another numbering, float32 sums in another order (gaps 0 and 1.0e-7)
MULTI_ENTRY_REL_TOL = 1e-6
# the forced step's FGMRES count against phase 5's: float32 rounding in
# another order steers the Krylov iterates
MULTI_ITERS_SLACK = 2
# the forced step's update, node by node, as a share of its largest entry:
# 2.1e-6 / 1.5e-6; the control 4.3e-3 / 4.5e-3
MULTI_UPDATE_TOL = 1e-4
MULTI_TIMEOUT_S = 600  # a group of ranks that takes longer has hung
# the rank counts whose flat leg runs its 2 BDF1 steps from the Stokes guess
# (26.4 s at 2 ranks, one device's 17.9 s); at the others the forced step
# alone
FLAT_STEP_RANKS = (2,)


def channel_mesh():
    """The 102,400-cell channel of phases 3-6 and 15."""
    return nt.refine_uniform(nt.rectangle(80, 40, 0, 7, 0, 4), 2)


def natural(s, y):
    """(velocity [dim, n_v], pressure [n_p]) of solver s's planar vector y
    in the mesh's natural dof order, whatever the blocked numbering."""
    d = s.dofs
    y = np.asarray(y, np.float64)
    return y[: d.n_u].reshape(d.dim, d.n_vs)[:, d.v_perm], y[d.n_u:][d.p_perm]


def from_natural(s, v, p):
    """The planar vector of solver s holding natural-order v and p (zero on
    the padding holes of its numbering)."""
    d = s.dofs
    y = np.zeros(d.n_total)
    y[: d.n_u].reshape(d.dim, d.n_vs)[:, d.v_perm] = v
    y[d.n_u:][d.p_perm] = p
    return y


def node_gap(a, b):
    """max |a - b| over max |b|, the natural-order arrays flattened."""
    a, b = np.concatenate([np.ravel(t) for t in a]), np.concatenate([np.ravel(t) for t in b])
    return float(np.abs(a - b).max() / np.abs(b).max())


def forced_then_steps(s, state, rank=0, steps=True):
    """Solver s (set up here if it is not) on phase 15's work: a forced
    Newton step at a natural-order state (taken twice: bit-equal), then
    (``steps``) its BDF1 steps from rest.  Every rank calls it.  Returns the
    natural-order update and velocities, the entry ||r||, the FGMRES count,
    the Newton residuals and the forced step's wall times."""
    if not s._is_setup:
        s.setup()
    y = from_natural(s, *state)
    if s._dist is not None:
        y = wspmd.to_dist(y, s._dist)[rank * s._n_state:][: s._n_state]
    x = torch.as_tensor(y, dtype=torch.float32, device=DEV)
    bc = s._bc_values(s.cfg.dt)
    outs, times = [], []
    for _ in range(2):
        W.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs.append(s._newton_iteration(x, torch.zeros_like(x), bc, s.cfg.dt, True))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    step_launches = {k.split()[0]: c for k, c in W.launch_counts().items()}
    step_floats = W.exchange_floats()
    (u1, r1, it1, ok1, _), (u2, _, it2, _, _) = outs
    if not (ok1 and it1 == it2 and torch.equal(u1, u2)):
        raise RuntimeError(f"rank {rank}: two forced steps from one state differ "
                           f"({it1} and {it2} FGMRES iterations, converged {ok1})")
    run = dict(update=natural(s, s._planar(u1 - x)), entry=r1, iters=it1,
               step_ms=[t * 1e3 for t in times], step_launches=step_launches,
               step_exchange_floats=step_floats)
    if not steps:
        return run
    vel = {}

    def keep(step, t, sol):
        vel[step] = natural(s, sol.cpu())[0]

    s.output_hooks.append(keep)
    n_rec = len(s.log.records)
    W.reset_launch_counts()
    t0 = time.perf_counter()
    s.solve()
    torch.cuda.synchronize()
    s.output_hooks.remove(keep)
    run.update(velocity=vel, steps=trajectory(s.log.records[n_rec:]),
               solve_s=time.perf_counter() - t0,
               launches={k.split()[0]: c for k, c in W.launch_counts().items()})
    return run


def sharded_vs_plain(s, ops_, rank):
    """On the card, the sharded wrappers (frame, kernel, unframe; the edge
    blocks through pinned host buffers) against their plain versions with
    the same group, at the main path's operands; the gather and the
    scatter also against the global layout's plain versions on the same
    global vectors (seeded alike on every rank).  Returns {name: max|err|}."""
    lay, g, lg, dl = s._win_layout, s._group, s._lay_global, s._dist
    n_u = lay.dim * lay.nvs_own
    rng = np.random.default_rng(11)
    xg = torch.as_tensor(rng.standard_normal(lg.n_u + lg.n_ps), dtype=torch.float32)
    Rg = torch.as_tensor(rng.standard_normal((lg.nli, lg.ncd)), dtype=torch.float32)
    own = slice(rank * dl.nb_loc * lay.Bmax, (rank + 1) * dl.nb_loc * lay.Bmax)
    F = lay.frame * lay.Bmax

    def chunk(v):
        return wspmd.to_dist(v, dl)[rank * dl.llen:][: dl.llen].to(DEV)

    x, xo = chunk(xg), chunk(0.5 * xg)
    R = torch.nn.functional.pad(Rg[:, own], (F, F)).to(DEV)
    calls = {
        "K1 group": (lambda: W.windowed_matvec(lay, ops_["A_bf"], x, g),
                     lambda: W.windowed_matvec_reference(lay, ops_["A_bf"], x, g)),
        "K3 group": (lambda: W.windowed_gather(lay, x, g),
                     lambda: W._gather_reference(lay, x, g)),
        "K3 pair group": (lambda: W.windowed_gather_pair(lay, x, xo, g),
                          lambda: (W._gather_reference(lay, x, g),
                                   W._gather_reference(lay, xo, g))),
        "K4 group": (lambda: W.windowed_scatter(lay, R, g),
                     lambda: W._scatter_reference(lay, R, g)),
    }
    for key, (A_sub, _) in ops_["blocks"].items():
        i, o = key.split("->")
        xi = x[:n_u] if i == "v" else x[n_u:]
        calls[f"K2 {key} group"] = (
            lambda A_sub=A_sub, xi=xi, i=i, o=o: W.windowed_matvec_block(
                lay, A_sub, xi, in_spaces=i, out_spaces=o, group=g),
            lambda A_sub=A_sub, xi=xi, i=i, o=o: W._block_reference(lay, A_sub, xi, i, o, g))
    errs = {}
    for key, (kernel, plain) in calls.items():
        got, want = stacked(kernel()), stacked(plain())
        errs[key] = float((got.double() - want.double()).abs().max())
        ok = (torch.equal(got, want) if key.startswith("K3")
              else errs[key] <= REL_TOL * float(want.double().abs().max()))
        if not ok:
            raise RuntimeError(f"rank {rank}: {key} disagrees with its plain version "
                               f"(max|err| {errs[key]:.3e})")
    # against one device's view: the gather at the owned columns is exact,
    # the scatter's owned chunk within REL_TOL
    X = W.windowed_gather(lay, x, g)[:, F: F + dl.nb_loc * lay.Bmax].cpu()
    errs["K3 global"] = float((X - W._gather_reference(lg, xg)[:, own]).abs().max())
    want = chunk(W._scatter_reference(lg, Rg)).double()
    errs["K4 global"] = float((W.windowed_scatter(lay, R, g).double() - want).abs().max())
    if errs["K3 global"] != 0 or errs["K4 global"] > REL_TOL * float(want.abs().max()):
        raise RuntimeError(f"rank {rank}: the sharded gather or scatter departs from one "
                           f"device's ({errs['K3 global']:.3e}, {errs['K4 global']:.3e})")
    return errs


def rank_kernels(s, rank):
    """Phase 15(a) on one rank of solver s (set up, sharded): K1-K4 against
    their plain versions at its framed layout alone, the sharded wrappers
    against theirs with the group and against one device's
    (``sharded_vs_plain``), the floats one K1 product sends, and a sharded
    K1 product's time against K1's alone at the framed layout."""
    lay = s._win_layout
    res = dict(errs={})
    # a bare framed layout (``_Sharded``) takes seeded operands
    calls, ops_ = (kb.wrapper_operands(s) if hasattr(s, "_wassembly")
                   else kb.seeded_operands(lay))
    for key, (kernel, plain) in calls.items():
        got, want = stacked(kernel()), stacked(plain())
        err = float((got.double() - want.double()).abs().max())
        exact = key.startswith("K3")
        res["errs"][key] = err
        if not (torch.equal(got, want) if exact else err <= REL_TOL * float(want.abs().max())):
            raise RuntimeError(f"rank {rank}: {key} disagrees with its plain version at the "
                               f"framed layout (max|err| {err:.3e})")
    res["errs"].update(sharded_vs_plain(s, ops_, rank))
    x_own = torch.as_tensor(np.random.default_rng(rank).standard_normal(s._n_state),
                            dtype=torch.float32, device=DEV)
    W.reset_launch_counts()
    W.windowed_matvec(lay, ops_["A_bf"], x_own, s._group)
    res["floats_per_matvec"], res["llen"] = W.exchange_floats(), s._n_state
    # what framing costs a product: the sharded K1 product (frame, exchange,
    # K1, exchange, fold) against the bare K1 call at the framed layout,
    # each over 20 warm calls between CUDA events (the exchange syncs)
    res["k1_framed_ms"] = kb.cuda_ms(lambda: W.windowed_matvec(lay, ops_["A_bf"], ops_["x"]))
    res["k1_sharded_ms"] = kb.cuda_ms(
        lambda: W.windowed_matvec(lay, ops_["A_bf"], x_own, s._group))
    return res


def framing(s):
    """The numbers of a rank's framed layout."""
    lay = s._win_layout
    return dict(nb=s._dist.nb, nb_loc=s._dist.nb_loc, frame=lay.frame, nb_framed=lay.nb,
                ncd=lay.ncd, frame_cols=2 * lay.frame * lay.Bmax, OWv=lay.OWv, OWp=lay.OWp,
                hv=lay.hv, hp=lay.hp)


def channel_rank(rank, n, ref):
    """The channel of phases 3-6 on this rank: (a) ``rank_kernels``; (b)
    ``forced_then_steps``' forced step at phase 5's state.  Rank 0 saves
    the natural-order results (the parent compares)."""
    s = nt.NavierStokesSolver(channel_mesh(), config(), log=nt.RunLog(verbose=False),
                              n_devices=n, device=DEV)
    t0 = time.perf_counter()
    s.setup()
    torch.cuda.synchronize()
    res = dict(rank=rank, setup_s=time.perf_counter() - t0, **framing(s))
    res.update(rank_kernels(s, rank))
    run = forced_then_steps(s, ref["state"], rank, steps=False)
    run.setdefault("launches", run["step_launches"])
    if min(run["launches"].values()) == 0:
        raise RuntimeError(f"rank {rank}: a kernel was never launched: {run['launches']}")
    if rank == 0:
        torch.save(run, OUT / f"multi_rank_{n}.pt")
    res.update({k: run.get(k) for k in ("step_ms", "solve_s", "step_launches",
                                        "step_exchange_floats", "launches")})
    return res


def box_rank(rank, n, ref):
    """The 196,608-tet box of phase 14 on this rank: its framed layout's
    compact tables (the 16-bit and shared-memory limits hold per chunk, or
    ``compact_tables`` raises), (a) ``rank_kernels``; at BOX_RANKS ranks
    (b) ``forced_then_steps`` at phase 14's seeded state, phase 14's 2
    BDF1 steps; the peak device memory.  Rank 0 saves (b)'s natural-order
    results.  At another rank count the solver is not set up (cut for
    time): (a) runs on the bare framed layout with seeded operands."""
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    if n == BOX_RANKS:
        s = nt.NavierStokesSolver(kb.box_mesh(), kb.box_config(), log=nt.RunLog(verbose=False),
                                  inlet=kb.box_inlet, n_devices=n, device=DEV)
        s.setup()
    else:
        lay_g, _ = kb.bare_layout(kb.box_mesh(), kb.box_config(), nb_multiple=n, device="cpu")
        s = _Sharded(lay_g, wspmd.make_dist_layout(lay_g, n), rank)
    torch.cuda.synchronize()
    lay = s._win_layout
    if lay.dim != 3 or not lay.frame:
        raise RuntimeError(f"rank {rank}: the box did not take the sharded 3D path")
    res = dict(rank=rank, setup_s=time.perf_counter() - t0, **framing(s))
    pk = lay._packed
    pk.compact_args  # the rank's compact tables, built on its device at first use
    tabs = pk.compact
    res["compact"] = dict(E_v=tabs["v"].E, E_p=tabs["p"].E,
                          max_entries=[tabs["v"].max_entries, tabs["p"].max_entries],
                          max_pairs=[tabs["v"].max_pairs, tabs["p"].max_pairs],
                          smem=W.compact_smem_bytes(lay, tabs), smem_limit=W._MAX_SMEM_BYTES)
    res.update(rank_kernels(s, rank))
    if n == BOX_RANKS:
        run = forced_then_steps(s, ref["box"]["state"], rank)
        if min(run["launches"].values()) == 0 or min(run["step_launches"].values()) == 0:
            raise RuntimeError(f"rank {rank}: a kernel of the 3D path was never launched: "
                               f"{run['launches']}, {run['step_launches']}")
        if rank == 0:
            torch.save(run, OUT / "box_multi.pt")
        res.update({k: run[k] for k in ("step_ms", "solve_s", "step_launches",
                                        "step_exchange_floats", "launches")})
    res["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    return res


def multi_rank(rank, n, init, ref_path):
    """One rank of phase 15 (spawned; joins a gloo group on the one card
    through ``initialize_distributed``): the legs of ``ref["legs"]`` in
    turn, "channel" (``channel_rank``), "tight" at TIGHT_RANKS ranks
    (``tight_rank``), "box" (``box_rank``), "flat" (``flat_rank``) and "p3"
    (``p3_rank_kernels``; at P3_RANKS ranks ``p3_rank_solves``).  Each
    rank writes its numbers to OUT (the parent compares)."""
    from navier_stokes_tpu_torch.parallel.bootstrap import (initialize_distributed,
                                                            shutdown_distributed)

    torch.cuda.set_device(DEV)
    if not initialize_distributed(backend="gloo", init_method=init, world_size=n, rank=rank):
        raise RuntimeError(f"rank {rank}: no process group joined")
    ref = torch.load(ref_path, weights_only=False)
    res = dict(rank=rank)
    if "channel" in ref["legs"]:
        res.update(channel_rank(rank, n, ref))
    torch.cuda.empty_cache()
    if "tight" in ref["legs"] and n == TIGHT_RANKS:
        res["tight"] = tight_rank(rank, n)
    torch.cuda.empty_cache()
    if "box" in ref["legs"]:
        res["box"] = box_rank(rank, n, ref)
    torch.cuda.empty_cache()
    if "flat" in ref["legs"]:
        res["flat"] = flat_rank(rank, n)
    torch.cuda.empty_cache()
    if "p3" in ref["legs"]:
        res["p3_kernels"] = p3_rank_kernels(rank, n)
        if n == P3_RANKS:
            res["p3_solves"] = p3_rank_solves(rank, n, ref)
    (OUT / f"multi_rank_{n}_{rank}.json").write_text(json.dumps(res))
    shutdown_distributed()


# ---- phase 15, the tight leg: sharded BDF1 steps held to a tight bound ------
#
# At the main path's tolerances (rel_tol 1e-2, Newton to an absolute 1e-2)
# the 102,400-cell channel's velocities after 2 BDF1 steps spread by ~0.15
# of max |u| between runs that differ only in the order of float32 sums
# (PERF.md), too wide to tell a sharding fault.  Here 2 BDF1 steps with the
# channel's inlet on phase 11's
# 25,600-cell channel, 2 ranks against one device at their numbering, with
# every tangent solved to 1e-4 and the Newton loop run to an absolute 1e-4:
# the tightest pair that every float32 solve of both runs meets (at 1e-5 some
# tangent solves stall and Newton's residual stays near its float32 floor,
# ~1e-5).  Readings on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md): the
# ranks' velocity within 5.0e-4 (step 1) and 2.8e-4 (step 2) of max |u|;
# one device started from rest nudged by 1e-7 a dof 5.4e-4 and 2.8e-4 (so
# the ranks spread as a rounding-sized nudge does); the control, one device
# with the inflow 0.1 % stronger, 1.3e-3 and 1.2e-3.  The bound sits between
# the ranks' reading and the control's, 1.6x from each.

TIGHT_RANKS = 2
TIGHT_REL_TOL = 1e-4  # every tangent solve's rel_tol
TIGHT_NEWTON_TOL = 1e-4  # Newton's absolute tolerance
TIGHT_VEL_TOL = 8e-4
TIGHT_INLET_CONTROL = 1e-3  # the control's inflow, u_m scaled by 1 + this
TIGHT_NUDGE = 1e-7  # a reading beside it: the start nudged by this times N(0, 1) a dof


def tight_mesh():
    """Phase 11's 25,600-cell channel."""
    return nt.refine_uniform(nt.rectangle(80, 40, 0, 7, 0, 4), 1)


def tight_config(inlet_scale=1.0):
    cfg = config(rel_tol=TIGHT_REL_TOL)
    cfg.T = 0.1  # 2 BDF1 steps
    cfg.newton.tol = TIGHT_NEWTON_TOL
    cfg.inlet.u_m *= inlet_scale
    return cfg


def tight_run(s, nudge=0.0):
    """Solver s (not set up) through its BDF1 steps from rest (with nudge,
    from nudge times a seeded N(0, 1) on every real dof; one device).
    Returns the natural-order velocity after each step, the trajectory and
    the run's time."""
    s.setup()
    if nudge:
        rng = np.random.default_rng(5)
        v, p = natural(s, np.zeros(s.dofs.n_total))
        y = from_natural(s, *(nudge * rng.standard_normal(a.shape) for a in (v, p)))
        s.solution = torch.as_tensor(y, dtype=torch.float32, device=DEV)
    vel = {}
    s.output_hooks.append(lambda step, t, sol: vel.__setitem__(step, natural(s, sol.cpu())[0]))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    s.solve(resume=bool(nudge))
    torch.cuda.synchronize()
    return dict(velocity=vel, steps=trajectory(s.log.records), solve_s=time.perf_counter() - t0)


def tight_rank(rank, n):
    """The tight leg on this rank; rank 0 saves the natural-order results."""
    run = tight_run(nt.NavierStokesSolver(tight_mesh(), tight_config(),
                                          log=nt.RunLog(verbose=False), n_devices=n, device=DEV))
    if rank == 0:
        torch.save(run, OUT / f"tight_{n}.pt")
    return dict(solve_s=run["solve_s"])


def tight_one_device(nudge=0.0, inlet_scale=1.0):
    """The tight leg on one device at the ranks' numbering."""
    s = nt.NavierStokesSolver(tight_mesh(), tight_config(inlet_scale),
                              log=nt.RunLog(verbose=False), device=DEV, nb_multiple=TIGHT_RANKS)
    return tight_run(s, nudge)


def steps_met(run, tol):
    """Whether every Newton loop of a run met tol and every tangent solve its
    rel_tol (no krylov_failure record)."""
    return all(res and res[-1] <= tol and not fails for _, res, _, fails in run["steps"])


def tight_references():
    """The tight leg's one-device runs at the ranks' numbering: as the
    ranks, the control with the inflow scaled by 1 + TIGHT_INLET_CONTROL,
    and, a reading, a start nudged by TIGHT_NUDGE a dof."""
    return dict(same=tight_one_device(),
                inlet=tight_one_device(inlet_scale=1 + TIGHT_INLET_CONTROL),
                nudged=tight_one_device(nudge=TIGHT_NUDGE))


def tight_report(got, ref):
    """Print the tight leg's gaps and return them: every run's Newton and
    FGMRES counts, whether each met its tolerances, and the velocity node
    by node after each step as a share of max |u| (the ranks', the
    control's and the nudged run's, against one device at the ranks'
    numbering), with the bound."""
    row = dict(met={}, gaps={})
    for name, run in (("ranks", got), *ref.items()):
        row["met"][name] = steps_met(run, TIGHT_NEWTON_TOL)
        row["gaps"][name] = [node_gap(run["velocity"][k], ref["same"]["velocity"][k])
                             for k in (1, 2)]
        print(f"  tight leg (rel_tol {TIGHT_REL_TOL:g}, Newton {TIGHT_NEWTON_TOL:g}): {name}: "
              f"Newton residuals {[['%.3e' % x for x in r] for _, r, _, _ in run['steps']]}, "
              f"FGMRES {[i for _, _, i, _ in run['steps']]}, met {row['met'][name]}, "
              f"{run['solve_s']:.1f} s; velocity gap to one device at the ranks' numbering "
              f"{row['gaps'][name][0]:.2e} (step 1), {row['gaps'][name][1]:.2e} (step 2) "
              f"(tol {TIGHT_VEL_TOL:g})", flush=True)
    return row


def channel_checks(n, g):
    """Raise unless the channel's n-rank run meets the MULTI_* bounds and
    each control fails its bound."""
    if g["entry"] > MULTI_ENTRY_REL_TOL or abs(g["iters"][0] - g["iters"][1]) > MULTI_ITERS_SLACK:
        raise RuntimeError(f"{n} ranks: the forced step departs from phase 5's")
    if g["update"] > MULTI_UPDATE_TOL or g["update_ctrl"] <= MULTI_UPDATE_TOL:
        raise RuntimeError(f"{n} ranks: the update bound fails or cannot tell another "
                           "numbering apart")


def tight_checks(row):
    """Raise unless each run met its tolerances, the ranks' velocity is
    within TIGHT_VEL_TOL of one device's at their numbering, and the
    control (the inflow scaled by 1 + TIGHT_INLET_CONTROL) is not."""
    if not all(row["met"].values()):
        raise RuntimeError(f"tight leg: a run missed its tolerances: {row['met']}")
    if max(row["gaps"]["ranks"]) > TIGHT_VEL_TOL or max(row["gaps"]["inlet"]) <= TIGHT_VEL_TOL:
        raise RuntimeError(f"tight leg: the velocity bound fails or cannot see the control "
                           f"({row['gaps']})")


# ---- phase 15, the box: the sharded 3D path ----------------------------------

BOX_RANKS = 2  # the box's solves; its kernels run at every MULTI_RANKS count
# Bounds of the box's 2-rank run against one device at its numbering (nb
# 220 = 2 x 110, phase 14's own), in the style of the MULTI_* ones; the
# control is one device at another numbering (nb_multiple 3: nb 222, other
# blocks and Cahouet-Chabard aggregates).  Readings on an NVIDIA H100 80GB
# HBM3 at 700 W (PERF.md), ranks / control:
#
# the forced step's entry ||r||: the same state in the same numbering
# (0 / 0: the bound holds the sharded residual, no control can tell it)
BOX_ENTRY_REL_TOL = 1e-6
# its FGMRES count (30 / 30)
BOX_ITERS_SLACK = 2
# its update node by node, as a share of its max (3.5e-6 / 1.3e-3)
BOX_UPDATE_TOL = 1e-4
# step 1's first two residuals, relative (2.6e-6 / 1.0e-2)
BOX_FIRST_TOL = 1e-4
# the velocity after each BDF1 step node by node, as a share of max |u|:
# 2.3e-5 and 9.8e-4 / 1.02 and 0.18.  Tangents at rel_tol 1e-2 as on phase
# 14's path; the tight leg shows what that tolerance spreads.
BOX_VEL_TOL = 1e-2


def box_references(solver, state):
    """Phase 15's one-device runs of the box (``forced_then_steps`` at
    phase 14's seeded state): at the BOX_RANKS-rank numbering, which is
    phase 14's solver itself when its block count is a multiple of
    BOX_RANKS (nb_multiple then changes nothing), and the control at
    another numbering (nb_multiple 3)."""
    nat = natural(solver, state.cpu())
    same = solver if solver._win_layout.nb % BOX_RANKS == 0 else nt.NavierStokesSolver(
        kb.box_mesh(), kb.box_config(), log=nt.RunLog(verbose=False), inlet=kb.box_inlet,
        device=DEV, nb_multiple=BOX_RANKS)
    ref = dict(state=nat, phase14_nb=solver._win_layout.nb, same=forced_then_steps(same, nat))
    ref["same"]["nb"] = same._win_layout.nb
    del same
    ctrl = nt.NavierStokesSolver(kb.box_mesh(), kb.box_config(), log=nt.RunLog(verbose=False),
                                 inlet=kb.box_inlet, device=DEV, nb_multiple=3)
    ref["control"] = forced_then_steps(ctrl, nat)
    ref["control"]["nb"] = ctrl._win_layout.nb
    return ref


def box_compare(got, ref):
    """The box's 2-rank run against one device at its numbering, and the
    control against the same: printed, and returned as a dict of gaps."""
    one, ctrl = ref["same"], ref["control"]
    g = dict(
        entry=abs(got["entry"] - one["entry"]) / one["entry"],
        entry_ctrl=abs(ctrl["entry"] - one["entry"]) / one["entry"],
        iters=(got["iters"], one["iters"], ctrl["iters"]),
        update=node_gap(got["update"], one["update"]),
        update_ctrl=node_gap(ctrl["update"], one["update"]),
        first=residual_gaps(got["steps"], one["steps"]),
        first_ctrl=residual_gaps(ctrl["steps"], one["steps"]),
        vel=[node_gap(got["velocity"][k], one["velocity"][k]) for k in (1, 2)],
        vel_ctrl=[node_gap(ctrl["velocity"][k], one["velocity"][k]) for k in (1, 2)],
        newton=[[len(r) for _, r, _, _ in run["steps"]] for run in (got, one, ctrl)],
        fgmres=[[i for _, _, i, _ in run["steps"]] for run in (got, one, ctrl)])
    print(f"  box, {BOX_RANKS} ranks against one device at nb {one['nb']} (phase 14's nb "
          f"{ref['phase14_nb']}; control at nb {ctrl['nb']}): forced step entry ||r|| "
          f"{got['entry']:.6e} / {one['entry']:.6e} (gap {g['entry']:.2e}, tol "
          f"{BOX_ENTRY_REL_TOL:g}; control {g['entry_ctrl']:.2e}); FGMRES {g['iters']} (ranks, "
          f"one device, control; slack {BOX_ITERS_SLACK}); update node by node within "
          f"{g['update']:.2e} of its max (tol {BOX_UPDATE_TOL:g}; control {g['update_ctrl']:.2e})"
          f"\n  2 BDF1 steps: Newton counts {g['newton']}, FGMRES {g['fgmres']} (ranks, one "
          f"device, control); residuals' relative gaps "
          f"{[['%.1e' % x for x in r] for r in g['first']]} (tol {BOX_FIRST_TOL:g} on step 1's "
          f"first two; control {[['%.1e' % x for x in r] for r in g['first_ctrl']]}); velocity "
          f"within {g['vel'][0]:.2e} (step 1), {g['vel'][1]:.2e} (step 2) of max |u| (tol "
          f"{BOX_VEL_TOL:g}; control {g['vel_ctrl'][0]:.2e}, {g['vel_ctrl'][1]:.2e})", flush=True)
    return g


def box_checks(g):
    """Raise unless the box's 2-rank run meets every bound and each control
    fails its bound."""
    if g["entry"] > BOX_ENTRY_REL_TOL or abs(g["iters"][0] - g["iters"][1]) > BOX_ITERS_SLACK:
        raise RuntimeError("box: the forced step departs from one device's")
    if g["update"] > BOX_UPDATE_TOL or g["update_ctrl"] <= BOX_UPDATE_TOL:
        raise RuntimeError("box: the update bound fails or cannot tell another numbering apart")
    if g["newton"][0] != g["newton"][1]:
        raise RuntimeError("box: the Newton counts depart from one device's")
    if max(g["first"][0][:2]) > BOX_FIRST_TOL or max(g["first_ctrl"][0][:2]) <= BOX_FIRST_TOL:
        raise RuntimeError("box: the first residuals' bound fails or cannot tell another "
                           "numbering apart")
    if max(g["vel"]) > BOX_VEL_TOL or max(g["vel_ctrl"]) <= BOX_VEL_TOL:
        raise RuntimeError("box: the velocity bound fails or cannot tell another numbering "
                           "apart")


# ---- phase 15, the flat legs: the flat operator's multi-device design -------
#
# The flat operator (parallel/spmd.py) splits Morton chunks of the cells
# over the ranks and keeps every vector whole on every rank: each assembly
# and operator product is all-reduced (through the host under gloo), each
# rank runs the same Krylov arithmetic on the same vectors.  (f): the
# 102,400-cell channel's flat residual and tangent action at phase 11's
# smooth state, node by node against one device's, within FLAT_TOL (float32
# sums in another order).  (g): phase 11's 25,600-cell channel with phase
# 11's settings (block_triangular): a forced Newton step from zero (three
# times: bit-equal) and 2 BDF1 steps from the Stokes guess, against one
# device; every rank's update and state bit-equal to rank 0's.
FLAT_ENTRY_REL_TOL = 1e-6  # the forced step's entry ||r||: one state, sums in another order
FLAT_ITERS_SLACK = 2
# The forced step's update node by node as a share of its max.  On an NVIDIA
# H100 80GB HBM3 at 700 W the 2 ranks' update sat 1.01e-5 from one device's,
# and one device started FLAT_NUDGE a dof away from zero 1.35e-5 (a reading
# printed beside every run): the ranks part from one device as a
# rounding-sized nudge does.  The bound sits 7x above the nudge's reading.
FLAT_UPDATE_TOL = 1e-4
FLAT_NUDGE = 1e-7
# The steps' Stokes guess is solved to 1e-5: in float32 the default 1e-6 is
# out of reach on this channel (phase 9's comment), where the solve runs on
# until FGMRES stagnates (113 iterations, 27 s on one device).  The inflow
# ramps from zero at t = 0, so the guess is u = 0, p = p_out, and each
# step's entry residual (1.5e-3, 3.0e-3) sits below newton.tol: the steps
# solve no tangent.  Forcing one puts it at float32's floor, where FGMRES
# runs to its 2,000-iteration cap (103 s a step on 2 ranks); a later,
# stronger inflow makes block_triangular's inner CG on the
# convection-dominated A00 run to its cap (ROADMAP.md Queue 3).  The
# forced step carries the tangent solve's checks.
FLAT_STOKES_REL_TOL = 1e-5


def flat_config():
    """Phase 11's flat configuration (block_triangular), 2 BDF1 steps from
    the Stokes guess (to FLAT_STOKES_REL_TOL)."""
    cfg = config()
    cfg.krylov.matvec, cfg.krylov.preconditioner = "flat", "block_triangular"
    cfg.T, cfg.initial_guess = 0.1, "stokes"
    cfg.krylov.stokes_rel_tol = FLAT_STOKES_REL_TOL
    return cfg


def flat_solver(mesh, n=None):
    s = nt.NavierStokesSolver(mesh, flat_config(), log=nt.RunLog(verbose=False), n_devices=n,
                              device=DEV)
    t0 = time.perf_counter()
    s.setup()
    if s._matvec != "flat":
        raise RuntimeError(f"the solver took the {s._matvec} path, not flat")
    return s, time.perf_counter() - t0


def flat_run(s, nudge=0.0, reps=2, steps=True):
    """(g) on flat solver s: ``reps`` forced Newton steps from zero (or from
    ``nudge`` times a seeded N(0, 1) a dof), bit-equal and with equal
    FGMRES counts, then (``steps``) its BDF1 steps from the Stokes guess.
    Returns the update, entry ||r||, FGMRES count, median ms, and the
    steps' trajectory, velocity after each step, state and time."""
    n_u = s.dofs.n_u
    x0 = torch.zeros(s.dofs.n_total, dtype=torch.float32, device=DEV)
    if nudge:
        x0 += torch.as_tensor(nudge * np.random.default_rng(5).standard_normal(s.dofs.n_total),
                              dtype=torch.float32, device=DEV)
    bc = s._bc_values(s.cfg.dt).float()
    outs, times = [], []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs.append(s._newton_iteration(x0, torch.zeros_like(x0), bc, s.cfg.dt, True))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    u1, r1, it1, ok1, _ = outs[0]
    if not ok1 or any(o[2] != it1 or not torch.equal(o[0], u1) for o in outs[1:]):
        raise RuntimeError(f"flat forced steps from one state differ or fail: "
                           f"{[(o[2], o[3]) for o in outs]}")
    upd = (u1 - x0).double().cpu().numpy()
    run = dict(update=(upd[:n_u], upd[n_u:]), entry=r1, iters=it1,
               ms=float(np.median(times)) * 1e3, update_full=u1.cpu().numpy())
    if not steps:
        return run
    vel = {}
    s.output_hooks.append(lambda step, t, sol: vel.__setitem__(step, sol[:n_u].cpu().numpy()))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    s.solve()
    torch.cuda.synchronize()
    state = s.solution.double().cpu().numpy()
    run.update(steps=trajectory(s.log.records), velocity=vel, solve_s=time.perf_counter() - t0,
               state=s.solution.cpu().numpy(), state_split=(state[:n_u], state[n_u:]),
               stokes=stokes_solve(s.log.records))
    return run


def flat_assembled(s):
    """(f): (velocity rows, pressure rows) of the residual and of J w at
    phase 11's smooth states, by node."""
    return [by_node(s, y)[1:] for y in assembled(s, smooth_state(s, 0), smooth_state(s, 1))]


def flat_rank(rank, n):
    """The flat legs on this rank: (f) on the 102,400-cell channel, (g) on
    the 25,600-cell one.  Every rank saves its (g) update and state (the
    parent holds them bit-equal to rank 0's); rank 0 saves what the parent
    compares with one device."""
    s, t_setup = flat_solver(channel_mesh(), n)
    f = flat_assembled(s)
    del s
    torch.cuda.empty_cache()
    s, t_setup1 = flat_solver(tight_mesh(), n)
    g = flat_run(s, reps=1, steps=n in FLAT_STEP_RANKS)
    torch.save({k: g[k] for k in ("update_full", "state") if k in g}, OUT / f"flat_{n}_{rank}.pt")
    if rank == 0:
        torch.save(dict(f=f, g=g), OUT / f"flat_{n}.pt")
    return dict(setup_s=[t_setup, t_setup1], ms=g["ms"], solve_s=g.get("solve_s"),
                n_cells=s.ctx.n_cells)


def flat_references():
    """The flat legs on one device: (f), (g), and (g)'s forced step from a
    start nudged FLAT_NUDGE a dof away (the update bound's reading)."""
    s, t_setup = flat_solver(channel_mesh())
    f = flat_assembled(s)
    del s
    torch.cuda.empty_cache()
    s, t_setup1 = flat_solver(tight_mesh())
    g = flat_run(s)
    nudged = flat_run(s, FLAT_NUDGE, reps=1, steps=False)
    print(f"  flat, one device: set-up {t_setup:.1f} s (102,400 cells), {t_setup1:.1f} s "
          f"(25,600); forced step from zero: entry ||r|| {g['entry']:.6e}, FGMRES {g['iters']}, "
          f"median {g['ms']:.1f} ms; started {FLAT_NUDGE:g} a dof away: FGMRES "
          f"{nudged['iters']}, update within {node_gap(nudged['update'], g['update']):.2e} of "
          f"its max", flush=True)
    return dict(f=f, g=g, nudged=nudged)


def flat_checks(n, ranks_out, ref):
    """Print and check the flat legs' n-rank run against one device."""
    got = torch.load(OUT / f"flat_{n}.pt", weights_only=False)
    f_gaps = [[float(np.abs(a - b).max() / np.abs(b).max()) for a, b in zip(mine, ones)]
              for mine, ones in zip(got["f"], ref["f"])]
    per = ranks_out[0]["flat"]["n_cells"]
    print(f"  flat (f), {n} ranks, the 102,400-cell channel ({per} cells a rank): residual "
          f"rows within {f_gaps[0][0]:.2e} (velocity), {f_gaps[0][1]:.2e} "
          f"(pressure) of one device's max, J w within {f_gaps[1][0]:.2e}, {f_gaps[1][1]:.2e} "
          f"(tol {FLAT_TOL:g})", flush=True)
    if max(max(g) for g in f_gaps) > FLAT_TOL:
        raise RuntimeError(f"flat, {n} ranks: the sharded residual or J w departs from one "
                           "device's")
    g, one = got["g"], ref["g"]
    entry = abs(g["entry"] - one["entry"]) / one["entry"]
    upd, upd_nudge = node_gap(g["update"], one["update"]), node_gap(ref["nudged"]["update"],
                                                                    one["update"])
    mine = [torch.load(OUT / f"flat_{n}_{r}.pt", weights_only=False) for r in range(n)]
    same = all(np.array_equal(m[k], mine[0][k]) for m in mine[1:] for k in mine[0])
    print(f"  flat (g), {n} ranks, the 25,600-cell channel: forced step entry ||r|| "
          f"{g['entry']:.6e} / {one['entry']:.6e} (gap {entry:.2e}, tol {FLAT_ENTRY_REL_TOL:g}); "
          f"FGMRES {g['iters']} / {one['iters']} (slack {FLAT_ITERS_SLACK}); update within "
          f"{upd:.2e} of its max (tol {FLAT_UPDATE_TOL:g}; one device nudged {FLAT_NUDGE:g} a "
          f"dof: {upd_nudge:.2e}); every rank's update and state bit-equal to rank 0's: {same}",
          flush=True)
    if entry > FLAT_ENTRY_REL_TOL or abs(g["iters"] - one["iters"]) > FLAT_ITERS_SLACK:
        raise RuntimeError(f"flat, {n} ranks: the forced step departs from one device's")
    if upd > FLAT_UPDATE_TOL or not same:
        raise RuntimeError(f"flat, {n} ranks: the update departs from one device's, or the "
                           "ranks' replicated states differ")
    if "steps" not in g:  # the forced step alone
        return g["ms"]
    newton = [[len(r) for _, r, _, _ in run["steps"]] for run in (g, one)]
    state = node_gap(g["state_split"], one["state_split"])
    print(f"  2 BDF1 steps from the Stokes guess ({g['stokes'][0]} / {one['stokes'][0]} FGMRES "
          f"iterations, converged {g['stokes'][1] is None} / {one['stokes'][1] is None}): Newton "
          f"counts {newton[0]} / {newton[1]}, residuals "
          f"{[['%.6e' % x for x in r] for _, r, _, _ in g['steps']]} / "
          f"{[['%.6e' % x for x in r] for _, r, _, _ in one['steps']]}; the state within "
          f"{state:.2e} of one device's max (tol {FLAT_UPDATE_TOL:g}); {g['solve_s']:.1f} s (one "
          f"device {one['solve_s']:.1f} s)", flush=True)
    if not all(r and r[-1] <= config().newton.tol for _, r, _, _ in g["steps"]):
        raise RuntimeError(f"flat, {n} ranks: a Newton loop did not converge")
    if (newton[0] != newton[1] or g["stokes"][0] != one["stokes"][0]
            or state > FLAT_UPDATE_TOL):
        raise RuntimeError(f"flat, {n} ranks: the steps depart from one device's")
    return g["ms"]


# ---- phase 15, the P3/P2 legs: sharded cubic velocity --------------------------
#
# (h) K1-K4 at every rank's framed P3/P2 layout of the 102,400-cell channel
# (hv = hp = 1) and of the 196,608-tet box (hv = hp = 6, the widest halo a
# layout takes), on seeded operands (no assembly): each kernel against its
# plain version within REL_TOL (K3 exact), a repeat bit-equal, and the
# sharded wrappers with the group against theirs and one device's.  (i) at
# P3_RANKS ranks against one device at their numbering: the P3/P2 channel's
# forced step without a preconditioner (phase 16's), and on box(6, 6, 6) at
# P3_BOX_CPB cells a block (halo 6) with Cahouet-Chabard, a forced step and
# 2 BDF1 steps; held to the BOX_* bounds.
P3_RANKS = 2
P3_BOX_CPB = 28


def p3_small_box():
    return nt.box(6, 6, 6)


def p3_box_config():
    cfg = kb.box_config(degree=3)
    cfg.krylov.cells_per_block = P3_BOX_CPB
    cfg.krylov.preconditioner = "cahouet_chabard"
    return cfg


P3_SOLVES = {  # name: (mesh, config, inlet, BDF1 steps after the forced step)
    "channel": (channel_mesh, lambda: config(degree=3), None, False),
    "box": (p3_small_box, p3_box_config, kb.box_inlet, True),
}


class _Sharded:
    """What ``rank_kernels``, ``sharded_vs_plain`` and ``framing`` read of a
    sharded solver, for a bare framed layout."""

    def __init__(self, lay_global, dl, rank):
        self._lay_global, self._dist, self._group = lay_global, dl, torch.distributed.group.WORLD
        self._win_layout = wspmd.local_layout(lay_global, dl, rank).to(DEV)
        self._n_state = dl.llen


def p3_rank_kernels(rank, n):
    """(h) on this rank: {"channel" / "box": the layout's numbers, each
    check's max|err|}."""
    out = {}
    for name, mesh, cfg in (("channel", channel_mesh(), config(degree=3)),
                            ("box", kb.box_mesh(), kb.box_config(degree=3))):
        t0 = time.perf_counter()
        lay_g, _ = kb.bare_layout(mesh, cfg, nb_multiple=n, device="cpu")
        sh = _Sharded(lay_g, wspmd.make_dist_layout(lay_g, n), rank)
        lay = sh._win_layout
        t_layout = time.perf_counter() - t0
        calls, ops_ = kb.seeded_operands(lay)
        errs = {}
        for key, (kernel, plain) in calls.items():
            got, want = stacked(kernel()), stacked(plain())
            errs[key] = float((got.double() - want.double()).abs().max())
            ok = (torch.equal(got, want) if key.startswith("K3")
                  else errs[key] <= REL_TOL * float(want.double().abs().max()))
            if not ok or not torch.equal(stacked(kernel()), got):
                raise RuntimeError(f"rank {rank}: P3/P2 {name}: {key} disagrees with its plain "
                                   f"version (max|err| {errs[key]:.3e}) or with itself")
        errs.update(sharded_vs_plain(sh, ops_, rank))
        if not W.scatter_rows(lay):
            raise RuntimeError(f"rank {rank}: P3/P2 {name}: K4 is not the row-ordered sum")
        out[name] = dict(errs=errs, layout_s=t_layout, nb=lay_g.nb, nb_loc=sh._dist.nb_loc,
                         scatter=W.scatter_design(lay),
                         frame=lay.frame, hv=lay.hv, hp=lay.hp, OWv=lay.OWv, OWp=lay.OWp,
                         ncd=lay.ncd, k=(lay.k_v, lay.k_p))
        del calls, ops_, sh, lay
        torch.cuda.empty_cache()
    return out


def p3_state(s, seed=0):
    """A seeded natural-order state (0.05 N(0, 1) a real dof) for solver s."""
    y = 0.05 * np.random.default_rng(seed).standard_normal(s.dofs.n_total)
    v, p = natural(s, y)
    return v, p


def p3_rank_solves(rank, n, ref):
    """(i) on this rank; rank 0 saves each run's natural-order results."""
    out = {}
    for name, (mesh, cfg, inlet, steps) in P3_SOLVES.items():
        c = cfg()
        c.T = 0.1
        s = nt.NavierStokesSolver(mesh(), c, log=nt.RunLog(verbose=False), inlet=inlet,
                                  n_devices=n, device=DEV)
        t0 = time.perf_counter()
        s.setup()
        t_setup = time.perf_counter() - t0
        run = forced_then_steps(s, ref["p3"][name]["state"], rank, steps=steps)
        run.setdefault("launches", run["step_launches"])
        if rank == 0:
            torch.save(run, OUT / f"p3_multi_{name}.pt")
        out[name] = dict(setup_s=t_setup, frame=s._win_layout.frame, hv=s._win_layout.hv,
                         launches=run["launches"], step_launches=run["step_launches"],
                         step_ms=run["step_ms"], solve_s=run.get("solve_s"))
        del s
        torch.cuda.empty_cache()
    return out


def p3_references():
    """(i) on one device at the P3_RANKS-rank numbering: the seeded states
    and the runs."""
    ref = {}
    for name, (mesh, cfg, inlet, steps) in P3_SOLVES.items():
        c = cfg()
        c.T = 0.1
        s = nt.NavierStokesSolver(mesh(), c, log=nt.RunLog(verbose=False), inlet=inlet,
                                  device=DEV, nb_multiple=P3_RANKS).setup()
        state = p3_state(s)
        ref[name] = dict(state=state, one=forced_then_steps(s, state, steps=steps),
                         nb=s._win_layout.nb, hv=s._win_layout.hv)
        del s
        torch.cuda.empty_cache()
    return ref


def p3_checks(ref, ranks_out):
    """(i)'s P3_RANKS-rank runs against one device (the BOX_* bounds)."""
    for name, r in ref.items():
        got, one = torch.load(OUT / f"p3_multi_{name}.pt", weights_only=False), r["one"]
        entry = abs(got["entry"] - one["entry"]) / one["entry"]
        upd = node_gap(got["update"], one["update"])
        line = (f"  P3/P2 {name}, {P3_RANKS} ranks against one device at nb {r['nb']} (hv "
                f"{r['hv']}): forced step entry ||r|| {got['entry']:.6e} / {one['entry']:.6e} "
                f"(gap {entry:.2e}, tol {BOX_ENTRY_REL_TOL:g}); FGMRES {got['iters']} / "
                f"{one['iters']} (slack {BOX_ITERS_SLACK}); update within {upd:.2e} of its max "
                f"(tol {BOX_UPDATE_TOL:g}); ms {min(got['step_ms']):.1f} / "
                f"{min(one['step_ms']):.1f}")
        bad = (entry > BOX_ENTRY_REL_TOL or abs(got["iters"] - one["iters"]) > BOX_ITERS_SLACK
               or upd > BOX_UPDATE_TOL)
        if "steps" in one:
            first = residual_gaps(got["steps"], one["steps"])
            vel = [node_gap(got["velocity"][k], one["velocity"][k]) for k in (1, 2)]
            newton = [[len(x) for _, x, _, _ in run["steps"]] for run in (got, one)]
            line += (f"\n  2 BDF1 steps: Newton counts {newton[0]} / {newton[1]}, FGMRES "
                     f"{[i for _, _, i, _ in got['steps']]} / "
                     f"{[i for _, _, i, _ in one['steps']]}; residuals' relative gaps "
                     f"{[['%.1e' % x for x in q] for q in first]} (tol {BOX_FIRST_TOL:g} on step "
                     f"1's first two); velocity within {vel[0]:.2e}, {vel[1]:.2e} of max |u| "
                     f"(tol {BOX_VEL_TOL:g}); {got['solve_s']:.1f} s (one device "
                     f"{one['solve_s']:.1f} s)")
            check_converged(got["steps"], config().newton.tol)
            bad = bad or newton[0] != newton[1] or max(first[0][:2]) > BOX_FIRST_TOL or (
                max(vel) > BOX_VEL_TOL)
        print(line + f"; launches a rank {[x['p3_solves'][name]['launches'] for x in ranks_out]}",
              flush=True)
        if bad:
            raise RuntimeError(f"P3/P2 {name}: the {P3_RANKS}-rank run departs from one "
                               "device's")


def p3_kernel_report(n, ranks_out):
    for name in ("channel", "box"):
        rs = [r["p3_kernels"][name] for r in ranks_out]
        r0 = rs[0]
        print(f"  P3/P2 (h) {name}, {n} ranks: k_v/k_p {r0['k']}, nb {r0['nb']} = {n} x "
              f"{r0['nb_loc']}, frame {r0['frame']} (hv/hp {r0['hv']}/{r0['hp']}, OWv/OWp "
              f"{r0['OWv']}/{r0['OWp']}), {r0['ncd']} slot columns a rank, layout "
              f"{r0['layout_s']:.1f} s, K4 {r0['scatter']}; largest error a check: "
              + ", ".join(f"{k} {max(r['errs'][k] for r in rs):.2e}" for k in r0["errs"]),
              flush=True)


def run_ranks(n, ref, ref_path):
    """Phase 15's ranks: n spawned processes on ``multi_rank``; returns each
    rank's numbers."""
    import torch.multiprocessing as mp

    torch.save(ref, ref_path)
    store = OUT / f"multi_rank_store_{n}"
    store.unlink(missing_ok=True)
    ctx = mp.start_processes(multi_rank, args=(n, f"file://{store}", str(ref_path)),
                             nprocs=n, join=False, start_method="spawn")
    deadline = time.monotonic() + MULTI_TIMEOUT_S
    while not ctx.join(timeout=10):
        if time.monotonic() > deadline:
            for proc in ctx.processes:
                proc.kill()
            raise RuntimeError(f"{n} ranks outlasted {MULTI_TIMEOUT_S} s")
    return [json.loads((OUT / f"multi_rank_{n}_{r}.json").read_text()) for r in range(n)]


def one_device_at(ref, n):
    """``forced_then_steps``' forced step on one device at the n-rank run's
    numbering."""
    s = nt.NavierStokesSolver(channel_mesh(), config(), log=nt.RunLog(verbose=False),
                              device=DEV, nb_multiple=n)
    run = forced_then_steps(s, ref["state"], steps=False)
    run["nb"] = s._win_layout.nb
    return run


def residual_gaps(a, b):
    """The relative gaps between two runs' Newton residuals, step by step."""
    return [[abs(x - y) / y for x, y in zip(ra, rb)]
            for (_, ra, _, _), (_, rb, _, _) in zip(a, b)]


MULTI_LEGS = ("channel", "tight", "box", "flat", "p3")


def multi_rank_phase(ref, smi, box_ref, legs=MULTI_LEGS):
    """Phase 15: the owned-range domain decomposition on 2 and 4 ranks of
    the one card (gloo, edge blocks through pinned host buffers; NCCL
    refuses two ranks on one device), each rank a process.  The channel
    against one device at the same numbering (the bounds above) and phase
    4-5's run (entry ||r||, FGMRES and Newton counts; phase 4-5's run is
    also the control: another numbering, which the update bound must tell
    apart); the tight leg at TIGHT_RANKS ranks (its bound and control
    above); the box's kernels at every rank count and its solves at
    BOX_RANKS against phase 14's (``box_references``); the flat operator's
    legs (f)-(g) against one device (``flat_references``); the P3/P2 legs
    (h)-(i) (``p3_references``).  ``legs`` picks some ("channel" needs
    phase 5's ``ref``, "box" phase 14's ``box_ref``).  Returns {rank
    count: each rank's numbers}."""
    phase(f"15 multi-rank: {', '.join(legs)} on 2 and 4 ranks of the card (gloo), against one "
          "device")
    ref_path = OUT / "multi_rank_ref.pt"
    rank_ref = dict(ref or {}, legs=legs)
    one_refs = {}
    for leg, make in (("tight", tight_references), ("flat", flat_references),
                      ("p3", p3_references)):
        if leg in legs:
            t0 = time.perf_counter()
            one_refs[leg] = make()
            print(f"  {leg} legs, one device: {time.perf_counter() - t0:.1f} s", flush=True)
            torch.cuda.empty_cache()
    if "box" in legs:
        rank_ref["box"] = dict(state=box_ref["state"])
    rank_ref["p3"] = one_refs.get("p3")
    out, flat_ms = {}, {}
    for n in MULTI_RANKS:
        t0 = time.perf_counter()
        out[n] = run_ranks(n, rank_ref, ref_path)
        print(f"  [{n} ranks, every leg: {time.perf_counter() - t0:.1f} s with process start]",
              flush=True)
        if "flat" in legs:
            flat_ms[n] = flat_checks(n, out[n], one_refs["flat"])
        if "p3" in legs:
            p3_kernel_report(n, out[n])
            if n == P3_RANKS:
                p3_checks(one_refs["p3"], out[n])
        if "channel" not in legs:
            continue
        t0 = time.perf_counter()
        one = one_device_at(ref, n)
        torch.cuda.empty_cache()
        print(f"  the channel on one device at nb_multiple {n}: {time.perf_counter() - t0:.1f} s",
              flush=True)
        got = torch.load(OUT / f"multi_rank_{n}.pt", weights_only=False)
        r0 = out[n][0]
        print(f"  {n} ranks: nb {r0['nb']} = {n} x {r0['nb_loc']}, frame {r0['frame']} blocks a "
              f"side: K1-K4 launch on {r0['nb_framed']} blocks, {r0['ncd']} slot columns of "
              f"which {r0['frame_cols']} frame padding; owned vector {r0['llen']}; setup "
              f"{r0['setup_s']:.1f} s; one device at nb_multiple {n}: nb {one['nb']}", flush=True)
        entry = abs(got["entry"] - ref["entry"]) / ref["entry"]
        upd, upd_ctrl = (node_gap(got["update"], one["update"]),
                         node_gap(ref["update"], one["update"]))
        print(f"  forced step: entry ||r|| {got['entry']:.6e} (phase 5 {ref['entry']:.6e}, "
              f"gap {entry:.2e}, tol {MULTI_ENTRY_REL_TOL:g}); FGMRES {got['iters']} (phase 5 "
              f"{ref['iters']}, same numbering {one['iters']}); update node by node within "
              f"{upd:.2e} of its max of one device's at the same numbering (tol "
              f"{MULTI_UPDATE_TOL:g}; control, phase 5's at its own numbering: {upd_ctrl:.2e})",
              flush=True)
        g = dict(entry=entry, iters=(got["iters"], ref["iters"]), update=upd,
                 update_ctrl=upd_ctrl)
        channel_checks(n, g)
        if n == TIGHT_RANKS and "tight" in legs:
            tight_checks(tight_report(torch.load(OUT / f"tight_{n}.pt", weights_only=False),
                                      one_refs["tight"]))
        if n == BOX_RANKS and "box" in legs:
            box_checks(box_compare(torch.load(OUT / "box_multi.pt", weights_only=False),
                                   box_ref))
    if "flat" in legs:
        print(f"  flat forced step from zero ({smi}): 1 rank {one_refs['flat']['g']['ms']:.1f} ms "
              "(the median of 2), " + ", ".join(f"{n} ranks {flat_ms[n]:.1f} ms"
                                                for n in MULTI_RANKS), flush=True)
    if "channel" in legs:
        channel_report(out, ref, smi)
    if "box" in legs:
        box_report(out, box_ref, smi)
    return out


def channel_report(out, ref, smi):
    """Print the channel leg's per-rank numbers."""
    for n, rs in out.items():
        for r in rs:
            print(f"  {n} ranks, rank {r['rank']}: one K1 product sends {r['floats_per_matvec']} "
                  f"floats, {r['floats_per_matvec'] / r['llen']:.4f} of its vector "
                  f"({r['llen']}), {r['k1_sharded_ms']:.4f} ms a product against "
                  f"{r['k1_framed_ms']:.4f} for K1 alone at the framed layout (warm); "
                  f"forced step sends {r['step_exchange_floats']}; launches: forced step "
                  f"{r['step_launches']}; max|err| at the framed layout {max(r['errs'].values()):.3e}", flush=True)
        print(f"  {n} ranks, largest error a check: "
              + ", ".join(f"{k} {max(r['errs'][k] for r in rs):.2e}" for k in rs[0]['errs']),
              flush=True)
    print(f"  forced step wall time ({smi}): 1 rank {ref['ms']:.1f} ms (phase 5's median), "
          + ", ".join(f"{n} ranks {min(out[n][0]['step_ms']):.1f} ms" for n in MULTI_RANKS),
          flush=True)


def box_report(out, box_ref, smi):
    """Print the box leg's per-rank numbers."""
    for n, rs in out.items():
        for r in (r["box"] for r in rs):
            c = r["compact"]
            print(f"  box, {n} ranks, rank {r['rank']}: nb {r['nb']} = {n} x {r['nb_loc']}, frame "
                  f"{r['frame']} blocks a side (hv/hp {r['hv']}/{r['hp']}, OWv/OWp "
                  f"{r['OWv']}/{r['OWp']}): K1-K4 launch on {r['nb_framed']} blocks, "
                  f"{r['frame_cols']} of {r['ncd']} slot columns frame padding "
                  f"({r['frame_cols'] / r['ncd']:.4f}); compact tables E_v/E_p {c['E_v']}/"
                  f"{c['E_p']}, at most {c['max_entries']} entries and {c['max_pairs']} pairs a "
                  f"chunk, {c['smem']} of {c['smem_limit']} bytes of shared memory; setup "
                  f"{r['setup_s']:.1f} s; one K1 product sends {r['floats_per_matvec']} floats, "
                  f"{r['floats_per_matvec'] / r['llen']:.4f} of its vector ({r['llen']}), "
                  f"{r['k1_sharded_ms']:.4f} ms a product against {r['k1_framed_ms']:.4f} for K1 "
                  f"alone at the framed layout (warm); peak device memory {r['peak_gb']:.2f} GB"
                  + (f"; launches: forced step {r['step_launches']}, 2 steps {r['launches']}; "
                     f"forced step sends {r['step_exchange_floats']}" if "launches" in r else ""),
                  flush=True)
        print(f"  box, {n} ranks, largest error a check: "
              + ", ".join(f"{k} {max(r['box']['errs'][k] for r in rs):.2e}"
                          for k in rs[0]["box"]["errs"]), flush=True)
    print(f"  box forced step wall time ({smi}): 1 rank {min(box_ref['same']['step_ms']):.1f} ms, "
          f"{BOX_RANKS} ranks {min(out[BOX_RANKS][0]['box']['step_ms']):.1f} ms", flush=True)


# ---- phase 16: Taylor-Hood P3/P2 on the windowed kernels --------------------

# P3/P2 runs without a preconditioner (kernel_bench.channel_config(degree=3)):
# Cahouet-Chabard and the block preconditioners scale by the lumped pressure
# mass, which both packages build by row sums, wrong for P2 pressure
# (ROADMAP.md Queue 3).  An unpreconditioned tangent solve may stop at its
# cap (krylov.max_iters); the run goes on as the solver does, and each
# capped solve is printed with its last ||r||/||b||.  The Cahouet-Chabard
# forced steps put K2 on the solver's path at P3/P2, capped at P3_CC_CAP
# FGMRES iterations: on triangles they cannot converge.
P3_CC_CAP = 60
# (d): unit_square(P3_PARITY_N) at P3/P2 with the time-dependent forcing,
# 3 BDF1 steps of P3_PARITY_DT, FGMRES(P3_PARITY_RESTART), tangents to 1e-9
# (float64, CPU) and 1e-6 (float32, card), held to PARITY_TOL as phase 7.
# Steps 2-3 start from entry rows some 50x below step 1's, where the float32
# solves' 1e-6 shows most: on an NVIDIA H100 80GB HBM3 at 700 W the rows
# read 7.7e-8, 5.5e-5 and 7.0e-5 of their step's entry row (PERF.md).  The
# forcing keeps those entry rows up; the unforced flow's fall further
P3_PARITY_N, P3_PARITY_DT, P3_PARITY_RESTART = 4, 0.1, 200


def capped_solves(records):
    """[(step, FGMRES iterations, last ||r||/||b||)] of each tangent solve
    of a run that stopped at its cap (a krylov_failure after its Newton
    iteration's entry residual, the solve's ||b||)."""
    out, step, b = [], 0, None
    for r in records:
        ev = r.get("event")
        if ev == "time_step":
            step = r["step"]
        elif ev == "newton":
            b = r["residual"]
        elif ev == "krylov_failure" and r.get("system") == "tangent":
            out.append((step, r["iters"], r["residual"] / b))
    return out


def p3_steps(solver, log, need=("K1", "K3", "K4")):
    """Phase 16: the solver's BDF1 steps from rest (cfg.T) with the launch
    counts zeroed before and read after; each step's Newton residuals and
    FGMRES counts, the capped solves, the peak device memory.  The steps
    must be finite and launch ``need``.  Returns the launches."""
    W.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    solver.solve()
    torch.cuda.synchronize()
    t_solve = time.perf_counter() - t0
    launches = {k.split()[0]: v for k, v in W.launch_counts().items()}
    steps = trajectory(log.records)
    for step, res, its, _ in steps:
        print(f"  step {step}: ||r|| = {', '.join(f'{x:.6e}' for x in res)}; "
              f"GMRES iterations {its}", flush=True)
    capped = capped_solves(log.records)
    print(f"  {len(steps)} steps in {t_solve:.2f} s; capped at {solver.cfg.krylov.max_iters}: "
          f"{len(capped)} {[(st, it, f'{rel:.3e}') for st, it, rel in capped]}; Newton "
          f"converged in every step {all(r and r[-1] <= solver.cfg.newton.tol for _, r, _, _ in steps)}"
          f"; peak device memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB; launches "
          f"{launches}", flush=True)
    want = round(solver.cfg.T / solver.cfg.dt)
    if len(steps) != want or not bool(torch.isfinite(solver.solution).all()):
        raise RuntimeError(f"the P3/P2 run did not take {want} finite steps")
    if min(launches[k] for k in need) == 0:
        raise RuntimeError(f"a kernel of the P3/P2 path was never launched: {launches}")
    print(f"  K4 ran {W.scatter_design(solver._win_layout)}", flush=True)
    return launches


def p3_cc_forced(solver):
    """Phase 16: three forced Newton steps of solver (set up) with
    Cahouet-Chabard, FGMRES capped at P3_CC_CAP: bit-equal, K2 launched in
    each of its space pairs.  The preconditioner is switched on the solver
    for these steps and back after (set-up builds nothing that depends on
    it: the coarse spaces follow krylov.cc_coarse_agg*).  Returns one
    step's launches."""
    k = solver.cfg.krylov
    was = solver._precond, k.max_iters
    solver._precond, k.max_iters = "cahouet_chabard", P3_CC_CAP
    try:
        step_launches, forced = forced_step(solver, converge=False)
    finally:
        solver._precond, k.max_iters = was
    pairs = dict(W.windowed_matvec_block.pairs)
    print(f"  Cahouet-Chabard, FGMRES capped at {P3_CC_CAP}: converged {forced['converged']}, "
          f"last ||r||/||b|| {forced['final_rel']:.3e}; K2 launches by space pair {pairs}",
          flush=True)
    if min(pairs.values()) == 0 or min(step_launches.values()) == 0:
        raise RuntimeError(f"a kernel was not launched by the P3/P2 CC step: {step_launches}, "
                           f"{pairs}")
    return step_launches


def p3_layout_line(solver, mesh, t_setup):
    lay = solver._win_layout
    pk = lay._packed
    line = (f"  cells {mesh.n_cells}  n_total {solver.dofs.n_total}  nb {lay.nb}  Bmax "
            f"{lay.Bmax}  Bc {lay.Bc}  nchunks {lay.nchunks}  ncd {lay.ncd}  OWv/OWp "
            f"{lay.OWv}/{lay.OWp}  hv/hp {lay.hv}/{lay.hp}  RVv/RVp {lay.RVv}/{lay.RVp}  nl/nli "
            f"{lay.nl}/{lay.nli}  tables {pk.pos_v.dtype}  "
            + (f"slot colours {pk.ncolors}" if lay.dim == 2 else "no slot colours (3D)")
            + f"  setup {t_setup:.2f} s; device memory {torch.cuda.memory_allocated() / 1e9:.2f} GB")
    if (lay.k_v, lay.k_p) != ((10, 6) if lay.dim == 2 else (20, 10)):
        raise RuntimeError(f"not a P3/P2 layout: {line}")
    print(line, flush=True)


def p3_parity():
    """Phase 16(d): unit_square(P3_PARITY_N) at P3/P2, float32 on the card
    against float64 on the CPU, Newton rows per step within PARITY_TOL of
    the step's entry row, every solve converged."""
    runs = {}
    for dtype, device, rel in (("float64", "cpu", 1e-9), ("float32", DEV, 1e-6)):
        cfg = config(dtype, rel, cells_per_block=16, degree=3)
        cfg.dt, cfg.T, cfg.krylov.restart = P3_PARITY_DT, 3 * P3_PARITY_DT, P3_PARITY_RESTART
        plog = nt.RunLog(verbose=False)
        s = nt.NavierStokesSolver(nt.unit_square(P3_PARITY_N), cfg, log=plog, forcing=forcing_xt,
                                  device=device)
        t0 = time.perf_counter()
        s.solve()
        runs[dtype] = trajectory(plog.records)
        print(f"  {dtype} on {device}: n_total {s.dofs.n_total}, {time.perf_counter() - t0:.1f} s",
              flush=True)
    for (step, r64, i64, f64), (_, r32, i32, f32) in zip(runs["float64"], runs["float32"]):
        worst = max(abs(a - b) for a, b in zip(r64, r32)) / r64[0]
        print(f"  step {step}: f64 {['%.6e' % v for v in r64]} GMRES {i64}\n"
              f"          f32 {['%.6e' % v for v in r32]} GMRES {i32}  worst |diff|/entry "
              f"{worst:.2e} (tol {PARITY_TOL:g})", flush=True)
        if len(r64) != len(r32) or worst > PARITY_TOL or f64 or f32:
            raise RuntimeError(f"step {step}: P3/P2 float32 GPU run departs from float64 CPU run")
    if len(runs["float64"]) != 3 or len(runs["float32"]) != 3:
        raise RuntimeError("P3/P2 parity runs did not take 3 steps")


def p3_run(solver, log, name):
    """Phase 16 (b)-(c) on a set-up P3/P2 solver: three forced Newton steps
    without a preconditioner, its cfg.T of BDF1 steps from rest, three
    capped Cahouet-Chabard forced steps.  Returns the steps' launches (K2:
    the Cahouet-Chabard step's) and one forced step's (K2 likewise)."""
    print(f"  the {name}, no preconditioner: three forced Newton steps", flush=True)
    step_launches, _ = forced_step(solver, converge=False)
    print(f"  the {name}, no preconditioner: {round(solver.cfg.T / solver.cfg.dt)} BDF1 steps "
          "from rest", flush=True)
    launches = p3_steps(solver, log)
    print(f"  the {name}: Cahouet-Chabard forced steps", flush=True)
    cc = p3_cc_forced(solver)
    launches["K2"] = step_launches["K2"] = cc["K2"]
    return launches, step_launches


def p3_phase():
    """Phase 16: Taylor-Hood P3/P2 through NavierStokesSolver on the
    windowed kernels.  (a) every kernel against its plain version at the
    102,400-cell channel's P3/P2 layout (phase 3's checks); (b) there,
    without a preconditioner, three forced Newton steps (bit-equal) and 2
    BDF1 steps from rest; (c) three Cahouet-Chabard forced steps, capped;
    (d) float32 on the card against float64 on the CPU on a small mesh;
    (e) at the 196,608-tet box's P3/P2 layout (halo 6), (a)'s checks on
    seeded operands (the layout alone: the solver's set-up there takes some
    200 s of host precompute, kernel_bench --case box --degree 3 times its
    solves), and (b)-(c) on the box refined once (24,576 tets).  Returns
    {"channel": ..., "box": ...}: (a)'s records (the box's: (e)'s), the
    launches of the steps and one forced step's ((b)'s, K2 from (c))."""
    phase("16 p3: Taylor-Hood P3/P2 (cubic velocity) on the windowed kernels, float32")
    print("  (a) the channel at P3/P2: kernels vs plain", flush=True)
    mesh = channel_mesh()
    cfg = config(degree=3)
    cfg.T = 2 * cfg.dt
    log = nt.RunLog(verbose=False)
    t0 = time.perf_counter()
    solver = nt.NavierStokesSolver(mesh, cfg, log=log, device=DEV).setup()
    torch.cuda.synchronize()
    p3_layout_line(solver, mesh, time.perf_counter() - t0)
    recs = kernels_vs_plain(solver._win_layout, kb.wrapper_operands(solver))
    out = dict(channel=(recs, *p3_run(solver, log, "channel")))
    del solver
    print("  (d) small-mesh parity at P3/P2: float32 GPU kernels vs float64 CPU plain versions",
          flush=True)
    p3_parity()

    print("  (e) the box at P3/P2: kernels vs plain at its layout, on seeded operands", flush=True)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    mesh = kb.box_mesh()
    cfg = kb.box_config(degree=3)
    cfg.T = 2 * cfg.dt
    t0 = time.perf_counter()
    lay, dofs = kb.bare_layout(mesh, cfg, device=DEV)
    print(f"  cells {mesh.n_cells}  n_total {dofs.n_total}  nb {lay.nb}  Bmax {lay.Bmax}  Bc "
          f"{lay.Bc}  nchunks {lay.nchunks}  ncd {lay.ncd}  OWv/OWp {lay.OWv}/{lay.OWp}  hv/hp "
          f"{lay.hv}/{lay.hp}  RVv/RVp {lay.RVv}/{lay.RVp}  nl/nli {lay.nl}/{lay.nli}  tables "
          f"{lay._packed.pos_v.dtype}; layout {time.perf_counter() - t0:.2f} s", flush=True)
    recs = kernels_vs_plain(lay, kb.seeded_operands(lay))
    print(f"  peak device memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB (the CSR "
          "yardsticks' build)", flush=True)
    del lay
    torch.cuda.empty_cache()
    print("  (e) the box refined once at P3/P2: the solver's runs", flush=True)
    mesh = nt.refine_uniform(nt.box(8, 8, 8), 1)
    log = nt.RunLog(verbose=False)
    t0 = time.perf_counter()
    solver = nt.NavierStokesSolver(mesh, cfg, log=log, inlet=kb.box_inlet, device=DEV).setup()
    torch.cuda.synchronize()
    p3_layout_line(solver, mesh, time.perf_counter() - t0)
    out["box"] = (recs, *p3_run(solver, log, "box refined once"))
    return out


# phase 17: FGMRES deflation.  (a)-(c) the weakly pinned channel
# refine_uniform(rectangle(160, 16, 0, 4, 0, 0.4), 2) (81,920 cells: the
# outlet, tag 1, one short edge of a 10:1 channel), channel_config's solver
# with the DFG inflow (H 0.4, ramped), nu 1e-3, dt 0.05, 2 BDF1 steps,
# kp_deflate 2, no Kp coarse space (the AUTO rule's choice at 81,920 cells:
# the probe's largest amplification, 6.75e5 in float64, is over its 5e5
# cutoff), and the outer operator in float32: the main path's bf16
# operator ("auto" at rel_tol 1e-2) leaves the 576-cell channel's second
# Newton solve stuck at 1.8e-3 of step 1's entry row, above its 1e-2 x
# 1.2e-2 target (float32 on the CPU).  (d) the same channel unrefined,
# rectangle(48, 6, 0, 4, 0, 0.4) (576 cells, tests/test_kp_deflation.py's).
DEFL_KP = 2
DEFL_ROWS = 2 * DEFL_KP  # each kept mode and its velocity response
DEFL_UNIT_TOL = 1e-5  # each row's norm, stored in float32
DEFL_CPB_SMALL = 64
# the tangent solves' cap: (c)'s second step stalls at half of ||b||,
# deflated or not, and ran to the configuration's 2,000 (2,040 iterations,
# 28.1 s of the phase's 49.6 s on an NVIDIA H100 80GB HBM3 at 700 W), so
# the phase caps it here for the script's time limit
DEFL_MAX_ITERS = 600
# (d): the 576-cell channel's forced Newton step at a seeded state, its
# tangent solve one FGMRES cycle of DEFL_CYCLE steps (restart and cap
# DEFL_CYCLE, no tolerance to stop it), deflated with the CPU's rows, in
# float32 on the card against float64 on the CPU.  A solve run to a
# tolerance ends at the same answer with or without the rows, while a fixed
# cycle's iterate depends on them: the update must lie within DEFL_STEP_TOL
# of the CPU's (max |diff| over max), and the control, the card's cycle
# without rows, must not.  Deflated float32 solves on this channel stop at
# 5.4e-5 of ||b|| (2,040 iterations), so a tight solve is out of reach.
# Float32 against float64 on the CPU: 8.9e-3 after 8 steps, 2.9e-3 after
# 16, 1.3e-3 after 30; the control 0.99, 0.99, 0.91.  The card's own rows
# must be the CPU's, sign included (the probe fixes it): 1 - cos within
# DEFL_ROW_TOL
DEFL_CYCLE = 30
DEFL_STEP_TOL = 1e-2
DEFL_ROW_TOL = 1e-6


def deflation_mesh(refine=2):
    if refine:
        return nt.refine_uniform(nt.rectangle(160, 16, 0, 4, 0, 0.4), refine)
    return nt.rectangle(48, 6, 0, 4, 0, 0.4)


def deflation_config(dtype="float32", rel_tol=1e-2, cells_per_block=448):
    cfg = config(dtype, rel_tol, cells_per_block=cells_per_block)
    cfg.inlet.H, cfg.nu, cfg.dt = 0.4, 1e-3, 0.05
    cfg.T = 2 * cfg.dt
    cfg.krylov.kp_deflate = DEFL_KP
    cfg.krylov.cc_coarse_agg = 0
    cfg.krylov.operator_dtype = "float32"
    cfg.krylov.max_iters = DEFL_MAX_ITERS
    return cfg


@contextlib.contextmanager
def host_seconds(module, names):
    """{name: seconds} spent in the module's functions ``names`` while the
    block runs (each wrapped for the block's length)."""
    took, saved = {n: 0.0 for n in names}, {n: getattr(module, n) for n in names}

    def timed(n):
        def call(*args, **kw):
            t0 = time.perf_counter()
            try:
                return saved[n](*args, **kw)
            finally:
                took[n] += time.perf_counter() - t0
        return call

    for n in names:
        setattr(module, n, timed(n))
    try:
        yield took
    finally:
        for n in names:
            setattr(module, n, saved[n])


def deflation_setup():
    """(a): the 81,920-cell channel's solver, its rows checked: DEFL_ROWS
    unit rows on the card alternating (0, w) / (u_w, 0)."""
    from navier_stokes_tpu_torch.fem import windowed_assembly as wam

    mesh = deflation_mesh()
    log = nt.RunLog(verbose=False)
    t0 = time.perf_counter()
    with host_seconds(wam, ("_kp_near_null_modes", "_kp_mode_velocity_responses")) as took:
        solver = nt.NavierStokesSolver(mesh, deflation_config(), log=log, device=DEV).setup()
    torch.cuda.synchronize()
    lay = solver._win_layout
    print(f"  cells {mesh.n_cells}  n_total {solver.dofs.n_total}  nb {lay.nb}  hv/hp "
          f"{lay.hv}/{lay.hp}; set-up {time.perf_counter() - t0:.2f} s, of it on the host: the "
          f"Kp probe (eigsh) {took['_kp_near_null_modes']:.2f} s, the velocity responses (CG) "
          f"{took['_kp_mode_velocity_responses']:.2f} s", flush=True)
    m = solver._wassembly.kp_modes
    if m is None or m.shape != (DEFL_ROWS, solver.dofs.n_total) or m.device != DEV:
        raise RuntimeError(f"expected {DEFL_ROWS} deflation rows on the card, got "
                           f"{None if m is None else (tuple(m.shape), m.device)}")
    n_u = solver.dofs.n_u
    for i, row in enumerate(m.double()):
        nv, np_ = float(row[:n_u].norm()), float(row[n_u:].norm())
        want = "pressure" if i % 2 == 0 else "velocity"
        print(f"  row {i}: ||velocity part|| {nv:.7f}, ||pressure part|| {np_:.7f} "
              f"(a {want} row), ||row|| - 1 = {nv + np_ - 1:.2e}", flush=True)
        if (nv if want == "pressure" else np_) != 0.0 or abs(nv + np_ - 1) > DEFL_UNIT_TOL:
            raise RuntimeError(f"deflation row {i} is not a unit {want} row")
    return solver, log


def deflation_forced(solver):
    """(b): three deflated forced Newton steps (``forced_step``: bit-equal,
    equal counts, converged), K1 and K2 launched; one undeflated beside."""
    step_launches, forced = forced_step(solver)
    if min(step_launches.get(k, 0) for k in ("K1", "K2")) == 0:
        raise RuntimeError(f"K1 or K2 did not launch in the deflated step: {step_launches}")
    wa = solver._wassembly
    solver._wassembly = dataclasses.replace(wa, kp_modes=None)
    try:
        bc_vals = torch.as_tensor(solver.dirichlet.values(solver.cfg.dt), dtype=torch.float32,
                                  device=DEV)
        t0 = time.perf_counter()
        plain = solver._newton_iteration(forced["state"], torch.zeros_like(forced["state"]),
                                         bc_vals, solver.cfg.dt, True)
        torch.cuda.synchronize()
        t_plain = time.perf_counter() - t0
    finally:
        solver._wassembly = wa
    print(f"  FGMRES iterations of the forced step: deflated {forced['iters']} "
          f"({forced['ms']:.1f} ms), undeflated {plain[2]} ({t_plain * 1e3:.1f} ms, converged "
          f"{plain[3]}, last ||r||/||b|| {plain[4] / plain[1]:.3e})", flush=True)


def deflation_steps(solver, log):
    """(c): 2 BDF1 steps from rest, deflated; every Newton loop converges.
    A tangent solve that stalls and stops at its cap (DEFL_MAX_ITERS) is
    printed with its last ||r||, as phase 12 prints the cavity's."""
    W.reset_launch_counts()
    t0 = time.perf_counter()
    solver.solve()
    torch.cuda.synchronize()
    print(f"  {time.perf_counter() - t0:.2f} s; launches {W.launch_counts()}", flush=True)
    steps = trajectory(log.records)
    for step, res, its, fails in steps:
        print(f"  step {step}: ||r|| = {', '.join(f'{x:.6e}' for x in res)}; GMRES iterations "
              f"{its}" + "".join(f"; a solve stopped at {f['iters']} iterations, ||r|| "
                                 f"{f['residual']:.6e}" for f in fails), flush=True)
        if not res or res[-1] > solver.cfg.newton.tol:
            raise RuntimeError(f"step {step}: the deflated Newton loop did not converge ({res})")
    if len(steps) != 2 or not bool(torch.isfinite(solver.solution).all()):
        raise RuntimeError("the deflated run did not take 2 finite steps")


def cycle_solver(dtype):
    """The 576-cell channel's solver for (d), set up: float64 on the CPU,
    float32 on the card; its tangent solve one cycle of DEFL_CYCLE steps."""
    cfg = deflation_config(dtype, 1e-14, cells_per_block=DEFL_CPB_SMALL)
    cfg.krylov.restart = cfg.krylov.max_iters = DEFL_CYCLE
    device = "cpu" if dtype == "float64" else DEV
    return nt.NavierStokesSolver(deflation_mesh(0), cfg, log=nt.RunLog(verbose=False),
                                 device=device).setup()


def cycle_step(s, rows):
    """The forced Newton step of (d) on solver s with deflation rows
    ``rows`` (None: none) at the seeded state 0.05 * standard_normal (numpy
    seed 0): (the update in float64 on the host, FGMRES count, last
    ||r||/||b||, seconds)."""
    dev, dt = s.device, s._dtype
    wa = s._wassembly
    s._wassembly = dataclasses.replace(wa, kp_modes=None if rows is None
                                       else rows.to(device=dev, dtype=dt))
    try:
        x = torch.as_tensor(0.05 * np.random.default_rng(0).standard_normal(s.dofs.n_total),
                            dtype=dt, device=dev)
        bc = torch.as_tensor(s.dirichlet.values(s.cfg.dt), dtype=dt, device=dev)
        t0 = time.perf_counter()
        u, res, iters, _, last = s._newton_iteration(x, torch.zeros_like(x), bc, s.cfg.dt, True)
        upd = (u - x).double().cpu().numpy()
    finally:
        s._wassembly = wa
    return upd, iters, last / res, time.perf_counter() - t0


def deflation_cycle():
    """(d): the card's own rows against the CPU's, then ``cycle_step`` in
    float32 on the card with the CPU's rows against float64 on the CPU
    (within DEFL_STEP_TOL), and the control without rows (outside it)."""
    t0 = time.perf_counter()
    cpu, card = cycle_solver("float64"), cycle_solver("float32")
    rows = cpu._wassembly.kp_modes
    mine = card._wassembly.kp_modes
    if mine is None or mine.shape != rows.shape or mine.device != DEV:
        raise RuntimeError(f"the card's solver has no {tuple(rows.shape)} rows on the card")
    cos = [float(a @ b / (a.norm() * b.norm())) for a, b in zip(mine.double().cpu(), rows)]
    print(f"  {rows.shape[0]} rows; 1 - cos of the card's rows to the CPU's "
          f"{['%.1e' % (1 - c) for c in cos]} (tol {DEFL_ROW_TOL:g}, sign included); set-up "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    if max(1 - c for c in cos) > DEFL_ROW_TOL:
        raise RuntimeError("the card's deflation rows are not the CPU's")
    want, it64, rel64, t64 = cycle_step(cpu, rows)
    runs = {"deflated": cycle_step(card, rows), "control, no rows": cycle_step(card, None)}
    gaps = {k: float(np.abs(r[0] - want).max() / np.abs(want).max()) for k, r in runs.items()}
    print(f"  float64 on cpu: FGMRES {it64}, ||r||/||b|| {rel64:.3e}, {t64:.1f} s", flush=True)
    for k, (_, it, rel, t) in runs.items():
        print(f"  float32 on {DEV}, {k}: FGMRES {it}, ||r||/||b|| {rel:.3e}, {t:.1f} s; update "
              f"within {gaps[k]:.2e} of the CPU's max (tol {DEFL_STEP_TOL:g})", flush=True)
    if {it64} | {r[1] for r in runs.values()} != {DEFL_CYCLE}:
        raise RuntimeError(f"a solve of (d) did not run its one cycle of {DEFL_CYCLE} steps")
    if gaps["deflated"] > DEFL_STEP_TOL or gaps["control, no rows"] <= DEFL_STEP_TOL:
        raise RuntimeError("the deflated float32 GPU cycle departs from the float64 CPU one, "
                           "or the bound cannot tell a cycle without rows apart")


# (e): Morton-ordered layouts (renumber_blocked(order="sfc")) on every
# kernel family: name, mesh, configuration.  The 2D P2/P1 subwindow kernels
# sum a chunk in its subwindows in shared memory, and along the Morton curve
# a chunk's subwindow spans most of its window: at the 102,400-cell channel
# 2 x 832 + 216 rows of 128 floats and the ring's two stages, 993,280 bytes
# against a block's 232,448 (288,768 at the 25,600-cell channel), so those
# layouts take the compact kernels (W.compact_layout: matvec3_kernel<2, 6,
# 3> and scatter_rows_kernel<2, 6> on the compact tables); the 6,400-cell
# channel's fits (116,736) and keeps the subwindow kernels.  The P3/P2 and
# 3D kernels work on each chunk's distinct entries at every layout.
SFC_LAYOUTS = (
    ("the 6,400-cell channel, P2/P1", lambda: nt.rectangle(80, 40, 0, 7, 0, 4), config),
    ("the 25,600-cell channel, P2/P1",
     lambda: nt.refine_uniform(nt.rectangle(80, 40, 0, 7, 0, 4), 1), config),
    ("the 102,400-cell channel, P2/P1", channel_mesh, lambda: config(cells_per_block=1792)),
    ("the 102,400-cell channel, P3/P2", channel_mesh,
     lambda: config(degree=3, cells_per_block=1792)),
    ("refine_uniform(box(8, 8, 8), 1), P2/P1 tetrahedra",
     lambda: nt.refine_uniform(nt.box(8, 8, 8), 1), kb.box_config),
)
# the layout whose compact route the kernels line times (kernels_vs_plain)
SFC_TIMED = "the 102,400-cell channel, P2/P1"
# the CUDA kernels whose names say which 2D P2/P1 route a call took
ROUTE_KERNELS = {True: ("matvec3_kernel", "scatter_rows_kernel"),
                 False: ("matvec_kernel", "scatter_kernel")}


def compact_plains(lay, operands):
    """{call: plain call} of a compact 2D P2/P1 layout's K1, K2 and K4 in the
    compact kernels' order (``_compact_matvec_reference``,
    ``_compact_scatter_reference``), on ``kb.seeded_operands``' operands."""
    tabs = W.compact_tables(lay)
    x = operands["x"]
    out = {"K1 f32": lambda: W._compact_matvec_reference(lay, operands["A_t"], x, "vp", "vp",
                                                         tabs),
           "K1": lambda: W._compact_matvec_reference(lay, operands["A_bf"], x, "vp", "vp", tabs),
           "K4": lambda: W._compact_scatter_reference(lay, operands["R"], tabs)}
    for key, (A_sub, xs) in operands["blocks"].items():
        i, o = key.split("->")
        out[f"K2 {key}"] = (lambda A_sub=A_sub, xs=xs, i=i, o=o:
                            W._compact_matvec_reference(lay, A_sub, xs, i, o, tabs))
    return out


def check_route(name, lay, calls):
    """A 2D P2/P1 layout's route, from the host (``W.compact_layout``,
    ``W.span_smem_bytes``, held against windowed.cu's own figure by
    ``W.check_span_smem``) and from the CUDA kernels that a K1, a K2 p->p
    and a K4 call ran (torch.profiler): a compact layout that ran a
    subwindow kernel, or the reverse, fails."""
    compact = W.compact_layout(lay)
    print(f"  route: {'compact' if compact else 'subwindow'} (the subwindow kernels would take "
          f"{W.check_span_smem(lay, lay._packed.meta)} B of a block's {W._MAX_SMEM_BYTES}, "
          f"host and windowed.cu alike); K1 "
          f"{W.matvec_design(lay, 'vp', 'vp')}, K2 {W.matvec_design(lay, 'p', 'p')}, K4 "
          f"{W.scatter_design(lay)}", flush=True)
    if compact:
        print("  " + kb.compact_stats(lay).strip(), flush=True)
    ran = set()
    for key in ("K1", "K2 p->p", "K4"):
        for kernel in kb.device_time_by_kernel(calls[key][0], reps=1):
            m = re.search(r"(\w+_kernel)\b", kernel)
            ran.add(m.group(1) if m else kernel)
    print(f"  ran {sorted(ran)}", flush=True)
    if not set(ROUTE_KERNELS[compact]) <= ran or set(ROUTE_KERNELS[not compact]) & ran:
        raise RuntimeError(f"{name}'s sfc layout took the other route: {sorted(ran)}")


def sfc_kernels():
    """(e): at each layout of SFC_LAYOUTS (its blocks doubled from the
    configuration's until the halo fits), on seeded operands: at 2D P2/P1
    the route the layout took (``check_route``); every wrapper called once
    with the launch counts zeroed before and read after (the path's run),
    then held against its plain version (on a compact layout K1, K2 and K4
    against the compact kernels' order, ``compact_plains``), and a repeat
    bit-equal.  At SFC_TIMED also ``kernels_vs_plain``'s times, bound and
    library calls.  Returns (SFC_TIMED's records, its path's launches)."""
    timed = None
    for name, mesh, cfg in SFC_LAYOUTS:
        t0 = time.perf_counter()
        lay, dofs = kb.bare_layout(mesh(), cfg(), device=DEV, order="sfc")
        print(f"  {name}: n_total {dofs.n_total}  nb {lay.nb}  Bmax {lay.Bmax}  nchunks "
              f"{lay.nchunks}  OWv/OWp {lay.OWv}/{lay.OWp}  hv/hp {lay.hv}/{lay.hp}  RVv/RVp "
              f"{lay.RVv}/{lay.RVp}  tables {lay._packed.pos_v.dtype}; "
              f"{time.perf_counter() - t0:.2f} s", flush=True)
        calls, operands = kb.seeded_operands(lay)
        if (lay.dim, lay.k_v) == (2, 6):
            check_route(name, lay, calls)
        if W.compact_layout(lay):
            plains = compact_plains(lay, operands)
            calls = {k: (c, plains.get(k, p)) for k, (c, p) in calls.items()}
        W.reset_launch_counts()
        got = {key: stacked(kernel()) for key, (kernel, _) in calls.items()}
        torch.cuda.synchronize()
        launched = W.launch_counts()
        print(f"  launches of one call each: {launched}", flush=True)
        if min(launched.values()) == 0:
            raise RuntimeError(f"a kernel did not launch at {name}'s sfc layout: {launched}")
        for key, (kernel, plain) in calls.items():
            want = stacked(plain())
            err = float((got[key].double() - want.double()).abs().max())
            scale = float(want.double().abs().max())
            exact = key.startswith("K3")
            ok = torch.equal(got[key], want) if exact else err <= REL_TOL * scale
            print(f"  {key:<8} max|err| {err:.3e} (rel {err / scale:.2e}, "
                  f"{'bit-equal required' if exact else f'tol {REL_TOL:g}'})", flush=True)
            if not ok:
                raise RuntimeError(f"{key} at {name}'s sfc layout disagrees with its plain version")
            check_repeat(key, kernel)
        if name == SFC_TIMED:
            timed = kernels_vs_plain(lay, (calls, operands)), launched
        del lay, calls, operands, got
        torch.cuda.empty_cache()
    return timed


def deflation_phase():
    """Phase 17: FGMRES deflation with kp_deflate's Schur-paired Kp modes,
    float32, windowed + Cahouet-Chabard: (a) the 81,920-cell weakly pinned
    channel's set-up, its rows, their structure and norms, the host time of
    the probe (eigsh) and of the velocity responses (CG); (b) three deflated
    forced Newton steps at a seeded state and one undeflated; (c) 2 BDF1
    steps from rest, deflated; (d) the 576-cell channel's rows and one
    deflated FGMRES cycle, float32 on the card against float64 on the CPU,
    and the cycle without rows as the control; (e) K1-K4 at the
    Morton-ordered layouts of SFC_LAYOUTS."""
    phase("17 deflation: FGMRES with kp_deflate's Schur-paired Kp modes, float32, windowed + "
          "Cahouet-Chabard")
    print("  (a) the 81,920-cell channel: set-up and the deflation rows", flush=True)
    solver, log = deflation_setup()
    print("  (b) forced Newton steps at a seeded state, deflated", flush=True)
    deflation_forced(solver)
    print("  (c) 2 BDF1 steps from rest, deflated", flush=True)
    deflation_steps(solver, log)
    del solver
    torch.cuda.empty_cache()
    print("  (d) the 576-cell channel, one deflated FGMRES cycle: float32 GPU kernels vs "
          "float64 CPU plain versions", flush=True)
    deflation_cycle()
    print("  (e) kernels vs plain at Morton-ordered layouts", flush=True)
    return sfc_kernels()


# Phase 18: the trajectory check (scripts/trajectory_parity.py) on a small
# generated channel.  Every entry row (iter 0: a step's entering residual,
# which integrates every earlier step's solves) of the float32 card run
# within TRAJ_ENTRY_TOL relative of the float64 CPU run's.  Two controls
# must fail it: the inflow 1 % larger (another flow: entry rows ~1e-2
# apart) and the float32 run with its outer operator stored in bf16 (a
# lower-precision path: ~3e-3 relative rounding of every tangent entry).
# The bound lies between the sound float32 runs (3.5e-8 on an H100,
# 2.8e-7 on the CPU, 7.6e-7 on the 6,400-cell channel's 20 steps) and the
# bf16 control (1.2e-5 on the CPU and on an H100)
TRAJ_CELLS, TRAJ_STEPS = 1600, 2
TRAJ_ENTRY_TOL = 2e-6
TRAJ_CONTROLS = {"u_m x 1.01": dict(u_m=tp.U_M * 1.01),
                 "bf16 outer operator": dict(operator_dtype="bfloat16")}


def trajectory_phase():
    """Phase 18: the trajectory check's two legs on the 1,600-cell channel,
    float64 on the CPU and float32 on the card (K1-K4 launched), and the
    controls of TRAJ_CONTROLS."""
    phase(f"18 trajectory: the dynamic inlet on the {TRAJ_CELLS}-cell channel, {TRAJ_STEPS} "
          "BDF1 steps with tight tangents, float32 on the card against float64 on the CPU")
    t0 = time.perf_counter()
    f64 = tp.run("float64", "cpu", TRAJ_CELLS, TRAJ_STEPS)
    t1 = time.perf_counter()
    W.reset_launch_counts()
    f32 = tp.run("float32", str(DEV), TRAJ_CELLS, TRAJ_STEPS)
    launched = W.launch_counts()
    t2 = time.perf_counter()
    print(f"  float64 on cpu {t1 - t0:.1f} s ({torch.get_num_threads()} threads), float32 on "
          f"{DEV} {t2 - t1:.1f} s (launches {launched})", flush=True)
    for name, leg in (("float64", f64), ("float32", f32)):
        rows = [f"{r['step']}/{r['iter']} {r['residual']:.9e}" for r in leg["trajectory"]]
        print(f"  {name}: rows (step/iter ||r||) {rows}; FGMRES {leg['fgmres_iters']}; "
              f"tangent solves short of rel_tol {leg['tangent_floors']}", flush=True)
    if min(launched.values()) == 0:
        raise RuntimeError(f"a kernel did not launch in the float32 trajectory run: {launched}")
    c = tp.compare(f64, f32)  # raises where the Newton stopping decisions differ
    print(f"  {tp.summary(c)} (entry bound {TRAJ_ENTRY_TOL:g})", flush=True)
    if c["max_rel_diff_entry"] > TRAJ_ENTRY_TOL or f32["note"] != "completed":
        raise RuntimeError("the float32 trajectory departs from the float64 one")
    for name, kw in TRAJ_CONTROLS.items():
        t3 = time.perf_counter()
        control = tp.run("float32", str(DEV), TRAJ_CELLS, TRAJ_STEPS, **kw)
        try:
            gap = tp.compare(f64, control)["max_rel_diff_entry"]
            said = f"entry rows within {gap:.3e}"
        except ValueError as e:  # other stopping decisions fail the check too
            gap, said = float("inf"), str(e)
        rows = [f"{r['step']}/{r['iter']} {r['residual']:.9e}" for r in control["trajectory"]]
        print(f"  the control ({name}, {time.perf_counter() - t3:.1f} s): {said}; rows {rows}; "
              f"FGMRES {control['fgmres_iters']}", flush=True)
        if gap <= TRAJ_ENTRY_TOL:
            raise RuntimeError(f"the entry-row bound cannot tell the control ({name}) apart")


MEASURED = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "library",
            "cold_clean_ms", "warm_ms", "host_us")


def sharded_numbers(ranks, leg):
    """{rank count: [each rank's {"launches": {kernel: count} or None,
    "errs": {check: max|err|}}]} of phase 15's leg "channel", "box",
    "p3 channel" or "p3 box" (the P3/P2 errors from (h), the launches from
    (i) at P3_RANKS ranks)."""
    out = {}
    for n, rs in ranks.items():
        if leg == "channel":
            out[n] = [dict(launches=r.get("launches"), errs=r["errs"]) for r in rs]
        elif leg == "box":
            out[n] = [dict(launches=r["box"].get("launches"), errs=r["box"]["errs"]) for r in rs]
        else:
            name = leg.split()[1]
            out[n] = [dict(launches=r["p3_solves"][name]["launches"] if "p3_solves" in r else None,
                           errs=r["p3_kernels"][name]["errs"]) for r in rs]
    return out


def kernel_entries(recs, launches, step_launches, suffix, sharded=None):
    """The kernels line's entries of K1-K4 from ``kernels_vs_plain``'s
    records: the launches of a main-path run and of one forced Newton step,
    the largest error over a kernel's calls, the measured numbers of its
    timed call, and the others' under ``also``; with ``sharded`` (phase
    15's numbers, ``sharded_numbers``) each rank's launches in its run at 2
    ranks (the channels': the forced step; the boxes': their steps) and the
    largest error of the kernel's checks on the ranks, at 2 and at 4 ranks
    (else null); for K1, K2 and K4 ``design``, the CUDA kernels that
    served each product (``W.matvec_design``, ``W.scatter_design``)."""
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
            sharded_ranks=2 if sharded else None,
            sharded_launches=[r["launches"][k] for r in sharded[2]] if sharded else None,
            **{f"sharded_max_abs_err{'' if n == 2 else '_4'}": (
                max(e for r in sharded[n] for key, e in r["errs"].items() if key.split()[0] == k)
                if sharded else None) for n in MULTI_RANKS},
        )
        designs = {key: r["design"] for key, r in mine.items() if "design" in r}
        if designs:  # the CUDA kernels of each timed call
            entry["design"] = designs
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
    mesh = channel_mesh()
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
    recs = kernels_vs_plain(solver._win_layout, kb.wrapper_operands(solver))

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
    step_launches, forced = forced_step(solver)
    multi_ref = dict(  # phase 15's state, targets and controls, in the natural dof order
        state=natural(solver, forced["state"].cpu()), entry=forced["entry"],
        iters=forced["iters"], ms=forced["ms"],
        update=natural(solver, (forced["u_new"] - forced["state"]).cpu()))

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
    recs3, launches3, step_launches3, box_ref = box_phase()
    ranks = multi_rank_phase(multi_ref, smi, box_ref)
    p3 = p3_phase()
    sfc_recs, sfc_launches = deflation_phase()
    trajectory_phase()
    phase.total()

    kernels = (kernel_entries(recs, launches, step_launches, "", sharded_numbers(ranks, "channel"))
               + kernel_entries(recs3, launches3, step_launches3, ", 3D",
                                sharded_numbers(ranks, "box"))
               + kernel_entries(*p3["channel"], ", P3", sharded_numbers(ranks, "p3 channel"))
               + kernel_entries(*p3["box"], ", 3D P3", sharded_numbers(ranks, "p3 box"))
               + kernel_entries(sfc_recs, sfc_launches, dict.fromkeys(("K1", "K2", "K3", "K4"), 0),
                                ", 2D P2/P1 Morton layout (compact route)"))
    kernels.append(dict(
        name="K5 mxu_probe", route="cuda", source=PROBE_SOURCE, replaces=REPLACES["K5"],
        launches=probe_launches, launches_per_newton_step=0,
        sharded_ranks=None, sharded_launches=None, sharded_max_abs_err=None,
        sharded_max_abs_err_4=None,
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
