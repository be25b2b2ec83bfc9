"""Drive the PyTorch + CUDA port of the Navier-Stokes solver once on one GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero; there is no CPU fallback):
  1. device     the card's name and power limit
  2. build      nvcc builds navier_stokes_tpu_torch/csrc/windowed.cu and
                csrc/mxu_probe.cu for sm_90a, both at once
  3. kernels    each windowed kernel (K1-K4) against its plain torch version
                at the shapes of the 102,400-cell channel; CUDA-event times
                with the inputs out of L2 (and warm), host time a call, the
                bound in bytes and the share of it reached, one PyTorch call
                of the same function where there is one (K3, K4), the packed
                position tables against _abs_loc, and K1 / K2 replayed from
                a CUDA graph
  4. slice      NavierStokesSolver on that channel in float32: 3 BDF1 steps of
                the windowed, Cahouet-Chabard-preconditioned Newton solve;
                every Newton loop and every tangent solve must converge
  5. newton     forced Newton steps at a seeded state; each kernel's
                launches in one of them
  6. launches   each kernel's launch count during phase 4 (all must be > 0)
  7. parity     unit_square(6): float32 on the GPU (kernels) against float64
                on the CPU (plain versions), Newton residuals per step
  8. probe      K5, the tensor-core probe, against its plain version at
                every M of the probe, then its entry point's table
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

Files the phases write (.msh, configs, run logs) go to build/chip_smoke/.
The next-to-last line is the kernels' JSON record, and the last line is
{"ok": true, "device": {...}}.  In the record, per kernel: ``launches`` on
the main path (phase 4; K5: its entry point), ``launches_per_newton_step``
(phase 5), ``max_abs_err`` against the plain version, ``ms`` the wrapper's
CUDA-event time with its inputs out of L2 (``warm_ms`` in a loop on the
same inputs, ``host_us`` the host's time to queue a call), ``plain_ms`` the
plain version's, ``bound_ms`` the least time the card could take (the bytes
that must move over 3.35 TB/s, or the operations over 989 TFLOP/s:
``bound_by``), ``library_ms`` one PyTorch call computing the same function
(null where there is none; never used by the package; for K5 the probe's
products as warm torch.matmul calls queued one by one, ``library_graph_ms``
the same calls replayed from a CUDA graph).
"""

import contextlib
import json
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
# the card's published peaks (H100 SXM): device memory and dense bf16
PEAK_BYTES_PER_S, PEAK_BF16_FLOPS = 3.35e12, 989e12


def phase(name):
    print(f"\n== {name}", flush=True)


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


def compare(name, kernel, plain, exact=False, bound_bytes=None, library=None):
    """Kernel vs plain on the same inputs, then times in turns (plain,
    kernel, kernel, plain) with the inputs out of L2, the kernel's warm time
    and host time a call, and ``library`` (one PyTorch call of the same
    function) if given.  With ``bound_bytes`` the share of the bound reached
    is checked: over 1.0 the count of bytes or the timing is wrong."""
    got, want = kernel(), plain()
    torch.cuda.synchronize()
    err = float((got.double() - want.double()).abs().max())
    scale = float(want.double().abs().max())
    ok = torch.equal(got, want) if exact else err <= REL_TOL * scale
    p1, k1, k2, p2 = (cuda_ms_cold(plain), cuda_ms_cold(kernel), cuda_ms_cold(kernel),
                      cuda_ms_cold(plain))
    rec = dict(max_abs_err=err, rel_err=err / max(scale, 1e-300),
               ms=(k1 + k2) / 2, plain_ms=(p1 + p2) / 2, warm_ms=cuda_ms(kernel),
               host_us=host_us(kernel), library_ms=None)
    line = (f"  {name:<30} max|err| {err:.3e} (rel {rec['rel_err']:.2e}, "
            f"{'bit-equal required' if exact else f'tol {REL_TOL:g}'}) "
            f"kernel {rec['ms']:.4f} ms (warm {rec['warm_ms']:.4f}, host "
            f"{rec['host_us']:.1f} us a call)  plain {rec['plain_ms']:.4f} ms")
    if library is not None:
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


def bound_bytes_of(lay, ops):
    """Bytes each wrapper call must move at this layout, every input read
    once and every output written once: of A the used rows' values in the
    occupied slots; of the packed position tables the occupied slots'
    entries of the spaces the call touches, with their subwindow offsets and
    the slot counts; the vectors.  K3 writes its whole [nli, ncd] output."""
    pos_v, _, cnt = W.pack_positions(lay)
    n_occ, idx = int(cnt.sum()), pos_v.element_size()
    tables = {"v": lay.k_v * n_occ * idx + lay.offs_v.numel() * 4,
              "p": lay.k_p * n_occ * idx + lay.offs_p.numel() * 4}
    size = {"v": lay.n_u, "p": lay.n_ps}
    rows = {"v": lay.dim * lay.k_v, "p": lay.k_p}

    def matvec(ins, outs, elt):
        spaces = set(ins) | set(outs)
        return (sum(rows[a] for a in ins) * sum(rows[a] for a in outs) * n_occ * elt
                + sum(tables[a] for a in spaces) + cnt.numel() * 4
                + 4 * sum(size[a] for a in ins) + 4 * sum(size[a] for a in outs))

    n = lay.n_u + lay.n_ps
    both = tables["v"] + tables["p"] + cnt.numel() * 4
    out = {
        "K3": 4 * n + both + 4 * lay.nli * lay.ncd,
        "K4": 4 * lay.nl * n_occ + both + 4 * n,
        "K1 f32": matvec("vp", "vp", 4),
        "K1": matvec("vp", "vp", 2),
    }
    for key, (A_sub, _) in ops["blocks"].items():
        i, o = key.split("->")
        out[f"K2 {key}"] = matvec(i, o, A_sub.element_size())
    return out


def flat_dof_index(lay):
    """[nli * ncd] int64: the entry of the extended vector [x, 0] that
    X[l, s] copies (n_total for padded slots, rows past nl and window
    positions off the vector's ends).  For the library yardsticks of K3
    (index_select) and K4 (index_add_) only."""
    n = lay.n_u + lay.n_ps
    pos_v, pos_p, _ = W.pack_positions(lay)
    b = torch.arange(lay.nb, device=lay.device)[:, None, None]
    rows = []
    for pos, OW, h, size, starts in (
            (pos_v, lay.OWv, lay.hv, lay.n_vs, [c * lay.n_vs for c in range(lay.dim)]),
            (pos_p, lay.OWp, lay.hp, lay.n_ps, [lay.n_u])):
        p = W.unpack_positions(pos)  # [nb, k, Bmax]
        r = (b - h) * OW + p
        ok = (p >= 0) & (r >= 0) & (r < size)
        for start in starts:
            rows.append(torch.where(ok, r + start, n).permute(1, 0, 2).reshape(-1, lay.ncd))
    rows.append(torch.full((lay.nli - lay.nl, lay.ncd), n, device=lay.device))
    return torch.cat(rows).reshape(-1)


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


def matmul_loop_ms(a, b, M, iters):
    """(queued, replayed) warm CUDA-event times in ms of ``iters`` bf16
    torch.matmul calls a_panel(i % 8) @ b, the products of one probe launch:
    queued one by one from the host, and replayed from a CUDA graph of the
    same loop (no host time between the products)."""
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
    return cuda_ms(loop), cuda_ms(graph.replay)


def check_graph_replay(name, call, x):
    """Capture one wrapper call in a CUDA graph, write new values into its
    input vector, replay, and hold the output against an eager call."""
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
    want = call()
    torch.cuda.synchronize()
    err = float((y.double() - want.double()).abs().max())
    scale = float(want.double().abs().max())
    replay_ms = cuda_ms(graph.replay)
    print(f"  {name}: graph replay vs eager max|err| {err:.3e} (rel {err / scale:.2e}, "
          f"tol {REL_TOL:g}); replay {replay_ms:.4f} ms warm", flush=True)
    if not err <= REL_TOL * scale:
        raise RuntimeError(f"{name}: graph replay disagrees with an eager call")


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
        for line in info["log"].splitlines():
            if "registers" in line or ("spill" in line and " 0 bytes spill stores" not in line):
                print(f"  ptxas: {line.strip()}")

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
    calls, ops_ = kb.channel_operands(solver)
    x, R = ops_["x"], ops_["R"]
    check_packed_tables(lay)
    # one PyTorch call of the same function, for K3 and K4 (yardsticks only)
    dof_index = flat_dof_index(lay)
    x_ext = torch.cat([x, x.new_zeros(1)])
    lib_gather = lambda: torch.index_select(x_ext, 0, dof_index).view(lay.nli, lay.ncd)
    lib_scatter = lambda: x.new_zeros(n + 1).index_add_(0, dof_index, R.reshape(-1))[:n]
    if not torch.equal(lib_gather(), W._gather_reference(lay, x)):
        raise RuntimeError("the index_select yardstick is not K3's function")
    want = W._scatter_reference(lay, R)
    if float((lib_scatter() - want).abs().max()) > REL_TOL * float(want.abs().max()):
        raise RuntimeError("the index_add_ yardstick is not K4's function")
    bounds = bound_bytes_of(lay, ops_)
    titles = {"K3": "K3 gather", "K4": "K4 scatter", "K1 f32": "K1 matvec, f32 A",
              "K1": "K1 matvec, bf16 A (main path)"}
    library = {"K3": lib_gather, "K4": lib_scatter}
    recs = {
        key: compare(titles.get(key, f"{key}, bf16 A"), kernel, plain, exact=key == "K3",
                     bound_bytes=bounds[key], library=library.get(key))
        for key, (kernel, plain) in calls.items()
    }
    check_graph_replay("K2 v->v", calls["K2 v->v"][0], x)
    check_graph_replay("K1 bf16", calls["K1"][0], x)
    del calls, ops_, x, R, x_ext, dof_index, lib_gather, lib_scatter, library, want

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
    state = torch.as_tensor(0.05 * np.random.default_rng(0).standard_normal(n),
                            dtype=torch.float32, device=DEV)
    bc_vals = torch.as_tensor(solver.dirichlet.values(solver.cfg.dt), dtype=torch.float32,
                              device=DEV)
    times = []
    for _ in range(3):
        W.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = solver._newton_iteration(state, torch.zeros_like(state), bc_vals,
                                       solver.cfg.dt, True)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        step_launches = {k.split()[0]: v for k, v in W.launch_counts().items()}
        print(f"  forced Newton step: {times[-1] * 1e3:.1f} ms, ||r|| {out[1]:.6e}, "
              f"GMRES iterations {out[2]}, converged {out[3]}", flush=True)
        if not out[3]:
            raise RuntimeError("forced Newton step: tangent solve did not converge")
    print(f"  median {np.median(times) * 1e3:.1f} ms; launches in one step: {step_launches}",
          flush=True)

    phase("6 kernel launches during phase 4")
    for k, v in launches.items():
        print(f"  {k}: {v}")
    if min(launches.values()) == 0:
        raise RuntimeError(f"a kernel of the main path was never launched: {launches}")

    phase("7 small-mesh parity: float32 GPU kernels vs float64 CPU plain versions")
    runs = {}
    for dtype, device, rel in (("float64", "cpu", 1e-9), ("float32", DEV, 1e-6)):
        plog = nt.RunLog(verbose=False)
        s = nt.NavierStokesSolver(
            nt.unit_square(6), config(dtype, rel, cells_per_block=16), log=plog, device=device
        )
        s.solve()
        runs[dtype] = trajectory(plog.records)
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
    # K5's bound and yardstick at the largest M: the products' operations over
    # the tensor cores' peak (or the operands' bytes, if that took longer), and
    # the same PROBE_CHECK_ITERS products as bf16 torch.matmul calls over the
    # rotating panels (a and b are the last M's operands)
    m_max = max(mxu.M_VALUES)
    k5 = probe_recs[m_max]
    flops = 2.0 * m_max * mxu.K * mxu.N * PROBE_CHECK_ITERS
    moved = a.numel() * 2 + b.numel() * 2 + m_max * mxu.N * 4
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, moved / PEAK_BYTES_PER_S * 1e3
    k5.update(bound_ms=max(t_ops, t_bytes), bound_by="operations" if t_ops >= t_bytes else "bytes")
    k5["share"] = k5["bound_ms"] / k5["ms"]
    k5["library_ms"], k5["library_graph_ms"] = matmul_loop_ms(a, b, m_max, PROBE_CHECK_ITERS)
    print(f"  K5 M={m_max}: bound {k5['bound_ms']:.5f} ms by {k5['bound_by']} "
          f"({flops / 1e9:.2f} GFLOP), share {k5['share']:.4f}; {PROBE_CHECK_ITERS} bf16 "
          f"torch.matmul calls, warm: queued {k5['library_ms']:.4f} ms, replayed from a "
          f"CUDA graph {k5['library_graph_ms']:.4f} ms; the kernel warm {k5['warm_ms']:.4f} ms "
          f"(a product: matmul {k5['library_graph_ms'] / PROBE_CHECK_ITERS * 1e3:.2f} us, "
          f"kernel {k5['warm_ms'] / PROBE_CHECK_ITERS * 1e3:.2f} us)", flush=True)
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

    names = {"K1": "K1 windowed_matvec", "K2": "K2 windowed_matvec_block",
             "K3": "K3 windowed_gather", "K4": "K4 windowed_scatter"}
    counts = {k.split()[0]: v for k, v in launches.items()}
    timed = {"K1": "K1", "K2": "K2 v->v", "K3": "K3", "K4": "K4"}
    measured = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "warm_ms", "host_us")
    kernels = []
    for k in ("K1", "K2", "K3", "K4"):
        mine = {key: r for key, r in recs.items() if key.split()[0] == k}
        entry = dict(
            name=names[k], route="cuda", source=KERNEL_SOURCE, replaces=REPLACES[k],
            launches=counts[k], launches_per_newton_step=step_launches[k],
            max_abs_err=max(r["max_abs_err"] for r in mine.values()), timed=timed[k],
            **{key: recs[timed[k]][key] for key in measured},
        )
        if len(mine) > 1:  # the other operands of the same kernel
            entry["also"] = {key: {m: r[m] for m in measured} for key, r in mine.items()
                             if key != timed[k]}
        kernels.append(entry)
    kernels.append(dict(
        name="K5 mxu_probe", route="cuda", source=PROBE_SOURCE, replaces=REPLACES["K5"],
        launches=probe_launches, launches_per_newton_step=0,
        max_abs_err=max(r["max_abs_err"] for r in probe_recs.values()),
        timed=f"M={m_max}, {PROBE_CHECK_ITERS} products",
        library_graph_ms=k5["library_graph_ms"], **{key: k5[key] for key in measured},
    ))
    print()
    print(smi)  # the card's name and power limit, as nvidia-smi gives them
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                              "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
