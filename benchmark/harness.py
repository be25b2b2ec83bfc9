"""The benchmark's run of one cell: set-up, the measured window, the traced
segment and the check against the plain reference.

A cell is a configuration (``configs/<name>.json``: geometry, physics, mesh
recipe, solver settings) under a traffic mix (``traffic/<name>.json``: time
step, scheme, start state, inflow law, segment length K).  The window
replays one segment of K time steps from its start state until the window's
seconds are spent at a segment's end; each step is ``solve(resume=True)``
with the end time one dt on.  ``--seed`` perturbs the start's interior
velocity, so every seed does the same work on other inputs.

Everything particular to a configuration, a traffic mix, a mesh generator,
an inflow profile (``profiles/``), a time law (``laws/``), a start state
(``starts/``) or a metric is found by name under this directory: nothing
here names one.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import math
import re
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

from . import bytes as B
from .reference import Reference, match
from .trace import SEGMENT, Span, read_trace

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "navier_stokes_tpu")
# the CUDA kernels of the port's windowed operator, by their names in a trace
WINDOWED_KERNEL = re.compile(
    r"\b(matvec3?|stream_matvec|narrow_product|narrow_merge|gather|scatter(3|_rows)?|merge3?)"
    r"_kernel\b")


def load_json(path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path):
    """A module of this directory by its file (names may hold dots)."""
    spec = importlib.util.spec_from_file_location(f"benchmark_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> list:
    """Top-level names of loaded modules that a run must not load."""
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def cell(spec: dict, workload: str, root: Path = HERE):
    """(workload entry, configuration, traffic) of a cell of BENCHMARK.json."""
    for w in spec["workloads"]:
        if w["name"] == workload:
            cfg = load_json(root / "configs" / f"{w['config']}.json")
            traffic = load_json(root / "traffic" / f"{w['traffic']}.json")
            return w, cfg, traffic
    raise KeyError(f"no workload {workload!r} in BENCHMARK.json")


def metrics_of(spec: dict, workload: str, kind: str) -> list:
    """The cell's metrics of ``kind`` ("end_to_end" or "per_layer")."""
    return [m for m in spec[kind] if workload in m.get("workloads", [workload])]


def read_metrics(metrics: list, run: dict, root: Path = HERE) -> dict:
    """{name: {"value", "unit"}} from each metric's reader
    (``metrics/<name>.py``: ``read(run)``); a reader that finds nothing to
    read returns None and its metric is left out."""
    out = {}
    for m in metrics:
        value = load_module(root / "metrics" / f"{m['name']}.py").read(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


class Inflow:
    """The inlet velocity u_m law(t) shape(x): the configuration's profile
    (``profiles/<physics.profile>.py``: ``shape(x, geometry)``) and the
    traffic's time law (``laws/<law>.py``: ``amplitude(t, traffic)``)."""

    def __init__(self, cfg: dict, traffic: dict):
        self.u_m, self.geometry, self.traffic = cfg["physics"]["u_m"], cfg["geometry"], traffic
        self.shape = load_module(HERE / "profiles" / f"{cfg['physics']['profile']}.py").shape
        self.law = load_module(HERE / "laws" / f"{traffic['law']}.py").amplitude

    def __call__(self, x: np.ndarray, t: float = 0.0) -> np.ndarray:
        return self.u_m * self.law(t, self.traffic) * self.shape(x, self.geometry)


def start_kind(traffic: dict):
    """The traffic's start state (``starts/<start>.py``: ``make(solver,
    traffic)``, and ``check(judge, state)`` where the reference judges the
    start by itself)."""
    return load_module(HERE / "starts" / f"{traffic['start']}.py")


def zero_velocity(x, t=0.0):
    return np.zeros_like(x)


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


@dataclass
class Bench:
    """One cell's set-up: the mesh, the solver and the unperturbed start."""

    cfg: dict
    traffic: dict
    mesh: dict
    solver: object
    start: torch.Tensor
    interior: torch.Tensor  # velocity rows the seed perturbs (bool, planar)
    inflow: Inflow
    device: str
    times: dict = field(default_factory=dict)


def build_mesh(cfg: dict) -> dict:
    recipe = dict(cfg["geometry"], **cfg["mesh"])
    gen = load_module(HERE / "meshes" / f"{recipe['generator']}.py")
    return gen.build(recipe)


def setup(cfg: dict, traffic: dict, device: str = "cuda") -> Bench:
    """Mesh, solver set-up and the traffic's start state, each timed."""
    from navier_stokes_tpu_torch import Mesh, NavierStokesSolver, RunLog, SolverConfig

    times = {}
    t0 = time.perf_counter()
    mesh = build_mesh(cfg)
    times["mesh_s"] = time.perf_counter() - t0
    phys = cfg["physics"]
    scfg = SolverConfig.from_dict(dict(cfg["solver"], nu=phys["nu"], rho=phys["rho"],
                                       dt=traffic["dt"], time_scheme=traffic["scheme"]))
    inflow = Inflow(cfg, traffic)
    solver = NavierStokesSolver(
        Mesh(mesh["coords"], mesh["cells"], mesh["facets"], mesh["tags"]), scfg,
        log=RunLog(verbose=False), inlet=inflow, device=device)
    t0 = time.perf_counter()
    solver.setup()
    sync(device)
    times["solver_setup_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    start = start_kind(traffic).make(solver, traffic)
    sync(device)
    times[f"{traffic['start']}_s"] = time.perf_counter() - t0
    dofs = solver.dofs
    n_u = dofs.dim * dofs.n_vs
    real = np.ones(dofs.n_vs, bool) if dofs.v_mask is None else np.asarray(dofs.v_mask, bool)
    interior = np.tile(real, dofs.dim)
    rows = np.asarray(solver.dirichlet.rows, np.int64)
    interior[rows[rows < n_u]] = False
    return Bench(cfg, traffic, mesh, solver, start.detach().clone(),
                 torch.as_tensor(interior, device=device), inflow, device, times)


def perturbed(bench: Bench, seed: int) -> torch.Tensor:
    """The start state with its interior velocity moved by up to
    ``perturbation`` x u_m, uniformly at random from ``seed``."""
    g = torch.Generator(device=bench.device)
    g.manual_seed(int(seed))
    n_u = bench.interior.numel()
    amp = bench.traffic["perturbation"] * bench.cfg["physics"]["u_m"]
    noise = (torch.rand(n_u, generator=g, device=bench.device, dtype=torch.float64) * 2 - 1) * amp
    x = bench.start.clone()
    x[:n_u] += (noise * bench.interior).to(x.dtype)
    return x


def reset(solver, start: torch.Tensor):
    """The segment's start: the fields a restored checkpoint sets."""
    solver.solution = start.clone()
    solver.solution_old = solver.solution
    solver.solution_old2 = None
    solver.time = 0.0
    solver._step = 0


def step(solver) -> dict:
    """One time step through the public time loop; its log records."""
    i0 = len(solver.log.records)
    solver.cfg.T = solver.time + solver.cfg.dt
    solver.solve(resume=True)
    recs = solver.log.records[i0:]
    newton = [r["residual"] for r in recs if r.get("event") == "newton"]
    solves = [r["iters"] for r in recs
              if r.get("event") == "gmres" and r.get("system") == "tangent"]
    capped = sum(1 for r in recs if r.get("event") == "krylov_failure")
    del solver.log.records[i0:]
    return {"t": solver.time, "newton": len(newton), "last_residual": newton[-1] if newton else 0.0,
            "solves": solves, "capped": capped}


def window(bench: Bench, start: torch.Tensor, seconds: float) -> dict:
    """Whole segments from ``start`` until ``seconds`` are spent at a
    segment's end: the wall time, each step's record and a copy of each
    step's state for the check."""
    from navier_stokes_tpu_torch.ops.windowed import launch_counts, reset_launch_counts

    s, K = bench.solver, bench.traffic["steps"]
    steps, held = [], []
    reset_launch_counts()
    sync(bench.device)
    t0 = time.perf_counter()
    while True:
        reset(s, start)
        for k in range(1, K + 1):
            rec = step(s)
            rec["k"] = k
            steps.append(rec)
            held.append(s.solution.clone())
        if time.perf_counter() - t0 >= seconds:
            break
    sync(bench.device)
    wall = time.perf_counter() - t0
    return {"wall_s": wall, "steps": steps, "held": held,
            "launches": sum(launch_counts().values())}


def traced_segment(bench: Bench, start: torch.Tensor) -> dict:
    """One segment under torch.profiler, with spans around the solver's
    calls of ``fgmres`` and ``assemble_windowed`` and a tally of the
    windowed products by space pair and A's storage, taken where every
    wrapper launches one (``ops.windowed._launch_matvec``).  A tally that
    does not match the wrappers' own counts of K1 and K2 raises: a product
    launched past it would leave its time in the roofline and its bytes
    out."""
    import navier_stokes_tpu_torch.models.navier_stokes as nsm
    import navier_stokes_tpu_torch.ops.windowed as ow
    from torch.profiler import ProfilerActivity, profile, record_function

    s, dev = bench.solver, bench.device
    spans = {"tangent_solve": Span("bench.fgmres", dev),
             "assemble": Span("bench.assemble_windowed", dev)}
    tally = {}

    launch = ow._launch_matvec

    def counted(lay, A, x, in_spaces, out_spaces, n_out_pad):
        key = (in_spaces, out_spaces, A.element_size())
        tally[key] = tally.get(key, 0) + 1
        return launch(lay, A, x, in_spaces, out_spaces, n_out_pad)

    saved = {n: getattr(nsm, n) for n in ("fgmres", "assemble_windowed")}
    nsm.fgmres = spans["tangent_solve"].wrap(saved["fgmres"])
    nsm.assemble_windowed = spans["assemble"].wrap(saved["assemble_windowed"])
    ow._launch_matvec = counted
    activities = [ProfilerActivity.CPU]
    if torch.device(dev).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    ow.reset_launch_counts()
    try:
        with profile(activities=activities) as prof:
            with record_function(SEGMENT):
                reset(s, start)
                for _ in range(bench.traffic["steps"]):
                    with record_function("bench.step"):
                        step(s)
                sync(dev)
    finally:
        for n, fn in saved.items():
            setattr(nsm, n, fn)
        ow._launch_matvec = launch
    counts = ow.launch_counts()
    products = counts["K1 windowed_matvec"] + counts["K2 windowed_matvec_block"]
    if sum(tally.values()) != products:
        raise RuntimeError(
            f"the byte tally saw {sum(tally.values())} windowed products, the wrappers "
            f"counted {products} (K1 + K2): kernels.windowed_roofline would miss bytes")
    c = B.layout_counts(s._win_layout)
    moved = sum(n * B.matvec_bytes(c, i, o, e) for (i, o, e), n in tally.items())
    moved += counts["K3 windowed_gather"] * B.gather_pair_bytes(c)
    moved += counts["K4 windowed_scatter"] * B.scatter_bytes(c)
    out = read_trace(prof, WINDOWED_KERNEL)
    out.update(bytes=moved, peak_bytes_per_s=B.PEAK_BYTES_PER_S,
               spans={k: v.durations_ms() for k, v in spans.items()})
    return out


def states_for_check(bench: Bench, start: torch.Tensor, win: dict, seed: int) -> list:
    """The steps the reference judges: ``checked_steps`` of the window's
    steps drawn from the seed, the last always among them; each with its
    state, the states before it in its segment and its time, moved to the
    reference's node order on the host."""
    steps, n = win["steps"], len(win["steps"])
    m = min(bench.traffic["checked_steps"], n)
    rng = np.random.default_rng(int(seed))
    picks = sorted(set(rng.choice(n - 1, size=m - 1, replace=False).tolist()) | {n - 1}) \
        if n > 1 else [0]
    jobs = []
    for i in picks:
        k = steps[i]["k"]
        prev = [win["held"][i - j] if k > j else start for j in (1, 2)]
        jobs.append({"step": i, "order": 1 if k == 1 else 2, "t": steps[i]["t"],
                     "u": bench_host(bench, win["held"][i]),
                     "u_old": bench_host(bench, prev[0]),
                     "u_old2": bench_host(bench, prev[1]) if k > 1 else None})
    return jobs


def bench_host(bench: Bench, x: torch.Tensor):
    """(velocity [n_real, dim], pressure [n_real_p]) of a state, in the
    program's real dofs' order (float64, host)."""
    s = bench.solver
    return (np.asarray(s.velocity(x, real_only=True), np.float64),
            np.asarray(s.pressure(x, real_only=True), np.float64))


def program_points(bench: Bench):
    """The support points of the program's real velocity and pressure dofs."""
    d = bench.solver.dofs
    pc = d.p_coords if d.p_mask is None else d.p_coords[np.asarray(d.p_mask, bool)]
    return bench.solver.velocity_coords(real_only=True), pc


class Judge:
    """The plain reference on the cell's mesh, placed to read the program's
    states by their support points."""

    def __init__(self, bench_cfg: dict, mesh: dict, inflow: Inflow, points, device):
        # the program's Dirichlet conditions: the inflow on the inlet tags,
        # then no-slip on the wall tags (which take shared nodes)
        sol = bench_cfg["solver"]
        bc = {**{t: inflow for t in sol["inlet_tags"]},
              **{t: zero_velocity for t in sol["wall_tags"]}}
        self.ref = Reference(mesh["coords"], mesh["cells"], mesh["facets"], mesh["tags"], bc,
                             device=device)
        scale = float(np.abs(mesh["coords"]).max())
        self.vperm = match(self.ref.nodes, points[0], scale)
        self.pperm = match(self.ref.nodes[: self.ref.nv], points[1], scale)
        self.phys = bench_cfg["physics"]
        self.device = device
        self._diag = {}

    def _dev(self, state):
        u, p = state
        t = lambda a: torch.as_tensor(a, device=self.device, dtype=self.ref.dtype)
        return t(u[self.vperm]), t(p[self.pperm])

    def step_residual(self, job, dt) -> float:
        """||residual|| of a judged step at its state, with the Dirichlet rows."""
        nu, rho, order = self.phys["nu"], self.phys["rho"], job["order"]
        if order not in self._diag:
            self._diag[order] = self.ref.diagonal(dt=dt, nu=nu, rho=rho, order=order)
        u, p = self._dev(job["u"])
        uo, _ = self._dev(job["u_old"])
        uo2 = self._dev(job["u_old2"])[0] if job["u_old2"] is not None else None
        r_u, r_p = self.ref.residual(u, p, uo, uo2, dt=dt, nu=nu, rho=rho, order=order)
        return self.ref.norm(r_u, r_p, u, job["t"], self._diag[order])

    def stokes_residual(self, state) -> float:
        """||Stokes residual|| at ``state`` over ||d g|| on the Dirichlet rows
        (the right-hand side of the program's Stokes solve, with d the
        viscous diagonal)."""
        nu, rho = self.phys["nu"], self.phys["rho"]
        d = self.ref.diagonal(dt=1.0, nu=nu, rho=rho, stokes=True)
        u, p = self._dev(state)
        r = self.ref.norm(*self.ref.residual(u, p, nu=nu, rho=rho, stokes=True), u, 0.0, d)
        g = torch.as_tensor(self.ref.bc_values(0.0), device=self.device, dtype=self.ref.dtype)
        bc = torch.as_tensor(self.ref.bc_nodes, device=self.device)
        return r / float(torch.linalg.vector_norm(d[bc, None] * g))


def checks(judge: Judge, traffic: dict, jobs: list, start_state, limits: dict) -> dict:
    """{name: {"value", "limit"}}: the largest residual of the judged steps,
    and the start's own check where its kind has one (named after it)."""
    out = {"residual": {"value": max(judge.step_residual(j, traffic["dt"]) for j in jobs),
                        "limit": limits.get("residual")}}
    kind = start_kind(traffic)
    if hasattr(kind, "check"):
        out[traffic["start"]] = {"value": kind.check(judge, start_state),
                                 "limit": limits.get(traffic["start"])}
    return out


def passed(ch: dict) -> bool:
    return all(c["limit"] is not None and math.isfinite(c["value"]) and c["value"] <= c["limit"]
               for c in ch.values())


def free(bench: Bench):
    """Drop the solver and its device memory."""
    bench.solver = None
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def run_cell(spec: dict, workload: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t_start: float | None = None, cfg=None, traffic=None):
    """One run of a cell: (the result line, with ``checks`` last; the
    step-by-step record).  ``cfg`` and ``traffic`` stand in for the files
    (tests at small sizes)."""
    t_start = time.perf_counter() if t_start is None else t_start
    w, cfg0, traffic0 = cell(spec, workload)
    cfg, traffic = cfg or cfg0, traffic or traffic0
    path = HERE / "limits" / f"{workload}.json"
    limits = load_json(path) if path.exists() else {}
    bench = setup(cfg, traffic, device)
    start = perturbed(bench, seed)
    # warm-up: the segment's first two steps (BDF1 and BDF2)
    reset(bench.solver, start)
    for _ in range(min(2, traffic["steps"])):
        step(bench.solver)
    sync(device)
    setup_s = time.perf_counter() - t_start
    win = window(bench, start, seconds)
    tr = traced_segment(bench, start) if trace else None
    peak = torch.cuda.max_memory_allocated() if torch.device(device).type == "cuda" else 0
    steps = win["steps"]
    tol = bench.solver.cfg.newton.tol
    finite = [bool(torch.isfinite(x).all()) for x in win["held"]]
    failed = sum(1 for r, ok in zip(steps, finite) if r["last_residual"] > tol or not ok)
    # the reference judges the window's states once the solver is freed
    jobs = states_for_check(bench, start, win, seed)
    start_state = bench_host(bench, bench.start)
    points = program_points(bench)
    solves = [n for r in steps for n in r["solves"]]
    run = {"setup_s": setup_s, "step_ms": win["wall_s"] / len(steps) * 1e3,
           **bench.times, "steps": len(steps), "newton": sum(r["newton"] for r in steps),
           "solves": len(solves), "fgmres_iters": sum(solves),
           "capped": sum(r["capped"] for r in steps), "launches": win["launches"],
           "trace": tr}
    win["held"].clear()
    free(bench)
    t0 = time.perf_counter()
    judge = Judge(cfg, bench.mesh, bench.inflow, points, device)
    ch = checks(judge, traffic, jobs, start_state, limits)
    check_s = time.perf_counter() - t0
    kind = "end_to_end" if not trace else "per_layer"
    metrics = read_metrics(metrics_of(spec, workload, kind), run)
    dev = {"platform": "gpu" if torch.device(device).type == "cuda" else "cpu",
           "kind": torch.cuda.get_device_name(0) if torch.cuda.is_available() else "cpu",
           "count": w["chips"], "memory_peak_bytes": int(peak)}
    if tr is not None:
        dev.update(busy_s=tr["busy_s"], window_s=tr["segment_s"])
    result = {"correct": all(finite) and passed(ch), "attempted": len(steps),
              "failed": failed, "metrics": metrics, "device": dev}
    if tr is not None:
        result["breakdown"] = tr["breakdown"]
    result["checks"] = ch
    diag = {"steps": [[r["k"], r["newton"], r["solves"], r["last_residual"]] for r in steps],
            "times": bench.times, "check_s": check_s, "judged": [j["step"] for j in jobs],
            "run": {k: v for k, v in run.items() if k != "trace"}}
    return result, diag
