"""Time the windowed kernels' wrappers and the Newton step on one GPU.

    python -m navier_stokes_tpu_torch.scripts.kernel_bench [--label NAME] [--case box]
        [--degree 3]

It runs on the card only (no CUDA device: it exits): from the repository's
root on a machine with one H100, e.g. ``python -m
navier_stokes_tpu_torch.scripts.kernel_bench --case box --degree 3``.

Run from a directory that holds the package (the repository root, or an
unpacked copy of another commit: the script uses only the package's public
functions, so one file times two trees in one run on one card).  On the
102,400-cell channel of chip_smoke.py (float32, windowed, Cahouet-Chabard)
it prints one JSON object with, for each wrapper call (K1 with bf16 and
float32 A, the three K2 products with bf16 A, K3, the K3 pair -- the
gathers of u and u_old of an assembly, one launch where the tree has
``windowed_gather_pair``, else two ``windowed_gather`` calls -- K4, and
K5, the tensor-core probe, at M 256 over 64 products).  ``--case box``
times the same wrapper calls (not K5) at the 3D layout of the 196,608-tet
box (``box_mesh``, ``box_config``: chip_smoke.py phase 14).  ``--degree 3``
takes either case at Taylor-Hood P3/P2 (cubic velocity, quadratic pressure:
``channel_config`` / ``box_config`` with ``degree=3``, chip_smoke.py phase 16)
in place of P2/P1:

  warm_ms        CUDA-event time of a call in a loop of calls on the same
                 inputs (what fits the 50 MB L2 stays there)
  cold_ms        CUDA-event time of a call made after a 256 MB write has
                 pushed its inputs out of L2: what a caller inside the
                 solver sees, and the time to hold against a bound in bytes
                 from device memory.  L2 is left full of the write's dirty
                 lines, so the call also pays for writing them back
                 (every timed batch is queued behind a device-side wait,
                 ``HOST_LEAD_CYCLES``, so that the host's time a call is in
                 none of these figures: without it a warm loop of wrapper
                 calls reads the host's pace, ~25-50 us a call, and a cold
                 reading can hold a stall of the host)
  cold_clean_ms  the same after the 256 MB write and then a 256 MB read:
                 L2 holds only clean lines, so nothing is written back
  host_us        host time a call: the median of 5 batches of 200 calls
                 queued with no synchronisation
  bound_ms       the bytes a windowed wrapper call must move
                 (``bound_bytes_of``) over 3.35 TB/s; ``share`` is
                 bound_ms / cold_ms
  library_ms     cold time of one PyTorch call of the same function
                 (``library_call``: a CSR product, index_select or
                 index_add_), never used by the package
  moved_bytes    (K1, K2, K4 in 3D; K1, K2 and K4 on P3/P2 triangles) the
                 bytes the kernel and its merge really move
                 (``moved_bytes_compact``): the bound's, plus x where the
                 kernel reads it, the compact tables or the row list, and
                 the scratch
  stream         (the products on the streaming kernel: K1 at P3/P2, K2
                 v->v on P3/P2 triangles, K2 v->p and p->p on P3/P2
                 tetrahedra) its launch (``W.stream_config``): ring stages
                 and bytes a stage, shared memory a block, resident blocks
                 an SM, the grid

and the median host-clock time of a forced Newton step at a seeded state
and of the BDF1 solve (3 steps on the channel, 2 on the box).  ``--bare``
times the wrappers on seeded operands at the layout alone (``bare_layout``,
``seeded_operands``: no solver set-up, no Newton step; the box's P3/P2
set-up takes ~200 s), ``--no-library`` skips the yardsticks.
``--profile`` adds each call's device time by CUDA kernel
(torch.profiler) warm, after the write and after the write and the read (a
product on two kernels, such as K2 v->p and p->p on P3/P2 triangles, shows
its product and its merge apart), and the device time by CUDA kernel of
one forced Newton step.  ``--only``
takes names ("K3 pair") or families ("K3": K3 and the K3 pair).  The
timing helpers are chip_smoke.py's too.

``--save PATH`` writes each timed wrapper's output at the seeded operands
(torch.save, on the host); ``--compare PATH`` holds this tree's outputs
bit for bit (torch.equal) against such a file and exits 1 where one
differs or is missing.  With ``--bare`` the operands depend on the layout
and the seed alone, so two commits' kernels can be compared: e.g. the
parent with ``--save`` from an unpacked copy, then the change with
``--compare`` (``bit_equal`` in the record).
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import time

import numpy as np
import torch

from ..ops import windowed as W

FLUSH_BYTES = 256 << 20  # five times the H100's 50 MB L2
REPS = 30  # timed calls behind every warm and cold figure of main()
PEAK_BYTES_PER_S = 3.35e12  # H100 SXM device memory (the bound's rate)
# the CUDA kernels of csrc/windowed.cu, by their names in a profiler trace
WINDOWED_KERNEL = re.compile(
    r"\b(matvec3?|stream_matvec|narrow_product|narrow_merge|gather|scatter(3|_rows)?|merge3?)"
    r"_kernel\b")


def channel_config(dtype="float32", rel_tol=1e-2, cells_per_block=448, degree=2):
    """chip_smoke.py's solver configuration: 3 BDF1 steps, windowed matvec,
    Cahouet-Chabard, the corrected formulation (with the reference's quirks
    the tangent is not the residual's derivative, and the channel's Newton
    loop diverges from step 2 on, in float64 with the plain versions too).

    ``degree=3``: Taylor-Hood P3/P2 and no preconditioner ("identity", the
    configuration's default).  Cahouet-Chabard and the block preconditioners
    scale by the lumped pressure mass ``inv_mp``, which both packages build
    by row sums, wrong for P2 pressure (vertex entries near 0 on triangles,
    negative on tetrahedra: ROADMAP.md Queue 3), so their P3/P2 tangent
    solves do not converge."""
    from .. import SolverConfig

    cfg = SolverConfig()
    cfg.dtype = dtype
    if degree == 3:
        cfg.degree_velocity, cfg.degree_pressure = 3, 2
    elif degree != 2:
        raise ValueError(f"degree {degree}: the windowed kernels take P2/P1 and P3/P2")
    cfg.T = 0.15  # 3 BDF1 steps at dt = 0.05
    cfg.inlet_tags, cfg.neumann_tags, cfg.wall_tags = (0,), (1,), (2, 3)
    cfg.inlet.freeze_time, cfg.inlet.H = False, 4.0  # non-zero inflow
    cfg.krylov.matvec = "windowed"
    cfg.krylov.preconditioner = "cahouet_chabard" if degree == 2 else "identity"
    cfg.krylov.max_iters = 2000
    cfg.krylov.rel_tol = rel_tol
    cfg.krylov.cells_per_block = cells_per_block
    cfg.convection_form = "standard"
    cfg.include_continuity_residual = True
    cfg.jacobian_mass_rho = True
    cfg.newton.max_iters = 20
    return cfg


BOX_RAMP_T = 0.1  # the box inlet's ramp time
BOX_U_M = 1.5  # the box inlet's peak velocity


def box_config(dtype="float32", rel_tol=1e-2, degree=2):
    """The 3D case (chip_smoke.py phase 14): bench.py's tetrahedral leg on a
    unit cube -- P2/P1 tetrahedra, windowed + Cahouet-Chabard with 6 A00
    sweeps and the tangent stored in bf16 -- in channel_config's corrected
    formulation, BDF1, dt 0.05, 2 steps; inlet tag 0 (``box_inlet``),
    outlet 1, walls 2-5.  The A00 sweeps are FGMRES, not bench.py's CG: at
    the 196,608-tet box convection dominates A00 in step 2 (u/h 48 against
    rho/dt 20) and the CG-swept tangent solve stalls at 5e-2 of ||b||, with
    the tangent stored in float32 as in bf16 (``box_a00``); the JAX
    package's CG sweeps lose to convection alike (tests/test_torch_3d.py,
    PERF.md §6).  ``degree=3``: P3/P2 tetrahedra, no preconditioner
    (``channel_config``)."""
    cfg = channel_config(dtype, rel_tol, degree=degree)
    cfg.T = 0.1  # 2 BDF1 steps at dt = 0.05
    cfg.inlet_tags, cfg.neumann_tags, cfg.wall_tags = (0,), (1,), (2, 3, 4, 5)
    cfg.krylov.tangent_store_dtype = "bfloat16"
    cfg.krylov.cc_iters_a00 = 6
    cfg.krylov.a00_solver = "gmres"
    return cfg


def box_inlet(x, t=0.0):
    """u = (16 u_m y(1-y) z(1-z) min(1, t / BOX_RAMP_T), 0, 0) on the unit
    cube's inlet face: a parabolic profile with peak u_m = BOX_U_M, ramped
    up from rest."""
    v = np.zeros_like(x)
    y, z = x[:, 1], x[:, 2]
    v[:, 0] = 16.0 * BOX_U_M * y * (1.0 - y) * z * (1.0 - z) * min(1.0, t / BOX_RAMP_T)
    return v


def box_mesh():
    """refine_uniform(box(8, 8, 8), 2): 196,608 tetrahedra (bench.py's 3D
    leg where it has no .msh of its own, at its default refine 2)."""
    from .. import box, refine_uniform

    return refine_uniform(box(8, 8, 8), 2)


# A device-side wait (torch.cuda._sleep, in clock cycles: ~10 ms at the
# H100's clocks) queued before every timed batch, so that the host has
# queued the whole batch before the card reaches its first event: no time
# the host takes to queue a call (~25-50 us for a windowed wrapper) and no
# stall of the host falls between two events.
HOST_LEAD_CYCLES = 20_000_000


def _host_ahead():
    torch.cuda._sleep(HOST_LEAD_CYCLES)


def cuda_ms(fn, reps=20):
    """Warm time of fn() in ms: one pair of events around ``reps`` calls,
    queued behind ``_host_ahead``."""
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    _host_ahead()
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def evictor(clean=False):
    """A function that pushes everything out of L2: a write of FLUSH_BYTES
    (which leaves L2 full of dirty lines), and with ``clean`` a read of
    another FLUSH_BYTES after it (which writes them back and leaves only
    clean lines)."""
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    if not clean:
        return flush.zero_
    other = torch.zeros(FLUSH_BYTES // 4, dtype=torch.float32, device="cuda")
    total = torch.empty((), dtype=torch.float32, device="cuda")

    def evict():
        flush.zero_()
        torch.sum(other, dim=0, out=total)

    return evict


@torch.no_grad()
def cuda_ms_cold(fn, reps=20, clean=False):
    """Time of fn() in ms with its inputs out of L2: before every call
    ``evictor(clean)`` evicts them; each call has its own pair of events,
    the whole batch queued behind ``_host_ahead`` (the eviction alone kept
    the host ahead only while the host did not stall: a stall of 50-130 us
    fell inside one call's events)."""
    fn()  # first-call work (library handles, scratch) is not the call's time
    evict = evictor(clean)
    pairs = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
             for _ in range(reps)]
    torch.cuda.synchronize()
    _host_ahead()
    for t0, t1 in pairs:
        evict()
        t0.record()
        fn()
        t1.record()
    torch.cuda.synchronize()
    return sum(t0.elapsed_time(t1) for t0, t1 in pairs) / reps


def host_us(fn, calls=200, batches=5):
    """Host time of one fn() in us: the median over ``batches`` batches of
    ``calls`` calls queued back to back with no synchronisation (host clock
    over a batch; the device catches up between batches)."""
    per_call = []
    for _ in range(batches):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        per_call.append((time.perf_counter() - t0) * 1e6 / calls)
    torch.cuda.synchronize()
    return float(np.median(per_call))


def _kernel_times(fn, reps):
    """{CUDA kernel name: (device us, launches) over ``reps`` calls of fn()},
    from a torch.profiler trace."""
    from torch.profiler import ProfilerActivity, profile

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
            out[ev.key[:90]] = (t, ev.count)
    return out


@torch.no_grad()
def device_time_by_kernel(fn, reps=30, evict=None):
    """{CUDA kernel name: (device us, launches) a call of fn()}, from a
    torch.profiler trace of ``reps`` calls: warm, or each after ``evict()``
    (an ``evictor``), of the kernels fn() launches warm.  Launches below
    fn()'s own count a call mean the trace lost events."""
    fn()
    torch.cuda.synchronize()
    times = _kernel_times(fn, reps)
    if evict is not None:
        def call():
            evict()
            fn()

        times = {k: v for k, v in _kernel_times(call, reps).items() if k in times}
    return {k: (t / reps, n / reps) for k, (t, n) in times.items()}


def wrapper_operands(solver, seed=1):
    """Seeded operands of every wrapper at solver's layout: {name: (call,
    plain call)} for K1 (float32 and bf16 A), K2 (bf16 A), K3, the K3 pair,
    K4.  In a sharded run (every rank calls this: the assembly exchanges)
    the layout is the rank's framed one and the operands are of its size;
    the tangent is assembled at the owned part of the seeded state."""
    from ..fem.windowed_assembly import assemble_windowed

    lay, wa = solver._win_layout, solver._wassembly
    dev = lay.device
    rng = np.random.default_rng(seed)
    n = lay.n_u + lay.n_ps

    def vec():
        return torch.as_tensor(rng.standard_normal(n), dtype=torch.float32, device=dev)

    x, u, xo = vec(), 0.05 * vec(), vec()
    u_own = u[: lay.dim * lay.nvs_own + lay.nps_own]
    A_t, _, _ = assemble_windowed(wa, lay, u_own, torch.zeros_like(u_own), dt=0.05, nu=1e-3,
                                  rho=1.0, group=getattr(solver, "_group", None))
    A_t = A_t.float()  # the tangent's store may be bf16 (the box's is)
    R = torch.as_tensor(rng.standard_normal((lay.nli, lay.ncd)), dtype=torch.float32,
                        device=dev)
    return _wrapper_calls(lay, x, xo, A_t, R, wa.Kp_t)


def bare_layout(mesh, cfg, nb_multiple=1, device="cuda:0", order="rcm"):
    """(layout, dofs): the windowed layout that NavierStokesSolver.setup
    builds for mesh at cfg's degrees (the blocked renumbering,
    cells_per_block doubled while the halo is too wide; the block count a
    multiple of nb_multiple), without the assembly's host precompute.
    ``order``: the renumbering's cell order, "rcm" (the solver's) or "sfc"
    (the Morton curve of ``renumber_blocked``)."""
    from ..fem.dofs import make_dofs, renumber_blocked

    dofs = make_dofs(mesh, cfg.degree_velocity, cfg.degree_pressure)
    cpb = cfg.krylov.cells_per_block
    for _ in range(6):
        try:
            d, bi = renumber_blocked(dofs, cells_per_block=cpb, nb_multiple=nb_multiple,
                                     order=order)
            return W.build_windowed_layout(d.cell_vdofs, d.cell_pdofs, d.n_vs, d.n_ps, mesh.dim,
                                           block_info=bi, Bc=cfg.krylov.chunk_cells,
                                           device=device), d
        except ValueError:
            cpb *= 2
    raise RuntimeError("no windowed layout fits the mesh")


def seeded_operands(lay, seed=1):
    """``wrapper_operands`` at a bare layout, with no solver behind it: x,
    x_old, A [nl, nli, ncd] and R [nli, ncd] standard normal from a torch
    generator on the layout's device (made there: A holds 1.4 G values at
    the 196,608-tet box at P3/P2), K2 p->p's operator cut from A."""
    g = torch.Generator(device=lay.device).manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=lay.device)

    n = lay.n_u + lay.n_ps
    x, xo, A_t, R = randn(n), randn(n), randn(lay.nl, lay.nli, lay.ncd), randn(lay.nli, lay.ncd)
    return _wrapper_calls(lay, x, xo, A_t, R, W.slice_block(lay, A_t, "p", "p"))


def _wrapper_calls(lay, x, xo, A_t, R, Kp_t):
    """{name: (call, plain call)} and the operands of ``wrapper_operands``."""
    A_bf = A_t.to(torch.bfloat16)
    n_u = lay.n_u
    # an older tree gathers u and u_old with two calls
    pair = getattr(W, "windowed_gather_pair", None) or (
        lambda lay, a, b: (W.windowed_gather(lay, a), W.windowed_gather(lay, b)))
    calls = {
        "K3": (lambda: W.windowed_gather(lay, x), lambda: W._gather_reference(lay, x)),
        "K3 pair": (lambda: pair(lay, x, xo),
                    lambda: (W._gather_reference(lay, x), W._gather_reference(lay, xo))),
        "K4": (lambda: W.windowed_scatter(lay, R), lambda: W._scatter_reference(lay, R)),
        "K1 f32": (lambda: W.windowed_matvec(lay, A_t, x),
                   lambda: W.windowed_matvec_reference(lay, A_t, x)),
        "K1": (lambda: W.windowed_matvec(lay, A_bf, x),
               lambda: W.windowed_matvec_reference(lay, A_bf, x)),
    }
    blocks = {
        "v->v": (W.slice_block(lay, A_t, "v", "v").to(torch.bfloat16), x[:n_u]),
        "v->p": (W.slice_block(lay, A_t, "v", "p").to(torch.bfloat16), x[:n_u]),
        "p->p": (Kp_t.to(torch.bfloat16), x[n_u:]),
    }
    for key, (A_sub, xs) in blocks.items():
        i, o = key.split("->")
        calls[f"K2 {key}"] = (
            lambda A_sub=A_sub, xs=xs, i=i, o=o: W.windowed_matvec_block(
                lay, A_sub, xs, in_spaces=i, out_spaces=o),
            lambda A_sub=A_sub, xs=xs, i=i, o=o: W._block_reference(lay, A_sub, xs, i, o),
        )
    operands = dict(x=x, xo=xo, R=R, A_t=A_t, A_bf=A_bf, blocks=blocks)
    return calls, operands


def bound_bytes_of(lay, operands):
    """Bytes each wrapper call must move at this layout, every input read
    once and every output written once: of A the used rows' values in the
    occupied slots; of the packed position tables the occupied slots'
    entries of the spaces the call touches, with their subwindow offsets and
    the slot counts, and in 2D (K1, K2, K4) the occupied slots' colours (3D
    kernels and a compact 2D layout's read none); the vectors.  The widths (k_v, k_p, nl, nli) are
    the layout's, P2/P1 or P3/P2.  K3 writes its whole [nli, ncd] output;
    the pair reads the tables once for its two vectors and outputs."""
    pos_v, _, cnt = W.pack_positions(lay)
    n_occ, idx = int(cnt.sum()), pos_v.element_size()
    compact = getattr(W, "compact_layout", lambda _: False)(lay)
    colours = n_occ if lay.dim == 2 and not compact else 0
    tables = {"v": lay.k_v * n_occ * idx + lay.offs_v.numel() * 4,
              "p": lay.k_p * n_occ * idx + lay.offs_p.numel() * 4}
    size = {"v": lay.n_u, "p": lay.n_ps}
    rows = {"v": lay.dim * lay.k_v, "p": lay.k_p}

    def matvec(ins, outs, elt):
        spaces = set(ins) | set(outs)
        return (sum(rows[a] for a in ins) * sum(rows[a] for a in outs) * n_occ * elt
                + sum(tables[a] for a in spaces) + cnt.numel() * 4 + colours
                + 4 * sum(size[a] for a in ins) + 4 * sum(size[a] for a in outs))

    n = lay.n_u + lay.n_ps
    both = tables["v"] + tables["p"] + cnt.numel() * 4
    out = {
        "K3": 4 * n + both + 4 * lay.nli * lay.ncd,
        "K3 pair": 2 * (4 * n + 4 * lay.nli * lay.ncd) + both,
        "K4": 4 * lay.nl * n_occ + both + colours + 4 * n,
        "K1 f32": matvec("vp", "vp", 4),
        "K1": matvec("vp", "vp", 2),
    }
    for key, (A_sub, _) in operands["blocks"].items():
        i, o = key.split("->")
        out[f"K2 {key}"] = matvec(i, o, A_sub.element_size())
    return out


def moved_bytes_compact(lay, operands):
    """{call: bytes} that the compact kernels and their merge really move
    (``bound_bytes_of`` counts each input once instead): in 3D for K1, each
    K2 product and K4, and on P3/P2 triangles for K1, each K2 product and
    K4, and on a compact 2D P2/P1 layout (``W.compact_layout``) for K1, each
    K2 product and K4 ({} on other P2/P1 triangle layouts).  The compact
    block kernel (K1 at P2/P1, K2 but the streamed and narrow products): A as in the bound; x at every chunk's entries of the
    in-spaces; of ``compact_tables`` the occupied slots' entry indices and
    the entries' rows of the in-spaces, the (slot, dof) pairs with their
    offsets, the entries' places and the row offsets of the out-spaces; the
    compact scratch written by the chunks and read by the merge; y.  The
    streaming kernel (K1 and the products of ``W.streamed_products`` at
    P3/P2): A as in the bound; each chunk's work record (``stream_records``;
    on a tree without them the slot counts, the work list and each chunk's
    table offsets of the out-spaces); of the in-spaces, for K1 the occupied
    slots' packed positions and one x value a (slot, dof), for a block
    product each chunk's entries' rows and x there and the occupied slots'
    entry indices; of the out-spaces' tables the pairs and each entry's
    first pair (``tr_rel``) once, the scratch each way (in entry order),
    the row offsets and, a component at a time, the entry at each place
    (``at``); y.  The narrow kernels (K2 v->p and p->p on P3/P2 triangles,
    ``W.narrow_products``): A as in the bound; the slot counts; the
    occupied slots' packed positions of the in-space and one x value a
    (slot, dof); the slots' sums Y written and read once a (slot, dof)
    pair; the row list (``W.row_list``); y.  K4 at P2/P1 on tetrahedra
    (``scatter3_kernel`` + ``merge3_kernel``) reads no entry index and no
    x; K4 on the P3/P2 elements and on compact 2D P2/P1 layouts
    (``W.scatter_rows``: the row-ordered sum over R) reads R's value at each (slot, dof) pair of every component,
    both spaces' row lists and their offsets, and writes y."""
    products = W.streamed_products(lay) if hasattr(W, "streamed_products") else (
        (("vp", "vp"),) if W.streams_k1(lay) else ())
    narrow = getattr(W, "narrow_products", lambda _: ())(lay)
    compact = getattr(W, "compact_layout", lambda _: False)(lay)
    if lay.dim == 2 and not products and not compact:
        return {}
    tabs = W.compact_tables(lay)
    pos_v, _, cnt = W.pack_positions(lay)
    n_occ = int(cnt.sum())
    ncomp = {"v": lay.dim, "p": 1}
    k = {"v": lay.k_v, "p": lay.k_p}
    n = {"v": lay.n_vs, "p": lay.n_ps}

    def rows(spaces):
        return sum(ncomp[s] * k[s] for s in spaces)

    def out_space(s):  # the sums' tables and the scratch each way, y
        t = tabs[s]
        return (2 * 4 * ncomp[s] * t.E + 2 * t.tr.numel() + 4 * (2 * t.E + 1)
                + 4 * t.row_ptr.numel() + 4 * ncomp[s] * n[s])

    def matvec(ins, outs, elt):
        total = rows(ins) * rows(outs) * n_occ * elt + cnt.numel() * 4
        for s in ins:
            t = tabs[s]
            total += 4 * ncomp[s] * t.E + 2 * k[s] * n_occ + 4 * (t.E + t.off.numel())
        for s in outs:
            total += out_space(s) + (0 if s in ins else 4 * tabs[s].off.numel())
        return total

    n_work = len(W.stream_work(lay, cnt))

    def stream(ins, outs, elt):
        k1 = (ins, outs) == ("vp", "vp")
        total = rows(ins) * rows(outs) * n_occ * elt
        if hasattr(W, "stream_records"):  # a chunk's 48-byte record
            total += 48 * n_work
        else:  # the slot counts, the work list, the chunk's table offsets
            total += cnt.numel() * 4 + 4 * n_work + 16 * len(outs) * n_work
        for s in ins:
            if k1:  # a slot's packed positions and x values
                total += k[s] * n_occ * pos_v.element_size() + 4 * ncomp[s] * k[s] * n_occ
            else:  # the entries' rows and x there; the slots' entry indices
                total += 4 * (ncomp[s] + 1) * tabs[s].E + 2 * k[s] * n_occ
        for s in outs:
            t = tabs[s]
            total += (2 * t.tr.numel() + 2 * t.E + 2 * 4 * ncomp[s] * t.E
                      + 4 * t.row_ptr.numel() + 4 * ncomp[s] * t.E + 4 * ncomp[s] * n[s])
        return total

    def narrow_route(ins, outs, elt):
        (s,) = ins
        pairs = tabs[outs].tr.numel()
        return (rows(ins) * rows(outs) * n_occ * elt + cnt.numel() * 4
                + k[s] * n_occ * pos_v.element_size() + 4 * ncomp[s] * k[s] * n_occ
                + 2 * 4 * pairs + 4 * (n[outs] + 1) + 4 * pairs + 4 * n[outs])

    def moved(ins, outs, elt):
        if (ins, outs) in narrow:
            return narrow_route(ins, outs, elt)
        return (stream if (ins, outs) in products else matvec)(ins, outs, elt)

    out = {"K1 f32": moved("vp", "vp", 4), "K1": moved("vp", "vp", 2)}
    if getattr(W, "scatter_rows", lambda _: False)(lay):
        pairs = {s: tabs[s].tr.numel() for s in "vp"}
        out["K4"] = (4 * sum(ncomp[s] * pairs[s] for s in "vp") + 4 * sum(pairs.values())
                     + 4 * (n["v"] + 1 + n["p"] + 1) + 4 * (lay.n_u + lay.n_ps))
    elif lay.dim == 3:
        out["K4"] = (4 * lay.nl * n_occ + cnt.numel() * 4
                     + sum(out_space(s) + 4 * tabs[s].off.numel() for s in "vp"))
    for key, (A_sub, _) in operands["blocks"].items():
        i, o = key.split("->")
        if lay.dim == 3 or compact or (i, o) in products or (i, o) in narrow:
            out[f"K2 {key}"] = moved(i, o, A_sub.element_size())
    return out


def stream_spaces(lay, name, operands):
    """(dtype of A, in_spaces, out_spaces) of a timed K1 or K2 call that
    runs on the streaming kernel at this layout, else None (a tree whose
    streaming kernel serves K1 alone: K1's only)."""
    if name in ("K1", "K1 f32"):
        spaces = ("vp", "vp")
        dtype = torch.bfloat16 if name == "K1" else torch.float32
    elif name.startswith("K2 ") and hasattr(W, "streamed_products"):
        spaces = tuple(name.split()[1].split("->"))
        dtype = operands["blocks"][name.split()[1]][0].dtype
    else:
        return None
    if not getattr(W, "streams_k1", lambda _: False)(lay):
        return None
    if hasattr(W, "streamed_products"):
        return (dtype, *spaces) if spaces in W.streamed_products(lay) else None
    return (dtype,)


def compact_stats(lay) -> str:
    """One line on a layout's compact tables (host numpy): entries in all
    and at most a chunk, the most (slot, dof) pairs a chunk, pairs an entry,
    places a touched row."""
    parts = []
    for key, t in W.compact_tables(lay).items():
        pairs = np.diff(t.tr_off.cpu().numpy())
        places = np.diff(t.row_ptr.cpu().numpy())
        parts.append(f"{key}: {t.E} entries, at most {t.max_entries} and {t.max_pairs} (slot, "
                     f"dof) pairs a chunk; pairs an entry "
                     f"{pairs.mean():.2f} (at most {pairs.max()}); places a touched row "
                     f"{places[places > 0].mean():.2f} (at most {places.max()})")
    return "  compact tables " + "; ".join(parts)


def flat_dof_index(lay):
    """[nli * ncd] int64: the entry of the extended vector [x, 0] that
    X[l, s] copies (n_total for padded slots, rows past nl and window
    positions off the vector's ends).  For the library yardsticks only: K3
    (index_select), K4 (index_add_) and the CSR matrices of K1 and K2."""
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


CSR_PIECE_PAIRS = 100_000_000  # (slot, entry) pairs coalesced at a time


def csr_yardstick(lay, A, x, ins, outs):
    """(call, what it is): y = A x as one CSR product with the assembled
    matrix of a windowed operator A [n_in, n_out_pad, ncd] (K1: A_t; K2: a
    slice_block), built here from the cells' dof indices over the in- and
    out-spaces' segments, with float32 values (torch's CSR product refuses
    bf16 values with a float32 vector on the H100).  The cells' entries are
    coalesced a range of slots at a time, then all together: at the
    196,608-tet box at P3/P2, K1 has 70 x 70 entries a cell, whose int64
    indices alone would take 15 GB at once."""
    n = lay.n_u + lay.n_ps
    D = flat_dof_index(lay).view(lay.nli, lay.ncd)
    nv = lay.dim * lay.k_v
    sl = {"v": slice(0, nv), "p": slice(nv, lay.nl), "vp": slice(0, lay.nl)}
    rows, cols = D[sl[outs]], D[sl[ins]]
    vals = A[:, : rows.shape[0], :]  # vals[j, i, s]: out row dof_i(s), in col dof_j(s)
    start = {"v": 0, "p": lay.n_u, "vp": 0}
    size = {"v": lay.n_u, "p": lay.n_ps, "vp": n}
    shape = (size[outs], size[ins])
    step = max(1, CSR_PIECE_PAIRS // (vals.shape[0] * vals.shape[1]))
    parts = []
    for s0 in range(0, lay.ncd, step):
        v = vals[:, :, s0 : s0 + step]
        R = rows[None, :, s0 : s0 + step].expand(v.shape)
        C = cols[:, None, s0 : s0 + step].expand(v.shape)
        ok = (R < n) & (C < n)
        idx = torch.stack([R[ok] - start[outs], C[ok] - start[ins]])
        parts.append(torch.sparse_coo_tensor(idx, v[ok].float(), shape).coalesce())
    coo = torch.sparse_coo_tensor(torch.cat([p.indices() for p in parts], dim=1),
                                  torch.cat([p.values() for p in parts]), shape)
    del parts
    csr = coo.coalesce().to_sparse_csr()
    return (lambda: csr @ x), f"CSR @ x, float32 values ({csr._nnz()} stored entries)"


def library_call(lay, operands, key):
    """(call, what it is): one PyTorch call computing wrapper call ``key``'s
    function on ``wrapper_operands``' operands, for a yardstick only (never
    used by the package): K3 index_select (the pair: one index_select of
    both vectors stacked) and K4 index_add_ through the flat dof index, K1
    and each K2 product a CSR product with the assembled matrix, built
    here, outside any timing."""
    x, xo, R = operands["x"], operands["xo"], operands["R"]
    n = lay.n_u + lay.n_ps
    if key.startswith("K3") or key == "K4":
        dof_index = flat_dof_index(lay)
        x_ext = torch.cat([x, x.new_zeros(1)])
        if key == "K3":
            return (lambda: torch.index_select(x_ext, 0, dof_index).view(lay.nli, lay.ncd),
                    "torch.index_select of x through the flat dof index")
        if key == "K3 pair":
            pair_ext = torch.stack([x_ext, torch.cat([xo, xo.new_zeros(1)])])
            return (lambda: torch.index_select(pair_ext, 1, dof_index).view(2, lay.nli, lay.ncd),
                    "one torch.index_select of [x, x_old] stacked [2, n + 1], along dim 1 "
                    "through the flat dof index")
        return (lambda: x.new_zeros(n + 1).index_add_(0, dof_index, R.reshape(-1))[:n],
                "torch.index_add_ of R through the flat dof index")
    if key.startswith("K1"):
        return csr_yardstick(lay, operands["A_t" if key == "K1 f32" else "A_bf"], x, "vp", "vp")
    pair = key.split()[1]
    A_sub, xs = operands["blocks"][pair]
    return csr_yardstick(lay, A_sub, xs, *pair.split("->"))


def probe_call(M=256, iters=64, seed=5):
    """K5 on seeded bf16 operands at the probe's widths (chip_smoke phase
    8's timed case)."""
    from . import mxu_probe as mxu

    g = torch.Generator().manual_seed(seed)
    a = torch.randn((8 * M, mxu.K), generator=g).to(torch.bfloat16).cuda()
    b = torch.randn((mxu.K, mxu.N), generator=g).to(torch.bfloat16).cuda()
    return lambda: mxu.mxu_probe(a, b, M, iters)


def _host_outputs(out):
    """A wrapper call's output (a tensor or a tuple of them) as a tuple of
    host tensors."""
    out = out if isinstance(out, (tuple, list)) else (out,)
    return tuple(t.detach().cpu() for t in out)


def bit_equal(outputs: dict, ref: dict) -> dict:
    """{name: whether every tensor of outputs[name] equals ref[name]'s bit
    for bit (torch.equal: shape, type and values)}, over both dicts' names
    (a name missing from either is False)."""
    return {name: name in outputs and name in ref and len(outputs[name]) == len(ref[name])
            and all(torch.equal(a, b) for a, b in zip(outputs[name], ref[name]))
            for name in sorted(set(outputs) | set(ref))}


def forced_newton_step(solver, reps=3, seed=0):
    """Host-clock seconds of ``reps`` forced Newton steps at a seeded state,
    and the last step's (residual, FGMRES iterations, converged, the tangent
    solve's final ||r||)."""
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
    return times, out[1:5]


def main(argv=None):
    ap = argparse.ArgumentParser(prog="navier_stokes_tpu_torch.scripts.kernel_bench")
    ap.add_argument("--label", default="", help="a name for this tree in the record")
    ap.add_argument("--case", choices=("channel", "box"), default="channel",
                    help="the 102,400-cell channel (2D) or the 196,608-tet box (3D)")
    ap.add_argument("--degree", type=int, choices=(2, 3), default=2,
                    help="Taylor-Hood P2/P1 or P3/P2 (cubic velocity)")
    ap.add_argument("--kernels-only", action="store_true",
                    help="skip the Newton step and the solve")
    ap.add_argument("--only", default="", help="comma-separated wrapper names to time")
    ap.add_argument("--profile", action="store_true",
                    help="also print each call's device time by CUDA kernel (torch.profiler)")
    ap.add_argument("--bare", action="store_true",
                    help="time the kernels on seeded operands at the layout alone, without the "
                         "solver's set-up (implies --kernels-only)")
    ap.add_argument("--order", choices=("rcm", "sfc"), default="rcm",
                    help="the layout's cell order: the solver's (rcm) or the Morton curve of "
                         "renumber_blocked(order='sfc'), which the solver never builds "
                         "(implies --bare)")
    ap.add_argument("--no-library", action="store_true",
                    help="skip the one-call library yardstick (a CSR product at K1 and K2)")
    ap.add_argument("--save", default="",
                    help="write the timed wrappers' outputs to this file (torch.save)")
    ap.add_argument("--compare", default="",
                    help="hold the timed wrappers' outputs bit for bit against this file")
    args = ap.parse_args(argv)
    args.bare = args.bare or args.order == "sfc"
    if not torch.cuda.is_available():
        sys.exit("kernel_bench: no CUDA device visible to torch")
    import navier_stokes_tpu_torch as nt

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    dev = torch.device("cuda:0")
    if args.case == "box":
        mesh, cfg = box_mesh(), box_config(degree=args.degree)
    else:
        mesh = nt.refine_uniform(nt.rectangle(80, 40, 0, 7, 0, 4), 2)
        cfg = channel_config(degree=args.degree)
    t0 = time.perf_counter()
    if args.bare:
        lay, dofs = bare_layout(mesh, cfg, device=dev, order=args.order)
        n_total = dofs.n_total
        calls, operands = seeded_operands(lay)
    else:
        extra = dict(inlet=box_inlet) if args.case == "box" else {}
        solver = nt.NavierStokesSolver(mesh, cfg, log=nt.RunLog(verbose=False), device=dev,
                                       **extra)
        solver.setup()
        n_total = solver.dofs.n_total
    torch.cuda.synchronize()
    t_setup = time.perf_counter() - t0
    if not args.bare:
        calls, operands = wrapper_operands(solver)
        lay = solver._win_layout
    bounds = bound_bytes_of(lay, operands)
    moved = moved_bytes_compact(lay, operands) if hasattr(W, "streams_k1") else {}
    if args.case == "channel" and args.degree == 2:
        calls["K5"] = (probe_call(), None)
    print(f"  layout: P{args.degree}/P{args.degree - 1}, nb {lay.nb} Bmax {lay.Bmax} Bc "
          f"{lay.Bc} nchunks {lay.nchunks} RVv/RVp {lay.RVv}/{lay.RVp} hv/hp {lay.hv}/{lay.hp} "
          f"nl/nli {lay.nl}/{lay.nli} n_total {n_total}; order {args.order}; "
          f"{'layout' if args.bare else 'setup'} "
          f"{t_setup:.2f} s", flush=True)
    print(f"  card {smi}", flush=True)
    if moved:
        print(compact_stats(lay), flush=True)
    rec = {"label": args.label, "card": smi, "case": args.case, "degree": args.degree,
           "order": args.order, "cells": mesh.n_cells, "setup_s": t_setup, "kernels": {}}
    only = [k.strip() for k in args.only.split(",") if k.strip()]
    calls = {name: c for name, c in calls.items()
             if not only or any(name == k or name.startswith(k + " ") for k in only)}
    outputs = {name: _host_outputs(call()) for name, (call, _) in calls.items()}
    if args.save:
        torch.save(outputs, args.save)
    if args.compare:
        rec["bit_equal"] = bit_equal(outputs, torch.load(args.compare))
        print(f"  bit-equal to {args.compare}: {rec['bit_equal']}", flush=True)
    del outputs
    for name, (call, _) in calls.items():
        w1, c1, d1, d2, c2, w2 = (cuda_ms(call, REPS), cuda_ms_cold(call, REPS),
                                  cuda_ms_cold(call, REPS, clean=True),
                                  cuda_ms_cold(call, REPS, clean=True),
                                  cuda_ms_cold(call, REPS), cuda_ms(call, REPS))
        rec["kernels"][name] = r = dict(warm_ms=(w1 + w2) / 2, cold_ms=(c1 + c2) / 2,
                                        cold_clean_ms=(d1 + d2) / 2, host_us=host_us(call))
        line = (f"  {name:<8} warm {w1:.4f}/{w2:.4f} ms  cold {c1:.4f}/{c2:.4f} ms  "
                f"cold_clean {d1:.4f}/{d2:.4f} ms  host {r['host_us']:.1f} us")
        if name in bounds:  # the windowed wrappers: the bound and a library call
            r.update(bound_bytes=bounds[name], bound_ms=bounds[name] / PEAK_BYTES_PER_S * 1e3)
            r["share"] = r["bound_ms"] / r["cold_ms"]
            line += (f"  bound {r['bound_ms']:.4f} ms ({r['bound_bytes'] / 1e6:.1f} MB), share "
                     f"{r['share']:.3f}")
            if not args.no_library:
                lib, r["library"] = library_call(lay, operands, name)
                r["library_ms"] = cuda_ms_cold(lib, REPS)
                del lib
                line += f"  library {r['library_ms']:.4f} ms ({r['library']})"
        if name in moved:
            r["moved_bytes"] = moved[name]
            line += f"  moved {moved[name] / 1e6:.1f} MB"
        # an older tree names the products' kernels with kernel_design
        design = getattr(W, "matvec_design", None) or getattr(W, "kernel_design", None)
        if name.startswith(("K1", "K2 ")) and design:
            pair = ("vp", "vp") if name.startswith("K1") else name.split()[1].split("->")
            r["design"] = design(lay, *pair)
            line += f"  design {r['design']}"
        elif name == "K4" and hasattr(W, "scatter_design"):
            r["design"] = W.scatter_design(lay)
            line += f"  design {r['design']}"
        spaces = stream_spaces(lay, name, operands)
        if spaces:
            r["stream"] = W.stream_config(lay, *spaces)
            line += f"  stream {r['stream']}"
        print(line, flush=True)
        if args.profile:
            for mode, clean in (("warm", None), ("cold", False), ("cold_clean", True)):
                evict = None if clean is None else evictor(clean)
                r[f"device_us_{mode}"] = times = device_time_by_kernel(call, evict=evict)
                for kname, (us, n) in times.items():
                    print(f"           {mode:<10} {us:8.2f} us ({n:g} launches)  {kname}",
                          flush=True)
    del calls, operands
    rc = int(not all(rec.get("bit_equal", {}).values()))
    if args.kernels_only or args.bare:
        print(json.dumps(rec))
        return rc
    times, (res, iters, ok, kres) = forced_newton_step(solver, reps=5)
    rec["newton_step_ms"] = [t * 1e3 for t in times]
    rec["newton_step_median_ms"] = float(np.median(times) * 1e3)
    rec["newton_step"] = dict(residual=float(res), fgmres_iters=int(iters), converged=bool(ok),
                              final_rel_residual=float(kres) / float(res))
    print(f"  forced step: {rec['newton_step']}; median {rec['newton_step_median_ms']:.1f} ms",
          flush=True)
    if args.profile:
        # one forced step's device time: the windowed kernels' and the rest's
        by_kernel = device_time_by_kernel(lambda: forced_newton_step(solver, reps=1), reps=1)
        ours = {k: v for k, v in by_kernel.items() if WINDOWED_KERNEL.search(k)}
        rec["newton_step_device_us"] = dict(
            total=sum(us for us, _ in by_kernel.values()),
            windowed=sum(us for us, _ in ours.values()),
            by_kernel=dict(sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:20]))
        print(f"  forced step: median {rec['newton_step_median_ms']:.1f} ms; device "
              f"{rec['newton_step_device_us']['total'] / 1e3:.1f} ms, of it the windowed "
              f"kernels {rec['newton_step_device_us']['windowed'] / 1e3:.1f} ms", flush=True)
        for kname, (us, n) in rec["newton_step_device_us"]["by_kernel"].items():
            print(f"           {us:10.1f} us ({n:g} launches)  {kname}", flush=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    solver.solve()
    torch.cuda.synchronize()
    rec[f"solve_{solver._step}_steps_s"] = time.perf_counter() - t0
    print(json.dumps(rec))
    return rc


if __name__ == "__main__":
    sys.exit(main())
