"""Probe the tensor cores' cost granularity in M on the GPU.

Port of ``scripts/mxu_probe.py``: time [M, K] @ [K, N] bf16 products with
f32 accumulation inside one kernel's loop for varying M, to calibrate the
windowed kernels' cost model (is the cost ~ ceil(M/16) mma tiles, or ~ M?).

    python -m navier_stokes_tpu_torch.scripts.mxu_probe [--iters N]

prints, per M, the kernel's ns per product, its rate, its ns per row of M,
and the plain torch version's ns per product (timed over ``PLAIN_ITERS``
products).

``mxu_probe`` is the wrapper: a CPU tensor goes to the plain version
(``mxu_probe_reference``), a CUDA tensor launches the kernel of
``csrc/mxu_probe.cu`` (built by nvcc at first use) or raises.  Its launches
are counted in ``mxu_probe.launches``.
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import sys

import torch

from ..ops.windowed import _PKG, _raise_on, build_library

__all__ = ["mxu_probe", "mxu_probe_reference", "build_kernel", "probe_table", "main",
           "M_VALUES"]

_SOURCE = _PKG / "csrc" / "mxu_probe.cu"
K, N = 128, 768  # the probe's depth and width
M_VALUES = (8, 16, 32, 64, 128, 144, 192, 256)
MAX_M = 256  # the kernel's largest M (16 mma row tiles)
PLAIN_ITERS = 2000  # products in the plain version's timed run


def build_kernel() -> dict:
    """Build ``csrc/mxu_probe.cu`` (``ops.windowed.build_library``) and load it."""
    info = build_library(_SOURCE, "ns_mxu_probe")
    _load(info["path"])
    return info


@functools.lru_cache(maxsize=None)
def _load(path: str):
    lib = ctypes.CDLL(path)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.ns_mxu_probe.argtypes = [p, p, p, i, i, i, p]
    lib.ns_mxu_probe.restype = i
    return lib


@functools.lru_cache(maxsize=1)
def _lib():
    return _load(build_kernel()["path"])


def mxu_probe_reference(a: torch.Tensor, b: torch.Tensor, M: int, iters: int) -> torch.Tensor:
    """The same loop in torch: acc += a_panel(i % 8) @ b in float32."""
    acc = torch.zeros((M, b.shape[1]), dtype=torch.float32, device=a.device)
    bf = b.float()
    for i in range(iters):
        p = i % 8
        acc += a[p * M : (p + 1) * M].float() @ bf
    return acc


def mxu_probe(a: torch.Tensor, b: torch.Tensor, M: int, iters: int) -> torch.Tensor:
    """acc[M, N] = sum_{i < iters} a[(i%8)*M : (i%8+1)*M] @ b, f32 accumulation.

    a: bfloat16 [8M, 128]; b: bfloat16 [128, N] with N a multiple of 64;
    1 <= M <= 256."""
    if a.device.type == "cpu":
        return mxu_probe_reference(a, b, M, iters)
    if a.device.type != "cuda":
        raise ValueError(f"no mxu_probe kernel for device {a.device}")
    if a.dtype != torch.bfloat16 or b.dtype != torch.bfloat16:
        raise TypeError(f"operands must be bfloat16; got {a.dtype}, {b.dtype}")
    if not (1 <= M <= MAX_M) or iters < 1:
        raise ValueError(f"need 1 <= M <= {MAX_M} and iters >= 1; got M={M}, iters={iters}")
    n = b.shape[1]
    if tuple(a.shape) != (8 * M, K) or b.shape[0] != K or n % 64 or n == 0:
        raise ValueError(
            f"need a [{8 * M}, {K}] and b [{K}, N], N a multiple of 64; "
            f"got {tuple(a.shape)}, {tuple(b.shape)}"
        )
    for t in (a, b):
        if t.device != a.device or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("operands must be contiguous, 16-byte aligned, on one device")
    out = torch.empty((M, n), dtype=torch.float32, device=a.device)
    err = _lib().ns_mxu_probe(a.data_ptr(), b.data_ptr(), out.data_ptr(), M, n, iters,
                              torch.cuda.current_stream(a.device).cuda_stream)
    _raise_on(err, "ns_mxu_probe")
    mxu_probe.launches += 1
    return out


mxu_probe.launches = 0


def ns_per_product(fn, iters: int, reps: int = 3) -> float:
    """Warm CUDA-event time of ``fn()`` (one probe of ``iters`` products),
    in ns per product."""
    fn()
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) * 1e6 / reps / iters


def probe_table(iters: int, device="cuda") -> list[dict]:
    """Time the kernel (``iters`` products a launch) and the plain version
    (``PLAIN_ITERS`` products a run) at every M of ``M_VALUES``, on all-ones
    operands as the original does, and print one line per M.  M is padded to
    whole 16-row mma tiles in the kernel; ``mma_rows`` says to how many."""
    dev = torch.device(device)
    rows = []
    for M in M_VALUES:
        a = torch.ones((8 * M, K), dtype=torch.bfloat16, device=dev)
        b = torch.ones((K, N), dtype=torch.bfloat16, device=dev)
        ns = ns_per_product(lambda: mxu_probe(a, b, M, iters), iters)
        plain = ns_per_product(lambda: mxu_probe_reference(a, b, M, PLAIN_ITERS), PLAIN_ITERS,
                               reps=1)
        macs = M * K * N
        row = dict(M=M, mma_rows=16 * -(-M // 16), ns=ns, tmacs=macs / ns / 1e3,
                   ns_per_row=ns / M, plain_ns=plain)
        rows.append(row)
        print(
            f"M={M:4d} (mma rows {row['mma_rows']:3d}): {ns:8.1f} ns/matmul  "
            f"{row['tmacs']:7.2f} TMAC/s ({2 * row['tmacs']:7.2f} TFLOP/s)  "
            f"ns/Mrow={row['ns_per_row']:6.2f}  plain {plain:8.1f} ns/matmul", flush=True,
        )
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(prog="navier_stokes_tpu_torch.scripts.mxu_probe")
    ap.add_argument("--iters", type=int, default=200000, help="products per kernel launch")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("mxu_probe: no CUDA device visible to torch")
    print(f"K={K} N={N} iters={args.iters} dtype=bfloat16 "
          f"device={torch.cuda.get_device_name(0)}")
    probe_table(args.iters)
    return 0


if __name__ == "__main__":
    sys.exit(main())
