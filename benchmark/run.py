"""Run one cell of the benchmark once, on the card, and print its result.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds ``navier_stokes_tpu_torch``.  The
last line of standard output is the result (``correct``, ``attempted``,
``failed``, ``metrics``, ``device``, with ``--trace 1`` ``breakdown``, and
``checks`` last: each number compared with its limit); the line before it
holds the step-by-step record.  The last lines of standard error repeat the
checks.  Without a CUDA card, or with fewer cards than the cell asks for,
it prints no result and exits 2; if a module of JAX or of the JAX package
is loaded once the window has closed, it names it and exits 3.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # the port builds its kernels into build/kernels/ beside its package,
    # a fixed place inside the checkout, so only a checkout's first run builds
    import torch

    from .harness import cell, forbidden_modules, load_json, run_cell

    spec = load_json(ROOT / "BENCHMARK.json")
    w, _, _ = cell(spec, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < w["chips"]:
        print(f"no result: the cell needs {w['chips']} CUDA card(s), torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    result, diag = run_cell(spec, args.workload, args.seed, args.seconds, bool(args.trace),
                            "cuda", T_START)
    bad = forbidden_modules()
    if bad:
        print(f"no result: modules loaded that a run must not load: {', '.join(bad)}",
              file=sys.stderr)
        return 3
    print(json.dumps(diag))
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
