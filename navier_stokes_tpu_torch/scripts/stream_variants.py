"""Variants of csrc/windowed.cu timed against one another in one process.

Each variant is a copy of the source with some ``constexpr int`` constants
set (``{"kStageRowBytes": 104}``) and some lines replaced (``{"subs":
[[old, new], ...]}``, each ``old`` must occur in the source).  Every variant
is built in parallel (one nvcc a variant) into build/kernels/, then, at the
seeded bare layout of each case (``kernel_bench.bare_layout``,
``seeded_operands``), each wrapper call is timed with every variant in
turns (v1 .. vn, then vn .. v1): its cold ms (``kernel_bench.cuda_ms_cold``)
and its device time by CUDA kernel after a 256 MB write
(``kernel_bench.device_time_by_kernel``), with the streaming kernel's launch
where it runs one.  A variant's outputs must equal the first variant's bit
for bit unless it says ``"noeq": true`` (an ablation that skips work).

    python -m navier_stokes_tpu_torch.scripts.stream_variants \\
        --variants '{"d": {}, "wide": {"kStageRowBytes": 104}}' \\
        --case channel,box --only "K2 v->p,K2 p->p"

``--variants`` also takes the path of a JSON file.  On the card only.
"""

import argparse
import json
import re
import sys
import threading
from pathlib import Path

import torch

from ..ops import windowed as W
from . import kernel_bench as kb


def variant_source(src: str, spec: dict) -> str:
    """The source with a variant's constants set and lines replaced."""
    for key, value in spec.items():
        if key == "subs":
            for old, new in value:
                if old not in src:
                    raise ValueError(f"not in the source: {old!r}")
                src = src.replace(old, new)
        elif key != "noeq":
            src, n = re.subn(rf"(constexpr int {key} = )-?\d+;", rf"\g<1>{value};", src)
            if n != 1:
                raise ValueError(f"no single constexpr int {key} in the source")
    return src


def build_variants(variants: dict) -> dict:
    """{name: library path}, every variant built at once."""
    src = W._SOURCE.read_text()
    out_dir = W._BUILD_DIR.parent / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    libs, errors = {}, []

    def build(name, spec):
        try:
            path = out_dir / f"{name}.cu"
            path.write_text(variant_source(src, spec))
            libs[name] = W.build_library(path, f"ns_windowed_{name}")["path"]
        except Exception as err:  # reported after every build has ended
            errors.append(f"{name}: {err}")

    threads = [threading.Thread(target=build, args=item) for item in variants.items()]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise RuntimeError("variant builds failed:\n" + "\n".join(errors))
    return libs


def case_layout(case: str, degree: int):
    import navier_stokes_tpu_torch as nt

    if case == "box":
        mesh, cfg = kb.box_mesh(), kb.box_config(degree=degree)
    else:
        mesh = nt.refine_uniform(nt.rectangle(80, 40, 0, 7, 0, 4), 2)
        cfg = kb.channel_config(degree=degree)
    return kb.bare_layout(mesh, cfg, device="cuda:0")[0]


def main(argv=None):
    ap = argparse.ArgumentParser(prog="navier_stokes_tpu_torch.scripts.stream_variants")
    ap.add_argument("--variants", required=True, help="JSON {name: spec}, or a JSON file's path")
    ap.add_argument("--case", default="channel", help="channel, box or both (comma-separated)")
    ap.add_argument("--degree", type=int, choices=(2, 3), default=3)
    ap.add_argument("--only", default="K1,K2 v->v,K2 v->p,K2 p->p",
                    help="comma-separated wrapper names to time")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("stream_variants: no CUDA device visible to torch")
    text = args.variants
    variants = json.loads(Path(text).read_text() if text.endswith(".json") else text)
    libs = build_variants(variants)
    names = list(variants)
    only = [k.strip() for k in args.only.split(",") if k.strip()]
    for case in args.case.split(","):
        lay = case_layout(case, args.degree)
        calls, operands = kb.seeded_operands(lay)
        calls = {key: call for key, (call, _) in calls.items() if key in only}
        bounds = kb.bound_bytes_of(lay, operands)
        ref, res = {}, {}
        for name in names + names[::-1]:
            W._lib = lambda path=libs[name]: W._load(path)
            for key, call in calls.items():
                out = call().clone()
                torch.cuda.synchronize()
                if not variants[name].get("noeq"):
                    if key in ref and not torch.equal(out, ref[key]):
                        raise RuntimeError(f"{name}: {key} differs from {names[0]}'s bits")
                    ref.setdefault(key, out)
                cold = kb.cuda_ms_cold(call, kb.REPS)
                dev = kb.device_time_by_kernel(call, evict=kb.evictor(False))
                total = sum(us for us, _ in dev.values())
                spaces = kb.stream_spaces(lay, key, operands)
                cfg = W.stream_config(lay, *spaces) if spaces else {}
                res.setdefault((key, name), []).append((cold, total))
                print(f"  {case} {key:8} {name:10} cold {cold:.4f} ms  device {total:7.2f} us "
                      f"({', '.join(f'{us:.2f}' for us, _ in dev.values())})  share "
                      f"{bounds[key] / kb.PEAK_BYTES_PER_S * 1e3 / cold:.3f}  {cfg}", flush=True)
        print(f"-- {case}: mean cold ms, mean device us a call")
        for key in calls:
            for name in names:
                v = res[(key, name)]
                print(f"  {key:8} {name:10} {sum(a for a, _ in v) / len(v):.4f}  "
                      f"{sum(b for _, b in v) / len(v):7.2f}", flush=True)
        del calls, operands, lay
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
