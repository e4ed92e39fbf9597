"""What a part of the segmented scan kernel costs: builds
engine/csrc/seg_scan.cu as it is and with one part taken out, and times
both on one CUDA card at chip_smoke.py's [seg_scan_time] shapes.

    python -m rayforce_tpu_torch.tools.scanparts [--rows N] [--out DIR]

The variant `no_wait` drops the look-back of the integer route: no
block waits for, or folds in, its predecessors' words, so its answers
are wrong wherever a run crosses a block's first row; it exists only to
time the rest of the launch (the f64 routes do not change). The shapes
add aj's ids with f64 values (3e7 rows, the global tail route). For each
shape it prints one JSON line: the full kernel's and each variant's ms
(CUDA events, median of 11; every variant called through the same
wrapper, seg_scan_cuda), whether each equals the plain version bit for
bit, and the byte bound. Numbers are only meaningful on the card.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys
import tempfile

# (variant, [(text of csrc/seg_scan.cu, its replacement)])
VARIANTS = {
    "no_wait": [("      if (!joint) {\n        const T pfx = look_back",
                 "      if (false) {\n        const T pfx = look_back")],
}


HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet


def _same(torch, got, want):
    """Equal type, shape and bits (f64 compared as its i64 bits)."""
    if got.dtype != want.dtype or got.shape != want.shape:
        return False
    if got.dtype == torch.float64:
        got, want = got.view(torch.int64), want.view(torch.int64)
    return bool(torch.equal(got, want))


def _ms(torch, fn, reps=11, warm=2):
    """Median device ms of fn over reps runs, by CUDA events."""
    for _ in range(warm):
        fn()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    torch.cuda.synchronize()
    for e0, e1 in events:
        e0.record()
        fn()
        e1.record()
    torch.cuda.synchronize()
    return statistics.median(e0.elapsed_time(e1) for e0, e1 in events)


def _build(src_text, path):
    from rayforce_tpu_torch.engine import cubuild
    cu = path + ".cu"
    with open(cu, "w") as f:
        f.write(src_text)
    return subprocess.Popen(
        [cubuild._nvcc(), "-O3", "-std=c++17",
         "-gencode=arch=compute_90a,code=sm_90a", "-shared", "-Xcompiler",
         "-fPIC", "-o", path, cu], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=10_000_000)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("scanparts: no CUDA device", file=sys.stderr)
        return 2
    from rayforce_tpu_torch.engine import device as dev
    from rayforce_tpu_torch.engine import groupby as G
    from rayforce_tpu_torch.engine.cubuild import CSRC
    from .sortprof import _join_scan_shapes, seg_scan_shapes
    dev.set_device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    src = open(os.path.join(CSRC, "seg_scan.cu")).read()
    libs = {"full": G._seg_lib()}
    with tempfile.TemporaryDirectory() as tmp:
        jobs = {}
        for name, edits in VARIANTS.items():
            text = src
            for old, new in edits:
                if old not in text:
                    raise SystemExit(f"scanparts: {name}: the source no "
                                     f"longer has {old!r}")
                text = text.replace(old, new)
            path = os.path.join(tmp, f"lib{name}.so")
            jobs[name] = (path, _build(text, path))
        for name, (path, proc) in jobs.items():
            out = proc.communicate()[0]
            if proc.returncode:
                raise SystemExit(f"scanparts: {name} did not build:\n{out}")
            lib = ctypes.CDLL(path)
            for fn, (res, argt) in G.ARGTYPES.items():
                getattr(lib, fn).restype = res
                getattr(lib, fn).argtypes = argt
            libs[name] = lib
        n = args.rows
        rows = []
        shapes = seg_scan_shapes(torch, n) + _join_scan_shapes(torch, n)
        # aj's ids with f64 values: the global tail route
        gen = torch.Generator(device="cuda")
        gen.manual_seed(3)
        aj_ids = shapes[-1][1]
        shapes.append(("aj_f64_sum", aj_ids, torch.rand(
            aj_ids.shape[0], generator=gen, device="cuda",
            dtype=torch.float64), "sum", False))
        for tag, ids, vals, op, rev in shapes:
            want = G.seg_scan_plain(ids, vals, op, rev)
            r = {"shape": tag, "rows": int(vals.shape[0]),
                 "route": G.seg_scan_route(int(vals.shape[0]), vals.dtype)}
            for name, lib in libs.items():
                G._lib = lib
                r[f"{name}_equal"] = _same(
                    torch, G.seg_scan_cuda(ids, vals, op, rev), want)
                r[f"{name}_ms"] = _ms(
                    torch, lambda: G.seg_scan_cuda(ids, vals, op, rev))
            G._lib = libs["full"]
            r["bound_ms"] = int(vals.shape[0]) * (
                ids.element_size() + 2 * vals.element_size() *
                int(vals[0].numel())) / HBM_BYTES_PER_S * 1e3
            print(json.dumps(r), flush=True)
            rows.append(r)
        if args.out:
            os.makedirs(args.out, exist_ok=True)
            with open(os.path.join(args.out, "scanparts.json"), "w") as f:
                json.dump(rows, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
