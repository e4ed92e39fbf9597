"""What the dense aggregate kernel's per-warp cells buy: builds
engine/csrc/dense_agg.cu as it is and with every call on the CTA's
shared cells, and times both on one CUDA card.

    python -m rayforce_tpu_torch.tools.denseparts [--rows N] [--out DIR]

The variant `shared_cells` takes the layout the kernel keeps for many
cells and lanes at every shape: one set of integer cells a CTA,
updated by one 64-bit shared atomic a group (a CAS loop on sm_90)
where the kernel as it is gives each warp its own cells and updates
them by a load and a store (`private_cells`); its answers are the
same. The shapes are the inputs the dense queries and the entry step
give the kernel (tools/sortprof.py `dense_calls`) and three more at
--rows rows: `where_half` (half the rows on the trash code, as a where
filter leaves them; an i64 sum and an f64 min), `codes7` (7 codes; an
i64 sum and an i64 max) and `codes512` (512 codes; an i64 sum, an f64
sum, an f64 min and an i64 max: shared cells in the kernel as it is).
For each shape it prints one JSON line: each build's ms (CUDA events,
median of 11, the same wrapper, dense_agg_cuda), whether each equals
the plain version bit for bit, and the byte bound. Numbers are only
meaningful on the card.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import tempfile

from .scanparts import HBM_BYTES_PER_S, _build, _ms, _same

# (variant, [(text of csrc/dense_agg.cu, its replacement)])
VARIANTS = {
    "shared_cells": [("  L.priv = private_cells(W, n_acc, n_f);",
                      "  L.priv = false;")],
}


def _synthetic(torch, n):
    """{shape: dense_agg_cuda arguments} of the three shapes that no
    main-path query gives the kernel."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)

    def ri(lo, hi, dtype=torch.int64):
        return torch.randint(lo, hi, (n,), generator=gen, device="cuda",
                             dtype=dtype)
    f = torch.rand(n, generator=gen, device="cuda", dtype=torch.float64)
    v = ri(1, 6)
    half = torch.where(torch.rand(n, generator=gen, device="cuda") < 0.5,
                       ri(0, 100, torch.int32), 100)
    return {
        "where_half": (half, 101, n, (v,), (), (f,), (), True, True),
        "codes7": (ri(0, 8, torch.int32), 8, n, (v,), (), (), (v,), True,
                   True),
        "codes512": (ri(0, 513, torch.int32), 513, n, (v,), (f,), (f,),
                     (v,), True, True),
    }


def _same_lanes(torch, got, want):
    return sorted(got) == sorted(want) and \
        all(_same(torch, got[k], want[k]) for k in want)


def _bytes(call):
    codes, W, n, ints, fsums, mins, maxs, counts, fidx = call
    lanes = list(ints) + list(fsums) + list(mins) + list(maxs)
    return (n if codes.stride(0) else 1) * codes.element_size() + \
        sum(n * x.element_size() for x in lanes) + \
        W * 8 * (len(lanes) + bool(counts) + 2 * bool(fidx))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=10_000_000)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("denseparts: no CUDA device", file=sys.stderr)
        return 2
    from rayforce_tpu_torch.engine import device as dev
    from rayforce_tpu_torch.engine import groupby as G
    from rayforce_tpu_torch.engine.cubuild import CSRC
    from .sortprof import dense_calls
    dev.set_device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    src = open(os.path.join(CSRC, "dense_agg.cu")).read()
    libs = {"kernel": G._dense_lib()}
    with tempfile.TemporaryDirectory() as tmp:
        jobs = {}
        for name, edits in VARIANTS.items():
            text = src
            for old, new in edits:
                if old not in text:
                    raise SystemExit(f"denseparts: {name}: the source no "
                                     f"longer has {old!r}")
                text = text.replace(old, new)
            path = os.path.join(tmp, f"lib{name}.so")
            jobs[name] = (path, _build(text, path))
        for name, (path, proc) in jobs.items():
            out = proc.communicate()[0]
            if proc.returncode:
                raise SystemExit(f"denseparts: {name} did not build:\n{out}")
            lib = ctypes.CDLL(path)
            for fn, (res, argt) in G.DENSE_ARGTYPES.items():
                getattr(lib, fn).restype = res
                getattr(lib, fn).argtypes = argt
            libs[name] = lib
        rows = []
        shapes = {**dense_calls(torch, args.rows),
                  **_synthetic(torch, args.rows)}
        for tag, call in shapes.items():
            want = G.dense_agg_plain(*call)
            r = {"shape": tag, "rows": call[2], "cells": call[1]}
            for name, lib in libs.items():
                G._dlib = lib
                r[f"{name}_equal"] = _same_lanes(
                    torch, G.dense_agg_cuda(*call), want)
                r[f"{name}_ms"] = _ms(torch,
                                      lambda: G.dense_agg_cuda(*call))
            G._dlib = libs["kernel"]
            r["bound_ms"] = _bytes(call) / HBM_BYTES_PER_S * 1e3
            print(json.dumps(r), flush=True)
            rows.append(r)
        if args.out:
            os.makedirs(args.out, exist_ok=True)
            with open(os.path.join(args.out, "denseparts.json"), "w") as f:
                json.dump(rows, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
