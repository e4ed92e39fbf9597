"""What each part of the dense aggregate kernel costs: builds
engine/csrc/dense_agg.cu (or the source --src names) as it is and with
one part changed, and times every build on one CUDA card.

    python -m rayforce_tpu_torch.tools.denseparts [--rows N] [--out DIR]
        [--src FILE] [--parts v3|v2] [--sass DIR]

--parts names a set of variants (PARTS), each a list of text
replacements in the source. `v3` (the default) holds the parts of the
kernel as it is, each with the same answers: `shared_cells` (the CTA's
words, updated by shared atomics, at every shape), `f64_member_loop`
(the f64 fold of 32 rows of one code by the group's
member loop) and `warp_groups` (integer groups of 12 rows or more
reduced by the warp's shuffles, registers held to five CTAs an SM).
`v2` holds the parts of the kernel's earlier version, whose call was a
memset, the pass, tree passes and a finish (give its source with
--src): each takes one part out, so its answers are wrong, and exists
only to time the rest. Every build is compiled with -Xptxas -v, and
each kernel's registers, spills and shared memory are printed as one
JSON line a build; --sass writes `cuobjdump -sass` of each build under
DIR.

The shapes are the inputs the dense queries and the entry step give the
kernel (tools/sortprof.py `dense_calls`) and three more at --rows rows
(`_synthetic`): `where_half` (half the rows on the trash code, as a
where filter leaves them; an i64 sum and an f64 min), `codes7` (7
codes; an i64 sum and an i64 max) and `codes512` (512 codes; an i64
sum, an f64 sum, an f64 min and an i64 max). For each shape it prints
one JSON line: each build's ms (CUDA events, median of 11, the same
wrapper, dense_agg_cuda: the host's enqueue shows in it where it takes
longer than the card's work), its device us (the sum of the launches
of one call in a profiler trace, tools/sortprof.py `launch_split`) and
launches, the host's us to enqueue one call (median of 11, nothing
synchronised), whether each equals the plain version bit for bit, and
the byte bound. Numbers are only meaningful on the card.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys
import statistics
import tempfile
import time

from .scanparts import HBM_BYTES_PER_S, _ms, _same

# {set: {variant: [(text of the source, its replacement)]}}
PARTS = {
    "v3": {
        # the CTA's words, updated by shared atomics, at every shape
        "shared_cells": [("  L->priv = private_cells(W, n_acc, n_f);",
                          "  L->priv = false;")],
        # the f64 fold of 32 rows of one code by the group's member loop
        "f64_member_loop": [("                if (grp[u] == FULL) {",
                             "                if (false) {")],
        # integer groups of DA_BIG rows or more reduced by the warp's
        # shuffles (one ballot a step to find them), registers held to
        # five CTAs an SM: faster where a trash code takes half the rows,
        # slower on uniform codes
        "warp_groups": [
            ('#pragma unroll\n'
             '            for (int u = 0; u < DA_UNROLL; ++u) {\n'
             '              if (grp[u] == FULL) {   // the same in every la'
             'ne\n'
             '                const u64 s = warp_reduce(x[u], add);\n'
             '                if (lane == 0 && key[u] >= 0)\n'
             '                  cell_put<PRIV>(c + key[u], s, add);\n'
             '              } else {\n'
             "                // the group's first lane combines its member"
             "s' words\n"
             '                sx[lane] = x[u];\n'
             '                __syncwarp();\n'
             '                if (key[u] >= 0 && lane == __ffs(grp[u]) - 1)'
             ' {\n'
             '                  u64 a = 0;\n'
             '                  for (unsigned m = grp[u]; m; m &= m - 1) {\n'
             ''
             '                    const u64 y = sx[__ffs(m) - 1];\n'
             '                    a = add ? a + y : (y > a ? y : a);\n'
             '                  }\n'
             '                  cell_put<PRIV>(c + key[u], a, add);\n'
             '                }\n'
             '                __syncwarp();\n'
             '              }\n'
             '            }\n',
             '#pragma unroll\n'
             '            for (int u = 0; u < DA_UNROLL; ++u) {\n'
             "              // a group of DA_BIG rows or more: the warp's s"
             'huffles over\n'
             "              // the group's words, the other rows' 0 (one pa"
             'ss when all\n'
             '              // 32 rows share a code)\n'
             '              for (unsigned b = big[u]; b; b &= b - 1) {\n'
             '                const int f = __ffs(b) - 1;\n'
             '                const u64 s = warp_reduce(\n'
             '                    key[u] == __shfl_sync(FULL, key[u], f) ? '
             'x[u] : 0, add);\n'
             '                if (lane == f) cell_put<PRIV>(c + key[u], s, '
             'add);\n'
             '              }\n'
             '              if (grp[u] != FULL) {\n'
             "                // a smaller group's first lane combines its "
             "members' words\n"
             '                sx[lane] = x[u];\n'
             '                __syncwarp();\n'
             '                if (key[u] >= 0 && lane == __ffs(grp[u]) - 1 '
             '&&\n'
             '                    __popc(grp[u]) < DA_BIG) {\n'
             '                  u64 a = 0;\n'
             '                  for (unsigned m = grp[u]; m; m &= m - 1) {\n'
             ''
             '                    const u64 y = sx[__ffs(m) - 1];\n'
             '                    a = add ? a + y : (y > a ? y : a);\n'
             '                  }\n'
             '                  cell_put<PRIV>(c + key[u], a, add);\n'
             '                }\n'
             '                __syncwarp();\n'
             '              }\n'
             '            }\n'),
            ("        // counts and row ids: the group's first lane counts "
             'it and\n'
             '        // offers its row to fidx, its last lane to lidx\n'
             '#pragma unroll\n'
             '        for (int u = 0; u < DA_UNROLL; ++u) {\n',
             "        // counts and row ids: the group's first lane counts "
             'it and\n'
             '        // offers its row to fidx, its last lane to lidx\n'
             '        unsigned big[DA_UNROLL], heavy = 0;\n'
             '#pragma unroll\n'
             '        for (int u = 0; u < DA_UNROLL; ++u)\n'
             '          heavy |= key[u] >= 0 && lane == __ffs(grp[u]) - 1 &'
             '&\n'
             '                   __popc(grp[u]) >= DA_BIG;\n'
             '        heavy = __any_sync(FULL, heavy);\n'
             '#pragma unroll\n'
             '        for (int u = 0; u < DA_UNROLL; ++u) {\n'
             '          big[u] = heavy ? __ballot_sync(FULL, key[u] >= 0 &&'
             '\n'
             '                                                   lane == __'
             'ffs(grp[u]) - 1 &&\n'
             '                                                   __popc(grp'
             '[u]) >= DA_BIG)\n'
             '                         : 0;\n'),
            ('#define DA_LEVELS 8 ',
             '#define DA_BIG 12\n'
             '#define DA_LEVELS 8 '),
            ('__launch_bounds__(32 * DA_WARPS)\n'
             'dense_pass',
             '__launch_bounds__(32 * DA_WARPS, 5)\n'
             'dense_pass'),
        ],
    },
    "v2": {
        # the whole row loop: launch, cell reset, tree and flush alone
        "no_rows": [("      for (int64_t base = chunk * DA_CHUNK; base < r1;",
                     "      for (int64_t base = r1; base < r1;")],
        # the value lanes
        "no_lanes": [("        for (int l = 0; l < p.n_lanes; ++l) {",
                      "        for (int l = 0; l < 0; ++l) {")],
        # the fidx / lidx offers
        "no_offers": [("              if (p.fidx)\n",
                       "              if (false)\n"),
                      ("if (p.fidx && lane == 31 - __clz(grp[u]))",
                       "if (false)")],
        # the stage combine of an integer lane: shuffles for every step
        "no_stage": [("if (grp[u] == FULL) {   // the same in every lane",
                      "if (true) {   // the same in every lane")],
        # __match_any_sync: every row its own group
        "no_match": [("grp[u] = __match_any_sync(FULL, key[u]);",
                      "grp[u] = 1u << lane;")],
    },
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


def _host_us(torch, fn, reps=11):
    """Median host us of fn, enqueue only, the card idle before each."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e6)
    torch.cuda.synchronize()
    return statistics.median(times)


def _build(text, path):
    """nvcc of `text` into the library `path` with ptxas's report."""
    from rayforce_tpu_torch.engine import cubuild
    cu = path + ".cu"
    with open(cu, "w") as f:
        f.write(text)
    return subprocess.Popen(
        [cubuild._nvcc(), "-O3", "-std=c++17", "-Xptxas", "-v",
         "-gencode=arch=compute_90a,code=sm_90a", "-shared", "-Xcompiler",
         "-fPIC", "-o", path, cu], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)


def ptxas_report(out):
    """{kernel: {registers, spill_stores, spill_loads, stack, smem}} of
    ptxas -v's report, for every kernel of the dense_agg namespace."""
    rep, fn = {}, None
    for line in out.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line) or \
            re.search(r"Function properties for (\w+)", line)
        if m:
            fn = m.group(1) if "dense_agg" in m.group(1) else None
            continue
        if fn is None:
            continue
        r = rep.setdefault(fn, {})
        for key, pat in (("stack", r"(\d+) bytes stack frame"),
                         ("spill_stores", r"(\d+) bytes spill stores"),
                         ("spill_loads", r"(\d+) bytes spill loads"),
                         ("registers", r"Used (\d+) registers"),
                         ("smem", r"(\d+) bytes smem")):
            m = re.search(pat, line)
            if m:
                r[key] = int(m.group(1))
    return rep


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=10_000_000)
    ap.add_argument("--out", default="")
    ap.add_argument("--src", default="")
    ap.add_argument("--parts", default="v3", choices=sorted(PARTS))
    ap.add_argument("--sass", default="")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("denseparts: no CUDA device", file=sys.stderr)
        return 2
    from rayforce_tpu_torch.engine import cubuild
    from rayforce_tpu_torch.engine import device as dev
    from rayforce_tpu_torch.engine import groupby as G
    from .sortprof import dense_calls, launch_split
    dev.set_device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    src = open(args.src or os.path.join(cubuild.CSRC, "dense_agg.cu")).read()
    libs = {}
    with tempfile.TemporaryDirectory() as tmp:
        jobs = {}
        for name, edits in {"kernel": [], **PARTS[args.parts]}.items():
            text = src
            for old, new in edits:
                if text.count(old) != 1:
                    raise SystemExit(f"denseparts: {name}: the source does "
                                     f"not hold {old!r} once")
                text = text.replace(old, new)
            path = os.path.join(tmp, f"lib{name}.so")
            jobs[name] = (path, _build(text, path))
        for name, (path, proc) in jobs.items():
            out = proc.communicate()[0]
            if proc.returncode:
                raise SystemExit(f"denseparts: {name} did not build:\n{out}")
            print(json.dumps({"build": name, "ptxas": ptxas_report(out)}),
                  flush=True)
            if args.sass:
                os.makedirs(args.sass, exist_ok=True)
                with open(os.path.join(args.sass, f"{name}.sass"), "w") as f:
                    subprocess.run([os.path.join(os.path.dirname(
                        cubuild._nvcc()), "cuobjdump"), "-sass", path],
                        stdout=f, stderr=subprocess.STDOUT, check=False)
            lib = ctypes.CDLL(path)
            for fn, (res, argt) in G.DENSE_ARGTYPES.items():
                getattr(lib, fn).restype = res
                getattr(lib, fn).argtypes = argt
            libs[name] = lib
        rows = []
        shapes = {**dense_calls(torch, args.rows),
                  **_synthetic(torch, args.rows)}
        saved = G._dense_lib()
        try:
            for tag, call in shapes.items():
                want = G.dense_agg_plain(*call)
                r = {"shape": tag, "rows": call[2], "cells": call[1]}
                for name, lib in libs.items():
                    G._dlib = lib
                    r[f"{name}_equal"] = _same_lanes(
                        torch, G.dense_agg_cuda(*call), want)
                    r[f"{name}_ms"] = _ms(torch,
                                          lambda: G.dense_agg_cuda(*call))
                    split = launch_split(lambda: G.dense_agg_cuda(*call))
                    r[f"{name}_device_us"] = sum(d for _n, d in split)
                    r[f"{name}_launch_us"] = [d for _n, d in split]
                    r[f"{name}_host_us"] = _host_us(
                        torch, lambda: G.dense_agg_cuda(*call))
                r["bound_ms"] = _bytes(call) / HBM_BYTES_PER_S * 1e3
                print(json.dumps(r), flush=True)
                rows.append(r)
        finally:
            G._dlib = saved
        if args.out:
            os.makedirs(args.out, exist_ok=True)
            with open(os.path.join(args.out, "denseparts.json"), "w") as f:
                json.dump(rows, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
