"""Where the device time goes: torch.profiler over the CUDA radix sort,
over warm grouped selects on a G1 table (the sort-agg queries, the
dense plan's and the wide engine's) and over warm joins, table sorts and
window joins on bench.py's join tables (tools/jtables.py), on one CUDA
card.

    python -m rayforce_tpu_torch.tools.sortprof [--rows N] [--out DIR]
        [--queries q1,q7,ij,aj,wj,wj0,...] [--no-sort] [--no-queries]

The sort is profiled at the main path's shapes: one key word alone (the
compaction sorts' key-only route), one key word with one and with two
payload words (sort-agg's main sort; keys below 10^5), and wide's four
key words with one payload word (q7). For each it prints the device
time of every launch of one sort in order (memset, histogram, plan,
each pass, gathers) and the sums by kernel name.

Prints, per profiled region, the device time by kernel name and the
region's wall time, device-busy time and idle share, and writes the
Chrome traces under --out; per query also the radix sort's launches in
one run. A join, table sort or window join's run forces every lazy
output column.
Numbers are only meaningful on the card.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time


def _device_kernels(prof):
    """[(name, device ms, calls)] of the device kernels, largest first."""
    rows = []
    for e in prof.key_averages():
        t = getattr(e, "device_time_total", None)
        if t is None:
            t = getattr(e, "cuda_time_total", 0)
        if e.key.startswith("cuda") or not t:
            continue
        if getattr(e, "device_type", None) is not None and \
                "CUDA" not in str(e.device_type):
            continue
        rows.append((e.key, t / 1e3, e.count))
    return sorted(rows, key=lambda r: -r[1])


def _report(tag, prof, wall_ms, reps, out):
    rows = _device_kernels(prof)
    busy = sum(r[1] for r in rows) / reps
    print(f"== {tag}: wall {wall_ms:.3f} ms/run, device busy "
          f"{busy:.3f} ms/run, idle share "
          f"{max(0.0, 1 - busy / wall_ms):.3f}")
    for name, ms, calls in rows[:14]:
        print(f"   {ms / reps:9.4f} ms/run  {calls // reps:4d}x  {name[:90]}")
    if out:
        prof.export_chrome_trace(os.path.join(out, f"{tag}.json"))


def _launch_split(fn):
    """[(kernel or memset name, device us)] of one call of fn, in launch
    order, from the profiler's trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    rows = sorted((e["ts"], e["name"], e["dur"]) for e in events
                  if e.get("cat") in ("kernel", "gpu_memset")
                  and "dur" in e)
    return [(name, dur) for _ts, name, dur in rows]


def _sort_shapes(torch, psort, n):
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)

    def rnd(lo, hi, dtype=torch.int32):
        return torch.randint(lo, hi, (n,), generator=gen, device="cuda",
                             dtype=dtype)
    key = rnd(0, 100_000)
    p1, p2 = rnd(-2**31, 2**31 - 1), rnd(-2**31, 2**31 - 1)
    w0 = (rnd(0, 100, torch.int64) << 38) | \
        (rnd(0, 100, torch.int64) << 31) | \
        (rnd(0, 100_000, torch.int64) << 14) | \
        (rnd(0, 100, torch.int64) << 7) | rnd(0, 100, torch.int64)
    w1 = (rnd(0, 100_000, torch.int64) << 24) | \
        torch.arange(n, device="cuda")
    wide = list(psort.split64(w0)) + list(psort.split64(w1)) + \
        [rnd(0, 100_000_000)]
    return [("key_only_1w", [key], 1), ("sortagg_2w", [key, p1], 1),
            ("sortagg_3w", [key, p1, p2], 1), ("wide_q7", wide, 4)]


def _profile(tag, fn, reps, out):
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / reps
    _report(tag, prof, wall, reps, out)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=10_000_000)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--out", default="")
    ap.add_argument("--queries", default="q2,q3,q5,q6",
                    help="comma-separated names of tools.g1.QUERIES, "
                    "tools.jtables.JOIN_QUERIES and WJOIN_QUERIES")
    ap.add_argument("--no-sort", action="store_true",
                    help="skip the radix sort's own profiles")
    ap.add_argument("--no-queries", action="store_true",
                    help="skip the grouped selects")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("sortprof: no CUDA device", file=sys.stderr)
        return 2
    if args.out:
        os.makedirs(args.out, exist_ok=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    from rayforce_tpu_torch import Runtime
    from rayforce_tpu_torch.core import symbols
    from rayforce_tpu_torch.engine import device as dev, psort
    from rayforce_tpu_torch.engine import select as sel
    from .g1 import QUERIES, g1_table
    from .jtables import JOIN_QUERIES, WJOIN_QUERIES, force_columns, \
        join_tables
    dev.set_device("cuda")

    n = args.rows
    for tag, words, nk in () if args.no_sort else \
            _sort_shapes(torch, psort, n):
        def run():
            return psort.sort_i32_cuda(words, nk)
        split = _launch_split(run)
        print(f"== radix_sort {tag}: {len(split)} launches, "
              f"{sum(d for _n, d in split) / 1e3:.4f} ms device")
        for name, dur in split:
            print(f"   {dur:9.2f} us  {name[:90]}")
        _profile(f"radix_sort_{tag}", run, args.reps, args.out)
    if args.no_queries:
        return 0

    rt = Runtime()
    names = args.queries.split(",")
    joins = {**{k: q for k, (q, _e) in JOIN_QUERIES.items()},
             **WJOIN_QUERIES}
    tables = join_tables(n, "cuda") if any(
        q in joins for q in names) else {"t": g1_table(n, "cuda")}
    for tname, tbl in tables.items():
        rt.interp.globals[symbols.intern(tname)] = tbl
    for name in names:
        if name in joins:
            q = joins[name]

            def run(q=q):
                return force_columns(rt.eval_str(q))
        else:
            q = QUERIES[name][0]

            def run(q=q):
                return rt.eval_str(q)
        run()
        torch.cuda.synchronize()
        before = psort.LAUNCHES["radix_sort"]
        run()
        launches = psort.LAUNCHES["radix_sort"] - before
        _profile(name, run, args.reps, args.out)
        print(f"   sort launches per run {launches}")
        if name not in joins:
            p = sel.last_profile
            ms = p["exec_ms"] if "exec_ms" in p else \
                p["dispatch_ms"] + p["exec+fetch_ms"]
            print(f"   exec_ms (last run) {ms:.3f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
