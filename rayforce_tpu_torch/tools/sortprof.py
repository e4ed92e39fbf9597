"""Where the device time goes: torch.profiler over the CUDA radix sort,
over warm grouped selects on a G1 table (the sort-agg queries, the
dense plan's and the wide engine's) and over warm joins, table sorts and
window joins on bench.py's join tables (tools/jtables.py), on one CUDA
card.

    python -m rayforce_tpu_torch.tools.sortprof [--rows N] [--out DIR]
        [--queries q1,q7,ij,aj,wj,wj0,...] [--no-sort] [--no-queries]
        [--seg-scan] [--dense] [--mesh N]

With --mesh N every query runs on an N-shard mesh on the card
(RAYFORCE_MESH=N; its shards share the card): the grouped selects, and
the joins, table sorts and window joins (ij, lj, aj, xasc, xdesc, wj,
wj0 on the dist-bcast-probe, dist-asof, dist-sort and dist-wjoin
engines); the queries may include tools.g1.MESH_QUERIES (the id3
medians, one over a copy of the table with a 60%-heavy id3 code).

The sort is profiled at the main path's shapes: one key word alone (the
compaction sorts' key-only route), one key word with one and with two
payload words (sort-agg's main sort; keys below 10^5), and wide's four
key words with one payload word (q7). For each it prints the device
time of every launch of one sort in order (memset, histogram, plan,
each pass, gathers) and the sums by kernel name.

With --seg-scan the segmented scan (engine/csrc/seg_scan.cu) is
profiled too, at chip_smoke.py's [seg_scan_time] shapes: at --rows rows
over sorted i32 ids of 10^5 codes, i32 sum, f64 sum (one lane and an
(n, 1) lane), i64 sum, i64 max (and reversed, as q7 scans), i32 min;
ij's i64 min over 1.1 x --rows rows of i32 ids with runs of about 5.5
rows, and aj's i64 max over 3 x --rows rows of i64 ids with runs of about
1667 rows. For each it prints the route (groupby.seg_scan_route), the
device time of every launch of one scan (integer values: the memset of
the look-back words and the one block pass; f64: block pass, tail pass,
fix-up) and the plain version's device time.

With --dense the dense aggregate (engine/csrc/dense_agg.cu) is profiled
too, on the inputs the dense plan's queries give it (tools.g1.QUERIES
q1, q4, med, no_by and small_where on a --rows-row G1 table) and the
flagship step's (entry.py): for each the lanes, the device time of
every launch of one call (one dense_pass a library call) and the plain
version's device time.

Prints, per profiled region, the device time by kernel name (the top 14
and every seg_scan and dense_agg kernel) and the region's wall time,
device-busy time and idle share, and writes the Chrome traces under
--out; per query also the radix sort's, the scan's and the dense
aggregate's launches in one run. A join,
table sort or window join's run forces every lazy output column.
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
    for i, (name, ms, calls) in enumerate(rows):
        if i < 14 or "seg_scan::" in name or "dense_agg::" in name:
            print(f"   {ms / reps:9.4f} ms/run  {calls // reps:4d}x  "
                  f"{name[:90]}")
    if out:
        prof.export_chrome_trace(os.path.join(out, f"{tag}.json"))


def launch_split(fn, tries=3):
    """[(kernel or memset name, device us)] of one call of fn, in launch
    order, from the profiler's trace. A trace that comes back with no
    device event (the profiler drops one now and then) is taken again,
    up to `tries` times."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
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
        if rows:
            break
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


def seg_scan_shapes(torch, n):
    """The main path's scan shapes at n rows, on sorted i32 ids of 10^5
    codes (id3's runs): [(tag, ids, values, op, reverse)]. chip_smoke.py
    times the same."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    ids = torch.sort(_ints(torch, gen, n, 100_000, torch.int32)).values
    f = torch.rand(n, generator=gen, device="cuda",
                   dtype=torch.float64) * 100
    i64 = _ints(torch, gen, n, 2**40, torch.int64)
    return [("q2_i32_sum", ids, _ints(torch, gen, n, 5, torch.int32), "sum",
             False),
            ("q3_f64_sum", ids, f, "sum", False),
            ("q4_f64_sum_1lane", ids, f[:, None], "sum", False),
            ("q5_i64_sum", ids, i64, "sum", False),
            ("q7_i64_max_rev", ids, i64, "max", True),
            ("i64_max", ids, i64, "max", False),
            ("q6_i32_min", ids, _ints(torch, gen, n, 100, torch.int32),
             "min", False)]


def _ints(torch, gen, n, hi, dtype):
    return torch.randint(0, hi, (n,), generator=gen, device="cuda",
                         dtype=dtype)


def _join_scan_shapes(torch, n):
    """ij's and aj's scans with synthetic ids: ij's i64 min over 1.1 n
    rows of i32 ids in runs of about 5.5 rows, aj's i64 max over 3 n rows
    of i64 ids in runs of about 1667 rows (18 000 syms)."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)
    out = []
    for tag, rows, codes, id_dtype, op in (
            ("ij", n + n // 10, int((n + n // 10) / 5.5), torch.int32, "min"),
            ("aj", 3 * n, 18_000, torch.int64, "max")):
        ids = torch.sort(_ints(torch, gen, rows, codes, id_dtype)).values
        out.append((tag, ids, _ints(torch, gen, rows, 2**62, torch.int64),
                    op, False))
    return out


DENSE_QUERIES = ("q1", "q4", "med", "no_by", "small_where")


def dense_calls(torch, n):
    """{shape: the arguments of its dense_agg_cuda call}: the first call
    of each of DENSE_QUERIES on an n-row G1 table, and the flagship
    step's. chip_smoke.py times the same calls."""
    from rayforce_tpu_torch import Runtime
    from rayforce_tpu_torch.core import symbols
    from rayforce_tpu_torch.entry import entry
    from .g1 import QUERIES, g1_table
    from .multiproc_worker import count_dense
    rt = Runtime()
    rt.interp.globals[symbols.intern("t")] = g1_table(n, "cuda")
    out = {}
    for name in DENSE_QUERIES + ("entry",):
        calls = []
        with count_dense({}, calls):
            if name == "entry":
                step, args = entry()
                step(*args)
            else:
                rt.eval_str(QUERIES[name][0])
        out[name] = calls[0][1]
    torch.cuda.synchronize()
    return out


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
    ap.add_argument("--seg-scan", action="store_true",
                    help="profile the segmented scan at its main-path "
                    "shapes")
    ap.add_argument("--dense", action="store_true",
                    help="profile the dense aggregate at the dense "
                    "queries' inputs")
    ap.add_argument("--mesh", type=int, default=0,
                    help="run the grouped selects on an N-shard mesh")
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
    from rayforce_tpu_torch.engine import groupby as G
    from rayforce_tpu_torch.engine import join as ej
    from rayforce_tpu_torch.engine import select as sel
    from rayforce_tpu_torch.engine import sort as es
    from rayforce_tpu_torch.engine import wjoin as ew
    from .g1 import MESH_QUERIES, QUERIES, g1_table, skewed_id3
    from .jtables import JOIN_QUERIES, WJOIN_QUERIES, force_columns, \
        join_tables
    dev.set_device("cuda")

    n = args.rows
    for tag, words, nk in () if args.no_sort else \
            _sort_shapes(torch, psort, n):
        def run():
            return psort.sort_i32_cuda(words, nk)
        split = launch_split(run)
        print(f"== radix_sort {tag}: {len(split)} launches, "
              f"{sum(d for _n, d in split) / 1e3:.4f} ms device")
        for name, dur in split:
            print(f"   {dur:9.2f} us  {name[:90]}")
        _profile(f"radix_sort_{tag}", run, args.reps, args.out)
    for tag, ids, vals, op, rev in seg_scan_shapes(torch, n) + \
            _join_scan_shapes(torch, n) if args.seg_scan else ():
        def run():
            return G.seg_scan_cuda(ids, vals, op, rev)
        split = launch_split(run)
        plain = launch_split(lambda: G.seg_scan_plain(ids, vals, op, rev))
        print(f"== seg_scan {tag}: {int(vals.shape[0])} x "
              f"{int(vals[0].numel())} {str(vals.dtype)[6:]} {op}"
              f"{' reverse' if rev else ''}, route "
              f"{G.seg_scan_route(int(vals.shape[0]), vals.dtype)}: "
              f"{len(split)} launches, "
              f"{sum(d for _n, d in split) / 1e3:.4f} ms device; plain "
              f"{len(plain)} launches, "
              f"{sum(d for _n, d in plain) / 1e3:.4f} ms device")
        for name, dur in split:
            print(f"   {dur:9.2f} us  {name[:90]}")
    for tag, call in dense_calls(torch, n).items() if args.dense else ():
        split = launch_split(lambda: G.dense_agg_cuda(*call))
        plain = launch_split(lambda: G.dense_agg_plain(*call))
        lanes = {k: [str(x.dtype)[6:] for x in v] for k, v in
                 zip(("int", "fsum", "min", "max"), call[3:7]) if v}
        print(f"== dense_agg {tag}: {call[2]} rows x {call[1]} cells, "
              f"lanes {json.dumps(lanes, separators=(',', ':'))}: "
              f"{len(split)} launches, "
              f"{sum(d for _n, d in split) / 1e3:.4f} ms device; plain "
              f"{len(plain)} launches, "
              f"{sum(d for _n, d in plain) / 1e3:.4f} ms device")
        for name, dur in split:
            print(f"   {dur:9.2f} us  {name[:90]}")
    if args.no_queries:
        return 0

    rt = Runtime()
    names = args.queries.split(",")
    joins = {**{k: q for k, (q, _e) in JOIN_QUERIES.items()},
             **WJOIN_QUERIES}
    tables = join_tables(n, "cuda") if any(
        q in joins for q in names) else {"t": g1_table(n, "cuda")}
    if "med_id3_skew" in names:
        tables["t_skew"] = skewed_id3(tables["t"], "cuda")[0]
    for tname, tbl in tables.items():
        rt.interp.globals[symbols.intern(tname)] = tbl
    if args.mesh:
        os.environ["RAYFORCE_MESH"] = str(args.mesh)
        dev._mesh_state.update({"mesh": None, "checked": False})
        print(f"mesh: {dev.mesh().n} shards on {dev.mesh().devices[0]}")
    for name in names:
        if name in joins:
            q = joins[name]

            def run(q=q):
                return force_columns(rt.eval_str(q))
        else:
            q = MESH_QUERIES[name] if name in MESH_QUERIES else \
                QUERIES[name][0]

            def run(q=q):
                return rt.eval_str(q)
        run()
        torch.cuda.synchronize()
        before = dict(psort.LAUNCHES)
        run()
        launches = {k: psort.LAUNCHES[k] - before[k] for k in before}
        _profile(name, run, args.reps, args.out)
        print(f"   sort launches per run {launches['radix_sort']}, scan "
              f"launches per run {launches['seg_scan']}, dense launches "
              f"per run {launches['dense_agg']}")
        if name in joins:
            prof = es.last_profile if q.startswith("(x") else \
                ew.last_profile if q.startswith("(window") else \
                ej.last_profile
            print(f"   engine {prof.get('engine')}")
        else:
            p = sel.last_profile
            ms = p["exec_ms"] if "exec_ms" in p else \
                p["dispatch_ms"] + p["exec+fetch_ms"]
            eng = p.get("engine", "spmd" if p.get("spmd") else "dense")
            print(f"   exec_ms (last run) {ms:.3f}, engine {eng}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
