"""Where the device time goes: torch.profiler over the CUDA radix sort
and over warm grouped selects on a G1 table (the sort-agg queries, the
dense plan's and the wide engine's), on one CUDA card.

    python -m rayforce_tpu_torch.tools.sortprof [--rows N] [--out DIR]
        [--queries q1,q7,...] [--no-sort]

Prints, per profiled region, the device time by kernel name and the
region's wall time, device-busy time and idle share, and writes the
Chrome traces under --out. Numbers are only meaningful on the card.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
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
                    help="comma-separated names of tools.g1.QUERIES")
    ap.add_argument("--no-sort", action="store_true",
                    help="skip the radix sort's own profiles")
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
    dev.set_device("cuda")

    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    n = args.rows
    for n_words in () if args.no_sort else (1, 2, 3):
        words = [torch.randint(0, 1 << 20, (n,), generator=gen,
                               device="cuda", dtype=torch.int32)
                 for _ in range(n_words)]
        _profile(f"radix_sort_{n_words}w",
                 lambda: psort.sort_i32_cuda(words, 1), args.reps,
                 args.out)

    rt = Runtime()
    rt.interp.globals[symbols.intern("t")] = g1_table(n, "cuda")
    for name in args.queries.split(","):
        q = QUERIES[name][0]
        rt.eval_str(q)
        _profile(name, lambda: rt.eval_str(q), args.reps, args.out)
        p = sel.last_profile
        ms = p["exec_ms"] if "exec_ms" in p else \
            p["dispatch_ms"] + p["exec+fetch_ms"]
        print(f"   exec_ms (last run) {ms:.3f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
