"""Sets of runs of benchmark cells, and the spread of each metric.

    python3 portbench/sets.py --workload <cell>[,<cell>...] --seeds 11,12,13 \
        [--sets 2] [--seconds S] [--trace-seeds 21,22] [--out FILE]

From the root of a checkout on a machine with the cards. For each cell:
one run of 2 s that builds the kernels (its set-up is printed apart),
then `--sets` sets of one run per seed, the same seeds in each set,
then one traced run per trace seed; every run a process of its own
(`portbench/run.py`), one at a time. Appends one JSON line per run to
`--out` and prints per set and metric the median and the spread (the
distance between the quartiles over the median, statistics.quantiles
n=4), and the bound five times the widest spread gives (at least 1%);
for `setup_s`, whose bound is fixed at 0.25 and judged by its median,
how far the second set's median lies from the first's.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

from portbench.stats import spread  # noqa: E402


def one(workload, seed, seconds, trace, out):
    t = time.perf_counter()
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        workload, "--seed", str(seed), "--seconds",
                        str(seconds), "--trace", str(trace)],
                       capture_output=True, text=True)
    lines = p.stdout.strip().splitlines()
    rec = {"workload": workload, "seed": seed, "seconds": seconds,
           "trace": trace, "rc": p.returncode,
           "wall_s": time.perf_counter() - t,
           "result": json.loads(lines[-1]) if p.returncode == 0 and lines
           else None, "stderr_tail": p.stderr[-1500:]}
    with open(out, "a") as f:
        f.write(json.dumps(rec) + "\n")
    r = rec["result"]
    short = {k: v["value"] for k, v in r["metrics"].items()} if r else None
    print(f"{workload} seed {seed} trace {trace}: rc {p.returncode}, wall "
          f"{rec['wall_s']:.1f} s, correct {r and r['correct']}, {short}",
          flush=True)
    if p.returncode != 0:
        print(p.stderr[-3000:], flush=True)
    return r


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--sets", type=int, default=2)
    ap.add_argument("--seconds", type=float, default=10)
    ap.add_argument("--trace-seeds", default="")
    ap.add_argument("--out", default="chiprun_out/sets.jsonl")
    args = ap.parse_args(argv)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    seeds = [int(s) for s in args.seeds.split(",")]
    for w in args.workload.split(","):
        first = one(w, 7 + seeds[0], 2, 0, args.out)
        if first:
            print(f"{w}: first run set-up {first['metrics']['setup_s']}")
        sets = [[one(w, s, args.seconds, 0, args.out) for s in seeds]
                for _ in range(args.sets)]
        for s in [int(x) for x in args.trace_seeds.split(",") if x]:
            one(w, s, args.seconds, 1, args.out)
        widest, medians = {}, {}
        for i, runs in enumerate(sets):
            ok = [r for r in runs if r]
            for m in sorted(ok[0]["metrics"]) if ok else ():
                vals = [r["metrics"][m]["value"] for r in ok]
                sp = spread(vals) if len(vals) > 1 else float("nan")
                widest[m] = max(widest.get(m, 0.0), sp)
                medians.setdefault(m, []).append(statistics.median(vals))
                print(f"{w} set {i + 1} {m}: median "
                      f"{statistics.median(vals)!r} spread {sp!r} "
                      f"values {vals}")
        for m, sp in widest.items():
            if m == "setup_s":
                meds = medians[m]
                print(f"{w} {m}: widest spread {sp!r}; last set's median "
                      f"over the first's {meds[-1] / meds[0]!r}")
            else:
                print(f"{w} {m}: widest spread {sp!r}, bound "
                      f"{max(0.01, 5 * sp)!r}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
