"""Run one cell of the benchmark of rayforce_tpu_torch once, on CUDA.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout. The cell is an entry of BENCHMARK.json's
`workloads`; see `portbench/harness.py` for what a run does. Prints
progress and, last, each number compared beside its limit on standard
error, and one JSON object as the last line of standard output:
`correct`, `attempted`, `failed`, `metrics` (the cell's end-to-end
metrics, or with --trace 1 its per-layer ones), `device`, with
--trace 1 `breakdown`, and last `checks`. Exits with 2, printing no
result, where CUDA is absent or has fewer cards than the cell asks
for, and with another code than 0 where JAX or the JAX package was
loaded or anything else fails.

A cell of `chips` N > 1 runs on cards 0 to N - 1 as the program's mesh
of one row shard a card (`RAYFORCE_MESH=N`; a run whose mesh is not
that ends with no result): its tables made and placed shard by shard
where its generator defines `make_shards`, every card synchronised
after each query, `device.busy_s` the mean of the cards' own busy time
with `busy_s_per_card` beside it, and `memory_peak_bytes` the fullest
card's, with `memory_peak_bytes_per_card` beside it.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the checkout's root in place of this script's directory, so that
# portbench is a package and none of its modules shadows another
sys.path[0] = ROOT


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def power_limit():
    """The card's name and power limit, as nvidia-smi reads them."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi: {e}"


def main(argv=None):
    args = parse(argv)
    from portbench import harness
    cell = harness.load_cell(args.workload)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        harness.log(f"{args.workload} needs {cell.chips} CUDA card(s); "
                    f"found {torch.cuda.device_count()}")
        return 2
    harness.log(power_limit())
    out = harness.run(cell, args.seed, args.seconds, bool(args.trace),
                      "cuda", T0)
    for name, c in out["checks"].items():
        harness.log(f"check {name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
