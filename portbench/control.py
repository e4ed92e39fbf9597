"""The readings that the limits of a cell's comparison are set from.

    python3 portbench/control.py --workload <cell> --seeds 1,2,...,12 \
        --control-seeds 31,32,33 [--out FILE]

From the root of a checkout on a machine with a card. In one process,
at the cell's own sizes: for each seed of `--seeds`, the program's
reading (the tables made from the seed and placed in the program, each
query of the mix run through `Runtime().eval_str` twice, the second
result forced and compared with the plain reference, as a run compares
its sampled results); for each seed of `--control-seeds`, the control's
reading (the reference computed with its float lanes in float32, the
nearest precision below the configuration's float64, put in the
program's place and compared the same way). Prints one JSON line per
seed, then the lower reading (the largest the program gave) and the
upper one (the smallest the control gave) of each number compared.
A cell of N > 1 chips runs as a run does (`harness.py`): on the
program's mesh of N shards, its tables made, placed and checked shard
by shard where its generator makes shards.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import sys

sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

from portbench import compare as cmp  # noqa: E402
from portbench import harness  # noqa: E402


def program_reading(cell, seed, device, make_runtime=harness.runtime):
    """{query: reading} of the program on the seed's tables."""
    import torch
    tensors = harness.cell_tables(cell, seed, device)
    rt = make_runtime(harness.place_tables(
        tensors, harness.check_mesh(cell, device)))
    got = {}
    for q in cell.traffic["queries"]:
        harness.force(rt.eval_str(q["text"]))
        res = rt.eval_str(q["text"])
        got[q["name"]] = list(zip(harness.column_names(res),
                                  harness.force(res)))
    del rt
    gc.collect()
    if device == "cuda":
        for i in range(cell.chips):
            torch.cuda.synchronize(i)
        torch.cuda.empty_cache()
    return {q["name"]: cmp.compare(got.pop(q["name"]), _ref(q, tensors))
            for q in cell.traffic["queries"]}


def control_reading(cell, seed, device):
    """{query: reading} of the reference in float32 in the program's
    place."""
    import torch
    tensors = harness.cell_tables(cell, seed, device)
    out = {}
    for q in cell.traffic["queries"]:
        low = [(name, val) for name, val, _kind in
               _ref(q, tensors, torch.float32)]
        out[q["name"]] = cmp.compare(low, _ref(q, tensors))
    return out


def _ref(q, tensors, fdtype=None):
    import torch
    return harness.reference(q["reference"]["kind"]).run(
        tensors, q["reference"], fdtype or torch.float64)


def readings(cell, seeds, control_seeds, device, out=None):
    """Per seed the merged readings of the program and of the control;
    returns (lower, upper) by number compared."""
    lower, upper = {}, {}
    for side, fn, ss in (("program", program_reading, seeds),
                         ("control", control_reading, control_seeds)):
        for seed in ss:
            per_q = fn(cell, seed, device)
            r = cmp.merge(per_q.values())
            line = json.dumps({"workload": cell.name, "side": side,
                               "seed": seed, "reading": r,
                               "per_query": per_q})
            print(line, flush=True)
            if out:
                with open(out, "a") as f:
                    f.write(line + "\n")
            for k in cell.traffic["limits"]:
                if side == "program":
                    lower[k] = max(lower.get(k, r[k]), r[k])
                else:
                    upper[k] = min(upper.get(k, r[k]), r[k])
    return lower, upper


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", required=True)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        harness.log("control: no CUDA card")
        return 2
    cell = harness.load_cell(args.workload)
    if torch.cuda.device_count() < cell.chips:
        harness.log(f"control: {cell.name} needs {cell.chips} cards")
        return 2
    harness.build_kernels()
    from rayforce_tpu_torch.engine import device as dev
    harness.switch_mesh(cell.chips)
    dev.set_device("cuda")
    lower, upper = readings(
        cell, [int(s) for s in args.seeds.split(",")],
        [int(s) for s in args.control_seeds.split(",")], "cuda", args.out)
    print(json.dumps({"workload": cell.name, "lower": lower,
                      "upper": upper, "limits": cell.traffic["limits"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
