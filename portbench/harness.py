"""One run of one benchmark cell, driven by data.

A cell of `BENCHMARK.json` names a configuration (its file holds the
sizes and the generator, `data/<generator>.py`) and a traffic mix
(`traffic/<mix>.json`: the queries, their Rayfall text, weights, order,
each query's reference spec and the limits of the comparison). Each
metric is a reader of its own, `metrics/<name>.py`, and each kind of
query a reference of its own, `reference/<kind>.py`. Adding a cell, a
mix, a configuration or a metric adds files and entries; nothing here
changes.

A run: set-up (the program's kernels built or loaded, the tables made
on the device from the seed and placed in the program, each query of
the mix run twice); a closed loop of one client with no think time for
`seconds`, each query through the program's served entry
`Runtime().eval_str` with every lazy column of its result forced and
the device synchronised; with `trace`, the loop runs under
torch.profiler with the kernels' entry points recorded. Then, with the
program's state freed, one result of each query, sampled from the
window by the seed, is held against the plain reference.
"""
from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import os
import random
import sys
import time
from dataclasses import dataclass, field

from . import compare as cmp

PB = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(PB)
# top-level module names that must not be loaded: JAX and the JAX
# package the program is a port of
FORBIDDEN = ("jax", "jaxlib", "flax", "rayforce_tpu")


def log(*a):
    print("[portbench]", *a, file=sys.stderr, flush=True)


def _json(path):
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list
    per_layer: list


def load_cell(workload, bench_path=os.path.join(ROOT, "BENCHMARK.json")):
    """The cell `workload` of a BENCHMARK.json, with its configuration,
    its traffic mix and the metrics it reports."""
    bench = _json(bench_path)
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in {bench_path}")
    w = cells[workload]
    return cell(bench, os.path.dirname(os.path.abspath(bench_path)),
                workload, w["config"], w["traffic"], w["chips"])


def cell(bench, root, name, config, traffic, chips=1):
    """A cell of configuration `config` (an entry of `bench`'s configs,
    its file under `root`) and traffic mix `traffic`, reporting the
    metrics of `bench` that apply to `name`."""
    def applies(m):
        return name in m.get("workloads", [name])
    e2e = [m for m in bench["end_to_end"] if applies(m)]
    moved = {m["name"] for m in e2e}
    per = [m for m in bench["per_layer"] if applies(m) and
           m["moves"] in moved]
    cfg = {c["name"]: c for c in bench["configs"]}[config]
    return Cell(name, int(chips), _json(os.path.join(root, cfg["file"])),
                _json(os.path.join(PB, "traffic", traffic + ".json")),
                e2e, per)


def _module_at(kind, name):
    """portbench/<kind>/<name>.py as a module (a metric's name may hold
    dots)."""
    path = os.path.join(PB, kind, name + ".py")
    spec = importlib.util.spec_from_file_location(
        f"portbench_{kind}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric(name):
    return _module_at("metrics", name)


def reference(kind):
    return importlib.import_module(f"portbench.reference.{kind}")


def make_tables(config, seed, device):
    """{table: {column: tensor}} made by the configuration's generator."""
    gen = importlib.import_module(f"portbench.data.{config['generator']}")
    return gen.make(config, seed, device)


# -- the program --------------------------------------------------------------

def build_kernels():
    """Build (first run in a checkout) or find the program's hand-written
    kernels, all at once, in its own build cache inside the checkout."""
    from rayforce_tpu_torch.engine import cubuild
    names = sorted(f[:-3] for f in os.listdir(cubuild.CSRC)
                   if f.endswith(".cu"))
    cubuild.build(names)
    return names


def place_tables(tensors):
    """The tensors as the program's tables, placed on its device
    (`engine/device.py` put_table), as `tools/jtables.py` `_table` does."""
    import torch
    from rayforce_tpu_torch.core import types as T
    from rayforce_tpu_torch.core.obj import DevPending, Obj, table, vec_sym
    from rayforce_tpu_torch.engine import device as dev
    out = {}
    for tname, cols in tensors.items():
        objs = []
        for a in cols.values():
            c = Obj(T.F64 if a.dtype == torch.float64 else T.I64,
                    DevPending(a))
            c.meta = {"dev": a}
            objs.append(c)
        out[tname] = table(vec_sym(list(cols)), objs)
        dev.put_table(out[tname])
    return out


def runtime(tables):
    from rayforce_tpu_torch import Runtime
    from rayforce_tpu_torch.core import symbols
    rt = Runtime()
    for tname, tbl in tables.items():
        rt.interp.globals[symbols.intern(tname)] = tbl
    return rt


def force(res):
    """Every column of a result as arrays, each lazy column forced (a
    timing must include the gathers): a typed column gives its tensor,
    a right-only LIST column its (values, match mask). A copy of
    `tools/jtables.py` `force_columns`, except that a column the program
    already materialised (a host array) is taken as it is."""
    return [p.arr if (p := c.pending()) is not None else c.v
            for c in res.v[1]]


def column_names(res):
    from rayforce_tpu_torch.core import symbols
    return [symbols.name_of(int(s)) for s in res.v[0].v]


# -- the run ------------------------------------------------------------------

@dataclass
class Readings:
    """What the window gave the metric readers."""
    setup_s: float
    window_s: float = 0.0
    latencies_s: list = field(default_factory=list)
    ends_s: list = field(default_factory=list)
    queries: list = field(default_factory=list)
    launches: dict = field(default_factory=dict)
    calls: dict = field(default_factory=dict)
    spans: dict = field(default_factory=dict)
    trace: object = None


class Sampler:
    """One result of each query of the window, drawn from the seed
    (reservoir sampling): the k-th completion replaces the kept one with
    probability 1/k."""

    def __init__(self, seed):
        self.rng = random.Random(f"sample:{seed}")
        self.seen, self.kept = {}, {}

    def offer(self, name, res, cols):
        k = self.seen[name] = self.seen.get(name, 0) + 1
        if self.rng.randrange(k) == 0:
            self.kept[name] = list(zip(column_names(res), cols))


def query_order(traffic, seed):
    """The queries of the mix, round after round: each query `weight`
    times a round, in an order shuffled from the seed ("shuffle") or as
    listed ("fixed")."""
    rng = random.Random(f"order:{seed}")
    base = [q for q in traffic["queries"] for _ in range(q.get("weight", 1))]
    while True:
        r = list(base)
        if traffic.get("order", "shuffle") == "shuffle":
            rng.shuffle(r)
        yield from r


def _record_calls(mods, calls):
    """Wrap each metric's ENTRY so that its calls' bytes are recorded
    under the metric's name; returns the undo list."""
    undo = []
    for name, mod in mods.items():
        entry = getattr(mod, "ENTRY", None)
        if entry is None:
            continue
        owner = importlib.import_module(entry[0])
        real = getattr(owner, entry[1])
        rec = calls.setdefault(name, [])

        def wrapped(*a, _real=real, _rec=rec, _fn=mod.call_bytes, **k):
            _rec.append(_fn(*a, **k))
            return _real(*a, **k)
        setattr(owner, entry[1], wrapped)
        undo.append((owner, entry[1], real))
    return undo


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules} &
                  set(FORBIDDEN))


def run(cell, seed, seconds, trace, device, t0, make_runtime=runtime):
    """Run the cell once; returns the result line's object. `t0`: the
    perf_counter reading at process start. `make_runtime(tables)` gives
    the served entry (tests put a broken one in its place)."""
    import torch
    from rayforce_tpu_torch.engine import device as dev
    cuda = device == "cuda"
    dev.set_device(device)
    if cuda:
        log("kernels:", ", ".join(build_kernels()))
    tensors = make_tables(cell.config, seed, device)
    tables = place_tables(tensors)
    rt = make_runtime(tables)
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    for q in cell.traffic["queries"]:
        for _ in range(2):
            force(rt.eval_str(q["text"]))
            sync()
    gc.collect()
    readings = Readings(setup_s=time.perf_counter() - t0)
    log(f"set-up {readings.setup_s:.3f} s")

    listed = cell.per_layer if trace else cell.end_to_end
    mods = {m["name"]: metric(m["name"]) for m in listed}
    sampler = Sampler(seed)
    attempted, failed = window(rt, cell, seed, seconds, trace, cuda, sync,
                               mods, readings, sampler)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    # the program's state goes before the reference runs
    del rt, tables
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    limits = cell.traffic["limits"]
    checks = check(cell, tensors, sampler)

    metrics = {}
    for m in listed:
        v = mods[m["name"]].read(readings) if readings.queries else None
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    out = {"correct": failed == 0 and cmp.passes(checks, limits),
           "attempted": attempted, "failed": failed, "metrics": metrics,
           "device": {"platform": "gpu" if cuda else "cpu",
                      "kind": torch.cuda.get_device_name(0) if cuda
                      else "cpu",
                      "count": cell.chips, "memory_peak_bytes": peak}}
    if trace:
        out["device"].update(busy_s=readings.trace.busy_s,
                             window_s=readings.trace.window_s)
        out["breakdown"] = {"device_ops": readings.trace.device_ops,
                            "idle_gaps": readings.trace.idle_gaps}
    out["checks"] = {k: {"value": checks[k], "limit": lim}
                     for k, lim in limits.items()}
    # last, after the references and the metric readers have run too
    found = forbidden_modules()
    if found:
        raise SystemExit(f"modules of JAX or the JAX package were loaded: "
                         f"{found}")
    return out


def window(rt, cell, seed, seconds, trace, cuda, sync, mods, readings,
           sampler):
    """The closed loop: queries in the mix's order until `seconds` have
    passed, each result forced and the device synchronised; the
    readings filled, each result offered to the sampler, and with
    `trace` the profiler's summary. Returns (attempted, failed)."""
    from rayforce_tpu_torch.core import profiler as pprof
    from rayforce_tpu_torch.engine import psort
    spans, attempted, failed = [], 0, 0
    if trace:
        from torch.profiler import ProfilerActivity, profile
        undo = _record_calls(mods, readings.calls)
        pprof.enabled = True
        # the device's activity alone (kernels, copies, memsets and the
        # CUDA runtime calls that launch them): recording every host op
        # as well nearly doubled a query's host time
        prof = profile(activities=[ProfilerActivity.CUDA if cuda else
                                   ProfilerActivity.CPU])
        prof.__enter__()
    before = dict(psort.LAUNCHES)
    start = end = time.perf_counter()
    start_ns = time.time_ns()
    deadline = start + seconds
    try:
        for q in query_order(cell.traffic, seed):
            t = time.perf_counter()
            if t >= deadline:
                break
            attempted += 1
            if trace:
                pprof.reset()
                t_ns = time.time_ns()
            try:
                res = rt.eval_str(q["text"])
                cols = force(res)
                sync()
            except Exception as e:
                failed += 1
                log(f"{q['name']} failed: {type(e).__name__}: {e}")
                break
            end = time.perf_counter()
            readings.latencies_s.append(end - t)
            readings.ends_s.append(end - start)
            readings.queries.append(q["name"])
            if trace:
                spans.append((t_ns, time.time_ns(), q["name"]))
                for label, ms in pprof.spans():
                    readings.spans.setdefault(label, []).append(ms)
            sampler.offer(q["name"], res, cols)
            del res, cols
    finally:
        end_ns = time.time_ns()
        if trace:
            t_exit = time.perf_counter()
            prof.__exit__(None, None, None)
            log(f"profiler stopped in {time.perf_counter() - t_exit:.1f} s")
            pprof.enabled = False
            for owner, attr, real in undo:
                setattr(owner, attr, real)
    readings.window_s = end - start
    readings.launches = {k: psort.LAUNCHES[k] - before[k] for k in before}
    per_s = [0] * (int(readings.window_s) + 1)
    for e in readings.ends_s:
        per_s[int(e)] += 1
    log("queries completed in each second of the window:", per_s)
    if trace:
        from . import trace as tr
        t_read = time.perf_counter()
        readings.trace = tr.summarize(prof, start_ns, end_ns, spans)
        log(f"trace: {len(readings.trace.ops)} device ops, read in "
            f"{time.perf_counter() - t_read:.1f} s")
    return attempted, failed


def check(cell, tensors, sampler):
    """The readings of the sampled results against the reference: each
    query's logged, all of them merged. A query that never completed
    counts as a mismatch."""
    per_query = {}
    for q in cell.traffic["queries"]:
        got = sampler.kept.pop(q["name"], None)
        if got is None:
            per_query[q["name"]] = {"exact_mismatches": 1,
                                    "f64_rel_err": 0.0}
            continue
        want = reference(q["reference"]["kind"]).run(tensors, q["reference"])
        per_query[q["name"]] = cmp.compare(got, want)
        del got, want
    for name, r in per_query.items():
        log(f"{name}: completed {sampler.seen.get(name, 0)}, "
            f"exact_mismatches {r['exact_mismatches']}, "
            f"f64_rel_err {r['f64_rel_err']!r}")
    return cmp.merge(per_query.values())
