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

A cell of N > 1 chips runs as the program's mesh of one row shard per
card:
- the mesh: `RAYFORCE_MESH=N`, the program's own switch, is set before
  its first mesh lookup (`engine/device.py` `mesh()`); the run ends
  with no result unless that mesh has N shards, shard i on card i (on
  CPU torch: N shards), before the tables are made and again after
  set-up. A one-chip cell runs with no mesh: the variable is removed
  and the run ends with no result if the program has one.
- the tables: a generator that defines `make_shards(config, seed,
  devices)` makes them shard by shard: {table: {column: [one tensor a
  card]}}, row block i on card i, in equal blocks, so that no card
  holds a whole column. A configuration whose `rows` are not a
  multiple of N is refused. A generator with `make` alone gives whole
  tensors on the engine's card, placed as on one chip, and the program
  slices its shards from them.
- the placement: each sharded column goes to the program as an Obj
  whose whole payload is lazy, a DevPending with shape (rows,) whose
  thunk concatenates the shards on the engine's card, and whose mesh
  copy is the shards themselves, in the cache that `dev_col_sharded`
  reads: `meta["dev_sh"] = (mesh.key, shards)`; then
  `device.put_table` as on one chip. (The program's stats pass forces
  the thunk: at a size where a whole column does not fit the engine's
  card, `put_table` fails.)
- the check: the references get the shard lists of a sharded table,
  and a mix over one must name reference kinds that take them
  (`SHARDS = True` in `reference/<kind>.py`, `groupby_shards`);
  otherwise whole tensors, as on one chip.
- the clock, trace and peak: after each query, and in set-up, every
  card of the cell is synchronised; the trace's busy time is the mean
  over the cell's cards of each card's own busy union
  (`trace.summarize`, `busy_s_per_card` beside it); idle gaps are
  stretches where no card works; `memory_peak_bytes` is the fullest
  card's peak.
With one chip every number is taken as it was before these rules.
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
    its file under `root`) and traffic mix `traffic` (`portbench/
    traffic/<traffic>.json` under `root`), reporting the metrics of
    `bench` that apply to `name`."""
    def applies(m):
        return name in m.get("workloads", [name])
    e2e = [m for m in bench["end_to_end"] if applies(m)]
    moved = {m["name"] for m in e2e}
    per = [m for m in bench["per_layer"] if applies(m) and
           m["moves"] in moved]
    cfg = {c["name"]: c for c in bench["configs"]}[config]
    return Cell(name, int(chips), _json(os.path.join(root, cfg["file"])),
                _json(os.path.join(root, "portbench", "traffic",
                                   traffic + ".json")),
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


def generator(config):
    return importlib.import_module(f"portbench.data.{config['generator']}")


def make_tables(config, seed, device):
    """{table: {column: tensor}} made by the configuration's generator."""
    return generator(config).make(config, seed, device)


def cards(device, n):
    """The devices of a cell of `n` chips: card i for shard i, or CPU
    torch for each."""
    import torch
    if device == "cuda":
        return [torch.device("cuda", i) for i in range(n)]
    return [torch.device(device)] * n


def make_shards(config, seed, devices):
    """{table: {column: [tensor on devices[i]]}} made shard by shard by
    the configuration's generator: equal row blocks, block i on
    devices[i]. Raises ValueError for rows that do not split evenly."""
    n = len(devices)
    if int(config.get("rows", 0)) % n:
        raise ValueError(f"{config['rows']} rows do not split into {n} "
                         f"equal shards")
    tables = generator(config).make_shards(config, seed, devices)
    for tname, cols in tables.items():
        for cname, shards in cols.items():
            lens = {int(x.shape[0]) for x in shards}
            where = [str(x.device) for x in shards]
            if len(shards) != n or len(lens) != 1 or \
                    where != [str(d) for d in devices]:
                raise ValueError(f"{tname}.{cname}: shards of rows {lens} "
                                 f"on {where}, not {n} equal blocks on "
                                 f"{[str(d) for d in devices]}")
    return tables


def sharded(cell):
    """Whether the cell's tables are made and placed shard by shard."""
    return cell.chips > 1 and hasattr(generator(cell.config), "make_shards")


def cell_tables(cell, seed, device):
    """The cell's tables from the seed: shard lists for a sharded cell,
    else whole tensors on the engine's device."""
    if sharded(cell):
        return make_shards(cell.config, seed, cards(device, cell.chips))
    return make_tables(cell.config, seed, device)


# -- the program --------------------------------------------------------------

def build_kernels():
    """Build (first run in a checkout) or find the program's hand-written
    kernels, all at once, in its own build cache inside the checkout."""
    from rayforce_tpu_torch.engine import cubuild
    names = sorted(f[:-3] for f in os.listdir(cubuild.CSRC)
                   if f.endswith(".cu"))
    cubuild.build(names)
    return names


def place_tables(tensors, mesh=None):
    """The tensors as the program's tables, placed on its device
    (`engine/device.py` put_table), as `tools/jtables.py` `_table` does.
    A column given as a list of shards goes in as the program's mesh
    copy for `mesh`, its whole payload a thunk that concatenates them
    on the engine's device (the module's docstring)."""
    import torch
    from rayforce_tpu_torch.core import types as T
    from rayforce_tpu_torch.core.obj import DevPending, Obj, table, vec_sym
    from rayforce_tpu_torch.engine import device as dev
    out = {}
    for tname, cols in tensors.items():
        objs = []
        for a in cols.values():
            if isinstance(a, list):
                rows = sum(int(x.shape[0]) for x in a)
                c = Obj(T.F64 if a[0].dtype == torch.float64 else T.I64,
                        DevPending(thunk=lambda a=a, rows=rows:
                                   _concat(a, rows, dev.device()),
                                   shape=(rows,)))
                c.meta = {"dev_sh": (mesh.key, a)}
            else:
                c = Obj(T.F64 if a.dtype == torch.float64 else T.I64,
                        DevPending(a))
                c.meta = {"dev": a}
            objs.append(c)
        out[tname] = table(vec_sym(list(cols)), objs)
        dev.put_table(out[tname])
    return out


def _concat(shards, rows, device):
    """The shards as one tensor on `device`, each copied into its block."""
    import torch
    out = torch.empty(rows, dtype=shards[0].dtype, device=device)
    at = 0
    for x in shards:
        out[at:at + x.shape[0]].copy_(x)
        at += int(x.shape[0])
    return out


def switch_mesh(chips):
    """The program's mesh switch for a cell of `chips` cards, set before
    its first mesh lookup: RAYFORCE_MESH=chips, or none for one chip."""
    if chips > 1:
        os.environ["RAYFORCE_MESH"] = str(chips)
    else:
        os.environ.pop("RAYFORCE_MESH", None)


def check_mesh(cell, device):
    """The program's mesh, which for a cell of N > 1 chips has to be N
    shards, shard i on card i (on CPU torch: N shards), and for one chip
    has to be none; ends the run with no result otherwise."""
    from rayforce_tpu_torch.engine import device as dev
    m = dev.mesh()
    if cell.chips == 1:
        if m is not None:
            raise SystemExit(f"{cell.name}: one chip, but the program runs "
                             f"a mesh of {m.n} shards")
        return None
    want = [str(d) for d in cards(device, cell.chips)]
    got = None if m is None else [str(d) for d in m.devices]
    if got != want:
        raise SystemExit(f"{cell.name}: {cell.chips} chips, but the "
                         f"program's mesh is {got}, not {want}")
    return m


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
    switch_mesh(cell.chips)
    dev.set_device(device)
    mesh = check_mesh(cell, device)
    if sharded(cell):
        kinds = {q["reference"]["kind"] for q in cell.traffic["queries"]}
        whole = sorted(k for k in kinds
                       if not getattr(reference(k), "SHARDS", False))
        if whole:
            raise SystemExit(f"{cell.name}: its tables are sharded and "
                             f"the reference kinds {whole} take whole "
                             f"tables")
    if cuda:
        log("kernels:", ", ".join(build_kernels()))
    tensors = cell_tables(cell, seed, device)
    tables = place_tables(tensors, mesh)
    rt = make_runtime(tables)
    n_cards = cell.chips if cuda else 0

    def sync():
        for i in range(n_cards):
            torch.cuda.synchronize(i)
    for q in cell.traffic["queries"]:
        for _ in range(2):
            force(rt.eval_str(q["text"]))
            sync()
    gc.collect()
    check_mesh(cell, device)
    readings = Readings(setup_s=time.perf_counter() - t0)
    log(f"set-up {readings.setup_s:.3f} s")

    listed = cell.per_layer if trace else cell.end_to_end
    mods = {m["name"]: metric(m["name"]) for m in listed}
    sampler = Sampler(seed)
    attempted, failed = window(rt, cell, seed, seconds, trace, cuda, sync,
                               mods, readings, sampler)
    peaks = [torch.cuda.max_memory_allocated(i) for i in range(n_cards)]
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
                      "count": cell.chips,
                      "memory_peak_bytes": max(peaks, default=0)}}
    if cuda and n_cards > 1:
        out["device"]["memory_peak_bytes_per_card"] = peaks
    if trace:
        out["device"].update(busy_s=readings.trace.busy_s,
                             window_s=readings.trace.window_s)
        if n_cards > 1:
            out["device"]["busy_s_per_card"] = readings.trace.busy_s_per_card
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
    passed, each result forced and every card synchronised; the
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
        readings.trace = tr.summarize(prof, start_ns, end_ns, spans,
                                      range(cell.chips))
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
