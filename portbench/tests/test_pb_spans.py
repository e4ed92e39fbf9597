"""The readers of the program's spans (`portbench/spans.py` and the
five metrics that read it) on a synthetic span log and synthetic device
operations worked out by hand; a whole CPU run in which they run; and,
on a CUDA card, that the spans share the device trace's clock and that
every synchronizing CUDA op of the three mixes fires inside a `sync:`
span."""
import sys
import time
import warnings
from types import SimpleNamespace

import pytest

from portbench import harness, spans
from rayforce_tpu_torch.core import profiler
from rayforce_tpu_torch.core.profiler import Span

NEW = ("host_syncs_per_query", "sync_wait_ms", "engine_host_ms",
       "engine_idle_ms", "frontend_idle_ms")


def _log():
    """Three requests: 1 before the window, 2 and 3 in it (times in ns)."""
    rows = [
        # request 1: outside the window
        (1, 1, "query", 0, 50, -1),
        (2, 1, "engine: sortagg", 10, 40, 1),
        (3, 1, "sync: sortagg.scalars", 20, 30, 2),
        # request 2: a select and a gather the caller forces
        (10, 2, "query", 100, 200, -1),
        (11, 2, "select: eval spec", 99, 110, 10),
        (12, 2, "plan", 110, 120, 10),
        (13, 2, "plan: build", 112, 118, 12),
        (14, 2, "engine: sortagg", 120, 180, 10),
        (15, 2, "sync: sortagg.scalars", 150, 170, 14),
        (16, 2, "gather", 185, 195, 10),
        (17, 2, "gather", 205, 215, -1),
        # request 3: a window join whose lane runs when forced
        (20, 3, "query", 300, 400, -1),
        (21, 3, "engine: wjoin", 310, 350, 20),
        (22, 3, "sync: wjoin.bounds", 320, 325, 21),
        (23, 3, "gather", 330, 340, 21),
        (24, 3, "sync: join.all_matched", 360, 365, 20),
        (25, 3, "gather", 410, 430, -1),
        (26, 3, "engine: wjoin", 412, 428, 25),
        (27, 3, "sync: wjoin.span", 415, 420, 26),
    ]
    return [Span(*r) for r in sorted(rows, key=lambda r: r[4])]


# busy: [0, 60] [105, 125] [140, 160] (k3 inside k2) [190, 310]
# [322, 345] [405, 414]
OPS = [("k7", 0, 60), ("k1", 105, 125), ("k2", 140, 160), ("k3", 145, 155),
       ("k4", 190, 310), ("k5", 322, 345), ("k6", 405, 414)]


def test_split_by_hand():
    s = spans.split(_log(), 2, OPS)
    assert s.queries == 2
    # syncs of requests 2 and 3 only
    assert s.syncs == 4 and s.sync_ns == 20 + 5 + 5 + 5
    # engine spans [110, 180] [310, 350] [412, 428] less the syncs and
    # gathers below them ([150, 170] [320, 325] [330, 340] [415, 420]);
    # the root gather around [412, 428] and the front end's sync and
    # gathers take nothing from them
    assert s.engine_host_ns == 40 + 10 + 10 + 5 + 10 + 3 + 8
    # the same less the syncs alone, then less busy: [125, 140]
    # [170, 180] [310, 320] [345, 350] [414, 415] [420, 428]; the gap
    # [170, 190] straddles the engine's end and the front end
    assert s.engine_idle_ns == 15 + 10 + 10 + 5 + 1 + 8
    # queries and root gathers less engine and sync spans, less busy:
    # [100, 105] [180, 190] [350, 360] [365, 400] [428, 430]; the front
    # end's sync [360, 365] is left out; select: eval spec adds nothing
    assert s.frontend_idle_ns == 5 + 10 + 10 + 35 + 2
    # no device operation: no idle to split
    s = spans.split(_log(), 2, [])
    assert s.engine_idle_ns is None and s.frontend_idle_ns is None
    assert s.syncs == 4
    # one query in the window: request 3 alone
    s = spans.split(_log(), 1, OPS)
    assert (s.queries, s.syncs) == (1, 3)
    assert s.engine_host_ns == 10 + 5 + 10 + 3 + 8
    assert spans.split(_log()[:0], 2, OPS) is None


def _ctx(ops=OPS, queries=("q2", "q3")):
    return harness.Readings(setup_s=1.0, window_s=1.0, queries=list(queries),
                            trace=SimpleNamespace(ops=list(ops)))


def test_readers_by_hand(monkeypatch):
    monkeypatch.setattr(profiler, "log", _log)
    monkeypatch.setattr(profiler, "dropped", lambda: 0)
    ctx = _ctx()
    want = {"host_syncs_per_query": 2.0, "sync_wait_ms": 35 / 2 / 1e6,
            "engine_host_ms": 86 / 2 / 1e6, "engine_idle_ms": 49 / 2 / 1e6,
            "frontend_idle_ms": 62 / 2 / 1e6}
    for name, v in want.items():
        assert harness.metric(name).read(ctx) == pytest.approx(v, rel=1e-12)
    # a ring that dropped spans, a trace with no device operation (CPU
    # torch), no completed query: nothing is read
    for ctx, dropped in ((_ctx(), 1), (_ctx(ops=[]), 0),
                         (_ctx(queries=[]), 0)):
        monkeypatch.setattr(profiler, "dropped", lambda d=dropped: d)
        for name in NEW:
            assert harness.metric(name).read(ctx) is None, name


def test_a_program_without_the_span_log_reads_nothing(monkeypatch):
    monkeypatch.delattr(profiler, "log")
    for name in NEW:
        assert harness.metric(name).read(_ctx()) is None


def test_whole_cpu_run_runs_the_readers(cpu_engine, tiny_cell, monkeypatch):
    seen = {}
    real = harness.metric

    def metric(name):
        mod = real(name)
        if name in NEW:
            read = mod.read

            def recorded(ctx, _read=read, _name=name):
                seen[_name] = (ctx, _read(ctx))
                return seen[_name][1]
            mod.read = recorded
        return mod
    monkeypatch.setattr(harness, "metric", metric)
    out = harness.run(tiny_cell("g1_1e7_k100.wide"), 2**31 + 5, 0.5, True,
                      "cpu", time.perf_counter())
    assert out["correct"]
    # on CPU torch no device operation is traced: the readers run and
    # leave their metrics out
    assert set(out["metrics"]) == {"frontend_ms"}
    assert set(seen) == set(NEW)
    assert all(v is None for _ctx, v in seen.values())
    ctx = seen["engine_idle_ms"][0]
    n = len(ctx.queries)
    assert profiler.dropped() == 0 and not profiler.enabled
    # the same window against a device idle throughout, and busy
    # throughout: each query one read, inside the wide engine
    log = profiler.log()
    idle = spans.split(log, n, [("k", 0, 1)])
    busy = spans.split(log, n, [("k", 0, 2**62)])
    assert idle.queries == n and idle.syncs == n
    window = [r for r in log if r.request in
              {x.request for x in log if x.name == "query"}]
    assert {r.name for r in window if r.name.startswith("sync: ")} >= \
        {"sync: wide.groups"}
    assert busy.engine_idle_ns == busy.frontend_idle_ns == 0
    assert 0 < idle.engine_host_ns <= idle.engine_idle_ns
    assert idle.frontend_idle_ns > 0


# -- on the card --------------------------------------------------------------

def _need_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")


@pytest.fixture
def card_engine():
    from rayforce_tpu_torch.engine import device as dev
    old = dict(dev._cfg)
    dev.set_device("cuda")
    dev.set_threshold(1)
    yield dev
    dev._cfg.clear()
    dev._cfg.update(old)
    profiler.enabled = False


def _cell_at(name, n):
    import json
    import os
    with open(os.path.join(harness.ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    w = {w["name"]: w for w in bench["workloads"]}[name]
    cell = harness.cell(bench, harness.ROOT, name, w["config"], w["traffic"])
    cell.config["rows" if cell.config["generator"] == "g1" else "n"] = n
    return cell


@pytest.mark.card
def test_spans_share_the_device_trace_clock(card_engine):
    _need_card()
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    harness.build_kernels()
    cell = _cell_at("g1_1e7_k100.sortagg", 1_000_000)
    rt = harness.runtime(harness.place_tables(
        harness.make_tables(cell.config, 11, "cuda")))
    q2 = cell.traffic["queries"][0]["text"]
    for _ in range(2):
        harness.force(rt.eval_str(q2))
    torch.cuda.synchronize()
    profiler.enabled = True
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            profiler.reset()
            harness.force(rt.eval_str(q2))
            torch.cuda.synchronize()
    finally:
        profiler.enabled = False
    sp = [r for r in profiler.log() if r.name == "sync: sortagg.scalars" and
          r.request == profiler._request]
    assert len(sp) == 1
    s, e = sp[0].start_ns, sp[0].end_ns
    host, dev_ops = [], []
    for ev in prof.profiler.kineto_results.events():
        a = ev.start_ns()
        b = a + ev.duration_ns()
        (host if ev.device_type() == DeviceType.CPU else dev_ops).append(
            (ev.name(), a, b))
    tol = 50_000
    # the runtime calls of the read: the copy and the wait for it
    calls = [c for c in host if c[0] in ("cudaMemcpyAsync",
                                         "cudaStreamSynchronize")
             and c[2] > s - tol and c[1] < e + tol]
    copies = [o for o in dev_ops if o[0].startswith("Memcpy DtoH") and
              s - tol < o[2] < e + tol]
    print(f"[clock] span {s}..{e} ({(e - s) / 1e3:.1f} us); calls "
          + ", ".join(f"{n} {(a - s) / 1e3:+.1f}/{(b - e) / 1e3:+.1f} us"
                      for n, a, b in calls)
          + "; copies " + ", ".join(f"{n} ends {(b - e) / 1e3:+.1f} us"
                                    for n, a, b in copies), file=sys.stderr)
    assert calls and all(s - tol <= a and b <= e + tol for _n, a, b in calls)
    assert len(copies) == 1
    assert s <= copies[0][2] <= e


@pytest.mark.card
def test_every_sync_of_the_mixes_fires_inside_a_sync_span(card_engine):
    _need_card()
    import torch
    harness.build_kernels()
    fired, outside = [], []

    def hook(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" not in str(message):
            return
        import traceback
        port = [f"{f.filename.rsplit('rayforce_tpu_torch/', 1)[-1]}:"
                f"{f.lineno}" for f in traceback.extract_stack()
                if "rayforce_tpu_torch" in f.filename]
        if not port:
            return
        open_ = profiler.open_spans()
        fired.append(open_[-1] if open_ else None)
        if not open_ or not open_[-1].startswith("sync: "):
            outside.append((port[-3:], open_))
    for name in ("g1_1e7_k100.sortagg", "taq_10m_20m.asof_window",
                 "g1_1e7_k100.wide"):
        cell = _cell_at(name, 100_000)
        rt = harness.runtime(harness.place_tables(
            harness.make_tables(cell.config, 13, "cuda")))
        torch.cuda.synchronize()
        for q in cell.traffic["queries"]:
            for _ in range(3):       # the first builds the plans
                profiler.enabled = True
                profiler.reset()
                with warnings.catch_warnings():
                    warnings.simplefilter("always")
                    warnings.showwarning = hook
                    torch.cuda.set_sync_debug_mode("warn")
                    try:
                        harness.force(rt.eval_str(q["text"]))
                    finally:
                        torch.cuda.set_sync_debug_mode(0)
                        profiler.enabled = False
                torch.cuda.synchronize()
        del rt
    sites = {}
    for f in fired:
        sites[f] = sites.get(f, 0) + 1
    print(f"[census] {len(fired)} synchronizing ops: {sites}",
          file=sys.stderr)
    assert fired and not outside, outside
