"""The port's span recorder (`rayforce_tpu_torch/core/profiler.py`):
nesting, requests, self time, threads, the ring's bound, the disabled
path, the `-t` report, the sync helper; and the span tree that a G1
select, an asof join and a window join leave through `Runtime.eval_str`
on CPU torch."""
import collections
import os
import subprocess
import sys
import threading
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from rayforce_tpu_torch.core import profiler

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def prof(monkeypatch):
    """The recorder enabled, with an empty ring of its own."""
    monkeypatch.setattr(profiler, "_ring",
                        collections.deque(maxlen=profiler.RING))
    monkeypatch.setattr(profiler, "_dropped", 0)
    monkeypatch.setattr(profiler, "_local", threading.local())
    monkeypatch.setattr(profiler, "enabled", True)
    profiler.reset()
    return profiler


@pytest.fixture
def clock(monkeypatch):
    """A fake time_ns: each reading is `now[0]`, then advances it by
    `step[0]`."""
    now, step = [1000], [0]

    def time_ns():
        t = now[0]
        now[0] += step[0]
        return t
    monkeypatch.setattr(profiler, "time", SimpleNamespace(time_ns=time_ns))
    return SimpleNamespace(now=now, step=step)


def test_nesting_and_parent_indices(prof):
    with prof.span("query"):
        with prof.span("plan"):
            with prof.span("plan: build"):
                pass
        tok = prof.begin("engine: sortagg")
        prof.host("sortagg.scalars", int, torch.tensor(3))
        prof.end(tok)
    recs = {r.name: r for r in prof.log()}
    assert recs["query"].parent == -1
    assert recs["plan"].parent == recs["query"].index
    assert recs["plan: build"].parent == recs["plan"].index
    assert recs["engine: sortagg"].parent == recs["query"].index
    assert recs["sync: sortagg.scalars"].parent == \
        recs["engine: sortagg"].index
    for r in recs.values():
        if r.parent != -1:
            p = next(x for x in recs.values() if x.index == r.parent)
            assert p.start_ns <= r.start_ns <= r.end_ns <= p.end_ns
    assert prof.open_spans() == []
    # the log lists spans as they closed; spans() as they opened
    assert [n for n, _ in prof.spans()] == [
        "query", "plan", "plan: build", "engine: sortagg",
        "sync: sortagg.scalars"]


def test_request_ids_across_reset(prof):
    with prof.span("query"):
        pass
    first = prof.log()[-1].request
    prof.reset()
    with prof.span("query"):
        with prof.span("gather"):
            pass
    prof.reset()
    with prof.span("gather"):
        pass
    reqs = [r.request for r in prof.log()]
    assert reqs == [first, first + 1, first + 1, first + 2]
    # reset() keeps the log, and spans() reads the current request only
    assert len(prof.log()) == 4
    assert [n for n, _ in prof.spans()] == ["gather"]


def test_self_time(prof, clock):
    clock.step[0] = 0
    clock.now[0] = 0
    with prof.span("query"):            # [0, 100]
        clock.now[0] = 10
        with prof.span("engine: wide"):  # [10, 60]
            clock.now[0] = 20
            with prof.span("sync: wide.groups"):  # [20, 50]
                clock.now[0] = 50
            clock.now[0] = 60
        clock.now[0] = 70
        with prof.span("gather"):       # [70, 80]
            clock.now[0] = 80
        clock.now[0] = 100
    recs = prof.log()
    own = prof.self_ns(recs)
    by = {r.name: own[r.index] for r in recs}
    assert by == {"query": 100 - 50 - 10, "engine: wide": 50 - 30,
                  "sync: wide.groups": 30, "gather": 10}
    assert [(n, ms) for n, ms in prof.spans()] == [
        ("query", 100e-6), ("engine: wide", 50e-6),
        ("sync: wide.groups", 30e-6), ("gather", 10e-6)]


def test_stamps_are_the_trace_clock(prof):
    import time
    a = time.time_ns()
    with prof.span("query"):
        pass
    b = time.time_ns()
    r = prof.log()[-1]
    assert a <= r.start_ns <= r.end_ns <= b


def test_per_thread_stacks(prof):
    go = threading.Barrier(2)
    errors = []

    def work(tag):
        try:
            go.wait(timeout=10)
            for i in range(200):
                with prof.span(f"engine: {tag}"):
                    with prof.span(f"sync: {tag}.{i}"):
                        pass
        except Exception as e:     # re-raised below, in the test's thread
            errors.append(e)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        ts = [threading.Thread(target=work, args=(t,)) for t in "ab"]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not errors and not any(t.is_alive() for t in ts)
    recs = prof.log()
    by_index = {r.index: r for r in recs}
    assert len(recs) == 800
    for r in recs:
        tag = r.name.split(": ")[1][0]
        if r.name.startswith("engine: "):
            assert r.parent == -1
        else:
            # each sync's parent is its own thread's engine span
            assert by_index[r.parent].name == f"engine: {tag}"
    assert len({r.index for r in recs}) == 800


def test_ring_bound_and_drop_count(prof, monkeypatch):
    monkeypatch.setattr(profiler, "_ring", collections.deque(maxlen=8))
    for i in range(13):
        with prof.span(f"s{i}"):
            pass
    assert [r.name for r in prof.log()] == [f"s{i}" for i in range(5, 13)]
    assert prof.dropped() == 5


def test_disabled_path_appends_nothing(prof, monkeypatch, clock):
    monkeypatch.setattr(profiler, "enabled", False)
    clock.step[0] = 1
    before = clock.now[0]
    with prof.span("query"):
        tok = prof.begin("plan")
        prof.end(tok)
        assert prof.host("x", int, torch.tensor(5)) == 5
        prof.since_request("select: eval spec")
    assert tok is None
    assert prof.log() == [] and prof.spans() == [] and prof.report() == ""
    assert prof.open_spans() == []
    assert clock.now[0] == before     # no clock read
    assert prof.span("a") is prof.span("b")   # no allocation


@pytest.mark.parametrize("read, args", [
    (lambda t: t.tolist(), (torch.arange(5),)),
    (int, (torch.tensor(7),)),
    (bool, (torch.tensor([0, 1]).any(),)),
    (lambda t: t.cpu(), (torch.arange(3.0),)),
    (torch.nonzero, (torch.tensor([0, 2, 0, 3]),)),
    (lambda t: t.cpu().numpy(), (torch.tensor([1.5, -0.0]),)),
])
@pytest.mark.parametrize("on", [True, False])
def test_host_returns_the_raw_read(prof, monkeypatch, read, args, on):
    monkeypatch.setattr(profiler, "enabled", on)
    got = prof.host("site", read, *args)
    want = read(*args)
    assert type(got) is type(want)
    if isinstance(want, torch.Tensor):
        assert got.dtype == want.dtype and torch.equal(got, want)
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype and np.array_equal(got, want)
        assert np.signbit(got).tolist() == np.signbit(want).tolist()
    else:
        assert got == want
    assert [r.name for r in prof.log()] == (["sync: site"] if on else [])


def test_host_closes_its_span_on_error(prof):
    def fail():
        raise ValueError("read failed")
    with pytest.raises(ValueError):
        prof.host("site", fail)
    assert [r.name for r in prof.log()] == ["sync: site"]
    assert prof.open_spans() == []


# -- the spans of the port's query path on CPU torch --------------------------

@pytest.fixture
def cpu_device():
    from rayforce_tpu_torch.engine import device as dev
    old = dict(dev._cfg)
    dev.set_device("cpu")
    dev.set_threshold(1)
    yield dev
    dev._cfg.clear()
    dev._cfg.update(old)


TABLES = """
(set n 3000)
(set t (table [id1 id2 id3 v1 v3]
    (list (% (til n) 7) (% (* (til n) 3) 5) (% (* (til n) 7) 1000)
          (+ 1 (% (til n) 5)) (as 'F64 (% (til n) 11)))))
(set atr (table [Sym Ts Px] (list (% (til n) 2) (* (til n) 7)
                                 (as 'F64 (% (til n) 9)))))
(set aqu (table [Sym Ts Bid] (list (% (til (* 2 n)) 3)
                                  (- (* (til (* 2 n)) 3) 1000)
                                  (as 'F64 (% (til (* 2 n)) 7)))))
(set wt (table [Sym Ts] (list (% (til n) 2) (* (til n) 5))))
(set wq (table [Sym Ts Bid Ask] (list (% (til (* 2 n)) 3)
                                      (- (* (til (* 2 n)) 2) 2000)
                                      (as 'F64 (% (til (* 2 n)) 10))
                                      (as 'F64 (+ 20 (% (til (* 2 n)) 10))))))
"""

# each query's engine span and the chains (root to span) of its reads
QUERIES = {
    "select": ("(select {s: (sum v1) a: (avg v3) from: t by: id3})",
               "engine: sortagg",
               [["query", "engine: sortagg", "sync: sortagg.scalars"]]),
    "asof": ("(asof-join [Sym Ts] atr aqu)", "engine: asof",
             [["query", "sync: join.all_matched"]]),
    "window": ("(window-join1 [Sym Ts] (map-left + [-2000 2000] "
               "(at wt 'Ts)) wt wq {mx: (max Ask) mn: (min Bid)})",
               "engine: wjoin",
               [["query", "engine: wjoin", "sync: wjoin.bounds"],
                ["gather", "engine: wjoin", "sync: wjoin.span"],
                ["gather", "engine: wjoin", "sync: wjoin.zero_sign"]]),
}


@pytest.mark.parametrize("query", sorted(QUERIES))
def test_query_path_span_tree(prof, cpu_device, monkeypatch, query):
    from rayforce_tpu_torch import Runtime
    text, engine, reads = QUERIES[query]
    rt = Runtime()
    monkeypatch.setattr(profiler, "enabled", False)
    rt.eval_str(TABLES)
    monkeypatch.setattr(profiler, "enabled", True)
    prof.reset()
    res = rt.eval_str(text)
    for c in res.v[1]:
        p = c.pending()
        if p is not None:
            p.arr
    recs = [r for r in prof.log() if r.request == profiler._request]
    by_index = {r.index: r for r in recs}

    def chain(r):
        out = [r.name]
        while r.parent != -1:
            r = by_index[r.parent]
            out.append(r.name)
        return out[::-1]
    chains = [chain(r) for r in recs]
    roots = [r for r in recs if r.parent == -1]
    query_span = roots[0]
    assert query_span.name == "query"
    assert {r.name for r in roots[1:]} <= {"gather"}
    assert ["query", engine] in chains
    for c in reads:
        assert c in chains, (c, chains)
    # every read of the request is a sync span's
    assert all(c[-1].startswith("sync: ") for c in chains
               if any(n.startswith("sync: ") for n in c))
    for r in recs:
        if r.parent != -1 and r.name != "select: eval spec":
            p = by_index[r.parent]
            assert p.start_ns <= r.start_ns <= r.end_ns <= p.end_ns
    if query == "select":
        assert ["query", "plan", "plan: build"] in chains
        # the front end's span: from the request's start to the spec
        # evaluated, before the plan lookup
        spec = next(r for r in recs if r.name == "select: eval spec")
        plan = next(r for r in recs if r.name == "plan")
        assert chain(spec) == ["query", "select: eval spec"]
        assert spec.start_ns == profiler._t0 <= query_span.start_ns
        assert spec.end_ns <= plan.start_ns
        # a second run finds its plan cached
        prof.reset()
        rt.eval_str(text)
        names = [n for n, _ in prof.spans()]
        assert "plan" in names and "plan: build" not in names
    else:
        # the lazy columns the caller forces: roots of the request
        assert any(r.name == "gather" for r in roots)


def test_cli_t_report_is_nested(tmp_path):
    script = tmp_path / "s.rfl"
    script.write_text(
        "(set n 140000)\n"
        "(set t (table [K V] (list (% (til n) 1000) (+ 1 (% (til n) 5)))))\n"
        "(set r (select {s: (sum V) from: t by: K}))\n"
        "(println \"rows: %\" (count r))\n")
    env = dict(os.environ, RAYFORCE_DEVICE="cpu", OMP_NUM_THREADS="1")
    p = subprocess.run([sys.executable, "-m", "rayforce_tpu_torch", "-t",
                        "-f", str(script)], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr
    assert "rows: 1000" in p.stdout
    lines = p.stderr.splitlines()
    rows = {ln.strip().split("  ")[0]: ln for ln in lines}
    assert lines[0].split() == ["span", "ms", "self", "ms"]
    indent = {name: len(ln) - len(ln.lstrip()) for name, ln in rows.items()}
    assert indent["query"] == 2
    assert indent["select: eval spec"] == indent["plan"] == 4
    assert indent["engine: sortagg"] == 4
    assert indent["plan: build"] == 6
    assert indent["sync: sortagg.scalars"] == 6
    assert lines[-1].split()[0] == "total"
