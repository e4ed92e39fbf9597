"""A cell of several chips on CPU torch at a tiny size: the program's
mesh of 4 shards switched on by the cell's `chips`, G1 made, placed and
checked shard by shard (`data/g1_shards.py`, `reference/
groupby_shards.py`), a sound run correct and a run with one shard's
answer broken not; the run refused where the mesh is not the cell's;
and the trace's busy time per card."""
import json
import os
import time
from types import SimpleNamespace

import pytest
import torch

from portbench import compare as cmp
from portbench import harness
from portbench import trace as tr
from portbench.data import g1_shards
from portbench.reference import groupby, groupby_shards

CHIPS = 4

# db-benchmark q1-q6 (rayforce_tpu_torch/tools/g1.py QUERIES): the
# dense plan (q1, q4) and the dist-group engine (q2, q3, q5, q6) on the
# mesh
QUERIES = {
    "q1": ("(select {s: (sum v1) from: t by: id1})",
           ["id1"], [["s", "sum", "v1"]]),
    "q2": ("(select {s: (sum v1) from: t by: {id1: id1 id2: id2}})",
           ["id1", "id2"], [["s", "sum", "v1"]]),
    "q3": ("(select {s: (sum v1) a: (avg v3) from: t by: id3})",
           ["id3"], [["s", "sum", "v1"], ["a", "avg", "v3"]]),
    "q4": ("(select {a1: (avg v1) a2: (avg v2) a3: (avg v3) from: t "
           "by: id4})", ["id4"],
           [["a1", "avg", "v1"], ["a2", "avg", "v2"], ["a3", "avg", "v3"]]),
    "q5": ("(select {s1: (sum v1) s2: (sum v2) s3: (sum v3) from: t "
           "by: id6})", ["id6"],
           [["s1", "sum", "v1"], ["s2", "sum", "v2"], ["s3", "sum", "v3"]]),
    "q6": ("(select {mx: (max v1) mn: (min v2) from: t by: id3})",
           ["id3"], [["mx", "max", "v1"], ["mn", "min", "v2"]]),
}


def _spec(q, kind="groupby_shards"):
    _text, by, aggs = QUERIES[q]
    return {"kind": kind, "table": "t", "by": by, "aggs": aggs}


def _config(rows=20_000):
    with open(os.path.join(harness.PB, "configs", "g1_1e7_k100.json")) as f:
        cfg = json.load(f)
    cfg.update(generator="g1_shards", chips=CHIPS, rows=rows)
    return cfg


def _cell(kind="groupby_shards", rows=8_000):
    traffic = {"why": "q1-q6 shuffled over 4 shards", "order": "shuffle",
               "limits": {"exact_mismatches": 0, "f64_rel_err": 1e-10},
               "queries": [{"name": q, "text": QUERIES[q][0], "weight": 1,
                            "reference": _spec(q, kind)} for q in QUERIES]}
    bench = harness.load_cell("g1_1e7_k100.sortagg")
    return harness.Cell("g1_shards.mesh4", CHIPS, _config(rows), traffic,
                        bench.end_to_end, bench.per_layer)


@pytest.fixture
def mesh_engine(cpu_engine):
    """The program's device path on CPU torch, its mesh looked up anew
    before and after the test (the program caches it per process), and
    RAYFORCE_MESH, which a run sets, as it was before."""
    old = os.environ.pop("RAYFORCE_MESH", None)
    cpu_engine._mesh_state.update(mesh=None, checked=False)
    try:
        yield cpu_engine
    finally:
        os.environ.pop("RAYFORCE_MESH", None)
        if old is not None:
            os.environ["RAYFORCE_MESH"] = old
        cpu_engine._mesh_state.update(mesh=None, checked=False)


def _run(cell, make_runtime=harness.runtime, trace=False):
    # long enough for every query of the mix to complete on a busy CPU
    return harness.run(cell, 2**31 + 21, 4.0, trace, "cpu",
                       time.perf_counter(), make_runtime)


def test_sound_sharded_run_is_correct_on_a_mesh_of_four(mesh_engine):
    seen = []

    def make_runtime(tables):
        rt = harness.runtime(tables)
        real = rt.eval_str

        def eval_str(src):
            m = mesh_engine.mesh()
            seen.append(None if m is None else m.n)
            return real(src)
        rt.eval_str = eval_str
        return rt
    out = _run(_cell(), make_runtime)
    assert out["correct"] and out["failed"] == 0, out["checks"]
    assert out["device"]["count"] == CHIPS
    assert set(out["metrics"]) == {"setup_s", "qps", "p95_ms"}
    assert out["attempted"] > 0 and set(seen) == {CHIPS}
    assert os.environ["RAYFORCE_MESH"] == str(CHIPS)


def test_the_program_reads_the_placed_shards(mesh_engine):
    """Each column's mesh copy is the generator's shards themselves, and
    its whole payload their concatenation."""
    cell = _cell()
    harness.switch_mesh(CHIPS)
    m = harness.check_mesh(cell, "cpu")
    tensors = harness.cell_tables(cell, 5, "cpu")
    tables = harness.place_tables(tensors, m)
    for name, col in zip(harness.column_names(tables["t"]),
                         tables["t"].v[1]):
        shards = mesh_engine.dev_col_sharded(col, m)
        assert all(a is b for a, b in zip(shards, tensors["t"][name]))
        assert torch.equal(col.pending().arr, torch.cat(shards))


def _shard_broken(fault):
    """The program's mesh copy of the last shard broken after placement:
    one value altered, or the shard's values left out (zeroed)."""
    def make_runtime(tables):
        for col in tables["t"].v[1]:
            key, shards = col.meta["dev_sh"]
            x = shards[-1].clone()
            if fault == "altered":
                x[len(x) // 2] += 1
            else:
                x.zero_()
            col.meta["dev_sh"] = (key, shards[:-1] + [x])
        return harness.runtime(tables)
    return make_runtime


@pytest.mark.parametrize("fault", ["altered", "left_out"])
def test_one_shard_broken_is_not_correct(mesh_engine, fault):
    out = _run(_cell(), _shard_broken(fault))
    assert out["correct"] is False, out["checks"]


def test_traced_sharded_run(mesh_engine):
    out = _run(_cell(), trace=True)
    assert out["correct"]
    assert {"busy_s", "window_s"} <= set(out["device"])


def test_a_cell_of_four_never_runs_on_one(mesh_engine, monkeypatch):
    monkeypatch.setattr(mesh_engine, "mesh", lambda: None)
    with pytest.raises(SystemExit, match="mesh"):
        _run(_cell())


def test_a_cell_of_one_runs_with_no_mesh(mesh_engine, tiny_cell):
    os.environ["RAYFORCE_MESH"] = "4"
    out = _run(tiny_cell("g1_1e7_k100.wide"))
    assert out["correct"] and "RAYFORCE_MESH" not in os.environ
    os.environ["RAYFORCE_MESH"] = "4"
    mesh_engine._mesh_state.update(mesh=None, checked=False)
    assert mesh_engine.mesh().n == 4    # looked up before the run
    with pytest.raises(SystemExit, match="one chip"):
        _run(tiny_cell("g1_1e7_k100.wide"))


def test_sharded_tables_need_a_reference_that_takes_shards(mesh_engine):
    with pytest.raises(SystemExit, match="take whole"):
        _run(_cell(kind="groupby"))


def test_rows_that_do_not_split_are_refused():
    with pytest.raises(ValueError, match="equal shards"):
        harness.make_shards(_config(rows=20_001), 3, ["cpu"] * CHIPS)


def test_make_is_the_concatenation_of_make_shards():
    cfg = _config(rows=4_000)
    seed = 2**31 + 3
    shards = g1_shards.make_shards(cfg, seed, [torch.device("cpu")] * CHIPS)
    whole = g1_shards.make(cfg, seed, "cpu")
    assert list(whole["t"]) == [s[0] for s in cfg["tables"]["t"]]
    for name, x in whole["t"].items():
        assert [int(s.shape[0]) for s in shards["t"][name]] == [1_000] * 4
        assert torch.equal(x, torch.cat(shards["t"][name]))
    # each shard its own stream: blocks differ, and another seed differs
    assert not torch.equal(shards["t"]["id3"][0], shards["t"]["id3"][1])
    other = g1_shards.make(cfg, seed + 1, "cpu")
    assert not torch.equal(other["t"]["v3"], whole["t"]["v3"])


@pytest.mark.parametrize("q", sorted(QUERIES))
def test_groupby_shards_is_groupby_of_the_concatenation(q):
    cfg = _config(rows=8_000)
    shards = g1_shards.make_shards(cfg, 11, [torch.device("cpu")] * CHIPS)
    whole = {"t": {k: torch.cat(v) for k, v in shards["t"].items()}}
    got = groupby_shards.run(shards, _spec(q))
    want = groupby.run(whole, _spec(q, "groupby"))
    assert [(n, k) for n, _v, k in got] == [(n, k) for n, _v, k in want]
    r = cmp.compare([(n, v) for n, v, _k in got], want)
    assert r["exact_mismatches"] == 0 and r["f64_rel_err"] < 1e-13, r
    # the control's precision reads apart where the query has float lanes
    low = groupby_shards.run(shards, _spec(q), torch.float32)
    if any(k == "float" for _n, _v, k in want):
        assert cmp.compare([(n, v) for n, v, _k in low],
                           want)["f64_rel_err"] > 1e-10


def _event(name, start, dur, card=None):
    e = SimpleNamespace(
        name=lambda: name, start_ns=lambda: start, duration_ns=lambda: dur,
        device_type=lambda: torch.autograd.DeviceType.CUDA,
        is_user_annotation=lambda: False)
    if card is not None:
        e.device_index = lambda: card
    return e


def _prof(events):
    return SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: events)))


def test_trace_busy_per_card_and_their_mean():
    ev = [_event("k0", 1000, 3000, 0), _event("k0b", 2000, 1000, 0),
          _event("k1", 3000, 4000, 1), _event("k1b", 9000, 500, 1)]
    t = tr.summarize(_prof(ev), 0, 10000, [(0, 10000, "q1")], cards=(0, 1))
    # card 0: [1000, 4000]; card 1: [3000, 7000] + [9000, 9500]
    assert t.busy_s_per_card == [3000 / 1e9, 4500 / 1e9]
    assert t.busy_s == pytest.approx((3000 + 4500) / 2 / 1e9)
    # idle gaps: where no card works, [0, 1000] [7000, 9000] [9500, 10000]
    assert sorted(g[1] for g in t.idle_gaps) == [5e-7, 1e-6, 2e-6]
    assert t.kernels == 4
    # a card with no operation counts in the mean
    t3 = tr.summarize(_prof(ev), 0, 10000, [], cards=(0, 1, 2))
    assert t3.busy_s_per_card[2] == 0
    assert t3.busy_s == pytest.approx(7500 / 3 / 1e9)


def test_trace_of_one_card_is_as_before():
    ev = [_event("a", 1000, 3000, 0), _event("b", 3500, 1000, 0),
          _event("c", 6000, 500, 0)]
    one = tr.summarize(_prof(ev), 0, 10000, [(0, 10000, "q")], cards=(0,))
    plain = tr.summarize(_prof([_event("a", 1000, 3000),
                                _event("b", 3500, 1000),
                                _event("c", 6000, 500)]),
                         0, 10000, [(0, 10000, "q")])
    assert one.busy_s == plain.busy_s == (3500 + 500) / 1e9
    assert one.busy_s_per_card == [one.busy_s]
    assert (one.ops, one.idle_gaps, one.device_ops, one.kernels) == \
        (plain.ops, plain.idle_gaps, plain.device_ops, plain.kernels)
