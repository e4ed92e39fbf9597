"""The four-card cell `g1_1e9_k100.mesh4`: its configuration, mix and
metrics load through `harness.load_cell`; a tiny run of the same mix on
four shards of CPU torch reads `correct`; and each of its per-layer
metrics' readers computes its figure from a fake trace and a fake
counter."""
import os
import time

import pytest

from portbench import harness
from portbench import trace as tr

CELL = "g1_1e9_k100.mesh4"
NEW = {"mesh_moved_mb_per_query", "mesh_copy_ms", "card_busy_max_ms"}


def test_the_cell_loads_with_its_config_mix_and_metrics():
    cell = harness.load_cell(CELL)
    assert cell.chips == 4
    cfg = cell.config
    assert (cfg["generator"], cfg["rows"], cfg["chips"], cfg["reduced"]) \
        == ("g1_shards", 10**9, 4, [])
    cols = {c[0]: c[1:] for c in cfg["tables"]["t"]}
    assert cols["id3"][1:] == cols["id6"][1:] == [0, 10**7]
    assert [q["name"] for q in cell.traffic["queries"]] == \
        ["q1", "q2", "q3", "q4", "q5", "q6"]
    assert {q["reference"]["kind"] for q in cell.traffic["queries"]} == \
        {"groupby_shards"}
    assert cell.traffic["limits"] == {"exact_mismatches": 0,
                                      "f64_rel_err": 1e-10}
    assert {m["name"] for m in cell.end_to_end} == \
        {"setup_s", "qps", "p95_ms"}
    assert {m["name"] for m in cell.per_layer} == NEW
    # the sortagg cell's queries word for word
    sortagg = harness.load_cell("g1_1e7_k100.sortagg")
    texts = {q["name"]: q["text"] for q in cell.traffic["queries"]}
    for q in sortagg.traffic["queries"]:
        assert texts[q["name"]] == q["text"]
    # and no other cell reports the new metrics
    for w in ("g1_1e7_k100.sortagg", "g1_1e7_k100.wide",
              "taq_10m_20m.asof_window"):
        assert not NEW & {m["name"] for m in harness.load_cell(w).per_layer}


@pytest.fixture
def mesh_engine(cpu_engine):
    """The program's mesh looked up anew around the test, and
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


@pytest.mark.parametrize("trace", [False, True])
def test_a_tiny_run_of_the_mix_on_four_shards_is_correct(mesh_engine,
                                                          trace):
    cell = harness.load_cell(CELL)
    cell.config.update(rows=8_000)
    copies = dict(mesh_engine.WHOLE_COPIES)
    out = harness.run(cell, 2**31 + 19, 4.0, trace, "cpu",
                      time.perf_counter())
    assert out["correct"] and out["failed"] == 0, out["checks"]
    assert out["device"]["count"] == 4
    assert mesh_engine.WHOLE_COPIES == copies
    if trace:
        # CPU torch: one device, no copy between cards, nothing to time
        # on a card; the counter reads (0 bytes)
        assert set(out["metrics"]) == {"mesh_moved_mb_per_query"}
        assert out["metrics"]["mesh_moved_mb_per_query"]["value"] == 0
    else:
        assert set(out["metrics"]) == {"setup_s", "qps", "p95_ms"}


def _ctx(ops=(), per_card=(), queries=4):
    t = tr.Trace(window_s=1.0, busy_s_per_card=list(per_card),
                 ops=list(ops))
    return harness.Readings(setup_s=1.0, queries=["q1"] * queries, trace=t)


def test_mesh_copy_ms_sums_the_peer_copies_of_every_card():
    m = harness.metric("mesh_copy_ms")
    ops = [("Memcpy PtoP (Device -> Device)", 0, 3_000_000),
           ("Memcpy PtoP (Device -> Device)", 5_000_000, 6_000_000),
           ("Memcpy DtoD (Device -> Device)", 0, 9_000_000),
           ("void pass_kernel<16>", 0, 7_000_000)]
    assert m.read(_ctx(ops)) == pytest.approx(4.0 / 4)
    assert m.read(_ctx(ops[2:])) is None
    assert m.read(harness.Readings(setup_s=1.0, queries=["q1"])) is None


def test_card_busy_max_ms_is_the_busiest_cards():
    m = harness.metric("card_busy_max_ms")
    assert m.read(_ctx(per_card=[0.5, 2.0, 1.0, 0.25])) == \
        pytest.approx(2.0e3 / 4)
    assert m.read(_ctx(per_card=[0.0, 0.0])) is None
    assert m.read(harness.Readings(setup_s=1.0, queries=["q1"])) is None


def test_mesh_moved_mb_per_query_reads_the_window_of_the_counter():
    from rayforce_tpu_torch.parallel import dist
    saved = dist.moved["bytes"]
    try:
        dist.moved["bytes"] = 7_000_000       # set-up's moves
        m = harness.metric("mesh_moved_mb_per_query")
        dist.moved["bytes"] += 12_000_000     # the window's
        assert m.read(_ctx()) == pytest.approx(12.0 / 4)
    finally:
        dist.moved["bytes"] = saved


def test_mesh_moved_mb_per_query_reads_nothing_without_the_counter(
        monkeypatch):
    from rayforce_tpu_torch.parallel import dist
    monkeypatch.delattr(dist, "moved")
    m = harness.metric("mesh_moved_mb_per_query")
    assert m.read(_ctx()) is None


def test_new_readers_read_no_device_number_on_one_cpu_trace():
    """A trace with no card (CPU torch) gives the device readers
    nothing."""
    ctx = _ctx(ops=[("aten::add", 0, 1000)], per_card=[0.0])
    for name in ("mesh_copy_ms", "card_busy_max_ms"):
        assert harness.metric(name).read(ctx) is None
