"""The 1e8-row G1 cell: the readers of sortagg_exact_calls_per_query
and sort_key_words_per_query (per-query counts; nothing for a program
without the counter), both reported in `g1_1e8_k100.sortagg` alone, and
its configuration (db-benchmark's 1e8 rows, id3 and id6 at N/K = 1e6
levels)."""
import json
import os

import pytest
import torch

from portbench import harness

NEW = ("sortagg_exact_calls_per_query", "sort_key_words_per_query")
CELL = "g1_1e8_k100.sortagg"


@pytest.mark.parametrize("name, counter, count", [
    ("sortagg_exact_calls_per_query", "sortagg_exact", 3),
    ("sort_key_words_per_query", "radix_key_words", 21)])
def test_reader_counts_a_query_and_leaves_out_a_missing_counter(
        name, counter, count):
    m = harness.metric(name)
    ctx = harness.Readings(setup_s=1.0, queries=["q2", "q3", "q5", "q6"],
                           launches={"radix_sort": 13, counter: count})
    assert m.read(ctx) == count / 4
    ctx.launches = {"radix_sort": 13, counter: 0}
    assert m.read(ctx) == 0.0              # the counter there, no count
    ctx.launches = {"radix_sort": 13}      # a program without it
    assert m.read(ctx) is None


def test_only_the_1e8_cell_reports_the_new_metrics():
    with open(os.path.join(harness.ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    for w in bench["workloads"]:
        names = {m["name"] for m in harness.load_cell(w["name"]).per_layer}
        for name in NEW:
            assert (name in names) == (w["name"] == CELL), (w["name"], name)


def test_the_1e8_config_is_db_benchmarks_g1_at_1e8_rows():
    cell = harness.load_cell(CELL)
    cfg = cell.config
    assert (cfg["generator"], cfg["chips"], cfg["rows"], cfg["reduced"]) \
        == ("g1", 1, 100_000_000, [])
    assert cell.chips == 1 and cfg["assumed"]
    assert cfg["source"].startswith(
        "https://github.com/h2oai/db-benchmark groupby G1_1e8_1e2_0_0")
    ranges = {c[0]: tuple(c[2:4]) for c in cfg["tables"]["t"]}
    assert ranges["id3"] == ranges["id6"] == (0, 1_000_000)
    assert all(ranges[k] == (0, 100) for k in ("id1", "id2", "id4", "id5"))
    with open(os.path.join(harness.PB, "configs", "g1_1e7_k100.json")) as f:
        small = json.load(f)
    assert set(cfg) == set(small)
    assert [c for c in cfg["tables"]["t"] if c[0] not in ("id3", "id6")] \
        == [c for c in small["tables"]["t"] if c[0] not in ("id3", "id6")]
    tiny = dict(cfg, rows=50_000)
    t = harness.make_tables(tiny, 2**31 + 23, "cpu")["t"]
    for k in ("id3", "id6"):
        x = t[k]
        assert x.dtype == torch.int64 and x.shape == (50_000,)
        assert 0 <= int(x.min()) and int(x.max()) < 1_000_000
        # drawn over the whole range, not the 1e7 cell's 1e5 codes
        assert int(x.max()) >= 100_000
