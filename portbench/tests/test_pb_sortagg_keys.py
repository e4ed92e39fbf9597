"""The reader of sortagg_keys_calls_per_query: the sort-agg engine's main
sort word kernels' launches a query; nothing where none launched (a
program without the kernels, or CPU torch), and the metric reported in
the two sort-agg cells alone."""
import json
import os

from portbench import harness

NAME = "sortagg_keys_calls_per_query"
CELLS = ("g1_1e7_k100.sortagg", "g1_1e8_k100.sortagg")


def test_keys_calls_per_query_reads_the_counter():
    m = harness.metric(NAME)
    ctx = harness.Readings(setup_s=1.0, queries=["q2", "q3", "q5", "q6"],
                           launches={"radix_sort": 13, "sortagg_keys": 8})
    assert m.read(ctx) == 2.0
    # no launch (CPU torch runs the plain version), or a program
    # without the counter
    ctx.launches = {"radix_sort": 13, "sortagg_keys": 0}
    assert m.read(ctx) is None
    ctx.launches = {"radix_sort": 13}
    assert m.read(ctx) is None


def test_only_the_sortagg_cells_report_the_keys_calls():
    with open(os.path.join(harness.ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    for w in bench["workloads"]:
        names = {m["name"] for m in harness.load_cell(w["name"]).per_layer}
        assert (NAME in names) == (w["name"] in CELLS), w["name"]
