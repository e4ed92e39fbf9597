"""BENCHMARK.json against the benchmark's contract, and adding a
configuration, a traffic mix and a per-layer metric by new files and
entries alone."""
import json
import os
import re
import shutil
import subprocess
import sys

from portbench import harness

with open(os.path.join(harness.ROOT, "BENCHMARK.json")) as f:
    BENCH = json.load(f)

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")
KEYS = {"configs": {"name", "source", "file", "reduced", "why"},
        "workloads": {"name", "config", "traffic", "chips", "why"},
        "end_to_end": {"name", "unit", "better", "bound", "source"},
        "per_layer": {"name", "unit", "better", "source", "layer", "moves"}}


def test_keys_names_and_units():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    for group, keys in KEYS.items():
        names = [e["name"] for e in BENCH[group]]
        assert len(names) == len(set(names)), group
        for e in BENCH[group]:
            assert set(e) - {"workloads"} == keys, (group, e["name"])
            assert NAME.match(e["name"]), e["name"]
            for k in ("why", "layer", "source"):
                if k in e:
                    assert TEXT.match(e[k]), (e["name"], k)
            if "unit" in e:
                assert UNIT.match(e["unit"]), e["unit"]
                assert e["better"] in ("lower", "higher")
    for w in BENCH["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4)
    for c in BENCH["configs"]:
        assert all(NAME.match(k) for k in c["reduced"])
    for word in BENCH["command"]:
        assert TEXT.match(word)
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_every_cell_reports_what_the_contract_asks():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        if m["unit"] == "%" and "roofline" in m["name"]:
            assert m["name"].endswith("_roofline")
    for w in BENCH["workloads"]:
        cell = harness.load_cell(w["name"])
        assert {m["name"] for m in cell.end_to_end} >= {"setup_s", "qps"}
        assert cell.per_layer
        for m in cell.end_to_end + cell.per_layer:
            assert os.path.exists(os.path.join(harness.PB, "metrics",
                                               m["name"] + ".py"))


def test_paths_hold_the_command_and_the_configurations():
    assert BENCH["paths"] == ["portbench"]
    assert BENCH["command"][1].startswith("portbench/")
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))
    for c in BENCH["configs"]:
        assert c["file"].startswith("portbench/")
        with open(os.path.join(harness.ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert (cfg["source"], cfg["reduced"]) == (c["source"],
                                                   c["reduced"])
        assert os.path.exists(os.path.join(harness.PB, "data",
                                           cfg["generator"] + ".py"))


DUMMY_METRIC = '''"""dummy_queries (queries): queries completed."""


def read(ctx):
    return float(len(ctx.queries))
'''


def test_new_cell_mix_config_and_metric_take_only_new_files(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(harness.PB, root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(harness.ROOT, "BENCHMARK.json"), root)
    os.symlink(os.path.join(harness.ROOT, "rayforce_tpu_torch"),
               root / "rayforce_tpu_torch")
    before = {p: (root / "portbench" / p).read_bytes() for p in
              os.listdir(root / "portbench") if p.endswith(".py")}
    pb = root / "portbench"
    (pb / "configs" / "dummy_g1.json").write_text(json.dumps({
        "name": "dummy_g1", "source": "https://example.org/dummy",
        "generator": "g1", "chips": 1, "reduced": [], "rows": 3000,
        "tables": {"t": [["k", "int", 0, 7], ["v", "int", 0, 9]]}}))
    (pb / "traffic" / "dummy_mix.json").write_text(json.dumps({
        "why": "one grouped sum", "order": "shuffle",
        "limits": {"exact_mismatches": 0, "f64_rel_err": 1e-10},
        "queries": [{"name": "s", "weight": 1,
                     "text": "(select {s: (sum v) from: t by: k})",
                     "reference": {"kind": "groupby", "table": "t",
                                   "by": ["k"],
                                   "aggs": [["s", "sum", "v"]]}}]}))
    (pb / "metrics" / "dummy_queries.py").write_text(DUMMY_METRIC)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "dummy_g1", "source": "x",
                             "file": "portbench/configs/dummy_g1.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "dummy_g1.mix", "config": "dummy_g1",
                               "traffic": "dummy_mix", "chips": 1,
                               "why": "a test"})
    bench["per_layer"].append({"name": "dummy_queries", "unit": "queries",
                               "better": "higher", "source": "host_clock",
                               "layer": "test", "moves": "qps",
                               "workloads": ["dummy_g1.mix"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    code = """
import json, os, sys, time
sys.path.insert(0, os.getcwd())
os.environ["RAYFORCE_DEVICE"] = "cpu"
from portbench import harness
cell = harness.load_cell("dummy_g1.mix")
out = [harness.run(cell, 4, 0.2, t, "cpu", time.perf_counter())
       for t in (False, True)]
print(json.dumps(out))
"""
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300, cwd=root)
    assert p.returncode == 0, p.stderr[-3000:]
    plain, traced = json.loads(p.stdout.strip().splitlines()[-1])
    assert plain["correct"] and traced["correct"]
    assert set(plain["metrics"]) == {"setup_s", "qps", "p95_ms"}
    assert traced["metrics"]["dummy_queries"]["value"] >= 1
    assert before == {p: (pb / p).read_bytes() for p in before}
