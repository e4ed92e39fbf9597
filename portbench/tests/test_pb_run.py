"""Whole runs on the CPU at a tiny size: a sound run is correct; a run
whose timed path is broken underneath is not, for each fault a cell of
this benchmark can have; the control (the reference in float32 in the
program's place) fails the limits; and a run loads neither JAX nor the
JAX package. (One card: no exchange between chips to leave out.)"""
import json
import os
import subprocess
import sys
import time

import pytest
import torch

from portbench import compare as cmp
from portbench import control, harness

def _run(cell, make_runtime=harness.runtime, trace=False, seed=2**31 + 9):
    return harness.run(cell, seed, 0.3, trace, "cpu", time.perf_counter(),
                       make_runtime)


def test_sound_run_is_correct(mix, cpu_engine, tiny_cell):
    out = _run(tiny_cell(mix))
    assert out["correct"] and out["failed"] == 0 and out["attempted"] > 0
    assert set(out["metrics"]) == {"setup_s", "qps", "p95_ms"}
    assert list(out)[-1] == "checks"


def test_traced_run_reports_its_per_layer_metrics(cpu_engine, tiny_cell):
    out = _run(tiny_cell("g1_1e7_k100.sortagg"), trace=True)
    assert out["correct"]
    # on CPU torch only the host-side readings exist; device ones are
    # left out, never written as 0
    assert set(out["metrics"]) == {"frontend_ms"}
    assert {"busy_s", "window_s", "memory_peak_bytes"} <= set(out["device"])
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}


def _altered(tables):
    """An answer altered where it is produced: one value of each
    result's last typed column moved."""
    from rayforce_tpu_torch.core.obj import DevPending, Obj, table
    rt = harness.runtime(tables)
    real = rt.eval_str

    def eval_str(src):
        res = real(src)
        names, cols = res.v
        cols = list(cols)
        for i in reversed(range(len(cols))):
            c = cols[i]
            p = c.pending()
            x = p.arr if p is not None else c.v
            if isinstance(x, tuple):
                continue
            x = torch.as_tensor(x).clone()
            j = int(torch.nonzero(torch.isfinite(x.double()))[0])
            x[j] = x[j] * (1 + 1e-6) + 1
            cols[i] = Obj(c.t, DevPending(x))
            break
        return table(names, cols)
    rt.eval_str = eval_str
    return rt


def _half_rows(tables):
    """Half of the batch left out: the program answers over the first
    half of each table's rows."""
    return harness.runtime(harness.place_tables({
        name: {col: c.pending().arr[:len(t) // 2]
               for col, c in zip(harness.column_names(t), t.v[1])}
        for name, t in tables.items()}))


def _unchanged(tables):
    """A query that returns its state unchanged: the first table as it
    is, in place of the answer."""
    rt = harness.runtime(tables)
    first = next(iter(tables.values()))
    rt.eval_str = lambda src: first
    return rt


@pytest.mark.parametrize("fault", [_altered, _half_rows, _unchanged])
def test_broken_timed_path_is_not_correct(mix, fault, cpu_engine,
                                          tiny_cell):
    out = _run(tiny_cell(mix), fault)
    assert out["correct"] is False, out["checks"]


def test_control_fails_the_limits(mix, cpu_engine, tiny_cell):
    cell = tiny_cell(mix)
    limits = cell.traffic["limits"]
    for seed in (31, 32, 33):
        r = cmp.merge(control.control_reading(cell, seed, "cpu").values())
        assert not cmp.passes(r, limits), (seed, r)
        p = cmp.merge(control.program_reading(cell, seed, "cpu").values())
        assert cmp.passes(p, limits), (seed, p)


def test_a_run_loads_neither_jax_nor_the_jax_package():
    code = f"""
import os, sys, time, json
sys.path.insert(0, {harness.ROOT!r})
os.environ["RAYFORCE_DEVICE"] = "cpu"
from portbench import harness
from rayforce_tpu_torch.engine import device as dev
dev.set_threshold(1)
cell = harness.load_cell("taq_10m_20m.asof_window")
cell.config.update(n=2000)
out = harness.run(cell, 3, 0.2, True, "cpu", time.perf_counter())
print(json.dumps({{"correct": out["correct"],
                  "tops": sorted({{m.split(".")[0] for m in sys.modules}})}}))
"""
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300, cwd=harness.ROOT)
    assert p.returncode == 0, p.stderr[-3000:]
    got = json.loads(p.stdout.strip().splitlines()[-1])
    assert got["correct"]
    assert not {"jax", "jaxlib", "flax", "rayforce_tpu"} & set(got["tops"])
    assert "rayforce_tpu_torch" in got["tops"]


def test_a_reference_that_loads_jax_leaves_no_result(tmp_path):
    """The check for JAX comes after the references: a reference kind
    that imports a module named `jax` ends the run without a result."""
    import shutil
    root = tmp_path / "checkout"
    shutil.copytree(harness.PB, root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(harness.ROOT, "BENCHMARK.json"), root)
    os.symlink(os.path.join(harness.ROOT, "rayforce_tpu_torch"),
               root / "rayforce_tpu_torch")
    (root / "stubs" / "jax").mkdir(parents=True)
    (root / "stubs" / "jax" / "__init__.py").write_text("")
    (root / "portbench" / "reference" / "jaxlike.py").write_text(
        "import jax  # noqa: F401\nfrom .groupby import run  # noqa: F401\n")
    mix = root / "portbench" / "traffic" / "g1_wide.json"
    t = json.loads(mix.read_text())
    for q in t["queries"]:
        q["reference"]["kind"] = "jaxlike"
    mix.write_text(json.dumps(t))
    code = """
import json, os, sys, time
sys.path[:0] = [os.getcwd(), os.path.join(os.getcwd(), "stubs")]
from portbench import harness
from rayforce_tpu_torch.engine import device as dev
dev.set_threshold(1)
cell = harness.load_cell("g1_1e7_k100.wide")
cell.config.update(rows=3000)
print(json.dumps(harness.run(cell, 5, 0.2, False, "cpu",
                             time.perf_counter())))
"""
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300, cwd=root,
                       env=dict(os.environ, RAYFORCE_DEVICE="cpu"))
    assert p.returncode != 0 and p.stdout.strip() == "", p.stdout[-2000:]
    assert "['jax']" in p.stderr, p.stderr[-2000:]


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "rayforce_tpu_torch_x", sys)
    assert "rayforce_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "rayforce_tpu.engine", sys)
    assert harness.forbidden_modules() == ["rayforce_tpu"]


def test_run_without_a_card_prints_no_result():
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        "g1_1e7_k100.wide", "--seed", "1", "--seconds",
                        "1", "--trace", "0"], capture_output=True,
                       text=True, timeout=300, cwd=harness.ROOT)
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert p.returncode != 0 and p.stdout.strip() == ""
