"""The plain references: against the program on CPU torch for every
query of every mix, and against plain Python loops on small tables; and
that they import nothing of the program, JAX or the JAX package."""
import ast
import math
import os

import pytest
import torch

from portbench import compare as cmp
from portbench import control, harness
from portbench.reference import asof_join, groupby, window_join

@pytest.mark.parametrize("seed", [1, 2**31 + 3])
def test_reference_agrees_with_the_program(mix, seed, cpu_engine,
                                           tiny_cell):
    cell = tiny_cell(mix)
    per_query = control.program_reading(cell, seed, "cpu")
    assert set(per_query) == {q["name"] for q in cell.traffic["queries"]}
    for name, r in per_query.items():
        assert cmp.passes(r, cell.traffic["limits"]), (name, r)


def test_reference_imports_nothing_of_the_program():
    ref_dir = os.path.join(harness.PB, "reference")
    for fname in os.listdir(ref_dir):
        if not fname.endswith(".py"):
            continue
        with open(os.path.join(ref_dir, fname)) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                tops = [a.name.split(".")[0] for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                tops = [(node.module or "").split(".")[0]] if \
                    not node.level else []
            else:
                continue
            assert not set(tops) & {"jax", "jaxlib", "flax", "rayforce_tpu",
                                    "rayforce_tpu_torch"}, (fname, tops)


def _rand_table(gen, n, cols):
    return {c: torch.randint(lo, hi, (n,), generator=gen)
            for c, (lo, hi) in cols.items()}


def test_groupby_against_a_loop():
    gen = torch.Generator().manual_seed(4)
    t = _rand_table(gen, 500, {"a": (0, 7), "b": (-3, 3), "v": (-50, 50)})
    t["f"] = torch.rand(500, generator=gen, dtype=torch.float64)
    spec = {"table": "t", "by": ["a", "b"],
            "aggs": [["s", "sum", "v"], ["c", "count", "v"],
                     ["mx", "max", "v"], ["mn", "min", "f"],
                     ["av", "avg", "f"], ["sf", "sum", "f"]]}
    got = groupby.run({"t": t}, spec)
    groups = {}
    for i in range(500):
        groups.setdefault((int(t["a"][i]), int(t["b"][i])), []).append(i)
    keys = list(groups)                     # first-appearance order
    want = {"a": [k[0] for k in keys], "b": [k[1] for k in keys],
            "s": [sum(int(t["v"][i]) for i in g) for g in groups.values()],
            "c": [len(g) for g in groups.values()],
            "mx": [max(int(t["v"][i]) for i in g) for g in groups.values()],
            "mn": [min(float(t["f"][i]) for i in g) for g in groups.values()],
            "av": [math.fsum(float(t["f"][i]) for i in g) / len(g)
                   for g in groups.values()],
            "sf": [math.fsum(float(t["f"][i]) for i in g)
                   for g in groups.values()]}
    assert [c[0] for c in got] == list(want)
    for name, val, kind in got:
        assert kind == ("float" if name in ("av", "sf") else "exact")
        if kind == "exact":
            assert val.tolist() == want[name], name
        else:
            assert val.tolist() == pytest.approx(want[name], rel=1e-13)


def _trades_quotes(gen, nt=300, nq=700, syms=5, span=5000):
    def side(n, extra):
        d = {"sym": torch.randint(0, syms, (n,), generator=gen),
             "ts": torch.randint(0, span, (n,), generator=gen).sort().values}
        d.update({c: torch.randint(1, 100, (n,), generator=gen)
                  .to(torch.float64) for c in extra})
        return d
    return side(nt, ["price"]), side(nq, ["bid", "ask"])


def test_asof_against_a_loop():
    gen = torch.Generator().manual_seed(5)
    tr, q = _trades_quotes(gen)
    got = {c[0]: c[1] for c in asof_join.run(
        {"trades": tr, "quotes": q},
        {"left": "trades", "right": "quotes", "keys": ["sym", "ts"]})}
    assert list(got) == ["sym", "ts", "price", "bid", "ask"]
    for i in range(300):
        cand = [j for j in range(700) if int(q["sym"][j]) ==
                int(tr["sym"][i]) and int(q["ts"][j]) <= int(tr["ts"][i])]
        vals, hit = got["bid"]
        assert bool(hit[i]) == bool(cand), i
        if cand:
            assert float(vals[i]) == float(q["bid"][cand[-1]])
            assert float(got["ask"][0][i]) == float(q["ask"][cand[-1]])


def test_window_join1_against_a_loop():
    gen = torch.Generator().manual_seed(6)
    tr, q = _trades_quotes(gen)
    spec = {"left": "trades", "right": "quotes", "keys": ["sym", "ts"],
            "window": [-200, 300], "prevailing": False,
            "aggs": [["mx", "max", "ask"], ["mn", "min", "bid"]]}
    got = {c[0]: c[1] for c in window_join.run(
        {"trades": tr, "quotes": q}, spec)}
    assert list(got) == ["sym", "ts", "price", "mx", "mn"]
    for i in range(300):
        t = int(tr["ts"][i])
        w = [j for j in range(700) if int(q["sym"][j]) == int(tr["sym"][i])
             and t - 200 <= int(q["ts"][j]) <= t + 300]
        if not w:
            assert math.isnan(got["mx"][i]) and math.isnan(got["mn"][i])
        else:
            assert float(got["mx"][i]) == max(float(q["ask"][j]) for j in w)
            assert float(got["mn"][i]) == min(float(q["bid"][j]) for j in w)


def test_compare_counts_what_differs():
    a = torch.tensor([1, 2, 3])
    f = torch.tensor([1.0, float("nan"), 3.0], dtype=torch.float64)
    ref = [("k", a, "exact"), ("x", f, "exact"), ("s", f * 2, "float"),
           ("m", (a, torch.tensor([True, False, True])), "exact")]
    same = [(n, v) for n, v, _k in ref]
    assert cmp.compare(same, ref) == {"exact_mismatches": 0,
                                      "f64_rel_err": 0.0}
    off = [("k", torch.tensor([1, 2, 4])), ("x", f),
           ("s", f * 2 * (1 + 1e-9)),
           ("m", (torch.tensor([1, 9, 0]), torch.tensor([True, False, True])))]
    r = cmp.compare(off, ref)
    assert r["exact_mismatches"] == 2
    assert r["f64_rel_err"] == pytest.approx(1e-9, rel=1e-3)
    assert cmp.compare([("k", a.numpy())], ref[:1])["exact_mismatches"] == 0
    assert cmp.compare([("q", a)], ref[:1])["exact_mismatches"] == 3
    assert cmp.compare([("k", a.double())], ref[:1])["exact_mismatches"] == 3
    assert cmp.compare(same[:2], ref)["exact_mismatches"] == 2
