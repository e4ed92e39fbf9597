"""The generators: the same seed gives the same tables, another seed
others, within the configuration's ranges."""
import json
import os

import pytest
import torch

from portbench import harness

CONFIGS = os.path.join(harness.PB, "configs")
TINY = {"g1": {"rows": 5_000},
        "taq": {"n": 2_000}}


def _config(name):
    with open(os.path.join(CONFIGS, name)) as f:
        cfg = json.load(f)
    cfg.update(TINY[cfg["generator"]])
    return cfg


@pytest.mark.parametrize("name", sorted(os.listdir(CONFIGS)))
def test_generator_repeats_from_a_seed(name):
    cfg = _config(name)
    seed = 2**31 + 17
    a, b = (harness.make_tables(cfg, seed, "cpu") for _ in range(2))
    c = harness.make_tables(cfg, seed + 1, "cpu")
    assert a.keys() == b.keys() == c.keys()
    for t in a:
        assert list(a[t]) == list(b[t])
        for col in a[t]:
            assert torch.equal(a[t][col], b[t][col]), (t, col)
    assert any(not torch.equal(a[t][col], c[t][col]) for t in a for col in a[t])


def test_g1_ranges():
    cfg = _config("g1_1e7_k100.json")
    t = harness.make_tables(cfg, 3, "cpu")["t"]
    for name, kind, lo, hi, *rest in cfg["tables"]["t"]:
        x = t[name]
        assert x.shape == (cfg["rows"],)
        assert x.dtype == (torch.int64 if kind == "int" else torch.float64)
        assert lo <= float(x.min()) and float(x.max()) <= hi
        if rest:
            assert torch.equal(torch.round(x * 10 ** rest[0]) /
                               10 ** rest[0], x)


def test_taq_is_the_sources_layout():
    """Keys and times as examples/wj.rfl and aj.rfl make them; values in
    the sources' ranges on the tick; every seed the same keys and times."""
    cfg = _config("taq_10m_20m.json")
    n = cfg["n"]
    a, b = (harness.make_tables(cfg, s, "cpu") for s in (5, 2**31 + 5))
    i = torch.arange(2 * n)
    wt, wq, at, aq = (a[t] for t in ("wtrades", "wquotes", "atrades",
                                     "aquotes"))
    assert list(wt) == ["Sym", "Ts"] and list(wq) == ["Sym", "Ts", "Bid",
                                                      "Ask"]
    assert list(at) == ["Sym", "Ts", "Px"] and list(aq) == ["Sym", "Ts",
                                                             "Bid"]
    assert wt["Sym"].tolist() == [0, 1] * (n // 2)
    assert torch.equal(wt["Ts"], 34_200_000 + 5 * i[:n])
    assert torch.equal(wq["Sym"], i % 3)
    assert torch.equal(wq["Ts"], 34_198_000 + 2 * i)
    assert at["Sym"].tolist()[:20] == [0] * 9 + [1] + [0] * 9 + [1]
    assert torch.equal(at["Ts"], 34_200_000 + 7 * i[:n])
    assert torch.equal(aq["Ts"], 34_199_000 + 3 * i)
    for t, (lo, hi) in (("wquotes", (90, 100)), ("wquotes", (110, 120)),
                        ("atrades", (100, 109)), ("aquotes", (99, 106))):
        col = {"wquotes": "Bid" if lo == 90 else "Ask", "atrades": "Px",
               "aquotes": "Bid"}[t]
        x = a[t][col]
        assert x.dtype == torch.float64
        assert lo <= float(x.min()) and float(x.max()) < hi
        assert torch.equal(torch.round(x * 100) / 100, x)
    for t in a:
        for k in ("Sym", "Ts"):
            assert torch.equal(a[t][k], b[t][k])
