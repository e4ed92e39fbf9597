"""The sort-agg engine's two plans on db-benchmark G1's queries, each
picked by the head rule itself (`engine/sortagg.py` build_plan: the
head plan when NC (ln NC + 6) <= HEAD_M, else the exact plan with its
i64 code|position|packed key), as the 1e8-row benchmark cell
`g1_1e8_k100.sortagg` runs them: q2 (1e4 codes) on the head plan, q3,
q5 and q6 on the exact one.

G1's columns at 2e5 rows, with id3 and id6 at N/K for K = 10 (2e4
codes), and HEAD_M shrunk to 160 000 in both packages: then q2's need
is 1.52e5 and q3's 3.18e5, as at 1e8 rows HEAD_M = 2^21 sits between
q2's 1.5e5 and q3's 2.0e7. Each query is the mix's own
(`portbench/traffic/g1_sortagg.json`): the port's answer on its device
path (CPU torch) is the JAX package's byte for byte, and the plain
torch reference's (`portbench/reference/groupby.py`) within the mix's
limits under `portbench/compare.py`; an exact answer moves
`psort.LAUNCHES["sortagg_exact"]` by one, a head answer not at all."""
import json
import os

import numpy as np
import pytest
import torch

from portbench import compare as pcmp
from portbench.reference import groupby
from rayforce_tpu.engine import device as rdev
from rayforce_tpu.engine import sortagg as rsa
from rayforce_tpu_torch.core import symbols
from rayforce_tpu_torch.engine import device as dev
from rayforce_tpu_torch.engine import psort
from rayforce_tpu_torch.engine import select as sel
from rayforce_tpu_torch.engine import sortagg
from test_torch_sortagg import _check, _runtimes

torch.set_num_threads(1)

with open(os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "portbench", "traffic",
        "g1_sortagg.json")) as f:
    MIX = json.load(f)
QUERIES = {q["name"]: q for q in MIX["queries"]}

N = 200_000
HEAD_M = 160_000
G1 = [("id1", 0, 100), ("id2", 0, 100), ("id3", 0, N // 10),
      ("id4", 0, 100), ("id5", 0, 100), ("id6", 0, N // 10),
      ("v1", 1, 6), ("v2", 1, 16), ("v3", 0.0, 100.0)]


@pytest.fixture(scope="module")
def g1():
    """(JAX runtime, port runtime, the columns as tensors), both device
    paths on for every table size and HEAD_M shrunk in both packages
    while the module runs."""
    rsaved, saved = dict(rdev._cfg), dict(dev._cfg)
    old = (sortagg.HEAD_M, rsa.HEAD_M)
    rdev.set_enabled(True)
    rdev.set_threshold(1)
    dev.set_device("cpu")
    dev.set_threshold(1)
    sortagg.HEAD_M = rsa.HEAD_M = HEAD_M
    rng = np.random.default_rng(1_000_003)
    cols = {}
    for name, lo, hi in G1:
        if isinstance(lo, float):
            cols[name] = np.round(rng.uniform(lo, hi, N), 6)
        else:
            cols[name] = rng.integers(lo, hi, N).astype(np.int64)
    rrt, prt = _runtimes({name: (a, "F64" if a.dtype == np.float64
                                 else "I64") for name, a in cols.items()})
    yield rrt, prt, {"t": {k: torch.from_numpy(a) for k, a in cols.items()}}
    sortagg.HEAD_M, rsa.HEAD_M = old
    rdev._cfg.clear()
    rdev._cfg.update(rsaved)
    dev._cfg.clear()
    dev._cfg.update(saved)


@pytest.mark.parametrize("name", sorted(QUERIES))
def test_head_rule_picks_the_plan_and_both_plans_answer(g1, name):
    rrt, prt, tensors = g1
    q = QUERIES[name]
    exact = name != "q2"
    before = psort.LAUNCHES["sortagg_exact"]
    sel.last_profile.clear()
    res = prt.eval_str(q["text"])
    assert sel.last_profile["engine"] == "sortagg"
    assert sel.last_profile["exact"] is exact
    assert psort.LAUNCHES["sortagg_exact"] == before + exact
    got = [(symbols.name_of(int(s)), c.pending().arr
            if c.pending() is not None else c.v)
           for s, c in zip(res.v[0].v, res.v[1])]
    r = pcmp.compare(got, groupby.run(tensors, q["reference"]))
    assert pcmp.passes(r, MIX["limits"]), (name, r)
    _check(rrt, prt, q["text"])
