"""Every oracle golden (tests/golden/*.json) through the PyTorch port's
Runtime, exactly as tests/golden_util.py runs them for the JAX package:
the check that the port's copy of the host layer is faithful.

Case statements that write scratch files under /tmp are pointed at a
per-test directory instead, so that this file never races the JAX
package's golden tests on the same paths when the suite runs in
parallel workers. Symbol ids are dense in intern order and symbols
compare by id, so each case starts from the symbol table of a fresh
process, as the oracle recorded it."""
import glob
import json
import os

import pytest
import torch

from rayforce_tpu_torch import Runtime
from rayforce_tpu_torch.core import symbols
from rayforce_tpu_torch.core.errors import RayError, err_msg
from rayforce_tpu_torch.engine import device as dev

torch.set_num_threads(1)

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")


def _cases():
    out = []
    for path in sorted(glob.glob(os.path.join(GOLDEN_DIR, "*.json"))):
        suite = os.path.basename(path)[:-5]
        with open(path) as f:
            golden = json.load(f)
        out += [(f"{suite}::{k}", v["stmts"], v["expect"])
                for k, v in golden.items()]
    return out


CASES = _cases()


@pytest.fixture(autouse=True, scope="module")
def _cpu_engine():
    saved = dict(dev._cfg)
    dev.set_device("cpu")
    yield
    dev._cfg.clear()
    dev._cfg.update(saved)


@pytest.fixture(scope="module")
def _base_symbols():
    Runtime()                  # interns every builtin's name
    return symbols.count()


@pytest.fixture(autouse=True)
def _fresh_symbols(_base_symbols):
    yield
    for name in symbols._by_id[_base_symbols:]:
        del symbols._by_name[name]
    del symbols._by_id[_base_symbols:]


@pytest.mark.parametrize("name,stmts,expect", CASES,
                         ids=[c[0] for c in CASES])
def test_golden(name, stmts, expect, tmp_path):
    rt = Runtime()
    try:
        result = None
        for s in stmts:
            result = rt.eval_str(s.replace("/tmp/", f"{tmp_path}/"))
        got = rt.format_result(result)
    except RayError as e:
        got = "ERROR:" + err_msg(e)
    assert got == expect, f"got {got!r}, want {expect!r}"
