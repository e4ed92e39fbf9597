"""The benchmark's own tests, run apart from the repository's:

    python -m pytest portbench/tests -q

Each runs the program on CPU torch (RAYFORCE_DEVICE=cpu, the kernels'
plain versions) at a tiny size, but those marked `card`, which skip
unless a CUDA card is present (decided inside each test)."""
import json
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
    BENCH = json.load(f)
# the mixes the tests run, by cell name
MIXES = {w["name"]: (w["config"], w["traffic"]) for w in BENCH["workloads"]}


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "card: needs a CUDA card; skips without one")


def pytest_generate_tests(metafunc):
    if "mix" in metafunc.fixturenames:
        metafunc.parametrize("mix", sorted(MIXES))
    if "workload" in metafunc.fixturenames:
        metafunc.parametrize("workload",
                             [w["name"] for w in BENCH["workloads"]])


# tiny sizes of each configuration, for runs on the CPU
TINY = {"g1": {"rows": 20_000},
        "taq": {"n": 3_000}}


@pytest.fixture
def tiny_cell():
    """load(name): the cell of MIXES with its configuration cut to a CPU
    test's size."""
    from portbench import harness

    def load(name):
        cell = harness.cell(BENCH, ROOT, name, *MIXES[name])
        cell.config.update(TINY[cell.config["generator"]])
        return cell
    return load


@pytest.fixture
def cpu_engine():
    """The program's device path on CPU torch for every table size."""
    from rayforce_tpu_torch.engine import device as dev
    old = dict(dev._cfg)
    dev.set_device("cpu")
    dev.set_threshold(1)
    yield dev
    dev._cfg.clear()
    dev._cfg.update(old)
