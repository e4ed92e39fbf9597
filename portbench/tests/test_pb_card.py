"""On a CUDA card: a short run of each cell is correct, and at a size a
test can hold the control fails the limits where the program passes.
Each test skips unless a card is present."""
import json
import subprocess
import sys

import pytest

from portbench import compare as cmp
from portbench import control, harness

def _need_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")


@pytest.mark.card
def test_short_run_on_the_card_is_correct(workload):
    _need_card()
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        workload, "--seed", str(2**31 + 77), "--seconds",
                        "2", "--trace", "0"], capture_output=True, text=True,
                       timeout=1200, cwd=harness.ROOT)
    assert p.returncode == 0, p.stderr[-3000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["correct"] and out["device"]["platform"] == "gpu"


@pytest.mark.card
def test_control_fails_on_the_card(mix, tiny_cell):
    _need_card()
    from rayforce_tpu_torch.engine import device as dev
    old = dict(dev._cfg)
    dev.set_device("cuda")
    dev.set_threshold(1)
    try:
        cell = tiny_cell(mix)
        for seed in (41, 42, 43):
            r = cmp.merge(control.control_reading(cell, seed, "cuda")
                          .values())
            p = cmp.merge(control.program_reading(cell, seed, "cuda")
                          .values())
            assert not cmp.passes(r, cell.traffic["limits"]), (seed, r)
            assert cmp.passes(p, cell.traffic["limits"]), (seed, p)
    finally:
        dev._cfg.clear()
        dev._cfg.update(old)
