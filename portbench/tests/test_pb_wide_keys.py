"""The wide key-word kernels' two readers: the calls a query from the
program's counter, the roofline's bytes from a call's shapes, and a
program without the kernels (the entry missing) read as nothing."""
from types import SimpleNamespace

import torch

from portbench import harness


def test_calls_per_query_reads_the_counter():
    m = harness.metric("wide_keys_calls_per_query")
    ctx = harness.Readings(setup_s=1.0, queries=["q7"] * 4,
                           launches={"wide_keys": 12})
    assert m.read(ctx) == 3.0
    ctx.launches = {"radix_sort": 8}      # a program without the kernels
    assert m.read(ctx) is None


def test_roofline_bytes_and_entry(monkeypatch):
    m = harness.metric("wide_keys_roofline")
    assert m.ENTRY == ("rayforce_tpu_torch.engine.wide", "wide_keys_cuda")
    n = 1000
    keys = [torch.zeros(n, dtype=torch.int64),
            torch.zeros(2 * n, dtype=torch.int32)[::2],
            torch.tensor(7, dtype=torch.int64),               # a scalar
            torch.zeros(1, dtype=torch.int16).expand(n)]      # stride 0
    mask = torch.ones(n, dtype=torch.bool)
    words = [torch.zeros(n, dtype=torch.int32) for _ in range(4)]
    assert m.call_bytes("pack", None, keys + [mask], words) == \
        n * 8 + n * 4 + 8 + 2 + n + 4 * n * 4
    outs = [torch.zeros(n, dtype=t) for t in (torch.bool, torch.int32,
                                                  torch.int64, torch.int32)]
    assert m.call_bytes("bound", None, words, outs) == \
        4 * n * 4 + n * (1 + 4 + 8 + 4)
    from rayforce_tpu_torch.engine import wide
    monkeypatch.delattr(wide, "wide_keys_cuda")
    m = harness.metric("wide_keys_roofline")
    assert m.ENTRY is None
    ctx = SimpleNamespace(trace=None, calls={})
    assert m.read(ctx) is None
