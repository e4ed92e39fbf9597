"""The port's wide-code engine (rayforce_tpu_torch/engine/wide.py, more
than `dense_max` key codes) held against the JAX package's: the same
seeded numpy columns go into both packages' tables, and each query's
formatted output must match byte for byte — reference device, port
device and port host — with both packages on the wide engine. The port
runs its device path on CPU torch, where both of wide's sorts (the
multi-word key sort and the order carry-sort) are the plain version of
the CUDA radix sort."""
import numpy as np
import pytest
import torch

from rayforce_tpu.engine import device as rdev
from rayforce_tpu.engine import select as rsel
from rayforce_tpu_torch.core import types as T
from rayforce_tpu_torch.engine import device as dev
from rayforce_tpu_torch.engine import psort
from rayforce_tpu_torch.engine import select as sel
from test_torch_dense import _check
from test_torch_sortagg import _runtimes

torch.set_num_threads(1)


@pytest.fixture(autouse=True, scope="module")
def _engines():
    rsaved, saved = dict(rdev._cfg), dict(dev._cfg)
    rdev.set_enabled(True)
    rdev.set_threshold(1)
    dev.set_device("cpu")
    dev.set_threshold(1)
    yield
    rdev._cfg.clear()
    rdev._cfg.update(rsaved)
    dev._cfg.clear()
    dev._cfg.update(saved)


def _wide(rrt, prt, q):
    assert _check(rrt, prt, q, engine="wide") == "wide"


# tests/test_wide.py, through both packages

def test_wide_two_keys():
    rng = np.random.default_rng(21)
    n = 30000
    k1 = rng.integers(0, 2000, n).astype(np.int64)
    k2 = rng.integers(0, 1000, n).astype(np.int64)
    v1 = rng.integers(-50, 50, n).astype(np.int64)
    v1[rng.integers(0, n, 200)] = T.NULL_I64
    v3 = rng.uniform(-10, 10, n)
    v3[rng.integers(0, n, 200)] = np.nan
    rrt, prt = _runtimes({"k1": (k1, "I64"), "k2": (k2, "I64"),
                          "v1": (v1, "I64"), "v3": (v3, "F64")})
    for q in [
        "(select {s: (sum v1) c: (count v1) from: t by: {k1: k1 k2: k2}})",
        "(select {a: (avg v3) mx: (max v1) from: t by: {k1: k1 k2: k2}})",
        "(select {mn: (min v3) from: t by: {k1: k1 k2: k2} "
        "where: (> v1 0)})",
        "(select {f: (first v3) l: (last v1) from: t by: {k1: k1 k2: k2}})",
    ]:
        _wide(rrt, prt, q)


def test_wide_multiword_keys():
    """Key ranges whose packed width exceeds one 61-bit word."""
    rng = np.random.default_rng(5)
    n = 20000
    k1 = rng.integers(0, 1 << 20, n).astype(np.int64) << 15
    k2 = rng.integers(0, 1 << 20, n).astype(np.int64) << 20
    k3 = rng.integers(0, 500, n).astype(np.int64)
    v = rng.uniform(0, 100, n)
    rrt, prt = _runtimes({"k1": (k1, "I64"), "k2": (k2, "I64"),
                          "k3": (k3, "I64"), "v": (v, "F64")})
    _wide(rrt, prt, "(select {s: (sum v) c: (count v) from: t "
                    "by: {k1: k1 k2: k2 k3: k3}})")


def test_wide_all_rows_distinct():
    rng = np.random.default_rng(9)
    n = 20000
    k = rng.permutation(np.arange(3_000_000, dtype=np.int64))[:n]
    v = rng.integers(0, 100, n).astype(np.int64)
    rrt, prt = _runtimes({"k": (k, "I64"), "v": (v, "I64")})
    _wide(rrt, prt, "(select {s: (sum v) from: t by: k})")


def test_wide_engine_matches_host():
    """tests/test_device_parity.py's table and query with dense_max
    forced to 512 in both packages, so 7 x 1200 codes go wide."""
    rng = np.random.default_rng(42)
    N = 4000
    id1 = rng.integers(0, 7, N).astype(np.int64)
    id3 = rng.integers(0, 1200, N).astype(np.int64)
    v1 = rng.integers(-3, 6, N).astype(np.int64)
    v1[rng.integers(0, N, 40)] = T.NULL_I64
    v2 = rng.integers(0, 100, N).astype(np.int32)
    v3 = rng.uniform(-50, 100, N)
    v3[rng.integers(0, N, 40)] = np.nan
    rrt, prt = _runtimes({"id1": (id1, "I64"), "id3": (id3, "I64"),
                          "v1": (v1, "I64"), "v2": (v2, "I32"),
                          "v3": (v3, "F64")})
    old = (rdev._cfg["dense_max"], dev._cfg["dense_max"])
    rdev._cfg["dense_max"] = dev._cfg["dense_max"] = 512
    try:
        _wide(rrt, prt, "(select {s: (sum v3) c: (count v1) from: t by: "
                        "{id1: id1 id3: id3}})")
    finally:
        rdev._cfg["dense_max"], dev._cfg["dense_max"] = old


Q7 = ("(select {s: (sum v3) c: (count v3) from: t by: "
      "{id1: id1 id2: id2 id3: id3 id4: id4 id5: id5 id6: id6}})")


def test_q7_on_g1_key_ranges():
    """bench.py q7 on a 20 000-row table with G1's key ranges and its
    6-decimal v3, so the key words are laid out as on the 1e7-row table:
    id1, id2, id3, id4, id5 (45 bits) in word 0 under the trash bit,
    id6 and the row position in word 1 — 4 i32 key words in the sort."""
    rng = np.random.default_rng(2024)
    n = 20_000
    cols = {}
    for nm, hi in (("id1", 100), ("id2", 100), ("id3", 100_000),
                   ("id4", 100), ("id5", 100), ("id6", 100_000)):
        cols[nm] = (rng.integers(0, hi, n).astype(np.int64), "I64")
    cols["v1"] = (rng.integers(1, 6, n).astype(np.int64), "I64")
    cols["v3"] = (np.round(rng.uniform(0, 100, n), 6), "F64")
    rrt, prt = _runtimes(cols)
    calls = []
    plain = psort.sort_i32_plain

    def counting(words, n_keys=1, perm=False):
        calls.append((n_keys, len(words)))
        return plain(words, n_keys, perm=perm)

    psort.sort_i32_plain = counting
    try:
        sel.last_profile.clear()
        _wide(rrt, prt, Q7)
    finally:
        psort.sort_i32_plain = plain
    assert rsel.last_profile["engine"] == sel.last_profile["engine"] == "wide"
    # the key sort: 4 key words + v3 as one q32 word; the carry sort:
    # fkey + 4 code words + s (f64, 2 words) + c (i32)
    assert calls == [(4, 5), (1, 8)]
