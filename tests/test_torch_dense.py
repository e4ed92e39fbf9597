"""The port's dense plan (<=512 key codes and selects with no `by`,
rayforce_tpu_torch/engine/select.py) held against the JAX package's: the
same seeded numpy columns go into both packages' tables, and each query's
formatted output must match byte for byte — reference device, port
device and port host. The port runs its device path on CPU torch
(`set_device("cpu")`), where every sort is the plain version of the CUDA
radix sort; the reference runs on JAX CPU with its device path forced on,
as tests/test_device_parity.py runs it. Each query must take the same
engine in both packages (the dense plan, sort-agg, or the host)."""
import random

import numpy as np
import pytest
import torch

from rayforce_tpu.core import types as RT
from rayforce_tpu.core.fmt import format_top as ref_fmt
from rayforce_tpu.engine import device as rdev
from rayforce_tpu.engine import select as rsel
from rayforce_tpu_torch.core import types as T
from rayforce_tpu_torch.core.fmt import format_top as fmt
from rayforce_tpu_torch.engine import device as dev
from rayforce_tpu_torch.engine import psort
from rayforce_tpu_torch.engine import select as sel
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


def _engine(prof):
    """Which engine answered the last query: "dense" (the dense plan),
    "sortagg" / "wide", or "host" when the device path declined it."""
    if "dispatch_ms" in prof:
        return "dense"
    return prof.get("engine", "host")


def _check(rrt, prt, q, engine=None):
    """Reference device == port device == port host, formatted; both
    packages took the same engine (`engine`, when given)."""
    rdev.set_enabled(True)
    rsel.last_profile.clear()
    r = ref_fmt(rrt.eval_str(q))
    sel.last_profile.clear()
    dev.set_enabled(True)
    p = fmt(prt.eval_str(q))
    got = _engine(sel.last_profile)
    assert got == _engine(rsel.last_profile), q
    if engine is not None:
        assert got == engine, q
    dev.set_enabled(False)
    try:
        h = fmt(prt.eval_str(q))
    finally:
        dev.set_enabled(True)
    assert p == r, f"{q}\nPORT:\n{p}\nREFERENCE:\n{r}"
    assert p == h, f"{q}\nPORT DEVICE:\n{p}\nPORT HOST:\n{h}"
    return got


@pytest.fixture(scope="module")
def parity():
    """tests/test_device_parity.py's table."""
    rng = np.random.default_rng(42)
    N = 4000
    id1 = rng.integers(0, 7, N).astype(np.int64)
    id3 = rng.integers(0, 1200, N).astype(np.int64)
    v1 = rng.integers(-3, 6, N).astype(np.int64)
    v1[rng.integers(0, N, 40)] = T.NULL_I64
    v2 = rng.integers(0, 100, N).astype(np.int32)
    v3 = rng.uniform(-50, 100, N)
    v3[rng.integers(0, N, 40)] = np.nan
    big = rng.integers(-2**62, 2**62, N).astype(np.int64)
    return _runtimes({"id1": (id1, "I64"), "id3": (id3, "I64"),
                      "v1": (v1, "I64"), "v2": (v2, "I32"),
                      "v3": (v3, "F64"), "big": (big, "I64")})


# tests/test_device_parity.py QUERIES on the dense plan (<=512 codes and
# no by), plus the other lanes of the plan: where, first/last, min/max of
# a derived expression, med of an integer column, full-width sums
DENSE = [
    "(select {s: (sum v1) c: (count v1) from: t by: id1})",
    "(select {a: (avg v3) s: (sum v3) from: t by: id1})",
    "(select {mx: (max v1) mn: (min v3) from: t by: id1})",
    "(select {f: (first v2) l: (last v2) from: t by: id1})",
    "(select {s: (sum v1) a: (avg v3) from: t})",
    "(select {m1: (med v2) m2: (med v3) from: t by: id1})",
    "(select {m: (med v1) c: (count v1) from: t by: id1 "
    "where: (> v2 20)})",
    "(select {mx: (max (+ v1 v2)) mn: (min (* v3 2.0)) from: t by: id1})",
    "(select {s: (sum big) a: (avg big) mx: (max big) from: t by: id1})",
    "(select {s: (sum (+ v1 v2)) from: t by: id1 where: (< v3 0.0)})",
    "(select {mn: (min v1) mx: (max v3) m: (med v3) f: (first v3) "
    "from: t})",
    "(select {s: (sum v2) from: t by: {id1: id1 r: (% v2 7)}})",
]


@pytest.mark.parametrize("q", DENSE)
def test_dense_queries_match_reference(parity, q):
    _check(*parity, q, engine="dense")


def test_dense_sorts_through_the_psort_entry(parity):
    """med and the first-appearance order sort through the psort entry
    (on the card: the CUDA radix sort)."""
    psort.LAUNCHES["radix_sort"] = 0
    calls = []
    plain = psort.sort_i32_plain

    def counting(words, n_keys=1, perm=False):
        calls.append(n_keys)
        return plain(words, n_keys, perm=perm)

    psort.sort_i32_plain = counting
    try:
        _check(*parity, DENSE[5], engine="dense")
    finally:
        psort.sort_i32_plain = plain
    # two med (code, value) sorts: i32 code + i32 key, i32 code + f64
    # key as two words; the order sort: first-row ids as one i32 word
    # (the permutation comes back from the sort); no f64 sum lane, so no
    # code sort for one
    assert sorted(calls) == [1, 2, 3]


def test_full_width_sum_wraps_and_avg_is_exact():
    """Full-range i64 group sums past 2^63: the dense plan recombines
    the limb sums on the host (self_recombine). sum wraps to i64; avg
    divides the exact total."""
    rng = np.random.default_rng(31)
    n = 4000
    big = rng.integers(-2**62, 2**62, n).astype(np.int64)
    big[: n // 2] = rng.integers(2**62 - 2**40, 2**62, n // 2)
    big[::97] = T.NULL_I64
    id1 = rng.integers(0, 7, n).astype(np.int64)
    rrt, prt = _runtimes({"id1": (id1, "I64"), "big": (big, "I64")})
    q = "(select {s: (sum big) a: (avg big) from: t by: id1})"
    assert _check(rrt, prt, q, engine="dense") == "dense"
    # some group's true sum lies beyond the i64 range
    ok = big != T.NULL_I64
    sums = [sum(int(x) for x in big[ok & (id1 == g)]) for g in range(7)]
    assert max(abs(s) for s in sums) >= 2**63
    q = "(select {s: (sum big) a: (avg big) from: t})"
    _check(rrt, prt, q, engine="dense")


def test_null_group_keys_run_on_the_host(parity):
    """A key column with nulls: the host path groups the nulls as one
    key. The reference's dense codes wrap them (its device result
    differs from its host path); the port declines the plan instead,
    so its result is the host's."""
    _rrt, prt = parity
    q = "(select {s: (sum v2) from: t by: {id1: id1 v1: v1}})"
    sel.last_profile.clear()
    p = fmt(prt.eval_str(q))
    assert _engine(sel.last_profile) == "host"
    dev.set_enabled(False)
    try:
        assert p == fmt(prt.eval_str(q))
    finally:
        dev.set_enabled(True)


AGGS = ["sum", "avg", "min", "max", "count", "first", "last", "med"]
VCOLS = ["v1", "v2", "v3", "v4"]
KCOLS = ["k1", "k2", "k3"]


def _fuzz_table(rng, n):
    """tests/test_device_fuzz.py's table, drawn in its order."""
    k1 = rng.integers(0, 6, n).astype(np.int64)
    k2 = rng.integers(-3, 4, n).astype(np.int64)
    k3 = rng.integers(0, 900, n).astype(np.int64)
    v1 = rng.integers(-50, 50, n).astype(np.int64)
    v1[rng.integers(0, n, max(n // 50, 1))] = RT.NULL_I64
    v2 = rng.integers(0, 1000, n).astype(np.int32)
    v3 = rng.uniform(-100, 100, n)
    v3[rng.integers(0, n, max(n // 50, 1))] = np.nan
    v4 = rng.integers(0, 2, n).astype(np.int8)
    return _runtimes({"k1": (k1, "I64"), "k2": (k2, "I64"),
                      "k3": (k3, "I64"), "v1": (v1, "I64"),
                      "v2": (v2, "I32"), "v3": (v3, "F64"),
                      "v4": (v4, "B8")})


def _fuzz_query(rnd):
    """tests/test_device_fuzz.py's query generator."""
    outs = []
    for i in range(rnd.randint(1, 3)):
        agg = rnd.choice(AGGS)
        col = rnd.choice(VCOLS if agg != "count" else VCOLS)
        if agg in ("sum", "avg", "med") and col == "v4":
            col = "v1"
        if agg in ("sum", "avg", "min", "max") and col != "v4" \
                and rnd.random() < 0.3:
            other = rnd.choice(["v1", "v2"])
            op = rnd.choice(["+", "-", "*"])
            outs.append(f"o{i}: ({agg} ({op} {col} {other}))")
            continue
        outs.append(f"o{i}: ({agg} {col})")
    nkeys = rnd.randint(0, 2)
    by = ""
    if nkeys == 1:
        by = f" by: {rnd.choice(KCOLS)}"
    elif nkeys == 2:
        ks = rnd.sample(KCOLS, 2)
        by = " by: {" + " ".join(f"{k}: {k}" for k in ks) + "}"
    where = ""
    if rnd.random() < 0.6:
        preds = []
        for _ in range(rnd.randint(1, 2)):
            c = rnd.choice(VCOLS[:3])
            op = rnd.choice([">", "<", ">=", "<=", "!="])
            preds.append(f"({op} {c} {rnd.randint(-40, 40)})")
        if len(preds) == 1:
            where = f" where: {preds[0]}"
        else:
            j = rnd.choice(["and", "or"])
            where = f" where: ({j} {preds[0]} {preds[1]})"
    return "(select {" + " ".join(outs) + " from: t" + by + where + "})"


def _fuzz(seed, sizes):
    rng = np.random.default_rng(seed)
    rnd = random.Random(seed)
    rrt, prt = _fuzz_table(rng, rnd.choice(sizes))
    for _ in range(8):
        _check(rrt, prt, _fuzz_query(rnd))


# tests/test_device_fuzz.py's seeds: test_fuzz_select (100-105) and
# test_fuzz_select_extended's default sweep (200-203)
@pytest.mark.parametrize("seed", list(range(100, 106)))
def test_fuzz_select_matches_reference(seed):
    _fuzz(seed, [777, 3001, 9000])


@pytest.mark.parametrize("seed", list(range(200, 204)))
def test_fuzz_select_extended_matches_reference(seed):
    _fuzz(seed, [777, 3001, 9000, 20000])


def test_fuzz_within_in_matches_reference():
    rrt, prt = _fuzz_table(np.random.default_rng(5), 4000)
    for q in [
        "(select {s: (sum v1) from: t by: k1 "
        "where: (within v2 [100 500])})",
        "(select {c: (count v3) from: t by: k1 "
        "where: (in k2 [-1 0 2])})",
    ]:
        _check(rrt, prt, q, engine="dense")
