"""The port's sort-agg engine (rayforce_tpu_torch/engine/sortagg.py) held
against the JAX package's: the same seeded numpy columns go into both
packages' tables, and each query's formatted output must match byte for
byte — reference device against port device, and port device against
port host. The port side runs its device path on CPU torch
(`set_device("cpu")`), where every sort is the plain version of the CUDA
radix sort; the reference runs on JAX CPU with its device path forced
on, as tests/test_sortagg.py runs it."""
import os

import numpy as np
import pytest
import torch

from rayforce_tpu import Runtime as RefRuntime
from rayforce_tpu.core import symbols as rsymbols
from rayforce_tpu.core import types as RT
from rayforce_tpu.core.fmt import format_top as ref_fmt
from rayforce_tpu.core.obj import Obj as RObj, table as rtable, \
    vec_sym as rvec_sym
from rayforce_tpu.engine import device as rdev
from rayforce_tpu.engine import select as rsel
from rayforce_tpu.engine import sortagg as rsa
from rayforce_tpu_torch import Runtime
from rayforce_tpu_torch.core import symbols, types as T
from rayforce_tpu_torch.core.fmt import format_top as fmt
from rayforce_tpu_torch.core.obj import table_from_numpy
from rayforce_tpu_torch.engine import device as dev
from rayforce_tpu_torch.engine import select as sel
from rayforce_tpu_torch.engine import sortagg

torch.set_num_threads(1)

# tests/test_sortagg.py QUERIES
QUERIES = [
    "(select {s: (sum v1) from: t by: k})",
    "(select {a: (avg v3) c: (count v1) from: t by: k})",
    "(select {mx: (max v2) mn: (min v1) from: t by: k})",
    "(select {mx: (max v3) mn: (min v3) from: t by: k})",
    "(select {f: (first v3) l: (last v1) from: t by: k})",
    "(select {m: (med v3) from: t by: k})",
    "(select {m: (med v1) s: (sum v2) from: t by: k})",
    "(select {d: (dev v3) from: t by: k})",
    "(select {d: (dev v1) from: t by: k})",
    "(select {s: (sum v1) from: t by: k where: (> v2 10)})",
    "(select {f: (first sy) l: (last sy) from: t by: k "
    "where: (< v3 50.0)})",
    "(select {s: (sum (+ v1 v2)) from: t by: k})",
]

# bench.py q2, q3, q5, q6: the sort-agg queries of the G1 benchmark
BENCH = {
    "q2": "(select {s: (sum v1) from: t by: {id1: id1 id2: id2}})",
    "q3": "(select {s: (sum v1) a: (avg v3) from: t by: id3})",
    "q5": "(select {s1: (sum v1) s2: (sum v2) s3: (sum v3) from: t "
          "by: id6})",
    "q6": "(select {mx: (max v1) mn: (min v2) from: t by: id3})",
}

# tests/test_device_parity.py QUERIES that land in sort-agg
PARITY = [
    "(select {s: (sum big) from: t by: id3})",
    "(select {s: (sum v2) a: (avg v1) from: t by: id3 where: (> v3 0)})",
    "(select {mx: (max v3) mn: (min v1) from: t by: id3})",
    "(select {s: (sum v1) from: t by: {id1: id1 id3: id3}})",
    "(select {m: (med v3) s: (sum v1) from: t by: id3})",
    "(select {a: (avg v3) from: t by: id3 where: (and (> v2 10) "
    "(< v1 4))})",
    "(select {c: (count v1) from: t by: id3 where: (within v3 "
    "[0.0 50.0])})",
]


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


def _tables(cols):
    """(reference table, port table) from {name: (array, type name)};
    SYMBOL arrays hold the names."""
    rcols = []
    for a, tn in cols.values():
        if tn == "SYMBOL":
            rcols.append(RObj(RT.SYMBOL, np.asarray(
                [rsymbols.intern(s) for s in a], dtype=np.int64)))
        else:
            rcols.append(RObj(getattr(RT, tn), a.copy()))
    ref = rtable(rvec_sym(list(cols)), rcols)
    port = table_from_numpy(list(cols), [a for a, _ in cols.values()],
                            [tn for _, tn in cols.values()])
    return ref, port


def _runtimes(cols, name="t"):
    ref, port = _tables(cols)
    rrt, prt = RefRuntime(), Runtime()
    rrt.interp.globals[rsymbols.intern(name)] = ref
    prt.interp.globals[symbols.intern(name)] = port
    return rrt, prt


def _check(rrt, prt, q):
    """Reference device == port device == port host, formatted; the port
    device run went through sort-agg."""
    rdev.set_enabled(True)
    rsel.last_profile.clear()
    r = ref_fmt(rrt.eval_str(q))
    sel.last_profile.clear()
    dev.set_enabled(True)
    p = fmt(prt.eval_str(q))
    assert sel.last_profile.get("engine") == "sortagg", q
    assert rsel.last_profile.get("engine") == "sortagg", q
    dev.set_enabled(False)
    try:
        h = fmt(prt.eval_str(q))
    finally:
        dev.set_enabled(True)
    assert p == r, f"{q}\nPORT:\n{p}\nREFERENCE:\n{r}"
    assert p == h, f"{q}\nPORT DEVICE:\n{p}\nPORT HOST:\n{h}"


def _mk(rng, n, card, keys=None):
    k = rng.integers(0, card, n).astype(np.int64) if keys is None else keys
    v1 = rng.integers(-50, 50, n).astype(np.int64)
    v1[rng.integers(0, n, max(n // 40, 1))] = T.NULL_I64
    v2 = rng.integers(0, 30, n).astype(np.int32)
    v3 = rng.uniform(-100, 100, n)
    v3[rng.integers(0, n, max(n // 40, 1))] = np.nan
    sy = np.asarray([f"s{i}" for i in rng.integers(0, 5, n)])
    return {"k": (k, "I64"), "v1": (v1, "I64"), "v2": (v2, "I32"),
            "v3": (v3, "F64"), "sy": (sy, "SYMBOL")}


_RT_CACHE: dict = {}


def _card_runtimes(card):
    if card not in _RT_CACHE:
        _RT_CACHE[card] = _runtimes(
            _mk(np.random.default_rng(card), 20000, card))
    return _RT_CACHE[card]


@pytest.mark.parametrize("q", QUERIES)
@pytest.mark.parametrize("card", [600, 2500, 20000])
def test_queries_match_reference(card, q):
    _check(*_card_runtimes(card), q)


# engine/exprc.py on the card's path: typed-null arithmetic, casts and
# boolean filters, each inside a sort-agg select
EXPRS = [
    "(select {s: (sum (- v1 3)) from: t by: k})",
    "(select {s: (sum (* v3 2.5)) from: t by: k})",
    "(select {s: (sum (/ v2 4)) a: (avg (div v2 4)) from: t by: k})",
    "(select {s: (sum (% v1 7)) from: t by: k})",
    "(select {s: (sum (xbar v2 10)) m: (max (xbar v3 0.5)) from: t by: k})",
    "(select {c: (count v1) from: t by: k where: (> (as 'I32 v3) 10)})",
    "(select {c: (count v1) from: t by: k where: (> (as 'F64 v1) 0.5)})",
    "(select {s: (sum (neg v1)) m: (min (neg v3)) from: t by: k})",
    "(select {s: (sum (* v1 v2)) from: t by: k})",
    "(select {c: (count v1) from: t by: k where: (not (> v2 10))})",
    "(select {c: (count v1) from: t by: k where: (in v2 [1 2 3 25])})",
    "(select {c: (count v1) from: t by: k where: (in sy [s1 s3])})",
    "(select {c: (count v1) from: t by: k where: (or (== sy 's2) "
    "(< v3 -50.0))})",
    "(select {c: (count v1) from: t by: k where: (within v2 [5 15])})",
    "(select {s: (sum v2) from: t by: k where: (!= v1 0)})",
    "(select {s: (sum v2) from: t by: k where: (>= (% v2 7) 3)})",
]


@pytest.mark.parametrize("q", EXPRS)
def test_expressions_match_reference(q):
    _check(*_card_runtimes(2500), q)


def _fallen_back():
    return {id(p) for p, _src in sel._plan_cache.values()
            if isinstance(p, sortagg._SAPlan) and p.fallback is not None}


def test_head_variant_and_straggler_fallback():
    """Shrunk head windows on both sides: with every group inside the
    head and tail windows the head-ordered variant answers; a group seen
    only in the last rows trips the exact fallback."""
    old = (sortagg.HEAD_M, sortagg.HEAD_FACTOR, rsa.HEAD_M,
           rsa.HEAD_FACTOR)
    try:
        sortagg.HEAD_M, sortagg.HEAD_FACTOR = 8192, 1
        rsa.HEAD_M, rsa.HEAD_FACTOR = 8192, 1
        rng = np.random.default_rng(7)
        n = 20000
        cols = _mk(rng, n, 600)
        k = cols["k"][0]
        assert len(np.unique(k[:8192])) == len(np.unique(k[-8192:])) == 600
        rrt, prt = _runtimes(cols)
        before = _fallen_back()
        for q in QUERIES[:6]:
            _check(rrt, prt, q)
            assert sel.last_profile["exact"] is False
        assert _fallen_back() == before
        k = rng.integers(0, 600, n).astype(np.int64)
        k[:n - 10] = k[:n - 10] % 599          # group 599 only at tail
        k[n - 10:] = 599
        rrt, prt = _runtimes(_mk(rng, n, 600, keys=k), name="u")
        for q in ["(select {s: (sum v1) f: (first v1) from: u by: k})",
                  "(select {l: (last v3) c: (count v1) from: u by: k})"]:
            _check(rrt, prt, q)
        assert len(_fallen_back() - before) == 2
    finally:
        (sortagg.HEAD_M, sortagg.HEAD_FACTOR, rsa.HEAD_M,
         rsa.HEAD_FACTOR) = old


@pytest.fixture(scope="module")
def g1():
    """A 200k-row table of db-benchmark's G1 shape (bench.py specs)."""
    rng = np.random.default_rng(2024)
    n = 200_000
    cols = {}
    for nm, hi in (("id1", 100), ("id2", 100), ("id3", 100_000),
                   ("id4", 100), ("id5", 100), ("id6", 100_000)):
        cols[nm] = (rng.integers(0, hi, n).astype(np.int64), "I64")
    cols["v1"] = (rng.integers(1, 6, n).astype(np.int64), "I64")
    cols["v2"] = (rng.integers(1, 16, n).astype(np.int64), "I64")
    cols["v3"] = (np.round(rng.uniform(0, 100, n), 6), "F64")
    return _runtimes(cols)


@pytest.mark.parametrize("name", sorted(BENCH))
def test_bench_queries_match_reference(g1, name):
    _check(*g1, BENCH[name])


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


@pytest.mark.parametrize("q", PARITY)
def test_device_parity_queries_match_reference(parity, q):
    _check(*parity, q)


def test_chained_select_stays_on_device():
    """A select over a device-resident sort-agg result (its columns are
    DevPendingSliced lanes) matches the host."""
    rrt, prt = _card_runtimes(2500)
    q = ("(select {x: (sum s) m: (max m) from: (select {s: (sum v2) "
         "m: (max v1) from: t by: k}) by: k})")
    dev.set_enabled(True)
    p = fmt(prt.eval_str(q))
    dev.set_enabled(False)
    try:
        h = fmt(prt.eval_str(q))
    finally:
        dev.set_enabled(True)
    assert p == h == ref_fmt(rrt.eval_str(q))


def test_narrowed_i64_operand_keeps_zeros():
    """A null-free i64 column whose range fits i32 rides the sort as an
    i32 operand. Its null test must use the i64 null: the JAX package
    narrows the null sentinel to i32 (it wraps to 0) and so drops zeros
    from min. The port is held to its own host path here."""
    rng = np.random.default_rng(1)
    n = 20000
    w = rng.integers(0, 2**30, n).astype(np.int64)
    w[::3] = 0
    _rrt, prt = _runtimes({
        "k": (rng.integers(0, 2000, n).astype(np.int64), "I64"),
        "v": (rng.integers(0, 2**30, n).astype(np.int64), "I64"),
        "w": (w, "I64")})
    q = "(select {a: (min v) b: (min w) d: (dev w) from: t by: k})"
    dev.set_enabled(True)
    p = fmt(prt.eval_str(q))
    assert sel.last_profile.get("engine") == "sortagg"
    dev.set_enabled(False)
    try:
        h = fmt(prt.eval_str(q))
    finally:
        dev.set_enabled(True)
    assert p == h


def _falls_back(monkeypatch):
    seen = []
    monkeypatch.setattr(sel, "warn_fallback", seen.append)
    return seen


def test_kernel_load_failure_raises_through_eval(monkeypatch, tmp_path):
    """A radix sort library that does not load is a DeviceError that
    reaches the caller of eval_str; it never turns into a host run. The
    sort entry takes the card's route (the CUDA library) on CPU here."""
    from rayforce_tpu_torch.engine import cubuild, psort
    bogus = tmp_path / "libradix_sort.so"
    bogus.write_bytes(b"not an ELF object")
    os.utime(bogus, (4e9, 4e9))            # newer than the source: no build
    monkeypatch.setattr(cubuild, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(cubuild, "_libs", {})
    monkeypatch.setattr(psort, "_lib", None)

    def card_route(words, n_keys=1, perm=False):
        psort._radix_lib()
        return psort.sort_i32_cuda(words, n_keys, perm=perm)

    monkeypatch.setattr(psort, "sort_i32_plain", card_route)
    seen = _falls_back(monkeypatch)
    _rrt, prt = _card_runtimes(2500)
    with pytest.raises(dev.DeviceError, match="cannot load"):
        prt.eval_str(QUERIES[0])
    assert seen == []


@pytest.mark.parametrize("err, fault", [
    (RuntimeError("CUDA error: an illegal memory access was encountered"),
     True),
    (torch.OutOfMemoryError("CUDA out of memory"), True),
    (TypeError("a plan the engine cannot run"), False),
])
def test_select_hook_raises_card_faults_only(monkeypatch, err, fault):
    """A CUDA fault inside the sort-agg pipeline propagates through
    eval_str; any other error runs the host path, as in the reference."""
    from rayforce_tpu_torch.engine import psort

    def broken(words, n_keys=1, perm=False):
        raise err

    monkeypatch.setattr(psort, "sort_i32_plain", broken)
    seen = _falls_back(monkeypatch)
    _rrt, prt = _card_runtimes(600)
    sel._plan_cache.clear()
    q = QUERIES[1]
    if fault:
        with pytest.raises(type(err)):
            prt.eval_str(q)
        assert seen == []
        return
    p = fmt(prt.eval_str(q))
    assert seen == [err]
    dev.set_enabled(False)
    try:
        assert p == fmt(prt.eval_str(q))
    finally:
        dev.set_enabled(True)


def test_med_of_signed_zeros_matches_reference():
    """The med sort's f64 key rides as order-preserving i64 bits, where
    -0.0 sorts just below 0.0; the formatted medians must match the
    reference's (whose sort compares the floats)."""
    rng = np.random.default_rng(5)
    n = 6000
    v = rng.choice(np.array([-0.0, 0.0, -1.5, 2.5]), n)
    v[::97] = np.nan
    rrt, prt = _runtimes({
        "k": (rng.integers(0, 900, n).astype(np.int64), "I64"),
        "v": (v, "F64")})
    _check(rrt, prt, "(select {m: (med v) from: t by: k})")
    _check(rrt, prt, "(select {m: (med (* v -1.0)) from: t by: k})")
