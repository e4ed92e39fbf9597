"""The port's device window join (rayforce_tpu_torch/engine/wjoin.py:
event-sort boundaries, prefix-sum and sparse-table aggregates) held
against the JAX package's, step by step and as whole programs.

The port runs its device path on CPU torch (`set_device("cpu")`), where
its sorts are the plain version of the CUDA radix sort; the reference
runs on JAX CPU with its device path forced on, as
tests/test_join_fuzz.py runs it. Boundaries, counts, first/last and
min/max are compared exactly; f64 sums, averages and deviations within
a tolerance sized to the prefix sums (the port adds them in a fixed
blocked order, the reference in XLA's). Whole programs are compared by
their formatted output, byte for byte: reference device, port device
and port host."""
import json
import os
import random

import numpy as np
import pytest
import torch

from rayforce_tpu import Runtime as RefRuntime
from rayforce_tpu.core import symbols as rsymbols
from rayforce_tpu.core.errors import RayError as RefRayError
from rayforce_tpu.core.errors import err_msg as ref_err_msg
from rayforce_tpu.core.fmt import format_top as ref_fmt
from rayforce_tpu.core.obj import Obj as RObj, table as rtable, \
    vec_sym as rvec_sym
from rayforce_tpu.core import types as RT
from rayforce_tpu.engine import device as rdev
from rayforce_tpu.engine import wjoin as rew
from rayforce_tpu_torch import Runtime
from rayforce_tpu_torch.core import symbols, types as T
from rayforce_tpu_torch.core.errors import RayError, err_msg
from rayforce_tpu_torch.core.fmt import format_top as fmt
from rayforce_tpu_torch.core.obj import DevPending, Obj, list_, table, \
    to_np, vec_sym
from rayforce_tpu_torch.engine import device as dev
from rayforce_tpu_torch.engine import psort
from rayforce_tpu_torch.engine import wjoin as ew
from rayforce_tpu_torch.ops import join as oj

torch.set_num_threads(1)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")


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


def _np(x):
    return np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)


# -- the boundaries -----------------------------------------------------------

def _boundary_data(seed, full_range):
    """(lcode, rcode, rt, lo, hi, n_codes): right codes leave some codes
    empty, right (code, time) pairs repeat, left codes include codes no
    right row has."""
    rng = np.random.default_rng(seed)
    nl, nr, n_codes = 700, 1100, 13
    rcode = rng.choice([0, 1, 2, 4, 5, 7, 8, 11], nr).astype(np.int64)
    lcode = rng.integers(0, n_codes, nl).astype(np.int64)
    if full_range:
        span = rng.integers(-2**61, 2**61, 40)
        rt = rng.choice(span, nr).astype(np.int64)
        lo = rng.choice(span, nl).astype(np.int64)
        hi = lo + rng.integers(0, 2**60, nl)
    else:
        rt = rng.integers(0, 300, nr).astype(np.int64)   # many ties
        lo = rng.integers(-20, 320, nl).astype(np.int64)
        hi = lo + rng.integers(-5, 40, nl)                # some inverted
    return lcode, rcode, rt, lo, hi, n_codes


def _pack_of(rt, lo, hi, n_codes):
    tmin = int(min(rt.min(), lo.min(), hi.min()))
    tbits = max(int(max(rt.max(), lo.max(), hi.max()) - tmin).bit_length(),
                1)
    if max(n_codes.bit_length(), 1) + tbits + 2 > 62:
        return None
    return (tmin, tbits)


def _boundaries(lcode, rcode, rt, lo, hi, n_codes, tp, pack):
    """(reference (sr, li, ri, ok), port (sr, li, ri, ok)) as numpy."""
    f = rew._boundaries_fn(len(lcode), len(rcode), n_codes, tp, 0, (),
                           pack=pack)
    want = [np.asarray(x) for x in f(lcode, rcode, rt, lo, hi)[:4]]
    t = [torch.from_numpy(a.copy()) for a in (lcode, rcode, rt, lo, hi)]
    got = [_np(x) for x in ew._boundary_core(*t, n_codes, tp, pack)]
    return want, got


@pytest.mark.parametrize("full_range,packed", [(False, True), (False, False),
                                               (True, False)])
@pytest.mark.parametrize("tp", [0, 1])
def test_boundary_core(tp, full_range, packed):
    """The right sort's permutation and each left row's (li, ri, ok)
    equal the reference's window index, with and without the packed
    (code, time, tie) key; a full-range i64 time cannot pack."""
    data = _boundary_data(10 * tp + int(full_range), full_range)
    pack = _pack_of(*data[2:])
    if full_range:
        assert pack is None
    if not packed:
        pack = None
    (wsr, wli, wri, wok), (sr, li, ri, ok) = _boundaries(*data, tp, pack)
    np.testing.assert_array_equal(sr, wsr)
    np.testing.assert_array_equal(ok, wok)
    np.testing.assert_array_equal(li, wli)
    np.testing.assert_array_equal(ri, wri)
    assert ok.any() and not ok.all()


def test_boundary_sort_calls_and_ties():
    """Tied (code, time) right rows keep their row order (the stable
    sort; the reference rides the row index as a second key), and the
    port sorts twice through the psort entry: the right rows, then the
    events, each with its permutation and no row-index word."""
    lcode = np.array([0, 0, 1], dtype=np.int64)
    rcode = np.array([1, 0, 0, 0, 1], dtype=np.int64)
    rt = np.array([5, 7, 7, 7, 5], dtype=np.int64)
    lo = np.array([6, 8, 0], dtype=np.int64)
    hi = np.array([7, 9, 9], dtype=np.int64)
    calls = []
    plain = psort.sort_i32_plain

    def counting(words, n_keys=1, perm=False):
        calls.append((n_keys, len(words), perm))
        return plain(words, n_keys, perm=perm)

    psort.sort_i32_plain = counting
    try:
        for pack in ((0, 4), None):
            calls.clear()
            want, got = _boundaries(lcode, rcode, rt, lo, hi, 2, 1, pack)
            for w, g in zip(want, got):
                np.testing.assert_array_equal(g, w)
            assert list(got[0]) == [1, 2, 3, 0, 4]
            assert calls == ([(2, 2, True), (2, 2, True)] if pack else
                             [(3, 3, True), (4, 4, True)])
    finally:
        psort.sort_i32_plain = plain


# -- each aggregate against its reference kernel ------------------------------

NULLABLE = {"I16": np.int16, "I32": np.int32, "I64": np.int64,
            "DATE": np.int32, "TIME": np.int32, "TIMESTAMP": np.int64}


def _column(tn, rng, n, nulls):
    """A right column of type `tn` with its nulls, all-null runs, and
    (F64) real -inf and signed zeros."""
    if tn == "F64":
        a = rng.uniform(-10, 10, n).round(1)
        a[rng.integers(0, n, n // 6)] = 0.0
        a[rng.integers(0, n, n // 6)] = -0.0
        a[rng.integers(0, n, n // 40)] = -np.inf
        a[rng.integers(0, n, n // 40)] = np.inf
        if nulls:
            a[rng.integers(0, n, n // 8)] = np.nan
            a[200:260] = np.nan
        return a
    if tn == "B8":
        return rng.integers(0, 2, n).astype(np.int8)
    if tn == "U8":
        return rng.integers(0, 256, n).astype(np.uint8)
    dt = NULLABLE[tn]
    info = np.iinfo(dt)
    a = rng.integers(max(info.min + 1, -10**6), min(info.max, 10**6),
                     n).astype(dt)
    if nulls:
        nv = T.NULL_BY_TYPE[getattr(T, tn)]
        a[rng.integers(0, n, n // 8)] = nv
        a[200:260] = nv
    return a


@pytest.fixture(scope="module")
def windows():
    """Sorted-order windows (li, ri, ok) from the reference's boundaries
    over 900 right rows, as numpy, with their widest window."""
    rng = np.random.default_rng(5)
    nl, nr = 800, 900
    rcode = np.sort(rng.integers(0, 4, nr)).astype(np.int64)
    rt = np.concatenate([np.sort(rng.integers(0, 2000, (rcode == c).sum()))
                         for c in range(4)]).astype(np.int64)
    lcode = rng.integers(0, 5, nl).astype(np.int64)
    lo = rng.integers(0, 2000, nl).astype(np.int64)
    hi = lo + rng.integers(-10, 400, nl)
    f = rew._boundaries_fn(nl, nr, 5, 0, 0, (), pack=None)
    _sr, li, ri, ok = (np.asarray(x) for x in
                       f(lcode, rcode, rt, lo, hi)[:4])
    return li.astype(np.int64), ri.astype(np.int64), ok


def _port_args(sv, li, ri, ok):
    return tuple(torch.from_numpy(a.copy()) for a in (sv, li, ri, ok))


TYPES = ["B8", "U8", "I16", "I32", "I64", "DATE", "TIME", "TIMESTAMP",
         "F64"]
# (type, with nulls): B8 and U8 have no null sentinel
TYPE_NULLS = [(tn, nulls) for tn in TYPES for nulls in (False, True)
              if not (nulls and tn in ("B8", "U8"))]


def _same_bits(got, want):
    if got.dtype == np.float64:
        assert np.array_equal(got.view(np.int64), want.view(np.int64)), \
            np.flatnonzero(got.view(np.int64) != want.view(np.int64))[:10]
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("tn,nulls", TYPE_NULLS)
def test_count_first_last(windows, tn, nulls):
    li, ri, ok = windows
    rt_ = getattr(T, tn)
    sv = _column(tn, np.random.default_rng(TYPES.index(tn)), len(li) + 100,
                 nulls)
    args = _port_args(sv, li, ri, ok)
    _same_bits(_np(ew._k_count(*args[1:])).astype(np.int64),
               np.asarray(rew._k_count(li, ri, ok)))
    for last in (False, True):
        want = np.asarray(rew._k_first_last(sv, li, ri, ok, rtype=rt_,
                                            last=last))
        got = _np(ew._k_first_last(*args, rt_, last))
        assert got.dtype == sv.dtype
        _same_bits(got, want.astype(got.dtype))


def _sum_tol(sv, rtype):
    """2^-40 of the column's absolute sum: the prefix sums' rounding
    bound (both sides add the whole column's prefix)."""
    nn = np.isnan(sv) if rtype == T.F64 else np.zeros(len(sv), bool)
    a = np.abs(np.where(nn | ~np.isfinite(sv.astype(np.float64)), 0,
                        sv.astype(np.float64)))
    return max(a.sum(), 1.0) * 2.0 ** -40


@pytest.mark.parametrize("tn,nulls", [
    (tn, nulls) for tn, nulls in TYPE_NULLS
    if tn in ("U8", "I16", "I32", "I64", "F64")])
def test_sum_avg_dev(windows, tn, nulls):
    li, ri, ok = windows
    rt_ = getattr(T, tn)
    rng = np.random.default_rng(40 + TYPES.index(tn))
    sv = _column(tn, rng, len(li) + 100, nulls)
    if tn == "F64":
        sv[~np.isfinite(sv) & ~np.isnan(sv)] = 1.5    # finite sums
    args = _port_args(sv, li, ri, ok)
    tol = _sum_tol(sv, rt_)
    # sum: integers exactly (f64 prefix sums of integers below 2^53)
    want = np.asarray(rew._k_sum_avg(sv, li, ri, ok, rtype=rt_,
                                     want_avg=False))
    got = _np(ew._k_sum_avg(*args, rt_, False))
    assert got.dtype == T.DTYPE[ew.SUM_TYPE[rt_]]
    if tn == "F64":
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        np.testing.assert_allclose(got, want, rtol=0, atol=tol)
    else:
        np.testing.assert_array_equal(got, want.astype(got.dtype))
    for name, g, w in (
            ("avg", ew._k_sum_avg(*args, rt_, True),
             rew._k_sum_avg(sv, li, ri, ok, rtype=rt_, want_avg=True)),
            ("dev", ew._k_dev(*args, rt_), rew._k_dev(sv, li, ri, ok,
                                                        rtype=rt_))):
        g, w = _np(g), np.asarray(w)
        np.testing.assert_array_equal(np.isnan(g), np.isnan(w), name)
        np.testing.assert_allclose(g, w, rtol=1e-12, atol=tol, err_msg=name)
        assert (~np.isnan(g)).any()


def _ref_minmax(sv, li, ri, ok, rtype, op, nullfree):
    """The reference's min/max: the null-free route (one rank sort shared
    by min and max) or the general route."""
    if nullfree:
        rank, vo = rew._k_rank_vals_nf(sv)
        red = rew._k_minmax_from_rank(rank, li, ri, op=op)
        return np.asarray(rew._k_value_from_sorted(vo, red, ok, rtype=rtype,
                                                   op=op))
    red = rew._k_minmax_rank(sv, li, ri, ok, rtype=rtype, op=op)
    return np.asarray(rew._k_minmax_value(sv, red, li, ri, ok,
                                          rtype=rtype, op=op))


@pytest.mark.parametrize("tn,nulls", TYPE_NULLS)
def test_min_max(windows, tn, nulls):
    """Window min and max equal the reference's, exactly: empty windows
    typed null, all-null windows typed INF (min) and null (max), real
    -inf kept by f64 max, narrow types in their own dtype, and a zero
    extreme signed as the reference's sort orders -0.0 and 0.0 (tied,
    in row order)."""
    li, ri, ok = windows
    rt_ = getattr(T, tn)
    sv = _column(tn, np.random.default_rng(80 + TYPES.index(tn)),
                 len(li) + 100, nulls)
    span = int(np.where(ok, ri - li + 1, 1).max())
    args = _port_args(sv, li, ri, ok)
    for op in ("min", "max"):
        want = _ref_minmax(sv, li, ri, ok, rt_, op, not nulls)
        got = _np(ew._k_minmax(*args, rt_, op, span))
        assert got.dtype == sv.dtype
        _same_bits(got, want.astype(got.dtype))
    if tn == "F64":
        # both zeros share windows; a window's zero keeps its sign
        z = np.where(ok, (sv[np.clip(li, 0, None)] == 0), False)
        assert z.any() and (np.signbit(sv) & (sv == 0)).any()


@pytest.mark.parametrize("op", ["min", "max"])
@pytest.mark.parametrize("dtype", [np.int64, np.float64])
def test_range_ext_blocked_route(monkeypatch, op, dtype):
    """Above the flat table's byte cap, the two-level structure (a block
    table, block prefixes and suffixes, a sparse table of block
    summaries) gives every window's extreme, checked against numpy on
    windows of every length up to several blocks."""
    rng = np.random.default_rng(3)
    n = 5000
    key = rng.integers(-10**9, 10**9, n).astype(dtype)
    li = rng.integers(0, n, 3000)
    ri = np.minimum(li + rng.integers(0, 1400, 3000), n - 1)
    li[:20], ri[:20] = np.arange(20), np.arange(20)   # one-row windows
    fn = np.minimum if op == "min" else np.maximum
    want = np.array([fn.reduce(key[a:b + 1]) for a, b in zip(li, ri)])
    args = (torch.from_numpy(key), op)
    t_li, t_ri = torch.from_numpy(li), torch.from_numpy(ri)
    span = int((ri - li + 1).max())
    flat = _np(ew._range_ext(args[0], t_li, t_ri, op, span))
    monkeypatch.setattr(ew, "_TABLE_BYTES", 0)
    blocked = _np(ew._range_ext(args[0], t_li, t_ri, op, span))
    np.testing.assert_array_equal(flat, want)
    np.testing.assert_array_equal(blocked, want)


def test_prefix_f64_fixed_order():
    """The blocked prefix sum: n + 1 values with a leading zero, within
    rounding of numpy's sequential cumsum, at one row, one full row and
    three levels of rows."""
    rng = np.random.default_rng(2)
    for n in (0, 1, 1000, 1024, 1025, (1 << 20) + 3):
        x = rng.uniform(-1, 1, n)
        got = _np(ew._prefix_f64(torch.from_numpy(x)))
        want = np.concatenate([[0.0], np.cumsum(x)])
        assert got.shape == (n + 1,)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-9)
        if n <= 1024:
            np.testing.assert_array_equal(got, want)


# -- whole programs -----------------------------------------------------------

def _runtimes(tables):
    """(reference Runtime, port Runtime) holding {name: {column: (array,
    type name)}}; "SYMBOL" arrays hold names."""
    rrt, prt = RefRuntime(), Runtime()
    for name, cols in tables.items():
        rcols, pcols = [], []
        for a, tn in cols.values():
            if tn == "SYMBOL":
                rcols.append(RObj(RT.SYMBOL, np.asarray(
                    [rsymbols.intern(s) for s in a], dtype=np.int64)))
                pcols.append(Obj(T.SYMBOL, np.asarray(
                    [symbols.intern(s) for s in a], dtype=np.int64)))
            else:
                rcols.append(RObj(getattr(RT, tn), a.copy()))
                pcols.append(Obj(getattr(T, tn), a.copy()))
        rrt.interp.globals[rsymbols.intern(name)] = rtable(
            rvec_sym(list(cols)), rcols)
        prt.interp.globals[symbols.intern(name)] = table(
            vec_sym(list(cols)), pcols)
    return rrt, prt


def check(rrt, prt, q, device=True):
    """Reference device == port device == port host, formatted; both
    devices ran device-wjoin (or, with device=False, neither did)."""
    rew.last_profile.clear()
    r = ref_fmt(rrt.eval_str(q))
    ew.last_profile.clear()
    p = fmt(prt.eval_str(q))
    want = "device-wjoin" if device else None
    assert rew.last_profile.get("engine") == want, q
    assert ew.last_profile.get("engine") == want, q
    dev.set_enabled(False)
    try:
        h = fmt(prt.eval_str(q))
    finally:
        dev.set_enabled(True)
    assert p == r, f"{q}\nPORT:\n{p}\nREFERENCE:\n{r}"
    assert p == h, f"{q}\nPORT DEVICE:\n{p}\nPORT HOST:\n{h}"
    return p


FUZZ_AGGS = ["{mx: (max p) mn: (min p)}",
             "{s: (sum q) a: (avg p) c: (count p)}",
             "{f: (first p) l: (last q)}",
             "{d: (dev p) dq: (dev q)}"]


@pytest.mark.parametrize("seed", range(12))
def test_window_join_fuzz(seed):
    """tests/test_join_fuzz.py's window-join fuzz, drawn in its order:
    random windows (empty and inverted ones too), nulls in the
    aggregated columns, duplicate (key, time) rows, every aggregate."""
    rng = np.random.default_rng(3000 + seed)
    rnd = random.Random(3000 + seed)
    nl = rnd.choice([400, 1500])
    nr = rnd.choice([900, 2600])
    lk = rng.integers(0, 15, nl).astype(np.int64)
    lts = np.sort(rng.integers(0, 50_000, nl)).astype(np.int64)
    rk = rng.integers(0, 15, nr).astype(np.int64)
    rts = np.sort(rng.integers(0, 50_000, nr)).astype(np.int64)
    p = rng.uniform(-100, 100, nr)
    p[rng.integers(0, nr, max(nr // 25, 1))] = np.nan
    q_ = rng.integers(-50, 50, nr).astype(np.int64)
    q_[rng.integers(0, nr, max(nr // 25, 1))] = T.NULL_I64
    rrt, prt = _runtimes({
        "tr": {"s": (lk, "I64"), "ts": (lts, "I64")},
        "qt": {"s": (rk, "I64"), "ts": (rts, "I64"), "p": (p, "F64"),
               "q": (q_, "I64")}})
    w = rnd.choice([(-1000, 1000), (-5000, 0), (0, 0), (-1, 1),
                    (-20000, 20000)])
    for fn in ("window-join", "window-join1"):
        for aggs in FUZZ_AGGS:
            check(rrt, prt, f"({fn} [s ts] (map-left + [{w[0]} {w[1]}] "
                            f"(at tr 'ts)) tr qt {aggs})")


def _golden(name):
    with open(os.path.join(GOLDEN, name)) as f:
        cases = json.load(f)
    return [(f"{name[:-5]}::{k}", v) for k, v in sorted(cases.items())
            if "window-join" in v["stmts"][-1]]


GOLDEN_WJ = _golden("joins.json") + _golden("wjoin_nulls.json") + \
    _golden("wjoin_meddev.json")


@pytest.fixture
def fresh_symbols():
    """Each golden case starts from the symbol table of a fresh process,
    as the oracle recorded it (symbols compare by id), in both
    packages."""
    RefRuntime()
    Runtime()
    rbase, base = rsymbols.count(), symbols.count()
    yield
    for mod, b in ((rsymbols, rbase), (symbols, base)):
        for name in mod._by_id[b:]:
            del mod._by_name[name]
        del mod._by_id[b:]


def _run(rt_, stmts, err_types, msg):
    try:
        result = None
        for s in stmts:
            result = rt_.eval_str(s)
        return rt_.format_result(result)
    except err_types as e:
        return "ERROR:" + msg(e)


@pytest.mark.parametrize("name,case", GOLDEN_WJ,
                         ids=[k for k, _ in GOLDEN_WJ])
def test_golden_window_joins(fresh_symbols, name, case):
    """Every window-join golden at threshold 1: the oracle's text from
    the reference device, the port device and the port host, each
    window join whose aggregates have a device kernel on device-wjoin
    in both packages (med and bare columns stay on the host path)."""
    stmts = case["stmts"]
    device = "(med " not in stmts[-1] and "{c: " not in stmts[-1]
    rew.last_profile.clear()
    ew.last_profile.clear()
    r = _run(RefRuntime(), stmts, RefRayError, ref_err_msg)
    p = _run(Runtime(), stmts, RayError, err_msg)
    want = "device-wjoin" if device else None
    assert rew.last_profile.get("engine") == want
    assert ew.last_profile.get("engine") == want
    dev.set_enabled(False)
    try:
        h = _run(Runtime(), stmts, RayError, err_msg)
    finally:
        dev.set_enabled(True)
    assert p == case["expect"]
    assert r == case["expect"]
    assert h == case["expect"]


@pytest.fixture(scope="module")
def parity():
    """tests/test_device_parity.py's lt and r tables (seed 42), drawn in
    its order."""
    rng = np.random.default_rng(42)
    N = 4000
    rng.integers(0, 7, N)
    rng.integers(0, 1200, N)
    rng.integers(-3, 6, N)
    rng.integers(0, N, 40)
    rng.integers(0, 100, N)
    rng.uniform(-50, 100, N)
    rng.integers(0, N, 40)
    rng.integers(-2**62, 2**62, N)
    NR = 2500
    r = {"id3": (rng.integers(0, 2400, NR).astype(np.int64), "I64"),
         "w": (rng.uniform(0, 10, NR), "F64"),
         "ts": (np.sort(rng.integers(0, 1_000_000, NR)).astype(np.int64),
                "I64")}
    lt = {"id3": (rng.integers(0, 2400, N).astype(np.int64), "I64"),
          "ts": (np.sort(rng.integers(0, 1_000_000, N)).astype(np.int64),
                 "I64")}
    return _runtimes({"r": r, "lt": lt})


@pytest.mark.parametrize("q", [
    "(window-join [id3 ts] (map-left + [-5000 5000] (at lt 'ts)) "
    "lt r {mx: (max w) mn: (min w) s: (sum w) c: (count w)})",
    "(window-join1 [id3 ts] (map-left + [-5000 5000] (at lt 'ts)) "
    "lt r {a: (avg w) f: (first w) l: (last w)})"])
def test_device_parity_window_joins(parity, q):
    check(*parity, q)


def _typed_tables(key):
    """300 left and 700 right rows keyed by `key` ("I64" or "SYMBOL") on
    an i32 TIME time column, the right table holding one column of each
    type (nulls included)."""
    rng = np.random.default_rng(9)
    nl, nr = 300, 700
    names = np.array(["nvda", "msft", "ibm", "aapl"])

    def keys(n):
        k = rng.integers(0, 4, n)
        return (names[k], "SYMBOL") if key == "SYMBOL" else \
            (k.astype(np.int64), "I64")
    cols = {"s": keys(nr),
            "xt": (np.sort(rng.integers(0, 86_400_000, nr)).astype(np.int32),
                   "TIME")}
    for tn in TYPES:
        # "c" + the type's name: `date`, `time` and `timestamp` name
        # builtins
        cols["c" + tn.lower()] = (_column(tn, rng, nr, tn != "B8" and
                                          tn != "U8"), tn)
    return _runtimes({
        "tr": {"s": keys(nl),
               "xt": (np.sort(rng.integers(0, 86_400_000, nl))
                      .astype(np.int32), "TIME")},
        "q": cols})


TYPED_BOUNDS = "(map-left + [-00:10:00.000 00:10:00.000] (at tr 'xt))"


@pytest.mark.parametrize("fn", ["window-join", "window-join1"])
@pytest.mark.parametrize("tn", [tn for tn in TYPES
                                if tn not in ("I64", "F64")])
def test_every_column_type(fn, tn):
    """Every aggregate over the narrow and temporal columns (nulls
    included) on an i32 TIME time column (the fuzz covers I64 and
    F64)."""
    rrt, prt = _typed_tables("I64")
    c = "c" + tn.lower()
    aggs = f"mn: (min {c}) mx: (max {c}) f: (first {c}) l: (last {c}) " \
        f"n: (count {c})"
    if tn in ("U8", "I16", "I32", "I64", "F64"):
        aggs += f" s: (sum {c}) a: (avg {c}) d: (dev {c})"
    check(rrt, prt, f"({fn} [s xt] {TYPED_BOUNDS} tr q {{{aggs}}})")


def test_symbol_keys_follow_the_reference_device():
    """Symbol keys interned out of name order: the device answer equals
    the reference's device answer. Both packages' host paths group the
    xasc-sorted right table (symbols in name order) by codes in intern
    order, so their windows differ there (ROADMAP queue 3)."""
    rrt, prt = _typed_tables("SYMBOL")
    q = f"(window-join [s xt] {TYPED_BOUNDS} tr q " \
        "{n: (count cf64) mx: (max cf64) l: (last ci32)})"
    rew.last_profile.clear()
    r = ref_fmt(rrt.eval_str(q))
    assert rew.last_profile.get("engine") == "device-wjoin"
    p = fmt(prt.eval_str(q))
    assert ew.last_profile.get("engine") == "device-wjoin"
    assert p == r
    dev.set_enabled(False)
    try:
        assert fmt(prt.eval_str(q)) != p
    finally:
        dev.set_enabled(True)


def test_null_right_times_keep_two_sort_keys():
    """A right time column with nulls: its stats range skips the nulls,
    so the packed (code, time - tmin, tie) key would wrap them; the port
    sorts (code, time, tie) as separate keys there and equals the host
    path. The reference packs anyway and its device answer differs from
    both packages' host paths (ROADMAP queue 3)."""
    rng = np.random.default_rng(4)
    nr, nl = 300, 200
    rts = np.sort(rng.integers(0, 10000, nr)).astype(np.int64)
    rts[[5, 100]] = T.NULL_I64
    rrt, prt = _runtimes({
        "tr": {"s": (rng.integers(0, 3, nl).astype(np.int64), "I64"),
               "ts": (np.sort(rng.integers(0, 10000, nl)).astype(np.int64),
                      "I64")},
        "qt": {"s": (rng.integers(0, 3, nr).astype(np.int64), "I64"),
               "ts": (rts, "I64"), "p": (rng.uniform(0, 1, nr), "F64")}})
    q = "(window-join [s ts] (map-left + [-300 300] (at tr 'ts)) tr qt " \
        "{c: (count p) mx: (max p) f: (first p)})"
    p = fmt(prt.eval_str(q))
    assert ew.last_profile["engine"] == "device-wjoin"
    dev.set_enabled(False)
    try:
        assert fmt(prt.eval_str(q)) == p
    finally:
        dev.set_enabled(True)
    assert ref_fmt(rrt.eval_str(q)) != p


def test_unsupported_aggregate_stays_on_host():
    rng = np.random.default_rng(1)
    rrt, prt = _runtimes({
        "tr": {"s": (rng.integers(0, 3, 50).astype(np.int64), "I64"),
               "ts": (np.arange(50, dtype=np.int64) * 10, "I64")},
        "qt": {"s": (rng.integers(0, 3, 80).astype(np.int64), "I64"),
               "ts": (np.arange(80, dtype=np.int64) * 7, "I64"),
               "p": (rng.uniform(0, 1, 80), "F64")}})
    check(rrt, prt, "(window-join [s ts] (map-left + [-20 20] (at tr 'ts)) "
                    "tr qt {m: (med p) c: (count p)})", device=False)


# -- bounds and rejections ----------------------------------------------------

def _device_tables(nl=400, nr=900):
    """A port Runtime whose tables live on the device (their columns
    hold device copies, as tools/jtables.py makes them)."""
    rng = np.random.default_rng(12)
    prt = Runtime()
    for name, n, extra in (("tr", nl, False), ("qt", nr, True)):
        cols = [Obj(T.I64, rng.integers(0, 9, n).astype(np.int64)),
                Obj(T.I64, np.sort(rng.integers(0, 10**5, n))
                    .astype(np.int64))]
        names = ["s", "ts"]
        if extra:
            cols.append(Obj(T.F64, rng.uniform(0, 1, n)))
            names.append("p")
        tbl = table(vec_sym(names), cols)
        dev.put_table(tbl)
        prt.interp.globals[symbols.intern(name)] = tbl
    return prt


def test_device_resident_bounds(monkeypatch):
    """`(map-left + [-w w] (at tr 'ts))` over a device-resident column
    comes out of the device arithmetic as device tensors, and the window
    join takes them as they are."""
    prt = _device_tables()
    bounds = prt.eval_str("(map-left + [-500 500] (at tr 'ts))")
    assert all(b.pending() is not None for b in bounds.v)
    seen = []
    real = ew._bound_tensor

    def spy(b):
        seen.append(isinstance(b, torch.Tensor))
        return real(b)

    monkeypatch.setattr(ew, "_bound_tensor", spy)
    q = "(window-join1 [s ts] (map-left + [-500 500] (at tr 'ts)) tr qt " \
        "{mx: (max p) c: (count p)})"
    p = fmt(prt.eval_str(q))
    assert seen == [True, True]
    assert ew.last_profile["engine"] == "device-wjoin"
    dev.set_enabled(False)
    try:
        assert fmt(prt.eval_str(q)) == p
    finally:
        dev.set_enabled(True)


def _lazy_windows(n, forced):
    def bound(off):
        def thunk():
            forced.append(off)
            return torch.arange(n, dtype=torch.int64) * 10 + off
        o = Obj(T.I64, DevPending(thunk=thunk, shape=(n,)))
        o.meta = {}
        return o
    return list_([bound(-5), bound(5)])


@pytest.mark.parametrize("aggs,dense_max,taken", [
    ("{m: (med p)}", 1 << 20, False),       # no device kernel
    ("{c: p}", 1 << 20, False),             # a bare column
    ("{mx: (max p)}", 4, False),            # key codes above dense_max
    ("{s: (sum s)}", 1 << 20, True),
])
def test_rejected_shape_does_not_force_bounds(monkeypatch, aggs, dense_max,
                                              taken):
    """The hook checks the aggregates, key columns and key code range
    before it asks for the window bounds: a shape it rejects leaves the
    bounds' thunks unforced. A shape it takes forces each once."""
    prt = _device_tables()
    monkeypatch.setitem(dev._cfg, "dense_max", dense_max)
    forced = []
    lt = prt.interp.globals[symbols.intern("tr")]
    rt_ = prt.interp.globals[symbols.intern("qt")]
    keys = Obj(T.SYMBOL, np.asarray([symbols.intern("s"),
                                     symbols.intern("ts")], dtype=np.int64))
    res = oj._try_device_window_join(prt.interp, keys,
                                     _lazy_windows(len(lt), forced), lt, rt_,
                                     _agg_dict(prt, aggs), 0)
    assert (res is not None) == taken
    assert forced == ([-5, 5] if taken else [])


def _agg_dict(prt, aggs):
    """The aggregation dict as window-join hands it to the hook
    (unevaluated expressions), caught from a run of the query."""
    seen = {}
    real = oj._try_device_window_join

    def grab(interp, keys, windows, lt, rt_, aggd, tp):
        seen["aggd"] = aggd
        return None

    oj._try_device_window_join = grab
    try:
        prt.eval_str(f"(window-join [s ts] (map-left + [-1 1] (at tr 'ts)) "
                     f"tr qt {aggs})")
    except RayError:
        pass
    finally:
        oj._try_device_window_join = real
    return seen["aggd"]


# -- faults on the card propagate; other errors take the host path -----------

@pytest.mark.parametrize("err, fault", [
    (RuntimeError("CUDA error: an illegal memory access was encountered"),
     True),
    (torch.OutOfMemoryError("CUDA out of memory"), True),
    (TypeError("a plan the engine cannot run"), False),
])
def test_faults_propagate(monkeypatch, err, fault):
    from rayforce_tpu_torch.engine import select as sel

    def broken(words, n_keys=1, perm=False):
        raise err

    prt = _device_tables()
    monkeypatch.setattr(psort, "sort_i32_plain", broken)
    seen = []
    monkeypatch.setattr(sel, "warn_fallback", seen.append)
    q = "(window-join [s ts] (map-left + [-50 50] (at tr 'ts)) tr qt " \
        "{f: (first p)})"
    if fault:
        with pytest.raises(type(err)):
            prt.eval_str(q)
        assert seen == []
        return
    out = prt.eval_str(q)
    # the window join, then the host path's right-table sort, fall back
    assert seen and all(e is err for e in seen)
    assert len(out) == 400


# -- the slice as a whole: bench.py's window joins at a small size ------------

@pytest.fixture(scope="module")
def bench_tables():
    """tools/jtables.py's trades, quotes and quotesn at 20 000 trades on
    CPU torch (device-resident columns), and their numpy copies in both
    packages."""
    from rayforce_tpu_torch.core.obj import to_np
    from rayforce_tpu_torch.tools.jtables import join_tables
    tables = {k: v for k, v in join_tables(20_000, "cpu").items()
              if k in ("trades", "quotes", "quotesn")}
    copies = {name: {symbols.name_of(int(s)): (
        to_np(c).copy(), "F64" if c.t == T.F64 else "I64")
        for s, c in zip(to_np(tbl.v[0]), tbl.v[1])}
        for name, tbl in tables.items()}
    prt = Runtime()
    for name, tbl in tables.items():
        prt.interp.globals[symbols.intern(name)] = tbl
    return prt, _runtimes(copies)


@pytest.mark.parametrize("name", ["wj", "wj0"])
def test_bench_window_joins(bench_tables, name):
    """Each WJOIN_QUERIES query: reference device == port device == port
    host on the tables' numpy copies; then on the device-resident tables
    (bounds from the device arithmetic), every forced lane equals the
    port host's column: exactly, or for the f64 sum, avg and dev lanes
    within 2^-40 of the prefix magnitude, as chip_smoke.py holds them."""
    from rayforce_tpu_torch.core.obj import to_np
    from rayforce_tpu_torch.tools.jtables import WJOIN_QUERIES, \
        force_columns
    prt, (rrt_c, prt_c) = bench_tables
    q = WJOIN_QUERIES[name]
    check(rrt_c, prt_c, q)
    ew.last_profile.clear()
    lanes = force_columns(prt.eval_str(q))
    assert ew.last_profile["engine"] == "device-wjoin"
    _held_to_host(prt, name, lanes)


def _held_to_host(prt, name, lanes):
    """Each forced lane of WJOIN_QUERIES[name] against the port host's
    column: exactly, or for wj0's f64 sum, avg and dev lanes within 2^-40
    of the prefix magnitude."""
    from rayforce_tpu_torch.core.obj import to_np
    from rayforce_tpu_torch.tools.jtables import WJOIN_QUERIES
    q = WJOIN_QUERIES[name]
    dev.set_enabled(False)
    try:
        want = prt.eval_str(q)
    finally:
        dev.set_enabled(True)
    names = [symbols.name_of(int(s)) for s in to_np(want.v[0])]
    pn = to_np(prt.interp.globals[symbols.intern("quotesn")].v[1][2])
    pn = pn[~np.isnan(pn)]
    for nm, (got,), w in zip(names, lanes, want.v[1]):
        g, w = got.numpy(), to_np(w)
        assert g.dtype == w.dtype and g.shape == w.shape, nm
        if name == "wj0" and nm in ("s", "a"):
            np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
            np.testing.assert_allclose(g, w, rtol=0,
                                       atol=np.abs(pn).sum() * 2.0 ** -40)
        elif name == "wj0" and nm == "d":
            np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
            np.testing.assert_allclose(
                g ** 2, w ** 2, rtol=0,
                atol=((pn - pn.mean()) ** 2).sum() * 2.0 ** -40)
        else:
            assert g.tobytes() == w.tobytes(), nm


def test_wj0_bit_stable_across_cpu_threads(bench_tables):
    """wj0's aggregates at 20 000 trades are the same bytes under 1, 2, 3
    and 8 CPU threads: the dev lane's shift and noise floor are sums in
    the fixed order of the prefix scan, not whole-vector sums whose
    order follows the intra-op thread split. Each run's formatted output
    equals the reference's, and its lanes the port host's within the
    tolerance of test_bench_window_joins."""
    from rayforce_tpu_torch.tools.jtables import WJOIN_QUERIES, \
        force_columns
    prt, (rrt_c, _prt_c) = bench_tables
    q = WJOIN_QUERIES["wj0"]
    rdev.set_enabled(True)
    want = ref_fmt(rrt_c.eval_str(q))
    saved = torch.get_num_threads()
    runs = {}
    try:
        for threads in (1, 2, 3, 8):
            torch.set_num_threads(threads)
            out = prt.eval_str(q)
            runs[threads] = force_columns(out)
            assert fmt(out) == want, threads
    finally:
        torch.set_num_threads(saved)
    for threads, lanes in runs.items():
        for nm, a, b in zip(out.v[0].v, lanes, runs[1]):
            assert all(x.numpy().tobytes() == y.numpy().tobytes()
                       for x, y in zip(a, b)), (threads, nm)
    _held_to_host(prt, "wj0", runs[1])


def test_k_dev_bit_stable_across_cpu_threads():
    """The window dev kernel over 240 000 right rows, a size at which a
    whole-vector f64 sum on CPU torch gives other bits under other
    thread counts: its lanes are the same bytes under 1, 2, 3, 4, 6 and
    8 threads."""
    rng = np.random.default_rng(12)
    n, nl = 240_000, 5_000
    sv = torch.from_numpy(rng.uniform(10, 200, n))
    sv[torch.from_numpy(rng.integers(0, n, n // 100))] = float("nan")
    li = torch.from_numpy(rng.integers(0, n - 20, nl))
    ri = li + torch.from_numpy(rng.integers(0, 20, nl))
    ok = torch.from_numpy(rng.random(nl) < 0.9)
    saved = torch.get_num_threads()
    got = {}
    try:
        for threads in (1, 2, 3, 4, 6, 8):
            torch.set_num_threads(threads)
            got[threads] = ew._k_dev(sv, li, ri, ok, T.F64).numpy()
    finally:
        torch.set_num_threads(saved)
    assert np.isfinite(got[1][ok.numpy()]).mean() > 0.9
    for threads, lane in got.items():
        assert lane.tobytes() == got[1].tobytes(), threads


# -- exact integer window sums ------------------------------------------------

def test_integer_window_sum_is_exact_past_2_53():
    """An i64 window sum whose right column's prefix passes 2^53: the
    port's device path takes it as a difference of i64 prefix sums, so
    it equals the port's host path row for row (f64 prefix sums lost up
    to 4 in the last digits here). The reference device keeps its f64
    prefix sums (ROADMAP queue 3)."""
    rng = np.random.default_rng(53)
    nr, nl = 20_000, 20_000
    v = rng.integers(1 << 40, 1 << 41, nr).astype(np.int64)
    _rrt, prt = _runtimes({
        "tr": {"s": (np.zeros(nl, np.int64), "I64"),
               "ts": (np.arange(nl, dtype=np.int64), "I64")},
        "qt": {"s": (np.zeros(nr, np.int64), "I64"),
               "ts": (np.arange(nr, dtype=np.int64), "I64"),
               "v": (v, "I64")}})
    q = "(window-join1 [s ts] (map-left + [-2 2] (at tr 'ts)) tr qt " \
        "{w: (sum v)})"
    ew.last_profile.clear()
    got = prt.eval_str(q)
    assert ew.last_profile.get("engine") == "device-wjoin"
    dev.set_enabled(False)
    try:
        want = prt.eval_str(q)
    finally:
        dev.set_enabled(True)
    assert fmt(got) == fmt(want)
    col = symbols.intern("w")
    gv = to_np(got.v[1][list(to_np(got.v[0])).index(col)])
    wv = to_np(want.v[1][list(to_np(want.v[0])).index(col)])
    np.testing.assert_array_equal(gv, wv)
    lo = np.clip(np.arange(nl) - 2, 0, None)
    hi = np.clip(np.arange(nl) + 2, None, nr - 1)
    cs = np.concatenate([[0], np.cumsum(v)])
    np.testing.assert_array_equal(gv, cs[hi + 1] - cs[lo])


@pytest.mark.parametrize("lo_bits", [40, 61])
def test_k_sum_avg_integer_sum_wraps_like_numpy(lo_bits):
    """`_k_sum_avg` on an i64 column against a numpy i64 window sum:
    exact past 2^53, wrapping past 2^63 (lo_bits 61: three-row windows
    of values in [2^61, 2^62) overflow), with null rows propagating."""
    rng = np.random.default_rng(lo_bits)
    n = 20_000
    sv = rng.integers(1 << lo_bits, 1 << (lo_bits + 1), n).astype(np.int64)
    sv[rng.integers(0, n, 30)] = T.NULL_I64
    li = np.clip(np.arange(n - 3) - 1, 0, None).astype(np.int64)
    ri = (np.arange(n - 3) + 1).astype(np.int64)
    ok = np.ones(n - 3, bool)
    ok[::97] = False
    got = _np(ew._k_sum_avg(*_port_args(sv, li, ri, ok), T.I64, False))
    nulls = sv == T.NULL_I64
    with np.errstate(over="ignore"):
        cs = np.concatenate([[0], np.cumsum(np.where(nulls, 0, sv))])
        want = cs[ri + 1] - cs[li]
    cn = np.concatenate([[0], np.cumsum(nulls)])
    want = np.where((cn[ri + 1] - cn[li] > 0) | ~ok, T.NULL_I64, want)
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, want)
    if lo_bits == 61:
        wrapped = ok & (cn[ri + 1] - cn[li] == 0)
        assert (want[wrapped] < (1 << 61)).any()
