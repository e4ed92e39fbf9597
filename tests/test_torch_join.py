"""The port's device joins (rayforce_tpu_torch/engine/join.py: left,
inner and asof joins by one stable sort and a segmented scan) held
against the JAX package's: the same seeded numpy columns go into both
packages' tables, and each join's formatted output must match byte for
byte — reference device, port device and port host — with both packages
on their sort-merge engine. The port runs its device path on CPU torch
(`set_device("cpu")`), where the join's sort is the plain version of the
CUDA radix sort; the reference runs on JAX CPU with its device path
forced on, as tests/test_join_fuzz.py runs it. Match ids are compared
exactly."""
import json
import os
import random
from contextlib import contextmanager

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
from rayforce_tpu.engine import join as rej
from rayforce_tpu.engine import sort as res
from rayforce_tpu_torch import Runtime
from rayforce_tpu_torch.core import symbols, types as T
from rayforce_tpu_torch.core.errors import RayError, err_msg
from rayforce_tpu_torch.core.fmt import format_top as fmt
from rayforce_tpu_torch.core.obj import Obj, table, vec_sym
from rayforce_tpu_torch.engine import device as dev
from rayforce_tpu_torch.engine import join as ej
from rayforce_tpu_torch.engine import psort
from rayforce_tpu_torch.engine import sort as es

torch.set_num_threads(1)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "joins.json")


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


# -- both packages' tables ----------------------------------------------------

def _cols(cols):
    """([reference columns], [port columns]) from {name: (array, type
    name)}: "SYMBOL" arrays hold names ("" is the null symbol); an
    ("ENUM", domain pair) type holds codes into a domain shared by every
    column that names the same pair."""
    rcols, pcols = [], []
    for a, tn in cols.values():
        if tn == "SYMBOL":
            rcols.append(RObj(RT.SYMBOL, np.asarray(
                [rsymbols.intern(s) if s else RT.NULL_I64 for s in a],
                dtype=np.int64)))
            pcols.append(Obj(T.SYMBOL, np.asarray(
                [symbols.intern(s) if s else T.NULL_I64 for s in a],
                dtype=np.int64)))
        elif isinstance(tn, tuple):
            rdom, pdom = tn[1]
            rcols.append(RObj(RT.ENUM, a.copy(), domain=rdom))
            pcols.append(Obj(T.ENUM, a.copy(), domain=pdom))
        else:
            rcols.append(RObj(getattr(RT, tn), a.copy()))
            pcols.append(Obj(getattr(T, tn), a.copy()))
    return rcols, pcols


def enum_domain(names):
    """One symbol domain in each package, for ("ENUM", domain) columns."""
    return (RObj(RT.SYMBOL, np.asarray([rsymbols.intern(s) for s in names],
                                       dtype=np.int64)),
            Obj(T.SYMBOL, np.asarray([symbols.intern(s) for s in names],
                                     dtype=np.int64)))


def runtimes(tables):
    """(reference Runtime, port Runtime), each holding the tables
    {name: {column: (array, type name)}}."""
    rrt, prt = RefRuntime(), Runtime()
    for name, cols in tables.items():
        rcols, pcols = _cols(cols)
        rrt.interp.globals[rsymbols.intern(name)] = rtable(
            rvec_sym(list(cols)), rcols)
        prt.interp.globals[symbols.intern(name)] = table(
            vec_sym(list(cols)), pcols)
    return rrt, prt


@contextmanager
def sort_calls():
    """[(n_keys, words)] of every call of the psort entry's CPU route."""
    calls = []
    plain = psort.sort_i32_plain

    def counting(words, n_keys=1, perm=False):
        calls.append((n_keys, len(words)))
        return plain(words, n_keys, perm=perm)

    psort.sort_i32_plain = counting
    try:
        yield calls
    finally:
        psort.sort_i32_plain = plain


def check(rrt, prt, q, engine="device-sortmerge"):
    """Reference device == port device == port host, formatted; both
    devices ran `engine` and the port's run went through the psort
    entry. Returns the port's sort calls and its output."""
    rmod, pmod = (rej, ej) if engine == "device-sortmerge" else (res, es)
    rdev.set_enabled(True)
    rmod.last_profile.clear()
    r = ref_fmt(rrt.eval_str(q))
    pmod.last_profile.clear()
    with sort_calls() as calls:
        p = fmt(prt.eval_str(q))
    assert rmod.last_profile.get("engine") == engine, q
    assert pmod.last_profile.get("engine") == engine, q
    assert calls, q
    dev.set_enabled(False)
    try:
        h = fmt(prt.eval_str(q))
    finally:
        dev.set_enabled(True)
    assert p == r, f"{q}\nPORT:\n{p}\nREFERENCE:\n{r}"
    assert p == h, f"{q}\nPORT DEVICE:\n{p}\nPORT HOST:\n{h}"
    return calls, p


# -- tests/test_join_fuzz.py, through both packages ---------------------------

FUZZ = [
    "(left-join [k1] l r)",
    "(inner-join [k1] l r)",
    "(left-join [k1 k2] l r)",
    "(inner-join [k1 k2] l r)",
    "(asof-join [k1 ts] l r)",
    "(asof-join [k1 k2 ts] l r)",
]

_FUZZ_RT: dict = {}


def _fuzz_runtimes(seed, with_nulls):
    """test_join_fuzz's tables for (seed, with_nulls), drawn in its
    order."""
    key = (seed, with_nulls)
    if key not in _FUZZ_RT:
        rng = np.random.default_rng(1000 + seed)
        rnd = random.Random(1000 + seed)
        nl = rnd.choice([800, 2500])
        nr = rnd.choice([300, 1700])
        k1l = rng.integers(0, 40, nl).astype(np.int64)
        k1r = rng.integers(0, 60, nr).astype(np.int64)
        k2l = rng.integers(-5, 5, nl).astype(np.int64)
        k2r = rng.integers(-5, 5, nr).astype(np.int64)
        if with_nulls:
            k1l[rng.integers(0, nl, max(nl // 30, 1))] = T.NULL_I64
            k1r[rng.integers(0, nr, max(nr // 30, 1))] = T.NULL_I64
        tl = rng.integers(0, 100_000, nl).astype(np.int64)
        tr = np.sort(rng.integers(0, 100_000, nr)).astype(np.int64)
        lv = rng.uniform(0, 10, nl)
        rv = rng.uniform(0, 10, nr)
        w = rng.integers(0, 1000, nr).astype(np.int64)
        _FUZZ_RT[key] = runtimes({
            "l": {"k1": (k1l, "I64"), "k2": (k2l, "I64"),
                  "ts": (tl, "I64"), "lv": (lv, "F64")},
            "r": {"k1": (k1r, "I64"), "k2": (k2r, "I64"),
                  "ts": (tr, "I64"), "rv": (rv, "F64"),
                  "w": (w, "I64")}})
    return _FUZZ_RT[key]


@pytest.mark.parametrize("q", FUZZ)
@pytest.mark.parametrize("with_nulls", [False, True])
@pytest.mark.parametrize("seed", range(4))
def test_join_fuzz(seed, with_nulls, q):
    check(*_fuzz_runtimes(seed, with_nulls), q)


def test_asof_packed_tie_rule():
    """A right row at exactly the left row's time matches, and among
    equal-time rights the last wins (core/index.c:3194-3266), on the
    packed (code, time, side) key: one i64 key, two i32 words."""
    rrt, prt = runtimes({
        "r": {"k": (np.array([1, 1, 1, 2]), "I64"),
              "ts": (np.array([10, 10, 20, 15]), "I64"),
              "rv": (np.array([100, 200, 300, 400]), "I64")},
        "l": {"k": (np.array([1, 1, 1, 1, 2]), "I64"),
              "ts": (np.array([10, 19, 20, 5, 15]), "I64")}})
    calls, p = check(rrt, prt, "(asof-join [k ts] l r)")
    assert calls == [(2, 2)]
    assert "200" in p and "300" in p and "400" in p


def test_asof_unsorted_right_times_follow_the_reference_device():
    """With right times not ascending within a key, the device match is
    the largest right row id at or before the left time (a prefix max
    of positions), as on the reference's device; the host path takes
    the latest time instead (ROADMAP queue 3). The port's device answer
    is held to the reference's device answer."""
    rng = np.random.default_rng(8)
    nl, nr = 500, 300
    rrt, prt = runtimes({
        "r": {"k": (rng.integers(0, 6, nr).astype(np.int64), "I64"),
              "ts": (rng.integers(0, 1000, nr).astype(np.int64), "I64"),
              "rv": (np.arange(nr, dtype=np.int64), "I64")},
        "l": {"k": (rng.integers(0, 6, nl).astype(np.int64), "I64"),
              "ts": (rng.integers(0, 1000, nl).astype(np.int64), "I64")}})
    q = "(asof-join [k ts] l r)"
    r = ref_fmt(rrt.eval_str(q))
    assert rej.last_profile.get("engine") == "device-sortmerge"
    assert fmt(prt.eval_str(q)) == r
    dev.set_enabled(False)
    try:
        assert fmt(prt.eval_str(q)) != r
    finally:
        dev.set_enabled(True)


# -- tests/test_device_parity.py's join rows, on its fixture ------------------

@pytest.fixture(scope="module")
def parity():
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
    NR = 2500
    r_id3 = rng.integers(0, 2400, NR).astype(np.int64)
    r_w = rng.uniform(0, 10, NR)
    r_ts = np.sort(rng.integers(0, 1_000_000, NR)).astype(np.int64)
    lt_id3 = rng.integers(0, 2400, N).astype(np.int64)
    lt_ts = np.sort(rng.integers(0, 1_000_000, N)).astype(np.int64)
    return runtimes({
        "t": {"id1": (id1, "I64"), "id3": (id3, "I64"), "v1": (v1, "I64"),
              "v2": (v2, "I32"), "v3": (v3, "F64"), "big": (big, "I64")},
        "r": {"id3": (r_id3, "I64"), "w": (r_w, "F64"),
              "ts": (r_ts, "I64")},
        "lt": {"id3": (lt_id3, "I64"), "ts": (lt_ts, "I64")}})


@pytest.mark.parametrize("q", ["(inner-join [id3] t r)",
                               "(left-join [id3] t r)",
                               "(asof-join [id3 ts] lt r)"])
def test_device_parity_joins(parity, q):
    check(*parity, q)


# -- tests/golden/joins.json through the port at threshold 1 -----------------

with open(GOLDEN) as _f:
    _GOLDEN = sorted(json.load(_f).items())


@pytest.fixture
def fresh_symbols():
    """Each golden case starts from the symbol table of a fresh process,
    as the oracle recorded it (symbols compare by id)."""
    Runtime()
    base = symbols.count()
    yield
    for name in symbols._by_id[base:]:
        del symbols._by_name[name]
    del symbols._by_id[base:]


@pytest.mark.parametrize("name,case", _GOLDEN, ids=[k for k, _ in _GOLDEN])
def test_golden_joins_on_the_device(fresh_symbols, name, case):
    """Every join golden with the port's device path on from one row:
    ij, lj and aj on the sort-merge engine, and the window joins' right
    table sorted by the device xasc."""
    rt = Runtime()
    ej.last_profile.clear()
    es.last_profile.clear()
    try:
        result = None
        for s in case["stmts"]:
            result = rt.eval_str(s)
        got = rt.format_result(result)
    except RayError as e:
        got = "ERROR:" + err_msg(e)
    assert got == case["expect"]
    if "window-join" in case["stmts"][-1]:
        assert es.last_profile.get("engine") == "device-sort"
    else:
        assert ej.last_profile.get("engine") == "device-sortmerge"


# -- match ids, route by route ------------------------------------------------

def _key_objs(arrays, tn="I64"):
    ref, port = [], []
    for a in arrays:
        if isinstance(tn, tuple):
            ref.append(RObj(RT.ENUM, a.copy(), domain=tn[1][0]))
            port.append(Obj(T.ENUM, a.copy(), domain=tn[1][1]))
        else:
            ref.append(RObj(getattr(RT, tn), a.copy()))
            port.append(Obj(getattr(T, tn), a.copy()))
    return ref, port


def _route(name, rng):
    """(left key arrays, right key arrays, time pair or None, type,
    expected (n_keys, words) of the port's sort) for one route."""
    nl, nr = 3000, 1200

    def ints(n, lo, hi):
        return rng.integers(lo, hi, n).astype(np.int64)

    def times(n, lo, hi):
        return np.sort(ints(n, lo, hi))
    if name == "narrow":
        return [ints(nl, 0, 900)], [ints(nr, 0, 1400)], None, "I64", (1, 1)
    if name == "nullable":
        lk, rk = ints(nl, -50, 50), ints(nr, -40, 60)
        lk[::17] = T.NULL_I64
        rk[::23] = T.NULL_I64
        return [lk], [rk], None, "I64", (1, 1)
    if name == "multi_key":
        lk = [ints(nl, 0, 30), ints(nl, -3, 3), ints(nl, 0, 5)]
        rk = [ints(nr, 0, 40), ints(nr, -3, 3), ints(nr, 0, 5)]
        lk[1][::31] = T.NULL_I64
        return lk, rk, None, "I64", (1, 1)
    if name == "wide_code":
        # a code range above 2^31: the code rides as two i32 words
        lk = [ints(nl, 0, 1 << 20) << 20, ints(nl, 0, 3)]
        rk = [lk[0][rng.integers(0, nl, nr)], ints(nr, 0, 3)]
        return lk, rk, None, "I64", (2, 2)
    if name == "enum":
        dom = enum_domain([f"e{i}" for i in (5, 3, 9, 1, 0, 7, 2)])
        return [ints(nl, 0, 7)], [ints(nr, 0, 5)], None, ("ENUM", dom), \
            (1, 1)
    if name == "asof_packed":
        return [ints(nl, 0, 50)], [ints(nr, 0, 60)], \
            (ints(nl, 0, 10**6), times(nr, 0, 10**6)), "I64", (2, 2)
    if name == "asof_unpacked":
        # a time span of ~2^62 leaves no room for the packed key:
        # (code, time) sort as two keys, the code narrowed to one word
        return [ints(nl, 0, 50)], [ints(nr, 0, 60)], \
            (ints(nl, -2**61, 2**61), times(nr, -2**61, 2**61)), "I64", \
            (3, 3)
    assert name == "temporal"
    return [], [], (ints(nl, -10**5, 10**6), times(nr, 0, 10**6)), "I64", \
        (2, 2)


ROUTES = ["narrow", "nullable", "multi_key", "wide_code", "enum",
          "asof_packed", "asof_unpacked", "temporal"]


@pytest.mark.parametrize("route", ROUTES)
def test_match_ids_route(route):
    """match_ids_device against the reference's on seeded codes, exactly,
    and the port's sort took the route's key words."""
    rng = np.random.default_rng(ROUTES.index(route) + 77)
    lks, rks, tm, tn, shape = _route(route, rng)
    rl, pl = _key_objs(lks, tn)
    rr, pr = _key_objs(rks, tn)
    if tm is None:
        want = rej.match_ids_device(rl, rr)
        with sort_calls() as calls:
            got = ej.match_ids_device(pl, pr)
    else:
        (rlt,), (plt,) = _key_objs([tm[0]])
        (rrt_,), (prt_,) = _key_objs([tm[1]])
        want = rej.match_ids_device(rl, rr, ltime=rlt, rtime=rrt_,
                                    mode="asof")
        with sort_calls() as calls:
            got = ej.match_ids_device(pl, pr, ltime=plt, rtime=prt_,
                                      mode="asof")
    want = np.asarray(want)
    got = got.numpy()
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, want)
    assert calls == [shape]
    assert ej.last_profile["engine"] == "device-sortmerge"
    # the route must see both matches and misses
    assert (got == T.NULL_I64).any() and (got != T.NULL_I64).any()


def test_enum_keys_join():
    """An inner and a left join on enum keys sharing one domain."""
    rng = np.random.default_rng(3)
    dom = enum_domain(["m", "c", "x", "a", "q"])
    nl, nr = 900, 40
    rrt, prt = runtimes({
        "l": {"e": (rng.integers(0, 5, nl).astype(np.int64), ("ENUM", dom)),
              "v": (rng.integers(0, 100, nl).astype(np.int64), "I64")},
        "r": {"e": (rng.integers(0, 4, nr).astype(np.int64), ("ENUM", dom)),
              "w": (rng.uniform(0, 1, nr), "F64")}})
    check(rrt, prt, "(inner-join [e] l r)")
    check(rrt, prt, "(left-join [e] l r)")


# -- edge joins ---------------------------------------------------------------

def _edge_runtimes(lkeys, rkeys):
    rng = np.random.default_rng(len(lkeys) + len(rkeys))
    lkeys = np.asarray(lkeys, dtype=np.int64)
    rkeys = np.asarray(rkeys, dtype=np.int64)
    return runtimes({
        "l": {"k": (lkeys, "I64"),
              "v": (rng.integers(0, 9, len(lkeys)).astype(np.int64), "I64"),
              "s": (rng.uniform(0, 1, len(lkeys)), "F64")},
        "r": {"k": (rkeys, "I64"),
              "s": (rng.uniform(5, 6, len(rkeys)), "F64"),
              "w": (rng.integers(100, 200, len(rkeys)).astype(np.int32),
                    "I32")}})


IJ = "(inner-join [k] l r)"


def test_inner_join_no_match():
    rrt, prt = _edge_runtimes(np.arange(50) % 10, np.arange(100, 110))
    check(rrt, prt, IJ)
    assert len(prt.eval_str(IJ)) == 0


def test_inner_join_every_match():
    rrt, prt = _edge_runtimes(np.arange(60) % 7, np.arange(7)[::-1])
    check(rrt, prt, IJ)
    assert len(prt.eval_str(IJ)) == 60


def test_inner_join_one_right_row():
    rrt, prt = _edge_runtimes(np.arange(40) % 5, [3])
    check(rrt, prt, IJ)
    assert len(prt.eval_str(IJ)) == 8
    check(rrt, prt, "(left-join [k] l r)")


def test_left_join_every_row_matched_stays_typed():
    """A right-only column with every left row matched stays a typed
    vector (a lazy gather), not a LIST."""
    rrt, prt = _edge_runtimes(np.arange(30) % 6, [5, 0, 4, 1, 3, 2, 2])
    _, p = check(rrt, prt, "(left-join [k] l r)")
    assert "I32" in p and "LIST" not in p
    out = prt.eval_str("(left-join [k] l r)")
    assert out.v[1][-1].t == T.I32


def test_left_join_unmatched_rows_degrade_to_list():
    """With some left rows unmatched, the right-only column is a LIST of
    typed atoms and untyped nulls, lazy on the device until read."""
    rrt, prt = _edge_runtimes(np.arange(30) % 9, [5, 0, 4, 1])
    _, p = check(rrt, prt, "(left-join [k] l r)")
    assert "LIST" in p and "Null" in p
    out = prt.eval_str("(left-join [k] l r)")
    col = out.v[1][-1]
    assert col.t == T.LIST and col.pending() is not None


# -- the slice as a whole: bench.py's join tables at a small size -------------

@pytest.fixture(scope="module")
def bench_tables():
    """tools/jtables.py's tables at 20 000 G1 rows on CPU torch: the
    tables themselves (device-resident columns) and their numpy copies
    in both packages."""
    from rayforce_tpu_torch.core.obj import to_np
    from rayforce_tpu_torch.tools.jtables import join_tables
    tables = join_tables(20_000, "cpu")
    copies = {name: {symbols.name_of(int(s)): (
        to_np(c).copy(), "F64" if c.t == T.F64 else "I64")
        for s, c in zip(to_np(tbl.v[0]), tbl.v[1])}
        for name, tbl in tables.items()}
    prt = Runtime()
    for name, tbl in tables.items():
        prt.interp.globals[symbols.intern(name)] = tbl
    return prt, runtimes(copies)


@pytest.mark.parametrize("name", ["ij", "lj", "aj", "xasc", "xdesc"])
def test_bench_join_queries(bench_tables, name):
    """Each JOIN_QUERIES query: reference device == port device == port
    host on the tables' numpy copies; then on the tables themselves,
    every forced device lane equals the port host's column in full (a
    right-only LIST column as its values and match mask)."""
    from rayforce_tpu_torch.core.obj import to_np
    from rayforce_tpu_torch.tools.jtables import JOIN_QUERIES, force_columns
    prt, (rrt_c, prt_c) = bench_tables
    q, engine = JOIN_QUERIES[name]
    check(rrt_c, prt_c, q, engine)
    lanes = force_columns(prt.eval_str(q))
    dev.set_enabled(False)
    try:
        want = prt.eval_str(q)
    finally:
        dev.set_enabled(True)
    assert len(lanes) == len(want.v[1])
    for got, w in zip(lanes, want.v[1]):
        if w.t == T.LIST:
            has = np.array([x.t != -T.NULL for x in w.v])
            vals, mask = (a.numpy() for a in got)
            np.testing.assert_array_equal(mask, has)
            np.testing.assert_array_equal(
                vals[has], np.array([x.v for x in w.v if x.t != -T.NULL]))
        else:
            assert got[0].numpy().tobytes() == to_np(w).tobytes()


# -- faults on the card propagate; other errors take the host path -----------

@pytest.mark.parametrize("err, fault", [
    (RuntimeError("CUDA error: an illegal memory access was encountered"),
     True),
    (torch.OutOfMemoryError("CUDA out of memory"), True),
    (TypeError("a plan the engine cannot run"), False),
])
@pytest.mark.parametrize("q", ["(inner-join [k1] l r)",
                               "(asof-join [k1 ts] l r)", "(xdesc l [k2])"])
def test_hooks_raise_card_faults_only(monkeypatch, q, err, fault):
    from rayforce_tpu_torch.engine import select as sel

    def broken(words, n_keys=1, perm=False):
        raise err

    monkeypatch.setattr(psort, "sort_i32_plain", broken)
    seen = []
    monkeypatch.setattr(sel, "warn_fallback", seen.append)
    _rrt, prt = _fuzz_runtimes(1, True)
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


@pytest.mark.parametrize("q", ["(left-join [k1] l r)", "(xasc l [k1])"])
def test_no_card_raises(q):
    """With the engine on CUDA and no card, a join or table sort raises
    DeviceError instead of running quietly on the host."""
    _rrt, prt = _fuzz_runtimes(2, False)
    saved = dev._cfg["device"]
    dev._cfg["device"] = torch.device("cuda")
    try:
        if torch.cuda.is_available():
            pytest.skip("a card is present")
        with pytest.raises(dev.DeviceError):
            prt.eval_str(q)
    finally:
        dev._cfg["device"] = saved
