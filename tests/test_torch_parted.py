"""The port's parted partition-streaming selects (ops/query.py
_stream_device_select: per-partition device partials through the ported
try_select_device, combined on the host) held against the JAX package's
on equal databases: the same seeded numpy partitions, each package
writing its own DB with its own storage. Each query's formatted output
must match byte for byte across the port's device streaming, the port's
host path and the reference's device streaming (tests/
test_parted_matrix.py's shapes). The port runs its device path on CPU
torch (`set_device("cpu")`), the reference on JAX CPU."""
import threading

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
from rayforce_tpu.ops import query as RQ
from rayforce_tpu.storage import parted as RP
from rayforce_tpu_torch import Runtime
from rayforce_tpu_torch.core import symbols, types as T
from rayforce_tpu_torch.core.errors import RayError, err_msg
from rayforce_tpu_torch.core.fmt import format_top as fmt
from rayforce_tpu_torch.core.obj import Obj, table, vec_sym
from rayforce_tpu_torch.engine import device as dev
from rayforce_tpu_torch.engine import psort
from rayforce_tpu_torch.engine import select as sel
from rayforce_tpu_torch.ops import query as Q
from rayforce_tpu_torch.storage import parted as P

torch.set_num_threads(1)

NP_PER = 40
DAYS = ["2024.01.01", "2024.01.02", "2024.01.03", "2024.01.04",
        "2024.01.05"]
VCOLS = ["i16", "i32", "i64", "f64", "u8", "b8", "tm", "ts"]
NUMERIC = {"i16", "i32", "i64", "f64", "u8"}
ORDERED = NUMERIC | {"b8", "tm", "ts"}


@pytest.fixture(autouse=True, scope="module")
def _engines():
    rsaved, saved = dict(rdev._cfg), dict(dev._cfg)
    rq, q = RQ.STREAM_PARTED, Q.STREAM_PARTED
    rdev.set_enabled(True)
    rdev.set_threshold(1)
    dev.set_device("cpu")
    dev.set_threshold(1)
    RQ.STREAM_PARTED = True
    Q.STREAM_PARTED = True
    yield
    RQ.STREAM_PARTED, Q.STREAM_PARTED = rq, q
    rdev._cfg.clear()
    rdev._cfg.update(rsaved)
    dev._cfg.clear()
    dev._cfg.update(saved)


def _matrix_part(rng):
    """tests/test_parted_matrix.py's partition: every column type, two
    nulls in each nullable column, a symbol column of five names."""
    n = NP_PER
    i16 = rng.integers(-100, 100, n).astype(np.int16)
    i16[rng.integers(0, n, 2)] = T.NULL_I16
    i32 = rng.integers(-1000, 1000, n).astype(np.int32)
    i32[rng.integers(0, n, 2)] = T.NULL_I32
    i64 = rng.integers(-5000, 5000, n).astype(np.int64)
    i64[rng.integers(0, n, 2)] = T.NULL_I64
    f64 = rng.uniform(-50, 50, n)
    f64[rng.integers(0, n, 2)] = np.nan
    cols = {
        "i16": (i16, "I16"), "i32": (i32, "I32"), "i64": (i64, "I64"),
        "f64": (f64, "F64"),
        "u8": (rng.integers(0, 200, n).astype(np.uint8), "U8"),
        "b8": (rng.integers(0, 2, n).astype(np.int8), "B8"),
        "tm": (rng.integers(0, 86_400_000, n).astype(np.int32), "TIME"),
        "ts": (rng.integers(0, 10**15, n).astype(np.int64), "TIMESTAMP")}
    names = np.array(["ibm", "aapl", "msft", "tsla", "nvda"])
    return {"s": (names[rng.integers(0, 5, n)], "SYMBOL"), **cols}


def _nf_part(rng, pi):
    """tests/test_parted_matrix.py's null-free partition (the gate for
    the avg/dev sum and count partials); pno is the partition number."""
    n = NP_PER
    names = np.array(["ibm", "aapl", "msft"])
    return {"s": (names[rng.integers(0, 3, n)], "SYMBOL"),
            "i32": (rng.integers(-1000, 1000, n).astype(np.int32), "I32"),
            "i64": (rng.integers(-5000, 5000, n).astype(np.int64), "I64"),
            "f64": (rng.uniform(-50, 50, n), "F64"),
            "u8": (rng.integers(0, 200, n).astype(np.uint8), "U8"),
            "pno": (np.full(n, pi, dtype=np.int64), "I64")}


def _tables(cols):
    """(reference table, port table) of {name: (array, type name)}."""
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
    return (rtable(rvec_sym(list(cols)), rcols),
            table(vec_sym(list(cols)), pcols))


def _databases(tmp_path_factory, make_part, seed):
    """(reference Runtime, port Runtime), each with its own DB of the same
    partitions loaded as `pt`."""
    root = tmp_path_factory.mktemp("parted")
    rrt, prt = RefRuntime(), Runtime()
    rng = np.random.default_rng(seed)
    for i, day in enumerate(DAYS):
        rtab, ptab = _tables(make_part(rng, i))
        RP.set_parted(str(root / "ref"), day, "q", rtab, interp=rrt.interp)
        P.set_parted(str(root / "port"), day, "q", ptab, interp=prt.interp)
    rrt.interp.globals[rsymbols.intern("pt")] = RP.get_parted(
        str(root / "ref"), "q", interp=rrt.interp)
    prt.interp.globals[symbols.intern("pt")] = P.get_parted(
        str(root / "port"), "q", interp=prt.interp)
    return rrt, prt


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    return _databases(tmp_path_factory, lambda rng, i: _matrix_part(rng), 77)


@pytest.fixture(scope="module")
def env_nf(tmp_path_factory):
    return _databases(tmp_path_factory, _nf_part, 177)


@pytest.fixture
def streamed(monkeypatch):
    """[whether each call of the port's _stream_device_select answered]."""
    calls = []
    real = Q._stream_device_select

    def probe(*a):
        r = real(*a)
        calls.append(r is not None)
        return r

    monkeypatch.setattr(Q, "_stream_device_select", probe)
    return calls


def check(rrt, prt, q, ref=True):
    """Port device streaming == port host (== reference device streaming
    with `ref`), formatted. Each new query shape costs the reference a
    JAX compile of about a second, so the matrices hold the first column
    of each shape against it."""
    p = fmt(prt.eval_str(q))
    dev.set_enabled(False)
    try:
        h = fmt(prt.eval_str(q))
    finally:
        dev.set_enabled(True)
    assert p == h, f"{q}\nPORT DEVICE:\n{p}\nPORT HOST:\n{h}"
    if ref:
        r = ref_fmt(rrt.eval_str(q))
        assert p == r, f"{q}\nPORT:\n{p}\nREFERENCE:\n{r}"


@pytest.mark.parametrize("agg", ["sum", "min", "max", "first", "last",
                                 "count"])
def test_matrix_device_streaming(env, streamed, agg):
    """Every combine-decomposable aggregate over four column types, by a
    symbol and by the virtual Date, with and without a where."""
    cols = (VCOLS if agg in ("first", "last", "count")
            else [c for c in VCOLS if c in
                  (NUMERIC if agg == "sum" else ORDERED)])
    for c in cols[:4]:
        for by in [" by: s", " by: Date"]:
            for wh in ["", " where: (> i32 0)"]:
                check(*env, f"(select {{o: ({agg} {c}) from: pt{by}{wh}}})",
                      ref=c == cols[0])
    assert streamed and all(streamed)


@pytest.mark.parametrize("agg", ["avg", "dev"])
def test_avg_dev_partials_null_free(env_nf, streamed, agg):
    """avg and dev stream as sum, count (and sum of squares) partials over
    stats-known null-free columns."""
    for c in ["i64", "f64", "u8"]:
        for by in [" by: s", " by: Date"]:
            for wh in ["", " where: (> i32 0)"]:
                check(*env_nf, f"(select {{o: ({agg} {c}) m: (max {c}) "
                               f"from: pt{by}{wh}}})", ref=c == "i64")
    assert streamed and all(streamed)


@pytest.mark.parametrize("agg", ["avg", "dev"])
def test_avg_dev_partials_nullable(env, streamed, agg):
    """Nullable columns stream too: null-skipping derived sums and a
    non-null count lane."""
    for c in ["i16", "i64", "f64"]:
        for by in [" by: s", " by: Date"]:
            for wh in ["", " where: (!= i32 0Ni)"]:
                check(*env, f"(select {{o: ({agg} {c}) m: (max {c}) "
                            f"from: pt{by}{wh}}})", ref=c == "i16")
    assert streamed and all(streamed)


def test_all_filtered_partitions(env_nf, streamed):
    """Partitions 2-4 filtered out entirely contribute nothing; the query
    still streams."""
    check(*env_nf, "(select {s: (sum i64) a: (avg f64) from: pt by: s "
                   "where: (< pno 2)})")
    assert streamed == [True]


def test_every_partition_runs_on_the_device(env, monkeypatch):
    """Each partition's partial comes from the device select and goes
    through the psort entry."""
    seen = []
    real = sel.try_select_device

    def watched(*a, **k):
        before = psort.LAUNCHES["radix_sort"]
        calls = []
        plain = psort.sort_i32_plain

        def counting(words, n_keys=1, perm=False):
            calls.append(n_keys)
            return plain(words, n_keys, perm=perm)

        psort.sort_i32_plain = counting
        try:
            r = real(*a, **k)
        finally:
            psort.sort_i32_plain = plain
        seen.append((r is not None and not isinstance(r, str), len(calls)))
        assert psort.LAUNCHES["radix_sort"] == before   # no card here
        return r

    _rrt, prt = env
    monkeypatch.setattr(sel, "try_select_device", watched)
    q = "(select {s: (sum i64) x: (max f64) from: pt by: s " \
        "where: (> i32 -2000)})"
    prt.interp.globals[symbols.intern("pt")].meta.pop("_stream_warm", None)
    prt.eval_str(q)
    assert len(seen) == len(DAYS)
    assert all(ok and n > 0 for ok, n in seen)


def test_warm_plans_dispatch_concurrently(env_nf, monkeypatch):
    """A query's second run dispatches its partitions from a thread pool;
    its result equals the serial first run's and the host path's."""
    rrt, prt = env_nf
    pt = prt.interp.globals[symbols.intern("pt")]
    q = "(select {s: (sum i64) a: (avg f64) mx: (max i32) from: pt by: s})"
    pt.meta.pop("_stream_warm", None)
    threads = []
    real = sel.try_select_device

    def watched(*a, **k):
        threads.append(threading.current_thread() is threading.main_thread())
        return real(*a, **k)

    monkeypatch.setattr(sel, "try_select_device", watched)
    cold = fmt(prt.eval_str(q))
    assert threads == [True] * len(DAYS)
    threads.clear()
    warm = fmt(prt.eval_str(q))
    assert len(threads) == len(DAYS) and not any(threads)
    assert warm == cold
    check(rrt, prt, q)


# -- tests/golden/parted_oracle.json with the device streaming --------------

def _parted_golden():
    import json
    import os
    path = os.path.join(os.path.dirname(__file__), "golden",
                        "parted_oracle.json")
    with open(path) as f:
        return sorted(json.load(f).items())


PARTED_GOLDEN = _parted_golden()


@pytest.fixture
def fresh_symbols():
    Runtime()
    base = symbols.count()
    yield
    for name in symbols._by_id[base:]:
        del symbols._by_name[name]
    del symbols._by_id[base:]


@pytest.mark.parametrize("name,case", PARTED_GOLDEN,
                         ids=[k for k, _ in PARTED_GOLDEN])
def test_parted_golden_with_the_device(fresh_symbols, streamed, tmp_path,
                                       name, case):
    """The parted oracle goldens through the port with the device path on
    from one row and streaming forced: grouped selects over the parted
    table stream their partitions on the device. Scratch paths under
    /tmp point at a per-test directory."""
    rt = Runtime()
    try:
        result = None
        for s in case["stmts"]:
            result = rt.eval_str(s.replace("/tmp/", f"{tmp_path}/"))
        got = rt.format_result(result)
    except RayError as e:
        got = "ERROR:" + err_msg(e)
    assert got == case["expect"]
    if "by:" in case["stmts"][-1]:
        assert streamed and all(streamed)
