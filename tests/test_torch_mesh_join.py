"""Whole joins, table sorts and window joins on the port's device mesh,
held against the JAX package's: the same Rayfall runs through
`rayforce_tpu.Runtime` and `rayforce_tpu_torch.Runtime`, both with
RAYFORCE_MESH=8, threshold 1 and the device on (the reference over its 8
virtual CPU devices, the port over 8 shards of CPU torch). The formatted
output must be equal byte for byte, and equal to the port's host path;
both packages must have run the same engine (dist-bcast-probe, dist-eq,
dist-asof, dist-sort, dist-wjoin, or where the mesh declines the shape
the one-device engine) and noted the same exchanged bytes and kernel
calls in `dist.stats`. The counterparts of tests/test_dist.py's
test_mesh_join_parity, test_mesh_partitioned_join_parity,
test_mesh_asof_join_parity, test_mesh_sort_parity,
test_mesh_window_join_parity and test_mesh_join_fuzz."""
import random

import numpy as np
import pytest
import torch

from rayforce_tpu.core.fmt import format_top as ref_fmt
from rayforce_tpu.engine import device as rdev
from rayforce_tpu.engine import join as rej
from rayforce_tpu.engine import sort as res
from rayforce_tpu.engine import wjoin as rew
from rayforce_tpu.parallel import dist as rdist
from rayforce_tpu_torch.core import types as T
from rayforce_tpu_torch.core.fmt import format_top as fmt
from rayforce_tpu_torch.engine import device as dev
from rayforce_tpu_torch.engine import join as ej
from rayforce_tpu_torch.engine import select as sel
from rayforce_tpu_torch.engine import sort as es
from rayforce_tpu_torch.engine import wjoin as ew
from rayforce_tpu_torch.parallel import dist as pdist
from test_join_fuzz import QUERIES, _mk_tables
from test_torch_join import runtimes
from test_torch_mesh import _port_twin, mesh_env

torch.set_num_threads(1)


@pytest.fixture(autouse=True, scope="module")
def _engines():
    import jax
    if len(jax.devices()) < 8:
        pytest.skip("the reference needs 8 virtual devices")
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


@pytest.fixture(autouse=True)
def _mesh():
    with mesh_env(8):
        yield


def _profiles(q):
    """(reference, port) last_profile of the engine that runs q."""
    if q.startswith(("(xasc", "(xdesc")):
        return res.last_profile, es.last_profile
    if q.startswith("(window-join"):
        return rew.last_profile, ew.last_profile
    return rej.last_profile, ej.last_profile


def check(rrt, prt, q, engine=None, host=True):
    """Reference device == port device (== port host), formatted; both
    packages ran the same engine (`engine` where given) and noted the
    same exchange. Returns the port's output."""
    rprof, pprof = _profiles(q)
    rdist.reset_stats()
    pdist.reset_stats()
    rprof.clear()
    pprof.clear()
    rdev.set_enabled(True)
    dev.set_enabled(True)
    r = ref_fmt(rrt.eval_str(q))
    p = fmt(prt.eval_str(q))
    got = pprof.get("engine")
    assert got == rprof.get("engine"), (q, got, rprof.get("engine"))
    if engine is not None:
        assert got == engine, q
    assert dict(pdist.stats) == dict(rdist.stats), q
    assert p == r, f"{q}\nPORT:\n{p}\nREFERENCE:\n{r}"
    if host:
        dev.set_enabled(False)
        try:
            h = fmt(prt.eval_str(q))
        finally:
            dev.set_enabled(True)
        assert p == h, f"{q}\nPORT DEVICE:\n{p}\nPORT HOST:\n{h}"
    return p


# -- the broadcast-build and partitioned-build probes -------------------------

def _join_runtimes(seed, nl, lk_hi, nr, rk_hi):
    rng = np.random.default_rng(seed)
    return runtimes({
        "l": {"k": (rng.integers(0, lk_hi, nl).astype(np.int64), "I64"),
              "v": (rng.uniform(0, 10, nl), "F64")},
        "r": {"k": (rng.permutation(rk_hi)[:nr].astype(np.int64), "I64"),
              "w": (rng.integers(0, 1000, nr).astype(np.int64), "I64")}})


@pytest.mark.parametrize("q", ["(left-join [k] l r)", "(inner-join [k] l r)"])
def test_mesh_join_parity(q):
    check(*_join_runtimes(31, 8 * 600 + 3, 400, 300, 800), q,
          "dist-bcast-probe")


@pytest.mark.parametrize("q", ["(left-join [k] l r)", "(inner-join [k] l r)"])
def test_mesh_partitioned_join_parity(q):
    """bcast_max = 0 in both packages: every right side is partitioned."""
    rrt, prt = _join_runtimes(131, 8 * 600 + 3, 2000, 8 * 550 + 1, 4000)
    rsaved, saved = rdev._cfg.get("bcast_max"), dev._cfg["bcast_max"]
    rdev._cfg["bcast_max"] = dev._cfg["bcast_max"] = 0
    try:
        check(rrt, prt, q, "dist-eq")
    finally:
        dev._cfg["bcast_max"] = saved
        if rsaved is None:
            rdev._cfg.pop("bcast_max", None)
        else:
            rdev._cfg["bcast_max"] = rsaved


def test_bcast_max_picks_the_probe():
    """Right sides over bcast_max rows take the partitioned probe."""
    assert dev._cfg["bcast_max"] == 1 << 22
    rrt, prt = _join_runtimes(5, 900, 300, 200, 400)
    saved = dev._cfg["bcast_max"]
    try:
        dev._cfg["bcast_max"] = 200
        prt.eval_str("(left-join [k] l r)")
        assert ej.last_profile["engine"] == "dist-bcast-probe"
        dev._cfg["bcast_max"] = 199
        prt.eval_str("(left-join [k] l r)")
        assert ej.last_profile["engine"] == "dist-eq"
    finally:
        dev._cfg["bcast_max"] = saved


# -- the ring asof probe -------------------------------------------------------

def _asof_runtimes(seed, nl, nr, sorted_times=True, hi=1 << 20, keys=50):
    rng = np.random.default_rng(seed)

    def ts(n):
        t = rng.integers(0, hi, n)
        return (np.sort(t) if sorted_times else t).astype(np.int64)
    return runtimes({
        "tr": {"s": (rng.integers(0, keys, nl).astype(np.int64), "I64"),
               "ts": (ts(nl), "I64"),
               "q": (rng.integers(1, 10, nl).astype(np.int64), "I64")},
        "qt": {"s": (rng.integers(0, keys, nr).astype(np.int64), "I64"),
               "ts": (ts(nr), "I64"),
               "px": (rng.uniform(1, 100, nr), "F64")}})


def test_mesh_asof_join_parity():
    check(*_asof_runtimes(41, 8 * 400 + 5, 8 * 700 + 3),
          "(asof-join [s ts] tr qt)", "dist-asof")


def test_mesh_asof_unsorted_right_times():
    """Right times not ascending within a key: the mesh's ring probe takes
    the latest time at or before the left time (the one-device engine
    takes the largest right row id instead, ROADMAP queue 3), in both
    packages."""
    rrt, prt = _asof_runtimes(43, 8 * 300 + 1, 8 * 500 + 7,
                              sorted_times=False, hi=3000)
    q = "(asof-join [s ts] tr qt)"
    p = check(rrt, prt, q, "dist-asof", host=False)
    with mesh_env(1):
        one = fmt(prt.eval_str(q))
        assert ej.last_profile["engine"] == "device-sortmerge"
    assert one != p


def test_mesh_asof_unsorted_distinct_times_match_the_host():
    """With distinct right times the latest one at or before is also the
    host path's answer."""
    rng = np.random.default_rng(45)
    nl, nr = 8 * 300 + 1, 8 * 500 + 7
    times = rng.permutation(1 << 20)[:nl + nr].astype(np.int64)
    rrt, prt = runtimes({
        "tr": {"s": (rng.integers(0, 30, nl).astype(np.int64), "I64"),
               "ts": (times[:nl], "I64")},
        "qt": {"s": (rng.integers(0, 30, nr).astype(np.int64), "I64"),
               "ts": (times[nl:], "I64"),
               "px": (rng.uniform(1, 100, nr), "F64")}})
    check(rrt, prt, "(asof-join [s ts] tr qt)", "dist-asof", host=True)


def test_mesh_asof_declines_a_code_bound_of_2_31():
    """Key codes at 2^31 and over do not fit the ring probe's packed key:
    both packages decline to their one-device engine, same answer."""
    rng = np.random.default_rng(47)
    nl, nr = 8 * 200 + 3, 8 * 300 + 1
    big = np.array([0, 1 << 31], dtype=np.int64)
    rrt, prt = runtimes({
        "tr": {"s": (big[rng.integers(0, 2, nl)], "I64"),
               "ts": (np.sort(rng.integers(0, 10**6, nl)).astype(np.int64),
                      "I64")},
        "qt": {"s": (big[rng.integers(0, 2, nr)], "I64"),
               "ts": (np.sort(rng.integers(0, 10**6, nr)).astype(np.int64),
                      "I64"),
               "px": (rng.uniform(1, 100, nr), "F64")}})
    check(rrt, prt, "(asof-join [s ts] tr qt)", "device-sortmerge")


def test_keyless_asof_runs_one_device():
    """An asof join on the time alone has no key to partition by: it runs
    the one-device engine under a mesh, in both packages."""
    rng = np.random.default_rng(48)
    rrt, prt = runtimes({
        "tr": {"ts": (np.sort(rng.integers(0, 10**6, 900)).astype(np.int64),
                      "I64")},
        "qt": {"ts": (np.sort(rng.integers(0, 10**6, 700)).astype(np.int64),
                      "I64"),
               "px": (rng.uniform(1, 100, 700), "F64")}})
    check(rrt, prt, "(asof-join [ts] tr qt)", "device-sortmerge")


# -- the sample sort ------------------------------------------------------------

@pytest.fixture(scope="module")
def sort_runtimes():
    rng = np.random.default_rng(55)
    n = 8 * 900 + 5
    k1 = rng.integers(0, 12, n).astype(np.int64)
    k1[rng.integers(0, n, 60)] = T.NULL_I64
    k2 = rng.integers(-4, 4, n).astype(np.int32)
    v = rng.uniform(-50, 50, n)
    v[rng.integers(0, n, 60)] = np.nan
    v[rng.integers(0, n, 20)] = -0.0
    ts = rng.integers(0, 10**6, n).astype(np.int64)
    s = rng.choice(["ibm", "aapl", "msft", "goog", ""], n)
    return runtimes({"t": {"k1": (k1, "I64"), "k2": (k2, "I32"),
                           "v": (v, "F64"), "ts": (ts, "I64"),
                           "s": (s, "SYMBOL")}})


@pytest.mark.parametrize("q", ["(xasc t [k1])", "(xasc t [k1 k2])",
                               "(xdesc t [k2 v])", "(xasc t [v])",
                               "(xasc t [s ts])", "(xdesc t [k1 ts v])"])
def test_mesh_sort_parity(sort_runtimes, q):
    check(*sort_runtimes, q, "dist-sort")


@pytest.mark.parametrize("err, fault", [
    (dev.DeviceError("a kernel failed to launch"), True),
    (TypeError("a plan the mesh cannot run"), False)])
def test_mesh_sort_faults_propagate(sort_runtimes, monkeypatch, err, fault):
    """A device fault inside dist_sort reaches the caller; any other error
    falls back to the one-device sort, as in the reference."""
    _rrt, prt = sort_runtimes
    seen = []

    def broken(*a, **kw):
        def run(*keys):
            raise err
        return run

    monkeypatch.setattr(pdist, "dist_sort", broken)
    monkeypatch.setattr(sel, "warn_fallback", seen.append)
    if fault:
        with pytest.raises(dev.DeviceError):
            prt.eval_str("(xasc t [k1 ts])")
        assert seen == []
        return
    p = fmt(prt.eval_str("(xasc t [k1 ts])"))
    assert seen == [err]
    assert es.last_profile["engine"] == "device-sort"
    dev.set_enabled(False)
    try:
        assert fmt(prt.eval_str("(xasc t [k1 ts])")) == p
    finally:
        dev.set_enabled(True)


# -- the mesh window join -------------------------------------------------------

@pytest.fixture(scope="module")
def wj_runtimes():
    rng = np.random.default_rng(91)
    nl, nr = 8 * 300 + 5, 8 * 500 + 3
    p = rng.uniform(-100, 100, nr)
    p[rng.integers(0, nr, nr // 25)] = np.nan
    q = rng.integers(-50, 50, nr).astype(np.int64)
    q[rng.integers(0, nr, nr // 25)] = T.NULL_I64
    return runtimes({
        "tr": {"s": (rng.integers(0, 23, nl).astype(np.int64), "I64"),
               "ts": (np.sort(rng.integers(0, 50_000, nl)).astype(np.int64),
                      "I64")},
        "qt": {"s": (rng.integers(0, 23, nr).astype(np.int64), "I64"),
               "ts": (np.sort(rng.integers(0, 50_000, nr)).astype(np.int64),
                      "I64"),
               "p": (p, "F64"), "q": (q, "I64")}})


@pytest.mark.parametrize("aggs", [
    "{mx: (max p) mn: (min p) c: (count p)}",
    "{s: (sum q) a: (avg p) d: (dev p)}",
    "{f: (first p) l: (last q) mq: (max q)}"])
@pytest.mark.parametrize("fn, w", [("window-join", (-1000, 1000)),
                                   ("window-join", (-5000, 0)),
                                   ("window-join1", (-1000, 1000)),
                                   ("window-join1", (0, 0))])
def test_mesh_window_join_parity(wj_runtimes, fn, w, aggs):
    q = (f"({fn} [s ts] (map-left + [{w[0]} {w[1]}] (at tr 'ts)) tr qt "
         f"{aggs})")
    check(*wj_runtimes, q, "dist-wjoin")


# -- tests/test_join_fuzz.py's tables and queries on the mesh ------------------

@pytest.mark.parametrize("seed", range(4))
def test_mesh_join_fuzz(seed):
    """tests/test_dist.py's test_mesh_join_fuzz through both packages: its
    join queries (duplicate right keys, null keys with odd seeds), two
    multi-key sorts and two window joins."""
    from rayforce_tpu import Runtime as RefRuntime
    from rayforce_tpu.core import symbols as rsymbols
    from rayforce_tpu.core import types as RT
    from rayforce_tpu.core.obj import Obj as RObj, table as rtable, \
        vec_sym as rvec_sym
    from rayforce_tpu_torch import Runtime
    rng = np.random.default_rng(3100 + seed)
    rnd = random.Random(3100 + seed)
    nl = rnd.choice([8 * 150 + 3, 8 * 320 + 1])
    nr = rnd.choice([8 * 100 + 5, 8 * 260 + 7])
    lt, rt_ = _mk_tables(rng, nl, nr, with_nulls=bool(seed % 2))
    rrt, prt = RefRuntime(), Runtime()
    rrt.interp.globals[rsymbols.intern("l")] = lt
    rrt.interp.globals[rsymbols.intern("r")] = rt_
    qs = list(QUERIES) + ["(xasc l [k1 ts])", "(xdesc r [k2 rv])"]
    wk = rng.integers(0, 15, nl).astype(np.int64)
    wts = np.sort(rng.integers(0, 50_000, nl)).astype(np.int64)
    qk = rng.integers(0, 15, nr).astype(np.int64)
    qts = np.sort(rng.integers(0, 50_000, nr)).astype(np.int64)
    p = rng.uniform(-100, 100, nr)
    p[rng.integers(0, nr, max(nr // 25, 1))] = np.nan
    rrt.interp.globals[rsymbols.intern("tr")] = rtable(
        rvec_sym(["s", "ts"]), [RObj(RT.I64, wk), RObj(RT.I64, wts)])
    rrt.interp.globals[rsymbols.intern("qt")] = rtable(
        rvec_sym(["s", "ts", "p"]),
        [RObj(RT.I64, qk), RObj(RT.I64, qts), RObj(RT.F64, p)])
    for name in ("l", "r", "tr", "qt"):
        _port_twin(rrt, prt, name)
    w = rnd.choice([(-1000, 1000), (-5000, 0), (0, 0)])
    for fn, aggs in [("window-join", "{mx: (max p) s: (sum p) a: (avg p)}"),
                     ("window-join1",
                      "{mn: (min p) c: (count p) d: (dev p)}")]:
        qs.append(f"({fn} [s ts] (map-left + [{w[0]} {w[1]}] "
                  f"(at tr 'ts)) tr qt {aggs})")
    engines = set()
    for q in qs:
        check(rrt, prt, q)
        engines.add(_profiles(q)[1]["engine"])
    assert engines == {"dist-bcast-probe", "dist-asof", "dist-sort",
                       "dist-wjoin"}
