"""The port's device table sort (rayforce_tpu_torch/engine/sort.py: xasc
and xdesc by one stable multi-key sort and lazy takes) held against the
JAX package's: the same seeded numpy columns go into both packages'
tables, and each sort's formatted output must match byte for byte —
reference device, port device and port host — with both packages on
their device sort. The port runs its device path on CPU torch, where the
sort is the plain version of the CUDA radix sort."""
import numpy as np
import pytest
import torch

from rayforce_tpu_torch.core import symbols, types as T
from rayforce_tpu_torch.core.obj import to_np
from rayforce_tpu_torch.engine import device as dev
from rayforce_tpu_torch.engine import sort as es
from test_torch_join import (  # noqa: F401 (_engines: fixture)
    _engines, check, enum_domain, runtimes)

torch.set_num_threads(1)


def xcheck(rrt, prt, q):
    return check(rrt, prt, q, engine="device-sort")


# -- tests/test_join_fuzz.py test_sort_fuzz, through both packages ------------

SORT_FUZZ = [
    "(xasc t [k1])",
    "(xasc t [k1 k2])",
    "(xdesc t [k2 v])",
    "(xasc t [v])",
    "(xdesc t [k1 ts v])",
]

_FUZZ_RT: dict = {}


def _fuzz_runtimes(seed):
    if seed not in _FUZZ_RT:
        rng = np.random.default_rng(2000 + seed)
        n = 3000
        k1 = rng.integers(0, 12, n).astype(np.int64)
        k1[rng.integers(0, n, 40)] = T.NULL_I64
        k2 = rng.integers(-4, 4, n).astype(np.int32)
        v = rng.uniform(-50, 50, n)
        v[rng.integers(0, n, 40)] = np.nan
        ts = rng.integers(0, 10**6, n).astype(np.int64)
        _FUZZ_RT[seed] = runtimes({"t": {
            "k1": (k1, "I64"), "k2": (k2, "I32"), "v": (v, "F64"),
            "ts": (ts, "I64")}})
    return _FUZZ_RT[seed]


@pytest.mark.parametrize("q", SORT_FUZZ)
@pytest.mark.parametrize("seed", range(3))
def test_sort_fuzz(seed, q):
    xcheck(*_fuzz_runtimes(seed), q)


# -- tests/test_device_parity.py's sort rows, on its fixture ------------------

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
    return runtimes({"t": {
        "id1": (id1, "I64"), "id3": (id3, "I64"), "v1": (v1, "I64"),
        "v2": (v2, "I32"), "v3": (v3, "F64"), "big": (big, "I64")}})


@pytest.mark.parametrize("q", ["(xasc t [id1 v2])", "(xdesc t 'v3)",
                               "(xasc t [big])", "(xdesc t [v1 id3])"])
def test_device_parity_sorts(parity, q):
    """The parity rows, then an i64 key too wide for one word (big) and
    a nullable i64 key that rides as one biased word (v1)."""
    calls, _ = xcheck(*parity, q)
    assert calls == [(2, 2)]


def test_symbol_keys_in_string_order_with_null():
    """Symbols sort by name, not by intern order; the null symbol comes
    first."""
    rng = np.random.default_rng(11)
    n = 600
    names = np.array(["zeta", "alpha", "mu", "", "beta", "omega", "b"])
    s = names[rng.integers(0, len(names), n)]
    rrt, prt = runtimes({"t": {
        "s": (s, "SYMBOL"),
        "v": (rng.integers(0, 50, n).astype(np.int64), "I64")}})
    xcheck(rrt, prt, "(xasc t [s v])")
    xcheck(rrt, prt, "(xdesc t 's)")
    out = prt.eval_str("(xasc t 's)")
    got = [symbols.name_of(int(i)) if i != T.NULL_I64 else ""
           for i in to_np(out.v[1][0])]
    assert got == sorted(got)


def test_enum_keys():
    rng = np.random.default_rng(12)
    n = 700
    dom = enum_domain(["pear", "apple", "kiwi", "fig", "date"])
    e = rng.integers(0, 5, n).astype(np.int64)
    rrt, prt = runtimes({"t": {
        "e": (e, ("ENUM", dom)),
        "v": (rng.uniform(0, 1, n), "F64")}})
    xcheck(rrt, prt, "(xasc t 'e)")
    xcheck(rrt, prt, "(xdesc t [e v])")


def test_f64_key_nan_inf_signed_zeros():
    """NaN sorts as -inf (tied with it); -0.0 and 0.0 tie, so rows keep
    their order between them, on rows with different payloads."""
    rng = np.random.default_rng(13)
    n = 500
    f = rng.choice(np.array([np.nan, -np.inf, np.inf, -0.0, 0.0, -1.5, 2.25]),
                   n)
    rrt, prt = runtimes({"t": {
        "f": (f, "F64"), "p": (np.arange(n, dtype=np.int64), "I64")}})
    xcheck(rrt, prt, "(xasc t 'f)")
    xcheck(rrt, prt, "(xdesc t 'f)")
    out = prt.eval_str("(xasc t 'f)")
    key, pay = to_np(out.v[1][0]), to_np(out.v[1][1])
    zeros = pay[key == 0.0]
    assert len(zeros) > 10 and (np.diff(zeros) > 0).all()
    assert np.isnan(key[0]) or key[0] == -np.inf


def test_xdesc_tie_order():
    """xdesc is the flip of the stable ascending order: tied rows come out
    in reverse row order."""
    n = 400
    k = (np.arange(n) % 4).astype(np.int64)
    rrt, prt = runtimes({"t": {
        "k": (k, "I64"), "p": (np.arange(n, dtype=np.int64), "I64")}})
    xcheck(rrt, prt, "(xdesc t 'k)")
    out = prt.eval_str("(xdesc t 'k)")
    key, pay = to_np(out.v[1][0]), to_np(out.v[1][1])
    assert (np.diff(key) <= 0).all()
    for v in range(4):
        assert (np.diff(pay[key == v]) < 0).all()


def test_narrow_types_and_timestamps():
    """i16, i32 and date keys (one word as they are), a timestamp key with
    nulls (one biased word) and u8."""
    rng = np.random.default_rng(14)
    n = 800
    ts = rng.integers(10**18, 10**18 + 10**9, n).astype(np.int64)
    ts[::37] = T.NULL_I64
    h = rng.integers(-300, 300, n).astype(np.int16)
    h[::41] = T.NULL_I16
    d = rng.integers(0, 20_000, n).astype(np.int32)
    d[::43] = T.NULL_I32
    rrt, prt = runtimes({"t": {
        "ts": (ts, "TIMESTAMP"), "h": (h, "I16"), "d": (d, "DATE"),
        "u": (rng.integers(0, 200, n).astype(np.uint8), "U8")}})
    for q in ("(xasc t 'ts)", "(xdesc t [h ts])", "(xasc t [d u])",
              "(xdesc t [u h d])"):
        xcheck(rrt, prt, q)


def test_below_threshold_runs_on_the_host():
    rrt, prt = _fuzz_runtimes(0)
    old = dev._cfg["threshold"]
    dev.set_threshold(10**6)
    try:
        es.last_profile.clear()
        prt.eval_str("(xasc t [k1])")
        assert "engine" not in es.last_profile
    finally:
        dev.set_threshold(old)
