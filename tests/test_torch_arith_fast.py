"""The port's device arithmetic fast path (rayforce_tpu_torch/ops/vops.py
`_dev_arith_fast`: + - * over device-resident vectors, which carries the
window join's bounds) held against the JAX package's, the counterpart of
tests/test_arith_fast.py. The same seeded vectors (i16, i32, i64, f64,
timestamp, date, each with typed nulls; i64 products that wrap) go
through both packages, scalar x vector and vector x vector; the port
runs its device path on CPU torch, the reference on JAX CPU with its
device path on. Each result must engage the fast path in both packages
and format byte for byte as the reference device and the port host."""
import random

import numpy as np
import pytest
import torch

from rayforce_tpu.core import types as RT
from rayforce_tpu.core.fmt import format_top as ref_fmt
from rayforce_tpu.core.obj import Obj as RObj
from rayforce_tpu.engine import device as rdev
from rayforce_tpu.ops import vops as rvops
from rayforce_tpu_torch.core import types as T
from rayforce_tpu_torch.core.fmt import format_top as fmt
from rayforce_tpu_torch.core.obj import Obj
from rayforce_tpu_torch.engine import device as dev
from rayforce_tpu_torch.ops import vops

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


def _mk_vec(rng, kind, n):
    """tests/test_arith_fast.py's vectors: (type name, values)."""
    if kind == "i16":
        v = rng.integers(-3000, 3000, n).astype(np.int16)
        v[rng.integers(0, n, max(n // 8, 1))] = T.NULL_I16
        return "I16", v
    if kind == "i32":
        v = rng.integers(-(2**30), 2**30, n).astype(np.int32)
        v[rng.integers(0, n, max(n // 8, 1))] = T.NULL_I32
        return "I32", v
    if kind == "i64":
        v = rng.integers(-(2**40), 2**40, n).astype(np.int64)
        v[rng.integers(0, n, max(n // 8, 1))] = T.NULL_I64
        return "I64", v
    if kind == "f64":
        v = rng.uniform(-100, 100, n)
        v[rng.integers(0, n, max(n // 8, 1))] = np.nan
        return "F64", v
    if kind == "ts":
        v = rng.integers(0, 2**40, n).astype(np.int64)
        v[rng.integers(0, n, max(n // 8, 1))] = T.NULL_I64
        return "TIMESTAMP", v
    v = rng.integers(0, 20000, n).astype(np.int32)
    v[rng.integers(0, n, max(n // 8, 1))] = T.NULL_I32
    return "DATE", v


SCALARS = [("I64", np.int64(7)), ("I64", np.int64(-3)),
           ("F64", np.float64(2.5)), ("I32", np.int32(11)),
           ("I16", np.int16(4))]
OPS = ["add", "sub", "mul"]
KINDS = ["i16", "i32", "i64", "f64", "ts", "date"]


def _pair(tn, v, scalar=False):
    """The same value as a reference Obj and a port Obj."""
    t = getattr(T, tn)
    if scalar:
        return RObj(-getattr(RT, tn), v), Obj(-t, v)
    return RObj(getattr(RT, tn), v.copy()), Obj(t, v.copy())


def _legal(op, a, b):
    try:
        vops.promote_arith(op, abs(a.t), abs(b.t))
        return True
    except Exception:
        return False


def _check(op, rargs, pargs, host_args, what):
    """Both packages take the fast path; port device == reference device
    == port host, formatted."""
    r = rvops.arith(op, *rargs)
    p = vops.arith(op, *pargs)
    assert r.pending() is not None, (what, "reference fast path")
    assert p.pending() is not None, (what, "port fast path")
    dev.set_enabled(False)
    try:
        h = fmt(vops.arith(op, *host_args))
    finally:
        dev.set_enabled(True)
    pf = fmt(p)
    assert pf == ref_fmt(r), what
    assert pf == h, what


def _devify(robj, pobj):
    rdev.dev_col(robj)
    dev.dev_col(pobj)
    return robj, pobj


@pytest.mark.parametrize("seed", range(3))
def test_arith_fast_scalar_vector(seed):
    rng = np.random.default_rng(500 + seed)
    rnd = random.Random(500 + seed)
    n = 64
    for kind in KINDS:
        for op in OPS:
            for stn, sval in SCALARS:
                tn, v = _mk_vec(rng, kind, n)
                flip = rnd.random() < 0.5
                rs, ps = _pair(stn, sval, scalar=True)
                _rh, ph = _pair(tn, v)
                if not _legal(op, *((ps, ph) if flip else (ph, ps))):
                    continue
                rv, pv = _devify(*_pair(tn, v))
                rargs = (rs, rv) if flip else (rv, rs)
                pargs = (ps, pv) if flip else (pv, ps)
                hargs = (ps, ph) if flip else (ph, ps)
                _check(op, rargs, pargs, hargs, (kind, op, flip, stn, sval))


@pytest.mark.parametrize("seed", range(3))
def test_arith_fast_vector_vector(seed):
    rng = np.random.default_rng(900 + seed)
    n = 64
    for ka in KINDS:
        for kb in KINDS:
            for op in OPS:
                ta, a = _mk_vec(rng, ka, n)
                tb, b = _mk_vec(rng, kb, n)
                ha, hb = _pair(ta, a)[1], _pair(tb, b)[1]
                if not _legal(op, ha, hb):
                    continue
                ra, pa = _devify(*_pair(ta, a))
                rb, pb = _devify(*_pair(tb, b))
                _check(op, (ra, rb), (pa, pb), (ha, hb), (ka, kb, op))


def test_arith_fast_i64_products_wrap():
    """i64 x i64 products past 2^63 wrap in both packages, as the host's
    numpy products do."""
    rng = np.random.default_rng(7)
    n = 64
    a = rng.integers(2**40, 2**41, n).astype(np.int64)
    b = rng.integers(2**30, 2**31, n).astype(np.int64)
    a[3] = T.NULL_I64
    ra, pa = _devify(*_pair("I64", a))
    rb, pb = _devify(*_pair("I64", b))
    _check("mul", (ra, rb), (pa, pb), (_pair("I64", a)[1],
                                       _pair("I64", b)[1]), "wrap")
    with np.errstate(over="ignore"):
        want = a * b
    assert (want[np.arange(n) != 3] < 0).any()


def test_arith_fast_not_engaged_without_device_copy():
    """Host-only vectors keep the host path in both packages (no silent
    upload)."""
    ra = RObj(RT.I64, np.arange(64, dtype=np.int64))
    pa = Obj(T.I64, np.arange(64, dtype=np.int64))
    r = rvops.arith("add", ra, RObj(-RT.I64, np.int64(1)))
    p = vops.arith("add", pa, Obj(-T.I64, np.int64(1)))
    assert r.pending() is None
    assert p.pending() is None
    assert fmt(p) == ref_fmt(r)
    assert not (isinstance(pa.meta, dict) and "dev" in pa.meta)
