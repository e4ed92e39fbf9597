"""Column stats of the port's device engine (engine/device.py
`_k_stat_parts` and `_combine_parts`: min, max, has_null, qscale,
skipping nulls and NaNs) against the JAX package's `_k_minmax_all`, on
the decimal-grid fixtures of tests/test_qscale.py (grids 1, 1e2, 1e4,
1e6) plus typed-null integer columns. Both run in f64/i64 on the CPU,
so the stats must be equal."""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from rayforce_tpu.core.obj import Obj as RObj
from rayforce_tpu.engine import device as rdev
from rayforce_tpu_torch.core import types as T
from rayforce_tpu_torch.core.obj import table_from_numpy
from rayforce_tpu_torch.engine import device as dev

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _cpu_engine():
    saved = dict(dev._cfg)
    dev.set_device("cpu")
    yield
    dev._cfg.clear()
    dev._cfg.update(saved)


def _columns():
    rng = np.random.default_rng(0)
    n = 5000
    withnan = np.round(rng.uniform(0, 10, n), 4)
    withnan[::7] = np.nan
    i64 = rng.integers(-2**40, 2**40, n).astype(np.int64)
    i64[::9] = T.NULL_I64
    i32 = rng.integers(-1000, 1000, n).astype(np.int32)
    i32[::11] = T.NULL_I32
    i16 = rng.integers(-300, 300, n).astype(np.int16)
    i16[::13] = T.NULL_I16
    return {
        "dec6": (np.round(rng.uniform(0, 100, n), 6), "F64"),
        "dec2": (np.round(rng.uniform(-50, 50, n), 2), "F64"),
        "ints": (rng.integers(-1000, 1000, n).astype(np.float64), "F64"),
        "cont": (rng.uniform(0, 1, n), "F64"),
        "big": (rng.uniform(0, 1e10, n), "F64"),
        "withnan": (withnan, "F64"),
        "allnan": (np.full(n, np.nan), "F64"),
        "i64": (i64, "I64"),
        "i32": (i32, "I32"),
        "i16": (i16, "I16"),
        "u8": (rng.integers(0, 256, n).astype(np.uint8), "U8"),
        "b8": (rng.integers(0, 2, n).astype(np.int8), "B8"),
        "allnull": (np.full(n, T.NULL_I64, dtype=np.int64), "I64"),
    }


def test_minmax_all_matches_reference():
    cols = _columns()
    ref = [np.asarray(x) for x in rdev._k_minmax_all(
        [jnp.asarray(a) for a, _t in cols.values()])]
    parts = dev._fetch([dev._k_stat_parts(torch.from_numpy(a))
                        for a, _t in cols.values()])
    got = [np.asarray(dev._combine_parts([p], p.dtype == np.float64),
                      dtype=p.dtype) for p in parts]
    for name, r, g in zip(cols, ref, got):
        assert r.dtype == g.dtype, name
        assert r.tobytes() == g.tobytes(), (name, r, g)


def test_table_stats_match_reference():
    cols = _columns()
    t = table_from_numpy(list(cols), [a for a, _ in cols.values()],
                         [tn for _, tn in cols.values()])
    dev.put_table(t)
    for name, c in zip(cols, t.v[1]):
        a = cols[name][0]
        rc = RObj(c.t, a.copy())
        assert dev.column_range(c) == rdev.column_range(rc), name
        assert dev.column_has_null(c) == rdev.column_has_null(rc), name
        assert dev.column_qscale(c) == rdev.column_qscale(rc), name
    by = dict(zip(cols, t.v[1]))
    assert dev.column_qscale(by["dec6"]) == 1e6
    assert dev.column_qscale(by["dec2"]) == 1e2
    assert dev.column_qscale(by["ints"]) == 1.0
    assert dev.column_qscale(by["cont"]) is None
    assert dev.column_qscale(by["big"]) is None
    assert dev.column_qscale(by["withnan"]) == 1e4
    assert dev.column_has_null(by["i16"]) and \
        not dev.column_has_null(by["u8"])


def test_dev_col_is_cached_on_the_engine_device():
    t = table_from_numpy(["a"], [np.arange(10)], ["I64"])
    c = t.v[1][0]
    x = dev.dev_col(c)
    assert x.device.type == "cpu" and dev.dev_col(c) is x
    assert torch.equal(x, torch.arange(10))


def test_cuda_absent_is_an_error(monkeypatch):
    """With no setting the engine runs on CUDA; without a card the
    first device query raises instead of quietly using CPU torch."""
    monkeypatch.delenv("RAYFORCE_DEVICE", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    dev._cfg["device"] = None
    dev._cfg["enabled"] = None
    assert dev.available()
    with pytest.raises(dev.DeviceError):
        dev.device()


@pytest.mark.parametrize("err, fault", [
    (dev.DeviceError("nvcc failed"), True),
    (torch.OutOfMemoryError("CUDA out of memory"), True),
    (RuntimeError("CUDA error: an illegal memory access was encountered"),
     True),
    (RuntimeError("min(): Expected reduction dim to be specified"), False),
    (TypeError("can't convert np.ndarray of type numpy.object_"), False),
    (KeyError("range"), False),
])
def test_is_fault(err, fault):
    """Card faults propagate from the select hook; a plan the engine
    cannot run falls back to the host path, as in the reference."""
    assert dev.is_fault(err) is fault


def test_g1_table_specs():
    """tools/g1.py makes bench.py's G1 columns (chip_smoke.py's table)."""
    from rayforce_tpu_torch.tools.g1 import NAMES, g1_table
    t = g1_table(50_000, "cpu")
    cols = dict(zip(NAMES, t.v[1]))
    for nm, hi in (("id1", 99), ("id2", 99), ("id3", 99_999),
                   ("id4", 99), ("id5", 99), ("id6", 99_999),
                   ("v1", 5), ("v2", 15)):
        lo, top = dev.column_range(cols[nm])
        assert cols[nm].t == T.I64 and lo >= (1 if nm[0] == "v" else 0)
        assert top <= hi, nm
    assert cols["v3"].t == T.F64
    assert dev.column_qscale(cols["v3"]) == 1e6
    lo, hi = dev.column_range(cols["v3"])
    assert 0.0 <= lo and hi < 100.0


def test_g1_skewed_id3():
    """tools/g1.py skewed_id3 (the mesh phase's skewed table): id3 code
    137 holds about the asked share of the rows, the rest of id3 and the
    other columns are the table's own."""
    from rayforce_tpu_torch.core.obj import to_np
    from rayforce_tpu_torch.tools.g1 import NAMES, g1_table, skewed_id3
    t = g1_table(50_000, "cpu")
    s, heavy = skewed_id3(t, "cpu")
    a = {nm: to_np(c) for nm, c in zip(NAMES, t.v[1])}
    b = {nm: to_np(c) for nm, c in zip(NAMES, s.v[1])}
    hot = b["id3"] == 137
    assert heavy <= hot.sum() <= heavy + (a["id3"] == 137).sum()
    assert 0.58 < hot.mean() < 0.62
    np.testing.assert_array_equal(b["id3"][~hot], a["id3"][~hot])
    for nm in NAMES:
        if nm != "id3":
            np.testing.assert_array_equal(b[nm], a[nm])
    assert dev.column_range(s.v[1][NAMES.index("id3")])[1] <= 99_999


def test_constants_go_on_the_device_of_the_tensor_they_meet():
    """A numpy-scalar operand is made on the device of the tensor it
    meets (a mesh shard may sit on another device than the engine's),
    here the meta device; only a column-free expression, which meets no
    tensor, takes the engine's device."""
    from rayforce_tpu_torch.engine import exprc
    x = torch.empty(4, dtype=torch.int32, device="meta")
    a, b = exprc._common(x, np.int64(3))
    assert (a.device.type, b.device.type) == ("meta", "meta")
    assert a.dtype == b.dtype == torch.int64
    b, a = exprc._common(np.float64(2.5), x)
    assert (a.device.type, b.device.type) == ("meta", "meta")
    assert a.dtype == b.dtype == torch.float64
    assert exprc._isnull(np.int64(T.NULL_I64), T.I64, x.device).device.type \
        == "meta"
    assert exprc._tensor(np.int64(1), torch.int64).device == dev.device()
