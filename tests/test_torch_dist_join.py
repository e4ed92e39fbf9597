"""The port's mesh kernels of joins, table sorts and window joins
(rayforce_tpu_torch/parallel/dist.py dist_left_probe, dist_eq_probe,
dist_asof_probe, dist_sort(_auto); engine/wjoin.py _mesh_wjoin_kernel)
held against the JAX package's, side by side on the same seeded inputs:
the reference kernel runs on its 8-device virtual CPU mesh, the port's
on an 8-shard mesh over CPU torch, where every sort is the plain version
of the CUDA radix sort.

Match ids, orders, overflow counts and integer lanes must be equal;
f64 window sums and averages within 2^-40 of the column's sum |x|, and
deviations (held on dev^2) within 2^-40 of its second moment about the
mean: each side adds its prefix sums in its own order, so an error is
bounded by the prefix magnitude (chip_smoke.py's window-join tolerance);
every other lane bit for bit.
Each kernel also notes the same exchanged bytes and kernel calls in both
packages' `dist.stats`. The counterparts of tests/test_dist.py's
test_dist_left_probe, test_dist_asof_probe, test_dist_sort,
test_dist_eq_probe_dup_keys and test_dist_eq_probe_skew_no_capacity_blowup."""
import numpy as np
import pytest
import torch

from rayforce_tpu.engine import wjoin as RW
from rayforce_tpu.parallel import dist as R
from rayforce_tpu_torch.core import types as T
from rayforce_tpu_torch.engine import psort
from rayforce_tpu_torch.engine import wjoin as PW
from rayforce_tpu_torch.parallel import dist as D

torch.set_num_threads(1)

N_DEV = 8


@pytest.fixture(scope="module")
def meshes():
    import jax
    if len(jax.devices()) < N_DEV:
        pytest.skip("the reference needs 8 virtual devices")
    return R.make_mesh(N_DEV), D.make_mesh(N_DEV, device="cpu")


def _shard(meshes, a, fill=0):
    """The same host array row-sharded over both meshes, padded with
    `fill` (the reference pads with zeros: pad it here first)."""
    rm, pm = meshes
    pad = (-len(a)) % N_DEV
    a = np.concatenate([a, np.full(pad, fill, dtype=a.dtype)])
    return R.shard_rows(rm, a)[0], D.shard_rows(pm, a)[0]


def _np(x):
    if isinstance(x, list):
        return torch.cat(x).numpy()
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _stats_equal(run_ref, run_port):
    """Run both kernels with fresh stats; their exchanged bytes and
    kernel calls must agree. Returns both results."""
    R.reset_stats()
    D.reset_stats()
    r = run_ref()
    p = run_port()
    assert dict(D.stats) == dict(R.stats)
    return r, p


def test_shard_rows_pads_with_the_fill():
    pm = D.make_mesh(N_DEV, device="cpu")
    shards, pad = D.shard_rows(pm, np.arange(13, dtype=np.int64), -1)
    assert pad == 3
    assert torch.cat(shards).tolist() == list(range(13)) + [-1] * 3
    shards, _ = D.shard_rows(pm, torch.ones(5, dtype=torch.float64),
                             float("nan"))
    assert torch.isnan(torch.cat(shards)[5:]).all()
    assert torch.cat(D.shard_rows(pm, np.ones(3, np.int32))[0]).tolist() \
        == [1, 1, 1, 0, 0, 0, 0, 0]


def test_dist_left_probe(meshes):
    import jax
    rm, pm = meshes
    rng = np.random.default_rng(5)
    n = N_DEV * 512
    nr = 700
    lk = rng.integers(0, 1000, n).astype(np.int64)
    rk = rng.integers(0, 2000, nr).astype(np.int64)   # duplicate keys
    rl, pl = _shard(meshes, lk)
    r, p = _stats_equal(
        lambda: R.dist_left_probe(rm)(rl, jax.device_put(rk)),
        lambda: D.dist_left_probe(pm)(pl, torch.from_numpy(rk)))
    np.testing.assert_array_equal(_np(p[0]), np.asarray(r[0]))
    np.testing.assert_array_equal(_np(p[1]), np.asarray(r[1]))
    first = {}
    for i, k in enumerate(rk):
        first.setdefault(int(k), i)
    want = np.array([first.get(int(k), -1) for k in lk])
    np.testing.assert_array_equal(_np(p[0]), want)


@pytest.mark.parametrize("sorted_times", [True, False])
def test_dist_asof_probe(meshes, sorted_times):
    rm, pm = meshes
    rng = np.random.default_rng(6)
    n = N_DEV * 256
    nr = N_DEV * 384
    lk = rng.integers(0, 40, n).astype(np.int64)
    lt = rng.integers(0, 1_000_000, n).astype(np.int64)
    rk = rng.integers(0, 40, nr).astype(np.int64)
    rt_ = rng.integers(0, 1_000_000, nr).astype(np.int64)
    if sorted_times:
        rt_ = np.sort(rt_)
    rt_[::97] = rt_[1::97][:len(rt_[::97])]     # equal (key, time) rows
    rv = rng.uniform(0, 100, nr)
    rv[::53] = np.nan
    ins = [_shard(meshes, x) for x in (lk, lt, rk, rt_, rv)]
    r, p = _stats_equal(
        lambda: R.dist_asof_probe(rm)(*[x[0] for x in ins]),
        lambda: D.dist_asof_probe(pm)(*[x[1] for x in ins]))
    assert _np(p[0]).tobytes() == np.asarray(r[0]).tobytes()
    np.testing.assert_array_equal(_np(p[1]), np.asarray(r[1]))
    # numpy: the latest time at or before, the highest payload on ties
    for i in range(0, n, 37):
        m = (rk == lk[i]) & (rt_ <= lt[i])
        if not m.any():
            assert not _np(p[1])[i]
            continue
        t = rt_[m].max()
        cand = rv[m & (rt_ == t)]
        want = np.nan if np.isnan(cand).any() else cand.max()
        np.testing.assert_equal(_np(p[0])[i], want)


def _sort_both(meshes, keys, n):
    """dist_sort_auto in both packages over the same keys."""
    rm, pm = meshes
    sh = [_shard(meshes, k) for k in keys]
    return _stats_equal(
        lambda: np.asarray(R.dist_sort_auto(rm, n, tuple(
            k.dtype for k in keys))(*[s[0] for s in sh])),
        lambda: D.dist_sort_auto(pm, n, tuple(
            s[1][0].dtype for s in sh))(*[s[1] for s in sh]).numpy())


@pytest.mark.parametrize("n", [N_DEV * 700, N_DEV * 700 - 3])
def test_dist_sort(meshes, n):
    """Multi-key with heavy duplicates (the row id breaks ties, so the
    sort is stable), an i32 key among them."""
    rng = np.random.default_rng(77)
    k1 = rng.integers(0, 9, n).astype(np.int64)
    k2 = rng.uniform(-5, 5, n)
    k3 = rng.integers(-3, 3, n).astype(np.int32)
    for keys, cols in (([k1, k2], (k2, k1)), ([k3, k1, k2], (k2, k1, k3))):
        r, p = _sort_both(meshes, keys, n)
        np.testing.assert_array_equal(p, r)
        np.testing.assert_array_equal(p, np.lexsort((np.arange(n),) + cols))
        assert D.stats["kernel_calls"] == 1


def test_dist_sort_auto_retries_like_the_reference(meshes):
    """Keys already in order put each shard's rows into one bucket, far
    over twice the balanced share: both packages overflow, double and
    retry the same number of times."""
    n = N_DEV * 600
    k = np.arange(n, dtype=np.int64) // 3
    r, p = _sort_both(meshes, [k], n)
    np.testing.assert_array_equal(p, r)
    np.testing.assert_array_equal(p, np.arange(n))
    assert D.stats["kernel_calls"] > 1


def _f64_edges(rng, n, nan):
    v = rng.uniform(-5, 5, n)
    for x in (np.inf, -np.inf, 0.0, -0.0) + ((np.nan,) if nan else ()):
        v[rng.integers(0, n, n // 20)] = x
    return v


def test_dist_sort_f64_infinities_and_zeros(meshes):
    """An f64 key with +-inf and +-0.0 (0.0 and -0.0 tie, as in the
    reference's sorts), alone and after an integer key."""
    rng = np.random.default_rng(8)
    n = N_DEV * 300 + 5
    v = _f64_edges(rng, n, nan=False)
    k = rng.integers(0, 4, n).astype(np.int64)
    for keys, cols in (([v], (v + 0.0,)), ([k, v], (v + 0.0, k))):
        r, p = _sort_both(meshes, keys, n)
        np.testing.assert_array_equal(p, r)
        np.testing.assert_array_equal(p, np.lexsort((np.arange(n),) + cols))


def test_dist_sort_f64_nan_sorts_last(meshes):
    """With NaN in an f64 key the port sorts as the reference's one-device
    sort does: 0.0 ties -0.0 and every NaN sorts last, in row order. (The
    reference's sample sort misroutes NaN keys, ROADMAP queue 3; the
    engine maps NaN to -inf before any table sort.)"""
    import jax
    import jax.numpy as jnp
    _rm, pm = meshes
    rng = np.random.default_rng(9)
    n = N_DEV * 300 + 5
    v = _f64_edges(rng, n, nan=True)
    k = rng.integers(0, 4, n).astype(np.int64)
    for keys in ([v], [k, v]):
        order = D.dist_sort_auto(pm, n, ())(
            *[D.shard_rows(pm, x)[0] for x in keys]).numpy()
        want = jax.lax.sort([jnp.asarray(x) for x in keys] +
                            [jnp.arange(n)], num_keys=len(keys),
                            is_stable=True)[-1]
        np.testing.assert_array_equal(order, np.asarray(want))


@pytest.mark.parametrize("caps", [(64, 64, None), (12, 12, 12)])
def test_dist_eq_probe_dup_keys(meshes, caps):
    """First match = the smallest right row id with an equal key; a
    tight capacity reports the same overflow counts as the reference."""
    rm, pm = meshes
    rng = np.random.default_rng(17)
    n = N_DEV * 200
    lk = rng.integers(0, 60, n).astype(np.int64)
    rk = rng.integers(0, 90, n).astype(np.int64)   # many duplicates
    rl, pl = _shard(meshes, lk)
    rr, pr = _shard(meshes, rk)
    r, p = _stats_equal(
        lambda: R.dist_eq_probe(rm, n, caps[0], caps[1], cap_b=caps[2])(
            rl, rr),
        lambda: D.dist_eq_probe(pm, n, caps[0], caps[1], cap_b=caps[2])(
            pl, pr))
    for i in range(3):
        assert int(p[i][0]) == int(np.asarray(r[i])[0])
    if caps[0] == 12:
        assert int(p[0][0]) > 0
        return
    np.testing.assert_array_equal(_np(p[3])[:n], np.asarray(r[3])[:n])
    np.testing.assert_array_equal(_np(p[4])[:n], np.asarray(r[4])[:n])
    first = {}
    for i, k in enumerate(rk):
        first.setdefault(int(k), i)
    np.testing.assert_array_equal(
        _np(p[3])[:n], [first.get(int(k), -1) for k in lk])


@pytest.mark.parametrize("n", [N_DEV * 512, N_DEV * 512 - 5])
def test_dist_eq_probe_skew_no_capacity_blowup(meshes, n):
    """99:1 hot key: its rows resolve through the candidate lanes without
    riding the exchange, so the balanced capacity does not overflow."""
    rm, pm = meshes
    rng = np.random.default_rng(23)
    lk = np.where(rng.random(n) < 0.99, 7,
                  rng.integers(0, 500, n)).astype(np.int64)
    rk = rng.permutation(500)[:300].astype(np.int64)
    rl, pl = _shard(meshes, lk, -1)
    rr, pr = _shard(meshes, rk, -1)
    cap = max(2 * (n // N_DEV) // N_DEV, 64)
    r, p = _stats_equal(
        lambda: R.dist_eq_probe(rm, n, cap, cap, cap_b=cap * 4)(rl, rr),
        lambda: D.dist_eq_probe(pm, n, cap, cap, cap_b=cap * 4)(pl, pr))
    assert [int(x[0]) for x in p[:3]] == [0, 0, 0]
    assert [int(np.asarray(x)[0]) for x in r[:3]] == [0, 0, 0]
    np.testing.assert_array_equal(_np(p[3])[:n], np.asarray(r[3])[:n])
    np.testing.assert_array_equal(_np(p[4])[:n], np.asarray(r[4])[:n])
    first = {int(k): i for i, k in reversed(list(enumerate(rk)))}
    np.testing.assert_array_equal(
        _np(p[3])[:n], [first.get(int(k), -1) for k in lk])


@pytest.mark.parametrize("cap", [40, 400])
def test_bucket_slots_route_as_the_reference(cap):
    """`_bucket_slots` + `_place` (one prefix count) fill the send buffer
    as the reference's routing does (a stable argsort by destination, a
    within-bucket searchsorted, a dropping scatter), on a skewed
    destination with dead rows; the overflow is the same count."""
    import jax.numpy as jnp
    rng = np.random.default_rng(31)
    n = 1500
    dest = np.where(rng.random(n) < 0.6, 3,
                    rng.integers(0, N_DEV, n)).astype(np.int64)
    live = rng.random(n) < 0.9
    lane = rng.integers(0, 1 << 40, n).astype(np.int64)
    # the reference's route (engine/wjoin.py _mesh_wjoin_kernel `route`)
    dst = jnp.where(jnp.asarray(live), jnp.asarray(dest), N_DEV)
    order = jnp.argsort(dst, stable=True)
    ds = dst[order]
    within = jnp.arange(n) - jnp.searchsorted(ds, ds, side="left")
    ok = (ds < N_DEV) & (within < cap)
    slot = jnp.where(ok, ds * cap + within, N_DEV * cap)
    want = jnp.full((N_DEV * cap,), -1, jnp.int64).at[slot].set(
        jnp.asarray(lane)[order], mode="drop")
    slots, okp = D._bucket_slots(torch.from_numpy(dest), N_DEV, cap,
                                 torch.from_numpy(live))
    got = D._place(torch.from_numpy(lane), slots, N_DEV * cap, -1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int((torch.from_numpy(live) & ~okp).sum()) == \
        int(((ds < N_DEV) & ~ok).sum())


WJ_SPECS = [
    (("max", 0, T.F64), ("min", 0, T.F64), ("count", None, T.F64)),
    (("sum", 1, T.I64), ("avg", 0, T.F64), ("dev", 0, T.F64)),
    (("first", 0, T.F64), ("last", 1, T.I64), ("max", 1, T.I64)),
]


@pytest.mark.parametrize("tp", [0, 1])
@pytest.mark.parametrize("spec", range(len(WJ_SPECS)))
def test_mesh_wjoin_kernel(meshes, tp, spec):
    """The distributed window join's kernel: every aggregate lane per
    left row, the overflow counts, and the exchanged bytes."""
    rm, pm = meshes
    rng = np.random.default_rng(91 + spec)
    nl, nr = N_DEV * 100 + 5, N_DEV * 160 + 3
    n_codes = 23
    lcode = rng.integers(0, n_codes, nl).astype(np.int64)
    lts = np.sort(rng.integers(0, 50_000, nl)).astype(np.int64)
    lo, hi = lts - 1000, lts + (1000 if tp else 0)
    rcode = rng.integers(0, n_codes, nr).astype(np.int64)
    rts = np.sort(rng.integers(0, 50_000, nr)).astype(np.int64)
    p = rng.uniform(-100, 100, nr)
    p[rng.integers(0, nr, nr // 25)] = np.nan
    q = rng.integers(-50, 50, nr).astype(np.int64)
    q[rng.integers(0, nr, nr // 25)] = T.NULL_I64
    ins = [_shard(meshes, lcode, -1), _shard(meshes, lo),
           _shard(meshes, hi), _shard(meshes, rcode, -1),
           _shard(meshes, rts), _shard(meshes, p, np.nan), _shard(meshes, q)]
    rows_l, rows_r = -(-nl // N_DEV), -(-nr // N_DEV)
    caps = (max(2 * rows_l // N_DEV, 64), max(2 * rows_r // N_DEV, 64),
            max(2 * rows_l // N_DEV, 64))
    aggs = WJ_SPECS[spec]
    r, o = _stats_equal(
        lambda: RW._mesh_wjoin_kernel(rm, n_codes, tp, *caps, nl, aggs,
                                      ("float64", "int64"))(
            *[x[0] for x in ins]),
        lambda: PW._mesh_wjoin_kernel(pm, n_codes, tp, *caps, nl, aggs,
                                      ("torch.float64", "torch.int64"))(
            *[x[1] for x in ins]))
    assert [int(x[0]) for x in o[:3]] == [0, 0, 0]
    assert [int(np.asarray(x)[0]) for x in r[:3]] == [0, 0, 0]
    for (op, lane, _t), a, b in zip(aggs, r[3:], o[3:]):
        want, got = np.asarray(a)[:nl], _np(b)[:nl]
        assert got.dtype == want.dtype, op
        if op in ("sum", "avg", "dev") and got.dtype == np.float64:
            np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
            x = (p, q)[lane]
            x = x[~np.isnan(x)]
            if op == "dev":
                got, want = got ** 2, want ** 2
                tol = ((x - x.mean()) ** 2).sum() * 2.0 ** -40
            else:
                tol = np.abs(x).sum() * 2.0 ** -40
            np.testing.assert_allclose(got, want, rtol=0, atol=tol)
        else:
            assert got.tobytes() == want.tobytes(), op


def test_mesh_kernels_sort_through_the_psort_entry(meshes, monkeypatch):
    """Every sort of the join, sort and window-join mesh kernels goes
    through psort.sort_i32 (the CUDA radix sort on the card)."""
    calls = []
    real = psort.sort_i32

    def counting(ops, n_keys=1, perm=False):
        calls.append(len(ops))
        return real(ops, n_keys, perm)

    monkeypatch.setattr(psort, "sort_i32", counting)
    _rm, pm = meshes
    rng = np.random.default_rng(4)
    k = D.shard_rows(pm, rng.integers(0, 50, N_DEV * 64))[0]
    D.dist_sort_auto(pm, N_DEV * 64, ())(k)
    # local, splitter and merge sorts
    assert len(calls) == 2 * N_DEV + 1
    calls.clear()
    D.dist_eq_probe(pm, N_DEV * 64, 64, 64)(k, k)
    # heavy keys of both sides, the unrouted and the received right rows
    assert len(calls) == 2 * 2 * N_DEV + 1 + 2 * N_DEV
    calls.clear()
    D.dist_asof_probe(pm)(k, k, k, k, [x.double() for x in k])
    assert len(calls) == N_DEV
    import inspect
    assert "torch.sort" not in inspect.getsource(D)
