"""The port's sort entry point (rayforce_tpu_torch/engine/psort.py) keeps
the JAX package's psort contract. On CPU tensors it runs its plain
version, the one the CUDA radix sort is held against on the card.

- against the JAX package's Pallas bitonic sort in interpret mode, on
  small cases (n=977 and 4096 with 2^10-element blocks, so phase B's
  cross-block passes run);
- against numpy at larger n: heavy ties, INT32_MAX keys, two-key lex,
  and an i64 key carrying f64 + i64 payloads;
- split64/join64 round trips at the i64 extremes.

Keys must match exactly. The port's sort is stable, so every word
matches a stable numpy sort exactly; the reference's network is
unstable, so against it the rows of each equal-key run are compared
as a multiset."""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from rayforce_tpu.engine import psort as ref
from rayforce_tpu_torch.engine import psort
from rayforce_tpu_torch.engine.device import DeviceError

torch.set_num_threads(1)

I32_MAX = 2**31 - 1


@pytest.fixture(autouse=True)
def _interpret():
    old = ref._INTERPRET
    ref._INTERPRET = True
    yield
    ref._INTERPRET = old


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(xs):
    return [x.numpy() for x in xs]


def _rows(words):
    """Rows of parallel words, sorted, as one structured comparison."""
    m = np.stack(words, axis=1)
    return m[np.lexsort(m.T[::-1])]


@pytest.mark.parametrize("n", [977, 4096])
def test_pair_sort_matches_reference(n):
    rng = np.random.default_rng(n)
    k = rng.integers(-10**6, 10**6, n).astype(np.int32)
    k[1::5] = k[::5][: len(k[1::5])]            # some ties
    v = np.arange(n, dtype=np.int32)
    rk, rv = (np.asarray(x) for x in ref.sort_i32(
        [jnp.asarray(k), jnp.asarray(v)], n_keys=1, blk_log2=10))
    pk, pv = _np(psort.sort_i32([_t(k), _t(v)], n_keys=1))
    assert np.array_equal(pk, rk)
    assert np.array_equal(_rows([pk, pv]), _rows([rk, rv]))
    assert np.array_equal(pv, np.argsort(k, kind="stable"))


def test_two_key_lex_matches_reference():
    rng = np.random.default_rng(5)
    n = 4096
    k1 = rng.integers(0, 40, n).astype(np.int32)
    k2 = rng.integers(-10**6, 10**6, n).astype(np.int32)
    v = np.arange(n, dtype=np.int32)
    r = [np.asarray(x) for x in ref.sort_i32(
        [jnp.asarray(k1), jnp.asarray(k2), jnp.asarray(v)], n_keys=2,
        blk_log2=10)]
    p = _np(psort.sort_i32([_t(k1), _t(k2), _t(v)], n_keys=2))
    assert np.array_equal(p[0], r[0]) and np.array_equal(p[1], r[1])
    assert np.array_equal(_rows(p), _rows(r))


def test_sort_mixed_matches_reference():
    rng = np.random.default_rng(11)
    n = 977
    k = rng.integers(-2**40, 2**40, n).astype(np.int64)
    k[::3] = k[0]
    f = rng.uniform(-5, 5, n)
    g = rng.integers(-2**50, 2**50, n).astype(np.int64)
    rk, (rf, rg) = ref.sort_mixed(
        jnp.asarray(k), [jnp.asarray(f), jnp.asarray(g)],
        stable_iota=True)
    pk, (pf, pg) = psort.sort_mixed(_t(k), [_t(f), _t(g)],
                                    stable_iota=True)
    assert np.array_equal(pk.numpy(), np.asarray(rk))
    assert np.array_equal(pf.numpy(), np.asarray(rf))
    assert np.array_equal(pg.numpy(), np.asarray(rg))


@pytest.mark.parametrize("case", ["ties", "int32_max", "random"])
def test_one_key_against_numpy(case):
    rng = np.random.default_rng(len(case))
    n = 100_003
    if case == "ties":
        k = rng.integers(0, 7, n).astype(np.int32)
    elif case == "int32_max":
        k = np.full(n, I32_MAX, dtype=np.int32)
        k[::3] = -2**31
        k[1::7] = 0
    else:
        k = rng.integers(-2**31, I32_MAX, n, endpoint=True) \
            .astype(np.int32)
    v = rng.integers(-2**31, I32_MAX, n).astype(np.int32)
    pk, pv = _np(psort.sort_i32([_t(k), _t(v)], n_keys=1))
    order = np.argsort(k, kind="stable")
    assert np.array_equal(pk, k[order])
    assert np.array_equal(pv, v[order])


def test_three_key_lex_against_numpy():
    rng = np.random.default_rng(3)
    n = 65_537
    ks = [rng.integers(-3, 3, n).astype(np.int32) for _ in range(3)]
    ks[2][::11] = I32_MAX
    v = np.arange(n, dtype=np.int32)
    p = _np(psort.sort_i32([_t(x) for x in ks + [v]], n_keys=3))
    order = np.lexsort(ks[::-1])
    for got, want in zip(p, ks + [v]):
        assert np.array_equal(got, want[order])


def test_sort_mixed_i64_key_payloads_against_numpy():
    rng = np.random.default_rng(17)
    n = 50_000
    k = rng.integers(-2**62, 2**62, n).astype(np.int64)
    k[::4] = np.iinfo(np.int64).min
    k[1::9] = np.iinfo(np.int64).max
    f = rng.uniform(-1e300, 1e300, n)
    f[::13] = np.nan
    g = rng.integers(-2**63, 2**63 - 1, n).astype(np.int64)
    for stable_iota in (False, True):
        pk, (pf, pg) = psort.sort_mixed(_t(k), [_t(f), _t(g)],
                                        stable_iota=stable_iota)
        order = np.argsort(k, kind="stable")
        assert np.array_equal(pk.numpy(), k[order])
        assert np.array_equal(pf.numpy(), f[order], equal_nan=True)
        assert np.array_equal(pg.numpy(), g[order])


def test_split_join64_round_trip():
    x = np.array([np.iinfo(np.int64).min, np.iinfo(np.int64).max, -1, 0,
                  1, 2**32, -2**32, 2**31, -2**31 - 1], dtype=np.int64)
    hi, lo = psort.split64(_t(x))
    rhi, rlo = ref.split64(jnp.asarray(x))
    assert np.array_equal(hi.numpy(), np.asarray(rhi))
    assert np.array_equal(lo.numpy(), np.asarray(rlo))
    assert np.array_equal(psort.join64(hi, lo).numpy(), x)
    # (hi, lo) signed-lex order is the i64 order
    order = np.lexsort((lo.numpy(), hi.numpy()))
    assert np.array_equal(x[order], np.sort(x))


def test_other_devices_raise():
    w = torch.zeros(8, dtype=torch.int32, device="meta")
    with pytest.raises(DeviceError):
        psort.sort_i32([w])
