"""The port's sort entry point (rayforce_tpu_torch/engine/psort.py) keeps
the JAX package's psort contract. On CPU tensors it runs its plain
version, the one the CUDA radix sort is held against on the card.

- against the JAX package's Pallas bitonic sort in interpret mode, on
  small cases (n=977 and 4096 with 2^10-element blocks, so phase B's
  cross-block passes run);
- against numpy at larger n: heavy ties, INT32_MAX keys, two-key lex,
  4 and 6 key words (the wide engine's), and an i64 key carrying f64 +
  i64 payloads;
- against lax.sort on the wide engine's two-i64-word key sort and on
  med's (code, value) sort with an f64 key (NaN mapped to +inf, ±inf,
  ±0.0);
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


@pytest.mark.parametrize("n_keys", [4, 6])
@pytest.mark.parametrize("case", ["random", "ties", "extremes"])
def test_many_key_words_against_numpy(n_keys, case):
    """4 and 6 key words (wide's two and three i64 key words) with
    payload words, against a stable numpy lexsort."""
    rng = np.random.default_rng(n_keys * 10 + len(case))
    n = 30_011
    if case == "random":
        ks = [rng.integers(-2**31, I32_MAX, n, endpoint=True)
              .astype(np.int32) for _ in range(n_keys)]
    elif case == "ties":
        ks = [rng.integers(-2, 2, n).astype(np.int32)
              for _ in range(n_keys)]
    else:
        ks = [rng.choice(np.array([-2**31, -1, 0, I32_MAX], np.int32), n)
              for _ in range(n_keys)]
    pay = [np.arange(n, dtype=np.int32),
           rng.integers(-2**31, I32_MAX, n).astype(np.int32)]
    p = _np(psort.sort_i32([_t(x) for x in ks + pay], n_keys=n_keys))
    order = np.lexsort(ks[::-1])
    for got, want in zip(p, ks + pay):
        assert np.array_equal(got, want[order])


def test_sort_lex_i64_keys_match_lax_sort():
    """Wide's key sort: two non-negative i64 key words (4 i32 words)
    carrying f64 and i32 operands, against lax.sort on the same keys
    (unique keys: the row position rides the last word)."""
    import jax
    rng = np.random.default_rng(8)
    n = 5003
    w0 = rng.integers(0, 2**45, n).astype(np.int64)
    w0[::7] |= np.int64(1) << 61                   # trash bit
    w0[1::5] = w0[0]
    w1 = (rng.integers(0, 2**17, n).astype(np.int64) << 24) | np.arange(n)
    f = rng.uniform(-1, 1, n)
    q = rng.integers(-2**31, I32_MAX, n).astype(np.int32)
    want = jax.lax.sort([jnp.asarray(x) for x in (w0, w1, f, q)],
                        num_keys=2)
    (s0, s1), (sf, sq) = psort.sort_lex([_t(w0), _t(w1)], [_t(f), _t(q)])
    for got, w in zip((s0, s1, sf, sq), want):
        assert np.array_equal(got.numpy(), np.asarray(w))


def test_med_shape_f64_key_matches_lax_sort():
    """med's (code, value) sort: an i32 code word, then an f64 key with
    nulls (NaN) mapped to +inf by the caller, holding -inf, -0.0, 0.0
    and +inf: three key words through the entry. The sorted keys equal
    lax.sort's as floats (its CPU compare ties -0.0 with 0.0); the
    port's order is the IEEE total order, -0.0 before 0.0."""
    import jax
    rng = np.random.default_rng(12)
    n = 20_000
    codes = rng.integers(0, 513, n).astype(np.int32)
    v = rng.choice(np.array([-0.0, 0.0, np.inf, -np.inf, np.nan, 1.5,
                             -2.25]), n)
    v[::3] = rng.uniform(-1e9, 1e9, len(v[::3]))
    key = np.where(np.isnan(v), np.inf, v)
    calls = []
    plain = psort.sort_i32_plain

    def counting(words, n_keys=1, perm=False):
        calls.append(n_keys)
        return plain(words, n_keys, perm=perm)

    psort.sort_i32_plain = counting
    try:
        got = psort.sort_by_code(_t(codes), _t(key)).numpy()
    finally:
        psort.sort_i32_plain = plain
    assert calls == [3]
    _c, want = jax.lax.sort([jnp.asarray(codes), jnp.asarray(key)],
                            num_keys=2)
    assert np.array_equal(got, np.asarray(want))
    bits = key.view(np.int64)
    total = np.where(bits < 0, bits ^ np.int64(2**63 - 1), bits)
    assert np.array_equal(got.view(np.int64),
                          bits[np.lexsort((total, codes))])


def test_med_shape_i64_key_against_numpy():
    rng = np.random.default_rng(13)
    n = 20_000
    codes = rng.integers(0, 100, n).astype(np.int32)
    key = rng.integers(-2**63, 2**63 - 1, n, endpoint=True).astype(np.int64)
    key[::5] = np.iinfo(np.int64).max
    got = psort.sort_by_code(_t(codes), _t(key)).numpy()
    assert np.array_equal(got, key[np.lexsort((key, codes))])


@pytest.mark.parametrize("n", [0, 1, 2, 977])
@pytest.mark.parametrize("width", ["i32", "i64"])
def test_key_only_shapes(n, width):
    """The key-only call shapes (the compaction sorts: one i32 word; the
    head and tail sorts: one i64 key, no payload) through sort_i32 and
    sort_mixed(key, []), with ties and the signed extremes."""
    rng = np.random.default_rng(n + len(width))
    if width == "i32":
        k = rng.choice(np.array([-2**31, -1, 0, 5, I32_MAX], np.int32), n)
        got = psort.sort_i32([_t(k)])
        assert len(got) == 1 and got[0].dtype == torch.int32
        assert np.array_equal(got[0].numpy(), np.sort(k, kind="stable"))
    else:
        ext = np.array([np.iinfo(np.int64).min, -2**32, -1, 0, 2**31,
                        np.iinfo(np.int64).max], np.int64)
        k = rng.choice(ext, n)
        got, ops = psort.sort_mixed(_t(k), [])
        assert ops == [] and got.dtype == torch.int64
        assert np.array_equal(got.numpy(), np.sort(k, kind="stable"))


@pytest.mark.parametrize("n", [0, 1, 2, 977, 30_011])
def test_permutation_return_matches_stable_argsort(n):
    """perm=True returns the sort's own permutation (sorted row i came
    from row perm[i]): numpy's stable argsort, for one i32 word, an i64
    key through sort_lex, two key words with a payload, and argsort."""
    rng = np.random.default_rng(n)
    k = rng.integers(-3, 3, n).astype(np.int32)
    k[::7] = I32_MAX
    k[1::11] = -2**31
    words, perm = psort.sort_i32([_t(k)], perm=True)
    want = np.argsort(k, kind="stable")
    assert perm.dtype == torch.int32
    assert np.array_equal(perm.numpy(), want)
    assert np.array_equal(words[0].numpy(), k[want])

    k64 = rng.integers(-2**40, 2**40, n).astype(np.int64)
    k64[::3] = np.iinfo(np.int64).min
    (sk,), sops, perm = psort.sort_lex([_t(k64)], perm=True)
    want = np.argsort(k64, kind="stable")
    assert sops == [] and np.array_equal(perm.numpy(), want)
    assert np.array_equal(sk.numpy(), k64[want])
    assert np.array_equal(psort.argsort(_t(k64)).numpy(), want)

    k2 = rng.integers(0, 4, n).astype(np.int32)
    v = rng.integers(-2**31, I32_MAX, n).astype(np.int32)
    words, perm = psort.sort_i32([_t(k), _t(k2), _t(v)], n_keys=2,
                                 perm=True)
    want = np.lexsort((k2, k))
    assert np.array_equal(perm.numpy(), want)
    for got, x in zip(words, (k, k2, v)):
        assert np.array_equal(got.numpy(), x[want])


def _extern_c_signatures(name="radix_sort"):
    """{name: (return kind, [argument kinds])} of every extern "C"
    function in csrc/<name>.cu; a kind is 'ptr', 'i64' or 'i32'."""
    import os
    import re
    src = os.path.join(os.path.dirname(psort.__file__), "csrc",
                       f"{name}.cu")
    text = open(src).read()

    def kind(decl):
        decl = decl.strip()
        if "*" in decl:
            return "ptr"
        if re.match(r"(const\s+)?(int64_t|long long)\b", decl):
            return "i64"
        if re.match(r"(const\s+)?(int|int32_t)\b", decl):
            return "i32"
        raise AssertionError(f"unknown C type: {decl!r}")

    sigs = {}
    for m in re.finditer(r'extern\s+"C"\s+([\w\s\*]+?)\s*\b(rf_\w+)\s*'
                         r'\(([^)]*)\)', text):
        ret, name, args = m.groups()
        args = args.strip()
        kinds = [] if args in ("", "void") else \
            [kind(a) for a in args.split(",")]
        sigs[name] = (kind(ret), kinds)
    return sigs


def test_argtypes_table_matches_the_cuda_source():
    """psort's ctypes table against every extern "C" signature of the
    .cu: the same functions, the same argument count, and pointer versus
    64-bit versus 32-bit int at every position (a pointer passed as a
    32-bit int is cut, and ctypes would not say so)."""
    import ctypes

    def kind(t):
        if t is ctypes.c_void_p:
            return "ptr"
        if ctypes.sizeof(t) == 8:
            return "i64"
        assert ctypes.sizeof(t) == 4
        return "i32"

    sigs = _extern_c_signatures()
    assert set(sigs) == set(psort.ARGTYPES)
    for name, (res, args) in psort.ARGTYPES.items():
        assert sigs[name] == (kind(res), [kind(a) for a in args]), name
