"""The port's wide-code engine (rayforce_tpu_torch/engine/wide.py, more
than `dense_max` key codes) held against the JAX package's: the same
seeded numpy columns go into both packages' tables, and each query's
formatted output must match byte for byte — reference device, port
device and port host — with both packages on the wide engine. The port
runs its device path on CPU torch, where both of wide's sorts (the
multi-word key sort and the order carry-sort) are the plain version of
the CUDA radix sort.

The key words (`wide.py` pack, bound, decode): the plain version
against the earlier torch i64 formulas on each kind of plan (q7's, one and
three words, the position in a word of its own, a where mask, negative
least values, i32, u8, date, i16 and b8 keys, a broadcast scalar,
symbol and enum keys); the CUDA wrapper's arguments through a numpy
model of csrc/wide_keys.cu's arithmetic, the same cases and whole wide
selects; the dispatch, the faults and the ctypes table against the
source. The kernels themselves are held bit for bit against the plain
version on the card by chip_smoke.py."""
import contextlib
import ctypes
import os
import re
import zlib

import numpy as np
import pytest
import torch

from rayforce_tpu.engine import device as rdev
from rayforce_tpu.engine import select as rsel
from rayforce_tpu_torch.core import types as T
from rayforce_tpu_torch.engine import aggs
from rayforce_tpu_torch.engine import device as dev
from rayforce_tpu_torch.engine import groupby as G
from rayforce_tpu_torch.engine import psort
from rayforce_tpu_torch.engine import select as sel
from rayforce_tpu_torch.engine import wide
from rayforce_tpu_torch.engine.device import DeviceError
from test_torch_dense import _check
from test_torch_psort import _extern_c_signatures
from test_torch_sortagg import _runtimes, null_groups

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


def _wide(rrt, prt, q):
    assert _check(rrt, prt, q, engine="wide") == "wide"


# tests/test_wide.py, through both packages

def test_wide_two_keys():
    rng = np.random.default_rng(21)
    n = 30000
    k1 = rng.integers(0, 2000, n).astype(np.int64)
    k2 = rng.integers(0, 1000, n).astype(np.int64)
    v1 = rng.integers(-50, 50, n).astype(np.int64)
    v1[rng.integers(0, n, 200)] = T.NULL_I64
    v3 = rng.uniform(-10, 10, n)
    v3[rng.integers(0, n, 200)] = np.nan
    rrt, prt = _runtimes({"k1": (k1, "I64"), "k2": (k2, "I64"),
                          "v1": (v1, "I64"), "v3": (v3, "F64")})
    for q in [
        "(select {s: (sum v1) c: (count v1) from: t by: {k1: k1 k2: k2}})",
        "(select {a: (avg v3) mx: (max v1) from: t by: {k1: k1 k2: k2}})",
        "(select {mn: (min v3) from: t by: {k1: k1 k2: k2} "
        "where: (> v1 0)})",
        "(select {f: (first v3) l: (last v1) from: t by: {k1: k1 k2: k2}})",
    ]:
        _wide(rrt, prt, q)


def test_wide_multiword_keys():
    """Key ranges whose packed width exceeds one 61-bit word."""
    rng = np.random.default_rng(5)
    n = 20000
    k1 = rng.integers(0, 1 << 20, n).astype(np.int64) << 15
    k2 = rng.integers(0, 1 << 20, n).astype(np.int64) << 20
    k3 = rng.integers(0, 500, n).astype(np.int64)
    v = rng.uniform(0, 100, n)
    rrt, prt = _runtimes({"k1": (k1, "I64"), "k2": (k2, "I64"),
                          "k3": (k3, "I64"), "v": (v, "F64")})
    _wide(rrt, prt, "(select {s: (sum v) c: (count v) from: t "
                    "by: {k1: k1 k2: k2 k3: k3}})")


def test_wide_all_rows_distinct():
    rng = np.random.default_rng(9)
    n = 20000
    k = rng.permutation(np.arange(3_000_000, dtype=np.int64))[:n]
    v = rng.integers(0, 100, n).astype(np.int64)
    rrt, prt = _runtimes({"k": (k, "I64"), "v": (v, "I64")})
    _wide(rrt, prt, "(select {s: (sum v) from: t by: k})")


def test_wide_engine_matches_host():
    """tests/test_device_parity.py's table and query with dense_max
    forced to 512 in both packages, so 7 x 1200 codes go wide."""
    rng = np.random.default_rng(42)
    N = 4000
    id1 = rng.integers(0, 7, N).astype(np.int64)
    id3 = rng.integers(0, 1200, N).astype(np.int64)
    v1 = rng.integers(-3, 6, N).astype(np.int64)
    v1[rng.integers(0, N, 40)] = T.NULL_I64
    v2 = rng.integers(0, 100, N).astype(np.int32)
    v3 = rng.uniform(-50, 100, N)
    v3[rng.integers(0, N, 40)] = np.nan
    rrt, prt = _runtimes({"id1": (id1, "I64"), "id3": (id3, "I64"),
                          "v1": (v1, "I64"), "v2": (v2, "I32"),
                          "v3": (v3, "F64")})
    old = (rdev._cfg["dense_max"], dev._cfg["dense_max"])
    rdev._cfg["dense_max"] = dev._cfg["dense_max"] = 512
    try:
        _wide(rrt, prt, "(select {s: (sum v3) c: (count v1) from: t by: "
                        "{id1: id1 id3: id3}})")
    finally:
        rdev._cfg["dense_max"], dev._cfg["dense_max"] = old


# groups whose values are all null (id3 % 5 == 0) and partly null
# (id3 % 5 == 1): a nullable i64, a nullable f64, derived exprs
NULL_GROUPS = [
    "(select {s: (sum n1) a: (avg n1) mn: (min n1) mx: (max n1) "
    "f: (first n1) l: (last n1) c: (count n1) from: t "
    "by: {id1: id1 id3: id3}})",
    "(select {s: (sum n3) a: (avg n3) mn: (min n3) mx: (max n3) "
    "f: (first n3) l: (last n3) c: (count n3) from: t "
    "by: {id1: id1 id3: id3}})",
    "(select {s: (sum (+ n1 v2)) a: (avg (+ n1 v2)) mn: (min (+ n1 v2)) "
    "mx: (max (+ n1 v2)) c: (count n1) from: t by: {id1: id1 id3: id3}})",
    "(select {s: (sum (* n3 2.0)) a: (avg (* n3 2.0)) "
    "mn: (min (* n3 2.0)) mx: (max (* n3 2.0)) from: t "
    "by: {id1: id1 id3: id3}})",
]


@pytest.fixture(scope="module")
def null_tables():
    """tests/test_device_parity.py's key columns with null_groups'
    columns over id3."""
    rng = np.random.default_rng(42)
    N = 4000
    id1 = rng.integers(0, 7, N).astype(np.int64)
    id3 = rng.integers(0, 1200, N).astype(np.int64)
    v2 = rng.integers(0, 100, N).astype(np.int32)
    n1, n3 = null_groups(rng, id3)
    return _runtimes({"id1": (id1, "I64"), "id3": (id3, "I64"),
                      "v2": (v2, "I32"), "n1": (n1, "I64"),
                      "n3": (n3, "F64")})


@pytest.mark.parametrize("q", NULL_GROUPS)
def test_wide_null_groups_match_reference(null_tables, q):
    """dense_max forced to 512 in both packages, so 7 x 1200 codes go
    wide."""
    old = (rdev._cfg["dense_max"], dev._cfg["dense_max"])
    rdev._cfg["dense_max"] = dev._cfg["dense_max"] = 512
    try:
        _wide(*null_tables, q)
    finally:
        rdev._cfg["dense_max"], dev._cfg["dense_max"] = old


Q7 = ("(select {s: (sum v3) c: (count v3) from: t by: "
      "{id1: id1 id2: id2 id3: id3 id4: id4 id5: id5 id6: id6}})")


def test_q7_on_g1_key_ranges():
    """bench.py q7 on a 20 000-row table with G1's key ranges and its
    6-decimal v3, so the key words are laid out as on the 1e7-row table:
    id1, id2, id3, id4, id5 (45 bits) in word 0 under the trash bit,
    id6 and the row position in word 1 — 4 i32 key words in the sort."""
    rng = np.random.default_rng(2024)
    n = 20_000
    cols = {}
    for nm, hi in (("id1", 100), ("id2", 100), ("id3", 100_000),
                   ("id4", 100), ("id5", 100), ("id6", 100_000)):
        cols[nm] = (rng.integers(0, hi, n).astype(np.int64), "I64")
    cols["v1"] = (rng.integers(1, 6, n).astype(np.int64), "I64")
    cols["v3"] = (np.round(rng.uniform(0, 100, n), 6), "F64")
    rrt, prt = _runtimes(cols)
    calls = []
    plain = psort.sort_i32_plain

    def counting(words, n_keys=1, perm=False):
        calls.append((n_keys, len(words)))
        return plain(words, n_keys, perm=perm)

    psort.sort_i32_plain = counting
    try:
        sel.last_profile.clear()
        _wide(rrt, prt, Q7)
    finally:
        psort.sort_i32_plain = plain
    assert rsel.last_profile["engine"] == sel.last_profile["engine"] == "wide"
    # the key sort: 4 key words + v3 as one q32 word; the carry sort:
    # fkey + 4 code words + s (f64, 2 words) + c (i32)
    assert calls == [(4, 5), (1, 8)]


# -- the key words: plain version, kernel model, dispatch ---------------------
#
# The torch formulas wide.py ran before its key-word kernels, kept as
# the yardstick: it packed the i64 words in torch and split them with
# psort.split64, found the run boundaries on the joined i64 words with
# the position bits masked, and decoded the key columns from the masked
# words the order sort carried.

def _old_pack(lay, keys, mask, n):
    dvals = [k.to(torch.int64).expand(n) - lo
             for k, lo in zip(keys, lay.mins)]
    wvals = []
    for wi, wdims in enumerate(lay.words):
        w = torch.zeros(n, dtype=torch.int64)
        for di, sh, _bits in wdims:
            w = w | (dvals[di] << sh)
        if wi == lay.pos_word:
            w = w | torch.arange(n, dtype=torch.int64)
        wvals.append(w)
    if mask is not None:
        wvals[0] = wvals[0] | torch.where(mask, 0, 1 << 61)
    return [x for w in wvals for x in psort.split64(w)]


def _old_bound(lay, words):
    n_words = len(lay.words)
    sw = [psort.join64(words[2 * i], words[2 * i + 1])
          for i in range(n_words)]
    posmask = (1 << lay.pos_bits) - 1
    valid = sw[0] < (1 << 61)
    swc = [sw[i] if i != lay.pos_word else sw[i] & ~posmask
           for i in range(n_words)]
    diff = None
    for i in range(n_words):
        dd = swc[i][1:] != swc[i][:-1]
        diff = dd if diff is None else (diff | dd)
    flags = valid & torch.cat([torch.ones(1, dtype=torch.bool), diff])
    inc = flags.to(torch.int32) + (~valid).to(torch.int32)
    pos_row = sw[lay.pos_word] & posmask
    fkey = torch.where(flags, pos_row, 0x7FFFFFFF).to(torch.int32)
    return [flags, inc, pos_row, fkey], swc


def _old_decode(lay, key_meta, cw_o):
    out = []
    for wi, wdims in enumerate(lay.words):
        for di, sh, bits in wdims:
            _nm, lo, _rng, rt, dom = key_meta[di]
            vals = ((cw_o[wi] >> sh) & ((1 << bits) - 1)) + lo
            if rt == T.SYMBOL or dom is not None:
                out.append(vals.to(torch.int64))
            else:
                out.append(vals.to(aggs.tdt(rt)))
    return out


def _pick(rng, n, choices, dtype):
    return torch.from_numpy(np.asarray(choices, dtype=np.int64)[
        rng.integers(0, len(choices), n)]).to(dtype)


def _key_case(name, n=3001):
    """(key_meta, key columns, where mask or None, the rows the layout
    is made for) of each case; values come from each range's ends and a
    few values between, so that runs of equal keys form."""
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    i64 = torch.int64
    if name in ("q7", "q7_where"):
        # the layout q7 has at 1e7 rows, on 3001 of them
        meta = [(nm, 0, hi, T.I64, None) for nm, hi in (
            ("id1", 100), ("id2", 100), ("id3", 100_000), ("id4", 100),
            ("id5", 100), ("id6", 100_000))]
        keys = [_pick(rng, n, [0, hi - 1], i64)
                for _nm, _lo, hi, _rt, _dom in meta]
        mask = torch.from_numpy(rng.random(n) < 0.7) \
            if name == "q7_where" else None
        return meta, keys, mask, 10_000_000
    specs = {   # name -> [(rtype, lo, rng, dtype, choices)]
        "one_word": [(T.I64, 0, 1000, i64, [0, 1, 999]),
                     (T.I64, 3, 50, i64, [3, 52])],
        "three_words": [(T.I64, 0, 2**40, i64, [0, 2**40 - 1]),
                        (T.I64, 0, 2**40, i64, [0, 7, 2**40 - 1]),
                        (T.I64, 0, 2**40, i64, [1, 2**39])],
        "pos_own_word": [(T.I64, 0, 2**50, i64, [0, 2**50 - 1, 12345])],
        "negative_lo": [(T.I64, -2**40, 2**41, i64,
                         [-2**40, -1, 0, 2**40]),
                        (T.I64, -7, 15, i64, [-7, 0, 7])],
        "narrow": [(T.I32, -2**31, 2**32, torch.int32,
                    [-2**31, -1, 0, 2**31 - 1]),
                   (T.U8, 0, 256, torch.uint8, [0, 255]),
                   (T.DATE, 8000, 2000, torch.int32, [8000, 9999]),
                   (T.I16, -2**15, 2**16, torch.int16, [-2**15, 2**15 - 1]),
                   (T.B8, 0, 2, torch.int8, [0, 1])],
        "scalar": [(T.I64, 42, 1, i64, None),
                   (T.I64, 0, 3_000_000, i64, [0, 5, 2_999_999])],
        "symbol_enum": [(T.SYMBOL, 17, 100_000, i64, [17, 100_016]),
                        (T.ENUM, 0, 5000, i64, [0, 1, 4999])],
    }[name]
    meta, keys = [], []
    for j, (rt, lo, rg, dt, choices) in enumerate(specs):
        meta.append((f"k{j}", lo, rg, rt, "dom" if rt == T.ENUM else None))
        keys.append(torch.tensor(lo, dtype=dt) if choices is None
                    else _pick(rng, n, choices, dt))
    mask = torch.from_numpy(rng.random(n) < 0.6) \
        if name == "negative_lo" else None
    return meta, keys, mask, n


KEY_CASES = ("q7", "q7_where", "one_word", "three_words", "pos_own_word",
             "negative_lo", "narrow", "scalar", "symbol_enum")


def test_key_layouts_stay_as_they_were():
    """build_plan's word layout, now `key_layout`: q7 at 1e7 rows puts
    id1-id5 (45 bits) in word 0 and id6 with 24 position bits in word 1;
    the cases take one, three words and the position in its own word."""
    lays = {name: wide.key_layout(*_key_case(name)[::3])
            for name in KEY_CASES}
    assert lays["q7"].words == (
        ((0, 38, 7), (1, 31, 7), (2, 14, 17), (3, 7, 7), (4, 0, 7)),
        ((5, 24, 17),))
    assert (lays["q7"].pos_word, lays["q7"].pos_bits) == (1, 24)
    assert lays["q7"].carry == (0, 1)
    assert len(lays["one_word"].words) == 1
    assert len(lays["three_words"].words) == 3
    assert lays["pos_own_word"].words[1] == () and \
        lays["pos_own_word"].pos_word == 1 and \
        lays["pos_own_word"].carry == (0,)
    assert lays["narrow"].out == (torch.int32, torch.uint8, torch.int32,
                                  torch.int16, torch.int8)
    assert lays["symbol_enum"].out == (torch.int64, torch.int64)
    assert lays["negative_lo"].mins == (-2**40, -7)
    meta = [(f"k{i}", 0, 2, T.I64, None) for i in range(65)]
    assert wide.key_layout(meta, 100) is None      # more than 64 dims
    assert wide.key_layout(meta[:64], 100) is not None


def _steps(name, run):
    """(the old formulas' outputs, `run`'s outputs) of each step on one
    case: pack; the plain sort of the packed words; bound; decode of the
    carried words in a random order (the order sort's stand-in)."""
    meta, keys, mask, rows = _key_case(name)
    lay = wide.key_layout(meta, rows)
    n = max(int(k.numel()) for k in keys)
    got = {}
    kw = run("pack", lay, keys + ([mask] if mask is not None else []),
             [torch.empty(n, dtype=torch.int32)
              for _ in range(2 * len(lay.words))])
    got["pack"] = (_old_pack(lay, keys, mask, n), kw)
    sw = psort.sort_i32_plain(kw, n_keys=len(kw))
    want, swc = _old_bound(lay, sw)
    got["bound"] = (want, run("bound", lay, sw, [
        torch.empty(n, dtype=t) for t in (torch.bool, torch.int32,
                                          torch.int64, torch.int32)]))
    perm = torch.from_numpy(np.random.default_rng(3).permutation(n))
    carried = [sw[i][perm] for wi in lay.carry
               for i in (2 * wi, 2 * wi + 1)]
    got["decode"] = (_old_decode(lay, meta, [w[perm] for w in swc]),
                     run("decode", lay, carried,
                         [torch.empty(n, dtype=t) for t in lay.out]))
    return lay, got


def _plain(step, lay, ins, outs):
    wide.wide_keys_plain(step, lay, ins, outs)
    return outs


@pytest.mark.parametrize("name", KEY_CASES)
def test_plain_key_words_equal_the_old_formulas(name):
    """The plain pack, bound and decode against the earlier i64
    formulas, word for word and column for column."""
    lay, got = _steps(name, _plain)
    for step, (want, have) in got.items():
        assert len(want) == len(have), step
        for i, (w, h) in enumerate(zip(want, have)):
            assert w.dtype == h.dtype and torch.equal(w, h), (step, i)
    flags = got["bound"][1][0]
    assert 0 < int(flags.sum()) < flags.numel()    # runs of equal keys


# a model of csrc/wide_keys.cu behind its C interface: it reads and
# writes the tensors' memory at the pointers the wrapper passes, in the
# kernel's uint64 word arithmetic
_NP_KINDS = {0: np.uint8, 1: np.int8, 2: np.int16, 3: np.int32, 4: np.int64}
_U = np.uint64


def _at(ptr, dtype, n, stride=1):
    """n elements of dtype at a CPU address, stride elements apart (0:
    one element for every row), as a writable numpy view."""
    count = 1 if stride == 0 else (n - 1) * stride + 1
    ct = np.ctypeslib.as_ctypes_type(np.dtype(dtype))
    a = np.ctypeslib.as_array((ct * count).from_address(ptr))
    return np.broadcast_to(a[:1], (n,)) if stride == 0 else a[::stride]


class _ModelLib:
    def __init__(self, rc=0):
        self.rc = rc
        self.calls = []

    def rf_wide_keys_pack(self, n, n_dims, keys, strides, kinds, mins,
                          words, shifts, n_words, pos_word, mask,
                          mask_stride, hi, lo, stream):
        self.calls.append(("pack", stream))
        acc = np.zeros((n_words, n), dtype=_U)
        for d in range(n_dims):
            x = _at(keys[d], _NP_KINDS[kinds[d]], n, strides[d])
            acc[words[d]] |= (x.astype(np.int64).view(_U) -
                              _U(mins[d] % 2**64)) << _U(shifts[d])
        acc[pos_word] |= np.arange(n, dtype=_U)
        if mask is not None:
            m = _at(mask, np.uint8, n, mask_stride)
            acc[0] |= np.where(m == 0, _U(1 << 61), _U(0))
        for w in range(n_words):
            _at(hi[w], np.uint32, n)[:] = acc[w] >> _U(32)
            _at(lo[w], np.uint32, n)[:] = \
                acc[w].astype(np.uint32) ^ np.uint32(0x80000000)
        return self.rc

    def rf_wide_keys_bound(self, n, n_words, pos_word, pos_bits, hi, lo,
                           flags, inc, pos, fkey, stream):
        self.calls.append(("bound", stream))
        H = [_at(hi[w], np.int32, n) for w in range(n_words)]
        L = [_at(lo[w], np.uint32, n) for w in range(n_words)]
        pm = np.uint32((1 << pos_bits) - 1)
        valid = H[0] < (1 << 29)
        diff = np.zeros(n, dtype=bool)
        diff[0] = True
        for w in range(n_words):
            keep = ~pm if w == pos_word else np.uint32(0xFFFFFFFF)
            diff[1:] |= (H[w][1:] != H[w][:-1]) | \
                (((L[w][1:] ^ L[w][:-1]) & keep) != 0)
        f = valid & diff
        at = (L[pos_word] ^ np.uint32(0x80000000)) & pm
        _at(flags, np.uint8, n)[:] = f
        _at(inc, np.int32, n)[:] = f.astype(np.int32) + ~valid
        _at(pos, np.int64, n)[:] = at
        _at(fkey, np.int32, n)[:] = np.where(f, at, 0x7FFFFFFF)
        return self.rc

    def rf_wide_keys_decode(self, n, n_words, hi, lo, n_dims, words,
                            shifts, bits, mins, kinds, outs, stream):
        self.calls.append(("decode", stream))
        for d in range(n_dims):
            h = _at(hi[words[d]], np.uint32, n).astype(_U)
            l_ = (_at(lo[words[d]], np.uint32, n) ^
                  np.uint32(0x80000000)).astype(_U)
            v = ((h << _U(32)) | l_).view(np.int64) >> shifts[d]
            x = (v.view(_U) & _U((1 << bits[d]) - 1)) + _U(mins[d] % 2**64)
            _at(outs[d], _NP_KINDS[kinds[d]], n)[:] = \
                x.view(np.int64).astype(_NP_KINDS[kinds[d]])
        return self.rc


@pytest.fixture
def model(monkeypatch):
    lib = _ModelLib()
    monkeypatch.setattr(wide, "_wk_lib", lib)
    monkeypatch.setattr(G, "_card_stream",
                        lambda device: contextlib.nullcontext(1234))
    return lib


def _kernel(step, lay, ins, outs):
    wide.wide_keys_cuda(step, lay, ins, outs)
    return outs


@pytest.mark.parametrize("name", KEY_CASES)
def test_kernel_model_equals_the_old_formulas(model, name):
    """The CUDA wrapper's arguments, through a numpy model of the
    kernels' arithmetic, give the earlier formulas' words and columns bit
    for bit: one launch a call, on the card's stream."""
    before = psort.LAUNCHES["wide_keys"]
    _lay, got = _steps(name, _kernel)
    for step, (want, have) in got.items():
        for i, (w, h) in enumerate(zip(want, have)):
            assert w.dtype == h.dtype and torch.equal(w, h), (step, i)
    assert model.calls == [("pack", 1234), ("bound", 1234),
                           ("decode", 1234)]
    assert psort.LAUNCHES["wide_keys"] == before + 3


def test_wide_selects_through_the_kernel_model(model, monkeypatch):
    """Whole wide selects with the engine's key words through the CUDA
    wrapper and the kernel model: the reference's answers; each query
    packs, bounds and decodes once."""
    monkeypatch.setattr(wide, "_wide_keys", wide.wide_keys_cuda)
    rng = np.random.default_rng(77)
    n = 20_000
    cols = {"k1": (rng.integers(-3000, 3000, n).astype(np.int32), "I32"),
            "k2": (rng.integers(0, 256, n).astype(np.uint8), "U8"),
            "k3": (rng.integers(8000, 9000, n).astype(np.int32), "DATE"),
            "k4": (rng.integers(-500, 500, n).astype(np.int16), "I16"),
            "sy": (np.asarray([f"s{i}" for i in rng.integers(0, 40, n)]),
                   "SYMBOL"),
            "v1": (rng.integers(-50, 50, n).astype(np.int64), "I64"),
            "v3": (rng.uniform(-10, 10, n), "F64")}
    rrt, prt = _runtimes(cols)
    for q in [
        "(select {s: (sum v1) c: (count v1) from: t by: "
        "{k1: k1 k2: k2 k3: k3}})",
        "(select {a: (avg v3) f: (first v1) l: (last v3) from: t by: "
        "{k4: k4 sy: sy k1: k1} where: (> v1 0)})",
    ]:
        del model.calls[:]
        _wide(rrt, prt, q)
        assert [c for c, _s in model.calls] == ["pack", "bound", "decode"]


def test_dispatch_and_faults(model):
    """A CPU tensor takes the plain version (no launch), another device
    raises DeviceError; a failed launch raises DeviceError, a shape the
    kernels do not take ValueError, before any launch."""
    meta, keys, mask, rows = _key_case("one_word")
    lay = wide.key_layout(meta, rows)
    before = psort.LAUNCHES["wide_keys"]
    wide.pack_keys(lay, keys, mask, 3001)
    assert model.calls == [] and psort.LAUNCHES["wide_keys"] == before
    meta_dev = [torch.empty(8, dtype=torch.int64, device="meta")]
    with pytest.raises(DeviceError):
        wide._wide_keys("pack", lay, meta_dev, [
            torch.empty(8, dtype=torch.int32, device="meta")] * 2)
    outs = [torch.empty(3001, dtype=torch.int32) for _ in range(2)]
    with pytest.raises(ValueError):
        wide.wide_keys_cuda("pack", lay, [keys[0][:10], keys[1]], outs)
    with pytest.raises(ValueError):
        wide.wide_keys_cuda("pack", lay, [keys[0].double(), keys[1]], outs)
    with pytest.raises(ValueError):     # a mask of other than bytes
        wide.wide_keys_cuda("pack", lay, keys + [keys[0]], outs)
    with pytest.raises(ValueError):     # bound's outputs in other types
        wide.wide_keys_cuda("bound", lay, outs, [
            torch.empty(3001, dtype=torch.int32) for _ in range(4)])
    assert model.calls == []
    model.rc = 700
    with pytest.raises(DeviceError, match="cudaError 700"):
        wide.wide_keys_cuda("pack", lay, keys, outs)
    assert psort.LAUNCHES["wide_keys"] == before


def test_argtypes_table_matches_the_cuda_source():
    """wide.py's ctypes table against every extern "C" signature of
    csrc/wide_keys.cu, pointer versus 64-bit versus 32-bit int at every
    position; the dims limit against WK_MAX_DIMS."""
    def kind(t):
        if t is ctypes.c_void_p:
            return "ptr"
        return "i64" if ctypes.sizeof(t) == 8 else "i32"

    sigs = _extern_c_signatures("wide_keys")
    assert set(sigs) == set(wide.WIDE_KEYS_ARGTYPES)
    for name, (res, args) in wide.WIDE_KEYS_ARGTYPES.items():
        assert sigs[name] == (kind(res), [kind(a) for a in args]), name
    src = open(os.path.join(os.path.dirname(wide.__file__), "csrc",
                            "wide_keys.cu")).read()
    assert re.search(r"#define WK_MAX_DIMS (\d+)", src).group(1) == \
        str(wide.WIDE_KEYS_MAX_DIMS)
    # no kernel name that another family's roofline reader would count
    assert not re.search(r"\b(hist|plan|pass|identity|gather|small)_kernel"
                         r"\b|seg_scan::", src)
