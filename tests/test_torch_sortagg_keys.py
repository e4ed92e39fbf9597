"""The sort-agg engine's main sort words (`engine/sortagg.py` pack and
read, `csrc/sortagg_keys.cu`).

The plain version against the earlier formulas of the engine's pipeline
(copied below: the key codes, the code|position|packed key, psort's
split and join around the sort, the operands' casts and read-back, the
run starts, the compaction input and each scan's lane) on each kind of
plan: one key and two keys in mixed radix; an i32 head key, an i64 head
key of more than 31 bits and the exact code|pos|packed key; with and
without a where mask; operands of kinds i32, i64, f64 and q32 with their
nulls (integer sentinels, NaN); both compaction routes. The layouts
build_plan gives G1's queries. The CUDA wrapper's arguments through a
numpy model of the kernels' arithmetic behind their C interface: the
same cases, plans with more operands and lanes than one launch takes,
and whole grouped selects against the JAX package on the exact plan,
the head plan and the straggler fallback; the dispatch, the faults and
the ctypes table against the source. The kernels themselves are held
bit for bit against the plain version on the card by chip_smoke.py."""
import contextlib
import ctypes
import math
import os
import re
import zlib

import numpy as np
import pytest
import torch

from rayforce_tpu.engine import sortagg as rsa
from rayforce_tpu_torch.core import types as T
from rayforce_tpu_torch.engine import groupby as G
from rayforce_tpu_torch.engine import psort
from rayforce_tpu_torch.engine import select as sel
from rayforce_tpu_torch.engine import sortagg
from rayforce_tpu_torch.engine.device import DeviceError
from test_torch_psort import _extern_c_signatures
from test_torch_sortagg import _check, _engines, _mk, _runtimes  # noqa: F401
from test_torch_wide import _at

torch.set_num_threads(1)

I32, I64, F64, BOOL = torch.int32, torch.int64, torch.float64, torch.bool
INT32_MIN = -(1 << 31)
SRC = os.path.join(os.path.dirname(sortagg.__file__), "csrc",
                   "sortagg_keys.cu")


def _define(name):
    return int(re.search(rf"#define {name} (\d+)", open(SRC).read()).group(1))


# -- the earlier formulas, as the pipeline had them --------------------------

def _split(x):
    x = x.to(I64)
    return [(x >> 32).to(I32), x.to(I32) ^ INT32_MIN]


def _join(hi, lo):
    return (hi.to(I64) << 32) | ((lo ^ INT32_MIN).to(I64) & 0xFFFFFFFF)


def _old_operand(x, kind):
    if kind == "f64":
        return x.to(F64)
    if isinstance(kind, tuple):
        rq = torch.round(x * kind[1])
        return torch.where(torch.isnan(x), int(T.NULL_I32), rq.to(I32))
    return x.to(I32 if kind == "i32" else I64)


def _old_from_operand(v, kind, rt):
    if isinstance(kind, tuple):
        v = torch.where(v == int(T.NULL_I32), np.nan, v.to(F64) / kind[1])
    if rt == T.F64:
        return v, torch.isnan(v)
    v = v.to(I64)
    nv = T.NULL_BY_TYPE.get(rt)
    return v, ((v == int(nv)) if nv is not None else None)


def _old_skip(v, nul, op):
    if nul is None:
        return v
    fill, ifill = {"sum": (0.0, 0), "min": (np.inf, G.KEY_MAX),
                   "max": (-np.inf, G.I64_MIN)}[op]
    return torch.where(nul, fill if v.dtype == F64 else ifill, v)


def _old_pack(lay, keys, packed, ops, mask, n):
    """The words sort_mixed(key, [operand(x) ...]) sorted, and the codes."""
    codes = None
    for x, (lo, rng) in zip(keys, lay.keys):
        cc = (x.to(I64) - int(lo)).to(I32)
        codes = cc if codes is None else codes * int(rng) + cc
    if codes is None:
        codes = torch.zeros(n, dtype=I32)
    codes = codes.expand(n)
    if mask is not None:
        codes = torch.where(mask, codes, lay.n_codes)
    key_dt = I64 if lay.words == 2 else I32
    key = codes.to(key_dt)
    if lay.pos_bits:
        key = (key << lay.pos_bits) | torch.arange(n, dtype=key_dt)
    if lay.vb:
        key = key << lay.vb
        for x, (sh, _bits, lo) in zip(packed, lay.packed):
            key = key | ((x.to(key_dt) - lo) << sh)
    words = _split(key) if key_dt == I64 else [key]
    for x, (kind, _rt) in zip(ops, lay.operands):
        v = _old_operand(x, kind)
        if v.dtype == F64:
            words += _split(v.contiguous().view(I64))
        elif v.dtype == I64:
            words += _split(v)
        else:
            words.append(v.to(I32))
    return words, codes


def _old_read(lay, sw):
    """sc, the compaction input, [ng, nvalid] and each lane, as the
    pipeline computed them from the sorted key and operands."""
    n = int(sw[0].shape[0])
    skey = _join(sw[0], sw[1]) if lay.words == 2 else sw[0].to(I32)
    i, sops = lay.words, []
    for kind, _rt in lay.operands:
        if kind in ("i64", "f64"):
            v = _join(sw[i], sw[i + 1])
            sops.append(v.view(F64) if kind == "f64" else v)
            i += 2
        else:
            sops.append(sw[i].to(I32))
            i += 1
    sc = (skey >> (lay.vb + lay.pos_bits)).to(I32)
    valid = sc < lay.n_codes
    flags = valid & torch.cat([torch.ones(1, dtype=BOOL), sc[1:] != sc[:-1]])
    ix = torch.arange(n, dtype=I32)
    out = [sc, flags if lay.search else torch.where(flags, ix, ix + (1 << 30)),
           torch.stack([flags.sum(dtype=I32), valid.sum(dtype=I32)])]
    for spec in lay.lanes:
        if spec[0] in ("field32", "field"):
            sh, bits, lo = lay.packed[spec[1]]
            raw = (skey >> sh) & ((1 << bits) - 1)
            out.append(raw.to(I32) if spec[0] == "field32"
                       else raw.to(I64) + lo)
        elif spec[0] == "fused":
            fused = None
            for p, fo in spec[1]:
                sh, bits, _lo = lay.packed[p]
                part = ((skey >> sh) & ((1 << bits) - 1)).to(I64) << fo
                fused = part if fused is None else fused | part
            out.append(fused)
        else:
            kind, rt = lay.operands[spec[1]]
            v, nul = _old_from_operand(sops[spec[1]], kind, rt)
            out.append({"value": lambda: v, "null": lambda: nul,
                        "nulls": lambda: nul.to(I64),
                        "fill": lambda: _old_skip(v, nul, spec[-1])}[
                spec[0]]())
    return out


# -- the cases ---------------------------------------------------------------

Q32 = ("q32", 1e6)
# the numpy model multiplies a q32 word by 1 / scale, as torch divides a
# CUDA tensor by a host scalar; the plain version on the CPU divides: a
# power of two keeps both exact
Q32_MODEL = ("q32", 1024.0)


def _lanes_of_every_kind(ops):
    lanes = []
    for j, (_kind, rt) in enumerate(ops):
        lanes.append(("value", j))
        if rt == T.F64 or T.NULL_BY_TYPE.get(rt) is not None:
            lanes += [("null", j), ("nulls", j)]
        lanes += [("fill", j, op) for op in ("sum", "min", "max")]
    return tuple(lanes)


def _case(name, n=3001, q32=Q32):
    """(KeyPlan, key columns, packed columns, operand columns, where
    mask or None) of case `name` at n rows, from a seeded numpy RNG."""
    rng = np.random.default_rng(zlib.crc32(name.encode()) + n)
    pos = max((n - 1).bit_length(), 1)

    def ints(lo, hi, dtype=np.int64):
        return torch.from_numpy(rng.integers(lo, hi, n).astype(dtype))

    def holes(x, fill, share=0.1):
        at = torch.from_numpy(rng.random(n) < share)
        return torch.where(at, torch.tensor(fill, dtype=x.dtype), x)

    def mask():
        return torch.from_numpy(rng.random(n) < 0.7)
    v3 = torch.from_numpy(np.round(rng.uniform(0, 100, n), 6))
    exact = dict(n_codes=20_000, keys=((0, 20_000),), words=2,
                 pos_bits=pos, codes=False)
    KP = sortagg.KeyPlan
    if name == "one_key_exact_q3":
        return (KP(vb=3, packed=((0, 3, 1),), operands=((q32, T.F64),),
                   search=False, lanes=(("field32", 0), ("fill", 0, "sum")),
                   **exact),
                [ints(0, 20_000)], [ints(1, 6)], [holes(v3, np.nan)], None)
    if name == "one_key_exact_fused_where":
        fb = (7 * n).bit_length()
        return (KP(vb=7, packed=((0, 3, 1), (3, 4, 1)),
                   operands=((q32, T.F64),), search=False,
                   lanes=(("fused", ((0, 0), (1, fb))),
                          ("fill", 0, "sum")), **exact),
                [ints(0, 20_000)], [ints(1, 6), ints(1, 16)], [v3], mask())
    if name == "one_key_exact_search":
        return (KP(keys=((-50, 1000),), n_codes=1000, words=2,
                   pos_bits=pos, vb=7, packed=((0, 3, 1), (3, 4, -3)),
                   operands=(), codes=True, search=True,
                   lanes=(("field32", 0), ("field32", 1), ("field", 1))),
                [ints(-50, 950)], [ints(1, 6), ints(-3, 12, np.int32)], [],
                None)
    if name == "two_keys_head_i32_where":
        return (KP(keys=((0, 100), (5, 100)), n_codes=10_000, words=1,
                   pos_bits=0, vb=3, packed=((0, 3, 1),), operands=(),
                   codes=True, search=True,
                   lanes=(("field32", 0), ("field", 0))),
                [ints(0, 100), ints(5, 105, np.int32)], [ints(1, 6)], [],
                mask())
    if name == "two_keys_head_i32":
        return (KP(keys=((0, 100), (0, 200)), n_codes=20_000, words=1,
                   pos_bits=0, vb=7, packed=((0, 3, 1), (3, 4, 1)),
                   operands=(("i32", T.I64),), codes=True, search=False,
                   lanes=(("field32", 0), ("field32", 1),
                          ("fill", 0, "sum"))),
                [ints(0, 100, np.int16), ints(0, 200, np.uint8)],
                [ints(1, 6), ints(1, 16)], [ints(-2**31 + 1, 2**31 - 1)],
                None)
    if name == "one_key_head_i64":
        # 20 code bits and 14 packed: a head key of two words
        return (KP(keys=((0, 10**6),), n_codes=10**6, words=2, pos_bits=0,
                   vb=14, packed=((0, 14, -5000),), operands=(),
                   codes=True, search=False,
                   lanes=(("field32", 0), ("field", 0))),
                [ints(0, 10**6)], [ints(-5000, 5000, np.int16)], [], mask())
    if name == "operands_every_kind_where":
        ops = (("i32", T.I32), ("i32", T.I16), ("i32", T.B8),
               ("i32", T.I64), ("i64", T.I64), ("f64", T.F64),
               (q32, T.F64))
        f64 = torch.from_numpy(rng.normal(0, 1e3, n))
        for val in (np.nan, -np.nan, 0.0, -0.0, np.inf, -np.inf):
            f64 = holes(f64, val, 0.03)
        cols = [holes(ints(-2**31 + 1, 2**31 - 1, np.int32),
                      int(T.NULL_I32)),
                holes(ints(-2**15 + 1, 2**15 - 1, np.int16),
                      int(T.NULL_I16)),
                torch.from_numpy(rng.random(n) < 0.5),
                ints(-2**31 + 1, 2**31 - 1),
                holes(ints(-2**62, 2**62), int(T.NULL_I64)), f64,
                holes(v3, np.nan)]
        strided = ints(0, 1000, np.int32).repeat_interleave(2)[::2]
        return (KP(keys=((0, 1000), (7, 1)), n_codes=1000, words=2,
                   pos_bits=pos, vb=0, packed=(), operands=ops, codes=True,
                   search=True, lanes=_lanes_of_every_kind(ops)),
                [strided, torch.tensor(7)], [], cols, mask())
    raise KeyError(name)


CASES = ["one_key_exact_q3", "one_key_exact_fused_where",
         "one_key_exact_search", "two_keys_head_i32_where",
         "two_keys_head_i32", "one_key_head_i64",
         "operands_every_kind_where"]


def _same(got, want, what):
    assert len(got) == len(want), what
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == w.dtype and g.shape == w.shape, (what, i, g.dtype,
                                                           w.dtype)
        if g.dtype == F64:
            g, w = g.view(I64), w.view(I64)
        assert torch.equal(g, w), (what, i)


def _steps(name, n, step_fn, q32=Q32):
    """(the earlier formulas' outputs, step_fn's) for pack and read of
    case `name`; the sort between is the plain radix sort."""
    lay, keys, packed, ops, mask = _case(name, n, q32)
    ins = keys + packed + ops + ([mask] if mask is not None else [])
    nw = lay.words + sum(2 if k in ("i64", "f64") else 1
                         for k, _rt in lay.operands) + int(lay.codes)
    outs = step_fn("pack", lay, ins, [torch.empty(n, dtype=I32)
                                      for _ in range(nw)])
    words, codes = _old_pack(lay, keys, packed, ops, mask, n)
    want_pack = words + ([codes] if lay.codes else [])
    sw = psort.sort_i32(words, n_keys=lay.words)
    outs_r = [torch.empty(n, dtype=I32),
              torch.empty(n, dtype=BOOL if lay.search else I32),
              torch.empty(2, dtype=I32)] + [
        torch.empty(n, dtype=sortagg.lane_dtype(lay, s)) for s in lay.lanes]
    got_read = step_fn("read", lay, sw, outs_r)
    return {"pack": (want_pack, outs), "read": (_old_read(lay, sw),
                                                got_read)}


def _plain(step, lay, ins, outs):
    sortagg.sortagg_keys_plain(step, lay, ins, outs)
    return outs


@pytest.mark.parametrize("n", [977, 3001])
@pytest.mark.parametrize("name", CASES)
def test_plain_key_words_equal_the_old_formulas(name, n):
    for step, (want, got) in _steps(name, n, _plain).items():
        _same(got, want, (name, step))


def test_pack_words_and_read_words_shapes():
    """pack_words splits the codes off the words; read_words names each
    lane by its spec."""
    lay, keys, packed, ops, mask = _case("operands_every_kind_where", 977)
    words, codes = sortagg.pack_words(lay, keys, packed, ops, mask, 977)
    assert len(words) == 2 + 1 + 1 + 1 + 1 + 2 + 2 + 1
    assert codes.dtype == I32 and int(codes.max()) == 1000
    sc, comp, tot, lanes = sortagg.read_words(
        lay, psort.sort_i32(words, n_keys=2))
    assert comp.dtype == BOOL and tot.shape == (2,)
    assert list(lanes) == list(lay.lanes)
    assert int(tot[1]) == int((codes < 1000).sum())


# -- the layouts build_plan gives ----------------------------------------------

def _plan_of(prt, q):
    prt.eval_str(q)
    plans = [p for p, _src in sel._plan_cache.values()
             if isinstance(p, sortagg._SAPlan)]
    return plans[-1]


def test_build_plan_layouts_of_g1_queries():
    """q3, q5 and q6 on the exact plan (HEAD_M shrunk below their need):
    the code|pos|packed key of two words, v1 (and v2) packed, v3 a q32
    operand, the compaction sort's key; q2 on the head plan: an i32 key,
    the codes for the head sort, the cumsum route's flags."""
    old = sortagg.HEAD_M
    n, rng = 200_000, np.random.default_rng(11)
    cols = {"id1": (rng.integers(0, 100, n), "I64"),
            "id2": (rng.integers(0, 100, n), "I64"),
            "id3": (rng.integers(0, 20_000, n), "I64"),
            "v1": (rng.integers(1, 6, n), "I64"),
            "v2": (rng.integers(1, 16, n), "I64"),
            "v3": (np.round(rng.uniform(0, 100, n), 6), "F64")}
    try:
        sortagg.HEAD_M = 160_000
        _rrt, prt = _runtimes(cols)
        pos = (n - 1).bit_length()
        q3 = _plan_of(prt, "(select {s: (sum v1) a: (avg v3) from: t "
                           "by: id3})").lay
        assert q3 == sortagg.KeyPlan(
            keys=((0, 20_000),), n_codes=20_000, words=2, pos_bits=pos,
            vb=3, packed=((0, 3, 1),), operands=((("q32", 1e6), T.F64),),
            codes=False, search=False,
            lanes=(("field32", 0), ("fill", 0, "sum")))
        q5 = _plan_of(prt, "(select {s1: (sum v1) s2: (sum v2) s3: (sum v3) "
                           "from: t by: id3})").lay
        # v1 and v2 in either order (the plan orders columns by
        # identity), one fused sum lane over both
        assert sorted(b for _sh, b, _lo in q5.packed) == [3, 4]
        assert [s[0] for s in q5.lanes] == ["fused", "fill"]
        assert [p for p, _off in q5.lanes[0][1]] in ([0, 1], [1, 0])
        q6 = _plan_of(prt, "(select {mx: (max v1) mn: (min v2) from: t "
                           "by: id3})").lay
        assert q6.operands == () and \
            sorted(q6.lanes) == [("field32", 0), ("field32", 1)]
        q2 = _plan_of(prt, "(select {s: (sum v1) from: t by: {id1: id1 "
                           "id2: id2}})").lay
        assert (q2.words, q2.pos_bits, q2.codes, q2.search, q2.lanes) == \
            (1, 0, True, True, (("field32", 0),))
    finally:
        sortagg.HEAD_M = old


def test_kernel_limits_hold_the_plans():
    """A plan with more key columns than the kernels take is not built;
    the packed columns stop at the kernels' limit; the limits are the
    source's, and no plan's bit budget packs more fields than that."""
    assert sortagg.SORTAGG_KEYS_MAX_KEYS == _define("SK_MAX_KEYS")
    assert sortagg.SORTAGG_KEYS_MAX_FIELDS == _define("SK_MAX_FIELDS")
    assert re.search(r"#define SK_BIG \(1 << 30\)", open(SRC).read()) and \
        sortagg._BIG == 1 << 30
    assert re.search(r"#define SK_NULL_I32 \(-2147483647 - 1\)",
                     open(SRC).read()) and int(T.NULL_I32) == -2**31
    metas = [(f"k{i}", 0, 2, T.I64, None)
             for i in range(sortagg.SORTAGG_KEYS_MAX_KEYS + 1)]
    assert sortagg.build_plan(None, 1000, None, [None] * len(metas), metas,
                              2 ** len(metas), []) is None
    # a head key keeps 31 bits, an exact key 62, less a code bit and a
    # position bit: fewer fields than the limit either way
    assert 62 - 1 - 1 < 2 * sortagg.SORTAGG_KEYS_MAX_FIELDS


# -- the CUDA wrapper through a numpy model of the kernels ------------------------

_U = np.uint64
_NP = {0: np.uint8, 1: np.int8, 2: np.int16, 3: np.int32, 4: np.int64,
       5: np.float64}


def _u(x):
    return _U(int(x) % 2**64)


class _ModelLib:
    """The kernels' arithmetic in numpy behind their C interface: the
    addresses and arrays the wrapper passes, the launches the source's
    limits make."""

    def __init__(self, rc=0):
        self.rc = rc
        self.calls = []

    def rf_sortagg_keys_pack(self, n, n_codes, pos_bits, vb, n_keys, keys,
                             key_strides, key_kinds, key_los, key_rngs,
                             n_fields, fields, field_strides, field_kinds,
                             field_los, field_shifts, n_ops, ops,
                             op_strides, op_kinds, op_hows, op_scales,
                             op_w0, op_w1, mask, mask_stride, key0, key1,
                             codes, launches, stream):
        self.calls.append(("pack", stream))
        code = np.zeros(n, dtype=np.uint32)
        for d in range(n_keys):
            x = _at(keys[d], _NP[key_kinds[d]], n, key_strides[d])
            cc = (x.astype(np.int64).view(_U) - _u(key_los[d])).astype(
                np.uint32)
            code = code * np.uint32(key_rngs[d] % 2**32) + cc
        if mask is not None:
            m = _at(mask, np.uint8, n, mask_stride)
            code = np.where(m == 0, np.uint32(n_codes), code)
        if codes is not None:
            _at(codes, np.uint32, n)[:] = code
        key = code.view(np.int32).astype(np.int64).view(_U)
        if pos_bits:
            key = (key << _U(pos_bits)) | np.arange(n, dtype=_U)
        key = key << _U(vb)
        for f in range(n_fields):
            x = _at(fields[f], _NP[field_kinds[f]], n, field_strides[f])
            key |= (x.astype(np.int64).view(_U) - _u(field_los[f])) << \
                _U(field_shifts[f])
        if key1 is None:
            _at(key0, np.uint32, n)[:] = key.astype(np.uint32)
        else:
            self._pair(key0, key1, n, key)
        for o in range(n_ops):
            x = _at(ops[o], _NP[op_kinds[o]], n, op_strides[o])
            how = op_hows[o]
            if how == 0:
                _at(op_w0[o], np.int32, n)[:] = x.astype(np.int64).astype(
                    np.int32)
            elif how == 3:
                with np.errstate(invalid="ignore"):
                    q = np.rint(x * op_scales[o]).astype(np.int32)
                _at(op_w0[o], np.int32, n)[:] = np.where(
                    np.isnan(x), np.int32(T.NULL_I32), q)
            else:
                v = x.astype(np.float64).view(_U) if how == 2 else \
                    x.astype(np.int64).view(_U)
                self._pair(op_w0[o], op_w1[o], n, v)
        per = _define("SK_PACK_OPS")
        launches._obj.value = 1 + max(0, -(-(n_ops - per) // per))
        return self.rc

    @staticmethod
    def _pair(hi, lo, n, v):
        _at(hi, np.uint32, n)[:] = v >> _U(32)
        _at(lo, np.uint32, n)[:] = v.astype(np.uint32) ^ \
            np.uint32(0x80000000)

    @staticmethod
    def _join(hi, lo, n):
        h = _at(hi, np.uint32, n).astype(_U)
        lo_ = (_at(lo, np.uint32, n) ^ np.uint32(0x80000000)).astype(_U)
        return ((h << _U(32)) | lo_).view(np.int64)

    def rf_sortagg_keys_read(self, n, n_codes, shift_all, key0, key1, sc,
                             comp, comp_flags, tot, n_lanes, lane_ops,
                             lane_outs, lane_w0, lane_w1, lane_hows,
                             lane_shifts, lane_bits, lane_los, lane_fills,
                             lane_invs, lane_has_null, n_parts, part_shifts,
                             part_bits, part_offs, launches, stream):
        self.calls.append(("read", stream))
        key = _at(key0, np.int32, n).astype(np.int64) if key1 is None \
            else self._join(key0, key1, n)
        s = (key >> shift_all).astype(np.int32)
        valid = s < n_codes
        start = np.ones(n, dtype=bool)
        start[1:] = s[1:] != s[:-1]
        f = valid & start
        _at(sc, np.int32, n)[:] = s
        if comp_flags:
            _at(comp, np.uint8, n)[:] = f
        else:
            ix = np.arange(n, dtype=np.int32)
            _at(comp, np.int32, n)[:] = np.where(f, ix, ix + (1 << 30))
        _at(tot, np.int32, 2)[:] = [f.sum(), valid.sum()]

        def field(sh, bits):
            return ((key >> sh) & ((1 << bits) - 1)).view(_U)
        for i in range(n_lanes):
            op, out = lane_ops[i], lane_outs[i]
            if op in (0, 1):
                v = field(lane_shifts[i], lane_bits[i])
                if op == 0:
                    _at(out, np.uint32, n)[:] = v.astype(np.uint32)
                else:
                    _at(out, _U, n)[:] = v + _u(lane_los[i])
                continue
            if op == 2:
                acc = np.zeros(n, dtype=_U)
                for q in range(lane_shifts[i], lane_shifts[i] + lane_bits[i]):
                    acc |= field(part_shifts[q], part_bits[q]) << \
                        _U(part_offs[q])
                _at(out, _U, n)[:] = acc
                continue
            how = lane_hows[i]
            if how == 0:
                v = _at(lane_w0[i], np.int32, n).astype(np.int64)
            elif how in (1, 2):
                v = self._join(lane_w0[i], lane_w1[i], n)
            else:
                w = _at(lane_w0[i], np.int32, n)
                v = np.where(w == np.int32(T.NULL_I32), np.nan,
                             w.astype(np.float64) * lane_invs[i]).view(
                                 np.int64)
            if how >= 2:
                null = np.isnan(v.view(np.float64))
            else:
                null = (v == lane_los[i]) & bool(lane_has_null[i])
            if op == 4:
                _at(out, np.uint8, n)[:] = null
            elif op == 5:
                _at(out, np.int64, n)[:] = null
            else:
                _at(out, np.int64, n)[:] = np.where(
                    null & (op == 6), np.int64(lane_fills[i]), v)
        per = _define("SK_READ_LANES")
        launches._obj.value = 1 + max(0, -(-(n_lanes - per) // per))
        return self.rc


@pytest.fixture
def model(monkeypatch):
    lib = _ModelLib()
    monkeypatch.setattr(sortagg, "_sk_lib", lib)
    monkeypatch.setattr(G, "_card_stream",
                        lambda device: contextlib.nullcontext(1234))
    return lib


def _kernel(step, lay, ins, outs):
    sortagg.sortagg_keys_cuda(step, lay, ins, outs)
    return outs


@pytest.mark.parametrize("name", CASES)
def test_kernel_model_equals_the_old_formulas(model, name):
    """The CUDA wrapper's arguments, through the numpy model, give the
    earlier formulas' words and lanes bit for bit: one launch a call, on
    the card's stream, counted."""
    before = psort.LAUNCHES["sortagg_keys"]
    for step, (want, got) in _steps(name, 3001, _kernel,
                                    Q32_MODEL).items():
        _same(got, want, (name, step))
    assert model.calls == [("pack", 1234), ("read", 1234)]
    lanes = len(_case(name, 977)[0].lanes)
    per = _define("SK_READ_LANES")
    assert psort.LAUNCHES["sortagg_keys"] == before + 2 + (lanes > per)


def test_kernel_model_takes_more_launches_past_its_parameters(
        model, monkeypatch):
    """30 operands (past SK_PACK_OPS) and 60 lanes (past SK_READ_LANES):
    two launches each, every output the earlier formulas'."""
    n, rng = 1001, np.random.default_rng(5)
    ops = tuple(("i32", T.I32) if j % 2 else ("i64", T.I64)
                for j in range(30))
    lay = sortagg.KeyPlan(
        keys=((0, 50),), n_codes=50, words=2, pos_bits=10, vb=0,
        packed=(), operands=ops, codes=False, search=True,
        lanes=tuple(s for j in range(30)
                    for s in (("value", j), ("nulls", j))))
    keys = [torch.from_numpy(rng.integers(0, 50, n))]
    cols = [torch.from_numpy(rng.integers(-9, 9, n).astype(
        np.int32 if j % 2 else np.int64)) for j in range(30)]
    monkeypatch.setattr(sortagg, "_sortagg_keys", sortagg.sortagg_keys_cuda)
    before = psort.LAUNCHES["sortagg_keys"]
    words, _codes = sortagg.pack_words(lay, keys, [], cols, None, n)
    _same(words, _old_pack(lay, keys, [], cols, None, n)[0], "pack")
    sw = psort.sort_i32(words, n_keys=2)
    sc, comp, tot, lanes = sortagg.read_words(lay, sw)
    _same([sc, comp, tot] + list(lanes.values()), _old_read(lay, sw), "read")
    assert psort.LAUNCHES["sortagg_keys"] == before + 4


@pytest.mark.parametrize("exact", [True, False])
def test_selects_through_the_kernel_model(model, monkeypatch, exact):
    """Whole grouped selects with the main sort's words through the CUDA
    wrapper and the kernel model: the JAX package's answers, on the exact
    plan (HEAD_M shrunk below the need) and on the head plan; each answer
    packs and reads once."""
    monkeypatch.setattr(sortagg, "_sortagg_keys", sortagg.sortagg_keys_cuda)
    old = (sortagg.HEAD_M, rsa.HEAD_M)
    try:
        # 700 codes need 8785 head rows: 4096 puts the plan on the exact
        # key, 16384 (of 20 000 rows) on the head
        sortagg.HEAD_M = rsa.HEAD_M = 4096 if exact else 16384
        rng = np.random.default_rng(23 + exact)
        cols = _mk(rng, 20_000, 700)
        rrt, prt = _runtimes(cols)
        for q in ["(select {s: (sum v1) a: (avg v3) c: (count v1) "
                  "from: t by: k})",
                  "(select {mx: (max v2) mn: (min v1) f: (first v3) "
                  "l: (last v1) from: t by: k where: (> v2 10)})",
                  "(select {d: (dev v3) m: (med v3) s: (sum (+ v1 v2)) "
                  "from: t by: k})"]:
            del model.calls[:]
            _check(rrt, prt, q)
            assert sel.last_profile["exact"] is exact
            assert [c for c, _s in model.calls] == ["pack", "read"], q
    finally:
        sortagg.HEAD_M, rsa.HEAD_M = old


def test_straggler_fallback_through_the_kernel_model(model, monkeypatch):
    """A group seen only in the last rows: the head plan's pack and read,
    then the exact fallback's, the JAX package's answers; the next run
    goes straight to the fallback (one pack, one read)."""
    monkeypatch.setattr(sortagg, "_sortagg_keys", sortagg.sortagg_keys_cuda)
    old = (sortagg.HEAD_M, sortagg.HEAD_FACTOR, rsa.HEAD_M, rsa.HEAD_FACTOR)
    try:
        sortagg.HEAD_M, sortagg.HEAD_FACTOR = 8192, 1
        rsa.HEAD_M, rsa.HEAD_FACTOR = 8192, 1
        rng = np.random.default_rng(7)
        n = 20000
        k = rng.integers(0, 600, n).astype(np.int64)
        k[:n - 10] = k[:n - 10] % 599          # group 599 only at tail
        k[n - 10:] = 599
        rrt, prt = _runtimes(_mk(rng, n, 600, keys=k), name="u")
        q = "(select {s: (sum v1) f: (first v1) from: u by: k})"
        del model.calls[:]
        before = psort.LAUNCHES["sortagg_keys"]
        _check(rrt, prt, q)
        plan = _plan_of(prt, q)
        assert plan.fallback is not None and plan.fallback.exact
        assert [c for c, _s in model.calls][:4] == ["pack", "read"] * 2
        assert psort.LAUNCHES["sortagg_keys"] == before + 4 + 2
        del model.calls[:]
        _check(rrt, prt, q)
        assert [c for c, _s in model.calls] == ["pack", "read"]
    finally:
        (sortagg.HEAD_M, sortagg.HEAD_FACTOR, rsa.HEAD_M,
         rsa.HEAD_FACTOR) = old


def test_dispatch_and_faults(model):
    """A CPU tensor takes the plain version (no launch), another device
    raises DeviceError; a failed launch raises DeviceError, arguments the
    kernels do not take (shapes, counts, types) ValueError, before any
    launch."""
    lay, keys, packed, ops, mask = _case("one_key_exact_q3", 977)
    before = psort.LAUNCHES["sortagg_keys"]
    words, _c = sortagg.pack_words(lay, keys, packed, ops, mask, 977)
    assert model.calls == [] and psort.LAUNCHES["sortagg_keys"] == before
    meta = [torch.empty(8, dtype=I64, device="meta")] * 3
    with pytest.raises(DeviceError):
        sortagg._sortagg_keys("pack", lay, meta, [
            torch.empty(8, dtype=I32, device="meta")] * 3)
    outs = [torch.empty(977, dtype=I32) for _ in range(3)]
    ins = keys + packed + ops
    for bad_ins, bad_outs in [
            ([keys[0][:10]] + ins[1:], outs),           # a short column
            (ins + [keys[0]], outs),                    # a mask of i64
            (ins[:2], outs),                            # an operand short
            (ins, outs[:2]),                            # a word short
            (ins, outs[:2] + [torch.empty(977, dtype=I64)]),
            ([keys[0].double()] + ins[1:], outs),       # a float key
            (ins[:2] + [ops[0].to(I32)], outs)]:        # q32 of an i32
        with pytest.raises(ValueError):
            sortagg.sortagg_keys_cuda("pack", lay, bad_ins, bad_outs)
    with pytest.raises(ValueError):     # read's outputs in other types
        sortagg.sortagg_keys_cuda("read", lay, words, [
            torch.empty(977, dtype=I32) for _ in range(5)])
    with pytest.raises(ValueError):
        sortagg.sortagg_keys_cuda("sort", lay, ins, outs)
    assert model.calls == []
    model.rc = 700
    with pytest.raises(DeviceError, match="cudaError 700"):
        sortagg.sortagg_keys_cuda("pack", lay, ins, outs)


def test_argtypes_table_matches_the_cuda_source():
    """sortagg.py's ctypes table against every extern "C" signature of
    csrc/sortagg_keys.cu, pointer versus 64-bit versus 32-bit int at
    every position (a double array is a pointer); no kernel name that
    another family's roofline reader would count."""
    def kind(t):
        if t is ctypes.c_void_p:
            return "ptr"
        return "i64" if ctypes.sizeof(t) == 8 else "i32"

    sigs = _extern_c_signatures("sortagg_keys")
    assert set(sigs) == set(sortagg.SORTAGG_KEYS_ARGTYPES)
    for name, (res, args) in sortagg.SORTAGG_KEYS_ARGTYPES.items():
        assert sigs[name] == (kind(res), [kind(a) for a in args]), name
    src = open(SRC).read()
    assert not re.search(r"\b(hist|plan|pass|identity|gather|small)_kernel"
                         r"\b|seg_scan::|wide_keys::", src)
    assert math.isclose(_define("SK_THREADS") * _define("SK_ROWS"), 1024)
