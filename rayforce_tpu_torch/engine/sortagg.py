"""Mid-cardinality group-by: one sort + compacted segments.

Covers SMALL_N < n_codes <= dense_max (the reference's perfect/
range-multiplier group index over medium key spaces, core/index.c:2308;
its radix-partitioned grouping, core/index.c:2556, is the same
sort-then-segment idea). Every sort here goes through the psort entry
(engine/psort.py), which launches the hand-written CUDA radix sort on
the card.

Pipeline (plain torch over the column tensors, one scalar fetch):

1. codes (i32) from the dense key space; where-masked rows -> NC.
2. Small null-free integer aggregate columns PACK INTO THE SORT KEY's
   low bits; everything else rides as sort operands (i32 when the type
   or cached stats allow, else i64/f64).
3. ONE sort on the packed key.
4. Segment boundaries -> compaction, by a cumsum + searchsorted when
   NCAP <= SEARCH_NCAP, else by a second i32 sort of
   (boundary? position : position+BIG): the first NCAP entries are the
   group start positions in code order. Shapes are static; ng is the
   only data-dependent value, fetched as a scalar.
5. Every aggregate is a segmented scan (or key-bit extract) gathered
   at segment ends; counts are boundary diffs.
6. First-appearance order: a "head sort" over the first M rows
   (packed code|pos) yields exact first-row ids when every group
   appears in the head; a `straggler` flag (any group missing from the
   head) triggers ONE re-run on an exact fallback plan whose i64 key
   carries the row position (code|pos|packed). `last` symmetrically
   uses a tail sort. The fallback decision is cached on the plan.
7. Output lanes stay ON DEVICE (DevPendingSliced: capacity-NCAP lanes
   with logical length ng); the host fetches only [ng, straggler].

Steps 1-2 and the full-width reads after step 3 (the codes, the run
starts, the compaction input, each scan's lane) live in the main sort's
own i32 words from packing to reading back (an i64 key as psort's pair:
the signed high i32, the low i32 with its sign bit flipped). On the card
two hand-written kernels (`csrc/sortagg_keys.cu`, entered through
`_sortagg_keys`) pack the words from the columns and read the sorted
words back; on a CPU tensor `sortagg_keys_plain` does the same with the
torch formulas. The layout is build_plan's `KeyPlan`.

What the aggregates become (slots, operands, null rules, result
types) is engine/aggs.py's. Groups here are always non-empty
(compaction keeps occupied codes only), so empty-group fills never
apply.
"""
from __future__ import annotations

import ctypes
import math
import struct
from typing import NamedTuple

import numpy as np
import torch

from ..core import profiler as prof
from ..core import types as T
from . import aggs as A
from . import device as dev
from . import groupby as G
from .aggs import INT_LIKE, tdt
from .device import DeviceError
from .psort import (LAUNCHES, _LAUNCHES_LOCK, _words, argsort, join64,
                    sort_by_code, sort_i32, sort_mixed, split64)

# head/tail sort sizing (module-level so tests can shrink them to force
# the straggler fallback). The head must make missing-group odds tiny:
# for NC uniform groups the coupon-collector bound needs
# M >= NC*(ln NC + margin) rows.
HEAD_M = 1 << 21
HEAD_FACTOR = 8

# boundary-compaction strategy switch: up to this many groups a cumsum
# and one searchsorted replace the full-width compaction sort
SEARCH_NCAP = 1 << 14

_BIG = 1 << 30

I32, I64, F64, BOOL = torch.int32, torch.int64, torch.float64, torch.bool


class _SAPlan:
    __slots__ = ("fn", "col_objs", "key_meta", "aggs", "n_codes",
                 "n_rows", "exact", "fallback", "out_meta", "lay",
                 "_rebuild")


def _starts(sc):
    """Run starts of a sorted code vector: True where sc changes."""
    return torch.cat([torch.ones(1, dtype=BOOL, device=sc.device),
                      sc[1:] != sc[:-1]])


# -- the main sort's words ---------------------------------------------------

class KeyPlan(NamedTuple):
    """build_plan's main-sort words. keys: (least value, range) of each
    key column, the first most significant (aggs.mixed_codes); n_codes:
    the code of a where-masked row; words: 1 (an i32 key) or 2 (an i64
    key as psort's pair); pos_bits: the row position's bits under the
    packed fields (the exact plan), 0 for none; vb: the packed fields'
    bits; packed: (shift, bits, lo) of each packed column; operands:
    (kind, rtype) of each sort operand (aggs.operand_kind); codes:
    whether pack writes the i32 codes too (the head and tail sorts and
    med's sorts read them); search: whether read writes the run starts'
    flags (the cumsum route of the compaction) or the compaction sort's
    key; lanes: what read writes for the scans, each a tuple:
    ("field32", p) packed column p's biased field as i32, ("field", p)
    its value as i64, ("fused", ((p, offset), ...)) fields at their
    offsets of one i64 sum lane, ("value", j) operand j's value
    (aggs.from_operand), ("null", j) its null mask, ("nulls", j) the mask
    as i64, ("fill", j, op) its value with nulls as op's identity
    (aggs.skip_nulls)."""
    keys: tuple
    n_codes: int
    words: int
    pos_bits: int
    vb: int
    packed: tuple
    operands: tuple
    codes: bool
    search: bool
    lanes: tuple


# (restype, argtypes) of every extern "C" function of csrc/sortagg_keys.cu;
# tests/test_torch_sortagg_keys.py holds this table against the source
_P, _I32, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
SORTAGG_KEYS_ARGTYPES = {
    "rf_sortagg_keys_pack": (_I32, [
        _I64, _I32, _I32, _I32, _I32, _P, _P, _P, _P, _P, _I32, _P, _P, _P,
        _P, _P, _I32, _P, _P, _P, _P, _P, _P, _P, _P, _I64, _P, _P, _P, _P,
        _P]),
    "rf_sortagg_keys_read": (_I32, [
        _I64, _I32, _I32, _P, _P, _P, _P, _I32, _P, _I32, _P, _P, _P, _P,
        _P, _P, _P, _P, _P, _P, _P, _I32, _P, _P, _P, _P, _P]),
}
# the most key columns and packed columns a plan may have (the source's
# SK_MAX_KEYS, SK_MAX_FIELDS; the tests hold them against the source)
SORTAGG_KEYS_MAX_KEYS = 16
SORTAGG_KEYS_MAX_FIELDS = 32
# the kernels' column types (a bool is read as its byte), operand forms
# and lanes
_SK_KINDS = {torch.bool: 0, torch.uint8: 0, torch.int8: 1, torch.int16: 2,
             torch.int32: 3, torch.int64: 4, torch.float64: 5}
_SK_HOWS = {"i32": 0, "i64": 1, "f64": 2, "q32": 3}
_SK_LANES = {"field32": 0, "field": 1, "fused": 2, "value": 3, "null": 4,
             "nulls": 5, "fill": 6}

_sk_lib = None


def _sortagg_keys_lib():
    global _sk_lib
    if _sk_lib is None:
        from . import cubuild
        lib = cubuild.load("sortagg_keys")
        try:
            for name, (res, args) in SORTAGG_KEYS_ARGTYPES.items():
                fn = getattr(lib, name)
                fn.restype = res
                fn.argtypes = args
        except AttributeError as e:
            raise DeviceError(f"sort-agg key library: {e}") from e
        _sk_lib = lib
    return _sk_lib


def _how(kind):
    return "q32" if isinstance(kind, tuple) else kind


def _width(kind):
    """Sort words of one operand of `kind`."""
    return 2 if kind in ("i64", "f64") else 1


def lane_dtype(lay, spec):
    """The dtype of read's lane `spec`."""
    what = spec[0]
    if what == "field32":
        return I32
    if what == "null":
        return BOOL
    if what in ("value", "fill"):
        return F64 if _how(lay.operands[spec[1]][0]) in ("f64", "q32") \
            else I64
    return I64


def _key(lay, words):
    """The key of the words (i32, or the i64 of psort's pair)."""
    return words[0] if lay.words == 1 else join64(words[0], words[1])


def sortagg_keys_plain(step, lay, ins, outs):
    """The plain PyTorch version of `sortagg_keys_cuda` (the engine takes
    it for CPU tensors; chip_smoke.py times it on the card as the torch
    path the kernels replace): the torch formulas of the key, psort's
    words and aggs' operand rules. Steps:
    "pack": ins the key columns, the packed columns and the operand
      columns (a broadcast scalar as one element), then the where mask if
      the plan has one; outs the key's lay.words i32 words, each
      operand's words (psort._words of aggs.operand), then the i32 codes
      if lay.codes;
    "read": ins the sorted words (the key's, then the operands'); outs sc
      (i32, the group code), the compaction input (bool flags if
      lay.search, else the i32 key: the row where flagged, else row +
      2^30), the two i32 totals (flagged, valid rows), then each lane of
      lay.lanes (`lane_dtype`)."""
    n, d = int(outs[0].shape[0]), outs[0].device
    nk, nf, no = len(lay.keys), len(lay.packed), len(lay.operands)
    if step == "pack":
        codes = A.mixed_codes(ins[:nk], lay.keys, n, d)
        if len(ins) > nk + nf + no:
            codes = torch.where(ins[nk + nf + no], codes, lay.n_codes)
        key_dt = I64 if lay.words == 2 else I32
        key = codes.to(key_dt)
        if lay.pos_bits:
            key = (key << lay.pos_bits) | torch.arange(n, dtype=key_dt,
                                                       device=d)
        if lay.vb:
            key = key << lay.vb
            for x, (sh, _bits, lo) in zip(ins[nk:nk + nf], lay.packed):
                key = key | ((x.to(key_dt) - lo) << sh)
        words = [key] if lay.words == 1 else list(split64(key))
        for x, (kind, _rt) in zip(ins[nk + nf:nk + nf + no], lay.operands):
            words += _words(A.operand(x, kind))
        if lay.codes:
            words.append(codes)
        for o, w in zip(outs, words):
            o.copy_(w)
    elif step == "read":
        skey = _key(lay, ins)
        sc = (skey >> (lay.vb + lay.pos_bits)).to(I32)
        valid = sc < lay.n_codes
        flags = valid & _starts(sc)
        outs[0].copy_(sc)
        if lay.search:
            outs[1].copy_(flags)
        else:
            ix = torch.arange(n, dtype=I32, device=d)
            outs[1].copy_(torch.where(flags, ix, ix + _BIG))
        outs[2].copy_(torch.stack([flags.sum(dtype=I32),
                                   valid.sum(dtype=I32)]))
        vals, i = [], lay.words
        for kind, rt in lay.operands:
            if _width(kind) == 2:
                v = join64(ins[i], ins[i + 1])
                v = v.view(F64) if kind == "f64" else v
            else:
                v = ins[i]
            i += _width(kind)
            vals.append(A.from_operand(v, kind, rt))

        def field(p):
            sh, bits, _lo = lay.packed[p]
            return (skey >> sh) & ((1 << bits) - 1)
        for o, spec in zip(outs[3:], lay.lanes):
            what = spec[0]
            if what == "field32":
                o.copy_(field(spec[1]).to(I32))
            elif what == "field":
                o.copy_(field(spec[1]).to(I64) + lay.packed[spec[1]][2])
            elif what == "fused":
                fused = None
                for p, off in spec[1]:
                    part = field(p).to(I64) << off
                    fused = part if fused is None else fused | part
                o.copy_(fused)
            else:
                v, nul = vals[spec[1]]
                o.copy_(v if what == "value" else nul if what == "null"
                        else nul.to(I64) if what == "nulls"
                        else A.skip_nulls(v, nul, spec[2]))
    else:
        raise ValueError(f"sortagg_keys: no step {step!r}")


def _stride(x):
    """Elements a row of a column or mask: 0 for a broadcast scalar."""
    return 0 if x.numel() == 1 else x.stride(0)


def _f64_bits(x):
    return struct.unpack("<q", struct.pack("<d", float(x)))[0]


def sortagg_keys_cuda(step, lay, ins, outs):
    """The CUDA key-word kernels (csrc/sortagg_keys.cu) on CUDA tensors:
    bit for bit `sortagg_keys_plain`, the same steps, inputs and
    outputs, one launch a call (one more for each share of operands or
    lanes past the kernel's parameters). Columns and the mask are read
    in place at their strides. Any failure to build, load or launch
    raises DeviceError."""
    n = int(outs[0].shape[0])
    dv = outs[0].device
    nk, nf, no = len(lay.keys), len(lay.packed), len(lay.operands)
    hows = [_how(k) for k, _rt in lay.operands]
    n_words = lay.words + sum(_width(k) for k, _rt in lay.operands)
    ok = {"pack": nk + nf + no <= len(ins) <= nk + nf + no + 1 and
          nk <= SORTAGG_KEYS_MAX_KEYS and nf <= SORTAGG_KEYS_MAX_FIELDS and
          all(x.dtype != F64 for x in ins[:nk + nf]) and
          all((x.dtype == F64) == (h in ("f64", "q32"))
              for x, h in zip(ins[nk + nf:], hows)) and
          all(x.element_size() == 1 for x in ins[nk + nf + no:]) and
          [x.dtype for x in outs] == [I32] * (n_words + lay.codes),
          "read": len(ins) == n_words and
          all(x.dtype == I32 and x.numel() == n and x.is_contiguous()
              for x in ins) and
          [x.dtype for x in outs] == [I32, BOOL if lay.search else I32,
                                      I32] + [lane_dtype(lay, s)
                                              for s in lay.lanes]}
    bad = [x for x in ins + outs if x.device != dv or x.dim() > 1 or
           x.dtype not in _SK_KINDS]
    sizes = [2 if step == "read" and i == 2 else n
             for i in range(len(outs))]
    if not ok.get(step, True) or bad or \
            any(x.numel() not in (1, n) for x in ins) or \
            [x.numel() for x in outs] != sizes or \
            any(not x.is_contiguous() for x in outs):
        raise ValueError(f"sortagg_keys {step}: {n} rows on {dv}, ins " +
                         ", ".join(f"{x.dtype} {tuple(x.shape)} on {x.device}"
                                   for x in ins) + "; outs " +
                         ", ".join(f"{x.dtype} {tuple(x.shape)}"
                                   for x in outs))
    lib = _sortagg_keys_lib()

    def arr(xs, t=ctypes.c_void_p):
        return (t * max(len(xs), 1))(*xs)

    def ptrs(xs):
        return arr([None if x is None else x.data_ptr() for x in xs])

    launches = ctypes.c_int(0)
    try:
        with G._card_stream(dv) as stream:
            if step == "pack":
                keys, fields = ins[:nk], ins[nk:nk + nf]
                ops = ins[nk + nf:nk + nf + no]
                mask = ins[nk + nf + no] if len(ins) > nk + nf + no \
                    else None
                w0, w1, at = [], [], lay.words
                for kind, _rt in lay.operands:
                    w0.append(outs[at])
                    w1.append(outs[at + 1] if _width(kind) == 2 else None)
                    at += _width(kind)
                rc = lib.rf_sortagg_keys_pack(
                    n, lay.n_codes, lay.pos_bits, lay.vb,
                    nk, ptrs(keys), arr([_stride(k) for k in keys],
                                        ctypes.c_int64),
                    arr([_SK_KINDS[k.dtype] for k in keys], ctypes.c_int),
                    arr([int(lo) for lo, _r in lay.keys], ctypes.c_int64),
                    arr([int(r) for _lo, r in lay.keys], ctypes.c_int64),
                    nf, ptrs(fields), arr([_stride(f) for f in fields],
                                          ctypes.c_int64),
                    arr([_SK_KINDS[f.dtype] for f in fields], ctypes.c_int),
                    arr([lo for _sh, _b, lo in lay.packed], ctypes.c_int64),
                    arr([sh for sh, _b, _lo in lay.packed], ctypes.c_int),
                    no, ptrs(ops), arr([_stride(x) for x in ops],
                                       ctypes.c_int64),
                    arr([_SK_KINDS[x.dtype] for x in ops], ctypes.c_int),
                    arr([_SK_HOWS[h] for h in hows], ctypes.c_int),
                    arr([k[1] if h == "q32" else 0.0 for (k, _rt), h
                         in zip(lay.operands, hows)], ctypes.c_double),
                    ptrs(w0), ptrs(w1),
                    mask.data_ptr() if mask is not None else None,
                    _stride(mask) if mask is not None else 0,
                    outs[0].data_ptr(),
                    outs[1].data_ptr() if lay.words == 2 else None,
                    outs[-1].data_ptr() if lay.codes else None,
                    ctypes.byref(launches), stream)
            elif step == "read":
                firsts, at = [], lay.words
                for kind, _rt in lay.operands:
                    firsts.append(at)
                    at += _width(kind)
                parts, rows = [], []
                for spec in lay.lanes:
                    what, src = spec[0], spec[1]
                    row = {"op": _SK_LANES[what], "w0": None, "w1": None,
                           "how": 0, "shift": 0, "bits": 0, "lo": 0,
                           "fill": 0, "inv": 0.0, "null": 0}
                    if what in ("field32", "field"):
                        sh, bits, lo = lay.packed[src]
                        row.update(shift=sh, bits=bits,
                                   lo=lo if what == "field" else 0)
                    elif what == "fused":
                        row.update(shift=len(parts), bits=len(src))
                        parts += [(lay.packed[p][0], lay.packed[p][1], off)
                                  for p, off in src]
                    else:
                        kind, rt = lay.operands[src]
                        how, f64 = _how(kind), rt == T.F64
                        nv = A.dt_null(rt)
                        i = firsts[src]
                        row.update(
                            w0=ins[i], w1=ins[i + 1] if _width(kind) == 2
                            else None, how=_SK_HOWS[how],
                            lo=0 if f64 or nv is None else int(nv),
                            null=int(not f64 and nv is not None),
                            inv=1.0 / kind[1] if how == "q32" else 0.0)
                        if what == "fill":
                            fill = A.null_fill(spec[2], f64)
                            row["fill"] = _f64_bits(fill) if f64 \
                                else int(fill)
                    rows.append(row)

                def col(k, t=ctypes.c_int):
                    return arr([r[k] for r in rows], t)
                rc = lib.rf_sortagg_keys_read(
                    n, lay.n_codes, lay.vb + lay.pos_bits,
                    ins[0].data_ptr(),
                    ins[1].data_ptr() if lay.words == 2 else None,
                    outs[0].data_ptr(), outs[1].data_ptr(), int(lay.search),
                    outs[2].data_ptr(), len(rows), col("op"),
                    ptrs(outs[3:]), ptrs([r["w0"] for r in rows]),
                    ptrs([r["w1"] for r in rows]), col("how"), col("shift"),
                    col("bits"), col("lo", ctypes.c_int64),
                    col("fill", ctypes.c_int64), col("inv", ctypes.c_double),
                    col("null"), len(parts),
                    arr([p[0] for p in parts], ctypes.c_int),
                    arr([p[1] for p in parts], ctypes.c_int),
                    arr([p[2] for p in parts], ctypes.c_int),
                    ctypes.byref(launches), stream)
            else:
                raise ValueError(f"sortagg_keys: no step {step!r}")
    except (DeviceError, ValueError):
        raise
    except Exception as e:
        raise DeviceError(f"sortagg_keys {step}: {type(e).__name__}: {e}") \
            from e
    with _LAUNCHES_LOCK:
        LAUNCHES["sortagg_keys"] += launches.value
    if rc != 0:
        raise DeviceError(f"sortagg_keys {step} launch failed: cudaError "
                          f"{rc}")


def _sortagg_keys(step, lay, ins, outs):
    """One step of the main sort's words (`sortagg_keys_plain`'s
    contract): on a CUDA tensor the hand-written kernels, on a CPU tensor
    the plain version; nothing in between."""
    d = outs[0].device
    if d.type == "cuda":
        return sortagg_keys_cuda(step, lay, ins, outs)
    if d.type == "cpu":
        return sortagg_keys_plain(step, lay, ins, outs)
    raise DeviceError(f"sortagg_keys: no key-word kernels for device {d}")


def pack_words(lay, keys, packed, operands, mask, n):
    """The main sort's i32 words of n rows (the key's, then each
    operand's) and the i32 codes (None unless lay.codes) from the key
    columns, the packed columns, the operand columns and the where mask
    (or None)."""
    nw = lay.words + sum(_width(k) for k, _rt in lay.operands) + \
        int(lay.codes)
    outs = list(torch.empty((nw, n), dtype=I32,
                            device=keys[0].device).unbind(0))
    _sortagg_keys("pack", lay, list(keys) + list(packed) + list(operands) +
                  ([mask] if mask is not None else []), outs)
    return (outs[:-1], outs[-1]) if lay.codes else (outs, None)


def read_words(lay, words):
    """(sc, the compaction input, the totals [flagged, valid], {lane spec:
    lane}) of the sorted words (`sortagg_keys_plain`)."""
    n, d = int(words[0].shape[0]), words[0].device
    outs = [torch.empty(n, dtype=I32, device=d),
            torch.empty(n, dtype=BOOL if lay.search else I32, device=d),
            torch.empty(2, dtype=I32, device=d)] + [
        torch.empty(n, dtype=lane_dtype(lay, s), device=d)
        for s in lay.lanes]
    _sortagg_keys("read", lay, list(words), outs)
    return outs[0], outs[1], outs[2], dict(zip(lay.lanes, outs[3:]))


def build_plan(src, n_rows, cw, key_cs, key_meta, n_codes, aggs,
               force_exact=False):
    """Build a sort-agg plan (or None when unsupported)."""
    if n_rows >= (1 << 30) or n_rows == 0 or \
            len(key_meta) > SORTAGG_KEYS_MAX_KEYS:
        return None
    NC = n_codes
    NCAP = min(NC, n_rows)
    code_bits = max(int(NC).bit_length(), 1)
    pos_bits = max((n_rows - 1).bit_length(), 1)
    M = min(HEAD_M, n_rows)
    need = NC * (math.log(max(NC, 2)) + 6.0) * HEAD_FACTOR / 8.0
    use_head = (not force_exact) and n_rows > M and need <= M and \
        NCAP <= M
    exact = not use_head

    slots = A.Slots(cw, key_cs, [a.inner for a in aggs])
    cinfo = A.col_needs(aggs)
    need_lidx = any(a.name == "last" for a in aggs)

    # --- key packing (static) -------------------------------------------
    budget = (62 - code_bits - pos_bits) if exact else (31 - code_bits)
    packed: dict = {}   # cid -> (shift, bits, lo)
    vb = 0
    pack_order = sorted(cinfo)
    # pack a min/max-bearing column LAST (= the TOP field, highest
    # shift): within a group the sorted key's first/last rows then
    # carry that field's exact min/max for free (skey[bpos]/skey[ea]),
    # eliminating its segmented scans. Only valid in head mode — the
    # exact plan interleaves position bits above the values.
    mm_cands = [c for c in pack_order
                if cinfo[c]["ops"] & {"min", "max"}]
    if mm_cands and not exact:
        best = max(mm_cands,
                   key=lambda c: len(cinfo[c]["ops"] & {"min", "max"}))
        pack_order.remove(best)
        pack_order.append(best)
    for cid in pack_order:
        ci = cinfo[cid]
        if not (ci["ops"] - {"null", "med"}):
            continue   # nothing rides the main sort for this column
        if "null" in ci["ops"] or not ci["plain"] or \
                ci["rtype"] not in INT_LIKE or \
                len(packed) == SORTAGG_KEYS_MAX_FIELDS:
            continue
        col = ci["agg"].cols[0].col
        lo, hi = dev.column_range(col)
        if hi < lo:
            continue
        bits = max(int(hi - lo).bit_length(), 1)
        if vb + bits <= budget:
            packed[cid] = (vb, bits, int(lo))
            vb += bits
    # the free-boundary-extremes cid: packed, top field, min/max ops
    top_cid = None
    if packed and not exact:
        tc = max(packed, key=lambda c: packed[c][0])
        if cinfo[tc]["ops"] & {"min", "max"}:
            top_cid = tc

    operands, op_ix = A.operands(cinfo, packed)

    med_cids = sorted(cid for cid, ci in cinfo.items()
                      if "med" in ci["ops"])
    med_qs = {}
    for cid in med_cids:
        if cinfo[cid]["rtype"] == T.F64 and cinfo[cid]["plain"]:
            med_qs[cid] = dev.column_qscale(cinfo[cid]["agg"].cols[0].col)

    key_dt = I64 if (exact or code_bits + vb > 31) else I32
    posmask = (1 << pos_bits) - 1

    # --- the lanes read writes, and what each aggregate scans (static) --
    # FUSE the key-packed (null-free) integer sums into ONE segmented
    # scan: each column's biased values occupy a disjoint bit field
    # sized for its worst-case group sum, so one i64 seg-sum yields
    # every column's totals (extract + un-bias).
    pix = {cid: i for i, cid in enumerate(packed)}
    fuse_fields = []   # (cid, field_off, lo)
    foff = 0
    for cid in sorted(packed):
        if "sum" not in cinfo[cid]["ops"]:
            continue
        sh, bits, lo = packed[cid]
        span = (1 << bits) - 1
        fbits = max(int(span * n_rows).bit_length(), 1)
        if foff + fbits > 62:
            continue
        fuse_fields.append((cid, foff, lo))
        foff += fbits
    if len(fuse_fields) < 2:
        fuse_fields = []
    specs: list = []

    def lane(spec):
        if spec not in specs:
            specs.append(spec)
        return spec
    fused = lane(("fused", tuple((pix[cid], fo) for cid, fo, _lo
                                 in fuse_fields))) if fuse_fields else None
    # cid -> {"sum" / "min" / "max": (lane spec or "free", lo to add after
    # the scan or None), "nulls": lane spec, "dev": (value lane, null lane
    # or None)}
    scans: dict = {}
    for cid, ci in cinfo.items():
        ops = ci["ops"]
        got = scans[cid] = {}
        if cid in packed:
            p = pix[cid]
            sh, bits, lo = packed[cid]
            span = (1 << bits) - 1
            f32, fv = ("field32", p), ("field", p)
            if "sum" in ops and cid not in {c for c, _o, _l in fuse_fields}:
                # packed null-free field: biased i32 scan where group sums
                # are provably < 2^31, un-biased at the boundary
                got["sum"] = (lane(f32), lo) if span * n_rows < (1 << 31) \
                    else (lane(fv), None)
            if "dev" in ops:
                got["dev"] = (lane(fv), None)
            for m in ("min", "max"):
                if m in ops:
                    got[m] = ("free", lo) if cid == top_cid else \
                        (lane(f32), lo) if span < (1 << 31) else \
                        (lane(fv), None)
        elif cid in op_ix:
            j = op_ix[cid]
            nullable = ci["rtype"] == T.F64 or \
                A.dt_null(ci["rtype"]) is not None
            if "null" in ops and nullable:
                got["nulls"] = lane(("nulls", j))
            if "sum" in ops:
                got["sum"] = (lane(("fill", j, "sum")), None)
            if "dev" in ops:
                got["dev"] = (lane(("value", j)),
                              lane(("null", j)) if nullable else None)
            for m in ("min", "max"):
                if m in ops:
                    got[m] = (lane(("fill", j, m)), None)

    lay = KeyPlan(
        keys=tuple((lo, rng) for _nm, lo, rng, _rt, _dom in key_meta),
        n_codes=NC, words=2 if key_dt == I64 else 1,
        pos_bits=pos_bits if exact else 0, vb=vb,
        packed=tuple(packed.values()),
        operands=tuple((kind, cinfo[cid]["rtype"]) for cid, kind
                       in operands),
        codes=not exact or bool(med_cids), search=NCAP <= SEARCH_NCAP,
        lanes=tuple(specs))
    out_meta: dict = {"exact": exact}

    def pipeline(*cols):
        d = cols[0].device if cols else dev.device()

        def iota(n, dtype=I32):
            return torch.arange(n, dtype=dtype, device=d)

        mask = None
        if cw is not None:
            mask = slots.eval(cw, cols).to(BOOL)
        arrs = {cid: slots.eval(ci["agg"], cols)
                for cid, ci in cinfo.items() if ci["ops"]}

        # ---- main sort ---------------------------------------------------
        words, codes = pack_words(
            lay, [slots.eval(ck, cols) for ck in key_cs],
            [arrs[cid] for cid in packed],
            [arrs[cid] for cid, _kind in operands], mask, n_rows)
        sw = sort_i32(words, n_keys=lay.words)
        sc, comp, tot, L = read_words(lay, sw)
        ng, nvalid = tot[0], tot[1]

        def skey_at(ix):
            """The sorted key at rows ix (skey[ix])."""
            return _key(lay, [w[ix] for w in sw[:lay.words]])

        # ---- boundary compaction ------------------------------------
        if lay.search:
            # few groups: j-th boundary = first position where the
            # flag prefix-count reaches j+1
            cum = torch.cumsum(comp, 0, dtype=I32)
            bpos = torch.searchsorted(
                cum, torch.arange(1, NCAP + 1, dtype=I32, device=d),
                side="left", out_int32=True)
        else:
            bpos = sort_i32([comp])[0][:NCAP] & (_BIG - 1)
        bposc = torch.clamp(bpos, 0, n_rows - 1).long()
        jar = iota(NCAP)
        occ = jar < ng
        nxt = torch.cat([bpos[1:], bpos.new_zeros(1)])
        bnext = torch.where(jar + 1 < ng, nxt, nvalid)
        counts = (bnext - bpos).to(I64)
        ea = torch.clamp(bnext - 1, 0, n_rows - 1).long()
        bcode = sc[bposc]

        # ---- per-cid segment scans over read's lanes ---------------------
        segres = {}
        nullcnt = {}
        if fused is not None:
            ftot = G.seg_doubling_sum(sc, L[fused])[ea]
            for i, (cid, fo, lo) in enumerate(fuse_fields):
                hi_off = fuse_fields[i + 1][1] if i + 1 < \
                    len(fuse_fields) else 63
                field = (ftot >> fo) & ((1 << (hi_off - fo)) - 1)
                # un-bias: actual sum = field + lo * group count
                segres[("sum", cid)] = field + lo * counts

        for cid, got in scans.items():
            if "nulls" in got:
                nullcnt[cid] = G.seg_doubling_sum(sc, L[got["nulls"]])[ea]
            if "sum" in got:
                spec, lo = got["sum"]
                s = G.seg_doubling_sum(sc, L[spec])[ea]
                segres[("sum", cid)] = s if lo is None else \
                    s.to(I64) + lo * counts
            if "dev" in got:
                # std via segment-min-shifted moments: var =
                # E[(x-c)^2] - E[x-c]^2 with c = per-segment min
                # (broadcast per row as min(fwd-scan, bwd-scan)) —
                # cancellation-safe like the host's two-pass np.std
                vspec, nspec = got["dev"]
                xv = L[vspec].to(F64)
                nn = L[nspec] if nspec is not None else \
                    torch.zeros(xv.shape, dtype=BOOL, device=d)
                xm = torch.where(nn, np.inf, xv)
                fmin = G.seg_doubling_min(sc, xm)
                bmin = G.seg_doubling_min(sc, xm, reverse=True)
                c = torch.minimum(fmin, bmin)
                dd = torch.where(nn | ~torch.isfinite(c), 0.0, xv - c)
                segres[("devs", cid)] = G.seg_doubling_sum(sc, dd)[ea]
                segres[("dev2", cid)] = G.seg_doubling_sum(sc, dd * dd)[ea]
            for m, scan, at in (("min", G.seg_doubling_min, bposc),
                                ("max", G.seg_doubling_max, ea)):
                if m not in got:
                    continue
                spec, lo = got[m]
                if spec == "free":
                    # top packed field: the group's first (last) sorted
                    # row carries its exact min (max): code equal within
                    # the segment, this field is the highest value bits
                    sh, bits, _lo = packed[cid]
                    segres[(m, cid)] = ((skey_at(at) >> sh) &
                                        ((1 << bits) - 1)).to(I64) + lo
                else:
                    r = scan(sc, L[spec])[ea]
                    segres[(m, cid)] = r if lo is None else r.to(I64) + lo

        # ---- med: per-column (code, value) sorts reusing bpos ------------
        medvals = {}   # cid -> (sorted values, dequant scale or None)
        for cid in med_cids:
            rt = cinfo[cid]["rtype"]
            a = arrs[cid]
            qs = med_qs.get(cid)
            if rt == T.F64:
                if qs:
                    # i32 quantized med key: exact order, nulls last
                    rq = torch.round(a * qs)
                    mkey = torch.where(torch.isnan(a), 0x7FFFFFFF,
                                       rq.to(I32))
                else:
                    mkey = torch.where(torch.isnan(a), np.inf, a)
            else:
                nv = A.dt_null(rt)
                a64 = a.to(I64)
                mkey = torch.where(a64 == int(nv), G.KEY_MAX, a64) \
                    if nv is not None else a64
            medvals[cid] = (sort_by_code(codes, mkey), qs)

        # ---- first/last row ids ------------------------------------------
        straggler = torch.zeros((), dtype=I32, device=d)
        lidx = None
        if exact:
            fidx = ((skey_at(bposc) >> vb) & posmask).to(I64)
            lidx = ((skey_at(ea) >> vb) & posmask).to(I64)
        else:
            hb = max((M - 1).bit_length(), 1)
            hiota = iota(M)
            hkey = (codes[:M].to(I64) << hb) | iota(M, I64)
            hs, _ = sort_mixed(hkey, [])
            hsc = (hs >> hb).to(I32)
            hflags = (hsc < NC) & _starts(hsc)
            hng = hflags.sum(dtype=I32)
            hck = torch.where(hflags, hiota, hiota + _BIG)
            hbpos = sort_i32([hck])[0][:NCAP] & (_BIG - 1)
            hbposc = torch.clamp(hbpos, 0, M - 1).long()
            hbcode = hsc[hbposc]
            fidx = (hs[hbposc] & ((1 << hb) - 1)).to(I64)
            straggler = ((ng != hng) |
                         (occ & (bcode != hbcode)).any()).to(I32)
            if need_lidx:
                tcodes = codes[n_rows - M:]
                tkey = (tcodes.to(I64) << hb) | (M - 1 - iota(M, I64))
                ts, _ = sort_mixed(tkey, [])
                tsc = (ts >> hb).to(I32)
                tflags = (tsc < NC) & _starts(tsc)
                tng = tflags.sum(dtype=I32)
                tck = torch.where(tflags, hiota, hiota + _BIG)
                tbpos = sort_i32([tck])[0][:NCAP] & (_BIG - 1)
                tbposc = torch.clamp(tbpos, 0, M - 1).long()
                tbcode = tsc[tbposc]
                trev = ts[tbposc] & ((1 << hb) - 1)
                lidx = (n_rows - M) + (M - 1 - trev)
                straggler = straggler | (
                    (ng != tng) | (occ & (bcode != tbcode)).any()
                ).to(I32)

        # ---- first-appearance ordering -----------------------------------
        fkey = torch.where(occ, fidx, G.KEY_MAX)
        ordi = argsort(fkey)

        def order(x):
            return x[ordi]

        lanes = []
        names = []

        def emit(nm, x):
            names.append(nm)
            lanes.append(x)

        # key decode (device-side, compacted code -> per-key values)
        for i, (km, vals) in enumerate(zip(key_meta, A.key_values(
                order(bcode).to(I64), key_meta))):
            emit(f"key{i}", vals.to(tdt(km[3])))

        counts_o = order(counts)
        fidx_o = order(fidx)
        lidx_o = order(lidx) if lidx is not None else None

        def eff(cid):
            if cid in nullcnt:
                return counts_o - order(nullcnt[cid])
            return counts_o

        for a in aggs:
            cid = id(a.inner)
            rt = a.inner.rtype if a.name != "count" else T.I64
            lane = A.lane_name(a)
            if lane in names:
                continue
            if a.name == "count":
                emit(lane, counts_o)
            elif a.name in ("first", "last"):
                srcv = cols[slots.of[cid][0]]
                emit(lane, srcv[torch.clamp(
                    fidx_o if a.name == "first" else lidx_o, 0, n_rows - 1)])
            elif a.name in ("min", "max"):
                v = order(segres[(a.name, cid)])
                v = A.minmax_nulls(v, (order(nullcnt[cid]) >= counts_o)
                                   if cid in nullcnt else None, a, rt)
                emit(lane, v.to(tdt(rt)))
            elif a.name == "med":
                e = eff(cid)
                sv, qs = medvals[cid]
                emit(lane, A.median(sv, order(bpos).to(I64), e, n_rows, qs))
            elif a.name == "dev":
                e = eff(cid).to(F64)
                emit(lane, A.stddev(order(segres[("devs", cid)]),
                                    order(segres[("dev2", cid)]), e))
            elif a.name == "avg":
                e = eff(cid).to(F64)
                emit(lane, A.avg(order(segres[("sum", cid)]).to(F64), e))
            else:               # sum
                s = order(segres[("sum", cid)])
                if A.sum_propagates(a, cid in nullcnt):
                    s = A.sum_nulls(s, order(nullcnt[cid]), rt)
                emit(lane, s.to(tdt(A.result_type(a))))

        out_meta["names"] = names
        scalars = torch.stack([ng.to(I64), straggler.to(I64)])
        return (scalars,) + tuple(lanes)

    plan = _SAPlan()
    plan.fn = pipeline
    plan.col_objs = slots.cols
    plan.key_meta = key_meta
    plan.aggs = aggs
    plan.n_codes = NC
    plan.n_rows = n_rows
    plan.exact = exact
    plan.lay = lay
    plan.fallback = None
    plan.out_meta = out_meta
    if not exact:
        plan._rebuild = lambda: build_plan(
            src, n_rows, cw, key_cs, key_meta, n_codes, aggs,
            force_exact=True)
    return plan


def run(plan: _SAPlan):
    """Execute; returns the result table (device-resident columns),
    "empty" for a zero-group result, or re-runs the exact fallback
    plan when a group is missing from the head/tail windows."""
    if plan.fallback is not None:
        # a previous run hit a straggler: this data needs the exact
        # plan — go straight to it (don't pay the head attempt again)
        return run(plan.fallback)
    cols = [dev.dev_col(c) for c in plan.col_objs]
    outs = plan.fn(*cols)
    scalars = prof.host("sortagg.scalars", outs[0].cpu)
    ng, straggler = int(scalars[0]), int(scalars[1])
    if straggler and not plan.exact:
        with prof.span("plan: build"):
            plan.fallback = plan._rebuild()
        return run(plan.fallback)
    if plan.exact:
        with _LAUNCHES_LOCK:
            LAUNCHES["sortagg_exact"] += 1
    if ng <= 0:
        return "empty"
    return A.lanes_table(plan.key_meta, plan.aggs,
                         dict(zip(plan.out_meta["names"], outs[1:])), ng)
