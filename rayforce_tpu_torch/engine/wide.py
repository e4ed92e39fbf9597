"""High-cardinality grouping (n_codes > dense_max, up to ~n_rows
groups): the analogue of the reference's radix-partitioned hash
grouping (core/index.c:2556-2729), built on the same sort+segment
design as engine/sortagg.py but with:

- group keys packed into MULTIPLE i64 sort words (a 6-key group-by
  whose dense code space exceeds 2^62 still works losslessly — no
  hashing, no collisions); the row position rides the last word's low
  bits, so first/last-row ids come from segment boundaries exactly;
- a trash bit above word 0 routes where-masked rows to the end;
- per-group totals by REVERSED segmented scans, which put each
  segment's total on its first (boundary) row;
- first-appearance output ordering via ONE more sort that carries the
  result lanes alongside the first-row-id key (n_groups can be
  ~n_rows, so the result never leaves the device in group order);
- outputs stay ON DEVICE (DevPendingSliced); the host fetches one
  scalar (the group count).

The key words live in the radix sort's own i32 form from packing to
decoding (an i64 word as psort's pair: the signed high i32, the low i32
with its sign bit flipped). On the card three hand-written kernels
(`csrc/wide_keys.cu`, entered through `_wide_keys`) pack them from the
key columns, find the run boundaries in the sorted words and decode the
key columns from the words the order sort carried; on a CPU tensor
`wide_keys_plain` does the same with the i64 formulas. Both sorts go
through `psort.sort_lex` with these i32 words as their keys, so nothing
is split or joined around them.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from ..core import profiler as prof
from ..core import types as T
from ..core.obj import Obj, table, DevPendingSliced
from . import device as dev
from . import groupby as G
from .device import DeviceError
from .exprc import as_tensor, torch_dtype
from .psort import LAUNCHES, _LAUNCHES_LOCK, join64, sort_lex, split64

_TRASH_SHIFT = 61

SUM_OUT = {T.U8: T.I64, T.I16: T.I64, T.I32: T.I32, T.I64: T.I64}
NARROW32 = (T.B8, T.U8, T.I16, T.I32, T.DATE, T.TIME)

I32, I64, F64, BOOL = torch.int32, torch.int64, torch.float64, torch.bool


class _WPlan:
    __slots__ = ("fn", "col_objs", "key_meta", "aggs", "n_rows",
                 "out_meta")


def _dt_null(rt):
    return T.NULL_BY_TYPE.get(rt)


def _tdt(rt):
    return torch_dtype(T.DTYPE[rt])


# -- the key words ---------------------------------------------------------

class KeyLayout(NamedTuple):
    """build_plan's word layout. words[w]: ((dim, shift, bits), ...) of
    i64 word w, dims in order; mins[d]: dim d's least value; the row
    position in the low pos_bits of word pos_word; carry: the words that
    hold a dim, which the order sort carries (every word but a last one
    that holds the position alone); out: each dim's output dtype."""
    words: tuple
    mins: tuple
    pos_word: int
    pos_bits: int
    carry: tuple
    out: tuple


# (restype, argtypes) of every extern "C" function of csrc/wide_keys.cu;
# tests/test_torch_wide.py holds this table against the source
_P, _I32, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
WIDE_KEYS_ARGTYPES = {
    "rf_wide_keys_pack": (_I32, [_I64, _I32, _P, _P, _P, _P, _P, _P, _I32,
                                 _I32, _P, _I64, _P, _P, _P]),
    "rf_wide_keys_bound": (_I32, [_I64, _I32, _I32, _I32, _P, _P, _P, _P,
                                  _P, _P, _P]),
    "rf_wide_keys_decode": (_I32, [_I64, _I32, _P, _P, _I32, _P, _P, _P,
                                   _P, _P, _P, _P]),
}
# the most key dims a plan may have (the source's WK_MAX_DIMS; the
# tests hold it against the source)
WIDE_KEYS_MAX_DIMS = 64
# the kernels' column types (a bool is read as its byte)
_WK_KINDS = {torch.bool: 0, torch.uint8: 0, torch.int8: 1, torch.int16: 2,
             torch.int32: 3, torch.int64: 4}

_wk_lib = None


def _wide_keys_lib():
    global _wk_lib
    if _wk_lib is None:
        from . import cubuild
        lib = cubuild.load("wide_keys")
        try:
            for name, (res, args) in WIDE_KEYS_ARGTYPES.items():
                fn = getattr(lib, name)
                fn.restype = res
                fn.argtypes = args
        except AttributeError as e:
            raise DeviceError(f"wide key library: {e}") from e
        _wk_lib = lib
    return _wk_lib


def _stride(x):
    """Elements a row of a key column or mask: 0 for a broadcast scalar."""
    return 0 if x.numel() == 1 else x.stride(0)


def wide_keys_plain(step, lay, ins, outs):
    """The plain PyTorch version of `wide_keys_cuda` (the engine takes it
    for CPU tensors; chip_smoke.py times it on the card as the torch
    path the kernels replace): the i64 formulas, each word split as
    psort.split64. Steps:
    "pack": ins the key columns (dim order; a broadcast scalar as one
      element) and the where mask if the plan has one; outs the 2
      len(words) i32 sort words (high, low of each word);
    "bound": ins the sorted words; outs flags (bool: a valid row whose
      key, the position bits masked, differs from the row above), inc
      (i32: flags + not valid), pos (i64: the row position) and fkey
      (i32: pos on a flagged row, else INT32_MAX);
    "decode": ins the carried words (high, low of each word of
      lay.carry); outs each dim's column in its output dtype."""
    n, d = int(outs[0].shape[0]), outs[0].device
    if step == "pack":
        nd = len(lay.mins)
        vals = [k.to(I64).expand(n) - lo for k, lo in zip(ins, lay.mins)]
        for wi, wdims in enumerate(lay.words):
            w = torch.zeros(n, dtype=I64, device=d)
            for di, sh, _bits in wdims:
                w = w | (vals[di] << sh)
            if wi == lay.pos_word:
                w = w | torch.arange(n, dtype=I64, device=d)
            if wi == 0 and len(ins) > nd:
                w = w | torch.where(ins[nd].to(BOOL).expand(n), 0,
                                    1 << _TRASH_SHIFT)
            hi, lo = split64(w)
            outs[2 * wi].copy_(hi)
            outs[2 * wi + 1].copy_(lo)
    elif step == "bound":
        sw = [join64(ins[2 * i], ins[2 * i + 1])
              for i in range(len(lay.words))]
        posmask = (1 << lay.pos_bits) - 1
        valid = sw[0] < (1 << _TRASH_SHIFT)   # trash bit clear
        diff = torch.zeros(max(n - 1, 0), dtype=BOOL, device=d)
        for i, w in enumerate(sw):
            if i == lay.pos_word:
                w = w & ~posmask
            diff |= w[1:] != w[:-1]
        flags = valid & torch.cat([torch.ones(1, dtype=BOOL, device=d),
                                   diff])
        pos = sw[lay.pos_word] & posmask
        outs[0].copy_(flags)
        outs[1].copy_(flags.to(I32) + (~valid).to(I32))
        outs[2].copy_(pos)
        outs[3].copy_(torch.where(flags, pos, 0x7FFFFFFF))
    elif step == "decode":
        for ci, wi in enumerate(lay.carry):
            w = join64(ins[2 * ci], ins[2 * ci + 1])
            for di, sh, bits in lay.words[wi]:
                outs[di].copy_(((w >> sh) & ((1 << bits) - 1)) +
                               lay.mins[di])
    else:
        raise ValueError(f"wide_keys: no step {step!r}")


def wide_keys_cuda(step, lay, ins, outs):
    """The CUDA key-word kernels (csrc/wide_keys.cu) on CUDA tensors, one
    launch a call: bit for bit `wide_keys_plain`, the same steps,
    inputs and outputs. Key columns and the mask are read in place at
    their strides. Any failure to build, load or launch raises
    DeviceError."""
    n = int(outs[0].shape[0])
    dv = outs[0].device
    nd, nw = len(lay.mins), len(lay.words)
    words_in = [x.dtype for x in ins] == [I32] * len(ins)
    ok = {"pack": nd <= len(ins) <= nd + 1 and len(outs) == 2 * nw and
          all(x.element_size() == 1 for x in ins[nd:]) and
          all(x.dtype == I32 for x in outs),
          "bound": words_in and len(ins) == 2 * nw and
          [x.dtype for x in outs] == [BOOL, I32, I64, I32],
          "decode": words_in and len(ins) == 2 * len(lay.carry) and
          len(outs) == nd and all(x.dtype != BOOL for x in outs)}
    bad = [x for x in ins + outs if x.device != dv or x.dim() > 1 or
           x.numel() not in (1, n) or x.dtype not in _WK_KINDS]
    if not ok.get(step, True) or bad or any(
            x.numel() != n or not x.is_contiguous() for x in outs):
        raise ValueError(f"wide_keys {step}: {n} rows on {dv}, ins " +
                         ", ".join(f"{x.dtype} {tuple(x.shape)} on {x.device}"
                                   for x in ins) + "; outs " +
                         ", ".join(f"{x.dtype} {tuple(x.shape)}"
                                   for x in outs))
    lib = _wide_keys_lib()

    def ptrs(xs):
        return (ctypes.c_void_p * max(len(xs), 1))(
            *[x.data_ptr() for x in xs])

    def ints(xs, t=ctypes.c_int):
        return (t * max(len(xs), 1))(*xs)

    dims = [d for wd in lay.words for d in wd]
    word_of = [wi for wi, wd in enumerate(lay.words) for _d in wd]
    try:
        with G._card_stream(dv) as stream:
            if step == "pack":
                keys, mask = ins[:nd], ins[nd:]
                rc = lib.rf_wide_keys_pack(
                    n, nd, ptrs(keys), ints([_stride(k) for k in keys],
                                            ctypes.c_int64),
                    ints([_WK_KINDS[k.dtype] for k in keys]),
                    ints(list(lay.mins), ctypes.c_int64), ints(word_of),
                    ints([sh for _di, sh, _b in dims]), nw, lay.pos_word,
                    mask[0].data_ptr() if mask else None,
                    _stride(mask[0]) if mask else 0, ptrs(outs[0::2]),
                    ptrs(outs[1::2]), stream)
            elif step == "bound":
                rc = lib.rf_wide_keys_bound(
                    n, nw, lay.pos_word, lay.pos_bits,
                    ptrs(ins[0::2]), ptrs(ins[1::2]), *[
                        x.data_ptr() for x in outs], stream)
            elif step == "decode":
                rc = lib.rf_wide_keys_decode(
                    n, len(lay.carry), ptrs(ins[0::2]), ptrs(ins[1::2]),
                    len(dims), ints(word_of),
                    ints([sh for _di, sh, _b in dims]),
                    ints([b for _di, _sh, b in dims]),
                    ints(list(lay.mins), ctypes.c_int64),
                    ints([_WK_KINDS[x.dtype] for x in outs]), ptrs(outs),
                    stream)
            else:
                raise ValueError(f"wide_keys: no step {step!r}")
    except (DeviceError, ValueError):
        raise
    except Exception as e:
        raise DeviceError(f"wide_keys {step}: {type(e).__name__}: {e}") \
            from e
    if rc != 0:
        raise DeviceError(f"wide_keys {step} launch failed: cudaError {rc}")
    with _LAUNCHES_LOCK:
        LAUNCHES["wide_keys"] += 1


def _wide_keys(step, lay, ins, outs):
    """One step of the key words (`wide_keys_plain`'s contract): on a
    CUDA tensor the hand-written kernel, on a CPU tensor the plain
    version; nothing in between."""
    d = outs[0].device
    if d.type == "cuda":
        return wide_keys_cuda(step, lay, ins, outs)
    if d.type == "cpu":
        return wide_keys_plain(step, lay, ins, outs)
    raise DeviceError(f"wide_keys: no key-word kernels for device {d}")


def pack_keys(lay, keys, mask, n):
    """The 2 len(lay.words) i32 sort words of n rows (high, low of each
    word) from the key columns and the where mask (or None)."""
    buf = torch.empty((2 * len(lay.words), n), dtype=I32,
                      device=keys[0].device)
    outs = list(buf.unbind(0))
    _wide_keys("pack", lay, list(keys) + ([mask] if mask is not None
                                          else []), outs)
    return outs


def key_bounds(lay, words):
    """(flags, inc, pos, fkey) of the sorted words (`wide_keys_plain`)."""
    n, d = int(words[0].shape[0]), words[0].device
    outs = [torch.empty(n, dtype=t, device=d) for t in (BOOL, I32, I64, I32)]
    _wide_keys("bound", lay, list(words), outs)
    return outs


def decode_keys(lay, words):
    """Each key dim's column from the carried words (high, low of each
    word of lay.carry)."""
    n, d = int(words[0].shape[0]), words[0].device
    outs = [torch.empty(n, dtype=t, device=d) for t in lay.out]
    _wide_keys("decode", lay, list(words), outs)
    return outs


def key_layout(key_meta, n_rows):
    """The key words of n_rows rows grouped by key_meta's dims (name, lo,
    rng, rtype, enum domain): a KeyLayout, or None where a dim is wider
    than 60 bits or the plan has more dims than the kernels take."""
    if len(key_meta) > WIDE_KEYS_MAX_DIMS:
        return None
    pos_bits = max((n_rows - 1).bit_length(), 1)

    # --- pack key dims into i64 words (word 0 keeps bit 61 for trash) --
    dims = []   # (bits, lo) per key dim
    for _nm, lo, rng, _rt, _dom in key_meta:
        bits = max(int(rng - 1).bit_length(), 1)
        if bits > 60:
            return None
        dims.append((bits, lo))
    words: list[list] = [[]]   # word -> [(dim_idx, shift, bits)]
    used = [0]
    cap0 = _TRASH_SHIFT
    for di, (bits, _lo) in enumerate(dims):
        cap = cap0 if len(words) == 1 else 62
        if used[-1] + bits > cap:
            words.append([])
            used.append(0)
        words[-1].append((di, 0, bits))
        used[-1] += bits
    # ...assign shifts (big-endian within each word: earlier dims in
    # higher bits so lexicographic word order == dim order)
    for wi, wdims in enumerate(words):
        off = used[wi]
        fixed = []
        for di, _sh, bits in wdims:
            off -= bits
            fixed.append((di, off, bits))
        words[wi] = fixed
    # row position into the last word's low bits (or its own word)
    last_cap = cap0 if len(words) == 1 else 62
    if used[-1] + pos_bits <= last_cap:
        for i, (di, sh, bits) in enumerate(words[-1]):
            words[-1][i] = (di, sh + pos_bits, bits)
    else:
        words.append([])
    return KeyLayout(
        words=tuple(tuple(w) for w in words),
        mins=tuple(int(lo) for _bits, lo in dims),
        pos_word=len(words) - 1, pos_bits=pos_bits,
        carry=tuple(wi for wi, w in enumerate(words) if w),
        out=tuple(I64 if rt == T.SYMBOL or dom is not None else _tdt(rt)
                  for _nm, _lo, _rng, rt, dom in key_meta))


def build_plan(src, n_rows, cw, key_cs, key_meta, aggs):
    if n_rows >= (1 << 30) or n_rows == 0:
        return None
    if any(a.name in ("med", "dev") for a in aggs):
        return None   # host path covers these at extreme cardinality
    lay = key_layout(key_meta, n_rows)
    if lay is None:
        return None

    # --- column slots ----------------------------------------------------
    col_objs: list = []
    slot_of: dict = {}

    def assign(ck):
        mapping = []
        for ref in ck.cols:
            key = id(ref.col)
            if key not in slot_of:
                slot_of[key] = len(col_objs)
                col_objs.append(ref.col)
            mapping.append(slot_of[key])
        return mapping

    w_map = assign(cw) if cw is not None else None
    key_maps = [assign(ck) for ck in key_cs]
    agg_maps = {}
    for a in aggs:
        cid = id(a.inner)
        if cid not in agg_maps:
            agg_maps[cid] = assign(a.inner)

    # --- aggregate needs --------------------------------------------------
    def may_null(a):
        if not a.meta.get("plain_col"):
            return True
        try:
            return dev.column_has_null(a.inner.cols[0].col)
        except Exception as e:
            if dev.is_fault(e):
                raise
            return True

    cinfo: dict = {}
    for a in aggs:
        cid = id(a.inner)
        ci = cinfo.setdefault(cid, {
            "rtype": a.inner.rtype, "ops": set(), "agg": a.inner,
            "plain": a.meta.get("plain_col", False)})
        if a.name in ("count", "first", "last"):
            continue
        if a.name in ("sum", "avg"):
            ci["ops"].add("sum")
        elif a.name in ("min", "max"):
            ci["ops"].add(a.name)
        else:
            return None
        if may_null(a):
            ci["ops"].add("null")

    operands: list = []
    op_ix: dict = {}
    for cid in sorted(cinfo):
        ci = cinfo[cid]
        if not ci["ops"]:
            continue
        rt = ci["rtype"]
        if rt == T.F64:
            kind = "f64"
            if ci["plain"]:
                # decimal fixed-point column (qscale stat): exact i32
                # sort operand, dequantized right after (sortagg has
                # the same fast path; see engine/device.py)
                qs = dev.column_qscale(ci["agg"].cols[0].col)
                if qs:
                    kind = ("q32", float(qs))
        elif rt in NARROW32:
            kind = "i32"
        else:
            kind = "i64"
            if ci["plain"] and "null" not in ci["ops"]:
                lo, hi = dev.column_range(ci["agg"].cols[0].col)
                if -(1 << 31) < lo and hi < (1 << 31):
                    kind = "i32"
        op_ix[cid] = len(operands)
        operands.append((cid, kind))

    out_meta: dict = {}
    N = n_rows

    def pipeline(*cols):
        d = cols[0].device if cols else dev.device()

        def sub_env(mapping):
            return [cols[i] for i in mapping]

        mask = None
        if cw is not None:
            mask = as_tensor(cw.fn(sub_env(w_map))).to(BOOL)
        keys = [as_tensor(ck.fn(sub_env(mp)))
                for ck, mp in zip(key_cs, key_maps)]
        kw = pack_keys(lay, keys, mask, N)

        arrs = {}
        for cid, ci in cinfo.items():
            if ci["ops"]:
                arrs[cid] = as_tensor(ci["agg"].fn(sub_env(agg_maps[cid])))
        ops_in = []
        for cid, kind in operands:
            a = arrs[cid]
            if kind == "f64":
                ops_in.append(a.to(F64))
            elif isinstance(kind, tuple):     # ("q32", scale)
                rq = torch.round(a * kind[1])
                ops_in.append(torch.where(
                    torch.isnan(a), int(T.NULL_I32), rq.to(I32)))
            elif kind == "i32":
                ops_in.append(a.to(I32))
            else:
                ops_in.append(a.to(I64))

        # every key is unique (the row position rides the last word),
        # so the order is fully determined
        sw, sops = sort_lex(kw, ops_in)

        flags, inc, pos_row, fkey = key_bounds(lay, sw)
        ng = flags.sum()

        # REVERSED inclusive segmented scans put every segment's TOTAL
        # on its FIRST row — so all per-group quantities live on the
        # (already known) boundary rows with no boundary compaction
        segid = torch.cumsum(inc, 0, dtype=I32)

        def rsum(x):
            return G.seg_doubling_sum(segid, x, reverse=True)

        def rmin(x):
            return G.seg_doubling_min(segid, x, reverse=True)

        def rmax(x):
            return G.seg_doubling_max(segid, x, reverse=True)

        counts = rsum(torch.ones(N, dtype=I64, device=d))
        fidx = pos_row          # at a segment start: min pos = fidx
        lidx = rmax(pos_row)    # at a segment start: max pos = lidx

        segres = {}
        nullcnt = {}
        for cid, ci in cinfo.items():
            ops = ci["ops"]
            if not ops:
                continue
            rt = ci["rtype"]
            v = sops[op_ix[cid]]
            kind = operands[op_ix[cid]][1]
            if isinstance(kind, tuple):
                # quantized i32 operand -> f64 values with NaN nulls
                v = torch.where(v == int(T.NULL_I32), np.nan,
                                v.to(F64) / kind[1])
            if rt == T.F64:
                nul = torch.isnan(v)
            else:
                # widen first: an i64 column riding as i32 must not
                # meet its null sentinel wrapped to i32 (0)
                v = v.to(I64)
                nv = _dt_null(rt)
                nul = (v == int(nv)) if nv is not None else None
            if "null" in ops and nul is not None:
                nullcnt[cid] = rsum(nul.to(I64))
            if "sum" in ops:
                if rt == T.F64:
                    z = torch.where(nul, 0.0, v)
                else:
                    z = torch.where(nul, 0, v) if nul is not None else v
                segres[("sum", cid)] = rsum(z)
            if "min" in ops:
                if rt == T.F64:
                    mv = torch.where(nul, np.inf, v)
                else:
                    mv = torch.where(nul, G.KEY_MAX, v) \
                        if nul is not None else v
                segres[("min", cid)] = rmin(mv)
            if "max" in ops:
                if rt == T.F64:
                    mv = torch.where(nul, -np.inf, v)
                else:
                    mv = torch.where(nul, G.I64_MIN, v) \
                        if nul is not None else v
                segres[("max", cid)] = rmax(mv)

        # ---- un-ordered per-group lanes (live on segment-start rows) ----
        lanes = {}
        for a in aggs:
            cid = id(a.inner)
            rt = a.inner.rtype if a.name != "count" else T.I64
            lane = f"{a.name}:{a.sid}"
            if lane in lanes:
                continue
            if a.name == "count":
                lanes[lane] = counts
            elif a.name == "first":
                srcv = cols[agg_maps[cid][0]]
                lanes[lane] = srcv[torch.clamp(fidx, 0, N - 1)]
            elif a.name == "last":
                srcv = cols[agg_maps[cid][0]]
                lanes[lane] = srcv[torch.clamp(lidx, 0, N - 1)]
            elif a.name in ("min", "max"):
                # all-null: plain min keeps typed INF; derived-expr
                # min and any max yield typed NULL (host-pinned)
                v = segres[(a.name, cid)]
                if cid in nullcnt:
                    empty = nullcnt[cid] >= counts
                    plain = a.meta.get("plain_col")
                    if rt == T.F64:
                        if a.name == "max" or not plain:
                            v = torch.where(empty, np.nan, v)
                    elif a.name == "max" or not plain:
                        nv = _dt_null(rt)
                        v = torch.where(empty, int(
                            nv if nv is not None else T.NULL_I64), v)
                    else:
                        v = torch.where(empty, int(np.iinfo(
                            T.DTYPE[rt]).max), v)
                if rt != T.F64:
                    v = v.to(_tdt(rt))
                lanes[lane] = v
            elif a.name == "avg":
                e = counts - nullcnt[cid] if cid in nullcnt else counts
                e = e.to(F64)
                s = segres[("sum", cid)].to(F64)
                lanes[lane] = torch.where(e == 0, np.nan, s / e)
            elif rt == T.F64:
                s = segres[("sum", cid)]
                if cid in nullcnt and a.meta.get("plain_col"):
                    s = torch.where(nullcnt[cid] > 0, np.nan, s)
                lanes[lane] = s
            else:
                s = segres[("sum", cid)]
                ot = SUM_OUT.get(rt, T.I64)
                if cid in nullcnt and a.meta.get("plain_col"):
                    nv = _dt_null(ot)
                    s = torch.where(nullcnt[cid] > 0, int(
                        nv if nv is not None else T.NULL_I64), s)
                lanes[lane] = s.to(_tdt(ot))

        # ---- first-appearance ordering: carry lanes through ONE sort ----
        # fkey: the first row on a boundary row, else INT32_MAX; only the
        # first ng rows are read, so the order of the tied non-boundary
        # tail does not matter; counts ride as i32 (n_rows < 2^30). The
        # key words ride as they are: decoding never reads their
        # position bits
        carry_names = list(lanes.keys())
        carried = [lanes[nm].to(I32) if nm.startswith("count:")
                   else lanes[nm] for nm in carry_names]
        cwords = [w for wi in lay.carry for w in sw[2 * wi:2 * wi + 2]]
        (_,), sorted2 = sort_lex([fkey], cwords + carried)
        lane_o = {nm: ln.to(I64) if nm.startswith("count:") else ln
                  for nm, ln in zip(carry_names, sorted2[len(cwords):])}

        out = decode_keys(lay, sorted2[:len(cwords)])
        names = [f"key{di}" for di in range(len(out))]
        for nm in carry_names:
            names.append(nm)
            out.append(lane_o[nm])

        out_meta["names"] = names
        return (ng.reshape(1),) + tuple(out)

    plan = _WPlan()
    plan.fn = pipeline
    plan.col_objs = col_objs
    plan.key_meta = key_meta
    plan.aggs = aggs
    plan.n_rows = n_rows
    plan.out_meta = out_meta
    return plan


def run(plan: _WPlan):
    """Execute; returns the result table (device-resident columns) or
    "empty". The host fetches one scalar, the group count."""
    cols = [dev.dev_col(c) for c in plan.col_objs]
    outs = plan.fn(*cols)
    ng = int(prof.host("wide.groups", outs[0].cpu)[0])
    if ng <= 0:
        return "empty"
    lanes = dict(zip(plan.out_meta["names"], outs[1:]))

    out_names: list[int] = []
    out_cols: list[Obj] = []
    for i, (nm, lo, rng, rt, dom) in enumerate(plan.key_meta):
        out_names.append(nm)
        lane = lanes[f"key{i}"]
        if dom is not None:
            out_cols.append(Obj(T.ENUM, DevPendingSliced(lane, ng),
                                domain=dom))
        elif rt == T.SYMBOL:
            out_cols.append(Obj(T.SYMBOL, DevPendingSliced(lane, ng)))
        else:
            out_cols.append(Obj(rt, DevPendingSliced(lane, ng)))
    for a in plan.aggs:
        out_names.append(a.sid)
        rt = a.inner.rtype if a.name != "count" else T.I64
        lane = lanes[f"{a.name}:{a.sid}"]
        if a.name == "count":
            col = Obj(T.I64, DevPendingSliced(lane, ng))
        elif a.name in ("first", "last"):
            src = a.inner.cols[0].col
            if src.t == T.ENUM:
                col = Obj(T.ENUM, DevPendingSliced(lane, ng),
                          domain=src.domain)
            else:
                col = Obj(src.t, DevPendingSliced(lane, ng))
        elif a.name in ("min", "max"):
            col = Obj(rt, DevPendingSliced(lane, ng))
        elif a.name == "avg" or rt == T.F64:
            col = Obj(T.F64, DevPendingSliced(lane, ng))
        else:
            col = Obj(SUM_OUT.get(rt, T.I64),
                      DevPendingSliced(lane, ng))
        out_cols.append(col)
    return table(Obj(T.SYMBOL, np.asarray(out_names, dtype=np.int64)),
                 out_cols)
