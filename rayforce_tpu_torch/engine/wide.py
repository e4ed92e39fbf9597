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

import torch

from ..core import profiler as prof
from . import aggs as A
from . import device as dev
from . import groupby as G
from .aggs import tdt
from .device import DeviceError
from .psort import LAUNCHES, _LAUNCHES_LOCK, join64, sort_lex, split64

_TRASH_SHIFT = 61

I32, I64, F64, BOOL = torch.int32, torch.int64, torch.float64, torch.bool


class _WPlan:
    __slots__ = ("fn", "col_objs", "key_meta", "aggs", "n_rows",
                 "out_meta")


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
        out=tuple(tdt(rt) for _nm, _lo, _rng, rt, _dom in key_meta))


def build_plan(src, n_rows, cw, key_cs, key_meta, aggs):
    if n_rows >= (1 << 30) or n_rows == 0:
        return None
    if any(a.name in ("med", "dev") for a in aggs):
        return None   # host path covers these at extreme cardinality
    lay = key_layout(key_meta, n_rows)
    if lay is None:
        return None

    slots = A.Slots(cw, key_cs, [a.inner for a in aggs])
    cinfo = A.col_needs(aggs)
    operands, op_ix = A.operands(cinfo)

    out_meta: dict = {}
    N = n_rows

    def pipeline(*cols):
        d = cols[0].device if cols else dev.device()
        mask = None
        if cw is not None:
            mask = slots.eval(cw, cols).to(BOOL)
        keys = [slots.eval(ck, cols) for ck in key_cs]
        kw = pack_keys(lay, keys, mask, N)

        arrs = {cid: slots.eval(ci["agg"], cols)
                for cid, ci in cinfo.items() if ci["ops"]}
        ops_in = [A.operand(arrs[cid], kind) for cid, kind in operands]

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
            if cid not in op_ix:
                continue
            ops = ci["ops"]
            v, nul = A.from_operand(sops[op_ix[cid]], operands[op_ix[cid]][1],
                                    ci["rtype"])
            if "null" in ops and nul is not None:
                nullcnt[cid] = rsum(nul.to(I64))
            if "sum" in ops:
                segres[("sum", cid)] = rsum(A.skip_nulls(v, nul, "sum"))
            if "min" in ops:
                segres[("min", cid)] = rmin(A.skip_nulls(v, nul, "min"))
            if "max" in ops:
                segres[("max", cid)] = rmax(A.skip_nulls(v, nul, "max"))

        # ---- un-ordered per-group lanes (live on segment-start rows) ----
        lanes = {}
        for a in aggs:
            cid = id(a.inner)
            rt = a.inner.rtype
            lane = A.lane_name(a)
            if lane in lanes:
                continue
            if a.name == "count":
                lanes[lane] = counts
            elif a.name in ("first", "last"):
                srcv = cols[slots.of[cid][0]]
                lanes[lane] = srcv[torch.clamp(
                    fidx if a.name == "first" else lidx, 0, N - 1)]
            elif a.name in ("min", "max"):
                v = A.minmax_nulls(segres[(a.name, cid)],
                                   (nullcnt[cid] >= counts)
                                   if cid in nullcnt else None, a, rt)
                lanes[lane] = v.to(tdt(rt))
            elif a.name == "avg":
                e = counts - nullcnt[cid] if cid in nullcnt else counts
                e = e.to(F64)
                lanes[lane] = A.avg(segres[("sum", cid)].to(F64), e)
            else:               # sum
                s = segres[("sum", cid)]
                if A.sum_propagates(a, cid in nullcnt):
                    s = A.sum_nulls(s, nullcnt[cid], rt)
                lanes[lane] = s.to(tdt(A.result_type(a)))

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
    plan.col_objs = slots.cols
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
    return A.lanes_table(plan.key_meta, plan.aggs,
                         dict(zip(plan.out_meta["names"], outs[1:])), ng)
