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

Null semantics mirror the host kernels (oracle-pinned, see
engine/select.py): grouped sum propagates nulls, avg/min/max/med skip
them, all-null groups yield typed INF for min / typed NULL for max,
count counts all rows. Groups here are always non-empty (compaction
keeps occupied codes only), so empty-group fills never apply.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..core import types as T
from ..core.obj import Obj, table, DevPendingSliced
from . import device as dev
from . import groupby as G
from .exprc import as_tensor, torch_dtype
from .psort import argsort, sort_by_code, sort_i32, sort_mixed

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

SUM_OUT = {T.U8: T.I64, T.I16: T.I64, T.I32: T.I32, T.I64: T.I64}
INT_LIKE = (T.B8, T.U8, T.I16, T.I32, T.I64, T.DATE, T.TIME,
            T.TIMESTAMP, T.SYMBOL)
NARROW32 = (T.B8, T.U8, T.I16, T.I32, T.DATE, T.TIME)

I32, I64, F64, BOOL = torch.int32, torch.int64, torch.float64, torch.bool


class _SAPlan:
    __slots__ = ("fn", "col_objs", "key_meta", "aggs", "n_codes",
                 "n_rows", "exact", "fallback", "out_meta", "_rebuild")


def _dt_null(rt):
    return T.NULL_BY_TYPE.get(rt)


def _tdt(rt):
    return torch_dtype(T.DTYPE[rt])


def _starts(sc):
    """Run starts of a sorted code vector: True where sc changes."""
    return torch.cat([torch.ones(1, dtype=BOOL, device=sc.device),
                      sc[1:] != sc[:-1]])


def build_plan(src, n_rows, cw, key_cs, key_meta, n_codes, aggs,
               force_exact=False):
    """Build a sort-agg plan (or None when unsupported)."""
    if n_rows >= (1 << 30) or n_rows == 0:
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

    # --- per-cid aggregate needs ----------------------------------------
    def may_null(a):
        if not a.meta.get("plain_col"):
            return True
        try:
            return dev.column_has_null(a.inner.cols[0].col)
        except Exception as e:
            if dev.is_fault(e):
                raise
            return True

    cinfo: dict = {}   # cid -> dict(rtype, ops=set, agg, plain)
    need_lidx = False
    for a in aggs:
        cid = id(a.inner)
        ci = cinfo.setdefault(cid, {
            "rtype": a.inner.rtype, "ops": set(),
            "agg": a.inner, "plain": a.meta.get("plain_col", False)})
        if a.name == "count":
            continue
        if a.name == "first":
            continue
        if a.name == "last":
            need_lidx = True
            continue
        nullable = may_null(a)
        if a.name in ("sum", "avg"):
            ci["ops"].add("sum")
        elif a.name in ("min", "max"):
            ci["ops"].add(a.name)
        elif a.name == "med":
            ci["ops"].add("med")
        elif a.name == "dev":
            ci["ops"].add("dev")
        else:
            return None
        if nullable:
            ci["ops"].add("null")

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
                ci["rtype"] not in INT_LIKE:
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

    # --- operand layout (static) ----------------------------------------
    operands: list = []   # (cid, kind) kind in i32/i64/f64/(q32, scale)
    op_ix: dict = {}
    for cid in sorted(cinfo):
        ci = cinfo[cid]
        if cid in packed:
            continue
        needs_operand = bool(ci["ops"] - {"med"})
        if not needs_operand:
            continue
        rt = ci["rtype"]
        if rt == T.F64:
            kind = "f64"
            if ci["plain"]:
                # decimal fixed-point columns (cached qscale stat)
                # ride the sort as EXACT i32 operands — half the
                # sorted bytes of an f64 operand; decoded back to f64
                # (nulls -> NaN) right after the sort
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

    med_cids = sorted(cid for cid, ci in cinfo.items()
                      if "med" in ci["ops"])
    med_qs = {}
    for cid in med_cids:
        if cinfo[cid]["rtype"] == T.F64 and cinfo[cid]["plain"]:
            med_qs[cid] = dev.column_qscale(cinfo[cid]["agg"].cols[0].col)

    key_dt = I64 if (exact or code_bits + vb > 31) else I32
    posmask = (1 << pos_bits) - 1
    out_meta: dict = {"exact": exact}

    def pipeline(*cols):
        d = cols[0].device if cols else dev.device()

        def sub_env(mapping):
            return [cols[i] for i in mapping]

        def iota(n, dtype=I32):
            return torch.arange(n, dtype=dtype, device=d)

        mask = None
        if cw is not None:
            mask = as_tensor(cw.fn(sub_env(w_map))).to(BOOL)
        codes = None
        for ck, mp, (_nm, lo, rng, _rt, _dom) in zip(
                key_cs, key_maps, key_meta):
            arr = as_tensor(ck.fn(sub_env(mp)))
            cc = (arr.to(I64) - lo).to(I32)
            codes = cc if codes is None else codes * rng + cc
        if codes is None:
            codes = torch.zeros(n_rows, dtype=I32, device=d)
        codes = codes.expand(n_rows)
        if mask is not None:
            codes = torch.where(mask, codes, NC)

        arrs = {}
        for cid, ci in cinfo.items():
            arrs[cid] = as_tensor(ci["agg"].fn(sub_env(agg_maps[cid])))

        # ---- main sort ---------------------------------------------------
        key = codes.to(key_dt)
        if exact:
            key = (key << pos_bits) | iota(n_rows, key_dt)
        if vb:
            key = key << vb
            for cid, (sh, bits, lo) in packed.items():
                key = key | ((arrs[cid].to(key_dt) - lo) << sh)
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
        skey, sops = sort_mixed(key, ops_in)

        shift_all = vb + (pos_bits if exact else 0)
        sc = (skey >> shift_all).to(I32)
        valid = sc < NC
        flags = valid & _starts(sc)
        ng = flags.sum(dtype=I32)
        nvalid = valid.sum(dtype=I32)

        # ---- boundary compaction ------------------------------------
        if NCAP <= SEARCH_NCAP:
            # few groups: j-th boundary = first position where the
            # flag prefix-count reaches j+1
            cum = torch.cumsum(flags, 0, dtype=I32)
            bpos = torch.searchsorted(
                cum, torch.arange(1, NCAP + 1, dtype=I32, device=d),
                side="left", out_int32=True)
        else:
            ix = iota(n_rows)
            ck_ = torch.where(flags, ix, ix + _BIG)
            bpos = sort_i32([ck_])[0][:NCAP] & (_BIG - 1)
        bposc = torch.clamp(bpos, 0, n_rows - 1).long()
        jar = iota(NCAP)
        occ = jar < ng
        nxt = torch.cat([bpos[1:], bpos.new_zeros(1)])
        bnext = torch.where(jar + 1 < ng, nxt, nvalid)
        counts = (bnext - bpos).to(I64)
        ea = torch.clamp(bnext - 1, 0, n_rows - 1).long()
        bcode = sc[bposc]

        # ---- per-cid sorted values + segment scans -----------------------
        segres = {}
        nullcnt = {}

        # FUSE the key-packed (null-free) integer sums into ONE
        # segmented scan: each column's biased values occupy a
        # disjoint bit field sized for its worst-case group sum, so
        # one i64 seg-sum yields every column's totals (extract +
        # un-bias).
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
        if len(fuse_fields) >= 2:
            fused = None
            for cid, fo, _lo in fuse_fields:
                sh, bits, _l = packed[cid]
                part = ((skey >> sh) & ((1 << bits) - 1)).to(I64) << fo
                fused = part if fused is None else fused | part
            ftot = G.seg_doubling_sum(sc, fused)[ea]
            for i, (cid, fo, lo) in enumerate(fuse_fields):
                hi_off = fuse_fields[i + 1][1] if i + 1 < \
                    len(fuse_fields) else 63
                field = (ftot >> fo) & ((1 << (hi_off - fo)) - 1)
                # un-bias: actual sum = field + lo * group count
                segres[("sum", cid)] = field + lo * counts

        for cid, ci in cinfo.items():
            ops = ci["ops"]
            rt = ci["rtype"]
            raw = None
            free_mm = False
            p32 = False
            if cid in packed:
                sh, bits, lo = packed[cid]
                span = (1 << bits) - 1
                raw = (skey >> sh) & span      # biased >= 0
                v = raw.to(I64) + lo
                nul = None
                free_mm = cid == top_cid
                p32 = span * n_rows < (1 << 31)
            elif cid in op_ix:
                v = sops[op_ix[cid]]
                kind = operands[op_ix[cid]][1]
                if isinstance(kind, tuple):
                    # quantized i32 operand -> back to f64 values with
                    # NaN nulls; all F64 semantics below apply as-is
                    v = torch.where(v == int(T.NULL_I32), np.nan,
                                    v.to(F64) / kind[1])
                if rt == T.F64:
                    nul = torch.isnan(v)
                else:
                    # widen first: an i64 column riding as i32 must
                    # not meet its null sentinel wrapped to i32 (0)
                    v = v.to(I64)
                    nv = _dt_null(rt)
                    nul = (v == int(nv)) if nv is not None else None
            else:
                continue
            if "null" in ops and nul is not None:
                nullcnt[cid] = G.seg_doubling_sum(sc, nul.to(I64))[ea]
            if "sum" in ops and ("sum", cid) not in segres:
                if raw is not None and p32:
                    # packed null-free field: biased i32 scan (group
                    # sums provably < 2^31), un-bias at the boundary
                    bs = G.seg_doubling_sum(sc, raw.to(I32))[ea]
                    segres[("sum", cid)] = bs.to(I64) + lo * counts
                elif rt == T.F64:
                    z = torch.where(torch.isnan(v), 0.0, v)
                    segres[("sum", cid)] = G.seg_doubling_sum(sc, z)[ea]
                else:
                    z = torch.where(nul, 0, v) if nul is not None else v
                    segres[("sum", cid)] = G.seg_doubling_sum(sc, z)[ea]
            if "dev" in ops:
                # std via segment-min-shifted moments: var =
                # E[(x-c)^2] - E[x-c]^2 with c = per-segment min
                # (broadcast per row as min(fwd-scan, bwd-scan)) —
                # cancellation-safe like the host's two-pass np.std
                if rt == T.F64:
                    xv = v
                    nn = torch.isnan(v)
                else:
                    xv = v.to(F64)
                    nn = nul if nul is not None else \
                        torch.zeros(v.shape, dtype=BOOL, device=d)
                xm = torch.where(nn, np.inf, xv)
                fmin = G.seg_doubling_min(sc, xm)
                bmin = G.seg_doubling_min(sc.flip(0), xm.flip(0)).flip(0)
                c = torch.minimum(fmin, bmin)
                dd = torch.where(nn | ~torch.isfinite(c), 0.0, xv - c)
                segres[("devs", cid)] = G.seg_doubling_sum(sc, dd)[ea]
                segres[("dev2", cid)] = G.seg_doubling_sum(sc, dd * dd)[ea]
            if "min" in ops:
                if free_mm:
                    # top packed field: the group's first sorted row
                    # carries its exact min (code equal within the
                    # segment, this field is the highest value bits)
                    segres[("min", cid)] = (
                        (skey[bposc] >> sh) & span).to(I64) + lo
                elif raw is not None and span < (1 << 31):
                    segres[("min", cid)] = G.seg_doubling_min(
                        sc, raw.to(I32))[ea].to(I64) + lo
                else:
                    if rt == T.F64:
                        mv = torch.where(torch.isnan(v), np.inf, v)
                    else:
                        mv = torch.where(nul, G.KEY_MAX, v) \
                            if nul is not None else v
                    segres[("min", cid)] = G.seg_doubling_min(sc, mv)[ea]
            if "max" in ops:
                if free_mm:
                    segres[("max", cid)] = (
                        (skey[ea] >> sh) & span).to(I64) + lo
                elif raw is not None and span < (1 << 31):
                    segres[("max", cid)] = G.seg_doubling_max(
                        sc, raw.to(I32))[ea].to(I64) + lo
                else:
                    if rt == T.F64:
                        mv = torch.where(torch.isnan(v), -np.inf, v)
                    else:
                        mv = torch.where(nul, G.I64_MIN, v) \
                            if nul is not None else v
                    segres[("max", cid)] = G.seg_doubling_max(sc, mv)[ea]

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
                nv = _dt_null(rt)
                a64 = a.to(I64)
                mkey = torch.where(a64 == int(nv), G.KEY_MAX, a64) \
                    if nv is not None else a64
            medvals[cid] = (sort_by_code(codes, mkey), qs)

        # ---- first/last row ids ------------------------------------------
        straggler = torch.zeros((), dtype=I32, device=d)
        lidx = None
        if exact:
            fidx = ((skey[bposc] >> vb) & posmask).to(I64)
            lidx = ((skey[ea] >> vb) & posmask).to(I64)
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
        bcode_o = order(bcode).to(I64)
        muls = []
        m_ = 1
        for _nm, _lo, rng, _rt, _dom in reversed(key_meta):
            muls.append(m_)
            m_ *= rng
        muls.reverse()
        for i, ((nm, lo, rng, rt, dom), mul) in enumerate(
                zip(key_meta, muls)):
            vals = torch.remainder(
                torch.div(bcode_o, mul, rounding_mode="floor"), rng) + lo
            if rt == T.SYMBOL or dom is not None:
                emit(f"key{i}", vals.to(I64))
            else:
                emit(f"key{i}", vals.to(_tdt(rt)))

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
            lane = f"{a.name}:{a.sid}"
            if lane in names:
                continue
            if a.name == "count":
                emit(lane, counts_o)
            elif a.name == "first":
                srcv = cols[agg_maps[cid][0]]
                emit(lane, srcv[torch.clamp(fidx_o, 0, n_rows - 1)])
            elif a.name == "last":
                srcv = cols[agg_maps[cid][0]]
                emit(lane, srcv[torch.clamp(lidx_o, 0, n_rows - 1)])
            elif a.name in ("min", "max"):
                # all-null groups: PLAIN-column grouped min keeps the
                # typed INF init (aggr.c:1241); min/max of a DERIVED
                # expression runs per-group whole-vector semantics ->
                # typed NULL (math.c fold; host-pinned); grouped max
                # yields NULL either way
                v = order(segres[(a.name, cid)])
                if cid in nullcnt:
                    empty = order(nullcnt[cid]) >= counts_o
                    plain = a.meta.get("plain_col")
                    if rt == T.F64:
                        if a.name == "max" or not plain:
                            v = torch.where(empty, np.nan, v)
                        # plain min: all-null stays +inf (typed INF)
                    elif a.name == "max" or not plain:
                        nv = _dt_null(rt)
                        v = torch.where(empty, int(
                            nv if nv is not None else T.NULL_I64), v)
                    else:
                        v = torch.where(empty, int(np.iinfo(
                            T.DTYPE[rt]).max), v)
                if rt != T.F64:
                    v = v.to(_tdt(rt))
                emit(lane, v)
            elif a.name == "med":
                e = eff(cid)
                bpos_o = order(bpos).to(I64)
                lo_i = torch.clamp(
                    bpos_o + torch.clamp(e - 1, min=0) // 2,
                    0, n_rows - 1)
                hi_i = torch.clamp(bpos_o + e // 2, 0, n_rows - 1)
                sv, qs = medvals[cid]
                mv = (sv[lo_i].to(F64) + sv[hi_i].to(F64)) / 2.0
                if qs:
                    mv = mv / qs
                emit(lane, torch.where(e == 0, np.nan, mv))
            elif a.name == "dev":
                e = eff(cid).to(F64)
                s = order(segres[("devs", cid)])
                s2 = order(segres[("dev2", cid)])
                safe = torch.where(e == 0, 1.0, e)
                mean = s / safe
                var = s2 / safe - mean * mean
                v = torch.sqrt(torch.clamp(var, min=0.0))
                emit(lane, torch.where(e == 0, np.nan, v))
            elif a.name == "avg":
                e = eff(cid).to(F64)
                s = order(segres[("sum", cid)]).to(F64)
                emit(lane, torch.where(e == 0, np.nan, s / e))
            elif rt == T.F64:
                # sum of a PLAIN column propagates nulls (the fused
                # FN_AGGR path, aggr.c ADD accumulators); sum of a
                # derived expr materializes per-group vectors whose
                # whole-vector sum SKIPS nulls (oracle-pinned)
                s = order(segres[("sum", cid)])
                if cid in nullcnt and a.meta.get("plain_col"):
                    s = torch.where(order(nullcnt[cid]) > 0, np.nan, s)
                emit(lane, s)
            else:               # integer sum
                s = order(segres[("sum", cid)])
                ot = SUM_OUT.get(rt, T.I64)
                if cid in nullcnt and a.meta.get("plain_col"):
                    nv = _dt_null(ot)
                    s = torch.where(order(nullcnt[cid]) > 0, int(
                        nv if nv is not None else T.NULL_I64), s)
                emit(lane, s.to(_tdt(ot)))

        out_meta["names"] = names
        scalars = torch.stack([ng.to(I64), straggler.to(I64)])
        return (scalars,) + tuple(lanes)

    plan = _SAPlan()
    plan.fn = pipeline
    plan.col_objs = col_objs
    plan.key_meta = key_meta
    plan.aggs = aggs
    plan.n_codes = NC
    plan.n_rows = n_rows
    plan.exact = exact
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
    from ..core import profiler as _prof
    cols = [dev.dev_col(c) for c in plan.col_objs]
    outs = plan.fn(*cols)
    _prof.tick("device: dispatch")
    scalars = outs[0].cpu()
    _prof.tick("device: execute+sync")
    ng, straggler = int(scalars[0]), int(scalars[1])
    if straggler and not plan.exact:
        plan.fallback = plan._rebuild()
        return run(plan.fallback)
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
        elif a.name in ("med", "dev", "avg") or rt == T.F64:
            col = Obj(T.F64, DevPendingSliced(lane, ng))
        else:
            col = Obj(SUM_OUT.get(rt, T.I64),
                      DevPendingSliced(lane, ng))
        out_cols.append(col)
    return table(Obj(T.SYMBOL, np.asarray(out_names, dtype=np.int64)),
                 out_cols)
