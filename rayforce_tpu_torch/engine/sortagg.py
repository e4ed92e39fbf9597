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

What the aggregates become (slots, operands, null rules, result
types) is engine/aggs.py's. Groups here are always non-empty
(compaction keeps occupied codes only), so empty-group fills never
apply.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..core import profiler as prof
from ..core import types as T
from . import aggs as A
from . import device as dev
from . import groupby as G
from .aggs import INT_LIKE, tdt
from .psort import (LAUNCHES, _LAUNCHES_LOCK, argsort, sort_by_code,
                    sort_i32, sort_mixed)

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
                 "n_rows", "exact", "fallback", "out_meta", "_rebuild")


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

    operands, op_ix = A.operands(cinfo, packed)

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

        def iota(n, dtype=I32):
            return torch.arange(n, dtype=dtype, device=d)

        mask = None
        if cw is not None:
            mask = slots.eval(cw, cols).to(BOOL)
        codes = A.key_codes(slots, cols, key_cs, key_meta, n_rows, d)
        if mask is not None:
            codes = torch.where(mask, codes, NC)

        arrs = {}
        for cid, ci in cinfo.items():
            arrs[cid] = slots.eval(ci["agg"], cols)

        # ---- main sort ---------------------------------------------------
        key = codes.to(key_dt)
        if exact:
            key = (key << pos_bits) | iota(n_rows, key_dt)
        if vb:
            key = key << vb
            for cid, (sh, bits, lo) in packed.items():
                key = key | ((arrs[cid].to(key_dt) - lo) << sh)
        skey, sops = sort_mixed(key, [A.operand(arrs[cid], kind)
                                      for cid, kind in operands])

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
                v, nul = A.from_operand(sops[op_ix[cid]],
                                        operands[op_ix[cid]][1], rt)
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
                else:
                    segres[("sum", cid)] = G.seg_doubling_sum(
                        sc, A.skip_nulls(v, nul, "sum"))[ea]
            if "dev" in ops:
                # std via segment-min-shifted moments: var =
                # E[(x-c)^2] - E[x-c]^2 with c = per-segment min
                # (broadcast per row as min(fwd-scan, bwd-scan)) —
                # cancellation-safe like the host's two-pass np.std
                if rt == T.F64:
                    xv = v
                    nn = nul
                else:
                    xv = v.to(F64)
                    nn = nul if nul is not None else \
                        torch.zeros(v.shape, dtype=BOOL, device=d)
                xm = torch.where(nn, np.inf, xv)
                fmin = G.seg_doubling_min(sc, xm)
                bmin = G.seg_doubling_min(sc, xm, reverse=True)
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
                    segres[("min", cid)] = G.seg_doubling_min(
                        sc, A.skip_nulls(v, nul, "min"))[ea]
            if "max" in ops:
                if free_mm:
                    segres[("max", cid)] = (
                        (skey[ea] >> sh) & span).to(I64) + lo
                elif raw is not None and span < (1 << 31):
                    segres[("max", cid)] = G.seg_doubling_max(
                        sc, raw.to(I32))[ea].to(I64) + lo
                else:
                    segres[("max", cid)] = G.seg_doubling_max(
                        sc, A.skip_nulls(v, nul, "max"))[ea]

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
