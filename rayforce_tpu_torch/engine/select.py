"""Device fast path for select: fused filter + group + aggregate.

`try_select_device` builds (and caches) a plan for a select and runs
it. The engine is picked by the size of the dense key code space:

- <= SMALL_N (512) codes, and selects with no `by`: the dense plan
  built here. Where-mask, dense group codes, every aggregate and the
  first-appearance ordering run on the device (engine/groupby.py
  `dense_scan`: one dense aggregate pass for the lanes of `bcast_scan`
  and `matmul_tasks_scan`), and aggregates are FINALIZED
  there (limb sums, avg division, null fixes, output order by a sort of
  first-row ids), so the fetched lanes are the output columns: the host pays one transfer of one packed buffer
  (groupby.Packer). Group keys are decoded arithmetically from the
  ordered dense slot ids on the host; first/last values are host
  gathers at the fetched row ids.
- up to dense_max codes, and grouped selects with a `dev` aggregate:
  engine/sortagg.py;
- more than dense_max codes: engine/wide.py.

With a device mesh (RAYFORCE_MESH, `device.mesh()`), a dense plan runs
on every shard's rows with its partial lanes combined across shards
(psum / pmin / pmax, `spmd`) unless it needs a median, and a grouped
select beyond 512 codes (or with `dev`) runs over the mesh through
engine/dgroup.py when its shape is covered.
Aggregate null semantics are oracle-pinned (tools/oracle.py against the
reference binary) and engine/aggs.py owns them, with the rest of what
the aggregates of every engine become (slots, sort operands, result
types): GROUPED sum PROPAGATES nulls (ADD accumulators) while a no-by
select sums whole-vector and SKIPS them; avg skips; min/max skip nulls
with all-null groups yielding the typed INF sentinel (min) or the typed
null (max); count counts all rows. Group order is first-appearance
(core/index.c group-id assignment). Plans are cached
by a structural fingerprint of the query AST and the identity of the
source table.
"""
from __future__ import annotations

import sys
import time

import numpy as np
import torch

from ..core import profiler as prof
from ..core import symbols
from ..core import types as T
from ..core.obj import Obj, to_np, enum_domain
from . import aggs as A
from . import device as dev
from . import groupby as G
from .aggs import INT_LIKE, NARROW32
from .exprc import as_tensor, compile_expr, split_aggregate
from .psort import argsort, sort_by_code

_plan_cache: dict = {}

# last device query's phase timings, readable via the (internals)
# builtin — the analogue of the reference's -t timeit span recorder
# (chrono.h:62-81, printed per REPL eval in app/repl.c:76)
last_profile: dict = {}

MINMAX_OK = (T.B8, T.U8, T.I16, T.I32, T.I64, T.DATE, T.TIME,
             T.TIMESTAMP, T.F64)
F64_EXACT = 1 << 53

I32, I64, F64 = torch.int32, torch.int64, torch.float64


def _fingerprint(ast: Obj) -> str:
    t = ast.t
    if t == T.LIST:
        return "(" + " ".join(_fingerprint(x) for x in ast.v) + ")"
    if t == T.DICT:
        k, v = ast.v
        return "{" + _fingerprint(k) + ":" + _fingerprint(v) + "}"
    if t in (T.UNARY, T.BINARY, T.VARY):
        return "#" + ast.v.name
    if t == -T.SYMBOL:
        q = "'" if ast.attrs & 1 else ""
        return q + symbols.name_of(int(ast.v))
    if t < 0:
        return f"{t}:{ast.v}"
    if t == T.SYMBOL:
        return "[" + " ".join(symbols.name_of(int(s))
                              for s in to_np(ast)) + "]"
    if T.is_vector(t):
        return f"v{t}:{to_np(ast).tobytes().hex()[:64]}"
    return f"t{t}"


class _Agg:
    __slots__ = ("sid", "name", "inner", "meta")

    def __init__(self, sid, name, inner):
        self.sid = sid
        self.name = name
        self.inner = inner       # Compiled
        self.meta = {}


class _Plan:
    __slots__ = ("fn", "col_objs", "key_meta", "aggs", "n_codes",
                 "lanes_meta", "spmd")


def _minmax_payload(arr, rtype, is_min):
    """Value with nulls mapped to the losing extreme (reference skips
    nulls in MIN/MAX, ops.h:180-190). f64 stays in value space; ints
    are widened to i64."""
    nulls = A.null_mask(arr, rtype)
    if rtype == T.F64:
        return torch.where(nulls, np.inf if is_min else -np.inf, arr)
    return torch.where(nulls, G.KEY_MAX if is_min else G.I64_MIN,
                       arr.to(I64))


def _parse_by(by_ast):
    by_pairs = []
    if by_ast is not None:
        if by_ast.t == -T.SYMBOL and not (by_ast.attrs & 1):
            by_pairs = [(int(by_ast.v), by_ast)]
        elif by_ast.t == T.DICT:
            bkeys, bvals = by_ast.v
            if bkeys.t != T.SYMBOL:
                return None
            bids = to_np(bkeys)
            by_pairs = [(int(bids[i]), bvals.v[i])
                        for i in range(len(bids))]
        else:
            return None
    return by_pairs


def _compile_keys(src, by_pairs):
    """Compile key exprs, returning (key_cs, key_meta, n_codes) where
    n_codes is the full (possibly huge) dense code-space size."""
    key_cs = []
    key_meta = []   # (name, lo, rng, rtype, enum_dom | None)
    n_codes = 1
    for nm, ast in by_pairs:
        dom = None
        ck = compile_expr(src, ast)
        if ck is None or ck.rtype in (T.F64, T.C8):
            return None
        if len(ck.cols) == 1 and ast.t == -T.SYMBOL and \
                ck.cols[0].col.t == T.ENUM:
            # group on raw enum codes; the output column stays ENUM
            # over the same domain (host parity)
            col = ck.cols[0].col
            dom = col.domain
            lo, hi = 0, max(len(enum_domain(col)) - 1, 0)
            slot = ck.cols[0].slot
            ck.fn = (lambda env, s=slot: env[s])
        elif len(ck.cols) == 1 and ast.t == -T.SYMBOL:
            if dev.column_has_null(ck.cols[0].col):
                # the host groups null keys; dense codes would wrap them
                return None
            lo, hi = dev.column_range(ck.cols[0].col)
        else:
            arr = as_tensor(ck.fn([dev.dev_col(r.col) for r in ck.cols]))
            lo, hi = prof.host("select.key_range", lambda: (
                int(arr.min()), int(arr.max())))
        rng = hi - lo + 1
        if rng <= 0:
            return None
        n_codes *= rng
        key_cs.append(ck)
        key_meta.append((nm, lo, rng, ck.rtype, dom))
    return key_cs, key_meta, n_codes


def _compile_aggs(src, outs):
    aggs = []
    for sid, ast in outs:
        sp = split_aggregate(src, ast)
        if sp is None:
            return None
        name, inner = sp
        if name not in ("count", "sum", "avg", "min", "max",
                        "first", "last", "med", "dev"):
            return None
        if name in ("sum", "avg", "med", "dev") and inner.rtype not \
                in (T.U8, T.I16, T.I32, T.I64, T.F64):
            return None  # host raises err_type; keep that behavior
        if name in ("min", "max") and inner.rtype not in MINMAX_OK:
            return None
        if name in ("first", "last") and (
                len(inner.cols) != 1 or ast.v[1].t != -T.SYMBOL):
            return None  # first/last of derived exprs -> host path
        ag = _Agg(sid, name, inner)
        ag.meta["plain_col"] = (name != "count" and
                                len(inner.cols) == 1 and
                                ast.v[1].t == -T.SYMBOL)
        aggs.append(ag)
    return aggs


def _build_plan(src, outs, where_ast, by_ast):
    n_rows = len(src)
    cw = None
    if where_ast is not None:
        cw = compile_expr(src, where_ast)
        if cw is None or cw.rtype != T.B8:
            return None

    by_pairs = _parse_by(by_ast)
    if by_pairs is None:
        return None
    keys = _compile_keys(src, by_pairs)
    if keys is None:
        return None
    key_cs, key_meta, n_codes = keys
    aggs = _compile_aggs(src, outs)
    if aggs is None:
        return None

    small = n_codes <= G.SMALL_N
    has_dev = any(a.name == "dev" for a in aggs)
    if by_pairs and (not small or has_dev):
        m = dev.mesh()
        if m is not None:
            # mesh mode: the partial-aggregate all_to_all exchange
            # carries raw i64 codes, so any single-word code space
            # (< 2^61) distributes, beyond the single-device dense
            # ceiling too; shapes it does not cover run on one device
            from . import dgroup
            dp = dgroup.build_plan(src, n_rows, cw, key_cs, key_meta,
                                   n_codes, aggs, m)
            if dp is not None:
                return dp
    if n_codes > dev._cfg["dense_max"]:
        from . import wide
        return wide.build_plan(src, n_rows, cw, key_cs, key_meta,
                               aggs)

    if by_pairs and (not small or has_dev):
        # mid-cardinality (or dev-needing) grouped select: the
        # sort+compaction engine (engine/sortagg.py)
        from . import sortagg
        return sortagg.build_plan(src, n_rows, cw, key_cs, key_meta,
                                  n_codes, aggs)
    if has_dev:
        return None   # no-by dev: host path
    return _build_dense(n_rows, cw, bool(by_pairs), key_cs, key_meta,
                        n_codes, aggs)


def _build_dense(n_rows, cw, grouped, key_cs, key_meta, n_codes, aggs):
    """The dense plan for n_codes <= SMALL_N (a no-by select is one
    code). `grouped`: the select has a `by` (grouped sum PROPAGATES
    nulls, aggr.c ADD accumulators; a no-by select sums whole-vector
    and SKIPS them)."""
    slots = A.Slots(cw, key_cs, [a.inner for a in aggs])

    def plain_range(a):
        try:
            return dev.column_range(a.inner.cols[0].col)
        except Exception as e:
            if dev.is_fault(e):
                raise
            return None, None

    # per-column requirements (deduped by compiled-expression identity),
    # each taken in the order of its first aggregate: the same order in
    # every process, as a multi-process mesh combines the lanes by
    # position
    first_use: dict = {}
    for i, a in enumerate(aggs):
        first_use.setdefault(id(a.inner), i)

    def in_order(cids):
        return sorted(cids, key=first_use.__getitem__)

    need_nullcnt = set()
    need_limbs = {}        # cid -> (lo, hi) stats or (None, None)
    need_isumb = {}        # cid -> (lo, hi): exact sums, all < 2^53
    need_fsum = set()      # f64 sums
    need_min = set()
    need_max = set()
    need_med = set()       # per-column (codes, value) sorts
    for a in aggs:
        cid = id(a.inner)
        if a.name in ("sum", "avg"):
            if A.may_null(a):
                need_nullcnt.add(cid)   # eff count for bias/avg
            if a.inner.rtype in INT_LIKE:
                lo_, hi_ = plain_range(a) if a.meta["plain_col"] \
                    else (None, None)
                if lo_ is not None and hi_ >= lo_ and \
                        max(abs(lo_), abs(hi_)) * n_rows < F64_EXACT:
                    # stats-bounded int sum: every group sum is exact
                    # in f64, so no limb decomposition is needed
                    need_isumb[cid] = (lo_, hi_)
                else:
                    need_limbs[cid] = (lo_, hi_)
            else:
                need_fsum.add(cid)
        elif a.name in ("min", "max"):
            if A.may_null(a):
                need_nullcnt.add(cid)
            (need_min if a.name == "min" else need_max).add(cid)
            if a.meta["plain_col"] and a.inner.rtype in \
                    (T.I64, T.TIMESTAMP, T.SYMBOL):
                lo_, hi_ = plain_range(a)
                if lo_ is not None:
                    a.meta["vrange"] = (lo_, hi_)
        elif a.name == "med":
            if A.may_null(a):
                need_nullcnt.add(cid)
            need_med.add(cid)

    def limb_meta(cid):
        lo, hi = need_limbs[cid]
        if lo is not None and hi >= lo:
            width = max((hi - lo).bit_length(), 1)
            bias = -lo
            bound = max(abs(lo), abs(hi)) * n_rows   # |group sum| bound
        else:
            width, bias, bound = 64, 1 << 63, 1 << 63
        n_limbs = -(-width // G.LIMB_BITS)
        return n_limbs, bias, bound

    NC = n_codes
    lanes_meta = {}
    # on a mesh the plan runs on every shard's rows and combines their
    # dense partial lanes (a median needs whole groups: one device)
    m = dev.mesh()
    spmd = m is not None and not need_med
    n_dev = m.n if spmd else 1
    rows_local = -(-n_rows // n_dev)

    def inputs(cols, n, row0):
        """Rows [row0, row0 + n) of the (padded) table as the dense scans
        take them: (codes, value arrays, their types, and the named
        lanes {"task" | "sum" | "min" | "max": [(name, lane)]})."""
        d = cols[0].device if cols else dev.device()
        mask = None
        if cw is not None:
            mask = slots.eval(cw, cols).to(torch.bool)
        if spmd:
            # shard padding rows (global row id >= n_rows) are masked
            real = row0 + torch.arange(n, device=d) < n_rows
            mask = real if mask is None else mask & real
        codes = A.key_codes(slots, cols, key_cs, key_meta, n, d)
        if mask is not None:
            codes = torch.where(mask, codes, NC)

        arrs = {}
        rtypes = {}
        for a in aggs:
            cid = id(a.inner)
            if a.name != "count" and cid not in arrs:
                arrs[cid] = slots.eval(a.inner, cols)
                rtypes[cid] = a.inner.rtype

        # exact limb sums of the full-width integer columns
        tasks = []
        for cid in in_order(need_limbs):
            lo, hi = need_limbs[cid]
            nv = T.NULL_BY_TYPE.get(rtypes[cid])
            limbs, _nw, _b = G.int_limb_weights(arrs[cid], nv, lo, hi)
            tasks += [(f"limb{cid}_{i}", lb) for i, lb in enumerate(limbs)]
        sums = [(f"nullcnt{cid}",
                 A.null_mask(arrs[cid], rtypes[cid]).to(I64))
                for cid in in_order(need_nullcnt)]
        for cid in in_order(need_isumb):
            z = arrs[cid].to(I64)
            nv = A.dt_null(rtypes[cid])
            if nv is not None:
                z = torch.where(z == int(nv), 0, z)
            sums.append((f"isum{cid}", z))
        sums += [(f"fsum{cid}",
                  torch.where(torch.isnan(arrs[cid]), 0.0, arrs[cid]))
                 for cid in in_order(need_fsum)]
        mins = [(f"min{cid}", _minmax_payload(arrs[cid], rtypes[cid], True))
                for cid in in_order(need_min)]
        maxs = [(f"max{cid}", _minmax_payload(arrs[cid], rtypes[cid], False))
                for cid in in_order(need_max)]
        return codes, arrs, rtypes, {"task": tasks, "sum": sums,
                                     "min": mins, "max": maxs}

    def partials(cols):
        """One device's dense lanes: counts, first/last row ids, null
        counts, limb and bounded sums, extrema and medians."""
        codes, arrs, rtypes, lanes = inputs(cols, n_rows, 0)
        n = n_rows
        part = {}

        # ---- one dense pass: counts, first/last rows, exact task sums,
        # sums, extrema ----
        bc = G.dense_scan(codes, NC, n, [w for _, w in lanes["task"]],
                          *[tuple(x for _, x in lanes[k]) for k in _SCANNED],
                          want_counts=True, want_fidx=True)
        part.update({nm: bc[f"task{i}"]
                     for i, (nm, _) in enumerate(lanes["task"])})
        part.update({k: bc[k] for k in ("counts", "fidx", "lidx")})
        for k in _SCANNED:
            part.update({nm: bc[f"{k}{i}"]
                         for i, (nm, _) in enumerate(lanes[k])})

        # ---- med: per-column (codes, value) sort + middle gathers ----
        if need_med:
            counts = bc["counts"].to(F64)
            cnt64 = counts.to(I64)
            m_starts = torch.cat([cnt64.new_zeros(1),
                                  torch.cumsum(cnt64, 0)[:-1]])
        for cid in in_order(need_med):
            arr = arrs[cid]
            # nulls sort last; an i32-wide column keeps a one-word key
            if rtypes[cid] == T.F64:
                key = torch.where(torch.isnan(arr), np.inf, arr)
            else:
                narrow = rtypes[cid] in NARROW32
                key = arr.to(I64)
                nv = A.dt_null(rtypes[cid])
                if nv is not None:
                    key = torch.where(key == int(nv), (1 << 31) - 1
                                      if narrow else G.KEY_MAX, key)
                if narrow:
                    key = key.to(I32)
            sval = sort_by_code(codes, key)
            e = (counts - part[f"nullcnt{cid}"]
                 if cid in need_nullcnt else counts).to(I64)
            part[f"med{cid}"] = A.median(sval, m_starts, e, n)
        return part

    def spmd_partials(cols):
        """The mesh's dense lanes: every shard's inputs through
        dist_select_small, combined across shards in shard order."""
        from ..parallel import dist
        # this process's shards (all of them, but for a multi-process
        # mesh)
        ins = [inputs([c[s] for c in cols], rows_local, s * rows_local)
               if s in m.local else None for s in range(n_dev)]
        lanes = dist.pick(ins, 3)
        names = {k: [nm for nm, _ in v] for k, v in dist.here(lanes).items()}
        kern = dist.dist_select_small(
            m, NC, rows_local, len(names["sum"]), len(names["min"]),
            len(names["max"]), len(names["task"])).inner
        # the kernel's lanes: tasks, sums, mins, maxs, each per shard
        out = kern(dist.pick(ins, 0),
                   *[dist.smap(lambda _s, ln: ln[k][i][1], lanes)
                     for k in ("task",) + _SCANNED
                     for i in range(len(names[k]))])
        part = {nm: out[f"{k}{i}"] for k, v in names.items()
                for i, nm in enumerate(v)}
        part.update({k: out[k] for k in ("counts", "fidx", "lidx")})
        return part

    def finalize(part):
        """Order, decode and narrow the (combined) dense lanes into one
        packed buffer."""
        d = part["counts"].device
        counts = part["counts"].to(F64)
        fidx = part["fidx"]              # KEY_MAX for empty groups
        lidx = part["lidx"]
        mm = {nm: x for nm, x in part.items()
              if nm.startswith(("nullcnt", "limb"))}
        agg_raw = {nm: x for nm, x in part.items()
                   if nm.startswith(("isum", "fsum", "min", "max", "med"))}
        # ---- device-side finalization: order, decode, narrow ----
        # first-appearance order: a stable sort of first-row ids as one
        # i32 word (row ids < 2^31 - 1; empty groups hold KEY_MAX, here
        # INT32_MAX, and sort last)
        fkey = torch.clamp(fidx, max=(1 << 31) - 1).to(I32)
        ordi = argsort(fkey)
        n_occ = (counts > 0).sum().to(I32)

        P = G.Packer()
        P.add("nocc", n_occ.reshape(1))
        P.add("slots", ordi.to(I32))                # dense codes
        counts_o = counts[ordi]
        eff_cache = {}

        def eff(cid):
            if cid not in eff_cache:
                if cid in need_nullcnt:
                    eff_cache[cid] = counts_o - mm[f"nullcnt{cid}"][ordi]
                else:
                    eff_cache[cid] = counts_o
            return eff_cache[cid]

        emitted = set()
        for a in aggs:
            cid = id(a.inner)
            rt = a.inner.rtype if a.name != "count" else T.I64
            lane = A.lane_name(a)
            if lane in emitted:
                continue
            emitted.add(lane)
            if a.name == "count":
                P.add(lane, counts_o.to(I32 if n_rows < (1 << 31)
                                        else I64))
            elif a.name == "first":
                P.add(lane, fidx[ordi].to(I32))
            elif a.name == "last":
                P.add(lane, lidx[ordi].to(I32))
            elif a.name in ("min", "max"):
                v = agg_raw[f"{a.name}{cid}"][ordi]
                nullable = cid in need_nullcnt
                v = A.minmax_nulls(v, (mm[f"nullcnt{cid}"][ordi] == counts_o)
                                   if nullable else None, a, rt)
                if rt != T.F64:
                    narrow = rt in NARROW32
                    if not narrow and not nullable and \
                            "vrange" in a.meta:
                        vlo, vhi = a.meta["vrange"]
                        narrow = -(1 << 31) <= vlo and vhi < (1 << 31)
                    if narrow:
                        v = v.to(I32)
                P.add(lane, v)
            elif a.name == "med":
                P.add(lane, agg_raw[f"med{cid}"][ordi])
            elif rt == T.F64:   # f64 sum / avg
                s = agg_raw[f"fsum{cid}"][ordi]
                if a.name == "avg":
                    s = A.avg(s, eff(cid))
                elif A.sum_propagates(a, cid in need_nullcnt, grouped):
                    s = A.sum_nulls(s, mm[f"nullcnt{cid}"][ordi], rt)
                P.add(lane, s)
            else:               # integer sum / avg
                if cid in need_isumb:
                    lo_, hi_ = need_isumb[cid]
                    bound = max(abs(lo_), abs(hi_)) * n_rows
                    n_limbs = 0
                else:
                    n_limbs, bias, bound = limb_meta(cid)
                if bound < F64_EXACT:
                    if cid in need_isumb:
                        tot = agg_raw[f"isum{cid}"][ordi]
                    else:
                        tot = torch.zeros(NC, dtype=F64, device=d)
                        for i in range(n_limbs):
                            tot = tot + mm[f"limb{cid}_{i}"] * float(
                                1 << (G.LIMB_BITS * i))
                        tot = tot[ordi] - eff(cid) * float(bias)
                    if a.name == "avg":
                        P.add(lane, A.avg(tot, eff(cid)))
                    elif A.sum_propagates(a, cid in need_nullcnt, grouped):
                        P.add(lane, A.sum_nulls(
                            tot.to(I64), mm[f"nullcnt{cid}"][ordi], rt))
                    else:
                        v = tot.to(I64)
                        P.add(lane, v.to(I32) if bound < (1 << 31) else v)
                else:
                    # full-width sum: the host recombines exactly
                    for i in range(n_limbs):
                        P.add(f"limb{cid}_{i}", mm[f"limb{cid}_{i}"][ordi])
                    nc = (mm[f"nullcnt{cid}"][ordi]
                          if cid in need_nullcnt
                          else torch.zeros(NC, dtype=F64, device=d))
                    P.add(f"ncnt{cid}", nc.to(I64))
                    P.add(f"cnt{cid}", counts_o.to(I64))

        buf, layout = P.pack()
        lanes_meta["layout"] = layout
        return buf

    def pipeline(*cols):
        return finalize(spmd_partials(cols) if spmd else partials(cols))

    plan = _Plan()
    plan.fn = pipeline
    plan.spmd = spmd
    plan.col_objs = slots.cols
    plan.key_meta = key_meta
    plan.aggs = aggs
    plan.n_codes = n_codes
    plan.lanes_meta = lanes_meta

    for a in aggs:
        cid = id(a.inner)
        if a.name in ("sum", "avg") and a.inner.rtype in INT_LIKE:
            if cid in need_isumb:
                a.meta["limb_fallback"] = False
                continue
            n_limbs, bias, bound = limb_meta(cid)
            a.meta["limb_fallback"] = bound >= F64_EXACT
            a.meta["n_limbs"] = n_limbs
            a.meta["bias"] = bias
            a.meta["cid"] = cid
    return plan


# the lanes bcast_scan (and dense_scan after its tasks) takes, in its
# argument order
_SCANNED = ("sum", "min", "max")


def _stacked_bytes(layout) -> int:
    """The bytes of a packed result as the reference stacks it: one
    buffer per lane dtype (i64, f64, i32), each lane padded to the
    widest of its buffer. The exchange model counts a replicated result
    at this size in both packages."""
    size = {"i64": 8, "f64": 8, "i32": 4}
    widths: dict = {}
    for _nm, tag, _off, ln in layout:
        widths.setdefault(tag, []).append(ln)
    return sum(len(w) * max(w) * size[t] for t, w in widths.items())


def _host_gather(col_obj: Obj, idx: np.ndarray) -> Obj:
    """first/last: gather column values at group row ids on the host."""
    from ..ops.compose import gather
    return gather(col_obj, idx.astype(np.int64))


_warned = [False]


def warn_fallback(e):
    from ..core import log
    log.debug("device path fallback: %s: %s", type(e).__name__,
              str(e)[:200])
    if not _warned[0]:
        _warned[0] = True
        print(f"rayforce-tpu: device select path disabled by error "
              f"({type(e).__name__}: {str(e)[:200]}); using host path",
              file=sys.stderr)


def try_select_device(interp, src: Obj, outs, where_ast, by_ast, lim,
                      empty_to_none=True):
    """empty_to_none=False returns the string "empty" for an
    all-filtered result instead of collapsing it to None — parted
    streaming uses it to tell an EMPTY partition (skip it) from an
    UNSUPPORTED shape (host fallback)."""
    if not dev.available() or not dev.should_use(len(src)):
        return None
    if not outs:
        return None
    with prof.span("plan"):
        plan = _cached_plan(src, outs, where_ast, by_ast)
    if plan is None or plan == "unsupported":
        return None

    from . import dgroup as _dg
    from . import sortagg as _sa
    from . import wide as _wd
    if isinstance(plan, (_dg._DPlan, _sa._SAPlan, _wd._WPlan)):
        t0 = time.perf_counter()
        if isinstance(plan, _dg._DPlan):
            with prof.span("engine: dist-group"):
                r = _dg.run(plan)
            info = {"engine": "dist-group"}
        elif isinstance(plan, _sa._SAPlan):
            with prof.span("engine: sortagg"):
                r = _sa.run(plan)
            info = {"engine": "sortagg", "n_codes": plan.n_codes,
                    "exact": plan.exact}
        else:
            with prof.span("engine: wide"):
                r = _wd.run(plan)
            info = {"engine": "wide"}
        info["exec_ms"] = (time.perf_counter() - t0) * 1e3
        last_profile.clear()
        last_profile.update(info)
        return (None if empty_to_none else r) \
            if isinstance(r, str) else r

    with prof.span("engine: dense"):
        lanes = _run_dense(plan)
    k = int(lanes["nocc"][0])
    if k == 0:
        # every row filtered out: the host path carries the empty/
        # no-by result semantics (a no-by select still yields ONE row
        # of whole-vector-over-empty aggregates, e.g. avg -> 0Nf)
        return None if empty_to_none else "empty"
    # key values decoded arithmetically from the ordered dense codes
    codes = lanes["slots"][:k].astype(np.int64)
    out_cols = [A.key_obj(km, v.astype(T.DTYPE[km[3]])) for km, v in
                zip(plan.key_meta, A.key_values(codes, plan.key_meta))]
    grouped = bool(plan.key_meta)
    for a in plan.aggs:
        if a.meta.get("limb_fallback"):    # its lanes are the limb sums
            out_cols.append(self_recombine(
                a, lanes, k, avg=a.name == "avg",
                propagate=A.sum_propagates(a, True, grouped)))
            continue
        v = lanes[A.lane_name(a)][:k]
        if a.name in ("first", "last"):
            out_cols.append(_host_gather(a.inner.cols[0].col, v))
        else:
            t = A.result_type(a)
            out_cols.append(Obj(t, v.astype(T.DTYPE[t])))
    return A.result_table(plan.key_meta, plan.aggs, out_cols)


def _cached_plan(src: Obj, outs, where_ast, by_ast):
    """The plan of the select from the cache, or built and cached: None
    where it cannot be built, "unsupported" where it was not before."""
    # NOTE: the cache entry PINS src. Keys include id(src); a transient
    # table could die and CPython could hand its id to a NEW same-length
    # table, silently serving a stale plan that computes on the OLD
    # captured columns. Holding src in the entry makes id reuse
    # impossible while the entry lives.
    key = (id(src), len(src),
           _fingerprint(where_ast) if where_ast is not None else "",
           _fingerprint(by_ast) if by_ast is not None else "",
           tuple((sid, _fingerprint(ast)) for sid, ast in outs),
           dev.mesh_key())
    ent = _plan_cache.get(key)
    if ent is not None:
        return ent[0]
    with prof.span("plan: build"):
        plan = _build_plan(src, outs, where_ast, by_ast)
    if plan is None:
        _plan_cache[key] = ("unsupported", src)
        return None
    _plan_cache[key] = (plan, src)
    if len(_plan_cache) > 512:
        # FIFO eviction: long-running servers must not pin tables
        # (and their device columns) forever
        _plan_cache.pop(next(iter(_plan_cache)))
    return plan


def _run_dense(plan):
    """Run a dense plan; its packed result lanes, fetched to the host in
    one transfer."""
    t0 = time.perf_counter()
    if plan.spmd:
        m = dev.mesh()
        cols = [dev.dev_col_sharded(c, m) for c in plan.col_objs]
    else:
        cols = [dev.dev_col(c) for c in plan.col_objs]
    buf = plan.fn(*cols)
    t1 = time.perf_counter()
    if plan.spmd:
        # the combines counted as the reference counts its inline ones:
        # ~2*(n-1)*replicated bytes
        from ..parallel import dist as _dist
        _dist.stats["exchanged_bytes"] += 2 * (m.n - 1) * _stacked_bytes(
            plan.lanes_meta["layout"])
        _dist.stats["kernel_calls"] += 1
    buf = prof.host("select.dense_lanes", buf.cpu).numpy()
    t2 = time.perf_counter()
    lanes = G.unpack(buf, plan.lanes_meta["layout"])
    last_profile.clear()
    last_profile.update({"dispatch_ms": (t1 - t0) * 1000,
                         "exec+fetch_ms": (t2 - t1) * 1000,
                         "n_codes": plan.n_codes,
                         "spmd": plan.spmd})
    return lanes


def self_recombine(a: _Agg, lanes, k, avg: bool,
                   propagate: bool = True) -> Obj:
    """Host-exact recombination for full-width integer sums whose
    bound exceeds 2^53 (full-range i64 columns). avg divides the exact
    Python-int total; only the sum wraps to i64."""
    cid = a.meta["cid"]
    limb_sums = [lanes[f"limb{cid}_{i}"][:k]
                 for i in range(a.meta["n_limbs"])]
    nullc = lanes[f"ncnt{cid}"][:k]
    counts = lanes[f"cnt{cid}"][:k]
    tot = G.recombine_limbs(limb_sums, a.meta["bias"], counts, nullc)
    if avg:
        eff = (counts - nullc).astype(np.float64)
        num = np.array([float(x) for x in tot], dtype=np.float64)
        with np.errstate(invalid="ignore", divide="ignore"):
            v = num / eff
        v = np.where(eff == 0, T.NULL_F64, v)
        return Obj(T.F64, v)
    wrapped = ((tot.astype(object) + (1 << 63)) % (1 << 64)) - (1 << 63)
    vals = np.array([int(x) for x in wrapped], dtype=np.int64)
    if propagate:
        vals = A.sum_nulls(vals, nullc, a.inner.rtype)
    ot = A.result_type(a)
    return Obj(ot, vals.astype(T.DTYPE[ot]))
