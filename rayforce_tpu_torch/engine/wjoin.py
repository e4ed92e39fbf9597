"""Device window join (window-join / window-join1) over device-resident
columns.

The reference C engine sorts the right table by its keys, finds a
per-left-row window [li, ri] of right rows by binary searches, and
reduces each range (core/join.c:358-489, core/index.c:3287-3347,
core/aggr.c AGGR_ITER INDEX_TYPE_WINDOW). The device plan finds every
boundary with two stable sorts instead of per-row searches:

  right  = the right rows sorted by (key code, time); the permutation
           `sr` orders the aggregated columns
  events = right rows (tie 0) ++ lo events (tie +1 for window-join,
           -1 for window-join1) ++ hi events (tie +1), sorted by
           (key code, time, tie)
  prefix = cumsum(is_right) over the sorted events, put back in event
           order by one scatter through the sort's permutation: each
           left row's p_lo and p_hi

Window boundaries then clamp to each key group's rows exactly as
ops/join.py window_ranges does. Aggregates over the right columns in
sorted order:

  count, sum, avg, dev  prefix sums and boundary differences
  first, last           the nearest non-null row at each end (one
                        running min or max of row positions)
  min, max              a sparse table over the values, as many levels
                        deep as the widest window needs

Both sorts go through `psort.sort_lex`, so on the card through the CUDA
radix sort; it is stable and returns its permutation, so no row index
rides as a key and no second sort undoes the events sort (the TPU
package needs both). Output columns are lazy (DevPending), len(left)
rows each.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..core import profiler as prof
from ..core import types as T
from ..core.obj import DevPending, Obj
from . import device as dev
from . import psort
from .groupby import I64_MIN, KEY_MAX
from .join import _key_ranges, _pack_codes

SUM_TYPE = {T.U8: T.I64, T.I16: T.I64, T.I32: T.I32, T.I64: T.I64,
            T.F64: T.F64}
MINMAX_OK = (T.B8, T.U8, T.I16, T.I32, T.I64, T.DATE, T.TIME,
             T.TIMESTAMP, T.F64)
AGGS = ("count", "first", "last", "sum", "avg", "min", "max", "dev")

I64 = torch.int64
F64 = torch.float64
I32 = torch.int32

# which window-join engine ran last ("device-wjoin", or "dist-wjoin" on a
# mesh), as the reference records it
last_profile: dict = {}


def _null_mask_t(arr, rtype: int):
    if rtype == T.F64:
        return torch.isnan(arr)
    nv = T.NULL_BY_TYPE.get(rtype)
    if nv is None:
        return torch.zeros(arr.shape, dtype=torch.bool, device=arr.device)
    return arr == int(nv)


def _lim(dtype, op):
    """The losing extreme of `op` in `dtype` (the range identity)."""
    if dtype == F64:
        return math.inf if op == "min" else -math.inf
    if dtype == torch.int32:
        return 0x7FFFFFFF if op == "min" else -0x80000000
    return KEY_MAX if op == "min" else I64_MIN


def _k_bounds4(lo, hi):
    """(min lo, max lo, min hi, max hi) in one host fetch."""
    lmin, lmax = torch.aminmax(lo)
    hmin, hmax = torch.aminmax(hi)
    return [int(x) for x in prof.host(
        "wjoin.bounds", torch.stack([lmin, lmax, hmin, hmax]).tolist)]


# -- scans ---------------------------------------------------------------------

_SCAN_B = 1024


def _scan(x, op):
    """Inclusive scan (op "sum", "max" or "min") of a 1-D tensor: a scan
    along each 1024-wide row of a 2-D view, then the rows' totals
    scanned the same way and folded back in. A scan along the rows of a
    2-D tensor runs one block per row and adds in the same order on
    every run. torch's scan of a whole 1-D tensor does neither: cumsum
    combines tiles as they finish, so an f64 sum's last bits change from
    one card run to the next, and cummax / cummin sweep the whole
    tensor with one block."""
    n = int(x.shape[0])
    ident = 0 if op == "sum" else _lim(x.dtype, "min" if op == "min"
                                       else "max")
    rows = max(-(-n // _SCAN_B), 2)
    m = x.new_full((rows * _SCAN_B,), ident)
    m[:n] = x
    m = m.view(rows, _SCAN_B)
    if op == "sum":
        m = m.cumsum(1)
    else:
        m = (m.cummax(1) if op == "max" else m.cummin(1)).values
    if n > _SCAN_B:
        carry = _scan(m[:, -1].contiguous(), op)
        prev = torch.cat([carry.new_full((1,), ident), carry[:-1]])[:, None]
        if op == "sum":
            m = m + prev
        else:
            m = torch.maximum(m, prev) if op == "max" else \
                torch.minimum(m, prev)
    return m.reshape(-1)[:n]


def _prefix_f64(x):
    """[0, x0, x0 + x1, ...] (n + 1 values) of an f64 vector, added in
    the fixed order of `_scan`."""
    return torch.cat([x.new_zeros(1), _scan(x, "sum")])


def _next_pos(mask):
    """Per row, the first position at or after it where mask holds (n
    where none)."""
    n = int(mask.shape[0])
    iota = torch.arange(n, dtype=I64, device=mask.device)
    return _scan(torch.where(mask, iota, n).flip(0), "min").flip(0)


def _prev_pos(mask):
    """Per row, the last position at or before it where mask holds (-1
    where none)."""
    iota = torch.arange(int(mask.shape[0]), dtype=I64, device=mask.device)
    return _scan(torch.where(mask, iota, -1), "max")


def _prefix_count(mask):
    """[0, c0, c0 + c1, ...] of a boolean mask, as exact i64 counts."""
    return torch.cat([mask.new_zeros(1, dtype=I64),
                      torch.cumsum(mask.to(I64), 0)])


# -- boundaries ---------------------------------------------------------------

def _boundary_core(lcode, rcode, rt, lo, hi, n_codes, tp, pack,
                   lvalid=None):
    """(sr, li, ri, ok): the right table's sort permutation (sorted right
    row i is row sr[i]) and, per left row, its clamped window [li, ri]
    into the sorted right rows and whether the window holds a row.

    `pack` = (tmin, tbits) where (code, time - tmin, tie) fit one i64
    sort key; else the keys are (code, time[, tie]) with the code as one
    i32 word (codes lie in [0, n_codes], n_codes <= dense_max). On the
    mesh a shard's received buffers hold pad rows: right ones carry the
    trash code n_codes (they sort after every real code), left ones are
    masked by `lvalid` (their ok is False)."""
    nl, nr = int(lcode.shape[0]), int(rcode.shape[0])
    d = lcode.device
    probes = torch.arange(n_codes + 1, dtype=I64, device=d)
    if pack is not None:
        tmin, tbits = pack
        (skey,), _, sr = psort.sort_lex([(rcode << tbits) | (rt - tmin)],
                                        perm=True)
        starts_ext = torch.searchsorted(skey, probes << tbits)
    else:
        rc32 = rcode.to(torch.int32)
        (scode, _st), _, sr = psort.sort_lex([rc32, rt], perm=True)
        starts_ext = torch.searchsorted(scode, probes.to(torch.int32))
    # starts_ext[c] = right rows with a code below c
    cnt = starts_ext[1:] - starts_ext[:-1]
    lc = lcode.clamp(0, n_codes - 1)
    g_cnt = cnt[lc]
    g_fi = starts_ext[:-1][lc]
    g_ti = g_fi + g_cnt - 1
    has_group = g_cnt > 0

    lo_tie = 1 if tp == 0 else -1
    codes_all = torch.cat([rcode, lcode, lcode])
    times_all = torch.cat([rt, lo, hi])
    ties = torch.cat([torch.zeros(nr, dtype=I64, device=d),
                      torch.full((nl,), lo_tie, dtype=I64, device=d),
                      torch.ones(nl, dtype=I64, device=d)])
    if pack is not None:
        tmin, tbits = pack
        keys = [(codes_all << (tbits + 2)) | ((times_all - tmin) << 2) |
                (ties + 1)]
    else:
        keys = [codes_all.to(torch.int32), times_all, ties.to(torch.int32)]
    _, _, eperm = psort.sort_lex(keys, perm=True)
    eperm = eperm.long()
    prefix = torch.cumsum((eperm < nr).to(I64), 0)
    # back to event order by one scatter through the permutation
    pref = torch.empty(nr + 2 * nl, dtype=I64, device=d)
    pref.scatter_(0, eperm, prefix)
    p_lo = pref[nr:nr + nl]
    p_hi = pref[nr + nl:]

    if tp == 0:
        p_lo_r = p_lo - 1
        li = torch.where(p_lo_r < g_fi, g_fi, torch.minimum(p_lo_r, g_ti))
    else:
        li = torch.where((p_lo > g_ti) | (p_lo < g_fi), g_fi,
                         torch.maximum(p_lo, g_fi))
    p_hi_r = p_hi - 1
    ri = torch.where(p_hi_r < g_fi, g_fi, torch.minimum(p_hi_r, g_ti))
    safe_li = li.clamp(0, max(nr - 1, 0))
    safe_ri = ri.clamp(0, max(nr - 1, 0))
    # emptiness from the event prefixes alone: for window-join1 the
    # group's right rows inside [lo, hi]; for window-join (li reaches
    # back to the last row at or before lo) any row at or before hi
    if tp == 1:
        valid = has_group & (p_hi - p_lo > 0)
    else:
        valid = has_group & (p_hi - g_fi > 0)
    ok = valid & (li <= ri)
    if lvalid is not None:
        ok = ok & lvalid
    return sr.long(), safe_li, safe_ri, ok


# -- aggregates over the sorted right column ----------------------------------

def _k_count(li, ri, ok):
    return torch.where(ok, ri - li + 1, 0)


def _k_first_last(sv, li, ri, ok, rtype, last):
    """Window first/last SKIP NULLS to the nearest non-null row inside
    [li, ri] (reference first-non-null-slot semantics, aggr.c:394-438;
    oracle-pinned by the wjoin_nulls goldens)."""
    n = int(sv.shape[0])
    nt = rtype if rtype != T.ENUM else T.SYMBOL
    nn = _null_mask_t(sv, nt)
    if last:
        pos = _prev_pos(~nn)[ri]
        okfl = ok & (pos >= li)
    else:
        pos = _next_pos(~nn)[li]
        okfl = ok & (pos <= ri)
    g = sv[pos.clamp(0, max(n - 1, 0))]
    if rtype == T.F64:
        return torch.where(okfl, g, math.nan)
    nv = T.NULL_BY_TYPE.get(nt)
    fill = torch.tensor(0 if nv is None else int(nv), device=g.device)
    return torch.where(okfl, g, fill.to(g.dtype))


def _k_sum_avg(sv, li, ri, ok, rtype, want_avg):
    nn = _null_mask_t(sv, rtype)
    cn = _prefix_count(nn)
    n_null = cn[ri + 1] - cn[li]
    if not want_avg and rtype != T.F64:
        # an integer sum is the difference of i64 prefix sums: exact,
        # and wrapping past 2^63 as the host path's np.cumsum does
        vz = torch.where(nn, 0, sv.to(I64))
        cs = torch.cat([vz.new_zeros(1), _scan(vz, "sum")])
        s = cs[ri + 1] - cs[li]
    else:
        cs = _prefix_f64(torch.where(nn, 0, sv).to(F64))
        s = cs[ri + 1] - cs[li]
    if not want_avg:
        # a window sum PROPAGATES nulls (ADD accumulators, aggr.c;
        # oracle-pinned) and an EMPTY window sums to typed NULL, not 0
        # (the reference's Null macro; wjoin_nulls goldens)
        if rtype == T.F64:
            s = torch.where(n_null > 0, math.nan, s)
            return torch.where(ok, s, math.nan)
        ot = SUM_TYPE[rtype]
        nv = int(T.NULL_BY_TYPE.get(ot, T.NULL_I64))
        si = torch.where((n_null > 0) | ~ok, nv, s.to(I64))
        return si.to(_torch_dtype(ot))
    c = (ri + 1 - li - n_null).to(F64)
    a = s / torch.where(c > 0, c, 1.0)
    return torch.where(ok & (c > 0), a, math.nan)


def _k_dev(sv, li, ri, ok, rtype):
    """Window DEV via shifted cumulative moments over the sorted right
    column (reference aggr.c:2806 aggr_map_dev_window). The non-null mean
    shift conditions E[x'^2] - E[x']^2 to fmt precision. Nulls skip;
    empty windows yield 0Nf."""
    nn = _null_mask_t(sv, rtype)
    v = sv.to(F64)
    # the shift and the floor below are sums in the fixed order of the
    # prefix scan: a whole-vector sum on CPU torch adds in the order of
    # its thread split, so its last bits follow the thread count
    c0 = _prefix_f64(torch.where(nn, 0.0, v))[-1] / \
        (~nn).sum().clamp(min=1)
    x = torch.where(nn, 0.0, v - c0)
    cs = _prefix_f64(x)
    cs2 = _prefix_f64(x * x)
    cc = _prefix_count(~nn)
    s = cs[ri + 1] - cs[li]
    s2 = cs2[ri + 1] - cs2[li]
    c = (cc[ri + 1] - cc[li]).to(F64)
    safe = torch.where(c > 0, c, 1.0)
    mean = s / safe
    var = s2 / safe - mean * mean
    # noise floor: the prefix-difference cancellation error is bounded
    # by eps * (the global second moment); without it a constant
    # window's true variance (0) surfaces as ~1e-5 noise that fmt
    # prints in scientific notation where the host path prints 0.00
    floor = cs2[-1] * (2.0 ** -48) / safe
    var = torch.where(var <= floor, 0.0, var)
    out = torch.sqrt(torch.clamp(var, min=0.0))
    return torch.where(ok & (c > 0), out, math.nan)


# -- min / max: range extremes over the values --------------------------------

# the most bytes a flat sparse table may take; a deeper one goes to the
# two-level structure (a 2^_BLOG-row block table plus block summaries)
_TABLE_BYTES = 2 << 30
_BLOG = 8


def _msb(x):
    """floor(log2(x)) of positive i64 values, by five shift steps."""
    k = torch.zeros_like(x)
    for shift in (16, 8, 4, 2, 1):
        m = x >= (1 << shift)
        k = k + torch.where(m, shift, 0)
        x = torch.where(m, x >> shift, x)
    return k


def _sparse_levels(vals, levels, fn):
    """(levels, n) table: row k holds fn over [i, i + 2^k) (clipped to
    the end of vals)."""
    n = int(vals.shape[0])
    tab = vals.new_empty((levels, n))
    tab[0] = vals
    for k in range(1, levels):
        sh = 1 << (k - 1)
        if sh >= n:
            tab[k] = tab[k - 1]
            continue
        tab[k, :n - sh] = fn(tab[k - 1, :n - sh], tab[k - 1, sh:])
        tab[k, n - sh:] = tab[k - 1, n - sh:]
    return tab


def _sparse_query(tab, li, ri, fn):
    """fn over [li, ri] per row from a sparse table: two lookups of the
    level whose span covers half the window or more."""
    levels, n = tab.shape
    k = _msb(torch.clamp(ri - li + 1, min=1)).clamp(max=levels - 1)
    flat = tab.view(-1)
    a = flat[k * n + li]
    b = flat[k * n + torch.clamp(ri + 1 - (1 << k), min=0)]
    return fn(a, b)


def _range_ext(key, li, ri, op, span):
    """op (min or max) of key over [li, ri] per row (rows with li > ri
    get a value that the caller masks). `span` is the widest window
    that matters: the flat table is only that deep. Above _TABLE_BYTES
    the key goes into blocks of 2^_BLOG rows: a window shorter than a
    block reads a _BLOG-level table, a longer one the suffix of its first
    block, the prefix of its last and a sparse table over the whole
    blocks between."""
    fn = torch.minimum if op == "min" else torch.maximum
    n = int(key.shape[0])
    levels = max(int(span).bit_length(), 1)
    if levels * n * key.element_size() <= _TABLE_BYTES:
        return _sparse_query(_sparse_levels(key, levels, fn), li, ri, fn)
    B = 1 << _BLOG
    nb = -(-n // B)
    ident = _lim(key.dtype, op)
    v = torch.cat([key, key.new_full((nb * B - n,), ident)]).view(nb, B)
    cum = torch.cummin if op == "min" else torch.cummax
    pre = cum(v, 1).values.view(-1)
    suf = cum(v.flip(1), 1).values.flip(1).reshape(-1)
    bsum = v.amin(1) if op == "min" else v.amax(1)
    short = _sparse_query(_sparse_levels(key, _BLOG, fn), li, ri, fn)
    edge = fn(suf[li], pre[ri])
    b_lo = (li >> _BLOG) + 1
    b_hi = (ri >> _BLOG) - 1
    btab = _sparse_levels(bsum, max(nb.bit_length(), 1), fn)
    mid = _sparse_query(btab, b_lo.clamp(max=nb - 1),
                        b_hi.clamp(min=0, max=nb - 1), fn)
    long_ = fn(edge, torch.where(b_lo <= b_hi, mid, ident))
    return torch.where(ri - li + 1 < B, short, long_)


def _zero_sign(sv, out, li, ri, op):
    """The sign of a zero window extreme of an f64 column, as the
    reference's rank route gives it: its sort ties -0.0 with 0.0 and
    keeps their row order, so a window min of zero is the window's
    first zero and a max its last. Runs only when the column holds a
    -0.0."""
    z = sv == 0
    if not prof.host("wjoin.zero_sign", bool,
                     (z & torch.signbit(sv)).any()):
        return out
    pos = _next_pos(z)[li] if op == "min" else _prev_pos(z)[ri]
    return torch.where(out == 0, sv[pos.clamp(0, int(sv.shape[0]) - 1)],
                       out)


def _k_minmax(sv, li, ri, ok, rtype, op, span):
    """Window min/max with the reference's all-null rules (oracle-probed
    with i32 TIME columns; aggr.c AGGR_ITER INDEX_TYPE_WINDOW with
    min-init INF / max-init NULL, ops.h:180-190): an EMPTY window is
    typed NULL for both ops; a NON-EMPTY ALL-NULL window is typed INF for
    min and typed NULL for max. For f64 max the -inf init is ambiguous
    against real -inf data, so emptiness there comes from the exact
    non-null count. Narrow types come out in their own dtype."""
    if rtype == T.F64:
        nn = torch.isnan(sv)
        # + 0.0 maps -0.0 to 0.0; _zero_sign restores the sign
        key = torch.where(nn, _lim(F64, op), sv + 0.0)
        out = _zero_sign(sv, _range_ext(key, li, ri, op, span), li, ri, op)
        if op == "min":
            # an all-null window keeps its +inf (min init = INF)
            return torch.where(ok, out, math.nan)
        cn = _prefix_count(~nn)
        return torch.where(ok & (cn[ri + 1] - cn[li] > 0), out, math.nan)
    key = sv.to(I64)
    nv = T.NULL_BY_TYPE.get(rtype)
    if nv is not None:
        key = torch.where(key == int(nv), _lim(I64, op), key)
    out = _range_ext(key, li, ri, op, span)
    nv2 = int(T.NULL_BY_TYPE.get(rtype, T.NULL_I64))
    if op == "min":
        inf_t = int(T.INF_BY_TYPE.get(rtype, T.INF_I64))
        out = torch.where(out == KEY_MAX, inf_t, out)
        out = torch.where(ok, out, nv2)
    else:
        # the I64_MIN all-null sentinel cannot collide with real data
        # (it IS the i64 null; narrower types never reach it)
        out = torch.where(ok & (out != I64_MIN), out, nv2)
    return out.to(sv.dtype)


# -- the mesh window join -------------------------------------------------------

def _span_of(li, ri, ok):
    """A zero-argument callable giving the widest window that holds a
    row (one host fetch, at the first call)."""
    memo = []

    def span():
        if not memo:
            memo.append(prof.host("wjoin.span", int,
                                  torch.where(ok, ri - li + 1, 1).max()))
        return memo[0]
    return span


def _out_type(op, rtype):
    """The output column type of aggregate `op` over a column of rtype."""
    if op == "count":
        return T.I64
    if op in ("avg", "dev"):
        return T.F64
    return SUM_TYPE[rtype] if op == "sum" else rtype


def _aggregate(op, rtype, sv, li, ri, ok, span):
    """One aggregate lane over the sorted right values sv (None for
    count); span: a zero-argument callable giving the widest window
    (min and max only)."""
    if op == "count":
        return _k_count(li, ri, ok)
    if op in ("first", "last"):
        return _k_first_last(sv, li, ri, ok, rtype, op == "last")
    if op in ("sum", "avg"):
        return _k_sum_avg(sv, li, ri, ok, rtype, op == "avg")
    if op == "dev":
        return _k_dev(sv, li, ri, ok, rtype)
    return _k_minmax(sv, li, ri, ok, rtype, op, span())


def _mesh_wjoin_kernel(mesh, n_codes, tp, cap_l, cap_r, cap_b, nl_total,
                       aggs_spec, pay_dtypes):
    """Distributed window join: both tables route rows by code % n_shards
    (parallel/dist.py `_shuffle`), each shard remaps its codes densely
    (c // n_shards) and runs the boundaries and the aggregates over its
    complete key partition (windows never cross keys, so every shard's
    answers are exact), and each result lane goes back to its left row's
    owner (dist `_route_back`): the output is row-sharded in the left
    order with no replicating all_gather. Code and row-id lanes ride as
    i32, times as i64, payloads with their fills (NaN for f64, else 0).
    The received payloads are gathered by the shard's sort permutation,
    as on one device.

    aggs_spec: (op, payload lane | None, rtype) per output. fn(lcode, lo,
    hi, rcode, rts, *payloads), per-shard lists (codes -1 on pad rows)
    -> (ovf_l, ovf_r, ovf_b (1,) each, per aggregate the per-shard
    lanes); an overflow means a bucket was too small, and the caller
    retries with it doubled."""
    from ..parallel import dist
    n_dev = mesh.n
    n_local = -(-n_codes // n_dev)
    n_pay = len(pay_dtypes)

    def fill(dtype):
        return math.nan if dtype == F64 else 0

    def shard_lanes(xl, xr):
        """One shard's aggregate lanes over its received rows."""
        lcode, lo, hi, lrow = xl
        rcode, rts = xr[:2]
        lval = lrow >= 0
        llocal = torch.where(lval, lcode.to(I64) // n_dev, n_local)
        rlocal = torch.where(rcode >= 0, rcode.to(I64) // n_dev, n_local)
        sr, li, ri, ok = _boundary_core(llocal, rlocal, rts, lo, hi,
                                        n_local, tp, None, lvalid=lval)
        span = _span_of(li, ri, ok)
        spays = [p.index_select(0, sr) for p in xr[2:]]
        return [_aggregate(op, rtype, None if lane is None else spays[lane],
                           li, ri, ok, span)
                for op, lane, rtype in aggs_spec]

    def kernel(lcode, lo, hi, rcode, rts, *rpays):
        smap = dist.smap
        nl = int(dist.here(lcode).shape[0])
        lrow = smap(lambda me, c: me * nl + torch.arange(nl, device=c.device),
                    lcode)
        xl, ovf_l = dist._shuffle(
            smap(lambda _i, c: c % n_dev, lcode),
            smap(lambda _i, r: r < nl_total, lrow),
            smap(lambda _i, c, a, b, r: [(c.to(I32), -1), (a, 0), (b, 0),
                                         (r.to(I32), -1)],
                 lcode, lo, hi, lrow), n_dev, cap_l)
        xr, ovf_r = dist._shuffle(
            smap(lambda _i, c: c % n_dev, rcode),
            smap(lambda _i, c: c >= 0, rcode),
            smap(lambda me, c, t: [(c.to(I32), -1), (t, 0)] +
                 [(p[me], fill(p[me].dtype)) for p in rpays], rcode, rts),
            n_dev, cap_r)
        lanes = smap(lambda d, _c: shard_lanes([x[d] for x in xl],
                                               [x[d] for x in xr]), lcode)
        per_lane = [dist.pick(lanes, j) for j in range(len(aggs_spec))]
        ovf_b, outs = dist._route_back(
            xl[3], per_lane, [fill(dist.here(x).dtype) for x in per_lane],
            nl, cap_b)
        return (dist.here(dist.psum(ovf_l)), dist.here(dist.psum(ovf_r)),
                ovf_b, *outs)

    lane_bytes = 8 * len(aggs_spec)
    _a2a = n_dev * (n_dev - 1) * \
        ((4 + 8 + 8 + 4) * cap_l + (4 + 8 + 8 * n_pay) * cap_r)
    _a2ab = n_dev * (n_dev - 1) * cap_b * (4 + lane_bytes)
    return dist._counted(kernel, lambda *a: _a2a + _a2ab)


def _mesh_window_join(m, lcode, rcode, rt_d, lo_d, hi_d, n_codes, tp, aggs):
    """The mesh route: shard the code, time and payload lanes, run the
    distributed kernel with capacity retry (each overflowed capacity
    doubles, the return one up to a shard's rows), and wrap each result
    lane as a typed column. None where the reference declines: a
    shard's code space over dense_max, or 2^31 padded rows, where the
    i32 row ids that ride the exchange would wrap."""
    from ..parallel import dist
    n_dev = m.n
    nl, nr = int(lcode.shape[0]), int(rcode.shape[0])
    if -(-n_codes // n_dev) > dev._cfg["dense_max"]:
        return None
    rows_l, rows_r = -(-nl // n_dev), -(-nr // n_dev)
    if n_dev * rows_l >= 2**31 or n_dev * rows_r >= 2**31:
        return None
    pay_cols, pay_slot = [], {}
    for _sid, name, rcol, _rt in aggs:
        if name != "count" and id(rcol) not in pay_slot:
            pay_slot[id(rcol)] = len(pay_cols)
            pay_cols.append(rcol)
    aggs_spec = tuple((name, pay_slot[id(rcol)] if name != "count" else None,
                       rtype) for _sid, name, rcol, rtype in aggs)
    pays = [dev.dev_col(c) for c in pay_cols]
    pay_dtypes = tuple(str(p.dtype) for p in pays)

    def shard(a, f):
        return dist.shard_rows(m, a, f)[0]
    args = [shard(lcode, -1), shard(lo_d, 0), shard(hi_d, 0),
            shard(rcode, -1), shard(rt_d, 0)] + \
        [shard(p, math.nan if p.dtype == F64 else 0) for p in pays]
    caps = [max(2 * rows_l // n_dev, 64), max(2 * rows_r // n_dev, 64),
            max(2 * rows_l // n_dev, 64)]
    while True:
        outs = _mesh_wjoin_kernel(m, n_codes, tp, *caps, nl, aggs_spec,
                                  pay_dtypes)(*args)
        o_l, o_r, o_b = prof.host("wjoin.overflow",
                                  torch.cat(outs[:3]).tolist)
        if not (o_l or o_r or o_b):
            break
        if o_l:
            caps[0] *= 2
        if o_r:
            caps[1] *= 2
        if o_b:
            caps[2] = min(caps[2] * 2, rows_l)
    return {out_sid: _lazy(_out_type(name, rtype),
                           lambda x=dist.unshard(lane, nl): x, nl,
                           _out_domain(name, rcol))
            for (out_sid, name, rcol, rtype), lane in zip(aggs, outs[3:])}


# -- entry --------------------------------------------------------------------

def _torch_dtype(t):
    from .exprc import torch_dtype
    return torch_dtype(T.DTYPE[t])


def aggs_supported(aggs) -> bool:
    """Whether every (out_sid, name, right column, rtype) has a device
    kernel."""
    for _sid, name, _c, rtype in aggs:
        if name not in AGGS:
            return False
        if name in ("sum", "avg", "dev") and rtype not in SUM_TYPE:
            return False
        if name in ("min", "max") and rtype not in MINMAX_OK:
            return False
    return True


def _key_codes(lead_l, lead_r, nl, nr):
    """(left codes, right codes, code count) of the leading keys as
    dense i64 codes, or None when they cannot be coded within
    dense_max."""
    if not lead_l:
        d = dev.device()
        return (torch.zeros(nl, dtype=I64, device=d),
                torch.zeros(nr, dtype=I64, device=d), 1)
    metas = _key_ranges(lead_l, lead_r)
    if metas is None:
        return None
    total = math.prod(rng for _lo, rng, _nb in metas)
    if total > dev._cfg["dense_max"]:
        return None
    return _pack_codes(lead_l, metas), _pack_codes(lead_r, metas), total


def _bound_tensor(b):
    if isinstance(b, torch.Tensor):
        return b.to(dev.device(), I64)
    return torch.from_numpy(np.asarray(b, dtype=np.int64)).to(dev.device())


def _lazy(t, thunk, n, domain=None):
    o = Obj(t, DevPending(thunk=thunk, shape=(n,)), domain=domain)
    o.meta = {}
    return o


def _out_domain(op, rcol):
    """first and last keep the right column's domain (an enum's)."""
    return rcol.domain if op in ("first", "last") else None


def window_join_device(lkeys, rkeys, lo, hi, aggs, tp):
    """Window aggregates on the device. lkeys/rkeys: the leading key
    columns, then the time column. lo, hi: each left row's window
    bounds (device tensors or numpy arrays), or zero-argument callables
    that give them: they are called only once the shape is known to run
    here. aggs: [(out_sid, name, right column Obj, rtype)]. tp: 0 for
    window-join, 1 for window-join1. Returns {out_sid: lazy Obj}, or
    None for a shape the device does not take. Each lazy lane runs its
    aggregate when forced, as the span "engine: wjoin" too."""
    with prof.span("engine: wjoin"):
        return _window_join(lkeys, rkeys, lo, hi, aggs, tp)


def _window_join(lkeys, rkeys, lo, hi, aggs, tp):
    lead_l, time_l = lkeys[:-1], lkeys[-1]
    lead_r, time_r = rkeys[:-1], rkeys[-1]
    nl, nr = len(time_l), len(time_r)
    if nl == 0 or nr == 0 or not aggs_supported(aggs):
        return None
    codes = _key_codes(lead_l, lead_r, nl, nr)
    if codes is None:
        return None
    lcode, rcode, n_codes = codes
    lo_d = _bound_tensor(lo() if callable(lo) else lo)
    hi_d = _bound_tensor(hi() if callable(hi) else hi)
    if lo_d.shape != (nl,) or hi_d.shape != (nl,):
        return None
    rt_d = dev.dev_col(time_r).to(I64)
    last_profile.clear()
    m = dev.mesh()
    if m is not None:
        res = _mesh_window_join(m, lcode, rcode, rt_d, lo_d, hi_d, n_codes,
                                tp, aggs)
        if res is not None:
            last_profile["engine"] = "dist-wjoin"
            return res
    last_profile["engine"] = "device-wjoin"
    # (code, time - tmin, tie) as one i64 sort key where it fits; a null
    # right time lies outside the stats range, so it keeps two keys
    pack = None
    if not dev.column_has_null(time_r):
        rlo, rhi = dev.column_range(time_r)
        lmin, lmax, hmin, hmax = _k_bounds4(lo_d, hi_d)
        tmin = min(int(rlo), lmin, hmin)
        tbits = max((max(int(rhi), lmax, hmax) - tmin).bit_length(), 1)
        if max(n_codes.bit_length(), 1) + tbits + 2 <= 62:
            pack = (tmin, tbits)
    sr, li, ri, ok = _boundary_core(lcode, rcode, rt_d, lo_d, hi_d,
                                    n_codes, tp, pack)

    gathered: dict = {}

    def sorted_col(col):
        """A right column in the sorted right order, gathered once."""
        if id(col) not in gathered:
            gathered[id(col)] = dev.dev_col(col).index_select(0, sr)
        return gathered[id(col)]

    span = _span_of(li, ri, ok)

    def lane(op, c, t):
        with prof.span("engine: wjoin"):
            return _aggregate(op, t, None if op == "count" else
                              sorted_col(c), li, ri, ok, span)
    return {out_sid: _lazy(
        _out_type(name, rtype), lambda op=name, c=rcol, t=rtype: lane(
            op, c, t), nl, _out_domain(name, rcol))
        for out_sid, name, rcol, rtype in aggs}
