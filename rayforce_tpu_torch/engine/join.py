"""Device joins: sort-merge left, inner and asof joins over
device-resident columns.

The reference C engine builds a hash table on the right table's key
rows and probes it per left row (core/index.c:2886-2998 left/inner,
:3194-3266 asof). The device plan is a sort-merge with the same
semantics:

  codes = dense joint i64 codes of the key columns (one null slot)
  comb  = concat(right codes, left codes)          # rights first
  sort  = one stable sort of comb (or of (code, time)) through the
          psort entry, which also returns its permutation
  match = segmented prefix min / max of the right positions:
          per left row the FIRST right row with equal keys (left and
          inner joins, the reference's find-first probe), or the LAST
          right row at or before its time (asof)
  ids   = one scatter of the matches back to the left rows

Every sort goes through `psort.sort_lex`, so on the card through the
CUDA radix sort. The sort is stable and returns its own permutation, so
no row position rides in the key and no second sort undoes the first,
as the TPU package needs (it packs the position into the key and
unsorts with a second sort, having neither a cheap stable sort nor a
fast scatter).

Match ids stay on the device. The output columns are lazy (core.obj
DevPending thunks): nothing is gathered until a column is read.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..core import profiler as prof
from ..core import types as T
from ..core.obj import DevPending, DevPendingList, Obj, enum_domain
from . import device as dev
from . import groupby as G
from . import psort

_MAXC = 1 << 62
_PACKABLE = (T.B8, T.U8, T.I16, T.I32, T.I64, T.DATE, T.TIME,
             T.TIMESTAMP, T.SYMBOL)
_DEV_COL_OK_SORT = _PACKABLE + (T.F64, T.ENUM)
NULL = int(T.NULL_I64)
I64 = torch.int64

# which join engine ran last ("device-sortmerge", or on a mesh
# "dist-bcast-probe", "dist-eq" or "dist-asof"), as the reference
# records it
last_profile: dict = {}


def _key_ranges(lkeys, rkeys):
    """Joint (lo, rng, nullable) per key pair from the cached column
    stats; None when the pair cannot be packed into a shared dense i64
    code. A nullable key gets a code slot of its own (rng - 1): NULL
    matches NULL like any value (the reference's find probe), and the
    null rows never alias a real key combination."""
    metas = []
    total = 1
    for lc, rc in zip(lkeys, rkeys):
        if lc.t == T.ENUM or rc.t == T.ENUM:
            # comparable only when both enums share the domain object
            if lc.t != T.ENUM or rc.t != T.ENUM or \
                    lc.domain is not rc.domain:
                return None
            lo, hi = 0, max(len(enum_domain(lc)) - 1, 0)
        elif lc.t in _PACKABLE and lc.t == rc.t:
            llo, lhi = dev.column_range(lc)
            rlo, rhi = dev.column_range(rc)
            lo, hi = min(llo, rlo), max(lhi, rhi)
        else:
            return None
        nullable = dev.column_has_null(lc) or dev.column_has_null(rc)
        rng = hi - lo + 1 + (1 if nullable else 0)
        if rng <= 0:
            return None
        total *= rng
        if total > _MAXC:
            return None
        metas.append((lo, rng, nullable))
    return metas


def _pack_codes(cols, metas):
    """Dense i64 codes in [0, prod(rng)) of the key columns. The null
    sentinel is compared in the column's own dtype, as the reference
    does."""
    code = None
    for c, (lo, rng, nullable) in zip(cols, metas):
        x = dev.dev_col(c)
        a = x.to(I64) - lo
        if nullable:
            nv = T.NULL_BY_TYPE.get(T.SYMBOL if c.t == T.ENUM else c.t,
                                    T.NULL_I64)
            nv = np.int64(nv).astype(T.DTYPE[c.t]).item()
            a = torch.where(x == nv, rng - 1, a)
        code = a if code is None else code * rng + a
    return code


def _match(lcode, rcode, ltime, rtime, mode, time_pack):
    """Per left row, the matching right row id (i64, NULL_I64 where
    none). The keys are (code), or (code, time) for asof: one i64 key
    (code << (tbits + 1)) | (time - tmin) << 1 | is_left where
    `time_pack` = (tmin, tbits) is given, else two keys. Rights come
    first in the concatenation and the sort is stable, so within equal
    keys every right row precedes every left row: a right row at
    exactly the left row's time matches (the side bit says the same
    thing in the packed key)."""
    n_l, n_r = int(lcode.shape[0]), int(rcode.shape[0])
    n = n_l + n_r
    comb = torch.cat([rcode, lcode])
    if ltime is not None:
        tcomb = torch.cat([rtime.to(I64), ltime.to(I64)])
    if time_pack is not None:
        tmin, tbits = time_pack
        side = (torch.arange(n, device=comb.device) >= n_r).to(I64)
        keys = [(comb.to(I64) << (tbits + 1)) | ((tcomb - tmin) << 1) |
                side]
    elif ltime is not None:
        keys = [comb, tcomb]
    else:
        keys = [comb]
    skeys, _, perm = psort.sort_lex(keys, perm=True)
    scode = skeys[0] >> (time_pack[1] + 1) if time_pack is not None \
        else skeys[0]
    spos = perm.to(I64)
    is_right = spos < n_r
    if mode == "first":
        m = G.seg_doubling_min(scode, torch.where(is_right, spos,
                                                  G.KEY_MAX))
        none = m == G.KEY_MAX
    else:
        m = G.seg_doubling_max(scode, torch.where(is_right, spos, -1))
        none = m < 0
    # back to row order by one scatter; the right rows are written too,
    # so that every write has an address of its own
    out = torch.empty(n, dtype=I64, device=comb.device)
    out.scatter_(0, spos, torch.where(none, NULL, m))
    return out[n_r:]


def match_ids_device(lkeys, rkeys, ltime=None, rtime=None, mode="first"):
    """Per-left-row right match ids (an i64 device tensor, NULL_I64 where
    none), or None when the keys cannot be coded. mode 'first': the
    first right row with equal keys (left and inner joins); 'asof': the
    last right row at or before the left time within equal keys."""
    with prof.span("engine: asof" if mode == "asof" else
                   "engine: sortmerge"):
        return _match_ids(lkeys, rkeys, ltime, rtime, mode)


def _match_ids(lkeys, rkeys, ltime, rtime, mode):
    if not lkeys:
        if ltime is None:
            return None
        # pure temporal asof: every row in one group
        d = dev.device()
        lcode = torch.zeros(len(ltime), dtype=I64, device=d)
        rcode = torch.zeros(len(rtime), dtype=I64, device=d)
        total = 1
    else:
        metas = _key_ranges(lkeys, rkeys)
        if metas is None:
            return None
        lcode = _pack_codes(lkeys, metas)
        rcode = _pack_codes(rkeys, metas)
        total = math.prod(rng for _lo, rng, _nb in metas)
    m = dev.mesh()
    if m is not None and mode == "first" and ltime is None:
        rids = None
        if int(rcode.shape[0]) > dev._cfg["bcast_max"]:
            # a right side too big to replicate stays sharded: both
            # sides route by key and each shard probes its partition
            rids = _mesh_eq(m, lcode, rcode)
            engine = "dist-eq"
        if rids is None:
            rids = _mesh_bcast(m, lcode, rcode)
            engine = "dist-bcast-probe"
        last_profile.clear()
        last_profile["engine"] = engine
        return rids
    if m is not None and mode == "asof" and lkeys:
        rids = _mesh_asof(m, lcode, rcode, ltime, rtime, total)
        if rids is not None:
            last_profile.clear()
            last_profile["engine"] = "dist-asof"
            return rids
    time_pack = None
    if mode == "asof" and not (dev.column_has_null(ltime) or
                               dev.column_has_null(rtime)):
        # (code, time, side) in one i64 key where it fits 62 bits; the
        # codes lie in [0, total) with or without null keys, but a null
        # time lies outside the stats range
        llo, lhi = dev.column_range(ltime)
        rlo, rhi = dev.column_range(rtime)
        tmin = int(min(llo, rlo))
        tb = max(int(max(lhi, rhi) - tmin).bit_length(), 1)
        if max(total.bit_length(), 1) + tb + 1 <= 62:
            time_pack = (tmin, tb)
    if time_pack is None and total <= 1 << 31:
        # codes lie in [0, total): one i32 key word
        lcode, rcode = lcode.to(torch.int32), rcode.to(torch.int32)
    last_profile.clear()
    last_profile["engine"] = "device-sortmerge"
    if ltime is None:
        return _match(lcode, rcode, None, None, mode, None)
    return _match(lcode, rcode, dev.dev_col(ltime), dev.dev_col(rtime),
                  mode, time_pack)


# -- the mesh routes -----------------------------------------------------------
#
# With a mesh (RAYFORCE_MESH) the probes run over its row shards
# (parallel/dist.py), on the i64 codes: the broadcast-build probe, the
# partitioned-build probe for a right side over bcast_max rows, and the
# ring probe for asof. Each returns the i64 match ids, NULL_I64 where
# none, or None where the reference declines the shape too.

def _mesh_bcast(m, lcode, rcode):
    """The broadcast-build probe (dist_left_probe): the left codes
    row-sharded, the right codes replicated."""
    from ..parallel import dist
    n_l = int(lcode.shape[0])
    rid, has = dist.dist_left_probe(m)(dist.shard_rows(m, lcode, -1)[0],
                                       rcode)
    return torch.where(dist.unshard(has, n_l), dist.unshard(rid, n_l), NULL)


def _mesh_eq(m, lcode, rcode):
    """The partitioned-build probe (dist_eq_probe) with capacity retry:
    each capacity that overflowed doubles (the return one up to a
    shard's rows). None past 2^31 padded rows, where the i32 row ids
    that ride the exchange would wrap."""
    from ..parallel import dist
    n_dev = m.n
    n_l, n_r = int(lcode.shape[0]), int(rcode.shape[0])
    rows_l, rows_r = -(-n_l // n_dev), -(-n_r // n_dev)
    if n_dev * rows_l >= 2**31 or n_dev * rows_r >= 2**31:
        return None
    lp = dist.shard_rows(m, lcode, -1)[0]
    rp = dist.shard_rows(m, rcode, -1)[0]
    caps = [max(2 * rows_l // n_dev, 64), max(2 * rows_r // n_dev, 64),
            max(2 * rows_l // n_dev, 64)]
    while True:
        ovf_l, ovf_r, ovf_b, rid, has = dist.dist_eq_probe(
            m, n_l, caps[0], caps[1], cap_b=caps[2])(lp, rp)
        o_l, o_r, o_b = prof.host("join.overflow", torch.cat(
            [ovf_l, ovf_r, ovf_b]).tolist)
        if not (o_l or o_r or o_b):
            return torch.where(dist.unshard(has, n_l),
                               dist.unshard(rid, n_l), NULL)
        if o_l:
            caps[0] *= 2
        if o_r:
            caps[1] *= 2
        if o_b:
            caps[2] = min(caps[2] * 2, rows_l)


def _mesh_asof(m, lcode, rcode, ltime, rtime, code_bound):
    """The ring probe (dist_asof_probe); the matched right row ids ride
    as exact f64 payloads. None where (code, time - tmin) does not fit
    the probe's packed key: codes and the time span below 2^31."""
    from ..parallel import dist
    try:
        llo, lhi = dev.column_range(ltime)
        rlo, rhi = dev.column_range(rtime)
    except Exception as e:
        if dev.is_fault(e):
            raise
        return None
    tmin = int(min(int(llo), int(rlo)))
    tspan = int(max(int(lhi), int(rhi))) - tmin
    if tspan >= (1 << 31) or tspan < 0 or code_bound >= (1 << 31):
        return None
    n_l, n_r = int(lcode.shape[0]), int(rcode.shape[0])
    lt = dev.dev_col(ltime).to(I64) - tmin
    rt_ = dev.dev_col(rtime).to(I64) - tmin
    rv = torch.arange(n_r, dtype=torch.float64, device=rcode.device)
    val, hit = dist.dist_asof_probe(m)(
        dist.shard_rows(m, lcode, -1)[0], dist.shard_rows(m, lt, 0)[0],
        dist.shard_rows(m, rcode, -1)[0], dist.shard_rows(m, rt_, 0)[0],
        dist.shard_rows(m, rv, math.nan)[0])
    return torch.where(dist.unshard(hit, n_l),
                       dist.unshard(val, n_l).to(I64), NULL)


# -- lazy output columns ------------------------------------------------------

def _wrap(thunk, n, col: Obj, out_t: int) -> Obj:
    o = Obj(out_t, DevPending(thunk=thunk, shape=(n,)), domain=col.domain)
    o.meta = {}
    return o


def _gather(col: Obj, rids):
    src = dev.dev_col(col)
    return src.index_select(0, rids.clamp(0, src.shape[0] - 1))


def lazy_gather_col(col: Obj, rids, fill_left: Obj | None, n_out: int,
                    out_t: int | None = None) -> Obj:
    """The right column at the match ids, overlaid on the left column
    (right value on a match, left otherwise; join.c:83), deferred."""
    t = col.t if out_t is None else out_t

    def thunk():
        g = _gather(col, rids)
        if fill_left is not None:
            g = torch.where(rids != NULL, g, dev.dev_col(fill_left))
        return g

    return _wrap(thunk, n_out, col, t)


def lazy_take_col(col: Obj, ids, n_out: int) -> Obj:
    """The column at row ids (inner-join rows, a table sort's order),
    deferred."""
    return _wrap(lambda: dev.dev_col(col).index_select(0, ids), n_out, col,
                 col.t)


def lazy_right_only_col(col: Obj, rids, n_out: int) -> Obj:
    """A right-only column with unmatched rows: a LIST of typed atoms and
    untyped nulls (join.c:38-66), whose values and match mask stay on
    the device until it is read."""
    return Obj(T.LIST, DevPendingList(
        lambda: (_gather(col, rids), rids != NULL), (n_out,), col.t,
        col.domain))


def all_matched(rids) -> bool:
    """Whether every left row matched (one scalar fetch)."""
    return prof.host("join.all_matched", bool, (rids != NULL).all())


def compact_ids(rids):
    """(lids, rsel, n_match): the matched left rows in left order and
    their right rows, for the inner join. One ordered stream compaction;
    learning its length is the one host fetch."""
    lids = prof.host("join.compact", torch.nonzero, rids != NULL).squeeze(1)
    return lids, rids.index_select(0, lids), int(lids.shape[0])
