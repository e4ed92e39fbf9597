"""The grouped select's aggregate contract, one owner for the four
engines that run it: the dense plan (engine/select.py), engine/sortagg.py,
engine/wide.py and engine/dgroup.py. Each engine keeps its own mechanism
(the dense pass, the packed-key sort, the key words, the mesh's lanes);
what the aggregates become is decided here:

- column slots: a plan's compiled where, keys and aggregates over one
  deduplicated column list (`Slots`);
- aggregate needs: whether a column may hold nulls (`may_null`) and the
  ops each aggregated expression needs (`col_needs`);
- sort operands: how an aggregated column rides a sort and is read back
  after it (`operand_kind`, `operand`, `from_operand`, `skip_nulls`,
  `null_fill`);
- the finish rules (oracle-pinned against the reference binary, the
  host kernels' semantics): all-null groups give min the typed INF of a
  plain column and max or a derived expression's min the typed NULL
  (`minmax_nulls`); a grouped sum of a plain column propagates nulls
  (`sum_propagates`, `sum_nulls`); avg, med and dev skip them and divide
  by the non-null count (`avg`, `median`, `stddev`);
- the result schema: each aggregate's result type (`result_type`), the
  key codes in mixed radix and back (`key_codes`, `mixed_codes`,
  `key_values`), and the result table (`key_obj`, `agg_obj`,
  `result_table`, `lanes_table`).
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import types as T
from ..core.obj import Obj, table, DevPendingSliced
from . import device as dev
from .exprc import as_tensor, torch_dtype
from .groupby import I64_MIN, KEY_MAX

I32, I64, F64 = torch.int32, torch.int64, torch.float64

INT_LIKE = (T.B8, T.U8, T.I16, T.I32, T.I64, T.DATE, T.TIME,
            T.TIMESTAMP, T.SYMBOL)
# types whose values (and null) fit an i32 lane
NARROW32 = (T.B8, T.U8, T.I16, T.I32, T.DATE, T.TIME)
# an integer sum's result type (host parity: ops/math.py SUM_TYPE,
# oracle-pinned)
SUM_OUT = {T.U8: T.I64, T.I16: T.I64, T.I32: T.I32, T.I64: T.I64}


def tdt(rt):
    """The torch dtype of type rt's values."""
    return torch_dtype(T.DTYPE[rt])


def dt_null(rt):
    """Type rt's null sentinel, or None for a type with none."""
    return T.NULL_BY_TYPE.get(rt)


# -- column slots -----------------------------------------------------------

class Slots:
    """A plan's columns: each compiled expression (where, key, aggregate
    inner) mapped onto one deduplicated column list, `cols` (the plan's
    col_objs, uploaded in this order), in the order the expressions are
    added."""

    def __init__(self, cw, key_cs, exprs=()):
        self.cols: list = []
        self._slot: dict = {}   # id(column) -> slot
        self.of: dict = {}      # id(expr) -> the slots of its columns
        for ck in ([cw] if cw is not None else []) + list(key_cs) + \
                list(exprs):
            self._add(ck)

    def _add(self, ck):
        if id(ck) not in self.of:
            mapping = []
            for ref in ck.cols:
                key = id(ref.col)
                if key not in self._slot:
                    self._slot[key] = len(self.cols)
                    self.cols.append(ref.col)
                mapping.append(self._slot[key])
            self.of[id(ck)] = mapping
        return self.of[id(ck)]

    def eval(self, ck, cols):
        """Compiled expression ck over the plan's column tensors."""
        return as_tensor(ck.fn([cols[i] for i in self.of[id(ck)]]))


# -- aggregate needs --------------------------------------------------------

def may_null(a) -> bool:
    """False only for a plain column whose cached stats prove it
    null-free, which lets a plan drop its null work."""
    if not a.meta.get("plain_col"):
        return True
    try:
        return dev.column_has_null(a.inner.cols[0].col)
    except Exception as e:
        if dev.is_fault(e):
            raise
        return True


def col_needs(aggs) -> dict:
    """Per aggregated expression (by identity, in first-use order): its
    result type (`rtype`), the expression (`agg`), whether it is a plain
    column (`plain`) and the ops its aggregates read after the sort
    (`ops`: "sum" for sum and avg, "min", "max", "med", "dev", and "null"
    where it may hold nulls). count, first and last read none."""
    cinfo: dict = {}
    for a in aggs:
        ci = cinfo.setdefault(id(a.inner), {
            "rtype": a.inner.rtype, "ops": set(), "agg": a.inner,
            "plain": a.meta.get("plain_col", False)})
        if a.name in ("count", "first", "last"):
            continue
        ci["ops"].add("sum" if a.name in ("sum", "avg") else a.name)
        if may_null(a):
            ci["ops"].add("null")
    return cinfo


# -- sort operands ----------------------------------------------------------

def operand_kind(ci):
    """How a column of `col_needs` rides a sort: "f64"; ("q32", scale)
    for a plain f64 column on a decimal grid (engine/device.py qscale
    stat), an exact i32 of half the sorted bytes; "i32" for a narrow type
    or a null-free plain column whose range fits; else "i64"."""
    rt = ci["rtype"]
    if rt == T.F64:
        if ci["plain"]:
            qs = dev.column_qscale(ci["agg"].cols[0].col)
            if qs:
                return ("q32", float(qs))
        return "f64"
    if rt in NARROW32:
        return "i32"
    if ci["plain"] and "null" not in ci["ops"]:
        lo, hi = dev.column_range(ci["agg"].cols[0].col)
        if -(1 << 31) < lo and hi < (1 << 31):
            return "i32"
    return "i64"


def operands(cinfo, packed=()):
    """The sort operands: (cid, kind) in cid order for each column read
    after the sort (a med alone sorts on its own; a `packed` column
    rides in the key), and each cid's operand index."""
    out, ix = [], {}
    for cid in sorted(cinfo):
        if cid in packed or not cinfo[cid]["ops"] - {"med"}:
            continue
        ix[cid] = len(out)
        out.append((cid, operand_kind(cinfo[cid])))
    return out, ix


def operand(x, kind):
    """Column values x cast to ride the sort as `kind`."""
    if kind == "f64":
        return x.to(F64)
    if isinstance(kind, tuple):     # ("q32", scale)
        rq = torch.round(x * kind[1])
        return torch.where(torch.isnan(x), int(T.NULL_I32), rq.to(I32))
    return x.to(I32 if kind == "i32" else I64)


def from_operand(v, kind, rt):
    """A sorted operand read back: (values, null mask or None where the
    type has no null); f64 values for an f64 column (NaN nulls), i64
    for an integer one."""
    if isinstance(kind, tuple):
        v = torch.where(v == int(T.NULL_I32), np.nan, v.to(F64) / kind[1])
    if rt == T.F64:
        return v, torch.isnan(v)
    # widen first: an i64 column riding as i32 must not meet its null
    # sentinel wrapped to i32 (0)
    v = v.to(I64)
    nv = dt_null(rt)
    return v, ((v == int(nv)) if nv is not None else None)


def null_mask(x, rt):
    """The nulls of typed values x (NaN for f64; an integer null
    compared widened, as torch would wrap the i64 sentinel to a narrower
    dtype)."""
    if rt == T.F64:
        return torch.isnan(x)
    nv = dt_null(rt)
    if nv is None:
        return torch.zeros(x.shape, dtype=torch.bool, device=x.device)
    return x.to(I64) == int(nv)


_IDENTITY = {"sum": (0.0, 0), "min": (np.inf, KEY_MAX),
             "max": (-np.inf, I64_MIN)}


def null_fill(op, f64):
    """The identity of op ("sum", "min", "max") that a null takes in f64
    values (`f64`) or in integers widened to i64."""
    return _IDENTITY[op][0 if f64 else 1]


def skip_nulls(v, nul, op):
    """v (f64, or integers widened to i64) with its nulls replaced by the
    identity of op ("sum", "min", "max"), so a reduction skips them."""
    if nul is None:
        return v
    return torch.where(nul, null_fill(op, v.dtype == F64), v)


# -- the finish rules -------------------------------------------------------

def minmax_nulls(v, empty, a, rt):
    """A min/max lane with its all-null groups (`empty`, or None where
    the column has no null) filled: a plain column's grouped min keeps
    the typed INF it starts from (aggr.c:1241); max, and min of a derived
    expression (per-group whole-vector semantics, math.c fold), give the
    typed NULL. v holds an f64 column's values (a plain min's all-null
    groups are +inf already) or an integer column's, in any int dtype."""
    if empty is None:
        return v
    if a.name == "min" and a.meta.get("plain_col"):
        if rt == T.F64:
            return v
        fill = int(np.iinfo(T.DTYPE[rt]).max)
    else:
        fill = np.nan if rt == T.F64 else \
            int(T.NULL_BY_TYPE.get(rt, T.NULL_I64))
    return torch.where(empty, fill, v)


def sum_propagates(a, nullable, grouped=True) -> bool:
    """Whether sum a propagates nulls: a grouped sum of a PLAIN nullable
    column does (the fused FN_AGGR path, aggr.c ADD accumulators); a
    derived expression's per-group sum and a no-by select's whole-vector
    sum skip them (oracle-pinned)."""
    return nullable and grouped and bool(a.meta.get("plain_col"))


def sum_nulls(s, nulls, rt):
    """Sum lane s (torch or numpy) of a sum that propagates nulls: the
    typed null of its result type where the group's null count (or
    any-null flag) `nulls` is above 0."""
    fill = np.nan if rt == T.F64 else \
        int(T.NULL_BY_TYPE.get(SUM_OUT.get(rt, T.I64), T.NULL_I64))
    where = np.where if isinstance(s, np.ndarray) else torch.where
    return where(nulls > 0, fill, s)


def avg(s, e):
    """Mean of sum s over e non-null values; NaN (0Nf) where e is 0."""
    return torch.where(e == 0, np.nan, s / e)


def median(sv, starts, e, n, scale=None):
    """Each group's median from its values sorted within the group, nulls
    last (`sv`; a group's run begins at `starts`): the mean of the
    middle two of its e non-null values, divided by `scale` for values
    that rode quantized; NaN where e is 0."""
    lo_i = torch.clamp(starts + torch.clamp(e - 1, min=0) // 2, 0, n - 1)
    hi_i = torch.clamp(starts + e // 2, 0, n - 1)
    v = (sv[lo_i].to(F64) + sv[hi_i].to(F64)) / 2.0
    if scale:
        v = v / scale
    return torch.where(e == 0, np.nan, v)


def stddev(s, s2, e):
    """Standard deviation from shifted moments (s = sum of x - c, s2 =
    sum of (x - c)^2 over e non-null values); NaN where e is 0."""
    safe = torch.where(e == 0, 1.0, e)
    mean = s / safe
    var = s2 / safe - mean * mean
    v = torch.sqrt(torch.clamp(var, min=0.0))
    return torch.where(e == 0, np.nan, v)


# -- the result schema ------------------------------------------------------

def result_type(a):
    """The type of aggregate a's result column: count I64; first/last
    their column's type (an enum keeps its domain, `agg_obj`); min/max
    their own; avg, med, dev and an f64 sum F64; an integer sum
    SUM_OUT's."""
    rt = a.inner.rtype
    if a.name == "count":
        return T.I64
    if a.name in ("first", "last"):
        return a.inner.cols[0].col.t
    if a.name in ("min", "max"):
        return rt
    if a.name in ("avg", "med", "dev") or rt == T.F64:
        return T.F64
    return SUM_OUT.get(rt, T.I64)


def lane_name(a):
    return f"{a.name}:{a.sid}"


def key_codes(slots, cols, key_cs, key_meta, n, d, dtype=I32):
    """The dense group code of n rows in `dtype`: each key's offset from
    its least value in mixed radix, the first key most significant (all
    0 with no key). key_meta: (name, lo, rng, rtype, enum domain) a key."""
    return mixed_codes([slots.eval(ck, cols) for ck in key_cs],
                       [(lo, rng) for _nm, lo, rng, _rt, _dom in key_meta],
                       n, d, dtype)


def mixed_codes(keys, radix, n, d, dtype=I32):
    """`key_codes` of the evaluated key columns `keys`, each with its
    (least value, range) in `radix`."""
    codes = None
    for x, (lo, rng) in zip(keys, radix):
        cc = (x.to(d, I64) - int(lo)).to(dtype)
        codes = cc if codes is None else codes * int(rng) + cc
    if codes is None:
        codes = torch.zeros(n, dtype=dtype, device=d)
    return codes.expand(n)


def key_values(codes, key_meta):
    """Yields each key's values from mixed-radix codes (`key_codes`; a
    numpy array or a tensor), in the codes' dtype."""
    muls, m = [], 1
    for _nm, _lo, rng, _rt, _dom in reversed(key_meta):
        muls.append(m)
        m *= rng
    muls.reverse()
    for (_nm, lo, rng, _rt, _dom), mul in zip(key_meta, muls):
        yield (codes // mul) % rng + lo


def key_obj(km, payload):
    """Key column km's result column; its payload in T.DTYPE of its
    rtype (an enum key's rtype is SYMBOL: its codes ride as i64)."""
    _nm, _lo, _rng, rt, dom = km
    if dom is not None:
        return Obj(T.ENUM, payload, domain=dom)
    return Obj(rt, payload)


def agg_obj(a, payload):
    """Aggregate a's result column over its payload."""
    t = result_type(a)
    if t == T.ENUM:
        return Obj(t, payload, domain=a.inner.cols[0].col.domain)
    return Obj(t, payload)


def result_table(key_meta, aggs, cols):
    """The result table: key columns, then one column an aggregate."""
    names = [km[0] for km in key_meta] + [a.sid for a in aggs]
    return table(Obj(T.SYMBOL, np.asarray(names, dtype=np.int64)), cols)


def lanes_table(key_meta, aggs, lanes, ng):
    """The result table of device lanes named key{i} and `lane_name`, ng
    groups each, left on the device."""
    return result_table(key_meta, aggs, [
        key_obj(km, DevPendingSliced(lanes[f"key{i}"], ng))
        for i, km in enumerate(key_meta)] + [
        agg_obj(a, DevPendingSliced(lanes[lane_name(a)], ng))
        for a in aggs])
