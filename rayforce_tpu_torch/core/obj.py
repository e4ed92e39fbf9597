"""The universal value object.

The reference models every value as a 32-byte refcounted `obj_t` header with
inline data (core/rayforce.h:112-133). In rayforce-tpu a value is a slim
Python `Obj` whose payload is:

- atoms: a Python/numpy scalar (`t` negative),
- simple vectors: a numpy ndarray on host or a torch tensor on device
  (the compute path keeps big columns device-resident),
- LIST: a Python list of Obj,
- DICT: (keys Obj, vals Obj),
- TABLE: (colnames Obj(SYMBOL vec), cols list[Obj]),
- ENUM: payload is the int64 index array, `.domain` holds the symbol domain,
- LAMBDA / builtins: function payloads.

Refcounting/COW has no analogue: Python GC and functional (immutable-ish)
updates replace it. Mutation of tables goes through copy-on-write helpers in
ops/update.py.
"""
from __future__ import annotations

from typing import Any

import numpy as np

from . import profiler
from . import symbols
from . import types as T
from .errors import err_type


class DevPending:
    """Lazily-materialized device payload. Holds either a torch tensor
    or a thunk that will produce one (so even the device dispatch is
    deferred); the host numpy copy is made only when the host actually
    touches the values. Query results that stay on device (device
    selects feeding further selects) never pay the transfer."""

    __slots__ = ("shape", "_arr", "_thunk")

    def __init__(self, arr=None, thunk=None, shape=None):
        self._arr = arr
        self._thunk = thunk
        self.shape = tuple(arr.shape) if arr is not None else shape

    @property
    def arr(self):
        if self._arr is None:
            tok = profiler.begin("gather")
            try:
                self._arr = self._thunk()
            finally:
                profiler.end(tok)
            self._thunk = None
        return self._arr

    def materialize(self) -> np.ndarray:
        return profiler.host("obj.materialize", self.arr.cpu).numpy()


class DevPendingSliced(DevPending):
    """A device lane with capacity rows beyond its logical length
    (group-by outputs are computed into static NCAP-sized buffers; the
    real group count ng is dynamic). Host materialization slices the
    already-computed full lane with numpy — NO extra device ops — and
    device consumers get a lazily-dispatched device slice."""

    __slots__ = ("_full",)

    def __init__(self, full, n: int):
        super().__init__(thunk=lambda: full[:n], shape=(n,))
        self._full = full

    def materialize(self) -> np.ndarray:
        return profiler.host("obj.materialize",
                             self._full.cpu).numpy()[: self.shape[0]]


class ConstPending(DevPending):
    """MAPCOMMON-style constant column: one value + a row count
    (reference core/vary.c:185-391 represents the virtual Date/Id
    partition columns this way instead of materializing per-row
    vectors). Materializes to np.full only when the host actually
    touches the rows."""

    __slots__ = ("value", "dtype")

    def __init__(self, value, n: int, dtype):
        super().__init__(thunk=lambda: _const_dev(value, n, dtype),
                         shape=(n,))
        self.value = value
        self.dtype = dtype

    def materialize(self) -> np.ndarray:
        return np.full(self.shape[0], self.value, dtype=self.dtype)


def _const_dev(value, n, dtype):
    import torch
    from ..engine.device import device
    from ..engine.exprc import torch_dtype
    return torch.full((n,), value, dtype=torch_dtype(dtype),
                      device=device())


class DevPendingList(DevPending):
    """Right-only join column with unmatched rows: the device holds
    (gathered values, has_match); host materialization boxes them into
    the reference's LIST of typed atoms with untyped Nulls for
    unmatched rows (core/join.c:38-66)."""

    __slots__ = ("elem_t", "elem_domain")

    def __init__(self, thunk, shape, elem_t, domain=None):
        super().__init__(thunk=thunk, shape=shape)
        self.elem_t = elem_t
        self.elem_domain = domain

    def materialize(self):
        vals, has = (profiler.host("obj.materialize", x.cpu).numpy()
                     for x in self.arr)
        t = self.elem_t
        if t == T.ENUM:
            return [enum_atom(self.elem_domain, int(v)) if m
                    else NULL_OBJ for v, m in zip(vals, has)]
        return [Obj(-t, v) if m else NULL_OBJ
                for v, m in zip(vals, has)]


class Obj:
    __slots__ = ("t", "_v", "attrs", "domain", "meta")

    def __init__(self, t: int, v: Any, attrs: int = 0, domain=None, meta=None):
        self.t = t
        self._v = v
        self.attrs = attrs
        self.domain = domain  # ENUM: symbol-domain Obj; MAPGROUP: group index
        self.meta = meta      # scratch (e.g. parted partition info)

    @property
    def v(self):
        v = self._v
        if isinstance(v, DevPending):
            v = v.materialize()
            self._v = v
        return v

    @v.setter
    def v(self, val):
        self._v = val

    def pending(self):
        """The un-materialized DevPending payload, or None."""
        v = self._v
        return v if isinstance(v, DevPending) else None

    # -- convenience ---------------------------------------------------
    def is_atom(self) -> bool:
        return self.t < 0

    def __len__(self) -> int:
        t = self.t
        if t < 0:
            raise err_type("len of atom")
        if isinstance(self._v, DevPending):  # no materialize for len
            return int(self._v.shape[0])
        if t == T.LIST:
            return len(self.v)
        if t == T.TABLE:
            cols = self.v[1]
            return 0 if not cols else obj_len(cols[0])
        if t == T.DICT:
            return obj_len(self.v[0])
        if t in T.UNPARTED_OF:
            return int(sum(len(p) for p in self.v))
        if t == T.GUID:
            return self.v.shape[0]
        return int(self.v.shape[0])

    def __repr__(self):
        from . import fmt
        try:
            return fmt.format_obj(self)
        except Exception:
            return f"<Obj t={self.t}>"


def obj_len(o: Obj) -> int:
    return len(o)


# ---------------------------------------------------------------------------
# Atom constructors
# ---------------------------------------------------------------------------

def b8(x) -> Obj:
    return Obj(-T.B8, np.int8(1 if x else 0))


def u8(x) -> Obj:
    return Obj(-T.U8, np.uint8(x))


def i16(x) -> Obj:
    return Obj(-T.I16, np.int16(x))


def i32(x) -> Obj:
    return Obj(-T.I32, np.int32(x))


def i64(x) -> Obj:
    return Obj(-T.I64, np.int64(x))


def f64(x) -> Obj:
    return Obj(-T.F64, np.float64(x))


def c8(x) -> Obj:
    if isinstance(x, str):
        x = x.encode()[0] if x else 0
    return Obj(-T.C8, np.uint8(x))


def sym(name_or_id) -> Obj:
    if isinstance(name_or_id, str):
        return Obj(-T.SYMBOL, np.int64(symbols.intern(name_or_id)))
    return Obj(-T.SYMBOL, np.int64(name_or_id))


def sym_null() -> Obj:
    return Obj(-T.SYMBOL, T.NULL_I64)


def date(days) -> Obj:
    return Obj(-T.DATE, np.int32(days))


def time_(ms) -> Obj:
    return Obj(-T.TIME, np.int32(ms))


def timestamp(ns) -> Obj:
    return Obj(-T.TIMESTAMP, np.int64(ns))


def guid(b: bytes) -> Obj:
    return Obj(-T.GUID, np.frombuffer(bytes(b), dtype=np.uint8).copy())


def null() -> Obj:
    return Obj(-T.NULL, None)


NULL_OBJ = null()


def atom_null(t: int) -> Obj:
    """Typed null atom for simple type `t` (positive code)."""
    if t == T.F64:
        return f64(T.NULL_F64)
    if t == T.SYMBOL:
        return sym_null()
    if t == T.GUID:
        return Obj(-T.GUID, np.zeros(16, dtype=np.uint8))
    if t in T.NULL_BY_TYPE:
        return Obj(-t, T.NULL_BY_TYPE[t])
    if t == T.C8:
        return Obj(-T.C8, np.uint8(32))  # ' ' is the C8 null
    if t == T.B8:
        return Obj(-T.B8, np.int8(0))
    if t == T.U8:
        return Obj(-T.U8, np.uint8(0))
    return null()


# ---------------------------------------------------------------------------
# Vector constructors
# ---------------------------------------------------------------------------

def vector(t: int, data) -> Obj:
    """Simple typed vector from array-like; dtype enforced per the type map."""
    if t == T.GUID:
        arr = np.asarray(data, dtype=np.uint8).reshape(-1, 16)
        return Obj(T.GUID, arr)
    arr = np.asarray(data, dtype=T.DTYPE[t])
    return Obj(t, arr)


def vec_i64(data) -> Obj:
    return vector(T.I64, data)


def vec_f64(data) -> Obj:
    return vector(T.F64, data)


def vec_b8(data) -> Obj:
    return vector(T.B8, data)


def vec_sym(names) -> Obj:
    ids = np.fromiter((symbols.intern(n) for n in names), dtype=np.int64,
                      count=len(names))
    return Obj(T.SYMBOL, ids)


def string(s) -> Obj:
    if isinstance(s, str):
        s = s.encode("utf-8")
    return Obj(T.C8, np.frombuffer(bytes(s), dtype=np.uint8).copy())


def str_of(o: Obj) -> str:
    """Python str from a C8 vector or symbol atom."""
    if o.t == T.C8:
        return to_np(o).tobytes().decode("utf-8", errors="replace")
    if o.t == -T.C8:
        return chr(int(o.v))
    if o.t == -T.SYMBOL:
        if int(o.v) == int(T.NULL_I64):
            return ""
        return symbols.name_of(int(o.v))
    raise err_type("expected string")


def list_(items) -> Obj:
    return Obj(T.LIST, list(items))


def dict_(keys: Obj, vals: Obj) -> Obj:
    return Obj(T.DICT, (keys, vals))


def table(colnames: Obj, cols: list) -> Obj:
    return Obj(T.TABLE, (colnames, cols))


def enum(domain: Obj, ids) -> Obj:
    return Obj(T.ENUM, np.asarray(ids, dtype=np.int64), domain=domain)


def enum_atom(domain: Obj, idx: int) -> Obj:
    return Obj(-T.ENUM, np.int64(idx), domain=domain)


# ---------------------------------------------------------------------------
# Host/device transparency
# ---------------------------------------------------------------------------

def enum_domain(o: Obj) -> "Obj":
    """Resolve an enum's symbol domain: either held directly (internal) or
    named by a global symbol (reference enumerate/compose.c:389)."""
    d = o.domain
    if d is None:
        raise err_type("enum without domain")
    if d.t == T.SYMBOL:
        return d
    if d.t == -T.SYMBOL:
        from .interp import current_interp
        ip = current_interp()
        dom = ip.resolve(int(d.v)) if ip else None
        if dom is None or dom.t != T.SYMBOL:
            raise err_type("enum domain not resolvable")
        return dom
    raise err_type("bad enum domain")


def to_np(o: Obj) -> np.ndarray:
    """Materialize the vector payload as a host numpy array."""
    v = o.v
    if isinstance(v, np.ndarray):
        return v
    return np.asarray(v)


def payload_len(o: Obj) -> int:
    return int(o.v.shape[0])


# ---------------------------------------------------------------------------
# Nulls
# ---------------------------------------------------------------------------

def is_null_scalar(t: int, v) -> bool:
    """t is the positive simple type."""
    if t == T.F64:
        return bool(np.isnan(v))
    if t in T.NULL_BY_TYPE:
        return int(v) == int(T.NULL_BY_TYPE[t])
    if t == T.GUID:
        return not np.any(v)
    if t == T.C8:
        return int(v) == 32
    return False


def null_mask(o: Obj) -> np.ndarray:
    """Boolean mask of nulls for a simple vector."""
    a = to_np(o)
    t = abs(o.t)
    if t == T.F64:
        return np.isnan(a)
    if t in T.NULL_BY_TYPE:
        return a == T.NULL_BY_TYPE[t]
    if t == T.GUID:
        return ~a.any(axis=1)
    return np.zeros(len(a), dtype=bool)


# ---------------------------------------------------------------------------
# Generic element access (control-plane; hot gathers live in ops/)
# ---------------------------------------------------------------------------

def at_idx(o: Obj, i: int) -> Obj:
    """o[i] as an atom/element Obj. Negative indexing NOT allowed (matches
    reference at_idx which bounds-checks)."""
    t = o.t
    if t == T.LIST:
        return o.v[i]
    if t == T.DICT:
        return at_idx(o.v[1], i)
    if t == T.TABLE:
        names, cols = o.v
        row = [at_idx(c, i) for c in cols]
        return dict_(names, list_(row))
    if t == T.ENUM:
        return enum_atom(o.domain, int(to_np(o)[i]))
    if t == T.GUID:
        return Obj(-T.GUID, to_np(o)[i])
    if t in T.UNPARTED_OF:
        from ..ops.parted import parted_at_idx
        return parted_at_idx(o, i)
    if T.is_vector(t):
        return Obj(-t, to_np(o)[i])
    raise err_type("at_idx on non-indexable")


def elements(o: Obj):
    """Iterate elements of any vector-like as Objs."""
    n = len(o)
    for i in range(n):
        yield at_idx(o, i)


def table_cols(o: Obj):
    names, cols = o.v
    return names, cols


def col_by_name(tbl: Obj, name: str):
    names, cols = tbl.v
    sid = symbols.intern(name)
    ids = to_np(names)
    hits = np.nonzero(ids == sid)[0]
    if len(hits) == 0:
        return None
    return cols[int(hits[0])]


# ---------------------------------------------------------------------------
# Tables from numpy columns
# ---------------------------------------------------------------------------

_VEC_TYPE = {n.upper(): t for t, n in T.TYPE_NAMES.items()
             if 0 < t < T.ENUM and t != T.GUID}


def table_from_numpy(names, arrays, types) -> Obj:
    """A table from numpy columns and their Rayfall vector type names
    ("I64", "F64", "SYMBOL", ...). A SYMBOL column holds the symbol
    NAMES (str); they are interned in this package's symbol table, so
    only the names carry across packages, never the ids."""
    cols = []
    for a, tn in zip(arrays, types):
        t = _VEC_TYPE[tn.upper()]
        if t == T.SYMBOL:
            uniq, inv = np.unique(np.asarray(a, dtype=object).astype(str),
                                  return_inverse=True)
            ids = np.fromiter((symbols.intern(s) for s in uniq),
                              dtype=np.int64, count=len(uniq))
            cols.append(Obj(T.SYMBOL, ids[inv.reshape(-1)]))
        else:
            cols.append(vector(t, a))
    return table(vec_sym(list(names)), cols)
