"""AST -> torch expression compiler for the device select path.

Compiles a Rayfall where-clause / output expression over table columns
into a function of the column tensors. Supports the elementwise
operator core (arithmetic, comparisons, and/or/not, in/within, xbar,
casts) with the engine's typed-null semantics, and recognizes top-level
aggregates (sum/avg/min/max/count/first/last/med/dev) so select can fuse
filter+group+aggregate into device work.

Types follow numpy promotion on the operands' dtypes (what the JAX
package's jnp code computes); torch's own rule keeps a tensor's dtype
against a scalar, so each binary op casts both sides explicitly.

Unsupported constructs return None and the caller falls back to the
host interpreter — behavior is always identical, only the execution
engine differs.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import types as T
from ..core import symbols
from ..core.obj import Obj, to_np, col_by_name, enum_domain
from ..core.interp import Builtin

AGG_NAMES = {"sum", "avg", "min", "max", "count", "first", "last",
             "med", "dev"}

ARITH = {"+": "add", "-": "sub", "*": "mul", "/": "idiv", "div": "fdiv",
         "%": "mod", "xbar": "xbar"}
CMPS = {"==": "eq", "!=": "ne", "<": "lt", ">": "gt", "<=": "le",
        ">=": "ge"}

_NP2TORCH = {np.dtype(np.int8): torch.int8, np.dtype(np.uint8): torch.uint8,
             np.dtype(np.int16): torch.int16,
             np.dtype(np.int32): torch.int32,
             np.dtype(np.int64): torch.int64,
             np.dtype(np.float64): torch.float64,
             np.dtype(np.bool_): torch.bool}
_TORCH2NP = {v: k for k, v in _NP2TORCH.items()}


def torch_dtype(np_dtype) -> torch.dtype:
    """The torch dtype of a numpy dtype (or scalar type)."""
    return _NP2TORCH[np.dtype(np_dtype)]


def _np_dtype(v):
    if isinstance(v, torch.Tensor):
        return _TORCH2NP[v.dtype]
    return np.asarray(v).dtype


def _tensor(v, dtype, device=None):
    """v (a tensor or a numpy scalar) as a tensor of `dtype`. A scalar
    goes on `device`, the device of the tensor it meets; only a
    column-free expression, which meets none, takes the engine's."""
    if isinstance(v, torch.Tensor):
        return v.to(dtype)
    if device is None:
        from .device import device as engine_device
        device = engine_device()
    return torch.tensor(v, dtype=dtype, device=device)


def _device_of(*vs):
    """The device of the first tensor among vs (None when none is)."""
    return next((v.device for v in vs if isinstance(v, torch.Tensor)), None)


def as_tensor(v) -> torch.Tensor:
    """A compiled expression's value (a tensor, or a numpy scalar for a
    column-free expression) as a tensor of its own dtype."""
    return _tensor(v, v.dtype if isinstance(v, torch.Tensor)
                   else torch_dtype(_np_dtype(v)))


def _common(va, vb):
    """Both operands as tensors of their numpy-promoted dtype."""
    dt = torch_dtype(np.result_type(_np_dtype(va), _np_dtype(vb)))
    d = _device_of(va, vb)
    return _tensor(va, dt, d), _tensor(vb, dt, d)


class ColRef:
    __slots__ = ("name", "col", "slot")

    def __init__(self, name, col, slot):
        self.name = name
        self.col = col
        self.slot = slot


class Compiled:
    """A compiled elementwise expression: fn(cols...) -> tensor, plus
    the column inputs it consumes and the logical result type."""

    def __init__(self, fn, cols: list, rtype: int):
        self.fn = fn
        self.cols = cols
        self.rtype = rtype


def _builtin_name(o: Obj):
    if o.t in (T.UNARY, T.BINARY, T.VARY) and isinstance(o.v, Builtin):
        return o.v.name
    return None


class _Compiler:
    def __init__(self, tbl: Obj):
        self.tbl = tbl
        self.cols: list[ColRef] = []
        self.by_name: dict[int, ColRef] = {}
        self._col_touches = 0   # column READS, incl. repeat references

    def colref(self, sid: int):
        self._col_touches += 1
        if sid in self.by_name:
            return self.by_name[sid]
        col = col_by_name(self.tbl, symbols.name_of(sid))
        if col is None:
            return None
        if col.t in (T.LIST, T.C8, T.GUID) or col.t in T.UNPARTED_OF:
            return None
        ref = ColRef(sid, col, len(self.cols))
        self.cols.append(ref)
        self.by_name[sid] = ref
        return ref

    # returns (builder, logical_type) where builder(args)->tensor,
    # or None when uncompilable
    def compile(self, ast: Obj):
        t = ast.t
        if t == -T.SYMBOL:
            if ast.attrs & 1:  # quoted symbol literal
                sid = int(ast.v)
                return (lambda env, s=sid: np.int64(s)), T.SYMBOL
            ref = self.colref(int(ast.v))
            if ref is None:
                return None
            slot = ref.slot
            ct = ref.col.t
            if ct == T.ENUM:
                # enum -> symbol ids via its domain (device gather)
                dom = np.ascontiguousarray(to_np(enum_domain(ref.col)),
                                           dtype=np.int64)
                cache = {}

                def g_enum(env, s=slot, dom=dom, cache=cache):
                    x = env[s]
                    d = cache.get(x.device)
                    if d is None:
                        d = cache[x.device] = \
                            torch.from_numpy(dom).to(x.device)
                    ix = torch.clamp(x, 0, len(dom) - 1)
                    return torch.where(x == int(T.NULL_I64),
                                       int(T.NULL_I64), d[ix])
                return g_enum, T.SYMBOL
            return (lambda env, s=slot: env[s]), ct
        if t < 0:
            st = -t
            if st in (T.I16, T.I32, T.I64, T.F64, T.B8, T.U8, T.DATE,
                      T.TIME, T.TIMESTAMP):
                val = ast.v
                return (lambda env, v=val: v), st
            return None
        if t != T.LIST or not ast.v:
            return None
        head = ast.v[0]
        name = _builtin_name(head)
        if name is None:
            return None
        args = ast.v[1:]
        if name in ARITH and len(args) == 2:
            a = self.compile(args[0])
            b = self.compile(args[1])
            if a is None or b is None:
                return None
            return self._arith(ARITH[name], a, b)
        if name in CMPS and len(args) == 2:
            a = self.compile(args[0])
            b = self.compile(args[1])
            if a is None or b is None:
                return None
            return self._cmp(CMPS[name], a, b)
        if name == "not" and len(args) == 1:
            a = self.compile(args[0])
            if a is None or a[1] != T.B8:
                return None
            return (lambda env, f=a[0]:
                    ~_tensor(f(env), torch.bool)), T.B8
        if name == "as" and len(args) == 2 and args[0].t == -T.SYMBOL \
                and (args[0].attrs & 1):
            # numeric/temporal VECTOR casts only, mirroring
            # ops/cast._vec_num: raw C conversions (narrowing wraps,
            # no null special-casing; f64 -> int via cvtt32/cvtt64
            # with NaN/out-of-range on INT_MIN). Columns are vectors,
            # so both typename cases take the vector path — but a
            # column-free subexpression is an ATOM on the host (atom
            # table / type error), so require a column read.
            from ..ops.cast import NAME2TYPE, NUMERIC
            tt = NAME2TYPE.get(symbols.name_of(int(args[0].v)))
            tt = abs(tt) if tt is not None else None
            if tt not in NUMERIC:
                return None
            touches0 = self._col_touches
            a = self.compile(args[1])
            if a is None or a[1] not in NUMERIC \
                    or self._col_touches == touches0:
                return None
            fa, ta = a
            if ta == tt:
                return a
            if (tt, ta) in ((T.B8, T.U8), (T.U8, T.B8)):
                return None     # pair absent from the reference table

            def g_as(env, f=fa, ta=ta, tt=tt):
                v = f(env)
                if tt == T.F64:
                    return _tensor(v, torch.float64)
                if ta == T.F64:
                    v = _tensor(v, torch.float64)
                    if tt in (T.I64, T.TIMESTAMP):
                        bad = ~((v >= -(2.0 ** 63)) & (v < 2.0 ** 63))
                        w = torch.trunc(torch.where(bad, 0.0, v)) \
                            .to(torch.int64)
                        w = torch.where(bad, -2 ** 63, w)
                    else:
                        bad = ~((v > -(2.0 ** 31) - 1) & (v < 2.0 ** 31))
                        w = torch.trunc(torch.where(bad, 0.0, v)) \
                            .to(torch.int32)
                        w = torch.where(bad, -2 ** 31, w)
                    return w.to(r_dtype(tt))
                return _tensor(v, r_dtype(tt))
            return g_as, tt
        if name in ("and", "or"):
            parts = [self.compile(x) for x in args]
            if any(p is None or p[1] != T.B8 for p in parts):
                return None
            fns = [p[0] for p in parts]
            if name == "and":
                def g(env, fns=fns):
                    vs = [f(env) for f in fns]
                    d = _device_of(*vs)
                    r = _tensor(vs[0], torch.bool, d)
                    for v in vs[1:]:
                        r = r & _tensor(v, torch.bool, d)
                    return r
            else:
                def g(env, fns=fns):
                    vs = [f(env) for f in fns]
                    d = _device_of(*vs)
                    r = _tensor(vs[0], torch.bool, d)
                    for v in vs[1:]:
                        r = r | _tensor(v, torch.bool, d)
                    return r
            return g, T.B8
        if name == "neg" and len(args) == 1:
            a = self.compile(args[0])
            if a is None:
                return None
            return (lambda env, f=a[0]: -f(env)), a[1]
        if name == "in" and len(args) == 2 and args[1].t in \
                (T.SYMBOL, T.I64, T.I32, T.I16):
            a = self.compile(args[0])
            if a is None:
                return None
            vals = np.ascontiguousarray(to_np(args[1]), dtype=np.int64)

            def g_in(env, f=a[0], vals=vals):
                x = _tensor(f(env), torch.int64)
                return torch.isin(x, torch.from_numpy(vals).to(x.device))
            return g_in, T.B8
        if name == "within" and len(args) == 2 and args[1].t > 0 \
                and args[1].t != T.LIST and len(args[1]) == 2:
            a = self.compile(args[0])
            if a is None:
                return None
            rng = to_np(args[1])
            lo, hi = rng[0], rng[1]
            if args[1].t != T.F64:
                lo, hi = np.int64(lo), np.int64(hi)

            def g_within(env, f=a[0], lo=lo, hi=hi):
                x = f(env)
                xl, tl = _common(x, lo)
                xh, th = _common(x, hi)
                return (xl >= tl) & (xh <= th)
            return g_within, T.B8
        return None

    def _arith(self, op, a, b):
        fa, ta = a
        fb, tb = b
        from ..ops.vops import promote_arith
        try:
            if op == "fdiv":
                rt, ct = T.F64, T.F64
                promote_arith("mul", ta, tb)
            else:
                rt, ct = promote_arith(op, ta, tb)
        except Exception:
            return None
        nullv = T.NULL_BY_TYPE.get(rt)

        def g(env, fa=fa, fb=fb, op=op, ct=ct, rt=rt, ta=ta, tb=tb,
              nullv=nullv):
            va = fa(env)
            vb = fb(env)
            d = _device_of(va, vb)
            na = _isnull(va, ta, d)
            nb = _isnull(vb, tb, d)
            if ct == T.F64:
                va = _tensor(va, torch.float64, d)
                vb = _tensor(vb, torch.float64, d)
            else:
                va, vb = _common(va, vb)
            if op == "add":
                r = va + vb
            elif op == "sub":
                r = va - vb
            elif op == "mul":
                r = va * vb
            elif op == "idiv":
                zero = vb == 0
                r = torch.div(va, torch.where(zero, 1, vb),
                              rounding_mode="floor")
                nb = nb | zero
            elif op == "fdiv":
                zero = vb == 0
                r = va / torch.where(zero, 1.0, vb)
                nb = nb | zero
            elif op == "mod":
                zero = vb == 0
                r = torch.remainder(va, torch.where(zero, 1, vb))
                nb = nb | zero
            else:  # xbar: b * trunc(a/b), exact in integers
                zero = vb == 0
                safe = torch.where(zero, 1, vb)
                if rt == T.F64:
                    r = safe * torch.trunc(va / safe)
                else:
                    q = torch.div(torch.abs(va), torch.abs(safe),
                                  rounding_mode="floor")
                    q = torch.where((va < 0) != (safe < 0), -q, q)
                    r = safe * q
                nb = nb | zero
            r = r.to(r_dtype(rt))
            nulls = na | nb
            if nullv is not None:
                r = torch.where(nulls, _tensor(np.asarray(nullv),
                                               r.dtype, r.device), r)
            return r
        return g, rt

    def _cmp(self, op, a, b):
        fa, ta = a
        fb, tb = b
        num = (T.B8, T.U8, T.I16, T.I32, T.I64, T.F64)
        cls_a = "num" if ta in num else ta
        cls_b = "num" if tb in num else tb
        if cls_a != cls_b:
            return None
        f64involved = ta == T.F64 or tb == T.F64

        def g(env, fa=fa, fb=fb, op=op, f64=f64involved):
            va = fa(env)
            vb = fb(env)
            if f64:
                d = _device_of(va, vb)
                va = _tensor(va, torch.float64, d)
                vb = _tensor(vb, torch.float64, d)
                va = torch.where(torch.isnan(va), -np.inf, va)
                vb = torch.where(torch.isnan(vb), -np.inf, vb)
            else:
                va, vb = _common(va, vb)
            if op == "eq":
                return va == vb
            if op == "ne":
                return va != vb
            if op == "lt":
                return va < vb
            if op == "gt":
                return va > vb
            if op == "le":
                return va <= vb
            return va >= vb
        return g, T.B8


def r_dtype(rt):
    return {T.I16: torch.int16, T.I32: torch.int32, T.I64: torch.int64,
            T.F64: torch.float64, T.U8: torch.uint8, T.B8: torch.int8,
            T.DATE: torch.int32, T.TIME: torch.int32,
            T.TIMESTAMP: torch.int64}.get(rt, torch.int64)


def _isnull(v, t, device=None):
    if isinstance(v, torch.Tensor):
        if t == T.F64:
            return torch.isnan(v)
        nv = T.NULL_BY_TYPE.get(t)
        if nv is None:
            return torch.zeros((), dtype=torch.bool, device=v.device)
        return v == _tensor(np.asarray(nv), v.dtype, v.device)
    if t == T.F64:
        r = bool(np.isnan(np.float64(v)))
    else:
        nv = T.NULL_BY_TYPE.get(t)
        r = nv is not None and v == nv
    return _tensor(np.bool_(r), torch.bool, device)


def compile_expr(tbl: Obj, ast: Obj):
    """Compile an elementwise expression over tbl's columns.
    Returns Compiled or None."""
    c = _Compiler(tbl)
    r = c.compile(ast)
    if r is None:
        return None
    fn, rt = r
    out = Compiled(fn, c.cols, rt)
    out.ast = ast
    out.tbl = tbl
    return out


def expr_range(tbl: Obj, ast: Obj):
    """Conservative (lo, hi) interval of an elementwise int expression
    via interval arithmetic over cached column stats, or None when
    unbounded / unsupported. Null sentinel inputs are EXCLUDED (column
    stats ignore nulls; arithmetic on nulls yields nulls, which the
    consumers detect separately) — the bound covers non-null results
    only."""
    from . import device as dev

    def walk(node):
        t = node.t
        if t == -T.SYMBOL and not (node.attrs & 1):
            col = col_by_name(tbl, symbols.name_of(int(node.v)))
            if col is None or col.t not in (T.U8, T.I16, T.I32, T.I64,
                                            T.B8):
                return None
            try:
                lo, hi = dev.column_range(col)
                return int(lo), int(hi)
            except Exception as e:
                if dev.is_fault(e):
                    raise
                return None
        if t < 0 and -t in (T.U8, T.I16, T.I32, T.I64, T.B8):
            v = int(node.v)
            return v, v
        if t != T.LIST or not node.v:
            return None
        name = _builtin_name(node.v[0])
        args = node.v[1:]
        if name == "neg" and len(args) == 1:
            r = walk(args[0])
            return (-r[1], -r[0]) if r else None
        if name == "not" and len(args) == 1:
            return 0, 1
        if name in CMPS and len(args) == 2:
            return 0, 1
        if name == "as" and len(args) == 2 and args[0].t == -T.SYMBOL \
                and (args[0].attrs & 1):
            # Bounds survive a cast only when the inner expression is a
            # comparison/not (b8 in {0,1}, null-free): raw casts WRAP
            # null sentinels into ordinary values, so bounds computed
            # from null-skipping column stats would not cover them.
            from ..ops.cast import NAME2TYPE
            tt = NAME2TYPE.get(symbols.name_of(int(args[0].v)))
            tt = abs(tt) if tt is not None else None
            if tt not in (T.U8, T.I16, T.I32, T.I64, T.B8):
                return None
            inner = args[1]
            if inner.t != T.LIST or not inner.v:
                return None
            iname = _builtin_name(inner.v[0])
            if iname not in CMPS and iname != "not":
                return None
            return walk(inner)
        if name in ("+", "-", "*") and len(args) == 2:
            a, b = walk(args[0]), walk(args[1])
            if a is None or b is None:
                return None
            if name == "+":
                return a[0] + b[0], a[1] + b[1]
            if name == "-":
                return a[0] - b[1], a[1] - b[0]
            ps = [a[0] * b[0], a[0] * b[1], a[1] * b[0], a[1] * b[1]]
            return min(ps), max(ps)
        return None

    return walk(ast)


def split_aggregate(tbl: Obj, ast: Obj):
    """If ast is (agg inner-elementwise-expr), return (aggname, Compiled)
    for the inner expression; else None."""
    if ast.t != T.LIST or not ast.v:
        return None
    name = _builtin_name(ast.v[0])
    if name not in AGG_NAMES or len(ast.v) != 2:
        return None
    inner = compile_expr(tbl, ast.v[1])
    if inner is None:
        return None
    return name, inner
