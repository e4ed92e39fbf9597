"""Tree-walking evaluator.

Mirrors the reference's eval discipline (core/eval.c:660-893): lists are
calls, unquoted symbols resolve through lambda frames -> query contexts ->
globals, everything else is self-evaluating. Special forms receive raw ASTs;
FN_AGGR builtins receive unmaterialized MAPGROUP/MAPFILTER lazies, everything
else gets them collected (eval.c collect_lazy) — this is how aggregates fuse
with grouping.

The reference compiles lambdas to bytecode for speed (cc.c); here the hot
path is the vectorized kernel layer, so lambdas stay tree-walked on the host
control plane.
"""
from __future__ import annotations

import numpy as np

from . import profiler
from . import symbols
from . import types as T
from .obj import Obj, NULL_OBJ, sym, list_
from .parser import Lambda, parse
from .errors import RayError, err_arity, err_value, err_type

# Builtin attrs (reference core/ops.h:42-48)
FN_ATOMIC = 1
FN_AGGR = 2
FN_SPECIAL = 4
FN_RIGHT_ATOMIC = 8


class Builtin:
    __slots__ = ("name", "tcode", "fn", "attrs")

    def __init__(self, name: str, tcode: int, fn, attrs: int = 0):
        self.name = name
        self.tcode = tcode  # T.UNARY / T.BINARY / T.VARY
        self.fn = fn
        self.attrs = attrs


class Frame:
    """One lambda activation: parameter bindings by symbol id."""
    __slots__ = ("lam", "binds")

    def __init__(self, lam: Lambda, binds: dict):
        self.lam = lam
        self.binds = binds


class QueryCtx:
    """Column-name resolution scope for select/update (query.h analogue)."""
    __slots__ = ("table",)

    def __init__(self, table: Obj):
        self.table = table


SYM_SELF = symbols.intern("self")


class Interp:
    """Evaluator state: global bindings, lambda frames, query contexts."""

    def __init__(self, env):
        _CURRENT.append(self)
        self.env = env                      # Env (builtin registry)
        self.globals: dict[int, Obj] = {}
        self.frames: list[Frame] = []
        self.qctx: list[QueryCtx] = []
        self.depth = 0
        from ..ipc.client import HandleRegistry
        self.handles = HandleRegistry()

    def fork(self) -> "Interp":
        """A child evaluator sharing globals/env but with its OWN
        frame and query-context stacks — the analogue of the
        reference's per-executor VMs (pool.c: each executor owns a
        vm_t; globals/heap are shared). Used by pmap workers; not
        registered in the current-interp stack."""
        child = object.__new__(Interp)
        child.env = self.env
        child.globals = self.globals
        child.frames = []
        child.qctx = []
        child.depth = 0
        child.handles = self.handles
        return child

    # -- resolution (eval.c:134-176) ----------------------------------
    def resolve(self, sid: int):
        if sid == SYM_SELF and self.frames:
            return Obj(T.LAMBDA, self.frames[-1].lam)
        for fr in reversed(self.frames):
            if sid in fr.binds:
                return fr.binds[sid]
            if sid in fr.lam.env:
                return fr.lam.env[sid]
        for ctx in reversed(self.qctx):
            names, cols = ctx.table.v
            ids = np.asarray(names.v)
            hit = np.nonzero(ids == sid)[0]
            if len(hit):
                return cols[int(hit[0])]
        if sid in self.globals:
            return self.globals[sid]
        return None

    def amend(self, sid: int, val: Obj):
        """`set` target scope: enclosing lambda's persistent env, else
        globals (eval.c amend)."""
        if self.frames:
            self.frames[-1].lam.env[sid] = val
        else:
            self.globals[sid] = val
        return val

    def let(self, sid: int, val: Obj):
        """`let` binds in the current frame (locals) or globals at top."""
        if self.frames:
            self.frames[-1].binds[sid] = val
        else:
            self.globals[sid] = val
        return val

    # -- evaluation ----------------------------------------------------
    def eval(self, o: Obj) -> Obj:
        t = o.t
        if t == T.LIST:
            return self.eval_list(o)
        if t == -T.SYMBOL:
            if o.attrs & 1:  # ATTR_QUOTED
                return sym(int(o.v))
            val = self.resolve(int(o.v))
            if val is None:
                raise err_value(f"'{symbols.name_of(int(o.v))}' not found")
            return val
        return o

    def eval_arg(self, a: Obj, is_aggr: bool) -> Obj:
        x = self.eval(a)
        return x if is_aggr else collect_lazy(x)

    def eval_list(self, o: Obj) -> Obj:
        try:
            return self._eval_list(o)
        except RayError as e:
            if e.span is None and isinstance(o.meta, dict):
                e.span = o.meta.get("span")
            raise

    def _eval_list(self, o: Obj) -> Obj:
        items = o.v
        if not items:
            return NULL_OBJ
        car = items[0]
        args = items[1:]
        while True:
            t = car.t
            if t == T.UNARY:
                b = car.v
                if len(args) != 1:
                    raise err_arity(f"{b.name}: need 1, have {len(args)}")
                if b.attrs & FN_SPECIAL:
                    return b.fn(self, args[0])
                return b.fn(self.eval_arg(args[0], b.attrs & FN_AGGR))
            if t == T.BINARY:
                b = car.v
                if len(args) != 2:
                    raise err_arity(f"{b.name}: need 2, have {len(args)}")
                if b.attrs & FN_SPECIAL:
                    return b.fn(self, args[0], args[1])
                aggr = b.attrs & FN_AGGR
                return b.fn(self.eval_arg(args[0], aggr),
                            self.eval_arg(args[1], aggr))
            if t == T.VARY:
                b = car.v
                if b.attrs & FN_SPECIAL:
                    return b.fn(self, list(args))
                aggr = b.attrs & FN_AGGR
                return b.fn([self.eval_arg(a, aggr) for a in args])
            if t == T.LAMBDA:
                vals = [collect_lazy(self.eval(a)) for a in args]
                return self.call_lambda(car.v, vals)
            if t == -T.SYMBOL and not (car.attrs & 1):
                val = self.resolve(int(car.v))
                if val is None:
                    raise err_value(
                        f"'{symbols.name_of(int(car.v))}' not found")
                car = val
                continue
            if t == T.LIST:
                car = self.eval_list(car)
                continue
            raise err_type("not callable")

    def call_lambda(self, lam: Lambda, vals: list) -> Obj:
        if len(vals) != len(lam.params):
            raise RayError("length",
                           f"need {len(lam.params)}, have {len(vals)}")
        if len(self.frames) >= 1024:
            raise RayError("limit", "stack overflow")
        self.frames.append(Frame(lam, dict(zip(lam.params, vals))))
        try:
            return self.eval(lam.body)
        except _Return as r:
            return r.value
        finally:
            self.frames.pop()

    def eval_str(self, src: str) -> Obj:
        with profiler.span("query"):
            ast = parse(src, self.env)
            return self.eval(ast)


_CURRENT: list = []


def current_interp():
    """Most recently created Interp (process-wide; reference runtime_get)."""
    return _CURRENT[-1] if _CURRENT else None


class _Return(Exception):
    """Non-local exit for the `return` builtin."""

    def __init__(self, value):
        self.value = value


def collect_lazy(x: Obj) -> Obj:
    """Materialize MAPGROUP/MAPFILTER (eval.c collect_lazy)."""
    if isinstance(x, Obj):
        if x.t == T.MAPGROUP:
            from ..ops.aggr import aggr_collect
            return aggr_collect(x.v[0], x.v[1])
        if x.t == T.MAPFILTER:
            from ..ops.filter import filter_collect
            return filter_collect(x.v[0], x.v[1])
    return x


class Env:
    """Builtin registry (core/env.c)."""

    def __init__(self):
        self.builtins: dict[str, Obj] = {}
        self.typenames: dict[str, int] = {}

    def register(self, name, tcode, fn, attrs=0):
        self.builtins[name] = Obj(tcode, Builtin(name, tcode, fn, attrs))

    def builtin(self, name):
        return self.builtins.get(name)
