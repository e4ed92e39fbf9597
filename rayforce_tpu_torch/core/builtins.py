"""Builtin registry — the full user-facing API surface
(reference core/env.c:120-270; Appendix C of SURVEY.md).
"""
from __future__ import annotations

import time as _time

import numpy as np

from . import types as T
from . import symbols, fmt
from .obj import (Obj, NULL_OBJ, list_, sym, string, str_of, i64 as mk_i64,
                  date as mk_date, time_ as mk_time, timestamp as mk_ts)
from .interp import (Interp, Env, Builtin, FN_ATOMIC, FN_AGGR, FN_SPECIAL,
                     FN_RIGHT_ATOMIC, _Return, collect_lazy)
from .parser import parse
from .errors import RayError, err_type, err_value

from ..ops import math as m
from ..ops import vops, items, compose, logic, cast, sort, misc, iter as it
from ..ops import query as q


def _cmp(op):
    return lambda a, b: vops.compare(op, a, b)


def build_env(interp_holder: dict) -> Env:
    env = Env()
    U, B, V = T.UNARY, T.BINARY, T.VARY

    def interp():
        return interp_holder["interp"]

    # ---- special forms ------------------------------------------------
    def sf_quote(ip, a):
        if a.t == -T.SYMBOL:
            return sym(int(a.v))
        return a

    def sf_set(ip, target, vexpr):
        v = collect_lazy(ip.eval(vexpr))
        if target.t == -T.SYMBOL:
            # `set` always binds the GLOBAL (oracle: set inside a lambda is
            # visible at top level); `let` is the local binder.
            ip.globals[int(target.v)] = v
            return v
        # (set "path" x) persists to disk (binary.c:52-315)
        tv = ip.eval(target)
        if tv.t == T.C8:
            from ..storage import binary as stor
            stor.set_path(str_of(tv), v)
            return v
        raise err_type("set target must be a symbol or path")

    def sf_let(ip, target, vexpr):
        v = collect_lazy(ip.eval(vexpr))
        if target.t != -T.SYMBOL:
            raise err_type("let target must be a symbol")
        ip.let(int(target.v), v)
        return v

    def sf_do(ip, args):
        r = NULL_OBJ
        for a in args:
            r = ip.eval(a)
        return r

    def sf_if(ip, args):
        if len(args) not in (2, 3):
            raise RayError("arity", "if needs 2 or 3 args")
        c = collect_lazy(ip.eval(args[0]))
        if _truthy(c):
            return ip.eval(args[1])
        if len(args) == 3:
            return ip.eval(args[2])
        return NULL_OBJ

    def sf_try(ip, body, handler):
        from .errors import err_msg
        try:
            return collect_lazy(ip.eval(body))
        except _Return:
            raise
        except RayError as e:
            # the handler receives err_msg as a STRING (eval.c try_obj)
            h = ip.eval(handler)
            if h.t == T.LAMBDA:
                # the reference's error string includes the terminating NUL
                # (str_fmt "%s" writes len+1); it prints as a trailing space
                return ip.call_lambda(h.v,
                                      [string(err_msg(e) + "\x00")])
            return h

    def sf_timeit(ip, args):
        t0 = _time.perf_counter()
        r = NULL_OBJ
        for a in args:
            r = ip.eval(a)
        ms = (_time.perf_counter() - t0) * 1000.0
        return Obj(-T.F64, np.float64(ms))

    def fn_raise(o):
        # the reference accepts only strings (raise -> user error,
        # eval.c ray_raise:909) or error objects; anything else is a
        # type error. Unlike the reference (which drops the text,
        # err_user(NULL)) the message is kept — documented superset.
        if o.t == T.C8:
            raise RayError("user", str_of(o))
        if o.t == -T.ERR:
            raise o.v
        raise err_type("raise needs a string or error")

    def fn_return(args):
        raise _Return(args[0] if args else NULL_OBJ)

    def fn_eval(o):
        if o.t == T.C8:
            return interp().eval_str(str_of(o))
        return interp().eval(o)

    def fn_parse(o):
        return parse(str_of(o), env)

    def fn_load(o):
        path = str_of(o)
        with open(path) as f:
            src = f.read()
        return interp().eval_str(src)

    def fn_resolve(o):
        if o.t != -T.SYMBOL:
            raise err_type("resolve needs a symbol")
        v = interp().resolve(int(o.v))
        return v if v is not None else NULL_OBJ

    def fn_get(o):
        if o.t == -T.SYMBOL:
            v = interp().resolve(int(o.v))
            if v is None:
                raise err_value("not found")
            return v
        if o.t == T.C8:
            from ..storage import binary as stor
            return stor.get_path(str_of(o))
        raise err_type("get needs symbol or path")

    def fn_exit(args):
        code = int(args[0].v) if args else 0
        raise SystemExit(code)

    def fn_filter(xs, mask):
        """(filter data bools) -> kept values (items.c ray_filter)."""
        from ..ops.compose import gather
        if mask.t != T.B8:
            raise err_type("filter needs a boolean mask")
        import numpy as _np
        m = _np.asarray(mask.v).astype(bool)
        idx = _np.nonzero(m)[0].astype(_np.int64)
        if xs.t == T.TABLE:
            from .obj import table as mk_table
            names, cols = xs.v
            return mk_table(names, [gather(c, idx) for c in cols])
        if xs.t < 0:
            raise err_type("filter needs a sequence")
        if len(xs) != len(m):
            raise RayError("length", "filter mask length mismatch")
        return gather(xs, idx)

    # ---- iterator wrappers (need interp) ------------------------------
    def v_map(args):
        if len(args) < 2:
            raise RayError("arity", "map")
        return it.ray_map(interp(), args[0], list(args[1:]))

    def v_pmap(args):
        if len(args) < 2:
            raise RayError("arity", "pmap")
        return it.ray_pmap(interp(), args[0], list(args[1:]))

    def v_map_left(args):
        if len(args) != 3:
            raise RayError("arity", "map-left")
        return it.ray_map_left(interp(), args[0], args[1], args[2])

    def v_map_right(args):
        if len(args) != 3:
            raise RayError("arity", "map-right")
        return it.ray_map_right(interp(), args[0], args[1], args[2])

    def v_fold(args):
        return it.ray_fold(interp(), args[0], list(args[1:]))

    def v_fold_right(args):
        return it.ray_fold_right(interp(), args[0], list(args[1:]))

    def v_scan(args):
        return it.ray_scan(interp(), args[0], list(args[1:]))

    def v_scan_right(args):
        return it.ray_scan_right(interp(), args[0], list(args[1:]))

    def v_scan_left(args):
        return it.ray_scan_left(interp(), args[0], list(args[1:]))

    def v_apply(args):
        return it.ray_apply(interp(), args[0], list(args[1:]))

    # ---- query wrappers -----------------------------------------------
    def sf_select(ip, a):
        return q.ray_select(ip, a)

    def sf_update(ip, a):
        return q.ray_update(ip, a)

    # ---- temporal now/cast --------------------------------------------
    def _now_parts(o):
        """(date/time/timestamp 'utc|'local) -> current wall-clock
        broken down in that zone (reference timestamp_current,
        core/timestamp.c:497-526: 'utc -> gmtime, else localtime)."""
        from datetime import datetime, timezone, date as _d
        nm = symbols.name_of(int(o.v))
        dt = datetime.now(timezone.utc) if nm == "utc" \
            else datetime.now()
        days = (dt.date() - _d(2000, 1, 1)).days
        ms = (dt.hour * 3600 + dt.minute * 60 + dt.second) * 1000 \
            + dt.microsecond // 1000
        ns = days * 86_400_000_000_000 \
            + (dt.hour * 3600 + dt.minute * 60 + dt.second) \
            * 1_000_000_000 + dt.microsecond * 1000
        return days, ms, ns

    def fn_date(o):
        from .temporal import EPOCH_2000_DAYS
        if o.t == -T.SYMBOL:
            return mk_date(_now_parts(o)[0])
        if o.t == -T.NULL:
            return mk_date(int(_time.time() // 86400) - EPOCH_2000_DAYS)
        return cast.cast_any(T.DATE, o)

    def fn_time(o):
        if o.t == -T.SYMBOL:
            return mk_time(_now_parts(o)[1])
        if o.t == -T.NULL:
            t = _time.time()
            return mk_time(int((t % 86400) * 1000))
        return cast.cast_any(T.TIME, o)

    def fn_timestamp(o):
        from .temporal import EPOCH_2000_DAYS
        if o.t == -T.SYMBOL:
            return mk_ts(_now_parts(o)[2])
        if o.t == -T.NULL:
            return mk_ts(int((_time.time() - EPOCH_2000_DAYS * 86400)
                             * 1e9))
        return cast.cast_any(T.TIMESTAMP, o)

    # ---- registration -------------------------------------------------
    R = env.register
    # unary
    R("get", U, fn_get)
    R("quote", U, sf_quote, FN_SPECIAL)
    R("raise", U, fn_raise)

    R("parse", U, fn_parse)
    R("eval", U, fn_eval)
    R("load", U, fn_load)
    R("type", U, misc.ray_type)
    R("til", U, compose.ray_til)
    R("reverse", U, compose.ray_reverse)
    R("distinct", U, compose.ray_distinct)
    R("group", U, compose.ray_group)
    R("sum", U, m.ray_sum, FN_ATOMIC | FN_AGGR)
    R("avg", U, m.ray_avg, FN_ATOMIC | FN_AGGR)
    R("med", U, m.ray_med, FN_ATOMIC | FN_AGGR)
    R("dev", U, m.ray_dev, FN_ATOMIC | FN_AGGR)
    R("min", U, m.ray_min, FN_ATOMIC | FN_AGGR)
    R("max", U, m.ray_max, FN_ATOMIC | FN_AGGR)
    R("round", U, m.ray_round, FN_ATOMIC)
    R("floor", U, m.ray_floor, FN_ATOMIC)
    R("ceil", U, m.ray_ceil, FN_ATOMIC)
    R("first", U, items.ray_first, FN_AGGR)
    R("last", U, items.ray_last, FN_AGGR)
    R("count", U, items.ray_count, FN_AGGR)
    R("not", U, logic.ray_not, FN_ATOMIC)
    R("iasc", U, sort.ray_iasc)
    R("idesc", U, sort.ray_idesc)
    R("rank", U, sort.ray_rank)
    R("asc", U, sort.ray_asc)
    R("desc", U, sort.ray_desc)
    R("guid", U, compose.ray_guid, FN_ATOMIC)
    R("neg", U, m.ray_neg, FN_ATOMIC)
    R("where", U, items.ray_where, FN_ATOMIC)
    R("key", U, items.ray_key)
    R("value", U, items.ray_value)
    def fn_hclose(o):
        interp().handles.close(int(o.v))
        return NULL_OBJ
    R("hclose", U, fn_hclose)
    R("rc", U, misc.ray_rc)
    R("select", U, sf_select, FN_SPECIAL)
    R("update", U, sf_update, FN_SPECIAL)
    R("date", U, fn_date)
    R("time", U, fn_time)
    R("timestamp", U, fn_timestamp)
    R("nil?", U, logic.ray_is_null)
    R("resolve", U, fn_resolve)
    R("show", U, misc.ray_show)
    R("meta", U, misc.ray_meta)
    R("system", U, _fn_system)
    R("loadfn", V, _fn_loadfn)

    # kdb+ wire-protocol bridge (ext/kdb.py, the raykx analogue)
    def v_kopen(args):
        from ..ext import kdb
        if not args or args[0].t != T.C8:
            raise RayError("arity", 'kopen needs "host:port"')
        user = str_of(args[1]) if len(args) > 1 and \
            args[1].t == T.C8 else ""
        return mk_i64(kdb.kopen(interp().handles, str_of(args[0]),
                                user))

    def v_kwrite(args):
        from ..ext import kdb
        if len(args) != 2 or args[0].t != -T.I64:
            raise RayError("arity", "kwrite needs handle and message")
        return kdb.kwrite(interp().handles, int(args[0].v), args[1])

    def v_kclose(args):
        if len(args) != 1 or args[0].t != -T.I64:
            raise RayError("arity", "kclose needs a handle")
        interp().handles.close(int(args[0].v))
        return NULL_OBJ

    R("kopen", V, v_kopen)
    R("kwrite", V, v_kwrite)
    R("kclose", V, v_kclose)
    R("os-get-var", U, _fn_os_get)
    R("unify", U, compose.ray_unify)
    R("raze", U, compose.ray_raze)
    R("diverse", U, compose.ray_diverse)
    R("row", U, misc.ray_row, FN_AGGR)
    R("ser", U, _fn_ser)
    R("de", U, _fn_de)
    # binary
    R("try", B, sf_try, FN_SPECIAL)
    R("set", B, sf_set, FN_SPECIAL)
    R("let", B, sf_let, FN_SPECIAL)
    R("at", B, items.ray_at, FN_RIGHT_ATOMIC)
    R("==", B, _cmp("eq"), FN_ATOMIC)
    R("!=", B, _cmp("ne"), FN_ATOMIC)
    R("<", B, _cmp("lt"), FN_ATOMIC)
    R(">", B, _cmp("gt"), FN_ATOMIC)
    R("<=", B, _cmp("le"), FN_ATOMIC)
    R(">=", B, _cmp("ge"), FN_ATOMIC)
    R("+", B, m.ray_add, FN_ATOMIC)
    R("-", B, m.ray_sub, FN_ATOMIC)
    R("*", B, m.ray_mul, FN_ATOMIC)
    R("%", B, m.ray_mod, FN_ATOMIC)
    R("/", B, m.ray_div, FN_ATOMIC)
    R("div", B, m.ray_fdiv, FN_ATOMIC)
    R("like", B, logic.ray_like)
    R("dict", B, compose.ray_dict)
    R("table", B, compose.ray_table)
    R("find", B, items.ray_find)
    R("concat", B, compose.ray_concat)
    R("remove", B, compose.ray_remove)
    R("filter", B, fn_filter)
    R("take", B, items.ray_take)
    R("in", B, items.ray_in)
    R("within", B, items.ray_within)
    R("sect", B, items.ray_sect, FN_ATOMIC)
    R("except", B, items.ray_except)
    R("union", B, items.ray_union)
    R("rand", B, compose.ray_rand, FN_ATOMIC)
    R("as", B, cast.ray_cast)
    R("xasc", B, sort.ray_xasc)
    R("xdesc", B, sort.ray_xdesc)
    R("xrank", B, sort.ray_xrank)
    R("enum", B, compose.ray_enum)
    R("xbar", B, m.ray_xbar, FN_ATOMIC)
    R("os-set-var", B, _fn_os_set, FN_ATOMIC)
    R("split", B, compose.ray_split)
    R("bin", B, items.ray_bin)
    R("binr", B, items.ray_binr)
    # vary
    R("do", V, sf_do, FN_SPECIAL)
    R("and", V, logic.ray_and, FN_SPECIAL)
    R("or", V, logic.ray_or, FN_SPECIAL)
    R("env", V, _fn_env(interp_holder))
    R("timeit", V, sf_timeit, FN_SPECIAL)
    R("memstat", V, misc.ray_memstat)
    R("gc", V, lambda args: NULL_OBJ)
    R("list", V, compose.ray_list)
    R("enlist", V, compose.ray_enlist)
    R("format", V, misc.ray_format)
    R("print", V, misc.ray_print)
    R("println", V, misc.ray_println)
    R("apply", V, v_apply)
    R("map", V, v_map)
    R("pmap", V, v_pmap)
    R("map-left", V, v_map_left)
    R("map-right", V, v_map_right)
    R("fold", V, v_fold)
    R("fold-left", V, v_fold)
    R("fold-right", V, v_fold_right)
    R("scan", V, v_scan)
    R("scan-left", V, v_scan_left)
    R("scan-right", V, v_scan_right)
    from ..ops import update as upd
    R("insert", V, lambda args: upd.ray_insert(interp(), args))
    R("upsert", V, lambda args: upd.ray_upsert(interp(), args))
    R("alter", V, lambda args: upd.ray_alter(interp(), args))
    R("modify", V, lambda args: upd.ray_modify(interp(), args))
    from ..ops import join as jn
    R("left-join", V, jn.ray_left_join)
    R("inner-join", V, jn.ray_inner_join)
    R("asof-join", V, jn.ray_asof_join)
    R("window-join", V,
      lambda args: jn.ray_window_join(interp(), args, 0))
    R("window-join1", V,
      lambda args: jn.ray_window_join(interp(), args, 1))
    # ---- storage -------------------------------------------------------
    def v_set_splayed(args):
        from ..storage import splayed
        if len(args) == 2 and args[0].t == -T.SYMBOL:
            interp().globals[int(args[0].v)] = args[1]
            return args[1]
        if len(args) not in (2, 3):
            raise RayError("arity", "set-splayed")
        path = str_of(args[0])
        symfile = str_of(args[2]) if len(args) == 3 and \
            args[2].t == T.C8 else None
        splayed.set_splayed(path, args[1], symfile, interp())
        return args[0]

    def v_get_splayed(args):
        from ..storage import splayed
        return splayed.get_splayed(str_of(args[0]), interp())

    def v_set_parted(args):
        from ..storage import parted as pstore
        if len(args) == 2 and args[0].t == -T.SYMBOL:
            interp().globals[int(args[0].v)] = args[1]
            return args[1]
        if len(args) != 4:
            raise RayError("arity", "set-parted needs db part name table")
        pstore.set_parted(str_of(args[0]), str_of(args[1]),
                          str_of(args[2]), args[3], interp())
        return args[0]

    def v_get_parted(args):
        from ..storage import parted as pstore
        if len(args) != 2:
            raise RayError("arity", "get-parted")
        return pstore.get_parted(str_of(args[0]).rstrip("/"),
                                 str_of(args[1]), interp())

    def v_read_csv(args):
        from ..storage import csv as csvio
        if len(args) not in (2, 3):
            raise RayError("arity", "read-csv")
        sep = str_of(args[2]) if len(args) == 3 else ","
        return csvio.read_csv(args[0], str_of(args[1]), sep)

    def v_write_csv(args):
        from ..storage import csv as csvio
        if len(args) not in (2, 3):
            raise RayError("arity", "write-csv")
        sep = str_of(args[2]) if len(args) == 3 else ","
        csvio.write_csv(str_of(args[0]), args[1], sep)
        return args[0]

    # ---- IPC handles -----------------------------------------------
    def v_hopen(args):
        from ..ipc import client as ipc
        if not args:
            raise RayError("arity", "hopen")
        spec = str_of(args[0])
        timeout = float(args[1].v) / 1000.0 if len(args) > 1 else None
        return Obj(-T.I64,
                   np.int64(ipc.hopen(interp().handles, spec, timeout)))

    def fn_write(h, msg):
        from ..ipc import client as ipc
        return ipc.write(interp().handles, interp(), int(h.v), msg)

    def fn_read(o):
        from ..ipc import client as ipc
        if o.t == T.C8:
            with open(str_of(o), "rb") as f:
                data = f.read()
            return string(data)
        return ipc.read(interp().handles, int(o.v))

    def v_timer(args):
        from ..ipc import timers
        if len(args) < 2:
            raise RayError("arity", "timer")
        ms = int(args[0].v)
        fn = args[1]
        reps = int(args[2].v) if len(args) > 2 else None
        return Obj(-T.I64, np.int64(timers.register(ms, fn, reps)))

    R("hopen", V, v_hopen)
    R("timer", V, v_timer)
    R("read", U, fn_read)
    R("write", B, fn_write)
    R("set-splayed", V, v_set_splayed)
    R("get-splayed", V, v_get_splayed)
    R("set-parted", V, v_set_parted)
    R("get-parted", V, v_get_parted)
    R("read-csv", V, v_read_csv)
    R("write-csv", V, v_write_csv)
    R("args", V, _fn_args(interp_holder))
    R("if", V, sf_if, FN_SPECIAL)
    R("return", V, fn_return)
    R("exit", V, fn_exit)
    R("sysinfo", V, misc.ray_sysinfo)
    def v_internals(args):
        """(internals): engine introspection dict — last device query's
        phase timings (the reference's -t timeit spans, chrono.h:62)."""
        from ..engine.select import last_profile
        from .obj import dict_, sym, vec_sym
        if not last_profile:
            return NULL_OBJ
        ks = list(last_profile.keys())
        vs = []
        for k in ks:
            v = last_profile[k]
            if isinstance(v, bool):
                vs.append(Obj(-T.B8, np.int8(1 if v else 0)))
            elif isinstance(v, float):
                vs.append(Obj(-T.F64, np.float64(v)))
            elif isinstance(v, str):        # e.g. the engine's name
                vs.append(sym(v))
            else:
                vs.append(mk_i64(int(v)))
        return dict_(vec_sym(ks), list_(vs))

    R("internals", V, v_internals)
    R("set-fpr", U, misc.ray_set_fpr)
    return env


def _truthy(c) -> bool:
    """ops_as_b8 (reference core/ops.c:42): b8 value; u8/c8/i64/symbol/
    timestamp nonzero; vectors/lists nonempty; everything else true."""
    t = c.t
    if t == -T.B8:
        return bool(int(c.v))
    if t in (-T.U8, -T.C8, -T.I64, -T.SYMBOL, -T.TIMESTAMP):
        return int(c.v) != 0
    if t in (T.B8, T.U8, T.C8, T.I64, T.SYMBOL, T.TIMESTAMP, T.LIST):
        return len(c) != 0
    return True


def _fn_loadfn(args):
    """(loadfn "plugin.py" 'fname arity): bind a function exported by a
    plugin as a callable (reference core/dynlib.c:191 binds `obj_p
    f(obj_p, ...)` from a shared library; here the native-extension ABI
    is a Python module — which may itself wrap C via ctypes, as
    storage/native.py does). The function receives `arity` Obj
    arguments and must return an Obj."""
    import importlib.util
    import os as _os
    if len(args) != 3:
        raise RayError("arity", "loadfn needs lib, name, arity")
    path_o, name_o, arity_o = args
    if name_o.t != -T.SYMBOL:
        raise err_type("loadfn function name must be a symbol")
    arity = int(arity_o.v)
    path = str_of(path_o)
    fname = symbols.name_of(int(name_o.v))
    if path.endswith((".so", ".dylib", ".dll")):
        return _loadfn_cabi(path, fname, arity)
    if _os.path.exists(path):
        spec = importlib.util.spec_from_file_location(
            "_rf_plugin_" + _os.path.basename(path).replace(".", "_"),
            path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    else:
        import importlib
        mod = importlib.import_module(path)
    f = getattr(mod, fname, None)
    if f is None:
        raise err_value(f"no function {fname} in {path}")
    tcode = {1: T.UNARY, 2: T.BINARY}.get(arity, T.VARY)
    if tcode == T.VARY:
        def wrapped(vargs):
            return f(*vargs)
    else:
        wrapped = f
    return Obj(tcode, Builtin(fname, tcode, wrapped, 0))


def _fn_system(o):
    """(system "cmd"): run via the shell with stderr folded in; one
    output line returns a string, many a list of strings, none an
    empty string (reference core/sys.c:362-410)."""
    import subprocess
    if o.t != T.C8:
        raise err_type("system needs a string")
    r = subprocess.run(str_of(o) + " 2>&1", shell=True,
                       capture_output=True)
    lines = r.stdout.decode("utf-8", errors="replace").split("\n")
    if lines and lines[-1] == "":
        lines.pop()
    if not lines:
        return string("")
    if len(lines) == 1:
        return string(lines[0])
    from .obj import list_
    return list_([string(ln) for ln in lines])


def _fn_os_get(o):
    import os
    v = os.environ.get(str_of(o))
    return string(v) if v is not None else NULL_OBJ


def _fn_os_set(k, v):
    import os
    os.environ[str_of(k)] = str_of(v)
    return NULL_OBJ


def _fn_ser(o):
    from ..storage import serde
    return serde.ser_obj(o)


def _fn_de(o):
    from ..storage import serde
    return serde.de_obj(o)


def _fn_env(holder):
    def f(args):
        ip = holder["interp"]
        from .obj import dict_
        ids = np.asarray(sorted(ip.globals.keys()), dtype=np.int64)
        vals = list_([ip.globals[int(i)] for i in ids])
        return dict_(Obj(T.SYMBOL, ids), vals)
    return f


def _fn_args(holder):
    def f(args):
        ip = holder["interp"]
        return list_([string(a) for a in getattr(ip, "cli_args", [])])
    return f


class Runtime:
    """Process-wide engine (reference core/runtime.c runtime_create)."""

    def __init__(self, cli_args=None):
        holder: dict = {}
        self.env = build_env(holder)
        self.interp = Interp(self.env)
        holder["interp"] = self.interp
        self.interp.cli_args = cli_args or []

    def eval_str(self, src: str) -> Obj:
        return self.interp.eval_str(src)

    def format_result(self, o: Obj) -> str:
        s = fmt.format_top(o)
        # the reference's obj_fmt returns the NULL object when nothing
        # was rendered (format.c obj_fmt: dst stays NULL_OBJ), so an
        # empty rendering surfaces as "Null" through format/show
        return s if s else "Null"


def _loadfn_cabi(path: str, fname: str, arity: int):
    """Bind an exported C-ABI plugin function (the reference's dynlib
    `obj_p f(obj_p,...)` surface, core/dynlib.c:191; the ABI here is
    the flat rf_vec view of native/rayforce_plugin.h):

        int f(const rf_vec* args, int32_t nargs, rf_vec* out)
    """
    import ctypes

    class RfVec(ctypes.Structure):
        _fields_ = [("type", ctypes.c_int8),
                    ("len", ctypes.c_int64),
                    ("data", ctypes.c_void_p)]

    lib = ctypes.CDLL(path)
    try:
        cf = getattr(lib, fname)
    except AttributeError:
        raise err_value(f"no symbol {fname} in {path}")
    cf.restype = ctypes.c_int
    cf.argtypes = [ctypes.POINTER(RfVec), ctypes.c_int32,
                   ctypes.POINTER(RfVec)]
    libc = ctypes.CDLL(None)

    OK = {T.U8, T.I16, T.I32, T.I64, T.F64, T.B8, T.DATE, T.TIME,
          T.TIMESTAMP}

    def to_vec(o, keep):
        v = RfVec()
        if o.t < 0:
            st = -o.t
            if st not in OK:
                raise err_type(f"plugin args must be numeric, got {o.t}")
            a = np.ascontiguousarray([o.v], dtype=T.DTYPE[st])
            v.type, v.len = st, -1
        else:
            if o.t not in OK:
                raise err_type(f"plugin args must be numeric, got {o.t}")
            from .obj import to_np
            a = np.ascontiguousarray(to_np(o), dtype=T.DTYPE[o.t])
            v.type, v.len = o.t, len(a)
        keep.append(a)           # pin the buffer across the call
        v.data = a.ctypes.data_as(ctypes.c_void_p).value
        return v

    def from_vec(v):
        t = int(v.type)
        if t not in OK:
            raise err_type(f"plugin returned unsupported type {t}")
        dt = T.DTYPE[t]
        n = int(v.len)
        count = 1 if n < 0 else n
        buf = ctypes.cast(v.data, ctypes.POINTER(ctypes.c_char))
        raw = ctypes.string_at(buf, count * np.dtype(dt).itemsize)
        arr = np.frombuffer(raw, dtype=dt).copy()
        libc.free(ctypes.c_void_p(v.data))
        if n < 0:
            return Obj(-t, arr[0])
        return Obj(t, arr)

    def call(args_list):
        keep = []
        carr = (RfVec * max(len(args_list), 1))(
            *[to_vec(a, keep) for a in args_list])
        out = RfVec()
        rc = cf(carr, len(args_list), ctypes.byref(out))
        if rc != 0:
            raise RayError("user", f"plugin {fname} failed ({rc})")
        return from_vec(out)

    tcode = {1: T.UNARY, 2: T.BINARY}.get(arity, T.VARY)
    if tcode == T.UNARY:
        fn = lambda a: call([a])                      # noqa: E731
    elif tcode == T.BINARY:
        fn = lambda a, b: call([a, b])                # noqa: E731
    else:
        fn = call
    return Obj(tcode, Builtin(fname, tcode, fn, 0))
