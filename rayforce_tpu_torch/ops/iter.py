"""Iteration builtins: map/pmap/map-left/map-right/fold*/scan*/apply
(reference core/iter.c). These are special-formed through the interpreter
because they call back into user lambdas.
"""
from __future__ import annotations

import numpy as np

from ..core import types as T
from ..core.obj import Obj, at_idx, list_, NULL_OBJ
from ..core.errors import err_type, err_length, err_arity
from .compose import unify_list


def _call(interp, f: Obj, args: list) -> Obj:
    from ..core.interp import collect_lazy
    if f.t == T.LAMBDA:
        return interp.call_lambda(f.v, args)
    if f.t in (T.UNARY, T.BINARY, T.VARY):
        b = f.v
        if f.t == T.UNARY:
            if len(args) != 1:
                raise err_arity(f"{b.name}: need 1")
            return b.fn(args[0])
        if f.t == T.BINARY:
            if len(args) != 2:
                raise err_arity(f"{b.name}: need 2")
            return b.fn(args[0], args[1])
        if b.attrs & 4:  # special form can't be mapped
            raise err_type(f"cannot map special form {b.name}")
        return b.fn(args)
    raise err_type("not callable")


def _seq_len(o: Obj):
    return None if o.t < 0 else len(o)


def ray_map(interp, f: Obj, seqs: list) -> Obj:
    n = None
    for s in seqs:
        ln = _seq_len(s)
        if ln is not None:
            if n is None:
                n = ln
            elif n != ln:
                raise err_length("map length mismatch")
    if n is None:
        return _call(interp, f, seqs)
    out = []
    for i in range(n):
        args = [s if s.t < 0 else at_idx(s, i) for s in seqs]
        out.append(_call(interp, f, args))
    return unify_list(out)


def ray_map_left(interp, f: Obj, a: Obj, b: Obj) -> Obj:
    """Map over the LEFT argument, right fixed."""
    if a.t < 0:
        return _call(interp, f, [a, b])
    out = [_call(interp, f, [at_idx(a, i), b]) for i in range(len(a))]
    return unify_list(out)


def ray_map_right(interp, f: Obj, a: Obj, b: Obj) -> Obj:
    if b.t < 0:
        return _call(interp, f, [a, b])
    out = [_call(interp, f, [a, at_idx(b, i)]) for i in range(len(b))]
    return unify_list(out)


def ray_apply(interp, f: Obj, args: list) -> Obj:
    return _call(interp, f, args)


def ray_fold(interp, f: Obj, seqs: list) -> Obj:
    """Reference fold (iter.c ray_fold): unary f maps; binary f loops ONLY
    over LIST operands (typed vectors are atomic operands); with two lists
    zips pairwise into an accumulator."""
    if f.t == T.UNARY:
        if len(seqs) != 1:
            raise err_arity("fold")
        return ray_map(interp, f, seqs)
    if f.t == T.LAMBDA:
        # reference lambda-fold (iter.c ray_fold TYPE_LAMBDA): n==1 reduces
        # any sequence; n==2 seeds from x[0]'s first element and walks x[1]
        n = len(seqs)
        if n == 1:
            x = seqs[0]
            ln = len(x) if x.t >= 0 else 1
            if ln == 0:
                return list_([])
            acc = at_idx(x, 0) if x.t >= 0 else x
            for i in range(1, ln):
                acc = _call(interp, f, [acc, at_idx(x, i)])
            return acc
        if n == 2:
            x, y = seqs
            ln = len(x) if x.t >= 0 else 1
            if ln == 0:
                return list_([])
            acc = at_idx(x, 0) if x.t >= 0 else x
            for i in range(1, ln):
                acc = _call(interp, f, [acc, at_idx(y, i)])
            return acc
        raise err_arity("fold")
    if f.t == T.BINARY or f.t == T.VARY:
        if len(seqs) < 2:
            raise err_arity("fold")
        x, y = seqs[0], seqs[1]
        xl = x.t == T.LIST
        yl = y.t == T.LIST
        if (xl and y.t > 0 and not yl) or (yl and x.t > 0 and not xl):
            lx = len(x)
            if lx != len(y):
                raise err_arity("fold length mismatch")
            if lx == 0:
                return list_([])
            acc = _call(interp, f, [at_idx(x, 0), at_idx(y, 0)])
            for i in range(1, lx):
                acc = _call(interp, f, [acc, at_idx(y, i)])
            return acc
        if xl:
            if len(x) == 0:
                return y
            acc = _call(interp, f, [at_idx(x, 0), y])
            for i in range(1, len(x)):
                acc = _call(interp, f, [acc, at_idx(x, i)])
            return acc
        if yl:
            if len(y) == 0:
                return x
            acc = _call(interp, f, [x, at_idx(y, 0)])
            for i in range(1, len(y)):
                acc = _call(interp, f, [acc, at_idx(y, i)])
            return acc
        return _call(interp, f, [x, y])
    raise err_type("fold needs a function")


def ray_scan(interp, f: Obj, seqs: list) -> Obj:
    """Like fold but collecting intermediate accumulators."""
    if f.t == T.UNARY:
        return ray_map(interp, f, seqs)
    if len(seqs) < 2:
        raise err_arity("scan")
    x, y = seqs[0], seqs[1]
    xl = x.t == T.LIST
    yl = y.t == T.LIST
    out = []
    if (xl and y.t > 0 and not yl) or (yl and x.t > 0 and not xl):
        lx = len(x)
        if lx != len(y):
            raise err_arity("scan length mismatch")
        acc = None
        for i in range(lx):
            acc = _call(interp, f, [at_idx(x, i) if acc is None else acc,
                                    at_idx(y, i)])
            out.append(acc)
        return list_(out)
    if xl:
        acc = y
        for i in range(len(x)):
            acc = _call(interp, f, [at_idx(x, i) if i == 0 else acc,
                                    y if i == 0 else at_idx(x, i)])
            out.append(acc)
        return list_(out)
    if yl:
        acc = x
        for i in range(len(y)):
            acc = _call(interp, f, [acc, at_idx(y, i)])
            out.append(acc)
        return list_(out)
    # non-list args: one application, wrapped as the single
    # intermediate state (oracle: (scan - 100 [1 2 3]) -> ([99 98 97]))
    return list_([_call(interp, f, [x, y])])


def ray_scan_left(interp, f: Obj, seqs: list) -> Obj:
    """States [args1, f(args0, args1), f(prev, args2), ...]
    (oracle: (scan-left - 100 [1 2 3]) -> ([1 2 3] [99 98 97]))."""
    if len(seqs) < 2:
        raise err_arity("scan-left")
    out = [seqs[1]]
    acc = _call(interp, f, [seqs[0], seqs[1]])
    out.append(acc)
    for s in seqs[2:]:
        acc = _call(interp, f, [acc, s])
        out.append(acc)
    return list_(out)


def ray_fold_right(interp, f: Obj, seqs: list) -> Obj:
    """acc = init; per element LEFT-to-right acc = f(elem, acc)
    (oracle: (fold-right - 0 [1 2 3 4]) -> 2 — NOT right-assoc)."""
    if len(seqs) < 2:
        raise err_arity("fold-right")
    x, y = seqs[0], seqs[1]
    if y.t == T.LIST or (y.t > 0 and y.t != T.DICT):
        acc = x
        for i in range(len(y)):
            acc = _call(interp, f, [at_idx(y, i), acc])
        return acc
    return _call(interp, f, [x, y])


def ray_scan_right(interp, f: Obj, seqs: list) -> Obj:
    """fold-right states INCLUDING the initial accumulator
    (oracle: (scan-right - 0 [1 2 3]) -> (0 1 1 2))."""
    if len(seqs) < 2:
        raise err_arity("scan-right")
    x, y = seqs[0], seqs[1]
    if y.t == T.LIST or (y.t > 0 and y.t != T.DICT):
        out = [x]
        acc = x
        for i in range(len(y)):
            acc = _call(interp, f, [at_idx(y, i), acc])
            out.append(acc)
        return list_(out)
    return list_([_call(interp, f, [x, y])])


def _to_host(o: Obj) -> None:
    """Materialize every device-resident payload inside o."""
    if o.pending() is not None:
        o.v   # the property materializes it
    if o.t == T.TABLE:
        for c in o.v[1]:
            _to_host(c)
    elif o.t == T.DICT:
        _to_host(o.v[0])
        _to_host(o.v[1])
    elif o.t == T.LIST:
        for x in o.v:
            _to_host(x)


def _pmap_procs(interp, f: Obj, seqs: list, n: int) -> Obj:
    """Process-pool pmap for LAMBDA bodies: forked children inherit
    the interpreter state (globals, env) for free — the reference's
    per-executor VMs (iter.c:135-173) with OS processes standing in
    for executors, so pure-interpreter work scales past the GIL.
    Each child evaluates a contiguous chunk with the DEVICE ENGINE
    DISABLED (children never touch CUDA state across fork — host
    kernels are the correctness path) and ships results back over a
    pipe as serde frames. Any child failure raises and the caller
    falls back to the thread pool."""
    import os as _os
    import struct
    from ..storage import serde

    wenv = _os.environ.get("RAYFORCE_PMAP_WORKERS")
    workers = min(int(wenv) if wenv else (_os.cpu_count() or 1),
                  8, n)
    if workers < 2 or n < 8:
        raise RuntimeError("not worth forking")
    bounds = [(k * n) // workers for k in range(workers + 1)]
    # a forked child must never touch CUDA: bring every device-resident
    # operand to the host before forking
    for s in seqs:
        _to_host(s)
    kids = []
    for k in range(workers):
        rfd, wfd = _os.pipe()
        pid = _os.fork()
        if pid == 0:
            _os.close(rfd)
            code = 1
            try:
                from ..engine import device as _dev
                _dev.set_enabled(False)
                wk = interp.fork()
                frames = []
                for i in range(bounds[k], bounds[k + 1]):
                    args = [s if s.t < 0 else at_idx(s, i)
                            for s in seqs]
                    frames.append(serde.ser_payload(
                        _call(wk, f, args)))
                blob = b"".join(struct.pack("<Q", len(fr)) + fr
                                for fr in frames)
                hdr = struct.pack("<Q", len(blob))
                for chunk in (hdr, blob):
                    off = 0
                    while off < len(chunk):
                        off += _os.write(wfd, chunk[off:off + 65536])
                code = 0
            except BaseException:
                code = 1
            finally:
                try:
                    _os.close(wfd)
                except OSError:
                    pass
                _os._exit(code)
        _os.close(wfd)
        kids.append((pid, rfd))

    out: list = [None] * n
    fail = False
    try:
        for k, (pid, rfd) in enumerate(kids):
            data = bytearray()
            while True:
                b = _os.read(rfd, 1 << 20)
                if not b:
                    break
                data += b
            _os.close(rfd)
            _pid, status = _os.waitpid(pid, 0)
            if status != 0 or len(data) < 8:
                fail = True
                continue
            total = struct.unpack("<Q", data[:8])[0]
            if total != len(data) - 8:
                fail = True
                continue
            off = 8
            for i in range(bounds[k], bounds[k + 1]):
                ln = struct.unpack("<Q", data[off:off + 8])[0]
                off += 8
                out[i] = serde.de_payload(bytes(data[off:off + ln]),
                                          env=interp.env)
                off += ln
    except Exception:
        fail = True
    if fail:
        raise RuntimeError("pmap process path failed")
    return unify_list(out)


def ray_pmap(interp, f: Obj, seqs: list) -> Obj:
    """Parallel map (reference iter.c:135-173 ray_pmap: each item runs
    on an executor with its own VM). LAMBDA bodies take the PROCESS
    pool (_pmap_procs: fork + serde pipes — pure-interpreter work
    scales past the GIL like the reference's executors); builtins and
    any process-path failure take chunked THREADS with forked
    interpreters (own frame/qctx stacks, shared globals), where
    numpy/torch kernels release the GIL."""
    n = None
    for s in seqs:
        ln = _seq_len(s)
        if ln is not None:
            if n is None:
                n = ln
            elif n != ln:
                raise err_length("pmap length mismatch")
    if n is None:
        return _call(interp, f, seqs)
    if n < 2:
        return ray_map(interp, f, seqs)
    if f.t == T.LAMBDA and hasattr(__import__("os"), "fork"):
        try:
            return _pmap_procs(interp, f, seqs, n)
        except Exception:
            pass        # any process-path failure -> thread fallback
    import concurrent.futures as cf
    workers = min(8, n)
    bounds = [(k * n) // workers for k in range(workers + 1)]
    out: list = [None] * n

    def run_chunk(k):
        w = interp.fork()
        for i in range(bounds[k], bounds[k + 1]):
            args = [s if s.t < 0 else at_idx(s, i) for s in seqs]
            out[i] = _call(w, f, args)

    with cf.ThreadPoolExecutor(max_workers=workers) as ex:
        futs = [ex.submit(run_chunk, k) for k in range(workers)]
        for fu in futs:
            fu.result()
    return unify_list(out)
