"""Construction ops: til/reverse/dict/table/list/enlist/enum/concat/take/
distinct/group/raze/unify/diverse/split/rand/guid (reference core/compose.c).
"""
from __future__ import annotations

import numpy as np

from ..core import types as T
from ..core import symbols
from ..core.obj import (Obj, to_np, list_, dict_, table, vector, string,
                        at_idx, enum as mk_enum, NULL_OBJ, atom_null)
from ..core.errors import err_type, err_length, err_domain, err_value


def ray_til(o: Obj) -> Obj:
    if o.t >= 0 or -o.t not in (T.I16, T.I32, T.I64, T.U8):
        raise err_type("til needs an integer atom")
    n = int(o.v)
    if n < 0:
        raise err_domain("til of negative")
    return Obj(T.I64, np.arange(n, dtype=np.int64))


def ray_reverse(o: Obj) -> Obj:
    if o.t == T.LIST:
        return list_(list(reversed(o.v)))
    if o.t == T.DICT:
        # superset: the reference type-errors on dict/table reverse
        k, v = o.v
        return dict_(ray_reverse(k), ray_reverse(v))
    if o.t == T.TABLE:
        names, cols = o.v
        return table(names, [ray_reverse(c) for c in cols])
    if o.t in T.UNPARTED_OF:
        from .parted import parted_raze
        return ray_reverse(parted_raze(o))
    if o.t < 0:
        return o
    return Obj(o.t, to_np(o)[::-1].copy(), domain=o.domain)


def ray_list(args: list) -> Obj:
    return list_(args)


def unify_list(items: list) -> Obj:
    """Collapse a LIST of same-type atoms into a typed vector (reference
    unify_list). Returns LIST unchanged if heterogeneous."""
    if not items:
        return list_(items)
    t0 = items[0].t
    if t0 < 0 and t0 != -T.NULL and all(x.t == t0 for x in items):
        st = -t0
        if st == T.GUID:
            return Obj(T.GUID, np.stack([np.asarray(x.v) for x in items]))
        if st == T.ENUM:
            dom = items[0].domain
            if all(x.domain is dom for x in items):
                return mk_enum(dom, [int(x.v) for x in items])
            return list_(items)
        if st in T.DTYPE:
            return vector(st, [x.v for x in items])
    return list_(items)


def ray_enlist(args: list) -> Obj:
    return unify_list(args)


def ray_dict(k: Obj, v: Obj) -> Obj:
    if k.t < 0 or v.t < 0:
        raise err_type("dict needs vectors")
    if len(k) != len(v):
        raise err_length("dict keys/vals length mismatch")
    return dict_(k, v)


def ray_table(names: Obj, cols: Obj) -> Obj:
    if names.t != T.SYMBOL:
        raise err_type("table needs symbol column names")
    if cols.t != T.LIST:
        if T.is_vector(cols.t):
            cols = list_([cols])
        else:
            raise err_type("table needs a list of columns")
    colv = list(cols.v)
    if len(names) != len(colv):
        raise err_length("table names/columns length mismatch")
    n = None
    for c in colv:
        if c.t < 0:
            continue
        cl = len(c)
        if n is None:
            n = cl
        elif cl != n:
            raise err_length("table column length mismatch")
    if n is None:
        n = 1
    # broadcast atoms to columns; enum columns materialize to symbols
    for i, c in enumerate(colv):
        if c.t < 0:
            colv[i] = take_n(c, n)
        if colv[i].t == T.ENUM:
            from .items import ray_value
            colv[i] = ray_value(colv[i])
    return table(names, colv)


def take_n(o: Obj, n: int) -> Obj:
    """(take x n): repeat/truncate to length n (reference items.c ray_take
    with repeat)."""
    if o.t < 0:
        st = -o.t
        if st == T.GUID:
            return Obj(T.GUID, np.tile(np.asarray(o.v), (n, 1)))
        if st == T.ENUM:
            return mk_enum(o.domain, np.full(n, int(o.v), dtype=np.int64))
        if st in T.DTYPE:
            return Obj(st, np.full(n, o.v, dtype=T.DTYPE[st]))
        if st == T.NULL:
            return list_([NULL_OBJ] * n)
        return list_([o] * n)
    ln = len(o)
    if ln == 0:
        if o.t == T.LIST:
            return list_([])
        return Obj(o.t, to_np(o)[:0], domain=o.domain)
    idx = np.arange(n, dtype=np.int64) % ln
    return gather(o, idx)


def gather(o: Obj, idx: np.ndarray) -> Obj:
    """Positional gather (at_ids analogue)."""
    if o.t == T.LIST:
        return list_([o.v[int(i)] for i in idx])
    if o.t == T.TABLE:
        names, cols = o.v
        return table(names, [gather(c, idx) for c in cols])
    if o.t == T.DICT:
        k, v = o.v
        return dict_(k, gather(v, idx))
    if o.t in (T.MAPFILTER, T.MAPGROUP):
        from ..core.interp import collect_lazy
        return gather(collect_lazy(o), idx)
    if o.t in T.UNPARTED_OF:
        from .parted import parted_raze
        return gather(parted_raze(o), idx)
    a = to_np(o)
    n = len(a)
    idx = np.asarray(idx, dtype=np.int64)
    oob = (idx < 0) | (idx >= n)
    if oob.any():
        safe = np.where(oob, 0, idx)
        r = a[safe]
        t = o.t
        if t in T.NULL_BY_TYPE:
            r = np.where(oob, T.NULL_BY_TYPE[t], r)
        elif t == T.ENUM:
            r = np.where(oob, T.NULL_I64, r)
        elif t == T.GUID:
            r[oob] = 0
        else:
            r = np.where(oob, 0, r)
        return Obj(o.t, r, domain=o.domain)
    return Obj(o.t, a[idx], domain=o.domain)


def ray_concat(a: Obj, b: Obj) -> Obj:
    if a.t == T.DICT and b.t == T.DICT:
        # keyed merge, right wins (oracle-pinned: (concat {a:1}
        # {b:2 a:9}) -> {a:9 b:2})
        ka, va = a.v
        kb, vb = b.v
        keys = [int(s) for s in to_np(ka)]
        vals = list(va.v)
        pos = {s: i for i, s in enumerate(keys)}
        nb = to_np(kb)
        for i in range(len(nb)):
            s = int(nb[i])
            if s in pos:
                vals[pos[s]] = vb.v[i]
            else:
                pos[s] = len(keys)
                keys.append(s)
                vals.append(vb.v[i])
        return dict_(Obj(T.SYMBOL, np.asarray(keys, dtype=np.int64)),
                     list_(vals))
    if a.t == T.TABLE and b.t == T.TABLE:
        # row append; schemas must carry the same column names
        na, ca = a.v
        nb_o, cb = b.v
        ia = [int(s) for s in to_np(na)]
        ib = [int(s) for s in to_np(nb_o)]
        if set(ia) != set(ib):
            raise err_value("concat: mismatched table schemas")
        order = {s: i for i, s in enumerate(ib)}
        cols = [ray_concat(ca[i], cb[order[ia[i]]])
                for i in range(len(ia))]
        return table(na, cols)
    la = a.v if a.t == T.LIST else None
    lb = b.v if b.t == T.LIST else None
    if la is not None or lb is not None:
        ea = la if la is not None else (list(_elems(a)))
        eb = lb if lb is not None else (list(_elems(b)))
        return list_(ea + eb)
    if a.t < 0 and b.t < 0:
        return unify_list([a, b])
    ba, bb = abs(a.t), abs(b.t)
    compat = ba == bb and (ba != T.ENUM or a.domain is b.domain)
    if not compat:
        # incompatible operands -> 2-element list, atoms STAY atoms
        # (oracle-pinned: (concat "ab" 'c) -> ("ab" c))
        return list_([a, b])
    if a.t < 0:
        a = take_n(a, 1)
    if b.t < 0:
        b = take_n(b, 1)
    return Obj(a.t, np.concatenate([to_np(a), to_np(b)]),
               domain=a.domain if a.t == T.ENUM else None)


def _elems(o: Obj):
    if o.t < 0:
        yield o
    else:
        for i in range(len(o)):
            yield at_idx(o, i)


def ray_distinct(o: Obj) -> Obj:
    if o.t < 0:
        return o
    if o.t in T.UNPARTED_OF:
        # parted column: raze partitions first; parted ENUMs expand to
        # plain symbols (the reference's MAPLIST/PARTED distinct
        # expands mmap'd enums to values before distinct,
        # compose.c:1036, unlike in-memory enums which re-enumerate)
        from .parted import parted_raze
        r = parted_raze(o)
        if r.t == T.ENUM:
            from ..core.obj import enum_domain
            dom = to_np(enum_domain(r))
            r = Obj(T.SYMBOL, dom[to_np(r)])
        return ray_distinct(r)
    if o.t == T.LIST:
        seen = []
        from .cmp import obj_equal
        for e in o.v:
            if not any(obj_equal(e, s) for s in seen):
                seen.append(e)
        return list_(seen)
    a = to_np(o)
    if o.t == T.GUID:
        _, idx = np.unique(a, axis=0, return_index=True)
        return Obj(T.GUID, a[np.sort(idx)])
    if o.t in (T.B8, T.U8, T.I16, T.I32, T.I64, T.DATE, T.TIME,
               T.TIMESTAMP):
        # integer distinct scans a dense bitmap -> ascending value order
        # (reference index_distinct_*, index.c:437-671)
        return Obj(o.t, np.unique(a), domain=o.domain)
    _, idx = np.unique(a, return_index=True)
    out = a[np.sort(idx)]
    return Obj(o.t, out, domain=o.domain)


def ray_group(o: Obj) -> Obj:
    """value -> indices dict, first-appearance order (compose.c:1071)."""
    if o.t < 0:
        raise err_type("group needs a vector")
    if o.t in T.UNPARTED_OF:
        from .parted import parted_raze
        return ray_group(parted_raze(o))
    if o.t == T.LIST:
        # generic-object grouping (reference compose.c:1071 groups via
        # index_group over the list's row hashes): first-appearance
        # keys (unique elements, LIST) -> i64 index vectors
        from .cmp import obj_equal
        keys: list = []
        groups: list = []
        for i, e in enumerate(o.v):
            for gi, kx in enumerate(keys):
                if obj_equal(kx, e):
                    groups[gi].append(i)
                    break
            else:
                keys.append(e)
                groups.append([i])
        return dict_(list_(keys),
                     list_([Obj(T.I64, np.asarray(g, dtype=np.int64))
                            for g in groups]))
    a = to_np(o)
    uniq, first_idx, inv = np.unique(a, return_index=True,
                                     return_inverse=True)
    order = np.argsort(first_idx, kind="stable")
    remap = np.empty(len(uniq), dtype=np.int64)
    remap[order] = np.arange(len(uniq))
    gids = remap[inv]
    keys = Obj(o.t, uniq[order], domain=o.domain)
    groups = []
    sort_by_gid = np.argsort(gids, kind="stable")
    bounds = np.searchsorted(gids[sort_by_gid],
                             np.arange(len(uniq)))
    bounds = np.append(bounds, len(a))
    for g in range(len(uniq)):
        groups.append(Obj(T.I64, np.asarray(
            sort_by_gid[bounds[g]:bounds[g + 1]], dtype=np.int64)))
    return dict_(keys, list_(groups))


def ray_enum(name: Obj, vals: Obj, interp=None) -> Obj:
    """(enum 'global-name syms): the domain is a NAMED global symbol
    vector; the enum stores indices into it (compose.c ray_enum:389,
    enumerate). The name indirection is what makes shared sym-files work
    for splayed/parted tables."""
    if name.t != -T.SYMBOL:
        raise err_type("enum domain must be a symbol name")
    if vals.t not in (T.SYMBOL, -T.SYMBOL):
        raise err_type("enum values must be symbols")
    if interp is None:
        from ..core.interp import current_interp
        interp = current_interp()
    domain = interp.resolve(int(name.v)) if interp else None
    if domain is None or domain.t != T.SYMBOL:
        raise err_type("enum domain global must be a symbol vector")
    if vals.t == -T.SYMBOL:
        ids = _enum_ids(domain, np.asarray([vals.v]))
        return Obj(-T.ENUM, np.int64(ids[0]), domain=name)
    ids = _enum_ids(domain, to_np(vals))
    return Obj(T.ENUM, np.asarray(ids, dtype=np.int64), domain=name)


def _enum_ids(domain: Obj, sym_ids: np.ndarray) -> np.ndarray:
    dom = to_np(domain)
    pos = {int(s): i for i, s in enumerate(dom)}
    out = np.empty(len(sym_ids), dtype=np.int64)
    for i, s in enumerate(sym_ids):
        if int(s) not in pos:
            raise err_domain("value not in enum domain")
        out[i] = pos[int(s)]
    return out


def ray_rand(n: Obj, spec: Obj) -> Obj:
    """(rand n x): n random values below x / from vector x."""
    if n.t >= 0:
        raise err_type("rand count must be an atom")
    cnt = int(n.v)
    if spec.t < 0:
        st = -spec.t
        if st in (T.I16, T.I32, T.I64):
            return Obj(T.I64, np.random.randint(0, max(1, int(spec.v)),
                                                size=cnt).astype(np.int64))
        if st == T.F64:
            return Obj(T.F64, np.random.uniform(0, float(spec.v), size=cnt))
        raise err_type("rand spec")
    idx = np.random.randint(0, max(1, len(spec)), size=cnt)
    return gather(spec, idx.astype(np.int64))


def ray_guid(o: Obj) -> Obj:
    if o.t >= 0:
        raise err_type("guid needs an atom count")
    n = int(o.v)
    data = np.random.randint(0, 256, size=(n, 16), dtype=np.int64) \
        .astype(np.uint8)
    return Obj(T.GUID, data)


def ray_raze(o: Obj) -> Obj:
    if o.t in T.UNPARTED_OF:
        from .parted import parted_raze
        return parted_raze(o)
    if o.t != T.LIST:
        return o
    items = o.v
    if not items:
        return list_([])
    out = items[0]
    for e in items[1:]:
        out = ray_concat(out, e)
    if out.t == T.LIST:
        # the reference's raze unifies the merged rows when they are
        # same-type atoms ((raze (list (list 1 2) (list 3))) -> [1 2 3],
        # oracle-pinned); mixed content stays a LIST
        return unify_list(out.v)
    return out


def ray_unify(o: Obj) -> Obj:
    if o.t != T.LIST:
        return o
    return unify_list(o.v)


def ray_diverse(o: Obj) -> Obj:
    if o.t == T.LIST or o.t < 0:
        return o
    return list_(list(_elems(o)))


def ray_remove(o: Obj, idx: Obj) -> Obj:
    if o.t < 0:
        raise err_type("remove from atom")
    n = len(o)
    if idx.t < 0:
        kill = {int(idx.v)}
    else:
        kill = {int(i) for i in to_np(idx)}
    keep = np.asarray([i for i in range(n) if i not in kill],
                      dtype=np.int64)
    return gather(o, keep)


def ray_split(o: Obj, sep: Obj) -> Obj:
    """(split str sep); splitting a vector by indices = cut
    (compose.c ray_split:1345)."""
    from ..core.obj import str_of
    if o.t == T.C8 or o.t == -T.SYMBOL:
        s = str_of(o)
        if sep.t == T.C8:
            d = str_of(sep)
        elif sep.t == -T.C8:
            d = chr(int(sep.v))
        else:
            raise err_type("split separator must be chars")
        parts = s.split(d)
        return list_([string(p) for p in parts])
    if o.t > 0 and o.t != T.LIST:
        return ray_cut(o, sep)
    raise err_type("split needs a string")


def ray_cut(o: Obj, at: Obj) -> Obj:
    idx = to_np(at) if at.t > 0 else np.asarray([int(at.v)])
    n = len(o)
    outs = []
    for i, st in enumerate(idx):
        en = idx[i + 1] if i + 1 < len(idx) else n
        outs.append(gather(o, np.arange(int(st), int(en), dtype=np.int64)))
    return list_(outs)
