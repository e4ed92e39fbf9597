"""The engine's flagship step as a standalone entry point: the fused
filter + group + aggregate pipeline of the grouped select, on torch
tensors.

    from rayforce_tpu_torch.entry import entry
    step, args = entry()            # args on the card
    sums, counts, min_price, first_row = step(*args)

`entry(device="cpu")` puts the arguments on the CPU instead.

`dryrun_multichip(n)` runs a whole distributed query step once, at tiny
shapes, over an n-shard mesh: the mesh kernels of parallel/dist.py and
Rayfall selects, joins, a table sort and a window join through the
interpreter, each held against numpy or the host path.
"""
from __future__ import annotations

import numpy as np
import torch

from .engine import device as dev
from .engine import groupby as G

N_GROUPS = 100


def step(keys, values, prices):
    """Where prices > 50: per key in [0, N_GROUPS), the sum of values
    and the row count (exact integer segment sums), the least price and
    the first row id (KEY_MAX for a key with no row). Masked rows go to
    the trash code N_GROUPS."""
    n = keys.shape[0]
    codes = torch.where(prices > 50.0, keys.to(torch.int32), N_GROUPS)
    bc = G.dense_scan(
        codes, N_GROUPS, n,
        tasks=[values, torch.ones(n, dtype=torch.int32, device=keys.device)],
        mins=(prices.to(torch.float64),), want_counts=False, want_fidx=True)
    return bc["task0"], bc["task1"], bc["min0"], bc["fidx"]


def entry(device=None):
    """(step, args): args are 4096 seeded rows (keys i32 in [0, 100),
    values i32 in [0, 100), prices f32 in [0, 100)) on `device` (the
    engine's device when None)."""
    d = torch.device(device) if device is not None else dev.device()
    n = 4096
    rng = np.random.default_rng(0)
    args = (rng.integers(0, N_GROUPS, n).astype(np.int32),
            rng.integers(0, 100, n).astype(np.int32),
            rng.uniform(0, 100, n).astype(np.float32))
    return step, tuple(torch.from_numpy(a).to(d) for a in args)


def check_kernels(m, rng):
    """The raw mesh kernels on mesh `m` (one process or several: every
    result is read replicated) against numpy: the fused filter + group
    sum, counts, and the all_to_all key shuffle."""
    from .parallel import dist
    n_dev = m.n
    n_codes = 16
    rows_per = 64
    n = rows_per * n_dev
    codes = rng.integers(0, n_codes, n).astype(np.int32)
    values = rng.uniform(0, 10, n).astype(np.float64)
    mask = rng.random(n) > 0.3

    codes_d, _ = dist.shard_rows(m, codes)
    values_d, _ = dist.shard_rows(m, values)
    mask_d, _ = dist.shard_rows(m, mask)
    s, _cnt = dist.dist_filter_group_sum(m, n_codes)(codes_d, values_d,
                                                     mask_d)
    ref = np.zeros(n_codes)
    np.add.at(ref, codes[mask], values[mask])
    if not np.allclose(s.cpu().numpy()[:n_codes], ref):
        raise AssertionError("distributed group-sum mismatch")

    cnt2, _fidx = dist.dist_groupby_count_first(m, n_codes, rows_per)(
        codes_d)
    if not np.array_equal(cnt2.cpu().numpy()[:n_codes],
                          np.bincount(codes, minlength=n_codes)):
        raise AssertionError("distributed count mismatch")

    keys = rng.integers(0, 1000, n).astype(np.int64)
    vals = rng.integers(0, 100, n).astype(np.int64)
    keys_d, _ = dist.shard_rows(m, keys)
    vals_d, _ = dist.shard_rows(m, vals)
    rk, _rv, valid, ovf = dist.dist_shuffle(m, capacity=rows_per * 2)(
        keys_d, vals_d)
    if int(ovf[0]) != 0:
        raise AssertionError("shuffle overflowed")
    size = n_dev * rows_per * 2
    rk = dist.unshard(rk, n_dev * size).cpu().numpy().reshape(n_dev, -1)
    valid = dist.unshard(valid, n_dev * size).cpu().numpy() \
        .reshape(n_dev, -1)
    for d in range(n_dev):
        if not (rk[d][valid[d]] % n_dev == d).all():
            raise AssertionError("shuffle routing broken")
    if int(valid.sum()) != n:
        raise AssertionError("shuffle dropped rows")


def check_probes(m, rng, device):
    """The three join probes on mesh `m` against numpy: the broadcast
    build, the partitioned build and the asof ring."""
    from .parallel import dist
    n_dev = m.n
    nl = n_dev * 64
    lk = rng.integers(0, 300, nl).astype(np.int64)
    rk = rng.permutation(600)[:200].astype(np.int64)
    lkd, _ = dist.shard_rows(m, lk)
    rid, has = dist.dist_left_probe(m)(lkd, torch.from_numpy(rk).to(device))
    rid = dist.unshard(rid, nl).cpu().numpy()
    has = dist.unshard(has, nl).cpu().numpy()
    pos = {k: i for i, k in enumerate(rk)}
    for i in range(nl):
        if (lk[i] in pos) != bool(has[i]) or \
                (has[i] and rid[i] != pos[lk[i]]):
            raise AssertionError("join probe broken")

    rk_big = rng.integers(0, 500, nl).astype(np.int64)
    ovl, ovr, ovb, rid2, has2 = dist.dist_eq_probe(m, nl, 64, 64)(
        lkd, dist.shard_rows(m, rk_big)[0])
    if int(ovl[0]) or int(ovr[0]) or int(ovb[0]):
        raise AssertionError("eq probe overflowed")
    rid2 = dist.unshard(rid2, nl).cpu().numpy()
    has2 = dist.unshard(has2, nl).cpu().numpy()
    first = {}
    for i, k in enumerate(rk_big):
        first.setdefault(int(k), i)
    for i in range(0, nl, 13):
        k = int(lk[i])
        if (k in first) != bool(has2[i]) or \
                (has2[i] and rid2[i] != first[k]):
            raise AssertionError("partitioned probe broken")

    lt = rng.integers(0, 1 << 20, nl).astype(np.int64)
    rk2 = rng.integers(0, 12, nl).astype(np.int64)
    rt2 = rng.integers(0, 1 << 20, nl).astype(np.int64)
    rv2 = rng.uniform(0, 1, nl)
    val, hit = dist.dist_asof_probe(m)(*(dist.shard_rows(m, x)[0] for x in
                                         (lk % 12, lt, rk2, rt2, rv2)))
    val = dist.unshard(val, nl).cpu().numpy()
    hit = dist.unshard(hit, nl).cpu().numpy()
    order = np.lexsort((rt2, rk2))
    rks, rts, rvs = rk2[order], rt2[order], rv2[order]
    for i in range(0, nl, 17):
        mm = (rks == lk[i] % 12) & (rts <= lt[i])
        if mm.any() != bool(hit[i]) or \
                (hit[i] and abs(val[i] - rvs[np.nonzero(mm)[0][-1]]) > 1e-12):
            raise AssertionError("asof probe mismatch")


# the interpreter's steps of dryrun_multichip: (name, query, the engine
# the mesh runs, the engine's profile)
DRYRUN_QUERIES = [
    ("spmd", "(select {s: (sum v) a: (avg w) mx: (max w) c: (count v) "
             "from: t by: k where: (> w 1.0)})", "spmd", "select"),
    ("dist_group", "(select {s: (sum v) c: (count v) mx: (max v) "
                   "mn: (min v) from: t2 by: hk})", "dist-group", "select"),
    ("dist_sort", "(xasc t [k w])", "dist-sort", "sort"),
    ("dist_wjoin", "(window-join [s ts] (map-left + [-500 500] (at wt 'ts)) "
                   "wt wq {mx: (max px) s: (sum px) c: (count px)})",
     "dist-wjoin", "wjoin"),
]


def dryrun_tables(rng, n_devices):
    """{name: table} of DRYRUN_QUERIES, row counts not divisible by the
    shard count."""
    from .core import types as T
    from .core.obj import Obj, table, vec_sym

    def tbl(cols):
        return table(vec_sym(list(cols)), [Obj(t, a) for a, t in
                                           cols.values()])
    nn, nn2 = n_devices * 97 + 3, n_devices * 257 + 1
    nwl, nwr = n_devices * 40 + 1, n_devices * 70 + 3
    return {
        "t": tbl({"k": (rng.integers(0, 11, nn).astype(np.int64), T.I64),
                  "v": (rng.integers(-5, 20, nn).astype(np.int64), T.I64),
                  "w": (rng.uniform(0, 10, nn), T.F64)}),
        "t2": tbl({"hk": (rng.integers(0, 700, nn2).astype(np.int64),
                          T.I64),
                   "v": (rng.uniform(0, 5, nn2), T.F64)}),
        "wt": tbl({"s": (rng.integers(0, 9, nwl).astype(np.int64), T.I64),
                   "ts": (np.sort(rng.integers(0, 10_000, nwl))
                          .astype(np.int64), T.I64)}),
        "wq": tbl({"s": (rng.integers(0, 9, nwr).astype(np.int64), T.I64),
                   "ts": (np.sort(rng.integers(0, 10_000, nwr))
                          .astype(np.int64), T.I64),
                   "px": (rng.uniform(1, 100, nwr), T.F64)}),
    }


def engine_of(kind):
    """The engine the last query of `kind` ran ("spmd" for the dense plan
    on a mesh)."""
    from .engine import join as ej
    from .engine import select as sel
    from .engine import sort as es
    from .engine import wjoin as ew
    prof = {"select": sel.last_profile, "join": ej.last_profile,
            "sort": es.last_profile, "wjoin": ew.last_profile}[kind]
    if "dispatch_ms" in prof:
        return "spmd" if prof.get("spmd") else "dense"
    return prof.get("engine", "host")


def dryrun_multichip(n_devices: int, device=None) -> None:
    """A whole distributed query step over an n_devices-shard mesh on
    `device` (the engine's when None), run once at tiny shapes, as the
    reference's `dryrun_multichip`: the mesh kernels against numpy, and
    each of DRYRUN_QUERIES through the interpreter, where it must run its
    mesh engine and equal the host path. The engine's settings and mesh
    are restored afterwards."""
    import os

    from . import Runtime
    from .core import symbols
    from .core.fmt import format_top
    from .parallel import dist

    d = torch.device(device) if device is not None else dev.device()
    rng = np.random.default_rng(0)
    m = dist.make_mesh(n_devices, device=d)
    check_kernels(m, rng)
    check_probes(m, rng, d)

    saved_cfg, saved_mesh = dict(dev._cfg), dict(dev._mesh_state)
    saved_env = os.environ.get("RAYFORCE_MESH")
    os.environ["RAYFORCE_MESH"] = str(n_devices)
    dev._mesh_state.update({"mesh": None, "checked": False})
    try:
        dev.set_device(d)
        dev.set_threshold(1)
        if dev.mesh() is None:
            raise AssertionError("mesh mode failed to initialize")
        rt = Runtime()
        for name, tbl in dryrun_tables(rng, n_devices).items():
            rt.interp.globals[symbols.intern(name)] = tbl
        for name, q, want, kind in DRYRUN_QUERIES:
            got = format_top(rt.eval_str(q))
            if engine_of(kind) != want:
                raise AssertionError(f"{name}: ran {engine_of(kind)}, not "
                                     f"{want}")
            dev.set_enabled(False)
            try:
                host = format_top(rt.eval_str(q))
            finally:
                dev.set_enabled(True)
            if got != host:
                raise AssertionError(f"{name}: the mesh differs from the "
                                     "host path")
    finally:
        if saved_env is None:
            os.environ.pop("RAYFORCE_MESH", None)
        else:
            os.environ["RAYFORCE_MESH"] = saved_env
        dev._cfg.clear()
        dev._cfg.update(saved_cfg)
        dev._mesh_state.clear()
        dev._mesh_state.update(saved_mesh)
    print(f"dryrun_multichip({n_devices}): ok (mesh kernels + SPMD select "
          "+ distributed group-by, sort and window join)")
