"""Multi-shard kernels over an in-process device mesh.

The reference scales within one node via a pinned thread pool with
chunk-parallel kernels and merge steps (core/pool.c pool_map,
core/index.c index_group_distribute, core/aggr.c AGGR_COLLECT). Here the
same decompositions run over a mesh of N shards driven by one process:

- rows are sharded over the mesh axis ("d"), shard i holding rows
  [i * rows_local, (i + 1) * rows_local) of the table padded to a
  multiple of N, the shards spread over the visible cards (8 shards
  share one card, or CPU torch in the tests);
- group-by computes per-shard dense partial aggregates and combines them
  with `psum` / `pmin` / `pmax`, the analogue of per-thread partial
  vectors + the AGGR_COLLECT pairwise merge (aggr.c:163-181);
- high-cardinality group-bys and medians route partials or rows by code
  with `all_to_all`, the analogue of the radix partition scatter
  (index.c:2556-2729);
- table sorts route rows by sampled splitter ranges, joins and window
  joins by key (or replicate a small right side, or rotate sorted right
  shards around a ring for asof), and results go back to each row's
  owner shard (`_route_back`).

A collective is a plain function over the list of per-shard tensors. Its
reductions run in the fixed shard order 0..N-1, so a rerun is bit for bit
the same; a move between shards is `.to(device)`, a device-local copy
where the shards share a device. A kernel whose collectives fall in the
middle is a sequence of stages, each a loop over the shards, with the
collective between them. A replicated result is computed on each
process, on its first shard's device. Every sort goes through the
engine's psort entry, so on the card each is a launch of the CUDA radix
sort.

Each collective is recorded as the span "mesh: <name>" (core/
profiler.py), and `moved` counts the bytes it copies from one card to
another, where `stats` models what a ring would move.

The mesh may span P processes (engine/device.py starts them under
RAYFORCE_COORDINATOR): each process then holds N / P contiguous shards,
its per-shard lists hold None at the others', its stages run over its
own shards only, and each collective is one torch.distributed call that
crosses the process boundary. Every process computes every replicated
value the same way, so every process takes the same capacity retries
and gets the one-process mesh's answer bit for bit.
"""
from __future__ import annotations

import ctypes
import functools
import math
import time

import numpy as np
import torch
import torch.distributed as td

from ..core import profiler as prof
from ..engine import groupby as G
from ..engine import psort
from ..engine.device import DeviceError
from ..engine.psort import (LAUNCHES, _LAUNCHES_LOCK, f64_from_order,
                            f64_order, sort_lex)

I32, I64, F64, BOOL = torch.int32, torch.int64, torch.float64, torch.bool
KEY_MAX = G.KEY_MAX
I64_MIN = G.I64_MIN

# -- exchange accounting ------------------------------------------------------
#
# Every distributed kernel notes its per-invocation cross-shard traffic
# under the standard ring-algorithm cost model, the same formulas as the
# reference's, so a query reports the bytes a multi-device mesh would
# move:
#   all_to_all of per-shard buffer B bytes -> B*(n-1) total on the wire
#   psum/pmin/pmax of replicated result R  -> 2*R*(n-1)
#   all_gather of per-shard shard S        -> n*(n-1)*S

stats = {"exchanged_bytes": 0, "kernel_calls": 0}


def reset_stats():
    stats["exchanged_bytes"] = 0
    stats["kernel_calls"] = 0


# the bytes the in-process collectives copy from one card to another
# (`_move`): the transfers themselves, where `stats` models a ring's
moved = {"bytes": 0}


def _move(x, device):
    """x on `device`; a copy from another card counts in `moved`."""
    if x.device != device and x.device.type == device.type == "cuda":
        moved["bytes"] += x.numel() * x.element_size()
    return x.to(device)


def _collective(name):
    """A collective recorded as the span "mesh: <name>"."""
    def wrap(fn):
        @functools.wraps(fn)
        def run(*a):
            with prof.span("mesh: " + name):
                return fn(*a)
        return run
    return wrap


# what a multi-process mesh really hands to torch.distributed: calls,
# bytes this process sends (its own blocks included) and the wall
# seconds inside those calls, the staging copies included (a copy off
# the card first waits for the kernels queued before it)
wire = {"calls": 0, "bytes": 0, "seconds": 0.0}


def _counted(fn, est):
    """Wrap a dist kernel; `est(*args) -> bytes` runs on the host at
    call time."""
    def run(*a):
        stats["exchanged_bytes"] += int(est(*a))
        stats["kernel_calls"] += 1
        return fn(*a)
    run.inner = fn    # for callers composing the kernel into their own
    run.est = est     # run: call inner, account with est yourself
    return run


# -- the mesh -----------------------------------------------------------------

class Mesh:
    """N shards along one axis. One process drives them all (world 1),
    or P processes each drive N / P of them (world P, rank r owning the
    contiguous shards `local`, process-major as the reference's global
    device order): `devices[i]` is shard i's device where this process
    owns it, else None. The collectives then cross the process boundary
    over torch.distributed's default group, whose backend is
    `backend`."""

    def __init__(self, devices, axis="d", world=1, rank=0, backend=None):
        n = len(devices)
        per = n // world
        self.world, self.rank, self.backend = world, rank, backend
        self.local = range(rank * per, (rank + 1) * per)
        self.devices = [torch.device(d) if i in self.local else None
                        for i, d in enumerate(devices)]
        self.group = None if world == 1 else td.group.WORLD
        self.axis_names = (axis,)
        self.key = (n, tuple(str(d) for d in self.devices), world, rank)

    @property
    def n(self) -> int:
        return len(self.devices)


def make_mesh(n_devices=None, axis="d", device=None, world=1, rank=0,
              backend=None) -> Mesh:
    """A mesh of n_devices shards (default: one per visible card) on
    `device`'s kind (default: the engine's device). On CUDA shard i sits
    on card (c + i) % count of the visible cards, c the engine's, so
    shard 0 is on the engine's card and 8 shards share one card or
    spread over four; on the CPU every shard is on it. With `world` > 1
    this process is `rank` of the process group (engine/device.py
    starts it) and holds its N / world shards, all on `device`."""
    if device is None:
        from ..engine import device as dev
        device = dev.device()
    d = torch.device(device)
    if n_devices is None:
        n_devices = torch.cuda.device_count() if d.type == "cuda" else 1
    n = int(n_devices)
    if n < 1:
        raise ValueError(f"a mesh needs at least one shard, not {n}")
    if world > 1 or d.type != "cuda":
        return Mesh([d] * n, axis, world, rank, backend)
    count = torch.cuda.device_count()
    c = torch.cuda.current_device() if d.index is None else d.index
    return Mesh([torch.device("cuda", (c + i) % count) for i in range(n)],
                axis)


def shard_rows(mesh: Mesh, arr, fill=0):
    """Row-shard a host array or tensor over the mesh, padded with
    `fill` to a multiple of the shard count; only this process's shards
    are placed (None at the others), each row block straight from `arr`
    to its shard's device, so nothing the size of `arr` is made. Returns
    (per-shard tensors, pad)."""
    t = arr if isinstance(arr, torch.Tensor) else \
        torch.from_numpy(np.ascontiguousarray(arr))
    n = mesh.n
    rows = int(t.shape[0])
    per = -(-rows // n)
    out = []
    for i, d in enumerate(mesh.devices):
        blk = None if d is None else t[i * per:(i + 1) * per]
        if blk is not None and int(blk.shape[0]) < per:
            blk = torch.cat([blk, blk.new_full(
                (per - int(blk.shape[0]),) + tuple(t.shape[1:]), fill)])
        out.append(None if d is None else blk.to(d))
    return out, per * n - rows


# -- per-shard lists ------------------------------------------------------------
#
# A per-shard list has one entry per shard of the mesh; under a
# multi-process mesh the entries of the shards another process owns are
# None. A stage runs over this process's entries (`smap`), a replicated
# result is read from any of them (`here`).

def owned(xs):
    """The shard indices whose entries this process holds."""
    return [i for i, x in enumerate(xs) if x is not None]


def here(xs):
    """A replicated per-shard list's value on this process."""
    return next(x for x in xs if x is not None)


def smap(fn, *lists):
    """fn(shard index, each list's entry) over this process's shards;
    None at the others."""
    return [None if xs[0] is None else fn(me, *xs)
            for me, xs in enumerate(zip(*lists))]


def pick(xs, j):
    """Entry j of each shard's tuple, as a per-shard list."""
    return [None if x is None else x[j] for x in xs]


# -- collectives over per-shard lists -----------------------------------------
#
# With every shard in this process (world 1) a collective is a loop over
# the list. Across processes each is one torch.distributed call over the
# bytes of this process's shards, stacked: a gather or an
# all_to_all_single (with one nonzero split each way for the ring). Reductions still run in shard order
# 0..N-1 on every process, over every shard's partial, so the result is
# the one-process mesh's bit for bit. Under gloo a CUDA tensor goes
# through a pinned host buffer; under NCCL it stays on the card.

def _wire_call(what, fn, send, recv):
    """Run one torch.distributed call from `send` into `recv` (uint8,
    on one device), staging CUDA buffers through pinned host memory
    unless the backend is NCCL. Returns `recv` on `send`'s device. A
    failed call raises DeviceError: a mesh collective never falls back."""
    t0 = time.perf_counter()
    dv = send.device
    staged = dv.type == "cuda" and td.get_backend() != "nccl"
    if staged:
        s = torch.empty(send.shape, dtype=send.dtype, pin_memory=True)
        s.copy_(send)
        r = torch.empty(recv.shape, dtype=recv.dtype, pin_memory=True)
    else:
        s, r = send, recv
    try:
        fn(r, s)
    except RuntimeError as e:
        raise DeviceError(f"mesh collective {what} failed across "
                          f"processes: {e}") from e
    out = r.to(dv) if staged else r
    wire["calls"] += 1
    wire["bytes"] += int(send.numel())
    wire["seconds"] += time.perf_counter() - t0
    return out


def _bytes_of(t, rows):
    """t ((rows, ...)) as a (rows, bytes) uint8 view."""
    return t.contiguous().reshape(rows, -1).view(torch.uint8) \
        if t.numel() else torch.empty((rows, 0), dtype=torch.uint8,
                                      device=t.device)


def _from_bytes(b, like, rows):
    """Inverse of `_bytes_of`: (rows, *like.shape) of like's dtype."""
    return b.contiguous().view(like.dtype).reshape((rows,) +
                                                   tuple(like.shape))


def _gather_shards(xs):
    """Every shard's tensor (all of one shape and dtype), as a list in
    shard order, on this process's first shard's device: one gather of
    this process's stacked shards."""
    own = owned(xs)
    n = len(xs)
    mine = torch.stack([xs[i] for i in own])
    b = _bytes_of(mine, len(own))
    recv = b.new_empty((n, int(b.shape[1])))
    gather = getattr(td, "all_gather_single", None) or \
        td.all_gather_into_tensor
    out = _from_bytes(_wire_call("gather", gather, b, recv), xs[own[0]], n)
    return list(out.unbind(0))


def _all_shards(xs):
    """Every shard's tensor in shard order: the list itself in one
    process, else gathered."""
    return _gather_shards(xs) if any(x is None for x in xs) else xs


def _replicate(x, like):
    return [None if y is None else _move(x, y.device) for y in like]


def _reduce(xs, op):
    allx = _all_shards(xs)
    acc = allx[0]
    for x in allx[1:]:
        acc = op(acc, _move(x, acc.device))
    return _replicate(acc, xs)


@_collective("psum")
def psum(xs):
    """Elementwise sum over shards, in shard order; replicated."""
    return _reduce(xs, torch.add)


@_collective("pmin")
def pmin(xs):
    return _reduce(xs, torch.minimum)


@_collective("pmax")
def pmax(xs):
    return _reduce(xs, torch.maximum)


@_collective("all_to_all")
def all_to_all(xs):
    """xs[s] holds N equal blocks, block d bound for shard d (across
    processes every shard's tensor has one size): out[d] is the blocks
    in[s][d] over s, concatenated in shard order."""
    n = len(xs)
    own = owned(xs)
    if len(own) == n:
        parts = [x.reshape(n, -1) for x in xs]
        return [torch.cat([_move(parts[s][d], xs[d].device)
                           for s in range(n)]) for d in range(n)]
    per = len(own)
    world = n // per
    like = xs[own[0]]
    blk = int(like.numel()) // n
    # (my shard s, destination d, block) -> (rank of d, d within it, s)
    send = torch.stack([xs[s].reshape(n, blk) for s in own]) \
        .reshape(per, world, per, blk).permute(1, 2, 0, 3)
    b = _bytes_of(send, world)
    recv = _wire_call("all_to_all", td.all_to_all_single, b,
                      torch.empty_like(b))
    # (source rank, my shard d, its shard s, block) -> d: every s in order
    got = _from_bytes(recv, send[0], world).permute(1, 0, 2, 3) \
        .reshape(per, n * blk)
    out = [None] * n
    for j, d in enumerate(own):
        out[d] = _move(got[j], xs[d].device)
    return out


@_collective("all_gather")
def all_gather(xs):
    """Every shard's tensor, concatenated in shard order; replicated."""
    first = here(xs)
    return _replicate(torch.cat([_move(x, first.device)
                                 for x in _all_shards(xs)]), xs)


@_collective("rotate")
def rotate(xs):
    """The ring step: shard d takes shard d - 1's tensor (shard 0 the
    last shard's), on shard d's device. Across processes each rank sends
    its last shard to the next rank (every shard's tensor of one
    size)."""
    n = len(xs)
    own = owned(xs)
    if len(own) == n:
        return [_move(xs[d - 1], xs[d].device) for d in range(n)]
    per = len(own)
    world = n // per
    rank = own[0] // per
    last = xs[own[-1]]
    b = _bytes_of(last[None], 1)
    nb = int(b.shape[1])
    splits = [0] * world
    out_splits = [0] * world
    splits[(rank + 1) % world] = nb
    out_splits[(rank - 1) % world] = nb
    recv = _wire_call(
        "rotate", lambda r, s: td.all_to_all_single(
            r.reshape(-1), s.reshape(-1), out_splits, splits),
        b, torch.empty_like(b))
    out = [None] * n
    out[own[0]] = _move(_from_bytes(recv, last, 1)[0], xs[own[0]].device)
    for d in own[1:]:
        out[d] = _move(xs[d - 1], xs[d].device)
    return out


def axis_index(mesh: Mesh):
    """Each shard's position along the mesh axis."""
    return list(range(mesh.n))


def unshard(xs, n):
    """Row-sharded per-shard tensors as one tensor of their first n rows,
    on this process's first shard's device (every process gets it)."""
    first = here(xs)
    return torch.cat([_move(x, first.device) for x in _all_shards(xs)])[:n]


# -- shard-local helpers ------------------------------------------------------

def _new_run(sc):
    """True where a sorted key starts a run."""
    return torch.cat([torch.ones(1, dtype=BOOL, device=sc.device),
                      sc[1:] != sc[:-1]])


def _run_end(sc):
    """True where a sorted key ends a run."""
    return torch.cat([sc[1:] != sc[:-1],
                      torch.ones(1, dtype=BOOL, device=sc.device)])


def _rscan(seg, x, op):
    """Segmented scan from each row to its segment's end (seg: the
    segment ids in row order), so a segment's first row holds its total —
    the reference's reversed `seg_doubling_*` layout and summation
    order."""
    return G._seg_scan(seg, x, op, reverse=True)


def _rscan_lanes(seg, ops, xs):
    """`_rscan` of each lane xs[i] with its op: the lanes of one op are
    scanned together, as the columns of one (n, L) scan. Each entry of
    the list `xs` is dropped from it once stacked."""
    out = [None] * len(xs)
    for op in set(ops):
        idx = [i for i, o in enumerate(ops) if o == op]
        stacked = torch.stack([xs[i] for i in idx], 1)
        for i in idx:
            xs[i] = None
        res = _rscan(seg, stacked, op)
        del stacked
        for j, i in enumerate(idx):
            out[i] = res[:, j]
    return out


# A dropped row goes to one of this many slots past a buffer's end, row
# r to slot r % _DROP: on the card, a million stores to one address
# would queue on it.
_DROP = 4096


def _dropped(n, size, device):
    return size + (torch.arange(n, device=device) & (_DROP - 1))


def _compact_targets(flags, cap):
    """Slot of each flagged row in a buffer of `cap` slots, in row order
    (a flag prefix count); unflagged rows and flagged rows past the cap
    go past the end, and are dropped."""
    pos = torch.cumsum(flags.to(I64), 0) - 1
    return torch.where(flags & (pos < cap), pos,
                       _dropped(int(flags.shape[0]), cap, flags.device))


def _place(x, tgt, size, fill):
    """x's rows at slots `tgt` of a buffer of `size` slots filled with
    `fill`; the slots past `size` take the dropped rows and are cut."""
    buf = torch.full((size + _DROP,), fill, dtype=x.dtype, device=x.device)
    buf[tgt] = x
    return buf[:size]


def _bucket_slots(dest, n_dest, cap, live):
    """Slot of each live row in a send buffer of n_dest buckets of `cap`
    rows, rows in row order within their bucket: one prefix count over
    the (bucket, row) flags laid out bucket by bucket, less the rows of
    the buckets before. Rows past a bucket's cap and dead rows are
    dropped. Returns (slots, ok: live and placed)."""
    n = int(dest.shape[0])
    d = torch.where(live, dest, 0)
    hit = (torch.arange(n_dest, device=d.device)[:, None] == d[None, :]) \
        & live[None, :]
    cs = torch.cumsum(hit.reshape(-1).to(I64), 0).reshape(n_dest, n)
    before = torch.cat([cs.new_zeros(1), cs[:-1, -1]])
    within = cs.gather(0, d[None, :])[0] - before[d] - 1
    ok = live & (within < cap)
    return torch.where(ok, d * cap + within,
                       _dropped(n, n_dest * cap, d.device)), ok


def _sort_perm(keys):
    """The stable ascending order of the lexicographic keys (int64 row
    ids), through the psort entry."""
    return sort_lex(keys, perm=True)[2].long()


# -- distributed dense group-by ----------------------------------------------
#
# Per-shard partials come from the engine's own dense pipeline
# (groupby.dense_scan: bcast_scan's lanes and the exact integer sums in
# one pass); the cross-shard combine is psum / pmin / pmax. f64 sums are
# added in the dense aggregate's fixed order, so a rerun on the card is
# bit for bit the same.
# dist_select_small is the kernel of the dense plan on a mesh
# (engine/select.py `spmd`); the narrower kernels below are entries over
# its shard stage, kept at the reference's signatures and byte counts.

def _select_small(n_codes, shard_rows_n, codes, ints=(), sums=(), mins=(),
                  maxs=()):
    """dist_select_small's body over per-shard lists (`ints`, `sums`,
    `mins`, `maxs`: lanes, each a per-shard list)."""
    def part(me, c):
        n = int(c.shape[0])
        bc = G.dense_scan(c, n_codes, n, tasks=[w[me] for w in ints],
                          sums=tuple(x[me] for x in sums),
                          mins=tuple(x[me] for x in mins),
                          maxs=tuple(x[me] for x in maxs),
                          want_counts=True, want_fidx=True)
        off = me * shard_rows_n
        p = {"counts": bc["counts"],
             "fidx": torch.where(bc["fidx"] == KEY_MAX, KEY_MAX,
                                 bc["fidx"] + off),
             "lidx": torch.where(bc["lidx"] < 0, -1, bc["lidx"] + off)}
        p.update((k, v) for k, v in bc.items()
                 if k.startswith(("task", "sum", "min", "max")))
        return p

    parts = smap(part, codes)
    out = {}
    for name in here(parts):
        comb = pmin if name == "fidx" or name.startswith("min") else \
            pmax if name == "lidx" or name.startswith("max") else psum
        out[name] = here(comb(pick(parts, name)))
    return out


def dist_select_small(mesh: Mesh, n_codes: int, shard_rows_n: int,
                      n_sums: int, n_mins: int, n_maxs: int,
                      n_int_tasks: int):
    """The mesh version of engine/select.py's dense pipeline: each shard
    runs the dense scans over its rows; combines are psum (counts, sums,
    integer tasks), pmin (fidx, mins) and pmax (lidx, maxs).

    Inputs (per-shard lists): codes (trash = n_codes for filtered rows),
    integer task weights, f64 or integer sum lanes (nulls zeroed),
    min/max i64 or f64 lanes (nulls pre-mapped). Output: a dict of
    replicated dense lanes (counts i32, tasks as exact f64, sums f64)."""
    def kernel(codes, *rest):
        a, b, c = n_int_tasks, n_int_tasks + n_sums, \
            n_int_tasks + n_sums + n_mins
        return _select_small(n_codes, shard_rows_n, codes, rest[:a],
                             rest[a:b], rest[b:c], rest[c:])

    n_dev = mesh.n
    _R = (1 + n_int_tasks) * n_codes * 4 + 2 * n_codes * 8 + \
        (n_sums + n_mins + n_maxs) * n_codes * 8
    return _counted(kernel, lambda *a: 2 * (n_dev - 1) * _R)


def dist_groupby_sum(mesh: Mesh, n_codes: int):
    """Distributed group-by-sum over codes in [0, n_codes]: per-shard
    dense f64 partials, psum-combined. codes/values are per-shard lists;
    the result, (n_codes + 1,) f64, is replicated."""
    def kernel(codes, values):
        return _select_small(n_codes + 1, 0, codes,
                             sums=[smap(lambda _i, v: v.to(F64),
                                        values)])["sum0"]

    n_dev = mesh.n
    return _counted(kernel,
                    lambda *a: 2 * (n_dev - 1) * (n_codes + 1) * 4)


def dist_groupby_count_first(mesh: Mesh, n_codes: int, shard_rows_n: int):
    """Distributed counts (i32) + global first-row index (i64, KEY_MAX
    for an empty code) per dense code in [0, n_codes]."""
    def kernel(codes):
        out = _select_small(n_codes + 1, shard_rows_n, codes)
        return out["counts"], out["fidx"]

    n_dev = mesh.n
    return _counted(
        kernel, lambda *a: 2 * (n_dev - 1) * (n_codes + 1) * (4 + 8))


def dist_filter_group_sum(mesh: Mesh, n_codes: int):
    """The fused step: filter mask + dense codes + partial sums + psum.
    fn(codes, values, mask) -> (sums, counts), each (n_codes + 1,) f64
    and replicated; filtered rows land in slot n_codes."""
    def kernel(codes, values, mask):
        cm = smap(lambda _i, c, m: torch.where(m.to(BOOL), c, n_codes),
                  codes, mask)
        out = _select_small(n_codes + 1, 0, cm,
                            sums=[smap(lambda _i, v: v.to(F64), values)])
        return out["sum0"], out["counts"].to(F64)

    n_dev = mesh.n
    return _counted(
        kernel, lambda *a: 2 * (n_dev - 1) * 2 * (n_codes + 1) * 4)


# -- distributed shuffle (all_to_all by key) ----------------------------------

def _shuffle(dest, live, cols, n_dev, cap):
    """The raw-row exchange: each shard's live rows go to shard `dest`,
    up to `cap` rows per (source, destination) pair, in row order.
    dest, live: per-shard lists; cols: per shard, its [(lane, fill)].
    Returns (per lane, the received per-shard tensors, source shards in
    order; per shard, the (1,) i64 count of live rows past a cap)."""
    def send(_me, d, lv, cs):
        slot, ok = _bucket_slots(d, n_dev, cap, lv)
        return ([_place(x, slot, n_dev * cap, f) for x, f in cs],
                (lv & ~ok).sum().to(I64).reshape(1))

    sent = smap(send, dest, live, cols)
    sends = pick(sent, 0)
    return [all_to_all(pick(sends, j))
            for j in range(len(here(cols)))], pick(sent, 1)


def _route_back(lrows, lanes, fills, nl, cap, extra=None):
    """Rows back to their owners by global row id: the row of id g (-1
    for none; a left row's id, or a sorted row's global position) goes
    to shard g // nl at offset g % nl. Rows a shard owns skip the exchange (the diagonal bypass);
    the others ride one all_to_all of `cap` rows per (source,
    destination). Each owner places what arrived, its own rows and
    `extra[d]` ((targets, lane values) of rows that never left) by
    offset into buffers of nl rows; the offsets are unique, so the
    placement is the reference's offset sort. lrows: per shard; lanes:
    per lane, per shard. Returns (overflow (1,), per lane the per-shard
    outputs)."""
    n_dev = len(lrows)
    size = n_dev * cap
    sends, keeps, ovf = [None] * n_dev, [None] * n_dev, [None] * n_dev
    for me in owned(lrows):
        lr = lrows[me]
        dv = lr.device
        lv = lr >= 0
        dst = torch.where(lv, lr // nl, n_dev).to(I64)
        off = torch.where(lv, lr % nl, -1).to(I32)
        mine = lv & (dst == me)
        away = lv & ~mine
        slot, ok = _bucket_slots(dst, n_dev, cap, away)
        ovf[me] = (away & ~ok).sum().to(I64).reshape(1)
        sends[me] = [_place(off, slot, size, -1)] + \
            [_place(ln[me], slot, size, f) for ln, f in zip(lanes, fills)]
        keeps[me] = torch.where(mine, off.to(I64),
                                _dropped(int(lr.shape[0]), nl, dv))
    recv = [all_to_all(pick(sends, j)) for j in range(1 + len(lanes))]
    outs = [[None] * n_dev for _ in lanes]
    for me in owned(lrows):
        xo = recv[0][me]
        parts = [(keeps[me], [ln[me] for ln in lanes]),
                 (torch.where(xo >= 0, xo.to(I64),
                              _dropped(int(xo.shape[0]), nl, xo.device)),
                  [r[me] for r in recv[1:]])]
        if extra is not None:
            parts.append(extra[me])
        for j, f in enumerate(fills):
            like = recv[1 + j][me]
            buf = torch.full((nl + _DROP,), f, dtype=like.dtype,
                             device=like.device)
            for tgt, vals in parts:
                buf[tgt] = vals[j]
            outs[j][me] = buf[:nl]
    return here(psum(ovf)), outs


def dist_shuffle(mesh: Mesh, capacity: int):
    """Route rows to the shard owning key % n_shards.

    Returns fn(keys, values) -> (keys', values', valid', overflow): each
    shard receives up to `capacity` rows per source shard (per-shard
    lists of n_shards * capacity rows, source shards in order). Rows
    beyond capacity are NOT sent; `overflow` ((1,) i64) counts them so
    the caller can re-run with a larger capacity — nothing drops
    silently. The analogue of the reference's radix scatter with
    per-thread write cursors (index.c:2542-2553); the grouped median's
    exchange is the same `_shuffle`."""
    n_dev = mesh.n

    def kernel(keys, values):
        (rk, rv), ovf = _shuffle(
            smap(lambda _i, k: k % n_dev, keys),
            smap(lambda _i, k: torch.ones(k.shape, dtype=BOOL,
                                          device=k.device), keys),
            smap(lambda _i, k, v: [(k, -1), (v, 0)], keys, values),
            n_dev, capacity)
        return rk, rv, smap(lambda _i, x: x >= 0, rk), here(psum(ovf))

    return _counted(
        kernel, lambda *a: 2 * n_dev * (n_dev - 1) * capacity * 8)


def dist_shuffle_auto(mesh: Mesh, start_capacity: int):
    """Overflow-safe shuffle: doubles capacity and re-runs until no
    row overflows."""
    fns: dict = {}

    def run(keys, values):
        c = start_capacity
        while True:
            if c not in fns:
                fns[c] = dist_shuffle(mesh, c)
            rk, rv, valid, ovf = fns[c](keys, values)
            if prof.host("dist.overflow", int, ovf[0]) == 0:
                return rk, rv, valid
            c *= 2

    return run


# -- distributed wide group-by (partial-aggregate exchange) -------------------
#
# The mesh version of engine/wide.py, following the reference's
# radix-partition blueprint (core/index.c:2556-2729):
#
#   stage A (per shard): local sort-agg over the shard's rows ->
#     compacted partial groups (code, count, fidx, lanes). A heavy key
#     contributes at most ONE partial per shard, so key skew cannot
#     overload the exchange.
#   stage B: all_to_all partials to the shard owning code % n. The
#     per-(src, dst) capacity cannot overflow: one source's partials to
#     one destination are distinct codes that destination owns.
#   stage C (per shard): merge received partials (sort by code, fidx;
#     segmented combine), compact to `out_cap` groups. out_cap CAN
#     overflow under extreme hash imbalance, so the kernel returns an
#     overflow count; dist_wide_groupby_auto retries doubled.
#   stage D: all_gather merged groups, ordered by global first-row id
#     (first-appearance order, replicated result).

_LANE_FILL = {"sum": 0.0, "min": float("inf"), "max": float("-inf"),
              "first": 0.0, "last": 0.0}

# Stage A, the shard-local sort-agg: the shard's codes are sorted alone
# (masked rows at a sentinel past every code; one i32 word where the
# code space is known and below 2^31 - 1, else the i64 code), and the
# stable sort's permutation gives each sorted row's position. On the
# card the hand-written kernels of csrc/shard_partials.cu build the sort
# key, total each run's scanned lanes through the permutation (the
# segmented scan's reversed data flow, at the run heads alone), find the
# runs and their send slots, and place the partials into the send
# buffers (`shard_partials_cuda`); on a CPU tensor `shard_partials_plain`
# does the same with torch formulas and the segmented scan.

# (restype, argtypes) of every extern "C" function of
# csrc/shard_partials.cu; tests/test_torch_dist.py holds this table, and
# the constants below, against the source
_P, _CI32, _CI64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
SHARD_PARTIALS_ARGTYPES = {
    "rf_shard_partials_keys": (_CI32, [_CI64, _P, _CI64, _CI32, _CI32, _P,
                                       _P, _CI32, _P, _P, _CI32, _P, _P]),
    "rf_shard_partials_scratch_bytes": (_CI64, [_CI64, _CI32]),
    "rf_shard_partials_reduce": (_CI32, [_CI64, _P, _P, _CI32, _P, _CI32, _P,
                                         _P, _P, _CI32, _P, _CI64, _P, _P]),
    "rf_shard_partials_carry": (_CI32, [_CI64, _P, _P, _CI32, _P, _P, _CI64,
                                        _P, _P]),
    "rf_shard_partials_runs": (_CI32, [_CI64, _P, _P, _CI32, _CI32, _CI64,
                                       _P, _P, _P, _P, _P, _P]),
    "rf_shard_partials_place": (_CI32, [_CI64, _CI64, _CI32, _CI64, _P, _P,
                                        _P, _P, _P, _P, _P, _P, _P, _P,
                                        _CI32, _P, _P, _P, _P, _P, _P]),
}
SP_CHUNK = 4096          # sorted rows a warp takes in `runs`
SP_MAX_DEV = 1024        # the most buckets (shards) a launch takes
SP_MAX_LANES = 32        # the most lanes a launch takes
SP_ROW_LANES = 4         # the most scanned lanes laid side by side
_SP_OPS = {"min": 0, "max": 1, "sum": 2}    # reduce's and carry's op codes
_I32_MAX = (1 << 31) - 1

_sp_lib = None


def _shard_partials_lib():
    global _sp_lib
    if _sp_lib is None:
        from ..engine import cubuild
        lib = cubuild.load("shard_partials")
        try:
            for name, (res, args) in SHARD_PARTIALS_ARGTYPES.items():
                fn = getattr(lib, name)
                fn.restype = res
                fn.argtypes = args
        except AttributeError as e:
            raise DeviceError(f"shard partials library: {e}") from e
        _sp_lib = lib
    return _sp_lib


def _narrow_key(n_codes):
    """True where the sort key is one i32 word (masked rows at n_codes)."""
    return n_codes is not None and n_codes < _I32_MAX


def _scanned(lane_ops):
    """{op: the indices of its lanes} for the lanes the segmented scan
    totals (every op but first and last), in the order of lane_ops."""
    out: dict = {}
    for i, op in enumerate(lane_ops):
        if op not in ("first", "last"):
            out.setdefault(op, []).append(i)
    return out


def shard_partials_plain(me, codes, lanes, lane_ops, n_dev, D, n_codes):
    """The plain PyTorch version of `shard_partials_cuda` (the mesh takes
    it for CPU shards; chip_smoke.py times it on the card as the torch
    path the kernels replace): the sort-agg formulas over the code sorted
    alone. Each temporary of the shard's n rows is dropped once dead."""
    n = int(codes.shape[0])
    C = n if n_codes is None else min(n, n_codes)
    has_last = "last" in lane_ops
    if _narrow_key(n_codes):
        sentinel = n_codes
        key = [torch.where(codes >= 0, codes, n_codes).to(I32)]
    else:
        sentinel = KEY_MAX
        key = [torch.where(codes >= 0, codes, KEY_MAX)]
    (sc,), _, perm = sort_lex(key, perm=True)
    del key
    sc = sc.to(I64)
    perm = perm.long()
    svals = [x[perm] for x in lanes]
    valid = sc != sentinel
    flags = valid & _new_run(sc)
    tf = _compact_targets(flags, C)
    tl = _compact_targets(valid & _run_end(sc), C)
    pcode = _place(sc, tf, C, -1)
    del sc
    gid = perm + me * n                      # global row id
    del perm
    pfirst = _place(gid, tf, C, KEY_MAX)
    plast = _place(gid, tl, C, -1) if has_last else None
    del gid
    iota = torch.arange(n, device=codes.device)
    start = _place(iota, tf, C, 0)
    end = _place(iota, tl, C, 0)
    del iota
    seg = torch.cumsum(flags.to(I32) + (~valid).to(I32), 0, dtype=I32)
    del flags, valid
    out = [(pcode, -1), (end - start + 1, 0), (pfirst, KEY_MAX)]
    scan = [i for i, op in enumerate(lane_ops)
            if op not in ("first", "last")]
    ins = [svals[i] for i in scan]
    for i in scan:
        svals[i] = None
    red = dict(zip(scan, _rscan_lanes(
        seg, [lane_ops[i] for i in scan], ins)))
    del seg
    for i, (op, sv) in enumerate(zip(lane_ops, svals)):
        if op == "first":
            v = _place(sv, tf, C, 0.0)
        elif op == "last":
            v = _place(sv, tl, C, 0.0)
        else:
            v = _place(red.pop(i), tf, C, 0.0)
        out.append((v, _LANE_FILL[op]))
    if has_last:
        out.append((plast, -1))
    live = pcode >= 0
    slot, _ok = _bucket_slots(pcode % n_dev, n_dev, D, live)
    return [_place(x, slot, n_dev * D, fill) for x, fill in out]


def shard_partials_cuda(me, codes, lanes, lane_ops, n_dev, D, n_codes):
    """Stage A by the kernels of csrc/shard_partials.cu and the engine's
    radix sort: bit for bit `shard_partials_plain`.
    The codes and lanes are read in place at their strides. Any failure
    to build, load, allocate or launch raises DeviceError; shapes and
    types the kernels do not take raise ValueError before any launch."""
    n = int(codes.shape[0])
    dv = codes.device
    if codes.dtype != I64 or codes.dim() != 1 or \
            len(lanes) != len(lane_ops) or not 1 <= n_dev <= SP_MAX_DEV or \
            n >= _I32_MAX or D < 1 or \
            any(x.dtype != F64 or x.shape != (n,) or x.device != dv
                for x in lanes) or \
            any(op not in _LANE_FILL for op in lane_ops):
        raise ValueError(
            f"shard_partials: codes {codes.dtype} {tuple(codes.shape)} on "
            f"{dv}, {n_dev} shards of {D} slots, lanes " + ", ".join(
                f"{op} {x.dtype} {tuple(x.shape)} on {x.device}"
                for op, x in zip(lane_ops, lanes)))
    lib = _shard_partials_lib()
    size = n_dev * D
    scanned = _scanned(lane_ops)
    has_last = "last" in lane_ops
    src = [lanes[i] for idx in scanned.values() for i in idx]
    ops = [op for op, idx in scanned.items() for _ in idx]
    hi, lo, sentinel, perm, width, rows = shard_keys(codes, src, n_codes)
    # each run's scanned totals at its first sorted row: the (n, L) rows
    # of `heads` are written at the run heads alone
    heads = shard_reduce(n, hi, lo, sentinel, perm, src, ops, width, rows)
    del src, rows
    n_chunks = -(-n // SP_CHUNK)
    counts = torch.empty((n_dev + 1) * n_chunks, dtype=I32, device=dv)
    totals = torch.empty(n_dev + 1, dtype=I32, device=dv)
    hrow = torch.empty(size, dtype=I32, device=dv)
    erow = torch.empty(size, dtype=I32, device=dv)
    _sp_call(dv, "runs", lib.rf_shard_partials_runs, n, hi.data_ptr(),
             None if lo is None else lo.data_ptr(), sentinel, n_dev, D,
             counts.data_ptr(), totals.data_ptr(), None, hrow.data_ptr(),
             erow.data_ptr())
    del counts
    outs = [torch.empty(size, dtype=I64, device=dv) for _ in range(3)] + \
        [torch.empty(size, dtype=F64, device=dv) for _ in lane_ops] + \
        ([torch.empty(size, dtype=I64, device=dv)] if has_last else [])
    # each lane's values and where place reads them: 0 the total at the
    # run's first sorted row, 1 and 2 the lane at the first and last
    # sorted row's origin
    vals = {}
    for j, i in enumerate(i for idx in scanned.values() for i in idx):
        vals[i] = (heads[:, j], 0)
    for i, op in enumerate(lane_ops):
        if op in ("first", "last"):
            vals[i] = (lanes[i], 1 if op == "first" else 2)
    for b in range(0, max(len(lane_ops), 1), SP_MAX_LANES):
        part = range(b, min(b + SP_MAX_LANES, len(lane_ops)))
        ints = [o.data_ptr() for o in outs[:3]] if b == 0 else [None] * 3
        last = outs[-1].data_ptr() if has_last and b == 0 else None
        _sp_call(dv, "place", lib.rf_shard_partials_place, size, D, n_dev,
                 me * n, totals.data_ptr(), hrow.data_ptr(),
                 erow.data_ptr(), hi.data_ptr(),
                 None if lo is None else lo.data_ptr(), perm.data_ptr(),
                 *ints, last, len(part),
                 _ptrs([vals[i][0].data_ptr() for i in part]),
                 _ptrs([vals[i][0].stride(0) for i in part],
                       ctypes.c_int64),
                 _ptrs([vals[i][1] for i in part], ctypes.c_int),
                 _ptrs([_LANE_FILL[lane_ops[i]] for i in part],
                       ctypes.c_double),
                 _ptrs([outs[3 + i].data_ptr() for i in part]))
    with _LAUNCHES_LOCK:
        LAUNCHES["shard_partials"] += 1
        if heads is not None:
            LAUNCHES["shard_reduce"] += 1
    return outs


def _ptrs(xs, t=ctypes.c_void_p):
    return (t * max(len(xs), 1))(*xs)


def _sp_call(dv, what, fn, *args):
    """fn(*args, stream) on card dv's current stream; DeviceError for a
    failure or a nonzero cudaError."""
    try:
        with G._card_stream(dv) as stream:
            rc = fn(*args, stream)
    except Exception as e:
        raise DeviceError(f"shard_partials {what}: {type(e).__name__}: "
                          f"{e}") from e
    if rc != 0:
        raise DeviceError(f"shard_partials {what} launch failed: "
                          f"cudaError {rc}")


def shard_keys(codes, src, n_codes):
    """Stage A's sort of a shard's codes: csrc/shard_partials.cu's `keys`
    and the radix sort of its words. Returns (hi, lo, sentinel, perm,
    width, rows): the sorted key's words (lo None where the key is one i32
    word, its masked rows at `sentinel`), the sort's i32 permutation, and
    for two to SP_ROW_LANES scanned lanes `src` the lanes side by side in
    (n, width) rows, else width 0 and rows None."""
    n = int(codes.shape[0])
    dv = codes.device
    narrow = _narrow_key(n_codes)
    sentinel = n_codes if narrow else 0
    # two to four scanned lanes side by side, so that the gather reads a
    # row's lanes in one sector
    width = 0 if not 2 <= len(src) <= SP_ROW_LANES else \
        2 if len(src) == 2 else 4
    rows = torch.empty((n, width), dtype=F64, device=dv) if width else None
    words = torch.empty((1 if narrow else 2, n), dtype=I32, device=dv)
    _sp_call(dv, "keys", _shard_partials_lib().rf_shard_partials_keys, n,
             codes.data_ptr(), codes.stride(0), int(not narrow), sentinel,
             words[0].data_ptr(), None if narrow else words[1].data_ptr(),
             len(src) if width else 0, _ptrs([x.data_ptr() for x in src]),
             _ptrs([x.stride(0) for x in src], ctypes.c_int64), width,
             None if rows is None else rows.data_ptr())
    skey, perm = psort.sort_i32(list(words.unbind(0)), n_keys=len(words),
                                perm=True)
    return skey[0], None if narrow else skey[1], sentinel, perm, width, rows


def shard_reduce(n, hi, lo, sentinel, perm, src, ops, width, rows):
    """Each run's scanned totals by csrc/shard_partials.cu's `reduce` and
    `carry`: an (n, len(src)) f64 tensor holding, at each run's first
    sorted row, lane j's `ops[j]` total over the run in column j (bit for
    bit the reversed segmented scan's value there), its other rows never
    written; None where no lane is scanned. hi, lo: the
    sorted key's words (lo None for one word, masked rows at
    `sentinel`); perm: the sort's permutation; src: the lanes in shard
    order; rows: keys' side-by-side rows where `width` is 2 or 4."""
    if not src:
        return None
    lib = _shard_partials_lib()
    dv = perm.device
    L = len(src)
    heads = torch.empty((n, L), dtype=F64, device=dv)
    nb = min(L, SP_MAX_LANES)
    scratch = torch.empty(-(-lib.rf_shard_partials_scratch_bytes(n, nb) // 8),
                          dtype=I64, device=dv)
    lo_p = None if lo is None else lo.data_ptr()
    for b in range(0, L, SP_MAX_LANES):
        part = range(b, min(b + SP_MAX_LANES, L))
        codes = _ptrs([_SP_OPS[ops[i]] for i in part], ctypes.c_int)
        _sp_call(dv, "reduce", lib.rf_shard_partials_reduce, n,
                 hi.data_ptr(), lo_p, sentinel, perm.data_ptr(), len(part),
                 codes, _ptrs([rows.data_ptr()] if width else
                              [src[i].data_ptr() for i in part]),
                 _ptrs([0] if width else [src[i].stride(0) for i in part],
                       ctypes.c_int64), width, heads[:, b].data_ptr(),
                 heads.stride(0), scratch.data_ptr())
        _sp_call(dv, "carry", lib.rf_shard_partials_carry, n, hi.data_ptr(),
                 lo_p, len(part), codes, heads[:, b].data_ptr(),
                 heads.stride(0), scratch.data_ptr())
    return heads


def shard_partials(me, codes, lanes, lane_ops, n_dev, D, n_codes):
    """Stage A of `dist_wide_groupby` on shard `me`: its partial groups
    (code, count, first global row id, one value a lane, and the last
    global row id where a lane is "last") placed in its send buffers of
    n_dev buckets of D slots, bucket code % n_dev, the runs of a bucket
    in code order, each buffer's empty slots at its fill. codes: the
    shard's n i64 codes (masked rows < 0; below n_codes where that is
    known); lanes: one f64 lane an op. On a CUDA tensor the hand-written
    kernels, on a CPU tensor the plain version; nothing in between."""
    d = codes.device
    if d.type == "cuda":
        return shard_partials_cuda(me, codes, lanes, lane_ops, n_dev, D,
                                   n_codes)
    if d.type == "cpu":
        return shard_partials_plain(me, codes, lanes, lane_ops, n_dev, D,
                                    n_codes)
    raise DeviceError(f"shard_partials: no stage A for device {d}")


def dist_wide_groupby(mesh: Mesh, rows_local: int, out_cap: int,
                      lane_ops=("sum",), n_codes=None):
    """The distributed group-by kernel with one f64 value lane per entry
    of `lane_ops` (each "sum" | "min" | "max" | "first" | "last").

    fn(codes, *lanes) with per-shard i64 codes (masked rows = -1) and
    len(lane_ops) f64 lanes; returns replicated (ng, overflow, codes,
    counts, fidx, *lane_results) where the first `ng` entries of each
    output are the groups in global first-appearance order.

    "first"/"last" lanes hold the lane value at the group's globally
    first/last row: each shard's partial keeps the value at its first
    and last sorted row; the merge resolves first by its (code,
    first-row id) sort and last by a second (code, -last-row id) sort.

    With `n_codes` (the dense code-space size) known, a shard emits at
    most min(rows_local, n_codes) partials and one source sends one
    destination at most ceil(n_codes / n) of them, so the buffers shrink
    to ~n_codes / n each without losing the zero-drop guarantee."""
    n_dev = mesh.n
    C = rows_local if n_codes is None else min(rows_local, n_codes)
    D = C if n_codes is None else max(min(C, -(-n_codes // n_dev)), 1)
    n_lanes = len(lane_ops)
    has_last = "last" in lane_ops

    def stage_c(recv):
        """Merge one shard's received partials into its groups."""
        rcode, rcnt, rfidx = recv[:3]
        rlanes = recv[3:3 + n_lanes]
        mkey = torch.where(rcode >= 0, rcode, KEY_MAX)
        perm = _sort_perm([mkey, rfidx])
        msc, msf, msn = mkey[perm], rfidx[perm], rcnt[perm]
        mslanes = [x[perm] for x in rlanes]
        mvalid = msc != KEY_MAX
        mflags = mvalid & _new_run(msc)
        mseg = torch.cumsum(mflags.to(I32) + (~mvalid).to(I32), 0,
                            dtype=I32)
        if has_last:
            # (code, -last-row id): its run heads are the partials with
            # the largest last-row id; the code sequence, so the run
            # heads, are the first sort's
            perm2 = _sort_perm([mkey, -recv[3 + n_lanes]])
        scan = [i for i, op in enumerate(lane_ops)
                if op not in ("first", "last")]
        red = dict(zip(scan, _rscan_lanes(
            mseg, [lane_ops[i] for i in scan],
            [mslanes[i] for i in scan])))
        tot = [ml if op == "first" else rl[perm2] if op == "last"
               else red[i]
               for i, (op, ml, rl) in enumerate(zip(lane_ops, mslanes,
                                                    rlanes))]
        my_ng = mflags.sum()
        tg = _compact_targets(mflags, out_cap)
        # a group's count: a difference of the i64 prefix sums of its
        # partials' counts (exact)
        iota = torch.arange(int(msc.shape[0]), device=msc.device)
        start = _place(iota, tg, out_cap, 0)
        end = _place(iota, _compact_targets(mvalid & _run_end(msc),
                                            out_cap), out_cap, 0)
        cs = torch.cat([msn.new_zeros(1), torch.cumsum(msn, 0)])
        gout = [_place(msc, tg, out_cap, -1), cs[end + 1] - cs[start],
                _place(msf, tg, out_cap, KEY_MAX)] + \
            [_place(x, tg, out_cap, 0.0) for x in tot]
        return gout, torch.clamp(my_ng - out_cap, min=0).reshape(1)

    def kernel(codes, *lanes):
        # stage A
        sends = smap(lambda me, c: shard_partials(
            me, c, [ln[me] for ln in lanes], lane_ops, n_dev, D, n_codes),
            codes)
        recvs = [all_to_all(pick(sends, j))
                 for j in range(len(here(sends)))]
        merged = smap(lambda d, _c: stage_c([r[d] for r in recvs]), codes)
        ovf = here(psum(pick(merged, 1)))
        gs = pick(merged, 0)
        gathered = [here(all_gather(pick(gs, j)))
                    for j in range(3 + n_lanes)]
        acode, acnt, afidx = gathered[:3]
        fkey = torch.where(acode >= 0, afidx, KEY_MAX)
        perm = _sort_perm([fkey])
        of = acode[perm]
        ng = (of >= 0).sum().reshape(1)
        return tuple([ng, ovf, of, acnt[perm], fkey[perm]] +
                     [x[perm] for x in gathered[3:]])

    _a2a = (3 + n_lanes + int(has_last)) * n_dev * (n_dev - 1) * D * 8
    _ag = (3 + n_lanes) * n_dev * (n_dev - 1) * out_cap * 8
    return _counted(kernel, lambda *a: _a2a + _ag)


def dist_wide_groupby_auto(mesh: Mesh, rows_local: int,
                           lane_ops=("sum",), n_codes=None):
    """Overflow-safe wrapper: run with balanced capacity + headroom,
    re-run with doubled merge capacity if any shard overflowed. With
    `n_codes` known the initial merge capacity is the exact per-shard
    ownership bound ceil(n_codes / n) — no overflow possible."""
    if n_codes is None:
        cap = max(2 * rows_local, 64)
    else:
        cap = max(min(2 * rows_local, -(-n_codes // mesh.n)), 64)
    tried = {}

    def run(codes, *lanes):
        c = cap
        while True:
            if c not in tried:
                tried[c] = dist_wide_groupby(mesh, rows_local, c,
                                             lane_ops, n_codes)
            out = tried[c](codes, *lanes)
            if prof.host("dist.overflow", int, out[1][0]) == 0:
                # (ng, codes, counts, fidx, *lane_results)
                return (out[0],) + out[2:]
            c *= 2

    return run


# -- distributed grouped median (raw-row shuffle) -----------------------------

_MED_KPER = 16    # locally-heavy candidate slots per shard


def dist_med_groupby(mesh: Mesh, rows_local: int, cap: int,
                     out_cap: int, n_lanes: int):
    """Distributed grouped MEDIAN: median is not decomposable, so rows
    shuffle raw to the shard owning code % n — every group lands
    complete on one shard, where a (code, value) sort + selection
    computes it exactly (core/aggr.c med over sorted per-group rows).

    SKEW: a code that is locally heavy on some shard (local run > cap/2;
    by pigeonhole every globally heavy code is) becomes a CANDIDATE
    whose rows never ride the exchange. Its median comes from a
    distributed rank selection instead: a 64-round bitwise search over
    the monotone f64 bit space, each round counting per shard the
    candidate's values below the trial and psum-combining the counts.

    fn(codes, *lanes) with per-shard i64 codes (-1 = masked) and n_lanes
    f64 value lanes (nulls as NaN, which sorts last). Returns replicated
    (ng, ovf_exchange, ovf_out, codes, fidx, *medians) in global
    first-appearance order. Either overflow counter nonzero means re-run
    with that capacity doubled (dist_med_groupby_auto)."""
    n_dev = mesh.n
    m = n_dev * cap
    K = n_dev * _MED_KPER
    theta = max(cap // 2, 1)

    def candidates(codes):
        """One shard's locally-heavy codes (at most _MED_KPER of them,
        code order; -1 fills) and how many it had beyond that."""
        (csort,), _ = sort_lex([torch.where(codes >= 0, codes, KEY_MAX)])
        n = int(csort.shape[0])
        runlen = torch.searchsorted(csort, csort, right=True) - \
            torch.arange(n, device=csort.device)
        heavy = (csort != KEY_MAX) & _new_run(csort) & (runlen > theta)
        over = torch.clamp(heavy.sum() - _MED_KPER, min=0).reshape(1)
        return _place(csort, _compact_targets(heavy, _MED_KPER),
                      _MED_KPER, -1), over

    def rank_select(cand_rows, lanes):
        """Per lane, the K candidates' medians by the distributed
        64-round rank search (replicated (K,) f64)."""
        meds = []
        for li in range(n_lanes):
            # per shard: the search tables below, and each candidate's
            # non-null values
            shard, es = [None] * n_dev, [None] * n_dev
            for me in owned(cand_rows):
                is_heavy, cand_of_row = cand_rows[me]
                rl = lanes[li][me]
                dv = rl.device
                s = f64_order(rl)     # signed order = float order
                ci = torch.where(is_heavy & ~torch.isnan(rl),
                                 cand_of_row, K).to(I32)
                (sci, ss), _ = sort_lex([ci, s])
                (svals,), _ = sort_lex([s])
                # the pair (candidate, value) packed as (candidate << 32 |
                # value rank) keeps the (ci, s) order in one i64 word,
                # so one searchsorted counts a candidate's values below
                # a trial
                packed = (sci.to(I64) << 32) | \
                    torch.searchsorted(svals, ss)
                kk = torch.arange(K, device=dv, dtype=I32)
                starts = torch.searchsorted(sci, kk)
                ends = torch.searchsorted(sci, kk, right=True)
                # per (candidate, rank) lane: the candidate in the high
                # word of a search key, and where its run starts
                shard[me] = (packed, svals,
                             kk.to(I64).repeat_interleave(2) << 32,
                             starts.repeat_interleave(2))
                es[me] = (ends - starts).to(I64)
            e = here(psum(es))
            dv0 = e.device
            ranks = torch.stack([torch.clamp((e - 1) // 2, min=0), e // 2],
                                1)
            cur = torch.zeros((K, 2), dtype=I64, device=dv0)   # u-space
            for bit in range(63, -1, -1):
                b = I64_MIN if bit == 63 else (1 << bit)
                trial = cur | b
                t_s = (trial ^ I64_MIN).reshape(-1)   # signed order
                cnts = [None] * n_dev
                for me in owned(shard):
                    packed, svals, khi, starts = shard[me]
                    rt = torch.searchsorted(svals, t_s.to(svals.device))
                    pos = torch.searchsorted(packed, khi | rt)
                    cnts[me] = pos - starts
                cnt = here(psum(cnts)).reshape(K, 2)
                cur = torch.where(cnt <= ranks, trial, cur)
            sel = f64_from_order(cur ^ I64_MIN)
            mv = (sel[:, 0] + sel[:, 1]) / 2.0
            meds.append(torch.where(e == 0, float("nan"), mv))
        return meds

    def local_medians(rcode, rrid, rlanes):
        """One shard's complete groups: codes, first-row ids, medians."""
        dv = rcode.device
        mkey = torch.where(rcode >= 0, rcode, KEY_MAX)
        iota = torch.arange(m, device=dv)
        meds = []
        for li, rl in enumerate(rlanes):
            (sc, sv), (sr,) = sort_lex([mkey, rl], ops=[rrid])
            if li == 0:
                mvalid = sc != KEY_MAX
                mflags = mvalid & _new_run(sc)
                tf = _compact_targets(mflags, out_cap)
                start = _place(iota, tf, out_cap, 0)
                end = _place(iota, _compact_targets(mvalid & _run_end(sc),
                                                    out_cap), out_cap, 0)
                gcode = _place(sc, tf, out_cap, -1)
                seg = torch.cumsum(mflags.to(I32) + (~mvalid).to(I32),
                                   0, dtype=I32)
                fidx = _place(_rscan(seg, sr, "min"), tf, out_cap, KEY_MAX)
                my_ng = mflags.sum()
            # same key -> identical code order and boundaries
            nn = torch.cat([iota.new_zeros(1),
                            torch.cumsum((~torch.isnan(sv)).to(I64), 0)])
            e = nn[end + 1] - nn[start]
            lo_i = torch.clamp(start + torch.clamp(e - 1, min=0) // 2,
                               0, m - 1)
            hi_i = torch.clamp(start + e // 2, 0, m - 1)
            mv = (sv[lo_i] + sv[hi_i]) / 2.0
            meds.append(torch.where(e == 0, float("nan"), mv))
        ovf = torch.clamp(my_ng - out_cap, min=0).reshape(1)
        return gcode, fidx, meds, ovf

    def kernel(codes, *lanes):
        # ---- locally-heavy candidates, gathered and deduplicated ------
        cl = smap(lambda _i, c: candidates(c), codes)
        ovf_cand = here(psum(pick(cl, 1)))
        cand = here(all_gather(pick(cl, 0)))
        (cand,), _ = sort_lex([torch.where(cand >= 0, cand, KEY_MAX)])
        dup = torch.cat([torch.zeros(1, dtype=BOOL, device=cand.device),
                         cand[1:] == cand[:-1]])
        cand = torch.where(dup | (cand == KEY_MAX), KEY_MAX, cand)
        (cand_s,), _ = sort_lex([cand])     # KEY_MAX holes at the end

        def cand_row(_me, c):
            cs = cand_s.to(c.device)
            cixc = torch.clamp(torch.searchsorted(cs, c), 0, K - 1)
            is_heavy = (cs[cixc] == c) & (c >= 0)
            return is_heavy, torch.where(is_heavy, cixc, K)
        cand_rows = smap(cand_row, codes)

        # ---- heavy candidates: distributed rank selection -------------
        heavy_meds = rank_select(cand_rows, lanes)

        def heavy_first(me, c, cr):
            # per candidate, its rows' first global row id and count over
            # the K + 1 dense cells (most rows go to the non-candidate K)
            n = int(c.shape[0])
            bc = G.bcast_scan(cr[1], K, n)
            return (torch.where(bc["fidx"] == KEY_MAX, KEY_MAX,
                                bc["fidx"] + me * n),
                    bc["counts"].to(I64))
        hfc = smap(heavy_first, codes, cand_rows)
        hfid = here(pmin(pick(hfc, 0)))
        hcnt = here(psum(pick(hfc, 1)))
        hvalid = (cand_s != KEY_MAX) & (hcnt > 0)
        hcode = torch.where(hvalid, cand_s, -1)
        hfid = torch.where(hvalid, hfid, KEY_MAX)

        # ---- raw-row shuffle by code ownership (light rows) -----------

        def col(me, c):
            n = int(c.shape[0])
            rid = me * n + torch.arange(n, device=c.device)
            return [(c, -1), (rid, KEY_MAX)] + \
                [(ln[me], float("nan")) for ln in lanes]
        recvs, ovf_ex = _shuffle(
            smap(lambda _i, c: c % n_dev, codes),
            smap(lambda _i, c, cr: (c >= 0) & ~cr[0], codes, cand_rows),
            smap(col, codes), n_dev, cap)
        local = smap(lambda d, _c: local_medians(
            recvs[0][d], recvs[1][d], [r[d] for r in recvs[2:]]), codes)
        ovf_out = here(psum(pick(local, 3)))

        # ---- gather + global first-appearance order -------------------
        # heavy candidate lanes are replicated, so they append ONCE
        acode = torch.cat([here(all_gather(pick(local, 0))), hcode])
        afidx = torch.cat([here(all_gather(pick(local, 1))), hfid])
        lmeds = pick(local, 2)
        ameds = [torch.cat([here(all_gather(pick(lmeds, i))), hm])
                 for i, hm in enumerate(heavy_meds)]
        fkey = torch.where(acode >= 0, afidx, KEY_MAX)
        perm = _sort_perm([fkey])
        oc = acode[perm]
        ng = (oc >= 0).sum().reshape(1)
        return tuple([ng, here(psum(ovf_ex)) + ovf_cand, ovf_out, oc,
                      fkey[perm]] + [x[perm] for x in ameds])

    _a2a = (2 + n_lanes) * n_dev * (n_dev - 1) * cap * 8
    _sel = n_lanes * 64 * 2 * (n_dev - 1) * K * 2 * 8   # rank psums
    _ag = (2 + n_lanes) * n_dev * (n_dev - 1) * out_cap * 8
    return _counted(kernel, lambda *a: _a2a + _sel + _ag)


def dist_med_groupby_auto(mesh: Mesh, rows_local: int, n_lanes: int):
    """Overflow-safe distributed median: doubles whichever capacity
    (exchange buckets / output groups) overflowed and re-runs."""
    n_dev = mesh.n
    caps = [max(2 * rows_local // n_dev, 64),
            max(2 * rows_local // n_dev, 64)]
    tried = {}

    def run(codes, *lanes):
        while True:
            key = (caps[0], caps[1])
            if key not in tried:
                tried[key] = dist_med_groupby(
                    mesh, rows_local, caps[0], caps[1], n_lanes)
            out = tried[key](codes, *lanes)
            oe, oo = prof.host("dist.overflow", lambda: (
                int(out[1][0]), int(out[2][0])))
            if oe == 0 and oo == 0:
                # (ng, codes, fidx, *medians)
                return (out[0],) + out[3:]
            if oe:
                caps[0] *= 2
            if oo:
                caps[1] *= 2

    return run


# -- distributed table sort (sample sort) -------------------------------------

def _lex_ge(keys, sps, j, rid, sp_rid):
    """(keys, rid) >= (splitter j's keys, its rid), folding the
    comparison from the last key backward: rid is the last tie-break,
    so the order is total and the routing keeps the sort stable."""
    res = rid >= sp_rid[j]
    for k, sp in zip(reversed(keys), reversed(sps)):
        s = sp[j]
        res = (k > s) | ((k == s) & res)
    return res


def _order_key(k):
    """A sort key as the sorts compare it, so that the splitter compares
    agree with them: an f64 key as its order bits (psort.f64_order) after
    the sort's canonical form (-0.0 ties 0.0; every NaN is one NaN, after
    +inf); an integer key as it is."""
    if k.dtype == F64:
        return f64_order(torch.where(torch.isnan(k), math.nan, k + 0.0))
    return k


def _key_fill(dtype):
    """The pad rows' key: above every real key of an order key of
    `dtype` (an f64 key rides as i64 order bits)."""
    return KEY_MAX if dtype in (I64, F64) else torch.iinfo(dtype).max


def dist_sort(mesh: Mesh, n_rows: int, key_dtypes, cap: int,
              n_samples: int = 64, cap3: int | None = None):
    """Distributed multi-key table sort, a sample sort (the mesh
    analogue of the reference's parallel order-by, core/order.c:246):

      1. each shard sorts (keys..., global row id);
      2. n_samples evenly spaced rows of each sorted run are gathered
         and sorted once; every n_samples-th is a splitter tuple;
      3. a row goes to the shard whose splitter range holds it: the
         count of splitters its (keys, row id) is >= (`_lex_ge`), which
         is monotone along the sorted run;
      4. one all_to_all moves the rows, `cap` per (source, destination);
         rows past it are counted in the overflow, never dropped
         silently (dist_sort_auto retries doubled);
      5. each shard sorts what it received: the shards' runs in shard
         order are the global order;
      6. rebalance to even shards: a row's global position p is the
         rows on the shards before plus its rank, and it goes to the
         owner of p (`_route_back`: rows already there stay, the others
         ride a second all_to_all of `cap3` per pair, each owner places
         its rows by offset). One all_gather of the even shards is the
         replicated permutation.

    fn(*keys) with per-shard lists of i32, i64 or f64 keys -> (overflow
    (1,), the i64 order of the n_rows rows). Pad rows (global row id >=
    n_rows) sort last and are cut. An f64 key is compared by its order
    bits: the reference compares its splitters by IEEE float compares
    while its sorts put NaN last, which misroutes NaN keys (ROADMAP
    queue 3); the engine maps NaN to -inf first, so no query meets
    that."""
    n_dev = mesh.n
    nk = len(key_dtypes)
    S = n_samples
    rows_out = -(-n_rows // n_dev)
    if cap3 is None:
        cap3 = min(max(2 * rows_out // n_dev, 64), rows_out)
    cap3 = min(cap3, rows_out)
    fills = [_key_fill(dt) for dt in key_dtypes] + [KEY_MAX]

    def local_sort(me, keys):
        n = int(keys[0].shape[0])
        rid = me * n + torch.arange(n, device=keys[0].device)
        valid = rid < n_rows
        ks = [torch.where(valid, _order_key(k), f)
              for k, f in zip(keys, fills)]
        return sort_lex(ks + [torch.where(valid, rid, KEY_MAX)])[0]

    def splitters(runs):
        first = here(runs)[0]
        n = int(first.shape[0])
        dv = first.device
        pos = torch.clamp((torch.arange(S, device=dv) * n) // S +
                          max(n // (2 * S), 0), 0, n - 1)
        gathered = [here(all_gather(smap(
            lambda _i, r: r[j][pos.to(r[j].device)], runs)))
            for j in range(nk + 1)]
        gs = sort_lex(gathered)[0]
        at = torch.arange(1, n_dev, device=dv) * S
        return [g[at] for g in gs]

    def route(run, sps):
        n = int(run[0].shape[0])
        dv = run[0].device
        sp = [x.to(dv) for x in sps]
        dest = torch.zeros(n, dtype=I64, device=dv)
        for j in range(n_dev - 1):
            dest += _lex_ge(run[:nk], sp[:nk], j, run[nk], sp[nk])
        # dest ascends along the run: a row's place in its bucket is
        # its distance from the bucket's first row
        start = torch.searchsorted(dest, torch.arange(n_dev, device=dv))
        within = torch.arange(n, device=dv) - start[dest]
        ok = within < cap
        slot = torch.where(ok, dest * cap + within,
                           _dropped(n, n_dev * cap, dv))
        return ([_place(x, slot, n_dev * cap, f) for x, f in zip(run, fills)],
                (~ok).sum().to(I64).reshape(1))

    def kernel(*keys):
        runs = smap(lambda me, _k: local_sort(me, [k[me] for k in keys]),
                    keys[0])
        sps = splitters(runs)
        sent = smap(lambda _i, r: route(r, sps), runs)
        ovf = here(psum(pick(sent, 1)))
        sends = pick(sent, 0)
        recv = [all_to_all(pick(sends, j)) for j in range(nk + 1)]
        mrid = smap(lambda d, _r: sort_lex([r[d] for r in recv])[0][nk],
                    runs)
        valid = smap(lambda _i, r: r != KEY_MAX, mrid)
        counts = here(all_gather(smap(
            lambda _i, v: v.sum().to(I64).reshape(1), valid)))
        first = torch.cumsum(counts, 0) - counts    # exclusive scan
        # each row's global position, whose owner takes it at its offset
        pos = smap(lambda me, v: torch.where(
            v, first.to(v.device)[me] + torch.cumsum(v.to(I64), 0) - 1, -1),
            valid)
        ovf3, (shards,) = _route_back(pos, [mrid], [KEY_MAX], rows_out, cap3)
        return ovf + ovf3.to(ovf.device), here(all_gather(shards))[:n_rows]

    _smp = (nk + 1) * n_dev * (n_dev - 1) * S * 8
    _a2a = (nk + 1) * n_dev * (n_dev - 1) * cap * 8
    _a2a3 = n_dev * (n_dev - 1) * cap3 * (4 + 8)
    _ag = n_dev * (n_dev - 1) * rows_out * 8
    _cnt = n_dev * (n_dev - 1) * 8
    return _counted(kernel, lambda *a: _smp + _a2a + _a2a3 + _ag + _cnt)


def dist_sort_auto(mesh: Mesh, n_rows: int, key_dtypes):
    """Overflow-safe distributed sort: the per-(source, destination)
    capacities start at twice the balanced expectation and double on
    overflow (cap3 up to a shard's rows), each tried pair cached.
    run(*keys) -> the i64 order."""
    n_dev = mesh.n
    rows_local = -(-n_rows // n_dev)
    cap0 = max(2 * rows_local // n_dev, 64)
    tried = {}

    def run(*keys):
        c = c3 = cap0
        while True:
            if (c, c3) not in tried:
                tried[(c, c3)] = dist_sort(
                    mesh, n_rows, tuple(here(k).dtype for k in keys), c,
                    cap3=c3)
            ovf, order = tried[(c, c3)](*keys)
            if int(ovf[0]) == 0:
                return order
            # one counter covers both exchanges: double both
            c *= 2
            c3 = min(c3 * 2, rows_local)

    return run


# -- distributed joins --------------------------------------------------------

def dist_left_probe(mesh: Mesh):
    """Distributed left/inner-join probe, broadcast-build: the (smaller)
    right key column is replicated and each shard probes its row shard
    of the left keys (the reference's HT build + probe, core/index.c:
    2886, with the build side broadcast). The right column is the same
    on every shard, so its (key, position) sort runs once.

    fn(lkeys per shard, rkeys replicated) -> per shard (right row id,
    -1 where none; has match): the first right row with an equal key."""
    n_dev = mesh.n

    def kernel(lkeys, rkeys):
        nr = int(rkeys.shape[0])
        # a stable sort by key is the (key, position) sort
        (sk,), _, sp = sort_lex([rkeys], perm=True)
        sp = sp.to(I64)

        def probe(_me, lk):
            skd, spd = sk.to(lk.device), sp.to(lk.device)
            ixc = torch.searchsorted(skd, lk).clamp(0, nr - 1)
            has = skd[ixc] == lk
            return torch.where(has, spd[ixc], -1), has
        out = smap(probe, lkeys)
        return pick(out, 0), pick(out, 1)

    # the broadcast of the replicated right key column
    return _counted(kernel, lambda lk, rk: (n_dev - 1) * rk.numel() * 8)


_EQ_KPER = 16    # locally-heavy candidate keys per shard and side


def dist_eq_probe(mesh: Mesh, n_total_l: int, cap_l: int, cap_r: int,
                  cap_b: int | None = None):
    """Partitioned-build distributed left/inner-join probe: both sides
    route rows by key % n_shards (all_to_all of `cap_l` / `cap_r` rows
    per (source, destination); overflow counted, never dropped
    silently), each shard sorts its right rows by (key, global row id)
    and probes its left rows with a first-match searchsorted, and each
    result goes back to its left row's owner (`_route_back`, `cap_b`),
    so the output is row-sharded in the left order with no replicating
    all_gather. The reference's HT build + probe
    (core/index.c:2886-2998) with the build side partitioned.

    SKEW: each shard nominates its _EQ_KPER locally heavy keys on either
    side (a run longer than cap / 2: by pigeonhole every key that could
    overflow a bucket is locally heavy somewhere). The candidates are
    gathered; each resolves to its first right row id by one pmin over
    the unrouted right shards, and rows with a candidate key never ride
    the exchange.

    fn(lkey, rkey) with per-shard i64 keys (>= 0 real, -1 padding) ->
    (ovf_l, ovf_r, ovf_b (1,) each, per shard right row ids (-1 where
    none), per shard has-match). Left row ids ride as i32."""
    n_dev = mesh.n
    KPER = _EQ_KPER
    KC = 2 * KPER * n_dev

    def local_heavy(keys, theta):
        """The shard's KPER keys with the longest runs over theta, most
        rows first, ties by key (KEY_MAX fills)."""
        (cs,), _ = sort_lex([torch.where(keys >= 0, keys, KEY_MAX)])
        cvalid = cs != KEY_MAX
        flags = cvalid & _new_run(cs)
        seg = torch.cumsum(flags.to(I32) + (~cvalid).to(I32), 0,
                           dtype=I32)
        runlen = _rscan(seg, torch.ones_like(cs), "sum")
        heavy = flags & (runlen > theta)
        _h, (hc,) = sort_lex([torch.where(heavy, -runlen, KEY_MAX)],
                             ops=[torch.where(heavy, cs, KEY_MAX)])
        if int(hc.shape[0]) < KPER:
            hc = torch.cat([hc, hc.new_full((KPER - int(hc.shape[0]),),
                                            KEY_MAX)])
        return hc[:KPER]

    def member(cand, keys):
        posc = torch.searchsorted(cand, keys).clamp(0, KC - 1)
        return (cand[posc] == keys) & (keys >= 0), posc

    def kernel(lkey, rkey):
        nl = int(here(lkey).shape[0])
        nr = int(here(rkey).shape[0])
        capb = cap_b if cap_b is not None else max(2 * nl // n_dev, 64)

        # ---- heavy candidates, resolved on the unrouted right shards --
        cand = here(all_gather(smap(
            lambda _i, lk, rk: torch.cat([local_heavy(lk, cap_l // 2),
                                          local_heavy(rk, cap_r // 2)]),
            lkey, rkey)))
        (cand,), _ = sort_lex([cand])

        def cmin_of(me, rk):
            c = cand.to(rk.device)
            # row ids ascend within a shard: the stable key sort is the
            # (key, row id) sort
            (lsk,), _, lperm = sort_lex([torch.where(rk >= 0, rk, KEY_MAX)],
                                        perm=True)
            cpc = torch.searchsorted(lsk, c).clamp(0, nr - 1)
            chit = (lsk[cpc] == c) & (c != KEY_MAX)
            return torch.where(chit, me * nr + lperm[cpc].to(I64), KEY_MAX)
        cmin = here(pmin(smap(cmin_of, rkey)))

        # ---- the other rows routed by key % n_shards ------------------
        ml = smap(lambda _i, k: member(cand.to(k.device), k), lkey)
        mr = smap(lambda _i, k: member(cand.to(k.device), k)[0], rkey)
        (xlk, xlr), ovf_l = _shuffle(
            smap(lambda _i, k: k % n_dev, lkey),
            smap(lambda _i, k, m: (k >= 0) & ~m[0], lkey, ml),
            smap(lambda me, k: [
                (k, -1), ((me * nl + torch.arange(nl, device=k.device))
                          .to(I32), -1)], lkey),
            n_dev, cap_l)
        (xrk, xrr), ovf_r = _shuffle(
            smap(lambda _i, k: k % n_dev, rkey),
            smap(lambda _i, k, h: (k >= 0) & ~h, rkey, mr),
            smap(lambda me, k: [
                (k, -1), (me * nr + torch.arange(nr, device=k.device),
                          KEY_MAX)], rkey),
            n_dev, cap_r)

        # ---- per shard: first match = smallest right row id -----------
        def first_match(_me, xk, xr, lk):
            # the received rows' ids ascend (source shards in order, rows
            # in order): the stable key sort is the (key, row id) sort
            (srk,), (srr,) = sort_lex([torch.where(xk >= 0, xk, KEY_MAX)],
                                      ops=[xr])
            ixc = torch.searchsorted(srk, lk.clamp(min=0)) \
                .clamp(0, int(srk.shape[0]) - 1)
            has = (srk[ixc] == lk) & (lk >= 0)
            return torch.where(has, srr[ixc], -1), has
        found = smap(first_match, xrk, xrr, xlk)

        # ---- back to each left row's owner, heavy rows merged there ---
        def heavy_rows(_me, k, m):
            ish, pos = m
            hmin = cmin.to(k.device)[pos]
            h_has = ish & (hmin != KEY_MAX)
            tgt = torch.where(ish, torch.arange(nl, device=k.device),
                              _dropped(nl, nl, k.device))
            return tgt, [torch.where(h_has, hmin, -1), h_has]
        ovf_b, (rid, has) = _route_back(
            xlr, [pick(found, 0), pick(found, 1)], [-1, False], nl, capb,
            smap(heavy_rows, lkey, ml))
        return (here(psum(ovf_l)), here(psum(ovf_r)), ovf_b, rid, has)

    capb_est = cap_b if cap_b is not None else cap_l
    _a2a = n_dev * (n_dev - 1) * \
        ((8 + 4) * cap_l + 16 * cap_r + (4 + 8 + 1) * capb_est)
    _cand = 2 * n_dev * (n_dev - 1) * KC * 8
    return _counted(kernel, lambda *a: _a2a + _cand)


def dist_asof_probe(mesh: Mesh):
    """Distributed asof join as a ring probe: left rows never move, each
    shard sorts its own right shard by (key << 31 | time, the payload's
    order bits) once, and the sorted shards rotate around the ring in
    n_shards steps (the reference's ppermute j -> j + 1: shard d takes
    shard d - 1's). Each step binary-searches the shard's left probes
    into the visiting right shard and keeps a running lexicographic max
    of (packed key, payload bits). No key-routed exchange, so a hot key
    costs what a uniform one does.

    fn(lkey, lts, rkey, rts, rval), all per-shard lists (keys >= 0 real,
    -1 padding; times below 2^31) -> per shard (value, NaN where none;
    has match), in the left order. Equal (key, time) rows resolve to
    the highest payload (with row-id payloads, the last by position)."""
    n_dev = mesh.n

    def kernel(lkey, lts, rkey, rts, rval):
        def right_run(_me, rk, rt_, rv):
            rpk = torch.where(rk >= 0, (rk << 31) | rt_, KEY_MAX)
            return sort_lex([rpk, f64_order(rv)])[0]
        runs = smap(right_run, rkey, rts, rval)
        srk, svs = pick(runs, 0), pick(runs, 1)
        lpk = smap(lambda _i, lk, lt: (lk.clamp(min=0) << 31) | lt,
                   lkey, lts)
        bpk = smap(lambda _i, x: torch.full_like(x, -1), lpk)
        bvs = smap(lambda _i, x: torch.full_like(x, I64_MIN), lpk)
        for step in range(n_dev):
            for d in owned(lkey):
                lk, q = lkey[d], lpk[d]
                sk, sv = srk[d], svs[d]
                ix = torch.searchsorted(sk, q, right=True) - 1
                ixc = ix.clamp(0, int(sk.shape[0]) - 1)
                ok = (ix >= 0) & ((sk[ixc] >> 31) == lk) & (lk >= 0)
                cpk = torch.where(ok, sk[ixc], -1)
                cvs = torch.where(ok, sv[ixc], I64_MIN)
                better = (cpk > bpk[d]) | ((cpk == bpk[d]) & (cvs > bvs[d]))
                bpk[d] = torch.where(better, cpk, bpk[d])
                bvs[d] = torch.where(better, cvs, bvs[d])
            if step < n_dev - 1:
                srk = rotate(srk)
                svs = rotate(svs)
        hits = smap(lambda _i, b: b >= 0, bpk)
        vals = smap(lambda _i, h, v: torch.where(h, f64_from_order(v),
                                                 math.nan), hits, bvs)
        return vals, hits

    # each right row rides the whole ring: n_shards steps x 16 bytes (the
    # shards are of one size: the global rows from this process's)
    return _counted(kernel, lambda lk, lts, rk, rts, rv:
                    n_dev * n_dev * int(here(rk).numel()) * 16)
