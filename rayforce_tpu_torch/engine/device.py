"""Device engine: the per-column device cache, per-table column stats,
and which device the engine runs on.

- Device choice. With no setting the engine runs on `cuda`; if CUDA is
  absent, the first column upload raises `DeviceError` (it does not
  quietly run on CPU torch). `RAYFORCE_DEVICE=cpu` (or
  `set_device("cpu")`) runs the device path on CPU torch with each
  kernel's plain version, as the tests do. `RAYFORCE_DEVICE=0` (or
  `set_enabled(False)`) runs the host numpy path.
- Columns are uploaded once and cached on their Obj.
- Column stats (min, max, has_null, qscale) are computed for a whole
  table at once and fetched in one transfer.
- The mesh (`mesh`, `dev_col_sharded`): with RAYFORCE_MESH=N one
  process drives N row shards of each table (parallel/dist.py), or,
  under RAYFORCE_COORDINATOR, each of P processes drives N / P of them.
  With one process a table is placed and its stats computed shard by
  shard (`put_table`), so no card ever holds a whole column: a whole
  device copy is made only when an engine that is not the mesh's asks
  for one, and `WHOLE_COPIES` counts those made while a mesh is on.
- Config: the row threshold for the device path, the dense
  code-space cap (the analogue of the reference's perfect-hash range
  guard, core/index.c:2308-2424), and on a mesh the largest right side
  a join replicates (`bcast_max`).
"""
from __future__ import annotations

import os

import numpy as np
import torch

from ..core import profiler as prof
from ..core import types as T
from ..core.obj import Obj, to_np


class DeviceError(RuntimeError):
    """The device engine cannot run: no card, or a kernel failed to
    build, load, allocate or launch. The select hook re-raises it
    instead of running the host path."""


def is_fault(e: BaseException) -> bool:
    """Whether an error on the device path must propagate instead of
    falling back to the host path: a DeviceError, an out-of-memory
    error, or a CUDA error that a torch call raised (an asynchronous
    fault in a kernel surfaces in a later call, as torch's
    AcceleratorError or, in older torch, a RuntimeError naming CUDA).
    Anything else is a plan the engine cannot run, and the host path
    takes it, as in the reference."""
    if isinstance(e, (DeviceError, torch.OutOfMemoryError)):
        return True
    if type(e).__name__ == "AcceleratorError":
        return True
    return isinstance(e, RuntimeError) and "CUDA" in str(e)


# -- configuration ----------------------------------------------------------

_cfg = {
    "enabled": None,       # None: from RAYFORCE_DEVICE at first use
    "device": None,        # None: from RAYFORCE_DEVICE at first use
    "threshold": 1 << 17,  # rows below this stay on the host numpy path
    "dense_max": 1 << 20,  # max dense group-code space (H*W <= ~1M)
    "bcast_max": 1 << 22,  # a mesh join replicates a right side this big
    "dist_timeout": 60.0,  # seconds a multi-process mesh waits for a peer
}


def available() -> bool:
    if _cfg["enabled"] is None:
        _cfg["enabled"] = os.environ.get("RAYFORCE_DEVICE", "") != "0"
    return bool(_cfg["enabled"])


def set_enabled(flag) -> None:
    _cfg["enabled"] = flag


def set_device(name) -> None:
    """Run the device path on `name` ("cuda" or "cpu") from now on."""
    _cfg["device"] = torch.device(name)
    _cfg["enabled"] = True


def device() -> torch.device:
    """The engine's device. Raises DeviceError when it is CUDA and no
    card is present."""
    d = _cfg["device"]
    if d is None:
        env = os.environ.get("RAYFORCE_DEVICE", "")
        d = torch.device("cpu" if env == "cpu" else "cuda")
        _cfg["device"] = d
    if d.type == "cuda" and not torch.cuda.is_available():
        raise DeviceError("the device engine runs on CUDA and no card is "
                          "present; set RAYFORCE_DEVICE=cpu to run it on "
                          "CPU torch or RAYFORCE_DEVICE=0 for the host path")
    return d


def set_threshold(n: int) -> None:
    _cfg["threshold"] = n


def should_use(n_rows: int) -> bool:
    return available() and n_rows >= _cfg["threshold"]


_mesh_state = {"mesh": None, "checked": False}


def _procs():
    """(world, rank) of a multi-process mesh from RAYFORCE_NUM_PROCS and
    RAYFORCE_PROC_ID."""
    try:
        world = int(os.environ["RAYFORCE_NUM_PROCS"])
        rank = int(os.environ["RAYFORCE_PROC_ID"])
    except (KeyError, ValueError) as e:
        raise DeviceError("RAYFORCE_COORDINATOR needs RAYFORCE_NUM_PROCS "
                          "and RAYFORCE_PROC_ID as integers") from e
    if world < 1 or not 0 <= rank < world:
        raise DeviceError(f"RAYFORCE_PROC_ID={rank} is not a rank of "
                          f"RAYFORCE_NUM_PROCS={world} processes")
    return world, rank


def backend_for(d, world) -> str:
    """The torch.distributed backend of a multi-process mesh on device
    `d`: gloo on CPU torch; NCCL where every rank has a card of its own
    (rank r on card r of at least `world` visible cards); gloo where
    ranks share a card, which NCCL refuses, its collectives staging the
    CUDA tensors through pinned host memory (parallel/dist.py)."""
    if d.type == "cuda" and torch.cuda.device_count() >= world:
        return "nccl"
    return "gloo"


def _start_procs(coord, world, rank, backend):
    """Join the process group once (its rendezvous at `coord`, host:port),
    waiting at most `dist_timeout` seconds for a peer."""
    import datetime
    import torch.distributed as td
    if td.is_initialized():
        if (td.get_world_size(), td.get_rank(), td.get_backend()) != \
                (world, rank, backend):
            raise DeviceError(
                "this process is already rank "
                f"{td.get_rank()} of {td.get_world_size()} "
                f"({td.get_backend()}), not {rank} of {world} ({backend})")
        return
    try:
        td.init_process_group(
            backend, init_method=f"tcp://{coord}", world_size=world,
            rank=rank,
            timeout=datetime.timedelta(seconds=_cfg["dist_timeout"]))
    except (RuntimeError, ValueError) as e:
        raise DeviceError(f"rank {rank} of {world} could not join the "
                          f"mesh at {coord} ({backend}): {e}") from e


def mesh():
    """The device mesh when mesh mode is on (RAYFORCE_MESH=N, or `auto`
    for one shard per visible card), else None. One process drives its
    N shards, spread over the visible cards from the engine's (parallel/
    dist.py make_mesh): 8 shards share one card, or CPU torch. Grouped
    selects, joins, table sorts and window joins then run as per-shard
    stages with their collectives (parallel/dist.py).

    Under RAYFORCE_COORDINATOR=host:port, with RAYFORCE_NUM_PROCS=P and
    RAYFORCE_PROC_ID=r, the N shards span P processes (N a multiple of
    P; `auto`: P times the cards a process sees, or P on CPU torch):
    rank r drives shards [r N/P, (r + 1) N/P), all on its card (card
    r % count) or CPU torch, over the backend `backend_for` names."""
    if _mesh_state["mesh"] is not None and \
            _mesh_state.get("device") != device():
        _mesh_state["checked"] = False     # the engine moved devices
    if not _mesh_state["checked"]:
        spec = os.environ.get("RAYFORCE_MESH")
        coord = os.environ.get("RAYFORCE_COORDINATOR")
        d = m = None
        if spec:
            d = device()
            count = torch.cuda.device_count() if d.type == "cuda" else 1
            world, rank = _procs() if coord else (1, 0)
            try:
                n = world * count if spec == "auto" else int(spec)
            except ValueError:
                n = 0
            from ..parallel.dist import make_mesh
            if world > 1:
                if n % world:
                    raise DeviceError(
                        f"RAYFORCE_MESH={n} shards do not split over "
                        f"{world} processes")
                backend = backend_for(d, world)
                shard_dev = d
                if d.type == "cuda":
                    torch.cuda.set_device(rank % count)
                    shard_dev = torch.device("cuda", rank % count)
                _start_procs(coord, world, rank, backend)
                m = make_mesh(n, device=shard_dev, world=world, rank=rank,
                              backend=backend)
            elif n > 1:
                m = make_mesh(n, device=d)
        _mesh_state.update({"mesh": m, "checked": True, "device": d})
    return _mesh_state["mesh"]


def mesh_key():
    """What a cached plan built under the current mesh depends on."""
    m = mesh()
    return None if m is None else m.key


# -- column device cache ----------------------------------------------------

_STATLESS = (T.GUID, T.C8, T.LIST)

# whole-column device copies made while a mesh is on (`dev_col` with
# `_mesh_state["mesh"]` set): the mesh's own placement and engines make
# none
WHOLE_COPIES = {"count": 0}


def dev_col(col: Obj) -> torch.Tensor:
    """Device copy of a column's payload, cached on the Obj. A column
    whose payload is still device-resident (DevPending) is used as-is."""
    d = device()
    if isinstance(col.meta, dict) and "dev" in col.meta:
        arr = col.meta["dev"]
        if arr.device == d or (arr.device.type == d.type == "cuda"):
            return arr
    p = col.pending()
    arr = p.arr if p is not None else \
        torch.from_numpy(np.ascontiguousarray(to_np(col))).to(d)
    if _mesh_state["mesh"] is not None:
        WHOLE_COPIES["count"] += 1
    if not isinstance(col.meta, dict):
        col.meta = {}
    col.meta["dev"] = arr
    return arr


def dev_col_sharded(col: Obj, m) -> list:
    """Row-sharded device copy of a column for mesh `m`: one padded row
    slice per shard (the pipelines mask pad rows by global row id),
    cached on the Obj for that mesh only. A column on the device already
    (a whole copy, or a DevPending payload, which this forces) is sliced
    there; any other is sliced from the host column block by block, each
    block straight onto its shard's device, so no device holds the whole
    column. Under a multi-process mesh only this process's shards are
    placed (every process holds the whole table on the host)."""
    if isinstance(col.meta, dict):
        hit = col.meta.get("dev_sh")
        if hit is not None and hit[0] == m.key:
            return hit[1]
    from ..parallel.dist import shard_rows
    on_dev = col.pending() is not None or (
        isinstance(col.meta, dict) and "dev" in col.meta)
    src = dev_col(col) if on_dev else np.ascontiguousarray(to_np(col))
    shards, _pad = shard_rows(m, src)
    if not isinstance(col.meta, dict):
        col.meta = {}
    col.meta["dev_sh"] = (m.key, shards)
    return shards


# decimal fixed-point scales probed by the column-stats pass: an f64
# column whose finite values all sit on one of these grids (and fit i32
# when scaled) can ride group-by sorts as an EXACT i32 operand.
QSCALES = (1.0, 1e2, 1e4, 1e6)

_I64_MAX = 0x7FFFFFFFFFFFFFFF
_I64_MIN = -0x8000000000000000
_INT_NULL = {torch.int64: int(T.NULL_I64), torch.int32: int(T.NULL_I32),
             torch.int16: int(T.NULL_I16)}


def _f64_range(a):
    """(NaN mask, min, max) of an f64 column, NaNs skipped."""
    nulls = torch.isnan(a)
    return nulls, torch.where(nulls, np.inf, a).min(), \
        torch.where(nulls, -np.inf, a).max()


def _int_range(a):
    """(min, max, has_null) of an integer column as i64 scalars, its
    type's null skipped."""
    nv = _INT_NULL.get(a.dtype)
    x = a.to(torch.int64)
    if nv is None:
        return x.min(), x.max(), x.new_zeros(())
    nulls = a == nv
    return torch.where(nulls, _I64_MAX, x).min(), \
        torch.where(nulls, _I64_MIN, x).max(), nulls.any().to(torch.int64)


def _on_grid(a, nulls, s):
    """Whether every non-null value of f64 `a` sits on the decimal grid
    1/s (within the stats tolerance) and fits i32 scaled: a 0-d bool."""
    vs = a * s
    rv = torch.round(vs)
    err = torch.abs(vs - rv)
    tol = 1e-7 + torch.abs(vs) * 1e-13
    return torch.where(
        nulls, True, (err <= tol) & (torch.abs(rv) <= (1 << 31) - 2)).all()


def _k_stat_parts(a):
    """The stats part of a column, or of one shard of it: a 7-vector
    (min, max, has_null, then for each scale of QSCALES whether the
    values sit on its grid), skipping nulls/NaNs, f64 for f64 values,
    else i64 with the flags zero. `_combine_parts` makes the column's
    stats of its parts."""
    if a.dtype == torch.float64:
        nulls, lo, hi = _f64_range(a)
        return torch.stack([lo, hi, nulls.any().to(torch.float64)] + [
            _on_grid(a, nulls, s).to(torch.float64) for s in QSCALES])
    lo, hi, anyn = _int_range(a)
    z = lo.new_zeros(())
    return torch.stack([lo, hi, anyn, z, z, z, z])


def _combine_parts(parts, is_f64):
    """A column's (min, max, has_null, qscale) from its fetched parts
    (one for a whole column, one a shard): mins by min, maxes by max,
    nulls by any, grid flags by all. has_null lets query plans drop
    per-group null work; qscale (f64 columns only; 0 = none) is the
    smallest decimal grid the values provably sit on, which lets them
    ride sorts as exact i32 operands."""
    lo = min(p[0] for p in parts)
    hi = max(p[1] for p in parts)
    anyn = any(p[2] for p in parts)
    if not is_f64:
        return [lo, hi, int(anyn), 0]
    ok = [s for j, s in enumerate(QSCALES) if all(p[3 + j] for p in parts)]
    return [lo, hi, float(anyn), min(ok, default=0.0)]


def _fetch(outs):
    """Every stats vector to the host in one transfer (f64 vectors ride
    as their i64 bits)."""
    rows = prof.host("device.stats", torch.stack(
        [o.view(torch.int64) if o.dtype == torch.float64 else o
         for o in outs]).cpu).numpy()
    return [r.view(np.float64) if o.dtype == torch.float64 else r
            for o, r in zip(outs, rows)]


def put_table(tbl: Obj) -> None:
    """Pre-stage all columns of a table on the device and compute their
    min/max stats (null/NaN-skipping) with one batched fetch. Under a
    mesh of one process, shard by shard (`_put_sharded`)."""
    _, cols = tbl.v
    m = mesh()
    if m is not None and m.world == 1 and cols and len(cols[0]):
        with prof.span("place: shards"):
            _put_sharded(cols, m)
        return
    statless = []
    arrs = []
    for c in cols:
        if c.t == T.LIST or c.t < 0 or c.t in T.UNPARTED_OF:
            continue
        a = dev_col(c)
        if c.t not in _STATLESS and not (
                isinstance(c.meta, dict) and "range" in c.meta):
            statless.append(c)
            arrs.append(a)
    if arrs:
        for c, p in zip(statless, _fetch([_k_stat_parts(a) for a in arrs])):
            _cache_stats(c, _combine_parts([p], c.t == T.F64))


def _put_sharded(cols, m) -> None:
    """put_table under mesh `m` of one process: each column's row shards
    placed (`dev_col_sharded`; a mesh copy cached for `m` is used as it
    is), each statted column's stats made from its shards' parts over
    their real rows, every part fetched in one transfer. Columns with no
    stats are placed on first use. No device gets a whole column."""
    parts, owners = [], []
    for c in cols:
        if c.t == T.LIST or c.t < 0 or c.t in T.UNPARTED_OF or \
                c.t in _STATLESS:
            continue
        shards = dev_col_sharded(c, m)
        if isinstance(c.meta, dict) and "range" in c.meta:
            continue
        n, per = len(c), int(shards[0].shape[0])
        for i, sh in enumerate(shards):
            real = min(max(n - i * per, 0), per)
            if real:
                parts.append(_k_stat_parts(sh[:real]).to(shards[0].device))
                owners.append(c)
    if not parts:
        return
    got: dict = {}
    for c, p in zip(owners, _fetch(parts)):
        got.setdefault(id(c), (c, []))[1].append(p)
    for c, ps in got.values():
        _cache_stats(c, _combine_parts(ps, c.t == T.F64))


def _cache_stats(c, lh):
    if c.t == T.F64:
        c.meta["range"] = (float(lh[0]), float(lh[1]))
        c.meta["qscale"] = float(lh[3]) or None
    else:
        c.meta["range"] = (int(lh[0]), int(lh[1]))
    c.meta["has_null"] = bool(lh[2])


def _ensure_stats(col: Obj):
    if not (isinstance(col.meta, dict) and "range" in col.meta):
        lh = _combine_parts(_fetch([_k_stat_parts(dev_col(col))]),
                            col.t == T.F64)
        if not isinstance(col.meta, dict):
            col.meta = {}
        _cache_stats(col, lh)


def column_range(col: Obj):
    """(min, max) of a column ignoring nulls/NaNs, cached."""
    _ensure_stats(col)
    return col.meta["range"]


def column_has_null(col: Obj) -> bool:
    _ensure_stats(col)
    return col.meta["has_null"]


def column_qscale(col: Obj):
    """Decimal fixed-point scale S (1/100/1e4/1e6) such that every
    finite value of this F64 column is (within the stats tolerance) an
    integer multiple of 1/S with |v*S| < 2^31 — or None. Lets sort
    engines ride the column as an exact i32 operand."""
    if col.t != T.F64:
        return None
    _ensure_stats(col)
    return col.meta.get("qscale")
