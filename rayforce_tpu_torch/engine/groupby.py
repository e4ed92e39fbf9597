"""Group-by kernels: dense per-code aggregates, the segmented scan and
the output packing.

- Dense per-code aggregates for small code spaces (`bcast_scan`), exact
  integer segment sums (`matmul_tasks_scan`, with `int_limb_weights` /
  `recombine_limbs` for full-width i64 sums) and both over the same
  codes at once (`dense_scan`). The TPU package computes these without
  scatters, by an (L, n) equality mask per 65536-row chunk and by f32
  one-hot MXU matmuls over 8-bit limbs, because its TPU has no fast
  scatter. Here every one of them is one call of `_dense_agg`: on a
  CUDA tensor the hand-written kernel of `csrc/dense_agg.cu`
  (`dense_agg_cuda`), on a CPU tensor its plain version
  `dense_agg_plain`, torch scatters over copies of the cells (`_cells`:
  with at most 513 cells a plain scatter would put millions of atomics
  on each address). Counts, integer sums (wrapping i64), first/last
  row ids and extrema are exact, so any order of the rows gives the
  same bits. f64 sums are added in one order fixed by the row index
  (`_fixed_order_sums`: a left fold in row order inside 1024-row
  chunks, then a pairwise tree over the chunks), which the kernel
  follows add for add.
- The inclusive segmented min/max/sum scan over runs of equal segment
  ids (sort-agg, wide, the joins, the mesh): on a CUDA tensor the
  hand-written kernel of `csrc/seg_scan.cu`, on a CPU tensor its plain
  version `seg_scan_plain`.
- `Packer` / `unpack`: every output lane of a dense plan in ONE i64
  buffer, so the host pays one device-to-host transfer per query.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
import threading

import numpy as np
import torch

from ..core import profiler as prof
from .device import DeviceError
from .psort import LAUNCHES, _LAUNCHES_LOCK, f64_from_order, f64_order

LIMB_BITS = 8
LIMB_MASK = (1 << LIMB_BITS) - 1
SMALL_N = 512

I64_MIN = -0x8000000000000000
KEY_MAX = 0x7FFFFFFFFFFFFFFF

_SEG_B = 1024   # intra-block width for the two-level segmented scan

_IDENT = {
    torch.float64: {"min": float("inf"), "max": float("-inf"), "sum": 0.0},
    torch.int32: {"min": 0x7FFFFFFF, "max": -0x80000000, "sum": 0},
    torch.int64: {"min": KEY_MAX, "max": I64_MIN, "sum": 0},
}


I64 = torch.int64


# -- dense scatters -----------------------------------------------------------

_COPIES = 4096        # most copies of the cells a dense scatter spreads over
_COPY_ROWS = 2048     # fewest rows per copy


def _cells(codes, n_cells: int, n_rows: int):
    """Scatter targets of the rows for n_cells dense cells: row r goes to
    copy r % C of its code's cell, so neighbouring rows (one warp) hit
    different addresses and no address takes more than ~n_rows / C
    atomics. Returns (flat targets, C); `_scatter_sum` / `_scatter_ext`
    reduce the C copies."""
    idx = codes[:n_rows].long()
    n_copies = min(_COPIES, max(1, n_rows // _COPY_ROWS))
    if n_copies > 1:
        rows = torch.arange(n_rows, dtype=I64, device=idx.device)
        idx = (rows % n_copies) * n_cells + idx
    return idx, n_copies


def _scatter_sum(cells, n_cells, x):
    """Exact i64 per-cell sums of the integer rows x ((n_rows,) or
    (n_rows, k)) at `_cells` targets."""
    idx, n_copies = cells
    acc = torch.zeros((n_copies * n_cells,) + tuple(x.shape[1:]), dtype=I64,
                      device=x.device)
    acc.index_add_(0, idx, x.to(I64))
    return acc.view((n_copies, n_cells) + tuple(x.shape[1:])).sum(0)


def _scatter_ext(cells, n_cells, x, op, init=None):
    """Per-cell amin/amax of x at `_cells` targets; an empty cell holds
    `init` (default: the losing extreme of x's dtype). f64 goes through
    its order-preserving i64 bits, so -0.0 and 0.0 never tie."""
    idx, n_copies = cells
    f64 = x.dtype == torch.float64
    if init is None:
        init = _IDENT[x.dtype]["min" if op == "amin" else "max"]
    out = torch.full((n_copies * n_cells,), init, dtype=x.dtype,
                     device=x.device)
    if f64:
        out, x = f64_order(out), f64_order(x)
    out.scatter_reduce_(0, idx, x, op)
    out = out.view(n_copies, n_cells)
    out = out.amin(0) if op == "amin" else out.amax(0)
    return f64_from_order(out) if f64 else out


# -- exact integer segment sums ----------------------------------------------

def int_limb_weights(arr, null_val, lo: int | None, hi: int | None):
    """Split a (possibly null-carrying) integer array into 8-bit limbs
    plus a null flag (i32 tensors), so full-width i64 sums stay exact:
    the host recombines the limb sums in Python ints (recombine_limbs).

    With cached column stats [lo, hi] the value is biased by lo and
    only ceil(bits(span)/8) limbs are emitted; otherwise the value is
    sign-xor biased to the full unsigned 64-bit range (8 limbs). Limbs
    are taken on i64 (torch has few uint64 ops on CUDA): a wrapped i64
    holds the same bytes as the u64 it stands for."""
    a = arr.to(I64)
    nulls = (a == int(null_val)) if null_val is not None else \
        torch.zeros(a.shape, dtype=torch.bool, device=a.device)
    a = torch.where(nulls, 0, a)
    if lo is not None and hi is not None and hi >= lo:
        u = torch.where(nulls, 0, a - lo)
        bias = -lo  # sum = limb_total - eff*bias
        width = max((hi - lo).bit_length(), 1)
    else:
        u = torch.where(nulls, 0, a ^ I64_MIN)
        bias = 1 << 63
        width = 64
    n_limbs = -(-width // LIMB_BITS)
    limbs = [((u >> (LIMB_BITS * i)) & LIMB_MASK).to(torch.int32)
             for i in range(n_limbs)]
    return limbs, nulls.to(torch.int32), bias


def recombine_limbs(limb_sums: list[np.ndarray], bias: int,
                    counts: np.ndarray, null_counts: np.ndarray):
    """Host-side exact recombination of per-group limb sums (f64,
    exact integers) into Python-int group sums. Nulls were zeroed on
    device and excluded from the bias correction."""
    n = len(limb_sums[0])
    out = np.zeros(n, dtype=object)
    for i, s in enumerate(limb_sums):
        out = out + s.astype(np.int64).astype(object) * (1 << (LIMB_BITS * i))
    eff = (counts - null_counts).astype(object)
    out = out - eff * bias
    return out


# -- the dense aggregate: plain version, kernel, dispatch ------------------

_DENSE_CHUNK = 1024   # rows of a chunk of the fixed f64 order (DA_CHUNK)


def _fixed_order_sums(codes, vals, n_cells):
    """(n_cells, F) f64 sums of the rows of vals (F (n,) f64 lanes) by
    code in [0, n_cells), in the order the kernel adds them: rows in
    chunks of _DENSE_CHUNK; in a chunk each cell's partial is the left
    fold of its rows in row order from -0.0; then the chunk partials of
    a cell combine by a pairwise tree over the chunk index, level by
    level, an odd last node passed up as it is. The fold runs one step
    per rank of a row among its (chunk, code)'s rows, over every
    (chunk, code) at once; each add is one torch add, as the kernel's
    fma(1.0, b, a) is on the card."""
    n, F, dv = int(codes.shape[0]), len(vals), codes.device
    W = n_cells
    if n == 0:
        return torch.full((W, F), -0.0, dtype=torch.float64, device=dv)
    K = -(-n // _DENSE_CHUNK)
    pos = torch.arange(n, device=dv)
    key = (pos // _DENSE_CHUNK) * W + codes.long()
    order = torch.argsort(key, stable=True)
    sk = key[order]
    new = torch.ones(n, dtype=torch.bool, device=dv)
    new[1:] = sk[1:] != sk[:-1]
    rank = pos - torch.cummax(torch.where(new, pos, 0), 0).values
    by_rank = torch.argsort(rank, stable=True)
    rows, keys = order[by_rank], sk[by_rank]
    v = torch.stack(vals, 1)
    acc = torch.full((K * W, F), -0.0, dtype=torch.float64, device=dv)
    lo = 0
    for size in prof.host("groupby.rank_sizes",
                          torch.bincount(rank).tolist):
        t = keys[lo:lo + size]
        acc[t] = acc[t] + v[rows[lo:lo + size]]
        lo += size
    x = acc.view(K, W, F)
    while x.shape[0] > 1:
        h = x.shape[0] // 2
        y = x[0:2 * h:2] + x[1:2 * h:2]
        x = torch.cat([y, x[2 * h:]]) if x.shape[0] % 2 else y
    return x[0]


def dense_agg_plain(codes, n_cells, n_rows, ints=(), fsums=(), mins=(),
                    maxs=(), want_counts=True, want_fidx=True):
    """Plain PyTorch version of the dense aggregate over rows
    [0, n_rows), codes in [0, n_cells). Returns (n_cells,) lanes:
    counts (i64); fidx / lidx (i64, KEY_MAX / -1 for an empty cell);
    int{j} the wrapping i64 sum of ints[j] (i32 or i64); fsum{j} the
    fixed-order sum of fsums[j] (f64; 0.0 for an empty cell); min{j} /
    max{j} of mins[j] / maxs[j] (i32, i64 or f64, in their type; the
    losing extreme for an empty cell; f64 through its order bits, so
    -0.0 and 0.0 never tie)."""
    c = codes[:n_rows]
    dv = c.device
    W = n_cells
    cells = _cells(c, W, n_rows)
    out = {}
    acc = _scatter_sum(cells, W, torch.stack(
        [x[:n_rows].to(I64) for x in ints] +
        [torch.ones(n_rows, dtype=I64, device=dv)], 1))
    cnt = acc[:, -1]
    if want_counts:
        out["counts"] = cnt
    for j in range(len(ints)):
        out[f"int{j}"] = acc[:, j]
    if want_fidx:
        rows = torch.arange(n_rows, dtype=I64, device=dv)
        out["fidx"] = _scatter_ext(cells, W, rows, "amin")
        out["lidx"] = _scatter_ext(cells, W, rows, "amax", init=-1)
    if fsums:
        tot = _fixed_order_sums(c, [x[:n_rows] for x in fsums], W)
        for j in range(len(fsums)):
            out[f"fsum{j}"] = torch.where(cnt == 0, 0.0, tot[:, j])
    for j, m in enumerate(mins):
        out[f"min{j}"] = _scatter_ext(cells, W, m[:n_rows], "amin")
    for j, m in enumerate(maxs):
        out[f"max{j}"] = _scatter_ext(cells, W, m[:n_rows], "amax")
    return out


# (restype, argtypes) of every extern "C" function of csrc/dense_agg.cu;
# tests/test_torch_dense_agg.py holds this table against the source
_P, _I32, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
DENSE_ARGTYPES = {
    "rf_dense_agg_chunk": (_I32, []),
    "rf_dense_agg_scratch_bytes": (_I64, [_I64, _I32, _I32, _I32]),
    "rf_dense_agg_launches": (_I32, [_I64, _I32, _I32, _I32]),
    "rf_dense_agg": (_I32, [_P, _I32, _I64, _I64, _I32, _I32, _P, _P, _P,
                            _P, _P, _P, _P, _P, _P, _P]),
}
# the lanes' ops by the source's DA_* number; the most lanes of a call
# (DA_MAX_LANES); the shared memory one dense_pass CTA may take (DA_SMEM);
# the zeroed head of the scratch (DA_ZERO_BYTES): mirrors the tests hold
# against the source
_DA_OPS = {"int": 0, "min": 1, "max": 2, "fsum": 3}
DENSE_MAX_LANES = 24
DENSE_SMEM = 232448
DENSE_ZERO_BYTES = 232704


def dense_fits(n_cells, n_acc, n_f):
    """Whether the cells of n_acc integer words and n_f f64 sums a cell
    fit one dense_pass CTA of one warp (the source's smem_of at P=1)."""
    return 8 * (n_acc * n_cells + n_f * n_cells + 32) <= DENSE_SMEM


def dense_load_route(x, codes=False):
    """How dense_pass reads x: "contiguous" (stride 1: a warp's 32 rows
    in one coalesced load), "constant" (codes of stride 0: every row on
    one code), else "strided"."""
    if codes and x.stride(0) == 0:
        return "constant"
    return "contiguous" if x.stride(0) == 1 else "strided"


# (device, stream) -> the scratch of the dense kernel on that stream, its
# first DENSE_ZERO_BYTES zero between calls (the kernel zeroes what it
# used); calls on one stream run one after another on the card
_dense_work: dict = {}
_DENSE_WORK_LOCK = threading.Lock()


def _dense_scratch(device, stream, nbytes):
    key = (device, stream)
    with _DENSE_WORK_LOCK:
        buf = _dense_work.get(key)
        if buf is None or buf.numel() * 8 < nbytes:
            buf = torch.zeros(-(-nbytes // 8), dtype=I64, device=device)
            _dense_work[key] = buf
    return buf


_dlib = None


def _dense_lib():
    global _dlib
    if _dlib is None:
        from . import cubuild
        lib = cubuild.load("dense_agg")
        try:
            for name, (res, args) in DENSE_ARGTYPES.items():
                fn = getattr(lib, name)
                fn.restype = res
                fn.argtypes = args
        except AttributeError as e:
            raise DeviceError(f"dense aggregate library: {e}") from e
        if lib.rf_dense_agg_chunk() != _DENSE_CHUNK:
            raise DeviceError(f"dense aggregate library: chunks of "
                              f"{lib.rf_dense_agg_chunk()} rows, not "
                              f"{_DENSE_CHUNK}")
        _dlib = lib
    return _dlib


@functools.lru_cache(maxsize=256)
def _dense_plan(n_cells, fsum, want_fidx):
    """((lane indices, n_acc, n_f), ...) of the library calls for lanes
    whose f64-sum flags are `fsum`: each call's cells fit one CTA; the
    first call also takes fidx and lidx; every call counts."""
    batches, cur, n_acc, n_f = [], [], 3 if want_fidx else 1, 0
    for i, f in enumerate(fsum):
        if cur and (len(cur) == DENSE_MAX_LANES or
                    not dense_fits(n_cells, n_acc + (not f), n_f + f)):
            batches.append((tuple(cur), n_acc, n_f))
            cur, n_acc, n_f = [], 1, 0
        cur.append(i)
        n_acc, n_f = n_acc + (not f), n_f + f
        if not dense_fits(n_cells, n_acc, n_f):
            raise ValueError(f"dense_agg: {n_cells} cells do not fit one "
                             "CTA's shared memory")
    if not dense_fits(n_cells, n_acc, n_f):
        raise ValueError(f"dense_agg: {n_cells} cells do not fit one CTA's "
                         "shared memory")
    return tuple(batches) + ((tuple(cur), n_acc, n_f),)


def _dense_batches(n_cells, lanes, want_fidx):
    """The lanes [(name, tensor, op)] cut into calls whose cells fit one
    CTA (`_dense_plan`)."""
    plan = _dense_plan(n_cells, tuple(op == "fsum" for _n, _x, op in lanes),
                       want_fidx)
    return [[lanes[i] for i in idx] for idx, _a, _f in plan]


def dense_agg_cuda(codes, n_cells, n_rows, ints=(), fsums=(), mins=(),
                   maxs=(), want_counts=True, want_fidx=True):
    """The CUDA dense aggregate (csrc/dense_agg.cu) of CUDA tensors: bit
    for bit `dense_agg_plain` on the same card, the same lanes. Codes
    (i32 or i64) and every lane are read in place at their strides (a
    stride-0 view too). One call of the library is two kernel launches
    and no memset, its scratch the stream's (`_dense_scratch`); lanes
    whose cells do not fit one CTA together go in more than one call.
    Any failure to build, load, allocate or launch, and a shape the
    kernel does not take, raises DeviceError."""
    lanes = [(f"int{j}", x, "int") for j, x in enumerate(ints)] + \
        [(f"fsum{j}", x, "fsum") for j, x in enumerate(fsums)] + \
        [(f"min{j}", x, "min") for j, x in enumerate(mins)] + \
        [(f"max{j}", x, "max") for j, x in enumerate(maxs)]
    ok = {"int": (torch.int32, torch.int64), "fsum": (torch.float64,),
          "min": tuple(_KINDS), "max": tuple(_KINDS)}
    dv = codes.device
    if codes.dtype not in (torch.int32, torch.int64) or codes.dim() != 1 \
            or not 0 <= n_rows <= codes.shape[0] or n_cells < 1 or any(
                x.dtype not in ok[op] or x.dim() != 1 or x.device != dv or
                x.shape[0] < n_rows for _nm, x, op in lanes):
        raise ValueError(
            f"dense_agg: {n_rows} rows of codes {codes.dtype} "
            f"{tuple(codes.shape)} on {dv} over {n_cells} cells, lanes " +
            ", ".join(f"{op} {x.dtype} {tuple(x.shape)} on {x.device}"
                      for _nm, x, op in lanes))
    plan = _dense_plan(n_cells, tuple(op == "fsum" for _n, _x, op in lanes),
                       want_fidx)
    lib = _dense_lib()
    W = n_cells
    # every output a row of one buffer: one allocation a call
    names = [nm for nm, _x, _op in lanes] + \
        (["counts"] if want_counts else []) + \
        (["fidx", "lidx"] if want_fidx else [])
    buf = torch.empty((len(names), W), dtype=I64, device=dv)
    out = {nm: buf[i] for i, nm in enumerate(names)}
    for nm, x, op in lanes:
        if op != "int" and x.dtype != I64:
            out[nm] = out[nm].view(x.dtype)[:W]
    try:
        with _card_stream(dv) as stream:
            for bi, (idx, n_acc, n_f) in enumerate(plan):
                k = max(len(idx), 1)
                fid = want_fidx and bi == 0
                nbytes = lib.rf_dense_agg_scratch_bytes(n_rows, W, n_acc,
                                                        n_f)
                if nbytes < 0:
                    raise DeviceError(f"dense_agg: {n_rows} rows over {W} "
                                      f"cells, {n_acc} words and {n_f} f64 "
                                      "sums a cell: not a shape the kernel "
                                      "takes")
                scratch = _dense_scratch(dv, stream, nbytes)
                batch = [lanes[i] for i in idx]
                rc = lib.rf_dense_agg(
                    codes.data_ptr(), _KINDS[codes.dtype], codes.stride(0),
                    n_rows, W, len(batch),
                    (ctypes.c_void_p * k)(*[x.data_ptr()
                                            for _nm, x, _op in batch]),
                    (ctypes.c_int64 * k)(*[x.stride(0)
                                           for _nm, x, _op in batch]),
                    (ctypes.c_int * k)(*[_KINDS[x.dtype]
                                         for _nm, x, _op in batch]),
                    (ctypes.c_int * k)(*[_DA_OPS[op]
                                         for _nm, _x, op in batch]),
                    (ctypes.c_void_p * k)(*[out[nm].data_ptr()
                                            for nm, _x, _op in batch]),
                    out["counts"].data_ptr() if want_counts and bi == 0
                    else None,
                    out["fidx"].data_ptr() if fid else None,
                    out["lidx"].data_ptr() if fid else None,
                    scratch.data_ptr(), stream)
                if rc != 0:
                    break
    except DeviceError:
        raise
    except Exception as e:
        raise DeviceError(f"dense_agg: {type(e).__name__}: {e}") from e
    if rc != 0:
        raise DeviceError(f"dense_agg launch failed: cudaError {rc}")
    with _LAUNCHES_LOCK:
        LAUNCHES["dense_agg"] += 1
    return out


def _dense_agg(codes, n_cells, n_rows, ints=(), fsums=(), mins=(),
               maxs=(), want_counts=True, want_fidx=True):
    """The dense aggregate of `dense_agg_plain`'s contract: on a CUDA
    tensor the hand-written kernel, on a CPU tensor the plain version;
    nothing in between."""
    dev = codes.device
    args = (codes, n_cells, n_rows, ints, fsums, mins, maxs, want_counts,
            want_fidx)
    if dev.type == "cuda":
        return dense_agg_cuda(*args)
    if dev.type == "cpu":
        return dense_agg_plain(*args)
    raise DeviceError(f"dense_agg: no dense aggregate for device {dev}")


# -- the dense scans of the <=512-code select --------------------------------

def dense_scan(codes, n: int, n_rows: int, tasks=(), sums=(), mins=(),
               maxs=(), want_counts=True, want_fidx=True):
    """`bcast_scan` and `matmul_tasks_scan` over the same codes in one
    pass: bcast_scan's lanes, and task{t} the exact sum of tasks[t] as
    f64, each (n,)."""
    fs = [i for i, s in enumerate(sums) if s.dtype == torch.float64]
    isums = [s for i, s in enumerate(sums) if i not in fs]
    raw = _dense_agg(codes, n + 1, n_rows, list(tasks) + isums,
                     [sums[i] for i in fs], mins, maxs, want_counts,
                     want_fidx)
    out = {}
    if want_counts:
        out["counts"] = raw["counts"][:n].to(torch.int32)
    if want_fidx:
        out["fidx"], out["lidx"] = raw["fidx"][:n], raw["lidx"][:n]
    j = len(tasks)
    for i in range(len(sums)):
        if i in fs:
            out[f"sum{i}"] = raw[f"fsum{fs.index(i)}"][:n]
        else:
            out[f"sum{i}"] = raw[f"int{j}"][:n].to(torch.float64)
            j += 1
    for i in range(len(mins)):
        out[f"min{i}"] = raw[f"min{i}"][:n]
    for i in range(len(maxs)):
        out[f"max{i}"] = raw[f"max{i}"][:n]
    for t in range(len(tasks)):
        out[f"task{t}"] = raw[f"int{t}"][:n].to(torch.float64)
    return out


def bcast_scan(codes, n: int, n_rows: int, sums=(), mins=(), maxs=(),
               want_counts=True, want_fidx=True):
    """Dense per-code aggregates over codes in [0, n]; code n is the
    trash slot (masked rows) and is dropped. sums: integer lanes (summed
    exactly in i64) or f64 lanes, nulls pre-zeroed by the caller; mins/
    maxs: i64 or f64 lanes, nulls pre-mapped by the caller to the losing
    extreme. Returns a dict of dense (n,) lanes with the TPU package's
    types and sentinels: counts i32; fidx / lidx i64 first / last row
    ids (KEY_MAX / -1 for an empty code); sum{i} f64; min{i} / max{i}
    of their input's dtype (the losing extreme for an empty code)."""
    return dense_scan(codes, n, n_rows, (), sums, mins, maxs, want_counts,
                      want_fidx)


def matmul_tasks_scan(codes, weights: list, n_cells: int, n_rows: int):
    """Exact dense segment sums of each weights[i] (n_rows,) by group
    code (codes in [0, n_cells)). Returns a list of (n_cells,) f64 sums.

    The weights hold integers (8-bit limbs, ones, null flags), as the
    TPU package's f32 one-hot matmuls require; here they are integer
    lanes of the dense aggregate, summed in i64."""
    raw = _dense_agg(codes, n_cells, n_rows, list(weights),
                     want_counts=False, want_fidx=False)
    return [raw[f"int{t}"].to(torch.float64) for t in range(len(weights))]


# -- sorted-segment kernels ---------------------------------------------------

def _identity_for(vals, op):
    return _IDENT[vals.dtype][op]


def _apply(op, a, b):
    if op == "min":
        return torch.minimum(a, b)
    if op == "max":
        return torch.maximum(a, b)
    return a + b


def seg_scan_plain(seg_ids, vals, op, reverse=False):
    """Plain PyTorch version of the segmented scan. Two-level log
    doubling: log2(B) shift+op steps inside 1024-wide blocks, then a
    block-summary scan and one combine pass — the same blocking as the
    TPU package's scan, so sums add in the same order. vals is (n,) or
    (n, L): L lanes scanned at once, each exactly as on its own.
    reverse: the scan of the flipped arrays, flipped back."""
    if reverse:
        return _scan_forward(seg_ids.flip(0), vals.flip(0), op).flip(0)
    return _scan_forward(seg_ids, vals, op)


def _scan_forward(seg_ids, vals, op):
    ident = _identity_for(vals, op)
    n = vals.shape[0]
    lanes = tuple(vals.shape[1:])
    ex = (slice(None), slice(None)) + (None,) * len(lanes)
    R = -(-n // _SEG_B)
    pad = R * _SEG_B - n
    s2 = torch.cat([seg_ids, seg_ids.new_full((pad,), -2)]) \
        .reshape(R, _SEG_B)
    m = torch.cat([vals, vals.new_full((pad,) + lanes, ident)]) \
        .reshape((R, _SEG_B) + lanes)

    d = 1
    while d < _SEG_B:
        same = (s2[:, d:] == s2[:, :-d])[ex]
        shifted = torch.where(same, m[:, :-d], ident)
        m = torch.cat([m[:, :d], _apply(op, m[:, d:], shifted)], dim=1)
        d *= 2

    # block summaries: segmented scan over block tail values, with
    # flags = boundary inside the block OR at its left joint
    first_seg = s2[:, 0]
    carry_seg = s2[:, -1]
    cv = m[:, -1]
    internal = first_seg != carry_seg
    joint = torch.cat([torch.ones(1, dtype=torch.bool, device=vals.device),
                       first_seg[1:] != carry_seg[:-1]])
    g = internal | joint
    ex1 = (slice(None),) + (None,) * len(lanes)
    d = 1
    while d < R:
        ga, gb = g[:-d], g[d:]
        combined = _apply(op, cv[:-d], cv[d:])
        cv = torch.cat([cv[:d], torch.where(gb[ex1], cv[d:], combined)])
        g = torch.cat([g[:d], ga | gb])
        d *= 2
    # exclusive prefix for each block r = inclusive at r-1 when chained
    pfx = torch.cat([cv.new_full((1,) + lanes, ident), cv[:-1]])
    pfx = torch.where(joint[ex1], ident, pfx)
    in_first_run = (s2 == first_seg[:, None])[ex]
    m = torch.where(in_first_run, _apply(op, m, pfx[:, None]), m)
    return m.reshape((R * _SEG_B,) + lanes)[:n]


# (restype, argtypes) of every extern "C" function of csrc/seg_scan.cu;
# tests/test_torch_seg_scan.py holds this table against the source
ARGTYPES = {
    "rf_seg_scan_block": (_I32, []),
    "rf_seg_scan_scratch_bytes": (_I64, [_I64, _I32, _I32]),
    "rf_seg_scan_route": (_I32, [_I64, _I32]),
    "rf_seg_scan": (_I32, [_P, _I32, _I64, _P, _I32, _I64, _I64, _P, _I64,
                           _I32, _I32, _I32, _P, _P]),
}
_KINDS = {torch.int32: 0, torch.int64: 1, torch.float64: 2}
_OPS = {"min": 0, "max": 1, "sum": 2}

# The kernel's routes, by rf_seg_scan_route's number: integer values chain
# the block tails by a decoupled look-back in one launch; f64 values keep
# the plain version's tail doubling, in shared memory where a lane's tails
# and flags fit (SEG_TAIL_SMEM bytes, 8 + 1 a block), else in global
# memory. Mirrors of the source's constants, which the tests hold against
# it; chip_smoke.py holds the mirror against the library's answers.
SEG_ROUTES = ("lookback", "shared_tail", "global_tail")
SEG_TAIL_SMEM = 232448        # SS_TAIL_SMEM
SEG_COUNTER_BYTES = 256       # SS_COUNTER_BYTES
ROUTES = dict.fromkeys(SEG_ROUTES, 0)   # kernel calls per route


def _a256(x):
    return -(-x // 256) * 256


def seg_scan_route(n, dtype):
    """The route name the kernel takes for n rows of `dtype` values (of
    any number of lanes)."""
    if dtype != torch.float64:
        return "lookback"
    return "shared_tail" if -(-n // _SEG_B) * 9 <= SEG_TAIL_SMEM \
        else "global_tail"


def seg_scan_launches(n, dtype):
    """(kernel launches, memsets) of one call of the kernel on its route:
    integer values one block pass after a memset of the look-back words;
    f64 the block pass, the tail pass (none for a single block) and the
    fix-up."""
    if n <= 0:
        return 0, 0
    if seg_scan_route(n, dtype) == "lookback":
        return 1, 1
    return (3 if n > _SEG_B else 2), 0


def seg_scan_scratch_bytes(n, lanes, dtype):
    """Scratch bytes of one call, the regions its route uses, each
    256-byte aligned: lookback, a look-back word (a status and a value,
    twice the value's bytes) per block and lane and the counter; the f64
    routes, a summary word per block and the block tails, and the global
    tail the tails' second buffer and two flag bytes per block."""
    R = -(-n // _SEG_B)
    vb = 4 if dtype == torch.int32 else 8
    route = seg_scan_route(n, dtype)
    if route == "lookback":
        return _a256(R * lanes * 2 * vb) + SEG_COUNTER_BYTES
    shared = _a256(R * 4) + _a256(R * lanes * vb)
    if route == "shared_tail":
        return shared
    return shared + _a256(R * lanes * vb) + _a256(2 * R)


_lib = None


def _seg_lib():
    global _lib
    if _lib is None:
        from . import cubuild
        lib = cubuild.load("seg_scan")
        try:
            for name, (res, args) in ARGTYPES.items():
                fn = getattr(lib, name)
                fn.restype = res
                fn.argtypes = args
        except AttributeError as e:
            raise DeviceError(f"segmented scan library: {e}") from e
        if lib.rf_seg_scan_block() != _SEG_B:
            raise DeviceError(f"segmented scan library: blocks of "
                              f"{lib.rf_seg_scan_block()} rows, not {_SEG_B}")
        _lib = lib
    return _lib


@contextlib.contextmanager
def _card_stream(device):
    """`device` made current; yields its current stream's handle."""
    if device.index is None or device.index == torch.cuda.current_device():
        yield torch.cuda.current_stream(device).cuda_stream
        return
    with torch.cuda.device(device):
        yield torch.cuda.current_stream(device).cuda_stream


def seg_scan_cuda(seg_ids, vals, op, reverse=False):
    """The CUDA segmented scan (csrc/seg_scan.cu) of CUDA tensors: bit
    for bit `seg_scan_plain` on the same card: for integer values one
    kernel launch after a memset, for f64 three launches
    (`seg_scan_route`). ids (i32 or i64) and values (i32, i64 or f64;
    (n,) or (n, L)) are read in place, at their strides. Any failure to
    build, load, allocate or launch raises DeviceError."""
    n = int(vals.shape[0])
    if op not in _OPS or vals.dtype not in _KINDS or vals.dim() > 2 or \
            seg_ids.dtype not in (torch.int32, torch.int64) or \
            seg_ids.shape != (n,) or seg_ids.device != vals.device:
        raise ValueError(f"seg_scan: {op!r} of {vals.dtype} "
                         f"{tuple(vals.shape)} on {vals.device} by ids "
                         f"{seg_ids.dtype} {tuple(seg_ids.shape)} on "
                         f"{seg_ids.device}")
    lib = _seg_lib()
    out = torch.empty(vals.shape, dtype=vals.dtype, device=vals.device)
    if out.numel() == 0:
        return out
    L = 1 if vals.dim() == 1 else int(vals.shape[1])
    try:
        route = SEG_ROUTES[lib.rf_seg_scan_route(n, _KINDS[vals.dtype])]
        nbytes = lib.rf_seg_scan_scratch_bytes(n, L, _KINDS[vals.dtype])
        scratch = torch.empty(-(-nbytes // 8), dtype=torch.int64,
                              device=vals.device)
        with _card_stream(vals.device) as stream:
            rc = lib.rf_seg_scan(
                seg_ids.data_ptr(), _KINDS[seg_ids.dtype], seg_ids.stride(0),
                vals.data_ptr(), _KINDS[vals.dtype], vals.stride(0),
                vals.stride(-1), out.data_ptr(), n, L, _OPS[op],
                int(reverse), scratch.data_ptr(), stream)
    except Exception as e:
        raise DeviceError(f"seg_scan: {type(e).__name__}: {e}") from e
    if rc != 0:
        raise DeviceError(f"seg_scan launch failed: cudaError {rc}")
    with _LAUNCHES_LOCK:
        LAUNCHES["seg_scan"] += 1
        ROUTES[route] += 1
    return out


def _seg_scan(seg_ids, vals, op, reverse=False):
    """Inclusive segmented scan over runs of equal seg_ids (sorted
    ascending): on a CUDA tensor the hand-written kernel, on a CPU
    tensor the plain version; nothing in between. reverse=True scans
    from each row to its run's end (the scan of the flipped arrays,
    flipped back), so a run's first row holds its total."""
    dev = vals.device
    if dev.type == "cuda":
        return seg_scan_cuda(seg_ids, vals, op, reverse)
    if dev.type == "cpu":
        return seg_scan_plain(seg_ids, vals, op, reverse)
    raise DeviceError(f"seg_scan: no scan for device {dev}")


def seg_doubling_min(seg_ids, vals, reverse=False):
    return _seg_scan(seg_ids, vals, "min", reverse)


def seg_doubling_max(seg_ids, vals, reverse=False):
    return _seg_scan(seg_ids, vals, "max", reverse)


def seg_doubling_sum(seg_ids, vals, reverse=False):
    return _seg_scan(seg_ids, vals, "sum", reverse)


# -- output packing -----------------------------------------------------------

class Packer:
    """Accumulates a plan's output lanes into ONE i64 buffer (f64 lanes
    as their bits, narrower integers widened), so a query result crosses
    to the host in one transfer; `unpack` restores each lane's dtype."""

    _TAGS = {torch.float64: "f64", torch.int32: "i32"}

    def __init__(self):
        self.lanes = []
        self.layout = []     # (name, dtype tag, offset, length)
        self._off = 0

    def add(self, name: str, arr):
        tag = self._TAGS.get(arr.dtype, "i64")
        w = arr.contiguous().view(I64) if tag == "f64" else arr.to(I64)
        w = w.reshape(-1)
        self.lanes.append(w)
        self.layout.append((name, tag, self._off, int(w.shape[0])))
        self._off += int(w.shape[0])

    def pack(self):
        return torch.cat(self.lanes), self.layout


_NP = {"f64": np.float64, "i32": np.int32, "i64": np.int64}


def unpack(buf: np.ndarray, layout):
    """The host lanes of a packed buffer (an i64 numpy array)."""
    out = {}
    for nm, tag, off, ln in layout:
        x = buf[off:off + ln]
        out[nm] = x.view(np.float64) if tag == "f64" else \
            x.astype(_NP[tag])
    return out
