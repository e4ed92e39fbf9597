"""Group-by kernels, in plain torch.

- Dense per-code aggregates for small code spaces (`bcast_scan`) and
  exact integer segment sums (`matmul_tasks_scan`, with
  `int_limb_weights` / `recombine_limbs` for full-width i64 sums). The
  TPU package computes these without scatters, by an (L, n) equality
  mask per 65536-row chunk and by f32 one-hot MXU matmuls over 8-bit
  limbs, because its TPU has no fast scatter. Hopper scatters well, so
  here they are scatters: i64 `index_add_` for counts and integer sums,
  `scatter_reduce` amin/amax for row ids and extrema. With at most 513
  cells, a plain scatter would put millions of atomics on each address
  (and every row of a no-by select on one), which serialises them; so
  rows are dealt round-robin over up to 4096 copies of the cells and
  the copies are reduced afterwards (`_cells`). Integer adds and min/max
  are exact, so the result is the same on every run. f64 sums are the
  one lane a scatter cannot give deterministically (atomic f64 adds
  change their order, and so their last bits, from run to run): they
  take one stable sort of the codes through the psort entry and the
  segmented scan below, a fixed order.
- The inclusive segmented min/max/sum scan over runs of equal segment
  ids (sort-agg, wide, the joins, the mesh, and the f64 sums above):
  on a CUDA tensor the hand-written kernel of `csrc/seg_scan.cu`, on a
  CPU tensor its plain version `seg_scan_plain`.
- `Packer` / `unpack`: every output lane of a dense plan in ONE i64
  buffer, so the host pays one device-to-host transfer per query.
"""
from __future__ import annotations

import contextlib
import ctypes

import numpy as np
import torch

from .device import DeviceError
from .psort import LAUNCHES, _LAUNCHES_LOCK, f64_from_order, f64_order, \
    sort_lex

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

def matmul_tasks_scan(codes, weights: list, n_cells: int, n_rows: int):
    """Exact dense segment sums of each weights[i] (n_rows,) by group
    code (codes in [0, n_cells)). Returns a list of (n_cells,) f64 sums.

    The weights hold integers (8-bit limbs, ones, null flags), as the
    TPU package's f32 one-hot matmuls require; here one i64 scatter-add
    takes every task at once."""
    w = torch.stack([x[:n_rows].to(I64) for x in weights], 1)
    acc = _scatter_sum(_cells(codes, n_cells, n_rows), n_cells, w)
    return [acc[:, t].to(torch.float64) for t in range(len(weights))]


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


# -- small-n dense aggregates ------------------------------------------------

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
    c = codes[:n_rows]
    dv = c.device
    W = n + 1
    cells = _cells(c, W, n_rows)
    out = {}
    fsums = [i for i, s in enumerate(sums) if s.dtype == torch.float64]
    isums = [i for i, s in enumerate(sums) if i not in fsums]
    # counts and the integer sums: one scatter-add of their stacked rows
    ints = [s[:n_rows].to(I64) for i, s in enumerate(sums) if i in isums]
    need_cnt = want_counts or bool(fsums)
    if need_cnt:
        ints.append(torch.ones(n_rows, dtype=I64, device=dv))
    if ints:
        acc = _scatter_sum(cells, W, torch.stack(ints, 1))
        for j, i in enumerate(isums):
            out[f"sum{i}"] = acc[:n, j].to(torch.float64)
        cnt = acc[:, -1] if need_cnt else None
    if want_counts:
        out["counts"] = cnt[:n].to(torch.int32)
    if want_fidx:
        rows = torch.arange(n_rows, dtype=I64, device=dv)
        out["fidx"] = _scatter_ext(cells, W, rows, "amin")[:n]
        out["lidx"] = _scatter_ext(cells, W, rows, "amax", init=-1)[:n]
    if fsums:
        # rows in code order (stable: row order within a code), then
        # each code's total sits on its last sorted row
        (sc,), _, perm = sort_lex([c.to(torch.int32)], perm=True)
        perm = perm.long()
        ends = torch.clamp(torch.cumsum(cnt, 0)[:n] - 1, min=0)
        empty = cnt[:n] == 0
        tot = seg_doubling_sum(sc, torch.stack(
            [sums[i][:n_rows][perm] for i in fsums], 1))[ends]
        for j, i in enumerate(fsums):
            out[f"sum{i}"] = torch.where(empty, 0.0, tot[:, j])
    for i, m in enumerate(mins):
        out[f"min{i}"] = _scatter_ext(cells, W, m[:n_rows], "amin")[:n]
    for i, m in enumerate(maxs):
        out[f"max{i}"] = _scatter_ext(cells, W, m[:n_rows], "amax")[:n]
    return out


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
_P, _I32, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
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
