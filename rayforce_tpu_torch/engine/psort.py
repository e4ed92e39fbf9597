"""The device engine's sort entry point.

Contract (the TPU package's psort `sort_i32` / `sort_mixed` /
`split64` / `join64`): M parallel int32 words are sorted by their
first `n_keys` words as a signed-i32 lexicographic key, ascending, and
come back at the input length. i64 keys and payloads travel as two
words (hi signed, lo with its sign bit flipped, so that signed compare
of lo gives unsigned order); f64 payloads travel as their i64 bits.
`stable_iota` appends an i32 iota key word. psort's contract allows an
unstable sort; both versions here are stable (equal keys keep their
row order), so the output is deterministic.

Every engine sort goes through here: `sort_i32` (words), `sort_mixed`
(one key with payloads), `sort_lex` (several i32/i64/f64 keys with
payloads: wide's multi-word keys and order carry-sort),
`sort_by_code` (med's (code, value) sort) and `argsort` (the order
sorts). `perm=True` also returns the sort's own permutation, so that
no caller carries an iota payload to get it.

On a CUDA tensor the sort launches the hand-written radix sort in
`csrc/radix_sort.cu` (it replaces the TPU's blocked bitonic sort, both
of its pallas_call sites); on a CPU tensor it runs `sort_i32_plain`.
There is nothing in between.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from ..core import profiler as prof
from .device import DeviceError

INT32_MIN = -(1 << 31)

# launches of each hand-written kernel (this radix sort, groupby.py's
# segmented scan and dense aggregate, wide.py's key-word kernels,
# sortagg.py's main sort words, "sortagg_keys"; the mesh's stage A
# kernels, parallel/dist.py `shard_partials_cuda`, once a
# shard a stage A, and "shard_reduce" once a shard a stage A that totals
# a scanned lane by their reduce and carry), read by chip_smoke.py,
# portbench's readers and tests; besides, "radix_key_words" adds each
# radix sort's key words, and "sortagg_exact" counts sort-agg answers
# that came from its exact plan (sortagg.py `run`, a straggler's
# fallback included); parted selects launch from worker threads, so the
# count takes a lock
LAUNCHES = {"radix_sort": 0, "seg_scan": 0, "dense_agg": 0, "wide_keys": 0,
            "shard_partials": 0, "shard_reduce": 0, "radix_key_words": 0,
            "sortagg_exact": 0, "sortagg_keys": 0}
_LAUNCHES_LOCK = threading.Lock()

_P, _I32, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64

# (restype, argtypes) of every extern "C" function of csrc/radix_sort.cu;
# tests/test_torch_psort.py holds this table against the source
ARGTYPES = {
    "rf_radix_sort_tile": (_I32, []),
    "rf_radix_sort_small_max": (_I32, []),
    "rf_radix_sort_skip_offset": (_I32, []),
    "rf_radix_sort_scratch_bytes": (_I64, [_I64, _I32, _I32, _I32, _I32]),
    "rf_radix_sort_i32": (_I32, [_P, _P, _I32, _I32, _I64, _P, _I32, _P,
                                 _P]),
}

_lib = None


def _radix_lib():
    global _lib
    if _lib is None:
        from . import cubuild
        lib = cubuild.load("radix_sort")
        try:
            for name, (res, args) in ARGTYPES.items():
                fn = getattr(lib, name)
                fn.restype = res
                fn.argtypes = args
        except AttributeError as e:
            raise DeviceError(f"radix sort library: {e}") from e
        _lib = lib
    return _lib


def _launch(lib, words, n_keys, n, want_perm, route):
    dev = words[0].device
    outs = [torch.empty_like(w) for w in words]
    perm = torch.empty(n, dtype=torch.int32, device=dev) if want_perm \
        else None
    m = len(words)
    nbytes = lib.rf_radix_sort_scratch_bytes(n, m, n_keys, int(want_perm),
                                             route)
    # int64 elements: the caching allocator's blocks are 512-byte aligned
    scratch = torch.empty(-(-nbytes // 8), dtype=torch.int64, device=dev)
    ins = (ctypes.c_void_p * m)(*[w.data_ptr() for w in words])
    ous = (ctypes.c_void_p * m)(*[o.data_ptr() for o in outs])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.rf_radix_sort_i32(
            ctypes.cast(ins, ctypes.c_void_p),
            ctypes.cast(ous, ctypes.c_void_p), m, n_keys, n,
            perm.data_ptr() if want_perm else None, route,
            scratch.data_ptr(), stream)
    if rc != 0:
        raise DeviceError(f"radix sort launch failed: cudaError {rc}")
    return outs, perm, scratch.view(torch.int32)


def sort_i32_plain(words, n_keys=1, perm=False):
    """Plain PyTorch version: stable sorts from the last key word to
    the first, then one index_select of every word. With perm, also the
    int32 permutation (sorted row i came from row perm[i])."""
    n = words[0].shape[0]
    p = torch.arange(n, device=words[0].device)
    for w in reversed(words[:n_keys]):
        idx = torch.sort(w.index_select(0, p), stable=True).indices
        p = p.index_select(0, idx)
    outs = [w.index_select(0, p) for w in words]
    return (outs, p.to(torch.int32)) if perm else outs


def sort_i32_cuda(words, n_keys=1, skipped=None, perm=False, route=-1):
    """The CUDA radix sort on int32 CUDA tensors of one length. Any
    failure to build, load, allocate or launch raises DeviceError.
    `skipped`, a list, receives one flag per 8-bit pass (4 per key
    word, the last key word's low byte first): 1 where the kernel
    skipped the pass because every row has the same digit. Reading it
    waits for the sort. With perm, also returns the int32 permutation.
    `route` -1 lets the kernel pick how a large sort moves its words (by
    its estimate of the bytes each way); 0 and 1 force the route that
    carries every word through the passes and the one that carries row
    ids and gathers (chip_smoke.py times both)."""
    lib = _radix_lib()
    n = int(words[0].shape[0])
    if n >= (1 << 31) - 1:
        raise DeviceError(f"radix sort: {n} rows exceed int32 row ids")
    if n == 0:
        outs = [torch.empty_like(w) for w in words]
        return (outs, torch.empty(0, dtype=torch.int32,
                                  device=words[0].device)) if perm else outs
    try:
        outs, p, state = _launch(lib, words, n_keys, n, perm, route)
    except DeviceError:
        raise
    except Exception as e:
        raise DeviceError(f"radix sort: {type(e).__name__}: {e}") from e
    with _LAUNCHES_LOCK:
        LAUNCHES["radix_sort"] += 1
        LAUNCHES["radix_key_words"] += n_keys
    if skipped is not None:
        off = lib.rf_radix_sort_skip_offset()
        skipped += prof.host("psort.skipped",
                             state[off:off + 4 * n_keys].tolist)
    return (outs, p) if perm else outs


def sort_i32(ops, n_keys=1, perm=False):
    """Sort M parallel 1-D tensors of one length by their first n_keys
    words (each taken as int32; signed lexicographic, ascending, stable).
    Returns the sorted int32 words at the input length; with perm, the
    pair (words, int32 permutation: sorted row i came from row perm[i])."""
    if not 1 <= n_keys <= len(ops):
        raise ValueError(f"n_keys={n_keys} with {len(ops)} words")
    words = [x.to(torch.int32).contiguous() for x in ops]
    dev = words[0].device
    if any(w.device != dev or w.shape != words[0].shape for w in words):
        raise ValueError("sort_i32: words differ in device or shape")
    if dev.type == "cuda":
        return sort_i32_cuda(words, n_keys, perm=perm)
    if dev.type == "cpu":
        return sort_i32_plain(words, n_keys, perm=perm)
    raise DeviceError(f"sort_i32: no sort for device {dev}")


def split64(x):
    """i64 -> (hi signed i32, lo bias-flipped i32) preserving order
    under (hi, lo) signed-lex compare."""
    x = x.to(torch.int64)
    hi = (x >> 32).to(torch.int32)
    lo = x.to(torch.int32) ^ INT32_MIN
    return hi, lo


def join64(hi, lo):
    lo_u = (lo ^ INT32_MIN).to(torch.int64) & 0xFFFFFFFF
    return (hi.to(torch.int64) << 32) | lo_u


def f64_order(x):
    """f64 (no NaN) -> i64 whose signed order is the float order (-0.0
    just below 0.0, as lax.sort orders floats)."""
    b = x.contiguous().view(torch.int64)
    return torch.where(b < 0, b ^ 0x7FFFFFFFFFFFFFFF, b)


def f64_from_order(k):
    return torch.where(k < 0, k ^ 0x7FFFFFFFFFFFFFFF, k).view(torch.float64)


def _words(x):
    """The i32 words of one operand: i64 and f64 (as its i64 bits) take
    two, anything narrower one."""
    if x.dtype == torch.float64:
        return list(split64(x.contiguous().view(torch.int64)))
    if x.dtype == torch.int64:
        return list(split64(x))
    return [x.to(torch.int32)]


def _unwords(out, i, x):
    """Operand x's sorted value from its words starting at out[i]."""
    if x.dtype in (torch.int64, torch.float64):
        v = join64(out[i], out[i + 1])
        return (v.view(torch.float64) if x.dtype == torch.float64 else v), 2
    return out[i].to(x.dtype), 1


def sort_lex(keys, ops=(), stable_iota=False, perm=False):
    """The engine's `lax.sort(keys + ops, num_keys=len(keys))` call
    shape: keys compared lexicographically, ascending; each key is i32,
    i64 (two words, split64) or f64 (its order-preserving i64 bits,
    f64_order; the caller maps NaN). Carried operands are i32, i64, f64
    or narrower. `stable_iota` appends an i32 iota as the last key word.
    Returns (sorted keys, sorted ops), and with perm the int32
    permutation as a third item (sorted row i came from row perm[i])."""
    words = []
    for k in keys:
        words += _words(f64_order(k) if k.dtype == torch.float64 else k)
    n_keys = len(words)
    if stable_iota:
        n = int(keys[0].shape[0])
        words.append(torch.arange(n, dtype=torch.int32,
                                  device=keys[0].device))
        n_keys += 1
    for x in ops:
        words += _words(x)
    out = sort_i32(words, n_keys=n_keys, perm=perm)
    if perm:
        out, p = out
    skeys, i = [], 0
    for k in keys:
        if k.dtype == torch.float64:
            skeys.append(f64_from_order(join64(out[i], out[i + 1])))
            i += 2
        else:
            v, w = _unwords(out, i, k)
            skeys.append(v)
            i += w
    i = n_keys
    sops = []
    for x in ops:
        v, w = _unwords(out, i, x)
        sops.append(v)
        i += w
    return (skeys, sops, p) if perm else (skeys, sops)


def sort_mixed(key, ops, stable_iota=False):
    """The engine's `sort([key] + ops)` call shape: one i32/i64 key with
    carried i32/i64/f64 (or narrower) payload operands. Returns
    (sorted_key, sorted_ops)."""
    skeys, sops = sort_lex([key], ops, stable_iota)
    return skeys[0], sops


def argsort(key):
    """The stable ascending order of one i32/i64/f64 key as int64 row ids
    (the sort's own permutation; no iota payload rides the sort)."""
    return sort_lex([key], perm=True)[2].long()


def sort_by_code(codes, key):
    """key sorted by (codes, key) lexicographically: med's two-key sort
    (an i32 code word, then an i32, i64 or f64 key)."""
    return sort_lex([codes.to(torch.int32), key])[0][1]
