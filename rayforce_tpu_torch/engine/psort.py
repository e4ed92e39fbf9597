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

On a CUDA tensor the sort launches the hand-written radix sort in
`csrc/radix_sort.cu` (it replaces the TPU's blocked bitonic sort, both
of its pallas_call sites); on a CPU tensor it runs `sort_i32_plain`.
There is nothing in between.
"""
from __future__ import annotations

import ctypes

import torch

from .device import DeviceError

INT32_MIN = -(1 << 31)

# launches of each hand-written kernel, read by chip_smoke.py and tests
LAUNCHES = {"radix_sort": 0}

_lib = None


def _radix_lib():
    global _lib
    if _lib is None:
        from . import cubuild
        lib = cubuild.load("radix_sort")
        try:
            for fn in (lib.rf_radix_sort_tile, lib.rf_radix_sort_state_ints):
                fn.restype = ctypes.c_int
                fn.argtypes = []
            lib.rf_radix_sort_i32.restype = ctypes.c_int
            lib.rf_radix_sort_i32.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                ctypes.c_int64] + [ctypes.c_void_p] * 7
        except AttributeError as e:
            raise DeviceError(f"radix sort library: {e}") from e
        _lib = lib
    return _lib


def _launch(lib, words, n_keys, n):
    dev = words[0].device
    outs = [torch.empty_like(w) for w in words]
    ntiles = -(-n // lib.rf_radix_sort_tile())
    scratch = [torch.empty(n, dtype=torch.int32, device=dev)
               for _ in range(4)]
    counts = torch.empty(256 * ntiles, dtype=torch.int32, device=dev)
    state = torch.empty(lib.rf_radix_sort_state_ints(), dtype=torch.int32,
                        device=dev)
    m = len(words)
    ins = (ctypes.c_void_p * m)(*[w.data_ptr() for w in words])
    ous = (ctypes.c_void_p * m)(*[o.data_ptr() for o in outs])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.rf_radix_sort_i32(
            ctypes.cast(ins, ctypes.c_void_p),
            ctypes.cast(ous, ctypes.c_void_p), m, n_keys, n,
            *[s.data_ptr() for s in scratch], counts.data_ptr(),
            state.data_ptr(), stream)
    if rc != 0:
        raise DeviceError(f"radix sort launch failed: cudaError {rc}")
    return outs


def sort_i32_plain(words, n_keys=1):
    """Plain PyTorch version: stable sorts from the last key word to
    the first, then one index_select of every word."""
    n = words[0].shape[0]
    perm = torch.arange(n, device=words[0].device)
    for w in reversed(words[:n_keys]):
        idx = torch.sort(w.index_select(0, perm), stable=True).indices
        perm = perm.index_select(0, idx)
    return [w.index_select(0, perm) for w in words]


def sort_i32_cuda(words, n_keys=1):
    """The CUDA radix sort on int32 CUDA tensors of one length. Any
    failure to build, load, allocate or launch raises DeviceError."""
    lib = _radix_lib()
    n = int(words[0].shape[0])
    if n >= (1 << 31) - 1:
        raise DeviceError(f"radix sort: {n} rows exceed int32 row ids")
    if n == 0:
        return [torch.empty_like(w) for w in words]
    try:
        outs = _launch(lib, words, n_keys, n)
    except DeviceError:
        raise
    except Exception as e:
        raise DeviceError(f"radix sort: {type(e).__name__}: {e}") from e
    LAUNCHES["radix_sort"] += 1
    return outs


def sort_i32(ops, n_keys=1):
    """Sort M parallel 1-D tensors of one length by their first n_keys
    words (each taken as int32; signed lexicographic, ascending, stable).
    Returns the sorted int32 words at the input length."""
    if not 1 <= n_keys <= len(ops):
        raise ValueError(f"n_keys={n_keys} with {len(ops)} words")
    words = [x.to(torch.int32).contiguous() for x in ops]
    dev = words[0].device
    if any(w.device != dev or w.shape != words[0].shape for w in words):
        raise ValueError("sort_i32: words differ in device or shape")
    if dev.type == "cuda":
        return sort_i32_cuda(words, n_keys)
    if dev.type == "cpu":
        return sort_i32_plain(words, n_keys)
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


def sort_mixed(key, ops, stable_iota=False):
    """The engine's `sort([key] + ops)` call shape: one i32/i64 key with
    carried i32/i64/f64 (or narrower) payload operands. Returns
    (sorted_key, sorted_ops)."""
    n = int(key.shape[0])
    words = []
    if key.dtype == torch.int64:
        words += list(split64(key))
    else:
        words.append(key.to(torch.int32))
    n_keys = len(words)
    if stable_iota:
        words.append(torch.arange(n, dtype=torch.int32, device=key.device))
        n_keys += 1
    recipes = []          # (kind, first word index) per payload operand
    for x in ops:
        if x.dtype in (torch.int64, torch.float64):
            bits = x.contiguous().view(torch.int64) \
                if x.dtype == torch.float64 else x
            recipes.append(("w2", len(words)))
            words += list(split64(bits))
        else:
            recipes.append(("w1", len(words)))
            words.append(x.to(torch.int32))
    out = sort_i32(words, n_keys=n_keys)
    if key.dtype == torch.int64:
        skey = join64(out[0], out[1])
    else:
        skey = out[0].to(key.dtype)
    souts = []
    for (kind, i), x in zip(recipes, ops):
        if kind == "w2":
            v = join64(out[i], out[i + 1])
            souts.append(v.view(torch.float64)
                         if x.dtype == torch.float64 else v)
        else:
            souts.append(out[i].to(x.dtype))
    return skey, souts
