#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each reported on its own line:

1. card      the GPU's name and power limit (nvidia-smi);
2. build     build (or load) every CUDA kernel of the port from the
             sources in this checkout;
3. kernels   each kernel against its plain PyTorch version on the card:
             the radix sort (engine/psort.py) for n in {977, 2^20+3,
             1e7}, 1-3 key words, random / heavily tied / INT32_MAX
             keys, and sort_mixed with an i64 key carrying f64 + i64
             payloads. Every word must be equal (the sort is stable).
             Then the kernel's, the plain version's and torch.sort +
             gather's times at the main path's shape;
4. main path the db-benchmark G1_1e7_1e2 table (1e7 rows, K=100) made
             on the card from a seeded torch.Generator, and the grouped
             selects that run the sort-agg engine (bench q2, q3, q5,
             q6, a first/last query and a where query) through
             Runtime().eval_str. Each must run the sort-agg engine,
             launch the CUDA sort and never fall back to the host; each
             result must equal the port's host path on the same table
             (keys, order, counts and integer lanes exactly, f64 lanes
             within rtol 1e-9: the summation order differs). Then each
             query's warm median exec_ms over 3 runs;
5. report    one JSON line with every kernel's numbers, then the result
             line {"ok": true, "device": {...}}.

Any failure raises and exits non-zero before the result line. Without a
CUDA device, or without the rest of the repository beside it, it exits
non-zero and prints no result.
"""
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet

ROWS = 10_000_000
SORT_SIZES = (977, (1 << 20) + 3, ROWS)

QUERIES = {
    "q2": "(select {s: (sum v1) from: t by: {id1: id1 id2: id2}})",
    "q3": "(select {s: (sum v1) a: (avg v3) from: t by: id3})",
    "q5": "(select {s1: (sum v1) s2: (sum v2) s3: (sum v3) from: t "
          "by: id6})",
    "q6": "(select {mx: (max v1) mn: (min v2) from: t by: id3})",
    "first_last": "(select {f: (first v3) l: (last v1) from: t by: id3})",
    "where": "(select {s: (sum v1) a: (avg v3) from: t by: id3 "
             "where: (> v3 50.0)})",
}


def phase(tag, **kw):
    print(f"[{tag}] " + " ".join(f"{k}={v}" for k, v in kw.items()),
          flush=True)


def card_line():
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps=11, warm=2):
    """Median device time of fn over reps runs, by CUDA events."""
    import torch
    for _ in range(warm):
        fn()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    torch.cuda.synchronize()
    for e0, e1 in events:
        e0.record()
        fn()
        e1.record()
    torch.cuda.synchronize()
    return statistics.median(e0.elapsed_time(e1) for e0, e1 in events)


def max_abs_err(got, want):
    err = 0
    for g, w in zip(got, want):
        if g.shape != w.shape:
            raise AssertionError(f"shape {tuple(g.shape)} != "
                                 f"{tuple(w.shape)}")
        if g.numel():
            err = max(err, int((g.long() - w.long()).abs().max()))
    return err


def check_sort(psort, torch, gen):
    """The CUDA sort against its plain version; returns the largest
    difference seen (must be 0)."""
    worst = 0
    dev = torch.device("cuda")
    for n in SORT_SIZES:
        for n_keys in (1, 2, 3):
            for kind in ("random", "ties", "int32_max"):
                if kind == "random":
                    keys = [torch.randint(-2**31, 2**31 - 1, (n,),
                                          generator=gen, device=dev,
                                          dtype=torch.int32)
                            for _ in range(n_keys)]
                elif kind == "ties":
                    keys = [torch.randint(0, 7, (n,), generator=gen,
                                          device=dev, dtype=torch.int32)
                            for _ in range(n_keys)]
                else:
                    keys = [torch.full((n,), 2**31 - 1, device=dev,
                                       dtype=torch.int32)
                            for _ in range(n_keys)]
                    keys[-1][::3] = -2**31
                words = keys + [torch.arange(n, device=dev,
                                             dtype=torch.int32)]
                got = psort.sort_i32_cuda(words, n_keys)
                want = psort.sort_i32_plain(words, n_keys)
                torch.cuda.synchronize()
                err = max_abs_err(got, want)
                if err:
                    raise AssertionError(f"radix sort differs: n={n} "
                                         f"n_keys={n_keys} {kind}")
                worst = max(worst, err)
        # sort_mixed: i64 key, f64 + i64 payloads, stable iota
        key = torch.randint(-2**62, 2**62, (n,), generator=gen, device=dev,
                            dtype=torch.int64)
        key[::5] = key[0]
        f = torch.rand(n, generator=gen, device=dev, dtype=torch.float64)
        g = torch.randint(-2**62, 2**62, (n,), generator=gen, device=dev,
                          dtype=torch.int64)
        before = psort.LAUNCHES["radix_sort"]
        sk, (sf, sg) = psort.sort_mixed(key, [f, g], stable_iota=True)
        if psort.LAUNCHES["radix_sort"] != before + 1:
            raise AssertionError("sort_mixed on the card did not launch "
                                 "the CUDA sort")
        pk, (pf, pg) = psort.sort_mixed(key.cpu(), [f.cpu(), g.cpu()],
                                        stable_iota=True)
        err = max_abs_err([sk.cpu(), sf.cpu().view(torch.int64), sg.cpu()],
                          [pk, pf.view(torch.int64), pg])
        if err:
            raise AssertionError(f"sort_mixed differs at n={n}")
    return worst


def time_sort(psort, torch, gen, n_words):
    """(kernel ms, plain ms, torch.sort + gather ms, bound ms) for one
    key word and n_words - 1 payload words at ROWS rows."""
    dev = torch.device("cuda")
    words = [torch.randint(0, 100_000, (ROWS,), generator=gen, device=dev,
                           dtype=torch.int32)]
    words += [torch.randint(-2**31, 2**31 - 1, (ROWS,), generator=gen,
                            device=dev, dtype=torch.int32)
              for _ in range(n_words - 1)]

    def library():
        idx = torch.sort(words[0], stable=True).indices
        return [w.index_select(0, idx) for w in words[1:]]

    ms = [cuda_ms(lambda: psort.sort_i32_cuda(words, 1)),
          cuda_ms(lambda: psort.sort_i32_plain(words, 1)),
          cuda_ms(library)]
    bound = 2 * ROWS * n_words * 4 / HBM_BYTES_PER_S * 1e3
    return ms + [bound]


def main_path(rows, device):
    """Drive the grouped selects through the port's Runtime on a G1 table
    and hold each against the host path. Returns (launches of the main
    path's run, launches per query, warm median exec_ms per query)."""
    import torch
    from rayforce_tpu_torch import Runtime
    from rayforce_tpu_torch.core import symbols
    from rayforce_tpu_torch.engine import device as dev
    from rayforce_tpu_torch.engine import psort
    from rayforce_tpu_torch.engine import select as sel
    from rayforce_tpu_torch.tools.g1 import g1_table

    t0 = time.perf_counter()
    rt = Runtime()
    rt.interp.globals[symbols.intern("t")] = g1_table(rows, device)
    phase("table", rows=rows, seconds=round(time.perf_counter() - t0, 3))

    def no_fallback(e):
        raise AssertionError(f"device path fell back to the host: {e!r}")
    sel.warn_fallback = no_fallback

    per_query = {}
    results = {}
    psort.LAUNCHES["radix_sort"] = 0
    for name, q in QUERIES.items():
        before = psort.LAUNCHES["radix_sort"]
        sel.last_profile.clear()
        results[name] = rt.eval_str(q)
        if sel.last_profile.get("engine") != "sortagg":
            raise AssertionError(f"{name}: engine {sel.last_profile}")
        per_query[name] = psort.LAUNCHES["radix_sort"] - before
        if per_query[name] <= 0:
            raise AssertionError(f"{name}: the CUDA sort never launched")
    if device == "cuda":
        torch.cuda.synchronize()
    launches = psort.LAUNCHES["radix_sort"]

    dev.set_enabled(False)
    try:
        for name, q in QUERIES.items():
            groups = same_table(results[name], rt.eval_str(q), name)
            phase("match_host", query=name, groups=groups,
                  launches=per_query[name])
    finally:
        dev.set_enabled(True)

    exec_ms = {}
    for name, q in QUERIES.items():
        runs = []
        for _ in range(3):
            rt.eval_str(q)
            runs.append(sel.last_profile["exec_ms"])
        exec_ms[name] = statistics.median(runs)
        phase("exec_ms", query=name, median_ms=exec_ms[name], runs=runs)
    return launches, per_query, exec_ms


def same_table(got, want, name):
    """Port device result == port host result: names, keys, group order,
    integer lanes exactly; f64 lanes within rtol 1e-9."""
    import numpy as np
    from rayforce_tpu_torch.core import types as T
    from rayforce_tpu_torch.core.obj import to_np
    gn, gc = got.v
    wn, wc = want.v
    if not np.array_equal(to_np(gn), to_np(wn)):
        raise AssertionError(f"{name}: column names differ")
    for i, (g, w) in enumerate(zip(gc, wc)):
        if g.t != w.t:
            raise AssertionError(f"{name}: column {i} type {g.t} != {w.t}")
        a, b = to_np(g), to_np(w)
        if a.shape != b.shape:
            raise AssertionError(f"{name}: column {i} shape {a.shape} != "
                                 f"{b.shape}")
        if g.t == T.F64:
            if not np.all(np.isfinite(a)):
                raise AssertionError(f"{name}: column {i} not finite")
            np.testing.assert_allclose(a, b, rtol=1e-9, atol=0,
                                       err_msg=f"{name}: column {i}")
        elif not np.array_equal(a, b):
            raise AssertionError(f"{name}: column {i} differs")
    return len(gc[0])


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(HERE, "rayforce_tpu_torch")):
        print("chip_smoke: rayforce_tpu_torch is not beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from rayforce_tpu_torch.engine import cubuild, psort
    from rayforce_tpu_torch.engine import device as dev

    # 1. card
    card = card_line()
    phase("card", name=torch.cuda.get_device_name(0),
          count=torch.cuda.device_count())
    print(card, flush=True)
    dev.set_device("cuda")

    # 2. build
    t0 = time.perf_counter()
    psort._radix_lib()
    phase("build", kernels="radix_sort",
          seconds=round(time.perf_counter() - t0, 3),
          nvcc_seconds=cubuild.build_seconds)

    # 3. kernels against their plain versions
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    err = check_sort(psort, torch, gen)
    phase("kernels", radix_sort="equal", sizes=list(SORT_SIZES),
          max_abs_err=err)
    times = {w: time_sort(psort, torch, gen, w) for w in (2, 3)}
    for w, (ms, plain, lib, bound) in times.items():
        phase("sort_time", rows=ROWS, words=w, ms=ms, plain_ms=plain,
              torch_sort_gather_ms=lib, bound_ms=bound)

    # 4. the main path at full size
    main_launches, _per_query, _exec_ms = main_path(ROWS, "cuda")

    # 5. report
    ms, plain, lib, bound = times[2]
    kernels = [{
        "name": "radix_sort",
        "route": "cuda",
        "source": "rayforce_tpu_torch/engine/csrc/radix_sort.cu",
        "replaces": "rayforce_tpu/engine/psort.py:251 (_block_kernel), "
                    "rayforce_tpu/engine/psort.py:284 "
                    "(_window_pass_kernel)",
        "launches": main_launches,
        "max_abs_err": err,
        "ms": ms,
        "plain_ms": plain,
        "bound_ms": bound,
        "bound_by": "bytes",
        "library_ms": lib,
    }]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
