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
             payloads; the wide engine's shapes, 4 and 6 key words
             (random, tied, signed-i32 extremes) carrying f64 + i64
             payloads; the med shape, an i32 code word then an i64 key
             (or an f64 key as order-preserving bits). Every word must
             be equal (the sort is stable). Then the kernel's, the plain
             version's and torch.sort + gather's times at the sort-agg
             path's shape, and the kernel's and the plain version's at
             the wide key sort's (q7's key words on the G1 table), with
             the passes the kernel skipped;
4. main path the db-benchmark G1_1e7_1e2 table (1e7 rows, K=100) made
             on the card from a seeded torch.Generator, and the grouped
             selects of every engine through Runtime().eval_str: bench
             q1 and q4, a med, a no-by and a where + first/last select
             on the dense plan (<= 512 codes); q2, q3, q5, q6, a
             first/last and a where query on sort-agg; q7 on the wide
             engine. Each must run its engine, launch the CUDA sort and
             never fall back to the host; each result must equal the
             port's host path on the same table (keys, order, counts and
             integer lanes exactly, f64 lanes within rtol 1e-9: the
             summation order differs) and the next card run bit for
             bit. Then each query's warm median exec_ms over 3 runs;
5. entry     the flagship step (rayforce_tpu_torch/entry.py) on the card
             against the same step on the CPU;
6. report    one JSON line with every kernel's numbers, then the result
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


def _key_words(torch, gen, dev, n, n_keys, kind):
    if kind == "random":
        return [torch.randint(-2**31, 2**31 - 1, (n,), generator=gen,
                              device=dev, dtype=torch.int32)
                for _ in range(n_keys)]
    if kind == "ties":
        return [torch.randint(0, 7, (n,), generator=gen, device=dev,
                              dtype=torch.int32) for _ in range(n_keys)]
    if kind == "int32_max":
        keys = [torch.full((n,), 2**31 - 1, device=dev, dtype=torch.int32)
                for _ in range(n_keys)]
        keys[-1][::3] = -2**31
        return keys
    # signed-i32 extremes: every word drawn from {INT32_MIN, -1, 0, MAX}
    ext = torch.tensor([-2**31, -1, 0, 2**31 - 1], device=dev,
                       dtype=torch.int32)
    return [ext[torch.randint(0, 4, (n,), generator=gen, device=dev)]
            for _ in range(n_keys)]


def _check_words(psort, torch, words, n_keys, what):
    got = psort.sort_i32_cuda(words, n_keys)
    want = psort.sort_i32_plain(words, n_keys)
    torch.cuda.synchronize()
    err = max_abs_err(got, want)
    if err:
        raise AssertionError(f"radix sort differs: {what}")
    return err


def check_sort(psort, torch, gen):
    """The CUDA sort against its plain version; returns the largest
    difference seen (must be 0) and the number of cases."""
    worst, cases = 0, 0
    dev = torch.device("cuda")
    for n in SORT_SIZES:
        iota = torch.arange(n, device=dev, dtype=torch.int32)
        for n_keys in (1, 2, 3):
            for kind in ("random", "ties", "int32_max"):
                keys = _key_words(torch, gen, dev, n, n_keys, kind)
                worst = max(worst, _check_words(
                    psort, torch, keys + [iota], n_keys,
                    f"n={n} n_keys={n_keys} {kind}"))
                cases += 1
        # the wide engine's shapes: 4 and 6 key words (two and three i64
        # key words) carrying an f64 and an i64 payload
        f = torch.rand(n, generator=gen, device=dev, dtype=torch.float64)
        g = torch.randint(-2**62, 2**62, (n,), generator=gen, device=dev,
                          dtype=torch.int64)
        pay = list(psort.split64(f.view(torch.int64))) + \
            list(psort.split64(g))
        for n_keys in (4, 6):
            for kind in ("random", "ties", "extremes"):
                keys = _key_words(torch, gen, dev, n, n_keys, kind)
                worst = max(worst, _check_words(
                    psort, torch, keys + pay, n_keys,
                    f"n={n} n_keys={n_keys} {kind} (wide)"))
                cases += 1
        # the med shape: i32 code word, then an i64 key or an f64 key as
        # order-preserving bits (3 key words), row ids carried
        codes = torch.randint(0, 513, (n,), generator=gen, device=dev,
                              dtype=torch.int32)
        ik = torch.randint(-2**63, 2**63 - 1, (n,), generator=gen,
                           device=dev, dtype=torch.int64)
        ik[::5] = 2**63 - 1
        fk = (torch.rand(n, generator=gen, device=dev,
                         dtype=torch.float64) - 0.5) * 1e6
        fk[::7] = 0.0
        fk[1::7] = -0.0
        fk[2::11] = float("inf")
        fk[3::11] = float("-inf")
        for name, key in (("i64", ik), ("f64", psort.f64_order(fk))):
            words = [codes] + list(psort.split64(key)) + [iota]
            worst = max(worst, _check_words(
                psort, torch, words, 3, f"n={n} med {name} key"))
            cases += 1
        # sort_mixed: i64 key, f64 + i64 payloads, stable iota
        key = torch.randint(-2**62, 2**62, (n,), generator=gen, device=dev,
                            dtype=torch.int64)
        key[::5] = key[0]
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
        cases += 1
    return worst, cases


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


def time_wide_sort(psort, torch, gen):
    """The wide engine's key sort of q7 at ROWS rows: the two i64 key
    words that engine/wide.py packs from G1's six keys (id1, id2, id3,
    id4, id5 in word 0; id6 and the row position in word 1), as 4 i32
    key words, plus one payload word (v3 as its q32 operand). Returns
    (kernel ms, plain ms, bound ms, skipped pass flags)."""
    dev = torch.device("cuda")

    def ids(hi):
        return torch.randint(0, hi, (ROWS,), generator=gen, device=dev,
                             dtype=torch.int64)
    w0 = (ids(100) << 38) | (ids(100) << 31) | (ids(100_000) << 14) | \
        (ids(100) << 7) | ids(100)
    w1 = (ids(100_000) << 24) | torch.arange(ROWS, device=dev)
    words = list(psort.split64(w0)) + list(psort.split64(w1)) + \
        [torch.randint(0, 100_000_000, (ROWS,), generator=gen, device=dev,
                       dtype=torch.int32)]
    skipped = []
    psort.sort_i32_cuda(words, 4, skipped=skipped)
    ms = cuda_ms(lambda: psort.sort_i32_cuda(words, 4))
    plain = cuda_ms(lambda: psort.sort_i32_plain(words, 4))
    bound = 2 * ROWS * len(words) * 4 / HBM_BYTES_PER_S * 1e3
    return ms, plain, bound, skipped


def _engine(sel, before):
    """The engine that answered the last query: wide and sort-agg name
    themselves in last_profile; the dense plan is a select._Plan in the
    plan cache (and its profile has dispatch_ms)."""
    prof = sel.last_profile
    if "engine" in prof:
        return prof["engine"]
    new = [p for k, (p, _src) in sel._plan_cache.items() if k not in before]
    if len(new) == 1 and isinstance(new[0], sel._Plan) and \
            "dispatch_ms" in prof:
        return "dense"
    return f"none ({new}, {prof})"


def main_path(rows, device):
    """Drive the grouped selects through the port's Runtime on a G1 table
    and hold each against the host path and against a second card run.
    Returns (launches of the main path's run, launches per query, warm
    median exec_ms per query)."""
    import torch
    from rayforce_tpu_torch import Runtime
    from rayforce_tpu_torch.core import symbols
    from rayforce_tpu_torch.engine import device as dev
    from rayforce_tpu_torch.engine import psort
    from rayforce_tpu_torch.engine import select as sel
    from rayforce_tpu_torch.tools.g1 import QUERIES, g1_table

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
    for name, (q, engine) in QUERIES.items():
        before = psort.LAUNCHES["radix_sort"]
        cached = set(sel._plan_cache)
        sel.last_profile.clear()
        results[name] = rt.eval_str(q)
        got = _engine(sel, cached)
        if got != engine:
            raise AssertionError(f"{name}: engine {got}, not {engine}")
        per_query[name] = psort.LAUNCHES["radix_sort"] - before
        if per_query[name] <= 0:
            raise AssertionError(f"{name}: the CUDA sort never launched")
    if device == "cuda":
        torch.cuda.synchronize()
    launches = psort.LAUNCHES["radix_sort"]

    dev.set_enabled(False)
    try:
        for name, (q, engine) in QUERIES.items():
            t0 = time.perf_counter()
            want = rt.eval_str(q)
            host_s = time.perf_counter() - t0
            groups = same_table(results[name], want, name)
            phase("match_host", query=name, engine=engine, groups=groups,
                  launches=per_query[name], host_seconds=round(host_s, 3))
    finally:
        dev.set_enabled(True)

    exec_ms = {}
    for name, (q, engine) in QUERIES.items():
        runs = []
        for i in range(3):
            r = rt.eval_str(q)
            if i == 0:
                same_bits(results[name], r, name)
            p = sel.last_profile
            runs.append(p["exec_ms"] if "exec_ms" in p else
                        p["dispatch_ms"] + p["exec+fetch_ms"])
        exec_ms[name] = statistics.median(runs)
        phase("exec_ms", query=name, engine=engine, median_ms=exec_ms[name],
              runs=runs, bit_identical=True)
    return launches, per_query, exec_ms


def _columns(tbl, name):
    import numpy as np
    from rayforce_tpu_torch.core.obj import to_np
    names, cols = tbl.v
    return to_np(names), [(c.t, np.asarray(to_np(c))) for c in cols]


def same_table(got, want, name):
    """Port device result == port host result: names, keys, group order,
    integer lanes exactly; f64 lanes within rtol 1e-9."""
    import numpy as np
    from rayforce_tpu_torch.core import types as T
    gn, gc = _columns(got, name)
    wn, wc = _columns(want, name)
    if not np.array_equal(gn, wn):
        raise AssertionError(f"{name}: column names differ")
    for i, ((gt, a), (wt, b)) in enumerate(zip(gc, wc)):
        if gt != wt:
            raise AssertionError(f"{name}: column {i} type {gt} != {wt}")
        if a.shape != b.shape:
            raise AssertionError(f"{name}: column {i} shape {a.shape} != "
                                 f"{b.shape}")
        if gt == T.F64:
            if not np.all(np.isfinite(a)):
                raise AssertionError(f"{name}: column {i} not finite")
            np.testing.assert_allclose(a, b, rtol=1e-9, atol=0,
                                       err_msg=f"{name}: column {i}")
        elif not np.array_equal(a, b):
            raise AssertionError(f"{name}: column {i} differs")
    return len(gc[0][1])


def same_bits(got, want, name):
    """Two card runs of one query: every column equal bit for bit."""
    import numpy as np
    gn, gc = _columns(got, name)
    wn, wc = _columns(want, name)
    if not np.array_equal(gn, wn) or len(gc) != len(wc):
        raise AssertionError(f"{name}: card runs differ in columns")
    for i, ((gt, a), (wt, b)) in enumerate(zip(gc, wc)):
        if gt != wt or a.dtype != b.dtype or a.shape != b.shape or \
                a.tobytes() != b.tobytes():
            raise AssertionError(f"{name}: card runs differ in column {i}")


def check_entry(torch):
    """The flagship step on the card against the same step on the CPU:
    integer lanes exactly, f64 lanes within rtol 1e-9."""
    from rayforce_tpu_torch.entry import entry
    step, args = entry()
    if any(a.device.type != "cuda" for a in args):
        raise AssertionError("entry() did not put its arguments on the card")
    got = [x.cpu() for x in step(*args)]
    want = step(*[a.cpu() for a in args])
    for i, (g, w) in enumerate(zip(got, want)):
        if g.dtype != w.dtype or g.shape != w.shape:
            raise AssertionError(f"entry lane {i}: {g.dtype} {g.shape} "
                                 f"!= {w.dtype} {w.shape}")
        if g.dtype == torch.float64:
            torch.testing.assert_close(g, w, rtol=1e-9, atol=0)
        elif not torch.equal(g, w):
            raise AssertionError(f"entry lane {i} differs")
    return len(got)


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
    err, cases = check_sort(psort, torch, gen)
    phase("kernels", radix_sort="equal", sizes=list(SORT_SIZES),
          cases=cases, max_abs_err=err)
    times = {w: time_sort(psort, torch, gen, w) for w in (2, 3)}
    for w, (ms, plain, lib, bound) in times.items():
        phase("sort_time", rows=ROWS, words=w, ms=ms, plain_ms=plain,
              torch_sort_gather_ms=lib, bound_ms=bound)
    wms, wplain, wbound, skipped = time_wide_sort(psort, torch, gen)
    phase("sort_time", shape="wide_q7", rows=ROWS, key_words=4, words=5,
          ms=wms, plain_ms=wplain, library_ms="none", bound_ms=wbound,
          skipped_passes=sum(skipped), skip_flags=skipped)

    # 4. the main path at full size
    main_launches, per_query, _exec_ms = main_path(ROWS, "cuda")
    phase("main_path", launches=main_launches,
          per_query=json.dumps(per_query, separators=(",", ":")))

    # 5. the flagship step
    lanes = check_entry(torch)
    phase("entry", lanes=lanes, card_equals_cpu=True)

    # 6. report
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
