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
             (or an f64 key as order-preserving bits); then the cases
             that stress the one-sweep design: n from 1 through the
             one-block route's edge and tile edges to 2^24 + 5 (long
             look-back chains), a misaligned view, all keys equal (every
             pass skipped), the key-only routes, the permutation return,
             both routes for payload words, and back-to-back sorts of
             different data on one stream. Every word must be equal
             (the sort is stable). Then, at each main-path sort shape
             (1e7 x 1 key-only word, 1e7 x 1 key + 1 or 2 payload
             words, the wide q7 key sort, the med sort, the 1e5-row
             order sort with its permutation), one [sort_time] line:
             the kernel's, the plain version's and the library call's
             times (torch.sort(...).values, torch.sort + index_select,
             or none), each route's time, the byte bound and the
             passes the kernel skipped;
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
             bit. A [sort_shapes] line counts the main path's sort
             launches per (rows, key words, words). Then each query's
             warm median exec_ms over 3 runs;
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


def check_edges(psort, torch, gen):
    """The cases that stress the one-sweep design, each against the plain
    version: n from 1 through the one-block route's edge and tile edges
    to 2^24 + 5 rows (long look-back chains), a misaligned input view,
    all keys equal (every pass skipped), the key-only routes (1 and 2
    words), the permutation return, both routes (every word carried, or
    row ids carried and the rest gathered), and back-to-back sorts of
    different data on one stream.
    Returns the number of cases."""
    dev = torch.device("cuda")
    tile, small = psort._radix_lib().rf_radix_sort_tile(), \
        psort._radix_lib().rf_radix_sort_small_max()
    cases = 0

    def check(words, n_keys, what, perm=False, route=-1):
        got = psort.sort_i32_cuda(words, n_keys, perm=perm, route=route)
        want = psort.sort_i32_plain(words, n_keys, perm=perm)
        if perm:
            got = got[0] + [got[1]]
            want = want[0] + [want[1]]
        torch.cuda.synchronize()
        if max_abs_err(got, want):
            raise AssertionError(f"radix sort differs: {what}")

    sizes = (1, 2, tile - 1, tile, tile + 1, small, small + 1,
             3 * tile + 1, (1 << 24) + 5)
    for n in sizes:
        k = _key_words(torch, gen, dev, n, 1, "random")[0]
        t = _key_words(torch, gen, dev, n, 2, "ties")
        pay = torch.randint(-2**31, 2**31 - 1, (n,), generator=gen,
                            device=dev, dtype=torch.int32)
        check([k], 1, f"n={n} key-only 1 word")
        check(t, 2, f"n={n} key-only 2 words, ties")
        check([k, t[0]], 2, f"n={n} key-only 2 words, random")
        for route in (0, 1):      # carry every word / carry row ids
            check([k, pay], 1, f"n={n} 1 key + payload, route {route}",
                  route=route)
            check([t[0], pay], 1, f"n={n} permutation, route {route}",
                  perm=True, route=route)
            check(t + [pay, k], 2, f"n={n} 2 keys + 2 payload words, "
                  f"route {route}", route=route)
        cases += 9
    # a view 4 bytes past an aligned address: 16-byte loads start later
    n = 3 * tile + 7
    base = torch.randint(-2**31, 2**31 - 1, (n + 1,), generator=gen,
                         device=dev, dtype=torch.int32)
    check([base[1:]], 1, "misaligned key-only")
    check([base[1:], base[:-1]], 1, "misaligned with payload")
    # all keys equal: every pass skipped, the outputs are the inputs
    for n in (5, small + 3, 1 << 20):
        same = torch.full((n,), -7, device=dev, dtype=torch.int32)
        pay = torch.arange(n, device=dev, dtype=torch.int32)
        skipped = []
        psort.sort_i32_cuda([same, same, pay], 2, skipped=skipped)
        if skipped != [1] * 8:
            raise AssertionError(f"all-equal keys ran passes: {skipped}")
        check([same], 1, f"n={n} all keys equal, key-only")
        for route in (0, 1):
            check([same, same, pay], 2, f"n={n} all keys equal, route "
                  f"{route}", route=route)
            check([same, pay], 1, f"n={n} all keys equal, permutation, "
                  f"route {route}", perm=True, route=route)
        cases += 5
    # back to back on one stream: the second must not see the first's
    # look-back state
    n = (1 << 22) + 3
    a = _key_words(torch, gen, dev, n, 2, "random")
    b = _key_words(torch, gen, dev, n, 2, "ties")
    ga = psort.sort_i32_cuda(a, 1)
    gb = psort.sort_i32_cuda(b, 1)
    gc = psort.sort_i32_cuda(a, 2)
    torch.cuda.synchronize()
    for got, words, nk in ((ga, a, 1), (gb, b, 1), (gc, a, 2)):
        if max_abs_err(got, psort.sort_i32_plain(words, nk)):
            raise AssertionError("back-to-back sorts differ")
    return cases + 3


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


def _wide_words(psort, torch, gen, rows):
    """q7's key sort at `rows` rows: the two i64 key words that
    engine/wide.py packs from G1's six keys (id1, id2, id3, id4, id5 in
    word 0; id6 and the row position in word 1), as 4 i32 key words,
    plus one payload word (v3 as its q32 operand)."""
    dev = torch.device("cuda")

    def ids(hi):
        return torch.randint(0, hi, (rows,), generator=gen, device=dev,
                             dtype=torch.int64)
    w0 = (ids(100) << 38) | (ids(100) << 31) | (ids(100_000) << 14) | \
        (ids(100) << 7) | ids(100)
    w1 = (ids(100_000) << 24) | torch.arange(rows, device=dev)
    return list(psort.split64(w0)) + list(psort.split64(w1)) + \
        [torch.randint(0, 100_000_000, (rows,), generator=gen, device=dev,
                       dtype=torch.int32)]


def sort_shapes(psort, torch, gen):
    """The main path's sort shapes at full size: [(name, rows, words,
    n_keys, perm, library call or None)]."""
    dev = torch.device("cuda")
    rows = ROWS

    def rnd(n, lo=-2**31, hi=2**31 - 1):
        return torch.randint(lo, hi, (n,), generator=gen, device=dev,
                             dtype=torch.int32)
    key = rnd(rows, 0, 100_000)       # sort-agg's packed key: < 10^5
    p1, p2 = rnd(rows), rnd(rows)

    def sort_gather(k, pays):
        def f():
            v, idx = torch.sort(k, stable=True)
            return [v] + [x.index_select(0, idx) for x in pays]
        return f
    # med: an i32 code word (id4's 100 codes), then v3 as f64 order bits
    codes = rnd(rows, 0, 100)
    v3 = torch.rand(rows, generator=gen, device=dev,
                    dtype=torch.float64) * 100
    med = [codes] + list(psort.split64(psort.f64_order(v3)))
    # sort-agg's first-appearance order sort: 10^5 first-row ids (i64)
    fidx = torch.randperm(rows, generator=gen, device=dev)[:100_000]
    order = list(psort.split64(fidx))
    return [
        ("key_only_1w", rows, [key], 1, False,
         lambda: torch.sort(key).values),
        ("sortagg_2w", rows, [key, p1], 1, False, sort_gather(key, [p1])),
        ("sortagg_3w", rows, [key, p1, p2], 1, False,
         sort_gather(key, [p1, p2])),
        ("wide_q7", rows, _wide_words(psort, torch, gen, rows), 4, False,
         None),
        ("med", rows, med, 3, False, None),
        ("order_1e5", 100_000, order, 2, True,
         lambda: torch.sort(fidx, stable=True)),
    ]


def time_sorts(psort, torch, gen):
    """Kernel, plain and library ms (CUDA events, median of 11) and the
    byte bound at each main-path shape, with the passes the kernel
    skipped, and the kernel's time on each of its two routes where the
    shape has a payload or a permutation (carry_ms: every word carried
    through the passes; id_ms: row ids carried, the rest gathered). Each
    kernel output equals the plain version's."""
    out = []
    for name, rows, words, nk, perm, lib in sort_shapes(psort, torch, gen):
        skipped = []
        got = psort.sort_i32_cuda(words, nk, skipped=skipped, perm=perm)
        want = psort.sort_i32_plain(words, nk, perm=perm)
        if perm:
            got, want = got[0] + [got[1]], want[0] + [want[1]]
        if max_abs_err(got, want):
            raise AssertionError(f"radix sort differs at shape {name}")
        r = {"shape": name, "rows": rows, "words": len(words),
             "key_words": nk,
             "ms": cuda_ms(lambda: psort.sort_i32_cuda(words, nk,
                                                       perm=perm)),
             "plain_ms": cuda_ms(lambda: psort.sort_i32_plain(words, nk,
                                                              perm=perm)),
             "library_ms": cuda_ms(lib) if lib else None}
        if len(words) > 1 or perm:
            for key, route in (("carry_ms", 0), ("id_ms", 1)):
                got = psort.sort_i32_cuda(words, nk, perm=perm, route=route)
                if perm:
                    got = got[0] + [got[1]]
                if max_abs_err(got, want):
                    raise AssertionError(f"radix sort differs at shape "
                                         f"{name}, route {route}")
                r[key] = cuda_ms(lambda: psort.sort_i32_cuda(
                    words, nk, perm=perm, route=route))
        out_words = len(words) + (1 if perm else 0)
        r["bound_ms"] = (len(words) + out_words) * rows * 4 / \
            HBM_BYTES_PER_S * 1e3
        r["skipped_passes"] = sum(skipped)
        r["skip_flags"] = "".join(str(int(x)) for x in skipped)
        out.append(r)
    return out


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
    median exec_ms per query, calls of the sort per (rows, key words,
    words) in that run)."""
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
    shapes = {}
    real = psort.sort_i32_cuda

    def recording(words, n_keys=1, skipped=None, perm=False):
        k = (int(words[0].shape[0]), n_keys, len(words))
        shapes[k] = shapes.get(k, 0) + 1
        return real(words, n_keys, skipped, perm)

    psort.sort_i32_cuda = recording
    psort.LAUNCHES["radix_sort"] = 0
    try:
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
    finally:
        psort.sort_i32_cuda = real
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
    return launches, per_query, exec_ms, shapes


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
    cases += check_edges(psort, torch, gen)
    phase("kernels", radix_sort="equal", sizes=list(SORT_SIZES),
          cases=cases, max_abs_err=err)
    times = time_sorts(psort, torch, gen)
    for r in times:
        phase("sort_time", **r)

    # 4. the main path at full size
    main_launches, per_query, _exec_ms, shapes = main_path(ROWS, "cuda")
    phase("main_path", launches=main_launches,
          per_query=json.dumps(per_query, separators=(",", ":")))
    phase("sort_shapes", calls=json.dumps(
        [{"rows": n, "key_words": k, "words": m, "launches": c}
         for (n, k, m), c in sorted(shapes.items())],
        separators=(",", ":")))

    # 5. the flagship step
    lanes = check_entry(torch)
    phase("entry", lanes=lanes, card_equals_cpu=True)

    # 6. report
    main = next(r for r in times if r["shape"] == "sortagg_2w")
    kernels = [{
        "name": "radix_sort",
        "route": "cuda",
        "source": "rayforce_tpu_torch/engine/csrc/radix_sort.cu",
        "replaces": "rayforce_tpu/engine/psort.py:251 (_block_kernel), "
                    "rayforce_tpu/engine/psort.py:284 "
                    "(_window_pass_kernel)",
        "launches": main_launches,
        "max_abs_err": err,
        "ms": main["ms"],
        "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"],
        "bound_by": "bytes",
        "library_ms": main["library_ms"],
    }]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
