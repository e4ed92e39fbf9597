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
5. joins     bench.py's join tables made on the card (tools/jtables.py:
             the G1 table, a 1e6-row right table, 1e7 trades and 2e7
             quotes), and the joins and table sorts through
             Runtime().eval_str: ij and lj (1e7 x 1e6 rows), aj (1e7 x
             2e7), xasc t [id3 v1] and xdesc t 'v3 (1e7 rows). Each must
             run its engine (device-sortmerge, device-sort), launch the
             CUDA sort and never fall back to the host; every column,
             each lazy one forced, must equal the port's host path
             exactly (a right-only LIST column as its values and match
             mask), the match ids of ij, lj and aj must equal the host
             path's, and the next card run must be bit for bit the same.
             One [join_ms] line per query: the warm median of 3 wall runs
             with every lazy column forced and the card synchronised, the
             sort launches, the host path's seconds, and the peak device
             memory at aj. Then one [sort_time] line per sort shape of
             these queries, on the words the query gave the sort: kernel,
             plain and library (torch.sort(stable=True) of the one-value
             key) ms, the byte bound and the passes skipped;
6. wjoin     on the same tables, the window joins through
             Runtime().eval_str (tools/jtables.py WJOIN_QUERIES): wj,
             bench.py's window-join1 of 1e7 trades against 2e7 quotes
             (max and min of p over +-1000), and wj0, a window-join over
             +-1e7 (about 12 quotes a window) with every aggregate over
             the nullable columns of `quotesn`. Each must run
             device-wjoin, launch the CUDA sort and never fall back;
             every forced column must equal the port's host path (count,
             first, last, min and max exactly; sum, avg and dev within a
             tolerance sized to the prefix sums, each lane's max_abs_err
             printed) and the next card run bit for bit. One [join_ms]
             line per query (wj0 with base_mb and peak_mb) and one
             [sort_time] line per sort shape of these queries;
7. parted    the G1 table at 1e7 rows written as 10 date partitions of
             1e6 rows (storage/parted.py) into a temporary directory,
             opened with get_parted, and six grouped selects over it
             (q1, q3, q5, q6, dev v3 by id4, q3 with a where): first
             streaming partition by partition (ops/query.py
             STREAM_PARTED = True; every partition must run on the
             device and launch the sort), then razed into one device
             table (STREAM_PARTED = None: 720 MB is under the razing
             guard). Each must equal the port's host path over the
             parted table (keys and integer lanes exactly, f64 within
             rtol 1e-9). One [parted_ms] line per query and mode: the
             warm median of 3 wall runs;
8. entry     the flagship step (rayforce_tpu_torch/entry.py) on the card
             against the same step on the CPU;
9. report    one JSON line with every kernel's numbers (the radix sort's
             launches count the main path's, the joins', the window
             joins' and the parted selects' runs), then the result line
             {"ok": true, "device": {...}}.

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


def _join_parts(q):
    """(head, key names, left table, right table) of `(head [keys] l r)`."""
    keys = q[q.index("[") + 1:q.index("]")].split()
    left, right = q[q.index("]") + 1:-1].split()
    return q[1:].split()[0], keys, left, right


def _host_lanes(rt, q, tables):
    """The port's host path on the same tables, as (column names, numpy
    lanes). A left or asof join's right-only column with unmatched rows
    becomes a LIST of boxed atoms there, which at 1e7 rows costs minutes
    and gigabytes: for those joins the lanes come from the host path's
    own match (`left_join_ids`, `asof_ids`) and gathers, the right-only
    column as (values, match mask) with the values gathered at row 0
    where unmatched, as the device gathers them."""
    import numpy as np
    from rayforce_tpu_torch.core import symbols
    from rayforce_tpu_torch.core import types as T
    from rayforce_tpu_torch.core.obj import col_by_name, to_np, vec_sym
    from rayforce_tpu_torch.engine import device as dev
    from rayforce_tpu_torch.ops import join as oj
    from rayforce_tpu_torch.ops.items import ray_except, ray_union
    dev.set_enabled(False)
    try:
        if not q.startswith(("(left-join", "(asof-join")):
            res = rt.eval_str(q)
            return list(to_np(res.v[0])), [(to_np(c),) for c in res.v[1]]
        head, keys, left, right = _join_parts(q)
        lt, rt_ = tables[left], tables[right]
        lk = [col_by_name(lt, k) for k in keys]
        rk = [col_by_name(rt_, k) for k in keys]
        rids = oj.asof_ids(lk, rk) if head == "asof-join" else \
            oj.left_join_ids(lk, rk)
        has = rids != T.NULL_I64
        safe = np.where(has, rids, 0)
        key_syms = vec_sym(keys)
        rest = to_np(ray_except(ray_union(lt.v[0], rt_.v[0]), key_syms))
        lanes = [(to_np(c),) for c in lk]
        for sid in rest:
            nm = symbols.name_of(int(sid))
            c1, c2 = col_by_name(lt, nm), col_by_name(rt_, nm)
            if c2 is None:
                lanes.append((to_np(c1),))
            elif c1 is None:
                g = to_np(c2)[safe]
                lanes.append((g,) if has.all() else (g, has))
            else:
                lanes.append((np.where(has, to_np(c2)[safe], to_np(c1)),))
        return list(to_np(key_syms)) + list(rest), lanes
    finally:
        dev.set_enabled(True)


def join_path(rows, device):
    """Drive the joins and table sorts (tools/jtables.py JOIN_QUERIES)
    through the port's Runtime on bench.py's join tables and hold each
    against the host path and against a second card run. Returns
    (launches of the run, launches per query, the sort calls of each
    query as (words, n_keys, perm), the Runtime, the tables)."""
    import numpy as np
    import torch
    from rayforce_tpu_torch import Runtime
    from rayforce_tpu_torch.core import symbols
    from rayforce_tpu_torch.core.obj import col_by_name, to_np
    from rayforce_tpu_torch.engine import join as ej
    from rayforce_tpu_torch.engine import psort
    from rayforce_tpu_torch.engine import select as sel
    from rayforce_tpu_torch.engine import sort as es
    from rayforce_tpu_torch.ops import join as oj
    from rayforce_tpu_torch.tools.jtables import JOIN_QUERIES, \
        force_columns, join_tables

    t0 = time.perf_counter()
    rt = Runtime()
    tables = join_tables(rows, device)
    for name, tbl in tables.items():
        rt.interp.globals[symbols.intern(name)] = tbl
    phase("join_tables", seconds=round(time.perf_counter() - t0, 3),
          rows=json.dumps({k: len(v) for k, v in tables.items()},
                          separators=(",", ":")))

    def no_fallback(e):
        raise AssertionError(f"device path fell back to the host: {e!r}")
    sel.warn_fallback = no_fallback

    def run(q):
        out = rt.eval_str(q)
        lanes = force_columns(out)
        torch.cuda.synchronize()
        return out, lanes

    per_query, results, calls = {}, {}, {}
    real = psort.sort_i32_cuda

    def recording(words, n_keys=1, skipped=None, perm=False):
        calls[current].append((list(words), n_keys, perm))
        return real(words, n_keys, skipped, perm)

    psort.sort_i32_cuda = recording
    psort.LAUNCHES["radix_sort"] = 0
    try:
        for current, (q, engine) in JOIN_QUERIES.items():
            calls[current] = []
            before = psort.LAUNCHES["radix_sort"]
            ej.last_profile.clear()
            es.last_profile.clear()
            if current == "aj":
                base_mb = torch.cuda.memory_allocated() / 2**20
                torch.cuda.reset_peak_memory_stats()
            results[current] = run(q)
            if current == "aj":
                peak_mb = torch.cuda.max_memory_allocated() / 2**20
            got = (ej.last_profile or es.last_profile).get("engine")
            if got != engine:
                raise AssertionError(f"{current}: engine {got}, not {engine}")
            per_query[current] = psort.LAUNCHES["radix_sort"] - before
            if per_query[current] <= 0:
                raise AssertionError(f"{current}: the CUDA sort never "
                                     "launched")
    finally:
        psort.sort_i32_cuda = real
    launches = psort.LAUNCHES["radix_sort"]

    for name, (q, engine) in JOIN_QUERIES.items():
        out, lanes = results[name]
        t0 = time.perf_counter()
        want_names, want = _host_lanes(rt, q, tables)
        host_s = time.perf_counter() - t0
        if list(to_np(out.v[0])) != list(want_names):
            raise AssertionError(f"{name}: column names differ from host")
        if [len(x) for x in lanes] != [len(x) for x in want]:
            raise AssertionError(f"{name}: column kinds differ from host")
        for i, (g, w) in enumerate(zip(lanes, want)):
            for a, b in zip(g, w):
                a = a.cpu().numpy()
                if a.dtype != b.dtype or a.shape != b.shape or \
                        a.tobytes() != b.tobytes():
                    raise AssertionError(f"{name}: column {i} differs "
                                         "from the host path")
        if engine == "device-sortmerge":
            # the match ids themselves against the host path's match
            head, keys, left, right = _join_parts(q)
            lk = [col_by_name(tables[left], k) for k in keys]
            rk = [col_by_name(tables[right], k) for k in keys]
            if head == "asof-join":
                got = ej.match_ids_device(lk[:-1], rk[:-1], ltime=lk[-1],
                                          rtime=rk[-1], mode="asof")
                want_ids = oj.asof_ids(lk, rk)
            else:
                got = ej.match_ids_device(lk, rk)
                want_ids = oj.left_join_ids(lk, rk)
            if not np.array_equal(got.cpu().numpy(), want_ids):
                raise AssertionError(f"{name}: match ids differ from host")
        runs = []
        for i in range(4):
            t0 = time.perf_counter()
            _out, again = run(q)
            ms = (time.perf_counter() - t0) * 1e3
            if i == 0:
                for g, h in zip(lanes, again):
                    for a, b in zip(g, h):
                        if not torch.equal(a.view(torch.uint8),
                                           b.view(torch.uint8)):
                            raise AssertionError(f"{name}: card runs differ")
            else:
                runs.append(ms)
            del _out, again
        r = {"query": name, "engine": engine, "rows": len(out),
             "median_ms": statistics.median(runs), "runs": runs,
             "launches": per_query[name], "host_seconds": round(host_s, 3),
             "bit_identical": True}
        if name == "aj":
            # device memory in use before aj's run and at its peak
            r["base_mb"], r["peak_mb"] = round(base_mb, 1), round(peak_mb, 1)
        phase("join_ms", **r)
    return launches, per_query, calls, rt, tables


# the f64 lanes of the window joins, held to the host path within a
# tolerance: output column -> (aggregate, right table, right column)
WJ_F64_LANES = {"wj0": {"s": ("sum", "quotesn", "pn"),
                        "a": ("avg", "quotesn", "pn"),
                        "d": ("dev", "quotesn", "pn")}}


def _wj_tolerance(kind, x):
    """The window-join f64 lanes' tolerance against the host path. Both
    paths take boundary differences of prefix sums over the whole sorted
    right column, adding in different orders, so an error is bounded by
    the column's prefix magnitude: 2^-40 of sum |x| for sum and avg
    (an average divides by a count >= 1), and for dev 2^-40 of the
    shifted second moment sum (x - mean)^2, held on dev^2."""
    import numpy as np
    x = x[~np.isnan(x)]
    if kind == "dev":
        return float(((x - x.mean()) ** 2).sum()) * 2.0 ** -40
    return float(np.abs(x).sum()) * 2.0 ** -40


def wjoin_path(rt, tables):
    """Drive the window joins (tools/jtables.py WJOIN_QUERIES) through the
    port's Runtime on bench.py's join tables and hold each against the
    host path and a second card run. Returns (launches of the run,
    launches per query, the sort calls of each query)."""
    import numpy as np
    import torch
    from rayforce_tpu_torch.core import symbols
    from rayforce_tpu_torch.core.obj import col_by_name, to_np
    from rayforce_tpu_torch.engine import device as dev
    from rayforce_tpu_torch.engine import psort
    from rayforce_tpu_torch.engine import wjoin as ew
    from rayforce_tpu_torch.tools.jtables import WJOIN_QUERIES, \
        force_columns

    def run(q):
        out = rt.eval_str(q)
        lanes = force_columns(out)
        torch.cuda.synchronize()
        return out, lanes

    per_query, results, calls = {}, {}, {}
    real = psort.sort_i32_cuda

    def recording(words, n_keys=1, skipped=None, perm=False):
        calls[current].append((list(words), n_keys, perm))
        return real(words, n_keys, skipped, perm)

    psort.sort_i32_cuda = recording
    psort.LAUNCHES["radix_sort"] = 0
    try:
        for current, q in WJOIN_QUERIES.items():
            calls[current] = []
            before = psort.LAUNCHES["radix_sort"]
            ew.last_profile.clear()
            if current == "wj0":
                base_mb = torch.cuda.memory_allocated() / 2**20
                torch.cuda.reset_peak_memory_stats()
            results[current] = run(q)
            if current == "wj0":
                peak_mb = torch.cuda.max_memory_allocated() / 2**20
            got = ew.last_profile.get("engine")
            if got != "device-wjoin":
                raise AssertionError(f"{current}: engine {got}, not "
                                     "device-wjoin")
            per_query[current] = psort.LAUNCHES["radix_sort"] - before
            if per_query[current] <= 0:
                raise AssertionError(f"{current}: the CUDA sort never "
                                     "launched")
    finally:
        psort.sort_i32_cuda = real
    launches = psort.LAUNCHES["radix_sort"]

    for name, q in WJOIN_QUERIES.items():
        out, lanes = results[name]
        dev_names = [symbols.name_of(int(x)) for x in to_np(out.v[0])]
        t0 = time.perf_counter()
        dev.set_enabled(False)
        try:
            want = rt.eval_str(q)
            want_cols = [to_np(c) for c in want.v[1]]
        finally:
            dev.set_enabled(True)
        host_s = time.perf_counter() - t0
        if [symbols.name_of(int(x)) for x in to_np(want.v[0])] != \
                dev_names:
            raise AssertionError(f"{name}: column names differ from host")
        errs = {}
        f64 = WJ_F64_LANES.get(name, {})
        for cname, (g,), w in zip(dev_names, lanes, want_cols):
            a = g.cpu().numpy()
            if cname in f64:
                kind, tname, rcol = f64[cname]
                tol = _wj_tolerance(kind, to_np(col_by_name(tables[tname],
                                                            rcol)))
                if a.dtype != w.dtype or a.shape != w.shape or \
                        not np.array_equal(np.isnan(a), np.isnan(w)):
                    raise AssertionError(f"{name}: lane {cname} differs "
                                         "from the host path in its nulls")
                ok = ~np.isnan(a)
                if kind == "dev":
                    err = float(np.abs(a[ok] ** 2 - w[ok] ** 2).max())
                else:
                    err = float(np.abs(a[ok] - w[ok]).max())
                errs[cname] = err
                if err > tol:
                    raise AssertionError(f"{name}: lane {cname} differs "
                                         f"from the host path by {err} > "
                                         f"{tol}")
            elif a.dtype != w.dtype or a.shape != w.shape or \
                    a.tobytes() != w.tobytes():
                raise AssertionError(f"{name}: lane {cname} differs from "
                                     "the host path")
        del want, want_cols
        runs = []
        for i in range(4):
            t0 = time.perf_counter()
            _out, again = run(q)
            ms = (time.perf_counter() - t0) * 1e3
            if i == 0:
                for (a,), (b,) in zip(lanes, again):
                    if not torch.equal(a.view(torch.uint8),
                                       b.view(torch.uint8)):
                        raise AssertionError(f"{name}: card runs differ")
            else:
                runs.append(ms)
            del _out, again
        valid = int((~torch.isnan(lanes[2][0])).sum()) if name == "wj" \
            else int((lanes[2][0] > 0).sum())
        r = {"query": name, "engine": "device-wjoin", "rows": len(out),
             "median_ms": statistics.median(runs), "runs": runs,
             "launches": per_query[name], "host_seconds": round(host_s, 3),
             "bit_identical": True, "nonempty_windows": valid,
             "max_abs_err": json.dumps(errs, separators=(",", ":"))}
        if name == "wj0":
            r["base_mb"], r["peak_mb"] = round(base_mb, 1), round(peak_mb, 1)
        phase("join_ms", **r)
    return launches, per_query, calls


PARTS = 10


def parted_path(rows, device):
    """Write the G1 table as PARTS date partitions into a temporary
    directory, open it with get_parted, and run tools/g1.py
    PARTED_QUERIES over it, streaming partition by partition and razed,
    each held against the port's host path over the parted table.
    Returns (launches of the checked run of each query and mode, the
    launches per query and mode); the timed reruns are not counted."""
    import shutil
    import tempfile
    import torch
    from rayforce_tpu_torch import Runtime
    from rayforce_tpu_torch.core import symbols
    from rayforce_tpu_torch.core.obj import Obj, table, to_np
    from rayforce_tpu_torch.engine import device as dev
    from rayforce_tpu_torch.engine import psort
    from rayforce_tpu_torch.engine import select as sel
    from rayforce_tpu_torch.ops import query as Q
    from rayforce_tpu_torch.storage import parted as P
    from rayforce_tpu_torch.tools.g1 import PARTED_QUERIES, g1_table

    rt = Runtime()
    t0 = time.perf_counter()
    g1 = g1_table(rows, device)
    names, cols = g1.v
    host = [(c.t, to_np(c)) for c in cols]
    del g1, cols
    tmp = tempfile.mkdtemp(prefix="rf_parted_")
    saved = Q.STREAM_PARTED
    try:
        step = rows // PARTS
        for i in range(PARTS):
            part = table(names, [Obj(t, a[i * step:(i + 1) * step])
                                 for t, a in host])
            P.set_parted(tmp, f"2024.01.{i + 1:02d}", "t", part,
                         interp=rt.interp)
        del host, part
        pt = P.get_parted(tmp, "t", interp=rt.interp)
        rt.interp.globals[symbols.intern("pt")] = pt
        phase("parted_table", rows=len(pt), partitions=PARTS,
              seconds=round(time.perf_counter() - t0, 3))

        want, host_s = {}, {}
        dev.set_enabled(False)
        try:
            for name, q in PARTED_QUERIES.items():
                t0 = time.perf_counter()
                want[name] = rt.eval_str(q)
                _columns(want[name], name)
                host_s[name] = round(time.perf_counter() - t0, 3)
        finally:
            dev.set_enabled(True)

        def run(q):
            out = rt.eval_str(q)
            _columns(out, q)
            torch.cuda.synchronize()
            return out

        per_query = {}
        psort.LAUNCHES["radix_sort"] = 0
        for mode, flag in (("stream", True), ("razed", None)):
            Q.STREAM_PARTED = flag
            for name, q in PARTED_QUERIES.items():
                # each call of the device select (one per partition when
                # streaming, one for the razed table): whether it
                # answered, and its sort launches
                seen = []
                real = sel.try_select_device

                def watched(*a, **k):
                    before = psort.LAUNCHES["radix_sort"]
                    r = real(*a, **k)
                    seen.append((r is not None and not isinstance(r, str),
                                 psort.LAUNCHES["radix_sort"] - before))
                    return r
                before = psort.LAUNCHES["radix_sort"]
                sel.try_select_device = watched
                try:
                    got = run(q)
                finally:
                    sel.try_select_device = real
                per_query[f"{name}_{mode}"] = \
                    psort.LAUNCHES["radix_sort"] - before
                calls = PARTS if mode == "stream" else 1
                if len(seen) != calls or not all(
                        ok and n > 0 for ok, n in seen):
                    raise AssertionError(f"{name} ({mode}): device calls "
                                         f"{seen}, not {calls} that each "
                                         "launch the sort")
                groups = same_table(got, want[name], f"{name} ({mode})")
                runs = []
                for _ in range(3):
                    t0 = time.perf_counter()
                    run(q)
                    runs.append((time.perf_counter() - t0) * 1e3)
                phase("parted_ms", query=name, mode=mode, groups=groups,
                      median_ms=statistics.median(runs), runs=runs,
                      launches=per_query[f"{name}_{mode}"],
                      device_calls=len(seen), host_seconds=host_s[name])
        return sum(per_query.values()), per_query
    finally:
        Q.STREAM_PARTED = saved
        shutil.rmtree(tmp, ignore_errors=True)


def time_join_sorts(psort, torch, calls):
    """Each join and table sort's own sort, on the very words its query
    gave it: kernel, plain and library ms (CUDA events, median of 11),
    the byte bound and the passes skipped. The library call is
    torch.sort(stable=True) with indices of the key as one i32 or i64
    value (1 or 2 key words); each kernel output equals the plain
    version's."""
    out, seen = [], []
    for name, cl in calls.items():
        for words, nk, perm in cl:
            same = [r for w, r in seen if len(w) == len(words) and
                    r["key_words"] == nk and r["perm"] == perm and
                    all(torch.equal(a, b) for a, b in zip(w, words))]
            if same:             # lj sorts the words ij sorted
                same[0]["shape"] += "+" + name
                continue
            skipped = []
            got = psort.sort_i32_cuda(words, nk, skipped=skipped, perm=perm)
            want = psort.sort_i32_plain(words, nk, perm=perm)
            if perm:
                got, want = got[0] + [got[1]], want[0] + [want[1]]
            if max_abs_err(got, want):
                raise AssertionError(f"radix sort differs at {name}'s sort")
            lib = None
            if nk <= 2:
                key = words[0] if nk == 1 else \
                    psort.join64(words[0], words[1])
                lib = cuda_ms(lambda: torch.sort(key, stable=True))
            rows = int(words[0].shape[0])
            r = {"shape": name, "rows": rows, "words": len(words),
                 "key_words": nk, "perm": perm,
                 "ms": cuda_ms(lambda: psort.sort_i32_cuda(words, nk,
                                                           perm=perm)),
                 "plain_ms": cuda_ms(lambda: psort.sort_i32_plain(
                     words, nk, perm=perm)),
                 "library_ms": lib,
                 "bound_ms": (2 * len(words) + int(perm)) * rows * 4 /
                 HBM_BYTES_PER_S * 1e3,
                 "skipped_passes": sum(skipped),
                 "skip_flags": "".join(str(int(x)) for x in skipped)}
            seen.append((words, r))
            out.append(r)
    return out


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

    # 5. the joins and table sorts at the bench's sizes
    join_launches, join_per_query, calls, rt, tables = join_path(ROWS,
                                                                 "cuda")
    phase("join_path", launches=join_launches,
          per_query=json.dumps(join_per_query, separators=(",", ":")))
    for r in time_join_sorts(psort, torch, calls):
        phase("sort_time", **r)
    del calls

    # 6. the window joins on the same tables
    wj_launches, wj_per_query, calls = wjoin_path(rt, tables)
    phase("wjoin_path", launches=wj_launches,
          per_query=json.dumps(wj_per_query, separators=(",", ":")))
    for r in time_join_sorts(psort, torch, calls):
        phase("sort_time", **r)
    del calls, rt, tables
    torch.cuda.empty_cache()

    # 7. parted selects, streamed and razed
    parted_launches, parted_per_query = parted_path(ROWS, "cuda")
    phase("parted_path", launches=parted_launches,
          per_query=json.dumps(parted_per_query, separators=(",", ":")))

    # 8. the flagship step
    lanes = check_entry(torch)
    phase("entry", lanes=lanes, card_equals_cpu=True)

    # 9. report
    main = next(r for r in times if r["shape"] == "sortagg_2w")
    kernels = [{
        "name": "radix_sort",
        "route": "cuda",
        "source": "rayforce_tpu_torch/engine/csrc/radix_sort.cu",
        "replaces": "rayforce_tpu/engine/psort.py:251 (_block_kernel), "
                    "rayforce_tpu/engine/psort.py:284 "
                    "(_window_pass_kernel)",
        "launches": main_launches + join_launches + wj_launches +
        parted_launches,
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
