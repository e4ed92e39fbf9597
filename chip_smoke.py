#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each reported on its own line:

1. card      the GPU's name and power limit (nvidia-smi);
2. build     build (or load) every CUDA kernel of the port from the
             sources in this checkout, one nvcc for each, all started
             together: the radix sort, the segmented scan, the dense
             aggregate, the wide engine's key-word kernels, the mesh's
             stage A kernels and sort-agg's main sort word kernels;
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
             passes the kernel skipped. Then the segmented scan
             (engine/groupby.py seg_scan_cuda) against seg_scan_plain,
             bit for bit: min, max and sum; i32, i64 and f64 values;
             i32 ids and i64 ids as a strided view; one lane and three
             (a view of an (n, 4) tensor); both directions; n in
             SCAN_SIZES (1 to 3e7) over runs of 1, 3, 2500 and 3500
             rows (three blocks and more), one run and sorted ids with
             -2s out of order; NaN of either sign, +-0.0, +-inf, the
             identities and -1 among the values. One run over all 3e7
             rows is the look-back's longest chain and an f64 global
             tail; at 1e7 and 3e7 rows each case runs three times and
             must give the same bits every time. Each case's route
             (groupby.seg_scan_route) and scratch size must be the
             library's, and the cases must take all three routes
             (integer look-back, f64 shared tail, f64 global tail),
             counted on the [kernels] line. One [seg_scan_time] line per
             main-path scan shape at 1e7 rows (tools/sortprof.py
             seg_scan_shapes): kernel and plain ms, the byte bound, no
             library call, the route, and the kernel launches and
             memsets of one call (the route's, beside a profiler
             trace's). Then the dense aggregate (engine/groupby.py
             dense_agg_cuda) against dense_agg_plain, bit for bit in
             every lane: 1, 7, 100 and 512 codes plus the trash code,
             over DENSE_SIZES rows (1 to 1e7, 1.25e6 a mesh shard);
             i32 codes, i64 codes as a strided view, every row on one
             code and a stride-0 view of one; an i32 limb lane, an i64
             lane whose sums wrap, f64 sums with +-0.0, +-inf (inf -
             inf in a cell) and magnitudes from 1e-300 to 1e300, i64
             extrema with KEY_MAX and I64_MIN, f64 extrema with NaN of
             either sign, +-0.0 and +-inf, an i32 min; counts and then
             first/last row ids left out; every lane as a strided and
             as a misaligned view; at 1e7 rows three runs a case, equal
             every time; then tools/denseparts.py's three synthetic
             shapes at 1e7 rows (half the rows on a trash code, 7
             codes, 512 codes), three equal runs each, and a
             [dense_time] line for each. Then the wide engine's key-word
             kernels (engine/wide.py wide_keys_cuda) against
             wide_keys_plain on the inputs copied to the CPU, bit for
             bit, at each of SORT_SIZES rows on q7's plan (G1's six
             keys) and on a three-word plan with a where mask (i64
             with a negative least value, i32 over its whole range, u8,
             i16 and a broadcast scalar key): pack, the CUDA sort of
             the packed words, the boundaries of the sorted words, the
             decode of the carried words in a random order; one launch
             a call. One [wide_keys_time] line a step of each plan at
             1e7 rows: kernel ms, the plain version's ms on the card
             (the torch i64 path the kernels replaced), the byte bound
             and the launches of one call. Then the mesh's stage A
             (parallel/dist.py shard_partials_cuda) against its plain
             version and a frozen copy of the parent formulas (the row
             position packed into an i64 key), every send buffer bit for
             bit, over SHARD_CASES: 1e7 rows on each shard of a 4-shard
             mesh and 2.5e8 rows (one card's shard of
             g1_1e9_k100.mesh4), 24-bit and 14-bit codes, 1 and 3 sum
             lanes, 10% masked rows; then at 1e7 rows two-word codes and
             all five lane ops over 8 shards; one code over a 2.5e8-row
             shard (one run through every block) and a 10 000 333-row
             shard with four lanes side by side; one count of each
             counter (shard_partials, shard_reduce) a call. One
             [shard_partials_time] line a dist-group query of that cell
             at 2.5e8 rows over 4 shards: stage A whole by the kernels,
             the parent formulas and the plain version (CUDA events,
             median of 11), the sort and reduce and carry (`reduce_ms`)
             alone on the same rows, the family's byte bound (the codes,
             the permutation and each row's lanes read once, the sorted
             key read three times, a total a run and a tail a block
             written once, the send buffers written once), its launches
             and each path's peak device memory. Then sort-agg's main
             sort words (engine/sortagg.py sortagg_keys_cuda) against
             sortagg_keys_plain on the same card, bit for bit, at 1e7 and
             1e8 rows on G1's q3, q5 and q6 exact plans (code|pos|packed
             key of two words, the compaction sort's key, a q32 operand,
             a fused sum lane), two keys on the head plan with a where
             mask (an i32 key, the codes, the cumsum route's flags), a
             head key of two words, and an exact plan with a where mask,
             a strided and a broadcast scalar key whose operands are
             every kind with its nulls (i32, i16, bool, i64, f64 with NaN
             of either sign, +-0.0 and +-inf, q32 with NaN), read back as
             values, null masks, null count lanes and fills: pack, the
             CUDA sort of the packed words, read; one launch a call,
             counted. One [sortagg_keys_time] line a step of q3's and q5's
             exact plans on a 1e8-row G1 table with id3 and id6 at 1e6
             codes (the 1e8-row benchmark cell's), the calls the engine
             makes: kernel ms, the plain version's ms on the card (the
             torch path the kernels replaced), the byte bound and the
             launches of one call;
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
             launches per (rows, key words, words), and a
             [seg_scan_shapes] line its scans per shape: each query of
             SCAN_QUERIES must launch the scan kernel and none may run
             the plain version (phases 5, 6, 8, 9 and 10 print and
             check the same line); a [dense_shapes] line its dense
             aggregates by rows, cells, lanes and how the kernel reads
             the codes and lanes: each dense query (DENSE_QUERIES) must
             launch the dense kernel and none may run its plain version
             (phases 7, 8, 10 and 11 the same); a [wide_keys_path]
             line the wide_keys kernels' launches per query, counted
             from zero at the phase's start: 3 in q7 (pack, bound and
             decode), 0 in every other query; a [sortagg_keys_path] line
             the same of the sortagg_keys kernels: 2 in each sort-agg
             query (pack and read), 0 in every other. Then each query's warm
             median exec_ms over 3 runs, and one [dense_time] line per
             dense query on the inputs it gave the dense aggregate:
             kernel, plain, torch-scatter-route and torch.bincount ms,
             the byte bound, the kernel launches, library calls and
             load route of one call;
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
             key) ms, the byte bound and the passes skipped, and one
             [seg_scan_time] line for ij's and aj's scans on the ids
             and values the query gave the scan;
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
             rtol 1e-9); q1 in both modes and dev streamed must
             launch the dense kernel ([dense_shapes]). One [parted_ms] line per
             query and mode: the warm median of 3 wall runs;
8. mesh      the G1 table of phase 4 (same seed, 1e7 rows) row-sharded
             over an 8-shard mesh (RAYFORCE_MESH=8, engine/device.py
             `mesh`; parallel/dist.py: the shards spread over the
             visible cards, so on one card all 8 share it), and every
             tools/g1.py QUERIES select plus two medians at id3's
             cardinality (tools/g1.py MESH_QUERIES: one over the
             table, one over a copy made on the card from a seed in
             which one id3 code holds 60% of the rows, so the median's
             candidate path runs). Each must run the engine the mesh
             route picks (spmd for the dense plan, dist-group for
             sort-agg shapes and the medians; the dense median and q7,
             whose code and row bits pass 62, stay on one device),
             launch the CUDA sort and never fall back; each result
             must equal the single-device card result (phase 4's, or
             for the two medians a card run with the mesh off, itself
             held against the host path) with keys, order, counts and
             integer lanes exactly, f64 within rtol 1e-9, and the next
             mesh run bit for bit. One [mesh_ms] line per query: the
             warm median of 3 exec_ms, the shards, the engine, the
             exchanged bytes and kernel calls of the dist.stats model,
             the sort launches, the stage A kernels' calls (one a shard
             of each dist-group kernel call, none in another engine; the
             plain version never runs) and of them those that reduced a
             scanned lane (shard_reduce), the peak device memory of the
             engine's card and the cards the shards sit on. On one card
             the 8
             shards exchange through device-local copies: these are not
             a multi-card mesh's times. A [dense_time] line for q4's
             first shard (1.25e6 rows);
9. mesh     bench.py's join tables of phase 5 made again from the same
   joins     seeds, with `t_skew` (tools/g1.py skewed_id3: one id3 code
             on 60% of the rows), and the joins, table sorts and window
             joins of tools/jtables.py MESH_JOIN_QUERIES over the
             8-shard mesh: ij and lj (dist-bcast-probe), the same with
             bcast_max = 0 and ij over t_skew (dist-eq; its heavy-key
             route), aj (dist-asof), xasc and xdesc (dist-sort), wj and
             wj0 (dist-wjoin). Each runs first with the mesh off (the
             single-device card answer, held against the host path in
             phases 5 and 6), then on the mesh: it must run its engine,
             launch the CUDA sort, note the reference's exchanged bytes
             (a retry adds its own call's), equal the single-device
             answer (match ids, orders and every column exactly; wj0's
             f64 sum, avg and dev within phase 6's tolerance) and the
             next mesh run bit for bit. One [mesh_join_ms] line per
             query: the warm median of 3 wall runs with every lazy
             column forced and the card synchronised, the single-device
             median, the engine, exchanged bytes and kernel calls, the
             sort launches and the peak device memory;
10. multi-  the 8-shard mesh of phases 8 and 9 over 2 processes
    proc     (tools/multiproc_worker.py, `launch`; RAYFORCE_COORDINATOR,
             engine/device.py `mesh`), 4 shards each, over the
             torch.distributed backend engine/device.py `backend_for`
             names (gloo where the ranks share a card, its collectives
             staged through pinned host memory; NCCL with a card a
             rank). Each rank makes the G1 and join tables of phases 8
             and 9 from the same seeds on the card and runs every query
             of both phases. Each must run the one-process mesh's
             engine, note its exchanged bytes, launch the CUDA sort on
             every rank (and the dense kernel where the one-process
             mesh did) and give the one-process mesh's answer bit for
             bit (a digest of every column) on every rank and rerun.
             One [multiproc_ms] line per query: the slower rank's median
             of 2 warm wall runs (every lazy column forced, the card
             synchronised) beside phase 8's or 9's, the exchanged bytes,
             the calls, bytes and wall ms the rank handed to
             torch.distributed, the launches and peak memory per rank;
11. entry    the flagship step (rayforce_tpu_torch/entry.py) on the card
             (one dense kernel launch) against the same step on the
             CPU, and its [dense_time] line;
12. report   one JSON line with every kernel's numbers (the radix sort's
             launches count the main path's, the joins', the window
             joins', the parted selects', the mesh selects', the mesh
             joins' and the two ranks' runs; the scan's the same but the
             parted selects'; the dense aggregate's the main path's, the
             parted selects', the mesh selects', the two ranks' and the
             entry step's; the stage A kernels' the mesh selects'; the
             sortagg_keys kernels' the main path's; the scan's times are
             those of its 1e7-row i64 sum, the dense aggregate's those of
             q1, stage A's those of q5's shard, sortagg_keys' those of
             q5's pack and read at 1e8 rows),
             then the result line {"ok": true, "device": {...}}.

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


# -- the wide engine's key words ----------------------------------------------

def _wide_plans(W, T, torch, gen, n):
    """[(name, layout, key columns, where mask)] at n rows: q7's plan
    (G1's six keys as i64 codes; at 1e7 rows id1-id5 in word 0, id6 and
    the row position in word 1) and a three-word plan with a where mask
    whose keys are an i64 with a negative least value, an i32 over its
    whole range, an i64, a u8, an i16 and a broadcast scalar, each drawn
    from its range's ends and a few values between (runs of equal
    keys)."""
    dev = torch.device("cuda")

    def pick(choices, dtype):
        c = torch.tensor(choices, dtype=torch.int64, device=dev)
        i = torch.randint(0, len(choices), (n,), generator=gen, device=dev)
        return c[i].to(dtype)
    q7 = [(nm, 0, hi, T.I64, None) for nm, hi in (
        ("id1", 100), ("id2", 100), ("id3", 100_000), ("id4", 100),
        ("id5", 100), ("id6", 100_000))]
    q7_keys = [torch.randint(0, hi, (n,), generator=gen, device=dev,
                             dtype=torch.int64)
               for _nm, _lo, hi, _rt, _dom in q7]
    three = [("a", -2**39, 2**40, T.I64, None),
             ("b", -2**31, 2**32, T.I32, None),
             ("c", 0, 2**28, T.I64, None), ("d", 0, 256, T.U8, None),
             ("e", -2**15, 2**16, T.I16, None), ("f", 7, 1, T.I64, None)]
    three_keys = [pick([-2**39, -1, 0, 2**39 - 1], torch.int64),
                  pick([-2**31, -1, 0, 2**31 - 1], torch.int32),
                  pick([0, 2**28 - 1], torch.int64),
                  pick([0, 255], torch.uint8),
                  pick([-2**15, 2**15 - 1], torch.int16),
                  torch.tensor(7, dtype=torch.int64, device=dev)]
    mask = torch.rand(n, generator=gen, device=dev) < 0.7
    lay3 = W.key_layout(three, n)
    if len(lay3.words) != 3 or lay3.pos_word != 2:
        raise AssertionError(f"the three-word plan has {lay3}")
    return [("q7", W.key_layout(q7, n), q7_keys, None),
            ("three_where", lay3, three_keys, mask)]


def _same_all(torch, got, want, what):
    for i, (g, w) in enumerate(zip(got, want)):
        if g.dtype != w.dtype or g.shape != w.shape or \
                not torch.equal(g.cpu(), w):
            raise AssertionError(f"wide_keys {what}: output {i} differs")


def check_wide_keys(W, T, psort, torch, gen):
    """The key-word kernels against their plain version on the card's
    inputs copied to the CPU, bit for bit, at each of SORT_SIZES on both
    plans: pack the keys; the CUDA radix sort of the packed words; the
    boundaries of the sorted words; the decode of the carried words in a
    random order (the order sort's stand-in). Each step one launch.
    Returns the cases checked."""
    cases = 0
    for n in SORT_SIZES:
        for name, lay, keys, mask in _wide_plans(W, T, torch, gen, n):
            def cpu(xs):
                return [x.cpu() for x in xs]
            before = psort.LAUNCHES["wide_keys"]
            kw = W.pack_keys(lay, keys, mask, n)
            plain_mask = None if mask is None else mask.cpu()
            _same_all(torch, kw, W.pack_keys(lay, cpu(keys), plain_mask, n),
                      f"pack {name} n={n}")
            sw = psort.sort_i32(kw, n_keys=len(kw))
            _same_all(torch, W.key_bounds(lay, sw),
                      W.key_bounds(lay, cpu(sw)), f"bound {name} n={n}")
            perm = torch.randperm(n, generator=gen, device=sw[0].device)
            carried = [sw[i].index_select(0, perm) for wi in lay.carry
                       for i in (2 * wi, 2 * wi + 1)]
            _same_all(torch, W.decode_keys(lay, carried),
                      W.decode_keys(lay, cpu(carried)),
                      f"decode {name} n={n}")
            if psort.LAUNCHES["wide_keys"] != before + 3:
                raise AssertionError(f"wide_keys {name} n={n}: "
                                     f"{psort.LAUNCHES['wide_keys'] - before}"
                                     " launches for three calls")
            cases += 3
    return cases


def wide_keys_bytes(ins, outs):
    """Each input read once (one element where every row reads the
    same), each output written once: a frozen copy lives in
    portbench/metrics/wide_keys_roofline.py."""
    def read(x):
        return x.element_size() * (1 if x.dim() == 0 or x.stride(0) == 0
                                   else x.numel())
    return sum(read(x) for x in ins) + \
        sum(x.numel() * x.element_size() for x in outs)


def time_wide_keys(W, T, psort, torch, gen):
    """One [wide_keys_time] line a step of each plan at ROWS rows: the
    kernel's ms, the plain version's on the card (the torch i64 path the
    kernel replaced) and the byte bound, with the kernel's launches a
    call."""
    out = []
    for name, lay, keys, mask in _wide_plans(W, T, torch, gen, ROWS):
        kw = W.pack_keys(lay, keys, mask, ROWS)
        sw = psort.sort_i32(kw, n_keys=len(kw))
        bounds = W.key_bounds(lay, sw)
        carried = [sw[i] for wi in lay.carry for i in (2 * wi, 2 * wi + 1)]
        dec = W.decode_keys(lay, carried)
        calls = {"pack": (keys + ([mask] if mask is not None else []),
                          kw),
                 "bound": (sw, bounds), "decode": (carried, dec)}
        for step, (ins, outs) in calls.items():
            before = psort.LAUNCHES["wide_keys"]
            W.wide_keys_cuda(step, lay, ins, outs)
            launches = psort.LAUNCHES["wide_keys"] - before
            out.append({
                "plan": name, "step": step, "rows": ROWS,
                "words": len(lay.words), "dims": len(lay.mins),
                "ms": cuda_ms(lambda: W.wide_keys_cuda(step, lay, ins,
                                                       outs)),
                "plain_ms": cuda_ms(lambda: W.wide_keys_plain(
                    step, lay, ins, outs)),
                "bound_ms": wide_keys_bytes(ins, outs) / HBM_BYTES_PER_S *
                1e3,
                "launches": launches})
    return out



# -- sort-agg's main sort words -------------------------------------------------

SORTAGG_KEY_SIZES = (ROWS, 100_000_000)


def _sortagg_key_cases(S, T, torch, gen, n):
    """[(name, KeyPlan, pack's inputs)] at n rows: G1's q3, q5 and q6 on
    the exact plan (id3 at 1e6 codes; code|pos|packed key, the compaction
    sort's key), two keys on the head plan (an i32 key, the codes, the
    cumsum route's flags) with a where mask, one key on a head plan whose
    key needs two words, and an exact plan with a where mask, a strided
    key and a broadcast scalar key whose operands are every kind with its
    nulls: an i32 column with NULL_I32, an i16 with NULL_I16 riding i32, a
    bool, an i64 with NULL_I64, an f64 with NaN of either sign, +-0.0
    and +-inf, and a q32 with NaN, each read back as its value, null
    mask, null count lane and fills."""
    dv = torch.device("cuda")
    pos = max((n - 1).bit_length(), 1)

    def ints(lo, hi, dtype=torch.int64):
        return torch.randint(lo, hi, (n,), generator=gen, device=dv,
                             dtype=torch.int64).to(dtype)

    def holes(x, fill, share=0.1):
        at = torch.rand(n, generator=gen, device=dv) < share
        return torch.where(at, torch.tensor(fill, dtype=x.dtype, device=dv),
                           x)
    q32 = ("q32", 1e6)
    v3 = torch.round(torch.rand(n, generator=gen, device=dv,
                                dtype=torch.float64) * 1e8) / 1e6
    id3, v1, v2 = ints(0, 10**6), ints(1, 6), ints(1, 16)
    fb = max((7 * n).bit_length(), 1)     # v1's fused field
    exact = dict(keys=((0, 10**6),), n_codes=10**6, words=2, pos_bits=pos,
                 codes=False, search=False)
    cases = [
        ("q3_exact", S.KeyPlan(vb=3, packed=((0, 3, 1),),
                               operands=((q32, T.F64),),
                               lanes=(("field32", 0), ("fill", 0, "sum")),
                               **exact), [id3, v1, v3]),
        ("q5_exact", S.KeyPlan(vb=7, packed=((0, 3, 1), (3, 4, 1)),
                               operands=((q32, T.F64),),
                               lanes=(("fused", ((0, 0), (1, fb))),
                                      ("fill", 0, "sum")), **exact),
         [id3, v1, v2, v3]),
        ("q6_exact", S.KeyPlan(vb=7, packed=((0, 3, 1), (3, 4, 1)),
                               operands=(), lanes=(("field32", 0),
                                                   ("field32", 1)), **exact),
         [id3, v1, v2])]
    # two keys on the head plan: an i32 key, with a where mask
    id1, id2 = ints(0, 100), ints(0, 100, torch.int32)
    cases.append(("head_two_keys_where", S.KeyPlan(
        keys=((0, 100), (0, 100)), n_codes=10**4, words=1, pos_bits=0,
        vb=3, packed=((0, 3, 1),), operands=(), codes=True, search=True,
        lanes=(("field32", 0), ("field", 0))),
        [id1, id2, v1, torch.rand(n, generator=gen, device=dv) < 0.7]))
    # one key on a head plan of two words: 20 code bits + 14 packed
    wide = ints(-5000, 5000, torch.int16)
    cases.append(("head_i64_key", S.KeyPlan(
        keys=((0, 10**6),), n_codes=10**6, words=2, pos_bits=0, vb=14,
        packed=((0, 14, -5000),), operands=(), codes=True, search=False,
        lanes=(("field32", 0), ("field", 0))), [id3, wide]))
    # every operand kind with its nulls, an exact plan with a where mask,
    # a strided i32 key and a broadcast scalar key
    i32 = holes(ints(-2**31 + 1, 2**31 - 1, torch.int32),
                int(T.NULL_I32))
    i16 = holes(ints(-2**15 + 1, 2**15 - 1, torch.int16), int(T.NULL_I16))
    b8 = torch.rand(n, generator=gen, device=dv) < 0.5
    i64 = holes(ints(-2**62, 2**62), int(T.NULL_I64))
    f64 = torch.randn(n, generator=gen, device=dv, dtype=torch.float64)
    for val in (float("nan"), -float("nan"), 0.0, -0.0, float("inf"),
                -float("inf")):
        f64 = holes(f64, val, 0.02)
    q = holes(v3, float("nan"))
    ops = (("i32", T.I32), ("i32", T.I16), ("i32", T.B8), ("i64", T.I64),
           ("f64", T.F64), (q32, T.F64))
    lanes = []
    for j, (_kind, rt) in enumerate(ops):
        lanes += [("value", j)]
        if rt != T.B8:
            lanes += [("null", j), ("nulls", j)]
        lanes += [("fill", j, op) for op in ("sum", "min", "max")]
    strided = ints(0, 1000, torch.int32).repeat_interleave(2)[::2]
    cases.append(("operands_where", S.KeyPlan(
        keys=((0, 1000), (7, 1)), n_codes=1000, words=2, pos_bits=pos,
        vb=0, packed=(), operands=ops, codes=True, search=True,
        lanes=tuple(lanes)),
        [strided, torch.tensor(7, device=dv), i32, i16, b8, i64, f64, q,
         torch.rand(n, generator=gen, device=dv) < 0.5]))
    return cases


def _same_words(torch, got, want, what):
    try:
        _same_bits(torch, got, want, what)
    except AssertionError as e:
        raise AssertionError(f"sortagg_keys {e}") from None


def check_sortagg_keys(S, T, psort, torch, gen):
    """The main sort's word kernels against their plain version on the
    same card, bit for bit, at each of SORTAGG_KEY_SIZES on every case of
    `_sortagg_key_cases`: pack, the CUDA radix sort of the packed words,
    read. Each call adds its launches (one) to LAUNCHES["sortagg_keys"].
    Returns the cases checked."""
    cases = 0
    for n in SORTAGG_KEY_SIZES:
        for name, lay, ins in _sortagg_key_cases(S, T, torch, gen, n):
            nk, nf = len(lay.keys), len(lay.packed)
            no = len(lay.operands)
            mask = ins[nk + nf + no] if len(ins) > nk + nf + no else None
            args = (ins[:nk], ins[nk:nk + nf], ins[nk + nf:nk + nf + no],
                    mask, n)
            before = psort.LAUNCHES["sortagg_keys"]
            words, codes = S.pack_words(lay, *args)
            got = words + ([codes] if lay.codes else [])
            if psort.LAUNCHES["sortagg_keys"] != before + 1:
                raise AssertionError(f"sortagg_keys pack {name} n={n}: "
                                     "not one launch")
            outs = [torch.empty_like(x) for x in got]
            S.sortagg_keys_plain("pack", lay, list(ins), outs)
            _same_words(torch, got, outs, f"pack {name} n={n}")
            del outs, got, codes
            sw = psort.sort_i32(words, n_keys=lay.words)
            del words
            before = psort.LAUNCHES["sortagg_keys"]
            sc, comp, tot, lanes = S.read_words(lay, sw)
            if psort.LAUNCHES["sortagg_keys"] != before + 1:
                raise AssertionError(f"sortagg_keys read {name} n={n}: "
                                     "not one launch")
            got = [sc, comp, tot] + [lanes[s] for s in lay.lanes]
            outs = [torch.empty_like(x) for x in got]
            S.sortagg_keys_plain("read", lay, sw, outs)
            _same_words(torch, got, outs, f"read {name} n={n}")
            cases += 2
            del sw, sc, comp, tot, lanes, got, outs
        torch.cuda.empty_cache()
    return cases


def sortagg_keys_bytes(ins, outs):
    """Each input read once (one element where every row reads the
    same), each output written once."""
    def read(x):
        return x.element_size() * (1 if x.dim() == 0 or x.stride(0) == 0
                                   else x.numel())
    return sum(read(x) for x in ins) + \
        sum(x.numel() * x.element_size() for x in outs)


def time_sortagg_keys(S, torch, rows):
    """One [sortagg_keys_time] line a step of q3's and q5's exact plans
    on a G1 table of `rows` rows with id3 and id6 at 1e6 codes (the
    1e8-row benchmark cell's): each call the engine makes, recorded,
    then timed by the kernel and by the plain version on the card (the
    torch path the kernels replaced), with the byte bound at
    HBM_BYTES_PER_S and the launches of one call."""
    from rayforce_tpu_torch import Runtime
    from rayforce_tpu_torch.core import symbols
    from rayforce_tpu_torch.core import types as T
    from rayforce_tpu_torch.core.obj import DevPending, Obj, table, vec_sym
    from rayforce_tpu_torch.engine import device as dev
    from rayforce_tpu_torch.engine import psort
    from rayforce_tpu_torch.engine import select as sel
    from rayforce_tpu_torch.tools.g1 import NAMES, QUERIES
    gen = torch.Generator(device="cuda")
    gen.manual_seed(24)
    cols = []
    for lo, hi in [(0, 100), (0, 100), (0, 10**6), (0, 100), (0, 100),
                   (0, 10**6), (1, 6), (1, 16)]:
        cols.append(torch.randint(lo, hi, (rows,), generator=gen,
                                  device="cuda", dtype=torch.int64))
    v3 = torch.rand(rows, generator=gen, device="cuda",
                    dtype=torch.float64) * 100.0
    cols.append(torch.round(v3 * 1e6) / 1e6)
    del v3
    objs = [Obj(T.F64 if a.dtype == torch.float64 else T.I64, DevPending(a))
            for a in cols]
    for o, a in zip(objs, cols):
        o.meta = {"dev": a}
    t = table(vec_sym(NAMES), objs)
    dev.put_table(t)
    rt = Runtime()
    rt.interp.globals[symbols.intern("t")] = t
    out = []
    real = S._sortagg_keys
    for name in ("q3", "q5"):
        calls = []

        def recording(step, lay, ins, outs):
            calls.append((step, lay, ins, outs))
            return real(step, lay, ins, outs)
        S._sortagg_keys = recording
        try:
            rt.eval_str(QUERIES[name][0])
        finally:
            S._sortagg_keys = real
        if not sel.last_profile.get("exact"):
            raise AssertionError(f"{name} at {rows} rows: not the exact "
                                 "plan")
        for step, lay, ins, outs in calls:
            before = psort.LAUNCHES["sortagg_keys"]
            S.sortagg_keys_cuda(step, lay, ins, outs)
            launches = psort.LAUNCHES["sortagg_keys"] - before
            out.append({
                "query": name, "step": step, "rows": rows,
                "words": lay.words, "packed": len(lay.packed),
                "operands": len(lay.operands), "lanes": len(lay.lanes),
                "ms": cuda_ms(lambda: S.sortagg_keys_cuda(step, lay, ins,
                                                          outs)),
                "bound_ms": sortagg_keys_bytes(ins, outs) /
                HBM_BYTES_PER_S * 1e3,
                "plain_ms": cuda_ms(lambda: S.sortagg_keys_plain(
                    step, lay, ins, outs), reps=5),
                "launches": launches})
        del calls
    del rt, t, objs, cols
    torch.cuda.empty_cache()
    return out



# stage A of the mesh's dist-group engine (parallel/dist.py
# shard_partials): the checked cases, (rows, code space or None for
# codes up to 2^37 on the two-word key, lane ops, shards), at 1e7 rows
# and at one card's shard of g1_1e9_k100.mesh4 (2.5e8 rows), 24-bit and
# 14-bit codes, 1 and 3 lanes; and the timed shapes, each dist-group
# query of that cell on one card's shard: (code space, lane ops)
SHARD_ROWS = 250_000_000
SHARD_CASES = [(n, codes, ("sum",) * lanes, 4)
               for n in (ROWS, SHARD_ROWS) for codes in (10**7, 10**4)
               for lanes in (1, 3)] + [
    (ROWS, None, ("sum", "min", "max", "first", "last"), 8),
    (ROWS, 10**7, ("max", "first", "sum", "last", "min"), 8),
    # one run over every block of a card's shard (carry's pieces), and a
    # row count off the 1024-row blocks with four lanes side by side
    (SHARD_ROWS, 1, ("sum", "max", "min"), 4),
    (10_000_333, 10**7, ("sum", "max", "sum", "min"), 4)]
SHARD_TIMES = {"q2": (10**4, ("sum",)), "q3": (10**7, ("sum", "sum")),
               "q5": (10**7, ("sum",) * 3), "q6": (10**7, ("max", "min"))}


def _parent_stage_a(dist, torch, me, codes, lanes, lane_ops, n_dev, D,
                    n_codes):
    """dist_wide_groupby's stage A before csrc/shard_partials.cu, frozen:
    (code << pos_bits) | position sorted as one i64 key, then ~40 torch
    passes over the rows (the yardstick and a second oracle)."""
    n = int(codes.shape[0])
    C = n if n_codes is None else min(n, n_codes)
    has_last = "last" in lane_ops
    pos_bits = max(int(n - 1).bit_length(), 1)
    posmask = (1 << pos_bits) - 1
    key = torch.where(codes >= 0, (codes << pos_bits) |
                      torch.arange(n, device=codes.device), dist.KEY_MAX)
    (skey,), _, perm = dist.sort_lex([key], perm=True)
    del key
    perm = perm.long()
    svals = [x[perm] for x in lanes]
    del perm
    sc = skey >> pos_bits
    valid = skey != dist.KEY_MAX
    flags = valid & dist._new_run(sc)
    tf = dist._compact_targets(flags, C)
    tl = dist._compact_targets(valid & dist._run_end(sc), C)
    pcode = dist._place(sc, tf, C, -1)
    del sc
    gid = (skey & posmask) + me * n
    del skey
    pfirst = dist._place(gid, tf, C, dist.KEY_MAX)
    plast = dist._place(gid, tl, C, -1) if has_last else None
    del gid
    iota = torch.arange(n, device=codes.device)
    start = dist._place(iota, tf, C, 0)
    end = dist._place(iota, tl, C, 0)
    del iota
    seg = torch.cumsum(flags.to(torch.int32) + (~valid).to(torch.int32), 0,
                       dtype=torch.int32)
    del flags, valid
    out = [(pcode, -1), (end - start + 1, 0), (pfirst, dist.KEY_MAX)]
    scan = [i for i, op in enumerate(lane_ops)
            if op not in ("first", "last")]
    ins = [svals[i] for i in scan]
    for i in scan:
        svals[i] = None
    red = dict(zip(scan, dist._rscan_lanes(
        seg, [lane_ops[i] for i in scan], ins)))
    del seg
    for i, (op, sv) in enumerate(zip(lane_ops, svals)):
        if op == "first":
            v = dist._place(sv, tf, C, 0.0)
        elif op == "last":
            v = dist._place(sv, tl, C, 0.0)
        else:
            v = dist._place(red.pop(i), tf, C, 0.0)
        out.append((v, dist._LANE_FILL[op]))
    if has_last:
        out.append((plast, -1))
    slot, _ok = dist._bucket_slots(pcode % n_dev, n_dev, D, pcode >= 0)
    return [dist._place(x, slot, n_dev * D, fill) for x, fill in out]


def _shard_case(torch, gen, n, n_codes, n_lanes, masked):
    """A shard's codes (i64) and f64 lanes; where `masked`, 10% of the
    codes at -1 and the lanes' rows 7 k at -0.0, 11 k + 3 at +0.0 and
    100 003 k + 5 at NaN."""
    hi = n_codes if n_codes is not None else 1 << 37
    codes = torch.randint(0, hi, (n,), generator=gen, device="cuda")
    if masked:
        codes[torch.rand(n, generator=gen, device="cuda") < 0.1] = -1
    lanes = [torch.rand(n, generator=gen, device="cuda",
                        dtype=torch.float64) * 200 - 100
             for _ in range(n_lanes)]
    if masked:
        for x in lanes:
            x[::7] = -0.0
            x[3::11] = 0.0
            x[5::100_003] = float("nan")
    return codes, lanes


def _shard_slots(n, n_codes, n_dev):
    """dist_wide_groupby's D for a shard of n rows."""
    C = n if n_codes is None else min(n, n_codes)
    return C if n_codes is None else max(min(C, -(-n_codes // n_dev)), 1)


def _same_bits(torch, got, want, what):
    if len(got) != len(want):
        raise AssertionError(f"{what}: {len(got)} buffers, not {len(want)}")
    for j, (g, w) in enumerate(zip(got, want)):
        if g.dtype != w.dtype or g.shape != w.shape:
            raise AssertionError(f"{what}: buffer {j} {g.dtype} "
                                 f"{tuple(g.shape)}, not {w.dtype} "
                                 f"{tuple(w.shape)}")
        if g.dtype == torch.float64:
            g, w = g.view(torch.int64), w.view(torch.int64)
        if not torch.equal(g, w):
            bad = int((g != w).sum())
            raise AssertionError(f"{what}: buffer {j} differs in {bad} "
                                 "slots")


def check_shard_partials(dist, psort, torch, gen):
    """Stage A's kernels (dist.shard_partials_cuda) against the plain
    version and the frozen parent formulas on the card, every send buffer
    bit for bit, over SHARD_CASES (10% masked rows, each shard of the
    case's mesh in turn at 1e7 rows, shard 1 at 2.5e8); one count a
    call. Returns the cases checked."""
    cases = 0
    for n, n_codes, ops, n_dev in SHARD_CASES:
        codes, lanes = _shard_case(torch, gen, n, n_codes, len(ops), True)
        D = _shard_slots(n, n_codes, n_dev)
        for me in (range(n_dev) if n == ROWS else (1,)):
            what = f"shard_partials n={n} codes={n_codes} ops={ops} " \
                f"shard {me}/{n_dev}"
            before = dict(psort.LAUNCHES)
            got = dist.shard_partials_cuda(me, codes, lanes, ops, n_dev, D,
                                           n_codes)
            for counter in ("shard_partials", "shard_reduce"):
                if psort.LAUNCHES[counter] != before[counter] + 1:
                    raise AssertionError(f"{what}: not one {counter} count "
                                         "a call")
            _same_bits(torch, got, dist.shard_partials_plain(
                me, codes, lanes, ops, n_dev, D, n_codes), what + " plain")
            _same_bits(torch, got, _parent_stage_a(
                dist, torch, me, codes, lanes, ops, n_dev, D, n_codes),
                what + " parent")
            if not 0 < int((got[0] >= 0).sum()) <= n_dev * D:
                raise AssertionError(f"{what}: no partials")
            del got
            cases += 1
        del codes, lanes
        torch.cuda.empty_cache()
    return cases


def shard_partials_bytes(n, words, scanned, size, outs):
    """The kernel family's byte bound for one shard: the codes read and
    the key words written once (keys); the sorted key, the permutation and
    each row's scanned lanes read once, a total a run and lane (at most
    `size` runs) and a tail a block and lane written once (reduce, carry);
    the sorted key read twice (runs); the send buffers written once
    (place); the sort apart."""
    return (8 * n + 4 * words * n +
            4 * words * n + 4 * n + 8 * scanned * n +
            8 * scanned * (size + -(-n // 1024)) +
            2 * 4 * words * n + 8 * size * outs)


def shard_partials_launches(n, scanned):
    """Launches of one stage A call with at most 32 scanned lanes: keys,
    the three of runs and place; reduce and carry's one or two (two where
    a chain can pass 1024 blocks)."""
    blocks = -(-n // 1024)
    return 5 + (0 if not scanned else 1 + (blocks > 1) + (blocks > 1025))


def time_shard_partials(dist, psort, G, torch, gen):
    """One [shard_partials_time] line a dist-group query of
    g1_1e9_k100.mesh4 at one card's shard (2.5e8 rows over four shards,
    no masked rows): CUDA events, median of 11, of stage A whole by the
    parent formulas, by the plain version and by the kernels; the sort,
    and reduce and carry (`reduce_ms`), alone on the same rows; the
    family's byte bound; its launches a call; each path's peak device
    memory."""
    out = []
    n_dev = 4
    for name, (n_codes, ops) in SHARD_TIMES.items():
        codes, lanes = _shard_case(torch, gen, SHARD_ROWS, n_codes,
                                   len(ops), False)
        D = _shard_slots(SHARD_ROWS, n_codes, n_dev)
        args = (1, codes, lanes, ops, n_dev, D, n_codes)
        peaks = {}
        for path, fn in (("parent", lambda: _parent_stage_a(
                dist, torch, *args)),
                ("plain", lambda: dist.shard_partials_plain(*args)),
                ("kernel", lambda: dist.shard_partials_cuda(*args))):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            fn()
            torch.cuda.synchronize()
            peaks[path] = round((torch.cuda.max_memory_allocated() - base) /
                                1e9, 3)
        r = {"shape": name, "rows": SHARD_ROWS, "codes": n_codes,
             "ops": ",".join(ops), "shards": n_dev,
             "ms": cuda_ms(lambda: dist.shard_partials_cuda(*args)),
             "parent_ms": cuda_ms(lambda: _parent_stage_a(dist, torch,
                                                          *args)),
             "plain_ms": cuda_ms(lambda: dist.shard_partials_plain(*args))}
        key = torch.where(codes >= 0, codes, n_codes).to(torch.int32)
        r["sort_ms"] = cuda_ms(lambda: psort.sort_i32([key], 1, perm=True))
        del key
        # reduce and carry on the kernels' own sorted key and side-by-side
        # rows, the lanes in the wrapper's order
        scanned = dist._scanned(ops)
        src = [lanes[i] for idx in scanned.values() for i in idx]
        sops = [op for op, idx in scanned.items() for _ in idx]
        hi, lo, sentinel, perm, width, rows = dist.shard_keys(codes, src,
                                                              n_codes)
        r["reduce_ms"] = cuda_ms(lambda: dist.shard_reduce(
            SHARD_ROWS, hi, lo, sentinel, perm, src, sops, width, rows))
        del hi, lo, perm, rows, src
        r["family_ms"] = r["ms"] - r["sort_ms"]
        r["bound_ms"] = shard_partials_bytes(
            SHARD_ROWS, 1, len(ops), n_dev * D, 3 + len(ops)) / \
            HBM_BYTES_PER_S * 1e3
        r["launches"] = shard_partials_launches(SHARD_ROWS, len(ops))
        r["peak_gb"] = json.dumps(peaks, separators=(",", ":"))
        out.append(r)
        del codes, lanes, args
        torch.cuda.empty_cache()
    return out


SCAN_SIZES = (1, 977, 1023, 1024, 1025, (1 << 20) + 3, ROWS, 3 * ROWS)
# run lengths: 1, 3, 2500, one run over every row, runs of 3500 rows (each
# over three or more 1024-row blocks), and sorted ids from -5 with -2s
# dropped in out of order
SCAN_IDS = ("run1", "run3", "run2500", "one", "long", "mixed")
# the f64 bit patterns dropped into the scan's values, with their row
# strides: NaN, NaN with its sign bit set, 0.0, -0.0, inf and -inf
SCAN_F64_BITS = ((0x7FF8000000000000, 997), (0xFFF8000000000000, 1009),
                 (0, 5), (0x8000000000000000, 7), (0x7FF0000000000000, 101),
                 (0xFFF0000000000000, 103))
# the queries of each phase that run the segmented scan (the dense plan's
# f64 sums take the dense aggregate's fixed order, no scan)
SCAN_QUERIES = {
    "main": ("q2", "q3", "q5", "q6", "q7", "where"),
    "join": ("ij", "lj", "aj"),
    "mesh": ("q2", "q3", "q5", "q6", "q7", "where", "med_id3",
             "med_id3_skew"),
    "mesh_join": ("ij_eq", "lj_eq", "ij_eq_skew"),
}


def _scan_ids(torch, gen, dev, n, kind):
    i = torch.arange(n, device=dev)
    if kind == "mixed":
        a = torch.sort(torch.randint(-5, max(2, n // 50), (n,),
                                     generator=gen, device=dev)).values
        a[torch.rand(n, generator=gen, device=dev) < 0.02] = -2
        return a
    return {"run1": i, "run3": i // 3, "run2500": i // 2500,
            "one": torch.zeros_like(i), "long": i // 3500}[kind]


def _scan_vals(torch, gen, dev, n, dtype):
    """(n, 4) values: random, with the special values of the type (f64:
    SCAN_F64_BITS; integers: the identities, which are also the joins'
    "no row" sentinels, -1 and 0) at fixed row strides."""
    if dtype == torch.float64:
        v = (torch.rand((n, 4), generator=gen, device=dev,
                        dtype=torch.float64) - 0.5) * 2e6
        bits = v.view(torch.int64).view(-1)
        for b, step in SCAN_F64_BITS:
            bits[::step] = b - (1 << 64) if b >= 1 << 63 else b
        return v
    info = torch.iinfo(dtype)
    v = torch.randint(info.min, info.max, (n, 4), generator=gen, device=dev,
                      dtype=dtype)
    flat = v.view(-1)
    for x, step in ((info.max, 101), (info.min, 103), (-1, 7), (0, 5)):
        flat[::step] = x
    return v


def _same_scan(torch, got, want):
    """Equal type, shape and bits (f64 compared as its i64 bits)."""
    if got.dtype != want.dtype or got.shape != want.shape:
        return False
    if got.dtype == torch.float64:
        got, want = got.view(torch.int64), want.view(torch.int64)
    return bool(torch.equal(got, want))


# sizes at which every case runs SCAN_REPEATS times, equal every time
SCAN_REPEATED = (ROWS, 3 * ROWS)
SCAN_REPEATS = 3


def _scan_kinds(n):
    if n <= (1 << 20) + 3:
        return SCAN_IDS
    return ("run1", "long", "mixed", "one") if n == 3 * ROWS else \
        ("run1", "long", "mixed")


def check_seg_scan(G, torch, gen):
    """The CUDA segmented scan against its plain version on the card, bit
    for bit: every op (min, max, sum), value type (i32, i64, f64), id type
    (i32, and i64 as a strided view), one lane and three (a view of an
    (n, 4) tensor) and both directions, at n in SCAN_SIZES over the id
    patterns of SCAN_IDS (the three longest sizes over run1, long and
    mixed, 3e7 over one as well), SCAN_REPEATS runs a case at
    SCAN_REPEATED sizes. Each case's route and scratch bytes must be the
    library's; the cases must take every route. Returns the number of
    cases and the kernel calls per route."""
    dev = torch.device("cuda")
    lib = G._seg_lib()
    routes = dict(G.ROUTES)
    cases = 0
    for n in SCAN_SIZES:
        vals = {dt: _scan_vals(torch, gen, dev, n, dt)
                for dt in (torch.int32, torch.int64, torch.float64)}
        reps = SCAN_REPEATS if n in SCAN_REPEATED else 1
        for kind in _scan_kinds(n):
            base = _scan_ids(torch, gen, dev, n, kind)
            for ids in (base.to(torch.int32),
                        torch.stack([base, base], 1)[:, 0]):
                for dt, v4 in vals.items():
                    for v in (v4[:, 0].contiguous(), v4[:, :3]):
                        L = 1 if v.dim() == 1 else int(v.shape[1])
                        what = (f"n={n} {kind} ids {ids.dtype} {dt} lanes "
                                f"{tuple(v.shape[1:])}")
                        route = G.SEG_ROUTES[lib.rf_seg_scan_route(
                            n, G._KINDS[dt])]
                        if route != G.seg_scan_route(n, dt) or \
                                lib.rf_seg_scan_scratch_bytes(
                                    n, L, G._KINDS[dt]) != \
                                G.seg_scan_scratch_bytes(n, L, dt):
                            raise AssertionError(
                                f"seg_scan route or scratch differs from "
                                f"groupby's mirror: {what}")
                        for op in ("min", "max", "sum"):
                            for rev in (False, True):
                                want = G.seg_scan_plain(ids, v, op, rev)
                                for rep in range(reps):
                                    got = G.seg_scan_cuda(ids, v, op, rev)
                                    if not _same_scan(torch, got, want):
                                        raise AssertionError(
                                            f"seg_scan differs: {what} "
                                            f"{op} reverse={rev} (run "
                                            f"{rep + 1} of {reps})")
                                cases += 1
        del vals
    torch.cuda.synchronize()
    routes = {k: G.ROUTES[k] - routes[k] for k in routes}
    missing = [k for k, c in routes.items() if c <= 0]
    if missing:
        raise AssertionError(f"seg_scan: phase 3 never took {missing}")
    return cases, routes


def time_scan(G, torch, name, ids, vals, op, rev):
    """Kernel and plain ms (CUDA events, median of 11) of one scan, with
    its byte bound (ids read once, values read once and written once),
    its route and its kernel launches and memsets (the route's, and those
    of the fullest of three profiler traces of one call, which must not
    exceed them; the profiler drops a device event now and then, and
    `traced` is None when all three came back empty); the kernel's
    output equals the plain version's bit for bit."""
    from rayforce_tpu_torch.tools.sortprof import launch_split
    got = G.seg_scan_cuda(ids, vals, op, rev)
    if not _same_scan(torch, got,
                      G.seg_scan_plain(ids, vals, op, rev)):
        raise AssertionError(f"seg_scan differs at shape {name}")
    n, lanes = int(vals.shape[0]), int(vals[0].numel())
    launches, memsets = G.seg_scan_launches(n, vals.dtype)
    # timed before the profiler traces: times taken after them came out
    # higher on the card
    ms = cuda_ms(lambda: G.seg_scan_cuda(ids, vals, op, rev))
    plain_ms = cuda_ms(lambda: G.seg_scan_plain(ids, vals, op, rev))
    split = max((launch_split(lambda: G.seg_scan_cuda(ids, vals, op, rev))
                 for _ in range(3)), key=len)
    traced = [sum("memset" not in k.lower() for k, _us in split),
              sum("memset" in k.lower() for k, _us in split)]
    if traced[0] > launches or traced[1] > memsets:
        raise AssertionError(f"seg_scan at {name}: traced {traced} "
                             f"launches and memsets, the route has "
                             f"{launches} and {memsets}")
    return {"shape": name, "rows": n, "lanes": lanes,
            "dtype": str(vals.dtype)[6:], "id_dtype": str(ids.dtype)[6:],
            "op": op, "reverse": rev,
            "route": G.seg_scan_route(n, vals.dtype),
            "launches": launches, "memsets": memsets,
            "traced": json.dumps(traced) if split else None,
            "ms": ms, "plain_ms": plain_ms,
            "bound_ms": n * (ids.element_size() + 2 * vals.element_size() *
                             lanes) / HBM_BYTES_PER_S * 1e3,
            "library_ms": None}


def scan_report(path, per_query, shapes, want):
    """Each query of `want` launched the scan kernel, and no query ran
    the plain version on the card; prints the [seg_scan_shapes] line."""
    plain = sorted(k for k in shapes if k.endswith(" plain"))
    if plain:
        raise AssertionError(f"{path}: the plain scan ran on the card: "
                             f"{plain}")
    missing = [q for q in want if per_query.get(q, 0) <= 0]
    if missing:
        raise AssertionError(f"{path}: the scan kernel never launched in "
                             f"{missing}")
    phase("seg_scan_shapes", path=path, launches=sum(per_query.values()),
          per_query=json.dumps(per_query, separators=(",", ":")),
          calls=json.dumps(shapes, separators=(",", ":")))
    return sum(per_query.values())


# the dense aggregate's cases: codes (and the trash code n), rows (1e7 / 8
# rows is a mesh shard of phase 8), runs of each case at ROWS
DENSE_CODES = (1, 7, 100, 512)
DENSE_SIZES = (1, 31, 32, 33, 1023, 1025, 977, (1 << 20) + 3, ROWS // 8,
               ROWS)
DENSE_REPEATS = 3
# the f64 sums' special values, with their row strides: 0.0, -0.0, inf,
# -inf (a cell with both adds inf - inf: NaN)
DENSE_SUM_BITS = ((0, 5), (0x8000000000000000, 7), (0x7FF0000000000000, 1009),
                  (0xFFF0000000000000, 1013))
# the queries of each phase that run the dense aggregate (razed, dev v3
# runs sort-agg; streamed, its partials are dense selects)
DENSE_QUERIES = {
    "main": ("q1", "q4", "med", "no_by", "small_where"),
    "parted": ("q1_stream", "q1_razed", "dev_stream"),
    "mesh": ("q1", "q4", "med", "no_by", "small_where", "med_id3",
             "med_id3_skew"),
}


def _put_bits(torch, v, specials):
    bits = v.view(torch.int64)
    for b, step in specials:
        bits[::step] = b - (1 << 64) if b >= 1 << 63 else b
    return v


def _dense_lanes(torch, gen, dev, n):
    """The lanes of a dense case: ints (an i32 limb lane, an i64 lane
    whose sums wrap), an f64 sum lane with magnitudes from 1e-300 to
    1e300 and DENSE_SUM_BITS, mins (i64 with KEY_MAX and I64_MIN, f64
    with SCAN_F64_BITS: NaN of either sign, +-0.0, +-inf; i32) and maxs
    (the same f64 and i64 lanes)."""
    def ri(lo, hi, dtype=torch.int64):
        return torch.randint(lo, hi, (n,), generator=gen, device=dev,
                             dtype=dtype)
    mag = torch.pow(10.0, ri(-300, 301).double())
    fs = _put_bits(torch, (torch.rand(n, generator=gen, device=dev,
                                      dtype=torch.float64) - 0.5) * mag,
                   DENSE_SUM_BITS)
    i64 = ri(-2**63, 2**63 - 1)
    i64[::11] = 2**63 - 1
    i64[::13] = -2**63
    f = _put_bits(torch, (torch.rand(n, generator=gen, device=dev,
                                     dtype=torch.float64) - 0.5) * 10,
                  SCAN_F64_BITS)
    return {"ints": (ri(0, 256, torch.int32), ri(2**61, 2**62)),
            "fsums": (fs,),
            "mins": (i64, f, ri(-2**31, 2**31 - 1, torch.int32)),
            "maxs": (f, i64)}


def _dense_codes(torch, gen, dev, n, rows, kind):
    if kind == "random":
        return torch.randint(0, n + 1, (rows,), generator=gen, device=dev,
                             dtype=torch.int32)
    if kind == "i64_view":
        c = torch.randint(0, n + 1, (rows,), generator=gen, device=dev)
        return torch.stack([c, c], 1)[:, 0]
    one = torch.full((1,), n // 2, dtype=torch.int32, device=dev)
    return one.expand(rows) if kind == "stride0" else \
        one.repeat(rows)


def _same_dense(torch, got, want):
    """The same lanes, each of equal type, shape and bits."""
    if sorted(got) != sorted(want):
        return False
    return all(_same_scan(torch, got[k], want[k]) for k in want)


def check_dense_agg(G, torch, gen):
    """The CUDA dense aggregate against its plain version on the card,
    bit for bit in every lane: DENSE_CODES codes plus the trash code over
    DENSE_SIZES rows; i32 codes, i64 codes as a strided view, every row on
    one code and a stride-0 view of one code; every lane of
    `_dense_lanes`, and the same lanes as a strided and as a misaligned
    view (`_lane_view`); counts and then first/last row ids left out; at ROWS
    each case DENSE_REPEATS times, equal every time. Then the three
    synthetic shapes of tools/denseparts.py at ROWS, DENSE_REPEATS times
    each. Returns the number of cases."""
    from rayforce_tpu_torch.tools import denseparts
    dev = torch.device("cuda")
    cases = 0
    for rows in DENSE_SIZES:
        lanes = _dense_lanes(torch, gen, dev, rows)
        reps = DENSE_REPEATS if rows == ROWS else 1
        for n in DENSE_CODES:
            runs = [(kind, True, True, None) for kind in
                    ("random", "i64_view", "one", "stride0")] + \
                [("random", False, True, None), ("random", True, False, None),
                 ("random", True, True, "strided"),
                 ("random", True, True, "offset")]
            for kind, counts, fidx, view in runs:
                codes = _dense_codes(torch, gen, dev, n, rows, kind)
                ls = {k: tuple(_lane_view(torch, x, view) for x in v)
                      for k, v in lanes.items()} if view else lanes
                args = (codes, n + 1, rows, ls["ints"], ls["fsums"],
                        ls["mins"], ls["maxs"], counts, fidx)
                _check_dense(G, torch, args, reps,
                             f"{rows} rows, {n} codes {kind}, "
                             f"counts={counts} fidx={fidx} lanes={view}")
                cases += 1
        del lanes
    for name, args in denseparts._synthetic(torch, ROWS).items():
        _check_dense(G, torch, args, DENSE_REPEATS, f"shape {name}")
        cases += 1
    torch.cuda.synchronize()
    return cases


def _lane_view(torch, x, how):
    """x's values as every other element of a (n, 2) tensor ("strided")
    or one element past a 16-byte boundary ("offset"), read in place."""
    if how == "strided":
        return torch.stack([x, x], 1)[:, 0]
    buf = torch.empty(x.shape[0] + 1, dtype=x.dtype, device=x.device)
    buf[1:] = x
    return buf[1:]


def _check_dense(G, torch, args, reps, what):
    want = G.dense_agg_plain(*args)
    for rep in range(reps):
        got = G.dense_agg_cuda(*args)
        if not _same_dense(torch, got, want):
            bad = [k for k in want if k not in got or
                   not _same_scan(torch, got[k], want[k])]
            raise AssertionError(f"dense_agg differs: {what}, lanes {bad} "
                                 f"(run {rep + 1} of {reps})")


def dense_launches(G, call):
    """(kernel launches, library calls, load route) of one dense_agg_cuda
    call with these arguments: each library call of the wrapper
    (G._dense_batches) launches rf_dense_agg_launches kernels; the route
    is how the kernel reads the codes and the lanes
    (G.dense_load_route)."""
    codes, W, n, ints, fsums, mins, maxs, _counts, fidx = call
    lanes = [("", x, "int") for x in ints] + \
        [("", x, "fsum") for x in fsums] + \
        [("", x, "min") for x in mins] + [("", x, "max") for x in maxs]
    lib = G._dense_lib()
    k = 0
    batches = G._dense_batches(W, lanes, fidx)
    for bi, b in enumerate(batches):
        n_f = sum(op == "fsum" for _nm, _x, op in b)
        k += lib.rf_dense_agg_launches(
            n, W, (3 if fidx and bi == 0 else 1) + len(b) - n_f, n_f)
    route = "codes " + G.dense_load_route(codes, True)
    if lanes:
        route += ", lanes " + "+".join(sorted(
            {G.dense_load_route(x) for _nm, x, _op in lanes}))
    return k, len(batches), route


def scatter_route(G, psort, torch, codes, W, n, ints, fsums, mins, maxs,
                  counts, fidx):
    """The torch route this kernel replaced, on the same inputs: one
    stacked index_add_ over copies of the cells for the counts and
    integer sums, scatter_reduce_ for the row ids and extrema, and for
    f64 sums a stable sort of the codes (the CUDA radix sort), a gather
    of the lanes and the segmented scan (its CUDA kernel). Timed as the
    yardstick; no part of the port calls it."""
    I64 = torch.int64
    c = codes[:n]
    cells = G._cells(c, W, n)
    acc = G._scatter_sum(cells, W, torch.stack(
        [x[:n].to(I64) for x in ints] +
        [torch.ones(n, dtype=I64, device=c.device)], 1))
    out = [acc]
    if fidx:
        rows = torch.arange(n, dtype=I64, device=c.device)
        out += [G._scatter_ext(cells, W, rows, "amin"),
                G._scatter_ext(cells, W, rows, "amax", init=-1)]
    if fsums:
        (sc,), _, perm = psort.sort_lex([c.to(torch.int32)], perm=True)
        perm = perm.long()
        ends = torch.clamp(torch.cumsum(acc[:, -1], 0) - 1, min=0)
        out.append(G.seg_doubling_sum(sc, torch.stack(
            [x[:n][perm] for x in fsums], 1))[ends])
    out += [G._scatter_ext(cells, W, m[:n], "amin") for m in mins]
    out += [G._scatter_ext(cells, W, m[:n], "amax") for m in maxs]
    return out


def dense_bytes(call):
    """Bytes one dense aggregate must move: the codes (one element for a
    stride-0 view) and every lane read once, every (W,) output written
    once."""
    codes, W, n, ints, fsums, mins, maxs, counts, fidx = call
    lanes = list(ints) + list(fsums) + list(mins) + list(maxs)
    read = (n if codes.stride(0) else 1) * codes.element_size() + \
        sum(n * x.element_size() for x in lanes)
    return read + W * 8 * (len(lanes) + bool(counts) + 2 * bool(fidx))


def time_dense(G, psort, torch, name, call):
    """Kernel, plain and torch-scatter-route ms (CUDA events, median of
    11; the plain version of 3) of one dense aggregate on the inputs a
    query gave it, and the ms of torch.bincount of its codes (the one
    PyTorch call that computes one of its outputs, the counts); its byte
    bound, launches, library calls and load route; the kernel's output
    equals the plain version's bit for bit."""
    codes, W, n, ints, fsums, mins, maxs, _c, _f = call
    if not _same_dense(torch, G.dense_agg_cuda(*call),
                       G.dense_agg_plain(*call)):
        raise AssertionError(f"dense_agg differs at shape {name}")
    launches, lib_calls, route = dense_launches(G, call)
    return {"shape": name, "rows": n, "cells": W,
            "lanes": json.dumps({k: [str(x.dtype)[6:] for x in v] for k, v
                                 in (("int", ints), ("fsum", fsums),
                                     ("min", mins), ("max", maxs)) if v},
                                separators=(",", ":")),
            "code_stride": codes.stride(0), "route": json.dumps(route),
            "launches": launches, "library_calls": lib_calls,
            "ms": cuda_ms(lambda: G.dense_agg_cuda(*call)),
            "plain_ms": cuda_ms(lambda: G.dense_agg_plain(*call), reps=3,
                                warm=1),
            "library_ms": cuda_ms(lambda: scatter_route(G, psort, torch,
                                                        *call)),
            "bincount_ms": cuda_ms(lambda: torch.bincount(codes[:n],
                                                          minlength=W)),
            "bound_ms": dense_bytes(call) / HBM_BYTES_PER_S * 1e3}


def dense_report(path, per_query, shapes, want):
    """Each query of `want` launched the dense kernel, and no query ran
    its plain version on the card; prints the [dense_shapes] line."""
    plain = sorted(k for k in shapes if k.endswith(" plain"))
    if plain:
        raise AssertionError(f"{path}: the plain dense aggregate ran on "
                             f"the card: {plain}")
    missing = [q for q in want if per_query.get(q, 0) <= 0]
    if missing:
        raise AssertionError(f"{path}: the dense kernel never launched in "
                             f"{missing}")
    phase("dense_shapes", path=path, launches=sum(per_query.values()),
          per_query=json.dumps(per_query, separators=(",", ":")),
          calls=json.dumps(shapes, separators=(",", ":")))
    return sum(per_query.values())


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
    words) in that run, the host copies of the results, the scan
    kernel's launches in that run, the dense kernel's launches in that
    run with the first call of each dense query, by query, the
    wide_keys kernels' launches in that run and the sortagg_keys
    kernels')."""
    import torch
    from rayforce_tpu_torch import Runtime
    from rayforce_tpu_torch.core import symbols
    from rayforce_tpu_torch.engine import device as dev
    from rayforce_tpu_torch.engine import psort
    from rayforce_tpu_torch.engine import select as sel
    from rayforce_tpu_torch.tools.g1 import QUERIES, g1_table
    from rayforce_tpu_torch.tools.multiproc_worker import count_dense, \
        count_scans

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

    scans, scan_per_query = {}, {}
    dense, dense_per_query, dense_calls = {}, {}, {}
    wide_per_query, sk_per_query = {}, {}
    psort.sort_i32_cuda = recording
    psort.LAUNCHES["radix_sort"] = psort.LAUNCHES["seg_scan"] = \
        psort.LAUNCHES["dense_agg"] = psort.LAUNCHES["wide_keys"] = \
        psort.LAUNCHES["sortagg_keys"] = 0
    try:
        with count_scans(scans), count_dense(dense):
            for name, (q, engine) in QUERIES.items():
                before = dict(psort.LAUNCHES)
                cached = set(sel._plan_cache)
                sel.last_profile.clear()
                calls = []
                with count_dense({}, calls):
                    results[name] = rt.eval_str(q)
                if calls:
                    dense_calls[name] = calls[0][1]
                got = _engine(sel, cached)
                if got != engine:
                    raise AssertionError(f"{name}: engine {got}, not "
                                         f"{engine}")
                per_query[name] = psort.LAUNCHES["radix_sort"] - \
                    before["radix_sort"]
                scan_per_query[name] = psort.LAUNCHES["seg_scan"] - \
                    before["seg_scan"]
                dense_per_query[name] = psort.LAUNCHES["dense_agg"] - \
                    before["dense_agg"]
                wide_per_query[name] = psort.LAUNCHES["wide_keys"] - \
                    before["wide_keys"]
                sk_per_query[name] = psort.LAUNCHES["sortagg_keys"] - \
                    before["sortagg_keys"]
                if per_query[name] <= 0:
                    raise AssertionError(f"{name}: the CUDA sort never "
                                         "launched")
    finally:
        psort.sort_i32_cuda = real
    if device == "cuda":
        torch.cuda.synchronize()
    launches = psort.LAUNCHES["radix_sort"]
    # pack, bound and decode: one launch each in a wide query, none in
    # the other engines
    for name, (q, engine) in QUERIES.items():
        want = 3 if engine == "wide" else 0
        if wide_per_query[name] != want:
            raise AssertionError(f"{name}: {wide_per_query[name]} wide_keys "
                                 f"launches, not {want}")
    wide_launches = psort.LAUNCHES["wide_keys"]
    phase("wide_keys_path", path="main", launches=wide_launches,
          per_query=json.dumps(wide_per_query, separators=(",", ":")))
    # pack and read: one launch each in a sort-agg query, none in the
    # other engines
    for name, (q, engine) in QUERIES.items():
        want = 2 if engine == "sortagg" else 0
        if sk_per_query[name] != want:
            raise AssertionError(f"{name}: {sk_per_query[name]} "
                                 f"sortagg_keys launches, not {want}")
    sk_launches = psort.LAUNCHES["sortagg_keys"]
    phase("sortagg_keys_path", path="main", launches=sk_launches,
          per_query=json.dumps(sk_per_query, separators=(",", ":")))
    scan_launches = scan_report("main", scan_per_query, scans,
                                SCAN_QUERIES["main"])
    dense_launches_ = dense_report("main", dense_per_query, dense,
                                   DENSE_QUERIES["main"])

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
    host_cols = {name: _columns(r, name) for name, r in results.items()}
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
    return launches, per_query, exec_ms, shapes, host_cols, scan_launches, \
        (dense_launches_, dense_calls), wide_launches, sk_launches


def _exec_ms(prof):
    return prof["exec_ms"] if "exec_ms" in prof else \
        prof["dispatch_ms"] + prof["exec+fetch_ms"]


MESH_SHARDS = 8
# the engine the mesh route picks for each query
MESH_ENGINES = {"q1": "spmd", "q4": "spmd", "med": "dense",
                "no_by": "spmd", "small_where": "spmd", "q2": "dist-group",
                "q3": "dist-group", "q5": "dist-group", "q6": "dist-group",
                "first_last": "dist-group", "where": "dist-group",
                "q7": "wide", "med_id3": "dist-group",
                "med_id3_skew": "dist-group"}


def _mesh_engine(prof):
    if "dispatch_ms" in prof:
        return "spmd" if prof.get("spmd") else "dense"
    return prof.get("engine", "host")


def mesh_path(rows, device, single):
    """Run every G1 query and the two id3 medians over an 8-shard mesh
    (the shards spread over the visible cards), each held against its
    single-device card result (`single`: phase 4's host copies, held
    against the host path there; the two medians' are taken and held
    against the host path here) and a second mesh run. Returns (launches
    of the checked runs, launches per query, per query the mesh answer's
    digest, exchanged bytes, engine, warm wall ms and whether it scanned
    and ran the dense kernel for phase 10, the scan kernel's launches in
    the checked runs, and the dense kernel's launches in them with the
    first call of q4, one shard's)."""
    import torch
    from rayforce_tpu_torch import Runtime
    from rayforce_tpu_torch.core import symbols
    from rayforce_tpu_torch.engine import device as dev
    from rayforce_tpu_torch.engine import psort
    from rayforce_tpu_torch.engine import select as sel
    from rayforce_tpu_torch.parallel import dist
    from rayforce_tpu_torch.tools.g1 import MESH_QUERIES, QUERIES, \
        g1_table, skewed_id3
    from rayforce_tpu_torch.tools.jtables import force_columns
    from rayforce_tpu_torch.tools.multiproc_worker import count_dense, \
        count_scans, digest

    def no_fallback(e):
        raise AssertionError(f"device path fell back to the host: {e!r}")
    sel.warn_fallback = no_fallback

    def no_plain(*a):
        raise AssertionError("stage A ran its plain version on the card")

    t0 = time.perf_counter()
    rt = Runtime()
    t = g1_table(rows, device)
    t_skew, heavy = skewed_id3(t, device)
    rt.interp.globals[symbols.intern("t")] = t
    rt.interp.globals[symbols.intern("t_skew")] = t_skew
    queries = {name: q for name, (q, _e) in QUERIES.items()}
    queries.update(MESH_QUERIES)
    phase("mesh_table", rows=rows, heavy_rows=heavy,
          seconds=round(time.perf_counter() - t0, 3))

    # the two medians' single-device card answers, held against the host
    want = dict(single)
    for name, q in MESH_QUERIES.items():
        sel.last_profile.clear()
        r = rt.eval_str(q)
        if _mesh_engine(sel.last_profile) != "sortagg":
            raise AssertionError(f"{name}: one device ran "
                                 f"{_mesh_engine(sel.last_profile)}")
        dev.set_enabled(False)
        try:
            t0 = time.perf_counter()
            h = rt.eval_str(q)
            host_s = round(time.perf_counter() - t0, 3)
        finally:
            dev.set_enabled(True)
        groups = same_table(r, h, name)
        want[name] = _columns(r, name)
        phase("match_host", query=name, engine="sortagg", groups=groups,
              host_seconds=host_s)

    os.environ["RAYFORCE_MESH"] = str(MESH_SHARDS)
    dev._mesh_state.update({"mesh": None, "checked": False})
    plain = dist.shard_partials_plain
    dist.shard_partials_plain = no_plain
    try:
        m = dev.mesh()
        if m is None or m.n != MESH_SHARDS:
            raise AssertionError(f"no {MESH_SHARDS}-shard mesh: {m}")
        results, per_query, stats, peak = {}, {}, {}, {}
        scans, scan_per_query, partials, reduces = {}, {}, {}, {}
        dense, dense_per_query, shard_call = {}, {}, []
        psort.LAUNCHES["radix_sort"] = psort.LAUNCHES["seg_scan"] = \
            psort.LAUNCHES["dense_agg"] = \
            psort.LAUNCHES["shard_partials"] = \
            psort.LAUNCHES["shard_reduce"] = 0
        for name, q in queries.items():
            before = dict(psort.LAUNCHES)
            dist.reset_stats()
            sel.last_profile.clear()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            with count_scans(scans), count_dense(
                    dense, shard_call if name == "q4" else None):
                results[name] = rt.eval_str(q)
                _columns(results[name], name)
            torch.cuda.synchronize()
            peak[name] = (torch.cuda.max_memory_allocated() - base) / 2**20
            got = _mesh_engine(sel.last_profile)
            if got != MESH_ENGINES[name]:
                raise AssertionError(f"{name}: mesh engine {got}, not "
                                     f"{MESH_ENGINES[name]}")
            per_query[name] = psort.LAUNCHES["radix_sort"] - \
                before["radix_sort"]
            scan_per_query[name] = psort.LAUNCHES["seg_scan"] - \
                before["seg_scan"]
            dense_per_query[name] = psort.LAUNCHES["dense_agg"] - \
                before["dense_agg"]
            partials[name] = psort.LAUNCHES["shard_partials"] - \
                before["shard_partials"]
            reduces[name] = psort.LAUNCHES["shard_reduce"] - \
                before["shard_reduce"]
            if per_query[name] <= 0:
                raise AssertionError(f"{name}: the CUDA sort never launched")
            # stage A on every shard of each wide group-by kernel call
            # (every dist-group query runs one), in no other engine
            if (partials[name] > 0) != (got == "dist-group") or \
                    partials[name] % MESH_SHARDS:
                raise AssertionError(f"{name} ({got}): {partials[name]} "
                                     "shard_partials calls")
            # reduce and carry in a stage A with a scanned lane alone
            if reduces[name] > partials[name] or \
                    reduces[name] % MESH_SHARDS:
                raise AssertionError(f"{name} ({got}): {reduces[name]} "
                                     "shard_reduce counts")
            stats[name] = dict(dist.stats)
            if got in ("spmd", "dist-group") and \
                    stats[name]["kernel_calls"] <= 0:
                raise AssertionError(f"{name}: no mesh kernel ran")
        torch.cuda.synchronize()
        launches = psort.LAUNCHES["radix_sort"]
        scan_launches = scan_report("mesh", scan_per_query, scans,
                                    SCAN_QUERIES["mesh"])
        dense_launches_ = dense_report("mesh", dense_per_query, dense,
                                       DENSE_QUERIES["mesh"])

        answers = {}
        for name, q in queries.items():
            groups = same_table(results[name], want[name], name)
            runs, walls = [], []
            for i in range(3):
                t0 = time.perf_counter()
                r = rt.eval_str(q)
                force_columns(r)
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t0) * 1e3)
                if i == 0:
                    same_bits(results[name], r, name)
                runs.append(_exec_ms(sel.last_profile))
            answers[name] = {"digest": digest(results[name]),
                             "engine": MESH_ENGINES[name],
                             "exchanged_bytes":
                             stats[name]["exchanged_bytes"],
                             "ms": statistics.median(walls),
                             "scans": scan_per_query[name] > 0,
                             "dense": dense_per_query[name] > 0}
            phase("mesh_ms", query=name, engine=MESH_ENGINES[name],
                  shards=MESH_SHARDS, groups=groups,
                  median_ms=statistics.median(runs), runs=runs,
                  wall_ms=statistics.median(walls),
                  exchanged_bytes=stats[name]["exchanged_bytes"],
                  kernel_calls=stats[name]["kernel_calls"],
                  launches=per_query[name], peak_mb=round(peak[name], 1),
                  shard_partials=partials[name],
                  shard_reduce=reduces[name],
                  equals_single_device=True, bit_identical=True,
                  cards=len(set(m.devices)))
        return launches, per_query, answers, scan_launches, \
            (dense_launches_, shard_call[0][1]), sum(partials.values())
    finally:
        dist.shard_partials_plain = plain
        os.environ.pop("RAYFORCE_MESH", None)
        dev._mesh_state.update({"mesh": None, "checked": False})


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
    query as (words, n_keys, perm), the Runtime, the tables, the scan
    calls of each query as (ids, values, op, reverse), the scan kernel's
    launches in the run)."""
    import numpy as np
    import torch
    from rayforce_tpu_torch import Runtime
    from rayforce_tpu_torch.core import symbols
    from rayforce_tpu_torch.core.obj import col_by_name, to_np
    from rayforce_tpu_torch.engine import groupby as G
    from rayforce_tpu_torch.engine import join as ej
    from rayforce_tpu_torch.engine import psort
    from rayforce_tpu_torch.engine import select as sel
    from rayforce_tpu_torch.engine import sort as es
    from rayforce_tpu_torch.ops import join as oj
    from rayforce_tpu_torch.tools.jtables import JOIN_QUERIES, \
        force_columns, join_tables
    from rayforce_tpu_torch.tools.multiproc_worker import count_scans

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

    per_query, results, calls, scan_calls = {}, {}, {}, {}
    scans, scan_per_query = {}, {}
    real, real_scan = psort.sort_i32_cuda, G.seg_scan_cuda

    def recording(words, n_keys=1, skipped=None, perm=False):
        calls[current].append((list(words), n_keys, perm))
        return real(words, n_keys, skipped, perm)

    def recording_scan(seg_ids, vals, op, reverse=False):
        scan_calls[current].append((seg_ids, vals, op, reverse))
        return real_scan(seg_ids, vals, op, reverse)

    psort.sort_i32_cuda, G.seg_scan_cuda = recording, recording_scan
    psort.LAUNCHES["radix_sort"] = psort.LAUNCHES["seg_scan"] = 0
    try:
        with count_scans(scans):
            for current, (q, engine) in JOIN_QUERIES.items():
                calls[current], scan_calls[current] = [], []
                before = dict(psort.LAUNCHES)
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
                    raise AssertionError(f"{current}: engine {got}, not "
                                         f"{engine}")
                per_query[current] = psort.LAUNCHES["radix_sort"] - \
                    before["radix_sort"]
                scan_per_query[current] = psort.LAUNCHES["seg_scan"] - \
                    before["seg_scan"]
                if per_query[current] <= 0:
                    raise AssertionError(f"{current}: the CUDA sort never "
                                         "launched")
    finally:
        psort.sort_i32_cuda, G.seg_scan_cuda = real, real_scan
    launches = psort.LAUNCHES["radix_sort"]
    scan_launches = scan_report("join", scan_per_query, scans,
                                SCAN_QUERIES["join"])

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
    return launches, per_query, calls, rt, tables, scan_calls, scan_launches


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


def f64_lane_err(name, cname, a, b, spec, tables, against):
    """A window join's f64 sum, avg or dev lane (numpy) held to another
    answer: the same nulls, and within `_wj_tolerance`. spec: the lane's
    WJ_F64_LANES entry. Returns the max abs error (on dev^2 for dev)."""
    import numpy as np
    from rayforce_tpu_torch.core.obj import col_by_name, to_np
    kind, tname, rcol = spec
    if a.dtype != b.dtype or a.shape != b.shape or \
            not np.array_equal(np.isnan(a), np.isnan(b)):
        raise AssertionError(f"{name}: lane {cname} differs from {against} "
                             "in its nulls")
    ok = ~np.isnan(a)
    err = float(np.abs(a[ok] ** 2 - b[ok] ** 2).max()) if kind == "dev" \
        else float(np.abs(a[ok] - b[ok]).max())
    tol = _wj_tolerance(kind, to_np(col_by_name(tables[tname], rcol)))
    if err > tol:
        raise AssertionError(f"{name}: lane {cname} differs from {against} "
                             f"by {err} > {tol}")
    return err


def wjoin_path(rt, tables):
    """Drive the window joins (tools/jtables.py WJOIN_QUERIES) through the
    port's Runtime on bench.py's join tables and hold each against the
    host path and a second card run. Returns (launches of the run,
    launches per query, the sort calls of each query, the scan kernel's
    launches in the run)."""
    import torch
    from rayforce_tpu_torch.core import symbols
    from rayforce_tpu_torch.core.obj import to_np
    from rayforce_tpu_torch.engine import device as dev
    from rayforce_tpu_torch.engine import psort
    from rayforce_tpu_torch.engine import wjoin as ew
    from rayforce_tpu_torch.tools.jtables import WJOIN_QUERIES, \
        force_columns
    from rayforce_tpu_torch.tools.multiproc_worker import count_scans

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

    scans, scan_per_query = {}, {}
    psort.sort_i32_cuda = recording
    psort.LAUNCHES["radix_sort"] = psort.LAUNCHES["seg_scan"] = 0
    try:
        with count_scans(scans):
            for current, q in WJOIN_QUERIES.items():
                calls[current] = []
                before = dict(psort.LAUNCHES)
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
                per_query[current] = psort.LAUNCHES["radix_sort"] - \
                    before["radix_sort"]
                scan_per_query[current] = psort.LAUNCHES["seg_scan"] - \
                    before["seg_scan"]
                if per_query[current] <= 0:
                    raise AssertionError(f"{current}: the CUDA sort never "
                                         "launched")
    finally:
        psort.sort_i32_cuda = real
    launches = psort.LAUNCHES["radix_sort"]
    scan_launches = scan_report("wjoin", scan_per_query, scans, ())

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
                errs[cname] = f64_lane_err(name, cname, a, w, f64[cname],
                                           tables, "the host path")
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
    return launches, per_query, calls, scan_launches


# the exchanged bytes of each mesh join with no capacity retry, from the
# reference's formulas (parallel/dist.py, engine/wjoin.py) at 1e7 rows
MESH_JOIN_BYTES = {"ij": 56_000_000, "lj": 56_000_000,
                   "ij_eq": 465_729_376, "lj_eq": 465_729_376,
                   "ij_eq_skew": 465_729_376, "aj": 2_560_000_000,
                   "xasc": 1_190_086_464, "xdesc": 1_050_057_792,
                   "wj": 1_470_000_000, "wj0": 2_590_000_000}


def mesh_join_path(rows, device):
    """Drive the joins, table sorts and window joins (tools/jtables.py
    MESH_JOIN_QUERIES) over an 8-shard mesh on the card, each held
    against the same query with the mesh off (the single-device card
    answer, which phases 5 and 6 hold against the host path) and a
    second mesh run. Returns (launches of the checked mesh runs, the
    launches per query, per query the mesh answer's digest, exchanged
    bytes, engine, warm wall ms and whether it scanned for phase 10, and
    the scan kernel's launches in the checked mesh runs)."""
    import torch
    from rayforce_tpu_torch import Runtime
    from rayforce_tpu_torch.core import symbols
    from rayforce_tpu_torch.core.obj import col_by_name, to_np
    from rayforce_tpu_torch.engine import device as dev
    from rayforce_tpu_torch.engine import join as ej
    from rayforce_tpu_torch.engine import psort
    from rayforce_tpu_torch.engine import select as sel
    from rayforce_tpu_torch.engine import sort as es
    from rayforce_tpu_torch.engine import wjoin as ew
    from rayforce_tpu_torch.parallel import dist
    from rayforce_tpu_torch.tools.g1 import skewed_id3
    from rayforce_tpu_torch.tools.jtables import MESH_JOIN_QUERIES, \
        force_columns, join_tables
    from rayforce_tpu_torch.tools.multiproc_worker import count_scans, \
        digest

    def no_fallback(e):
        raise AssertionError(f"device path fell back to the host: {e!r}")
    sel.warn_fallback = no_fallback

    t0 = time.perf_counter()
    rt = Runtime()
    tables = join_tables(rows, device)
    tables["t_skew"], heavy = skewed_id3(tables["t"], device)
    for name, tbl in tables.items():
        rt.interp.globals[symbols.intern(name)] = tbl
    phase("mesh_join_tables", seconds=round(time.perf_counter() - t0, 3),
          heavy_rows=heavy)

    def set_mesh(n):
        if n:
            os.environ["RAYFORCE_MESH"] = str(n)
        else:
            os.environ.pop("RAYFORCE_MESH", None)
        dev._mesh_state.update({"mesh": None, "checked": False})
        m = dev.mesh()
        if (m.n if m is not None else 0) != n:
            raise AssertionError(f"no {n}-shard mesh: {m}")
        return m

    def run(q):
        out = rt.eval_str(q)
        lanes = force_columns(out)
        torch.cuda.synchronize()
        return out, lanes

    def ids(q):
        """The query's match ids or row order, or None (window joins)."""
        if q.startswith("(x"):
            head, tbl, *keys = q[1:-1].translate(
                str.maketrans("[]'", "   ")).split()
            return es.table_order_device(
                [col_by_name(tables[tbl], k) for k in keys],
                head == "xdesc")
        if q.startswith("(window"):
            return None
        head, keys, left, right = _join_parts(q)
        lk = [col_by_name(tables[left], k) for k in keys]
        rk = [col_by_name(tables[right], k) for k in keys]
        if head == "asof-join":
            return ej.match_ids_device(lk[:-1], rk[:-1], ltime=lk[-1],
                                       rtime=rk[-1], mode="asof")
        return ej.match_ids_device(lk, rk)

    def engine(q):
        prof = es.last_profile if q.startswith("(x") else \
            ew.last_profile if q.startswith("(window") else ej.last_profile
        return prof.get("engine")

    launches, per_query, answers = 0, {}, {}
    scans, scan_per_query = {}, {}
    saved_bmax = dev._cfg["bcast_max"]
    try:
        for name, (q, want_engine, bmax) in MESH_JOIN_QUERIES.items():
            dev._cfg["bcast_max"] = saved_bmax if bmax is None else bmax
            set_mesh(0)
            _out, single = run(q)
            single_ids = ids(q)
            one_runs = []
            for _ in range(3):
                t0 = time.perf_counter()
                del _out
                _out, _lanes = run(q)
                one_runs.append((time.perf_counter() - t0) * 1e3)
            del _out, _lanes
            cards = len(set(set_mesh(MESH_SHARDS).devices))
            for mod in (ej, es, ew):
                mod.last_profile.clear()
            dist.reset_stats()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            psort.LAUNCHES["radix_sort"] = psort.LAUNCHES["seg_scan"] = 0
            with count_scans(scans):
                out, lanes = run(q)
            per_query[name] = psort.LAUNCHES["radix_sort"]
            scan_per_query[name] = psort.LAUNCHES["seg_scan"]
            launches += per_query[name]
            peak = (torch.cuda.max_memory_allocated() - base) / 2**20
            stats = dict(dist.stats)
            got = engine(q)
            if got != want_engine:
                raise AssertionError(f"{name}: mesh engine {got}, not "
                                     f"{want_engine}")
            if per_query[name] <= 0:
                raise AssertionError(f"{name}: the CUDA sort never launched")
            if stats["kernel_calls"] <= 0 or (
                    stats["kernel_calls"] == 1 and
                    stats["exchanged_bytes"] != MESH_JOIN_BYTES[name]):
                raise AssertionError(f"{name}: exchange {stats}, not "
                                     f"{MESH_JOIN_BYTES[name]} bytes")
            # against the single-device card answer
            if single_ids is not None and \
                    not torch.equal(ids(q), single_ids):
                raise AssertionError(f"{name}: match ids or order differ "
                                     "from one device")
            names = [symbols.name_of(int(x)) for x in to_np(out.v[0])]
            f64 = WJ_F64_LANES.get(name, {})
            errs = {}
            for cname, g, w in zip(names, lanes, single):
                if cname in f64:
                    errs[cname] = f64_lane_err(
                        name, cname, g[0].cpu().numpy(), w[0].cpu().numpy(),
                        f64[cname], tables, "one device")
                    continue
                for a, b in zip(g, w):
                    if a.dtype != b.dtype or a.shape != b.shape or \
                            not torch.equal(a.view(torch.uint8),
                                            b.view(torch.uint8)):
                        raise AssertionError(f"{name}: column {cname} "
                                             "differs from one device")
            del single, single_ids
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
                                raise AssertionError(f"{name}: mesh runs "
                                                     "differ")
                else:
                    runs.append(ms)
                del _out, again
            phase("mesh_join_ms", query=name, engine=got, shards=MESH_SHARDS,
                  rows=len(out), median_ms=statistics.median(runs),
                  runs=runs, one_device_ms=statistics.median(one_runs),
                  exchanged_bytes=stats["exchanged_bytes"],
                  kernel_calls=stats["kernel_calls"],
                  launches=per_query[name], peak_mb=round(peak, 1),
                  max_abs_err=json.dumps(errs, separators=(",", ":")),
                  equals_single_device=True, bit_identical=True,
                  cards=cards)
            answers["mj_" + name] = {
                "digest": digest(out), "engine": got,
                "exchanged_bytes": stats["exchanged_bytes"],
                "ms": statistics.median(runs),
                "scans": scan_per_query[name] > 0}
            del out, lanes
        scan_launches = scan_report("mesh_join", scan_per_query, scans,
                                    SCAN_QUERIES["mesh_join"])
        return launches, per_query, answers, scan_launches
    finally:
        dev._cfg["bcast_max"] = saved_bmax
        set_mesh(0)


MP_RANKS = 2


def multiproc_path(rows, answers):
    """Phase 10: MP_RANKS processes (rayforce_tpu_torch/tools/
    multiproc_worker.py, started by its `launch`) form one MESH_SHARDS-
    shard mesh on this host's cards over torch.distributed, with the
    backend `engine/device.py` `backend_for` names; each makes the G1 and
    join tables at `rows` rows from phase 8's and 9's seeds and runs every
    query of `answers` (phase 8's and 9's one-process mesh answers) once
    and twice more timed. Each query must run the one-process mesh's
    engine, note its exchanged bytes, launch the CUDA sort on every rank
    (and the scan kernel, where the one-process mesh's run did) and give
    its answer bit for bit (the digest of every column) on every rank and
    every run; where the one-process mesh's run launched the dense kernel,
    every rank's must too, and none may run its plain version. Returns
    (the ranks' sort launches of the checked runs, per query, their scan
    kernel launches and their dense kernel launches)."""
    import torch
    from rayforce_tpu_torch.engine.device import backend_for
    from rayforce_tpu_torch.tools import multiproc_worker as W

    backend = backend_for(torch.device("cuda"), MP_RANKS)
    t0 = time.perf_counter()
    outs = W.launch(MP_RANKS, MESH_SHARDS,
                    ["--rows", str(rows), "--reps", "2", "--timeout", "180",
                     "--queries", ",".join(answers)], timeout=480)
    seconds = round(time.perf_counter() - t0, 3)
    recs = []
    for rank, (out, _err) in enumerate(outs):
        if not out.rstrip().endswith("MULTIPROC_OK"):
            raise AssertionError(f"rank {rank} did not finish:\n{out[-2000:]}")
        recs.append(W.records(out))
    per = MESH_SHARDS // MP_RANKS
    for rank, r in enumerate(recs):
        head = r[0]
        if (head["world"], head["rank"], head["shards"], head["local"],
                head["backend"]) != (MP_RANKS, rank, MESH_SHARDS,
                                     [rank * per, (rank + 1) * per],
                                     backend):
            raise AssertionError(f"rank {rank}: mesh {head}")
    colls = [next(x["collectives"] for x in r if "collectives" in x)
             for r in recs]
    if any(c != colls[0] for c in colls):
        raise AssertionError("the ranks' collectives differ")
    phase("multiproc", ranks=MP_RANKS, shards=MESH_SHARDS, backend=backend,
          devices=json.dumps([r[0]["device"] for r in recs]),
          tables_s=json.dumps([round(next(x["tables_s"] for x in r
                                          if "tables_s" in x), 3)
                               for r in recs]),
          seconds=seconds)
    queries = [{x["query"]: x for x in r if "query" in x} for r in recs]
    launches, per_query, faults = 0, {}, []
    scans, scan_per_query = {}, {}
    dense, dense_per_query = {}, {}
    for name, want in answers.items():
        got = [q[name] for q in queries]
        for rank, g in enumerate(got):
            if g["engine"] != want["engine"]:
                faults.append(f"{name}: rank {rank} ran {g['engine']}, not "
                              f"{want['engine']}")
            if g["digest"] != want["digest"]:
                faults.append(f"{name}: rank {rank}'s answer is not the "
                              "one-process mesh's, bit for bit")
            if not g["reruns_equal"]:
                faults.append(f"{name}: rank {rank}'s reruns differ")
            if g["exchanged_bytes"] != want["exchanged_bytes"]:
                faults.append(f"{name}: rank {rank} noted "
                              f"{g['exchanged_bytes']} bytes, not "
                              f"{want['exchanged_bytes']}")
            if g["launches"] <= 0:
                faults.append(f"{name}: rank {rank} never launched the "
                              "CUDA sort")
            if want["scans"] and g["seg_scan_launches"] <= 0:
                faults.append(f"{name}: rank {rank} never launched the "
                              "scan kernel")
            for k, c in g["seg_scan_shapes"].items():
                scans[k] = scans.get(k, 0) + c
            if want.get("dense") and g["dense_agg_launches"] <= 0:
                faults.append(f"{name}: rank {rank} never launched the "
                              "dense kernel")
            for k, c in g["dense_agg_shapes"].items():
                dense[k] = dense.get(k, 0) + c
        per_query[name] = sum(g["launches"] for g in got)
        scan_per_query[name] = sum(g["seg_scan_launches"] for g in got)
        dense_per_query[name] = sum(g["dense_agg_launches"] for g in got)
        launches += per_query[name]
        mesh_ms = max(statistics.median(g["ms"]) for g in got)
        wire_ms = max(g["wire"]["seconds"] for g in got) * 1e3
        phase("multiproc_ms", query=name, engine=want["engine"],
              ranks=MP_RANKS, shards=MESH_SHARDS, backend=backend,
              mesh_ms=round(mesh_ms, 3),
              one_process_mesh_ms=round(want["ms"], 3),
              runs=json.dumps([[round(x, 3) for x in g["ms"]]
                               for g in got]),
              exchanged_bytes=want["exchanged_bytes"],
              wire_calls=got[0]["wire"]["calls"],
              wire_bytes=int(got[0]["wire"]["bytes"]),
              wire_ms=round(wire_ms, 3),
              launches=json.dumps([g["launches"] for g in got]),
              peak_mb=json.dumps([round(g["peak_mb"], 1) for g in got]),
              equals_one_process_mesh=all(g["digest"] == want["digest"]
                                          for g in got),
              bit_identical=all(g["reruns_equal"] for g in got))
    if faults:
        raise AssertionError("\n".join(faults))
    scan_launches = scan_report(
        "multiproc", scan_per_query, scans,
        [name for name, want in answers.items() if want["scans"]])
    dense_launches_ = dense_report(
        "multiproc", dense_per_query, dense,
        [name for name, want in answers.items() if want.get("dense")])
    return launches, per_query, scan_launches, dense_launches_


PARTS = 10


def parted_path(rows, device):
    """Write the G1 table as PARTS date partitions into a temporary
    directory, open it with get_parted, and run tools/g1.py
    PARTED_QUERIES over it, streaming partition by partition and razed,
    each held against the port's host path over the parted table.
    Returns (launches of the checked run of each query and mode, the
    launches per query and mode, the dense kernel's launches in the
    checked runs); the timed reruns are not counted. The dense runs
    (DENSE_QUERIES["parted"]: query_mode) must launch the dense kernel
    and no query may run its plain version."""
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
    from rayforce_tpu_torch.tools.multiproc_worker import count_dense

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

        per_query, dense, dense_per_query = {}, {}, {}
        psort.LAUNCHES["radix_sort"] = psort.LAUNCHES["dense_agg"] = 0
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
                before = dict(psort.LAUNCHES)
                sel.try_select_device = watched
                try:
                    with count_dense(dense):
                        got = run(q)
                finally:
                    sel.try_select_device = real
                per_query[f"{name}_{mode}"] = \
                    psort.LAUNCHES["radix_sort"] - before["radix_sort"]
                dense_per_query[f"{name}_{mode}"] = \
                    psort.LAUNCHES["dense_agg"] - before["dense_agg"]
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
        dense_launches_ = dense_report("parted", dense_per_query, dense,
                                       DENSE_QUERIES["parted"])
        return sum(per_query.values()), per_query, dense_launches_
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
    """Port device result == port host result (or another run's columns,
    as `_columns` gives them): names, keys, group order, integer lanes
    exactly; f64 lanes within rtol 1e-9."""
    import numpy as np
    from rayforce_tpu_torch.core import types as T
    gn, gc = _columns(got, name)
    wn, wc = want if isinstance(want, tuple) else _columns(want, name)
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
    integer lanes exactly, f64 lanes within rtol 1e-9. The card's step
    must launch the dense kernel once and never run its plain version.
    Returns (lanes, the dense kernel's launches, its call)."""
    from rayforce_tpu_torch.engine import psort
    from rayforce_tpu_torch.entry import entry
    from rayforce_tpu_torch.tools.multiproc_worker import count_dense
    step, args = entry()
    if any(a.device.type != "cuda" for a in args):
        raise AssertionError("entry() did not put its arguments on the card")
    dense, calls = {}, []
    psort.LAUNCHES["dense_agg"] = 0
    with count_dense(dense, calls):
        got = [x.cpu() for x in step(*args)]
    launches = dense_report("entry", {"step": psort.LAUNCHES["dense_agg"]},
                            dense, ["step"])
    if launches != 1:
        raise AssertionError(f"entry: {launches} dense launches, not 1")
    want = step(*[a.cpu() for a in args])
    for i, (g, w) in enumerate(zip(got, want)):
        if g.dtype != w.dtype or g.shape != w.shape:
            raise AssertionError(f"entry lane {i}: {g.dtype} {g.shape} "
                                 f"!= {w.dtype} {w.shape}")
        if g.dtype == torch.float64:
            torch.testing.assert_close(g, w, rtol=1e-9, atol=0)
        elif not torch.equal(g, w):
            raise AssertionError(f"entry lane {i} differs")
    return len(got), launches, calls[0][1]


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
    from rayforce_tpu_torch.core import types as T
    from rayforce_tpu_torch.engine import groupby as G
    from rayforce_tpu_torch.engine import sortagg as S
    from rayforce_tpu_torch.engine import wide as W
    from rayforce_tpu_torch.parallel import dist
    from rayforce_tpu_torch.tools import denseparts
    from rayforce_tpu_torch.tools.sortprof import seg_scan_shapes

    # 1. card
    card = card_line()
    phase("card", name=torch.cuda.get_device_name(0),
          count=torch.cuda.device_count())
    print(card, flush=True)
    dev.set_device("cuda")
    result = json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}})

    # 2. build: one nvcc for each kernel family, all started together
    t0 = time.perf_counter()
    cubuild.build(["radix_sort", "seg_scan", "dense_agg", "wide_keys",
                   "shard_partials", "sortagg_keys"])
    psort._radix_lib()
    G._seg_lib()
    G._dense_lib()
    W._wide_keys_lib()
    dist._shard_partials_lib()
    S._sortagg_keys_lib()
    phase("build", kernels="radix_sort,seg_scan,dense_agg,wide_keys,"
          "shard_partials,sortagg_keys",
          seconds=round(time.perf_counter() - t0, 3),
          nvcc_seconds=json.dumps(cubuild.build_seconds))

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
    t0 = time.perf_counter()
    scan_cases, scan_routes = check_seg_scan(G, torch, gen)
    phase("kernels", seg_scan="equal", sizes=list(SCAN_SIZES),
          cases=scan_cases, repeats=SCAN_REPEATS,
          routes=json.dumps(scan_routes, separators=(",", ":")),
          max_abs_err=0, seconds=round(time.perf_counter() - t0, 3))
    scan_times = [time_scan(G, torch, *shape)
                  for shape in seg_scan_shapes(torch, ROWS)]
    for r in scan_times:
        phase("seg_scan_time", **r)
    t0 = time.perf_counter()
    dense_cases = check_dense_agg(G, torch, gen)
    phase("kernels", dense_agg="equal", sizes=list(DENSE_SIZES),
          codes=list(DENSE_CODES), cases=dense_cases,
          repeats=DENSE_REPEATS, max_abs_err=0,
          seconds=round(time.perf_counter() - t0, 3))
    dense_times = [time_dense(G, psort, torch, name, call) for name, call
                   in denseparts._synthetic(torch, ROWS).items()]
    for r in dense_times:
        phase("dense_time", **r)

    t0 = time.perf_counter()
    wide_cases = check_wide_keys(W, T, psort, torch, gen)
    phase("kernels", wide_keys="equal", sizes=list(SORT_SIZES),
          plans="q7,three_where", cases=wide_cases, max_abs_err=0,
          seconds=round(time.perf_counter() - t0, 3))
    wide_times = time_wide_keys(W, T, psort, torch, gen)
    for r in wide_times:
        phase("wide_keys_time", **r)
    t0 = time.perf_counter()
    shard_cases = check_shard_partials(dist, psort, torch, gen)
    phase("kernels", shard_partials="equal",
          sizes=sorted({c[0] for c in SHARD_CASES}), cases=shard_cases,
          against="plain,parent", max_abs_err=0,
          seconds=round(time.perf_counter() - t0, 3))
    shard_times = time_shard_partials(dist, psort, G, torch, gen)
    for r in shard_times:
        phase("shard_partials_time", **r)
    t0 = time.perf_counter()
    sk_cases = check_sortagg_keys(S, T, psort, torch, gen)
    phase("kernels", sortagg_keys="equal", sizes=list(SORTAGG_KEY_SIZES),
          plans="q3_exact,q5_exact,q6_exact,head_two_keys_where,"
          "head_i64_key,operands_where", cases=sk_cases, max_abs_err=0,
          seconds=round(time.perf_counter() - t0, 3))
    sk_times = time_sortagg_keys(S, torch, SORTAGG_KEY_SIZES[-1])
    for r in sk_times:
        phase("sortagg_keys_time", **r)

    # 4. the main path at full size
    main_launches, per_query, _ms, shapes, single, main_scans, \
        (main_dense, dense_calls), main_wide, main_sk = main_path(ROWS,
                                                                 "cuda")
    phase("main_path", launches=main_launches, seg_scan_launches=main_scans,
          dense_agg_launches=main_dense, wide_keys_launches=main_wide,
          sortagg_keys_launches=main_sk,
          per_query=json.dumps(per_query, separators=(",", ":")))
    for name, call in dense_calls.items():
        r = time_dense(G, psort, torch, name, call)
        dense_times.append(r)
        phase("dense_time", **r)
    del dense_calls
    phase("sort_shapes", calls=json.dumps(
        [{"rows": n, "key_words": k, "words": m, "launches": c}
         for (n, k, m), c in sorted(shapes.items())],
        separators=(",", ":")))

    # 5. the joins and table sorts at the bench's sizes
    join_launches, join_per_query, calls, rt, tables, scan_calls, \
        join_scans = join_path(ROWS, "cuda")
    phase("join_path", launches=join_launches, seg_scan_launches=join_scans,
          per_query=json.dumps(join_per_query, separators=(",", ":")))
    for r in time_join_sorts(psort, torch, calls):
        phase("sort_time", **r)
    # lj scans the ids and values ij scans
    for name in ("ij", "aj"):
        for ids, vals, op, rev in scan_calls[name]:
            r = time_scan(G, torch, name, ids, vals, op, rev)
            scan_times.append(r)
            phase("seg_scan_time", **r)
    del calls, scan_calls

    # 6. the window joins on the same tables
    wj_launches, wj_per_query, calls, wj_scans = wjoin_path(rt, tables)
    phase("wjoin_path", launches=wj_launches, seg_scan_launches=wj_scans,
          per_query=json.dumps(wj_per_query, separators=(",", ":")))
    for r in time_join_sorts(psort, torch, calls):
        phase("sort_time", **r)
    del calls, rt, tables
    torch.cuda.empty_cache()

    # 7. parted selects, streamed and razed
    parted_launches, parted_per_query, parted_dense = parted_path(ROWS,
                                                                  "cuda")
    phase("parted_path", launches=parted_launches,
          dense_agg_launches=parted_dense,
          per_query=json.dumps(parted_per_query, separators=(",", ":")))

    # 8. the grouped selects over an 8-shard mesh on the card
    torch.cuda.empty_cache()
    mesh_launches, mesh_per_query, answers, mesh_scans, \
        (mesh_dense, shard_call), mesh_partials = mesh_path(ROWS, "cuda",
                                                           single)
    phase("mesh_path", launches=mesh_launches, shards=MESH_SHARDS,
          seg_scan_launches=mesh_scans, dense_agg_launches=mesh_dense,
          shard_partials_calls=mesh_partials,
          per_query=json.dumps(mesh_per_query, separators=(",", ":")))
    r = time_dense(G, psort, torch, "mesh_q4_shard", shard_call)
    dense_times.append(r)
    phase("dense_time", **r)
    del shard_call
    del single
    torch.cuda.empty_cache()

    # 9. the joins, table sorts and window joins over the 8-shard mesh
    mj_launches, mj_per_query, mj_answers, mj_scans = mesh_join_path(
        ROWS, "cuda")
    phase("mesh_join_path", launches=mj_launches, shards=MESH_SHARDS,
          seg_scan_launches=mj_scans,
          per_query=json.dumps(mj_per_query, separators=(",", ":")))
    answers.update(mj_answers)
    torch.cuda.empty_cache()

    # 10. the same mesh over MP_RANKS processes
    mp_launches, mp_per_query, mp_scans, mp_dense = multiproc_path(
        ROWS, answers)
    phase("multiproc_path", launches=mp_launches, ranks=MP_RANKS,
          shards=MESH_SHARDS, seg_scan_launches=mp_scans,
          dense_agg_launches=mp_dense,
          per_query=json.dumps(mp_per_query, separators=(",", ":")))

    # 11. the flagship step
    lanes, entry_dense, entry_call = check_entry(torch)
    phase("entry", lanes=lanes, card_equals_cpu=True,
          dense_agg_launches=entry_dense)
    r = time_dense(G, psort, torch, "entry", entry_call)
    dense_times.append(r)
    phase("dense_time", **r)

    # 12. report
    main = next(r for r in times if r["shape"] == "sortagg_2w")
    scan = next(r for r in scan_times if r["shape"] == "q5_i64_sum")
    dense = next(r for r in dense_times if r["shape"] == "q1")
    q5_shard = next(r for r in shard_times if r["shape"] == "q5")
    kernels = [{
        "name": "radix_sort",
        "route": "cuda",
        "source": "rayforce_tpu_torch/engine/csrc/radix_sort.cu",
        "replaces": "rayforce_tpu/engine/psort.py:251 (_block_kernel), "
                    "rayforce_tpu/engine/psort.py:284 "
                    "(_window_pass_kernel)",
        "launches": main_launches + join_launches + wj_launches +
        parted_launches + mesh_launches + mj_launches + mp_launches,
        "max_abs_err": err,
        "ms": main["ms"],
        "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"],
        "bound_by": "bytes",
        "library_ms": main["library_ms"],
    }, {
        "name": "seg_scan",
        "route": "cuda",
        "source": "rayforce_tpu_torch/engine/csrc/seg_scan.cu",
        "replaces": "rayforce_tpu/engine/groupby.py:281 (_seg_scan, jnp "
                    "under jax.jit)",
        "launches": main_scans + join_scans + wj_scans + mesh_scans +
        mj_scans + mp_scans,
        "max_abs_err": 0,
        "ms": scan["ms"],
        "plain_ms": scan["plain_ms"],
        "bound_ms": scan["bound_ms"],
        "bound_by": "bytes",
        "library_ms": scan["library_ms"],
    }, {
        "name": "dense_agg",
        "route": "cuda",
        "source": "rayforce_tpu_torch/engine/csrc/dense_agg.cu",
        "replaces": "rayforce_tpu/engine/groupby.py:168 (bcast_scan), :89 "
                    "(matmul_tasks_scan), jnp under jax.jit",
        "launches": main_dense + parted_dense + mesh_dense + mp_dense +
        entry_dense,
        "max_abs_err": 0,
        "ms": dense["ms"],
        "plain_ms": dense["plain_ms"],
        "bound_ms": dense["bound_ms"],
        "bound_by": "bytes",
        "library_ms": dense["library_ms"],
    }, {
        "name": "wide_keys",
        "route": "cuda",
        "source": "rayforce_tpu_torch/engine/csrc/wide_keys.cu",
        "replaces": "none: rayforce_tpu/engine/wide.py pipeline's key "
                    "arithmetic, jnp under jax.jit (q7: pack + bound + "
                    "decode)",
        "launches": main_wide,
        "max_abs_err": 0,
        "ms": sum(r["ms"] for r in wide_times if r["plan"] == "q7"),
        "plain_ms": sum(r["plain_ms"] for r in wide_times
                        if r["plan"] == "q7"),
        "bound_ms": sum(r["bound_ms"] for r in wide_times
                        if r["plan"] == "q7"),
        "bound_by": "bytes",
        "library_ms": None,
    }, {
        "name": "shard_partials",
        "route": "cuda",
        "source": "rayforce_tpu_torch/engine/csrc/shard_partials.cu",
        "replaces": "none: rayforce_tpu/parallel/dist.py "
                    "dist_wide_groupby's stage A, jnp under jax.jit (the "
                    "mesh's q5 shard at 2.5e8 rows: keys, reduce, carry, "
                    "runs, place)",
        "launches": mesh_partials,
        "max_abs_err": 0,
        "ms": q5_shard["ms"],
        "plain_ms": q5_shard["plain_ms"],
        "bound_ms": q5_shard["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
    }, {
        "name": "sortagg_keys",
        "route": "cuda",
        "source": "rayforce_tpu_torch/engine/csrc/sortagg_keys.cu",
        "replaces": "none: rayforce_tpu/engine/sortagg.py pipeline's key "
                    "arithmetic, jnp under jax.jit (q5's exact plan at 1e8 "
                    "rows: pack + read)",
        "launches": main_sk,
        "max_abs_err": 0,
        "ms": sum(r["ms"] for r in sk_times if r["query"] == "q5"),
        "plain_ms": sum(r["plain_ms"] for r in sk_times
                        if r["query"] == "q5"),
        "bound_ms": sum(r["bound_ms"] for r in sk_times
                        if r["query"] == "q5"),
        "bound_by": "bytes",
        "library_ms": None,
    }]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(result, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
