"""One rank of a multi-process device mesh, and the launcher that starts
the ranks on one host.

    RAYFORCE_COORDINATOR=127.0.0.1:29500 RAYFORCE_NUM_PROCS=2 \\
    RAYFORCE_PROC_ID=0 RAYFORCE_MESH=8 \\
    python -m rayforce_tpu_torch.tools.multiproc_worker --rows 20000

(and the same with RAYFORCE_PROC_ID=1; `launch` starts both). The rank
joins the mesh through `engine/device.py` `mesh()`, checks the raw mesh
kernels against numpy (entry.py `check_kernels`, `check_probes`), runs
the collectives on seeded shards (`collective_cases`), then every query of
`QUERIES` through the interpreter: the grouped selects of the dense plan
and the mesh group-by, the medians, the join probes, the table sorts and
the window joins, over tools/jtables.py's tables at `--rows` rows. Each
result is printed as one line `MP {json}`: the engine it ran, the
modelled exchanged bytes (parallel/dist.py `stats`), the radix sort's,
the segmented scan's and the dense aggregate's launches, the scan's and
the dense aggregate's calls by shape, the formatted output, a digest
of every column's bytes, the wall times and whether every rerun gave
the same bytes. The last line
is MULTIPROC_OK.
"""
from __future__ import annotations

import argparse
import contextlib
import hashlib
import json
import math
import os
import socket
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

def _queries():
    """name -> (runtime, query, the profile its engine is read from,
    bcast_max or None for the default). Runtime "a" holds entry.py's
    dryrun tables (the reference worker's selects, a sort and a window
    join), "j" tools/jtables.py's tables with t_skew."""
    from ..entry import DRYRUN_QUERIES
    from .g1 import MESH_QUERIES, QUERIES as G1_QUERIES
    from .jtables import MESH_JOIN_QUERIES
    out = {name: ("a", q, kind, None)
           for name, q, _eng, kind in DRYRUN_QUERIES}
    out.update((name, ("j", q, "select", None))
               for name, (q, _e) in G1_QUERIES.items())
    out.update((name, ("j", q, "select", None))
               for name, q in MESH_QUERIES.items())
    for name, (q, _e, bmax) in MESH_JOIN_QUERIES.items():
        kind = "sort" if q.startswith("(x") else \
            "wjoin" if q.startswith("(window") else "join"
        out["mj_" + name] = ("j", q, kind, bmax)
    return out


QUERIES = _queries()


def digest_tensor(x) -> str:
    h = hashlib.sha256(f"{x.dtype}{tuple(x.shape)}".encode())
    h.update(x.detach().cpu().contiguous().view(torch.uint8).numpy()
             .tobytes())
    return h.hexdigest()


def digest(tbl) -> str:
    """A digest of a result table: its column names (as text: symbol ids
    follow each process's interning order) and every column's type and
    bytes on the device (each lazy column forced; a right-only LIST
    column as its values and match mask)."""
    from ..core import symbols
    from ..core.obj import to_np
    from .jtables import force_columns
    h = hashlib.sha256(" ".join(symbols.name_of(int(s))
                                for s in to_np(tbl.v[0])).encode())
    for c, lanes in zip(tbl.v[1], force_columns(tbl)):
        h.update(str(c.t).encode())
        for x in lanes:
            h.update(digest_tensor(x).encode())
    return h.hexdigest()


def collective_cases(m) -> dict:
    """{name: digest} of each collective of parallel/dist.py over seeded
    per-shard tensors (shard d's from seed d), read back whole: the
    replicated value, or the per-shard outputs unsharded."""
    from ..parallel import dist
    n = m.n
    dv = next(d for d in m.devices if d is not None)

    def shards(seed, fn):
        return [fn(torch.Generator().manual_seed(seed * 1000 + d)).to(dv)
                if d in m.local else None for d in range(n)]

    def f64(k):
        return lambda g: torch.rand(k, generator=g, dtype=torch.float64) \
            * 1e3 - 500.0

    def i64(k):
        return lambda g: torch.randint(-10**12, 10**12, (k,), generator=g)

    out = {
        "psum": dist.here(dist.psum(shards(1, f64(257)))),
        "pmin": dist.here(dist.pmin(shards(2, i64(33)))),
        "pmax": dist.here(dist.pmax(shards(3, f64(33)))),
        "all_gather": dist.here(dist.all_gather(shards(4, i64(7)))),
        "unshard": dist.unshard(shards(5, f64(11)), n * 11 - 3),
        "all_to_all": dist.unshard(dist.all_to_all(shards(6, f64(n * 5))),
                                   n * n * 5),
        "all_to_all_bool": dist.unshard(dist.all_to_all(shards(
            7, lambda g: torch.rand(n * 3, generator=g) < 0.5)), n * n * 3),
        "rotate": dist.unshard(dist.rotate(shards(8, i64(13))), n * 13),
    }
    return {k: digest_tensor(v) for k, v in out.items()}


def load_tables(rows, device) -> dict:
    """{runtime name: Runtime} with the tables of QUERIES, made from
    seeds on `device`."""
    from .. import Runtime
    from ..core import symbols
    from ..entry import dryrun_tables
    from .g1 import skewed_id3
    from .jtables import join_tables
    ra, rj = Runtime(), Runtime()
    tables = join_tables(rows, device)
    tables["t_skew"], _heavy = skewed_id3(tables["t"], device)
    for name, tbl in tables.items():
        rj.interp.globals[symbols.intern(name)] = tbl
    rng = np.random.default_rng(0)
    for name, tbl in dryrun_tables(rng, 8).items():
        ra.interp.globals[symbols.intern(name)] = tbl
    return {"a": ra, "j": rj}


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def timed(rt, q, device):
    """(result, wall ms) of one query with every lazy column forced and
    the device synchronised."""
    from .jtables import force_columns
    t0 = time.perf_counter()
    out = rt.eval_str(q)
    force_columns(out)
    _sync(device)
    return out, (time.perf_counter() - t0) * 1e3


@contextlib.contextmanager
def count_scans(shapes):
    """Count, in `shapes`, each call of the segmented scan by "rows x
    lanes dtype op", with " rev" added for reverse and " plain" for a
    call of the plain version."""
    from ..engine import groupby as G
    real = G.seg_scan_cuda, G.seg_scan_plain

    def counted(fn, tag):
        def f(seg_ids, vals, op, reverse=False):
            k = f"{int(vals.shape[0])}x{math.prod(vals.shape[1:])} " \
                f"{str(vals.dtype)[6:]} {op}{' rev' if reverse else ''}{tag}"
            shapes[k] = shapes.get(k, 0) + 1
            return fn(seg_ids, vals, op, reverse)
        return f
    G.seg_scan_cuda = counted(real[0], "")
    G.seg_scan_plain = counted(real[1], " plain")
    try:
        yield shapes
    finally:
        G.seg_scan_cuda, G.seg_scan_plain = real


_COUNT_LOCK = threading.Lock()


@contextlib.contextmanager
def count_dense(shapes, calls=None):
    """Count, in `shapes`, each call of the dense aggregate by "rows x
    cells: lanes (routes)" (the ops of its lanes: int, fsum, min, max;
    how the kernel reads the codes and the lanes, groupby
    `dense_load_route`), with " plain" added for a call of the plain
    version; parted selects call from worker threads. `calls`, a list,
    also gets (key, args, kwargs) of every kernel call."""
    from ..engine import groupby as G
    real = G.dense_agg_cuda, G.dense_agg_plain

    def counted(fn, tag):
        def f(codes, n_cells, n_rows, ints=(), fsums=(), mins=(), maxs=(),
              *a, **k):
            lanes = " ".join(f"{op}{len(x)}" for op, x in (
                ("int", ints), ("fsum", fsums), ("min", mins),
                ("max", maxs)) if x)
            routes = "codes " + G.dense_load_route(codes, True)
            vals = list(ints) + list(fsums) + list(mins) + list(maxs)
            if vals:
                routes += ", lanes " + "+".join(sorted(
                    {G.dense_load_route(x) for x in vals}))
            key = f"{n_rows}x{n_cells}: {lanes or '-'} ({routes}){tag}"
            with _COUNT_LOCK:
                shapes[key] = shapes.get(key, 0) + 1
                if calls is not None and not tag:
                    calls.append((key, (codes, n_cells, n_rows, ints, fsums,
                                        mins, maxs) + a, k))
            return fn(codes, n_cells, n_rows, ints, fsums, mins, maxs, *a,
                      **k)
        return f
    G.dense_agg_cuda = counted(real[0], "")
    G.dense_agg_plain = counted(real[1], " plain")
    try:
        yield shapes
    finally:
        G.dense_agg_cuda, G.dense_agg_plain = real


def run_query(rts, name, reps=1, device="cpu") -> dict:
    """QUERIES[name] once, recorded, then `reps` timed reruns, each held
    to the first run's bytes."""
    from ..core.fmt import format_top
    from ..engine import device as dev
    from ..engine import join as ej
    from ..engine import psort
    from ..engine import select as sel
    from ..engine import sort as es
    from ..engine import wjoin as ew
    from ..entry import engine_of
    from ..parallel import dist
    rt_name, q, kind, bmax = QUERIES[name]
    rt = rts[rt_name]
    saved = dev._cfg["bcast_max"]
    if bmax is not None:
        dev._cfg["bcast_max"] = bmax
    try:
        for prof in (sel.last_profile, ej.last_profile, es.last_profile,
                     ew.last_profile):
            prof.clear()
        dist.reset_stats()
        psort.LAUNCHES["radix_sort"] = psort.LAUNCHES["seg_scan"] = \
            psort.LAUNCHES["dense_agg"] = 0
        shapes, dense = {}, {}
        with count_scans(shapes), count_dense(dense):
            out, first_ms = timed(rt, q, device)
        rec = {"query": name,
               "engine": engine_of(kind),
               "exchanged_bytes": dist.stats["exchanged_bytes"],
               "kernel_calls": dist.stats["kernel_calls"],
               "launches": psort.LAUNCHES["radix_sort"],
               "seg_scan_launches": psort.LAUNCHES["seg_scan"],
               "seg_scan_shapes": shapes,
               "dense_agg_launches": psort.LAUNCHES["dense_agg"],
               "dense_agg_shapes": dense,
               "digest": digest(out), "out": format_top(out),
               "rows": len(out)}
        del out
        ms, same = [], True
        wire0 = dict(dist.wire)
        for _ in range(reps):
            again, t = timed(rt, q, device)
            ms.append(t)
            same = same and digest(again) == rec["digest"]
            del again
        rec.update(first_ms=first_ms, ms=ms, reruns_equal=same)
        if reps:
            rec["wire"] = {k: (dist.wire[k] - wire0[k]) / reps
                           for k in wire0}
        return rec
    finally:
        dev._cfg["bcast_max"] = saved


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", type=int, default=20_000,
                    help="rows of the G1 and join tables")
    ap.add_argument("--reps", type=int, default=1,
                    help="timed reruns of each query")
    ap.add_argument("--queries", default="",
                    help="comma-separated QUERIES names (default: all)")
    ap.add_argument("--timeout", type=float, default=60.0,
                    help="seconds a collective waits for a peer")
    args = ap.parse_args(argv)

    from ..engine import device as dev
    from ..engine import select as sel
    from ..entry import check_kernels, check_probes

    def no_fallback(e):
        raise AssertionError(f"device path fell back to the host: {e!r}")
    sel.warn_fallback = no_fallback

    torch.set_num_threads(1)
    device = dev.device()
    dev.set_device(device)
    dev.set_threshold(1)
    dev._cfg["dist_timeout"] = args.timeout
    m = dev.mesh()
    world = int(os.environ["RAYFORCE_NUM_PROCS"])
    if m is None or m.world != world:
        raise AssertionError(f"no {world}-process mesh: {m}")
    emit({"rank": m.rank, "world": m.world, "shards": m.n,
          "local": [m.local.start, m.local.stop], "backend": m.backend,
          "device": str(next(d for d in m.devices if d is not None))})

    rng = np.random.default_rng(0)
    check_kernels(m, rng)
    check_probes(m, rng, next(d for d in m.devices if d is not None))
    emit({"collectives": collective_cases(m)})

    t0 = time.perf_counter()
    rts = load_tables(args.rows, device)
    _sync(device)
    emit({"tables_s": time.perf_counter() - t0})
    names = args.queries.split(",") if args.queries else list(QUERIES)
    on_card = torch.device(device).type == "cuda"
    for name in names:
        if on_card:
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
        rec = run_query(rts, name, args.reps, device)
        if on_card:
            # above the tables, as chip_smoke.py's mesh phases report it
            rec["peak_mb"] = (torch.cuda.max_memory_allocated() -
                              base) / 2**20
        emit(rec)
    # leave together: the rendezvous store lives in rank 0
    import torch.distributed as td
    td.barrier()
    td.destroy_process_group()
    print("MULTIPROC_OK", flush=True)
    return 0


def emit(rec):
    print("MP " + json.dumps(rec), flush=True)


def records(stdout) -> list:
    """The `MP` records of a rank's output."""
    return [json.loads(line[3:]) for line in stdout.splitlines()
            if line.startswith("MP ")]


# -- the launcher -------------------------------------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(n_procs, shards, worker_args=(), env=None, timeout=120.0):
    """Start `n_procs` ranks of this worker on localhost over an
    `shards`-shard mesh and wait for them (at most `timeout` seconds in
    all). Returns each rank's (stdout, stderr). Raises RuntimeError with
    every rank's output when a rank fails or the time runs out; the
    other ranks are killed then. A port taken between its choice and
    the rendezvous is retried once on another."""
    for attempt in range(2):
        port = _free_port()
        procs, files = [], []
        try:
            for rank in range(n_procs):
                e = dict(os.environ if env is None else env)
                e.update({"RAYFORCE_COORDINATOR": f"127.0.0.1:{port}",
                          "RAYFORCE_NUM_PROCS": str(n_procs),
                          "RAYFORCE_PROC_ID": str(rank),
                          "RAYFORCE_MESH": str(shards),
                          "PYTHONPATH": ROOT + os.pathsep +
                          e.get("PYTHONPATH", "")})
                out = tempfile.TemporaryFile(mode="w+")
                err = tempfile.TemporaryFile(mode="w+")
                files.append((out, err))
                procs.append(subprocess.Popen(
                    [sys.executable, "-m",
                     "rayforce_tpu_torch.tools.multiproc_worker",
                     *worker_args], env=e, cwd=ROOT, stdout=out,
                    stderr=err, text=True))
            # wait for every rank; one that fails stops the others, which
            # would otherwise wait out their timeout in a collective
            deadline = time.monotonic() + timeout
            timed_out = False
            while True:
                rcs = [p.poll() for p in procs]
                if None not in rcs or any(rc not in (None, 0) for rc in rcs):
                    break
                if time.monotonic() > deadline:
                    timed_out = True
                    break
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        outs = []
        for out, err in files:
            out.seek(0)
            err.seek(0)
            outs.append((out.read(), err.read()))
            out.close()
            err.close()
        rcs = [p.returncode for p in procs]
        if not timed_out and all(rc == 0 for rc in rcs):
            return outs
        if attempt == 0 and not timed_out and any(
                "EADDRINUSE" in e or "address already in use" in e.lower()
                for _o, e in outs):
            continue
        report = "\n".join(
            f"--- rank {i} rc={rc} stdout ---\n{o[-4000:]}\n"
            f"--- rank {i} stderr ---\n{e[-4000:]}"
            for i, (rc, (o, e)) in enumerate(zip(rcs, outs)))
        raise RuntimeError(("the ranks timed out after "
                            f"{timeout} s\n" if timed_out else
                            "a rank failed\n") + report)


if __name__ == "__main__":
    sys.exit(main())
