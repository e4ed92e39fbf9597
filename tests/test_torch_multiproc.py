"""The port's multi-process mesh: 2 processes x 4 shards of CPU torch on
localhost, joined over torch.distributed (gloo) through the
RAYFORCE_COORDINATOR hook of rayforce_tpu_torch/engine/device.py `mesh()`,
each rank running rayforce_tpu_torch/tools/multiproc_worker.py.

Every collective over the 2 ranks must give the world-1 result bit for
bit; every query of the worker (the reference worker's selects, the G1
grouped selects and medians, the join probes, the table sorts and the
window joins, over tools/jtables.py's tables at 20 000 rows) must run
the engine of the port's one-process 8-shard mesh, note the same
exchanged bytes and give its formatted output byte for byte, its columns
bit for bit, and the host path's formatted output; the selects of the
reference worker and the medians also the reference's 8-device mesh's.
The counterpart of tests/test_multiproc.py."""
import os
import subprocess
import sys
from contextlib import contextmanager

import numpy as np
import pytest
import torch

from rayforce_tpu import Runtime as RefRuntime
from rayforce_tpu.core import symbols as rsymbols
from rayforce_tpu.core import types as RT
from rayforce_tpu.core.fmt import format_top as ref_fmt
from rayforce_tpu.core.obj import Obj as RObj, table as rtable, \
    vec_sym as rvec_sym
from rayforce_tpu.engine import device as rdev
from rayforce_tpu.engine import select as rsel
from rayforce_tpu_torch.core import symbols, types as T
from rayforce_tpu_torch.core.fmt import format_top as fmt
from rayforce_tpu_torch.core.obj import to_np
from rayforce_tpu_torch.engine import device as dev
from rayforce_tpu_torch.engine import select as sel
from rayforce_tpu_torch.tools import multiproc_worker as W

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROWS = 20_000
COLLECTIVES = ["psum", "pmin", "pmax", "all_gather", "unshard",
               "all_to_all", "all_to_all_bool", "rotate"]
# (a) the reference worker's selects and the G1 grouped selects on the
# dense plan and the mesh group-by, (b) the medians: held against the
# reference's 8-device mesh too
REFERENCE = ["spmd", "dist_group", "q1", "q3", "med_id3", "med_id3_skew"]


@contextmanager
def port_mesh(n=8, **env):
    """RAYFORCE_MESH=n (and `env`; None unsets) for the port, its device
    on CPU torch at threshold 1; its settings and mesh state restored on
    exit."""
    names = ["RAYFORCE_MESH"] + list(env)
    old_env = {k: os.environ.get(k) for k in names}
    saved_cfg, saved_mesh = dict(dev._cfg), dict(dev._mesh_state)
    os.environ["RAYFORCE_MESH"] = str(n)
    for k, v in env.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v
    dev.set_device("cpu")
    dev.set_threshold(1)
    dev._mesh_state.update({"mesh": None, "checked": False})
    try:
        yield
    finally:
        for k, v in old_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        dev._cfg.clear()
        dev._cfg.update(saved_cfg)
        dev._mesh_state.clear()
        dev._mesh_state.update(saved_mesh)


@pytest.fixture(scope="module")
def ranks():
    """Each rank's records: {"head", "collectives", "queries"}."""
    env = dict(os.environ, RAYFORCE_DEVICE="cpu")
    try:
        outs = W.launch(2, 8, ["--rows", str(ROWS)], env=env, timeout=120)
    except RuntimeError as e:
        pytest.fail(str(e))
    got = []
    for out, _err in outs:
        assert out.rstrip().endswith("MULTIPROC_OK"), out[-2000:]
        recs = W.records(out)
        got.append({"head": recs[0],
                    "collectives": next(r["collectives"] for r in recs
                                        if "collectives" in r),
                    "queries": {r["query"]: r for r in recs
                                if "query" in r}})
    return got


@pytest.fixture(scope="module")
def one_process(monkeypatch_module):
    """The same collectives and queries on the port's one-process 8-shard
    mesh, each query's host-path output beside it, and the runtimes."""
    fallbacks = []
    monkeypatch_module.setattr(sel, "warn_fallback", fallbacks.append)
    with port_mesh(8):
        m = dev.mesh()
        assert m.n == 8 and m.world == 1
        coll = W.collective_cases(m)
        rts = W.load_tables(ROWS, "cpu")
        queries = {}
        for name in W.QUERIES:
            rec = W.run_query(rts, name)
            dev.set_enabled(False)
            try:
                rec["host"] = fmt(rts[W.QUERIES[name][0]].eval_str(
                    W.QUERIES[name][1]))
            finally:
                dev.set_enabled(True)
            queries[name] = rec
    assert fallbacks == []
    return {"collectives": coll, "queries": queries, "rts": rts}


@pytest.fixture(scope="module")
def monkeypatch_module():
    mp = pytest.MonkeyPatch()
    yield mp
    mp.undo()


def test_ranks_form_one_mesh(ranks):
    for rank, r in enumerate(ranks):
        assert r["head"] == {"rank": rank, "world": 2, "shards": 8,
                             "local": [4 * rank, 4 * rank + 4],
                             "backend": "gloo", "device": "cpu"}
    assert set(ranks[0]["queries"]) == set(W.QUERIES)


@pytest.mark.parametrize("name", COLLECTIVES)
def test_collective_equals_world_one(ranks, one_process, name):
    """Each collective over 2 ranks x 4 shards: the world-1 result over
    the same 8 seeded shards, bit for bit, on both ranks."""
    want = one_process["collectives"][name]
    assert [r["collectives"][name] for r in ranks] == [want, want]


@pytest.mark.parametrize("name", list(W.QUERIES))
def test_query_equals_one_process_mesh(ranks, one_process, name):
    """Both ranks: the one-process mesh's engine, exchanged bytes and
    kernel calls, formatted output byte for byte and columns bit for
    bit; a rerun gives the same bytes."""
    want = one_process["queries"][name]
    for rank, r in enumerate(ranks):
        got = r["queries"][name]
        for k in ("engine", "exchanged_bytes", "kernel_calls", "rows",
                  "out", "digest"):
            assert got[k] == want[k], (rank, k)
        assert got["reruns_equal"], rank
    if want["engine"] in ("spmd", "dist-group") or \
            want["engine"].startswith("dist-"):
        assert want["exchanged_bytes"] > 0


@pytest.mark.parametrize("name", list(W.QUERIES))
def test_query_equals_host(ranks, one_process, name):
    """The ranks' formatted output is the host path's."""
    host = one_process["queries"][name]["host"]
    assert [r["queries"][name]["out"] for r in ranks] == [host, host]


def _ref_runtime(port_rt, names):
    """A reference Runtime holding copies of the port runtime's tables."""
    rrt = RefRuntime()
    for name in names:
        tbl = port_rt.interp.globals[symbols.intern(name)]
        cols = [RObj(RT.F64 if c.t == T.F64 else RT.I64,
                     np.asarray(to_np(c)).copy()) for c in tbl.v[1]]
        cnames = [symbols.name_of(int(s)) for s in to_np(tbl.v[0])]
        rrt.interp.globals[rsymbols.intern(name)] = rtable(
            rvec_sym(cnames), cols)
    return rrt


@pytest.mark.parametrize("name", REFERENCE)
def test_query_equals_reference_mesh(ranks, one_process, name):
    """(a) and (b): the reference's in-process 8-device mesh gives the
    ranks' formatted output and runs the same engine."""
    import jax
    if len(jax.devices()) < 8:
        pytest.skip("the reference needs 8 virtual devices")
    rt_name, q, _kind, _bmax = W.QUERIES[name]
    tables = ["t", "t2"] if rt_name == "a" else ["t", "t_skew"]
    rrt = _ref_runtime(one_process["rts"][rt_name], tables)
    saved_cfg, saved_mesh = dict(rdev._cfg), dict(rdev._mesh_state)
    old = os.environ.get("RAYFORCE_MESH")
    os.environ["RAYFORCE_MESH"] = "8"
    rdev._mesh_state.update({"mesh": None, "checked": False})
    try:
        rdev.set_enabled(True)
        rdev.set_threshold(1)
        rsel.last_profile.clear()
        r = ref_fmt(rrt.eval_str(q))
        prof = dict(rsel.last_profile)
    finally:
        if old is None:
            os.environ.pop("RAYFORCE_MESH", None)
        else:
            os.environ["RAYFORCE_MESH"] = old
        rdev._cfg.clear()
        rdev._cfg.update(saved_cfg)
        rdev._mesh_state.clear()
        rdev._mesh_state.update(saved_mesh)
    engine = ("spmd" if prof.get("spmd") else "dense") \
        if "dispatch_ms" in prof else prof.get("engine", "host")
    for rank in ranks:
        assert rank["queries"][name]["engine"] == engine
        assert rank["queries"][name]["out"] == r


@pytest.mark.parametrize("procs, mesh", [(3, "8"), (2, "7")])
def test_shards_must_split_over_the_processes(procs, mesh):
    """RAYFORCE_MESH=N with N not a multiple of the process count raises
    DeviceError before any rendezvous."""
    with port_mesh(mesh, RAYFORCE_COORDINATOR="127.0.0.1:1",
                   RAYFORCE_NUM_PROCS=str(procs), RAYFORCE_PROC_ID="0"):
        with pytest.raises(dev.DeviceError, match="do not split"):
            dev.mesh()


@pytest.mark.parametrize("rank", [None, "2"])
def test_coordinator_needs_a_rank(rank):
    """RAYFORCE_COORDINATOR without a valid rank raises DeviceError."""
    env = {"RAYFORCE_NUM_PROCS": "2", "RAYFORCE_PROC_ID": rank}
    with port_mesh(8, RAYFORCE_COORDINATOR="127.0.0.1:1", **env):
        with pytest.raises(dev.DeviceError, match="RAYFORCE_PROC_ID"):
            dev.mesh()


def test_missing_peer_raises_after_the_timeout():
    """Rank 0 of 2 whose peer never comes: mesh() raises DeviceError once
    the rendezvous times out (here after 3 s), and the process exits;
    nothing hangs."""
    code = (
        "import sys\n"
        f"sys.path.insert(0, {ROOT!r})\n"
        "from rayforce_tpu_torch.engine import device as dev\n"
        "dev.set_device('cpu')\n"
        "dev._cfg['dist_timeout'] = 3.0\n"
        "try:\n"
        "    dev.mesh()\n"
        "except dev.DeviceError as e:\n"
        "    print('DeviceError:', e)\n"
        "    sys.exit(3)\n")
    env = dict(os.environ, RAYFORCE_COORDINATOR=f"127.0.0.1:{W._free_port()}",
               RAYFORCE_NUM_PROCS="2", RAYFORCE_PROC_ID="0",
               RAYFORCE_MESH="8")
    r = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                       capture_output=True, text=True, timeout=90)
    assert r.returncode == 3, r.stderr[-3000:]
    assert "could not join the mesh" in r.stdout
