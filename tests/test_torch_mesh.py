"""Whole grouped selects on the port's device mesh, held against the JAX
package's: the same Rayfall runs through `rayforce_tpu.Runtime` and
`rayforce_tpu_torch.Runtime`, both with RAYFORCE_MESH=8, threshold 1 and
the device on (the reference over its 8 virtual CPU devices, the port
over 8 shards of CPU torch). The formatted output must be equal byte for
byte, and equal to the port's host path; the port's mesh must really
have run (`spmd` True for the dense plan, engine `dist-group` for the
mesh group-by), and both packages' `dist.stats` must note the same
exchanged bytes and kernel calls. The counterparts of
tests/test_dist.py's end-to-end mesh tests and of
tests/test_qscale.py::test_small_path_spmd_bcast_sums. Each test
restores both packages' mesh state, so no mesh leaks into other tests
of the same worker."""
import os
import random
from contextlib import contextmanager

import numpy as np
import pytest
import torch

from rayforce_tpu.core.fmt import format_top as ref_fmt
from rayforce_tpu.core.obj import to_np as ref_to_np
from rayforce_tpu.engine import device as rdev
from rayforce_tpu.engine import select as rsel
from rayforce_tpu.parallel import dist as rdist
from rayforce_tpu_torch import Runtime
from rayforce_tpu_torch.core import symbols, types as T
from rayforce_tpu_torch.core.fmt import format_top as fmt
from rayforce_tpu_torch.core.obj import Obj, table, vec_sym
from rayforce_tpu_torch.engine import device as dev
from rayforce_tpu_torch.engine import join as ejoin
from rayforce_tpu_torch.engine import select as sel
from rayforce_tpu_torch.parallel import dist as pdist
from test_device_fuzz import _mk_query, _mk_table
from test_torch_sortagg import _runtimes, null_groups

torch.set_num_threads(1)


@pytest.fixture(autouse=True, scope="module")
def _engines():
    import jax
    if len(jax.devices()) < 8:
        pytest.skip("the reference needs 8 virtual devices")
    rsaved, saved = dict(rdev._cfg), dict(dev._cfg)
    rdev.set_enabled(True)
    rdev.set_threshold(1)
    dev.set_device("cpu")
    dev.set_threshold(1)
    yield
    rdev._cfg.clear()
    rdev._cfg.update(rsaved)
    dev._cfg.clear()
    dev._cfg.update(saved)


@contextmanager
def mesh_env(n=8, **env):
    """RAYFORCE_MESH=n (and `env`) for both packages, their mesh state
    restored on exit."""
    names = ["RAYFORCE_MESH"] + list(env)
    old_env = {k: os.environ.get(k) for k in names}
    old_r, old_p = dict(rdev._mesh_state), dict(dev._mesh_state)
    os.environ["RAYFORCE_MESH"] = str(n)
    os.environ.update(env)
    rdev._mesh_state.update({"mesh": None, "checked": False})
    dev._mesh_state.update({"mesh": None, "checked": False})
    try:
        yield
    finally:
        for k, v in old_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        rdev._mesh_state.clear()
        rdev._mesh_state.update(old_r)
        dev._mesh_state.clear()
        dev._mesh_state.update(old_p)


def _engine(prof):
    """"spmd" / "dense" for the dense plan (on the mesh or not), else
    the engine, "host" when the device path declined the query."""
    if "dispatch_ms" in prof:
        return "spmd" if prof.get("spmd") else "dense"
    return prof.get("engine", "host")


def check(rrt, prt, q, engine=None):
    """Reference device == port device == port host, formatted; both
    packages took the same engine and noted the same exchange."""
    rdist.reset_stats()
    pdist.reset_stats()
    rdev.set_enabled(True)
    rsel.last_profile.clear()
    r = ref_fmt(rrt.eval_str(q))
    sel.last_profile.clear()
    dev.set_enabled(True)
    p = fmt(prt.eval_str(q))
    got = _engine(sel.last_profile)
    assert got == _engine(rsel.last_profile), q
    if engine is not None:
        assert got == engine, q
    assert dict(pdist.stats) == dict(rdist.stats), q
    dev.set_enabled(False)
    try:
        h = fmt(prt.eval_str(q))
    finally:
        dev.set_enabled(True)
    assert p == r, f"{q}\nPORT:\n{p}\nREFERENCE:\n{r}"
    assert p == h, f"{q}\nPORT DEVICE:\n{p}\nPORT HOST:\n{h}"
    return got


def _port_twin(rrt, prt, name="t"):
    """Copy a reference Runtime's table `name` into the port Runtime."""
    from rayforce_tpu.core import symbols as rsymbols
    rt = rrt.interp.globals[rsymbols.intern(name)]
    names = [rsymbols.name_of(int(s)) for s in ref_to_np(rt.v[0])]
    cols = [Obj(c.t, ref_to_np(c).copy()) for c in rt.v[1]]
    prt.interp.globals[symbols.intern(name)] = table(vec_sym(names), cols)


def test_mesh_state():
    """RAYFORCE_MESH=8 gives 8 shards on the engine's device; 1 and
    auto (one CPU device) give none; the column shards and the plans are
    cached per mesh."""
    with mesh_env(8):
        m = dev.mesh()
        assert m.n == 8 and m.devices == [torch.device("cpu")] * 8
        col = Obj(T.I64, np.arange(5003, dtype=np.int64))
        sh8 = dev.dev_col_sharded(col, m)
        assert len(sh8) == 8 and dev.dev_col_sharded(col, m) is sh8
        m4 = pdist.make_mesh(4, device="cpu")
        sh4 = dev.dev_col_sharded(col, m4)
        assert len(sh4) == 4 and int(sh4[0].shape[0]) == 1251
    for spec in ("1", "auto", "x"):
        with mesh_env(spec):
            assert dev.mesh() is None
            assert dev.mesh_key() is None
    # without RAYFORCE_MESH the mesh check touches no device (here the
    # engine's device, CUDA, has no card)
    saved_cfg = dict(dev._cfg)
    with mesh_env(1):
        del os.environ["RAYFORCE_MESH"]
        dev._cfg["device"] = torch.device("cuda")
        try:
            assert dev.mesh() is None
        finally:
            dev._cfg.clear()
            dev._cfg.update(saved_cfg)


@pytest.fixture(scope="module")
def spmd_tables():
    """tests/test_dist.py::test_spmd_select_parity's table: 5003 rows,
    not divisible by 8."""
    rng = np.random.default_rng(4)
    N = 5003
    v1 = rng.integers(-3, 6, N).astype(np.int64)
    v1[rng.integers(0, N, 40)] = T.NULL_I64
    return _runtimes({"id1": (rng.integers(0, 9, N).astype(np.int64),
                              "I64"),
                      "v1": (v1, "I64"),
                      "v3": (rng.uniform(-50, 100, N), "F64")})


SPMD = [
    "(select {s: (sum v1) c: (count v1) from: t by: id1})",
    "(select {a: (avg v3) mx: (max v3) mn: (min v1) from: t by: id1 "
    "where: (> v3 0)})",
    "(select {s: (sum v3) f: (first v1) l: (last v3) from: t})",
]


@pytest.mark.parametrize("q", SPMD)
def test_spmd_select_parity(spmd_tables, q):
    with mesh_env(8):
        check(*spmd_tables, q, engine="spmd")


def test_spmd_plan_runs_dist_select_small(spmd_tables, monkeypatch):
    """The dense plan on a mesh computes its lanes with the port's
    dist_select_small over every shard (its byte count is the plan's
    own, as the reference's inline combine counts it)."""
    calls = []
    real = pdist.dist_select_small

    def spy(mesh, *a):
        calls.append(mesh.n)
        return real(mesh, *a)
    monkeypatch.setattr(pdist, "dist_select_small", spy)
    with mesh_env(8):
        check(*spmd_tables, SPMD[1], engine="spmd")
    assert calls and set(calls) == {8}


def test_spmd_med_runs_on_one_device(spmd_tables):
    """A dense plan with a median needs whole groups: it runs on one
    device under the mesh, as in the reference."""
    with mesh_env(8):
        check(*spmd_tables, "(select {m: (med v3) from: t by: id1})",
              engine="dense")


@pytest.fixture(scope="module")
def wide_tables():
    """tests/test_dist.py::test_mesh_wide_select_parity's table."""
    rng = np.random.default_rng(12)
    n = 8 * 1000 + 5
    k1 = rng.integers(0, 900, n).astype(np.int64)
    k2 = rng.integers(0, 50, n).astype(np.int64)
    v = rng.uniform(0, 10, n)
    w = rng.integers(0, 100, n).astype(np.int64)
    nf = rng.uniform(0, 10, n)
    nf[rng.random(n) < 0.5] = np.nan
    ni = rng.integers(-20, 20, n).astype(np.int64)
    ni[rng.random(n) < 0.5] = T.NULL_I64
    n1, n3 = null_groups(rng, k1)
    return _runtimes({"k1": (k1, "I64"), "k2": (k2, "I64"),
                      "v": (v, "F64"), "w": (w, "I64"), "nf": (nf, "F64"),
                      "ni": (ni, "I64"), "n1": (n1, "I64"),
                      "n3": (n3, "F64")})


WIDE = [
    "(select {s: (sum v) c: (count v) from: t by: {k1: k1 k2: k2}})",
    "(select {a: (avg v) from: t by: {k1: k1 k2: k2} where: (> w 30)})",
    "(select {s: (sum w) from: t by: k1})",
    "(select {mx: (max v) mn: (min w) s: (sum v) from: t by: k1})",
    "(select {mn: (min v) mx: (max v) c: (count v) from: t "
    "by: {k1: k1 k2: k2} where: (< w 70)})",
    "(select {s: (sum nf) a: (avg nf) mn: (min nf) mx: (max nf) "
    "c: (count nf) from: t by: k1})",
    "(select {s: (sum ni) a: (avg ni) mn: (min ni) mx: (max ni) from: t "
    "by: {k1: k1 k2: k2}})",
    "(select {f: (first v) l: (last w) fi: (first ni) ln: (last nf) "
    "from: t by: k1})",
    "(select {d: (dev v) a: (avg v) from: t by: k1})",
    "(select {d: (dev nf) di: (dev w) from: t by: k1})",
    "(select {s: (sum v) c: (count v) from: t by: {a: k1 b: k2 c2: w}})",
    "(select {m: (med v) s: (sum v) from: t by: k1})",
    "(select {m: (med nf) mi: (med w) c: (count v) from: t "
    "by: {k1: k1 k2: k2}})",
    "(select {s: (sum (* v nf)) mn: (min (+ nf v)) mx: (max (* nf 2.0)) "
    "from: t by: k1})",
    "(select {a: (avg (- v nf)) m: (med (+ v nf)) from: t "
    "by: {k1: k1 k2: k2}})",
    "(select {s: (sum (+ w ni)) mn: (min (* ni 3)) a: (avg (- w ni)) "
    "from: t by: k1})",
    # groups whose values are all null (k1 % 5 == 0) and partly null
    # (k1 % 5 == 1): a nullable i64, a nullable f64, derived exprs
    "(select {s: (sum n1) a: (avg n1) mn: (min n1) mx: (max n1) "
    "f: (first n1) l: (last n1) c: (count n1) from: t by: k1})",
    "(select {s: (sum n3) a: (avg n3) mn: (min n3) mx: (max n3) "
    "f: (first n3) l: (last n3) c: (count n3) from: t by: k1})",
    "(select {s: (sum (+ n1 w)) a: (avg (+ n1 w)) mn: (min (+ n1 w)) "
    "mx: (max (+ n1 w)) c: (count n1) from: t by: k1})",
    "(select {s: (sum (* n3 2.0)) a: (avg (* n3 2.0)) "
    "mn: (min (* n3 2.0)) mx: (max (* n3 2.0)) from: t by: k1})",
]


@pytest.mark.parametrize("q", WIDE)
def test_mesh_wide_select_parity(wide_tables, q):
    with mesh_env(8):
        check(*wide_tables, q, engine="dist-group")


def test_mesh_skewed_median_takes_the_candidate_path():
    """One key holding 60% of the rows is locally heavy on every shard:
    its median comes from the distributed rank search, and the answer
    is still the reference's and the host's."""
    rng = np.random.default_rng(60)
    n = 8 * 700 + 3
    k = rng.integers(0, 600, n).astype(np.int64)
    k[rng.random(n) < 0.6] = 77
    v = rng.uniform(-5, 5, n)
    v[rng.random(n) < 0.05] = np.nan
    rrt, prt = _runtimes({"k": (k, "I64"), "v": (v, "F64")})
    with mesh_env(8):
        check(rrt, prt, "(select {m: (med v) s: (sum v) from: t by: k})",
              engine="dist-group")


def test_small_path_spmd_bcast_sums():
    """tests/test_qscale.py::test_small_path_spmd_bcast_sums: the mesh's
    dense plan psum-combines the counts, null counts and int sums."""
    rng = np.random.default_rng(6)
    n = 8 * 1021 + 5
    k = rng.integers(0, 50, n).astype(np.int64)
    v = rng.integers(-9, 9, n).astype(np.int64)
    v[rng.integers(0, n, 30)] = T.NULL_I64
    rrt, prt = _runtimes({"k": (k, "I64"), "v": (v, "I64")})
    with mesh_env(8):
        check(rrt, prt, "(select {s: (sum v) a: (avg v) c: (count v) "
                        "from: t by: k})", engine="spmd")


def _fuzz(seed, sizes, n_queries):
    """tests/test_dist.py's mesh fuzz: test_device_fuzz's table and
    queries with RAYFORCE_MESH=8; every query runs a mesh engine or
    falls back, in both packages alike."""
    from rayforce_tpu import Runtime as RefRuntime
    from rayforce_tpu.core import symbols as rsymbols
    rng = np.random.default_rng(seed)
    rnd = random.Random(seed)
    rrt, prt = RefRuntime(), Runtime()
    rrt.interp.globals[rsymbols.intern("t")] = _mk_table(
        rng, rnd.choice(sizes))
    _port_twin(rrt, prt)
    engines = []
    with mesh_env(8):
        for _ in range(n_queries):
            engines.append(check(rrt, prt, _mk_query(rnd)))
    return engines


@pytest.mark.parametrize("seed", range(3))
def test_mesh_select_fuzz(seed):
    _fuzz(500 + seed, [1013, 4001], 6)


@pytest.mark.parametrize("seed", range(700, 704))
def test_mesh_select_fuzz_extended(seed):
    _fuzz(seed, [1013, 4001, 9001], 10)


def test_mesh_fuzz_reaches_both_mesh_engines():
    engines = set()
    for seed in range(500, 503):
        engines |= set(_fuzz(seed, [1013, 4001], 6))
    assert {"spmd", "dist-group"} <= engines


def test_mesh_of_one_and_of_eight_agree(wide_tables):
    """The same programs under RAYFORCE_MESH=1 (one device: sort-agg and
    the dense plan) and =8 (the mesh) print the same text; switching the
    mesh size in one process serves no stale plan or shard."""
    _rrt, prt = wide_tables
    qs = [WIDE[0], WIDE[5], WIDE[11], SPMD[0].replace("id1", "k2")
          .replace("v1", "w").replace("v3", "v")]
    outs = {}
    for n in (1, 8, 1, 8):
        with mesh_env(n):
            got = []
            for q in qs:
                sel.last_profile.clear()
                got.append((fmt(prt.eval_str(q)), _engine(sel.last_profile)))
            outs.setdefault(n, got)
            assert outs[n] == got
    assert [t for t, _e in outs[1]] == [t for t, _e in outs[8]]
    assert [e for _t, e in outs[1]] == ["sortagg", "sortagg", "sortagg",
                                        "dense"]
    assert [e for _t, e in outs[8]] == ["dist-group", "dist-group",
                                        "dist-group", "spmd"]


def test_join_under_a_mesh_runs_one_device():
    """A join with no key to partition by (an asof join on the time
    alone) runs the single-device engine under RAYFORCE_MESH, with the
    host's answer; keyed joins take the mesh (tests/
    test_torch_mesh_join.py)."""
    rng = np.random.default_rng(3)
    rrt, prt = _runtimes({"ts": (np.sort(rng.integers(0, 10**6, 400))
                                 .astype(np.int64), "I64"),
                          "a": (rng.uniform(0, 1, 400), "F64")})
    _rrt2, prt2 = _runtimes({"ts": (np.sort(rng.integers(0, 10**6, 40))
                                    .astype(np.int64), "I64"),
                             "b": (rng.uniform(0, 1, 40), "F64")},
                            name="r")
    prt.interp.globals[symbols.intern("r")] = \
        prt2.interp.globals[symbols.intern("r")]
    q = "(asof-join [ts] t r)"
    with mesh_env(8):
        ejoin.last_profile.clear()
        p = fmt(prt.eval_str(q))
        assert ejoin.last_profile.get("engine") == "device-sortmerge"
        dev.set_enabled(False)
        try:
            assert fmt(prt.eval_str(q)) == p
        finally:
            dev.set_enabled(True)
