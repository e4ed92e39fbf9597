"""A table placed on the port's in-process mesh shard by shard, with no
whole column on any device (`engine/device.py` `put_table` under a
mesh, `dev_col_sharded`):

- the stats made from the shards (min, max, has_null, qscale) are
  what the JAX package's `_k_minmax_all` gives over the whole column,
  bit for bit, for 1 to 5 shards with pad rows;
- under RAYFORCE_MESH=4 a table built on the host is placed block by
  block, no column gets a whole device copy, and db-benchmark q1-q6 run
  on the mesh's engines and print what the JAX package's Runtime prints
  under the same mesh (and what the port's host path prints);
- a table handed over as shards, with a whole payload that raises when
  forced, runs q1-q6 on the mesh's engines without forcing it, and the
  answers are the plain shard reference's (`portbench/reference/
  groupby_shards.py`).

All on CPU torch (`RAYFORCE_DEVICE=cpu`), every device of the mesh the
CPU; the JAX package on its virtual CPU devices."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from portbench import compare as pcmp
from portbench.reference import groupby_shards
from rayforce_tpu.engine import device as rdev
from rayforce_tpu_torch import Runtime
from rayforce_tpu_torch.core import symbols, types as T
from rayforce_tpu_torch.core.obj import DevPending, Obj, table, vec_sym
from rayforce_tpu_torch.engine import device as dev
from rayforce_tpu_torch.engine import select as sel
from rayforce_tpu_torch.parallel import dist
from test_torch_mesh import check, mesh_env
from test_torch_sortagg import _runtimes

torch.set_num_threads(1)

# db-benchmark q1-q6 (rayforce_tpu_torch/tools/g1.py), each with its
# reference spec and the engine it runs on the mesh
QUERIES = {
    "q1": ("(select {s: (sum v1) from: t by: id1})",
           ["id1"], [["s", "sum", "v1"]], "spmd"),
    "q2": ("(select {s: (sum v1) from: t by: {id1: id1 id2: id2}})",
           ["id1", "id2"], [["s", "sum", "v1"]], "dist-group"),
    "q3": ("(select {s: (sum v1) a: (avg v3) from: t by: id3})",
           ["id3"], [["s", "sum", "v1"], ["a", "avg", "v3"]], "dist-group"),
    "q4": ("(select {a1: (avg v1) a2: (avg v2) a3: (avg v3) from: t "
           "by: id4})", ["id4"],
           [["a1", "avg", "v1"], ["a2", "avg", "v2"], ["a3", "avg", "v3"]],
           "spmd"),
    "q5": ("(select {s1: (sum v1) s2: (sum v2) s3: (sum v3) from: t "
           "by: id6})", ["id6"],
           [["s1", "sum", "v1"], ["s2", "sum", "v2"], ["s3", "sum", "v3"]],
           "dist-group"),
    "q6": ("(select {mx: (max v1) mn: (min v2) from: t by: id3})",
           ["id3"], [["mx", "max", "v1"], ["mn", "min", "v2"]],
           "dist-group"),
}
# G1's columns at a test's size: id3 and id6 past the dense plan's 512
# codes, so that q3, q5 and q6 take dist-group
G1 = [("id1", 0, 100), ("id2", 0, 100), ("id3", 0, 1000), ("id4", 0, 100),
      ("id5", 0, 100), ("id6", 0, 1000), ("v1", 1, 6), ("v2", 1, 16),
      ("v3", 0.0, 100.0)]


@pytest.fixture(autouse=True)
def _engine():
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


# -- the stats from the shards ------------------------------------------------

def _column(kind, n, rng):
    """(type, values) of a column of `n` rows whose stats are hard to get
    right from parts: nulls (all of the last rows, so that a shard may
    hold nothing else), NaNs, infinities, values on a decimal grid and
    values just off it."""
    if kind in ("i64", "i32", "i16"):
        t, dt, null = {"i64": (T.I64, np.int64, T.NULL_I64),
                       "i32": (T.I32, np.int32, T.NULL_I32),
                       "i16": (T.I16, np.int16, T.NULL_I16)}[kind]
        x = rng.integers(-3000, 3000, n).astype(dt)
        x[rng.random(n) < 0.1] = null
        x[-n // 4:] = null
        return t, x
    if kind == "u8":
        return T.U8, rng.integers(0, 256, n).astype(np.uint8)
    x = np.round(rng.uniform(-50, 50, n), 6)
    if kind == "f64_nan_inf":
        x[rng.random(n) < 0.1] = np.nan
        x[-n // 4:] = np.nan
        x[3], x[n // 2] = np.inf, -np.inf
    elif kind.startswith("f64_grid"):
        s = float(kind.split("_")[-1])
        x = np.round(x * s) / s
        if kind.startswith("f64_grid_off"):
            # one value just off the grid, in the last real shard
            x[n - 7] += 0.37 / s
    return T.F64, x


STAT_KINDS = ["i64", "i32", "i16", "u8", "f64_nan_inf"] + \
    [f"f64_grid_{s:g}" for s in dev.QSCALES] + \
    [f"f64_grid_off_{s:g}" for s in dev.QSCALES]


def _stats(col):
    return col.meta["range"], col.meta["has_null"], col.meta.get("qscale")


def _bits(stats):
    """The stats with each float as its bits (NaN == NaN, -0.0 != 0.0)."""
    def b(v):
        return ("f", np.float64(v).view(np.int64).item()) \
            if isinstance(v, float) else v
    (lo, hi), anyn, q = stats
    return b(lo), b(hi), anyn, b(q) if q is not None else None


@pytest.mark.parametrize("kind", STAT_KINDS)
@pytest.mark.parametrize("n_shards", [1, 2, 3, 4, 5])
def test_shard_stats_are_the_whole_columns_bit_for_bit(kind, n_shards):
    rng = np.random.default_rng([n_shards, len(kind)])
    n = 1003                     # pad rows for every count of shards > 1
    t, x = _column(kind, n, rng)
    whole = Obj(t, x.copy(), meta={})
    dev._cache_stats(whole, jax.device_get(
        rdev._k_minmax_all([jnp.asarray(x)]))[0])
    m = dist.make_mesh(n_shards, device="cpu")
    col = Obj(t, x.copy())
    dev._put_sharded([col], m)
    assert _bits(_stats(col)) == _bits(_stats(whole))
    assert "dev" not in col.meta
    shards = col.meta["dev_sh"][1]
    assert len(shards) == n_shards
    assert torch.cat(shards)[:n].numpy().tobytes() == x.tobytes()


def test_shard_stats_of_each_grid_pick_its_scale():
    """The grid cases above reach every qscale, and none off the grids."""
    m = dist.make_mesh(3, device="cpu")
    got = {}
    for kind in STAT_KINDS[5:]:
        t, x = _column(kind, 1003, np.random.default_rng(7))
        col = Obj(t, x)
        dev._put_sharded([col], m)
        got[kind] = col.meta["qscale"]
    assert [got[f"f64_grid_{s:g}"] for s in dev.QSCALES] == \
        list(dev.QSCALES)
    assert [got[f"f64_grid_off_{s:g}"] for s in dev.QSCALES[:-1]] == \
        list(dev.QSCALES[1:])


def test_put_table_without_a_mesh_makes_the_whole_copy():
    """No mesh: put_table places each column whole, as before."""
    t, x = _column("i64", 1000, np.random.default_rng(3))
    col = Obj(t, x)
    with mesh_env(1):
        assert dev.mesh() is None
        dev.put_table(table(vec_sym(["a"]), [col]))
    assert "dev" in col.meta and "dev_sh" not in col.meta
    assert col.meta["range"] == (int(x[x != T.NULL_I64].min()),
                                 int(x.max()))


# -- whole queries ------------------------------------------------------------

def _g1(n, seed):
    rng = np.random.default_rng(seed)
    cols = {}
    for name, lo, hi in G1:
        if isinstance(lo, float):
            cols[name] = np.round(rng.uniform(lo, hi, n), 6)
        else:
            cols[name] = rng.integers(lo, hi, n).astype(np.int64)
    return cols


def _runtime(tbl):
    rt = Runtime()
    rt.interp.globals[symbols.intern("t")] = tbl
    return rt


def _engine_of():
    prof = sel.last_profile
    if "dispatch_ms" in prof:
        return "spmd" if prof.get("spmd") else "dense"
    return prof.get("engine", "host")


def test_a_host_table_is_placed_block_by_block_and_runs_on_the_mesh():
    if len(jax.devices()) < 4:
        pytest.skip("the reference needs 4 virtual devices")
    cols = _g1(4003, 5)          # 4003 rows: the last shard is padded
    rrt, prt = _runtimes({name: (a, "F64" if a.dtype == np.float64
                                 else "I64") for name, a in cols.items()})
    tbl = prt.interp.globals[symbols.intern("t")]
    with mesh_env(4):
        m = dev.mesh()
        copies = dict(dev.WHOLE_COPIES)
        dev.put_table(tbl)
        for c, a in zip(tbl.v[1], cols.values()):
            assert "dev" not in c.meta
            key, shards = c.meta["dev_sh"]
            assert key == m.key and len(shards) == 4
            assert torch.equal(torch.cat(shards)[:len(a)],
                               torch.from_numpy(a))
        for q, (text, _by, _aggs, engine) in QUERIES.items():
            # the JAX package's Runtime under the same mesh == the
            # port's mesh == the port's host path, on the same engine
            check(rrt, prt, text, engine=engine)
        assert dev.WHOLE_COPIES == copies
        assert all("dev" not in c.meta for c in tbl.v[1])


def test_shards_handed_over_run_on_the_mesh_without_the_whole_payload():
    n = 4000
    cols = _g1(n, 9)
    with mesh_env(4):
        m = dev.mesh()
        blocks = {name: list(torch.from_numpy(a).chunk(4))
                  for name, a in cols.items()}
        forced = []

        def refuse():
            forced.append(1)
            raise AssertionError("the whole payload was forced")
        objs = []
        for name, a in cols.items():
            c = Obj(T.F64 if a.dtype == np.float64 else T.I64,
                    DevPending(thunk=refuse, shape=(n,)))
            c.meta = {"dev_sh": (m.key, blocks[name])}
            objs.append(c)
        tbl = table(vec_sym(list(cols)), objs)
        copies = dict(dev.WHOLE_COPIES)
        moved = dist.moved["bytes"]
        dev.put_table(tbl)
        rt = _runtime(tbl)
        for q, (text, by, aggs, engine) in QUERIES.items():
            sel.last_profile.clear()
            res = rt.eval_str(text)
            assert _engine_of() == engine, q
            got = [(symbols.name_of(int(s)), c.pending().arr
                    if c.pending() is not None else c.v)
                   for s, c in zip(res.v[0].v, res.v[1])]
            want = groupby_shards.run({"t": blocks}, {
                "kind": "groupby_shards", "table": "t", "by": by,
                "aggs": aggs})
            r = pcmp.compare(got, want)
            assert r["exact_mismatches"] == 0 and \
                r["f64_rel_err"] < 1e-12, (q, r)
        assert dev.WHOLE_COPIES == copies
        # every shard on the CPU: no copy crosses from one card to another
        assert dist.moved["bytes"] == moved
        assert not forced and all("dev" not in c.meta for c in objs)
