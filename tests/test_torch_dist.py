"""The port's mesh kernels (rayforce_tpu_torch/parallel/dist.py) held
against the JAX package's, side by side on the same seeded inputs: the
reference kernel runs on its 8-device virtual CPU mesh
(`rayforce_tpu.parallel.dist.make_mesh(8)`, as tests/test_dist.py's
`mesh8` fixture), the port's on an 8-shard mesh over CPU torch, where
every sort is the plain version of the CUDA radix sort.

Counts, codes, row ids and integer lanes must be equal; f64 lanes within
rtol 1e-12 (the port's f64 partials against numpy's sums; the
reference's dense sums ride f32 one-hot matmuls, so against them the
bound is its own rtol 1e-5); medians bit for bit. Each kernel also
notes the same exchanged bytes in both packages' `dist.stats`."""
import numpy as np
import pytest
import torch

from rayforce_tpu.engine import groupby as RG
from rayforce_tpu.parallel import dist as R
from rayforce_tpu_torch.engine import psort
from rayforce_tpu_torch.parallel import dist as D
from test_torch_wide import _at

torch.set_num_threads(1)

N_DEV = 8


@pytest.fixture(scope="module")
def meshes():
    import jax
    if len(jax.devices()) < N_DEV:
        pytest.skip("the reference needs 8 virtual devices")
    return R.make_mesh(N_DEV), D.make_mesh(N_DEV, device="cpu")


def _shard(meshes, a):
    """The same host array row-sharded over both meshes."""
    rm, pm = meshes
    return R.shard_rows(rm, a)[0], D.shard_rows(pm, a)[0]


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _stats_equal(run_ref, run_port):
    """Run both kernels with fresh stats; their exchanged bytes and
    kernel calls must agree. Returns both results."""
    R.reset_stats()
    D.reset_stats()
    r = run_ref()
    p = run_port()
    assert dict(D.stats) == dict(R.stats)
    return r, p


def test_mesh_shards_rows_and_collectives():
    pm = D.make_mesh(N_DEV, device="cpu")
    assert pm.n == N_DEV and pm.axis_names == ("d",)
    assert all(d.type == "cpu" for d in pm.devices)
    a = np.arange(5003, dtype=np.int64)
    shards, pad = D.shard_rows(pm, a)
    assert pad == (-5003) % N_DEV
    assert [int(s.shape[0]) for s in shards] == [626] * N_DEV
    np.testing.assert_array_equal(torch.cat(shards).numpy()[:5003], a)
    assert (torch.cat(shards).numpy()[5003:] == 0).all()
    xs = [torch.full((3,), float(i)) for i in range(N_DEV)]
    assert D.psum(xs)[0].tolist() == [28.0] * 3
    assert D.pmin(xs)[5].tolist() == [0.0] * 3
    assert D.pmax(xs)[0].tolist() == [7.0] * 3
    blocks = [torch.arange(N_DEV * 2) + 100 * s for s in range(N_DEV)]
    out = D.all_to_all(blocks)
    for d in range(N_DEV):
        assert out[d].tolist() == [100 * s + 2 * d + j for s in range(N_DEV)
                                   for j in range(2)]
    assert D.all_gather([torch.tensor([s]) for s in range(N_DEV)])[3] \
        .tolist() == list(range(N_DEV))
    assert D.axis_index(pm) == list(range(N_DEV))


def test_dist_groupby_sum(meshes):
    rm, pm = meshes
    rng = np.random.default_rng(0)
    n_codes = 37
    n = N_DEV * 512
    codes = rng.integers(0, n_codes, n).astype(np.int32)
    vals = rng.uniform(0, 10, n).astype(np.float32)
    rc, pc = _shard(meshes, codes)
    rv, pv = _shard(meshes, vals)
    r, p = _stats_equal(lambda: R.dist_groupby_sum(rm, n_codes)(rc, rv),
                        lambda: D.dist_groupby_sum(pm, n_codes)(pc, pv))
    want = np.zeros(n_codes + 1)
    np.add.at(want, codes, vals.astype(np.float64))
    np.testing.assert_allclose(_np(p), want, rtol=1e-12)
    np.testing.assert_allclose(_np(p), np.asarray(r), rtol=1e-5)


def test_dist_groupby_count_first(meshes):
    rm, pm = meshes
    rng = np.random.default_rng(5)
    n_codes = 29
    per = 700
    codes = rng.integers(0, n_codes + 1, N_DEV * per).astype(np.int32)
    codes[codes == 17] = 3          # an empty code
    rc, pc = _shard(meshes, codes)
    r, p = _stats_equal(
        lambda: R.dist_groupby_count_first(rm, n_codes, per)(rc),
        lambda: D.dist_groupby_count_first(pm, n_codes, per)(pc))
    np.testing.assert_array_equal(_np(p[0]), np.asarray(r[0]))
    np.testing.assert_array_equal(_np(p[1]), np.asarray(r[1]))
    assert int(_np(p[1])[17]) == RG.KEY_MAX


def test_dist_select_small(meshes):
    rm, pm = meshes
    rng = np.random.default_rng(1)
    n_codes = 20
    per = 1024
    n = N_DEV * per
    codes = rng.integers(0, n_codes, n).astype(np.int32)
    mask = rng.random(n) > 0.3
    codes_m = np.where(mask, codes, n_codes).astype(np.int32)
    vals = rng.uniform(-5, 5, n)
    ints = rng.integers(0, 200, n).astype(np.int64)
    ins = [_shard(meshes, a) for a in (
        codes_m, ints.astype(np.float32), vals,
        np.where(mask, ints, RG.KEY_MAX), np.where(mask, ints, RG.I64_MIN))]
    args = dict(n_sums=1, n_mins=1, n_maxs=1, n_int_tasks=1)
    r, p = _stats_equal(
        lambda: R.dist_select_small(rm, n_codes, per, **args)(
            *[x[0] for x in ins]),
        lambda: D.dist_select_small(pm, n_codes, per, **args)(
            *[x[1] for x in ins]))
    assert set(p) == set(r)
    for k in r:
        want, got = np.asarray(r[k]), _np(p[k])
        if k == "sum0":
            np.testing.assert_allclose(got, want, rtol=1e-12)
        else:
            np.testing.assert_array_equal(got, want.astype(got.dtype), k)
    ref_cnt = np.bincount(codes[mask], minlength=n_codes)
    np.testing.assert_array_equal(_np(p["counts"]), ref_cnt)


def test_dist_filter_group_sum(meshes):
    rm, pm = meshes
    rng = np.random.default_rng(8)
    n_codes = 45
    n = N_DEV * 600
    codes = rng.integers(0, n_codes, n).astype(np.int32)
    vals = rng.uniform(-3, 9, n)
    mask = rng.random(n) < 0.6
    ins = [_shard(meshes, a) for a in (codes, vals, mask)]
    r, p = _stats_equal(
        lambda: R.dist_filter_group_sum(rm, n_codes)(*[x[0] for x in ins]),
        lambda: D.dist_filter_group_sum(pm, n_codes)(*[x[1] for x in ins]))
    want = np.zeros(n_codes + 1)
    c = np.where(mask, codes, n_codes)
    np.add.at(want, c, vals)
    np.testing.assert_allclose(_np(p[0]), want, rtol=1e-12)
    np.testing.assert_allclose(_np(p[0]), np.asarray(r[0]), rtol=1e-5)
    np.testing.assert_array_equal(_np(p[1]), np.bincount(
        c, minlength=n_codes + 1).astype(np.float64))
    np.testing.assert_array_equal(_np(p[1]), np.asarray(r[1]))


@pytest.mark.parametrize("capacity", [512, 8])
def test_dist_shuffle_routing(meshes, capacity):
    """Routing equals the reference's slot for slot; a tight capacity
    reports its overflow (never drops silently) and the auto wrapper's
    doubling retry routes every row."""
    rm, pm = meshes
    rng = np.random.default_rng(2)
    n = N_DEV * 256
    keys = rng.integers(0, 5000, n).astype(np.int64)
    vals = rng.integers(0, 100, n).astype(np.int64)
    rk, pk = _shard(meshes, keys)
    rv, pv = _shard(meshes, vals)
    r, p = _stats_equal(lambda: R.dist_shuffle(rm, capacity)(rk, rv),
                        lambda: D.dist_shuffle(pm, capacity)(pk, pv))
    for i in range(3):
        np.testing.assert_array_equal(torch.cat(p[i]).numpy(),
                                      np.asarray(r[i]))
    ovf = int(p[3][0])
    assert ovf == int(np.asarray(r[3])[0])
    valid = torch.stack(p[2])
    for d in range(N_DEV):
        assert (p[0][d][p[2][d]] % N_DEV == d).all()
    assert int(valid.sum()) + ovf == n
    assert (ovf > 0) == (capacity == 8)
    rk3, _rv3, v3 = D.dist_shuffle_auto(pm, capacity)(pk, pv)
    assert int(torch.stack(v3).sum()) == n
    got = torch.cat(rk3)[torch.cat(v3)].numpy()
    np.testing.assert_array_equal(np.sort(got), np.sort(keys))


def _first_appearance(codes):
    seen = {}
    for i, c in enumerate(codes):
        if c >= 0 and c not in seen:
            seen[c] = i
    return sorted(seen, key=lambda c: seen[c])


def _wide(meshes, codes, lanes, lane_ops, per, n_codes=None):
    rm, pm = meshes
    rc, pc = _shard(meshes, codes)
    ls = [_shard(meshes, x) for x in lanes]
    r, p = _stats_equal(
        lambda: R.dist_wide_groupby_auto(rm, per, lane_ops, n_codes)(
            rc, *[x[0] for x in ls]),
        lambda: D.dist_wide_groupby_auto(pm, per, lane_ops, n_codes)(
            pc, *[x[1] for x in ls]))
    ng = int(np.asarray(r[0])[0])
    assert int(p[0][0]) == ng
    # codes, counts and first-row ids exactly; f64 lanes within 1e-12
    for i, (a, b) in enumerate(zip(r[1:], p[1:])):
        want, got = np.asarray(a)[:ng], _np(b)[:ng]
        if i < 3:
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)
    assert _np(p[1])[:ng].tolist() == _first_appearance(codes)
    return ng, [_np(x)[:ng] for x in p[1:]]


@pytest.mark.parametrize("n_codes", [None, 3000])
def test_dist_wide_groupby(meshes, n_codes):
    rng = np.random.default_rng(3)
    per = 1024
    n = N_DEV * per
    codes = rng.integers(0, 3000, n).astype(np.int64)
    codes[rng.random(n) < 0.1] = -1        # masked (filtered) rows
    vals = rng.uniform(0, 10, n)
    _ng, (code, cnt, _fidx, s) = _wide(meshes, codes, [vals], ("sum",),
                                       per, n_codes)
    for i, c in enumerate(code):
        sel = codes == c
        assert cnt[i] == sel.sum()
        assert abs(s[i] - vals[sel].sum()) <= 1e-12 * vals[sel].sum()


def test_dist_wide_groupby_skewed(meshes):
    """One heavy key owning 60% of the rows: at most one partial per
    shard rides the exchange, and the result is exact."""
    rng = np.random.default_rng(4)
    per = 512
    n = N_DEV * per
    codes = rng.integers(0, 500, n).astype(np.int64)
    codes[rng.random(n) < 0.6] = 137
    vals = rng.uniform(0, 1, n)
    _ng, (code, cnt, _f, s) = _wide(meshes, codes, [vals], ("sum",), per)
    hh = np.nonzero(code == 137)[0]
    assert len(hh) == 1
    assert cnt[hh[0]] == int((codes == 137).sum())
    assert abs(s[hh[0]] - vals[codes == 137].sum()) < 1e-9


def test_dist_wide_groupby_lanes(meshes):
    """Every lane kind in one kernel: sum, min, max, first, last."""
    rng = np.random.default_rng(7)
    per = 512
    n = N_DEV * per
    codes = rng.integers(0, 900, n).astype(np.int64)
    codes[rng.random(n) < 0.15] = -1
    va = rng.uniform(-50, 50, n)
    vb = rng.uniform(0, 1000, n)
    ops = ("sum", "min", "max", "first", "last")
    _ng, (code, _c, _f, s, mn, mx, fv, lv) = _wide(
        meshes, codes, [va, va, vb, vb, vb], ops, per)
    for i, c in enumerate(code):
        sel = np.nonzero(codes == c)[0]
        assert abs(s[i] - va[sel].sum()) < 1e-8
        assert mn[i] == va[sel].min()
        assert mx[i] == vb[sel].max()
        assert fv[i] == vb[sel[0]]
        assert lv[i] == vb[sel[-1]]


def test_dist_wide_groupby_overflow_retry(meshes):
    """A merge capacity below the groups one shard owns overflows; the
    auto wrapper reruns doubled and the answer is the reference's."""
    rm, pm = meshes
    rng = np.random.default_rng(9)
    per = 256
    codes = (rng.integers(0, 300, N_DEV * per) * N_DEV).astype(np.int64)
    vals = rng.uniform(0, 1, N_DEV * per)
    rc, pc = _shard(meshes, codes)
    rv, pv = _shard(meshes, vals)
    out = D.dist_wide_groupby(pm, per, 64)(pc, pv)
    assert int(out[1][0]) > 0
    assert int(out[1][0]) == int(np.asarray(
        R.dist_wide_groupby(rm, per, 64)(rc, rv)[1])[0])
    _wide(meshes, codes, [vals], ("sum",), per)


def _med(meshes, codes, lanes, per, cap=None):
    """Both packages' median kernels; medians bit for bit. With `cap`,
    the kernel at that capacity (its overflow lanes must be 0);
    otherwise the auto wrapper."""
    rm, pm = meshes
    rc, pc = _shard(meshes, codes)
    ls = [_shard(meshes, x) for x in lanes]
    if cap is None:
        fr = R.dist_med_groupby_auto(rm, per, len(lanes))
        fp = D.dist_med_groupby_auto(pm, per, len(lanes))
    else:
        fr = R.dist_med_groupby(rm, per, cap, cap, len(lanes))
        fp = D.dist_med_groupby(pm, per, cap, cap, len(lanes))
    r, p = _stats_equal(lambda: fr(rc, *[x[0] for x in ls]),
                        lambda: fp(pc, *[x[1] for x in ls]))
    if cap is not None:
        assert int(p[1][0]) == 0 and int(p[2][0]) == 0
        r, p = (r[0],) + tuple(r[3:]), (p[0],) + tuple(p[3:])
    ng = int(np.asarray(r[0])[0])
    assert int(p[0][0]) == ng
    for a, b in zip(r[1:], p[1:]):
        want, got = np.asarray(a)[:ng], _np(b)[:ng]
        np.testing.assert_array_equal(got.view(np.int64),
                                      want.view(np.int64))
    code = _np(p[1])[:ng]
    assert code.tolist() == _first_appearance(codes)
    for j, vals in enumerate(lanes):
        meds = _np(p[3 + j])[:ng]
        for i, c in enumerate(code):
            v = np.sort(vals[codes == c])
            v = v[~np.isnan(v)]
            if len(v) == 0:
                assert np.isnan(meds[i])
            else:
                e = len(v)
                assert meds[i] == (v[(e - 1) // 2] + v[e // 2]) / 2.0
    return code


def test_dist_med_groupby(meshes):
    """NaN nulls skipped; more groups land on a shard than the initial
    output capacity holds, so the auto wrapper's doubling retry runs."""
    rng = np.random.default_rng(21)
    per = 512
    n = N_DEV * per
    codes = rng.integers(0, 3000, n).astype(np.int64)
    codes[rng.random(n) < 0.1] = -1
    va = rng.uniform(-100, 100, n)
    va[rng.random(n) < 0.2] = np.nan
    vb = rng.uniform(0, 50, n)
    D.reset_stats()
    _med(meshes, codes, [va, vb], per)
    assert D.stats["kernel_calls"] > 1          # retried


@pytest.mark.parametrize("auto", [False, True])
def test_dist_med_groupby_skewed(meshes, auto):
    """~99% of the rows on two heavy keys: their medians come from the
    distributed rank search (the candidate path), so the kernel succeeds
    at the initial capacity (auto: the wrapper runs it once); still
    exact, nulls included."""
    rng = np.random.default_rng(33)
    per = 512
    n = N_DEV * per
    codes = rng.integers(0, 400, n).astype(np.int64)
    hot = rng.random(n) < 0.99
    codes[hot] = np.where(rng.random(hot.sum()) < 0.7, 137, 22)
    codes[rng.random(n) < 0.02] = -1
    va = rng.uniform(-1000, 1000, n)
    va[rng.random(n) < 0.15] = np.nan
    vb = rng.standard_normal(n) * 1e6
    vb[:40] = -0.0
    cap = max(2 * per // N_DEV, 64)
    code = _med(meshes, codes, [va, vb], per, cap=None if auto else cap)
    assert {137, 22} <= set(code.tolist())
    if auto:
        assert D.stats["kernel_calls"] == 1


def test_med_rank_search_extremes(meshes):
    """The rank search over the whole f64 order: infinities, negative
    and positive values, a candidate with one value, one with only
    nulls."""
    rng = np.random.default_rng(44)
    per = 256
    n = N_DEV * per
    codes = np.full(n, 5, np.int64)
    codes[::3] = 9
    codes[7] = 1                                # a light group
    v = rng.standard_normal(n) * 1e300
    v[::11] = np.inf
    v[::13] = -np.inf
    v[codes == 9] = np.nan                      # all null
    _med(meshes, codes, [v], per, cap=max(2 * per // N_DEV, 64))


def test_dist_kernels_sort_through_the_psort_entry(meshes, monkeypatch):
    """Every sort of the mesh kernels goes through psort.sort_i32 (the
    CUDA radix sort on the card); none calls torch.sort itself."""
    calls = []
    real = psort.sort_i32

    def counting(ops, n_keys=1, perm=False):
        calls.append((len(ops), n_keys))
        return real(ops, n_keys, perm)

    monkeypatch.setattr(psort, "sort_i32", counting)
    rng = np.random.default_rng(6)
    per = 128
    codes = rng.integers(0, 50, N_DEV * per).astype(np.int64)
    vals = rng.uniform(0, 1, N_DEV * per)
    _rm, pm = meshes
    pc = D.shard_rows(pm, codes)[0]
    pv = D.shard_rows(pm, vals)[0]
    D.dist_wide_groupby_auto(pm, per, ("sum", "last"))(pc, pv, pv)
    # stage A per shard, stage C's two merge sorts per shard, stage D
    assert len(calls) == 3 * N_DEV + 1
    calls.clear()
    D.dist_med_groupby_auto(pm, per, 1)(pc, pv)
    assert calls
    import inspect
    assert "torch.sort" not in inspect.getsource(D)


# -- stage A of dist_wide_groupby: the kernels' path and the plain one ------

def _parent_stage_a(me, codes, lanes, lane_ops, n_dev, rows_local, n_codes):
    """dist_wide_groupby's stage A as it was before csrc/shard_partials.cu,
    frozen as the oracle: (code << pos_bits) | position sorted as one i64
    key, then the torch formulas."""
    C = rows_local if n_codes is None else min(rows_local, n_codes)
    D_ = C if n_codes is None else max(min(C, -(-n_codes // n_dev)), 1)
    size = n_dev * D_
    has_last = "last" in lane_ops
    n = int(codes.shape[0])
    pos_bits = max(int(n - 1).bit_length(), 1)
    posmask = (1 << pos_bits) - 1
    key = torch.where(codes >= 0, (codes << pos_bits) | torch.arange(n),
                      D.KEY_MAX)
    (skey,), _, perm = D.sort_lex([key], perm=True)
    perm = perm.long()
    svals = [x[perm] for x in lanes]
    sc = skey >> pos_bits
    valid = skey != D.KEY_MAX
    flags = valid & D._new_run(sc)
    tf = D._compact_targets(flags, C)
    tl = D._compact_targets(valid & D._run_end(sc), C)
    pcode = D._place(sc, tf, C, -1)
    gid = (skey & posmask) + me * n
    pfirst = D._place(gid, tf, C, D.KEY_MAX)
    plast = D._place(gid, tl, C, -1) if has_last else None
    iota = torch.arange(n)
    start = D._place(iota, tf, C, 0)
    end = D._place(iota, tl, C, 0)
    seg = torch.cumsum(flags.to(torch.int32) + (~valid).to(torch.int32), 0,
                       dtype=torch.int32)
    out = [(pcode, -1), (end - start + 1, 0), (pfirst, D.KEY_MAX)]
    scan = [i for i, op in enumerate(lane_ops)
            if op not in ("first", "last")]
    red = dict(zip(scan, D._rscan_lanes(
        seg, [lane_ops[i] for i in scan], [svals[i] for i in scan])))
    for i, (op, sv) in enumerate(zip(lane_ops, svals)):
        if op == "first":
            v = D._place(sv, tf, C, 0.0)
        elif op == "last":
            v = D._place(sv, tl, C, 0.0)
        else:
            v = D._place(red.pop(i), tf, C, 0.0)
        out.append((v, D._LANE_FILL[op]))
    if has_last:
        out.append((plast, -1))
    live = pcode >= 0
    slot, _ok = D._bucket_slots(pcode % n_dev, n_dev, D_, live)
    return [D._place(x, slot, size, fill) for x, fill in out], D_


_U64 = np.uint64
_KEY_MAX_WORDS = _U64(0x7FFFFFFF7FFFFFFF)


class _PartialsModel:
    """A model of csrc/shard_partials.cu behind its C interface: it reads
    and writes the tensors' memory at the pointers the wrapper passes,
    chunk by chunk as the `runs` launches count, offset and place."""

    def __init__(self, rc=0):
        self.rc = rc
        self.calls = []

    def rf_shard_partials_keys(self, n, codes, stride, wide, sentinel, hi,
                               lo, n_lanes, src, src_stride, width, rows,
                               stream):
        self.calls.append(("keys", stream))
        if n_lanes:
            r = _at(rows, _U64, n * width).reshape(n, width)
            r[:] = 0
            for i in range(n_lanes):
                r[:, i] = _at(src[i], _U64, n, src_stride[i])
        c = _at(codes, np.int64, n, stride)
        if wide:
            v = np.where(c >= 0, c, D.KEY_MAX).view(_U64)
            _at(hi, np.uint32, n)[:] = v >> _U64(32)
            _at(lo, np.uint32, n)[:] = \
                v.astype(np.uint32) ^ np.uint32(0x80000000)
        else:
            _at(hi, np.int32, n)[:] = np.where(c >= 0, c, sentinel)
        return self.rc

    # reduce and carry: the plain version's reversed scan at the run heads,
    # with the kernels' data flow (csrc/shard_partials.cu's header)
    _B = 1024
    _LEAD, _G, _JOINT, _CARRY = 0x7FF, 1 << 11, 1 << 12, 1 << 13
    _PAD = _U64(0xFFFFFFFFFFFFFFFF)
    _IDENT = {0: np.inf, 1: -np.inf, 2: 0.0}
    _OP = {0: np.minimum, 1: np.maximum, 2: np.add}

    @staticmethod
    def _scratch(n, lanes):
        """Offsets of the scratch's words, tails, counters, chain records,
        pieces and piece trees, and its size (the source's scratch_of)."""
        def a256(x):
            return -(-x // 256) * 256
        R = -(-n // 1024)
        pieces = 2 * (R // 1024) + 2
        words, tails = 0, a256(4 * R)
        ctl = tails + a256(8 * R * lanes)
        chain = ctl + 256
        piece = chain + a256(20 * (R // 1024 + 1))
        pval = piece + a256(4 * pieces)
        return dict(words=words, tails=tails, ctl=ctl, chain=chain,
                    piece=piece, pval=pval,
                    total=pval + a256(8 * pieces * lanes))

    def rf_shard_partials_scratch_bytes(self, n, n_lanes):
        return self._scratch(n, n_lanes)["total"]

    def _ids(self, n, hi, lo, sentinel):
        """Each sorted row's id: its key, a masked row its own value."""
        k = self._key(n, hi, lo)
        masked = k == (_KEY_MAX_WORDS if lo is not None
                       else _U64(sentinel & 0xFFFFFFFF))
        return np.where(masked, _U64(1 << 63) | np.arange(n, dtype=_U64), k)

    def rf_shard_partials_reduce(self, n, hi, lo, sentinel, perm, n_lanes,
                                 ops, src, src_stride, width, heads,
                                 head_stride, scratch, stream):
        self.calls.append(("reduce", stream))
        assert not width or head_stride == n_lanes
        B = self._B
        R = -(-n // B)
        pad = R * B - n
        # the flipped rows in R blocks, pads past n
        ids = np.r_[self._ids(n, hi, lo, sentinel)[::-1],
                    np.full(pad, self._PAD)].reshape(R, B)
        flat = ids.reshape(-1)
        valid = (flat >> _U64(63)) == 0
        head = (valid & (np.r_[flat[1:], self._PAD] != flat)).reshape(R, B)
        first, last = ids[:, 0], ids[:, -1]
        joint = np.r_[True, first[1:] != last[:-1]]
        firsts = ids == first[:, None]
        lead = np.where(firsts.all(1), B, np.argmin(firsts, 1))
        after = np.r_[ids[1:, 0], self._PAD]
        here = ((first >> _U64(63)) == 0) & ((lead < B) | (after != first))
        words = lead | np.where(joint | (first != last), self._G, 0) | \
            np.where(joint, self._JOINT, 0) | \
            np.where(~joint & here, self._CARRY, 0)
        lay = self._scratch(n, n_lanes)
        _at(scratch + lay["words"], np.uint32, R)[:] = words
        tails = _at(scratch + lay["tails"], np.float64,
                    R * n_lanes).reshape(R, n_lanes)
        p = _at(perm, np.int32, n).astype(np.int64)
        rows = _at(src[0], np.float64, n * width).reshape(n, width) \
            if width else None
        b = np.nonzero(head.reshape(-1))[0]
        for j in range(n_lanes):
            op, ident = self._OP[ops[j]], self._IDENT[ops[j]]
            v = rows[p, j] if width else \
                _at(src[j], np.float64, n, src_stride[j])[p]
            m = np.r_[v[::-1], np.full(pad, ident)].reshape(R, B)
            d = 1
            while d < B:
                same = ids[:, d:] == ids[:, :-d]
                m = np.concatenate(
                    [m[:, :d], op(m[:, d:], np.where(same, m[:, :-d],
                                                     ident))], 1)
                d *= 2
            tails[:, j] = m[:, -1]
            if ops[j] == 2:          # step 3 with the identity, joint blocks
                m = np.where(joint[:, None] & firsts, m + 0.0, m)
            _at(heads + 8 * j, np.float64, n, head_stride)[n - 1 - b] = \
                m.reshape(-1)[b]
        _at(scratch + lay["ctl"], np.int32, 2)[:] = 0
        return self.rc

    @classmethod
    def _tree(cls, vals, op):
        """The kernels' warp tree over vals (j = 0 the chain's last tail,
        at most 1024): lane l's 32 tails in its registers, then the lanes
        by shuffles."""
        v = list(vals) + [None] * (1024 - len(vals))
        count = len(vals)
        for lane in range(32):
            for h in (1, 2, 4, 8, 16):
                for k in range(0, 32 - h, 2 * h):
                    if 32 * lane + k + h < count:
                        v[32 * lane + k] = op(v[32 * lane + k + h],
                                              v[32 * lane + k])
        x = [v[32 * lane] for lane in range(32)]
        for o in (1, 2, 4, 8, 16):
            for lane in range(0, 32, 2 * o):
                if 32 * (lane + o) < count:
                    x[lane] = op(x[lane + o], x[lane])
        return x[0]

    @classmethod
    def _chain_start(cls, words, k, n, rb, h):
        """The chain's first block as the kernel finds it: a g block among
        the 32 summary words below rb, else a 32-way gallop and search for
        the lowest block whose last row holds the head's key."""
        below = [r for r in range(rb - 1, rb - 33, -1)
                 if r >= 0 and words[r] & cls._G]
        if below:
            return below[0]

        def same(r):
            return k[n - 1024 * (r + 1)] == k[h]

        hi, step = rb - 32, 32
        while True:
            q = [hi - step * (lane + 1) for lane in range(32)]
            false = [lane for lane in range(32)
                     if not (q[lane] >= 0 and same(q[lane]))]
            if false:
                f = false[0]
                lo, hi = hi - step * (f + 1), hi - step * f
                break
            hi, step = hi - step * 32, step * 32
        lo = max(lo, -1)
        while hi - lo > 1:
            st = -(-(hi - lo) // 32)
            q = [lo + st * (lane + 1) for lane in range(32)]
            f = next(lane for lane in range(32)
                     if q[lane] >= hi or same(q[lane]))
            hi, lo = min(lo + st * (f + 1), hi), lo + st * f
        return hi

    def rf_shard_partials_carry(self, n, hi, lo, n_lanes, ops, heads,
                                head_stride, scratch, stream):
        self.calls.append(("carry", stream))
        B = self._B
        R = -(-n // B)
        lay = self._scratch(n, n_lanes)
        words = _at(scratch + lay["words"], np.uint32, R).astype(np.int64)
        tails = _at(scratch + lay["tails"], np.float64,
                    R * n_lanes).reshape(R, n_lanes)
        k = self._key(n, hi, lo)
        for rb in np.nonzero(words & self._CARRY)[0].tolist():
            h = int(n - rb * B - (words[rb] & self._LEAD))
            ra = self._chain_start(words, k, n, rb, h)
            K = rb - ra
            for j in range(n_lanes):
                op = self._OP[ops[j]]
                chain = tails[ra:rb, j][::-1]
                if K <= 1024:
                    pfx = self._tree(chain, op)
                else:
                    pv = [self._tree(chain[i:i + 1024], op)
                          for i in range(0, K, 1024)]
                    pfx = self._tree(pv[:1024], op)
                    if len(pv) > 1024:
                        pfx = op(self._tree(pv[1024:], op), pfx)
                o = _at(heads + 8 * j + 8 * h * head_stride, np.float64, 1)
                o[0] = op(o[0], pfx)
        return self.rc

    def _key(self, n, hi, lo):
        """The sorted key's rows as 64-bit patterns (equal keys, equal
        patterns)."""
        h = _at(hi, np.uint32, n).astype(_U64)
        return h if lo is None else \
            (h << _U64(32)) | _at(lo, np.uint32, n).astype(_U64)

    @staticmethod
    def _code(k, lo):
        """The codes of the key patterns k."""
        if lo is None:
            return k.astype(np.uint32).view(np.int32).astype(np.int64)
        return ((k >> _U64(32)) << _U64(32) |
                ((k & _U64(0xFFFFFFFF)) ^ _U64(0x80000000))).view(np.int64)

    def rf_shard_partials_runs(self, n, hi, lo, sentinel, n_dev, D_, counts,
                               totals, seg, hrow, erow, stream):
        self.calls.append(("runs", stream))
        k = self._key(n, hi, lo)
        valid = k != (_KEY_MAX_WORDS if lo is not None
                      else _U64(sentinel & 0xFFFFFFFF))
        head = valid & np.r_[True, k[1:] != k[:-1]]
        end = valid & np.r_[k[1:] != k[:-1], True]
        bk = np.where(valid, self._code(k, lo) % n_dev, -1)
        chunk = np.arange(n) // D.SP_CHUNK
        n_chunks = -(-n // D.SP_CHUNK)
        cnt = np.zeros((n_dev + 1, n_chunks), np.int64)
        np.add.at(cnt, (bk[head], chunk[head]), 1)
        inc = head.astype(np.int64) + ~valid
        np.add.at(cnt[n_dev], chunk, inc)
        off = np.cumsum(cnt, 1) - cnt              # exclusive, a row each
        _at(counts, np.int32, (n_dev + 1) * n_chunks)[:] = off.reshape(-1)
        _at(totals, np.int32, n_dev + 1)[:] = cnt.sum(1)
        first = np.arange(n_chunks) * D.SP_CHUNK

        def within(x):
            """x's inclusive prefix count inside each row's chunk."""
            cs = np.cumsum(x)
            return cs - (cs - x)[first][chunk]

        if seg is not None:
            _at(seg, np.int32, n)[:] = off[n_dev][chunk] + within(inc)
        hr, er = _at(hrow, np.int32, n_dev * D_), _at(erow, np.int32,
                                                      n_dev * D_)
        for b in range(n_dev):
            hb = head & (bk == b)
            rank = off[b][chunk] + within(hb.astype(np.int64)) - 1
            for rows, buf in ((hb, hr), (end & (bk == b), er)):
                keep = rows & (rank < D_)
                buf[b * D_ + rank[keep]] = np.nonzero(keep)[0]
        return self.rc

    def rf_shard_partials_place(self, size, D_, n_dev, base, totals, hrow,
                                erow, hi, lo, perm, code, count, first,
                                last, n_lanes, src, stride, at, fill, dst,
                                stream):
        self.calls.append(("place", stream))
        s = np.arange(size)
        b = s // D_
        live = s - b * D_ < _at(totals, np.int32, n_dev + 1)[b]
        h = np.where(live, _at(hrow, np.int32, size), 0)
        e = np.where(live, _at(erow, np.int32, size), 0)
        rows = int(max(h.max(initial=0), e.max(initial=0))) + 1
        p = _at(perm, np.int32, rows).astype(np.int64)
        if code is not None:
            c = self._code(self._key(rows, hi, lo), lo)
            _at(code, np.int64, size)[:] = np.where(live, c[h], -1)
            _at(count, np.int64, size)[:] = np.where(live, e - h + 1, 0)
            _at(first, np.int64, size)[:] = np.where(live, p[h] + base,
                                                     D.KEY_MAX)
        if last is not None:
            _at(last, np.int64, size)[:] = np.where(live, p[e] + base, -1)
        for i in range(n_lanes):
            row = h if at[i] == 0 else p[h] if at[i] == 1 else p[e]
            n_src = int(row.max(initial=0)) + 1
            v = _at(src[i], _U64, n_src, stride[i])[row]
            _at(dst[i], _U64, size)[:] = np.where(
                live, v, np.float64(fill[i]).view(_U64))
        return self.rc


@pytest.fixture
def partials_model(monkeypatch):
    import contextlib
    lib = _PartialsModel()
    monkeypatch.setattr(D, "_sp_lib", lib)
    monkeypatch.setattr(D.G, "_card_stream",
                        lambda device: contextlib.nullcontext(4321))
    return lib


STAGE_A_KEYS = {"i32": 3000, "i64": None, "i64_known": 1 << 40}


# run lengths of the "edges" layouts: every run ends on a 1024-row block
# boundary of the reversed layout (the shard's 10 240 rows less 1024
# masked ones, which sort last), two runs share a block
_EDGE_RUNS = (1024, 2048, 1024, 3072, 512, 512, 1024)


def _stage_a_case(n_dev, key, skewed, seed):
    """Per shard (me, codes, lanes) of n_dev shards of 10 000 rows (three
    chunks of the kernels' runs; not a multiple of 1024): 10% masked,
    codes below 3000 (spread over 2^40 for the i64 keys), with `skewed`
    True 60% on one code; lanes with +-0.0 and +-inf among their values.
    The layouts past the skew: "one_run", one code on every row, no
    masked rows (one run over every block of the reversed layout);
    "edges", 10 240 rows in runs of _EDGE_RUNS and 1024 masked rows, so
    that every run ends on a block boundary (joint blocks); "zeros", the
    same runs with -0.0 on every row of the sum's lane, so that the totals
    at the heads of joint blocks' first runs take step 3's identity (-0.0
    + 0.0) and those of runs carried in from an earlier block stay -0.0
    (min and max keep nonzero values: torch's CPU minimum and maximum
    return either zero of a +-0.0 pair, by vector or scalar path)."""
    rng = np.random.default_rng(seed)
    per = 10_240 if skewed in ("edges", "zeros") else 10_000
    if skewed in ("edges", "zeros"):
        codes = np.concatenate([np.concatenate(
            [np.repeat(rng.choice(3000, len(_EDGE_RUNS), replace=False),
                       _EDGE_RUNS), np.full(1024, -1)])[rng.permutation(per)]
            for _ in range(n_dev)])
    else:
        codes = rng.integers(0, 3000, n_dev * per).astype(np.int64)
    if skewed is True:
        codes[rng.random(codes.size) < 0.6] = 137
    if skewed == "one_run":
        codes[:] = 137
    if key != "i32":
        codes = np.where(codes >= 0, codes * 366_503_875 + 11, -1)
    if skewed in (False, True):
        codes[rng.random(codes.size) < 0.1] = -1
    lanes = [rng.uniform(-50, 50, codes.size) for _ in range(5)]
    lanes[0][::97] = np.inf
    lanes[1][::89] = -np.inf
    lanes[2][::83] = -0.0
    lanes[3][::79] = 0.0
    if skewed == "zeros":
        lanes[0][:] = -0.0
        lanes[3][::2] = -0.0
        lanes[4][::3] = 0.0
    return [(me, torch.from_numpy(codes[me * per:(me + 1) * per].copy()),
             [torch.from_numpy(x[me * per:(me + 1) * per].copy())
              for x in lanes]) for me in range(n_dev)], per


def _bits_equal(got, want, what):
    assert len(got) == len(want), what
    for j, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == w.dtype and g.shape == w.shape, (what, j)
        if g.dtype == torch.float64:
            g, w = g.view(torch.int64), w.view(torch.int64)
        assert torch.equal(g, w), (what, j)


@pytest.mark.parametrize("n_dev", [4, 8])
@pytest.mark.parametrize("key", list(STAGE_A_KEYS))
@pytest.mark.parametrize("skewed", [False, True, "one_run", "edges",
                                    "zeros"])
def test_stage_a_send_buffers_equal_the_parent_formulas(
        partials_model, n_dev, key, skewed):
    """Stage A's send buffers from the code sorted alone equal the
    position-packed formulas' bit for bit, for the plain version and for
    the CUDA wrapper through a model of the kernels (keys, reduce, carry,
    runs, place: one call each, one count of each counter a shard): every
    shard, the lanes sum, min, max, first and last together, over each
    layout of `_stage_a_case`."""
    n_codes = STAGE_A_KEYS[key]
    ops = ("sum", "min", "max", "first", "last")
    shards, per = _stage_a_case(n_dev, key, skewed, 40 + n_dev)
    before = dict(psort.LAUNCHES)
    for me, codes, lanes in shards:
        want, D_ = _parent_stage_a(me, codes, lanes, ops, n_dev, per,
                                   n_codes)
        live = int((want[0] >= 0).sum())
        assert 0 < live < n_dev * D_
        _bits_equal(D.shard_partials(me, codes, lanes, ops, n_dev, D_,
                                     n_codes), want, ("plain", me))
        assert partials_model.calls == []
        _bits_equal(D.shard_partials_cuda(me, codes, lanes, ops, n_dev, D_,
                                          n_codes), want, ("kernel", me))
        assert partials_model.calls == [(s, 4321) for s in (
            "keys", "reduce", "carry", "runs", "place")]
        del partials_model.calls[:]
    for counter in ("shard_partials", "shard_reduce"):
        assert psort.LAUNCHES[counter] == before[counter] + n_dev, counter
    if skewed == "zeros":
        # both signs of zero reach the sum's send buffer
        sums = torch.cat([D.shard_partials_plain(
            me, c, ls, ops, n_dev, D_, n_codes)[3] for me, c, ls in shards])
        bits = set(sums.view(torch.int64).tolist())
        assert {0, -(1 << 63)} <= bits


@pytest.mark.parametrize("ops", [
    ("sum", "sum", "last"),                      # two lanes side by side
    ("min",),                                    # one lane, read alone
    ("sum",) * 3 + ("max", "first", "min")])     # five, read one by one
def test_stage_a_lane_routes_equal_the_parent_formulas(partials_model, ops):
    """The lanes' other routes through the kernel model: two scanned lanes
    laid side by side in 16-byte rows, one lane gathered alone, five
    gathered one by one; bit for bit the parent formulas' buffers."""
    shards, per = _stage_a_case(4, "i32", False, 7)
    for me, codes, lanes in shards[:2]:
        lanes = (lanes * 2)[:len(ops)]
        want, D_ = _parent_stage_a(me, codes, lanes, ops, 4, per, 3000)
        _bits_equal(D.shard_partials_cuda(me, codes, lanes, ops, 4, D_,
                                          3000), want, ("kernel", me, ops))
        _bits_equal(D.shard_partials_plain(me, codes, lanes, ops, 4, D_,
                                           3000), want, ("plain", me, ops))


@pytest.mark.parametrize("rows,n_codes", [
    (1024 * 1100 + 333, 3000),      # one run: a chain of 1100 blocks, two
                                    # pieces
    (1024 * 1100 + 333, None),      # the same on the two-word key
    (1024 * 100 + 7, 3000)])        # two runs over ~50 blocks each:
                                    # the search over the sorted key
def test_stage_a_long_chains_equal_the_parent_formulas(partials_model, rows,
                                                        n_codes):
    """Runs over more blocks than the 32 summary words carry's first look
    covers, and one run over more than a warp's 1024 tails (carry's
    pieces), through the kernel model: bit for bit the parent formulas'
    buffers, one shard of four, sum, max and min lanes side by side."""
    rng = np.random.default_rng(rows)
    if rows > 1 << 20:
        codes = np.full(rows, 7, dtype=np.int64)
    else:
        codes = np.repeat(np.array([5, 16]), -(-rows // 2))[:rows]
        codes = codes[rng.permutation(rows)]
        codes[rng.random(rows) < 0.01] = -1
    if n_codes is None:
        codes = np.where(codes >= 0, codes * 366_503_875 + 11, -1)
    ops = ("sum", "max", "min")
    lanes = [torch.from_numpy(rng.uniform(-50, 50, rows)) for _ in ops]
    lanes[0][::101] = -0.0
    codes = torch.from_numpy(codes)
    want, D_ = _parent_stage_a(1, codes, lanes, ops, 4, rows, n_codes)
    _bits_equal(D.shard_partials_cuda(1, codes, lanes, ops, 4, D_, n_codes),
                want, ("kernel", rows, n_codes))
    assert [c for c, _s in partials_model.calls] == [
        "keys", "reduce", "carry", "runs", "place"]


def test_dist_wide_groupby_through_the_kernel_model(meshes, partials_model,
                                                    monkeypatch):
    """The whole distributed group-by with stage A through the CUDA
    wrapper and the kernel model gives the reference's answer: every lane
    kind, wide and narrow keys."""
    monkeypatch.setattr(D, "shard_partials", D.shard_partials_cuda)
    rng = np.random.default_rng(12)
    per = 700
    n = N_DEV * per
    codes = rng.integers(0, 900, n).astype(np.int64)
    codes[rng.random(n) < 0.1] = -1
    va = rng.uniform(-50, 50, n)
    ops = ("sum", "min", "max", "first", "last")
    for n_codes in (None, 900):
        del partials_model.calls[:]
        _wide(meshes, codes, [va] * 5, ops, per, n_codes)
        assert [c for c, _s in partials_model.calls].count("runs") == N_DEV


def test_shard_partials_dispatch_and_faults(partials_model):
    """A CPU tensor takes the plain version (no launch), another device
    raises DeviceError; a failed launch raises DeviceError, and inputs the
    kernels do not take ValueError, before any launch."""
    from rayforce_tpu_torch.engine.device import DeviceError
    codes = torch.arange(50, dtype=torch.int64) % 7
    lanes = [torch.ones(50, dtype=torch.float64)]
    before = psort.LAUNCHES["shard_partials"]
    D.shard_partials(0, codes, lanes, ("sum",), 4, 2, 7)
    assert partials_model.calls == [] and \
        psort.LAUNCHES["shard_partials"] == before
    with pytest.raises(DeviceError):
        D.shard_partials(0, torch.empty(8, dtype=torch.int64, device="meta"),
                         [], (), 4, 2, 7)
    for bad in [
            (codes.to(torch.int32), lanes, ("sum",), 4),
            (codes, [lanes[0].float()], ("sum",), 4),
            (codes, [lanes[0][:10]], ("sum",), 4),
            (codes, lanes, ("sum", "sum"), 4),
            (codes, lanes, ("median",), 4),
            (codes, lanes, ("sum",), D.SP_MAX_DEV + 1)]:
        with pytest.raises(ValueError):
            D.shard_partials_cuda(0, bad[0], bad[1], bad[2], bad[3], 2, 7)
    assert partials_model.calls == []
    partials_model.rc = 700
    with pytest.raises(DeviceError, match="cudaError 700"):
        D.shard_partials_cuda(0, codes, lanes, ("sum",), 4, 2, 7)
    assert psort.LAUNCHES["shard_partials"] == before


def test_shard_partials_argtypes_match_the_cuda_source():
    """dist.py's ctypes table against every extern "C" signature of
    csrc/shard_partials.cu, pointer versus 64-bit versus 32-bit int at
    every position; the chunk and the limits against the source's."""
    import ctypes
    import os
    import re
    from test_torch_psort import _extern_c_signatures

    def kind(t):
        if t is ctypes.c_void_p:
            return "ptr"
        return "i64" if ctypes.sizeof(t) == 8 else "i32"

    sigs = _extern_c_signatures("shard_partials")
    assert set(sigs) == set(D.SHARD_PARTIALS_ARGTYPES)
    for name, (res, args) in D.SHARD_PARTIALS_ARGTYPES.items():
        assert sigs[name] == (kind(res), [kind(a) for a in args]), name
    src = open(os.path.join(os.path.dirname(psort.__file__), "csrc",
                            "shard_partials.cu")).read()
    for const in ("SP_CHUNK", "SP_MAX_DEV", "SP_MAX_LANES", "SP_ROW_LANES"):
        assert re.search(rf"#define {const} (\d+)", src).group(1) == \
            str(getattr(D, const)), const
    # no kernel name that another family's roofline reader would count
    assert not re.search(r"\b(hist|plan|pass|identity|gather|small)_kernel"
                         r"\b|seg_scan::|wide_keys::", src)
