"""The port's group-by kernels (engine/groupby.py) against the JAX
package's on the same seeded arrays:

- the segmented scan (`_seg_scan`, the two-level log-doubling
  min/max/sum over sorted runs) for i32, i64 and f64 lanes; lengths are
  not multiples of the 1024-wide block, and runs cross block
  boundaries;
- the dense aggregates of the <=512-code select (`bcast_scan`), the
  exact limb sums (`int_limb_weights`, `matmul_tasks_scan`,
  `recombine_limbs`) and the output packing (`Packer`, `unpack`), for
  1 to 512 codes, row counts that are not multiples of the TPU's
  65536-row chunk (one beyond it), empty codes, nulls and NaN.

Integer lanes, row ids and extrema must be exact; f64 sums within rtol
1e-12 (the summation orders differ), atol 1e-9 for the dense sums."""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from rayforce_tpu.engine import groupby as RG
from rayforce_tpu_torch.engine import groupby as G

torch.set_num_threads(1)

_ref_scan = jax.jit(RG._seg_scan, static_argnames="op")


def _segments(rng, n, mean_run):
    runs = rng.geometric(1.0 / mean_run, size=n)
    seg = np.repeat(np.arange(len(runs)), runs)[:n]
    return seg.astype(np.int32)


def _vals(rng, n, dtype):
    if dtype == "f64":
        return rng.uniform(-1e6, 1e6, n)
    if dtype == "i32":
        return rng.integers(-2**20, 2**20, n).astype(np.int32)
    return rng.integers(-2**50, 2**50, n).astype(np.int64)


@pytest.mark.parametrize("dtype", ["i32", "i64", "f64"])
@pytest.mark.parametrize("n,mean_run", [(5000, 3), (10_241, 2500),
                                        (1, 1)])
def test_seg_scan_matches_reference(dtype, n, mean_run):
    rng = np.random.default_rng(n + mean_run)
    seg = _segments(rng, n, mean_run)
    vals = _vals(rng, n, dtype)
    for op in ("min", "max", "sum"):
        want = np.asarray(_ref_scan(jnp.asarray(seg), jnp.asarray(vals),
                                    op=op))
        got = G._seg_scan(torch.from_numpy(seg), torch.from_numpy(vals),
                          op).numpy()
        assert got.dtype == want.dtype, op
        if dtype == "f64" and op == "sum":
            np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)
        else:
            assert np.array_equal(got, want), op


def test_seg_scan_against_numpy():
    """The scan's definition: inclusive op over each run up to the row."""
    rng = np.random.default_rng(9)
    n = 4099
    seg = _segments(rng, n, 900)
    vals = rng.integers(-1000, 1000, n).astype(np.int64)
    got = {op: G._seg_scan(torch.from_numpy(seg), torch.from_numpy(vals),
                           op).numpy() for op in ("min", "max", "sum")}
    starts = np.flatnonzero(np.r_[True, seg[1:] != seg[:-1]])
    ends = np.r_[starts[1:], n]
    for s, e in zip(starts, ends):
        r = vals[s:e]
        assert np.array_equal(got["sum"][s:e], np.cumsum(r))
        assert np.array_equal(got["min"][s:e], np.minimum.accumulate(r))
        assert np.array_equal(got["max"][s:e], np.maximum.accumulate(r))


# -- the dense kernels of the <=512-code select -------------------------------

def _codes(rng, n, n_rows):
    """Codes in [0, n] (n is the trash slot of masked rows); code 0 is
    left empty when n > 1, so empty groups are covered."""
    c = rng.integers(0, n + 1, n_rows).astype(np.int32)
    if n > 1:
        c[c == 0] = 1
    return c


@pytest.mark.parametrize("n,n_rows", [(1, 977), (7, 70_001), (100, 5003),
                                      (512, 3001)])
def test_bcast_scan_matches_reference(n, n_rows):
    rng = np.random.default_rng(n * 7 + n_rows)
    codes = _codes(rng, n, n_rows)
    f = rng.uniform(-1e6, 1e6, n_rows)
    f[rng.integers(0, n_rows, 20)] = 0.0            # nulls pre-zeroed
    i = rng.integers(-1000, 1000, n_rows).astype(np.int64)
    mn_i = rng.integers(-2**62, 2**62, n_rows).astype(np.int64)
    mn_i[::11] = RG.KEY_MAX                         # nulls -> losing extreme
    mx_f = rng.uniform(-5, 5, n_rows)
    mx_f[::13] = -np.inf
    mx_f[::17] = -0.0
    mn_f = rng.uniform(-5, 5, n_rows)
    mn_f[::19] = np.inf
    want = RG.bcast_scan(jnp.asarray(codes), n, n_rows,
                         sums=(jnp.asarray(f), jnp.asarray(i, jnp.float64)),
                         mins=(jnp.asarray(mn_i), jnp.asarray(mn_f)),
                         maxs=(jnp.asarray(mx_f),))
    got = G.bcast_scan(torch.from_numpy(codes), n, n_rows,
                       sums=(torch.from_numpy(f), torch.from_numpy(i)),
                       mins=(torch.from_numpy(mn_i), torch.from_numpy(mn_f)),
                       maxs=(torch.from_numpy(mx_f),))
    assert sorted(got) == sorted(want)
    for k in want:
        w, g = np.asarray(want[k]), got[k].numpy()
        assert g.dtype == w.dtype and g.shape == w.shape == (n,), k
        if k == "sum0":
            np.testing.assert_allclose(g, w, rtol=1e-12, atol=1e-9)
        else:
            # extrema as bits: -0.0 and 0.0 must not be confused
            assert np.array_equal(g.view(np.int64) if g.dtype == np.float64
                                  else g,
                                  w.view(np.int64) if w.dtype == np.float64
                                  else w), k


def test_bcast_scan_only_fidx():
    """want_counts=False (the flagship step's call): no counts lane."""
    rng = np.random.default_rng(3)
    codes = _codes(rng, 100, 4096)
    p = rng.uniform(0, 100, 4096)
    want = RG.bcast_scan(jnp.asarray(codes), 100, 4096,
                         mins=(jnp.asarray(p),), want_counts=False)
    got = G.bcast_scan(torch.from_numpy(codes), 100, 4096,
                       mins=(torch.from_numpy(p),), want_counts=False)
    assert sorted(got) == sorted(want) == ["fidx", "lidx", "min0"]
    for k in want:
        assert np.array_equal(got[k].numpy(), np.asarray(want[k])), k


@pytest.mark.parametrize("n,n_rows", [(1, 977), (7, 70_001), (100, 5003),
                                      (512, 3001)])
@pytest.mark.parametrize("stats", [True, False])
def test_limb_sums_match_reference(n, n_rows, stats):
    """int_limb_weights -> matmul_tasks_scan -> recombine_limbs: the
    exact full-width group sums of a null-carrying i64 column, with
    cached stats (biased, fewer limbs) and without (8 limbs)."""
    rng = np.random.default_rng(n + n_rows + stats)
    codes = _codes(rng, n, n_rows)
    a = rng.integers(-2**62, 2**62, n_rows).astype(np.int64)
    a[: n_rows // 3] = rng.integers(2**62 - 2**30, 2**62, n_rows // 3)
    nv = np.iinfo(np.int64).min
    a[rng.integers(0, n_rows, max(n_rows // 50, 1))] = nv
    ok = a != nv
    lo, hi = (int(a[ok].min()), int(a[ok].max())) if stats else (None, None)
    rl, rnul, rbias = RG.int_limb_weights(jnp.asarray(a), nv, lo, hi)
    pl, pnul, pbias = G.int_limb_weights(torch.from_numpy(a), nv, lo, hi)
    assert pbias == rbias and len(pl) == len(rl)
    for r, p in zip(rl + [rnul], pl + [pnul]):
        assert np.array_equal(p.numpy(), np.asarray(r).astype(np.int64))
    ones = np.ones(n_rows, np.int32)
    rs = RG.matmul_tasks_scan(jnp.asarray(codes),
                              rl + [rnul, jnp.asarray(ones, jnp.float32)],
                              n + 1, n_rows)
    ps = G.matmul_tasks_scan(torch.from_numpy(codes),
                             pl + [pnul, torch.from_numpy(ones)],
                             n + 1, n_rows)
    assert len(ps) == len(rs)
    for r, p in zip(rs, ps):
        assert p.dtype == torch.float64
        assert np.array_equal(p.numpy(), np.asarray(r))
    # the select pipeline fetches counts and null counts as i64 lanes
    *limbs, nulls, counts = [p.numpy()[:n] for p in ps]
    got = G.recombine_limbs(limbs, pbias, counts.astype(np.int64),
                            nulls.astype(np.int64))
    want = RG.recombine_limbs(
        [np.asarray(r)[:n] for r in rs[:-2]], rbias,
        np.asarray(rs[-1])[:n].astype(np.int64),
        np.asarray(rs[-2])[:n].astype(np.int64))
    assert list(got) == list(want)
    for g in range(n):
        sel = ok & (codes == g)
        assert got[g] == sum(int(x) for x in a[sel])


def test_packer_round_trip_matches_reference():
    """Every lane comes back with the reference's values and dtype,
    from one i64 buffer."""
    rng = np.random.default_rng(4)
    lanes = {
        "nocc": np.array([5], np.int32),
        "slots": rng.integers(0, 512, 300).astype(np.int32),
        "i64": rng.integers(-2**63, 2**63 - 1, 7).astype(np.int64),
        "f64": np.array([np.nan, -0.0, np.inf, -np.inf, 1.5e-300, 3.0]),
        "b": rng.integers(0, 2, 9).astype(bool),
        "i16": rng.integers(-100, 100, 4).astype(np.int16),
    }
    rp, pp = RG.Packer(), G.Packer()
    for nm, a in lanes.items():
        rp.add(nm, jnp.asarray(a))
        pp.add(nm, torch.from_numpy(a))
    rbufs, rlay = rp.pack()
    want = RG.unpack([np.asarray(b) for b in rbufs], rlay)
    buf, lay = pp.pack()
    assert buf.dtype == torch.int64 and buf.dim() == 1
    got = G.unpack(buf.numpy(), lay)
    assert sorted(got) == sorted(want)
    for nm in lanes:
        g, w = got[nm], np.asarray(want[nm])
        assert g.dtype == w.dtype, nm
        if g.dtype == np.float64:
            assert np.array_equal(g.view(np.int64), w.view(np.int64)), nm
        else:
            assert np.array_equal(g, w), nm
