"""The port's segmented scan (engine/groupby.py `_seg_scan`, the
two-level log-doubling min/max/sum over sorted runs) against the JAX
package's, for i32, i64 and f64 lanes. Lengths are not multiples of the
1024-wide block, and runs cross block boundaries. Integer lanes must be
exact; f64 sums within rtol 1e-12 (the two libraries may fuse the same
additions differently)."""
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
