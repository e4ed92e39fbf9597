"""The segmented scan's dispatch and its plain version
(rayforce_tpu_torch/engine/groupby.py `_seg_scan`, `seg_scan_plain`,
`seg_scan_cuda`) against the JAX package's `_seg_scan` under jax.jit on
the CPU, on the same seeded arrays:

- a CPU tensor runs the plain version and never the CUDA kernel; any
  other device but CUDA raises DeviceError; the ctypes table matches
  every extern "C" signature of csrc/seg_scan.cu;
- reverse=True is flip -> scan -> flip, and the reference's scan of the
  flipped arrays, for i32, i64 and f64 values, min, max and sum, one lane
  and three;
- the edges: lengths on both sides of the 1024-row block, a run over
  three blocks, every row its own run, one run for all rows, negative
  ids and -2 (the pad's id), values equal to the identities;
- an (n, L) scan is L one-lane scans;
- signed zeros: torch's minimum / maximum return the first operand on a
  tie, jnp's order -0.0 below 0.0, so a min or max scan may differ from
  the reference in a zero's sign (pinned below, ROADMAP queue 3).

The CUDA kernel itself is held bit for bit against the plain version on
the card by chip_smoke.py. Integer lanes and min/max must be exact here;
f64 sums within rtol 1e-12 (the reference's XLA may fuse the adds
differently), as in test_torch_groupby.py."""
import ctypes
import os
import re

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from rayforce_tpu.engine import groupby as RG
from rayforce_tpu_torch.engine import groupby as G
from rayforce_tpu_torch.engine import psort
from rayforce_tpu_torch.engine.device import DeviceError

torch.set_num_threads(1)

_ref_scan = jax.jit(RG._seg_scan, static_argnames="op")

OPS = ("min", "max", "sum")
DTYPES = ("i32", "i64", "f64")
_NP = {"i32": np.int32, "i64": np.int64, "f64": np.float64}
_IDENT = {"i32": (2**31 - 1, -2**31), "i64": (2**63 - 1, -2**63),
          "f64": (np.inf, -np.inf)}


def _vals(rng, shape, dtype, idents=False):
    if dtype == "f64":
        v = rng.uniform(-1e6, 1e6, shape)
    elif dtype == "i32":
        v = rng.integers(-2**20, 2**20, shape).astype(np.int32)
    else:
        v = rng.integers(-2**50, 2**50, shape).astype(np.int64)
    if idents:
        # the identities and the joins' "no row" sentinels as data
        flat = v.reshape(-1)
        lo, hi = _IDENT[dtype][1], _IDENT[dtype][0]
        for i, x in enumerate((hi, lo, -1, 0)):
            flat[i::7] = x
    return v


def _ids(rng, n, kind):
    if kind == "run1":
        a = np.arange(n)
    elif kind == "one":
        a = np.zeros(n, np.int64)
    elif kind == "three_blocks":
        # a run from row 100 over blocks 0-3, short runs around it
        a = np.arange(n) // 3
        a[100:100 + 3 * 1024] = -1
        a = np.sort(a)
    else:
        # sorted ids from -5, with -2 among them and unsorted -2s dropped in
        a = np.sort(rng.integers(-5, max(2, n // 40), n))
        a[rng.random(n) < 0.02] = -2
    return a


def _check(got, want, dtype, op, what):
    assert got.dtype == want.dtype, what
    if dtype == "f64" and op == "sum":
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=0,
                                   err_msg=what)
    else:
        assert np.array_equal(got, want), what


def _ref(ids, vals, op):
    """The reference's scan of each lane of vals ((n,) or (n, L))."""
    if vals.ndim == 1:
        return np.asarray(_ref_scan(jnp.asarray(ids), jnp.asarray(vals),
                                    op=op))
    return np.stack([_ref(ids, vals[:, j], op)
                     for j in range(vals.shape[1])], 1)


# -- dispatch -----------------------------------------------------------------

def test_cpu_tensor_runs_the_plain_version(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("the CUDA scan ran for a CPU tensor")
    monkeypatch.setattr(G, "seg_scan_cuda", boom)
    rng = np.random.default_rng(1)
    ids = torch.from_numpy(_ids(rng, 3000, "mixed").astype(np.int32))
    vals = torch.from_numpy(_vals(rng, 3000, "i64"))
    before = dict(psort.LAUNCHES)
    for op in OPS:
        for rev in (False, True):
            got = G._seg_scan(ids, vals, op, reverse=rev)
            assert torch.equal(got, G.seg_scan_plain(ids, vals, op, rev))
    assert psort.LAUNCHES == before


@pytest.mark.parametrize("fn", ["_seg_scan", "seg_doubling_sum"])
def test_other_device_raises(fn):
    ids = torch.zeros(8, dtype=torch.int32, device="meta")
    vals = torch.zeros(8, dtype=torch.int64, device="meta")
    with pytest.raises(DeviceError):
        if fn == "_seg_scan":
            G._seg_scan(ids, vals, "min")
        else:
            G.seg_doubling_sum(ids, vals, reverse=True)


def test_library_without_a_symbol_raises(monkeypatch):
    from rayforce_tpu_torch.engine import cubuild

    class Lib:
        rf_seg_scan_block = staticmethod(lambda: 1024)
    monkeypatch.setattr(G, "_lib", None)
    monkeypatch.setattr(cubuild, "load", lambda name: Lib())
    with pytest.raises(DeviceError):
        G._seg_lib()


@pytest.mark.parametrize("case", ["float_ids", "int16_vals", "3d_vals",
                                  "short_ids", "bad_op"])
def test_cuda_wrapper_refuses_what_the_kernel_does_not_take(monkeypatch,
                                                             case):
    """seg_scan_cuda checks its arguments before it builds anything."""
    from rayforce_tpu_torch.engine import cubuild

    def no_build(name):
        raise AssertionError("built the library for a refused call")
    monkeypatch.setattr(G, "_lib", None)
    monkeypatch.setattr(cubuild, "load", no_build)
    ids = torch.zeros(6, dtype=torch.int32)
    vals = torch.zeros(6, dtype=torch.int64)
    op = "sum"
    if case == "float_ids":
        ids = ids.double()
    elif case == "int16_vals":
        vals = vals.to(torch.int16)
    elif case == "3d_vals":
        vals = vals.reshape(6, 1, 1)
    elif case == "short_ids":
        ids = ids[:5]
    else:
        op = "mean"
    with pytest.raises(ValueError):
        G.seg_scan_cuda(ids, vals, op)


def _extern_c_signatures():
    """{name: (return kind, [argument kinds])} of every extern "C"
    function in csrc/seg_scan.cu; a kind is 'ptr', 'i64' or 'i32'."""
    src = os.path.join(os.path.dirname(G.__file__), "csrc", "seg_scan.cu")
    text = open(src).read()

    def kind(decl):
        decl = decl.strip()
        if "*" in decl:
            return "ptr"
        if re.match(r"(const\s+)?(int64_t|long long)\b", decl):
            return "i64"
        if re.match(r"(const\s+)?(int|int32_t)\b", decl):
            return "i32"
        raise AssertionError(f"unknown C type: {decl!r}")

    sigs = {}
    for m in re.finditer(r'extern\s+"C"\s+([\w\s\*]+?)\s*\b(rf_\w+)\s*'
                         r'\(([^)]*)\)', text):
        ret, name, args = m.groups()
        args = args.strip()
        kinds = [] if args in ("", "void") else \
            [kind(a) for a in args.split(",")]
        sigs[name] = (kind(ret), kinds)
    return sigs


def test_argtypes_table_matches_the_cuda_source():
    """groupby's ctypes table against every extern "C" signature of
    seg_scan.cu: the same functions, the same argument count, and
    pointer versus 64-bit versus 32-bit int at every position."""
    def kind(t):
        if t is ctypes.c_void_p:
            return "ptr"
        if ctypes.sizeof(t) == 8:
            return "i64"
        assert ctypes.sizeof(t) == 4
        return "i32"

    sigs = _extern_c_signatures()
    assert set(sigs) == set(G.ARGTYPES)
    for name, (res, args) in G.ARGTYPES.items():
        assert sigs[name] == (kind(res), [kind(a) for a in args]), name


def test_block_width_matches_the_cuda_source():
    src = open(os.path.join(os.path.dirname(G.__file__), "csrc",
                            "seg_scan.cu")).read()
    assert re.search(r"#define SS_B (\d+)", src).group(1) == str(G._SEG_B)


# -- reverse ------------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("lanes", [1, 3])
def test_reverse_is_the_flipped_scan(dtype, lanes):
    rng = np.random.default_rng(len(dtype) + lanes)
    n = 2500
    ids = _ids(rng, n, "mixed").astype(np.int64)
    shape = (n,) if lanes == 1 else (n, lanes)
    vals = _vals(rng, shape, dtype)
    ti, tv = torch.from_numpy(ids), torch.from_numpy(vals)
    for op in OPS:
        got = G._seg_scan(ti, tv, op, reverse=True)
        flipped = G._seg_scan(ti.flip(0), tv.flip(0), op).flip(0)
        assert torch.equal(got, flipped), op
        want = _ref(ids[::-1].copy(), vals[::-1].copy(), op)[::-1]
        _check(got.numpy(), want, dtype, op, f"{op} reverse")


@pytest.mark.parametrize("fn,op", [("seg_doubling_min", "min"),
                                   ("seg_doubling_max", "max"),
                                   ("seg_doubling_sum", "sum")])
def test_doubling_wrappers_pass_reverse(fn, op):
    rng = np.random.default_rng(3)
    ids = torch.from_numpy(_ids(rng, 1500, "mixed").astype(np.int32))
    vals = torch.from_numpy(_vals(rng, 1500, "i64"))
    assert torch.equal(getattr(G, fn)(ids, vals, reverse=True),
                       G.seg_scan_plain(ids, vals, op, reverse=True))


# -- edges against the reference --------------------------------------------

@pytest.mark.parametrize("n", [1, 1023, 1024, 1025, 2049, 3073])
@pytest.mark.parametrize("kind", ["mixed", "three_blocks", "run1", "one"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_edges_match_reference(n, kind, dtype):
    rng = np.random.default_rng(n * 7 + len(kind) + len(dtype))
    ids = _ids(rng, n, kind)
    vals = _vals(rng, n, dtype, idents=True)
    for id_dtype in (np.int32, np.int64):
        for op in OPS:
            want = _ref(ids.astype(id_dtype), vals, op)
            got = G._seg_scan(torch.from_numpy(ids.astype(id_dtype)),
                              torch.from_numpy(vals), op).numpy()
            _check(got, want, dtype, op, f"{op} ids {id_dtype.__name__}")


def test_empty_scan():
    for dtype in DTYPES:
        vals = torch.from_numpy(np.zeros(0, _NP[dtype]))
        ids = torch.zeros(0, dtype=torch.int32)
        for op in OPS:
            for rev in (False, True):
                assert G._seg_scan(ids, vals, op, rev).shape == (0,)


# -- lanes ------------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
def test_lanes_are_one_lane_scans(dtype):
    rng = np.random.default_rng(11)
    n = 3001
    ids = torch.from_numpy(_ids(rng, n, "mixed").astype(np.int32))
    vals = torch.from_numpy(_vals(rng, (n, 3), dtype, idents=True))
    for op in OPS:
        for rev in (False, True):
            got = G._seg_scan(ids, vals, op, rev)
            assert got.shape == (n, 3)
            for j in range(3):
                one = G._seg_scan(ids, vals[:, j].contiguous(), op, rev)
                torch.testing.assert_close(got[:, j], one, rtol=0, atol=0,
                                           equal_nan=True)


# -- signed zeros: a reference-side difference --------------------------------

def test_signed_zero_rule_differs_from_reference():
    """jnp.minimum / maximum order -0.0 below 0.0; torch's give one of
    the two operands on a tie (on x86 CPU torch the vectorised loop gives
    the second). Over runs of two zeros of opposite signs the port's min
    and max scans equal the reference's in value, the reference's signs
    follow -0.0 < 0.0, and the port's differ from them in a zero's sign
    in at least one case: the difference ROADMAP queue 3 records."""
    ids = np.zeros(2, np.int32)
    differs = []
    for op in ("min", "max"):
        for vals in ([-0.0, 0.0], [0.0, -0.0]):
            v = np.array(vals)
            got = G._seg_scan(torch.from_numpy(ids), torch.from_numpy(v),
                              op).numpy()
            want = _ref(ids, v, op)
            assert np.array_equal(got, want)            # -0.0 == 0.0
            ieee = [np.signbit(v[0]),
                    np.signbit(v).all() if op == "max" else
                    np.signbit(v).any()]
            assert list(np.signbit(want)) == ieee, (op, vals)
            if list(np.signbit(got)) != list(np.signbit(want)):
                differs.append((op, vals))
    assert differs
