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
the card by chip_smoke.py. Here, models in plain torch of its routes'
data flow are held bit for bit against the plain version: the integer
look-back (the plain in-block doubling, then a sequential chain of the
flagged block tails, then the fix-up) and the f64 fix-up of the rows the
block summaries name; and the wrapper's route choice, scratch size and
arguments against the source's constants and a stand-in library. Integer lanes and min/max must be exact here;
f64 sums within rtol 1e-12 (the reference's XLA may fuse the adds
differently), as in test_torch_groupby.py."""
import contextlib
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


# -- the kernel's routes, modelled in plain torch -----------------------------

def _blocks(ids, vals, op):
    """The plain version's padded blocks after its in-block doubling:
    (ids (R, B), doubled values (R, B, *lanes), first ids, joint, g)."""
    ident = G._IDENT[vals.dtype][op]
    B = G._SEG_B
    n, lanes = vals.shape[0], tuple(vals.shape[1:])
    ex = (slice(None), slice(None)) + (None,) * len(lanes)
    R = -(-n // B)
    pad = R * B - n
    s2 = torch.cat([ids, ids.new_full((pad,), -2)]).reshape(R, B)
    m = torch.cat([vals, vals.new_full((pad,) + lanes, ident)]) \
        .reshape((R, B) + lanes)
    d = 1
    while d < B:
        same = (s2[:, d:] == s2[:, :-d])[ex]
        m = torch.cat([m[:, :d], G._apply(op, m[:, d:], torch.where(
            same, m[:, :-d], ident))], dim=1)
        d *= 2
    first = s2[:, 0]
    joint = torch.cat([torch.ones(1, dtype=torch.bool),
                       first[1:] != s2[:-1, -1]])
    return s2, m, first, joint, joint | (first != s2[:, -1])


def _run_scan(v, heads, op):
    """The inclusive scan of each run of v (rows, *lanes) that `heads`
    starts, by a head-flagged doubling."""
    f, d = heads.clone(), 1
    ex = (slice(None),) + (None,) * (v.dim() - 1)
    while d < v.shape[0]:
        v = torch.cat([v[:d], torch.where(f[d:][ex], v[d:],
                                          G._apply(op, v[:-d], v[d:]))])
        f = torch.cat([f[:d], f[:-d] | f[d:]])
        d *= 2
    return v


def _lookback_model(ids, vals, op, reverse=False):
    """The integer route: the in-block doubling, except in blocks whose
    ids never turn back (non-decreasing or non-increasing over the rows
    below n), where each run's own scan stands in for it; then the chain
    c[r] = g[r] ? tail[r] : op(c[r-1], tail[r]) in block order (what the
    look-back computes), then op(m, c[r-1]) on the rows with their
    block's first id where the block has no joint."""
    if reverse:
        return _lookback_model(ids.flip(0), vals.flip(0), op).flip(0)
    s2, m, first, joint, g = _blocks(ids, vals, op)
    B, n = G._SEG_B, vals.shape[0]
    ident = G._IDENT[vals.dtype][op]
    pad = s2.shape[0] * B - n
    raw = torch.cat([vals, vals.new_full((pad,) + tuple(vals.shape[1:]),
                                         ident)]).reshape(m.shape)
    for r in range(s2.shape[0]):
        b = s2[r, :min(B, n - r * B)]
        if bool((b[1:] >= b[:-1]).all()) or bool((b[1:] <= b[:-1]).all()):
            heads = torch.cat([torch.ones(1, dtype=torch.bool),
                               s2[r, 1:] != s2[r, :-1]])
            m[r] = _run_scan(raw[r], heads, op)
    c = []
    for r in range(s2.shape[0]):
        tail = m[r, -1]
        c.append(tail if g[r] else G._apply(op, c[r - 1], tail))
        if not joint[r]:
            rows = s2[r] == first[r]
            m[r, rows] = G._apply(op, m[r, rows], c[r - 1])
    return m.reshape((-1,) + tuple(vals.shape[1:]))[:vals.shape[0]]


def _summary_fixup_model(ids, vals, op, reverse=False):
    """The f64 routes' fix-up from the block summaries: the plain tail
    doubling, then op(m, pfx) on the block's leading run of first-id rows
    and, only where a later row has the first id too (unsorted ids), on
    those rows; min and max skip the blocks with a joint."""
    if reverse:
        return _summary_fixup_model(ids.flip(0), vals.flip(0), op).flip(0)
    ident = G._IDENT[vals.dtype][op]
    s2, m, first, joint, g = _blocks(ids, vals, op)
    cv, R, d = m[:, -1], s2.shape[0], 1
    while d < R:
        cv = torch.cat([cv[:d], torch.where(
            g[d:].reshape((-1,) + (1,) * (cv.dim() - 1)), cv[d:],
            G._apply(op, cv[:-d], cv[d:]))])
        g = torch.cat([g[:d], g[:-d] | g[d:]])
        d *= 2
    B = G._SEG_B
    for r in range(R):
        if joint[r] and op != "sum":
            continue
        eq = s2[r] == first[r]
        lead = int((~eq).nonzero()[0]) if not eq.all() else B
        rows = torch.zeros(B, dtype=torch.bool)
        rows[:lead] = True
        if eq[lead:].any():
            rows |= eq
        pfx = m.new_full(m.shape[2:], ident) if joint[r] else cv[r - 1]
        m[r, rows] = G._apply(op, m[r, rows], pfx)
    return m.reshape((-1,) + tuple(vals.shape[1:]))[:vals.shape[0]]


def _wrapping_vals(rng, shape, dtype):
    """Full-range integers (sums wrap), the identities dropped in."""
    info = np.iinfo(_NP[dtype])
    v = rng.integers(info.min, info.max, shape, dtype=_NP[dtype],
                     endpoint=True)
    flat = v.reshape(-1)
    for i, x in enumerate((info.max, info.min, -1, 0)):
        flat[i::7] = x
    return v


@pytest.mark.parametrize("kind", ["run1", "one", "three_blocks", "mixed"])
@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("dtype", ["i32", "i64"])
def test_lookback_chain_is_the_plain_scan(dtype, op, kind):
    """The integer route's premises: chaining the flagged block tails one
    after another equals the plain version's tail doubling bit for bit,
    and so does each run's own scan in a block whose ids never turn back,
    because min, max and the wrapping sum are exact. Over every id kind
    (the mixed kind's unsorted -2s keep some blocks on the doubling), the
    identities as data, wrapping sums, both directions, 1 and 3 lanes."""
    rng = np.random.default_rng(len(kind) * 31 + len(op) + len(dtype))
    for n in (1000, 3073, 5121):
        for lanes in (1, 3):
            ids = _ids(rng, n, kind)
            shape = (n,) if lanes == 1 else (n, lanes)
            vals = torch.from_numpy(_wrapping_vals(rng, shape, dtype))
            for id_dtype in (torch.int32, torch.int64):
                ti = torch.from_numpy(ids).to(id_dtype)
                for rev in (False, True):
                    got = _lookback_model(ti, vals, op, rev)
                    want = G.seg_scan_plain(ti, vals, op, rev)
                    assert torch.equal(got, want), (n, lanes, id_dtype,
                                                    rev)


def test_lookback_sums_wrap():
    """The data of the test above does wrap: a one-run sum over full-range
    values leaves the range the exact sum would need."""
    rng = np.random.default_rng(5)
    for dtype in ("i32", "i64"):
        v = _wrapping_vals(rng, 4000, dtype)
        got = _lookback_model(torch.zeros(4000, dtype=torch.int32),
                              torch.from_numpy(v), "sum")
        assert int(got[-1]) != sum(int(x) for x in v)
        assert int(got[-1]) == int(G.seg_scan_plain(
            torch.zeros(4000, dtype=torch.int32), torch.from_numpy(v),
            "sum")[-1])


@pytest.mark.parametrize("kind", ["run1", "one", "three_blocks", "mixed"])
@pytest.mark.parametrize("op", OPS)
def test_summary_fixup_is_the_plain_scan(op, kind):
    """The f64 routes' fix-up reads no ids but in blocks whose first id
    comes back after its leading run, and skips min and max blocks with
    a joint; that equals the plain version's id-equality fix-up bit for
    bit (f64 compared as bits: NaN, +-0.0, +-inf among the values). A
    NaN's own bits are compared for sums alone: min and max with the
    identity keep a NaN as it is on the card (torch's CUDA rule, which
    chip_smoke.py holds), while CPU torch's may return another NaN."""
    rng = np.random.default_rng(len(kind) * 7 + len(op))
    for n in (1000, 3073, 5121):
        ids = _ids(rng, n, kind)
        for lanes in (1, 3):
            shape = (n,) if lanes == 1 else (n, lanes)
            v = _vals(rng, shape, "f64")
            flat = v.reshape(-1)
            for bits, step in ((0x7FF8000000000000, 97), (0, 5),
                               (0x8000000000000000, 7),
                               (0x7FF0000000000000, 101)):
                flat.view(np.int64)[::step] = np.int64(
                    bits - (1 << 64) if bits >= 1 << 63 else bits)
            vals = torch.from_numpy(v)
            ti = torch.from_numpy(ids)
            for rev in (False, True):
                got = _summary_fixup_model(ti, vals, op, rev)
                want = G.seg_scan_plain(ti, vals, op, rev)
                nan = torch.isnan(want)
                assert torch.equal(torch.isnan(got), nan)
                gb, wb = got.view(torch.int64), want.view(torch.int64)
                if op == "sum":
                    assert torch.equal(gb, wb), (n, lanes, rev)
                else:
                    assert torch.equal(gb[~nan], wb[~nan]), (n, lanes, rev)


def _cu_source():
    return open(os.path.join(os.path.dirname(G.__file__), "csrc",
                             "seg_scan.cu")).read()


def test_route_and_scratch_constants_match_the_cuda_source():
    src = _cu_source()

    def define(name):
        return int(re.search(rf"#define {name} (\d+)", src).group(1))
    assert define("SS_TAIL_SMEM") == G.SEG_TAIL_SMEM
    assert define("SS_COUNTER_BYTES") == G.SEG_COUNTER_BYTES
    # the regions of the scratch per route, as the source lays them out
    layout = re.search(r"static Layout layout\(.*?\n\}", src, re.S).group(0)
    assert "L.counter = align256(R * lanes * 2 * vb);" in layout
    assert "L.a = L.b = L.g = L.total = L.counter + SS_COUNTER_BYTES;" \
        in layout
    assert "L.counter = L.a = align256(R * 4);" in layout
    assert "L.b = L.g = L.total = L.a + align256(R * lanes * vb);" in layout
    assert "L.g = L.b + align256(R * lanes * vb);" in layout
    assert "L.total = L.g + align256(2 * R);" in layout
    routes = re.search(r"enum \{ (ROUTE_\w+ = \d+(?:, ROUTE_\w+ = \d+)*) \}",
                       src).group(1)
    names = [m.group(1).lower() for m in
             re.finditer(r"ROUTE_(\w+) = (\d+)", routes)]
    assert names == list(G.SEG_ROUTES)
    # the shared tail holds a lane's R f64 tails and R flag bytes
    assert re.search(r"blocks_of\(n\) \* \(int64_t\)\(sizeof\(double\) \+ "
                     r"1\) <= SS_TAIL_SMEM", src)


@pytest.mark.parametrize("n,dtype,route", [
    (1, torch.int32, "lookback"),
    (30_000_000, torch.int64, "lookback"),
    (1, torch.float64, "shared_tail"),
    (10_000_000, torch.float64, "shared_tail"),
    (25_827 * 1024, torch.float64, "shared_tail"),
    (25_827 * 1024 + 1, torch.float64, "global_tail"),
    (30_000_000, torch.float64, "global_tail"),
])
def test_route_choice(n, dtype, route):
    """Integer values always take the look-back; f64 values the shared
    tail while a lane's tails and flags fit in 227 KB (R <= 25 827
    blocks), else the global tail, however many lanes (one lane's tails
    at a time)."""
    assert G.seg_scan_route(n, dtype) == route


@pytest.mark.parametrize("n,lanes,dtype,want", [
    # lookback: 2 x vb bytes a block and lane, then the counter
    (1, 1, torch.int32, 256 + 256),
    (10_000_000, 1, torch.int64, 156416 + 256),
    (10_000_000, 1, torch.int32, 78336 + 256),
    (30_000_000, 3, torch.int64, 1406464 + 256),
    # shared_tail: the summary words, the tails
    (10_000_000, 1, torch.float64, 39168 + 78336),
    (1025, 3, torch.float64, 256 + 256),
    # global_tail: and the second buffer, two flag bytes a block
    (30_000_000, 1, torch.float64, 117248 + 2 * 234496 + 58624),
])
def test_scratch_bytes_per_route(n, lanes, dtype, want):
    """The scratch holds the regions the call's route uses, each 256-byte
    aligned: lookback a look-back word (a status and a value, twice the
    value's bytes) a block and lane and the block counter; the f64 routes
    a summary word a block and the block tails; the global tail also the
    tails' second buffer and two flag bytes a block."""
    assert G.seg_scan_scratch_bytes(n, lanes, dtype) == want


class _FakeLib:
    """A stand-in for the built library: records what the wrapper passes
    and returns `rc` from the launch."""

    def __init__(self, rc=0):
        self.rc = rc
        self.calls = []

    def rf_seg_scan_block(self):
        return 1024

    def rf_seg_scan_route(self, n, kind):
        self.calls.append(("route", n, kind))
        return G.SEG_ROUTES.index(G.seg_scan_route(
            n, {0: torch.int32, 1: torch.int64, 2: torch.float64}[kind]))

    def rf_seg_scan_scratch_bytes(self, n, lanes, kind):
        self.calls.append(("scratch", n, lanes, kind))
        return G.seg_scan_scratch_bytes(
            n, lanes, {0: torch.int32, 1: torch.int64, 2: torch.float64}[kind])

    def rf_seg_scan(self, *args):
        self.calls.append(("scan",) + args)
        return self.rc


@pytest.mark.parametrize("dtype,lanes", [(torch.int64, 1),
                                         (torch.float64, 3)])
def test_wrapper_passes_scratch_and_arguments(monkeypatch, dtype, lanes):
    lib = _FakeLib()
    monkeypatch.setattr(G, "_lib", lib)
    monkeypatch.setattr(G, "_card_stream",
                        lambda device: contextlib.nullcontext(1234))
    allocated = []
    real_empty = torch.empty

    def empty(*a, **k):
        t = real_empty(*a, **k)
        allocated.append(t)
        return t
    monkeypatch.setattr(torch, "empty", empty)
    n = 3000
    ids = torch.arange(n, dtype=torch.int64) // 7
    vals = torch.zeros((n, 4), dtype=dtype)[:, :lanes]
    if lanes == 1:
        vals = vals[:, 0]
    before = dict(G.ROUTES), G.LAUNCHES["seg_scan"]
    out = G.seg_scan_cuda(ids, vals, "max", reverse=True)
    route = G.seg_scan_route(n, dtype)
    kind = G._KINDS[dtype]
    assert lib.calls[0] == ("route", n, kind)
    assert lib.calls[1] == ("scratch", n, lanes, kind)
    scan = lib.calls[2]
    scratch = next(t for t in allocated if t.data_ptr() == scan[13])
    assert scratch.numel() * scratch.element_size() >= \
        G.seg_scan_scratch_bytes(n, lanes, dtype)
    assert scan[1:] == (ids.data_ptr(), 1, ids.stride(0), vals.data_ptr(),
                        kind, vals.stride(0), vals.stride(-1),
                        out.data_ptr(), n, lanes, 1, 1,
                        scratch.data_ptr(), 1234)
    assert G.ROUTES[route] == before[0][route] + 1
    assert G.LAUNCHES["seg_scan"] == before[1] + 1


def test_wrapper_raises_on_a_failed_launch(monkeypatch):
    monkeypatch.setattr(G, "_lib", _FakeLib(rc=700))
    monkeypatch.setattr(G, "_card_stream",
                        lambda device: contextlib.nullcontext(0))
    before = dict(G.ROUTES), G.LAUNCHES["seg_scan"]
    with pytest.raises(DeviceError, match="cudaError 700"):
        G.seg_scan_cuda(torch.zeros(10, dtype=torch.int32),
                        torch.zeros(10, dtype=torch.int64), "sum")
    assert (dict(G.ROUTES), G.LAUNCHES["seg_scan"]) == before


@pytest.mark.parametrize("n,dtype,want", [
    (0, torch.int64, (0, 0)),
    (5, torch.int32, (1, 1)),
    (30_000_000, torch.int64, (1, 1)),
    (1024, torch.float64, (2, 0)),
    (1025, torch.float64, (3, 0)),
    (30_000_000, torch.float64, (3, 0)),
])
def test_launches_per_route(n, dtype, want):
    """The integer route is one block pass after a memset of the
    look-back words; f64 adds the tail pass (none for one block) and the
    fix-up, as the source's launcher has it."""
    assert G.seg_scan_launches(n, dtype) == want
    src = _cu_source()
    run = re.search(r"static int run\(Args<I, T> a.*?\n\}", src, re.S).group(0)
    integral, f64 = run.split("} else {", 1)
    assert integral.count("cudaMemsetAsync") == 1
    assert integral.count("<<<") == 1
    assert "cudaMemsetAsync" not in f64 and f64.count("<<<") == 4
    assert "if (R > 1 && route == ROUTE_SHARED_TAIL)" in f64
    assert "} else if (R > 1) {" in f64


def test_scanparts_variants_still_apply():
    """tools/scanparts.py builds variants of csrc/seg_scan.cu by text
    replacement: each replaced text is in the source exactly once."""
    from rayforce_tpu_torch.tools import scanparts
    src = _cu_source()
    for name, edits in scanparts.VARIANTS.items():
        for old, _new in edits:
            assert src.count(old) == 1, name
