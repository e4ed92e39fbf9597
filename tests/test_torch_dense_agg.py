"""The dense aggregate (rayforce_tpu_torch/engine/groupby.py `_dense_agg`,
`dense_agg_plain`, `dense_agg_cuda`; `dense_scan`, `bcast_scan`,
`matmul_tasks_scan` on top) against the JAX package's `bcast_scan` and
`matmul_tasks_scan` on JAX CPU, on the same seeded numpy arrays:

- every lane of the plain version against the reference's: counts,
  first/last row ids, integer sums, exact task sums and extrema as bits,
  f64 sums within rtol 1e-12 (the reference adds in another order), for
  1 to 512 codes and row counts either side of the 1024-row chunk;
- the fixed f64 order, bit for bit against a numpy fold-and-tree: each
  cell's left fold from -0.0 in row order inside a chunk, then a
  pairwise tree over the chunks (a cell of -0.0 rows stays -0.0); a
  numpy model of the CUDA kernel's grouping (32 rows at a time, the rows
  of each code one group, each group folded by its first lane in lane
  order) against `_fixed_order_sums`, and a model of its way through the
  tree (the first log2(P) levels inside a CTA of P warps, then aligned
  blocks of DA_TREE nodes combined as a binary counter, level after
  level) against the same tree, for every P, CTA count and order in
  which the CTAs finish their groups;
- the dispatch: a CPU tensor runs the plain version and never loads the
  library, another device raises DeviceError; one dense pass a query
  and a flagship step, tasks included;
- the wrapper against a stand-in library: codes and lanes read in place
  at their strides (stride-0 codes too), outputs and the stream's
  scratch (its head zero, kept per device and stream), lanes cut into
  calls whose cells fit one CTA, DeviceError on a failed launch, on a
  shape the library does not take and on a library without a symbol,
  ValueError on what the kernel does not take; the load routes; the
  ctypes table, the constants and the shared-memory rule against
  csrc/dense_agg.cu.

The CUDA kernel itself is held bit for bit against the plain version on
the card by chip_smoke.py."""
import contextlib
import ctypes
import os
import re

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from rayforce_tpu.engine import groupby as RG
from rayforce_tpu_torch.engine import device as dev
from rayforce_tpu_torch.engine import groupby as G
from rayforce_tpu_torch.engine import psort
from rayforce_tpu_torch.engine.device import DeviceError

torch.set_num_threads(1)

C = G._DENSE_CHUNK
KEY_MAX, I64_MIN = G.KEY_MAX, G.I64_MIN


def _source():
    return open(os.path.join(os.path.dirname(G.__file__), "csrc",
                             "dense_agg.cu")).read()


def _define(name):
    return int(re.search(rf"#define {name} (\d+)", _source()).group(1))


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int64) if a.dtype == np.float64 else a


def _codes(rng, n, n_rows):
    """Codes in [0, n] (n is the trash slot); code 0 left empty when
    n > 1, so empty cells are covered."""
    c = rng.integers(0, n + 1, n_rows).astype(np.int32)
    if n > 1:
        c[c == 0] = 1
    return c


# -- the plain version against the reference --------------------------------

@pytest.mark.parametrize("n,n_rows", [(1, 1), (1, C + 1), (7, 33),
                                      (7, C - 1), (100, 2 * C + 5),
                                      (512, 3001)])
def test_dense_scan_matches_reference(n, n_rows):
    rng = np.random.default_rng(n * 31 + n_rows)
    codes = _codes(rng, n, n_rows)
    w = rng.integers(0, 256, n_rows).astype(np.int32)       # one limb
    f = rng.uniform(-1e6, 1e6, n_rows)
    f[::23] = 0.0                                           # nulls zeroed
    i = rng.integers(-1000, 1000, n_rows).astype(np.int64)
    mn_i = rng.integers(-2**62, 2**62, n_rows).astype(np.int64)
    mn_i[::11] = KEY_MAX
    mn_f = rng.uniform(-5, 5, n_rows)
    mn_f[::19] = np.inf
    mn_f[::7] = -0.0
    mx_f = rng.uniform(-5, 5, n_rows)
    mx_f[::13] = -np.inf
    mx_f[::17] = 0.0
    mx_i = rng.integers(-2**62, 2**62, n_rows).astype(np.int64)
    mx_i[::5] = I64_MIN
    want = RG.bcast_scan(jnp.asarray(codes), n, n_rows,
                         sums=(jnp.asarray(f), jnp.asarray(i, jnp.float64)),
                         mins=(jnp.asarray(mn_i), jnp.asarray(mn_f)),
                         maxs=(jnp.asarray(mx_f), jnp.asarray(mx_i)))
    want_task = RG.matmul_tasks_scan(jnp.asarray(codes),
                                     [jnp.asarray(w, jnp.float32)], n + 1,
                                     n_rows)[0]
    t = torch.from_numpy
    got = G.dense_scan(t(codes), n, n_rows, tasks=[t(w)],
                       sums=(t(f), t(i)), mins=(t(mn_i), t(mn_f)),
                       maxs=(t(mx_f), t(mx_i)))
    assert sorted(got) == sorted(list(want) + ["task0"])
    for k in want:
        wk, gk = np.asarray(want[k]), got[k].numpy()
        assert gk.dtype == wk.dtype and gk.shape == wk.shape == (n,), k
        if k == "sum0":
            np.testing.assert_allclose(gk, wk, rtol=1e-12, atol=1e-9)
        else:
            assert np.array_equal(_bits(gk), _bits(wk)), k
    assert got["task0"].dtype == torch.float64
    assert np.array_equal(got["task0"].numpy(), np.asarray(want_task)[:n])


def test_matmul_tasks_scan_keeps_the_trash_cell():
    """matmul_tasks_scan returns all n_cells sums, the trash cell too,
    as the reference's does; bcast_scan drops it."""
    rng = np.random.default_rng(5)
    codes = _codes(rng, 9, 3000)
    w = rng.integers(0, 256, 3000).astype(np.int32)
    want = RG.matmul_tasks_scan(jnp.asarray(codes),
                                [jnp.asarray(w, jnp.float32)], 10, 3000)
    got = G.matmul_tasks_scan(torch.from_numpy(codes), [torch.from_numpy(w)],
                              10, 3000)
    assert np.array_equal(got[0].numpy(), np.asarray(want[0]))
    assert got[0].shape == (10,) and float(got[0][9]) > 0


def test_plain_version_lanes_against_numpy():
    """dense_agg_plain's raw lanes by their definition: i32 extrema in
    i32, wrapping i64 sums, first/last row ids and their sentinels, a
    stride-0 codes view (every row on one code)."""
    rng = np.random.default_rng(8)
    n_rows, W = 2 * C + 77, 6
    codes = rng.integers(0, W - 1, n_rows).astype(np.int64)   # W-1 empty
    big = np.full(n_rows, 2**62, np.int64)
    m32 = rng.integers(-2**31, 2**31 - 1, n_rows).astype(np.int32)
    got = G.dense_agg_plain(torch.from_numpy(codes), W, n_rows,
                            ints=(torch.from_numpy(big),),
                            mins=(torch.from_numpy(m32),),
                            maxs=(torch.from_numpy(m32),))
    for c in range(W):
        sel = codes == c
        rows = np.flatnonzero(sel)
        assert int(got["counts"][c]) == len(rows)
        assert int(got["fidx"][c]) == (rows[0] if len(rows) else KEY_MAX)
        assert int(got["lidx"][c]) == (rows[-1] if len(rows) else -1)
        wrapped = (len(rows) * 2**62 + 2**63) % 2**64 - 2**63
        assert int(got["int0"][c]) == wrapped
        assert got["min0"].dtype == torch.int32
        assert int(got["min0"][c]) == (m32[sel].min() if len(rows)
                                       else 2**31 - 1)
        assert int(got["max0"][c]) == (m32[sel].max() if len(rows)
                                       else -2**31)
    one = torch.tensor([3], dtype=torch.int32).expand(n_rows)
    assert one.stride(0) == 0
    got = G.dense_agg_plain(one, 5, n_rows)
    assert got["counts"].tolist() == [0, 0, 0, n_rows, 0]
    assert got["fidx"].tolist() == [KEY_MAX] * 3 + [0, KEY_MAX]
    assert got["lidx"].tolist() == [-1] * 3 + [n_rows - 1, -1]


# -- the fixed f64 order -----------------------------------------------------

def _level_tree(nodes):
    """The pairwise tree over a list of numpy rows, level by level, an
    odd last node passed up."""
    while len(nodes) > 1:
        nodes = [nodes[k] + nodes[k + 1] if k + 1 < len(nodes) else
                 nodes[k] for k in range(0, len(nodes), 2)]
    return nodes[0]


def _np_fixed_order(codes, vals, W):
    n = len(codes)
    part = np.full((max(-(-n // C), 1), W), -0.0)
    for r in range(n):
        part[r // C, codes[r]] = part[r // C, codes[r]] + vals[r]
    return _level_tree(list(part))


def _wide_values(rng, n):
    """Values whose sums depend on their order: magnitudes from 1e-300 to
    1e300, both signs."""
    return rng.uniform(-1, 1, n) * 10.0 ** rng.integers(-300, 301, n)


@pytest.mark.parametrize("n_rows", [1, C - 1, C, C + 1, 3 * C + 7, 9 * C])
def test_fixed_f64_order_is_fold_then_tree(n_rows):
    rng = np.random.default_rng(n_rows)
    W = 8
    codes = rng.integers(0, W - 1, n_rows).astype(np.int32)
    v = _wide_values(rng, n_rows)
    v[codes == 3] = -0.0          # a cell of -0.0 rows stays -0.0
    v[codes == 4] = 0.0
    v[(codes == 5) & (rng.random(n_rows) < 0.1)] = np.inf
    v[(codes == 6) & (rng.random(n_rows) < 0.1)] = -np.inf
    got = G.dense_agg_plain(torch.from_numpy(codes), W, n_rows,
                            fsums=(torch.from_numpy(v),))["fsum0"].numpy()
    want = _np_fixed_order(codes, v, W)
    cnt = np.bincount(codes, minlength=W)
    want = np.where(cnt == 0, 0.0, want)      # empty cell 7: 0.0
    assert np.array_equal(got.view(np.int64), want.view(np.int64))
    if 3 in codes:
        assert got.view(np.int64)[3] == np.float64(-0.0).view(np.int64)
    assert got.view(np.int64)[7] == 0


def _counter_node(parts):
    """A warp's binary counter over a group's chunk partials (in chunk
    order): chunk j merges the blocks its trailing one bits name, and at
    the group's end the blocks of its size's bits combine, the lowest
    first, each as the left operand of what is above it."""
    blk = {}
    for j, x in enumerate(parts):
        lv = 0
        while (j >> lv) & 1:
            x = blk[lv] + x
            lv += 1
        blk[lv] = x
    m, node = len(parts), None
    for lv in range(m.bit_length()):
        if (m >> lv) & 1:
            node = blk[lv] if node is None else blk[lv] + node
    return node


def _group_node(part, g, P):
    """dense_pass's tree inside a CTA of P warps: the group's P aligned
    chunks by the tree's first log2(P) levels (a pair only where its
    right node holds a chunk below K)."""
    K = part.shape[0]
    f = [part[g * P + w] if g * P + w < K else None for w in range(P)]
    s = 1
    while s < P:
        for j in range(0, P, 2 * s):
            if g * P + j + s < K:
                f[j] = f[j] + f[j + s]
        s *= 2
    return f[0]


def _kernel_tree(part, P, T, ctas, rng):
    """The CUDA kernel's way through the tree over the (K, W) chunk
    partials: dense_pass's group g (P aligned chunks) inside its CTA
    (`_group_node`); the groups spread over `ctas` CTAs (g, g + ctas,
    ...), which finish them in a random interleaving; dense_finish
    combines each aligned block of T nodes (`tree_of`, a binary
    counter) once the block is whole, level after level."""
    K = part.shape[0]
    G = -(-K // P)
    level_n = [G]
    while level_n[-1] > 1:
        level_n.append(-(-level_n[-1] // T))
    nodes = [dict() for _ in level_n]
    done = [dict() for _ in level_n]
    queues = [list(range(w, G, ctas)) for w in range(ctas)]
    while any(queues):
        w = rng.choice([i for i, q in enumerate(queues) if q])
        g = queues[w].pop(0)
        nodes[0][g] = _group_node(part, g, P)
        idx = g
        for lvl in range(len(level_n) - 1):
            blk = idx // T
            cnt = min(T, level_n[lvl] - blk * T)
            done[lvl + 1][blk] = done[lvl + 1].get(blk, 0) + 1
            if done[lvl + 1][blk] != cnt:
                break
            nodes[lvl + 1][blk] = _counter_node(
                [nodes[lvl][blk * T + k] for k in range(cnt)])
            idx = blk
    return nodes[-1][0]


@pytest.mark.parametrize("K", [1, 2, 3, 7, 8, 9, 33, 100, 257, 1025, 1100,
                               33 * 32 + 5])
def test_kernel_tree_is_the_plain_tree(K):
    """For every CTA width the kernel may take (it narrows P to fit its
    shared memory), every CTA count and every order in which the CTAs
    finish, its split of the tree gives the plain tree's bits."""
    P_max, T = _define("DA_WARPS"), _define("DA_TREE")
    rng = np.random.default_rng(K)
    part = _wide_values(rng, K * 5).reshape(K, 5)
    want = _level_tree(list(part)).view(np.int64)
    P = P_max
    while P >= 1:
        for ctas in (1, 3, 8, 1056):
            got = _kernel_tree(part, P, T, ctas, rng).view(np.int64)
            assert np.array_equal(got, want), (P, ctas)
        P //= 2


def _peers(keys, bits):
    """__match_any_sync of 32 keys: lane l's mask of the lanes with its
    key (built here from one ballot a key bit)."""
    lanes = np.arange(32, dtype=np.uint64)
    peers = np.full(32, 0xFFFFFFFF, dtype=np.uint64)
    for b in range(bits):
        on = ((keys >> b) & 1).astype(bool)
        ballot = np.uint64(int((on.astype(np.uint64) << lanes).sum()))
        peers &= np.where(on, ballot, ~ballot & np.uint64(0xFFFFFFFF))
    return peers


def _kernel_chunk_sums(codes, vals, W):
    """(W, F) f64 sums as the CUDA kernel adds them: per chunk, 32 rows
    at a time (rows past the end carry key W): 32 rows of one code fold
    in row order; otherwise each group of the match is folded by its
    first lane over its members in lane order, into the cell's chunk
    partial (from -0.0); then the kernel's tree."""
    n, F = len(codes), len(vals)
    bits = int(W).bit_length()
    K = max(-(-n // C), 1)
    part = np.full((K, W, F), -0.0)
    with np.errstate(invalid="ignore"):
        _fold_groups(codes, vals, W, bits, part)
    return _kernel_tree(part.reshape(K, W * F), _define("DA_WARPS"),
                        _define("DA_TREE"), 7,
                        np.random.default_rng(n)).reshape(W, F)


def _fold_groups(codes, vals, W, bits, part):
    n, F = len(codes), len(vals)
    for r0 in range(0, n, 32):
        k = np.full(32, W, dtype=np.int64)
        k[:min(32, n - r0)] = codes[r0:r0 + 32]
        k[(k < 0) | (k >= W)] = W
        chunk = r0 // C
        if (k == k[0]).all():
            if k[0] < W:
                for i in range(32):
                    for f in range(F):
                        part[chunk, k[0], f] = part[chunk, k[0], f] + \
                            vals[f][r0 + i]
            continue
        peers = _peers(k, bits)
        for lane in range(32):
            m = int(peers[lane])
            if k[lane] == W or lane != (m & -m).bit_length() - 1:
                continue
            for member in range(32):
                if (m >> member) & 1:
                    for f in range(F):
                        part[chunk, k[lane], f] = part[chunk, k[lane], f] + \
                            vals[f][r0 + member]


@pytest.mark.parametrize("n_codes", [1, 7, 100, 512])
@pytest.mark.parametrize("n_rows", [1, 31, C - 1, C, C + 1, 3 * C + 7])
def test_kernel_grouping_is_the_fixed_order(n_rows, n_codes):
    """The kernel's grouping, modelled in numpy, adds every cell's rows
    in `_fixed_order_sums`' order: bit for bit, with a -0.0 cell, a cell
    of inf and -inf (inf - inf) and codes outside the cells."""
    rng = np.random.default_rng(n_rows * 7 + n_codes)
    W = n_codes + 1
    codes = rng.integers(0, W, n_rows).astype(np.int64)
    codes[::97] = W + 3                      # skipped
    v = _wide_values(rng, n_rows)
    v[codes == 0] = -0.0
    if n_codes > 1:
        v[(codes == 1) & (rng.random(n_rows) < 0.3)] = np.inf
        v[(codes == 1) & (rng.random(n_rows) < 0.3)] = -np.inf
    w = rng.uniform(-1, 1, n_rows)
    got = _kernel_chunk_sums(codes, [v, w], W)
    want = G._fixed_order_sums(torch.from_numpy(np.where(codes < W, codes, W)),
                               [torch.from_numpy(v), torch.from_numpy(w)],
                               W + 1)[:W].numpy()
    # _fixed_order_sums has no skipped rows: they went to its extra cell
    assert np.array_equal(got.view(np.int64), want.view(np.int64))


@pytest.mark.parametrize("n_rows", [1, 31, C - 1, C, C + 1, 3 * C + 7])
def test_kernel_grouping_of_skewed_codes(n_rows):
    """90% of the rows on one code (a filter's trash code): long runs of
    32 rows of one code, and groups of many members, in the fixed
    order."""
    rng = np.random.default_rng(n_rows)
    W = 101
    codes = np.where(rng.random(n_rows) < 0.9, 100,
                     rng.integers(0, 100, n_rows)).astype(np.int64)
    v = _wide_values(rng, n_rows)
    got = _kernel_chunk_sums(codes, [v], W)
    want = G._fixed_order_sums(torch.from_numpy(codes), [torch.from_numpy(v)],
                               W).numpy()
    assert np.array_equal(got.view(np.int64), want.view(np.int64))


def test_the_order_decides_the_bits():
    """Chunk partials 1, 1e16, -1e16, 1: the tree gives (1 + 1e16) +
    (-1e16 + 1) = 0.0, a left fold 1.0; the plain version gives the
    tree's."""
    v = np.zeros(4 * C)
    v[::C] = [1.0, 1e16, -1e16, 1.0]
    got = G.dense_agg_plain(torch.zeros(4 * C, dtype=torch.int32), 1, 4 * C,
                            fsums=(torch.from_numpy(v),))["fsum0"]
    assert got.tolist() == [0.0]
    part = v[::C].reshape(4, 1)
    assert _level_tree(list(part))[0] == 0.0 and np.cumsum(part)[-1] == 1.0


# -- dispatch ---------------------------------------------------------------

def test_cpu_tensors_run_the_plain_version(monkeypatch):
    from rayforce_tpu_torch.engine import cubuild

    def no_build(name):
        raise AssertionError("built a CUDA library for CPU tensors")
    monkeypatch.setattr(cubuild, "load", no_build)
    monkeypatch.setattr(G, "_dlib", None)
    rng = np.random.default_rng(2)
    codes = torch.from_numpy(_codes(rng, 12, 5000))
    w = torch.from_numpy(rng.integers(0, 256, 5000).astype(np.int32))
    f = torch.from_numpy(rng.uniform(-9, 9, 5000))
    before = dict(psort.LAUNCHES)
    got = G.dense_scan(codes, 12, 5000, tasks=[w], sums=(f,), mins=(f,))
    raw = G.dense_agg_plain(codes, 13, 5000, ints=[w], fsums=[f], mins=[f])
    assert torch.equal(got["task0"], raw["int0"][:12].double())
    assert torch.equal(got["sum0"], raw["fsum0"][:12])
    assert torch.equal(got["min0"], raw["min0"][:12])
    assert torch.equal(got["counts"], raw["counts"][:12].int())
    assert torch.equal(G.matmul_tasks_scan(codes, [w], 13, 5000)[0],
                       raw["int0"].double())
    assert psort.LAUNCHES == before


@pytest.mark.parametrize("fn", ["bcast_scan", "matmul_tasks_scan",
                                "dense_scan"])
def test_other_device_raises(fn):
    codes = torch.zeros(8, dtype=torch.int32, device="meta")
    with pytest.raises(DeviceError):
        if fn == "matmul_tasks_scan":
            G.matmul_tasks_scan(codes, [codes], 2, 8)
        else:
            getattr(G, fn)(codes, 1, 8)


@pytest.fixture
def _cpu_engine():
    saved = dict(dev._cfg)
    dev.set_device("cpu")
    dev.set_threshold(1)
    yield
    dev._cfg.clear()
    dev._cfg.update(saved)


@pytest.mark.parametrize("q", [
    "(select {s: (sum big) a: (avg v3) mx: (max big) c: (count v3) "
    "from: t by: id1})",
    "(select {s: (sum big) mn: (min v3) from: t})",
])
def test_one_dense_pass_a_query(_cpu_engine, monkeypatch, q):
    """The dense plan's counts, row ids, limb tasks, sums and extrema
    come from one call of the dense aggregate."""
    from rayforce_tpu_torch.core.fmt import format_top
    from rayforce_tpu_torch.engine import select as sel
    from test_torch_sortagg import _runtimes
    rng = np.random.default_rng(4)
    n = 3000
    _rrt, prt = _runtimes({
        "id1": (rng.integers(0, 9, n).astype(np.int64), "I64"),
        "big": (rng.integers(-2**62, 2**62, n).astype(np.int64), "I64"),
        "v3": (rng.uniform(-5, 5, n), "F64")})
    calls = []
    real = G.dense_agg_plain

    def counting(codes, n_cells, n_rows, ints=(), *a, **k):
        calls.append(len(ints))
        return real(codes, n_cells, n_rows, ints, *a, **k)
    monkeypatch.setattr(G, "dense_agg_plain", counting)
    sel.last_profile.clear()
    got = format_top(prt.eval_str(q))
    assert "dispatch_ms" in sel.last_profile
    assert len(calls) == 1 and calls[0] >= 8    # 8 limbs of `big` at least
    monkeypatch.setattr(G, "dense_agg_plain", real)
    dev.set_enabled(False)
    try:
        assert got == format_top(prt.eval_str(q))
    finally:
        dev.set_enabled(True)


def test_entry_step_is_one_dense_pass(monkeypatch):
    from rayforce_tpu_torch.entry import N_GROUPS, entry
    step, args = entry(device="cpu")
    calls = []
    real = G.dense_agg_plain

    def counting(*a, **k):
        calls.append(1)
        return real(*a, **k)
    monkeypatch.setattr(G, "dense_agg_plain", counting)
    s, c, mn, fidx = step(*args)
    assert len(calls) == 1
    keys, values, prices = (a.numpy() for a in args)
    keep = prices > 50.0
    for g in range(N_GROUPS):
        sel = keep & (keys == g)
        assert float(s[g]) == values[sel].sum()
        assert float(c[g]) == sel.sum()
        assert float(mn[g]) == (prices[sel].astype(np.float64).min()
                                if sel.any() else np.inf)
        assert int(fidx[g]) == (np.flatnonzero(sel)[0] if sel.any()
                                else KEY_MAX)


# -- the wrapper against a stand-in library ---------------------------------

class _FakeLib:
    def __init__(self, rc=0):
        self.rc = rc
        self.calls = []

    def rf_dense_agg_scratch_bytes(self, n, cells, n_acc, n_f):
        self.calls.append(("scratch", n, cells, n_acc, n_f))
        return 4096 + n_f

    def rf_dense_agg(self, codes, kind, stride, n, cells, k, ins, strides,
                     kinds, ops, outs, counts, fidx, lidx, scratch, stream):
        self.calls.append(("agg", codes, kind, stride, n, cells, k,
                           list(ins)[:k], list(strides)[:k],
                           list(kinds)[:k], list(ops)[:k], list(outs)[:k],
                           counts, fidx, lidx, scratch, stream))
        return self.rc


@pytest.fixture
def fake(monkeypatch):
    lib = _FakeLib()
    monkeypatch.setattr(G, "_dlib", lib)
    monkeypatch.setattr(G, "_card_stream",
                        lambda device: contextlib.nullcontext(1234))
    return lib


@pytest.mark.parametrize("want_counts,want_fidx", [(True, True),
                                                   (False, True),
                                                   (True, False)])
def test_wrapper_passes_lanes_outputs_and_scratch(fake, monkeypatch,
                                                  want_counts, want_fidx):
    monkeypatch.setattr(G, "_dense_work", {})
    n, W = 3000, 101
    codes = torch.tensor([7], dtype=torch.int32).expand(n)    # stride 0
    i32 = torch.zeros(2 * n, dtype=torch.int32)[::2]
    i64 = torch.zeros(n, dtype=torch.int64)
    f = torch.zeros((n, 3), dtype=torch.float64)[:, 1]
    before = psort.LAUNCHES["dense_agg"]
    out = G.dense_agg_cuda(codes, W, n, ints=(i32, i64), fsums=(f,),
                           mins=(f,), maxs=(i64,), want_counts=want_counts,
                           want_fidx=want_fidx)
    assert psort.LAUNCHES["dense_agg"] == before + 1
    n_acc = (3 if want_fidx else 1) + 4
    assert fake.calls[0] == ("scratch", n, W, n_acc, 1)
    (_, cptr, kind, stride, rows, cells, k, ins, strides, kinds, ops, outs,
     counts, fidx, lidx, scratch, stream) = fake.calls[1]
    assert (cptr, kind, stride, rows, cells, k, stream) == \
        (codes.data_ptr(), 0, 0, n, W, 5, 1234)
    assert ins == [x.data_ptr() for x in (i32, i64, f, f, i64)]
    assert strides == [2, 1, 3, 3, 1]
    assert kinds == [0, 1, 2, 2, 1]
    assert ops == [0, 0, 3, 1, 2]
    names = ["int0", "int1", "fsum0", "min0", "max0"]
    assert outs == [out[nm].data_ptr() for nm in names]
    assert [out[nm].dtype for nm in names] == \
        [torch.int64, torch.int64, torch.float64, torch.float64, torch.int64]
    assert all(out[nm].shape == (W,) for nm in names)
    assert counts == (out["counts"].data_ptr() if want_counts else None)
    assert ("counts" in out) == want_counts
    assert fidx == (out["fidx"].data_ptr() if want_fidx else None)
    assert lidx == (out["lidx"].data_ptr() if want_fidx else None)
    # the stream's scratch: one buffer of the library's bytes, zero
    (key, buf), = G._dense_work.items()
    assert key == (codes.device, 1234) and buf.data_ptr() == scratch
    assert buf.numel() * buf.element_size() >= 4096 + 1
    assert not buf.any()


def test_scratch_is_kept_per_stream(monkeypatch):
    """One scratch a (device, stream), zero when it is made, grown when a
    call needs more; the kernel leaves its head zero, so calls reuse it
    without a memset."""
    monkeypatch.setattr(G, "_dense_work", {})
    a = G._dense_scratch(torch.device("cpu"), 1, 100)
    assert G._dense_scratch(torch.device("cpu"), 1, 64) is a
    assert a.numel() * 8 >= 100 and not a.any()
    b = G._dense_scratch(torch.device("cpu"), 2, 100)
    assert b is not a
    c = G._dense_scratch(torch.device("cpu"), 1, 1000)
    assert c is not a and c.numel() * 8 >= 1000 and not c.any()
    assert G._dense_work == {(torch.device("cpu"), 1): c,
                             (torch.device("cpu"), 2): b}


def test_wrapper_raises_where_the_kernel_cannot_take_the_shape(fake):
    """A shape the library does not take (its scratch bytes -1) raises
    DeviceError before any launch: no fallback."""
    fake.rf_dense_agg_scratch_bytes = lambda *a: -1
    before = psort.LAUNCHES["dense_agg"]
    with pytest.raises(DeviceError, match="not a shape the kernel takes"):
        G.dense_agg_cuda(torch.zeros(10, dtype=torch.int32), 3, 10)
    assert not [c for c in fake.calls if c[0] == "agg"]
    assert psort.LAUNCHES["dense_agg"] == before


def test_load_routes():
    """How the kernel reads each array: stride-0 codes as one code,
    stride 1 in coalesced loads, anything else strided."""
    x = torch.zeros(64, dtype=torch.int32)
    assert G.dense_load_route(x, True) == "contiguous"
    assert G.dense_load_route(x[:1].expand(64), True) == "constant"
    assert G.dense_load_route(x[:1].expand(64)) == "strided"
    assert G.dense_load_route(x[::2]) == "strided"
    assert G.dense_load_route(x[1:]) == "contiguous"


def test_wrapper_cuts_lanes_into_calls_that_fit(fake):
    """More lanes than one call takes, and more cells than one CTA holds
    for them all: every lane in one call, in order; fidx, lidx and counts
    in the first; each call's cells fit (the source's shared memory at
    one warp)."""
    n, W = 100, 3000
    codes = torch.zeros(n, dtype=torch.int64)
    lanes = [torch.zeros(n, dtype=torch.int64) for _ in range(30)]
    out = G.dense_agg_cuda(codes, W, n, ints=lanes[:20], fsums=[
        torch.zeros(n, dtype=torch.float64)] * 3, maxs=lanes[20:])
    aggs = [c for c in fake.calls if c[0] == "agg"]
    scr = [c for c in fake.calls if c[0] == "scratch"]
    assert len(aggs) > 1 and len(aggs) == len(scr)
    assert [p for c in aggs for p in c[11]] == \
        [out[f"int{j}"].data_ptr() for j in range(20)] + \
        [out[f"fsum{j}"].data_ptr() for j in range(3)] + \
        [out[f"max{j}"].data_ptr() for j in range(10)]
    assert aggs[0][12:15] == (out["counts"].data_ptr(),
                              out["fidx"].data_ptr(),
                              out["lidx"].data_ptr())
    assert all(c[12:15] == (None, None, None) for c in aggs[1:])
    for c, s in zip(aggs, scr):
        n_f = c[10].count(3)
        assert s[3:] == ((3 if c is aggs[0] else 1) + c[6] - n_f, n_f)
        assert c[6] <= G.DENSE_MAX_LANES and G.dense_fits(W, *s[3:])


def test_wrapper_raises_on_a_failed_launch(fake):
    fake.rc = 700
    before = psort.LAUNCHES["dense_agg"]
    with pytest.raises(DeviceError, match="cudaError 700"):
        G.dense_agg_cuda(torch.zeros(10, dtype=torch.int32), 3, 10)
    assert psort.LAUNCHES["dense_agg"] == before


def test_library_without_a_symbol_raises(monkeypatch):
    from rayforce_tpu_torch.engine import cubuild

    class Lib:
        rf_dense_agg_chunk = staticmethod(lambda: C)
    monkeypatch.setattr(G, "_dlib", None)
    monkeypatch.setattr(cubuild, "load", lambda name: Lib())
    with pytest.raises(DeviceError):
        G._dense_lib()


def test_library_of_another_chunk_raises(monkeypatch):
    from rayforce_tpu_torch.engine import cubuild

    class Lib:
        pass
    lib = Lib()
    for name in G.DENSE_ARGTYPES:
        setattr(lib, name, lambda *a: 512)
    monkeypatch.setattr(G, "_dlib", None)
    monkeypatch.setattr(cubuild, "load", lambda name: lib)
    with pytest.raises(DeviceError, match="512"):
        G._dense_lib()


@pytest.mark.parametrize("case", ["float_codes", "2d_codes", "i16_lane",
                                  "f32_fsum", "2d_lane", "short_lane",
                                  "no_cells", "rows_past_codes",
                                  "too_many_cells"])
def test_cuda_wrapper_refuses_what_the_kernel_does_not_take(monkeypatch,
                                                             case):
    from rayforce_tpu_torch.engine import cubuild

    def no_build(name):
        raise AssertionError("built the library for a refused call")
    monkeypatch.setattr(G, "_dlib", None)
    monkeypatch.setattr(cubuild, "load", no_build)
    n, W = 6, 4
    codes = torch.zeros(n, dtype=torch.int32)
    ints, fsums = [torch.zeros(n, dtype=torch.int64)], []
    rows = n
    if case == "float_codes":
        codes = codes.double()
    elif case == "2d_codes":
        codes = codes.reshape(3, 2)
    elif case == "i16_lane":
        ints = [ints[0].to(torch.int16)]
    elif case == "f32_fsum":
        fsums = [torch.zeros(n, dtype=torch.float32)]
    elif case == "2d_lane":
        ints = [torch.zeros((n, 1), dtype=torch.int64)]
    elif case == "short_lane":
        ints = [ints[0][:5]]
    elif case == "no_cells":
        W = 0
    elif case == "rows_past_codes":
        rows = n + 1
    else:
        W = 40_000
    with pytest.raises(ValueError):
        G.dense_agg_cuda(codes, W, rows, ints=ints, fsums=fsums)


# -- the mirrors against csrc/dense_agg.cu ---------------------------------

def _extern_c_signatures():
    """{name: (return kind, [argument kinds])} of every extern "C"
    function in csrc/dense_agg.cu; a kind is 'ptr', 'i64' or 'i32'."""
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
                         r'\(([^)]*)\)', _source()):
        ret, name, args = m.groups()
        args = args.strip()
        kinds = [] if args in ("", "void") else \
            [kind(a) for a in args.split(",")]
        sigs[name] = (kind(ret), kinds)
    return sigs


def test_argtypes_table_matches_the_cuda_source():
    def kind(t):
        if t is ctypes.c_void_p:
            return "ptr"
        if ctypes.sizeof(t) == 8:
            return "i64"
        assert ctypes.sizeof(t) == 4
        return "i32"

    sigs = _extern_c_signatures()
    assert set(sigs) == set(G.DENSE_ARGTYPES)
    for name, (res, args) in G.DENSE_ARGTYPES.items():
        assert sigs[name] == (kind(res), [kind(a) for a in args]), name


def test_constants_match_the_cuda_source():
    src = _source()
    assert _define("DA_CHUNK") == G._DENSE_CHUNK
    assert _define("DA_MAX_LANES") == G.DENSE_MAX_LANES
    assert _define("DA_SMEM") == G.DENSE_SMEM
    assert _define("DA_ZERO_BYTES") == G.DENSE_ZERO_BYTES == \
        _define("DA_SMEM") + 256

    ops = re.search(r"enum \{ DA_SUM = (\d), DA_MIN = (\d), DA_MAX = (\d), "
                    r"DA_FSUM = (\d) \}", src).groups()
    assert [int(x) for x in ops] == [G._DA_OPS[k] for k in
                                     ("int", "min", "max", "fsum")]
    kinds = re.search(r"enum \{ KIND_I32 = (\d), KIND_I64 = (\d), "
                      r"KIND_F64 = (\d) \}", src).groups()
    assert [int(x) for x in kinds] == [G._KINDS[t] for t in
                                       (torch.int32, torch.int64,
                                        torch.float64)]
    # dense_fits is the source's smem_of at one warp with the CTA's cells
    # shared (its least): 8 * (n_acc * W + (n_f * W + 32))
    body = re.search(r"static int64_t smem_of\([^)]*\) \{\s*return ([^;]+);",
                     src).group(1)
    assert re.sub(r"\s+", " ", body) == \
        "8 * ((int64_t)n_acc * W * (priv ? P : 1) + " \
        "(int64_t)P * ((int64_t)n_f * W + 32))"


@pytest.mark.parametrize("W", [1, 2, 101, 513, 2000, 9000])
def test_dense_fits_is_smem_of_at_one_warp(W):
    """dense_fits against the source's smem_of evaluated in Python (one
    warp, the CTA's cells), at the edge of DA_SMEM too."""
    def smem_of(n_acc, n_f, P, priv):
        return 8 * (n_acc * W * (P if priv else 1) + P * (n_f * W + 32))
    for n_acc in (1, 3, 4, 10, 27):
        for n_f in (0, 1, 3, 24):
            assert G.dense_fits(W, n_acc, n_f) == \
                (smem_of(n_acc, n_f, 1, False) <= _define("DA_SMEM"))


def test_denseparts_variants_still_apply():
    """tools/denseparts.py builds variants of csrc/dense_agg.cu by text
    replacement: each replaced text of the kernel's own parts is in the
    source exactly once."""
    from rayforce_tpu_torch.tools import denseparts
    src = _source()
    assert denseparts.PARTS["v3"]
    for name, edits in denseparts.PARTS["v3"].items():
        for old, _new in edits:
            assert src.count(old) == 1, name
