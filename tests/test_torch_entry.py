"""The port's flagship step (rayforce_tpu_torch/entry.py) against the JAX
package's `__graft_entry__.entry()` step, each on its own seeded
arguments (the same numpy draws). Sums, counts and first-row ids must
be exact; the least prices are exact too (a min picks an input)."""
import numpy as np
import torch

import __graft_entry__ as ref_entry
from rayforce_tpu_torch import entry as port_entry

torch.set_num_threads(1)


def test_entry_args_match_reference():
    _rstep, rargs = ref_entry.entry()
    _pstep, pargs = port_entry.entry(device="cpu")
    for r, p in zip(rargs, pargs):
        assert p.device.type == "cpu"
        assert np.array_equal(p.numpy(), r)
        assert p.numpy().dtype == r.dtype


def test_entry_step_matches_reference():
    rstep, rargs = ref_entry.entry()
    pstep, pargs = port_entry.entry(device="cpu")
    want = [np.asarray(x) for x in rstep(*rargs)]
    got = [x.numpy() for x in pstep(*pargs)]
    assert len(got) == len(want) == 4
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape, i
        assert g.dtype == w.dtype, (i, g.dtype, w.dtype)
        assert np.array_equal(g, w), i
    # the filter leaves some keys with rows and the trash code none
    assert (want[1] > 0).all() and want[1].sum() < len(rargs[0])


def test_entry_step_empty_groups():
    """A key with no row that passes the filter keeps the sentinels:
    sum 0, count 0, min +inf, first row KEY_MAX."""
    rstep, rargs = ref_entry.entry()
    pstep, pargs = port_entry.entry(device="cpu")
    keys, values, prices = rargs
    prices = prices.copy()
    prices[keys == 7] = 10.0
    want = [np.asarray(x) for x in rstep(keys, values, prices)]
    got = [x.numpy() for x in pstep(pargs[0], pargs[1],
                                     torch.from_numpy(prices))]
    for g, w in zip(got, want):
        assert np.array_equal(g, w)
    assert got[1][7] == 0 and got[2][7] == np.inf
    assert got[3][7] == np.iinfo(np.int64).max


def test_dryrun_multichip_on_cpu(capsys):
    """The port's dryrun_multichip (the counterpart of
    __graft_entry__.dryrun_multichip) over 8 shards of CPU torch: the
    mesh kernels against numpy and every DRYRUN_QUERIES step on its mesh
    engine, equal to the host path; the engine's settings and mesh are
    left as they were."""
    from rayforce_tpu_torch.engine import device as dev
    saved_cfg, saved_mesh = dict(dev._cfg), dict(dev._mesh_state)
    port_entry.dryrun_multichip(8, device="cpu")
    assert "dryrun_multichip(8): ok" in capsys.readouterr().out
    assert dev._cfg == saved_cfg and dev._mesh_state == saved_mesh
