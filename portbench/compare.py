"""The comparison that decides `correct`: a result of the program
against its plain reference.

Two numbers; a traffic mix's `limits` name those it compares, each
with its limit:

- `exact_mismatches`: elements of exact columns that differ (integers
  and f64 by value, NaN equal to NaN), a column of the wrong name,
  type or length counting all its rows (at least 1), and for a column
  with untyped nulls the rows whose null-ness differs plus the values
  that differ where the reference has one;
- `f64_rel_err`: the widest |got - want| / |want| over the float
  lanes (f64 sums and averages), a NaN or an infinity on one side only
  counted as a mismatch instead.
"""
from __future__ import annotations

import numpy as np
import torch

TINY = np.finfo(np.float64).tiny


def as_tensor(x, device):
    """A program column as a tensor on `device` (host arrays are
    copied)."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return torch.as_tensor(np.asarray(x)).to(device)


def _exact_diff(got, want):
    """Elements of two equal-shape tensors that differ (NaN == NaN)."""
    same = got == want
    if want.dtype.is_floating_point:
        same |= torch.isnan(got) & torch.isnan(want)
    return int((~same).sum())


def _float_diff(got, want):
    """(mismatches, widest relative error) of two f64 lanes."""
    special = ~torch.isfinite(want)
    bad = int(((special | ~torch.isfinite(got)) &
               ~((got == want) | (torch.isnan(got) & torch.isnan(want))))
              .sum())
    fin = ~special & torch.isfinite(got)
    if not bool(fin.any()):
        return bad, 0.0
    g, w = got[fin], want[fin]
    err = (g - w).abs() / w.abs().clamp(min=TINY)
    return bad, float(err.max())


def compare(got_cols, ref_cols):
    """{check: reading} of a program result [(name, value)] against its
    reference [(name, value, kind)]; value a tensor or host array, or
    (values, valid mask) for a column with untyped nulls."""
    mism, rel = 0, 0.0
    if len(got_cols) != len(ref_cols):
        mism += abs(len(got_cols) - len(ref_cols))
    for (gname, gval), (rname, rval, kind) in zip(got_cols, ref_cols):
        rv, rmask = rval if isinstance(rval, tuple) else (rval, None)
        dev = rv.device
        if isinstance(gval, tuple):
            gv, gmask = (as_tensor(x, dev) for x in gval)
        else:
            gv, gmask = as_tensor(gval, dev), None
        n = max(int(rv.shape[0]), int(gv.shape[0]), 1)
        if gname != rname or gv.dtype != rv.dtype or gv.shape != rv.shape:
            mism += n
            continue
        if rmask is not None or gmask is not None:
            if rmask is None:
                rmask = torch.ones_like(gmask)
            if gmask is None:
                gmask = torch.ones_like(rmask)
            mism += int((gmask != rmask).sum())
            gv, rv = gv[rmask & gmask], rv[rmask & gmask]
        if kind == "float":
            bad, err = _float_diff(gv, rv)
            mism += bad
            rel = max(rel, err)
        else:
            mism += _exact_diff(gv, rv)
    return {"exact_mismatches": mism, "f64_rel_err": rel}


def merge(readings):
    """The readings of several results together: mismatches add up, the
    widest error stands."""
    return {"exact_mismatches": sum(r["exact_mismatches"] for r in readings),
            "f64_rel_err": max((r["f64_rel_err"] for r in readings),
                               default=0.0)}


def passes(reading, limits):
    """Whether every number that the mix compares is within its limit."""
    return all(reading[k] <= lim for k, lim in limits.items())
