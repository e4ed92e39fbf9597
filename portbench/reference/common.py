"""Helpers of the plain references: dense codes of key columns, the
null values they write, and their output columns.

The references import nothing of the program (neither package of this
repo, nor JAX): plain torch on the tensors the generator made. Each
reference kind (`reference/<kind>.py`) has `run(tables, spec, fdtype)`
and returns the query's result as [(name, value, kind)]: value a
tensor, or (values, valid mask) for a column whose missing rows are
untyped nulls; kind "exact" (compared bit for bit, NaN equal to NaN) or
"float" (a computed f64 lane, compared by relative error). `fdtype` is
the precision the float lanes are computed in: float64, or float32 for
the control.
"""
from __future__ import annotations

import torch

# Rayfall's typed nulls: an empty f64 aggregate is NaN, an empty i64 one
# the least i64
NULL_I64 = -(1 << 63)
_CODE_LIMIT = 1 << 62


def dense_codes(columns):
    """One i64 code a row such that two rows get the same code exactly
    when every column agrees, codes in [0, n_codes). Mixed radix over
    each column's range; the running code is renumbered densely
    (torch.unique) before it would overflow, and at the end where there
    are more codes than rows. Returns (codes, n_codes)."""
    code, n_codes = None, 1
    for col in columns:
        c = col.to(torch.int64)
        lo = int(c.min())
        span = int(c.max()) - lo + 1
        c = c - lo
        if code is None:
            code, n_codes = c, span
            continue
        if n_codes * span >= _CODE_LIMIT:
            uniq, code = torch.unique(code, return_inverse=True)
            n_codes = int(uniq.shape[0])
        code = code * span + c
        n_codes *= span
    if n_codes > code.shape[0]:
        uniq, code = torch.unique(code, return_inverse=True)
        n_codes = int(uniq.shape[0])
    return code, n_codes


def joint_codes(left_cols, right_cols):
    """dense_codes over the rows of both tables (left rows first):
    (left codes, right codes, n_codes)."""
    n_l = int(left_cols[0].shape[0])
    code, n_codes = dense_codes([torch.cat([a, b]) for a, b in
                                 zip(left_cols, right_cols)])
    return code[:n_l], code[n_l:], n_codes


def sorted_by_code_time(code, time):
    """The permutation that orders rows by (code, time), equal rows in
    row order (two stable sorts, time first)."""
    order = torch.sort(time, stable=True).indices
    return order[torch.sort(code[order], stable=True).indices]
