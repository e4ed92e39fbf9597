"""Errors-as-values for rayforce-tpu.

The reference keeps a single static ERR object plus a tagged error context on
the VM (reference core/error.h:33-81). Here an error is a Python exception
carrying the same context kinds, so `try` can convert it back into a value.
"""
from __future__ import annotations


class RayError(Exception):
    """A Rayfall runtime error. `kind` mirrors the reference error codes."""

    def __init__(self, kind: str, msg: str = "", span=None):
        super().__init__(f"{kind}: {msg}" if msg else kind)
        self.kind = kind
        self.msg = msg
        self.span = span  # (line, col_start, col_end) if known
        self.trace = []   # list of (name, span) frames

    def __repr__(self):
        return f"RayError({self.kind!r}, {self.msg!r})"


def err_type(msg: str = "") -> RayError:
    return RayError("type", msg)


def err_arity(msg: str = "") -> RayError:
    return RayError("arity", msg)


def err_length(msg: str = "") -> RayError:
    return RayError("length", msg)


def err_index(msg: str = "") -> RayError:
    return RayError("index", msg)


def err_domain(msg: str = "") -> RayError:
    return RayError("domain", msg)


def err_value(msg: str = "") -> RayError:
    return RayError("value", msg)


def err_limit(msg: str = "") -> RayError:
    return RayError("limit", msg)


def err_os(msg: str = "") -> RayError:
    return RayError("os", msg)


def err_parse(msg: str = "", span=None) -> RayError:
    return RayError("parse", msg, span)


def err_user(msg: str = "") -> RayError:
    return RayError("user", msg)


def err_msg(e: "RayError") -> str:
    """The user-visible error text a `try` handler receives
    (reference core/error.c err_msg): user errors give their message,
    everything else the kind name."""
    if e.kind == "user":
        return e.msg or ""
    if e.kind == "os":
        return e.msg or "os"
    return e.kind
