"""Vector/blob files: `(set "path" x)` / `(get "path")`
(reference core/binary.c binary_set:52-345).

Disk layouts (byte-compatible with the reference):
- simple vector: 16-byte obj_t header {u8 mmod=0xfd, u8 order, i8 type,
  u8 attrs, u32 rc, i64 len} + raw little-endian data; readable zero-copy
  via np.memmap (the mmap analogue of binary.c:264-307 / ray_get).
- symbol vector: full serde bytes (ser_obj) — symbols persist as strings.
- enum: compound file (mmod=0xfe): one 4096-byte page whose data area
  names the domain global, then a 16-byte header + i64 indices.
- anything else (tables, dicts, lists, atoms): serde bytes.
"""
from __future__ import annotations

import os
import struct

import numpy as np

from ..core import types as T
from ..core import symbols
from ..core.obj import Obj, to_np, sym
from ..core.errors import RayError, err_type, err_os
from . import serde

MMOD_EXTERNAL_SIMPLE = 0xFD
MMOD_EXTERNAL_COMPOUND = 0xFE
PAGE = 4096
HDR = struct.Struct("<BBbBIq")  # mmod, order, type, attrs, rc, len


def _write_header(f, mmod, t, attrs, length):
    f.write(HDR.pack(mmod, 0, t & 0xFF if t >= 0 else t, attrs,
                     0, length))


def set_path(path: str, o: Obj) -> None:
    t = o.t
    if t == T.SYMBOL or t == T.TABLE or t == T.DICT or t == T.LIST \
            or t < 0:
        data = to_np(serde.ser_obj(o)).tobytes()
        with open(path, "wb") as f:
            f.write(data)
        return
    if t == T.ENUM:
        dom = o.domain
        if dom is None or dom.t != -T.SYMBOL:
            raise err_type("enum persistence needs a named domain")
        name = symbols.name_of(int(dom.v)).encode()
        page = bytearray(PAGE)
        page[0] = MMOD_EXTERNAL_COMPOUND
        page[16:16 + len(name)] = name
        ids = to_np(o)
        with open(path, "wb") as f:
            f.write(bytes(page))
            f.write(HDR.pack(MMOD_EXTERNAL_COMPOUND, 0,
                             T.ENUM, o.attrs, 0, len(ids)))
            f.write(ids.astype("<i8").tobytes())
        return
    if T.is_vector(t) and t != T.C8 or t == T.C8:
        a = to_np(o)
        with open(path, "wb") as f:
            _write_header(f, MMOD_EXTERNAL_SIMPLE, t, o.attrs, len(o))
            f.write(np.ascontiguousarray(a).tobytes())
        return
    raise err_type(f"cannot persist type {t}")


def get_path(path: str) -> Obj:
    if os.path.isdir(path):
        from .splayed import get_splayed
        return get_splayed(path)
    try:
        with open(path, "rb") as f:
            head = f.read(16)
    except OSError as e:
        raise err_os(str(e))
    if len(head) < 16:
        raise RayError("parse", "short file")
    prefix = struct.unpack("<I", head[:4])[0]
    if prefix == serde.SERDE_PREFIX:
        with open(path, "rb") as f:
            buf = f.read()
        return serde.de_payload(buf[16:])
    mmod = head[0]
    if mmod == MMOD_EXTERNAL_COMPOUND:
        # enum compound file
        with open(path, "rb") as f:
            page = f.read(PAGE)
            hdr = f.read(16)
            _m, _o, tt, attrs, _rc, n = HDR.unpack(hdr)
            ids = np.fromfile(f, dtype="<i8", count=n)
        name = page[16:page.index(0, 16)].decode()
        return Obj(T.ENUM, ids.astype(np.int64), attrs=attrs,
                   domain=sym(name))
    if mmod == MMOD_EXTERNAL_SIMPLE:
        _m, _o, tt, attrs, _rc, n = HDR.unpack(head)
        if tt >= 128:
            tt -= 256
        if tt == T.GUID:
            a = np.memmap(path, dtype=np.uint8, mode="r", offset=16,
                          shape=(n, 16))
            return Obj(T.GUID, a, attrs=attrs)
        dt = T.DTYPE.get(tt)
        if dt is None:
            raise RayError("parse", f"bad vector file type {tt}")
        # zero-copy mmap (reference ray_get mmaps, rayforce.c:2884)
        a = np.memmap(path, dtype=dt, mode="r", offset=16, shape=(n,))
        return Obj(tt, a, attrs=attrs)
    raise RayError("parse", "unknown file format")
