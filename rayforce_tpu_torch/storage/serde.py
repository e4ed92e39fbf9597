"""Binary serde — wire/disk format compatible with the reference
(core/serde.c:166-363): type-tagged, little-endian, recursive.

atoms: [i8 type][raw value]; symbol atom = NUL-terminated string.
vectors: [i8 type][u8 attrs=0][i64 len][payload]; symbol vectors are
NUL-terminated strings back-to-back. list/table/dict recurse; lambdas
serialize args+body; builtins by name. `ser_obj` prepends the 16-byte IPC
header {u32 prefix 0xcefadefa, u8 version, u8 flags, u8 endian, u8
msgtype, i64 size} (core/serde.h:30-40).
"""
from __future__ import annotations

import struct

import numpy as np

from ..core import types as T
from ..core import symbols
from ..core.obj import (Obj, to_np, list_, dict_, table, string, NULL_OBJ,
                        sym, vector)
from ..core.errors import RayError, err_type
from ..core.parser import Lambda

SERDE_PREFIX = 0xCEFADEFA
VERSION = 1

_VEC_FMT = {
    T.B8: ("b", 1), T.U8: ("B", 1), T.I16: ("h", 2), T.I32: ("i", 4),
    T.DATE: ("i", 4), T.TIME: ("i", 4), T.I64: ("q", 8),
    T.TIMESTAMP: ("q", 8), T.F64: ("d", 8),
}


def ser_bytes(o: Obj, out: bytearray) -> None:
    t = o.t
    if t == -T.NULL:
        out.append(T.NULL & 0xFF)
        return
    out.append(t & 0xFF)
    if t < 0:
        st = -t
        if st == T.B8 or st == T.U8 or st == T.C8:
            out.append(int(o.v) & 0xFF)
        elif st in (T.I16,):
            out += struct.pack("<h", int(o.v))
        elif st in (T.I32, T.DATE, T.TIME):
            out += struct.pack("<i", int(o.v))
        elif st in (T.I64, T.TIMESTAMP):
            out += struct.pack("<q", int(o.v))
        elif st == T.F64:
            out += struct.pack("<d", float(o.v))
        elif st == T.SYMBOL:
            name = "" if int(o.v) == int(T.NULL_I64) \
                else symbols.name_of(int(o.v))
            out += name.encode() + b"\x00"
        elif st == T.GUID:
            out += bytes(np.asarray(o.v, dtype=np.uint8).tobytes())
        elif st == T.ENUM:
            # enums travel as their symbol value
            from ..ops.items import ray_value
            out.pop()
            ser_bytes(ray_value(o), out)
        else:
            raise err_type(f"cannot serialize atom type {t}")
        return
    if t == T.C8:
        a = to_np(o)
        out.append(0)
        out += struct.pack("<q", len(a))
        out += a.tobytes()
        return
    if t in _VEC_FMT or t == T.B8:
        a = to_np(o)
        out.append(0)
        out += struct.pack("<q", len(a))
        out += a.tobytes()
        return
    if t == T.SYMBOL:
        a = to_np(o)
        out.append(0)
        out += struct.pack("<q", len(a))
        for sid in a:
            name = "" if int(sid) == int(T.NULL_I64) \
                else symbols.name_of(int(sid))
            out += name.encode() + b"\x00"
        return
    if t == T.GUID:
        a = to_np(o)
        out.append(0)
        out += struct.pack("<q", a.shape[0])
        out += a.tobytes()
        return
    if t == T.ENUM:
        from ..ops.items import ray_value
        out.pop()
        ser_bytes(ray_value(o), out)
        return
    if t == T.LIST:
        out.append(0)
        out += struct.pack("<q", len(o.v))
        for e in o.v:
            ser_bytes(e, out)
        return
    if t in (T.TABLE, T.DICT):
        out.append(0)
        k, v = (o.v[0], o.v[1]) if t == T.DICT else (o.v[0], list_(o.v[1]))
        ser_bytes(k, out)
        ser_bytes(v, out)
        return
    if t == T.LAMBDA:
        out.append(0)
        lam = o.v
        ser_bytes(lam.args_obj, out)
        ser_bytes(lam.body, out)
        return
    if t in (T.UNARY, T.BINARY, T.VARY):
        out += o.v.name.encode() + b"\x00"
        return
    raise err_type(f"cannot serialize type {t}")


class _Reader:
    def __init__(self, buf: bytes, pos: int = 0, env=None):
        self.buf = buf
        self.pos = pos
        self.env = env

    def u8(self):
        v = self.buf[self.pos]
        self.pos += 1
        return v

    def take(self, n):
        b = self.buf[self.pos:self.pos + n]
        self.pos += n
        return b

    def cstr(self):
        end = self.buf.index(0, self.pos)
        s = self.buf[self.pos:end].decode()
        self.pos = end + 1
        return s

    def read(self) -> Obj:
        t = self.u8()
        if t >= 128:
            t -= 256  # signed
        if t == T.NULL:
            return NULL_OBJ
        if t < 0:
            st = -t
            if st == T.B8:
                return Obj(-T.B8, np.int8(self.u8()))
            if st == T.U8:
                return Obj(-T.U8, np.uint8(self.u8()))
            if st == T.C8:
                return Obj(-T.C8, np.uint8(self.u8()))
            if st == T.I16:
                return Obj(-T.I16, np.int16(
                    struct.unpack("<h", self.take(2))[0]))
            if st in (T.I32, T.DATE, T.TIME):
                return Obj(t, np.int32(
                    struct.unpack("<i", self.take(4))[0]))
            if st in (T.I64, T.TIMESTAMP):
                return Obj(t, np.int64(
                    struct.unpack("<q", self.take(8))[0]))
            if st == T.F64:
                return Obj(-T.F64, np.float64(
                    struct.unpack("<d", self.take(8))[0]))
            if st == T.SYMBOL:
                name = self.cstr()
                return sym(name) if name else \
                    Obj(-T.SYMBOL, T.NULL_I64)
            if st == T.GUID:
                return Obj(-T.GUID,
                           np.frombuffer(self.take(16), np.uint8).copy())
            raise RayError("parse", f"bad serde atom type {t}")
        if t in _VEC_FMT or t in (T.B8, T.C8):
            self.u8()  # attrs
            n = struct.unpack("<q", self.take(8))[0]
            if t == T.C8:
                return Obj(T.C8,
                           np.frombuffer(self.take(n), np.uint8).copy())
            fmt, w = _VEC_FMT[t] if t in _VEC_FMT else ("b", 1)
            a = np.frombuffer(self.take(n * w),
                              dtype=T.DTYPE[t]).copy()
            return Obj(t, a)
        if t == T.SYMBOL:
            self.u8()
            n = struct.unpack("<q", self.take(8))[0]
            ids = np.empty(n, dtype=np.int64)
            for i in range(n):
                name = self.cstr()
                ids[i] = symbols.intern(name) if name else T.NULL_I64
            return Obj(T.SYMBOL, ids)
        if t == T.GUID:
            self.u8()
            n = struct.unpack("<q", self.take(8))[0]
            a = np.frombuffer(self.take(n * 16), np.uint8).copy()
            return Obj(T.GUID, a.reshape(n, 16))
        if t == T.LIST:
            self.u8()
            n = struct.unpack("<q", self.take(8))[0]
            return list_([self.read() for _ in range(n)])
        if t in (T.TABLE, T.DICT):
            self.u8()
            k = self.read()
            v = self.read()
            if t == T.TABLE:
                return table(k, list(v.v))
            return dict_(k, v)
        if t == T.LAMBDA:
            self.u8()
            args = self.read()
            body = self.read()
            return Obj(T.LAMBDA, Lambda(args, body))
        if t in (T.UNARY, T.BINARY, T.VARY):
            name = self.cstr()
            if self.env is not None:
                fn = self.env.builtin(name)
                if fn is not None:
                    return fn
            raise RayError("value", f"unknown builtin {name}")
        raise RayError("parse", f"bad serde type {t}")


def ser_payload(o: Obj) -> bytes:
    out = bytearray()
    ser_bytes(o, out)
    return bytes(out)


def ser_obj(o: Obj, msgtype: int = 0) -> Obj:
    """Serialize with the 16-byte IPC header -> U8 vector."""
    payload = ser_payload(o)
    hdr = struct.pack("<IBBBBq", SERDE_PREFIX, VERSION, 0, 0, msgtype,
                      len(payload))
    return Obj(T.U8, np.frombuffer(hdr + payload, np.uint8).copy())


def de_payload(buf: bytes, env=None) -> Obj:
    return _Reader(buf, 0, env).read()


def de_obj(o: Obj, env=None) -> Obj:
    """Deserialize a U8 vector produced by ser_obj."""
    if o.t != T.U8:
        raise err_type("de needs a byte vector")
    buf = to_np(o).tobytes()
    if len(buf) < 16:
        raise RayError("parse", "short serde buffer")
    prefix, ver, flags, endian, msgtype, size = struct.unpack(
        "<IBBBBq", buf[:16])
    if prefix != SERDE_PREFIX:
        raise RayError("parse", "bad serde prefix")
    if env is None:
        from ..core.interp import current_interp
        ip = current_interp()
        env = ip.env if ip else None
    return de_payload(buf[16:16 + size], env)
