"""kdb+ IPC wire-protocol bridge (the analogue of the reference's
ext/raykx plugin, the reference ext/raykx/raykx.c: its own serde/type
mapping between kdb objects and engine objects).

Implements the public kdb+ IPC format:
- handshake: client sends "user:pass\\x03\\x00", server replies one
  capability byte;
- message: 8-byte header [endian=1, msgtype(0 async,1 sync,2 response),
  compressed flag, 0, u32 total-length] + serialized object
  (compressed frames decode via the public kdb block scheme);
- atoms are negative type codes, vectors positive with [attrib u8]
  [u32 len]; 0 = mixed list, 99 = dict, 98 = table (98, attrib, dict).

Type mapping (kdb <-> rayforce): boolean 1<->B8, byte 4<->U8, short
5<->I16, int 6<->I32, long 7<->I64, float 9<->F64, char 10<->C8,
symbol 11<->SYMBOL (ENUM materializes), timestamp 12<->TIMESTAMP,
date 14<->DATE, time 19<->TIME, 0<->LIST, 99<->DICT, 98<->TABLE.
Both sides use the 2000.01.01 epoch for date/timestamp and
milliseconds-since-midnight for time, so temporal values map with NO
conversion.

Exposed builtins: (kopen "host:port" ["user"]) -> handle,
(kwrite h expr) sync query, (kclose h). `serve_once` accepts one kdb
client connection for the reverse direction (kdb querying this engine).
"""
from __future__ import annotations

import socket
import struct

import numpy as np

from ..core import types as T
from ..core import symbols
from ..core.obj import (Obj, NULL_OBJ, list_, dict_, table, string,
                        str_of, to_np)
from ..core.errors import RayError, err_type, err_os

# kdb type code <-> (rayforce type, numpy dtype, width)
_VEC = {
    1: (T.B8, np.int8, 1),
    4: (T.U8, np.uint8, 1),
    5: (T.I16, np.int16, 2),
    6: (T.I32, np.int32, 4),
    7: (T.I64, np.int64, 8),
    9: (T.F64, np.float64, 8),
    12: (T.TIMESTAMP, np.int64, 8),
    14: (T.DATE, np.int32, 4),
    19: (T.TIME, np.int32, 4),
}
_RT2K = {rt: k for k, (rt, _d, _w) in _VEC.items()}


def ser_k(o: Obj) -> bytes:
    """Serialize a rayforce object to kdb+ wire bytes (payload only)."""
    t = o.t
    if t < 0:
        st = -t
        if st == T.NULL:
            return b"\x65\x00"     # :: generic null
        if st == T.SYMBOL:
            return b"\xf5" + symbols.name_of(int(o.v)).encode() + b"\x00"
        if st == T.C8:
            return b"\xf6" + bytes([int(o.v) & 0xFF])
        if st in _RT2K:
            k = _RT2K[st]
            _rt, dt, _w = _VEC[k]
            return struct.pack("<b", -k) + np.asarray(
                [o.v], dtype=dt).tobytes()
        raise err_type(f"kdb: unsupported atom type {st}")
    if t == T.SYMBOL or t == T.ENUM:
        if t == T.ENUM:
            from ..ops.items import ray_value
            o = ray_value(o)
        names = b"".join(symbols.name_of(int(s)).encode() + b"\x00"
                         for s in to_np(o))
        return struct.pack("<bBI", 11, 0, len(o)) + names
    if t == T.C8:
        data = bytes(to_np(o).tobytes())
        return struct.pack("<bBI", 10, 0, len(data)) + data
    if t in _RT2K:
        k = _RT2K[t]
        _rt, dt, _w = _VEC[k]
        a = np.ascontiguousarray(to_np(o), dtype=dt)
        return struct.pack("<bBI", k, 0, len(a)) + a.tobytes()
    if t == T.LIST:
        body = b"".join(ser_k(e) for e in o.v)
        return struct.pack("<bBI", 0, 0, len(o.v)) + body
    if t == T.DICT:
        kk, vv = o.v
        return b"\x63" + ser_k(kk) + ser_k(vv)
    if t == T.TABLE:
        names, cols = o.v
        colblob = struct.pack("<bBI", 0, 0, len(cols)) + \
            b"".join(ser_k(c) for c in cols)
        return b"\x62\x00" + b"\x63" + ser_k(names) + colblob
    raise err_type(f"kdb: unsupported type {t}")


class _Rd:
    __slots__ = ("b", "i")

    def __init__(self, b: bytes):
        self.b = b
        self.i = 0

    def take(self, n):
        v = self.b[self.i:self.i + n]
        if len(v) != n:
            raise RayError("length", "kdb: truncated message")
        self.i += n
        return v

    def sym(self):
        j = self.b.index(b"\x00", self.i)
        s = self.b[self.i:j].decode()
        self.i = j + 1
        return s


def _de(r: _Rd) -> Obj:
    t = struct.unpack("<b", r.take(1))[0]
    if t < 0:
        k = -t
        if k == 11:
            return Obj(-T.SYMBOL, np.int64(symbols.intern(r.sym())))
        if k == 10:
            return Obj(-T.C8, np.uint8(r.take(1)[0]))
        if k in _VEC:
            rt, dt, w = _VEC[k]
            return Obj(-rt, np.frombuffer(r.take(w), dtype=dt)[0])
        raise err_type(f"kdb: unsupported atom type {t}")
    if t == 0:
        _at = r.take(1)
        n = struct.unpack("<I", r.take(4))[0]
        return list_([_de(r) for _ in range(n)])
    if t == 10:
        _at = r.take(1)
        n = struct.unpack("<I", r.take(4))[0]
        return string(r.take(n))
    if t == 11:
        _at = r.take(1)
        n = struct.unpack("<I", r.take(4))[0]
        ids = np.asarray([symbols.intern(r.sym()) for _ in range(n)],
                         dtype=np.int64)
        return Obj(T.SYMBOL, ids)
    if t in _VEC:
        rt, dt, w = _VEC[t]
        _at = r.take(1)
        n = struct.unpack("<I", r.take(4))[0]
        return Obj(rt, np.frombuffer(r.take(n * w),
                                     dtype=dt).copy())
    if t == 99:
        kk = _de(r)
        vv = _de(r)
        if kk.t == T.TABLE or vv.t == T.TABLE:
            return dict_(kk, vv)    # keyed table -> dict of tables
        return dict_(kk, vv)
    if t == 98:
        _at = r.take(1)
        d = struct.unpack("<b", r.take(1))[0]
        if d != 99:
            raise err_type("kdb: bad table payload")
        names = _de(r)
        cols = _de(r)
        if cols.t != T.LIST:
            raise err_type("kdb: bad table columns")
        return table(names, list(cols.v))
    if t == 100:   # lambda: context + char vector body -> string
        r.sym()
        return _de(r)
    if t == -128 or t == 128:
        raise RayError("user", f"kdb error: {r.sym()}")
    raise err_type(f"kdb: unsupported type {t}")


def de_k(b: bytes) -> Obj:
    return _de(_Rd(b))


def pack_msg(o: Obj, msgtype: int) -> bytes:
    payload = ser_k(o)
    return struct.pack("<BBBBI", 1, msgtype, 0, 0,
                       8 + len(payload)) + payload


def decompress(body: bytes) -> bytes:
    """kdb+ IPC block decompression (the public algorithm: one control
    byte per 8 items; a set bit copies 2+n bytes from a 256-slot
    position table hashed by adjacent-byte XOR, rebuilt from the output
    as it grows; matches the reference bridge raykx.c:268-333).

    `body` is everything after the 8-byte message header; its first 4
    bytes hold the uncompressed TOTAL length including that header."""
    if len(body) < 4:
        raise RayError("parse", "kdb: short compressed message")
    n_total = struct.unpack_from("<I", body)[0]
    n = n_total - 8
    out = bytearray(n)
    pos = [0] * 256
    d = 4
    s = 0
    p = 0
    ctrl = 0
    bit = 0
    while s < n:
        if bit == 0:
            ctrl = body[d]
            d += 1
            bit = 1
        if ctrl & bit:
            r = pos[body[d]]
            d += 1
            out[s] = out[r]
            out[s + 1] = out[r + 1]
            s += 2
            r += 2
            run = body[d]
            d += 1
            for m in range(run):
                out[s + m] = out[r + m]
        else:
            out[s] = body[d]
            s += 1
            d += 1
            run = None
        while p < s - 1:
            pos[out[p] ^ out[p + 1]] = p
            p += 1
        if run is not None:
            s += run
            p = s
        bit <<= 1
        if bit == 256:
            bit = 0
    return bytes(out)


def compress(payload: bytes) -> bytes:
    """Compress a message body with the same scheme (exercises
    `decompress` in the tests; usable toward peers that accept
    compressed frames). Emits the hash-slot byte for each match — the
    receiver resolves it through its own position table, which both
    sides grow identically from the decoded prefix. Returns the body
    WITH the leading u32 uncompressed-total field."""
    n = len(payload)
    out = bytearray(struct.pack("<I", n + 8))
    pos = [0] * 256
    s = 0
    p = 0
    block: list = []     # up to 8 encoded items
    fbits = 0

    def flush():
        nonlocal fbits, block
        if block:
            out.append(fbits)
            for b in block:
                out.extend(b)
            fbits = 0
            block = []

    while s < n:
        item = None
        if s + 1 < n:
            h = payload[s] ^ payload[s + 1]
            r = pos[h]
            if 0 <= r < s - 1 and payload[r] == payload[s] \
                    and payload[r + 1] == payload[s + 1]:
                run = 0
                while run < 255 and s + 2 + run < n \
                        and payload[r + 2 + run] == payload[s + 2 + run]:
                    run += 1
                item = (h, run)
        if item is not None:
            h, run = item
            fbits |= 1 << len(block)
            block.append(bytes((h, run)))
            s += 2
            while p < s - 1:
                pos[payload[p] ^ payload[p + 1]] = p
                p += 1
            s += run
            p = s
        else:
            block.append(payload[s:s + 1])
            s += 1
            while p < s - 1:
                pos[payload[p] ^ payload[p + 1]] = p
                p += 1
        if len(block) == 8:
            flush()
    flush()
    return bytes(out)


def read_msg(sock) -> tuple:
    hdr = _read_exact(sock, 8)
    endian, msgtype, comp, _z, total = struct.unpack("<BBBBI", hdr)
    if endian != 1:
        raise RayError("nyi", "kdb: big-endian peer")
    body = _read_exact(sock, total - 8)
    if comp:
        body = decompress(body)
    return msgtype, de_k(body)


def _read_exact(sock, n):
    buf = b""
    while len(buf) < n:
        c = sock.recv(n - len(buf))
        if not c:
            raise ConnectionError("kdb peer closed")
        buf += c
    return buf


# -- client -------------------------------------------------------------------

def kopen(registry, spec: str, user: str = "") -> int:
    from ..ipc.client import Handle
    host, port = spec.rsplit(":", 1)
    host = host or "127.0.0.1"
    try:
        sock = socket.create_connection((host, int(port)))
        sock.sendall(user.encode() + b"\x03\x00")
        cap = sock.recv(1)
        if not cap:
            raise err_os("kdb handshake rejected")
    except OSError as e:
        raise err_os(str(e))
    h = Handle("kdb", sock=sock)
    return registry.add(h)


def kwrite(registry, hid: int, msg: Obj) -> Obj:
    h = registry.get(hid)
    if h.kind != "kdb":
        raise err_type("kwrite needs a kdb handle")
    h.sock.sendall(pack_msg(msg, 1))
    while True:
        msgtype, obj = read_msg(h.sock)
        if msgtype == 2:
            return obj


# -- server shim (a kdb client querying THIS engine) --------------------------

def serve_conn(rt, conn) -> None:
    """Serve one accepted kdb connection until the peer closes:
    handshake reply, then char-vector queries evaluate as Rayfall."""
    creds = b""
    while not creds.endswith(b"\x00"):
        c = conn.recv(1)
        if not c:
            return
        creds += c
    conn.sendall(b"\x03")
    while True:
        try:
            msgtype, obj = read_msg(conn)
        except (ConnectionError, OSError):
            return
        try:
            if obj.t == T.C8:
                result = rt.eval_str(str_of(obj))
            else:
                result = rt.eval(obj) if hasattr(rt, "eval") else \
                    rt.interp.eval(obj)
        except RayError as e:
            from ..core.errors import err_msg
            result = string("'" + err_msg(e))
        if msgtype == 1:
            conn.sendall(pack_msg(
                result if result is not None else NULL_OBJ, 2))
