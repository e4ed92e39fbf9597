"""IPC wire protocol (reference core/ipc.c, core/serde.h:30-40).

TCP; handshake = client sends 1 version byte, server replies 1 byte; then
framed messages: 16-byte header {u32 prefix 0xcefadefa, u8 version, u8
flags, u8 endian, u8 msgtype(0=async,1=sync,2=response), i64 size} +
serde payload. RPC is "send code": a C8 payload is parsed+evaluated, any
other object is evaluated as an expression (ipc.c:372-395).
"""
from __future__ import annotations

import socket
import struct

from ..core import types as T
from ..core.obj import Obj, to_np
from ..storage import serde

MSG_ASYNC = 0
MSG_SYNC = 1
MSG_RESP = 2

HEADER = struct.Struct("<IBBBBq")
VERSION = 1


def pack_msg(o: Obj, msgtype: int) -> bytes:
    payload = serde.ser_payload(o)
    return HEADER.pack(serde.SERDE_PREFIX, VERSION, 0, 0, msgtype,
                       len(payload)) + payload


def read_exact(sock: socket.socket, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("peer closed")
        buf += chunk
    return buf


def read_msg(sock: socket.socket, env=None):
    hdr = read_exact(sock, 16)
    prefix, ver, flags, endian, msgtype, size = HEADER.unpack(hdr)
    if prefix != serde.SERDE_PREFIX:
        raise ConnectionError("bad message prefix")
    payload = read_exact(sock, size)
    return msgtype, serde.de_payload(payload, env)
