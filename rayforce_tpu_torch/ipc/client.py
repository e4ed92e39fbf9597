"""IPC client handles: (hopen "host:port"), (write h expr), (hclose h)
(reference core/io.c:144-366, core/ipc.c ipc_open/ipc_send).

Sync writes block for the response; while blocked, incoming *requests*
from the peer are served re-entrantly (the reference's poll_block_on
nested event pump, epoll.c:411-466) so two engines can call each other.
"""
from __future__ import annotations

import socket

import numpy as np

from ..core import types as T
from ..core.obj import Obj, NULL_OBJ, str_of, string
from ..core.errors import RayError, err_os, err_type
from . import protocol as proto


class Handle:
    __slots__ = ("sock", "kind", "path", "file")

    def __init__(self, kind, sock=None, path=None, file=None):
        self.kind = kind  # "ipc" | "file"
        self.sock = sock
        self.path = path
        self.file = file


class HandleRegistry:
    def __init__(self):
        self.handles: dict[int, Handle] = {}
        self.next_id = 3

    def add(self, h: Handle) -> int:
        i = self.next_id
        self.next_id += 1
        self.handles[i] = h
        return i

    def get(self, i: int) -> Handle:
        h = self.handles.get(i)
        if h is None:
            raise RayError("domain", f"bad handle {i}")
        return h

    def close(self, i: int):
        h = self.handles.pop(i, None)
        if h is None:
            return
        if h.sock is not None:
            h.sock.close()
        if h.file is not None:
            h.file.close()


def hopen(registry: HandleRegistry, spec: str, timeout=None) -> int:
    """(hopen "host:port") -> ipc handle; (hopen "path") -> file handle."""
    if ":" in spec and not spec.startswith("/") and not spec.startswith("."):
        host, port = spec.rsplit(":", 1)
        host = host or "127.0.0.1"
        try:
            sock = socket.create_connection((host, int(port)),
                                            timeout=timeout)
            # version handshake: NUL-terminated version bytes, server
            # replies one byte (reference ipc_open sends {VERSION, 0},
            # ipc.c:230-245; server scans to the trailing '\0',
            # ipc_read_handshake ipc.c:282-316)
            sock.sendall(bytes([proto.VERSION, 0]))
            proto.read_exact(sock, 1)
            sock.settimeout(None)
        except OSError as e:
            raise err_os(str(e))
        return registry.add(Handle("ipc", sock=sock))
    try:
        f = open(spec, "ab+")
    except OSError as e:
        raise err_os(str(e))
    return registry.add(Handle("file", path=spec, file=f))


def write(registry: HandleRegistry, interp, hid: int, msg: Obj) -> Obj:
    h = registry.get(hid)
    if h.kind == "file":
        # append to file (journaling pattern, examples/journal.rfl)
        from ..storage import serde
        h.file.write(bytes(np.asarray(
            serde.ser_obj(msg).v, dtype=np.uint8).tobytes()))
        h.file.flush()
        return Obj(-T.I64, np.int64(hid))
    # sync send: block for the response, serving incoming requests
    h.sock.sendall(proto.pack_msg(msg, proto.MSG_SYNC))
    while True:
        msgtype, obj = proto.read_msg(h.sock, interp.env)
        if msgtype == proto.MSG_RESP:
            return obj
        # re-entrant request service (ipc.c:502-522)
        try:
            if obj.t == T.C8:
                result = interp.eval_str(str_of(obj))
            else:
                result = interp.eval(obj)
        except RayError as e:
            from ..core.errors import err_msg
            result = string("'" + err_msg(e))
        if msgtype == proto.MSG_SYNC:
            h.sock.sendall(proto.pack_msg(result, proto.MSG_RESP))


def write_async(registry: HandleRegistry, hid: int, msg: Obj) -> None:
    h = registry.get(hid)
    if h.kind != "ipc":
        raise err_type("async write needs an ipc handle")
    h.sock.sendall(proto.pack_msg(msg, proto.MSG_ASYNC))


def read(registry: HandleRegistry, hid: int) -> Obj:
    h = registry.get(hid)
    if h.kind == "file":
        h.file.seek(0)
        data = h.file.read()
        return string(data)
    msgtype, obj = proto.read_msg(h.sock)
    return obj
