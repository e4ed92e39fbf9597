"""IPC server: the control-plane reactor (reference core/poll.c event loop
+ core/ipc.c message handling).

The reference's epoll/kqueue/IOCP reactor maps to a selectors-based loop on
the host CPU; queries dispatch into the (single) engine, whose heavy
kernels run on the TPU. User hooks `.z.po` / `.z.pc` fire on connection
open/close (ipc.c:195-219); the current handle id is exposed as `.z.w`
(saved/restored around each request, so nested re-entrant service keeps
it correct) and is itself a writable ipc handle — server-side code can
`(write .z.w msg)` to sync-call the requesting client back over the same
connection (the reference's poll_block_on discipline, ipc.c:502-524).

Frames are parsed from a PER-CONNECTION receive buffer: a slow client
delivering a message in pieces never blocks the reactor (the reference's
rx buffer state machines, poll.h:189-219)."""
from __future__ import annotations

import selectors
import socket

import numpy as np

from ..core import types as T
from ..core import symbols
from ..core.obj import Obj, NULL_OBJ, str_of
from ..core.errors import RayError, err_msg
from ..core.obj import string
from . import protocol as proto
from .client import Handle
from ..core import log

class IpcServer:
    def __init__(self, runtime, port: int, host: str = "0.0.0.0"):
        self.rt = runtime
        self.port = port
        self.host = host
        self.sel = selectors.DefaultSelector()
        self.listener = None
        self.handles: dict[int, socket.socket] = {}
        self.rxbuf: dict[int, bytearray] = {}
        self.running = False

    # -- user hooks (.z.po / .z.pc, ipc.c:195) --------------------------
    def _hook(self, name: str, handle: int):
        ip = self.rt.interp
        sid = symbols.intern(name)
        fn = ip.globals.get(sid)
        if fn is not None and fn.t == T.LAMBDA:
            try:
                ip.call_lambda(fn.v, [Obj(-T.I64, np.int64(handle))])
            except RayError:
                pass

    def start(self):
        self.listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self.listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.listener.bind((self.host, self.port))
        self.listener.listen(64)
        self.sel.register(self.listener, selectors.EVENT_READ,
                          self._accept)
        self.running = True

    def _accept(self, sock):
        conn, _addr = sock.accept()
        # version handshake (ipc_read_handshake, ipc.c:282-316): the
        # client's handshake is version bytes TERMINATED BY '\0' —
        # consume through the NUL (a stray terminator left in the
        # stream would misalign the first frame header), reply 1 byte
        try:
            conn.settimeout(5.0)
            hs = b""
            while not hs.endswith(b"\0") and len(hs) < 16:
                b = conn.recv(1)
                if not b:
                    conn.close()
                    return
                hs += b
            conn.settimeout(None)
        except OSError:
            conn.close()
            return
        conn.sendall(bytes([proto.VERSION]))
        # the connection registers in the INTERPRETER's handle registry
        # too: server-side code can (write h ...) to any client
        h = self.rt.interp.handles.add(Handle("ipc", sock=conn))
        self.handles[h] = conn
        self.rxbuf[h] = bytearray()
        self.sel.register(conn, selectors.EVENT_READ,
                          lambda s, h=h: self._on_data(s, h))
        log.info("ipc: connection %d open", h)
        self._hook(".z.po", h)

    def _on_data(self, conn, handle):
        try:
            data = conn.recv(1 << 16)
        except (ConnectionError, OSError):
            self._close(conn, handle)
            return
        if not data:
            self._close(conn, handle)
            return
        buf = self.rxbuf[handle]
        buf += data
        # drain every COMPLETE frame; partial frames stay buffered and
        # never block the reactor
        while True:
            if len(buf) < 16:
                return
            prefix, _v, _f, _e, msgtype, size = proto.HEADER.unpack(
                bytes(buf[:16]))
            if prefix != proto.serde.SERDE_PREFIX:
                self._close(conn, handle)
                return
            if len(buf) < 16 + size:
                return
            payload = bytes(buf[16:16 + size])
            del buf[:16 + size]
            self._process(conn, handle, msgtype, payload)
            if handle not in self.handles:
                # _process closed the connection (decode failure or
                # send error): stop draining — evaluating buffered
                # frames against a dead socket would run side effects
                # nobody can observe
                return

    def _process(self, conn, handle, msgtype, payload):
        ip = self.rt.interp
        try:
            obj = proto.serde.de_payload(payload, ip.env)
        except Exception:
            self._close(conn, handle)
            return
        # .z.w: save/restore per request (nested/interleaved service
        # must not clobber the outer handle)
        zw = symbols.intern(".z.w")
        prev = ip.globals.get(zw)
        ip.globals[zw] = Obj(-T.I64, np.int64(handle))
        try:
            try:
                result = self._eval_msg(obj)
            except RayError as e:
                result = string("'" + err_msg(e))
            except Exception as e:  # engine bug: surface, don't die
                result = string(f"'error: {e}")
        finally:
            if prev is None:
                ip.globals.pop(zw, None)
            else:
                ip.globals[zw] = prev
        if msgtype == proto.MSG_SYNC:
            try:
                conn.sendall(proto.pack_msg(result, proto.MSG_RESP))
            except OSError:
                self._close(conn, handle)

    def _eval_msg(self, obj: Obj) -> Obj:
        """RPC = send code: strings parse+eval, objects eval
        (ipc.c:372-395)."""
        ip = self.rt.interp
        if obj.t == T.C8:
            return ip.eval_str(str_of(obj))
        return ip.eval(obj)

    def _close(self, conn, handle):
        if handle not in self.handles:
            return      # idempotent: .z.pc fires once per connection
        try:
            self.sel.unregister(conn)
        except Exception:
            pass
        conn.close()
        self.handles.pop(handle, None)
        self.rxbuf.pop(handle, None)
        self.rt.interp.handles.handles.pop(handle, None)
        log.info("ipc: connection %d closed", handle)
        self._hook(".z.pc", handle)

    def stop(self):
        self.running = False
        if self.listener is not None:
            try:
                self.sel.unregister(self.listener)
            except Exception:
                pass
            self.listener.close()
        for h, c in list(self.handles.items()):
            self._close(c, h)

    def run_once(self, timeout=0.1):
        for key, _ in self.sel.select(timeout):
            key.data(key.fileobj)

    def run_forever(self):
        while self.running:
            self.run_once(0.25)
            # fire due timers registered via (timer ...)
            from . import timers
            timers.fire_due(self.rt)
