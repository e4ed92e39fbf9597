"""CLI entry: `python -m rayforce_tpu_torch [-f file] [-p port] [-i] [-- args]`
(reference app/main.c:36-114: optional script, optional IPC listener,
REPL when interactive)."""
from __future__ import annotations

import sys


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    script = None
    port = None
    kdb_port = None
    interactive = False
    user_args = []
    i = 0
    while i < len(argv):
        a = argv[i]
        if a == "-f" and i + 1 < len(argv):
            script = argv[i + 1]
            i += 2
        elif a == "-p" and i + 1 < len(argv):
            port = int(argv[i + 1])
            i += 2
        elif a == "-kp" and i + 1 < len(argv):
            kdb_port = int(argv[i + 1])
            i += 2
        elif a == "-i":
            interactive = True
            i += 1
        elif a == "-c" and i + 1 < len(argv):
            i += 2  # core count: torch owns threading; accepted for parity
        elif a == "-t":
            # activate the per-query phase profiler (the reference's
            # timeit span recorder, chrono.h:62-81); an optional
            # numeric level argument is accepted for CLI parity
            from ..core import profiler
            profiler.enabled = True
            if i + 1 < len(argv) and argv[i + 1].isdigit():
                i += 2
            else:
                i += 1
        elif a == "--":
            user_args = argv[i + 1:]
            break
        else:
            user_args.append(a)
            i += 1

    from ..core.builtins import Runtime
    rt = Runtime(cli_args=user_args)

    code = 0
    if script:
        from ..core import profiler
        try:
            if profiler.enabled:
                profiler.reset()
            rt.eval_str(open(script).read())
            if profiler.enabled:
                rep = profiler.report()
                if rep:
                    print(rep, file=sys.stderr)
        except SystemExit as e:
            code = e.code or 0
            if port is None and not interactive:
                return code
        except Exception as e:
            print(f"error: {e}", file=sys.stderr)
            return 1

    server = None
    if port is not None:
        from ..ipc.server import IpcServer
        server = IpcServer(rt, port)
        server.start()
        print(f"listening on :{port}", file=sys.stderr)

    if kdb_port is not None:
        # kdb+ wire-protocol listener (ext/kdb.py serve_conn): kdb
        # clients query this engine with their native IPC format
        import socket as _sk
        import threading as _th
        from ..ext import kdb as _kdb
        _lst = _sk.socket()
        _lst.setsockopt(_sk.SOL_SOCKET, _sk.SO_REUSEADDR, 1)
        _lst.bind(("0.0.0.0", kdb_port))
        _lst.listen(16)
        print(f"kdb protocol on :{kdb_port}", file=sys.stderr)

        def _kacc():
            while True:
                try:
                    c, _ = _lst.accept()
                except OSError:
                    return
                _th.Thread(target=_kdb.serve_conn, args=(rt, c),
                           daemon=True).start()
        _th.Thread(target=_kacc, daemon=True).start()
        if port is None and not interactive and script is None:
            import time as _t2
            while True:
                _t2.sleep(3600)

    if interactive or (script is None and port is None
                       and sys.stdin.isatty()):
        from .repl import repl
        repl(rt, server)
    elif server is not None:
        try:
            server.run_forever()
        except KeyboardInterrupt:
            server.stop()
    return code


if __name__ == "__main__":
    sys.exit(main())
