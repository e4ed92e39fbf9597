"""Interactive REPL (reference app/repl.c + app/term.c).

readline provides history and tab-completion over builtins and globals
(the reference's term.c line editor, 1688 LoC of raw-mode handling, maps
onto the host's readline). Multiline input continues while parens are
unbalanced. The IPC server (if any) is pumped between reads.
"""
from __future__ import annotations

import os
import sys

from ..core import types as T
from ..core import symbols, fmt
from ..core.errors import RayError, err_msg


def _completer_factory(rt):
    """readline-protocol completer over the shared candidate set
    (builtins + globals + table columns + query keywords; reference
    env.c:475-547 name enumeration)."""
    from .term import completions

    def complete(text, state):
        cands = completions(rt, text)
        return cands[state] if state < len(cands) else None
    return complete


def _balanced(src: str) -> bool:
    depth = 0
    in_str = False
    esc = False
    for ch in src:
        if in_str:
            if esc:
                esc = False
            elif ch == "\\":
                esc = True
            elif ch == '"':
                in_str = False
            continue
        if ch == '"':
            in_str = True
        elif ch in "([{":
            depth += 1
        elif ch in ")]}":
            depth -= 1
    return depth <= 0 and not in_str


def repl(rt, server=None):
    # the raw-mode editor (app/term.py, the reference's term.c) drives
    # real TTYs; piped stdin falls back to plain input(); readline (if
    # importable) backs input() history for the non-TTY path
    editor = None
    if sys.stdin.isatty() and sys.stdout.isatty():
        try:
            from .term import LineEditor, interactive_readline, \
                completions
            editor = LineEditor(
                completer=lambda text: completions(rt, text),
                history_path=os.path.expanduser(
                    "~/.rayforce_tpu_history"))
        except Exception:
            editor = None
    if editor is None:
        try:
            import readline
            readline.set_completer(_completer_factory(rt))
            readline.set_completer_delims(" \t\n()[]{}\"'")
            readline.parse_and_bind("tab: complete")
        except ImportError:
            pass
    print("rayforce-tpu; (exit 0) to quit", file=sys.stderr)
    buf = ""
    while True:
        try:
            if server is not None:
                server.run_once(0)
            prompt = "❯ " if not buf else "… "
            if editor is not None:
                line = interactive_readline(editor, prompt)
                if line is None:
                    print()
                    return
            else:
                line = input(prompt)
        except EOFError:
            print()
            return
        except KeyboardInterrupt:
            buf = ""
            print()
            continue
        buf = (buf + "\n" + line) if buf else line
        if not _balanced(buf):
            continue
        src, buf = buf, ""
        if not src.strip():
            continue
        try:
            from ..core import profiler
            if profiler.enabled:
                profiler.reset()
            result = rt.eval_str(src)
            if result is not None and result.t != -T.NULL:
                print(fmt.format_obj(result, 0, None, 1))
            if profiler.enabled:
                rep = profiler.report()
                if rep:
                    print(rep, file=sys.stderr)
        except SystemExit:
            raise
        except RayError as e:
            print(f"'{err_msg(e)}", file=sys.stderr)
            _print_span(src, getattr(e, "span", None))
        except Exception as e:
            print(f"'error: {e}", file=sys.stderr)


def _print_span(src: str, span):
    """Underline the failing subexpression (the reference's nfo-span
    error rendering, app/repl.c:50-78)."""
    if not span:
        return
    ln, c0, c1 = span
    lines = src.split("\n")
    if not (0 <= ln < len(lines)):
        return
    text = lines[ln]
    width = max(int(c1) - int(c0), 1)
    print(f"  {text}", file=sys.stderr)
    print("  " + " " * int(c0) + "^" * min(width, max(len(text) -
                                                      int(c0), 1)),
          file=sys.stderr)
