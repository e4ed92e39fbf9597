"""Raw-mode terminal line editor — the reference's app/term.c (1688
LoC: history, multiline, tab-completion over keywords/builtins/globals/
table-columns via env.c:475-547 name enumeration, ANSI colors).

`LineEditor` reads keys from a raw TTY and renders with ANSI escapes:
cursor movement (C-a/C-e/arrows/M-b/M-f), kill ops (C-k/C-u/C-w),
history stepping (up/down), persistent history file, and tab
completion (unique -> insert, common prefix -> extend, else a colored
column listing). The key reader and writer are injectable so tests
drive the editor without a pty.
"""
from __future__ import annotations

import os
import sys

# query-form keywords the parser recognizes inside dict literals
# (reference env.c hot symbols env.c:55-64: from/where/by/take...)
KEYWORDS = ["from:", "where:", "by:", "take:"]

_C_PROMPT = "\x1b[1;32m"    # bold green (reference term.c prompt)
_C_DIM = "\x1b[2m"
_C_RESET = "\x1b[0m"


def completions(rt, text: str) -> list:
    """Candidate names for `text`: builtins + globals + COLUMNS of
    every global table (the reference enumerates table columns for
    completion, env.c:475-547) + query keywords."""
    from ..core import symbols as S
    from ..core import types as T
    cands = set()
    for n in rt.env.builtins:
        if n.startswith(text):
            cands.add(n)
    for kw in KEYWORDS:
        if kw.startswith(text):
            cands.add(kw)
    for sid, val in rt.interp.globals.items():
        n = S.name_of(sid)
        if n.startswith(text):
            cands.add(n)
        try:
            if val.t == T.TABLE:
                names, _cols = val.v
                for csid in names.v:
                    cn = S.name_of(int(csid))
                    if cn.startswith(text):
                        cands.add(cn)
        except Exception:
            pass
    return sorted(cands)


class LineEditor:
    """One editing session over a raw-mode TTY (or injected streams).

    read_key() -> str (single char, possibly part of an escape seq);
    write(s) renders. readline(prompt) returns the submitted line
    (without newline) or None on EOF (C-d on empty line).
    """

    def __init__(self, completer=None, history_path=None,
                 read_key=None, write=None, width=None):
        self.completer = completer or (lambda text: [])
        self.history_path = history_path
        self.history: list = []
        self._read = read_key
        self._write = write
        self._width = width
        if history_path:
            try:
                with open(history_path) as f:
                    self.history = [ln.rstrip("\n") for ln in f][-500:]
            except OSError:
                pass

    # -- IO plumbing ------------------------------------------------------
    def _reader(self):
        if self._read is not None:
            return self._read
        def rd():
            ch = os.read(sys.stdin.fileno(), 1)
            return ch.decode("utf-8", "replace") if ch else ""
        return rd

    def _writer(self):
        if self._write is not None:
            return self._write
        def wr(s):
            sys.stdout.write(s)
            sys.stdout.flush()
        return wr

    def _save_history(self):
        if not self.history_path:
            return
        try:
            with open(self.history_path, "w") as f:
                f.write("\n".join(self.history[-500:]) + "\n")
        except OSError:
            pass

    # -- word helpers ------------------------------------------------------
    @staticmethod
    def _is_word(ch: str) -> bool:
        return ch.isalnum() or ch in "-_?.!"

    def _word_left(self, buf, pos):
        while pos > 0 and not self._is_word(buf[pos - 1]):
            pos -= 1
        while pos > 0 and self._is_word(buf[pos - 1]):
            pos -= 1
        return pos

    def _word_right(self, buf, pos):
        n = len(buf)
        while pos < n and not self._is_word(buf[pos]):
            pos += 1
        while pos < n and self._is_word(buf[pos]):
            pos += 1
        return pos

    def _token_start(self, buf, pos):
        """Start of the completion token before pos (delimiters match
        the readline fallback in repl.py)."""
        i = pos
        while i > 0 and buf[i - 1] not in " \t\n()[]{}\"'":
            i -= 1
        return i

    # -- rendering ---------------------------------------------------------
    def _render(self, wr, prompt, buf, pos, colored=True):
        p = f"{_C_PROMPT}{prompt}{_C_RESET}" if colored else prompt
        wr("\r\x1b[K" + p + buf)
        back = len(buf) - pos
        if back > 0:
            wr(f"\x1b[{back}D")

    def _show_candidates(self, wr, cands):
        width = self._width or 80
        colw = max(len(c) for c in cands) + 2
        per = max(width // colw, 1)
        wr("\r\n")
        for i in range(0, len(cands), per):
            row = "".join(c.ljust(colw) for c in cands[i:i + per])
            wr(_C_DIM + row.rstrip() + _C_RESET + "\r\n")

    # -- main loop ----------------------------------------------------------
    def readline(self, prompt: str = "") -> str | None:
        rd, wr = self._reader(), self._writer()
        buf = ""
        pos = 0
        hidx = len(self.history)
        saved = ""          # line being edited before history nav
        self._render(wr, prompt, buf, pos)
        while True:
            ch = rd()
            if ch == "":                      # stream EOF
                wr("\r\n")
                return buf if buf else None
            o = ord(ch[0]) if ch else 0
            if ch in ("\r", "\n"):
                wr("\r\n")
                if buf.strip():
                    if not self.history or self.history[-1] != buf:
                        self.history.append(buf)
                    self._save_history()
                return buf
            if o == 3:                        # C-c
                wr("^C\r\n")
                raise KeyboardInterrupt
            if o == 4:                        # C-d
                if not buf:
                    wr("\r\n")
                    return None
                if pos < len(buf):
                    buf = buf[:pos] + buf[pos + 1:]
            elif o in (8, 127):               # backspace
                if pos > 0:
                    buf = buf[:pos - 1] + buf[pos:]
                    pos -= 1
            elif o == 1:                      # C-a
                pos = 0
            elif o == 5:                      # C-e
                pos = len(buf)
            elif o == 11:                     # C-k
                buf = buf[:pos]
            elif o == 21:                     # C-u
                buf = buf[pos:]
                pos = 0
            elif o == 23:                     # C-w
                st = self._word_left(buf, pos)
                buf = buf[:st] + buf[pos:]
                pos = st
            elif o == 12:                     # C-l: clear screen
                wr("\x1b[2J\x1b[H")
            elif o == 9:                      # TAB
                st = self._token_start(buf, pos)
                token = buf[st:pos]
                cands = self.completer(token)
                if len(cands) == 1:
                    ins = cands[0][len(token):]
                    buf = buf[:pos] + ins + buf[pos:]
                    pos += len(ins)
                elif len(cands) > 1:
                    common = os.path.commonprefix(cands)
                    if len(common) > len(token):
                        ins = common[len(token):]
                        buf = buf[:pos] + ins + buf[pos:]
                        pos += len(ins)
                    else:
                        self._show_candidates(wr, cands)
            elif o == 27:                     # ESC sequences
                seq = rd()
                if seq == "[":
                    code = rd()
                    num = ""
                    while code.isdigit() or code == ";":
                        num += code
                        code = rd()
                    if code == "A":           # up: history
                        if hidx > 0:
                            if hidx == len(self.history):
                                saved = buf
                            hidx -= 1
                            buf = self.history[hidx]
                            pos = len(buf)
                    elif code == "B":         # down
                        if hidx < len(self.history):
                            hidx += 1
                            buf = self.history[hidx] \
                                if hidx < len(self.history) else saved
                            pos = len(buf)
                    elif code == "C":         # right
                        if num == "1;5":      # ctrl-right: word
                            pos = self._word_right(buf, pos)
                        elif pos < len(buf):
                            pos += 1
                    elif code == "D":         # left
                        if num == "1;5":
                            pos = self._word_left(buf, pos)
                        elif pos > 0:
                            pos -= 1
                    elif code == "H":
                        pos = 0
                    elif code == "F":
                        pos = len(buf)
                    elif code == "~":
                        if num == "3" and pos < len(buf):   # delete
                            buf = buf[:pos] + buf[pos + 1:]
                        elif num == "1":
                            pos = 0
                        elif num == "4":
                            pos = len(buf)
                elif seq == "b":              # M-b
                    pos = self._word_left(buf, pos)
                elif seq == "f":              # M-f
                    pos = self._word_right(buf, pos)
                elif seq == "":               # bare ESC at EOF
                    return buf if buf else None
            elif o >= 32:                     # printable
                buf = buf[:pos] + ch + buf[pos:]
                pos += len(ch)
            self._render(wr, prompt, buf, pos)


def raw_mode(fd):
    """Context manager: cbreak/raw the TTY, restore on exit."""
    import termios
    import tty
    import contextlib

    @contextlib.contextmanager
    def _cm():
        old = termios.tcgetattr(fd)
        try:
            tty.setraw(fd, termios.TCSADRAIN)
            yield
        finally:
            termios.tcsetattr(fd, termios.TCSADRAIN, old)
    return _cm()


def interactive_readline(editor: LineEditor, prompt: str):
    """One raw-mode read on the real TTY."""
    with raw_mode(sys.stdin.fileno()):
        return editor.readline(prompt)
