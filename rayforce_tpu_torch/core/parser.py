"""Rayfall reader.

Hand-written recursive-descent parser with the same surface grammar as the
reference (core/parse.c): `(...)` calls, `[...]` typed vector literals with
promotion, `{k: v}` dict literals, `(fn [args] body...)` lambdas, typed
number/temporal literals with h/i/l/f/x/d/t suffixes, 0N* nulls, 'sym quoted
symbols, strings with escapes, `;` comments, shebang skip. Known builtins are
replaced by function objects at parse time except inside vector literals and
dict keys (parse.c replace_symbols discipline).
"""
from __future__ import annotations

import numpy as np

from . import types as T
from . import symbols, temporal
from .obj import (Obj, b8, u8, i16, i32, i64, f64, c8, sym, sym_null, date,
                  time_, timestamp, string, list_, dict_, NULL_OBJ, vector,
                  guid)
from .errors import RayError, err_parse, err_domain

_OPS = set("+-*/%&|^~<>!=._?")
_TERM = set(")]}: \r\n\0")

I64_MIN, I64_MAX = -(2 ** 63), 2 ** 63 - 1


def _qnull():
    o = sym_null()
    o.attrs |= 1  # ATTR_QUOTED (parse.c:190)
    return o


def _is_alpha(c):
    return ("a" <= c <= "z") or ("A" <= c <= "Z")


def _is_alnum(c):
    return _is_alpha(c) or c.isdigit()


class _Token:
    """Terminator token (reference TYPE_TOKEN)."""
    __slots__ = ("c",)

    def __init__(self, c):
        self.c = c


class Lambda:
    """Parsed lambda. `env` persists across calls on the lambda object itself
    (reference: AS_LAMBDA(fn)->env, eval.c amend)."""
    __slots__ = ("name", "params", "args_obj", "body", "env")

    def __init__(self, args_obj: Obj, body: Obj):
        self.name = None
        self.args_obj = args_obj
        self.params = [int(x) for x in np.asarray(args_obj.v)]
        self.body = body
        self.env: dict[int, Obj] = {}


SYM_FN = symbols.intern("fn")


class Parser:
    def __init__(self, src: str, env=None):
        self.src = src
        self.pos = 0
        self.n = len(src)
        self.line = 0
        self.col = 0
        self.replace_symbols = True
        self.env = env  # builtin registry for symbol replacement

    # -- low-level ----------------------------------------------------
    def eof(self):
        return self.pos >= self.n or self.src[self.pos] == "\0"

    def peek(self, k=0):
        p = self.pos + k
        return self.src[p] if p < self.n else "\0"

    def advance_char(self, k=1):
        for _ in range(k):
            if self.pos < self.n and self.src[self.pos] == "\n":
                self.line += 1
                self.col = 0
            else:
                self.col += 1
            self.pos += 1

    def skip_ws(self):
        while not self.eof():
            c = self.src[self.pos]
            if c in " \t\r\n":
                self.advance_char()
            elif c == ";":
                while not self.eof() and self.src[self.pos] != "\n":
                    self.advance_char()
                if not self.eof():
                    self.advance_char()
            else:
                break

    def error(self, kind="parse", msg=""):
        raise RayError(kind, msg or f"at line {self.line + 1}:{self.col + 1}")

    # -- token dispatch ------------------------------------------------
    def next_token(self):
        self.skip_ws()
        if self.eof():
            return _Token("\0")
        c = self.peek()
        if c == "[":
            return self.parse_vector()
        if c == "(":
            return self.parse_list()
        if c == "{":
            return self.parse_dict()
        if (c == "-" and self.peek(1).isdigit()) or c.isdigit():
            tok = self.parse_0nx()
            if tok is not None:
                return tok
            tok = self.parse_timestamp_or_date()
            if tok is not None:
                return tok
            tok = self.parse_time()
            if tok is not None:
                return tok
            return self.parse_number()
        if c == "'":
            return self.parse_char_or_qsym()
        if c == '"':
            return self.parse_string()
        if _is_alpha(c) or c in _OPS:
            return self.parse_symbol()
        if c in _TERM:
            self.advance_char()
            return _Token(c)
        self.error()

    # -- literals ------------------------------------------------------
    def parse_0nx(self):
        if self.peek() != "0" or self.peek(1) != "N":
            return None
        k = self.peek(2)
        mk = {
            "0": lambda: NULL_OBJ,
            "h": lambda: i16(T.NULL_I16),
            "i": lambda: i32(T.NULL_I32),
            "d": lambda: date(T.NULL_I32),
            "t": lambda: time_(T.NULL_I32),
            "p": lambda: timestamp(T.NULL_I64),
            "l": lambda: i64(T.NULL_I64),
            "f": lambda: f64(T.NULL_F64),
            "g": lambda: guid(bytes(16)),
            "s": lambda: _qnull(),
        }
        if k in mk:
            self.advance_char(3)
            return mk[k]()
        return None

    def parse_timestamp_or_date(self):
        s, p = self.src, self.pos
        if self.n - p < 10 or p + 7 >= self.n:
            return None
        if not (s[p:p + 4].isdigit() and s[p + 4] == "." and
                s[p + 5:p + 7].isdigit() and s[p + 7] == "."):
            return None
        year = int(s[p:p + 4])
        month = int(s[p + 5:p + 7])
        if month > 12 or month < 1:
            self.error("domain", "bad month")
        q = p + 8
        if not (q + 1 < self.n and s[q].isdigit() and s[q + 1].isdigit()):
            return None
        day = int(s[q:q + 2])
        if day > 31 or day < 1:
            self.error("domain", "bad day")
        q += 2
        days = temporal.days_from_civil(year, month, day)
        if q >= self.n or s[q] != "D":
            self.advance_char(q - p)
            return date(days)
        q += 1

        def two(q):
            if q + 1 < self.n and s[q].isdigit() and s[q + 1].isdigit():
                return int(s[q:q + 2])
            return None
        h = two(q)
        if h is None:
            return None
        if h > 23:
            self.error("domain", "bad hour")
        q += 2
        if self.peek_at(q) != ":":
            return None
        q += 1
        mi = two(q)
        if mi is None:
            return None
        if mi > 59:
            self.error("domain", "bad minute")
        q += 2
        if self.peek_at(q) != ":":
            return None
        q += 1
        sec = two(q)
        if sec is None:
            return None
        if sec > 59:
            self.error("domain", "bad second")
        q += 2
        if self.peek_at(q) != ".":
            return None
        q += 1
        r = q
        while r < self.n and s[r].isdigit():
            r += 1
        if r == q:
            return None
        nanos = int(s[q:r])  # raw digits, no scaling (parse.c:409)
        self.advance_char(r - p)
        ns = temporal.make_ts_ns(year, month, day, h, mi, sec, nanos)
        return timestamp(ns)

    def peek_at(self, q):
        return self.src[q] if q < self.n else "\0"

    def parse_time(self):
        s, p = self.src, self.pos
        q = p
        sign = 1
        if self.peek_at(q) == "-":
            sign = -1
            q += 1
        if not (s[q:q + 2].isdigit() and len(s[q:q + 2]) == 2):
            return None
        hh = int(s[q:q + 2])
        q += 2
        if self.peek_at(q) != ":":
            return None
        q += 1
        if not s[q:q + 2].isdigit() or len(s[q:q + 2]) < 2:
            return None
        mm = int(s[q:q + 2])
        q += 2
        if self.peek_at(q) != ":":
            return None
        q += 1
        if not s[q:q + 2].isdigit() or len(s[q:q + 2]) < 2:
            return None
        ss = int(s[q:q + 2])
        q += 2
        ms = 0
        if self.peek_at(q) == ".":
            q += 1
            if not self.peek_at(q).isdigit():
                return None
            # 1-3 digits, NO scaling: .1 == 1 ms (parse.c:245-259)
            ms = int(self.peek_at(q))
            q += 1
            for _ in range(2):
                if self.peek_at(q).isdigit():
                    ms = ms * 10 + int(self.peek_at(q))
                    q += 1
        self.advance_char(q - p)
        return time_(temporal.make_time_ms(sign, hh, mm, ss, ms))

    def parse_number(self):
        s, p = self.src, self.pos
        if s[p:p + 2] == "0x" or (self.n - p >= 2 and s[p] == "0"
                                  and s[p + 1] == "x"):
            q = p + 2
            r = q
            while r < self.n and s[r] in "0123456789abcdefABCDEF":
                r += 1
            val = int(s[q:r], 16) if r > q else 0
            self.advance_char(r - p)
            return u8(val & 0xFF)
        q = p
        if self.peek_at(q) == "-":
            q += 1
        r = q
        while r < self.n and s[r].isdigit():
            r += 1
        intval = None
        if r > q:
            intval = int(s[p:r])
            if not (I64_MIN <= intval <= I64_MAX):
                intval = None  # overflow -> fall through to float
        if intval is not None and self.peek_at(r) != ".":
            return self.specify_number(r, intval)
        # float: strtod-style
        r2 = r
        if self.peek_at(r2) == ".":
            r2 += 1
            while r2 < self.n and s[r2].isdigit():
                r2 += 1
        if self.peek_at(r2) in "eE":
            r3 = r2 + 1
            if self.peek_at(r3) in "+-":
                r3 += 1
            if self.peek_at(r3).isdigit():
                r3 += 1
                while r3 < self.n and s[r3].isdigit():
                    r3 += 1
                r2 = r3
        if r2 > (q if r == q else r):
            val = float(s[p:r2])
            self.advance_char(r2 - p)
            if self.peek_at(self.pos) in "xhidtl":
                self.error("parse", "bad suffix on float")
            if self.peek_at(self.pos) == "f":
                self.advance_char()
            return f64(val)
        if intval is not None:
            return self.specify_number(r, intval)
        self.error("domain", "bad number")

    def specify_number(self, r, intval):
        sfx = self.peek_at(r)
        self.advance_char(r - self.pos)
        if sfx == "x":
            if intval > 255:
                self.advance_char()
                self.error("domain", "u8 overflow")
            self.advance_char()
            return u8(intval)
        if sfx == "h":
            self.advance_char()
            if not (-32767 <= intval <= 32767):
                self.error("domain", "i16 overflow")
            return i16(intval)
        if sfx == "i":
            self.advance_char()
            if not (-2147483647 <= intval <= 2147483647):
                self.error("domain", "i32 overflow")
            return i32(intval)
        if sfx == "d":
            self.advance_char()
            return date(intval)
        if sfx == "t":
            self.advance_char()
            return time_(intval)
        if sfx == "f":
            self.advance_char()
            return f64(float(intval))
        if sfx == "l":
            self.advance_char()
            return i64(intval)
        return i64(intval)

    def parse_char_or_qsym(self):
        # reference parse_char (parse.c:539-646)
        p = self.pos
        q = p + 1
        s = self.src
        if q >= self.n or self.peek_at(q) in _TERM:
            self.advance_char(1)
            out = sym_null()
            out.attrs |= 1  # ATTR_QUOTED
            return out
        ch = None
        if s[q] == "\\":
            q += 1
            esc = self.peek_at(q)
            mk = {"n": "\n", "r": "\r", "t": "\t", "\\": "\\", "'": "'"}
            if esc in mk:
                ch = mk[esc]
                q += 1
            elif esc.isdigit() and esc <= "7":
                val = int(esc)
                q += 1
                for _ in range(2):
                    d = self.peek_at(q)
                    if not (d.isdigit() and d <= "7"):
                        self.error("domain", "bad octal escape")
                    val = (val << 3) | int(d)
                    q += 1
                ch = chr(val)
            else:
                self.error("domain", "bad escape")
        else:
            ch = s[q]
            q += 1
        if self.peek_at(q) == "'":
            q += 1
            self.advance_char(q - p)
            return c8(ord(ch) & 0xFF)
        # quoted symbol
        while q < self.n and (_is_alnum(s[q]) or s[q] in _OPS):
            q += 1
        if self.peek_at(q) == "'":
            self.error("domain", "bad char literal")
        name = s[p + 1:q]
        self.advance_char(q - p)
        out = sym(name)
        out.attrs |= 1  # ATTR_QUOTED
        return out

    def parse_string(self):
        p = self.pos
        q = p + 1
        s = self.src
        buf = bytearray()
        while q < self.n:
            c = s[q]
            if c == "\\":
                q += 1
                esc = self.peek_at(q)
                mk = {"\\": "\\", '"': '"', "n": "\n", "r": "\r", "t": "\t"}
                if esc in mk:
                    buf.extend(mk[esc].encode())
                    q += 1
                elif esc.isdigit() and esc <= "7":
                    val = 0
                    for _ in range(3):
                        d = self.peek_at(q)
                        if not (d.isdigit() and d <= "7"):
                            self.error("domain", "bad octal escape")
                        val = (val << 3) | int(d)
                        q += 1
                    buf.append(val & 0xFF)
                else:
                    self.error("domain", "bad string escape")
                continue
            if c == '"':
                break
            buf.extend(c.encode())
            q += 1
        if self.peek_at(q) != '"':
            self.error("parse", "unterminated string")
        q += 1
        self.advance_char(q - p)
        return string(bytes(buf))

    def parse_symbol(self):
        s, p = self.src, self.pos
        for word, mk in (("true", lambda: b8(True)),
                         ("false", lambda: b8(False)),
                         ("null", lambda: NULL_OBJ)):
            if s.startswith(word, p):
                nxt = self.peek_at(p + len(word))
                if not (_is_alnum(nxt) or nxt in _OPS):
                    self.advance_char(len(word))
                    return mk()
        q = p + 1
        while q < self.n and (_is_alnum(s[q]) or s[q] in _OPS):
            q += 1
        name = s[p:q]
        self.advance_char(q - p)
        if self.replace_symbols and self.env is not None:
            fn = self.env.builtin(name)
            if fn is not None:
                return fn
        return sym(name)

    # -- containers ----------------------------------------------------
    def _advance_raw(self):
        saved = self.replace_symbols
        self.replace_symbols = False
        try:
            return self.next_token()
        finally:
            self.replace_symbols = saved

    def parse_vector(self):
        self.advance_char(1)  # '['
        vec_t = None
        vals: list = []
        while True:
            tok = self._advance_raw()
            if isinstance(tok, _Token):
                if tok.c == "]":
                    break
                self.error("parse", "bad vector literal")
            t = tok.t
            if t >= 0 and t != -T.NULL:
                # containers not allowed inside vector literals
                self.error("domain", "non-atom in vector literal")
            st = -t
            if st == T.B8:
                if vals and vec_t != T.B8:
                    self.error("domain", "mixed vector literal")
                vec_t = T.B8
                vals.append(int(tok.v))
            elif st == T.U8:
                if vals and vec_t != T.U8:
                    self.error("domain", "mixed vector literal")
                vec_t = T.U8
                vals.append(int(tok.v))
            elif st in (T.I16, T.I32, T.DATE, T.TIME, T.SYMBOL, T.TIMESTAMP):
                if vec_t is None:
                    vec_t = st
                    vals.append(tok.v)
                elif vec_t == st:
                    vals.append(tok.v)
                elif st == T.I16 and vec_t == T.F64:
                    vals.append(float(tok.v))
                else:
                    self.error("domain", "mixed vector literal")
            elif st == T.I64:
                if vec_t is None or vec_t == T.I64:
                    vec_t = T.I64
                    vals.append(tok.v)
                elif vec_t == T.F64:
                    vals.append(float(tok.v))
                else:
                    self.error("domain", "mixed vector literal")
            elif st == T.F64:
                if vec_t is None or vec_t == T.F64:
                    vec_t = T.F64
                    vals.append(tok.v)
                elif vec_t == T.I64:
                    vec_t = T.F64
                    vals = [float(x) for x in vals]
                    vals.append(tok.v)
                else:
                    self.error("domain", "mixed vector literal")
            else:
                self.error("domain", "bad vector literal element")
        if vec_t is None:
            return vector(T.I64, [])
        return vector(vec_t, vals)

    def parse_list(self):
        span0 = (self.line, self.col)
        self.advance_char(1)  # '('
        tok = self.next_token()
        # lambda special form
        if (not isinstance(tok, _Token) and tok.t == -T.SYMBOL
                and int(tok.v) == SYM_FN and not (tok.attrs & 1)):
            args = self.next_token()
            if isinstance(args, _Token):
                self.error("parse", "bad lambda args")
            if args.t != T.SYMBOL:
                if args.t == T.I64 and len(args.v) == 0:
                    args = Obj(T.SYMBOL, np.zeros(0, dtype=np.int64))
                else:
                    self.error("parse", "bad lambda args")
            body = self.parse_do_until_term()
            close = self.next_token()
            if not (isinstance(close, _Token) and close.c == ")"):
                self.error("domain", "bad lambda body")
            lam = Lambda(args, body)
            return Obj(T.LAMBDA, lam)
        items = []
        while True:
            if isinstance(tok, _Token):
                if tok.c == ")":
                    break
                self.error("parse", "bad list")
            items.append(tok)
            tok = self.next_token()
        if not items:
            return NULL_OBJ
        node = list_(items)
        # nfo span (reference parse.c:45-61 registers every node in the
        # nfo map; here call nodes carry (line, col_start, col_end) so
        # runtime errors can underline the failing subexpression)
        node.meta = {"span": (span0[0], span0[1],
                              self.col if self.line == span0[0]
                              else span0[1] + 1)}
        return node

    def parse_dict(self):
        self.advance_char(1)  # '{'
        keys: list = []
        key_t = None
        vals: list = []
        tok = self._advance_raw()
        while True:
            if isinstance(tok, _Token):
                if tok.c == "}":
                    break
                self.error("domain", "bad dict literal")
            if tok.t >= 0:
                self.error("domain", "bad dict key")
            if key_t is None:
                key_t = -tok.t
            keys.append(tok.v)
            colon = self.next_token()
            if not (isinstance(colon, _Token) and colon.c == ":"):
                self.error("parse", "expected ':' in dict literal")
            val = self.next_token()
            if isinstance(val, _Token):
                self.error("domain", "bad dict value")
            vals.append(val)
            tok = self._advance_raw()
        if key_t is None:
            return dict_(vector(T.SYMBOL, []), list_([]))
        return dict_(vector(key_t, keys), list_(vals))

    # -- top level -----------------------------------------------------
    def parse_do_until_term(self):
        """Collect expressions until a terminator; >1 becomes (do ...)."""
        exprs = []
        while not self.eof():
            save = self.pos, self.line, self.col
            tok = self.next_token()
            if isinstance(tok, _Token):
                if tok.c != "\0":
                    self.pos, self.line, self.col = save
                break
            exprs.append(tok)
        if not exprs:
            return NULL_OBJ
        if len(exprs) == 1:
            return exprs[0]
        do_fn = self.env.builtin("do") if self.env else sym("do")
        return list_([do_fn] + exprs)


def parse(src: str, env=None) -> Obj:
    p = Parser(src, env)
    if src.startswith("#!"):
        nl = src.find("\n")
        p.pos = len(src) if nl < 0 else nl
    res = p.parse_do_until_term()
    p.skip_ws()
    if not p.eof():
        p.error("parse", "unparsed input")
    return res
