"""Terminal progress bar for long operations (reference core/progress.c:
40-character block bar rendered during long loads). Renders only when
stderr is a tty; otherwise every call is a no-op.
"""
from __future__ import annotations

import sys

_WIDTH = 40


class Progress:
    def __init__(self, label: str, total: int):
        self.label = label
        self.total = max(int(total), 1)
        self.done = 0
        self._last = -1
        self.tty = sys.stderr.isatty()

    def step(self, n: int = 1) -> None:
        self.done += n
        if not self.tty:
            return
        filled = min(_WIDTH, (self.done * _WIDTH) // self.total)
        if filled == self._last:
            return
        self._last = filled
        bar = "█" * filled + "░" * (_WIDTH - filled)
        pct = min(100, (self.done * 100) // self.total)
        print(f"\r{self.label} [{bar}] {pct:3d}%", end="",
              file=sys.stderr, flush=True)

    def finish(self) -> None:
        if self.tty:
            self.step(self.total - self.done)
            print(file=sys.stderr)
