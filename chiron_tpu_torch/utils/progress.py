"""ANSI multi-line progress bars (parity: chiron/utils/progress.py:2-58).

A copy of ``chiron_tpu/utils/progress.py`` (standard library only), so that
the port imports nothing of the JAX package; the tests hold the two copies
to the same outputs.
"""

from __future__ import annotations

import shutil
import sys
import time


class multi_pbars:
    """Several stacked progress bars updated in place on a terminal."""

    def __init__(self, titles, bar_len: int = 30, stream=None):
        self.titles = list(titles)
        self.totals = [0] * len(self.titles)
        self.progresses = [0] * len(self.titles)
        self.bar_len = bar_len
        self.stream = stream or sys.stderr
        self._drawn = False
        self._last = 0.0

    def update(self, idx: int, title=None, progress=None, total=None) -> None:
        if title is not None:
            self.titles[idx] = title
        if progress is not None:
            self.progresses[idx] = progress
        if total is not None:
            self.totals[idx] = total

    def update_bar(self, min_interval: float = 0.1) -> None:
        now = time.time()
        if now - self._last < min_interval:
            return
        self._last = now
        self.refresh()

    def refresh(self) -> None:
        isatty = getattr(self.stream, "isatty", lambda: False)()
        if not isatty:
            return
        n = len(self.titles)
        if self._drawn:
            self.stream.write(f"\x1b[{n}A")
        width = shutil.get_terminal_size((80, 20)).columns
        for i in range(n):
            total = self.totals[i]
            prog = self.progresses[i]
            frac = min(prog / total, 1.0) if total else 0.0
            filled = int(self.bar_len * frac)
            bar = "#" * filled + "-" * (self.bar_len - filled)
            line = f"{self.titles[i][:30]:30s} [{bar}] {prog}/{total}"
            self.stream.write(line[:width] + "\x1b[K\n")
        self._drawn = True
        self.stream.flush()

    def end(self) -> None:
        if self._drawn:
            self.stream.flush()
