"""Progress bars: indicatif-parity spinner/bar on stderr, 8Hz redraw cap.

reference: src/aux/pbar.rs:7-96 — `prepare_pbar` returns a hidden bar in
multi-CSV mode; `prepare_pbar_force` ignores suppression; known-length bars
render `{spinner} [{elapsed}] {msg} [{bar}] {pos}/{len} ({eta}, {per_sec})`
and unknown-length ones `{spinner} [{elapsed}] {msg} [ ? ] {pos}
({per_sec})`; the PBSummary trait prints `[{hms}] {pos} ({per_sec:.2}/s)`
for hidden bars on finish. Bars self-hide when stderr is not a terminal
(indicatif's draw-target behavior).
"""

from __future__ import annotations

import sys
import time

_SPINNER = "⠋⠙⠹⠸⠼⠴⠦⠧⠇⠏"
_BAR_WIDTH = 40


def get_hms(dur_secs: float) -> str:
    """reference: pbar.rs:89-96 (HH:MM:SS.s, zero-padded)."""
    hours, rem = divmod(dur_secs, 3600.0)
    mins, rem = divmod(rem, 60.0)
    secs = rem % 60.0
    return f"{int(hours):0>2d}:{int(mins):0>2d}:{secs:0>4.1f}"


class ProgressBar:
    """8Hz-capped stderr spinner/bar with the reference's template."""

    def __init__(self, length: int = 0, hidden: bool = False):
        self.length = length
        self.pos = 0
        self.t0 = time.time()
        self.msg = ""
        self._last_draw = 0.0
        self._spin = 0
        self._finished = False
        try:
            tty = sys.stderr.isatty()
        except Exception:
            tty = False
        self.hidden = hidden or not tty

    # -- indicatif surface --

    def set_message(self, msg: str) -> None:
        self.msg = msg
        self._draw()

    def inc(self, n: int = 1) -> None:
        self.pos += n
        self._draw()

    def is_hidden(self) -> bool:
        return self.hidden

    def elapsed(self) -> float:
        return time.time() - self.t0

    def enable_steady_tick(self, _seconds: float = 0.125) -> None:
        # redraws happen on inc(); a thread-based ticker is not worth a
        # thread here — the 8Hz cap already bounds redraw cost
        pass

    def finish(self) -> None:
        if not self.hidden and not self._finished:
            self._draw(force=True)
            sys.stderr.write("\n")
            sys.stderr.flush()
        self._finished = True

    def finish_and_clear(self) -> None:
        if not self.hidden and not self._finished:
            sys.stderr.write("\r\x1b[2K")
            sys.stderr.flush()
        self._finished = True

    # -- PBSummary (pbar.rs:52-88) --

    def _summary_line(self) -> str:
        el = max(self.elapsed(), 1e-9)
        return f"[{get_hms(el)}] {self.pos} ({self.pos / el:.2f}/s)"

    def finish_with_summary(self) -> None:
        if self.is_hidden():
            print(self._summary_line(), file=sys.stderr)
        self.finish()

    def finish_with_summary_force(self) -> None:
        print(self._summary_line(), file=sys.stderr)
        self.finish_and_clear()

    # -- rendering --

    def _draw(self, force: bool = False) -> None:
        if self.hidden or self._finished:
            return
        now = time.time()
        if not force and now - self._last_draw < 0.125:  # 8Hz cap
            return
        self._last_draw = now
        self._spin = (self._spin + 1) % len(_SPINNER)
        el = now - self.t0
        rate = self.pos / el if el > 0 else 0.0
        spinner = _SPINNER[self._spin]
        if self.length > 0:
            frac = min(1.0, self.pos / self.length)
            filled = int(frac * _BAR_WIDTH)
            bar = "#" * filled + "-" * (_BAR_WIDTH - filled)
            eta = (self.length - self.pos) / rate if rate > 0 else 0.0
            line = (
                f"{spinner} [{get_hms(el)}] {self.msg} [{bar}] "
                f"{self.pos}/{self.length} ({eta:.1f}s, {rate:.0f}/s)"
            )
        else:
            line = (
                f"{spinner} [{get_hms(el)}] {self.msg} [ ? ] "
                f"{self.pos} ({rate:.0f}/s)"
            )
        sys.stderr.write("\r\x1b[2K" + line)
        sys.stderr.flush()


_MULTI_CSV_MODE = False


def set_multi_csv_mode(on: bool) -> None:
    """Analog of the reference's MULTI_CSV_MODE OnceLock global
    (fusion_scan.rs:28,320-325) — suppresses non-forced bars."""
    global _MULTI_CSV_MODE
    _MULTI_CSV_MODE = on


def prepare_pbar(length: int) -> ProgressBar:
    """Hidden in multi-CSV mode (pbar.rs:7-15)."""
    return ProgressBar(length, hidden=_MULTI_CSV_MODE)


def prepare_pbar_force(length: int) -> ProgressBar:
    return ProgressBar(length)
