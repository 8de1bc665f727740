"""The measured window: frames issued one at a time, closed loop, and the
arithmetic of its end-to-end metrics."""

from __future__ import annotations

import math
import time
from dataclasses import dataclass, field


@dataclass
class Window:
    frame_s: list = field(default_factory=list)   # each frame's call-to-return seconds
    start: float = 0.0
    end: float = 0.0
    failed: int = 0                               # calls that rendered nothing
    views: int = 1
    frames_in_view: int = 0                       # frames of the view shown at the close

    @property
    def seconds(self) -> float:
        return self.end - self.start

    def frame_ms(self) -> float:
        """The window's time over the frames it completed."""
        return self.seconds * 1000.0 / len(self.frame_s)

    def p95_ms(self) -> float:
        return percentile(self.frame_s, 95.0) * 1000.0

    def view_ms(self, per_view: int) -> list:
        """Median frame ms of each view, in order."""
        return [percentile(self.frame_s[i:i + per_view], 50.0) * 1000.0
                for i in range(0, len(self.frame_s), per_view)]


def percentile(values, q: float) -> float:
    """Nearest rank: the smallest value with at least q% of the values at
    or below it."""
    ordered = sorted(values)
    rank = max(1, math.ceil(q / 100.0 * len(ordered)))
    return ordered[rank - 1]


def run_window(render, turn, frames_per_view: int, seconds: float, max_frames=None,
               on_frame=None, clock=time.perf_counter) -> Window:
    """Call render() (one frame; it returns once the frame's result is
    read, False when nothing was rendered) until `seconds` have passed,
    and turn() after every frames_per_view frames. on_frame(i, phase)
    runs before ("start") and after ("end") frame i; max_frames stops
    the window early."""
    w = Window()
    w.start = clock()
    while True:
        i = len(w.frame_s)
        if on_frame is not None:
            on_frame(i, "start")
        t0 = clock()
        ok = render()
        t1 = clock()
        w.frame_s.append(t1 - t0)
        w.failed += 0 if ok else 1
        w.frames_in_view += 1
        if on_frame is not None:
            on_frame(i, "end")
        if t1 - w.start >= seconds or (max_frames is not None and i + 1 >= max_frames):
            w.end = t1
            return w
        if w.frames_in_view == frames_per_view:
            turn()
            w.views += 1
            w.frames_in_view = 0
