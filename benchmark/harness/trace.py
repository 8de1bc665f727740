"""The traced window: one torch.profiler timeline over a fixed number of
the window's frames, reduced to device busy time, kernel time by group and
the idle gaps with what the host was doing in each.

The timeline is the profiler's Chrome trace: device events are the
categories "kernel", "gpu_memcpy" and "gpu_memset"; host events are the
host categories (operators, runtime and driver calls, annotations). Both
carry "ts" and "dur" in microseconds on one clock. The window is the span
of the annotation WINDOW_MARK around the profiled frames.
"""

from __future__ import annotations

import json
import os
import tempfile
from dataclasses import dataclass

WINDOW_MARK = "benchmark.profiled_frames"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
TOP = 10


@dataclass
class Event:
    name: str
    start: float       # microseconds
    end: float
    cat: str


@dataclass
class Profile:
    device: list       # Events on the device
    host: list         # Events on the host
    start: float       # the profiled window, microseconds
    end: float
    frames: int

    @property
    def window_s(self) -> float:
        return (self.end - self.start) * 1e-6

    def clipped(self):
        """Device events inside the window, clipped to it."""
        for e in self.device:
            s, t = max(e.start, self.start), min(e.end, self.end)
            if t > s:
                yield e, s, t

    def busy_intervals(self) -> list:
        """The union of the device events' intervals, sorted."""
        out = []
        for _, s, t in sorted(self.clipped(), key=lambda x: x[1]):
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], t)
            else:
                out.append([s, t])
        return out

    def busy_s(self) -> float:
        return sum(t - s for s, t in self.busy_intervals()) * 1e-6

    def idle_gaps(self) -> list:
        """[(start, end)] of the window's stretches with nothing on the device."""
        gaps, at = [], self.start
        for s, t in self.busy_intervals():
            if s > at:
                gaps.append((at, s))
            at = max(at, t)
        if self.end > at:
            gaps.append((at, self.end))
        return gaps

    def host_activity(self, t: float) -> str:
        """The innermost host event around time t; "host idle" where none."""
        best = None
        for e in self.host:
            if e.start <= t <= e.end and (best is None or e.end - e.start < best.end - best.start):
                best = e
        return "host idle" if best is None else best.name

    def kernel_time_by_name(self) -> dict:
        out: dict = {}
        for e, s, t in self.clipped():
            out[e.name] = out.get(e.name, 0.0) + (t - s) * 1e-6
        return out

    def breakdown(self) -> dict:
        ops = sorted(self.kernel_time_by_name().items(), key=lambda kv: -kv[1])[:TOP]
        gaps = sorted(self.idle_gaps(), key=lambda g: g[0] - g[1])[:TOP]
        return {"device_ops": [[name[:160], sec] for name, sec in ops],
                "idle_gaps": [[self.host_activity(0.5 * (s + t))[:160], (t - s) * 1e-6]
                              for s, t in gaps]}


def parse_chrome_trace(trace: dict, frames: int) -> Profile:
    """A Profile from the profiler's Chrome trace (a dict)."""
    device, host, window = [], [], None
    for ev in trace.get("traceEvents", []):
        if ev.get("ph") != "X" or "dur" not in ev:
            continue
        e = Event(str(ev.get("name", "")), float(ev["ts"]), float(ev["ts"]) + float(ev["dur"]),
                  str(ev.get("cat", "")))
        if e.cat in DEVICE_CATS:
            device.append(e)
        elif e.cat in HOST_CATS:
            host.append(e)
            if e.name == WINDOW_MARK and e.cat == "user_annotation":
                window = e
    if window is None:
        raise ValueError(f"the trace has no {WINDOW_MARK} annotation")
    host = [e for e in host if e is not window]
    return Profile(device, host, window.start, window.end, frames)


class Tracer:
    """Profiles frames [WARMUP, WARMUP + frames) of the window, after
    WARMUP frames in which the profiler starts up (CUPTI's start-up lands
    there, not in the profiled frames): call step(i, phase) from the
    window's on_frame hook, then profile()."""

    WARMUP = 2

    def __init__(self, frames: int):
        self.frames = frames
        self._prof = None
        self._mark = None
        self._path = None
        self._text = None
        self._last = self.WARMUP + frames - 1

    @staticmethod
    def prime(device) -> None:
        """Start and stop the profiler once around a tiny device op, so that
        its one-time start-up (CUPTI's, seconds) falls before the window."""
        import torch
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
            torch.ones(1, device=device).add_(1)
            if torch.cuda.is_available():
                torch.cuda.synchronize()

    def _save(self, prof) -> None:
        # Called when the active frames end, before the profiler drops them.
        prof.export_chrome_trace(self._path)
        with open(self._path, encoding="utf-8") as f:
            self._text = f.read()

    def step(self, i: int, phase: str) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function, schedule

        if i > self._last:
            return
        if i == 0 and phase == "start":
            fd, self._path = tempfile.mkstemp(suffix=".json")
            os.close(fd)
            self._prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                                 schedule=schedule(wait=0, warmup=self.WARMUP,
                                                   active=self.frames, repeat=1),
                                 on_trace_ready=self._save)
            self._prof.start()
        if i == self.WARMUP and phase == "start":
            self._mark = record_function(WINDOW_MARK)
            self._mark.__enter__()
        if phase == "end":
            if i == self._last:
                if torch.cuda.is_available():
                    torch.cuda.synchronize()
                self._mark.__exit__(None, None, None)
                self._mark = None
            self._prof.step()

    def profile(self) -> Profile:
        """The profiled frames' timeline; raises where the window closed
        before they were all rendered."""
        if self._text is None:
            self._prof.stop()
        self._prof = None
        os.unlink(self._path)
        if self._mark is not None or not self._text:
            raise RuntimeError(f"no trace of the {self.frames} profiled frames: the window "
                               f"closed after {self.WARMUP} + {self.frames} frames: "
                               f"{self._mark is None}; trace read: {bool(self._text)}")
        return parse_chrome_trace(json.loads(self._text), self.frames)
