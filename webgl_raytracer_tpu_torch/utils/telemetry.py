"""The port's recorder of spans and counters. Off by default.

    from webgl_raytracer_tpu_torch.utils import telemetry
    telemetry.enable()                 # before the scene is compiled
    ...                                # set-up and Renderer frames
    telemetry.export("telemetry.json")
    telemetry.disable()

While it is off (`recorder` is None) no code of the port calls into this
module on a frame's path: each call site reads `recorder` and goes on, so
the frame that a Renderer captures is the one it captures without it.
The active recorder is one per process, like ops/kernels.launches.

Spans. Each has a name, a parent, a start and an end; its self time is
its duration less its children's.

- Device spans time a frame on its device: `frame` (a captured replay or
  an eager frame) and, under it, the transport's stages (frame.head with
  env.miss and pack, bounce[b] with extend, env.miss, shade, shadow,
  env.nee, sample and repack, frame.tail; render/integrator.py) and,
  around every hand-kernel launch (ops/kernels.launch), a span named
  after the kernel. On CUDA tensors each boundary is a stamp of the GPU's
  global nanosecond timer, written by a one-thread kernel
  (csrc/telemetry.cu) into a device buffer of the frame: recorded while
  the frame is captured, the stamps are kernel nodes of the CUDA graph,
  so every replay times itself with no host call, and the buffer is read
  once after the block's host read, which has already waited for the
  replay. (Timing events captured as external events time replays too,
  but on the H100 a record node took about three small kernels' slots and
  each elapsed_time read about 6 us of host time, some 0.7 ms a frame.)
  A block of several replays is timed by its last replay. Eager frames
  (the redo, vis frames, impl="plain", the capture's warm-up) stamp the
  same way; on CPU tensors the marks are the host's monotonic clock.
- Host spans: frame.setup, frame.launch, frame.wait, frame.redo and
  frame.capture of the frame loop (render/frame.py), and at set-up
  scene.compile (scene.bvh, scene.clusters, scene.upload), kernels.library
  and env.sky. They are stamped in nanoseconds of the clock of
  torch.profiler's Chrome trace, Unix time: an event there starts at
  ts = (stamp - baseTimeNanoseconds) / 1000. While a profiler is active
  each is also a record_function range of the same name.

Counters: the binned transport's live lanes per bounce, a device int64
tensor of the frame added to inside it, beside the lanes each bounce ran
(its buffer). Renderer.stats["captures"] and ops.kernels.launches are
read, not copied.

Storage: per span name its count, sum, min, max (and, for device spans,
self) in ms; one row per Renderer.render_frames call (summary()["frames"]);
every host span with its stamps. export(path) writes summary() as JSON.
"""

from __future__ import annotations

import contextlib
import functools
import json
import time

import torch

# The active Recorder, or None (off).
recorder = None


def enable() -> "Recorder":
    """Turn the recorder on with a new, empty Recorder and return it."""
    global recorder
    recorder = Recorder()
    return recorder


def disable() -> None:
    global recorder
    recorder = None


def export(path) -> dict:
    """Write the active recorder's summary() to `path` as JSON; returns
    it. Raises where the recorder is off."""
    if recorder is None:
        raise RuntimeError("the recorder is off: telemetry.enable() first")
    return recorder.export(path)


def host_span(name: str):
    """The active recorder's host span `name` (a context manager), or a
    no-op one where it is off."""
    return _NULL if recorder is None else recorder.host(name)


def spanned(name: str):
    """Decorator: each call of the function is the host span `name`."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with host_span(name):
                return fn(*args, **kwargs)
        return inner
    return wrap


_NULL = contextlib.nullcontext()


def profiling() -> bool:
    """Whether a torch profiler is recording on this thread."""
    return torch._C._autograd._profiler_enabled()


class _HostSpan:
    __slots__ = ("rec", "name", "start", "range")

    def __init__(self, rec, name):
        self.rec, self.name = rec, name

    def __enter__(self):
        self.range = None
        if profiling():
            self.range = torch.autograd.profiler.record_function(self.name)
            self.range.__enter__()
        self.rec._open_host.append(self.name)
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        rec = self.rec
        rec._open_host.pop()
        if self.range is not None:
            self.range.__exit__(None, None, None)
        rec._host_done(self.name, rec._open_host[-1] if rec._open_host else None,
                       self.start, end)
        return False


# Marks a frame may stamp on the card, and the bounces whose lanes it
# counts (render/config.py clamps max_bounces to 8): its buffer's sizes.
MAX_MARKS = 4096
LANE_SLOTS = 8


class _Plan:
    """One frame's device spans: the marks, in order, and the spans
    between them (name, parent span index or -1, start mark, end mark),
    and its live lanes a bounce. On the card one int64 buffer of the frame
    holds both: the lanes counted in its first LANE_SLOTS, then the
    stamps, so that one read takes them."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.marks = []         # host ns on the CPU; stamp slots on the card
        self.spans = []
        self.open = []          # indices of the open spans, outermost first
        self.pending = []       # (level, name): stages that open at the next mark
        self.bounces = 0        # bounces whose live lanes it counts
        self.lanes_run = None   # lanes each bounce ran
        if self.cuda:
            from ..ops.kernels import library, stream_handle

            self._stamp = library().wrt_clock_mark
            self._stream = stream_handle(self.device)
            self.buf = torch.empty(LANE_SLOTS + MAX_MARKS, dtype=torch.int64,
                                   device=self.device)
        else:
            self.buf = torch.zeros(LANE_SLOTS, dtype=torch.int64)

    def mark(self) -> int:
        i = len(self.marks)
        if self.cuda:
            if i == MAX_MARKS:
                raise RuntimeError(f"a frame stamps at most {MAX_MARKS} marks")
            with torch.cuda.device(self.device):
                err = self._stamp(self.buf.data_ptr() + 8 * (LANE_SLOTS + i), self._stream)
            if err != 0:
                raise RuntimeError(f"wrt_clock_mark failed: CUDA error {err}")
            self.marks.append(i)
        else:
            self.marks.append(time.perf_counter_ns())
        for level, name in self.pending:
            self.close_to(level, i)
            self.begin(name, i)
        self.pending.clear()
        return i

    def begin(self, name: str, at: int) -> None:
        self.spans.append([name, self.open[-1] if self.open else -1, at, None])
        self.open.append(len(self.spans) - 1)

    def close_to(self, depth: int, at: int) -> None:
        while len(self.open) > depth:
            self.spans[self.open.pop()][3] = at

    def count_lanes(self, bounce: int, live, run: int, bounces: int) -> None:
        if not self.bounces:
            if bounces > LANE_SLOTS:
                raise ValueError(f"lanes are counted for at most {LANE_SLOTS} bounces")
            self.bounces, self.lanes_run = bounces, [0] * bounces
            if self.cuda:
                self.buf[:bounces].zero_()
        self.buf[bounce].add_(live)
        self.lanes_run[bounce] += run

    def read(self) -> tuple:
        """(the marks in ns, the live lanes a bounce or None). On the card
        one read of the buffer, which waits for the frame: a block's host
        read has already waited for a replay."""
        if self.cuda:
            values = self.buf[:LANE_SLOTS + len(self.marks)].tolist()
            return tuple(values[LANE_SLOTS:]), (tuple(values[:self.bounces])
                                                 if self.bounces else None)
        return self.marks, tuple(self.buf[:self.bounces].tolist()) if self.bounces else None


class Recorder:
    """Spans and counters of the frames and set-up while it is active
    (the module docstring). The program calls it through its call sites
    only while it is telemetry.recorder."""

    def __init__(self):
        self.totals = {}         # device span name -> aggregate of the rows summarised
        self.host_spans = []     # (name, parent, start ns, end ns)
        self._open_host = []
        self._plan = None        # the frame being recorded
        self._row = None         # the render_frames call being recorded
        self._timed = []         # its frames' plans, read when it returns
        self._rows = []          # rows not yet summarised: stamps, layouts, times
        self._frames = []        # rows in summary form

    # -- host spans ------------------------------------------------------

    def host(self, name: str) -> _HostSpan:
        """A context manager: the host span `name`, a child of the host
        span open around it."""
        return _HostSpan(self, name)

    def _host_done(self, name, parent, start, end) -> None:
        self.host_spans.append((name, parent, start, end))
        if self._row is not None:
            host = self._row["host_ms"]
            host[name] = host.get(name, 0.0) + (end - start) * 1e-6

    @staticmethod
    def _add(totals, clock, name, ms, self_ms=None) -> None:
        t = totals.get(name)
        if t is None:
            t = totals[name] = {"clock": clock, "count": 0, "sum_ms": 0.0,
                                "min_ms": ms, "max_ms": ms}
            if self_ms is not None:
                t["self_ms"] = 0.0
        t["count"] += 1
        t["sum_ms"] += ms
        t["min_ms"] = min(t["min_ms"], ms)
        t["max_ms"] = max(t["max_ms"], ms)
        if self_ms is not None:
            t["self_ms"] += self_ms

    # -- device spans ----------------------------------------------------

    def begin_frame(self, device) -> None:
        """Open a frame's device spans on `device`: its root, `frame`,
        starts at the frame's first mark."""
        self._plan = _Plan(device)
        self._plan.pending.append((0, "frame"))

    def end_frame(self) -> _Plan:
        """Close every open span of the frame; returns its plan, which
        timed() reads once the frame has run."""
        plan, self._plan = self._plan, None
        plan.close_to(0, plan.mark())
        plan.layout = tuple(tuple(s) for s in plan.spans)
        plan.marks = tuple(plan.marks)
        del plan.spans, plan.open, plan.pending
        return plan

    def stage(self, name: str, level: int) -> None:
        """Close the frame's spans deeper than `level` (1: the frame's own
        stages; 2: their children) and open `name` there, at one mark."""
        plan = self._plan
        if plan is not None:
            at = plan.mark()
            plan.close_to(level, at)
            plan.begin(name, at)

    def stage_next(self, name: str, level: int) -> None:
        """stage(name, level) at the frame's next mark, which it shares:
        for a stage whose first work is its first part's (a bounce)."""
        if self._plan is not None:
            self._plan.pending.append((level, name))

    def end(self, level: int) -> None:
        """Close the frame's spans deeper than `level`."""
        plan = self._plan
        if plan is not None:
            plan.close_to(level, plan.mark())

    def push(self, name: str) -> None:
        """Open `name` inside the innermost open span (a kernel launch)."""
        plan = self._plan
        if plan is not None:
            plan.begin(name, plan.mark())

    def pop(self) -> None:
        plan = self._plan
        if plan is not None:
            plan.close_to(len(plan.open) - 1, plan.mark())

    def lanes(self, bounce: int, live, run: int, bounces: int) -> None:
        """Add `live` (a 0-d device tensor) to the frame's live lanes of
        `bounce`, which ran `run` lanes."""
        if self._plan is not None:
            self._plan.count_lanes(bounce, live, run, bounces)

    # -- rows --------------------------------------------------------------

    def call(self, renderer, frames: int) -> "_Call":
        """A context manager around one Renderer.render_frames call of
        `frames` frames: its row."""
        return _Call(self, renderer, frames)

    def timed(self, plan) -> None:
        """Read `plan` (a frame that has run, or a captured frame that has
        been replayed: its last replay) into the row of the call in
        progress, when the call returns."""
        if self._row is not None and plan is not None:
            self._timed.append(plan)

    def eager_frame(self, device) -> "_EagerFrame":
        """A context manager: one eager frame's device spans, timed in
        the row of the call in progress."""
        return _EagerFrame(self, device)

    def _close_row(self, renderer, redone) -> None:
        row, self._row = self._row, None
        timed, self._timed = self._timed, []
        row["return_ns"] = time.time_ns()
        if not timed:
            return
        reads = [(p, *p.read()) for p in timed]
        row["timed"] = tuple((p.layout, marks) for p, marks, _ in reads)
        lanes = [(live, p.lanes_run) for p, _, live in reads if live is not None]
        if lanes:
            row["lanes"] = tuple(sum(c) for c in zip(*(live for live, _ in lanes)))
            row["lanes_run"] = tuple(sum(c) for c in zip(*(run for _, run in lanes)))
        if renderer is not None:
            row["captures"] = renderer.stats["captures"]
            row["redone"] = renderer.stats["redone_frames"] > redone
        # Kept as a tuple of tuples of numbers and strings, which the
        # collector stops tracking: rows kept for a whole run do not
        # lengthen its passes.
        self._rows.append(tuple(row.items()))

    # -- summary -------------------------------------------------------------

    def frames(self) -> list:
        """The rows in summary form (each call's host stamps, host ms by
        span, device ms, count and self ms by span, lanes)."""
        self._frames.extend(self._summarise(row) for row in self._rows)
        self._rows = []
        return self._frames

    def _summarise(self, row) -> dict:
        row = dict(row)
        spans, frame_ms = {}, 0.0
        for layout, marks in row["timed"]:
            dur = [(marks[end] - marks[start]) * 1e-6 for _, _, start, end in layout]
            own = list(dur)
            for i, (_, parent, _, _) in enumerate(layout):
                if parent >= 0:
                    own[parent] -= dur[i]
            for i, (name, _, _, _) in enumerate(layout):
                self._add(self.totals, "device", name, dur[i], own[i])
                s = spans.setdefault(name, [0, 0.0, 0.0])
                s[0] += 1
                s[1] += dur[i]
                s[2] += own[i]
            frame_ms += dur[0]
        out = {k: list(v) if isinstance(v, tuple) else v
               for k, v in row.items() if k != "timed"}
        out["timed_frames"] = len(row["timed"])
        out["frame_ms"] = frame_ms
        out["spans"] = spans
        return out

    def summary(self) -> dict:
        """Everything recorded: spans by name, frame rows, host spans and
        the counters read (kernel launches by name)."""
        from ..ops.kernels import launches

        frames = self.frames()
        totals = {k: dict(v) for k, v in self.totals.items()}
        for name, _, start, end in self.host_spans:
            self._add(totals, "host", name, (end - start) * 1e-6)
        return {"clock": "host stamps: Unix ns, the clock of torch.profiler's Chrome "
                         "trace (ts = (stamp - baseTimeNanoseconds) / 1000)",
                "kernels": sorted(launches),
                "launches": dict(launches),
                "spans": totals,
                "frames": frames,
                "host_spans": [list(s) for s in self.host_spans]}

    def export(self, path) -> dict:
        data = self.summary()
        with open(path, "w", encoding="utf-8") as f:
            json.dump(data, f)
        return data


class _Call:
    __slots__ = ("rec", "renderer", "frames", "redone")

    def __init__(self, rec, renderer, frames):
        self.rec, self.renderer, self.frames = rec, renderer, frames

    def __enter__(self):
        self.redone = (self.renderer.stats["redone_frames"] if self.renderer is not None
                       else 0)
        self.rec._timed = []
        self.rec._row = {"call_ns": time.time_ns(), "frames": self.frames,
                         "profiler": profiling(), "host_ms": {}}
        return self

    def __exit__(self, *exc):
        self.rec._close_row(self.renderer, self.redone)
        return False


class _EagerFrame:
    __slots__ = ("rec", "device")

    def __init__(self, rec, device):
        self.rec, self.device = rec, device

    def __enter__(self):
        self.rec.begin_frame(self.device)
        return self

    def __exit__(self, *exc):
        self.rec.timed(self.rec.end_frame())
        return False
