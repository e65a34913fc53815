"""The port's span recorder: the compiled frame's stage times, host spans
of the frame, display and set-up paths, and counters, kept in memory.

    from pathtracer_tpu_torch.utils import spans
    spans.snapshot()        # everything recorded so far, as plain numbers

`span(name)`, a context manager or a decorator, records a block of the
frame, display and set-up paths as a host span (SPANS): pt_frame (one
call of the compiled frame) with its pt_frame.key / .warm / .capture /
.copy / .launch, pt_display.fetch (lanes_to_image), pt_display.u8
(to_uint8) and pt_setup.scene (load_scene). Each span keeps its name,
host start and end (time.perf_counter), the span it ran in, the compiled
frame's call it ran in (a pt_frame span opens one; None outside one) and
whether torch.profiler was on while it ran.

`stage(name)` marks a stage of the frame (STAGES). It records no host
span: while a profiler records, it runs the block under the
torch.profiler range `name` (what tools/trace_stats.py and utils/profiling
read in the eager frame's trace), and a span does the same under its own
name; untraced, neither opens a range (a range costs tens of µs of host
time a block).

A CUDA graph replay runs no host code, so no range sees the stages of the
compiled frame. So a captured frame holds a second graph of the same
iteration, its timed graph, captured while `capturing` a GraphEvents: each
of the top stages (TOP) records timed CUDA events on the capture stream at
its boundaries, event-record nodes of that graph. The compiled frame
replays the timed graph in place of the plain one for the last iteration
of a call when `timed_due` (at most once in TIMED_EVERY_S, and only once
the last timed replay was read); the next call of the compiled frame, or
clear_frames, reads it once it has finished (`read_replay`: a query of its
last event, never a synchronize) and adds one sample a stage: device ms an
iteration, summed over the bounces. A stage starts at the event where the
one before it ended: nothing runs between two stages of the captured
iteration.

Samples and spans that ran while torch.profiler was on are marked traced,
and `median` leaves them out, so that a reading from a traced run is of
its untraced frames. Every list is bounded (CAP, the newest kept).

ENABLED is the one switch: False gives no ranges, no spans, no timed graph
and no counters. It is an upper-case flag of a module that the compiled
frame bakes in (engine/wavefront.py BAKED_MODULES), so a frame captured
with a timed graph and one captured without are two cache entries.
"""
from __future__ import annotations

import collections
import contextlib
import statistics
import time

import torch
from torch.profiler import record_function

ENABLED = True
CAP = 1 << 16
# the least host seconds between two timed replays: one adds ~0.1 ms of
# device time (26 event nodes of an 800x800 depth-8 frame) and its reading
# ~0.3 ms of host time, which every replay or call would otherwise pay
TIMED_EVERY_S = 1.0

# the frame's stages, as the JAX package's scopes: raygen, then each
# bounce's intersect, shade and gather; the binned intersector's
# sub-stages inside pt_intersect come first, as trace_stats charges a
# kernel to the first stage open at its launch
TOP = ("pt_raygen", "pt_intersect", "pt_shade", "pt_gather")
SUB = ("pt_mi_sort", "pt_mi_cull", "pt_mi_stream", "pt_mi_fb")
STAGES = SUB + TOP
RANGES = frozenset(STAGES)
FRAME = "pt_frame"
SPANS = (FRAME, "pt_frame.key", "pt_frame.warm", "pt_frame.capture",
         "pt_frame.copy", "pt_frame.launch", "pt_display.fetch",
         "pt_display.u8", "pt_setup.scene")


def profiler_on() -> bool:
    """Whether torch.profiler (or the autograd profiler) is recording."""
    return torch._C._autograd._profiler_enabled()


class GraphEvents:
    """The timed events of one captured iteration, in the order recorded,
    and (stage, first event, last event) for each stage run."""

    __slots__ = ("events", "stages", "_open", "_boundary")

    def __init__(self):
        self.events, self.stages = [], []
        self._open = []          # (stage, its first event), innermost last
        self._boundary = None    # the event the last stage ended at

    def _record(self) -> int:
        ev = torch.cuda.Event(enable_timing=True, external=True)
        ev.record()
        self.events.append(ev)
        return len(self.events) - 1

    def enter(self, name: str) -> None:
        first = self._boundary if self._boundary is not None else \
            self._record()
        self._boundary = None
        self._open.append((name, first))

    def exit(self) -> None:
        name, first = self._open.pop()
        self._boundary = self._record()
        self.stages.append((name, first, self._boundary))

    def finished(self) -> bool:
        """Whether the last replay has run its last event."""
        return not self.events or self.events[-1].query()

    def stage_ms(self) -> dict:
        """{stage: device ms of the last replay, summed over its runs}."""
        out = {}
        for name, first, last in self.stages:
            out[name] = out.get(name, 0.0) + self.events[first].elapsed_time(
                self.events[last])
        return out


class Recorder:
    """Spans, samples and counters in memory: `records` holds each closed
    span as (id, name, start_s, end_s, parent id, call, traced), and
    `device` each top stage's (ms an iteration, traced); CAP of each, the
    newest kept."""

    def __init__(self, cap: int = CAP):
        self.cap = cap
        self.records = collections.deque(maxlen=cap)
        self.device, self.counters = {}, {}
        self.capture = None      # the GraphEvents of a capture under way
        self.pending = None      # (GraphEvents, traced) of an unread replay
        self._open = []          # (id, call) of the open spans
        self._ids = self._calls = 0
        self._next = float("-inf")   # when a timed replay is due again

    def open(self, name: str, call: bool, traced: bool) -> tuple:
        self._ids += 1
        parent, cur = self._open[-1] if self._open else (None, None)
        if call:
            self._calls += 1
            cur = self._calls
        self._open.append((self._ids, cur))
        return self._ids, name, time.perf_counter(), parent, cur, traced

    def close(self, token: tuple) -> None:
        sid, name, start, parent, call, traced = token
        end = time.perf_counter()
        self._open.pop()
        self.records.append((sid, name, start, end, parent, call,
                             traced or profiler_on()))

    def count(self, name: str, n=1) -> None:
        self.counters[name] = self.counters.get(name, 0) + n

    def timed_due(self) -> bool:
        return self.pending is None and time.perf_counter() >= self._next

    def replayed(self, events) -> None:
        self.pending = (events, profiler_on())
        self._next = time.perf_counter() + TIMED_EVERY_S

    def read_replay(self) -> None:
        if self.pending is None or not self.pending[0].finished():
            return
        events, traced = self.pending
        self.pending = None
        for name, ms in events.stage_ms().items():
            q = self.device.get(name)
            if q is None:
                q = self.device[name] = collections.deque(maxlen=self.cap)
            q.append((ms, traced))

    def snapshot(self) -> dict:
        host = {}
        for _, name, start, end, *_, traced in self.records:
            host.setdefault(name, []).append([end - start, traced])
        return {"spans": [list(r) for r in self.records], "host_s": host,
                "device_ms": {k: [list(v) for v in q]
                              for k, q in self.device.items()},
                "counters": dict(self.counters)}


_REC = Recorder()


@contextlib.contextmanager
def span(name: str, call: bool = False):
    """The block (or, as a decorator, each call) as the host span `name`
    (and a profiler range of that name while a profiler records); `call`
    opens a compiled frame's call, which the spans inside it carry."""
    if not ENABLED:
        yield
        return
    rec, traced = _REC, profiler_on()
    with record_function(name) if traced else contextlib.nullcontext():
        token = rec.open(name, call, traced)
        try:
            yield
        finally:
            rec.close(token)


@contextlib.contextmanager
def stage(name: str):
    """The block as the frame's stage `name` (one of STAGES): a profiler
    range while a profiler records, and inside the capture of a timed
    graph, for a top stage, timed events at its boundaries."""
    if not ENABLED:
        yield
        return
    events = _REC.capture if name in TOP else None
    with record_function(name) if profiler_on() else \
            contextlib.nullcontext():
        if events is not None:
            events.enter(name)
        try:
            yield
        finally:
            if events is not None:
                events.exit()


def count(name: str, n=1) -> None:
    """Add `n` to the counter `name`."""
    if ENABLED:
        _REC.count(name, n)


def graph_events():
    """A new timed graph's GraphEvents, or None with the recorder off (the
    frame then has no timed graph)."""
    return GraphEvents() if ENABLED else None


@contextlib.contextmanager
def capturing(events):
    """The top stages of the block record their boundaries into `events`
    (None: nothing)."""
    prev, _REC.capture = _REC.capture, events
    try:
        yield
    finally:
        _REC.capture = prev


def timed_due() -> bool:
    """Whether the next replay should be a timed one: the recorder on, the
    last timed replay read, and TIMED_EVERY_S since it was launched."""
    return ENABLED and _REC.timed_due()


def replayed(events) -> None:
    """A timed replay with `events` was launched; it is the one
    read_replay reads."""
    _REC.replayed(events)


def read_replay() -> None:
    """Add the last timed replay's stage times, once it has finished."""
    _REC.read_replay()


def snapshot() -> dict:
    """Everything recorded, as plain numbers: {"spans": [[id, name,
    start_s, end_s, parent id or None, call or None, traced]], "host_s":
    {span: [[seconds, traced]]} (the same spans by name), "device_ms":
    {top stage: [[ms an iteration, traced]]}, "counters": {name: value}}.
    The counters: captures (frames captured) and evictions (frames
    dropped past the cache's budget)."""
    return _REC.snapshot()


def reset() -> None:
    """Start the recorder afresh."""
    global _REC
    _REC = Recorder()


def median(samples) -> float | None:
    """The median of the untraced values of [[value, traced]] samples, or
    None where there are none."""
    vals = [v for v, traced in samples or () if not traced]
    return statistics.median(vals) if vals else None


def self_seconds(records) -> dict:
    """{span id: its duration less the durations of the spans whose
    parent it is} of snapshot()["spans"] records."""
    own = {r[0]: r[3] - r[2] for r in records}
    for sid, _, start, end, parent, *_ in records:
        if parent in own:
            own[parent] -= end - start
    return own
