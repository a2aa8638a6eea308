"""Spans and counters on the hot path, and the operator's trace.

The recorder:

  * `span(name, step=None)`: a context manager around one layer's work.
    While recording is off it returns one shared no-op context and does
    nothing else. While it is on, it keeps the name, perf_counter_ns() at
    entry and at exit, the native thread id, the index of its parent (the
    innermost span open on the same thread, -1 for none) and the step of
    the sampler or training step in progress (a span given `step` is that
    step: spans opened while it is open, on any thread, carry its number).
  * `count(name, n=1)`: adds to a counter while recording is on.
  * `start_recording()` / `take()`: switch recording on, and off again;
    `take()` returns the spans and counters as a `Recording`, with a
    (time.time_ns(), perf_counter_ns()) anchor pair taken at start and at
    stop, which puts the spans on the profiler's clock (Unix-epoch
    nanoseconds, the clock of kineto's events).

Nothing is written to disk by the recorder. The exporter, `start_trace()` /
`stop_trace(profiler, logdir)` and the context manager `trace(logdir)`,
records spans beside a host and device torch.profiler trace and writes one
Chrome trace (`<logdir>/trace.json`, for Perfetto or chrome://tracing) with
the spans as complete events on their threads' tracks.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import json
import os
import threading
import time
from typing import Dict, List, Optional, Tuple

import torch

TRACE_FILE = 'trace.json'


@dataclasses.dataclass(frozen=True)
class Span:
    name: str
    start_ns: int           # perf_counter_ns
    end_ns: int             # perf_counter_ns; the stop anchor if still open
    thread: int             # threading.get_native_id()
    parent: int             # index of the enclosing span, -1 for none
    step: Optional[int]


@dataclasses.dataclass(frozen=True)
class Recording:
    spans: List[Span]
    counters: Dict[str, int]
    thread: int                     # the thread that started recording
    idents: Dict[int, int]          # native thread id -> threading ident
    start: Tuple[int, int]          # (time_ns, perf_counter_ns) anchors
    stop: Tuple[int, int]

    def unix_ns(self, perf_ns: int) -> int:
        """A perf_counter_ns reading on the Unix-epoch clock, by the line
        through the two anchors."""
        (w0, p0), (w1, p1) = self.start, self.stop
        if p1 <= p0:
            return w0 + perf_ns - p0
        return w0 + (perf_ns - p0) * (w1 - w0) // (p1 - p0)


class _Off:
    """The context `span` returns while recording is off."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return None


_OFF = _Off()


class _Thread:
    """One thread's part of a recording: only that thread writes it, so
    the hot path takes no lock."""

    def __init__(self):
        self.native = threading.get_native_id()
        self.ident = threading.get_ident()
        self.spans: list = []       # [name, start, end, parent, step]
        self.open: list = []        # indices of its open spans
        self.counters = collections.Counter()


class _Active:
    """What is recorded between start_recording() and take()."""

    def __init__(self):
        self.local = threading.local()
        self.threads: List[_Thread] = []
        self.step: Optional[int] = None
        self.starter = self.thread()
        self.start = (time.time_ns(), time.perf_counter_ns())

    def thread(self) -> _Thread:
        t = getattr(self.local, 'rec', None)
        if t is None:
            t = self.local.rec = _Thread()
            self.threads.append(t)
        return t


_active: Optional[_Active] = None


class _Span:
    __slots__ = ('rec', 'name', 'step', 'thread', 'index', 'outer_step')

    def __init__(self, rec: _Active, name: str, step: Optional[int]):
        self.rec, self.name, self.step = rec, name, step

    def __enter__(self):
        rec = self.rec
        t = self.thread = rec.thread()
        if self.step is not None:
            self.outer_step, rec.step = rec.step, self.step
        self.index = len(t.spans)
        t.spans.append([self.name, time.perf_counter_ns(), None,
                        t.open[-1] if t.open else -1, rec.step])
        t.open.append(self.index)
        return self

    def __exit__(self, *exc):
        self.thread.spans[self.index][2] = time.perf_counter_ns()
        self.thread.open.pop()
        if self.step is not None:
            self.rec.step = self.outer_step
        return None


def span(name: str, step: Optional[int] = None):
    """A span named `name` (a layer boundary, e.g. 'sample.step') around
    the `with` block; `step` marks a sampler or training step."""
    rec = _active
    if rec is None:
        return _OFF
    return _Span(rec, name, step)


def count(name: str, n: int = 1) -> None:
    """Add n to the counter `name` while recording is on."""
    rec = _active
    if rec is not None:
        rec.thread().counters[name] += n


def start_recording() -> None:
    global _active
    if _active is not None:
        raise RuntimeError('spans are already being recorded')
    _active = _Active()


def take() -> Recording:
    """Stop recording and return what was recorded, each thread's spans in
    the order they opened. A span still open ends at the stop anchor."""
    global _active
    rec, _active = _active, None
    if rec is None:
        raise RuntimeError('spans are not being recorded')
    stop = (time.time_ns(), time.perf_counter_ns())
    spans, counters = [], collections.Counter()
    for t in list(rec.threads):
        base = len(spans)
        spans += [Span(n, s, stop[1] if e is None else e, t.native,
                       p + base if p >= 0 else -1, st)
                  for n, s, e, p, st in list(t.spans)]
        counters.update(t.counters)
    return Recording(spans, dict(counters), rec.starter.native,
                     {t.native: t.ident for t in rec.threads}, rec.start,
                     stop)


def start_trace() -> torch.profiler.profile:
    """Start tracing the host and, when CUDA is available, the device, and
    recording spans."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    start_recording()
    return prof


def _chrome_events(recording: Recording, base_ns: int = 0) -> list:
    """The recording's spans as Chrome trace complete events ('X') on their
    threads' tracks, and its counters as counter events ('C') at the stop,
    in microseconds from base_ns on the Unix-epoch clock."""
    pid = os.getpid()

    def us(perf_ns):
        return (recording.unix_ns(perf_ns) - base_ns) / 1e3

    events = [{'ph': 'X', 'cat': 'span', 'name': s.name, 'pid': pid,
               'tid': s.thread, 'ts': us(s.start_ns),
               'dur': (s.end_ns - s.start_ns) / 1e3,
               'args': {'step': s.step, 'parent': s.parent}}
              for s in recording.spans]
    events += [{'ph': 'C', 'cat': 'span', 'name': name, 'pid': pid,
                'tid': recording.thread, 'ts': us(recording.stop[1]),
                'args': {'value': value}}
               for name, value in sorted(recording.counters.items())]
    return events


def stop_trace(prof: torch.profiler.profile, logdir: str) -> str:
    """Stop `prof` and the span recording and write one Chrome trace, the
    profiler's events and the spans, into logdir; returns the file's
    path."""
    prof.stop()
    recording = take()
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, TRACE_FILE)
    prof.export_chrome_trace(path)
    with open(path) as f:
        data = json.load(f)
    # kineto writes its timestamps in microseconds from baseTimeNanoseconds
    data['traceEvents'] += _chrome_events(
        recording, int(data.get('baseTimeNanoseconds', 0)))
    with open(path, 'w') as f:
        json.dump(data, f)
    return path


@contextlib.contextmanager
def trace(logdir: Optional[str]):
    """Capture a trace into logdir when it is set, else do nothing."""
    if not logdir:
        yield
        return
    prof = start_trace()
    try:
        yield
    finally:
        stop_trace(prof, logdir)
