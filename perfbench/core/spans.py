"""The traced window put down to the program's spans
(decompdiff_tpu_torch/utils/profiling.py): each device operation to the
span that launched it, each idle gap to the span the host was in, and the
six per-layer numbers the spans give.

Both clocks are Unix-epoch nanoseconds: kineto's events natively, a span
through its recording's anchor pair. CUPTI names the thread of a CUDA
runtime record by the low 32 bits of its pthread id (threading.get_ident()),
which the recording maps to the native thread id its spans carry.

A device operation goes to the innermost span open on the thread that
launched it, at the launch's start; where no span is open on that thread
(the autograd engine's device thread runs a backward outside any span of
its own while the calling thread waits in torch.autograd.grad), to the
innermost span open at that time on the thread that started the recording.
An idle gap goes to the innermost span open on that thread at the gap's
start.

Not wired into the benchmark's traced window yet (core/trace.py and the
drivers hold no recording): perfbench/attribute.py runs a cell with it.
"""

from __future__ import annotations

import bisect
import collections
import ctypes
import dataclasses
from typing import Dict, List, Optional

from perfbench.core.trace import short_name

NONE = 'none'       # the name of the work no span holds


@dataclasses.dataclass
class Kineto:
    """The profiler's records of a traced window, in Unix-epoch ns."""
    ops: list           # device operations: (name, start, end, correlation)
    launches: dict      # correlation -> (runtime call, start, end, thread32)
    host: list          # runtime calls: (name, start, end)


def _is_annotation(e) -> bool:
    # the ranges core/trace.py leaves out
    return e.is_user_annotation() or e.name().startswith(
        ('Optimizer.', 'ProfilerStep'))


def read_kineto(prof) -> Kineto:
    """The device operations and CUDA runtime and driver calls of a
    finished torch.profiler.profile."""
    import torch
    ops, launches, host = [], {}, []
    for e in prof.profiler.kineto_results.events():
        if _is_annotation(e):
            continue
        rec = (e.name(), e.start_ns(), e.end_ns())
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            ops.append(rec + (e.correlation_id(),))
        elif e.name().startswith('cu'):
            host.append(rec)
            launches[e.correlation_id()] = rec + (e.device_resource_id(),)
    return Kineto(ops, launches, host)


def thread32(ident: int) -> int:
    """A pthread id as CUPTI's 32-bit thread field holds it."""
    return ctypes.c_int32(ident & 0xffffffff).value


class SpanIndex:
    """The recording's spans on the Unix-epoch clock, searchable by thread
    and time."""

    def __init__(self, recording):
        self.rec = recording
        self.spans = recording.spans
        self.start = [recording.unix_ns(s.start_ns) for s in self.spans]
        self.end = [recording.unix_ns(s.end_ns) for s in self.spans]
        by = collections.defaultdict(list)
        for i, s in enumerate(self.spans):
            by[s.thread].append((self.start[i], i))
        self.by_thread = {t: sorted(v) for t, v in by.items()}
        self.native = {thread32(ident): native
                       for native, ident in recording.idents.items()}

    def innermost(self, thread: Optional[int], t: int) -> int:
        """The innermost span open on `thread` at t, or -1. Spans of one
        thread nest, so it is the latest-opened span at or before t or the
        nearest of its parents still open at t."""
        row = self.by_thread.get(thread)
        if not row:
            return -1
        k = bisect.bisect_right(row, (t, len(self.spans))) - 1
        i = row[k][1] if k >= 0 else -1
        while i >= 0 and self.end[i] <= t:
            i = self.spans[i].parent
        return i

    def window(self, t: int) -> int:
        return self.innermost(self.rec.thread, t)

    def name(self, i: int) -> str:
        return self.spans[i].name if i >= 0 else NONE

    def under(self, i: int, name: str) -> bool:
        """Whether span i is `name` or lies inside it."""
        while i >= 0:
            if self.spans[i].name == name:
                return True
            i = self.spans[i].parent
        return False


def attribute(index: SpanIndex, kin: Kineto) -> List[int]:
    """The span of each device operation of kin.ops (-1: none, or no
    launch record)."""
    out = []
    for _, start, _, corr in kin.ops:
        launch = kin.launches.get(corr)
        if launch is None:
            out.append(-1)
            continue
        t = launch[1]
        i = index.innermost(index.native.get(launch[3]), t)
        out.append(i if i >= 0 else index.window(t))
    return out


def gaps(kin: Kineto) -> list:
    """Every hole between device operations: (length ns, start, the
    operation after it)."""
    out, end = [], None
    for name, s, e, _ in sorted(kin.ops, key=lambda o: o[1]):
        if end is not None and s > end:
            out.append((s - end, end, name))
        end = e if end is None else max(end, e)
    return out


def gap_label(index: SpanIndex, kin: Kineto, start: int, after: str) -> str:
    """core/trace.py's name of a gap, then ` @ ` and the span the window's
    thread was in at its start."""
    inner = [(e - s, name) for name, s, e in kin.host if s <= start < e]
    label = (f'host in {min(inner)[1]}' if inner
             else f'host before {short_name(after)}')
    return f'{label} @ {index.name(index.window(start))}'


@dataclasses.dataclass
class Attribution:
    index: SpanIndex
    kin: Kineto
    steps: int
    owner: List[int]        # the span of each device operation

    @classmethod
    def of(cls, recording, kin: Kineto, steps: int) -> 'Attribution':
        index = SpanIndex(recording)
        return cls(index, kin, steps, attribute(index, kin))

    def attributed_share(self, since: Optional[int] = None) -> float:
        """Device-operation time launched under some span, over all of it
        (with `since`, of the operations launched from then on)."""
        total = held = 0
        for (_, s, e, corr), i in zip(self.kin.ops, self.owner):
            launch = self.kin.launches.get(corr)
            if since is not None and (launch is None or launch[1] < since):
                continue
            total += e - s
            held += (e - s) if i >= 0 else 0
        return held / total if total else 0.0

    def device_ms_under(self, name: str) -> float:
        """Device ms a step of the operations launched under `name` (the
        span or one inside it). A window without the span is a fault."""
        self._require(name)
        ns = sum(e - s for (_, s, e, _), i in zip(self.kin.ops, self.owner)
                 if self.index.under(i, name))
        return ns / 1e6 / self.steps

    def host_ms_mean(self, name: str) -> float:
        """Host ms of one `name` span, the mean over the window's."""
        spans = self._require(name)
        return sum(self.index.end[i] - self.index.start[i]
                   for i in spans) / 1e6 / len(spans)

    def _require(self, name: str) -> list:
        spans = [i for i, s in enumerate(self.index.spans) if s.name == name]
        if not spans:
            raise RuntimeError(f'no {name!r} span in the traced window: the '
                               'program did not record it')
        return spans

    def by_span(self) -> Dict[str, dict]:
        """For each span name (and `none`): device ms, kernels and host ms
        a step, and the idle ms a step whose gap opened in it."""
        per = self.steps
        rows = collections.defaultdict(lambda: {
            'device_ms': 0.0, 'kernels': 0.0, 'host_ms': 0.0,
            'idle_ms': 0.0})
        for (name, s, e, _), i in zip(self.kin.ops, self.owner):
            row = rows[self.index.name(i)]
            row['device_ms'] += (e - s) / 1e6 / per
            if not name.startswith(('Memcpy', 'Memset')):
                row['kernels'] += 1 / per
        for i, s in enumerate(self.index.spans):
            rows[s.name]['host_ms'] += (
                self.index.end[i] - self.index.start[i]) / 1e6 / per
        for length, start, _ in gaps(self.kin):
            rows[self.index.name(self.index.window(start))]['idle_ms'] += (
                length / 1e6 / per)
        return dict(rows)

    def idle_gaps(self, n: int = 10) -> list:
        """The n longest gaps, labelled as core/trace.py labels them, with
        the span at their start: [label, seconds]."""
        top = sorted(gaps(self.kin), reverse=True)[:n]
        return [[gap_label(self.index, self.kin, start, after), length / 1e9]
                for length, start, after in top]


def loader_empty_pct(counters: dict) -> float:
    """Gets that found the loader's queue empty over all gets, percent."""
    gets = counters.get('loader.gets')
    if not gets:
        raise RuntimeError('no loader.gets counted in the traced window')
    return 100.0 * counters.get('loader.empty_gets', 0) / gets


def metrics(att: Attribution, counters: dict, kind: str) -> dict:
    """The six per-layer numbers of a traced window of `kind`."""
    if kind == 'sample':
        return {'guidance_ms.sample': att.device_ms_under('sample.guidance'),
                'posterior_ms.sample':
                    att.device_ms_under('sample.posterior')}
    return {'optimizer_ms.train': att.device_ms_under('train.optimizer'),
            'step_host_ms.train': att.host_ms_mean('train.step'),
            'collate_ms.train': att.host_ms_mean('loader.collate'),
            'loader_empty_pct.train': loader_empty_pct(counters)}
