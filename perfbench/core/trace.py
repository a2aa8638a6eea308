"""The traced window of a `--trace 1` run: torch.profiler over a fixed
number of the window's steps, read into a compact summary in memory (no
trace file is written). The device's busy time is the union of its
operations' intervals (a copy of scripts/profile_torch_sample.py's
union_us); the idle gaps are the holes in that union, each named by what
the host was doing at the gap's start.

Only the CUDA activity is traced: recording every host operator as well
slowed a guided sampling step from 90 to 650 ms on the card, which would
make the window's idle share the profiler's. The host side is then the
CUDA runtime calls CUPTI records (launches, copies, synchronisations); a
gap with no runtime call in flight is the host running Python before the
next launch, named by the operation launched next.
"""

from __future__ import annotations

import collections
import dataclasses


def union_us(intervals) -> float:
    total, end = 0.0, -float('inf')
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def short_name(name: str) -> str:
    """A kernel's name without its return type, namespaces, template
    arguments and parameters."""
    depth, out = 0, []
    for ch in name.replace('(anonymous namespace)::', ''):
        if ch in '<(':
            depth += 1
        elif ch in '>)':
            depth -= 1
        elif depth == 0:
            out.append(ch)
    return ''.join(out).replace('void ', '').strip()[:80]


def _is_annotation(e) -> bool:
    """A range the profiler mirrors onto the device timeline for a
    record_function: it spans kernels that are counted on their own."""
    return bool(getattr(e, 'is_user_annotation', False)) or \
        e.name.startswith(('Optimizer.', 'ProfilerStep'))


@dataclasses.dataclass
class TraceSummary:
    ops: list               # device operations: (name, start_us, end_us)
    host: list              # host operations: (name, start_us, end_us)
    window_us: float        # the traced window, host clock
    steps: int              # steps in the traced window

    @property
    def kernels(self) -> list:
        return [o for o in self.ops
                if not o[0].startswith(('Memcpy', 'Memset'))]

    @property
    def busy_us(self) -> float:
        return union_us((s, e) for _, s, e in self.ops)

    def matched(self, keys) -> list:
        return [o for o in self.kernels if any(k in o[0] for k in keys)]

    def top_ops(self, n=10) -> list:
        by = collections.defaultdict(float)
        for name, s, e in self.ops:
            by[name] += e - s
        top = sorted(by.items(), key=lambda kv: -kv[1])[:n]
        return [[name, us / 1e6] for name, us in top]

    def idle_gaps(self, n=10) -> list:
        """The n longest holes between device operations, each named by the
        host's CUDA runtime call in flight at its start, or else as the
        host busy before launching the operation that ends the gap."""
        spans, end = [], None
        for name, s, e in sorted(self.ops, key=lambda o: o[1]):
            if end is not None and s > end:
                spans.append((s - end, end, name))
            end = e if end is None else max(end, e)
        out = []
        for length, start, after in sorted(spans, reverse=True)[:n]:
            inner = [(e - s, name) for name, s, e in self.host
                     if s <= start < e]
            label = (f'host in {min(inner)[1]}' if inner
                     else f'host before {short_name(after)}')
            out.append([label, length / 1e6])
        return out


class Tracer:
    """Starts the profiler when the traced window opens and reads it when
    the window closes."""

    def __init__(self):
        import torch
        self._prof = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA])
        self.summary = None

    @staticmethod
    def initialise() -> None:
        """Start and stop an empty profile: a process's first profiler
        start initialises CUPTI (8.5 s on the card), which belongs in
        set-up, not in the traced window."""
        import torch
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]):
            pass

    def start(self) -> None:
        self._prof.__enter__()

    def stop(self, window_us: float, steps: int) -> TraceSummary:
        import torch
        self._prof.__exit__(None, None, None)
        ops, host = [], []
        for e in self._prof.events():
            if _is_annotation(e):
                continue
            rec = (e.name, e.time_range.start, e.time_range.end)
            if e.device_type == torch.autograd.DeviceType.CUDA:
                ops.append(rec)
            else:
                host.append(rec)
        self.summary = TraceSummary(ops, host, window_us, steps)
        self._prof = None
        return self.summary
