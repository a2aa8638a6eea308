"""What the per-layer metric readers (metrics/<name>.py) share: the traced
window's summary and the counts of its steps, and the arithmetic that turns
them into a metric. A reader returns None where its cell has nothing for it
to read, and the harness then leaves the metric out of the line.
"""

from __future__ import annotations

import dataclasses
import sys
from typing import Optional

from perfbench.core.trace import TraceSummary, short_name
from perfbench.counts import work


@dataclasses.dataclass
class ReadContext:
    kind: str                         # 'sample' or 'train'
    trace: TraceSummary
    shapes: list                      # work.Shapes of each traced step
    denoiser_ms: list = dataclasses.field(default_factory=list)
    loader_wait_s: list = dataclasses.field(default_factory=list)
    peak_mem_bytes: Optional[int] = None


def kernels_per_step(ctx: ReadContext, kind: str):
    if ctx.kind != kind:
        return None
    return len(ctx.trace.kernels) / ctx.trace.steps


def attn_roofline_pct(ctx: ReadContext, kind: str, keys) -> Optional[float]:
    """Sum over the traced steps' attention calls of their least time
    (counts/work.py), over the device time of the kernels whose names hold
    one of `keys`, in percent. A traced window in which no kernel matches
    is a fault of the run, not a 0."""
    if ctx.kind != kind:
        return None
    matched = ctx.trace.matched(keys)
    if not matched:
        raise RuntimeError(f'no device kernel in the traced window matches '
                           f'{keys}: the attention kernels did not run')
    names = sorted({short_name(n) for n, _, _ in matched})
    print(f'perfbench: attention kernels matched ({kind}): {names}',
          file=sys.stderr)
    least = 0.0
    for s in ctx.shapes:
        calls = work.forward_calls(s)
        if kind == 'train':
            calls = calls + work.backward_calls(s)
        least += sum(work.least_seconds(f, b) for _, f, b in calls)
    device_s = sum(e - s for _, s, e in matched) / 1e6
    return 100.0 * least / device_s


def mfu_pct(ctx: ReadContext, kind: str) -> Optional[float]:
    """Model FLOPs of the traced steps (a training step counts three
    forwards) over the traced window at the peak rate, in percent."""
    if ctx.kind != kind:
        return None
    per_call = 3.0 if kind == 'train' else 1.0
    flops = per_call * sum(work.model_flops(s) for s in ctx.shapes)
    return 100.0 * flops / (ctx.trace.window_us / 1e6
                            * work.PEAKS['flops_per_s'])


def idle_pct(ctx: ReadContext, kind: str) -> Optional[float]:
    if ctx.kind != kind:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_us / ctx.trace.window_us)


def peak_mem_gib(ctx: ReadContext, kind: str) -> Optional[float]:
    if ctx.kind != kind or ctx.peak_mem_bytes is None:
        return None
    return ctx.peak_mem_bytes / 2 ** 30


def mean_ms(values, scale=1.0) -> Optional[float]:
    if not values:
        return None
    return scale * sum(values) / len(values)
