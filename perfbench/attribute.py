#!/usr/bin/env python3
"""A cell's traced window with the program's spans recorded
(decompdiff_tpu_torch/utils/profiling.py), put down to them by
core/spans.py: device ms, kernels, host ms and idle ms a step by span, the
idle gaps labelled with the span the host was in, the share of device time
launched under some span, and the six per-layer numbers of the spans. One
process, the kernels built once; `--record 1 0` adds, for each seed, the
same traced run with recording off (in turns: on, off, then off, on), for
the recording's cost.

    python3 perfbench/attribute.py --workload <cell> --seeds 1 2 \
        [--record 1 [0]] [--out attribution.json]

The benchmark's own runs never run this: its traced window (core/trace.py,
the drivers) records no spans yet, so this puts a recording beside the
window's profiler by handing the drivers a Tracer that also records.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from perfbench.core import guard, spec, trace  # noqa: E402
from perfbench.core import spans as attribution  # noqa: E402
from perfbench.reference.compare import judge  # noqa: E402


_PLAIN = trace.Tracer


class SpanTracer(trace.Tracer):
    """The window's profiler, and the program's recording beside it."""

    last = None

    def start(self) -> None:
        from decompdiff_tpu_torch.utils import profiling
        super().start()
        profiling.start_recording()

    def stop(self, window_us: float, steps: int):
        from decompdiff_tpu_torch.utils import profiling
        self.recording = profiling.take()
        prof = self._prof
        summary = super().stop(window_us, steps)
        self.kineto = attribution.read_kineto(prof)
        SpanTracer.last = self
        return summary


def attribute_run(cell, seed, record, device) -> dict:
    from perfbench.run import measure
    SpanTracer.last = None
    trace.Tracer = SpanTracer if record else _PLAIN
    try:
        t0 = time.time()
        result, numbers = measure(cell, seed, 1.0, 1, device, t0)[:2]
    finally:
        trace.Tracer = _PLAIN
    correct = judge(numbers, cell.limits)[0]
    n = result.n_steps
    row = {'seed': seed, 'record': bool(record), 'correct': bool(correct),
           'card': result.notes.get('at_open', {}).get('card'),
           'steps': n, 'window_ms_a_step': 1e3 * result.window_s / n,
           'layers': {k: v for k, (v, _) in result.layers.items()},
           'idle_gaps': result.breakdown['idle_gaps']}
    if record:
        tr = SpanTracer.last
        att = attribution.Attribution.of(tr.recording, tr.kineto, n)
        kind = cell.traffic['kind']
        first = min(att.index.start[i] for i, s in
                    enumerate(att.index.spans) if s.name.endswith('.step'))
        row.update(attributed_share=att.attributed_share(),
                   attributed_share_from_first_step=att.attributed_share(
                       since=first),
                   by_span=att.by_span(), idle_gaps=att.idle_gaps(),
                   counters=tr.recording.counters,
                   metrics=attribution.metrics(att, tr.recording.counters,
                                               kind))
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seeds', type=int, nargs='+', required=True)
    ap.add_argument('--record', type=int, nargs='+', choices=(0, 1),
                    default=[1])
    ap.add_argument('--out')
    args = ap.parse_args(argv)
    cell = spec.load_cell(args.workload)
    guard.require_cuda(cell.workload['chips'])
    import torch
    rows = [attribute_run(cell, seed, record, torch.device('cuda', 0))
            for k, seed in enumerate(args.seeds)
            for record in (args.record if k % 2 == 0 else args.record[::-1])]
    guard.require_no_jax('after the windows')
    out = {'workload': args.workload,
           'card': torch.cuda.get_device_name(0), 'rows': rows}
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))
    print(json.dumps(out))
    return 0


if __name__ == '__main__':
    sys.exit(main())
