"""One run of one cell: the window's bookkeeping, the per-layer readers,
the correctness judgement and the result line.

The result line is the last line of standard output, one JSON object:
correct, attempted, failed, metrics, device, (traced runs) breakdown, and
last, under `checks`, each compared number beside its limit; the same
numbers are the last lines of standard error.
"""

from __future__ import annotations

import gc
import json
import os
import subprocess
import sys
import time

import torch

from perfbench.core import spec
from perfbench.core.readers import ReadContext
from perfbench.reference.compare import judge


CARD_FIELDS = ('name', 'clocks.sm', 'clocks.max.sm', 'clocks.mem',
               'power.draw', 'power.limit', 'temperature.gpu',
               'clocks_throttle_reasons.active')


def process_start_time() -> float:
    """The wall-clock time this process started (from /proc), or now where
    /proc is not there."""
    try:
        with open('/proc/self/stat') as f:
            fields = f.read().rsplit(')', 1)[1].split()
        start_ticks = int(fields[19])
        with open('/proc/stat') as f:
            btime = next(int(line.split()[1]) for line in f
                         if line.startswith('btime'))
        return btime + start_ticks / os.sysconf('SC_CLK_TCK')
    except (OSError, ValueError, IndexError, StopIteration):
        return time.time()


class RunResult:
    def __init__(self, cell, seed, seconds, trace, device, started_at):
        self.cell, self.seed, self.seconds = cell, seed, seconds
        self.trace, self.device = trace, device
        self.started_at = started_at            # wall clock
        self.cuda = device.type == 'cuda'
        tr = cell.traffic
        self.warmup = tr['warmup_steps']
        self.trace_steps = tr['trace_steps']
        self.e2e, self.layers, self.dev = {}, {}, {}
        self.breakdown = None
        self.setup_s = None
        self.attempted = 0
        self.count = 1                          # cards the run uses
        self.notes = {}                         # printed on stderr

    def sync(self):
        if self.cuda:
            torch.cuda.synchronize(self.device)

    def read_card(self, when: str):
        """Note the card's clocks, power and temperature (nvidia-smi, read
        only) and the host's load, outside the window: a run that reads
        slow says whether the card or the host was the cause."""
        note = {'loadavg': os.getloadavg(),
                'cpus': len(os.sched_getaffinity(0))}
        if self.cuda:
            try:
                q = subprocess.run(
                    ['nvidia-smi', '--query-gpu=' + ','.join(CARD_FIELDS),
                     '--format=csv,noheader,nounits'],
                    capture_output=True, text=True, timeout=20)
                note['card'] = q.stdout.strip() or q.stderr.strip()
            except (OSError, subprocess.SubprocessError) as e:
                note['card'] = repr(e)
        self.notes[f'at_{when}'] = note

    def mark_open(self):
        self.setup_s = time.time() - self.started_at
        if self.cuda:
            torch.cuda.reset_peak_memory_stats(self.device)

    def window(self, t_open, t_close, n_steps, work_per_step):
        self.read_card('close')
        self.window_s = t_close - t_open
        self.n_steps = n_steps
        self.notes.update(window_s=self.window_s, steps=n_steps,
                          setup_s=self.setup_s)
        self.attempted = int(n_steps * work_per_step)
        self.window_peak = (torch.cuda.max_memory_allocated(self.device)
                            if self.cuda else None)

    def read_layers(self, kind, trace, shapes, **series):
        ctx = ReadContext(kind=kind, trace=trace, shapes=shapes,
                          peak_mem_bytes=self.window_peak, **series)
        for m in self.cell.per_layer:
            value = spec.metric_reader(m['name'], self.cell.root)(ctx)
            if value is not None:
                self.layers[m['name']] = (value, m['unit'])
        self.dev['busy_s'] = trace.busy_us / 1e6
        self.dev['window_s'] = trace.window_us / 1e6
        self.breakdown = {'device_ops': trace.top_ops(),
                          'idle_gaps': trace.idle_gaps()}

    def release(self):
        """Read the run's memory peak, then free what the program held."""
        if self.cuda:
            self.dev['memory_peak_bytes'] = int(
                torch.cuda.max_memory_reserved(self.device))
        gc.collect()
        if self.cuda:
            torch.cuda.empty_cache()

    def line(self, numbers: dict) -> dict:
        correct, rows = judge(numbers, self.cell.limits)
        metrics = {}
        entries = (self.cell.per_layer if self.trace
                   else self.cell.end_to_end)
        values = dict(self.layers) if self.trace else {
            k: (v, None) for k, v in self.e2e.items()}
        if not self.trace:
            values['setup_s'] = (self.setup_s, None)
        for m in entries:
            if m['name'] in values:
                metrics[m['name']] = {'value': float(values[m['name']][0]),
                                      'unit': m['unit']}
        device = {'platform': 'gpu' if self.cuda else 'cpu',
                  'kind': (torch.cuda.get_device_name(self.device)
                           if self.cuda else 'cpu'),
                  'count': self.count,
                  'memory_peak_bytes': self.dev.get('memory_peak_bytes', 0)}
        if self.trace:
            device.update(busy_s=self.dev['busy_s'],
                          window_s=self.dev['window_s'])
        out = {'correct': bool(correct), 'attempted': self.attempted,
               'failed': 0 if correct else self.attempted,
               'metrics': metrics, 'device': device}
        if self.breakdown is not None:
            out['breakdown'] = self.breakdown
        out['checks'] = {name: {'value': value, 'limit': limit}
                         for name, value, limit in rows}
        print(f'perfbench: {json.dumps(self.notes)}', file=sys.stderr)
        for name, value, limit in rows:
            print(f'check {name} {value} limit {limit}', file=sys.stderr)
        return out


def emit(line: dict) -> None:
    sys.stdout.flush()
    print(json.dumps(line), flush=True)
