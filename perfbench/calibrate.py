#!/usr/bin/env python3
"""The readings a cell's correctness limits are set from, on the card at the
cell's own size, judged against the cell's limits: for each seed, one run
of the program (what the timed path produced, against the reference), the
control (the reference computed in TF32, the nearest precision below the
configuration's float32 with TF32 off, in the program's place) and the
fault of half the batch left out (planted in the reference in the
program's place). One process, the kernels built once.

    python3 perfbench/calibrate.py --workload <cell> --seeds 1 2 3 \
        [--seconds 51] [--out readings.json]

It exits 1 where the program fails a limit or the control or the fault
passes every one. The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from perfbench.core import guard, spec  # noqa: E402
from perfbench.reference.compare import judge  # noqa: E402


def readings(cell, seeds, seconds, device):
    """A row a seed: each reading's numbers, and whether it passes the
    cell's limits."""
    from perfbench.run import measure
    out = []
    for seed in seeds:
        t0 = time.time()
        result, numbers, driver, ev, ref = measure(cell, seed, seconds, 0,
                                                   device, t0)
        row = {'seed': seed, 'program': numbers}
        for name, kw in (('control', {'tf32': True}),
                         ('half_batch', {'half': True})):
            row[name] = driver.numbers(ev, driver.reference(ev, **kw), ref)
        row['passes'] = {k: judge(row[k], cell.limits)[0]
                         for k in ('program', 'control', 'half_batch')}
        row.update(e2e=result.e2e, notes=result.notes,
                   seconds=time.time() - t0)
        print(json.dumps(row, default=str), flush=True)
        del ev, ref
        out.append(row)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seeds', type=int, nargs='+', required=True)
    ap.add_argument('--seconds', type=float, default=51.0)
    ap.add_argument('--out')
    args = ap.parse_args(argv)
    cell = spec.load_cell(args.workload)
    guard.require_cuda(cell.workload['chips'])
    import torch
    rows = readings(cell, args.seeds, args.seconds, torch.device('cuda', 0))
    guard.require_no_jax('after the runs')
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(rows, indent=1, default=str))
    bad = [(r['seed'], k) for r in rows for k, ok in r['passes'].items()
           if ok != (k == 'program')]
    for seed, k in bad:
        print(f'calibrate: seed {seed}: the {k} reading '
              f'{"fails" if k == "program" else "passes"} the limits',
              file=sys.stderr)
    return 1 if bad else 0


if __name__ == '__main__':
    sys.exit(main())
