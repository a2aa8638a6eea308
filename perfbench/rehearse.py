#!/usr/bin/env python3
"""Rehearse a cell on the CPU at a tiny size, through the port's CPU path
(each kernel wrapper runs its plain version), to find wrong paths, shapes
and control flow before a run on the card. Not a measurement: the line it
prints says platform cpu, and its times are the CPU's.

    python3 perfbench/rehearse.py --workload <cell> [--seed 1] [--seconds 10]

The real widths stay in the configuration files; this shrinks them (and
the traffic) here only. Only --trace 0: a traced run reads the card's
profile.
"""

from __future__ import annotations

import argparse
import copy
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from perfbench.core import guard, spec  # noqa: E402

TINY_MODEL = {'hidden_dim': 32, 'n_heads': 4, 'num_layers': 1, 'knn': 8}
TINY_TRAFFIC = {'batch': 4, 'complexes': 24, 'reference_block': 2,
                'loader_threads': 2,
                'sizes': {'receptor_atoms': [200, 240],
                          'pocket_atoms': [40, 48], 'ligand_atoms': [10, 12],
                          'arms': [2, 3]}}


def tiny(cell):
    cell = copy.deepcopy(cell)
    cell.config['model'].update(TINY_MODEL)
    cell.traffic.update(TINY_TRAFFIC)
    return cell


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seed', type=int, default=1)
    ap.add_argument('--seconds', type=float, default=10.0)
    args = ap.parse_args(argv)
    import torch
    from perfbench.core.runner import emit
    from perfbench.run import measure
    cell = tiny(spec.load_cell(args.workload))
    result, numbers = measure(cell, args.seed, args.seconds, 0,
                              torch.device('cpu'), time.time())[:2]
    guard.require_no_jax('after the window')
    emit(result.line(numbers))
    return 0


if __name__ == '__main__':
    sys.exit(main())
