#!/usr/bin/env python3
"""Run one cell of the benchmark once, on one NVIDIA GPU.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The cell is a `workloads` entry of BENCHMARK.json. The run makes its
inputs and weights from --seed, warms up the shapes it uses (set-up),
measures for --seconds (with --trace 1: a traced window of the traffic
file's trace_steps steps, for the per-layer metrics), then checks what the
timed path produced against the plain reference and prints one JSON line.
It exits non-zero, with no result, without a CUDA device, outside a
checkout of the repository, or when JAX or the JAX package is loaded.
"""

from __future__ import annotations

import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# every build and kernel cache inside the checkout, at fixed paths
for var, sub in (('TRITON_CACHE_DIR', 'triton'),
                 ('TORCH_EXTENSIONS_DIR', 'torch_extensions'),
                 ('PYTORCH_KERNEL_CACHE_PATH', 'torch_kernels')):
    os.environ[var] = str(ROOT / 'build' / 'perfbench' / sub)
if __name__ == '__main__':
    # one thread in each math library's own pool (torch's intra-op pool,
    # OpenMP, BLAS): the host's cores go to the dispatching thread and the
    # loader's workers, and no idle pool spins beside them
    for var in ('OMP_NUM_THREADS', 'MKL_NUM_THREADS', 'OPENBLAS_NUM_THREADS'):
        os.environ[var] = '1'
sys.path.insert(0, str(ROOT))

from perfbench.core.runner import process_start_time  # noqa: E402

STARTED_AT = process_start_time()

import argparse  # noqa: E402
import time  # noqa: E402

from perfbench.core import guard, spec  # noqa: E402


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seed', type=int, required=True)
    ap.add_argument('--seconds', type=float, required=True)
    ap.add_argument('--trace', type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def measure(cell, seed, seconds, trace, device, started_at):
    """One run of `cell` on `device`, judged: (RunResult, the compared
    numbers, the driver module, its evidence, the reference's outputs)."""
    import torch
    from perfbench.core.runner import RunResult
    from decompdiff_tpu_torch.device import set_matmul_precision

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    set_matmul_precision()
    if device.type == 'cuda' and cell.model.get('use_pallas', False):
        from decompdiff_tpu_torch.ops import _build
        _build.build()
    result = RunResult(cell, seed, seconds, bool(trace), device, started_at)
    driver = spec.driver(cell.traffic['kind'], cell.root)
    evidence = driver.run(cell, seed, seconds, bool(trace), device, result)
    t_ref = time.perf_counter()
    ref = driver.reference(evidence)
    numbers = driver.numbers(evidence, evidence.program, ref)
    result.notes['reference_s'] = time.perf_counter() - t_ref
    return result, numbers, driver, evidence, ref


def main(argv=None) -> int:
    args = parse(argv)
    cell = spec.load_cell(args.workload)
    guard.require_cuda(cell.workload['chips'])
    import torch
    guard.require_no_jax('at start-up')
    result, numbers = measure(cell, args.seed, args.seconds, args.trace,
                              torch.device('cuda', 0), STARTED_AT)[:2]
    guard.require_no_jax('after the window')
    from perfbench.core.runner import emit
    emit(result.line(numbers))
    return 0


if __name__ == '__main__':
    sys.exit(main())
