#!/usr/bin/env python3
"""Where the time of a training step of the PyTorch port goes, on one
NVIDIA GPU (the port's twin of benchmarks/profile_train_step.py).

    python3 scripts/profile_torch_train.py [--steps 3] [--trace PATH]
        [--model uni_o2_bond|uni_o2]

Runs the training bench shapes (B=8, Np=320, Nl=32, the released
uni_o2_bond config, or with --model uni_o2 the released-width uni_o2
config with the m-gate, with random weights, kernels on, the released training
hyperparameters: jitter, symmetric t, loss, clip and Adam), warms up with one
step, then traces `--steps` steps with torch.profiler. Prints the wall time
per step, the device busy share (the union of kernel intervals over the
traced window) and the device time per step by kernel group; with --trace it
writes the Chrome trace to PATH. Needs torch and numpy only, and a CUDA
device.
"""

from __future__ import annotations

import argparse
import collections
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
sys.path.insert(0, str(Path(__file__).resolve().parent))

from decompdiff_tpu_torch.models.diffusion_model import (  # noqa: E402
    DecompDiffModel)
from decompdiff_tpu_torch.ops import _build  # noqa: E402
from decompdiff_tpu_torch.training.train_step import (  # noqa: E402
    DEFAULT_TRAIN_CONFIG, create_train_state, make_train_fns)
from decompdiff_tpu_torch.utils.testing import (  # noqa: E402
    random_complex_batch)
from profile_torch_sample import (  # noqa: E402
    GROUPS, MODELS, is_annotation, union_us)

B, NUM_PROTEIN, NUM_LIGAND, NUM_GROUPS = 8, 320, 32, 6
TRAIN_GROUPS = (
    ('edge_attention backward', ('edge_attention_bwd_kernel',
                                 'edge_attention_bwd_head_kernel')),
    ('bond_attention backward', ('bond_attention_bwd_kernel',
                                 'bond_attention_bwd_head_kernel',
                                 'bond_attention_bwd_gemm_kernel')),
    ('triplet_attention backward', ('triplet_attention_bwd_kernel',
                                    'triplet_attention_bwd_head_kernel')),
    ('backward slot sums', ('reduce_slots',)),
    ('optimizer (Adam, clip)', ('multi_tensor', 'foreach', 'adam', 'Adam')),
) + GROUPS


def group_of(name: str) -> str:
    for group, keys in TRAIN_GROUPS:
        if any(k in name for k in keys):
            return group
    return 'other'


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--steps', type=int, default=3)
    ap.add_argument('--trace', help='write the Chrome trace here')
    ap.add_argument('--model', choices=sorted(MODELS), default='uni_o2_bond')
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print('profile_torch_train: no CUDA device', file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0] if smi.stdout.strip()
          else torch.cuda.get_device_name(0), flush=True)
    _build.build()

    dev = torch.device('cuda')
    batch = random_complex_batch(np.random.default_rng(0), batch_size=B,
                                 num_protein=NUM_PROTEIN,
                                 num_ligand=NUM_LIGAND, num_groups=NUM_GROUPS,
                                 device=dev)
    model = DecompDiffModel.create(dict(MODELS[args.model], use_pallas=True),
                                   8, device=dev, seed=0)
    state = create_train_state(model, DEFAULT_TRAIN_CONFIG)
    step = make_train_fns(model, DEFAULT_TRAIN_CONFIG)[0]
    g = torch.Generator(device=dev).manual_seed(1)

    step(state, batch, g)                                   # warm-up
    torch.cuda.synchronize()
    activities = [torch.profiler.ProfilerActivity.CPU,
                  torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            step(state, batch, g)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6

    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not is_annotation(e)]
    if not kernels:
        print('profile_torch_train: the trace holds no device events',
              file=sys.stderr)
        return 1
    busy_us = union_us((e.time_range.start, e.time_range.end)
                       for e in kernels)
    by_group = collections.defaultdict(lambda: [0.0, 0])
    by_name = collections.defaultdict(lambda: [0.0, 0])
    for e in kernels:
        d = e.time_range.end - e.time_range.start
        by_group[group_of(e.name)][0] += d
        by_group[group_of(e.name)][1] += 1
        by_name[e.name][0] += d
        by_name[e.name][1] += 1
    steps = args.steps
    print(f'{args.model}: {steps} training steps at B={B} Np={NUM_PROTEIN} '
          f'Nl={NUM_LIGAND}: wall {wall_us / steps / 1e3:.3f} ms/step, device '
          f'busy {busy_us / steps / 1e3:.3f} ms/step '
          f'({100 * busy_us / wall_us:.1f}% of the window), '
          f'{len(kernels) / steps:.0f} kernel launches/step')
    print('device time per step by group (ms, launches, share of busy):')
    for group, (us, n) in sorted(by_group.items(), key=lambda kv: -kv[1][0]):
        print(f'  {group:28s} {us / steps / 1e3:9.3f} {n // steps:6d} '
              f'{100 * us / busy_us:6.1f}%')
    print('top kernels per step (ms, launches):')
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:14]
    for name, (us, n) in top:
        print(f'  {us / steps / 1e3:9.3f} {n // steps:6d}  {name[:100]}')
    if args.trace:
        Path(args.trace).parent.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(args.trace)
    return 0


if __name__ == '__main__':
    sys.exit(main())
