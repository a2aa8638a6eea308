#!/usr/bin/env python3
"""Where the time of a guided sampling step of the PyTorch port goes, on
one NVIDIA GPU.

    python3 scripts/profile_torch_sample.py [--steps 3] [--trace PATH]

Runs the bench shapes (B=8, Np=320, Nl=32, a full protein of Nf=2048, the
released uni_o2_bond config with random weights, kernels on, armsca_prox +
clash guidance at every step), warms up, then traces `--steps` truncate
steps with torch.profiler. Prints the wall time per step, the device busy
share (the union of kernel intervals over the traced window) and the device
time per step by kernel group; with --trace it writes the Chrome trace to
PATH. Needs torch and numpy only, and a CUDA device.
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

from decompdiff_tpu_torch.data.batch import FullProtein  # noqa: E402
from decompdiff_tpu_torch.models.diffusion_model import (  # noqa: E402
    DecompDiffModel)
from decompdiff_tpu_torch.ops import _build  # noqa: E402
from decompdiff_tpu_torch.sampling.sampler import (  # noqa: E402
    SampleConfig, sample_diffusion)
from decompdiff_tpu_torch.utils.testing import (  # noqa: E402
    DEFAULT_MODEL_CONFIG, random_complex_batch)

B, NUM_PROTEIN, NUM_LIGAND, NUM_FULL, NUM_GROUPS = 8, 320, 32, 2048, 6
GROUPS = (  # (group, substrings of the kernel name), first match wins
    ('edge_attention', ('edge_attention_kernel',)),
    ('bond_attention', ('bond_attention_kernel',)),
    ('triplet_attention', ('triplet_attention_kernel',)),
    ('matmul', ('gemm', 'gemv', 'cutlass', 'splitK', 'dot_kernel')),
    ('top-k / sort', ('topk', 'sort', 'Sort', 'bitonic', 'radix')),
    ('layer norm / softmax', ('layer_norm', 'LayerNorm', 'softmax',
                              'Softmax')),
    ('reduction', ('reduce', 'Reduce')),
    ('copy / cat / gather', ('copy', 'Copy', 'cat', 'Cat', 'gather',
                             'index', 'scatter')),
    ('elementwise', ('elementwise', 'vectorized', 'unrolled')),
)


def group_of(name: str) -> str:
    for group, keys in GROUPS:
        if any(k in name for k in keys):
            return group
    return 'other'


def union_us(intervals) -> float:
    total, end = 0.0, -float('inf')
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--steps', type=int, default=3)
    ap.add_argument('--trace', help='write the Chrome trace here')
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print('profile_torch_sample: no CUDA device', file=sys.stderr)
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
    rng = np.random.default_rng(0)
    batch = random_complex_batch(rng, batch_size=B, num_protein=NUM_PROTEIN,
                                 num_ligand=NUM_LIGAND, num_groups=NUM_GROUPS,
                                 device=dev)
    full = FullProtein(
        torch.as_tensor(rng.normal(size=(B, NUM_FULL, 3)) * 8,
                        dtype=torch.float32, device=dev),
        torch.ones((B, NUM_FULL), dtype=torch.bool, device=dev))
    model = DecompDiffModel.create(dict(DEFAULT_MODEL_CONFIG, use_pallas=True),
                                   8, device=dev, seed=0)
    g = torch.Generator(device=dev).manual_seed(1)
    state = (batch.ligand_pos, batch.ligand_v, batch.bond_type)
    cfg = SampleConfig(
        num_steps=args.steps, save_traj=False,
        energy_drift=({'type': 'armsca_prox', 'min_d': 1.2, 'max_d': 1.9},
                      {'type': 'clash', 'sigma': 2.0, 'gamma': 4.0}))

    sample_diffusion(model, cfg, batch, *state, full, generator=g)  # warm-up
    torch.cuda.synchronize()
    activities = [torch.profiler.ProfilerActivity.CPU,
                  torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        sample_diffusion(model, cfg, batch, *state, full, generator=g)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6

    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        print('profile_torch_sample: the trace holds no device events',
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
    print(f'{steps} guided steps at B={B} Np={NUM_PROTEIN} Nl={NUM_LIGAND} '
          f'Nf={NUM_FULL}: wall {wall_us / steps / 1e3:.3f} ms/step, device '
          f'busy {busy_us / steps / 1e3:.3f} ms/step '
          f'({100 * busy_us / wall_us:.1f}% of the window), '
          f'{len(kernels) / steps:.0f} kernel launches/step')
    print('device time per step by group (ms, launches, share of busy):')
    for group, (us, n) in sorted(by_group.items(), key=lambda kv: -kv[1][0]):
        print(f'  {group:22s} {us / steps / 1e3:9.3f} {n // steps:6d} '
              f'{100 * us / busy_us:6.1f}%')
    print('top kernels per step (ms, launches):')
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    for name, (us, n) in top:
        print(f'  {us / steps / 1e3:9.3f} {n // steps:6d}  {name[:100]}')
    if args.trace:
        Path(args.trace).parent.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(args.trace)
    return 0


if __name__ == '__main__':
    sys.exit(main())
