#!/usr/bin/env python3
"""Where the bond-attention backward's head route spends its cycles.

    python3 scripts/profile_torch_bond_bwd.py     # on a machine with a GPU

Copies decompdiff_tpu_torch into build/profile_bond_bwd (git-ignored) and
defines BOND_BWD_PHASE at the top of the copy's csrc/bond_attention.cu: at
each phase mark of bond_attention_bwd_head_kernel (launch A) and
bond_attention_bwd_gemm_kernel (launch B), a block barrier, then thread 0 of
the block adds the cycles since its last mark to the phase's counter (the
marks stand where every thread arrives, so a phase's count is the block's
time in it). Builds the copy, runs one backward per mode at the released
training shapes (B=8, Nl=32, a bond between every two distinct atoms,
H=128, 16 heads; seeded random inputs) and prints each phase's share of
its launch's cycles, summed over the blocks. The repository's own sources
are not changed. The barriers of the marks cost a few percent of the
kernels' time.
"""

from __future__ import annotations

import ctypes
import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
COPY = REPO / 'build' / 'profile_bond_bwd'
# (phase, launch) in the order of the marks' numbers
PHASES = [
    ('start: zero d Wo, stage Wo_v^T (pos)', 'A'),
    ('row start: live test, q and g', 'A'),
    ('Qk, Gv (Wo through L2)', 'A'),
    ('chunk: VL, rel . g, h_bond rows in', 'A'),
    ('first linears of both branches (tensor cores)', 'A'),
    ('pass A: LayerNorm, relu', 'A'),
    ('logits, d alpha / v (tensor cores)', 'A'),
    ('softmax and its backward (pos: d rel)', 'A'),
    ('pass B: LayerNorm again (Nl > 32 only)', 'A'),
    ('pass B: Yd, Ya sums', 'A'),
    ('pass B: d y, relu and LayerNorm backward', 'A'),
    ('pass B: d t_row, d pre out, d t_src / d x atomics', 'A'),
    ('row end: d bo, d Wo update, d q (Wo_k through L2)', 'A'),
    ('end: slot writes', 'A'),
    ('h_bond and d pre rows in', 'B'),
    ('d h_bond (tensor cores)', 'B'),
    ('d We sums (tensor cores)', 'B'),
    ('d We into the slot', 'B'),
]
NP = len(PHASES)

COUNTERS = f'''__device__ unsigned long long g_prof[{NP}];
__device__ long long g_last[1024];
#define BOND_BWD_PHASE(n) do {{ __syncthreads(); if (threadIdx.x == 0) {{ \\
  const long long t_ = clock64(); \\
  if ((n) >= 0) atomicAdd(&g_prof[(n) < 0 ? 0 : (n)], \\
                          (unsigned long long)(t_ - g_last[blockIdx.x])); \\
  g_last[blockIdx.x] = t_; }} }} while (0)
'''
READER = f'''
extern "C" int prof_read(unsigned long long* out) {{
  cudaError_t e = cudaMemcpyFromSymbol(out, g_prof, sizeof(g_prof));
  unsigned long long z[{NP}] = {{}};
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(g_prof, z, sizeof(z));
  return (int)e;
}}
'''


def prepare(copy: Path) -> None:
    """copy <- the package, its bond kernels counting their phases."""
    shutil.rmtree(copy, ignore_errors=True)
    shutil.copytree(REPO / 'decompdiff_tpu_torch',
                    copy / 'decompdiff_tpu_torch')
    cu = copy / 'decompdiff_tpu_torch' / 'csrc' / 'bond_attention.cu'
    src = cu.read_text()
    if src.count('BOND_BWD_PHASE(') < NP:
        raise SystemExit('profile: the kernel lost its phase marks')
    cu.write_text('#include <cuda_runtime.h>\n' + COUNTERS + src + READER)


def main(copy: Path = COPY) -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print('profile: needs a CUDA device', file=sys.stderr)
        return 1
    prepare(copy)
    sys.path.insert(0, str(copy))
    from decompdiff_tpu_torch.ops import _build
    from decompdiff_tpu_torch.ops import bond_attention as bond_ops
    from decompdiff_tpu_torch.ops.common import Branch
    _build.BUILD_DIR = copy / 'lib'
    _build.build(['bond_attention'])
    lib = ctypes.CDLL(str(_build.library_path('bond_attention')))

    dev = torch.device('cuda')
    rng = np.random.default_rng(0)
    B, Nl, H, heads = 8, 32, 128, 16

    def rand(*shape, scale=0.3):
        return torch.as_tensor(rng.normal(size=shape) * scale,
                               dtype=torch.float32, device=dev)

    mask = (1.0 - torch.eye(Nl, device=dev)).expand(B, Nl, Nl).contiguous()
    h_bond, q = rand(B, Nl, Nl, H, scale=1.0), rand(B, Nl, H, scale=1.0)
    x = rand(B, Nl, 3, scale=2.0)
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True)
    print(smi.stdout.strip() or torch.cuda.get_device_name(0))
    blocks = min(B * Nl, torch.cuda.get_device_properties(
        dev).multi_processor_count)
    for pos in (False, True):
        dv = heads if pos else H
        k = Branch(rand(B, Nl, H, scale=1.0), rand(B, Nl, H, scale=1.0),
                   rand(H, H, scale=0.1), rand(H, H), rand(H), 1.0 + rand(H),
                   rand(H))
        v = Branch(rand(B, Nl, H, scale=1.0), rand(B, Nl, H, scale=1.0),
                   rand(H, H, scale=0.1), rand(H, dv), rand(dv),
                   1.0 + rand(H), rand(H))
        g = rand(B, Nl, 3 if pos else H, scale=1.0)
        counts = (ctypes.c_ulonglong * NP)()
        for _ in range(2):  # the first launch warms up; the second counts
            lib.prof_read(counts)
            bond_ops.bond_attention_backward(g, h_bond, x if pos else None,
                                             mask, q, k, v, n_heads=heads,
                                             pos_mode=pos)
            torch.cuda.synchronize()
        lib.prof_read(counts)
        check = bond_ops.bond_attention_backward.row_launches
        print(f'bond backward [{"pos" if pos else "node"}], B={B} Nl={Nl} '
              f'H={H} heads={heads}, {blocks} blocks a launch (per-row '
              f'launches so far: {check})')
        for launch in ('A', 'B'):
            idx = [n for n, (_, w) in enumerate(PHASES) if w == launch]
            total = sum(counts[n] for n in idx)
            print(f'  launch {launch}: {total / blocks / 1e6:.3f} Mcycles '
                  'per block')
            for n in idx:
                print(f'    {PHASES[n][0]:52s} '
                      f'{100 * counts[n] / max(total, 1):6.2f}%  '
                      f'({counts[n] / blocks / 1e6:.4f} Mcycles per block)')
    return 0


if __name__ == '__main__':
    sys.exit(main())
