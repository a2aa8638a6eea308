#!/usr/bin/env python3
"""Where the head-factorized triplet-attention backward spends its cycles.

    python3 scripts/profile_torch_triplet_bwd.py     # on a machine with a GPU
    python3 scripts/profile_torch_triplet_bwd.py --nl 64 --real 56

Copies decompdiff_tpu_torch into build/profile_triplet_bwd (git-ignored),
inserts clock64 counters into the copy of csrc/triplet_attention.cu at the
phase boundaries of triplet_attention_bwd_head_kernel (thread 0 of each
block adds the cycles since its last counter, most of them just after a
block barrier, so a phase's count is the block's time in it), builds the
copy, runs one launch (H=128, 16 heads, the first --real atoms of each
complex bonded to every other, seeded random inputs) and prints each
phase's share of the cycles, summed over the blocks, and the instrumented
launch's device ms (CUDA events, the mean of TIMED launches). The default
shape is the released training shape (B=8, Nl=32); --nl 64 takes B=4, the
training entry point's batch on the ligand ladder's top bucket. The
repository's own sources are not changed. The counters cost a few percent
of the kernel's time.
"""

from __future__ import annotations

import argparse
import ctypes
import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
COPY = REPO / 'build' / 'profile_triplet_bwd'
TIMED = 5

COUNTERS = '''namespace hb = headbwd;
__device__ unsigned long long g_prof[16];
#define PROF(n) do { if (threadIdx.x == 0) { long long t_ = clock64(); \\
  atomicAdd(&g_prof[n], (unsigned long long)(t_ - t_last)); t_last = t_; } \\
  } while (0)
'''
READER = '''extern "C" int prof_read(unsigned long long* out) {
  cudaError_t e = cudaMemcpyFromSymbol(out, g_prof, sizeof(g_prof));
  unsigned long long z[16] = {};
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(g_prof, z, sizeof(z));
  return (int)e;
}

extern "C" int triplet_attention_bwd_route('''
# (text in the kernel, the same text with a counter) in the kernel's order
MARKS = [
    ('  for (int e = tid; e < 2 * H * MS; e += hb::THREADS) DWk[e] = 0.f;\n',
     '  long long t_last = clock64();\n'
     '  for (int e = tid; e < 2 * H * MS; e += hb::THREADS) DWk[e] = 0.f;\n'),
    ('      if (!row_has_source(f, (int)row, i, mrow_j)) {',
     '      PROF(0);\n      if (!row_has_source(f, (int)row, i, mrow_j)) {'),
    ('      // pass A: logits and d alpha of every source\n',
     '      __syncthreads(); PROF(1);\n'
     '      // pass A: logits and d alpha of every source\n'),
    ('      hb::head_softmax(LG, DA, VL, Nl, NH, HS + 2 * hb::MAXNH);\n',
     '      PROF(2);\n'
     '      hb::head_softmax(LG, DA, VL, Nl, NH, HS + 2 * hb::MAXNH);\n'
     '      __syncthreads(); PROF(3);\n'),
    ('        float e[hb::RW] = {};\n', '        PROF(4);\n'
     '        float e[hb::RW] = {};\n'),
    ("      // the row's d t_row, d bo, d Wo and d q\n",
     "      PROF(9);\n      // the row's d t_row, d bo, d Wo and d q\n"),
    ('      hb::store_heads<H>(M, sk.Y, NH);  // M is free: pass B ended in a '
     'barrier\n      __syncthreads();\n',
     '      hb::store_heads<H>(M, sk.Y, NH);  // M is free: pass B ended in a '
     'barrier\n      __syncthreads(); PROF(10);\n'),
    ('        a.d_q[row * H + c] = scale * (t + __ldg(f.k.bo + c) * '
     'S[c / hd]);\n      }\n',
     '        a.d_q[row * H + c] = scale * (t + __ldg(f.k.bo + c) * '
     'S[c / hd]);\n      }\n      __syncthreads(); PROF(11);\n'),
]
PHASES = ['row start, row_has_source', 'q, g; Qk and Gv (Wo through L2)',
          'pass A: pre, logits, d alpha', 'softmax and its backward',
          'pass B: chunk set-up', 'pass B: pre again, y to the tile',
          'pass B: Yd, Ya sums',
          'pass B: d y, LayerNorm backward, d angle, d t_src adds',
          'pass B: d Wa, d t_row', 'pass B: end of the row',
          'end: d Wo update, Yd to shared memory',
          'end: d q (Wo_k through L2)']


def replace_once(src: str, plain: str, new: str) -> str:
    if src.count(plain) != 1:
        raise SystemExit(f'profile: the kernel changed; not found once:\n'
                         f'{plain}')
    return src.replace(plain, new, 1)


def instrument(src: str) -> str:
    """The kernel source with the counters of MARKS and, inside
    head_branch_back, one after each of its block barriers (phases 5-8,
    both branches summed)."""
    src = replace_once(src, 'namespace hb = headbwd;', COUNTERS)
    for plain, counted in MARKS:
        src = replace_once(src, plain, counted)
    start = src.index('__device__ __forceinline__ void head_branch_back(')
    end = src.index('// Persistent: block g takes work items', start)
    body = src[start:end].replace(
        '    HeadBranchSums<H>& acc, float (&e)[hb::RW]) {',
        '    HeadBranchSums<H>& acc, float (&e)[hb::RW], long long& t_last) {',
        1)
    parts = body.split('__syncthreads();')
    if len(parts) != 5:
        raise SystemExit('profile: head_branch_back no longer has 4 barriers')
    body = ''.join(p + f'__syncthreads(); PROF({5 + n});'
                   for n, p in enumerate(parts[:-1])) + parts[-1]
    src = src[:start] + body + src[end:]
    src = replace_once(src, 'TSk, sk, e);', 'TSk, sk, e, t_last);')
    src = replace_once(src, 'NH, T, TSv, sv, e);',
                       'NH, T, TSv, sv, e, t_last);')
    return replace_once(src, 'extern "C" int triplet_attention_bwd_route(',
                        READER)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--nl', type=int, default=32, help='padded ligand atoms')
    ap.add_argument('--real', type=int, default=None,
                    help='bonded atoms of each complex (default: all)')
    opts = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print('profile: needs a CUDA device', file=sys.stderr)
        return 1
    shutil.rmtree(COPY, ignore_errors=True)
    shutil.copytree(REPO / 'decompdiff_tpu_torch',
                    COPY / 'decompdiff_tpu_torch')
    cu = COPY / 'decompdiff_tpu_torch' / 'csrc' / 'triplet_attention.cu'
    cu.write_text(instrument(cu.read_text()))
    sys.path.insert(0, str(COPY))
    from decompdiff_tpu_torch.ops import _build
    from decompdiff_tpu_torch.ops import triplet_attention as T
    from decompdiff_tpu_torch.ops.common import Branch
    _build.BUILD_DIR = COPY / 'lib'
    _build.build(['triplet_attention'])
    lib = ctypes.CDLL(str(_build.library_path('triplet_attention')))

    dev = torch.device('cuda')
    rng = np.random.default_rng(0)
    Nl, H, heads = opts.nl, 128, 16
    B = 8 if Nl <= 32 else 4
    real = opts.real or Nl

    def rand(*shape, scale=0.3):
        return torch.as_tensor(rng.normal(size=shape) * scale,
                               dtype=torch.float32, device=dev)

    def branch():
        return Branch(rand(B, Nl, Nl, H, scale=1.0),
                      rand(B, Nl, Nl, H, scale=1.0), rand(13, H), rand(H, H),
                      rand(H), 1.0 + rand(H), rand(H))
    atoms = torch.arange(Nl, device=dev) < real
    mask = ((atoms[:, None] & atoms[None, :]).float()
            - torch.eye(Nl, device=dev)).clamp_min(0.0)
    mask = mask.expand(B, Nl, Nl).contiguous()
    k, v = branch(), branch()
    angle = torch.as_tensor(rng.random((B, Nl, Nl, Nl)) * np.pi,
                            dtype=torch.float32, device=dev)
    q, g = rand(B, Nl, Nl, H, scale=1.0), rand(B, Nl, Nl, H, scale=1.0)
    counts = (ctypes.c_ulonglong * 16)()

    def run():
        T.triplet_attention_backward(g, angle, mask, q, k, v, n_heads=heads)
    for _ in range(2):      # the first launch warms up; the second counts
        lib.prof_read(counts)
        run()
        torch.cuda.synchronize()
    lib.prof_read(counts)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(TIMED):
        run()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / TIMED
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True)
    print(smi.stdout.strip() or torch.cuda.get_device_name(0))
    blocks = min(B * Nl, torch.cuda.get_device_properties(
        dev).multi_processor_count)
    total = sum(counts[n] for n in range(len(PHASES)))
    print(f'triplet backward, B={B} Nl={Nl} ({real} bonded atoms) H={H} '
          f'heads={heads}: '
          f'{total / blocks / 1e6:.3f} Mcycles per block; {ms:.4f} ms a '
          f'launch with the counters (mean of {TIMED}, the wrapper '
          'included)')
    for n, name in enumerate(PHASES):
        print(f'  {name:42s} {100 * counts[n] / total:6.2f}%  '
              f'({counts[n] / blocks / 1e6:.3f} Mcycles per block)')
    return 0


if __name__ == '__main__':
    sys.exit(main())
