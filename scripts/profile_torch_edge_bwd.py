#!/usr/bin/env python3
"""Where the head-factorized edge-attention backward spends its cycles.

    python3 scripts/profile_torch_edge_bwd.py     # on a machine with a GPU

Copies decompdiff_tpu_torch into build/profile_edge_bwd (git-ignored),
inserts clock64 counters into the copy of csrc/edge_attention.cu at the
phase boundaries of edge_attention_bwd_head_kernel (thread 0 of each block
adds the cycles since its last counter, almost all of them just after a
block barrier, so a phase's count is the block's time in it; a few
barriers are added to split the channel-map phases), builds the copy, runs one
launch per mode at the released training shapes (B=8, N=352 with 320
protein and 32 ligand nodes, K=32 nearest neighbours, H=128, 16 heads, 6
edge types; the m-gated mode with 4, as uni_o2 has; seeded random inputs)
and prints each phase's share of the cycles, summed over the blocks. The
repository's own sources are not changed. The counters cost a few percent
of the kernel's time.
"""

from __future__ import annotations

import ctypes
import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
COPY = REPO / 'build' / 'profile_edge_bwd'
NP = 20         # counters (at least the phases)

COUNTERS = f'''namespace hb = headbwd;
__device__ unsigned long long g_prof[{NP}];
__device__ long long g_last[1024];
#define PROF(n) do {{ if (threadIdx.x == 0) {{ long long t_ = clock64(); \\
  atomicAdd(&g_prof[n], (unsigned long long)(t_ - g_last[blockIdx.x])); \\
  g_last[blockIdx.x] = t_; }} }} while (0)
'''
READER = f'''extern "C" int prof_read(unsigned long long* out) {{
  cudaError_t e = cudaMemcpyFromSymbol(out, g_prof, sizeof(g_prof));
  unsigned long long z[{NP}] = {{}};
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(g_prof, z, sizeof(z));
  return (int)e;
}}

extern "C" int edge_attention_bwd_route('''
# (phase name, text in the kernel, the same text with the counter that ends
# the phase), in the kernel's order
MARKS = [
    ('start: zero d Wo, stage Wo_v (pos) / Wo_v wm (gate)',
     '  for (int e = tid; e < 2 * H * MS; e += hb::THREADS) DWk[e] = 0.f;\n',
     '  if (threadIdx.x == 0) g_last[blockIdx.x] = clock64();\n'
     '  for (int e = tid; e < 2 * H * MS; e += hb::THREADS) DWk[e] = 0.f;\n'),
    (None, '  const int row_end = (int)((long long)(blockIdx.x + 1) * a.rows '
     '/ gridDim.x);\n  __syncthreads();\n',
     '  const int row_end = (int)((long long)(blockIdx.x + 1) * a.rows '
     '/ gridDim.x);\n  __syncthreads(); PROF(0);\n'),
    ('row start: live test, q and g',
     '    __syncthreads();\n    hb::row_matrices<H, POS ? 1 : 2>',
     '    __syncthreads(); PROF(1);\n    hb::row_matrices<H, POS ? 1 : 2>'),
    ('Qk, Gv (Wo through L2)',
     '      __syncthreads();  // M and HS written; the last chunk is done\n',
     '      __syncthreads(); PROF(2);\n'),
    ('pass A: chunk scalars, RBF',
     '  __syncthreads();\n  edge_tile_pre_branch<H>(f.k',
     '  __syncthreads(); PROF(3);\n  edge_tile_pre_branch<H>(f.k'),
    ('pass A: pre of both branches (first linear)',
     '  __syncthreads();\n  hb::tile_ln<H>(Tk',
     '  __syncthreads(); PROF(4);\n  hb::tile_ln<H>(Tk'),
    ('pass A: LayerNorm, relu (m-gate)',
     '      __syncthreads();\n      hb::head_products_tc<H>(Tk',
     '      __syncthreads(); PROF(5);\n      hb::head_products_tc<H>(Tk'),
    ('pass A: logits, d alpha / v (tensor cores)',
     '    __syncthreads();\n    // d alpha; CV keeps',
     '    __syncthreads(); PROF(6);\n    // d alpha; CV keeps'),
    ('softmax, its backward, d e_w',
     '    // pass B: the head sums',
     '    __syncthreads(); PROF(7);\n    // pass B: the head sums'),
    ('pass B: pre again (K > 32 only)',
     '      __syncthreads();  // y of both branches in the tiles; CV, HS '
     'written\n',
     '      __syncthreads(); PROF(8);\n'),
    ('pass B: Yd, Ya (Ys) sums',
     '      __syncthreads();  // the tiles take d pre below\n',
     '      __syncthreads(); PROF(9);\n'),
    ('pass B: d y, relu and LayerNorm backward',
     '      __syncthreads();\n      if (tid < H)\n        for (int r = 0; '
     'r < nr; ++r) {\n          trow_k',
     '      __syncthreads(); PROF(10);\n      if (tid < H)\n        for '
     '(int r = 0; r < nr; ++r) {\n          trow_k'),
    ('pass B: d t_row, d t_src atomics',
     '      edge_dist_partial<H>(Tk, Tv, zk, zv, E);\n',
     '      __syncthreads(); PROF(11);\n'
     '      edge_dist_partial<H>(Tk, Tv, zk, zv, E);\n'
     '      __syncthreads(); PROF(12);\n'),
    ('pass B: distance chain (d pre . d pre / d dist)', None, None),
    ('pass B: d w_feat sums of the chunk',
     '        edge_wfeat_back<H, NR>(Tk, Tv, et, r_lo, n_r, wk, wv, seen);\n',
     '        edge_wfeat_back<H, NR>(Tk, Tv, et, r_lo, n_r, wk, wv, seen);\n'
     '        __syncthreads(); PROF(13);\n'),
    ('pass B: d w_feat to the block slot (coalesced adds)',
     '        flush_wfeat<H>(wv, gv.wfeat, seen, F, lig, r_lo, n_r);\n'
     '      }\n      __syncthreads();\n',
     '        flush_wfeat<H>(wv, gv.wfeat, seen, F, lig, r_lo, n_r);\n'
     '      }\n      __syncthreads(); PROF(14);\n'),
    ('pass B: d x (source atomics)',
     "    // the row's d t_row, d x, d bo, d Wo and d q\n",
     "    __syncthreads(); PROF(15);\n"
     "    // the row's d t_row, d x, d bo, d Wo and d q\n"),
    ('row end: d bo, d Wo update, Yd to shared memory',
     '    hb::store_heads<H>(M, Yd, NH);  // Qk is done: pass B ended in a '
     'barrier\n    __syncthreads();\n',
     '    hb::store_heads<H>(M, Yd, NH);  // Qk is done: pass B ended in a '
     'barrier\n    __syncthreads(); PROF(16);\n'),
    ('row end: d q (Wo_k through L2)',
     '          scale * (t + __ldg(f.k.bo + c) * SH[c / hd]);\n    }\n  }\n',
     '          scale * (t + __ldg(f.k.bo + c) * SH[c / hd]);\n    }\n'
     '    __syncthreads(); PROF(17);\n  }\n'),
    ('end: slot writes',
     '    out[cc] = t;\n  }\n}\n',
     '    out[cc] = t;\n  }\n  __syncthreads(); PROF(18);\n}\n'),
]
PHASES = [name for name, _, _ in MARKS if name]


def instrument(src: str, strict: bool = True) -> str:
    """The kernel source with the counters of MARKS; without `strict` a
    mark the source lacks is left out (its phase then reads 0)."""
    src = src.replace('namespace hb = headbwd;', COUNTERS, 1)
    for _, plain, counted in MARKS:
        if plain is None:           # the phase ends at its mark's second
            continue                # counter
        if src.count(plain) < 1:
            if not strict:
                continue
            raise SystemExit(f'profile: the kernel changed; not found:\n{plain}')
        src = src.replace(plain, counted, 1)
    return src.replace('extern "C" int edge_attention_bwd_route(', READER, 1)


def prepare(copy: Path, edit=lambda src: src, strict: bool = True) -> None:
    """copy <- the package, with edit(kernel source) instrumented."""
    shutil.rmtree(copy, ignore_errors=True)
    shutil.copytree(REPO / 'decompdiff_tpu_torch',
                    copy / 'decompdiff_tpu_torch')
    cu = copy / 'decompdiff_tpu_torch' / 'csrc' / 'edge_attention.cu'
    cu.write_text(instrument(edit(cu.read_text()), strict))


def main(copy: Path = COPY, fresh: bool = True) -> int:
    """Builds the instrumented copy (prepared anew unless not `fresh`) and
    prints the phases of one launch per mode."""
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print('profile: needs a CUDA device', file=sys.stderr)
        return 1
    if fresh:
        prepare(copy)
    sys.path.insert(0, str(copy))
    from decompdiff_tpu_torch.ops import _build
    from decompdiff_tpu_torch.ops import edge_attention as E
    from decompdiff_tpu_torch.ops.common import Branch
    from decompdiff_tpu_torch.ops.knn import knn_neighbors
    _build.BUILD_DIR = copy / 'lib'
    _build.build(['edge_attention'])
    lib = ctypes.CDLL(str(_build.library_path('edge_attention')))

    dev = torch.device('cuda')
    rng = np.random.default_rng(0)
    B, N, Np, K, H, heads = 8, 352, 320, 32, 128, 16

    def rand(*shape, scale=0.3):
        return torch.as_tensor(rng.normal(size=shape) * scale,
                               dtype=torch.float32, device=dev)

    x = rand(B, N, 3, scale=4.0)
    idx, nbr_mask, _ = knn_neighbors(
        x, torch.ones(B, N, dtype=torch.bool, device=dev), K)
    lig = (torch.arange(N, device=dev) >= Np).float().expand(B, N)
    lig = lig.contiguous()
    group = torch.as_tensor(rng.integers(0, 6, size=(B, N)),
                            dtype=torch.float32, device=dev)
    e_w = torch.as_tensor(rng.random((B, N, K)), dtype=torch.float32,
                          device=dev)
    q = rand(B, N, H, scale=1.0)
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True)
    print(smi.stdout.strip() or torch.cuda.get_device_name(0))
    blocks = min(B * N, torch.cuda.get_device_properties(
        dev).multi_processor_count)
    for mode in ('node', 'pos', 'gated'):
        pos, n_et = mode == 'pos', 4 if mode == 'gated' else 6
        k = Branch(rand(B, N, H, scale=1.0), rand(B, N, H, scale=1.0),
                   rand(n_et * 21, H), rand(H, H), rand(H), 1.0 + rand(H),
                   rand(H))
        dv = heads if pos else H
        v = Branch(rand(B, N, H, scale=1.0), rand(B, N, H, scale=1.0),
                   rand(n_et * 21, H), rand(H, dv), rand(dv), 1.0 + rand(H),
                   rand(H))
        g = rand(B, N, 3 if pos else H, scale=1.0)
        kw = dict(n_heads=heads, pos_mode=pos)
        if mode == 'gated':
            kw['gate'] = (rand(H), torch.full((1,), 0.5, device=dev))
        args = (x, lig, None if n_et == 4 else group, idx.int().contiguous(),
                nbr_mask.float(), e_w, q, k, v)
        counts = (ctypes.c_ulonglong * NP)()
        for _ in range(2):  # the first launch warms up; the second counts
            lib.prof_read(counts)
            E.edge_attention_backward(g, *args, **kw)
            torch.cuda.synchronize()
        lib.prof_read(counts)
        total = sum(counts[n] for n in range(len(PHASES)))
        print(f'edge backward [{mode}], B={B} N={N} K={K} H={H} heads='
              f'{heads} {n_et} edge types: {total / blocks / 1e6:.3f} '
              f'Mcycles per block')
        for n, name in enumerate(PHASES):
            print(f'  {name:50s} {100 * counts[n] / total:6.2f}%  '
                  f'({counts[n] / blocks / 1e6:.3f} Mcycles per block)')
    return 0


if __name__ == '__main__':
    sys.exit(main())
