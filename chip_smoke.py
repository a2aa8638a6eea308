#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (decompdiff_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # from the root of a repository checkout

1. Device: requires CUDA, turns TF32 off, prints the card's name and power
   limit (nvidia-smi).
2. Build: compiles the three CUDA sources of csrc/ (each holds a forward and
   a backward kernel) with nvcc (timed set-up).
3. Kernels: records the inputs each of the five kernel modes gets in the first
   layer of a released-config denoiser call (B=8, Np=320, Nl=32), those of
   the m-gated edge mode in the first layer of a released-width uni_o2
   (ew_net_type 'm') denoiser call, those of the edge modes with
   pallas_gather_bf16 (x_src) in the first layer of a released-config call
   with that key, and those of the edge, bond and triplet modes in the
   first layer of denoiser calls at the widths of the per-row forward
   kernels (WIDTHS, B=2); then holds every forward kernel against its plain
   PyTorch version on those inputs (the triplet kernel also with its bf16
   option against the bf16 plain version, at the released width and on the
   per-row kernel at WIDTHS, and the per-row edge kernel with an x_src
   shifted from x), and every backward kernel
   against plain autograd for a seeded cotangent (zeroed, where elements
   lie outside the tolerance, on the few rows whose relu gates within
   rounding of 0 explain them: decompdiff_tpu_torch/utils/gradcheck.py),
   timing each with CUDA events beside the previous time (PREVIOUS_MS) and
   its bounds (the triplet, edge and bond backward's from their
   head-factorized least work, the old all-FP32 count beside it); then the
   per-row edge, bond and triplet backward at WIDTHS (printed only), and
   the backward kernels on the inputs of a denoiser call at WIDE (B=2).
4. Sampling paths: guided reverse diffusion (armsca_prox + clash at every
   step) with kernels on, first with the released uni_o2_bond config, then
   the same with pallas_bf16, then with pallas_gather_bf16, then with the
   released-width uni_o2 config, then uni_o2_bond at each of WIDTHS (B=2,
   WIDTH_STEPS steps), and again there with pallas_bf16 and
   pallas_gather_bf16, each with every launch counter set to 0 just before
   and read just after; then one denoiser call with kernels on against
   kernels off (for pallas_bf16 against the float32 kernels: the option's
   cost, printed; for pallas_gather_bf16 against the same model with every
   kernel wrapper replaced by its plain version, and its distance from the
   float32 kernels printed), and for uni_o2 with ew_net_type m, global
   and r.
5. Training paths: training steps (forward, backward, clip and Adam) at B=8,
   Np=320, Nl=32 with kernels on, counters set to 0 just before and read
   just after, for uni_o2_bond, then with pallas_gather_bf16, then uni_o2,
   then uni_o2_bond at WIDE (B=2: per-row forwards, backward row buffers in
   device memory, launches exact in every counter; the edge, bond and
   triplet backward are the head-factorized kernels at the released width,
   with no per-row launch, and the per-row kernels at WIDE, every launch);
   the
   same steps with
   every kernel replaced by its plain version; seconds per step and peak
   device memory of both; one step's loss, grad norm and parameter
   gradients, kernels on against off (with pallas_gather_bf16 also against
   a plain step that rounds as the kernels do, FLIP_COUNT). Then the
   backward kernels held and timed on the inputs of denoiser calls at
   WIDER (B=2), printed only.
6. Prints the kernels JSON line and, last, the device JSON line.

Any failed check exits non-zero. Needs torch and numpy only.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
B, NUM_PROTEIN, NUM_LIGAND, NUM_FULL, NUM_GROUPS = 8, 320, 32, 2048, 6
STEPS = 20          # sampling steps
TRAIN_STEPS = 3     # timed training steps, after one warm-up step
# (hidden width, heads) of uni_o2_bond runs on the per-row forward kernels
# (widths outside the tensor-core kernels'), at B=2 and WIDTH_STEPS steps
WIDTHS, WIDTH_B, WIDTH_STEPS = ((96, 12), (256, 16)), 2, 5
# (hidden width, heads) of a uni_o2_bond training step (at WIDTH_B) whose
# backward kernels take their 1024-thread builds with the row buffers in
# device memory (the *_backward_wide records), and of the further widths at
# which those kernels are held and timed on a denoiser call's inputs too
# (printed only: the records are WIDE's, the width trained)
WIDE, WIDER = (512, 16), ((1024, 32),)
# H100 SXM published peaks: FP32 outside the tensor cores, HBM3 bandwidth,
# dense bf16 on the tensor cores
PEAK_FLOPS, PEAK_BYTES, TENSOR_PEAK = 67e12, 3.35e12, 989e12
# bf16 tensor-core passes that the [H, H] products (the second linears, and
# the bond's first linears) of each forward record's function take at its
# accuracy (row_mma.cuh: hi*hi + hi*lo + lo*hi for float32, hi*hi with
# bf16). The bound is the function's, whichever kernel computes it: the
# per-row (_row) records, which run those products on CUDA cores, are
# bounded as the tensor-core widths are.
TENSOR_PASSES = {'edge_attention': 3, 'edge_attention_mgate': 3,
                 'edge_attention_gather': 3, 'edge_attention_row': 3,
                 'edge_attention_row_gather': 3,
                 'bond_attention': 3, 'bond_attention_row': 3,
                 'triplet_attention': 3, 'triplet_attention_row': 3,
                 'triplet_attention_bf16': 1,
                 'triplet_attention_row_bf16': 1}
# kernel vs plain version: both float32, different summation order
KERNEL_RTOL, KERNEL_ATOL = 1e-3, 1e-4
# the triplet kernel's bf16 option vs the bf16 plain version: a y within
# float32 rounding of a bf16 rounding boundary can round the other way in
# the two (a flip), which moves a k or v entry by one bf16 ulp of y (up to
# 2^-7 |y|) times a row of Wo; so at most BF16_FRAC of the elements may lie
# outside BF16_RTOL / BF16_ATOL, and none beyond BF16_CAP
# (tests/test_torch_cuda.py)
BF16_RTOL, BF16_ATOL, BF16_FRAC, BF16_CAP = 1e-3, 1e-3, 1e-3, 1e-2
# backward kernel vs plain autograd: every element at GRAD_RTOL / GRAD_ATOL x
# max(1, |grad|max), with the cotangent zeroed on the rows whose relu gates
# lie within float32 rounding of 0 where they explain the elements outside
# (decompdiff_tpu_torch/utils/gradcheck.py)
# one denoiser call, kernels on vs off: six layers of the above, on
# coordinates of a few Angstrom and logits of order one
PATH_RTOL, PATH_ATOL = 1e-3, 1e-3
# one training step, kernels on vs off: the loss within float32 noise of six
# layers; the parameter gradients elementwise at the tolerance the JAX
# package holds its kernel path to against its dense path
# (tests/test_train_step.py)
LOSS_RTOL, STEP_RTOL, STEP_ATOL = 1e-4, 2e-3, 1e-4
# With pallas_gather_bf16 each edge call rounds its source table to bf16:
# h (and x as hi + lo) in the forward, their cotangents in the backward. The
# kernel and plain paths reach those values through other summation orders,
# so an element within float32 rounding of a bf16 rounding boundary can
# round to the neighbouring bf16 value in the two (a flip) and move by one
# bf16 ulp (up to 2^-7 of it), and with it everything downstream. So there
# at most FLIP_COUNT parameter gradient elements in all may lie outside the
# step tolerance, none beyond FLIP_CAP x max(1, |grad|max) (the readings: 2
# elements, 1.14e-4, in two runs); and a witness run must show that flips
# cause them: the plain path again, rounding as the kernel path does at
# every flip (table_roundings), must hold the step tolerance with none
# admitted.
FLIP_COUNT, FLIP_CAP = 16, 1e-3
# the TPU kernel each record replaces; the m-gated and gather records are
# the m_gate and gather_bf16 variants of the same two pallas_calls, the
# per-row (_row) records the same pallas_calls at the other widths, the
# _backward_wide records the backward pallas_calls at WIDE
KERNEL_SOURCES = {
    'edge_attention': 'decompdiff_tpu/ops/pallas/edge_kernel.py:540',
    'edge_attention_mgate': 'decompdiff_tpu/ops/pallas/edge_kernel.py:540',
    'edge_attention_gather': 'decompdiff_tpu/ops/pallas/edge_kernel.py:540',
    'edge_attention_gather_backward':
        'decompdiff_tpu/ops/pallas/edge_kernel.py:568',
    'edge_attention_row': 'decompdiff_tpu/ops/pallas/edge_kernel.py:540',
    'edge_attention_row_gather':
        'decompdiff_tpu/ops/pallas/edge_kernel.py:540',
    'triplet_attention_row':
        'decompdiff_tpu/ops/pallas/triplet_kernel.py:172',
    'triplet_attention_row_bf16':
        'decompdiff_tpu/ops/pallas/triplet_kernel.py:172',
    'bond_attention': 'decompdiff_tpu/ops/pallas/bond_kernel.py:128',
    'bond_attention_row': 'decompdiff_tpu/ops/pallas/bond_kernel.py:128',
    'edge_attention_backward_wide':
        'decompdiff_tpu/ops/pallas/edge_kernel.py:568',
    'bond_attention_backward_wide':
        'decompdiff_tpu/ops/pallas/bond_kernel.py:307',
    'triplet_attention_backward_wide':
        'decompdiff_tpu/ops/pallas/triplet_kernel.py:371',
    'triplet_attention': 'decompdiff_tpu/ops/pallas/triplet_kernel.py:172',
    'triplet_attention_bf16':
        'decompdiff_tpu/ops/pallas/triplet_kernel.py:172',
    'edge_attention_backward': 'decompdiff_tpu/ops/pallas/edge_kernel.py:568',
    'bond_attention_backward': 'decompdiff_tpu/ops/pallas/bond_kernel.py:307',
    'triplet_attention_backward':
        'decompdiff_tpu/ops/pallas/triplet_kernel.py:371',
    'edge_attention_mgate_backward':
        'decompdiff_tpu/ops/pallas/edge_kernel.py:568',
}
# Each kernel mode's ms as this script measured it on the per-row
# CUDA-core kernel, before that kernel's redesign (the forwards onto the
# tensor cores, the triplet, edge and bond backward head-factorized;
# PERF.md kernel table, NVIDIA H100 80GB HBM3, 700 W; the edge and bond
# backward's from the last runs of their per-row kernels at these shapes),
# printed beside this run's.
PREVIOUS_MS = {
    ('edge_attention', 'node'): '0.4334-0.4361',
    ('edge_attention', 'pos'): '0.3852-0.3888',
    ('edge_attention_mgate', 'node'): '0.4622-0.4671',
    ('bond_attention', 'node'): '0.0997-0.0999',
    ('bond_attention', 'pos'): '0.0934-0.0937',
    ('triplet_attention', 'node'): '1.8163-1.8297',
    ('edge_attention_backward', 'node'): '2.9100-2.9114',
    ('edge_attention_backward', 'pos'): '2.8446-2.8465',
    ('edge_attention_mgate_backward', 'node'): '2.9901-2.9944',
    ('edge_attention_gather_backward', 'node'): '2.8993-2.8997',
    ('edge_attention_gather_backward', 'pos'): '2.8403-2.8424',
    ('bond_attention_backward', 'node'): '0.5065-0.5089',
    ('bond_attention_backward', 'pos'): '0.5330-0.5357',
    ('triplet_attention_backward', 'node'): '6.3579-6.9527',
}


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def device_phase(torch):
    check(torch.cuda.is_available(), 'CUDA is not available')
    check((REPO / 'decompdiff_tpu_torch' / 'csrc').is_dir(),
          f'{REPO} is not a checkout holding decompdiff_tpu_torch')
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0 and smi.stdout.strip(),
          f'nvidia-smi failed: {smi.stderr.strip()}')
    print(smi.stdout.strip().splitlines()[0], flush=True)
    print(f'torch {torch.__version__} cuda {torch.version.cuda} '
          f'device {torch.cuda.get_device_name(0)}', flush=True)


def build_phase():
    from decompdiff_tpu_torch.ops import _build
    t0 = time.perf_counter()
    logs = _build.build()
    print(f'build: {len(_build.KERNELS)} sources (forward and backward '
          f'kernels) in {time.perf_counter() - t0:.1f} s (set-up)', flush=True)
    for name, log in logs.items():
        for line in log.splitlines():
            if any(w in line for w in ('entry function', 'registers',
                                       'spill')):
                print(f'  {name}: {line.strip()}')


def time_ms(torch, fn, iters=20, warmup=3):
    """Device ms per call of fn, by CUDA events. The device first spins
    (torch.cuda._sleep) for about twice the host time that the timed calls
    take to enqueue, so every launch is queued before the first event and
    the events time the device's work, not the wrapper's cost per call
    (which exceeds a tensor-core kernel's time)."""
    t0 = time.perf_counter()
    for _ in range(warmup):
        fn()
    host_s = (time.perf_counter() - t0) / warmup
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(2 * iters * host_s * 2e9))   # cycles at <= 2 GHz
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def capture_inputs(torch, ops, model, batch, state, wrapped=False):
    """The arguments of the first call of each kernel mode in one denoiser
    call (no kernel launched), keyed by (kernel record name, 'node' or
    'pos'), caught at the plain versions: a plain model's calls, or with
    `wrapped` a kernel model's calls under plain_versions. An m-gated edge
    call is the record edge_attention_mgate, one with an x_src
    edge_attention_gather."""
    captured = {}
    originals = {}
    for name, mod in ops.items():
        fn_name = f'{name}_reference'
        orig = originals[name] = getattr(mod, fn_name)

        def record(*args, _name=name, _orig=orig, **kw):
            rec = _name + ('_mgate' if kw.get('gate') is not None else '') \
                + ('_gather' if kw.get('x_src') is not None else '')
            mode = 'pos' if kw.get('pos_mode', False) else 'node'
            captured.setdefault((rec, mode), (args, kw))
            return _orig(*args, **kw)
        setattr(mod, fn_name, record)
    try:
        with torch.no_grad(), (plain_versions(ops) if wrapped
                               else contextlib.nullcontext()):
            model.apply(batch, *state)
    finally:
        for name, mod in ops.items():
            setattr(mod, f'{name}_reference', originals[name])
    return captured


@contextlib.contextmanager
def plain_versions(ops):
    """Every kernel wrapper replaced by its plain version: a kernel model
    then computes what its kernels compute (the bf16 options included, which
    the plain path does not read) without launching one."""
    wrappers = {name: getattr(mod, name) for name, mod in ops.items()}
    for name, mod in ops.items():
        setattr(mod, name, getattr(mod, f'{name}_reference'))
    try:
        yield
    finally:
        for name, mod in ops.items():
            setattr(mod, name, wrappers[name])


RECORD_SUFFIXES = ('_mgate', '_bf16', '_gather', '_row', '_wide')


def op_name(rec):
    """The ops module function of a kernel record name."""
    for suffix in RECORD_SUFFIXES:
        rec = rec.replace(suffix, '')
    return rec


def call_inputs(torch, args, kw):
    """Every tensor a kernel call reads: the tensor arguments, Branch fields,
    the gate and x_src."""
    tensors = [a for a in list(args) + list(kw.values())
               if torch.is_tensor(a)]
    for a in list(args) + [kw.get('gate')]:
        if isinstance(a, tuple):
            tensors += list(a)
    return tensors


def work(torch, name, args, kw, out):
    """(FLOPs, [H, H] second-linear FLOPs among them, bytes) the call needs
    on these inputs: 2 per multiply-add of the per-pair products, of q.k and
    alpha.v and of the m-gate's v.wm over valid (row, source) pairs only
    (LayerNorm, exp and adds left out, so the bound is a lower bound);
    every input read once and the output written once."""
    nbytes = sum(t.numel() * t.element_size()
                 for t in call_inputs(torch, args, kw))
    nbytes += out.numel() * out.element_size()
    H = args[-3].shape[-1]                # every kernel takes (..., q, k, v)
    nh = kw['n_heads']
    pos = kw.get('pos_mode', False)
    v_out = 2 * H * nh + 2 * H + 6 * nh if pos else 2 * H * H + 2 * H
    attn = 2 * H * H + 2 * H + v_out      # k second linear, q.k, v and alpha.v
    square = 2 * H * H * (1 if pos else 2)    # the [H, H] second linears
    if name.startswith('edge_attention'):  # (x, lig, group, idx, mask, ...)
        pairs = int((args[4] > 0.5).sum())
        n_types = 1 if args[2] is None else 2
        per_pair = 2 * 2 * 21 * n_types * H + attn
        if kw.get('gate') is not None:
            per_pair += 2 * H
    elif name.startswith('bond_attention'):   # (h_bond, x, mask, ...)
        pairs = int((args[2] > 0.5).sum())
        per_pair = 2 * 2 * H * H + attn
        square += 2 * 2 * H * H           # and the [H, H] first linears
    else:                                 # (angle, mask, ...)
        from decompdiff_tpu_torch.ops.triplet_attention import triplet_mask
        pairs = int(triplet_mask(args[1]).sum())
        per_pair = 2 * 2 * 13 * H + attn
    return pairs * per_pair, pairs * square, nbytes


def bounds(name, flops, square, nbytes):
    """(operations ms, bytes ms, operations ms with every FLOP at the FP32
    CUDA-core peak) of a record: for a record in TENSOR_PASSES the [H, H]
    products count at the bf16 tensor-core peak for each pass, the other
    operations at the FP32 peak; every other record's all at the FP32
    peak."""
    t_fp32 = flops / PEAK_FLOPS * 1e3
    passes = TENSOR_PASSES.get(name, 0)
    t_ops = ((flops - square) / PEAK_FLOPS + passes * square / TENSOR_PEAK
             ) * 1e3 if passes else t_fp32
    return t_ops, nbytes / PEAK_BYTES * 1e3, t_fp32


def modes(captured):
    """The captured modes in a fixed order, the m-gated ones after the
    others, then the gather ones, then the per-row ones: each earlier mode
    then draws the cotangent and follows the launches it did before the
    later ones existed, so its numbers stay comparable across runs."""
    def rank(kv):
        name = kv[0][0]
        return ([s in name for s in ('_row', '_gather', '_mgate')], kv[0])
    return sorted(captured.items(), key=rank)


def check_forward(torch, results, name, mode, args, kw, rtol, atol, frac=0.0,
                  cap=None):
    """One forward record on one mode's inputs: the kernel against its plain
    version (at most `frac` of the elements outside rtol / atol, none
    beyond `cap`), both timed, beside the previous time and the bounds. Returns
    the kernel's output."""
    mod = ops_module(name)
    kernel = getattr(mod, op_name(name))
    plain = getattr(mod, f'{op_name(name)}_reference')
    ref = plain(*args, **kw)
    out = kernel(*args, **kw)
    torch.cuda.synchronize()
    err = (out - ref).abs()
    max_abs = float(err.max())
    max_rel = float((err / ref.abs().clamp_min(1e-6)).max())
    outside = int((err > atol + rtol * ref.abs()).sum())
    ok = (bool(torch.isfinite(out).all()) and outside <= frac * out.numel()
          and (cap is None or max_abs <= cap))
    ms = time_ms(torch, lambda: kernel(*args, **kw))
    plain_ms = time_ms(torch, lambda: plain(*args, **kw))
    flops, square, nbytes = work(torch, name, args, kw, out)
    t_ops, t_bytes, t_fp32 = bounds(name, flops, square, nbytes)
    shapes = 'x'.join(str(s) for s in out.shape)
    fp32_note = (f' (FP32 CUDA-core bound {max(t_fp32, t_bytes):.4f} ms)'
                 if name in TENSOR_PASSES else '')
    print(f'kernel {name}[{mode}] out {shapes}: max_abs_err {max_abs:.3e} '
          f'max_rel_err {max_rel:.3e}, {outside} elements outside (rtol '
          f'{rtol}, atol {atol}; allowed {int(frac * out.numel())}'
          f'{f", none beyond {cap}" if cap else ""}) '
          f'{"ok" if ok else "MISMATCH"}; kernel {ms:.4f} ms'
          f'{previous_note(name, mode)}, plain {plain_ms:.4f} ms, bound '
          f'{max(t_ops, t_bytes):.4f} ms by '
          f'{"operations" if t_ops >= t_bytes else "bytes"}{fp32_note} '
          f'({flops / 1e9:.3f} GFLOP, {square / 1e9:.3f} of them [H, H] '
          f'products, {nbytes / 1e6:.2f} MB)', flush=True)
    check(ok, f'{name}[{mode}] disagrees with its plain version')
    r = results.setdefault(name, dict(err=0.0, modes=[]))
    r['err'] = max(r['err'], max_abs)
    r['modes'].append((ms, plain_ms, t_ops, t_bytes, t_fp32))
    return out


def kernel_phase(torch, captured):
    results = {}
    gen = torch.Generator(device='cuda').manual_seed(5)
    for (name, mode), (args, kw) in modes(captured):
        out = check_forward(torch, results, name, mode, args, kw,
                            KERNEL_RTOL, KERNEL_ATOL)
        if name == 'triplet_attention':   # its pallas_bf16 option
            out_bf16 = check_forward(torch, results, f'{name}_bf16', mode,
                                     args, dict(kw, bf16=True), BF16_RTOL,
                                     BF16_ATOL, BF16_FRAC, BF16_CAP)
            print(f'kernel {name}_bf16: the option moves the kernel output '
                  f'by max_abs {float((out_bf16 - out).abs().max()):.3e} '
                  f'against the float32 kernel', flush=True)
        if name == 'triplet_attention_row':   # the per-row kernel's bf16
            check_forward(torch, results, f'{name}_bf16', mode, args,
                          dict(kw, bf16=True), BF16_RTOL, BF16_ATOL,
                          BF16_FRAC, BF16_CAP)
        if name == 'edge_attention_row':  # per-row, sources from an x_src
            x = args[0]               # shifted from x (pallas_gather_bf16)
            x_src = x + 0.5 * torch.randn(x.shape, generator=gen,
                                          device=x.device)
            check_forward(torch, results, f'{name}_gather', mode, args,
                          dict(kw, x_src=x_src), KERNEL_RTOL, KERNEL_ATOL)
    # 6 modes of the released configs, 2 gather modes, and per width the
    # edge and bond node and pos modes and the triplet
    want = 8 + 5 * len(WIDTHS)
    check(len(captured) == want,
          f'expected {want} kernel modes, saw {sorted(captured)}')
    # a record per mode, and the bf16 options of the triplet (released
    # width and per width) and the per-row edge modes with an x_src
    checked = sum(len(r['modes']) for r in results.values())
    check(checked == want + 1 + 3 * len(WIDTHS),
          f'{checked} forward checks, expected {want + 1 + 3 * len(WIDTHS)}')
    return results


def previous_note(name, mode):
    ref = PREVIOUS_MS.get((name, mode))
    return f' (previous: {ref} ms)' if ref else ''


def nbytes(tensors):
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def grad_close(torch, a, b, rtol, atol):
    """(ok, max abs error, error / max(1, |b|max), elements outside
    rtol x |b| + atol x max(1, |b|max)) of gradient a against b."""
    scale = max(1.0, float(b.abs().max()))
    diff = (a - b).abs()
    outliers = int((diff > atol * scale + rtol * b.abs()).sum())
    err = float(diff.max())
    ok = bool(torch.isfinite(a).all()) and outliers == 0
    return ok, err, err / scale, outliers


def triplet_backward_work(torch, args, kw):
    """(FLOPs, product FLOPs among them) of the least work of the triplet
    backward on these inputs, head-factorized (csrc/head_bwd.cuh), 2 per
    multiply-add: per valid triplet the first linears of both branches
    again, d Wa and d angle (13 wide each), the LayerNorm and relu forward
    (6 a channel) and backward (8) of both branches, and the six heads-wide
    products (logits, d alpha, d y of both branches, Yd, Ya); per live row
    (one with a valid triplet) the five [H, H] products (Qk, Gv, d q, and d
    Wo of both branches). The products are the tensor-core share."""
    from decompdiff_tpu_torch.ops.triplet_attention import triplet_mask
    valid = triplet_mask(args[1])
    pairs, rows = int(valid.sum()), int(valid.any(-1).sum())
    H, nh = args[2].shape[-1], kw['n_heads']
    square = pairs * 2 * 6 * nh * H + rows * 2 * 5 * H * H
    return pairs * (3 * 2 * 2 * 13 * H + 2 * (6 + 8) * H) + square, square


def edge_backward_work(torch, args, kw):
    """(FLOPs, product FLOPs among them) of the least work of the edge
    backward on these inputs, head-factorized (csrc/head_bwd.cuh), 2 per
    multiply-add: per valid edge the first linears of both branches again,
    d w_feat and the distance chain (21 wide for each of the edge's 1 or 2
    types), the LayerNorm and relu forward (6 a channel) and backward (8)
    of both branches, and the six heads-wide products (logits, d alpha or
    pos mode's v, d y of both branches, Yd, Ya or pos mode's d Wo_v), with
    the m-gate three H-wide ones more (s, its d y_v, Ys); per live row (one
    with a valid edge) the [H, H] products: Qk, d q and d Wo_k, and in
    node mode Gv and d Wo_v; with the m-gate once Wo_v wm and Wo_v^T Ys.
    The products are the tensor-core share."""
    valid = args[4] > 0.5                 # (x, lig, group, idx, mask, ...)
    pairs, rows = int(valid.sum()), int(valid.any(-1).sum())
    H, nh = args[-3].shape[-1], kw['n_heads']
    n_types = 1 if args[2] is None else 2
    gate = kw.get('gate') is not None
    square = (pairs * 2 * (6 * nh + 3 * gate) * H
              + rows * 2 * (3 if kw.get('pos_mode', False) else 5) * H * H
              + 2 * 2 * H * H * gate)
    return (pairs * (3 * 2 * 2 * 21 * n_types * H + 2 * (6 + 8) * H)
            + square, square)


def bond_backward_work(torch, args, kw):
    """(FLOPs, product FLOPs among them) of the least work of the bond
    backward on these inputs, head-factorized (csrc/head_bwd.cuh), 2 per
    multiply-add: per valid pair the three [H, H] products of both branches
    (the first linear again, d h_bond and d We), the LayerNorm and relu
    forward (6 a channel) and backward (8) of both branches, and the six
    heads-wide products (logits, d alpha or pos mode's v, d y of both
    branches, Yd, Ya or pos mode's d Wo_v); per live row (one with a valid
    pair) the [H, H] products Qk, d q and d Wo_k, and in node mode Gv and
    d Wo_v. The products are the tensor-core share."""
    valid = args[2] > 0.5                 # (h_bond, x, mask, q, k, v)
    pairs, rows = int(valid.sum()), int(valid.any(-1).sum())
    H, nh = args[3].shape[-1], kw['n_heads']
    square = (pairs * 2 * (3 * 2 * H + 6 * nh) * H
              + rows * 2 * (3 if kw['pos_mode'] else 5) * H * H)
    return pairs * 2 * (6 + 8) * H + square, square


def backward_phase(torch, ops, captured, rows=False):
    """Each backward kernel against plain autograd (the plain forward's
    autograd backward, on the card) for a seeded cotangent, on the inputs
    the first layer gives each mode, by compare_backward
    (decompdiff_tpu_torch/utils/gradcheck.py: the cotangent zeroed on the
    few rows whose ambiguous relu gates explain the elements outside the
    tolerance, where any are). The per-row (_row) modes are forward records,
    skipped unless `rows` (then <kernel>_backward_row: every backward
    kernel is per-row outside H in 32, 64, 128); the _wide modes give the
    <kernel>_backward_wide records."""
    from decompdiff_tpu_torch.utils.gradcheck import (
        GRAD_ATOL, GRAD_RTOL, compare_backward)
    results = {}
    gen = torch.Generator(device='cuda').manual_seed(2)
    for (name, mode), (args, kw) in modes(captured):
        if name.endswith('_row') != rows:
            continue
        op = op_name(name)
        mod = ops[op]
        kernel = getattr(mod, f'{op}_backward')
        plain = getattr(mod, f'{op}_backward_reference')
        with torch.no_grad():
            out = getattr(mod, f'{op}_reference')(*args, **kw)
        g_full = torch.randn(out.shape, generator=gen, device=out.device)
        v = compare_backward(op, lambda g: kernel(g, *args, **kw),
                             lambda g: plain(g, *args, **kw), g_full, args,
                             kw)
        torch.cuda.synchronize()
        check(bool(v.errors), f'{name}[{mode}] backward: {v.message}')
        g, got = v.g, v.got
        for label, (err, rel, n_out) in v.errors.items():
            if n_out:
                print(f'  d {label}: {n_out} elements outside, max_err/scale '
                      f'{rel:.3e} MISMATCH', flush=True)
        max_abs = max(e[0] for e in v.errors.values())
        worst = max(e[1] for e in v.errors.values())
        n_out = sum(e[2] for e in v.errors.values())
        ms = time_ms(torch, lambda: kernel(g, *args, **kw))
        plain_ms = time_ms(torch, lambda: plain(g, *args, **kw), iters=5)
        # recompute plus two products per forward product, all at the FP32
        # peak; the triplet's, the edge's and the bond's: their
        # head-factorized least work, the products at three bf16
        # tensor-core passes (as
        # TENSOR_PASSES counts the forwards), the rest at the FP32 peak,
        # whichever kernel runs it; every input and the cotangent read once,
        # every gradient written once
        flops = 3 * work(torch, name, args, kw, out)[0]
        moved = (nbytes(call_inputs(torch, args, kw)) + nbytes([g])
                 + nbytes(got))
        t_fp32, t_bytes = flops / PEAK_FLOPS * 1e3, moved / PEAK_BYTES * 1e3
        t_ops = t_fp32
        least = {'triplet_attention': triplet_backward_work,
                 'edge_attention': edge_backward_work,
                 'bond_attention': bond_backward_work}.get(op)
        if least:
            flops, square = least(torch, args, kw)
            t_ops = ((flops - square) / PEAK_FLOPS
                     + 3 * square / TENSOR_PEAK) * 1e3
        rec = (f'{op}_backward_wide' if name.endswith('_wide')
               else f'{op}_backward_row' if rows else f'{name}_backward')
        zeroed = (f'the cotangent zeroed on {v.zeroed} of {v.live} live '
                  f'rows ({v.ambiguous} hold a gate within {v.tau:.3e} of 0)'
                  if v.live else 'the full cotangent')
        print(f'kernel {rec}[{mode}] {len(got)} gradients: '
              f'max_abs_err {max_abs:.3e} max_err/scale {worst:.3e}, '
              f'{n_out} elements outside rtol {GRAD_RTOL} / atol {GRAD_ATOL} '
              f'x max(1, |grad|max) {"ok" if v.ok else "MISMATCH"} with '
              f'{zeroed}; {v.full_outside} elements outside with none '
              f'zeroed; kernel {ms:.4f} ms{previous_note(rec, mode)}, plain '
              f'{plain_ms:.4f} ms, bound {max(t_ops, t_bytes):.4f} ms by '
              f'{"operations" if t_ops >= t_bytes else "bytes"} '
              f'({flops / 1e9:.3f} GFLOP, {moved / 1e6:.2f} MB; all-FP32 '
              f'bound of 3x the forward {max(t_fp32, t_bytes):.4f} ms)',
              flush=True)
        check(v.ok, f'{name}[{mode}] backward disagrees with plain autograd: '
              f'{v.message}')
        r = results.setdefault(rec, dict(err=0.0, modes=[]))
        r['err'] = max(r['err'], max_abs)
        r['modes'].append((ms, plain_ms, t_ops, t_bytes, t_fp32))
    return results


@contextlib.contextmanager
def table_roundings(rec, like=None):
    """Records in rec['calls'], for each gather_table call (one per edge
    call with pallas_gather_bf16), what its source table rounds to bf16:
    the float32 h and x in the forward, and the cotangents of h_src and
    x_src (those that need one) in the backward. With `like` (another run's
    record of the same calls), every such element that lies within GRAD_RTOL
    of like's but rounds to another bf16 value (a flip) takes like's value
    before the rounding (in the forward straight through, the gradient
    unchanged), so the two runs round alike; rec['flips'] counts those
    elements, forward and backward."""
    from decompdiff_tpu_torch.models import uni_transformer_bond as tutb
    from decompdiff_tpu_torch.utils.gradcheck import GRAD_RTOL
    orig = tutb.gather_table
    rec.update(calls=[], flips=[0, 0])

    def matched(v, ref, phase):
        flip = ((v.bfloat16() != ref.bfloat16())
                & ((v - ref).abs() <= GRAD_RTOL * ref.abs()))
        rec['flips'][phase] += int(flip.sum())
        return ref.where(flip, v)

    def recording(h, x):
        i = len(rec['calls'])
        vals = {'h': h.detach().clone(), 'x': x.detach().clone()}
        rec['calls'].append(vals)
        if like is not None:
            ref = like['calls'][i]
            h, x = (t + (matched(t.detach(), ref[k], 0) - t.detach())
                    for k, t in (('h', h), ('x', x)))
        tables = orig(h, x)

        def hook(g, key):
            vals[key] = g.detach().clone()
            return None if like is None else matched(
                g, like['calls'][i][key], 1)
        for key, t in zip(('h_src', 'x_src'), tables):
            if t.requires_grad:
                t.register_hook(lambda g, key=key: hook(g, key))
        return tables
    tutb.gather_table = recording
    try:
        yield
    finally:
        tutb.gather_table = orig


def train_phase(torch, batch, cfg, per_step, label, wrapped=False):
    """Training steps of `cfg` at the bench shapes, kernels on and off.
    per_step: the forward kernels' launches per step (each backward kernel
    launches as often as its forward). wrapped: kernels off is the kernel
    model under plain_versions (for an option the plain path does not
    read). Returns the launch counts of the kernel path."""
    from decompdiff_tpu_torch.training.train_step import (
        DEFAULT_TRAIN_CONFIG, create_train_state, make_train_fns)
    dev = torch.device('cuda')
    tcfg = DEFAULT_TRAIN_CONFIG
    ops = model_ops()
    models = dict(zip(('kernels', 'plain'), make_models(torch, cfg,
                                                        wrapped)))

    def plain_ctx(key):
        return (plain_versions(ops) if wrapped and key == 'plain'
                else contextlib.nullcontext())

    # one step's gradients from the same weights and the same draws; with
    # pallas_gather_bf16 also the witness: the plain path rounding its
    # source tables as the kernel path does wherever the two flip apart
    steps, tables = {}, {}
    runs = [('kernels', None), ('plain', None)]
    if wrapped:
        runs.append(('witness', 'kernels'))
    for key, like in runs:
        m = models['plain' if key == 'witness' else key]
        grad_step = make_train_fns(m, tcfg)[1]
        tables[key] = {}
        with plain_ctx('plain' if key == 'witness' else key), (
                table_roundings(tables[key], like and tables[like])
                if wrapped else contextlib.nullcontext()):
            steps[key] = grad_step(create_train_state(m, tcfg), batch,
                                   torch.Generator(device=dev).manual_seed(3))
    (g_on, m_on, t_on, _), (g_off, m_off, t_off, _) = (
        steps['kernels'], steps['plain'])
    check(torch.equal(t_on, t_off), 'the two paths drew different t')
    for key in m_off:
        a, b = float(m_on[key]), float(m_off[key])
        print(f'{label} train step kernels on vs off: {key} {a:.6f} vs '
              f'{b:.6f}', flush=True)
        check(abs(a - b) <= LOSS_RTOL * abs(b) + 1e-6,
              f'{key} differs with kernels on')
    norm_on = float(torch.sqrt(sum((g * g).sum() for g in g_on.values())))
    norm_off = float(torch.sqrt(sum((g * g).sum() for g in g_off.values())))
    worst_name, worst, outside, hit = '', 0.0, 0, 0
    for name, b in g_off.items():
        ok, _, rel, out_i = grad_close(torch, g_on[name], b, STEP_RTOL,
                                       STEP_ATOL)
        if wrapped:     # pallas_gather_bf16: bf16 flips admitted
            ok = bool(torch.isfinite(g_on[name]).all()) and rel <= FLIP_CAP
        if rel > worst:
            worst_name, worst = name, rel
        outside, hit = outside + out_i, hit + (out_i > 0)
        check(ok, f'gradient of {name} differs with kernels on (max_err/'
              f'scale {rel:.3e}, {out_i} elements outside)')
    flips, g_w = '', None
    if wrapped:
        g_w, w_worst, w_out = steps['witness'][0], 0.0, 0
        for name, b in g_w.items():
            rel, out_i = grad_close(torch, g_on[name], b, STEP_RTOL,
                                    STEP_ATOL)[2:]
            w_worst, w_out = max(w_worst, rel), w_out + out_i
        (fwd, bwd), n = tables['witness']['flips'], len(
            tables['witness']['calls'])
        print(f'{label} train step kernels on vs the plain path rounding its '
              f'{n} source tables as the kernels do at {fwd} forward and '
              f'{bwd} backward bf16 flips: {w_out} elements outside rtol '
              f'{STEP_RTOL} / atol {STEP_ATOL} x max(1, |grad|max); largest '
              f'max_err/scale {w_worst:.3e}', flush=True)
        check(outside <= FLIP_COUNT, f'{outside} gradient elements outside '
              f'the step tolerance, more than {FLIP_COUNT}')
        check(n > 0 and w_out == 0, 'the gradient elements outside the step '
              'tolerance are not explained by bf16 flips of the source '
              'tables')
        flips = (f'; {outside} elements of {hit} gradients outside it (at '
                 f'most {FLIP_COUNT} admitted: bf16 flips), each within '
                 f'{FLIP_CAP} x max(1, |grad|max)')
    del tables
    print(f'{label} train step kernels on vs off: grad_norm {norm_on:.6f} vs '
          f'{norm_off:.6f}; {len(g_off)} parameter gradients within rtol '
          f'{STEP_RTOL} / atol {STEP_ATOL} x max(1, |grad|max) elementwise'
          f'{flips}: largest max_err/scale {worst:.3e} ({worst_name})',
          flush=True)
    check(abs(norm_on - norm_off) <= STEP_RTOL * norm_off, 'grad_norm')
    del steps, g_on, g_off, g_w

    expect = {n: per_step.get(n.replace('_backward', ''), 0) * TRAIN_STEPS
              for n in get_launches(ops)}
    launches = {}
    for key, m in models.items():
        state = create_train_state(m, tcfg)
        step = make_train_fns(m, tcfg)[0]
        g = torch.Generator(device=dev).manual_seed(4)
        with plain_ctx(key):
            step(state, batch, g)                    # warm-up, not counted
            torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        # outside plain_ctx: it swaps the wrappers that hold the counters
        set_launches(ops, 0)
        t0 = time.perf_counter()
        with plain_ctx(key):
            for _ in range(TRAIN_STEPS):
                metrics = step(state, batch, g)
            torch.cuda.synchronize()
        elapsed = (time.perf_counter() - t0) / TRAIN_STEPS
        peak = torch.cuda.max_memory_allocated() / 2**20
        counts = get_launches(ops)
        print(f'{label} train path {key}: {TRAIN_STEPS} steps at '
              f'B={batch.batch_size} '
              f'Np={NUM_PROTEIN} Nl={NUM_LIGAND}: {elapsed:.4f} s/step, peak '
              f'device memory {peak:.1f} MiB; last step loss '
              f'{float(metrics["loss"]):.5f} grad_norm '
              f'{float(metrics["grad_norm"]):.5f}; launches {counts}',
              flush=True)
        check(all(bool(torch.isfinite(v)) for v in metrics.values()),
              f'non-finite training metrics ({key})')
        if key == 'kernels':
            launches = counts
            check(counts == expect, f'training launches differ from the '
                  f'expected {expect}')
        else:
            check(not any(counts.values()), 'the plain path launched kernels')
    return launches


SAMPLE_CFG = dict(
    num_steps=STEPS, save_traj=False,
    energy_drift=({'type': 'armsca_prox', 'min_d': 1.2, 'max_d': 1.9},
                  {'type': 'clash', 'sigma': 2.0, 'gamma': 4.0}))


def sample_counted(torch, model, batch, full_protein, per_call, label,
                   steps=STEPS):
    """`steps` guided steps with kernels on, every launch counter set to 0
    just before and read just after; checks the launches (per_call: each
    forward kernel's launches per denoiser call) and the samples. Returns
    (launches, initial state)."""
    from decompdiff_tpu_torch.sampling.sampler import (
        SampleConfig, sample_diffusion)
    ops = model_ops()
    cfg = dataclasses.replace(SampleConfig(**SAMPLE_CFG), num_steps=steps)
    dev = model.device
    g = torch.Generator(device=dev).manual_seed(1)
    centers, stds = batch.atom_prior_centers(), batch.atom_prior_stds()
    init_pos = centers + stds * torch.randn(centers.shape, generator=g,
                                            device=dev)
    init_v = model.atom_diff.sample_terminal(batch.ligand_v.shape, g).int()
    init_b = torch.where(
        batch.bond_mask,
        model.bond_diff.sample_terminal(batch.bond_type.shape, g), 0).int()

    # warm-up (library initialization), not counted
    sample_diffusion(model, dataclasses.replace(cfg, num_steps=1), batch,
                     init_pos, init_v, init_b, full_protein, generator=g)
    set_launches(ops, 0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = sample_diffusion(model, cfg, batch, init_pos, init_v, init_b,
                           full_protein, generator=g)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = get_launches(ops)

    expect = {n: per_call.get(n, 0) * steps for n in launches}
    nb = batch.batch_size
    print(f'{label} path: {steps} guided steps at B={nb} Np={NUM_PROTEIN} '
          f'Nl={NUM_LIGAND} Nf={NUM_FULL}: {elapsed / steps:.4f} s/step, '
          f'{elapsed / steps / nb:.5f} s/step/molecule; launches {launches} '
          f'(expected {expect})', flush=True)
    check(launches == expect, 'launch counts differ from the expected')
    check(out['pos'].shape == (nb, NUM_LIGAND, 3), 'pos shape')
    check(bool(torch.isfinite(out['pos']).all()), 'non-finite positions')
    check(bool(((out['v'] >= 0) & (out['v'] < 8)).all()), 'atom types')
    check(bool(((out['bond'] >= 0) & (out['bond'] < 5)).all()), 'bond types')
    check(bool((out['bond'][~batch.bond_mask] == 0).all()), 'masked bonds')
    return launches, (init_pos, init_v, init_b)


def path_phase(torch, model, plain_model, batch, full_protein, per_call,
               label):
    """Guided sampling with kernels on (launches counted) and with plain
    versions, then one denoiser call kernels on vs off. Returns the
    launches."""
    from decompdiff_tpu_torch.sampling.sampler import (
        SampleConfig, sample_diffusion)
    launches, state = sample_counted(torch, model, batch, full_protein,
                                     per_call, label)
    # the same steps with every kernel replaced by its plain version
    g = torch.Generator(device=model.device).manual_seed(1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sample_diffusion(plain_model, SampleConfig(**SAMPLE_CFG), batch, *state,
                     full_protein, generator=g)
    torch.cuda.synchronize()
    plain_elapsed = time.perf_counter() - t0
    print(f'{label} path with plain versions: '
          f'{plain_elapsed / STEPS:.4f} s/step', flush=True)
    denoiser_on_off(torch, model, plain_model, batch, state, label)
    return launches


def bf16_path_phase(torch, model, cfg, batch, full_protein, per_call):
    """Guided sampling with pallas_bf16 (the triplet kernel's bf16 option),
    launches counted; then one denoiser call against the float32 kernels of
    `model` (same weights): the option's cost, printed. Returns the
    launches."""
    from decompdiff_tpu_torch.models.diffusion_model import DecompDiffModel
    bf16 = DecompDiffModel.create(dict(cfg, use_pallas=True, pallas_bf16=True),
                                  8, device=model.device, seed=0)
    bf16.denoiser.load_state_dict(model.denoiser.state_dict())
    per_call = dict(per_call, triplet_attention_bf16=per_call[
        'triplet_attention'], triplet_attention=0)
    launches, state = sample_counted(torch, bf16, batch, full_protein,
                                     per_call, 'uni_o2_bond[bf16]')
    t = torch.full((B,), model.num_timesteps - 1, dtype=torch.long,
                   device=model.device)
    with torch.no_grad():
        got, want = bf16.apply(batch, *state, t), model.apply(batch, *state, t)
    for key in want:
        check(bool(torch.isfinite(got[key]).all()), f'non-finite {key}')
        print(f'uni_o2_bond[bf16] denoiser against the float32 kernels: '
              f'{key} max_abs_diff '
              f'{float((got[key] - want[key]).abs().max()):.3e}', flush=True)
    return launches


def gather_path_phase(torch, model, cfg, batch, full_protein, per_call):
    """Guided sampling with pallas_gather_bf16 (the edge kernels read the
    sources from x_src), launches counted; then one denoiser call against
    the same model under plain_versions (kernels on vs off), and its
    distance from the float32 kernels of `model` (same weights) printed.
    Returns the launches."""
    from decompdiff_tpu_torch.models.diffusion_model import DecompDiffModel
    gather = DecompDiffModel.create(
        dict(cfg, use_pallas=True, pallas_gather_bf16=True), 8,
        device=model.device, seed=0)
    gather.denoiser.load_state_dict(model.denoiser.state_dict())
    per_call = dict(per_call, edge_attention_gather=per_call[
        'edge_attention'], edge_attention=0)
    label = 'uni_o2_bond[gather_bf16]'
    launches, state = sample_counted(torch, gather, batch, full_protein,
                                     per_call, label)
    denoiser_on_off(torch, gather, gather, batch, state, label,
                    plain_ctx=lambda: plain_versions(model_ops()))
    t = torch.full((B,), model.num_timesteps - 1, dtype=torch.long,
                   device=model.device)
    with torch.no_grad():
        got, want = gather.apply(batch, *state, t), model.apply(batch, *state,
                                                                t)
    for key in want:
        print(f'{label} denoiser against the float32 kernels: {key} '
              f'max_abs_diff {float((got[key] - want[key]).abs().max()):.3e}',
              flush=True)
    return launches


def denoiser_on_off(torch, model, plain_model, batch, state, label,
                    plain_ctx=contextlib.nullcontext):
    """One denoiser call at the last timestep, kernels on vs off (the plain
    model's call made under plain_ctx())."""
    t = torch.full((batch.batch_size,), model.num_timesteps - 1,
                   dtype=torch.long, device=model.device)
    with torch.no_grad():
        on = model.apply(batch, *state, t)
        with plain_ctx():
            off = plain_model.apply(batch, *state, t)
    for key in on:
        err = float((on[key] - off[key]).abs().max())
        ok = bool(torch.allclose(on[key], off[key], rtol=PATH_RTOL,
                                 atol=PATH_ATOL))
        print(f'{label} denoiser kernels on vs off: {key} max_abs_err '
              f'{err:.3e} (rtol {PATH_RTOL}, atol {PATH_ATOL}) '
              f'{"ok" if ok else "MISMATCH"}', flush=True)
        check(bool(torch.isfinite(on[key]).all()), f'non-finite {key}')
        check(ok, f'{label} denoiser {key} differs with kernels on')


def width_phase(torch, bond_cfg, batch, widths, suffix):
    """uni_o2_bond at each of `widths` (kernel and plain models, seed 0):
    the inputs of the first layer's edge, bond and triplet calls, as the
    records <kernel><suffix> with modes 'H<width> node' / 'pos'. Returns
    (captured, {width: (cfg, models)})."""
    ops = model_ops()
    captured, models = {}, {}
    t = torch.zeros((batch.batch_size,), dtype=torch.long, device='cuda')
    state = (batch.ligand_pos, batch.ligand_v, batch.bond_type, t)
    for H, heads in widths:
        cfg = dict(bond_cfg, hidden_dim=H, n_heads=heads)
        models[H] = cfg, make_models(torch, cfg)
        for (name, mode), call in capture_inputs(torch, ops, models[H][1][1],
                                                 batch, state).items():
            captured[(f'{name}{suffix}', f'H{H} {mode}')] = call
    return captured, models


def row_calls(per_call):
    """per_call with each kernel's forward launches also in its per-row
    counter."""
    return dict(per_call, **{f'{n}_row': c for n, c in per_call.items()})


def width_path_phase(torch, models, batch, full_protein, per_call):
    """WIDTH_STEPS guided steps of each width's kernel model, launches
    counted (the forwards also in their per-row counters), and one denoiser
    call kernels on vs off. Returns the launches summed over the widths."""
    per_call = row_calls(per_call)
    total = {}
    for H, (cfg, (model, plain)) in models.items():
        label = f'uni_o2_bond[H{H}]'
        launches, state = sample_counted(torch, model, batch, full_protein,
                                         per_call, label, WIDTH_STEPS)
        denoiser_on_off(torch, model, plain, batch, state, label)
        for n, c in launches.items():
            total[n] = total.get(n, 0) + c
    return total


def width_option_phase(torch, models, batch, full_protein, per_call):
    """WIDTH_STEPS guided steps at each width (the models' weights) with
    pallas_bf16 and pallas_gather_bf16: every triplet forward launch is the
    per-row kernel's bf16 option, every edge launch the per-row kernel with
    an x_src; launches counted. Returns the launches summed over the
    widths."""
    from decompdiff_tpu_torch.models.diffusion_model import DecompDiffModel
    expect = dict(per_call, **{f'{n}_row': c for n, c in per_call.items()},
                  triplet_attention_bf16=per_call['triplet_attention'],
                  triplet_attention=0,
                  edge_attention_gather=per_call['edge_attention'],
                  edge_attention=0)
    total = {}
    for H, (cfg, (model, _)) in models.items():
        opt = DecompDiffModel.create(
            dict(cfg, use_pallas=True, pallas_bf16=True,
                 pallas_gather_bf16=True), 8, device=model.device, seed=0)
        opt.denoiser.load_state_dict(model.denoiser.state_dict())
        launches = sample_counted(torch, opt, batch, full_protein, expect,
                                  f'uni_o2_bond[H{H} bf16 gather_bf16]',
                                  WIDTH_STEPS)[0]
        del opt
        for n, c in launches.items():
            total[n] = total.get(n, 0) + c
    return total


def kernel_records(results, launches):
    """One record per kernel for the kernels JSON line. Per launch: edge and
    bond run their node and pos modes equally often on both paths (once each
    per layer), so a kernel's ms, plain_ms and bound_ms are the means over
    its modes, and launches * ms is its time on the path. `launches` is the
    count on the path that runs the kernel: sampling for the forward
    kernels (with pallas_bf16 for the triplet's bf16 record, with
    pallas_gather_bf16 for the gather record, the width paths for the
    per-row records), training for the backward ones. bound_fp32_ms: the
    bound with every operation at the FP32 CUDA-core peak, as PRs 1-3 gave
    it."""
    kernels = []
    for name, r in results.items():
        ms, plain_ms, t_ops, t_bytes, t_fp32 = (
            sum(col) / len(r['modes']) for col in zip(*r['modes']))
        base = op_name(name.replace('_backward', ''))
        kernels.append({
            'name': name, 'route': 'cuda',
            'source': f'decompdiff_tpu_torch/csrc/{base}.cu',
            'replaces': KERNEL_SOURCES[name],
            'launches': launches[name],
            'max_abs_err': r['err'],
            'ms': ms, 'plain_ms': plain_ms,
            'bound_ms': max(t_ops, t_bytes),
            'bound_by': 'operations' if t_ops >= t_bytes else 'bytes',
            'bound_fp32_ms': max(t_fp32, t_bytes),
            # no single PyTorch call computes these fused MLP attentions or
            # their gradients
            'library_ms': None,
        })
    return kernels


def model_ops():
    from decompdiff_tpu_torch.ops import (
        bond_attention, edge_attention, triplet_attention)
    return {'edge_attention': edge_attention,
            'bond_attention': bond_attention,
            'triplet_attention': triplet_attention}


def ops_module(rec):
    """The ops module of a kernel record name."""
    return model_ops()[op_name(rec).replace('_backward', '')]


def launch_counters(ops):
    """{record name: (wrapper, counter attribute)} of every forward and
    backward kernel; the m-gated and gather edge launches and the triplet's
    bf16 launches have counters of their own; the per-row forward launches
    (any mode) count in their per-row counters as well, the per-row
    backward launches (every width but 32, 64, 128, or outside a head
    route's heads and sources) in <kernel>_backward_row, and the backward
    launches with the row buffers in device memory in
    <kernel>_backward_wide (scratch_launches)."""
    counters = {}
    for name, mod in ops.items():
        for n in (name, f'{name}_backward'):
            counters[n] = (getattr(mod, n), 'launches')
            if name == 'edge_attention':
                for rec, attr in (('mgate', 'gated_launches'),
                                  ('gather', 'gather_launches')):
                    counters[n.replace(name, f'{name}_{rec}')] = (
                        getattr(mod, n), attr)
        if name == 'triplet_attention':
            counters[f'{name}_bf16'] = (getattr(mod, name), 'bf16_launches')
        counters[f'{name}_row'] = (getattr(mod, name), 'row_launches')
        counters[f'{name}_backward_wide'] = (getattr(mod, f'{name}_backward'),
                                             'scratch_launches')
        counters[f'{name}_backward_row'] = (
            getattr(mod, f'{name}_backward'), 'row_launches')
    return counters


def set_launches(ops, value):
    """Sets the launch count of every forward and backward kernel."""
    for fn, attr in launch_counters(ops).values():
        setattr(fn, attr, value)


def get_launches(ops):
    return {n: getattr(fn, attr)
            for n, (fn, attr) in launch_counters(ops).items()}


def make_models(torch, cfg, wrapped=False):
    """The kernel and plain models of cfg, with the same weights (seed 0).
    wrapped: the plain model is a kernel model too, to be run under
    plain_versions."""
    from decompdiff_tpu_torch.models.diffusion_model import DecompDiffModel
    dev = torch.device('cuda')
    model = DecompDiffModel.create(dict(cfg, use_pallas=True), 8, device=dev,
                                   seed=0)
    plain = DecompDiffModel.create(dict(cfg, use_pallas=wrapped), 8,
                                   device=dev, seed=0)
    plain.denoiser.load_state_dict(model.denoiser.state_dict())
    return model, plain


def main():
    try:
        import numpy as np
        import torch
    except ImportError as e:
        print(f'chip_smoke: {e}', file=sys.stderr)
        return 2
    try:
        device_phase(torch)
        sys.path.insert(0, str(REPO))
        build_phase()

        from decompdiff_tpu_torch.data.batch import FullProtein
        from decompdiff_tpu_torch.utils.testing import (
            DEFAULT_MODEL_CONFIG, random_complex_batch, uni_o2_model_config)
        dev = torch.device('cuda')
        rng = np.random.default_rng(0)
        batch = random_complex_batch(
            rng, batch_size=B, num_protein=NUM_PROTEIN, num_ligand=NUM_LIGAND,
            num_groups=NUM_GROUPS, device=dev)
        full_protein = FullProtein(
            pos=torch.as_tensor(rng.normal(size=(B, NUM_FULL, 3)) * 8,
                                dtype=torch.float32, device=dev),
            mask=torch.ones((B, NUM_FULL), dtype=torch.bool, device=dev))
        width_batch = random_complex_batch(
            np.random.default_rng(1), batch_size=WIDTH_B,
            num_protein=NUM_PROTEIN, num_ligand=NUM_LIGAND,
            num_groups=NUM_GROUPS, device=dev)
        width_full = FullProtein(full_protein.pos[:WIDTH_B],
                                 full_protein.mask[:WIDTH_B])
        bond_cfg, o2_cfg = DEFAULT_MODEL_CONFIG, uni_o2_model_config()
        model, plain_model = make_models(torch, bond_cfg)
        o2_model, o2_plain = make_models(torch, o2_cfg)
        gather_cfg = dict(bond_cfg, pallas_gather_bf16=True)
        gather_model = make_models(torch, gather_cfg)[0]

        ops = model_ops()
        t = torch.zeros((B,), dtype=torch.long, device=dev)
        state = (batch.ligand_pos, batch.ligand_v, batch.bond_type, t)
        captured = capture_inputs(torch, ops, plain_model, batch, state)
        o2_modes = capture_inputs(torch, ops, o2_plain, batch, state)
        captured[('edge_attention_mgate', 'node')] = o2_modes[
            ('edge_attention_mgate', 'node')]
        # the gather modes: the kernel model's calls, plain versions run
        gather_modes = capture_inputs(torch, ops, gather_model, batch, state,
                                      wrapped=True)
        for mode in ('node', 'pos'):
            key = ('edge_attention_gather', mode)
            captured[key] = gather_modes[key]
        width_modes, width_models = width_phase(torch, bond_cfg, width_batch,
                                                WIDTHS, '_row')
        captured.update(width_modes)
        with torch.no_grad():
            results = kernel_phase(torch, captured)
        results.update(backward_phase(torch, ops, captured))
        # the per-row backward kernels at WIDTHS (printed only)
        backward_phase(torch, ops, width_modes, rows=True)
        del captured, o2_modes, gather_modes, width_modes, gather_model
        # the WIDE backward records after the others, so that their models
        # and inputs do not change the device memory those run in
        wide_modes, wide_models = width_phase(torch, bond_cfg, width_batch,
                                              (WIDE,), '_wide')
        wide_cfg = wide_models.pop(WIDE[0])[0]
        results.update(backward_phase(torch, ops, wide_modes))
        del wide_modes, wide_models

        # forward launches per denoiser call; the m-gate runs in x2h only
        layers = bond_cfg['num_layers'] * bond_cfg['num_blocks']
        bond_calls = {'edge_attention': 2 * layers,
                      'bond_attention': 2 * layers,
                      'triplet_attention': layers}
        o2_layers = o2_cfg['num_layers'] * o2_cfg['num_blocks']
        o2_calls = {'edge_attention': o2_layers,
                    'edge_attention_mgate': o2_layers}
        sample_launches = path_phase(torch, model, plain_model, batch,
                                     full_protein, bond_calls, 'uni_o2_bond')
        bf16_launches = bf16_path_phase(torch, model, bond_cfg, batch,
                                        full_protein, bond_calls)
        gather_launches = gather_path_phase(torch, model, bond_cfg, batch,
                                            full_protein, bond_calls)
        width_launches = width_path_phase(torch, width_models, width_batch,
                                          width_full, bond_calls)
        width_option_launches = width_option_phase(
            torch, width_models, width_batch, width_full, bond_calls)
        del width_models
        o2_sample_launches = path_phase(torch, o2_model, o2_plain, batch,
                                        full_protein, o2_calls, 'uni_o2[m]')
        del model, plain_model, o2_model, o2_plain
        for ew in ('global', 'r'):
            on, off = make_models(torch, dict(o2_cfg, ew_net_type=ew))
            denoiser_on_off(torch, on, off, batch, state[:3], f'uni_o2[{ew}]')
            del on, off
        train_launches = train_phase(torch, batch, bond_cfg, bond_calls,
                                     'uni_o2_bond')
        gather_train_launches = train_phase(
            torch, batch, gather_cfg,
            dict(bond_calls, edge_attention_gather=bond_calls[
                'edge_attention'], edge_attention=0),
            'uni_o2_bond[gather_bf16]', wrapped=True)
        o2_train_launches = train_phase(torch, batch, o2_cfg, o2_calls,
                                        'uni_o2[m]')
        # at WIDE every forward runs its per-row kernel and every backward
        # launch keeps its row buffers in device memory
        wide_train_launches = train_phase(
            torch, width_batch, wide_cfg,
            dict(row_calls(bond_calls),
                 **{f'{n}_wide': c for n, c in bond_calls.items()}),
            f'uni_o2_bond[H{WIDE[0]}]')
        # last, so that their large models and float64 checks do not change
        # the device memory the paths run in
        for width in WIDER:
            backward_phase(torch, ops, width_phase(
                torch, bond_cfg, width_batch, (width,), '_wide')[0])
    except SmokeFailure as e:
        print(f'chip_smoke: FAILED: {e}', file=sys.stderr)
        return 1

    # each kernel's launches on the path that runs it: the m-gated ones on
    # the uni_o2 paths, the triplet's bf16 one on the pallas_bf16 sampling
    # path, the gather ones on the pallas_gather_bf16 paths, the per-row
    # ones on the width paths (their bf16 and gather variants on the width
    # paths with both options), the wide backward ones on the WIDE training
    # path, the others on the uni_o2_bond paths
    launches = {}
    for n in results:
        if n in ('triplet_attention_row_bf16', 'edge_attention_row_gather'):
            launches[n] = width_option_launches[n.replace('_row', '')]
            continue
        sampled, trained = ((o2_sample_launches, o2_train_launches)
                            if '_mgate' in n else
                            (gather_launches, gather_train_launches)
                            if '_gather' in n else
                            (sample_launches, train_launches))
        if n.endswith('_bf16'):
            sampled = bf16_launches
        if n.endswith('_row'):
            sampled = width_launches
        if n.endswith('_wide'):
            trained = wide_train_launches
        launches[n] = (trained if '_backward' in n else sampled)[n]
    print(json.dumps({'kernels': kernel_records(results, launches)}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
