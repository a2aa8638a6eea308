#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (decompdiff_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # from the root of a repository checkout

1. Device: requires CUDA, turns TF32 off, prints the card's name and power
   limit (nvidia-smi).
2. Build: compiles the three CUDA sources of csrc/ (each holds a forward and
   a backward kernel) with nvcc (timed set-up).
2a. Entry point: the sampling driver (decompdiff_tpu_torch/sampling/
   driver.py, the port of scripts/sample.py) as a user runs it, on a
   synthetic store of two ~320-atom pockets, from a JAX-layout checkpoint
   of the seeded released uni_o2_bond model, with the kernels, B=8, 8
   molecules per pocket and STEPS strided guided steps: launches counted
   (exactly calls x 12/12/6 forward, nothing else), result pickles checked,
   seconds per molecule printed split into host set-up, device sampling
   and reconstruction.
2b. Training entry point: the training driver (decompdiff_tpu_torch/
   training/driver.py, the port of scripts/train.py) as a user runs it,
   with configs/training.yml's settings (TRAIN_CONFIG: the released model,
   the kernels, batch 4) on a synthetic store of TRAIN_POCKETS (ligands
   padding to Nl=32 and to Nl=64), TRAIN_ITERS iterations with validation
   every TRAIN_VAL_FREQ, then RESUME_ITERS more resumed from the last
   checkpoint: launches counted per run (forwards per step and per
   validation call, backwards per step, the triplet backward on its head
   route at every Nl, its Nl=64 launches counted apart, no per-row launch,
   nothing else), losses finite, parameters moved, every checkpoint in the
   JAX layout and read back by the sampler's reader with the trained
   parameters, the resume at the next iteration with the saved learning
   rate, scheduler and Adam step count; seconds per step split into loader
   wait, step and validation, the first step's set-up, checkpoint seconds
   and peak device memory printed. Then
   every kernel at the trainer's shapes (B=4, Nl=24, 32 and 64): each
   forward against its plain version and each backward against plain
   autograd, printed, the triplet backward at Nl=64 (head route, d t_src
   in device memory) timed as the record triplet_attention_backward_nl64.
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
   per-row edge, bond and triplet backward at WIDTHS (printed only, but
   the triplet's at H=96: the record triplet_attention_backward_row), and
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
import pickle
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
B, NUM_PROTEIN, NUM_LIGAND, NUM_FULL, NUM_GROUPS = 8, 320, 32, 2048, 6
STEPS = 20          # sampling steps
# the sampling entry point (decompdiff_tpu_torch/sampling/driver.py) on a
# synthetic store of ENTRY_POCKETS pockets (protein atoms, ligand atoms,
# arms), ENTRY_SAMPLES molecules each at batch B, STEPS strided steps (1000
# in configs/sampling.yml)
ENTRY_POCKETS = ((320, 28, 3), (312, 26, 3))
ENTRY_SAMPLES = 8
# configs/sampling.yml's sample section, built here so that the script
# needs no PyYAML
ENTRY_SAMPLE_CFG = {
    'seed': 2021, 'prior_mode': 'ref_prior', 'num_samples': ENTRY_SAMPLES,
    'num_steps': STEPS, 'skip_mode': 'strided', 'center_pos_mode': 'protein',
    'sample_num_atoms': 'prior', 'arms_num_atoms_config': 'arm_num_config',
    'scaffold_num_atoms_config': 'scaffold_num_config',
    'energy_drift': [{'type': 'armsca_prox', 'min_d': 1.2, 'max_d': 1.9},
                     {'type': 'clash', 'sigma': 2, 'gamma': 4}]}
# the keys of a result pickle and of each of its rows (scripts/sample.py)
RESULT_KEYS = {'data_id', 'results', 'atom_mode', 'config'}
ROW_KEYS = {'pred_pos', 'pred_v', 'pred_bond', 'decomp_mask', 'mol',
            'smiles', 'complete', 'ligand_filename', 'src_protein_filename',
            'protein_path'}
# the training entry point (decompdiff_tpu_torch/training/driver.py) on a
# synthetic store of TRAIN_POCKETS (protein atoms, ligand atoms, arms): the
# first eleven train, the last validates (the JAX script's last 10%); the
# 24-30 atom ligands pad to Nl=32, the 52-58 atom ones to Nl=64, where the
# triplet backward takes its per-row kernel (the head route stops at 48)
TRAIN_POCKETS = ((312, 28, 3), (305, 26, 3), (318, 55, 3), (300, 30, 3),
                 (316, 24, 3), (309, 27, 3), (320, 58, 3), (303, 29, 3),
                 (311, 25, 3), (307, 52, 3), (314, 28, 3), (320, 26, 3))
TRAIN_ITERS, TRAIN_VAL_FREQ, RESUME_ITERS = 20, 10, 5
# configs/training.yml, built here so that the script needs no PyYAML
# (tests/test_torch_train_driver.py holds the two equal), its data.path
# set per run and its data.split dropped (no split file: the last 10%)
TRAIN_CONFIG = {
    'data': {'name': 'pl', 'path': None, 'mode': 'full',
             'prior_mode': 'ref_prior',
             'transform': {'ligand_atom_mode': 'basic',
                           'ligand_bond_mode': 'fc', 'max_num_arms': 10,
                           'random_rot': False}},
    'model': {'model_mean_type': 'C0', 'beta_schedule': 'sigmoid',
              'beta_start': 1.0e-7, 'beta_end': 2.0e-3,
              'v_beta_schedule': 'cosine', 'v_beta_s': 0.01,
              'num_diffusion_timesteps': 1000, 'loss_pos_type': 'mse',
              'sample_time_method': 'symmetric', 'bond_diffusion': True,
              'bond_net_type': 'lin', 'num_bond_classes': 5,
              'prior_types': False, 'h_node_in_bond_net': True,
              'add_prior_node': False, 'time_emb_dim': 0,
              'time_emb_mode': 'simple', 'center_pos_mode': 'protein',
              'node_indicator': True, 'model_type': 'uni_o2_bond',
              'num_blocks': 1, 'num_layers': 6, 'hidden_dim': 128,
              'n_heads': 16, 'edge_feat_dim': 4, 'num_r_gaussian': 20,
              'knn': 32, 'act_fn': 'relu', 'norm': True,
              'cutoff_mode': 'knn', 'r_max': 10.0, 'x2h_out_fc': False,
              'sync_twoup': False, 'use_global_ew': True,
              'use_pallas': True},
    'train': {'seed': 2021,
              'loss_weights': {'pos': 1.0, 'v': 100.0, 'bond': 100.0},
              'batch_size': 4, 'n_acc_batch': 1, 'max_iters': 500000,
              'val_freq': 2000, 'pos_noise_std': 0.1,
              'prior_noise_std': 0.5, 'max_grad_norm': 8.0,
              'optimizer': {'type': 'adam', 'lr': 5.0e-4, 'weight_decay': 0,
                            'beta1': 0.95, 'beta2': 0.999},
              'scheduler': {'type': 'plateau', 'factor': 0.6,
                            'patience': 10, 'min_lr': 1.0e-6}},
}
# the keys of a checkpoint (decompdiff_tpu/utils/checkpoint.py)
CKPT_KEYS = {'config', 'params', 'opt_state', 'step', 'lt_history',
             'lt_count', 'scheduler', 'iteration', 'extra'}
# the kernels at the training entry point's shapes: B and groups of its
# batches, and per bucket its store pads to, (Nl, real ligand atoms); the
# triplet backward's head route takes Nl up to TRIPLET_HEAD_NL (the top of
# the ligand ladder, data/collate.py), and above it the per-row kernel runs
TRAIN_B, TRAIN_GROUPS = 4, 4
TRAIN_SHAPES = ((24, 24), (32, 30), (64, 56))
TRIPLET_HEAD_NL = 64
TOP_RECORD = f'triplet_attention_backward_nl{TRIPLET_HEAD_NL}'
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
    'triplet_attention_backward_row':
        'decompdiff_tpu/ops/pallas/triplet_kernel.py:371',
    'triplet_attention_backward_nl64':
        'decompdiff_tpu/ops/pallas/triplet_kernel.py:371',
    'edge_attention_mgate_backward':
        'decompdiff_tpu/ops/pallas/edge_kernel.py:568',
}
# Each kernel mode's ms as this script measured it on the per-row
# CUDA-core kernel, before that kernel's redesign (the forwards onto the
# tensor cores, the triplet, edge and bond backward head-factorized;
# PERF.md kernel table, NVIDIA H100 80GB HBM3, 700 W; the edge and bond
# backward's from the last runs of their per-row kernels at these shapes,
# the triplet backward's at B=4, Nl=64 from the per-row kernel's three
# runs there), printed beside this run's.
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
    ('triplet_attention_backward_nl64', 'node B4 Nl64'): '38.9353-39.3584',
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
    print(gpu_name_and_limit(), flush=True)
    print(f'torch {torch.__version__} cuda {torch.version.cuda} '
          f'device {torch.cuda.get_device_name(0)}', flush=True)


def nonzero(counts):
    return {n: c for n, c in counts.items() if c}


def gpu_name_and_limit():
    """The card's name and power limit, as nvidia-smi prints them."""
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0 and smi.stdout.strip(),
          f'nvidia-smi failed: {smi.stderr.strip()}')
    return smi.stdout.strip().splitlines()[0]


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


RECORD_SUFFIXES = ('_mgate', '_bf16', '_gather', '_row', '_wide', '_nl64')


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
    kernel is per-row outside H in 32, 64, 128); the _wide and _nl64 modes
    give the <kernel>_backward_wide and <kernel>_backward_nl64 records."""
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
        suffix = next((x for x in ('_wide', '_nl64') if name.endswith(x)),
                      None)
        rec = (f'{op}_backward{suffix}' if suffix
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
        zero_launches(ops)
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
    zero_launches(ops)
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


def entry_phase(torch, per_call):
    """The sampling entry point as a user runs it: a synthetic pocket store
    (ENTRY_POCKETS), a JAX-layout .ckpt of the seeded released uni_o2_bond
    model (config and params, no optimizer state), and the driver with
    ENTRY_SAMPLE_CFG, --use_pallas, B=8, -i 0 1, every launch counter set
    to 0 just before and read just after. Checks the launches (no per-row
    or other launch) and the result pickles; prints seconds per molecule
    split into host set-up, device sampling and reconstruction. Returns the
    launches."""
    import pickle
    import shutil

    import numpy as np

    from decompdiff_tpu_torch.config import Config
    from decompdiff_tpu_torch.data.synthetic import write_synthetic_store
    from decompdiff_tpu_torch.models.diffusion_model import DecompDiffModel
    from decompdiff_tpu_torch.sampling import driver
    from decompdiff_tpu_torch.utils.params import state_dict_to_flax
    from decompdiff_tpu_torch.utils.testing import DEFAULT_MODEL_CONFIG
    work = REPO / 'build' / 'entry_phase'
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    try:
        store = work / 'synthetic.ddstore'
        write_synthetic_store(str(store), [
            dict(n_protein=n_p, n_ligand=n_l, num_arms=arms)
            for n_p, n_l, arms in ENTRY_POCKETS])
        cfg = dict(DEFAULT_MODEL_CONFIG)
        seeded = DecompDiffModel.create(cfg, 8, device='cpu', seed=0)
        ckpt = work / 'uni_o2_bond.ckpt'
        with open(ckpt, 'wb') as f:
            pickle.dump({'config': {'data': {'transform': {
                             'ligand_atom_mode': 'basic'}}, 'model': cfg},
                         'params': state_dict_to_flax(
                             seeded.denoiser.state_dict()),
                         'step': 0, 'iteration': 0}, f, protocol=4)
        ids = [str(i) for i in range(len(ENTRY_POCKETS))]
        args = driver.build_parser().parse_args(
            ['configs/sampling.yml', '--ckpt', str(ckpt), '-i', *ids,
             '--outdir', str(work / 'out'), '--batch_size', str(B),
             '--use_pallas'])
        config = Config({'data': {'path': str(store)},
                         'sample': ENTRY_SAMPLE_CFG})
        ops = model_ops()
        zero_launches(ops)
        t0 = time.perf_counter()
        summaries = driver.run(args, config)
        elapsed = time.perf_counter() - t0
        launches = get_launches(ops)

        calls = sum(len(s['shapes']) for s in summaries) * STEPS
        expect = {n: per_call.get(n, 0) * calls for n in launches}
        shapes = sorted({sh for s in summaries for sh in s['shapes']})
        print(f'entry point path: {len(summaries)} pockets x '
              f'{ENTRY_SAMPLES} molecules, batches {shapes} (B, Np, Nl), '
              f'{STEPS} strided guided steps: {calls} denoiser calls, '
              f'launches {nonzero(launches)} (expected {nonzero(expect)}, '
              f'every other counter 0)', flush=True)
        check(launches == expect,
              'entry point launch counts differ from the expected')
        n_mol = sum(s['n'] for s in summaries)
        n_recon = sum(s['n_recon'] for s in summaries)
        n_complete = sum(s['n_complete'] for s in summaries)
        for s in summaries:
            payload = driver.load_result(s['path'])
            check(set(payload) == RESULT_KEYS, f'result keys {set(payload)}')
            rows = payload['results']
            check(len(rows) == ENTRY_SAMPLES, f'{len(rows)} result rows')
            for r in rows:
                check(ROW_KEYS <= set(r) and ('sdf' in r or 'recon_error' in r),
                      f'result row keys {sorted(r)}')
                n = len(r['pred_v'])
                check(r['pred_pos'].shape == (n, 3)
                      and r['pred_bond'].shape == (n, n)
                      and bool(np.isfinite(r['pred_pos']).all()),
                      'result predictions: shape or non-finite positions')
        host, dev, recon = (sum(s[k] for s in summaries)
                            for k in ('host_s', 'device_s', 'recon_s'))
        print(f'entry point: reconstructed {n_recon}/{n_mol}, complete '
              f'{n_complete}/{n_mol}', flush=True)
        print(f'entry point seconds per molecule ({n_mol} molecules, '
              f'{elapsed:.3f} s in all, checkpoint and store loading '
              f'included): {elapsed / n_mol:.5f}; host set-up '
              f'{host / n_mol:.5f}, device sampling {dev / n_mol:.5f}, '
              f'reconstruction {recon / n_mol:.5f}; per pocket (host, '
              f'device, recon s): '
              + ', '.join(f'{s["host_s"]:.4f}/{s["device_s"]:.4f}/'
                          f'{s["recon_s"]:.4f}' for s in summaries)
              + f' on {gpu_name_and_limit()}', flush=True)
        return launches
    finally:
        shutil.rmtree(work, ignore_errors=True)


def expected_train_launches(summary, per_call, names):
    """The launches a training run should make, from its summary: each
    forward per_call times per step and per validation call, each backward
    per_call times per step, the triplet backward's per-row kernel in the
    steps whose ligands pad above the head route's TRIPLET_HEAD_NL atoms
    (also counted in triplet_attention_backward; the ligand ladder ends
    there, so none), TOP_RECORD per_call times per step at TRIPLET_HEAD_NL
    atoms, every other counter 0."""
    steps = len(summary['batch_shapes'])
    calls = steps + len(summary['eval_shapes'])
    wide = sum(1 for shape in summary['batch_shapes']
               if shape[2] > TRIPLET_HEAD_NL)
    top = sum(1 for shape in summary['batch_shapes']
              if shape[2] == TRIPLET_HEAD_NL)
    expect = dict.fromkeys(names, 0)
    for n, c in per_call.items():
        expect[n] = c * calls
        expect[f'{n}_backward'] = c * steps
    expect['triplet_attention_backward_row'] = (
        per_call['triplet_attention'] * wide)
    expect[TOP_RECORD] = per_call['triplet_attention'] * top
    return expect


class NumpyOnlyUnpickler(pickle.Unpickler):
    """Resolves the classes of numpy, builtins and collections alone."""

    def find_class(self, module, name):
        check(module.split('.')[0] in ('numpy', 'builtins', 'collections'),
              f'a checkpoint names {module}.{name}')
        return super().find_class(module, name)


def train_entry_phase(torch, per_call):
    """The training entry point as a user runs it: TRAIN_CONFIG on a
    synthetic store of TRAIN_POCKETS, driver.run for TRAIN_ITERS
    iterations, then RESUME_ITERS more resumed from the last checkpoint,
    every launch counter set to 0 just before each run and read just after.
    Checks the launches (expected_train_launches), the losses, that the
    parameters moved, every checkpoint (the JAX keys, numpy and builtins
    only, and the sampler's reader rebuilding the file's parameters; for
    the checkpoint of a run's last iteration, the parameters of the model
    the run ends with) and the resume; prints the seconds and the peak
    device memory. The run's model is caught where the driver builds its
    train state, outside every timed span. Returns the launches of both
    runs summed (get_launches)."""
    import shutil

    import numpy as np

    from decompdiff_tpu_torch.config import Config
    from decompdiff_tpu_torch.data.synthetic import write_synthetic_store
    from decompdiff_tpu_torch.models.diffusion_model import DecompDiffModel
    from decompdiff_tpu_torch.training import driver
    from decompdiff_tpu_torch.utils.checkpoint import (
        load_model_from_checkpoint, read_checkpoint)
    from decompdiff_tpu_torch.utils.params import flax_to_state_dict
    work = REPO / 'build' / 'train_entry_phase'
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    # the model each run trains
    models = []
    create_train_state = driver.create_train_state

    def recording(model, cfg):
        models.append(model)
        return create_train_state(model, cfg)
    driver.create_train_state = recording
    label = gpu_name_and_limit()
    init = DecompDiffModel.create(TRAIN_CONFIG['model'], 8, device='cpu',
                                  seed=TRAIN_CONFIG['train']['seed'])
    n_checked = 0
    try:
        store = work / 'synthetic.ddstore'
        write_synthetic_store(str(store), [
            dict(n_protein=n_p, n_ligand=n_l, num_arms=arms)
            for n_p, n_l, arms in TRAIN_POCKETS])
        config = Config(dict(TRAIN_CONFIG, data=dict(TRAIN_CONFIG['data'],
                                                     path=str(store))))
        ops = model_ops()
        total, runs = {}, []
        for tag, iters in (('first', TRAIN_ITERS),
                           ('resumed', TRAIN_ITERS + RESUME_ITERS)):
            argv = ['configs/training.yml', '--outdir', str(work / 'logs'),
                    '--tag', tag, '--max_iters', str(iters), '--val_freq',
                    str(TRAIN_VAL_FREQ), '--report_freq', '5']
            if runs:
                argv += ['--resume', runs[-1]['checkpoints'][-1]]
            args = driver.build_parser().parse_args(argv)
            zero_launches(ops)
            t0 = time.perf_counter()
            summary = driver.run(args, config)
            elapsed = time.perf_counter() - t0
            launches = get_launches(ops)
            runs.append(summary)
            expect = expected_train_launches(summary, per_call, launches)
            shapes = {}
            for shape in summary['batch_shapes']:
                shapes[shape] = shapes.get(shape, 0) + 1
            print(f'train entry point ({tag}): iterations '
                  f'{summary["iterations"][0]}-{summary["iterations"][-1]}, '
                  f'{elapsed:.3f} s in all; steps per (B, Np, Nl, A) '
                  f'{shapes}, {len(summary["eval_shapes"])} validation '
                  f'calls; launches {nonzero(launches)} (expected '
                  f'{nonzero(expect)}, every other counter 0)', flush=True)
            check(launches == expect, f'train entry point ({tag}) launch '
                  'counts differ from the expected')
            for n, c in launches.items():
                total[n] = total.get(n, 0) + c
            model = models.pop()
            final = {k: v.detach().cpu()
                     for k, v in model.denoiser.state_dict().items()}
            del model
            if tag == 'first':
                check(any(not torch.equal(v, final[k]) for k, v in
                          init.denoiser.state_dict().items()),
                      'the parameters did not move')
            for path in summary['checkpoints']:
                with open(path, 'rb') as f:
                    raw = NumpyOnlyUnpickler(f).load()
                check(set(raw) == CKPT_KEYS, f'{path}: keys {sorted(raw)}')
                rebuilt, _ = load_model_from_checkpoint(path, device='cuda')
                want = flax_to_state_dict(raw['params'])
                if raw['iteration'] == summary['iterations'][-1]:
                    check(all(torch.equal(v, final[k])
                              for k, v in want.items()),
                          f'{path}: the file does not hold the trained '
                          'parameters')
                check(set(want) == set(rebuilt.denoiser.state_dict())
                      and all(torch.equal(v.cpu(), want[k]) for k, v in
                              rebuilt.denoiser.state_dict().items()),
                      f'{path}: the sampler reader does not give the '
                      'file\'s parameters')
                n_checked += 1
                del rebuilt
            losses = summary['train_loss'] + [v['loss']
                                              for v in summary['val']]
            check(len(summary['iterations']) == iters - summary['start_iter']
                  + 1 and bool(np.isfinite(losses).all()),
                  f'train entry point ({tag}): a step was skipped or a loss '
                  'is not finite')
            sec = summary['seconds']
            n = len(summary['iterations']) - 1
            by_shape = {}   # the steps after the first, by padded shape
            for shape, t in zip(summary['batch_shapes'][1:],
                                summary['step_seconds'][1:]):
                by_shape.setdefault(shape[2], []).append(t)
            print(f'train entry point ({tag}) seconds per training step '
                  f'(B=4, after the first): loader wait '
                  f'{sec["loader_wait"] / n:.5f}, step '
                  f'{sec["steps"] / n:.5f} ('
                  + ', '.join(f'Nl={nl}: {sum(ts) / len(ts):.5f} over '
                              f'{len(ts)}' for nl, ts in sorted(
                                  by_shape.items()))
                  + f'), validation {sec["validation"] / n:.5f} '
                  f'({sec["validation"] / len(summary["val"]):.3f} s per '
                  f'validation of '
                  f'{len(summary["eval_shapes"]) // len(summary["val"])} '
                  f'calls); first step '
                  f'{sec["first_step"]:.3f} s (set-up); checkpoints '
                  f'{sec["checkpoint"]:.3f} s for '
                  f'{len(summary["checkpoints"])}; peak device memory '
                  f'{summary["max_memory_allocated"] / 2**20:.1f} MiB; train '
                  f'loss {summary["train_loss"][0]:.4f} -> '
                  f'{summary["train_loss"][-1]:.4f}, validation '
                  + ', '.join(f'{v["iteration"]}: loss {v["loss"]:.4f} '
                              f'atom_auroc {v["atom_auroc"]:.4f} bond_auroc '
                              f'{v["bond_auroc"]:.4f}'
                              for v in summary['val'])
                  + f' on {label}', flush=True)
        first, resumed = runs
        check(first['checkpoints'][-1].endswith(f'{TRAIN_ITERS}.ckpt'),
              f'the first run did not save at iteration {TRAIN_ITERS}')
        saved = read_checkpoint(first['checkpoints'][-1])
        got = resumed['resumed']
        check(resumed['start_iter'] == TRAIN_ITERS + 1
              and resumed['iterations'][0] == TRAIN_ITERS + 1
              and got['lr'] == saved['opt_state']['lr']
              and got['scheduler'] == saved['scheduler']
              and got['adam_steps'] == [float(TRAIN_ITERS)]
              and got['step'] == saved['step'] == TRAIN_ITERS,
              f'the resume restored {got}, not the checkpoint')
        print(f'train entry point: {n_checked} checkpoints in the JAX '
              f'layout read back with the trained parameters; resumed at '
              f'iteration {resumed["start_iter"]} with lr {got["lr"]:.3e}, '
              f'scheduler {got["scheduler"]}, Adam steps {got["adam_steps"]}',
              flush=True)
        return total
    finally:
        driver.create_train_state = create_train_state
        shutil.rmtree(work, ignore_errors=True)


def train_shapes_phase(torch, ops, cfg):
    """Every kernel at the shapes the training entry point launches it at
    cfg's width: per bucket of TRAIN_SHAPES, the inputs of the first call
    of each kernel mode in a plain denoiser call at B=TRAIN_B,
    Np=NUM_PROTEIN, each forward held against its plain version and each
    backward against plain autograd, the mode labelled with B and Nl. At
    the largest bucket, Nl=TRIPLET_HEAD_NL, the triplet backward takes its
    head route (its launches counted, none per-row): that check and time
    is the record triplet_attention_backward_nl64, returned; the other
    checks are printed only (their records are the B=8, Nl=32 ones of
    kernel_phase and backward_phase)."""
    import numpy as np

    from decompdiff_tpu_torch.models.diffusion_model import DecompDiffModel
    from decompdiff_tpu_torch.utils.testing import random_complex_batch
    dev = torch.device('cuda')
    plain = DecompDiffModel.create(dict(cfg, use_pallas=False), 8,
                                   device=dev, seed=0)
    t = torch.zeros((TRAIN_B,), dtype=torch.long, device=dev)
    top = {}
    for nl, real in TRAIN_SHAPES:
        batch = random_complex_batch(
            np.random.default_rng(2), batch_size=TRAIN_B,
            num_protein=NUM_PROTEIN, num_ligand=nl, real_ligand=real,
            num_groups=TRAIN_GROUPS, device=dev)
        state = (batch.ligand_pos, batch.ligand_v, batch.bond_type, t)
        captured = {(name, f'{mode} B{TRAIN_B} Nl{nl}'): call
                    for (name, mode), call in capture_inputs(
                        torch, ops, plain, batch, state).items()}
        check(len(captured) == 5, f'expected 5 kernel modes at Nl={nl}, saw '
              f'{sorted(captured)}')
        with torch.no_grad():
            for (name, mode), (args, kw) in modes(captured):
                check_forward(torch, {}, name, mode, args, kw, KERNEL_RTOL,
                              KERNEL_ATOL)
        if nl == TRIPLET_HEAD_NL:
            mode = f'node B{TRAIN_B} Nl{nl}'
            call = captured.pop(('triplet_attention', mode))
            zero_launches(ops)
            top.update(backward_phase(torch, ops, {
                (f'triplet_attention_nl{nl}', mode): call}))
            launches = get_launches(ops)
            check(launches[TOP_RECORD] > 0
                  and launches['triplet_attention_backward_row'] == 0,
                  f'the Nl={nl} triplet backward did not take its head '
                  f'route: {nonzero(launches)}')
        backward_phase(torch, ops, captured)
        del batch, captured
    check(set(top) == {TOP_RECORD},
          f'no training bucket at Nl={TRIPLET_HEAD_NL}')
    return top


def kernel_records(results, launches, entry_launches, train_entry_launches):
    """One record per kernel for the kernels JSON line. Per launch: edge and
    bond run their node and pos modes equally often on both paths (once each
    per layer), so a kernel's ms, plain_ms and bound_ms are the means over
    its modes, and launches * ms is its time on the path. `launches` is the
    count on the path that runs the kernel: sampling for the forward
    kernels (with pallas_bf16 for the triplet's bf16 record, with
    pallas_gather_bf16 for the gather record, the width paths for the
    per-row records), training for the backward ones. bound_fp32_ms: the
    bound with every operation at the FP32 CUDA-core peak, as PRs 1-3 gave
    it. entry_launches: the kernel's launches through the sampling entry
    point (entry_phase); train_entry_launches: through the training entry
    point (train_entry_phase, both runs)."""
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
            'entry_launches': entry_launches.get(name, 0),
            'train_entry_launches': train_entry_launches.get(name, 0),
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


def zero_launches(ops):
    """Sets the launch count of every forward and backward kernel to 0."""
    for fn, attr in launch_counters(ops).values():
        setattr(fn, attr, 0)
    ops['triplet_attention'].triplet_attention_backward.nl_launches = {}


def get_launches(ops):
    """The launch counts of launch_counters, and TOP_RECORD: the triplet
    backward's launches at Nl=TRIPLET_HEAD_NL."""
    counts = {n: getattr(fn, attr)
              for n, (fn, attr) in launch_counters(ops).items()}
    backward = ops['triplet_attention'].triplet_attention_backward
    counts[TOP_RECORD] = backward.nl_launches.get(TRIPLET_HEAD_NL, 0)
    return counts


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
        # forward launches per denoiser call; the m-gate runs in x2h only
        bond_cfg, o2_cfg = DEFAULT_MODEL_CONFIG, uni_o2_model_config()
        layers = bond_cfg['num_layers'] * bond_cfg['num_blocks']
        bond_calls = {'edge_attention': 2 * layers,
                      'bond_attention': 2 * layers,
                      'triplet_attention': layers}
        o2_layers = o2_cfg['num_layers'] * o2_cfg['num_blocks']
        o2_calls = {'edge_attention': o2_layers,
                    'edge_attention_mgate': o2_layers}
        entry_launches = entry_phase(torch, bond_calls)
        train_entry_launches = train_entry_phase(torch, bond_calls)
        nl64 = train_shapes_phase(torch, model_ops(), bond_cfg)
        ms, plain_ms, t_ops, t_bytes, _ = nl64[TOP_RECORD]['modes'][0]
        print(f'triplet backward head route at H={bond_cfg["hidden_dim"]}, '
              f'Nl={TRIPLET_HEAD_NL}, B={TRAIN_B} (the training entry '
              f'point\'s Nl={TRIPLET_HEAD_NL} steps; d t_src in device '
              f'memory): {ms:.4f} ms a launch, plain {plain_ms:.4f} ms, '
              f'bound {max(t_ops, t_bytes):.4f} ms; on '
              f'{gpu_name_and_limit()}', flush=True)
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
        results.update(nl64)
        # the per-row backward kernels at WIDTHS: the triplet's at the first
        # width is the record triplet_attention_backward_row (no released
        # path reaches it), the others are printed only
        row_key = ('triplet_attention_row', f'H{WIDTHS[0][0]} node')
        results.update(backward_phase(
            torch, ops, {row_key: width_modes[row_key]}, rows=True))
        backward_phase(torch, ops, {k: c for k, c in width_modes.items()
                                    if k != row_key}, rows=True)
        del captured, o2_modes, gather_modes, width_modes, gather_model
        # the WIDE backward records after the others, so that their models
        # and inputs do not change the device memory those run in
        wide_modes, wide_models = width_phase(torch, bond_cfg, width_batch,
                                              (WIDE,), '_wide')
        wide_cfg = wide_models.pop(WIDE[0])[0]
        results.update(backward_phase(torch, ops, wide_modes))
        del wide_modes, wide_models

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
        if n == TOP_RECORD:
            launches[n] = train_entry_launches[n]
            continue
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
    print(json.dumps({'kernels': kernel_records(
        results, launches, entry_launches, train_entry_launches)}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
