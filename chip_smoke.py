#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (decompdiff_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # from the root of a repository checkout

1. Device: requires CUDA, turns TF32 and cuBLAS's bf16 reduced-precision
   reductions off, prints the card's name and power limit (nvidia-smi).
2. Build: compiles the three CUDA sources of csrc/ (each holds a forward and
   a backward kernel) with nvcc and the host library csrc/ddnative.cpp
   (native.py's padding, PDB parsing and bond candidates) with g++, all
   started together (timed set-up).
2a. Entry point: the sampling driver (decompdiff_tpu_torch/sampling/
   driver.py, the port of scripts/sample.py) as a user runs it, on a
   synthetic store of two ~320-atom pockets, from a JAX-layout checkpoint
   of the seeded released uni_o2_bond model, with the kernels, B=8, 8
   molecules per pocket and STEPS strided guided steps: launches counted
   (exactly calls x 12/12/6 forward, nothing else), the native library's
   calls counted (native.calls, above 0), result pickles checked,
   seconds per molecule printed split into host set-up, device sampling
   and reconstruction. The padding routines of each batch the driver
   collated (B=8, Np=320, Nl=32) and the bond candidates of each sampled
   molecule through the C library and its plain versions: bitwise equal,
   host ms of each routine printed, C and plain. The sampled molecules
   through utils/visualize.py: one 3Dmol HTML view and one draw_mol_grid
   SVG, both holding every molecule. Then scripts/evaluate_torch.py (the
   evaluation
   driver, decompdiff_tpu_torch/evaluation/driver.py, the port of
   scripts/evaluate.py), run in this process, scores those pickles with
   --docking_mode none, and then the store's own ligands written as
   results: no kernel launched, scripts/evaluate.py's summary
   keys, counts equal to the sampling summaries', first-party QED and SA
   in [0, 1], JSDs finite, no module of JAX or the JAX package loaded;
   seconds per molecule printed.
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
2e. Data parallel (run after 2b, dp_phase): first two ranks' rows of a
   guided sampling step's stages (protein centroid, guidance gradients,
   one denoiser call) against the whole batch at the released config,
   B=8, Np=320, Nl=16 and 32, within rtol = atol = 1e-5 (where rows part
   in their last bit, 20 sampling steps of the halves against the whole
   batch printed); one training step's gradients twice on the same inputs,
   kernels and plain versions (printed: what makes runs differ). Then the
   training driver for DP_ITERS iterations of TRAIN_CONFIG on the
   TRAIN_POCKETS store in this process, twice (the noise floor), then
   scripts/train_torch.py under torchrun on one rank (NCCL), twice, and
   on two ranks sharing the card (gloo, 2 of the 4 complexes each):
   per-iteration losses and grad norms (rtol 5e-3) and the last
   checkpoint's parameters (rtol 5e-3 / atol 2e-3) against the in-process
   run, every checkpoint read back, each rank's launches those of the
   in-process run with nothing per row; then scripts/sample_torch.py under
   torchrun on the entry phase's pockets at both world sizes: each rank
   40 calls x 12/12/6 on its B/W rows, the two runs' result pickles equal
   (positions rtol 1e-4 / atol 1e-5, types and bonds exactly). Prints
   s/step, each rank's step seconds and its collectives' share of the
   step, and s/molecule; a torchrun that fails or outlasts DP_TIMEOUT is
   killed with its ranks and fails the phase. The JSON line carries each
   rank's launches at two ranks (dp_train_launches, dp_sample_launches).
2c. Reference weights and the drift: a reference-layout .pt of the released
   uni_o2_bond model (the state dict of tests/reference_oracle.py, saved
   with torch.save as {config, model, iteration}) converted by
   scripts/convert_checkpoint_torch.py in a subprocess; one denoiser call
   of the converted model with the kernels (B=1, REF_COMPLEX) against the
   oracle's float64 forward at rtol = atol = 3e-4, its max error printed;
   then the sampling driver from the converted .ckpt on the entry point's
   store with the mmff_min drift (REF_DRIFT: without RDKit the first-party
   force field, guidance/ffmin.py) besides armsca_prox and clash: launches
   exactly calls x 12/12/6 forward, the drift's calls equal to the strided
   steps inside its window times the batches, result pickles checked,
   seconds per molecule printed with the drift's host seconds and the
   batch rows it drifted; and the drift relaxes a stretched carbon chain.
2d. Data preparation: RAW_PAIRS raw receptor PDB / ligand SDF pairs
   (3,361-atom two-cavity lattice receptors, a two-armed ligand, each pair
   under its own seeded rigid motion) and an index entry naming a missing
   receptor, turned into a store by the port's scripts in subprocesses:
   preprocess_subcomplex_torch.py (without RDKit and alphaspace2 on the
   host, the first-party alpha-sphere finder and bond-cut fragments),
   import_reference_data_torch.py --index, split_dataset_torch.py; the
   status buckets (every pair ok, the missing receptor missing_file), the
   arms, the records' keys and the split checked, seconds per pair and per
   record printed; each raw receptor through the C PDB parser and its
   plain version (every field equal, host ms of each). Then the sampling
   driver on the built store as in 2a (launches exactly calls x 12/12/6
   forward, native calls above 0, the padding routines of its batches, B=8,
   Np=384, Nl=16, C against plain as in 2a); on the first batch the
   driver collated there (its own B, Np, Nl) each kernel mode's first-
   layer inputs through the kernel and its plain version (rtol 1e-3, atol
   1e-4) and one denoiser call kernels on vs off (rtol 1e-3, atol 1e-3);
   and scripts/evaluate_torch.py on its result pickles and on the prepared
   ligands;
   for each ligand is_pains, the QED alert count over a SMARTS corpus
   (DD_QED_ALERTS_SMARTS) and the arm occupancy and polar ratio of
   evaluation/eval_arms.py against the find_pockets pockets of its
   receptor: no kernel launched, the counts, occupancies and ratios
   checked and printed.
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
   The triplet forward also at the sampling cell's batch, B=TRIPLET_BATCH
   (the B=8 inputs repeated along the batch): against its plain version
   and timed, every launch on its pipelined kernel (printed).
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
5a. compute_dtype: bfloat16 (compute_bf16_phase), the released uni_o2_bond
   config with the key: the three forward kernels against their plain
   versions on the float32 inputs the bf16 denoiser hands them; one
   denoiser call kernels on vs off (BF16_PATH_FRAC / BF16_PATH_CAP),
   beside the same call with cuBLAS's bf16 reduced-precision reductions
   allowed, the bf16 plain path and the float32 kernels (printed); the
   same for uni_o2 (ew_net_type m); the sampling entry point from a .ckpt
   whose config sets the key (launches exactly calls x 12/12/6, nothing
   per row) and from the float32 .ckpt; TRAIN_STEPS training steps of each
   dtype (launches per step, losses finite, parameters moved); s/molecule,
   device ms per sampling step, training s/step and peak device memory of
   both dtypes printed.
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
# phase 2c: a reference-layout .pt of the released model (its state dict
# from tests/reference_oracle.py, seed REF_SEED), converted by
# scripts/convert_checkpoint_torch.py; one denoiser call on a complex of
# REF_COMPLEX (protein atoms, ligand atoms, arms), kernels on, against the
# oracle's float64 forward at the JAX oracle tests' tolerance
# (tests/test_oracle_parity.py); then the sampling driver from the converted
# checkpoint on the ENTRY_POCKETS store with the mmff_min drift added
REF_SEED, REF_COMPLEX, REF_RTOL, REF_ATOL = 0, (64, 16, 2), 3e-4, 3e-4
REF_DRIFT = {'type': 'mmff_min', 'start_time': 1000, 'end_time': 500}
# phase 2d, the data preparation (L0) from raw files: RAW_PAIRS receptor /
# ligand pairs, each the two-cavity lattice at PREP_HALF (15^3 points less
# the cavities: 3,361 atoms, a CrossDocked receptor's size) with the
# two-armed ligand, moved by its own rigid motion from PREP_SEED, and one
# index entry naming a missing receptor; preprocess_subcomplex_torch.py
# with PREP_WORKERS workers; the sampling driver on the built store's first
# PREP_SAMPLED pockets
RAW_PAIRS, PREP_HALF, PREP_SEED, PREP_WORKERS, PREP_SAMPLED = 8, 7, 0, 4, 2
# the keys of a record that build_store_from_index writes
PREP_RECORD_KEYS = {
    'protein_pos', 'protein_element', 'protein_atom_to_aa_type',
    'protein_is_backbone', 'ligand_pos', 'ligand_element',
    'ligand_bond_index', 'ligand_bond_type', 'ligand_atom_is_aromatic',
    'ligand_hybridization', 'ligand_atom_mask', 'pocket_atom_masks',
    'num_arms', 'num_scaffold', 'src_protein_filename',
    'src_ligand_filename', 'arms_prior', 'scaffold_prior',
    'pocket_prior_masks'}
# a QED alert corpus for DD_QED_ALERTS_SMARTS (name, SMARTS), and the
# alerts each prepared ligand (two cyclopropane arms joined by a
# three-carbon linker) raises: the first two patterns, not the third
PREP_ALERTS = (('cyclopropane', 'C1CC1'), ('propyl', '[CX4][CX4][CX4]'),
               ('benzene', 'c1ccccc1'))
PREP_ALERT_COUNT = 2
# the native host library (csrc/ddnative.cpp) against its plain versions:
# each routine timed over NATIVE_REPS calls (host seconds per call)
NATIVE_REPS = 20
# the keys of a result pickle and of each of its rows (scripts/sample.py)
RESULT_KEYS = {'data_id', 'results', 'atom_mode', 'config'}
ROW_KEYS = {'pred_pos', 'pred_v', 'pred_bond', 'decomp_mask', 'mol',
            'smiles', 'complete', 'ligand_filename', 'src_protein_filename',
            'protein_path'}
# the keys of eval_summary.pkl as scripts/evaluate.py writes them
EVAL_SUMMARY_KEYS = {
    'n_total', 'n_recon', 'n_complete', 'n_dock_success', 'bond_jsd',
    'pair_jsd', 'atom_type_jsd', 'ring_sizes', 'ring_ratio', 'chem', 'vina',
    'chem_backend', 'vina_metrics', 'high_affinity', 'success_rate',
    'diversity'}
# modules the port and this script must never load
FORBIDDEN_MODULES = ('jax', 'flax', 'optax', 'decompdiff_tpu')
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
# phase 2e, data parallel: the training entry point for DP_ITERS iterations
# (validation at the last) in this process and under torchrun on
# DP_WORLDS ranks (one rank: NCCL; two on the one card: gloo), on the
# TRAIN_POCKETS store with TRAIN_CONFIG; the sampling entry point under
# torchrun on the ENTRY_POCKETS store at each world size; each torchrun
# under DP_TIMEOUT seconds. Trajectories are held at the JAX package's dp
# tolerances (tests/test_multichip_deep.py), samples at its sampler's
# (tests/test_sampler.py)
DP_ITERS, DP_WORLDS, DP_TIMEOUT = 10, (1, 2), 300
DP_RTOL, DP_PARAM_TOL = 5e-3, dict(rtol=5e-3, atol=2e-3)
DP_POS_TOL = dict(rtol=1e-4, atol=1e-5)
# a rank's rows of each stage of a guided sampling step against the whole
# batch's, at the released config, B=8, Np=320 and each of DP_ROW_NLS
DP_ROW_TOL, DP_ROW_NLS = dict(rtol=1e-5, atol=1e-5), (16, 32)
# the torchrun training runs: (W, name); W=1 twice reads the noise floor
DP_TRAIN_RUNS = ((1, 'w1'), (1, 'w1_again'), (2, 'w2'))
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
# the sampling cell's batch (perfbench bond.sample.b100), at which the
# triplet forward is also held and timed
TRIPLET_BATCH = 100
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
# the Adam kernel: it reads p, g, m, v and writes p, m, v (float32), and
# does about 13 operations a parameter; held to its plain version as the
# card test holds the optimizer (tests/test_torch_cuda.py)
ADAM_BYTES, ADAM_FLOPS = 28, 13
ADAM_RTOL, ADAM_ATOL = 1e-6, 1e-7
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
# compute_dtype bfloat16, one denoiser call kernels on vs off (the kernel
# model under plain_versions: the same casts): h and h_bond are bf16 between
# the kernels, so a value that the two paths' float32 summation orders
# place on either side of a bf16 rounding boundary moves by one bf16 unit
# (a flip), and everything downstream with it; after a few layers the two
# calls differ by bf16 rounding noise throughout, as the bf16 call differs
# from the float32 one. So kernels on vs off must lie within BF16_NOISE
# times the option's own effect (on vs the float32 kernels), and none
# beyond BF16_PATH_CAP.
BF16_NOISE, BF16_PATH_CAP = 2.0, 0.1
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
    # no Pallas kernel: the JAX package's optax adam is XLA's fused
    # elementwise code
    'multi_tensor_adam': 'optax.adam (XLA, no Pallas kernel)',
}
# Each kernel mode's ms as this script measured it on the per-row
# CUDA-core kernel, before that kernel's redesign (the forwards onto the
# tensor cores, the triplet, edge and bond backward head-factorized;
# PERF.md kernel table, NVIDIA H100 80GB HBM3, 700 W; the edge and bond
# backward's from the last runs of their per-row kernels at these shapes,
# the triplet backward's at B=4, Nl=64 from the per-row kernel's three
# runs there), printed beside this run's. The triplet forward's are those of
# its mma.sync kernel before the wgmma pipeline (at B=TRIPLET_BATCH: on
# random inputs with the sampler's dense bond masks, in the same call).
PREVIOUS_MS = {
    ('edge_attention', 'node'): '0.4334-0.4361',
    ('edge_attention', 'pos'): '0.3852-0.3888',
    ('edge_attention_mgate', 'node'): '0.4622-0.4671',
    ('bond_attention', 'node'): '0.0997-0.0999',
    ('bond_attention', 'pos'): '0.0934-0.0937',
    ('triplet_attention', 'node'): '0.4360-0.4413',
    ('triplet_attention', f'node B{TRIPLET_BATCH}'): '5.2851-5.3697',
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
    # what the entry points set (decompdiff_tpu_torch/device.py)
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
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
    print(f'build: {len(_build.SOURCES)} sources, '
          f'{", ".join(_build.KERNELS)} (forward and backward kernels, nvcc) '
          f'and {", ".join(_build.HOST_LIBRARIES)} (the host library, g++: '
          f'{_build.library_path("ddnative").name}) in '
          f'{time.perf_counter() - t0:.1f} s (set-up)', flush=True)
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


@contextlib.contextmanager
def plain_adam():
    """The optimizer's Adam kernel (ops/multi_tensor_adam.py) replaced by
    its plain version, which takes its arguments: a training step then
    launches no hand-written kernel."""
    from decompdiff_tpu_torch.ops import multi_tensor_adam as mod
    kernel = mod.multi_tensor_adam
    mod.multi_tensor_adam = mod.multi_tensor_adam_reference
    try:
        yield
    finally:
        mod.multi_tensor_adam = kernel


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


def window_valid(torch, valid, kw):
    """valid [B, N, K] pairs of an edge call, only those of the rows in its
    destination-row window kw['rows'] (ops/edge_attention.py) where it has
    one: the rows outside the window are written 0, not computed."""
    if kw.get('rows') is None:
        return valid
    start, count = kw['rows']
    keep = torch.zeros(valid.shape[1], dtype=torch.bool, device=valid.device)
    keep[start:start + count] = True
    return valid & keep[:, None]


def work(torch, name, args, kw, out):
    """(FLOPs, [H, H] second-linear FLOPs among them, bytes) the call needs
    on these inputs: 2 per multiply-add of the per-pair products, of q.k and
    alpha.v and of the m-gate's v.wm over valid (row, source) pairs only,
    with an edge call's row window those of its rows (LayerNorm, exp and
    adds left out, so the bound is a lower bound); every input read once
    (with the window, the inputs read per destination row only at its rows)
    and the output written once."""
    nbytes = sum(t.numel() * t.element_size()
                 for t in call_inputs(torch, args, kw))
    nbytes += out.numel() * out.element_size()
    if kw.get('rows') is not None:   # idx, mask, e_w, q and both t_row
        per_row = sum(t.numel() * t.element_size()
                      for t in (*args[3:7], args[7][0], args[8][0]))
        nbytes -= int(per_row * (1 - kw['rows'][1] / args[3].shape[1]))
    H = args[-3].shape[-1]                # every kernel takes (..., q, k, v)
    nh = kw['n_heads']
    pos = kw.get('pos_mode', False)
    v_out = 2 * H * nh + 2 * H + 6 * nh if pos else 2 * H * H + 2 * H
    attn = 2 * H * H + 2 * H + v_out      # k second linear, q.k, v and alpha.v
    square = 2 * H * H * (1 if pos else 2)    # the [H, H] second linears
    if name.startswith('edge_attention'):  # (x, lig, group, idx, mask, ...)
        pairs = int(window_valid(torch, args[4] > 0.5, kw).sum())
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


def triplet_batch_phase(torch, call):
    """The triplet forward at the sampling cell's batch: the B=8, Nl=32
    inputs of a released-config denoiser call (call: its args and kw)
    repeated along the batch to B=TRIPLET_BATCH, against its plain version
    and timed (check_forward: printed, the record stays B=8's); every launch
    on the pipelined kernel (triplet_attention.pipelined_launches)."""
    from decompdiff_tpu_torch.ops import triplet_attention as mod
    from decompdiff_tpu_torch.ops.common import Branch
    args, kw = call
    reps = -(-TRIPLET_BATCH // args[0].shape[0])

    def tile(x):
        return x.repeat(reps, *[1] * (x.dim() - 1))[:TRIPLET_BATCH]
    big = [tile(a) for a in args[:3]] + [
        Branch(tile(p.t_row), tile(p.t_src), *p[2:]) for p in args[3:]]
    fn = mod.triplet_attention
    before = (fn.pipelined_launches, fn.launches, fn.row_launches)
    check_forward(torch, {}, 'triplet_attention', f'node B{TRIPLET_BATCH}',
                  big, kw, KERNEL_RTOL, KERNEL_ATOL)
    piped, launched, row = (n - b for n, b in zip(
        (fn.pipelined_launches, fn.launches, fn.row_launches), before))
    print(f'triplet forward at B={TRIPLET_BATCH}: {piped} pipelined of '
          f'{launched} launches, {row} per-row (the timed ones included)',
          flush=True)
    check(launched > 0 and piped == launched and row == 0,
          'a triplet forward launch did not take its pipelined kernel')


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
    The products are the tensor-core share. With a row window, the rows
    outside it carry no gradient, so only its rows count."""
    # (x, lig, group, idx, mask, ...)
    valid = window_valid(torch, args[4] > 0.5, kw)
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


def adam_phase(torch, cfg):
    """The optimizer's Adam kernel against its plain version over the
    parameters of `cfg`'s denoiser (the released one's 704 tensors, 4.98 M
    parameters) with the training config's Adam settings: one step from
    drawn gradients, moments and step counts (10 to 59), parameters,
    moments and step counts within ADAM_RTOL / ADAM_ATOL. Timed: the
    kernel launching its table again, as a training step does; the plain
    version; torch's fused Adam on the same tensors (library_ms; its
    update differs, see ops/multi_tensor_adam.py). Bound: ADAM_BYTES a
    parameter at PEAK_BYTES (ADAM_FLOPS at PEAK_FLOPS)."""
    from decompdiff_tpu_torch.models.diffusion_model import DecompDiffModel
    from decompdiff_tpu_torch.ops.multi_tensor_adam import (
        multi_tensor_adam, multi_tensor_adam_reference)
    from decompdiff_tpu_torch.training.train_step import (
        DEFAULT_TRAIN_CONFIG, create_train_state)
    dev = torch.device('cuda')
    model = DecompDiffModel.create(dict(cfg, use_pallas=True), 8, device=dev,
                                   seed=0)
    group = create_train_state(model, DEFAULT_TRAIN_CONFIG).optimizer.adam \
        .param_groups[0]
    hyper = dict(lr=group['lr'], beta1=group['betas'][0],
                 beta2=group['betas'][1], eps=group['eps'],
                 weight_decay=group['weight_decay'])
    params = [p.detach() for p in model.denoiser.parameters()]
    n = sum(p.numel() for p in params)
    gen = torch.Generator(device=dev).manual_seed(9)

    def draw(scale):
        return [torch.randn(p.shape, generator=gen, device=dev) * scale
                for p in params]
    grads, m, v = draw(1e-3), draw(1e-4), [x * x for x in draw(1e-3)]
    steps = [torch.full((), float(10 + i % 50), device=dev)
             for i in range(len(params))]
    want = [[t.clone() for t in col] for col in (params, m, v, steps)]
    got = [[t.clone() for t in col] for col in (params, m, v, steps)]
    multi_tensor_adam_reference(want[0], grads, *want[1:], **hyper)
    table = multi_tensor_adam(got[0], grads, *got[1:], **hyper)
    torch.cuda.synchronize()
    worst, outside = 0.0, 0
    for a, b in zip(got, want):
        a = torch.cat([t.reshape(-1) for t in a])
        b = torch.cat([t.reshape(-1) for t in b])
        err = (a - b).abs()
        worst = max(worst, float(err.max()))
        outside += int((err > ADAM_ATOL + ADAM_RTOL * b.abs()).sum())
    ms = time_ms(torch, lambda: multi_tensor_adam(got[0], grads, *got[1:],
                                                  **hyper, table=table))
    plain_ms = time_ms(torch, lambda: multi_tensor_adam_reference(
        want[0], grads, *want[1:], **hyper), iters=5, warmup=1)
    lib_params = [torch.nn.Parameter(p.clone()) for p in params]
    for p, g in zip(lib_params, grads):
        p.grad = g
    lib = torch.optim.Adam(lib_params, lr=hyper['lr'],
                           betas=(hyper['beta1'], hyper['beta2']),
                           eps=hyper['eps'],
                           weight_decay=hyper['weight_decay'], fused=True)
    library_ms = time_ms(torch, lib.step)
    t_ops = ADAM_FLOPS * n / PEAK_FLOPS * 1e3
    t_bytes = ADAM_BYTES * n / PEAK_BYTES * 1e3
    ok = outside == 0 and all(bool(torch.isfinite(t).all()) for t in got[0])
    print(f'kernel multi_tensor_adam[{len(params)} tensors, {n} parameters]: '
          f'max_abs_err {worst:.3e}, {outside} elements outside (rtol '
          f'{ADAM_RTOL}, atol {ADAM_ATOL}) {"ok" if ok else "MISMATCH"}; '
          f'kernel {ms:.4f} ms ({table.n_blocks} blocks), plain '
          f'{plain_ms:.4f} ms, torch fused Adam {library_ms:.4f} ms, bound '
          f'{max(t_ops, t_bytes):.4f} ms by bytes ({ADAM_BYTES * n / 1e6:.1f} '
          f'MB)', flush=True)
    check(ok, 'multi_tensor_adam disagrees with its plain version')
    return {'multi_tensor_adam': dict(
        err=worst, modes=[(ms, plain_ms, t_ops, t_bytes, t_ops)],
        library_ms=library_ms)}


def train_phase(torch, batch, cfg, per_step, label, wrapped=False):
    """Training steps of `cfg` at the bench shapes, kernels on and off.
    per_step: the forward kernels' launches per step (each backward kernel
    launches as often as its forward). wrapped: kernels off is the kernel
    model under plain_versions (for an option the plain path does not
    read); on both the plain path runs the plain Adam (plain_adam). Returns
    the launch counts of the kernel path, the Adam kernel's
    ('multi_tensor_adam', one a step) among them."""
    from decompdiff_tpu_torch.training.train_step import (
        DEFAULT_TRAIN_CONFIG, create_train_state, make_train_fns)
    dev = torch.device('cuda')
    tcfg = DEFAULT_TRAIN_CONFIG
    ops = model_ops()
    models = dict(zip(('kernels', 'plain'), make_models(torch, cfg,
                                                        wrapped)))

    def plain_ctx(key):
        stack = contextlib.ExitStack()
        if key == 'plain':
            stack.enter_context(plain_adam())
            if wrapped:
                stack.enter_context(plain_versions(ops))
        return stack

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
              for n in get_launches()}
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
        zero_launches()
        t0 = time.perf_counter()
        with plain_ctx(key):
            for _ in range(TRAIN_STEPS):
                metrics = step(state, batch, g)
            torch.cuda.synchronize()
        elapsed = (time.perf_counter() - t0) / TRAIN_STEPS
        peak = torch.cuda.max_memory_allocated() / 2**20
        counts, adam = get_launches(), adam_launches()
        print(f'{label} train path {key}: {TRAIN_STEPS} steps at '
              f'B={batch.batch_size} '
              f'Np={NUM_PROTEIN} Nl={NUM_LIGAND}: {elapsed:.4f} s/step, peak '
              f'device memory {peak:.1f} MiB; last step loss '
              f'{float(metrics["loss"]):.5f} grad_norm '
              f'{float(metrics["grad_norm"]):.5f}; launches {counts}, '
              f'multi_tensor_adam {adam}', flush=True)
        check(all(bool(torch.isfinite(v)) for v in metrics.values()),
              f'non-finite training metrics ({key})')
        if key == 'kernels':
            launches = dict(counts, multi_tensor_adam=adam)
            check(counts == expect, f'training launches differ from the '
                  f'expected {expect}')
            check(adam == TRAIN_STEPS, f'{adam} Adam kernel launches in '
                  f'{TRAIN_STEPS} steps')
        else:
            check(not any(counts.values()) and adam == 0,
                  'the plain path launched kernels')
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
    zero_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = sample_diffusion(model, cfg, batch, init_pos, init_v, init_b,
                           full_protein, generator=g)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = get_launches()

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


def rel_l2(torch, a, b):
    """|a - b| / |b| (L2 over every element)."""
    return float(torch.linalg.vector_norm(a - b)
                 / torch.linalg.vector_norm(b).clamp_min(1e-30))


def bf16_on_off(torch, model, model32, batch, state, label):
    """One denoiser call of a compute_dtype bfloat16 kernel model at the
    last timestep, kernels on vs the same model under plain_versions (the
    same casts, every kernel replaced by its plain version), against the
    bf16 noise of this call: model32 is the float32 kernel model of the
    same weights, and kernels on vs off must lie within BF16_NOISE times
    the option's own effect, both as the relative L2 distance over each
    prediction (on vs off against on vs float32) and as its largest
    element, and none beyond BF16_PATH_CAP. Returns (kernels on, off)."""
    t = torch.full((batch.batch_size,), model.num_timesteps - 1,
                   dtype=torch.long, device=model.device)
    with torch.no_grad():
        on = model.apply(batch, *state, t)
        with plain_versions(model_ops()):
            off = model.apply(batch, *state, t)
        f32 = model32.apply(batch, *state, t)
    for key in on:
        err = float((on[key] - off[key]).abs().max())
        effect = float((on[key] - f32[key]).abs().max())
        rel, rel_effect = (rel_l2(torch, on[key], off[key]),
                           rel_l2(torch, on[key], f32[key]))
        outside = int(((on[key] - off[key]).abs()
                       > PATH_ATOL + PATH_RTOL * off[key].abs()).sum())
        ok = (bool(torch.isfinite(on[key]).all())
              and on[key].dtype == torch.float32
              and rel <= BF16_NOISE * rel_effect
              and err <= BF16_NOISE * effect and err <= BF16_PATH_CAP)
        print(f'{label} denoiser kernels on vs off: {key} max_abs_err '
              f'{err:.3e}, relative L2 {rel:.3e}; the option\'s effect '
              f'(on vs the float32 kernels) max_abs {effect:.3e}, relative '
              f'L2 {rel_effect:.3e}; allowed {BF16_NOISE} x the effect, '
              f'none beyond {BF16_PATH_CAP}; {outside} of '
              f'{on[key].numel()} elements outside the float32 paths\' '
              f'rtol {PATH_RTOL} / atol {PATH_ATOL} '
              f'{"ok" if ok else "MISMATCH"}', flush=True)
        check(ok, f'{label} denoiser {key} differs with kernels on')
    return on, off


def bf16_train_run(torch, batch, cfg, per_step, label):
    """TRAIN_STEPS training steps of cfg's kernel model (seed 0) after one
    warm-up step, every launch counter set to 0 just before and read just
    after: launches exactly per_step (forward and backward) a step, every
    loss finite, every parameter moved. Prints s/step and peak device
    memory. Returns (launches, s/step, peak MiB)."""
    from decompdiff_tpu_torch.training.train_step import (
        DEFAULT_TRAIN_CONFIG, create_train_state, make_train_fns)
    dev = torch.device('cuda')
    ops = model_ops()
    model = make_models(torch, cfg)[0]
    state = create_train_state(model, DEFAULT_TRAIN_CONFIG)
    step = make_train_fns(model, DEFAULT_TRAIN_CONFIG)[0]
    g = torch.Generator(device=dev).manual_seed(4)
    before = {n: p.detach().clone()
              for n, p in model.denoiser.named_parameters()}
    step(state, batch, g)                           # warm-up, not counted
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    losses = []
    t0 = time.perf_counter()
    for _ in range(TRAIN_STEPS):
        losses.append(step(state, batch, g)['loss'])
    torch.cuda.synchronize()
    elapsed = (time.perf_counter() - t0) / TRAIN_STEPS
    peak = torch.cuda.max_memory_allocated() / 2**20
    launches = get_launches()
    expect = {n: per_step.get(n.replace('_backward', ''), 0) * TRAIN_STEPS
              for n in launches}
    losses = [float(v) for v in losses]
    still = [n for n, p in model.denoiser.named_parameters()
             if torch.equal(p, before[n])]
    print(f'{label} train path: {TRAIN_STEPS} steps at B={batch.batch_size} '
          f'Np={NUM_PROTEIN} Nl={NUM_LIGAND}: {elapsed:.4f} s/step, peak '
          f'device memory {peak:.1f} MiB; losses {losses}; parameters '
          f'unmoved {len(still)} of {len(before)}; launches '
          f'{nonzero(launches)} (expected {nonzero(expect)})', flush=True)
    check(launches == expect, f'{label} training launches differ from the '
          'expected')
    check(all(v == v and abs(v) < float('inf') for v in losses),
          f'{label}: non-finite losses')
    check(not still, f'{label}: parameters that did not move: {still[:5]}')
    del model, state
    return launches, elapsed, peak


def compute_bf16_phase(torch, batch, per_call):
    """compute_dtype: bfloat16 on the released uni_o2_bond config. The three
    forward kernels against their plain versions on the (float32) inputs
    that the bf16 denoiser hands them in its first layer; one denoiser call
    kernels on vs off (bf16_on_off), with cuBLAS's bf16 reduced-precision
    reductions off (the entry points' setting) and then allowed, and its
    distance from the bf16 plain path and from the float32 kernels printed;
    the same call on vs off for uni_o2 (ew_net_type m); the sampling entry
    point from a .ckpt whose config sets the key, on a synthetic store of
    ENTRY_POCKETS (launches exactly calls x per_call, nothing per row), and
    from the float32 .ckpt of the same weights; then bf16_train_run of both
    dtypes. Each dtype's sampling and training run twice, in turns with
    the other's. Prints s/molecule, device ms per sampling step, training
    s/step and peak device memory for float32 and bf16. Returns
    (sampling launches, training launches) of the bf16 runs."""
    import shutil

    from decompdiff_tpu_torch.utils.testing import (
        DEFAULT_MODEL_CONFIG, uni_o2_model_config)
    ops = model_ops()
    bf16 = {'compute_dtype': 'bfloat16'}
    cfg16 = dict(DEFAULT_MODEL_CONFIG, **bf16)
    model16, plain16 = make_models(torch, cfg16)
    model32 = make_models(torch, DEFAULT_MODEL_CONFIG)[0]
    t = torch.zeros((B,), dtype=torch.long, device=model16.device)
    state = (batch.ligand_pos, batch.ligand_v, batch.bond_type)
    captured = capture_inputs(torch, ops, model16, batch, (*state, t),
                              wrapped=True)
    check(sorted(captured) == sorted(
              [('edge_attention', 'node'), ('edge_attention', 'pos'),
               ('bond_attention', 'node'), ('bond_attention', 'pos'),
               ('triplet_attention', 'node')]),
          f'bf16 kernel modes {sorted(captured)}')
    with torch.no_grad():
        for (name, mode), (args, kw) in modes(captured):
            check(all(a.dtype == torch.float32 for a in
                      call_inputs(torch, args, kw) if a.is_floating_point()),
                  f'{name}[{mode}]: a kernel input is not float32')
            check_forward(torch, {}, name, f'{mode} compute_dtype bf16',
                          args, kw, KERNEL_RTOL, KERNEL_ATOL)
    del captured
    label = 'uni_o2_bond[compute_dtype bf16]'
    on, off = bf16_on_off(torch, model16, model32, batch, state, label)
    tl = torch.full((B,), model16.num_timesteps - 1, dtype=torch.long,
                    device=model16.device)
    matmul = torch.backends.cuda.matmul
    matmul.allow_bf16_reduced_precision_reduction = True
    try:
        with torch.no_grad():
            reduced = model16.apply(batch, *state, tl)
            with plain_versions(ops):
                reduced_off = model16.apply(batch, *state, tl)
    finally:
        matmul.allow_bf16_reduced_precision_reduction = False
    with torch.no_grad():
        dense = plain16.apply(batch, *state, tl)
    for key in on:
        print(f'{label} denoiser {key}: with cuBLAS bf16 reduced-precision '
              f'reductions allowed, against the same call without them '
              f'max_abs_diff {float((reduced[key] - on[key]).abs().max()):.3e}'
              f', kernels on vs off max_abs_err '
              f'{float((reduced[key] - reduced_off[key]).abs().max()):.3e} '
              f'(relative L2 {rel_l2(torch, reduced[key], reduced_off[key]):.3e}'
              f'); the bf16 plain path against the kernel path max_abs_diff '
              f'{float((dense[key] - on[key]).abs().max()):.3e}', flush=True)
    del model16, plain16, model32, on, off, reduced, reduced_off, dense
    o2, o2_32 = (make_models(torch, dict(uni_o2_model_config(),
                                         compute_dtype=dt))[0]
                 for dt in ('bfloat16', 'float32'))
    bf16_on_off(torch, o2, o2_32, batch, state,
                'uni_o2[m, compute_dtype bf16]')
    del o2, o2_32

    work = REPO / 'build' / 'bf16_phase'
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    # each dtype twice, in turns, so that neither gains from going second
    order = ('float32', 'bfloat16', 'bfloat16', 'float32')
    runs = {dtype: [] for dtype in order}
    try:
        store = work / 'synthetic.ddstore'
        write_pockets(store, ENTRY_POCKETS)
        for i, dtype in enumerate(order):
            sub = work / f'{i}_{dtype}'
            sub.mkdir()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            launches, summaries = sample_store(
                per_call, sub, store, len(ENTRY_POCKETS),
                f'entry point[compute_dtype {dtype}]',
                model_cfg=dict(DEFAULT_MODEL_CONFIG, compute_dtype=dtype))
            calls = sum(len(s['shapes']) for s in summaries) * STEPS
            n_mol = sum(s['n'] for s in summaries)
            runs[dtype].append(dict(
                launches=launches,
                mol_s=sum(s[k] for s in summaries for k in (
                    'host_s', 'device_s', 'recon_s')) / n_mol,
                step_ms=sum(s['device_s'] for s in summaries) / calls * 1e3,
                sample_mib=torch.cuda.max_memory_allocated() / 2**20))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    trained = {dtype: [] for dtype in order}
    for dtype in order:
        trained[dtype].append(bf16_train_run(
            torch, batch, dict(DEFAULT_MODEL_CONFIG, compute_dtype=dtype),
            per_call, f'uni_o2_bond[compute_dtype {dtype}]'))
    for dtype in runs:
        def col(key, fmt, rs=runs[dtype]):
            return ' / '.join(format(r[key], fmt) for r in rs)
        print(f'compute_dtype {dtype} (runs {order} in turns; this '
              f'dtype\'s two): {col("mol_s", ".5f")} s/molecule through '
              f'the sampling entry point (host set-up, device sampling and '
              f'reconstruction), {col("step_ms", ".3f")} ms device sampling '
              f'per step (B={B}), peak device memory '
              f'{col("sample_mib", ".1f")} MiB sampling; training '
              + ' / '.join(f'{t[1]:.4f}' for t in trained[dtype])
              + ' s/step, peak '
              + ' / '.join(f'{t[2]:.1f}' for t in trained[dtype])
              + f' MiB; on {gpu_name_and_limit()}', flush=True)
    return runs['bfloat16'][-1]['launches'], trained['bfloat16'][-1][0]


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


def write_pockets(path, pockets):
    """A synthetic store (data/synthetic.py) of pockets given as (protein
    atoms, ligand atoms, arms)."""
    from decompdiff_tpu_torch.data.synthetic import write_synthetic_store
    write_synthetic_store(str(path), [
        dict(n_protein=n_p, n_ligand=n_l, num_arms=arms)
        for n_p, n_l, arms in pockets])


def write_seeded_ckpt(path, cfg):
    """A JAX-layout .ckpt of the model of `cfg` with seed 0's parameters
    (config and params, no optimizer state), as the sampler reads one."""
    from decompdiff_tpu_torch.models.diffusion_model import DecompDiffModel
    from decompdiff_tpu_torch.utils.params import state_dict_to_flax
    seeded = DecompDiffModel.create(cfg, 8, device='cpu', seed=0)
    with open(path, 'wb') as f:
        pickle.dump({'config': {'data': {'transform': {
                         'ligand_atom_mode': 'basic'}}, 'model': cfg},
                     'params': state_dict_to_flax(
                         seeded.denoiser.state_dict()),
                     'step': 0, 'iteration': 0}, f, protocol=4)


def sample_store(per_call, work, store, n_pockets, label, catch=None,
                 model_cfg=None):
    """The sampling driver as a user runs it on store's first n_pockets
    pockets: a JAX-layout .ckpt of the seeded released uni_o2_bond model
    (config and params, no optimizer state; `model_cfg`, when given, is the
    checkpoint's model config), ENTRY_SAMPLE_CFG,
    --use_pallas, B=8, every launch counter set to 0 just before and read
    just after. Checks the launches (no per-row or other launch) and the
    result pickles; prints seconds per molecule split into host set-up,
    device sampling and reconstruction. `catch`, a dict, receives the
    driver's model ('model') and the first batch it collates ('batch').
    Returns the launches and the pockets' summaries."""
    import numpy as np

    from decompdiff_tpu_torch.config import Config
    from decompdiff_tpu_torch.sampling import driver
    from decompdiff_tpu_torch.utils.testing import DEFAULT_MODEL_CONFIG
    cfg = dict(model_cfg or DEFAULT_MODEL_CONFIG)
    ckpt = work / 'uni_o2_bond.ckpt'
    write_seeded_ckpt(ckpt, cfg)
    ids = [str(i) for i in range(n_pockets)]
    args = driver.build_parser().parse_args(
        ['configs/sampling.yml', '--ckpt', str(ckpt), '-i', *ids,
         '--outdir', str(work / 'out'), '--batch_size', str(B),
         '--use_pallas'])
    config = Config({'data': {'path': str(store)},
                     'sample': ENTRY_SAMPLE_CFG})
    from decompdiff_tpu_torch import native
    ops = model_ops()
    collate, load = driver.collate, driver.load_model_from_checkpoint
    if catch is not None:
        def collating(*a, **k):
            batch = collate(*a, **k)
            catch.setdefault('batch', batch)
            catch.setdefault('collate', []).append((a, k))
            return batch

        def loading(*a, **k):
            catch['model'], ckpt = load(*a, **k)
            return catch['model'], ckpt
        driver.collate, driver.load_model_from_checkpoint = collating, loading
    try:
        zero_launches()
        for counts in (native.calls, native.plain_calls):
            counts.update(dict.fromkeys(counts, 0))
        t0 = time.perf_counter()
        summaries = driver.run(args, config)
        elapsed = time.perf_counter() - t0
        launches = get_launches()
        native_calls = dict(native.calls)
        plain_calls = dict(native.plain_calls)
    finally:
        driver.collate, driver.load_model_from_checkpoint = collate, load

    calls = sum(len(s['shapes']) for s in summaries) * STEPS
    expect = {n: per_call.get(n, 0) * calls for n in launches}
    shapes = sorted({sh for s in summaries for sh in s['shapes']})
    print(f'{label} path: {len(summaries)} pockets x '
          f'{ENTRY_SAMPLES} molecules, batches {shapes} (B, Np, Nl), '
          f'{STEPS} strided guided steps: {calls} denoiser calls, '
          f'launches {nonzero(launches)} (expected {nonzero(expect)}, '
          f'every other counter 0)', flush=True)
    check(launches == expect,
          f'{label} launch counts differ from the expected')
    print(f'{label}: native host library calls (csrc/ddnative.cpp) '
          f'{nonzero(native_calls)}, the JAX package\'s plain routes '
          f'{plain_calls}', flush=True)
    check(sum(native_calls.values()) > 0,
          f'{label}: the path called no routine of the native library')
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
    print(f'{label}: reconstructed {n_recon}/{n_mol}, complete '
          f'{n_complete}/{n_mol}', flush=True)
    print(f'{label} seconds per molecule ({n_mol} molecules, '
          f'{elapsed:.3f} s in all, checkpoint and store loading '
          f'included): {elapsed / n_mol:.5f}; host set-up '
          f'{host / n_mol:.5f}, device sampling {dev / n_mol:.5f}, '
          f'reconstruction {recon / n_mol:.5f}; per pocket (host, '
          f'device, recon s): '
          + ', '.join(f'{s["host_s"]:.4f}/{s["device_s"]:.4f}/'
                      f'{s["recon_s"]:.4f}' for s in summaries)
          + f' on {gpu_name_and_limit()}', flush=True)
    return launches, summaries


def batch_kernel_phase(torch, model, batch, label):
    """The kernels at a main path's own batch: one denoiser call of
    `model` (a kernel model) at the last timestep from the batch's initial
    ligand, as the sampling driver passes it. Each kernel mode's first-layer
    inputs, caught at the plain versions under plain_versions, go through
    the kernel and its plain version (check_forward, KERNEL_RTOL /
    KERNEL_ATOL); then the whole call kernels on vs off (denoiser_on_off,
    PATH_RTOL / PATH_ATOL). These launches count in no path."""
    ops = model_ops()
    state = (batch.ligand_pos, batch.ligand_v, batch.bond_type)
    t = torch.full((batch.batch_size,), model.num_timesteps - 1,
                   dtype=torch.long, device=model.device)
    shape = (f'B{batch.batch_size} Np{batch.num_protein_atoms} '
             f'Nl{batch.num_ligand_atoms}')
    captured = capture_inputs(torch, ops, model, batch, (*state, t),
                              wrapped=True)
    check(sorted(captured) == sorted(
              [('edge_attention', 'node'), ('edge_attention', 'pos'),
               ('bond_attention', 'node'), ('bond_attention', 'pos'),
               ('triplet_attention', 'node')]),
          f'{label}: kernel modes {sorted(captured)}')
    with torch.no_grad():
        for (name, mode), (args, kw) in modes(captured):
            check_forward(torch, {}, name, f'{mode} {label} {shape}', args,
                          kw, KERNEL_RTOL, KERNEL_ATOL)
    denoiser_on_off(torch, model, model, batch, state, f'{label} {shape}',
                    plain_ctx=lambda: plain_versions(ops))


def entry_phase(torch, per_call):
    """The sampling entry point as a user runs it (sample_store) on a
    synthetic pocket store (ENTRY_POCKETS), -i 0 1, then its evaluation
    (evaluation_phase). Returns the sampling run's launches."""
    import shutil

    work = REPO / 'build' / 'entry_phase'
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    try:
        store = work / 'synthetic.ddstore'
        write_pockets(store, ENTRY_POCKETS)
        caught = {}
        launches, summaries = sample_store(
            per_call, work, store, len(ENTRY_POCKETS), 'entry point', caught)
        native_collate_phase(caught['collate'], 'entry point')
        del caught
        rows = sampled_rows(summaries)
        native_bonds_phase(rows, 'entry point')
        visualize_phase(rows, work, 'entry point')
        evaluation_phase(model_ops(), work, store, summaries)
        return launches
    finally:
        shutil.rmtree(work, ignore_errors=True)


class RecordingModule:
    """Stands in for a module: calls its functions and records each call's
    name and arguments."""

    def __init__(self, module):
        self.module, self.calls = module, []

    def __getattr__(self, name):
        fn = getattr(self.module, name)

        def call(*args):
            self.calls.append((name, args))
            return fn(*args)
        return call


def same_result(got, want):
    """Equal values, dtypes and structure (arrays, lists, dicts, None)."""
    import numpy as np
    if isinstance(want, dict):
        return (isinstance(got, dict) and got.keys() == want.keys()
                and all(same_result(got[k], want[k]) for k in want))
    if isinstance(want, (tuple, list)) and want and isinstance(
            want[0], np.ndarray):
        return (isinstance(got, type(want)) and len(got) == len(want)
                and all(same_result(g, w) for g, w in zip(got, want)))
    if isinstance(want, np.ndarray):
        return (isinstance(got, np.ndarray) and got.dtype == want.dtype
                and np.array_equal(got, want))
    return type(got) is type(want) and got == want


def host_seconds(fn, *args):
    """Host seconds per call of fn(*args), over NATIVE_REPS calls after
    one warm-up; returns (seconds, the warm-up's result)."""
    out = fn(*args)
    t0 = time.perf_counter()
    for _ in range(NATIVE_REPS):
        fn(*args)
    return (time.perf_counter() - t0) / NATIVE_REPS, out


def native_compare(calls, label, count, what):
    """Each (routine, args) of `calls` through the C library (native.py)
    and its plain version (native.plain) on the card's host: results
    bitwise equal; prints the host ms of each routine, C and plain, summed
    over the calls and divided by `count` (of `what`: batch, receptor)."""
    from decompdiff_tpu_torch import native
    per_routine = {}
    for name, args in calls:
        c_s, got = host_seconds(getattr(native, name), *args)
        plain_s, want = host_seconds(getattr(native.plain, name), *args)
        check(same_result(got, want),
              f'{label}: native.{name} differs from its plain version')
        c, plain, n = per_routine.get(name, (0.0, 0.0, 0))
        per_routine[name] = (c + c_s, plain + plain_s, n + 1)
    c_all = sum(c for c, _, _ in per_routine.values()) / count
    plain_all = sum(p for _, p, _ in per_routine.values()) / count
    print(f'{label} native host library: {len(calls)} calls, {count} x '
          f'{what}, every result bitwise its plain version\'s; host ms per '
          f'{what}, C / plain: '
          + ', '.join(f'{name} ({n}) {c / count * 1e3:.4f} / '
                      f'{p / count * 1e3:.4f}'
                      for name, (c, p, n) in per_routine.items())
          + f'; all {c_all * 1e3:.4f} / {plain_all * 1e3:.4f} '
          f'({plain_all / max(c_all, 1e-12):.2f}x) on {gpu_name_and_limit()}',
          flush=True)
    return c_all, plain_all


def native_collate_phase(collate_calls, label):
    """The padding routines of every batch the sampling driver collated
    (the entry phase: B=8, Np=320, Nl=32; the prepared store: B=8, Np=384,
    Nl=16), replayed through the C library and its plain versions
    (native_compare)."""
    from decompdiff_tpu_torch import native
    from decompdiff_tpu_torch.data import collate
    calls, shapes = [], []
    for args, kwargs in collate_calls:
        recorder = RecordingModule(native)
        collate.native = recorder
        try:
            batch = collate.collate(*args, **dict(kwargs, device='cpu'))
        finally:
            collate.native = native
        calls += recorder.calls
        shapes.append((batch.batch_size, batch.num_protein_atoms,
                       batch.num_ligand_atoms))
    check(calls, f'{label}: no padding routine was called')
    print(f'{label} collated batches (B, Np, Nl): {shapes}', flush=True)
    native_compare(calls, f'{label} collate', len(shapes), 'batch')


def sampled_rows(summaries):
    """The result rows of the sampling driver's pickles."""
    from decompdiff_tpu_torch.sampling import driver
    return [r for s in summaries
            for r in driver.load_result(s['path'])['results']]


def native_bonds_phase(rows, label):
    """The bond candidates of each sampled molecule (its predicted atoms
    with reconstruct/ligan.py's radii, stretch 1.3, min_d 0) through the C
    library and its plain version (native_compare)."""
    import numpy as np

    from decompdiff_tpu_torch.constants import atomic_numbers_from_index
    from decompdiff_tpu_torch.reconstruct import ligan
    calls = []
    for r in rows:
        element = atomic_numbers_from_index(r['pred_v'], 'basic')
        radii = np.array([ligan._r(z) for z in element], np.float32)
        calls.append(('perceive_bonds_native',
                      (np.asarray(r['pred_pos'], np.float64), radii, 1.3,
                       0.0)))
    native_compare(calls, f'{label} bond candidates',
                   len(rows), 'molecule')


def native_parse_phase(paths, label):
    """The raw receptors through the C PDB parser and its plain version:
    every field equal (native_compare)."""
    calls = [('parse_pdb_atoms_native', (Path(p).read_text(),))
             for p in paths]
    native_compare(calls, f'{label} PDB parser', len(paths), 'receptor')


def visualize_phase(rows, work, label):
    """The sampled molecules (their predicted atoms, positions and bonds
    as MolRecords) through the port's utils/visualize.py: one 3Dmol HTML
    view (visualize_ligand; without py3Dmol on the host, the first-party
    recorder of utils/viewer3d.py) and one draw_mol_grid SVG; both checked
    non-empty and holding every molecule."""
    import numpy as np

    from decompdiff_tpu_torch.constants import atomic_numbers_from_index
    from decompdiff_tpu_torch.data.mol import MolRecord
    from decompdiff_tpu_torch.utils import visualize
    mols = []
    for r in rows:
        bond = np.asarray(r['pred_bond'])
        src, dst = np.nonzero(bond)
        mols.append(MolRecord(
            element=atomic_numbers_from_index(r['pred_v'], 'basic'),
            pos=np.asarray(r['pred_pos'], np.float32),
            bond_index=np.stack([src, dst]), bond_type=bond[src, dst],
            aromatic=np.zeros(len(r['pred_v']), bool)))
    t0 = time.perf_counter()
    view = visualize.visualize_ligand(mols)
    html = Path(view.write_html(str(work / 'sampled.html'))).read_text()
    html_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    svg = visualize.draw_mol_grid(
        mols, legends=[f'sample {i}' for i in range(len(mols))])._repr_svg_()
    svg_s = time.perf_counter() - t0
    check(html.count('viewer.addModel(') == len(mols)
          and '$3Dmol.createViewer' in html,
          f'{label}: the 3Dmol view holds {html.count("viewer.addModel(")} '
          f'of {len(mols)} molecules')
    check(svg.startswith('<svg') and svg.count('<g transform=') == len(mols)
          and svg.count('<line') > 0,
          f'{label}: the SVG grid holds {svg.count("<g transform=")} of '
          f'{len(mols)} molecules')
    print(f'{label} visualize: {len(mols)} sampled molecules, 3Dmol HTML '
          f'({type(view).__module__}) {len(html)} characters in '
          f'{html_s:.3f} s, draw_mol_grid SVG {len(svg)} characters '
          f'({svg.count("<line")} bond lines) in {svg_s:.3f} s',
          flush=True)


def evaluate_counted(ops, outdir, label):
    """The evaluation entry point as a user runs it on outdir's result
    pickles: scripts/evaluate_torch.py (decompdiff_tpu_torch/evaluation/
    driver.py, the port of scripts/evaluate.py), --docking_mode none, run
    in this process (runpy) so that its launches stay countable; checks
    that it launched no kernel and wrote scripts/evaluate.py's keys, and
    that every chem row is first-party with QED and SA in [0, 1]. Returns
    its eval_summary.pkl and the seconds it took."""
    import runpy
    argv = sys.argv
    sys.argv = ['evaluate_torch.py', str(outdir), '--docking_mode', 'none']
    before = get_launches()
    t0 = time.perf_counter()
    try:
        runpy.run_path(str(REPO / 'scripts' / 'evaluate_torch.py'),
                       run_name='__main__')
    finally:
        sys.argv = argv
    elapsed = time.perf_counter() - t0
    after = get_launches()
    check(after == before, f'{label}: the evaluation launched kernels '
          f'{nonzero({n: after[n] - before[n] for n in after})}')
    with open(outdir / 'eval_summary.pkl', 'rb') as f:
        summary = pickle.load(f)
    check(summary.keys() == EVAL_SUMMARY_KEYS,
          f'{label}: eval_summary.pkl keys {sorted(summary)}')
    chem = summary['chem']
    check(len(chem) == summary['n_complete'],
          f'{label}: {len(chem)} chem rows for {summary["n_complete"]} '
          'complete molecules')
    if chem:
        check(summary['chem_backend'] == 'first_party'
              and all(c['chem_backend'] == 'first_party' for c in chem),
              f'{label}: chem backend {summary["chem_backend"]}')
        check(all(0.0 <= c['qed'] <= 1.0 and 0.0 <= c['sa'] <= 1.0
                  for c in chem), f'{label}: a QED or SA outside [0, 1]')
    return summary, elapsed


def jsd_values(summary):
    return ([v for k in ('bond_jsd', 'pair_jsd')
             for v in summary[k].values()] + [summary['atom_type_jsd']])


def write_store_ligands(store, path):
    """Writes the store's own ligands as a result pickle, as the sampling
    driver writes results (every one complete, basic atom types). Returns
    the rows."""
    import numpy as np

    from decompdiff_tpu_torch.constants import MAP_ATOM_BASIC
    from decompdiff_tpu_torch.data.mol import MolRecord
    from decompdiff_tpu_torch.data.store import DDStore
    from decompdiff_tpu_torch.sampling import driver
    rows = []
    for rec in DDStore(str(store)):
        n_atoms = len(rec['ligand_element'])
        mol = MolRecord(element=np.asarray(rec['ligand_element']),
                        pos=np.asarray(rec['ligand_pos'], np.float32),
                        bond_index=np.asarray(rec['ligand_bond_index']),
                        bond_type=np.asarray(rec['ligand_bond_type']),
                        aromatic=np.asarray(rec['ligand_atom_is_aromatic']))
        rows.append({'mol': mol, 'complete': True,
                     'pred_pos': mol.pos,
                     'pred_v': np.asarray([MAP_ATOM_BASIC[int(z)]
                                           for z in mol.element]),
                     'pred_bond': np.zeros((n_atoms, n_atoms), np.int64),
                     'ligand_filename': rec['src_ligand_filename']})
    driver.save_result(str(path), {'results': rows, 'atom_mode': 'basic'})
    return rows


def evaluation_phase(ops, work, store, summaries):
    """Scores the entry point's result pickles with the port's evaluation
    driver (evaluate_counted): its counts equal the sampling summaries';
    with a complete molecule every JSD that is not None is finite, with
    none every one is NaN or None, as scripts/evaluate.py gives for an
    empty set. A seeded random model's molecules rarely pass
    reconstruction, so the driver then scores the store's own ligands
    (the reference-ligand evaluation), written as the sampling driver
    writes results: every one complete, a chem row each, every JSD finite.
    Prints seconds per molecule of both; afterwards no module of JAX or of
    the JAX package is loaded."""
    import math

    import numpy as np
    summary, elapsed = evaluate_counted(ops, work / 'out', 'sampled')
    counts = {k: sum(s[c] for s in summaries)
              for k, c in (('n_total', 'n'), ('n_recon', 'n_recon'),
                           ('n_complete', 'n_complete'))}
    check({k: summary[k] for k in counts} == counts,
          f'evaluation counts {[summary[k] for k in counts]} differ from '
          f'the sampling summaries\' {list(counts.values())}')
    jsds = [v for v in jsd_values(summary) if v is not None]
    check(all(math.isfinite(v) for v in jsds) if summary['n_complete']
          else all(math.isnan(v) for v in jsds),
          f'sampled: JSDs {jsds} for {summary["n_complete"]} complete')
    n = summary['n_total']
    print(f'evaluation of the entry point\'s results (scripts/'
          f'evaluate_torch.py, --docking_mode none): {n} molecules, reconstructed '
          f'{summary["n_recon"]}, complete {summary["n_complete"]}, '
          f'{len(summary["chem"])} chem rows; {elapsed:.3f} s, '
          f'{elapsed / n:.5f} s per molecule; no kernel launched; on '
          f'{gpu_name_and_limit()}', flush=True)

    ref_out = work / 'reference_ligands'
    ref_out.mkdir()
    rows = write_store_ligands(store, ref_out / 'result_reference.pkl')
    # twice: the first call loads the SA fragment table (fpscores.pkl.gz)
    ref, first_s = evaluate_counted(ops, ref_out, 'reference ligands')
    again, ref_s = evaluate_counted(ops, ref_out, 'reference ligands')
    check(again == ref, 'reference ligands: a second evaluation differs')
    check(ref['n_total'] == ref['n_complete'] == len(ref['chem'])
          == len(rows), f'reference ligands: {ref["n_complete"]} complete, '
          f'{len(ref["chem"])} chem rows of {len(rows)}')
    jsds = jsd_values(ref)
    check(all(v is None or math.isfinite(v) for v in jsds)
          and any(v is not None for v in jsds),
          f'reference ligands: JSDs {jsds}')
    qed = [c['qed'] for c in ref['chem']]
    sa = [c['sa'] for c in ref['chem']]
    print(f'evaluation of the store\'s {len(rows)} reference ligands '
          f'({sum(len(r["pred_v"]) for r in rows)} atoms): QED '
          f'{np.mean(qed):.4f}, SA {np.mean(sa):.4f}, atom-type JSD '
          f'{ref["atom_type_jsd"]:.4f}; {ref_s:.3f} s, '
          f'{ref_s / len(rows):.5f} s per molecule (the first call, which '
          f'loads the SA fragment table: {first_s:.3f} s); no kernel '
          f'launched; on '
          f'{gpu_name_and_limit()}', flush=True)
    bad = sorted(m for m in sys.modules
                 if m.split('.')[0] in FORBIDDEN_MODULES)
    check(not bad, f'modules of JAX or the JAX package loaded: {bad}')


def reference_phase(torch, per_call):
    """Reference weights and the drift (phase 2c): a reference-layout .pt
    of the released uni_o2_bond model, converted as a user converts it
    (scripts/convert_checkpoint_torch.py in a subprocess); one denoiser
    call of the converted model with the kernels against the float64
    oracle (tests/reference_oracle.py decomp_forward); then the sampling
    driver from the converted .ckpt with ENTRY_SAMPLE_CFG plus REF_DRIFT,
    --use_pallas, every launch counter set to 0 just before and read just
    after. Checks the launches, the drift's calls (the strided steps inside
    its window, per batch) and the result pickles; prints the seconds per
    molecule with the drift's host seconds. Returns the driver run's
    launches."""
    import shutil

    import numpy as np

    sys.path.insert(0, str(REPO / 'tests'))
    import reference_oracle as oracle

    from decompdiff_tpu_torch.config import Config
    from decompdiff_tpu_torch.guidance.ffmin import make_ff_callback
    from decompdiff_tpu_torch.sampling import driver
    from decompdiff_tpu_torch.utils.checkpoint import (
        load_model_from_checkpoint)
    from decompdiff_tpu_torch.utils.testing import (
        DEFAULT_MODEL_CONFIG, padded_complex_batch, ragged_arrays,
        ragged_complexes, save_reference_checkpoint)
    work = REPO / 'build' / 'reference_phase'
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    label = gpu_name_and_limit()
    try:
        cfg = dict(DEFAULT_MODEL_CONFIG)
        sd = oracle.make_reference_state_dict(
            np.random.default_rng(REF_SEED), cfg, 8, 5, 29, 10)
        ref, ckpt = work / 'reference.pt', work / 'converted.ckpt'
        save_reference_checkpoint(str(ref), sd, {
            'model': cfg, 'data': {'transform': {
                'ligand_atom_mode': 'basic'}}}, iteration=0)
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, str(REPO / 'scripts' /
                                 'convert_checkpoint_torch.py'),
             str(ref), '--out', str(ckpt)],
            capture_output=True, text=True, timeout=600)
        check(proc.returncode == 0,
              f'convert_checkpoint_torch.py failed: {proc.stderr[-2000:]}')
        print(f'reference weights: {proc.stdout.strip()} in '
              f'{time.perf_counter() - t0:.2f} s', flush=True)

        model, _ = load_model_from_checkpoint(
            str(ckpt), device='cuda', overrides={'use_pallas': True})
        graphs = ragged_complexes(np.random.default_rng(REF_SEED),
                                  sizes=(REF_COMPLEX,))
        ragged = ragged_arrays(graphs)
        n_p, n_l, _ = REF_COMPLEX
        batch = padded_complex_batch(graphs, n_p, n_l, 4, device='cuda')
        ops = model_ops()
        zero_launches()
        with torch.no_grad():
            preds = model.apply(batch, batch.ligand_pos, batch.ligand_v,
                                batch.bond_type,
                                torch.tensor([3], device='cuda'))
        torch.cuda.synchronize()
        launches = get_launches()
        check(launches == {n: per_call.get(n, 0) for n in launches},
              f'oracle call launches {nonzero(launches)}')
        want = oracle.decomp_forward(
            sd, cfg, 8, 5, ragged['protein_pos'], ragged['protein_feat'],
            ragged['batch_protein'], ragged['ligand_pos'],
            ragged['ligand_v'], ragged['aux'], ragged['batch_ligand'],
            ragged['bond_index'], ragged['bond_type'])
        got = {k: preds[k][0].double().cpu().numpy()
               for k in ('pred_ligand_pos', 'pred_ligand_v', 'pred_bond')}
        got['pred_bond'] = np.stack([got['pred_bond'][i, j] for _, i, j
                                     in ragged['bond_local']])
        errs = {}
        for k, w in want.items():
            errs[k] = float(np.abs(got[k] - w).max())
            check(np.isfinite(got[k]).all() and np.allclose(
                got[k], w, rtol=REF_RTOL, atol=REF_ATOL),
                f'converted model vs oracle: {k} max abs err {errs[k]:.3e}')
        print(f'converted released model, kernels on, vs the float64 '
              f'oracle (B=1, Np={n_p}, Nl={n_l}, launches '
              f'{nonzero(launches)}): max abs err '
              + ', '.join(f'{k} {e:.3e}' for k, e in errs.items())
              + f' (rtol = atol = {REF_RTOL:g})', flush=True)
        del model, preds

        store = work / 'synthetic.ddstore'
        write_pockets(store, ENTRY_POCKETS)
        ids = [str(i) for i in range(len(ENTRY_POCKETS))]
        args = driver.build_parser().parse_args(
            ['configs/sampling.yml', '--ckpt', str(ckpt), '-i', *ids,
             '--outdir', str(work / 'out'), '--batch_size', str(B),
             '--use_pallas'])
        sample_cfg = dict(ENTRY_SAMPLE_CFG, energy_drift=(
            [REF_DRIFT] + ENTRY_SAMPLE_CFG['energy_drift']))
        config = Config({'data': {'path': str(store)},
                         'sample': sample_cfg})
        zero_launches()
        t0 = time.perf_counter()
        summaries = driver.run(args, config)
        elapsed = time.perf_counter() - t0
        launches = get_launches()

        batches = sum(len(s['shapes']) for s in summaries)
        calls = batches * STEPS
        expect = {n: per_call.get(n, 0) * calls for n in launches}
        T = DEFAULT_MODEL_CONFIG['num_diffusion_timesteps']
        ts = np.linspace(T - 1, 0, STEPS).round()
        in_window = int(((ts >= REF_DRIFT['end_time'])
                         & (ts < REF_DRIFT['start_time'])).sum())
        drift_calls = sum(s['drift_calls'] for s in summaries)
        print(f'reference entry path: {len(summaries)} pockets, {calls} '
              f'denoiser calls, launches {nonzero(launches)} (expected '
              f'{nonzero(expect)}); mmff_min drift calls {drift_calls} '
              f'(expected {in_window} in-window steps x {batches} '
              f'batches)', flush=True)
        check(launches == expect,
              'reference entry launch counts differ from the expected')
        check(drift_calls == in_window * batches,
              'mmff_min drift calls differ from the in-window steps')
        n_mol = sum(s['n'] for s in summaries)
        for s in summaries:
            rows = driver.load_result(s['path'])['results']
            check(len(rows) == ENTRY_SAMPLES
                  and all(np.isfinite(r['pred_pos']).all() for r in rows),
                  'reference entry result rows')
        host, dev, drift, recon = (sum(s[k] for s in summaries) for k in (
            'host_s', 'device_s', 'drift_s', 'recon_s'))
        relaxed = sum(s['drift_relaxed'] for s in summaries)
        # the relaxation itself on this host: a random model's ligands are
        # rarely one connected molecule, so the run may drift none
        chain = np.zeros((1, 5, 3), np.float32)
        chain[0, :, 0] = np.arange(5) * 1.9
        chain[0, :, 1] = [0.0, 0.3, -0.2, 0.25, 0.0]
        drifted = chain - make_ff_callback('basic')(
            chain, np.ones((1, 5), np.int64), np.ones((1, 5), bool))
        before, after = (np.linalg.norm(np.diff(c[0], axis=0), axis=1)
                         for c in (chain, drifted))
        check(np.abs(after - 1.52).max() < np.abs(before - 1.52).max(),
              f'ffmin drift of a stretched chain: bonds {before} -> {after}')
        print(f'reference entry seconds per molecule ({n_mol} molecules, '
              f'{elapsed:.3f} s in all): {elapsed / n_mol:.5f}; host set-up '
              f'{host / n_mol:.5f}, device sampling {dev / n_mol:.5f} (of '
              f'which mmff_min drift on the host {drift / n_mol:.5f}), '
              f'reconstruction {recon / n_mol:.5f}; drift_relaxed '
              f'{relaxed} of {drift_calls * B} batch rows drifted (a '
              f'stretched 5-carbon chain: C-C {before.mean():.3f} -> '
              f'{after.mean():.3f} A); on {label}', flush=True)
        return launches
    finally:
        shutil.rmtree(work, ignore_errors=True)


def run_script(name, *argv):
    """Runs scripts/<name> with argv in a subprocess, as a user runs it;
    fails on a non-zero exit. Returns its standard output and seconds."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, str(REPO / 'scripts' / name), *map(str, argv)],
        capture_output=True, text=True, timeout=600)
    seconds = time.perf_counter() - t0
    check(proc.returncode == 0,
          f'{name} failed: {proc.stdout[-1000:]} {proc.stderr[-2000:]}')
    return proc.stdout, seconds


def prep_phase(torch, per_call):
    """Data preparation (phase 2d): RAW_PAIRS raw receptor PDB / ligand SDF
    pairs and a missing receptor (utils/testing.py write_raw_pairs), turned
    into a store by the port's scripts as a user runs them:
    preprocess_subcomplex_torch.py (the L0 decomposition; without RDKit and
    alphaspace2 the first-party alpha-sphere finder and bond-cut
    fragments), import_reference_data_torch.py --index and
    split_dataset_torch.py. Checks the status buckets, the arms, the
    records and the split; then samples the store's first PREP_SAMPLED
    pockets (sample_store), holds the kernels against their plain versions
    on the first batch the driver collated (batch_kernel_phase: its first-
    layer inputs, then one denoiser call kernels on vs off), and scores the
    result pickles and the prepared
    ligands with scripts/evaluate_torch.py; for each prepared ligand
    is_pains, the QED alert count over PREP_ALERTS and eval_arms'
    occupancy and polar ratio against the find_pockets pockets of its
    receptor, with no launch in all the scoring. Prints seconds per pair,
    per record and per molecule. Returns the sampling run's launches."""
    import os
    import shutil
    from collections import Counter

    import numpy as np

    from decompdiff_tpu_torch.data.mol import parse_sdf_file
    from decompdiff_tpu_torch.data.protein import PDBProtein
    from decompdiff_tpu_torch.data.store import DDStore
    from decompdiff_tpu_torch.evaluation import (
        alerts, descriptors, eval_arms, scoring)
    from decompdiff_tpu_torch.preprocess.alphaspace import find_pockets
    from decompdiff_tpu_torch.utils.testing import write_raw_pairs
    t_phase = time.perf_counter()
    work = REPO / 'build' / 'prep_phase'
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    label = gpu_name_and_limit()
    try:
        raw, dest = work / 'raw', work / 'dest'
        index = write_raw_pairs(str(raw), RAW_PAIRS, half=PREP_HALF,
                                seed=PREP_SEED)
        n_receptor = len(PDBProtein(str(raw / index[0]['protein'])).element)
        native_parse_phase([raw / e['protein'] for e in index],
                           'prepared store')
        index.append({'protein': 'missing/missing_rec.pdb',
                      'ligand': index[0]['ligand']})
        with open(work / 'index.pkl', 'wb') as f:
            pickle.dump(index, f)

        out, pre_s = run_script(
            'preprocess_subcomplex_torch.py', work / 'index.pkl',
            '--raw_root', raw, '--dest', dest, '--num_workers',
            PREP_WORKERS, '--timeout', 300)
        fallbacks = [line[3:] for line in out.splitlines()
                     if line.startswith(' - ')]
        with open(dest / 'index.pkl', 'rb') as f:
            results = pickle.load(f)
        with open(dest / 'fail_index.pkl', 'rb') as f:
            fails = pickle.load(f)
        buckets = Counter(['ok'] * len(results)
                          + [e['status'] for e in fails])
        check(buckets == {'ok': RAW_PAIRS, 'missing_file': 1}
              and fails[0]['item']['protein'] == 'missing/missing_rec.pdb',
              f'preprocess status buckets {dict(buckets)}')
        for r in results:
            meta = r['data']
            arms = [set(a) for a in meta['all_submol_atom_idx'][:-1]]
            check(meta['num_arms'] == 2 and len(arms) == 2
                  and {0, 1, 2} <= arms[0] | arms[1]
                  and {6, 7, 8} <= arms[0] | arms[1]
                  and sorted(sum(meta['all_submol_atom_idx'], []))
                  == list(range(9)),
                  f'{r["src_ligand_filename"]}: arms '
                  f'{meta["all_submol_atom_idx"]}')
        print(f'data preparation (preprocess_subcomplex_torch.py): '
              f'{RAW_PAIRS} pairs of {n_receptor}-atom receptors and one '
              f'missing receptor, {PREP_WORKERS} workers; fallbacks '
              f'{fallbacks or "none"}; status {dict(buckets)}; '
              f'{pre_s:.3f} s, {pre_s / RAW_PAIRS:.4f} s per pair (the '
              f'script\'s start included) on {label}', flush=True)

        store = work / 'prepared.ddstore'
        out, store_s = run_script('import_reference_data_torch.py',
                                  '--index', dest, '--out', store)
        out, split_s = run_script('split_dataset_torch.py', store)
        with open(work / 'prepared_split.pkl', 'rb') as f:
            split = pickle.load(f)
        records = DDStore(str(store))
        check(len(records) == RAW_PAIRS
              and sorted(split['train'] + split['test'])
              == sorted(records.keys) and split['test'],
              f'{len(records)} records, split {split}')
        pockets = []
        for rec in records:
            n_p = len(rec['protein_pos'])
            pockets.append(n_p)
            raw_mol = parse_sdf_file(str(raw / rec['src_ligand_filename']))
            check(np.array_equal(rec['ligand_pos'], raw_mol.pos),
                  f'{rec["src_ligand_filename"]}: the record\'s ligand is '
                  'not its raw file\'s')
            check(set(rec) == PREP_RECORD_KEYS and rec['num_arms'] == 2
                  and rec['pocket_atom_masks'].shape == (2, n_p)
                  and n_p < n_receptor
                  and sorted(set(rec['ligand_atom_mask'].tolist()))
                  == [-1, 0, 1],
                  f'{rec["src_ligand_filename"]}: record keys '
                  f'{sorted(rec)}, arms {rec["num_arms"]}, '
                  f'{n_p} pocket atoms')
        print(f'store build (import_reference_data_torch.py --index): '
              f'{len(records)} records, pockets of {min(pockets)}-'
              f'{max(pockets)} atoms, 2 arms each; {store_s:.3f} s, '
              f'{store_s / len(records):.4f} s per record; split '
              f'(split_dataset_torch.py) train {len(split["train"])} test '
              f'{len(split["test"])} in {split_s:.3f} s; the scripts\' '
              f'starts included; on {label}', flush=True)

        caught = {}
        launches, summaries = sample_store(per_call, work, store,
                                           PREP_SAMPLED, 'prepared store',
                                           caught)
        batch_kernel_phase(torch, caught['model'], caught['batch'],
                           'prepared store')
        native_collate_phase(caught['collate'], 'prepared store')
        del caught

        ops = model_ops()
        before = get_launches()
        t0 = time.perf_counter()
        sampled, sampled_s = evaluate_counted(ops, work / 'out',
                                              'prepared store')
        check(sampled['n_total'] == sum(s['n'] for s in summaries),
              f'prepared store: {sampled["n_total"]} molecules scored')
        ligand_out = work / 'prepared_ligands'
        ligand_out.mkdir()
        rows = write_store_ligands(store, ligand_out / 'result_ligands.pkl')
        ligands, ligands_s = evaluate_counted(ops, ligand_out,
                                              'prepared ligands')
        check(ligands['n_complete'] == len(rows),
              f'prepared ligands: {ligands["n_complete"]} complete of '
              f'{len(rows)}')

        corpus = work / 'alerts.smarts'
        corpus.write_text(''.join(f'{s} {n}\n' for n, s in PREP_ALERTS))
        pains, counts, occupancy, polar = [], [], [], []
        previous = os.environ.get('DD_QED_ALERTS_SMARTS')
        os.environ['DD_QED_ALERTS_SMARTS'] = str(corpus)
        try:
            for rec, row in zip(records, rows):
                mol = row['mol']
                pains.append(scoring.is_pains(mol))
                counts.append(descriptors.qed_properties(mol)['ALERTS'])
                receptor = PDBProtein(str(raw / rec['src_protein_filename']))
                elements = np.asarray(receptor.element)
                found = find_pockets(
                    np.asarray(receptor.pos, np.float64).reshape(-1, 3),
                    receptor_element=elements,
                    binder_pos=np.asarray(mol.pos, np.float64))
                check(len(found) >= 2, f'{len(found)} contact pockets')
                for p in found:
                    occupancy.append(eval_arms.compute_occupancy(p, mol.pos))
                    polar.append(eval_arms.compute_polar_ratio(
                        elements, p, mol.element))
        finally:
            if previous is None:
                del os.environ['DD_QED_ALERTS_SMARTS']
            else:
                os.environ['DD_QED_ALERTS_SMARTS'] = previous
        score_s = time.perf_counter() - t0
        after = get_launches()
        check(after == before, 'the scoring launched kernels '
              f'{nonzero({n: after[n] - before[n] for n in after})}')
        check(counts == [PREP_ALERT_COUNT] * len(rows),
              f'QED alert counts {counts}')
        check(not any(pains), f'is_pains {pains}')
        check(all(0.0 <= o <= 1.0 for o in occupancy) and max(occupancy) > 0
              and all(0.0 <= a <= 1.0 and b == 0.0 for a, b in polar),
              f'arm occupancy {occupancy}, polar ratios {polar}')
        print(f'scoring (scripts/evaluate_torch.py, --docking_mode none): '
              f'the prepared store\'s {sampled["n_total"]} sampled '
              f'molecules (reconstructed {sampled["n_recon"]}, complete '
              f'{sampled["n_complete"]}) {sampled_s:.3f} s; its {len(rows)} '
              f'ligands QED {np.mean([c["qed"] for c in ligands["chem"]]):.4f}'
              f', SA {np.mean([c["sa"] for c in ligands["chem"]]):.4f} in '
              f'{ligands_s:.3f} s; is_pains ({alerts.pains_backend()}) '
              f'{sum(pains)} of {len(rows)}; QED alerts over '
              f'{len(PREP_ALERTS)} SMARTS {counts}; arm occupancy over '
              f'{len(occupancy)} contact pockets mean '
              f'{np.mean(occupancy):.4f} (min {min(occupancy):.4f}), '
              f'pocket polar ratio mean {np.mean([a for a, _ in polar]):.4f}'
              f'; all the scoring {score_s:.3f} s, '
              f'{score_s / len(rows):.4f} s per ligand; no kernel launched;'
              f' on {label}', flush=True)
        bad = sorted(m for m in sys.modules
                     if m.split('.')[0] in FORBIDDEN_MODULES)
        check(not bad, f'modules of JAX or the JAX package loaded: {bad}')
        print(f'data preparation phase: {time.perf_counter() - t_phase:.3f}'
              ' s in all (raw files, the three scripts, sampling, scoring) '
              f'on {label}', flush=True)
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
        write_pockets(store, TRAIN_POCKETS)
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
            zero_launches()
            t0 = time.perf_counter()
            summary = driver.run(args, config)
            elapsed = time.perf_counter() - t0
            launches = get_launches()
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
            # n_acc_batch 1: one Adam launch a step
            launches['multi_tensor_adam'] = adam_launches()
            check(launches['multi_tensor_adam'] == len(
                summary['batch_shapes']), f'train entry point ({tag}): '
                f'{launches["multi_tensor_adam"]} Adam kernel launches in '
                f'{len(summary["batch_shapes"])} steps')
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


def torchrun(world, script, argv, log):
    """scripts/<script> under torchrun --standalone on `world` ranks, as a
    user runs it, in its own process group: on a failure or after
    DP_TIMEOUT seconds every process of it is killed and the phase fails.
    Output goes to `log`. Returns the wall seconds."""
    import os
    import signal
    cmd = [sys.executable, '-m', 'torch.distributed.run', '--standalone',
           '--nproc_per_node', str(world), str(REPO / 'scripts' / script),
           *map(str, argv)]
    t0 = time.perf_counter()
    with open(log, 'w') as out:
        proc = subprocess.Popen(cmd, stdout=out, stderr=subprocess.STDOUT,
                                cwd=REPO, start_new_session=True)
        try:
            rc = proc.wait(timeout=DP_TIMEOUT)
        except subprocess.TimeoutExpired:
            rc = None
        finally:
            try:    # the ranks too, whatever torchrun left
                os.killpg(proc.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
            proc.wait()
    seconds = time.perf_counter() - t0
    tail = Path(log).read_text()[-3000:]
    check(rc == 0, f'torchrun {script} on {world} ranks '
          + ('timed out' if rc is None else f'exited {rc}') + f':\n{tail}')
    return seconds


def after_first(values):
    """The mean of the values after the first (which holds the set-up)."""
    return sum(values[1:]) / max(1, len(values) - 1)


def close(np, got, want, msg, rtol, atol=0.0):
    """Fails unless got is within rtol / atol of want elementwise; returns
    the largest absolute difference."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    check(got.shape == want.shape, f'{msg}: shape {got.shape}, not '
          f'{want.shape}')
    diff = np.abs(got - want)
    bad = int((diff > atol + rtol * np.abs(want)).sum())
    check(bad == 0, f'{msg}: {bad} elements outside rtol {rtol} / atol '
          f'{atol} (largest difference {diff.max():.3e})')
    return float(diff.max()) if diff.size else 0.0


def dp_train(torch, np, ops, work, per_call, label):
    """Phase 2e's training half (see dp_phase); returns each rank's
    launches at each world size."""
    from decompdiff_tpu_torch.config import Config
    from decompdiff_tpu_torch.parallel.mesh import choose_backend
    from decompdiff_tpu_torch.training import driver
    from decompdiff_tpu_torch.utils.checkpoint import (
        load_model_from_checkpoint)
    from decompdiff_tpu_torch.utils.params import flax_to_state_dict
    store = work / 'train.ddstore'
    write_pockets(store, TRAIN_POCKETS)
    config = dict(TRAIN_CONFIG, data=dict(TRAIN_CONFIG['data'],
                                          path=str(store)))
    cfg_path = work / 'training.json'     # JSON: no PyYAML needed
    cfg_path.write_text(json.dumps(config))
    common = ['--outdir', work / 'logs', '--max_iters', DP_ITERS,
              '--val_freq', DP_ITERS, '--report_freq', DP_ITERS]

    def params_of(path):
        with open(path, 'rb') as f:
            raw = NumpyOnlyUnpickler(f).load()
        check(set(raw) == CKPT_KEYS, f'{path}: keys {sorted(raw)}')
        rebuilt, _ = load_model_from_checkpoint(path, device='cuda')
        del rebuilt
        return {k: v.numpy()
                for k, v in flax_to_state_dict(raw['params']).items()}

    def in_process(tag):
        args = driver.build_parser().parse_args(
            [str(a) for a in (cfg_path, *common, '--tag', tag)])
        return driver.run(args, Config(config))

    # the reference: the driver in this process, a world of one
    zero_launches()
    t0 = time.perf_counter()
    want = in_process('inproc')
    seconds = time.perf_counter() - t0
    want_launches = get_launches()
    check(want_launches == expected_train_launches(want, per_call,
                                                   want_launches),
          'dp train in-process: launches differ from the expected')
    want_params = params_of(want['checkpoints'][-1])
    print(f'dp train in-process: {DP_ITERS} iterations, {seconds:.3f} s '
          f'in all; s/step after the first '
          f'{after_first(want["step_seconds"]):.5f}; launches '
          f'{nonzero(want_launches)} on {label}', flush=True)
    # the noise floor: the same run again in this process (and W=1 twice
    # below)
    again = in_process('inproc_again')
    moved = params_diff(np, params_of(again['checkpoints'][-1]), want_params)
    print(f'dp train in-process, run again: losses and grad norms per '
          f'iteration {rel_diff(np, again, want):.2e} relative from the '
          f'first run at most, final parameters {moved:.2e} at most; on '
          f'{label}', flush=True)
    by_world, first_w1 = {}, None
    for world, run in DP_TRAIN_RUNS:
        # one rank: NCCL; more ranks than GPUs: gloo
        tag = f'dp train {run}'
        backend = choose_backend(torch.device('cuda'), world,
                                 torch.cuda.device_count())[0]
        path = work / f'train_{run}.json'
        seconds = torchrun(world, 'train_torch.py', [
            cfg_path, *common, '--tag', run, '--summary', path],
            work / f'train_{run}.log')
        got = json.loads(path.read_text())
        check((got['world_size'], got['backend'], got['sharded'],
               got['iterations']) == (world, backend, True,
                                      list(range(1, DP_ITERS + 1))),
              f'{tag}: world {got["world_size"]}, backend {got["backend"]}'
              f', sharded {got["sharded"]}, iterations {got["iterations"]}')
        for k in ('train_loss', 'grad_norm'):
            close(np, got[k], want[k], f'{tag}: {k}', DP_RTOL)
        check([Path(p).name for p in got['checkpoints']]
              == [Path(p).name for p in want['checkpoints']],
              f'{tag}: checkpoints {got["checkpoints"]}')
        params = [params_of(p) for p in got['checkpoints']][-1]
        check(sorted(params) == sorted(want_params),
              f'{tag}: parameter names')
        worst = max(close(np, params[k], v, f'{tag}: {k}', **DP_PARAM_TOL)
                    for k, v in want_params.items())
        by_world[world] = []
        for r in got['ranks']:
            launches = get_launches(r['launches'])
            check(launches == want_launches and r['rows'] == TRAIN_CONFIG[
                      'train']['batch_size'] // world,
                  f'{tag} rank {r["rank"]}: {r["rows"]} rows, launches '
                  f'{nonzero(launches)}, not the in-process run\'s '
                  f'{nonzero(want_launches)}')
            by_world[world].append(launches)
            step = after_first(r['step_seconds'])
            comm = after_first(r['comm_seconds'])
            kinds = ', '.join(f'{rec["calls"] / DP_ITERS:g} {kind}'
                              for kind, rec in sorted(r['comm'].items()))
            mib = sum(rec['bytes'] for rec in r['comm'].values())
            print(f'{tag} rank {r["rank"]} ({backend}, {r["rows"]} '
                  f'complexes a step): s/step after the first {step:.5f}, '
                  f'collectives {comm:.5f} s a step '
                  f'({100 * comm / step:.2f}% of the step; {kinds} and '
                  f'{mib / DP_ITERS / 2**20:.2f} MiB a step); '
                  f'launches {nonzero(launches)} on {label}', flush=True)
        print(f'{tag}: {seconds:.3f} s under torchrun in all; losses and '
              f'grad norms per iteration within rtol {DP_RTOL} of the '
              f'in-process run (largest relative difference '
              f'{rel_diff(np, got, want):.2e}), final parameters within '
              f'{DP_PARAM_TOL} (largest difference {worst:.2e}); '
              f'{len(got["checkpoints"])} checkpoint(s) read back; on '
              f'{label}', flush=True)
        if world == 1 and first_w1 is not None:
            print(f'{tag}: losses and grad norms per iteration '
                  f'{rel_diff(np, got, first_w1[0]):.2e} relative from the '
                  f'first W=1 run at most, final parameters '
                  f'{params_diff(np, params, first_w1[1]):.2e} at most; on '
                  f'{label}', flush=True)
        elif world == 1:
            first_w1 = got, params
    return by_world


def rel_diff(np, got, want):
    """The largest relative difference of two training summaries' losses
    and grad norms, over the iterations."""
    return max(float(np.max(np.abs(np.subtract(got[k], want[k]))
                            / np.abs(want[k])))
               for k in ('train_loss', 'grad_norm'))


def params_diff(np, got, want):
    """The largest absolute difference of two parameter dicts."""
    return max(float(np.max(np.abs(got[k] - v))) for k, v in want.items())


def step_repeat(torch, ops, label):
    """The cause of the noise floor: one training step's gradients twice
    from the same weights, batch and draws, with the kernels and with their
    plain versions (plain_versions), at the released config and the
    training entry point's B=TRAIN_B, Np=NUM_PROTEIN, Nl=32; prints the
    largest difference of each pair (0: that path is deterministic)."""
    import numpy as np

    from decompdiff_tpu_torch.models.diffusion_model import DecompDiffModel
    from decompdiff_tpu_torch.training.train_step import (
        DEFAULT_TRAIN_CONFIG, create_train_state, make_train_fns)
    from decompdiff_tpu_torch.utils.testing import (
        DEFAULT_MODEL_CONFIG, random_complex_batch)
    dev = torch.device('cuda')
    model = DecompDiffModel.create(dict(DEFAULT_MODEL_CONFIG,
                                        use_pallas=True), 8, device=dev,
                                   seed=0)
    batch = random_complex_batch(
        np.random.default_rng(2), batch_size=TRAIN_B, num_protein=NUM_PROTEIN,
        num_ligand=32, num_groups=TRAIN_GROUPS, device=dev)
    grad_step = make_train_fns(model, DEFAULT_TRAIN_CONFIG)[1]
    for key, ctx in (('kernels', contextlib.nullcontext),
                     ('plain versions', lambda: plain_versions(ops))):
        runs = []
        for _ in range(2):
            with ctx():
                runs.append(grad_step(
                    create_train_state(model, DEFAULT_TRAIN_CONFIG), batch,
                    torch.Generator(device=dev).manual_seed(3))[:2])
        (g0, m0), (g1, m1) = runs
        grad = max(float((g0[k] - g1[k]).abs().max()) for k in g0)
        scale = max(float(g.abs().max()) for g in g0.values())
        loss = abs(float(m0['loss'] - m1['loss']))
        print(f'training step twice on the same inputs ({key}, B={TRAIN_B} '
              f'Nl=32): gradients {grad:.3e} apart at most (largest '
              f'|gradient| {scale:.3e}), loss {loss:.3e} apart; on {label}',
              flush=True)


def dp_sample(np, ops, work, per_call, label):
    """Phase 2e's sampling half (see dp_phase); returns each rank's
    launches at each world size."""
    from decompdiff_tpu_torch.sampling import driver
    from decompdiff_tpu_torch.utils.testing import DEFAULT_MODEL_CONFIG
    store = work / 'sample.ddstore'
    write_pockets(store, ENTRY_POCKETS)
    ckpt = work / 'uni_o2_bond.ckpt'
    write_seeded_ckpt(ckpt, dict(DEFAULT_MODEL_CONFIG))
    cfg_path = work / 'sampling.json'
    cfg_path.write_text(json.dumps({'data': {'path': str(store)},
                                    'sample': ENTRY_SAMPLE_CFG}))
    ids = [str(i) for i in range(len(ENTRY_POCKETS))]
    n_mol = ENTRY_SAMPLES * len(ids)
    first, by_world = None, {}
    for world in DP_WORLDS:
        tag, path = f'dp sample W={world}', work / f'sample_w{world}.json'
        seconds = torchrun(world, 'sample_torch.py', [
            cfg_path, '--ckpt', ckpt, '-i', *ids, '--outdir',
            work / f'out_w{world}', '--batch_size', B, '--use_pallas',
            '--summary', path], work / f'sample_w{world}.log')
        got = json.loads(path.read_text())
        calls = sum(len(p['shapes']) for p in got['pockets']) * STEPS
        expect = {n: per_call.get(n, 0) * calls for n in get_launches()}
        by_world[world] = []
        for r in got['ranks']:
            launches = get_launches(r['launches'])
            check(launches == expect and all(
                      rows == [B // world] for rows in r['rows']),
                  f'{tag} rank {r["rank"]}: rows {r["rows"]}, launches '
                  f'{nonzero(launches)}, expected {nonzero(expect)}')
            by_world[world].append(launches)
            print(f'{tag} rank {r["rank"]}: {B // world} molecules a batch,'
                  f' device sampling {sum(r["device_s"]) / n_mol:.5f} s a '
                  f'molecule; launches {nonzero(launches)} on {label}',
                  flush=True)
        rows = [row for p in got['pockets']
                for row in driver.load_result(p['path'])['results']]
        check(len(rows) == n_mol, f'{tag}: {len(rows)} result rows')
        print(f'{tag}: {seconds / n_mol:.5f} s a molecule under torchrun '
              f'({seconds:.3f} s in all, start-up included) on {label}',
              flush=True)
        if first is None:
            first = rows
            continue
        worst = 0.0
        for a, b in zip(first, rows):
            worst = max(worst, close(np, b['pred_pos'], a['pred_pos'],
                                     f'{tag}: positions', **DP_POS_TOL))
            check(np.array_equal(a['pred_v'], b['pred_v'])
                  and np.array_equal(a['pred_bond'], b['pred_bond']),
                  f'{tag}: types or bonds differ from W={DP_WORLDS[0]}')
        print(f'{tag}: result pickles against W={DP_WORLDS[0]}: positions '
              f'within {DP_POS_TOL} (largest difference {worst:.2e}), '
              f'types and bonds equal; on {label}', flush=True)
    return by_world


def dp_rows(torch, label):
    """Each stage of a guided sampling step on the two halves of a batch,
    as two data-parallel ranks compute them, against the whole batch
    (utils/testing.py dp_row_pairs: the protein centroid, each guidance
    gradient, each prediction of one denoiser call), with the kernels at
    the released config, B=8, Np=NUM_PROTEIN, a NUM_FULL-atom full protein
    and each Nl of DP_ROW_NLS: each within DP_ROW_TOL. Where a stage's rows
    part at all, also STEPS strided guided sampling steps of the halves
    against the whole batch, printed only: the discrete type and bond
    draws can turn a last-bit difference into other samples."""
    import numpy as np

    from decompdiff_tpu_torch.data.batch import FullProtein
    from decompdiff_tpu_torch.models.diffusion_model import DecompDiffModel
    from decompdiff_tpu_torch.parallel.mesh import Mesh, shard_batch
    from decompdiff_tpu_torch.sampling.sampler import (
        SampleConfig, sample_diffusion)
    from decompdiff_tpu_torch.utils.testing import (
        DEFAULT_MODEL_CONFIG, DP_ROW_DRIFTS, dp_row_pairs,
        random_complex_batch)
    dev = torch.device('cuda')
    model = DecompDiffModel.create(dict(DEFAULT_MODEL_CONFIG,
                                        use_pallas=True), 8, device=dev,
                                   seed=0)
    t = torch.full((B,), 999, dtype=torch.long, device=dev)
    for nl in DP_ROW_NLS:
        rng = np.random.default_rng(0)
        batch = random_complex_batch(rng, batch_size=B,
                                     num_protein=NUM_PROTEIN, num_ligand=nl,
                                     num_groups=NUM_GROUPS, device=dev)
        fp = FullProtein(
            pos=torch.as_tensor(rng.normal(size=(B, NUM_FULL, 3)) * 8,
                                dtype=torch.float32, device=dev),
            mask=torch.ones((B, NUM_FULL), dtype=torch.bool, device=dev))
        diffs = {}
        for stage, (whole, halves) in dp_row_pairs(model, batch, fp,
                                                    t).items():
            diffs[stage] = float((halves - whole).abs().max())
            bad = int((~torch.isclose(halves, whole, **DP_ROW_TOL)).sum())
            check(bad == 0, f'dp rows Nl={nl} {stage}: {bad} elements '
                  f'outside {DP_ROW_TOL} (largest difference '
                  f'{diffs[stage]:.3e})')
        print(f'dp rows Nl={nl}: two ranks\' rows against the whole batch '
              f'(B={B}, Np={NUM_PROTEIN}), largest differences within '
              f'{DP_ROW_TOL}: ' + ', '.join(f'{k} {v:.3e}'
                                           for k, v in diffs.items())
              + f'; on {label}', flush=True)
        if not any(diffs.values()):
            continue
        cfg = SampleConfig(num_steps=STEPS, save_traj=False,
                           skip_mode='strided', energy_drift=DP_ROW_DRIFTS)

        def sample(mesh=None):
            b, f = shard_batch(batch, mesh), shard_batch(fp, mesh)
            return sample_diffusion(
                model, cfg, b, b.ligand_pos, b.ligand_v, b.bond_type, f,
                generator=torch.Generator(device=dev).manual_seed(5),
                **({} if mesh is None else {'mesh': mesh}))
        whole = sample()
        halves = [sample(Mesh(r, 2, r, dev, None)) for r in range(2)]
        got = {k: torch.cat([h[k] for h in halves]) for k in whole
               if k in ('pos', 'v', 'bond')}
        print(f'dp rows Nl={nl}: {STEPS} strided guided sampling steps of '
              f'the halves against the whole batch (not checked): positions '
              f'{float((got["pos"] - whole["pos"]).abs().max()):.3e} apart '
              f'at most, {int((got["v"] != whole["v"]).sum())} types and '
              f'{int((got["bond"] != whole["bond"]).sum())} bonds differ; on '
              f'{label}', flush=True)


def dp_phase(torch, per_call):
    """Data parallel through both entry points (phase 2e), in
    build/dp_phase. First dp_rows, and step_repeat (what makes two runs
    of the same training differ). Training: the training driver for
    DP_ITERS iterations in this process, twice (the second run's distance
    from the first is the noise floor the dp tolerances sit above), then
    scripts/train_torch.py under torchrun for each of DP_TRAIN_RUNS (W=1
    twice, then W=2): per iteration the losses and grad norms, then the
    last checkpoint's parameters against the first in-process run's; the
    second W=1 run's distance from the first printed; every checkpoint
    read back; each rank's launches the in-process run's (every step's
    kernels once per layer and mode, on its B/W rows), none per row.
    Sampling: scripts/sample_torch.py under torchrun at each world size on
    the entry phase's pockets: each rank's launches calls x 12/12/6 on its
    B/W rows, the result pickles against the first world size's. Prints
    s/step, s/molecule, each rank's step seconds and its collectives'
    share of the step. Returns each rank's launches at the last world
    size, {'train': [...], 'sample': [...]}."""
    import shutil

    import numpy as np
    work = REPO / 'build' / 'dp_phase'
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    label = gpu_name_and_limit()
    ops = model_ops()
    try:
        dp_rows(torch, label)
        step_repeat(torch, ops, label)
        train = dp_train(torch, np, ops, work, per_call, label)
        sample = dp_sample(np, ops, work, per_call, label)
        return {'train': train[DP_WORLDS[-1]],
                'sample': sample[DP_WORLDS[-1]]}
    finally:
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
            zero_launches()
            top.update(backward_phase(torch, ops, {
                (f'triplet_attention_nl{nl}', mode): call}))
            launches = get_launches()
            check(launches[TOP_RECORD] > 0
                  and launches['triplet_attention_backward_row'] == 0,
                  f'the Nl={nl} triplet backward did not take its head '
                  f'route: {nonzero(launches)}')
        backward_phase(torch, ops, captured)
        del batch, captured
    check(set(top) == {TOP_RECORD},
          f'no training bucket at Nl={TRIPLET_HEAD_NL}')
    return top


def kernel_records(results, launches, entry_launches, train_entry_launches,
                   ref_launches, prep_launches, bf16_entry_launches,
                   bf16_train_launches, dp_launches):
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
    point (train_entry_phase, both runs); reference_entry_launches: through
    the sampling entry point from converted reference weights with the
    mmff_min drift (reference_phase); prep_entry_launches: through the
    sampling entry point on the store the data-preparation scripts built
    from raw files (prep_phase); bf16_entry_launches and
    bf16_train_launches: through the sampling entry point from a .ckpt
    whose config sets compute_dtype bfloat16, and through TRAIN_STEPS
    training steps of that config (compute_bf16_phase);
    dp_train_launches and dp_sample_launches: each rank's, in rank order,
    through the training and the sampling script under torchrun on
    DP_WORLDS[-1] ranks (dp_phase). The Adam kernel's record (adam_phase)
    counts its launches through the training path and the training entry
    point; the bf16 and data-parallel training runs do not count them
    (None), and no sampling path runs it (0)."""
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
            'reference_entry_launches': ref_launches.get(name, 0),
            'prep_entry_launches': prep_launches.get(name, 0),
            'bf16_entry_launches': bf16_entry_launches.get(name, 0),
            'bf16_train_launches': bf16_train_launches.get(name, 0),
            'dp_train_launches': [r.get(name, 0)
                                  for r in dp_launches['train']],
            'dp_sample_launches': [r.get(name, 0)
                                   for r in dp_launches['sample']],
            'max_abs_err': r['err'],
            'ms': ms, 'plain_ms': plain_ms,
            'bound_ms': max(t_ops, t_bytes),
            'bound_by': 'operations' if t_ops >= t_bytes else 'bytes',
            'bound_fp32_ms': max(t_fp32, t_bytes),
            # no single PyTorch call computes these fused MLP attentions or
            # their gradients; Adam's: torch's fused Adam
            'library_ms': r.get('library_ms'),
        })
        if name == 'multi_tensor_adam':
            kernels[-1].update(bf16_train_launches=None,
                               dp_train_launches=None)
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


def zero_launches():
    """Sets the launch count of every forward and backward kernel, and the
    optimizer's Adam kernel's, to 0."""
    from decompdiff_tpu_torch.ops import multi_tensor_adam, zero_launch_counts
    zero_launch_counts()
    multi_tensor_adam.multi_tensor_adam.launches = 0


def adam_launches():
    """The optimizer's Adam kernel's launches (multi_tensor_adam.launches,
    which ops.launch_counters and so get_launches leave out)."""
    from decompdiff_tpu_torch.ops import multi_tensor_adam
    return multi_tensor_adam.multi_tensor_adam.launches


def get_launches(counts=None):
    """Each kernel record's launch count, 0 where none: the counts of
    decompdiff_tpu_torch/ops launch_counts() (its launch_counters' names),
    or `counts`, a rank's launches from a driver's summary (ops
    launches_since); TOP_RECORD is the triplet backward's launches at
    Nl=TRIPLET_HEAD_NL."""
    from decompdiff_tpu_torch.ops import launch_counters, launch_counts
    counts = launch_counts() if counts is None else counts
    return {n: counts.get(n, 0) for n in [*launch_counters(), TOP_RECORD]}


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
        dp_launches = dp_phase(torch, bond_calls)
        ref_launches = reference_phase(torch, bond_calls)
        prep_launches = prep_phase(torch, bond_calls)
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
            triplet_batch_phase(torch, captured[('triplet_attention',
                                                 'node')])
        results.update(backward_phase(torch, ops, captured))
        results.update(nl64)
        results.update(adam_phase(torch, bond_cfg))
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
        bf16_entry_launches, bf16_train_launches = compute_bf16_phase(
            torch, batch, bond_calls)
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
        if n == 'multi_tensor_adam':
            launches[n] = train_launches[n]
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
        results, launches, entry_launches, train_entry_launches,
        ref_launches, prep_launches, bf16_entry_launches,
        bf16_train_launches, dp_launches)}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
