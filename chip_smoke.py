#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (decompdiff_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # from the root of a repository checkout

1. Device: requires CUDA, turns TF32 off, prints the card's name and power
   limit (nvidia-smi).
2. Build: compiles the three CUDA kernels of csrc/ with nvcc (timed set-up).
3. Kernels: records the inputs each of the five kernel modes gets in the first
   layer of a released-config denoiser call (B=8, Np=320, Nl=32), then holds
   every kernel against its plain PyTorch version on those inputs and times
   both with CUDA events.
4. Path: guided reverse diffusion (armsca_prox + clash at every step) with the
   released uni_o2_bond config and kernels on, with every launch counter set
   to 0 just before and read just after; then one denoiser call with kernels
   on against kernels off.
5. Prints the kernels JSON line and, last, the device JSON line.

Any failed check exits non-zero. Needs torch and numpy only.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
B, NUM_PROTEIN, NUM_LIGAND, NUM_FULL, NUM_GROUPS = 8, 320, 32, 2048, 6
STEPS = 20
# H100 SXM published peaks: FP32 outside the tensor cores, HBM3 bandwidth
PEAK_FLOPS, PEAK_BYTES = 67e12, 3.35e12
# kernel vs plain version: both float32, different summation order
KERNEL_RTOL, KERNEL_ATOL = 1e-3, 1e-4
# one denoiser call, kernels on vs off: six layers of the above, on
# coordinates of a few Angstrom and logits of order one
PATH_RTOL, PATH_ATOL = 1e-3, 1e-3
KERNEL_SOURCES = {
    'edge_attention': 'decompdiff_tpu/ops/pallas/edge_kernel.py:540',
    'bond_attention': 'decompdiff_tpu/ops/pallas/bond_kernel.py:128',
    'triplet_attention': 'decompdiff_tpu/ops/pallas/triplet_kernel.py:172',
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
    print(f'build: {len(_build.KERNELS)} kernels in '
          f'{time.perf_counter() - t0:.1f} s (set-up)', flush=True)
    for name, log in logs.items():
        for line in log.splitlines():
            if 'registers' in line or 'spill' in line:
                print(f'  {name}: {line.strip()}')


def time_ms(torch, fn, iters=20, warmup=3):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def capture_inputs(torch, ops, plain_model, batch, state):
    """The arguments of the first call of each kernel mode in one denoiser
    call (kernels off), keyed by (kernel name, pos_mode)."""
    captured = {}
    originals = {}
    for name, mod in ops.items():
        fn_name = f'{name}_reference'
        orig = originals[name] = getattr(mod, fn_name)

        def record(*args, _name=name, _orig=orig, **kw):
            captured.setdefault((_name, kw.get('pos_mode', False)),
                                (args, kw))
            return _orig(*args, **kw)
        setattr(mod, fn_name, record)
    try:
        with torch.no_grad():
            plain_model.apply(batch, *state)
    finally:
        for name, mod in ops.items():
            setattr(mod, f'{name}_reference', originals[name])
    return captured


def work(torch, name, args, kw, out):
    """(FLOPs, bytes) the call needs on these inputs: 2 per multiply-add of
    the per-pair products and of q.k and alpha.v over valid (row, source)
    pairs only (LayerNorm, exp and adds left out, so the bound is a lower
    bound); every input read once and the output written once."""
    tensors = [a for a in args if torch.is_tensor(a)]
    for a in args:
        if isinstance(a, tuple):
            tensors += list(a)
    nbytes = sum(t.numel() * t.element_size() for t in tensors)
    nbytes += out.numel() * out.element_size()
    H = args[-3].shape[-1]                # every kernel takes (..., q, k, v)
    nh = kw['n_heads']
    pos = kw.get('pos_mode', False)
    v_out = 2 * H * nh + 2 * H + 6 * nh if pos else 2 * H * H + 2 * H
    attn = 2 * H * H + 2 * H + v_out      # k second linear, q.k, v and alpha.v
    if name == 'edge_attention':          # (x, lig, group, idx, mask, ...)
        pairs = int((args[4] > 0.5).sum())
        n_types = 1 if args[2] is None else 2
        per_pair = 2 * 2 * 21 * n_types * H + attn
    elif name == 'bond_attention':        # (h_bond, x, mask, ...)
        pairs = int((args[2] > 0.5).sum())
        per_pair = 2 * 2 * H * H + attn
    else:                                 # (angle, mask, ...)
        from decompdiff_tpu_torch.ops.triplet_attention import triplet_mask
        pairs = int(triplet_mask(args[1]).sum())
        per_pair = 2 * 2 * 13 * H + attn
    return pairs * per_pair, nbytes


def kernel_phase(torch, ops, captured):
    results = {}
    for (name, pos), (args, kw) in sorted(captured.items()):
        mod = ops[name]
        kernel = getattr(mod, name)
        plain = getattr(mod, f'{name}_reference')
        ref = plain(*args, **kw)
        out = kernel(*args, **kw)
        torch.cuda.synchronize()
        err = (out - ref).abs()
        max_abs = float(err.max())
        max_rel = float((err / ref.abs().clamp_min(1e-6)).max())
        ok = bool(torch.allclose(out, ref, rtol=KERNEL_RTOL,
                                 atol=KERNEL_ATOL))
        ms = time_ms(torch, lambda: kernel(*args, **kw))
        plain_ms = time_ms(torch, lambda: plain(*args, **kw))
        flops, nbytes = work(torch, name, args, kw, out)
        t_ops, t_bytes = flops / PEAK_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
        mode = 'pos' if pos else 'node'
        shapes = 'x'.join(str(s) for s in out.shape)
        print(f'kernel {name}[{mode}] out {shapes}: max_abs_err {max_abs:.3e} '
              f'max_rel_err {max_rel:.3e} (rtol {KERNEL_RTOL}, atol '
              f'{KERNEL_ATOL}) {"ok" if ok else "MISMATCH"}; kernel '
              f'{ms:.4f} ms, plain {plain_ms:.4f} ms, bound '
              f'{max(t_ops, t_bytes):.4f} ms by '
              f'{"operations" if t_ops >= t_bytes else "bytes"} '
              f'({flops / 1e9:.3f} GFLOP, {nbytes / 1e6:.2f} MB)', flush=True)
        check(ok, f'{name}[{mode}] disagrees with its plain version')
        r = results.setdefault(name, dict(err=0.0, modes=[]))
        r['err'] = max(r['err'], max_abs)
        r['modes'].append((ms, plain_ms, t_ops, t_bytes))
    check(len(captured) == 5, f'expected 5 kernel modes, saw {sorted(captured)}')
    return results


def path_phase(torch, model, plain_model, batch, full_protein):
    from decompdiff_tpu_torch.sampling.sampler import (
        SampleConfig, sample_diffusion)
    ops = model_ops()
    cfg = SampleConfig(
        num_steps=STEPS, save_traj=False,
        energy_drift=({'type': 'armsca_prox', 'min_d': 1.2, 'max_d': 1.9},
                      {'type': 'clash', 'sigma': 2.0, 'gamma': 4.0}))
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
    for name, mod in ops.items():
        setattr(getattr(mod, name), 'launches', 0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = sample_diffusion(model, cfg, batch, init_pos, init_v, init_b,
                           full_protein, generator=g)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = {name: getattr(mod, name).launches for name, mod in ops.items()}

    layers = model.config['num_layers'] * model.config['num_blocks']
    expect = {'edge_attention': 2 * layers * STEPS,
              'bond_attention': 2 * layers * STEPS,
              'triplet_attention': layers * STEPS}
    print(f'path: {STEPS} guided steps at B={B} Np={NUM_PROTEIN} '
          f'Nl={NUM_LIGAND} Nf={NUM_FULL}: {elapsed / STEPS:.4f} s/step, '
          f'{elapsed / STEPS / B:.5f} s/step/molecule; launches {launches} '
          f'(expected {expect})', flush=True)
    check(launches == expect, 'launch counts differ from the expected')
    check(out['pos'].shape == (B, NUM_LIGAND, 3), 'pos shape')
    check(bool(torch.isfinite(out['pos']).all()), 'non-finite positions')
    check(bool(((out['v'] >= 0) & (out['v'] < 8)).all()), 'atom types')
    check(bool(((out['bond'] >= 0) & (out['bond'] < 5)).all()), 'bond types')
    check(bool((out['bond'][~batch.bond_mask] == 0).all()), 'masked bonds')

    # the same steps with every kernel replaced by its plain version
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sample_diffusion(plain_model, cfg, batch, init_pos, init_v, init_b,
                     full_protein, generator=g)
    torch.cuda.synchronize()
    plain_elapsed = time.perf_counter() - t0
    print(f'path with plain versions: {plain_elapsed / STEPS:.4f} s/step',
          flush=True)

    # one denoiser call, kernels on vs off
    t = torch.full((B,), model.num_timesteps - 1, dtype=torch.long,
                   device=dev)
    with torch.no_grad():
        on = model.apply(batch, init_pos, init_v, init_b, t)
        off = plain_model.apply(batch, init_pos, init_v, init_b, t)
    for key in on:
        err = float((on[key] - off[key]).abs().max())
        ok = bool(torch.allclose(on[key], off[key], rtol=PATH_RTOL,
                                 atol=PATH_ATOL))
        print(f'denoiser kernels on vs off: {key} max_abs_err {err:.3e} '
              f'(rtol {PATH_RTOL}, atol {PATH_ATOL}) '
              f'{"ok" if ok else "MISMATCH"}', flush=True)
        check(bool(torch.isfinite(on[key]).all()), f'non-finite {key}')
        check(ok, f'denoiser {key} differs with kernels on')
    return launches


def kernel_records(results, launches):
    """One record per kernel for the kernels JSON line. Per launch: edge and
    bond run their node and pos modes equally often on the path (once each
    per layer), so a kernel's ms, plain_ms and bound_ms are the means over
    its modes, and launches * ms is its time on the path."""
    kernels = []
    for name, r in results.items():
        ms, plain_ms, t_ops, t_bytes = (
            sum(col) / len(r['modes']) for col in zip(*r['modes']))
        kernels.append({
            'name': name, 'route': 'cuda',
            'source': f'decompdiff_tpu_torch/csrc/{name}.cu',
            'replaces': KERNEL_SOURCES[name],
            'launches': launches[name],
            'max_abs_err': r['err'],
            'ms': ms, 'plain_ms': plain_ms,
            'bound_ms': max(t_ops, t_bytes),
            'bound_by': 'operations' if t_ops >= t_bytes else 'bytes',
            # no single PyTorch call computes these fused MLP attentions
            'library_ms': None,
        })
    return kernels


def model_ops():
    from decompdiff_tpu_torch.ops import (
        bond_attention, edge_attention, triplet_attention)
    return {'edge_attention': edge_attention,
            'bond_attention': bond_attention,
            'triplet_attention': triplet_attention}


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
        from decompdiff_tpu_torch.models.diffusion_model import DecompDiffModel
        from decompdiff_tpu_torch.utils.testing import (
            DEFAULT_MODEL_CONFIG, random_complex_batch)
        dev = torch.device('cuda')
        rng = np.random.default_rng(0)
        batch = random_complex_batch(
            rng, batch_size=B, num_protein=NUM_PROTEIN, num_ligand=NUM_LIGAND,
            num_groups=NUM_GROUPS, device=dev)
        full_protein = FullProtein(
            pos=torch.as_tensor(rng.normal(size=(B, NUM_FULL, 3)) * 8,
                                dtype=torch.float32, device=dev),
            mask=torch.ones((B, NUM_FULL), dtype=torch.bool, device=dev))
        cfg = dict(DEFAULT_MODEL_CONFIG, use_pallas=True)
        model = DecompDiffModel.create(cfg, 8, device=dev, seed=0)
        plain_model = DecompDiffModel.create(dict(cfg, use_pallas=False), 8,
                                             device=dev, seed=0)
        plain_model.denoiser.load_state_dict(model.denoiser.state_dict())

        ops = model_ops()
        t = torch.zeros((B,), dtype=torch.long, device=dev)
        captured = capture_inputs(
            torch, ops, plain_model, batch,
            (batch.ligand_pos, batch.ligand_v, batch.bond_type, t))
        with torch.no_grad():
            results = kernel_phase(torch, ops, captured)
        launches = path_phase(torch, model, plain_model, batch, full_protein)
    except SmokeFailure as e:
        print(f'chip_smoke: FAILED: {e}', file=sys.stderr)
        return 1

    print(json.dumps({'kernels': kernel_records(results, launches)}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
