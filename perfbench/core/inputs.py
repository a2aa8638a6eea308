"""The inputs a run makes from its seed and hands to both the program and
the reference: the weights, the sampling batch with its initial state, and
the per-step draws of the sampler.

Everything is drawn on the run's device with torch.Generator (the weights
in one call) or, for the complexes, with numpy's generator; one seed gives
the same inputs on every run. Each purpose takes its own stream, seeded by
a hash of (seed, purpose), so the streams never overlap.
"""

from __future__ import annotations

import hashlib
import math

import numpy as np
import torch

from perfbench.reference.featurize import (
    batch_arrays, featurize, ligand_decomposition)


def stream(seed: int, *tags) -> int:
    """A 63-bit seed for the stream of `tags` under the run's seed."""
    key = ':'.join(str(t) for t in (seed,) + tags).encode()
    return int.from_bytes(hashlib.sha256(key).digest()[:8], 'little') >> 1


def generator(device, seed: int, *tags) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(stream(seed, *tags))


def draw_weights(shapes: dict, seed: int, device) -> dict:
    """A state dict for these parameter shapes, in one draw: kernels from a
    normal cut at two deviations with variance 1/fan_in, biases N(0, 0.05),
    LayerNorm scales 1 + N(0, 0.05)."""
    names = sorted(shapes)
    sizes = [math.prod(shapes[n]) for n in names]
    z = torch.randn(sum(sizes), generator=generator(device, seed, 'weights'),
                    device=device)
    out = {}
    for name, part in zip(names, torch.split(z, sizes)):
        t = part.reshape(shapes[name])
        if name.endswith('kernel'):
            t = t.clamp(-2.0, 2.0) / math.sqrt(shapes[name][0])
        elif name.endswith('scale'):
            t = 1.0 + 0.05 * t
        else:
            t = 0.05 * t
        out[name] = t.contiguous()
    return out


def load_weights(module: torch.nn.Module, weights: dict) -> None:
    own = dict(module.named_parameters())
    if set(own) != set(weights):
        raise KeyError('the drawn state dict does not match the model: '
                       f'{sorted(set(own) ^ set(weights))[:5]}')
    with torch.no_grad():
        for name, p in own.items():
            p.copy_(weights[name])


def to_device(arrays: dict, device) -> dict:
    return {k: torch.as_tensor(v).to(device) for k, v in arrays.items()}


def sampling_inputs(raw: dict, batch: int, classes: int, bond_classes: int,
                    seed: int, device):
    """The batch of `batch` molecules for one pocket under ref_prior with the
    reference ligand's arm and scaffold atom counts (ref
    scripts/sample_diffusion_decomp.py:149-201,297-316), as arrays padded
    to the port's rungs; the initial state x_T ~ N(mu_k, sigma_k) per
    atom's group, uniform atom and bond types; and the receptor that clash
    guidance reads. Returns (batch arrays on the device, (x_T, v_T, b_T),
    receptor [B, Nf, 3], receptor mask [B, Nf])."""
    rec = featurize(raw)
    counts = rec['prior_num_atoms']
    num_arms = rec['num_arms']
    mask = np.concatenate([np.full(c, i if i < num_arms else -1, np.int64)
                           for i, c in enumerate(counts)])
    aux, idx = ligand_decomposition(mask, num_arms)
    n = len(mask)
    gen = dict(rec, ligand_pos=np.zeros((n, 3), np.float32),
               ligand_v=np.zeros(n, np.int64), ligand_aux=aux,
               ligand_decomp_idx=idx,
               bond_type=np.zeros((n, n), np.int64))
    b = to_device(batch_arrays([gen] * batch), device)
    g = generator(device, seed, 'init')
    lig = b['ligand_mask']
    gidx = b['ligand_decomp_idx'].long()[..., None].expand(-1, -1, 3)
    mu = torch.gather(b['prior_centers'], 1, gidx)
    sd = torch.gather(b['prior_stds'], 1, gidx)
    x = mu + torch.randn(mu.shape, generator=g, device=device) * sd
    x = torch.where(lig[..., None], x, 0.0)
    v = torch.randint(0, classes, lig.shape, generator=g, device=device)
    bt = torch.randint(0, bond_classes, b['bond_mask'].shape, generator=g,
                       device=device)
    v = torch.where(lig, v, 0).to(torch.int32)
    bt = torch.where(b['bond_mask'], bt, 0).to(torch.int32)
    b['ligand_pos'], b['ligand_v'], b['bond_type'] = x, v, bt
    receptor = torch.as_tensor(raw['receptor_pos'], device=device)
    receptor = receptor[None].expand(batch, -1, -1).contiguous()
    return b, (x, v, bt), receptor, torch.ones(receptor.shape[:2],
                                               dtype=torch.bool,
                                               device=device)


class StepDraws:
    """The sampler's per-step draws, made on the device from the seed when
    the sampler asks for them (the public `noise_override` of
    sample_diffusion: draws[key][step]). Chain c's step s under key k is
    the stream (seed, 'draw', c, k, s), so the reference can make any step's
    draws again."""

    NORMAL = {'pos_eps'}

    def __init__(self, seed: int, shapes: dict, device, chain: int = 0):
        self.seed, self.shapes, self.device = seed, shapes, device
        self.chain = chain

    def draw(self, key: str, step: int) -> torch.Tensor:
        g = generator(self.device, self.seed, 'draw', self.chain, key, step)
        fn = torch.randn if key in self.NORMAL else torch.rand
        return fn(self.shapes[key], generator=g, device=self.device)

    def step(self, step: int) -> dict:
        return {k: self.draw(k, step) for k in self.shapes}

    def __getitem__(self, key: str):
        if key not in self.shapes:
            raise KeyError(key)
        draws = self

        class _Steps:
            def __getitem__(self, step):
                return draws.draw(key, int(step))
        return _Steps()
