"""Bucketed padding collator: featurized numpy records -> ComplexBatch on a
device (port of decompdiff_tpu/data/collate.py).

Padded sizes (Np, Nl, A) are rounded up to a small fixed ladder of bucket
edges, so a corpus runs at a handful of shapes. The padded arrays are the
JAX package's, bit for bit; `collate` moves them to the device as the
dtypes of data/batch.py's ComplexBatch.
"""

from __future__ import annotations

import bisect
from typing import List, Optional, Sequence

import numpy as np
import torch

from decompdiff_tpu_torch import native
from decompdiff_tpu_torch.data.batch import ComplexBatch
from decompdiff_tpu_torch.device import DeviceLike, resolve_device

# default bucket ladders (atoms), the JAX package's: CrossDocked pockets
# (~150-500 atoms) and ligands (~8-60 atoms) with <2x padding waste
PROTEIN_BUCKETS = (128, 192, 256, 320, 384, 448, 512, 640, 768)
LIGAND_BUCKETS = (16, 24, 32, 40, 48, 64)
GROUP_BUCKETS = (4, 8, 12)


def bucketize(n: int, buckets: Sequence[int]) -> int:
    idx = bisect.bisect_left(buckets, n)
    if idx == len(buckets):
        raise ValueError(f'size {n} exceeds largest bucket {buckets[-1]}')
    return buckets[idx]


def _pad_to(x: np.ndarray, shape) -> np.ndarray:
    pad = [(0, t - s) for s, t in zip(x.shape, shape)]
    return np.pad(x, pad)


def collate(records: List[dict], device: DeviceLike = None,
            protein_buckets=PROTEIN_BUCKETS,
            ligand_buckets=LIGAND_BUCKETS,
            group_buckets=GROUP_BUCKETS,
            np_override: Optional[int] = None,
            nl_override: Optional[int] = None,
            na_override: Optional[int] = None) -> ComplexBatch:
    """Pad a list of featurized records into one fixed-shape ComplexBatch
    on `device` (CUDA unless given)."""
    device = resolve_device(device)
    Np = np_override or bucketize(
        max(len(r['protein_pos']) for r in records), protein_buckets)
    Nl = nl_override or bucketize(
        max(len(r['ligand_pos']) for r in records), ligand_buckets)
    A = na_override or bucketize(
        max(len(r['prior_centers']) for r in records), group_buckets)
    for name, cap, key in (('np_override', Np, 'protein_pos'),
                           ('nl_override', Nl, 'ligand_pos'),
                           ('na_override', A, 'prior_centers')):
        worst = max(len(r[key]) for r in records)
        if worst > cap:
            raise ValueError(
                f'collate: {name}={cap} is smaller than the largest '
                f'record ({key} has {worst} rows)')

    def f32(key):
        return [np.asarray(r[key], np.float32) for r in records]

    def i32(key):
        return [np.asarray(r[key], np.int32) for r in records]

    p_counts = [len(r['protein_pos']) for r in records]
    l_counts = [len(r['ligand_pos']) for r in records]
    a_counts = [len(r['prior_centers']) for r in records]

    bond_type = native.pad_square_stack_i32(
        [np.asarray(r['bond_type'], np.int32) for r in records], Nl)
    prior_stds = native.pad_stack_f32(f32('prior_stds'), A)
    # padded prior rows keep std 1 so padded-atom math stays harmless
    prior_mask = native.length_masks(a_counts, A)
    prior_stds = np.where(prior_mask[..., None], prior_stds,
                          np.float32(1.0))

    bond_mask = native.fc_bond_masks(l_counts, Nl)
    if any('bond_graph_mask' in r for r in records):
        # restricted bond graphs (decomp_fc / scaffold_fc modes,
        # ref utils/transforms.py:339-378)
        gmask = np.stack([
            _pad_to(np.asarray(r['bond_graph_mask'], bool), (Nl, Nl))
            if 'bond_graph_mask' in r else np.ones((Nl, Nl), bool)
            for r in records])
        bond_mask = bond_mask & gmask
    bond_type = np.where(bond_mask, bond_type, 0)

    arrays = dict(
        protein_pos=native.pad_stack_f32(f32('protein_pos'), Np),
        protein_feat=native.pad_stack_f32(f32('protein_feat'), Np),
        protein_mask=native.length_masks(p_counts, Np),
        ligand_pos=native.pad_stack_f32(f32('ligand_pos'), Nl),
        ligand_v=native.pad_stack_i32(i32('ligand_v'), Nl)[..., 0],
        ligand_aux=native.pad_stack_f32(f32('ligand_aux'), Nl),
        ligand_mask=native.length_masks(l_counts, Nl),
        ligand_decomp_idx=native.pad_stack_i32(
            i32('ligand_decomp_idx'), Nl)[..., 0],
        bond_type=bond_type,
        bond_mask=bond_mask,
        prior_centers=native.pad_stack_f32(f32('prior_centers'), A),
        prior_stds=prior_stds,
        prior_num_atoms=native.pad_stack_i32(
            i32('prior_num_atoms'), A)[..., 0],
        prior_mask=prior_mask,
        num_arms=np.array([r['num_arms'] for r in records], np.int32),
    )
    return ComplexBatch(**{k: torch.from_numpy(v).to(device)
                           for k, v in arrays.items()})


def bucket_key(record: dict,
               protein_buckets=PROTEIN_BUCKETS,
               ligand_buckets=LIGAND_BUCKETS,
               group_buckets=GROUP_BUCKETS):
    """The padded shape a record lands in."""
    return (bucketize(len(record['protein_pos']), protein_buckets),
            bucketize(len(record['ligand_pos']), ligand_buckets),
            bucketize(len(record['prior_centers']), group_buckets))
