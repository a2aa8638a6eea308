"""Masked k-nearest-neighbor graphs over padded point sets (port of
decompdiff_tpu/ops/knn.py): a dense masked distance matrix and a top-k per
destination row give a regular [B, N, K] neighbor tensor.

The tie order of `torch.topk` may differ from `jax.lax.top_k`; ties only
occur among masked slots or between duplicate coordinates.
"""

from __future__ import annotations

import torch


def pairwise_sqdist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[..., N, 3], [..., M, 3] -> [..., N, M] squared distances."""
    diff = a[..., :, None, :] - b[..., None, :, :]
    return torch.sum(diff * diff, dim=-1)


def knn_neighbors(pos: torch.Tensor, mask: torch.Tensor, k: int):
    """Top-k nearest real neighbors for every node (self excluded).

    Args:
        pos:  [B, N, 3]
        mask: [B, N] bool — real (non-padding) nodes
        k:    neighbors per destination

    Returns:
        nbr_idx:  [B, N, K] int64 — source-node indices j for edges j -> i
        nbr_mask: [B, N, K] bool  — valid edges (dst real, src real, src != dst)
        nbr_d2:   [B, N, K] float — |xi - xj|^2 per edge; invalid slots hold
                  the float32 maximum.
    """
    n = pos.shape[-2]
    d2 = pairwise_sqdist(pos, pos)
    big = torch.finfo(d2.dtype).max
    eye = torch.eye(n, dtype=torch.bool, device=pos.device)
    invalid = eye[None] | ~mask[:, None, :]
    d2 = torch.where(invalid, big, d2)
    neg_d2, nbr_idx = torch.topk(-d2, k, dim=-1)
    nbr_mask = (neg_d2 > -big) & mask[:, :, None]
    return nbr_idx, nbr_mask, -neg_d2


def hybrid_neighbors(pos: torch.Tensor, mask: torch.Tensor,
                     mask_ligand: torch.Tensor, k: int, num_protein: int):
    """The reference's 'hybrid' edge connection in padded form
    (ref models/common.py:230-277, add_p_index=True): ligand(+prior)
    destination rows are fully connected to every other real ligand node
    plus their k nearest real protein atoms; protein rows take their k
    nearest real neighbors of any kind. Returns ([B, N, L + k] indices,
    mask, squared distances) with L = N - num_protein.
    """
    B, n, _ = pos.shape
    L = n - num_protein
    d2 = pairwise_sqdist(pos, pos)
    big = torch.finfo(d2.dtype).max
    eye = torch.eye(n, dtype=torch.bool, device=pos.device)

    lig_cols = torch.arange(num_protein, n, device=pos.device)
    fc_idx = lig_cols[None, None, :].expand(B, n, L)
    src_real = mask[:, None, :] & mask_ligand[:, None, :]
    fc_valid = torch.gather(src_real & ~eye[None], 2, fc_idx)
    fc_valid = fc_valid & mask_ligand[:, :, None]

    src_protein_ok = mask & ~mask_ligand
    allowed = torch.where(mask_ligand[:, :, None],
                          src_protein_ok[:, None, :], mask[:, None, :])
    d2k = torch.where(allowed & ~eye[None], d2, big)
    neg_d2, knn_idx = torch.topk(-d2k, k, dim=-1)
    knn_valid = (neg_d2 > -big) & mask[:, :, None]

    nbr_idx = torch.cat([fc_idx, knn_idx], dim=2)
    nbr_mask = torch.cat([fc_valid & mask[:, :, None], knn_valid], dim=2)
    fc_d2 = torch.gather(d2, 2, fc_idx)
    return nbr_idx, nbr_mask, torch.cat([fc_d2, -neg_d2], dim=2)
