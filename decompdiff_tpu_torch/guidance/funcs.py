"""Validity/drift guidance energies (port of
decompdiff_tpu/guidance/funcs.py; ref utils/guidance_funcs.py). Each energy
is a masked batch reduction; the sampler differentiates their sum with
torch.autograd.grad.

  * clash: smooth-min surface field G(x) = -sigma*log(1e-3 + sum_j
    exp(-|x-b_j|^2/sigma)), loss = mean over ligand atoms of max(0, ct - G)
    (ref :24-42)
  * armsca_prox: hinge on the min arm<->scaffold atom distance per arm,
    averaged over arms, summed over valid graphs / num_graphs (ref :50-78)
  * center_prox: sum of distances to the assigned prior centers (ref :45-47)
  * arms_repul: arm-arm minimum-distance hinge (ref :81-118)
"""

from __future__ import annotations

import torch

from decompdiff_tpu_torch.models.common import safe_norm

_BIG = 1e10


def center_prox_energy(ligand_pos, centers, ligand_mask):
    """sum over real atoms of ||x - mu_assigned||."""
    d = safe_norm(ligand_pos - centers, dim=-1)
    return torch.sum(d * ligand_mask.to(d.dtype))


def _group_ids(num_groups, device):
    return torch.arange(num_groups, device=device)


def armsca_prox_energy(ligand_pos, decomp_idx, num_arms, ligand_mask,
                       num_groups, min_d=1.2, max_d=1.9, batch_size=None):
    """Keep each arm's closest approach to the scaffold inside
    [min_d, max_d]; graphs lacking arms or scaffold atoms contribute 0.
    The sum over graphs is divided by `batch_size`, by default the rows
    given (a data-parallel rank passes the global batch's)."""
    B = ligand_mask.shape[0] if batch_size is None else batch_size
    decomp_idx = decomp_idx.long()
    num_arms = num_arms.long()
    is_arm = (decomp_idx < num_arms[:, None]) & ligand_mask
    is_sca = (decomp_idx == num_arms[:, None]) & ligand_mask

    diff = ligand_pos[:, :, None, :] - ligand_pos[:, None, :, :]
    dist = safe_norm(diff, dim=-1)                          # [B, Nl, Nl]
    pair_ok = is_arm[:, :, None] & is_sca[:, None, :]
    dist = torch.where(pair_ok, dist, _BIG)
    atom_min = dist.amin(dim=2)                             # min over scaffold

    in_group = ((decomp_idx[:, :, None]
                 == _group_ids(num_groups, ligand_pos.device))
                & is_arm[:, :, None])
    per_arm = torch.where(in_group, atom_min[:, :, None], _BIG).amin(dim=1)
    arm_valid = per_arm < _BIG / 2
    hinge = (torch.clamp(min_d - per_arm, min=0.0)
             + torch.clamp(per_arm - max_d, min=0.0))
    hinge = torch.where(arm_valid, hinge, 0.0)
    n_arms_valid = arm_valid.sum(dim=1).to(ligand_pos.dtype)
    per_graph = hinge.sum(dim=1) / torch.clamp(n_arms_valid, min=1.0)
    graph_valid = (n_arms_valid > 0).to(ligand_pos.dtype)
    return (per_graph * graph_valid).sum() / B


def clash_energy(protein_pos, protein_mask, ligand_pos, ligand_mask,
                 sigma=25.0, surface_ct=10.0):
    """Protein-ligand body-intersection loss, summed over graphs.
    protein_pos [B, Nf, 3] is the full protein in original coordinates and
    ligand_pos must be un-centered (ref models/decompdiff.py:662)."""
    d2 = torch.sum((ligand_pos[:, :, None, :]
                    - protein_pos[:, None, :, :]) ** 2, dim=-1)
    e = torch.where(protein_mask[:, None, :], torch.exp(-d2 / sigma), 0.0)
    g = -sigma * torch.log(1e-3 + e.sum(dim=2))
    viol = torch.clamp(surface_ct - g, min=0.0)
    m = ligand_mask.to(viol.dtype)
    per_graph = (viol * m).sum(dim=1) / torch.clamp(m.sum(dim=1), min=1.0)
    return per_graph.sum()


def arms_repul_energy(ligand_pos, decomp_idx, num_arms, ligand_mask,
                      num_groups, max_d=1.9, mode='min'):
    """Arm-arm repulsion: the minimum distance between different arms should
    exceed max_d. Sum over valid arm pairs / B."""
    if mode != 'min':
        raise NotImplementedError(mode)
    B = ligand_pos.shape[0]
    decomp_idx = decomp_idx.long()
    is_arm = (decomp_idx < num_arms.long()[:, None]) & ligand_mask
    diff = ligand_pos[:, :, None, :] - ligand_pos[:, None, :, :]
    dist = safe_norm(diff, dim=-1)
    group_ids = _group_ids(num_groups, ligand_pos.device)
    in_g = (decomp_idx[:, :, None] == group_ids) & is_arm[:, :, None]
    pair_ok = in_g[:, :, None, :, None] & in_g[:, None, :, None, :]
    d = torch.where(pair_ok, dist[:, :, :, None, None], _BIG).amin(dim=(1, 2))
    valid = (d < _BIG / 2) & (group_ids[:, None] < group_ids[None, :])
    hinge = torch.where(valid, torch.clamp(max_d - d, min=0.0), 0.0)
    return hinge.sum() / B
