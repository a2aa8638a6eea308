"""MMFF conformer drift — the one host-coupled guidance (RDKit-gated; port
of decompdiff_tpu/guidance/mmff.py).

Parity with ref utils/guidance_funcs.py:121-158 (compute_conf_drift): per
graph, reconstruct a molecule from the current point cloud, MMFF94s-minimize
it, and return grad = pred_pos - minimized_pos (zero on any failure). Exposed
as a host function of numpy arrays for SampleConfig.mmff_callback.
"""

from __future__ import annotations

import numpy as np

from decompdiff_tpu_torch.constants import (
    atomic_numbers_from_index, is_aromatic_from_index)
from decompdiff_tpu_torch.reconstruct.builder import (
    HAS_RDKIT, MolReconsError, reconstruct_from_generated)
from decompdiff_tpu_torch.utils.chem import ff_optimize


def make_mmff_callback(atom_enc_mode: str = 'basic'):
    """Returns f(pos [B, Nl, 3], v [B, Nl], mask [B, Nl]) -> drift [B, Nl, 3]
    suitable for SampleConfig.mmff_callback (host side, numpy in/out)."""
    if not HAS_RDKIT:
        raise ImportError('mmff_min guidance requires RDKit')

    def callback(pos, v, mask):
        pos = np.asarray(pos, np.float64)
        v = np.asarray(v)
        mask = np.asarray(mask)
        B, Nl, _ = pos.shape
        out = np.zeros((B, Nl, 3), np.float32)
        for b in range(B):
            m = mask[b]
            p = pos[b][m]
            atom_types = atomic_numbers_from_index(v[b][m], atom_enc_mode)
            aromatic = is_aromatic_from_index(v[b][m], atom_enc_mode)
            try:
                mol = reconstruct_from_generated(p, atom_types, aromatic)
            except MolReconsError:
                continue
            from rdkit import Chem
            if '.' in Chem.MolToSmiles(mol):
                continue
            r = ff_optimize(mol, addHs=True)
            if r[0] is None:
                continue
            ff_pos = r[-1].GetConformer().GetPositions()
            out[b, m] = (p - ff_pos).astype(np.float32)
        return out

    return callback
