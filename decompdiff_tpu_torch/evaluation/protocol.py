"""The full Vina evaluation protocol: per-sample docking modes and the
headline aggregates (Vina Score / Min / Dock, High Affinity, Success Rate).

Parity with ref scripts/evaluate_mol_from_meta_full.py:77-103 (mode dispatch:
qvina / vina=dock-only / vina_score=score_only+minimize /
vina_full=+dock) and :182-210 (mean/median aggregation). High Affinity (the
fraction of generated molecules docking better than the pocket's reference
ligand) and Success Rate (QED > 0.25, SA > 0.59, Vina Dock < -8.18) follow the
paper protocol reported in the reference README tables (BASELINE.md).

Port of decompdiff_tpu/evaluation/protocol.py,
the same numpy in the same order.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

QED_THRESHOLD = 0.25
SA_THRESHOLD = 0.59
VINA_DOCK_THRESHOLD = -8.18


def run_docking(mol, docking_mode: str, *, ligand_filename: str = '',
                protein_root: Optional[str] = None,
                protein_path: Optional[str] = None,
                exhaustiveness: int = 8, tmp_dir: Optional[str] = None,
                vina_task_cls=None, qvina_task_cls=None):
    """One sample's docking per the reference mode dispatch
    (ref evaluate_mol_from_meta_full.py:79-103).

    The protein is located via ligand_filename+protein_root (the reference
    convention) when both are given, else via an explicit protein_path
    recorded at sampling time. task classes injectable for tests.
    tmp_dir None is the platform's temporary directory (docking.py
    resolve_tmp_dir).
    """
    if docking_mode == 'none':
        return None
    if vina_task_cls is None or qvina_task_cls is None:
        from decompdiff_tpu_torch.evaluation import docking as _d
        vina_task_cls = vina_task_cls or _d.VinaDockingTask
        qvina_task_cls = qvina_task_cls or _d.QVinaDockingTask

    def make(cls):
        if ligand_filename and protein_root is not None:
            return cls.from_generated_mol(mol, ligand_filename,
                                          protein_root=protein_root,
                                          tmp_dir=tmp_dir)
        return cls(mol, protein_path=protein_path, tmp_dir=tmp_dir)

    if docking_mode == 'qvina':
        return make(qvina_task_cls).run_sync(exhaustiveness=exhaustiveness)
    if docking_mode == 'vina':
        return make(vina_task_cls).run(mode='dock',
                                       exhaustiveness=exhaustiveness)
    if docking_mode in ('vina_score', 'vina_full'):
        task = make(vina_task_cls)
        results = {
            'score_only': task.run(mode='score_only',
                                   exhaustiveness=exhaustiveness),
            'minimize': task.run(mode='minimize',
                                 exhaustiveness=exhaustiveness),
        }
        if docking_mode == 'vina_full':
            results['dock'] = task.run(mode='dock',
                                       exhaustiveness=exhaustiveness)
        return results
    raise ValueError(docking_mode)


def dock_affinity(vina_results, docking_mode: str) -> Optional[float]:
    """The 'Vina Dock'-comparable affinity of one sample, if the mode
    produced one."""
    if vina_results is None:
        return None
    if docking_mode in ('vina', 'qvina'):
        return float(vina_results[0]['affinity'])
    if docking_mode == 'vina_full':
        return float(vina_results['dock'][0]['affinity'])
    return None


def aggregate_vina(rows: List[dict], docking_mode: str) -> Dict[str, float]:
    """Mean/median per metric (ref evaluate_mol_from_meta_full.py:188-198).
    rows: the per-sample vina_results values (non-None)."""
    out: Dict[str, float] = {}

    def put(name, vals):
        if vals:
            out[f'{name}_mean'] = float(np.mean(vals))
            out[f'{name}_median'] = float(np.median(vals))

    if docking_mode in ('vina', 'qvina'):
        put('vina_dock', [r[0]['affinity'] for r in rows])
    elif docking_mode in ('vina_score', 'vina_full'):
        put('vina_score', [r['score_only'][0]['affinity'] for r in rows])
        put('vina_min', [r['minimize'][0]['affinity'] for r in rows])
        if docking_mode == 'vina_full':
            put('vina_dock', [r['dock'][0]['affinity'] for r in rows])
    return out


def success_rate(chem_rows: List[Optional[dict]],
                 dock_values: List[Optional[float]]) -> Optional[float]:
    """Fraction of samples with QED > 0.25, SA > 0.59 and Vina Dock < -8.18
    (paper protocol; BASELINE.md Success Rate 24.5%). Samples missing either
    a chem row or a dock value count as failures; returns None when no sample
    has both."""
    assert len(chem_rows) == len(dock_values)
    evaluable = [(c, d) for c, d in zip(chem_rows, dock_values)]
    if not any(c is not None and d is not None for c, d in evaluable):
        return None
    ok = sum(1 for c, d in evaluable
             if c is not None and d is not None
             and c['qed'] > QED_THRESHOLD and c['sa'] > SA_THRESHOLD
             and d < VINA_DOCK_THRESHOLD)
    return ok / len(evaluable)


def high_affinity(dock_values: List[Optional[float]],
                  ref_dock: Optional[float]) -> Optional[float]:
    """Fraction of generated molecules whose Vina Dock beats the pocket's
    reference ligand (BASELINE.md High Affinity 71.0%). Needs the reference
    ligand's docked affinity for this pocket."""
    if ref_dock is None:
        return None
    vals = [d for d in dock_values if d is not None]
    if not vals:
        return None
    return float(np.mean([d < ref_dock for d in vals]))


def pocket_diversity(mols) -> Optional[float]:
    """1 - mean pairwise fingerprint Tanimoto among one pocket's molecules
    (the paper's Diversity metric, reported in the reference README tables
    but shipped without code; BASELINE.md Diversity 0.68). Fingerprints are
    computed once per molecule: first-party path fingerprints for
    MolRecords, RDKFingerprint for RDKit mols (never mixed — the flavors'
    similarities are not comparable)."""
    mols = list(mols)
    if len(mols) < 2:
        return None
    if all(hasattr(m, 'bond_index') for m in mols):
        from decompdiff_tpu_torch.evaluation.descriptors import (
            path_fingerprint, tanimoto)
        fps = [path_fingerprint(m) for m in mols]
        sims = [tanimoto(fps[i], fps[j])
                for i in range(len(fps)) for j in range(i + 1, len(fps))]
    else:
        from rdkit import Chem, DataStructs
        fps = [Chem.RDKFingerprint(m) for m in mols]
        sims = [DataStructs.TanimotoSimilarity(fps[i], fps[j])
                for i in range(len(fps)) for j in range(i + 1, len(fps))]
    return float(1.0 - np.mean(sims))


def diversity(mols_by_pocket: Dict[str, list]) -> Optional[float]:
    """Mean pocket_diversity over pockets with >= 2 scored molecules."""
    vals = [pocket_diversity(ms) for ms in mols_by_pocket.values()]
    vals = [v for v in vals if v is not None]
    return float(np.mean(vals)) if vals else None
