"""Chemistry scoring: QED, SA, logP, Lipinski, ring sizes, Tanimoto.

Role parity with ref utils/evaluation/scoring_func.py:76-93 (get_chem),
sascorer.py (Ertl & Schuffenhauer fragment-contribution SA score) and
utils/evaluation/similarity.py:9-24 (fingerprint Tanimoto). RDKit mols use
the reference recipes verbatim; MolRecords (and any RDKit-free host) route
through the first-party structural descriptors in
evaluation/descriptors.py, with per-descriptor exactness documented there
and in PARITY.md.

Port of decompdiff_tpu/evaluation/scoring.py,
the same numpy in the same order.
"""

from __future__ import annotations

import gzip
import math
import os
import pickle
from collections import Counter
from typing import Optional

import numpy as np

try:
    from rdkit import Chem
    from rdkit.Chem import Crippen, Descriptors, Lipinski, QED
    from rdkit.Chem import rdMolDescriptors
    HAS_RDKIT = True
except Exception:
    HAS_RDKIT = False

_FPSCORES = os.path.join(os.path.dirname(__file__), 'assets', 'fpscores.pkl.gz')
_sa_model = None


def _require_rdkit():
    if not HAS_RDKIT:
        raise ImportError('RDKit is required for chemistry scoring '
                          '(QED/SA/logP/Lipinski); install rdkit.')


def can_score(mol) -> bool:
    """Whether get_chem can evaluate this molecule on this host: RDKit
    mols need RDKit installed; MolRecords always score via the first-party
    descriptor stack (evaluation/descriptors.py)."""
    if hasattr(mol, 'bond_index'):
        return True
    return HAS_RDKIT


def _load_sa_fragment_scores():
    global _sa_model
    if _sa_model is None:
        if not os.path.exists(_FPSCORES):
            raise FileNotFoundError(
                f'SA fragment scores not found at {_FPSCORES}; download '
                'fpscores.pkl.gz from the RDKit contrib SA_Score directory.')
        with gzip.open(_FPSCORES, 'rb') as f:
            data = pickle.load(f)
        model = {}
        for entry in data:
            for fp in entry[1:]:
                model[fp] = float(entry[0])
        _sa_model = model
    return _sa_model


def compute_sa_score(mol) -> float:
    """Ertl & Schuffenhauer synthetic accessibility, normalized to (0, 1]
    like the reference ((10 - sa) / 9; ref scoring_func.py:96-99)."""
    _require_rdkit()
    model = _load_sa_fragment_scores()
    fp = rdMolDescriptors.GetMorganFingerprint(mol, 2)
    fps = fp.GetNonzeroElements()
    score1 = 0.0
    nf = 0
    for bit_id, count in fps.items():
        nf += count
        score1 += model.get(bit_id, -4.0) * count
    score1 /= max(nf, 1)

    n_atoms = mol.GetNumAtoms()
    n_chiral = len(Chem.FindMolChiralCenters(mol, includeUnassigned=True))
    ri = mol.GetRingInfo()
    n_spiro = rdMolDescriptors.CalcNumSpiroAtoms(mol)
    n_bridge = rdMolDescriptors.CalcNumBridgeheadAtoms(mol)
    n_macro = sum(1 for ring in ri.AtomRings() if len(ring) > 8)

    size_penalty = n_atoms ** 1.005 - n_atoms
    stereo_penalty = math.log10(n_chiral + 1)
    spiro_penalty = math.log10(n_spiro + 1)
    bridge_penalty = math.log10(n_bridge + 1)
    macro_penalty = math.log10(2) if n_macro > 0 else 0.0
    score2 = (-size_penalty - stereo_penalty - spiro_penalty - bridge_penalty
              - macro_penalty)
    score3 = 0.0
    if n_atoms > len(fps):
        score3 = math.log(float(n_atoms) / len(fps)) * 0.5

    sascore = score1 + score2 + score3
    smin, smax = -4.0, 2.5
    sascore = 11.0 - (sascore - smin + 1) / (smax - smin) * 9.0
    if sascore > 8.0:
        sascore = 8.0 + math.log(sascore + 1.0 - 9.0)
    sascore = min(max(sascore, 1.0), 10.0)
    return round((10.0 - sascore) / 9.0, 2)


def is_pains(mol) -> bool:
    """PAINS_A substructure filter (ref scoring_func.py:15-25). MolRecords
    match through the first-party SMARTS engine (`evaluation/smarts.py`):
    a user-supplied corpus via DD_PAINS_SMARTS when present, else the
    self-authored motif-class subset in `evaluation/alerts.py` (provenance:
    `alerts.pains_backend()`). RDKit mols use the reference recipe."""
    if hasattr(mol, 'bond_index'):
        from decompdiff_tpu_torch.evaluation.alerts import is_pains_record
        return is_pains_record(mol)
    _require_rdkit()
    from copy import deepcopy
    from rdkit.Chem.FilterCatalog import FilterCatalog, FilterCatalogParams
    params = FilterCatalogParams()
    params.AddCatalog(FilterCatalogParams.FilterCatalogs.PAINS_A)
    catalog = FilterCatalog(params)
    mol = deepcopy(mol)
    Chem.SanitizeMol(mol)
    return catalog.GetFirstMatch(mol) is not None


def obey_lipinski(mol) -> int:
    """Count of satisfied Lipinski rules (ref scoring_func.py:102-110);
    MolRecords use the first-party descriptor path."""
    if hasattr(mol, 'bond_index'):
        from decompdiff_tpu_torch.evaluation.descriptors import lipinski_count
        return lipinski_count(mol)
    _require_rdkit()
    mol = Chem.Mol(mol)
    Chem.SanitizeMol(mol)
    rule_1 = Descriptors.ExactMolWt(mol) < 500
    rule_2 = Lipinski.NumHDonors(mol) <= 5
    rule_3 = Lipinski.NumHAcceptors(mol) <= 10
    logp = Crippen.MolLogP(mol)
    rule_4 = -2 <= logp <= 5
    rule_5 = rdMolDescriptors.CalcNumRotatableBonds(mol) <= 10
    return int(sum([rule_1, rule_2, rule_3, rule_4, rule_5]))


def get_basic(mol):
    """(n_atoms, n_bonds, n_rings, exact mol weight)
    (ref scoring_func.py:41-46). MolRecords use the first-party
    descriptor stack (heavy-atom graph + implicit-H monoisotopic MW)."""
    if hasattr(mol, 'bond_index'):
        from decompdiff_tpu_torch.evaluation.descriptors import (
            _undirected, implicit_h_counts, mol_weight, num_rings)
        bonds = _undirected(mol)
        h = implicit_h_counts(mol.element, bonds, mol.charges)
        return (mol.num_atoms, len(bonds), num_rings(mol),
                mol_weight(mol.element, h))
    _require_rdkit()
    n_atoms = len(mol.GetAtoms())
    n_bonds = len(mol.GetBonds())
    n_rings = len(Chem.GetSymmSSSR(mol))
    weight = Descriptors.ExactMolWt(mol)
    return n_atoms, n_bonds, n_rings, weight


def get_ring_sizes(mol) -> Counter:
    """Histogram of ring sizes (ref scoring_func.py:81-83, SSSR). Works on
    RDKit mols (SSSR) and on MolRecords via the BFS smallest-ring-per-bond
    routine shared with the liGAN reconstructor. A spanning-tree fundamental
    cycle basis is NOT equivalent: on fused systems (naphthalene) it reports
    phantom large cycles (6+10 instead of 6+6) depending on atom order."""
    if HAS_RDKIT and not hasattr(mol, 'bond_index'):
        from rdkit import Chem
        Chem.GetSymmSSSR(mol)
        ri = mol.GetRingInfo()
        return Counter(len(r) for r in ri.AtomRings())
    from decompdiff_tpu_torch.reconstruct.builder import _undirected_bonds
    from decompdiff_tpu_torch.reconstruct.ligan import find_rings
    bonds = _undirected_bonds(mol.bond_index, mol.bond_type)
    rings = find_rings(mol.num_atoms, {tuple(b): 1 for b in bonds},
                       max_size=24)
    sizes = Counter(len(r) for r in rings)
    return sizes


def get_chem(mol) -> dict:
    """QED / SA / logP / Lipinski / ring sizes (ref scoring_func.py:76-93).
    MolRecords score via the first-party descriptors (same keys;
    exactness levels documented in descriptors.py)."""
    if hasattr(mol, 'bond_index'):
        from decompdiff_tpu_torch.evaluation.descriptors import get_chem_record
        return get_chem_record(mol)
    _require_rdkit()
    qed_score = QED.qed(mol)
    sa_score = compute_sa_score(mol)
    logp_score = Crippen.MolLogP(mol)
    lipinski_score = obey_lipinski(mol)
    ring_info = mol.GetRingInfo()
    ring_size = Counter([len(r) for r in ring_info.AtomRings()])
    return {
        'qed': qed_score,
        'sa': sa_score,
        'logp': logp_score,
        'lipinski': lipinski_score,
        'ring_size': ring_size,
        'chem_backend': 'rdkit',
    }


def get_rdkit_rmsd(mol, n_conf: int = 20, random_seed: int = 42):
    """[max, min, median] RMSD between the generated geometry and `n_conf`
    re-embedded, force-field-relaxed conformers of the same bond graph
    (ref utils/evaluation/scoring_func.py:49-69 — a geometry-plausibility
    metric). RDKit mols use the reference recipe (EmbedMultipleConfs + UFF +
    GetBestRMS); MolRecords use the first-party DG + ffmin + Kabsch path.
    Returns [nan, nan, nan] on failure, like the reference."""
    nanout = [float('nan')] * 3
    if HAS_RDKIT and not hasattr(mol, 'bond_index'):
        from copy import deepcopy
        from rdkit.Chem import AllChem, rdMolAlign
        mol = deepcopy(mol)
        try:
            Chem.SanitizeMol(mol)
            mol3d = Chem.AddHs(mol)
            conf_ids = AllChem.EmbedMultipleConfs(mol3d, n_conf,
                                                  randomSeed=random_seed)
            rmsds = []
            for cid in conf_ids:
                AllChem.UFFOptimizeMolecule(mol3d, confId=cid)
                rmsds.append(rdMolAlign.GetBestRMS(mol, mol3d, refId=cid))
            rmsds = np.asarray(rmsds)
            return [float(rmsds.max()), float(rmsds.min()),
                    float(np.median(rmsds))]
        except Exception:
            return nanout
    if not hasattr(mol, 'bond_index'):
        return nanout
    from decompdiff_tpu_torch.utils.chem import _kabsch_rmsd
    from decompdiff_tpu_torch.utils.confgen import (
        generate_conformers, record_bonds)
    try:
        bonds = record_bonds(mol)
        confs = generate_conformers(mol.element, bonds, n_confs=n_conf,
                                    seed=random_seed)
        rmsds = np.asarray([_kabsch_rmsd(mol.pos, pos)
                            for pos, _ in confs])
        return [float(rmsds.max()), float(rmsds.min()),
                float(np.median(rmsds))]
    except Exception:
        return nanout


class _FFMinForceField:
    """RDKit-ForceField-shaped front over guidance/ffmin for MolRecords
    (CalcEnergy / Minimize / positions)."""

    def __init__(self, record):
        from decompdiff_tpu_torch.guidance.ffmin import build_ff_terms
        from decompdiff_tpu_torch.reconstruct.builder import _undirected_bonds
        self._element = record.element
        self._bonds = _undirected_bonds(record.bond_index, record.bond_type)
        self.positions = np.asarray(record.pos, np.float64).reshape(-1, 3)
        self._terms = build_ff_terms(self.positions, self._element,
                                     self._bonds)

    def CalcEnergy(self) -> float:
        from decompdiff_tpu_torch.guidance.ffmin import ff_energy_grad
        return float(ff_energy_grad(self.positions.reshape(-1),
                                    self._terms)[0])

    def Minimize(self, maxIts: int = 200) -> int:
        from decompdiff_tpu_torch.guidance.ffmin import relax_positions
        self.positions = relax_positions(self.positions, self._element,
                                         self._bonds, max_iter=maxIts,
                                         terms=self._terms)
        return 0


def get_molecule_force_field(mol, conf_id=None, force_field='mmff',
                             **kwargs):
    """Force field for a molecule (ref scoring_func.py:96-121: uff/mmff*).
    MolRecords return the first-party ffmin front (same CalcEnergy /
    Minimize call surface)."""
    if hasattr(mol, 'bond_index'):
        return _FFMinForceField(mol)
    _require_rdkit()
    from rdkit.Chem import AllChem
    if force_field == 'uff':
        return AllChem.UFFGetMoleculeForceField(mol, confId=conf_id,
                                                **kwargs)
    if force_field.startswith('mmff'):
        AllChem.MMFFSanitizeMolecule(mol)
        props = AllChem.MMFFGetMoleculeProperties(mol,
                                                  mmffVariant=force_field)
        return AllChem.MMFFGetMoleculeForceField(mol, props, confId=conf_id,
                                                 **kwargs)
    raise ValueError(f'Invalid force_field {force_field}')


def get_conformer_energies(mol, force_field='mmff') -> np.ndarray:
    """Per-conformer energies (ref scoring_func.py:124-145). A MolRecord
    carries one conformer, so the first-party path returns a length-1
    array of its ffmin energy."""
    if hasattr(mol, 'bond_index'):
        return np.asarray([_FFMinForceField(mol).CalcEnergy()], float)
    _require_rdkit()
    energies = []
    for conf in mol.GetConformers():
        ff = get_molecule_force_field(mol, conf_id=conf.GetId(),
                                      force_field=force_field)
        energies.append(ff.CalcEnergy())
    return np.asarray(energies, float)


def tanimoto_sim(mol, ref) -> float:
    """Fingerprint Tanimoto (ref utils/evaluation/similarity.py:9-13).
    RDKit mols use RDKFingerprint; MolRecord pairs use the first-party
    linear-path fingerprint (similarities are only comparable within one
    flavor — never mix a first-party value against an RDKit one)."""
    if hasattr(mol, 'bond_index') or hasattr(ref, 'bond_index'):
        if not (hasattr(mol, 'bond_index') and hasattr(ref, 'bond_index')):
            raise TypeError('tanimoto_sim needs two mols of the same kind '
                            '(both RDKit or both MolRecord)')
        from decompdiff_tpu_torch.evaluation.descriptors import (
            path_fingerprint, tanimoto)
        return tanimoto(path_fingerprint(mol), path_fingerprint(ref))
    _require_rdkit()
    from rdkit import DataStructs
    fp1 = Chem.RDKFingerprint(mol)
    fp2 = Chem.RDKFingerprint(ref)
    return DataStructs.TanimotoSimilarity(fp1, fp2)


def tanimoto_sim_N_to_1(mols, ref) -> list:
    """Similarity of each mol against one reference
    (ref utils/evaluation/similarity.py:15-17)."""
    return [tanimoto_sim(m, ref) for m in mols]


def batched_number_of_rings(mols) -> np.ndarray:
    """Ring counts per molecule (ref utils/evaluation/similarity.py:20-24,
    CalcNumRings)."""
    out = []
    for m in mols:
        if hasattr(m, 'bond_index'):
            from decompdiff_tpu_torch.evaluation.descriptors import num_rings
            out.append(num_rings(m))
        else:
            _require_rdkit()
            from rdkit.Chem import rdMolDescriptors as _rd
            out.append(_rd.CalcNumRings(m))
    return np.array(out)
