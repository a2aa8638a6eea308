"""First-party molecular descriptors (RDKit-free, on MolRecords).

The reference's chem scoring (ref utils/evaluation/scoring_func.py:28-93:
Lipinski rules, Crippen logP, QED, SA score; ref utils/evaluation/
similarity.py:9-24: fingerprint Tanimoto) is entirely RDKit-typed. RDKit is
absent from this image, so this module computes the same descriptor family
structurally from a MolRecord's (element, bonds, aromatic) graph:

  * implicit hydrogens from default-valence bookkeeping (the information
    RDKit's sanitization derives; MolRecords carry heavy atoms only),
  * monoisotopic molecular weight, H-bond donors/acceptors,
  * Ertl TPSA from the published N/O environment contributions
    (Ertl, Rohde & Selzer, J. Med. Chem. 2000 — the same table behind
    RDKit's CalcTPSA default),
  * the full Wildman-Crippen 68-type logP (evaluation/crippen.py),
  * a Daylight-style linear-path fingerprint + Tanimoto,
  * Lipinski rule-of-five count, exact QED (Bickerton ADS curves),
    and the full Ertl-Schuffenhauer SA score (fragment term via the
    RDKit-exact Morgan fingerprint, evaluation/morgan.py).

Exactness levels differ by descriptor and are documented per function (and
in PARITY.md): implicit H / MW / HBD / HBA / TPSA follow published exact
tables; logP is the FULL published Wildman-Crippen 68-type model
(evaluation/crippen.py, anchor-tested); QED uses Bickerton's published
fitted ADS desirability curves and weights_mean exactly, with the ALERTS
term defaulting to 0 (the Brenk SMARTS catalog is RDKit-internal; supply
it via DD_QED_ALERTS_SMARTS for an exact count); SA includes the
fragment-frequency term — the committed fpscores.pkl.gz corpus is queried
with the RDKit-exact first-party Morgan fingerprint (evaluation/morgan.py;
stereocenters via converged-WL rank distinctness, heteroatom centers
uncounted). When RDKit is installed,
evaluation/scoring.py prefers the reference recipes verbatim; these are
the in-image fallbacks.

Port of decompdiff_tpu/evaluation/descriptors.py,
the same numpy in the same order.
"""

from __future__ import annotations

import hashlib
import math
from collections import Counter
from typing import Dict, List, Optional, Tuple

import numpy as np

Bond = Tuple[int, int]

# --------------------------------------------------------------------------
# element tables

# monoisotopic masses (matches Descriptors.ExactMolWt, ref
# scoring_func.py:31 rule_1)
MONOISOTOPIC_MASS = {
    1: 1.00783, 5: 11.00931, 6: 12.0, 7: 14.00307, 8: 15.99491,
    9: 18.99840, 14: 27.97693, 15: 30.97376, 16: 31.97207, 17: 34.96885,
    33: 74.92160, 34: 79.91652, 35: 78.91834, 53: 126.90447,
}

# allowed valences, smallest first (RDKit's default-valence model)
DEFAULT_VALENCES = {
    1: (1,), 5: (3,), 6: (4,), 7: (3,), 8: (2,), 9: (1,),
    14: (4,), 15: (3, 5), 16: (2, 4, 6), 17: (1,),
    33: (3, 5), 34: (2, 4, 6), 35: (1,), 53: (1,),
}


def _undirected(record) -> Dict[Bond, int]:
    from decompdiff_tpu_torch.reconstruct.builder import _undirected_bonds
    return _undirected_bonds(record.bond_index, record.bond_type)


def _adjacency(n: int, bonds: Dict[Bond, int]):
    adj: List[List[Tuple[int, int]]] = [[] for _ in range(n)]
    for (a, b), order in bonds.items():
        adj[a].append((b, int(order)))
        adj[b].append((a, int(order)))
    return adj


def implicit_h_counts(element: np.ndarray, bonds: Dict[Bond, int],
                      charges: Optional[np.ndarray] = None) -> np.ndarray:
    """Implicit hydrogens per heavy atom: (smallest allowed valence >= the
    rounded bond-order sum) - bond-order sum, aromatic bonds counting 1.5.
    Charge shifts the valence target by +q for N/P and +q for O/S anions
    (N+ -> 4, O- -> 1), the common sanitization rule."""
    element = np.asarray(element)
    n = len(element)
    order_sum = np.zeros(n)
    for (a, b), order in bonds.items():
        o = 1.5 if order == 4 else float(order)
        order_sum[a] += o
        order_sum[b] += o
    out = np.zeros(n, np.int64)
    for i in range(n):
        s = int(round(order_sum[i]))
        allowed = DEFAULT_VALENCES.get(int(element[i]), (s,))
        q = int(charges[i]) if charges is not None else 0
        target = None
        for v in allowed:
            if v + q >= s:
                target = v + q
                break
        out[i] = 0 if target is None else target - s
    return out


def mol_weight(element: np.ndarray, h_counts: np.ndarray) -> float:
    """Monoisotopic weight incl. implicit Hs (Descriptors.ExactMolWt)."""
    w = sum(MONOISOTOPIC_MASS.get(int(z), 0.0) for z in np.asarray(element))
    return float(w + MONOISOTOPIC_MASS[1] * float(np.sum(h_counts)))


def num_h_donors(element, h_counts) -> int:
    """N/O atoms carrying at least one H (Lipinski.NumHDonors semantics)."""
    element = np.asarray(element)
    return int(np.sum((np.isin(element, (7, 8))) & (np.asarray(h_counts) > 0)))


def num_h_acceptors(element) -> int:
    """N + O count — the original rule-of-five acceptor definition.
    Documented divergence: RDKit's Lipinski.NumHAcceptors excludes a few
    environments (pyrrole N, amide N) via SMARTS; the structural count is
    the published rule (ref scoring_func.py:33 context)."""
    return int(np.sum(np.isin(np.asarray(element), (7, 8))))


# --------------------------------------------------------------------------
# TPSA (Ertl 2000, N/O contributions — RDKit CalcTPSA default table)

def tpsa(element, bonds: Dict[Bond, int], aromatic, h_counts,
         charges: Optional[np.ndarray] = None) -> float:
    element = np.asarray(element)
    aromatic = np.asarray(aromatic, bool)
    h = np.asarray(h_counts)
    adj = _adjacency(len(element), bonds)
    total = 0.0
    for i in range(len(element)):
        z = int(element[i])
        if z not in (7, 8):
            continue
        orders = [o for _, o in adj[i]]
        deg = len(orders)
        has_double = 2 in orders
        has_triple = 3 in orders
        arom = bool(aromatic[i]) or 4 in orders
        q = int(charges[i]) if charges is not None else 0
        hi = int(h[i])
        if z == 8:
            if q < 0:
                total += 23.06
            elif arom:
                total += 13.14
            elif hi >= 1:
                total += 20.23
            elif has_double:
                total += 17.07
            else:
                total += 9.23
        else:  # N
            if arom:
                if q > 0:
                    total += 14.14 if hi >= 1 else 4.10
                elif hi >= 1:
                    total += 15.79
                elif deg >= 3:
                    total += 4.93
                else:
                    total += 12.89
            elif q > 0:
                total += {3: 27.64, 2: 16.61, 1: 4.44}.get(hi, 0.0)
            elif has_triple:
                total += 23.79
            elif hi == 0:
                total += 12.36 if has_double else 3.24
            elif hi == 1:
                total += 23.85 if has_double else 12.03
            else:
                total += 26.02
    return float(total)


# --------------------------------------------------------------------------
# Crippen logP — full Wildman-Crippen 68-type model (evaluation/crippen.py)

def crippen_logp(element, bonds: Dict[Bond, int], aromatic, h_counts,
                 charges: Optional[np.ndarray] = None) -> float:
    """Crippen.MolLogP parity (ref scoring_func.py:81) via the full
    published Wildman-Crippen atom typing; see evaluation/crippen.py and
    tests/test_crippen.py for the exactness anchors."""
    from decompdiff_tpu_torch.evaluation.crippen import crippen_logp_exact
    return crippen_logp_exact(element, bonds, aromatic, h_counts, charges)


# --------------------------------------------------------------------------
# rings / rotatable bonds / aromatic rings

def _rings(record) -> List[Tuple[int, ...]]:
    from decompdiff_tpu_torch.reconstruct.ligan import find_rings
    bonds = _undirected(record)
    return find_rings(record.num_atoms, {b: 1 for b in bonds}, max_size=24)


def num_aromatic_rings(record) -> int:
    aromatic = np.asarray(record.aromatic, bool)
    return sum(1 for ring in _rings(record)
               if all(aromatic[a] for a in ring))


def num_rings(record) -> int:
    """Ring count (CalcNumRings parity for similarity.batched_number_of_rings,
    ref utils/evaluation/similarity.py:20-24)."""
    return len(_rings(record))


# --------------------------------------------------------------------------
# linear-path fingerprint + Tanimoto

def _atom_label(z: int, arom: bool) -> str:
    return f'{z}a' if arom else f'{z}'


def path_fingerprint(record, n_bits: int = 2048, max_path: int = 7,
                     bits_per_path: int = 2) -> np.ndarray:
    """Daylight-style fingerprint over linear bond paths of length
    1..max_path (ref similarity.py:9-13 uses Chem.RDKFingerprint — branched
    subgraphs, 2048 bits, 2 bits/subgraph; the first-party variant
    enumerates simple linear paths, the dominant subgraph class for
    drug-sized molecules). Hash values differ from RDKit's by construction;
    Tanimoto similarities are only comparable within one fingerprint
    flavor."""
    element = np.asarray(record.element)
    aromatic = np.asarray(record.aromatic, bool)
    bonds = _undirected(record)
    adj = _adjacency(len(element), bonds)
    arom_flag = aromatic.copy()
    for (a, b), order in bonds.items():
        if order == 4:
            arom_flag[a] = arom_flag[b] = True

    paths = set()

    def walk(path: List[int], orders: List[int]):
        if len(orders) >= 1:
            fwd = []
            for idx, a in enumerate(path):
                fwd.append(_atom_label(int(element[a]), bool(arom_flag[a])))
                if idx < len(orders):
                    fwd.append(str(orders[idx]))
            rev = list(reversed(fwd))
            paths.add(tuple(min(fwd, rev)))
        if len(orders) == max_path:
            return
        last = path[-1]
        for nbr, order in adj[last]:
            if nbr in path:
                continue
            walk(path + [nbr], orders + [order])

    for start in range(len(element)):
        # single atoms too (RDKFingerprint minPath=1 covers lone atoms via
        # their incident bonds; isolated atoms still deserve a bit)
        paths.add((_atom_label(int(element[start]), bool(arom_flag[start])),))
        walk([start], [])

    fp = np.zeros(n_bits, bool)
    for p in paths:
        digest = hashlib.md5('|'.join(p).encode()).digest()
        val = int.from_bytes(digest[:8], 'little')
        for k in range(bits_per_path):
            fp[(val >> (16 * k)) % n_bits] = True
    return fp


def tanimoto(fp_a: np.ndarray, fp_b: np.ndarray) -> float:
    inter = int(np.sum(fp_a & fp_b))
    union = int(np.sum(fp_a | fp_b))
    return inter / union if union else 0.0


# --------------------------------------------------------------------------
# Weisfeiler-Lehman atom environments (Morgan-style, for SA symmetry term
# and stereocenter estimation)

def _converged_partition(element, bonds: Dict[Bond, int], aromatic,
                         h_counts, charges) -> List[int]:
    """Coarsest stable WL partition of the atoms (iterated neighborhood
    refinement to a fixpoint) seeded with (element, charge, nH, aromatic,
    degree) — the same information RDKit's legacy canonical ranks start
    from, and the partition those ranks induce before tie-breaking. Two
    atoms share a class iff no amount of neighborhood refinement can tell
    them apart (equals the automorphism orbit partition on all
    non-pathological molecular graphs)."""
    n = len(element)
    adj = _adjacency(n, bonds)
    charges = np.zeros(n, np.int64) if charges is None else \
        np.asarray(charges)
    aromatic = np.asarray(aromatic, bool)

    def classes(ls):
        order = {lab: k for k, lab in enumerate(sorted(set(ls)))}
        return [order[lab] for lab in ls]

    cls = classes([(int(element[i]), int(charges[i]), int(h_counts[i]),
                    bool(aromatic[i]), len(adj[i])) for i in range(n)])
    for _ in range(max(n, 1)):
        new = classes([(cls[i],
                        tuple(sorted((o, cls[j]) for j, o in adj[i])))
                       for i in range(n)])
        if new == cls:
            break
        cls = new
    return cls


def _estimate_stereocenters(record, h_counts) -> int:
    """sp3 carbons whose (up to 4) substituent branches fall in pairwise
    distinct classes of the converged WL partition — the structural
    stand-in for FindMolChiralCenters(includeUnassigned=True) in the SA
    stereo penalty (ref utils/evaluation/sascorer.py:70-80 via
    scoring.py:77). RDKit's legacy possible-stereocenter flag compares the
    neighbors' canonical ranks; the converged partition is exactly those
    ranks before tie-breaking, so this matches it wherever WL refinement
    resolves the orbits (all molecule-sized graphs in practice). Remaining
    deliberate divergence: heteroatom centers (S=O, P, N+) are not
    counted."""
    element = np.asarray(record.element)
    bonds = _undirected(record)
    labels = _converged_partition(element, bonds, record.aromatic,
                                  h_counts, record.charges)
    adj = _adjacency(len(element), bonds)
    n = 0
    for i in range(len(element)):
        if int(element[i]) != 6:
            continue
        orders = [o for _, o in adj[i]]
        if any(o != 1 for o in orders):
            continue
        subs = [labels[j] for j, _ in adj[i]]
        hi = int(h_counts[i])
        if len(subs) + hi != 4 or hi > 1:
            continue
        if len(set(subs)) == len(subs):
            n += 1
    return n


# --------------------------------------------------------------------------
# composite scores

def lipinski_count(record) -> int:
    """Satisfied rule-of-five count (ref scoring_func.py:28-38): exact-MW
    < 500, HBD <= 5, HBA <= 10, -2 <= logP <= 5, rotatable bonds <= 10."""
    from decompdiff_tpu_torch.utils.chem import get_num_rotatable_bonds
    bonds = _undirected(record)
    h = implicit_h_counts(record.element, bonds, record.charges)
    rules = [
        mol_weight(record.element, h) < 500,
        num_h_donors(record.element, h) <= 5,
        num_h_acceptors(record.element) <= 10,
        -2 <= crippen_logp(record.element, bonds, record.aromatic, h) <= 5,
        get_num_rotatable_bonds(record) <= 10,
    ]
    return int(sum(rules))


# --------------------------------------------------------------------------
# QED (Bickerton et al., Nat. Chem. 2012) — exact fitted ADS curves

# average atomic masses (QED's MW property is Descriptors.MolWt — average,
# not monoisotopic)
AVERAGE_MASS = {
    1: 1.008, 2: 4.003, 3: 6.941, 4: 9.012, 5: 10.812, 6: 12.011,
    7: 14.007, 8: 15.999, 9: 18.998, 10: 20.180, 11: 22.990, 12: 24.305,
    13: 26.982, 14: 28.086, 15: 30.974, 16: 32.067, 17: 35.453,
    19: 39.098, 20: 40.078, 25: 54.938, 26: 55.845, 27: 58.933,
    28: 58.693, 29: 63.546, 30: 65.39, 33: 74.922, 34: 78.971,
    35: 79.904, 53: 126.904,
}

# Asymmetric-double-sigmoid parameters (A, B, C, D, E, F, DMAX) per QED
# property — the published fit of Bickerton et al. 2012 (supplementary
# table; the same constants RDKit's QED.py ships as adsParameters).
QED_ADS_PARAMS = {
    'MW': (2.817065973, 392.5754953, 290.7489764, 2.419764353,
           49.22325677, 65.37051707, 104.9805561),
    'ALOGP': (3.172690585, 137.8624751, 2.534937431, 4.581497897,
              0.822739154, 0.576295591, 131.3186604),
    'HBA': (2.948620388, 160.4605972, 3.615294657, 4.435986202,
            0.290141953, 1.300669958, 148.7763046),
    'HBD': (1.618662227, 1010.051101, 0.985094388, 0.000000000001,
            0.713820843, 0.920922555, 258.1632616),
    'PSA': (1.876861559, 125.2232657, 62.90773554, 87.83366614,
            12.01999824, 28.51324732, 104.5686167),
    'ROTB': (0.010000091, 272.4121427, 2.558379970, 1.565547684,
             1.271567166, 2.758063707, 105.4420403),
    'AROM': (3.217788970, 957.7374108, 2.274627939, 0.000000000001,
             1.317690384, 0.375760881, 312.3372610),
    'ALERTS': (0.010000000, 1199.094025, -0.09002883, 0.000000000001,
               0.185904477, 0.875193782, 417.7253140),
}

# QED.weights_mean — the default the reference's scoring uses
# (ref scoring_func.py:79 calls rdkit qed(mol) == weights_mean)
QED_WEIGHTS_MEAN = (0.66, 0.46, 0.05, 0.61, 0.06, 0.65, 0.48, 0.95)
_QED_PROPS = ('MW', 'ALOGP', 'HBA', 'HBD', 'PSA', 'ROTB', 'AROM', 'ALERTS')


def ads(x: float, params) -> float:
    """Bickerton's asymmetric double sigmoid, normalized by its maximum."""
    a, b, c, d, e, f, dmax = params
    return (a + b / (1 + math.exp(-(x - c + d / 2) / e))
            * (1 - 1 / (1 + math.exp(-(x - c - d / 2) / f)))) / dmax


def mol_weight_avg(element, h_counts) -> float:
    """Average molecular weight incl. implicit Hs (Descriptors.MolWt)."""
    w = sum(AVERAGE_MASS.get(int(z), 0.0) for z in np.asarray(element))
    return float(w + AVERAGE_MASS[1] * float(np.sum(h_counts)))


def qed_hba(record, bonds, h) -> int:
    """QED's own acceptor definition — the 11-pattern SMARTS set of
    QED.py's ``Acceptors`` (NOT Lipinski's N+O count), translated
    structurally pattern-for-pattern."""
    element = np.asarray(record.element)
    aromatic = np.asarray(record.aromatic, bool)
    adj = _adjacency(len(element), bonds)
    arom = aromatic.copy()
    for (a, b), o in bonds.items():
        if o == 4:
            arom[a] = arom[b] = True
    n = 0
    for i in range(len(element)):
        z, hi = int(element[i]), int(h[i])
        q = int(record.charges[i]) if record.charges is not None else 0
        orders = [o for _, o in adj[i]]
        deg = len(orders)
        if z == 8:
            if q < 0 and deg == 1:
                n += 1                        # [O-;X1]
            elif arom[i] and hi == 0 and deg == 2:
                n += 1                        # [oH0;X2]
            elif not arom[i] and q == 0:
                if hi == 1 and deg == 1:
                    n += 1                    # [OH1;X2;v2]
                elif hi == 0 and deg == 2 and all(o == 1 for o in orders):
                    n += 1                    # [OH0;X2;v2]
                elif hi == 0 and deg == 1 and orders == [2]:
                    n += 1                    # [OH0;X1;v2]
        elif z == 16:
            if q < 0 and deg == 1:
                n += 1                        # [S-;X1]
            elif not arom[i] and q == 0 and hi == 0:
                if deg == 2 and all(o == 1 for o in orders):
                    n += 1                    # [SH0;X2;v2]
                elif deg == 1 and orders == [2]:
                    n += 1                    # [SH0;X1;v2]
        elif z == 7:
            if arom[i] and hi == 0 and deg == 2:
                n += 1                        # [nH0;X2]
            elif not arom[i] and hi == 0 and deg == 1 and orders == [3]:
                n += 1                        # [NH0;X1;v3]
            elif (not arom[i] and q == 0 and deg + hi == 3
                    and all(o == 1 for o in orders)):
                # [$([N;+0;X3;v3]);!$(N[C,S]=O)] — amine, not amide-like
                amide = any(
                    int(element[j]) in (6, 16)
                    and any(o2 == 2 and int(element[k]) == 8
                            for k, o2 in adj[j])
                    for j, o in adj[i] if o == 1)
                if not amide:
                    n += 1
    return n


def qed_hbd(record, h) -> int:
    """CalcNumHBD semantics: N with >=1 H (neutral v3 or cationic v4),
    neutral O/S with exactly one H."""
    element = np.asarray(record.element)
    n = 0
    for i in range(len(element)):
        z, hi = int(element[i]), int(h[i])
        q = int(record.charges[i]) if record.charges is not None else 0
        if z == 7 and hi >= 1 and q >= 0:
            n += 1
        elif z in (8, 16) and hi == 1 and q == 0:
            n += 1
    return n


def num_rotatable_bonds_strict(record, h) -> int:
    """RDKit's Strict rotatable-bond pattern (what QED's ROTB uses): the
    default non-ring single-bond rule minus CX3-halide / tert-butyl rotors
    and amide-like bonds ([CD3](=[N,O,S])-[N,O,S])."""
    from decompdiff_tpu_torch.utils.chem import _record_rotatable_bonds
    element = np.asarray(record.element)
    bonds = _undirected(record)
    adj = _adjacency(len(element), bonds)

    def _trihalide_or_tbu(i):
        if int(element[i]) != 6:
            return False
        nbr_z = [int(element[j]) for j, o in adj[i] if o == 1]
        for hal in (9, 17, 35):
            if nbr_z.count(hal) >= 3:
                return True
        n_methyl = sum(1 for j, o in adj[i]
                       if o == 1 and int(element[j]) == 6
                       and len(adj[j]) == 1 and int(h[j]) == 3)
        return n_methyl >= 3

    def _amide_like(a, b):
        # a: [CD3](=[N,O,S]) carbon; b: the N/O/S single-bonded to it
        return (int(element[a]) == 6 and len(adj[a]) == 3
                and any(o == 2 and int(element[j]) in (7, 8, 16)
                        for j, o in adj[a])
                and int(element[b]) in (7, 8, 16))

    pairs, rot = _record_rotatable_bonds(record)
    count = 0
    for idx in rot:
        a, b = pairs[idx]
        if _trihalide_or_tbu(a) or _trihalide_or_tbu(b):
            continue
        if _amide_like(a, b) or _amide_like(b, a):
            continue
        count += 1
    return count


def qed_properties(record) -> Dict[str, float]:
    """The eight QED properties (QED.py ``properties(mol)`` parity, except
    ALERTS — see qed_score)."""
    bonds = _undirected(record)
    h = implicit_h_counts(record.element, bonds, record.charges)
    return {
        'MW': mol_weight_avg(record.element, h),
        'ALOGP': crippen_logp(record.element, bonds, record.aromatic, h,
                              record.charges),
        'HBA': qed_hba(record, bonds, h),
        'HBD': qed_hbd(record, h),
        'PSA': tpsa(record.element, bonds, record.aromatic, h,
                    record.charges),
        'ROTB': num_rotatable_bonds_strict(record, h),
        'AROM': num_aromatic_rings(record),
        'ALERTS': _qed_alert_count(record),
    }


def _qed_alert_count(record) -> int:
    """Structural-alert count for QED. RDKit's Brenk catalog is binary-only
    (see qed_score docstring); when the user supplies the SMARTS corpus via
    DD_QED_ALERTS_SMARTS (same file formats as the PAINS hook,
    evaluation/alerts.py), count matches exactly with the first-party
    engine; otherwise 0 (alert-free molecules score exactly either way)."""
    import os
    path = os.environ.get('DD_QED_ALERTS_SMARTS')
    if not path or not os.path.isfile(path):
        return 0
    from decompdiff_tpu_torch.evaluation.alerts import (
        load_catalog, match_alerts)
    return len(match_alerts(record, catalog=load_catalog(path),
                            first_only=False))


def qed_score(record) -> float:
    """QED with the published fitted ADS desirability curves and the
    weights_mean weighting — exact Bickerton/RDKit parity for every term
    except ALERTS (ref scoring_func.py:79 uses rdkit ``qed(mol)``).

    Documented divergence: the structural-alert count defaults to 0 — the
    Brenk alert SMARTS catalog lives inside RDKit (QED.StructuralAlerts)
    and is not reproducible in-image, the same corpus class as the SA
    fpscores table. d_ALERTS(0) is the curve's maximum, so alert-free
    molecules score exactly; molecules carrying alerts score higher here
    than RDKit would say (PARITY.md SS2). Supplying the corpus via
    DD_QED_ALERTS_SMARTS closes the gap exactly (first-party SMARTS
    engine, _qed_alert_count)."""
    props = qed_properties(record)
    t = sum(w * math.log(ads(props[k], QED_ADS_PARAMS[k]))
            for w, k in zip(QED_WEIGHTS_MEAN, _QED_PROPS))
    return float(math.exp(t / sum(QED_WEIGHTS_MEAN)))


def sa_score(record) -> float:
    """Full Ertl-Schuffenhauer SA score, normalized to (0, 1] like the
    reference ((10 - sa) / 9, ref scoring_func.py:96-99). The
    fragment-frequency term (score1, ref utils/evaluation/sascorer.py:29-56)
    is computed against the committed fpscores.pkl.gz corpus via the
    first-party Morgan fingerprint (evaluation/morgan.py) whose env ids are
    RDKit-exact (100% corpus membership on anchor molecules,
    tests/test_morgan.py); the size/ring/stereo/symmetry penalties follow
    the published formula (ref sascorer.py:60-106). Remaining divergence:
    the stereocenter count matches RDKit's legacy possible-stereocenter
    flag (converged-WL rank distinctness) but skips heteroatom centers
    and CIP-only corner cases."""
    element = np.asarray(record.element)
    bonds = _undirected(record)
    h = implicit_h_counts(element, bonds, record.charges)
    n_atoms = len(element)
    rings = _rings(record)

    spiro, bridge = set(), set()
    ring_sets = [set(r) for r in rings]
    adj = _adjacency(n_atoms, bonds)
    for i in range(len(ring_sets)):
        for j in range(i + 1, len(ring_sets)):
            shared = ring_sets[i] & ring_sets[j]
            if len(shared) == 1:
                spiro |= shared
            elif len(shared) == 2:
                a, b = sorted(shared)
                if (a, b) not in bonds:
                    bridge |= shared
            elif len(shared) > 2:
                # shared path: its endpoints are the bridgeheads
                for a in shared:
                    nbrs_in = sum(1 for x, _ in adj[a] if x in shared)
                    if nbrs_in < 2:
                        bridge.add(a)
    n_macro = sum(1 for r in rings if len(r) > 8)
    n_chiral = _estimate_stereocenters(record, h)

    size_penalty = n_atoms ** 1.005 - n_atoms
    stereo_penalty = math.log10(n_chiral + 1)
    spiro_penalty = math.log10(len(spiro) + 1)
    bridge_penalty = math.log10(len(bridge) + 1)
    macro_penalty = math.log10(2) if n_macro > 0 else 0.0
    score2 = (-size_penalty - stereo_penalty - spiro_penalty
              - bridge_penalty - macro_penalty)

    # fragment-frequency term + symmetry correction from the RDKit-exact
    # Morgan fingerprint (ref sascorer.py:44-56 and :86-90: numBits is the
    # count of distinct radius<=2 environments)
    from decompdiff_tpu_torch.evaluation.morgan import fragment_score
    score1, num_bits = fragment_score(element, bonds, h, record.charges)
    score3 = 0.0
    if n_atoms > num_bits:
        score3 = math.log(float(n_atoms) / num_bits) * 0.5

    sascore = score1 + score2 + score3
    smin, smax = -4.0, 2.5
    sascore = 11.0 - (sascore - smin + 1) / (smax - smin) * 9.0
    if sascore > 8.0:
        sascore = 8.0 + math.log(sascore + 1.0 - 9.0)
    sascore = min(max(sascore, 1.0), 10.0)
    return round((10.0 - sascore) / 9.0, 2)


def get_chem_record(record) -> dict:
    """get_chem on a MolRecord (same keys as ref scoring_func.py:76-93);
    see the per-descriptor exactness notes above."""
    from decompdiff_tpu_torch.evaluation.scoring import get_ring_sizes
    bonds = _undirected(record)
    h = implicit_h_counts(record.element, bonds, record.charges)
    return {
        'qed': qed_score(record),
        'sa': sa_score(record),
        'logp': crippen_logp(record.element, bonds, record.aromatic, h,
                             record.charges),
        'lipinski': lipinski_count(record),
        'ring_size': Counter(get_ring_sizes(record)),
        # provenance marker so downstream consumers cannot silently mix
        # scales: qed/logp/sa are published-exact here up to the documented
        # caveats (qed ALERTS defaults to 0; sa stereocenters carbon-only)
        'chem_backend': 'first_party',
    }
