"""Structural-alert catalogs for the first-party SMARTS engine (port of
decompdiff_tpu/evaluation/alerts.py).

The reference's `is_pains` (ref utils/evaluation/scoring_func.py:15-25)
matches RDKit's compiled PAINS_A FilterCatalog — a binary-only corpus this
image cannot read. Three execution tiers, most exact first:

  1. RDKit present: scoring.is_pains uses the reference recipe verbatim.
  2. A user-supplied SMARTS catalog file (``DD_PAINS_SMARTS`` env var or
     ``load_catalog(path)``): exact corpus matching via the first-party
     engine. Accepts RDKit's wehi_pains.csv format ("SMARTS","<regId=..>")
     and plain ``SMARTS<whitespace>name`` lines.
  3. Otherwise: FIRST_PARTY_ALERTS below — a self-authored subset of the
     highest-frequency PAINS/Brenk motif CLASSES (quinones, catechols,
     rhodanines, azo, Michael acceptors, ...). This is NOT the
     Baell-Holloway 2010 corpus: it flags the motif families, not the 480
     exact patterns. Provenance is carried by `pains_backend()`.

Divergence from the reference, kept as in the JAX package: tier 3 also
flags Brenk-class reactive motifs (aldehyde, alkyl halide, Michael
acceptor, disulfide, ...) under the is_pains name, which RDKit's PAINS_A
catalog does not flag, so PAINS rates without a DD_PAINS_SMARTS corpus
run higher than the reference's and are not comparable to them.
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

from decompdiff_tpu_torch.evaluation.smarts import MolContext, compile_smarts

# Self-authored motif-class alerts (name, SMARTS). Every pattern has a
# constructed positive + negative molecule in tests/test_smarts.py.
FIRST_PARTY_ALERTS: List[Tuple[str, str]] = [
    ('quinone_para', 'O=C1C=CC(=O)C=C1'),
    ('quinone_ortho', 'O=C1C(=O)C=CC=C1'),
    ('catechol', '[OX2H]c1ccccc1[OX2H]'),
    ('hydroquinone', '[OX2H]c1ccc([OX2H])cc1'),
    ('azo', '[#6]N=N[#6]'),
    ('acyclic_imine', '[CX3;!R]=[NX2;!R][#6]'),
    ('hydrazone', '[CX3]=[NX2][NX3]'),
    ('rhodanine', 'S1C(=S)NC(=O)C1'),
    ('ene_rhodanine', 'C=C1SC(=S)NC1=O'),
    ('thiazolidinone_ene', 'C=C1SC(=O)NC1=O'),
    ('isothiazolone', 'O=C1C=CSN1'),
    ('michael_acceptor', '[CX3]=[CX3][CX3]=[OX1]'),
    ('nitro_arom', 'c[N+](=O)[O-]'),
    ('nitro_arom_neutral', 'c[NX3](=O)=O'),
    ('thiourea', '[NX3][CX3](=S)[NX3]'),
    ('aldehyde', '[CX3H1]=O'),
    ('alkyl_halide', '[CX4][Cl,Br,I]'),
    ('peroxide', '[OX2][OX2]'),
    ('disulfide', '[#16X2][#16X2]'),
    ('mannich_phenol', '[OX2H]c1ccccc1[CH2][NX3]'),
]


_catalog_cache: dict = {}


def load_catalog(path: str) -> List[Tuple[str, str]]:
    """Load a SMARTS catalog. Supports RDKit's pains.csv quoting
    ("SMARTS","<regId=name>") and plain `SMARTS name` lines; '#' comments
    and blank lines skipped. Cached by (path, mtime) — the chem-scoring
    loop calls this once per molecule."""
    key = (path, os.stat(path).st_mtime_ns)
    hit = _catalog_cache.get(key)
    if hit is not None:
        return hit
    out: List[Tuple[str, str]] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith('#'):
                continue
            if line.startswith('"'):
                parts = [p.strip().strip('"') for p in line.split('","')]
                smarts = parts[0].lstrip('"')
                name = parts[1].rstrip('"') if len(parts) > 1 else smarts
                if name.startswith('<regId='):
                    name = name[len('<regId='):].rstrip('>')
            else:
                fields = line.split(None, 1)
                smarts = fields[0]
                name = fields[1].strip() if len(fields) > 1 else smarts
            out.append((name, smarts))
    if len(_catalog_cache) >= 8:    # stale-mtime entries of the same paths
        _catalog_cache.clear()
    _catalog_cache[key] = out
    return out


def _active_catalog() -> Tuple[str, List[Tuple[str, str]]]:
    path = os.environ.get('DD_PAINS_SMARTS')
    if path and os.path.isfile(path):
        return 'catalog_file', load_catalog(path)
    return 'first_party_subset', FIRST_PARTY_ALERTS


def pains_backend() -> str:
    """Provenance of the MolRecord PAINS path:
    'catalog_file' (user-supplied corpus) or 'first_party_subset'."""
    return _active_catalog()[0]


def match_alerts(record, catalog: Optional[List[Tuple[str, str]]] = None,
                 first_only: bool = True) -> List[str]:
    """Names of catalog alerts present in `record` (MolRecord)."""
    if catalog is None:
        catalog = _active_catalog()[1]
    ctx = MolContext(record)
    hits = []
    for name, smarts in catalog:
        if compile_smarts(smarts).match(ctx):
            hits.append(name)
            if first_only:
                break
    return hits


def is_pains_record(record) -> bool:
    """First-party PAINS verdict for a MolRecord (tiers 2/3 above)."""
    return bool(match_alerts(record))
