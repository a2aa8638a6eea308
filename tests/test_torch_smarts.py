"""The port's SMILES parser, SMARTS engine and alert catalogs
(decompdiff_tpu_torch/evaluation/{smiles,smarts,alerts}.py) and the two
hooks that reach them (scoring.is_pains on a MolRecord, the QED alert count
under DD_QED_ALERTS_SMARTS) against the JAX package on the CPU.

Molecules and patterns: every SMILES and SMARTS of tests/test_smarts.py
(its match cases, alert positives and negatives, writer molecules), each
SMARTS matched against every molecule. The four documented divergences of
the JAX engine from RDKit have a case each, showing the port keeps them.

Tolerance: exact. Each package parses the SMILES with its own parser and
matches with its own engine: graphs compare field by field with
np.array_equal, match verdicts, embeddings and alert lists with ==.
"""

import numpy as np
import pytest

from decompdiff_tpu.evaluation import alerts as j_alerts
from decompdiff_tpu.evaluation import descriptors as j_desc
from decompdiff_tpu.evaluation import scoring as j_scoring
from decompdiff_tpu.evaluation import smarts as j_smarts
from decompdiff_tpu.evaluation import smiles as j_smiles
from decompdiff_tpu_torch.evaluation import alerts as p_alerts
from decompdiff_tpu_torch.evaluation import descriptors as p_desc
from decompdiff_tpu_torch.evaluation import scoring as p_scoring
from decompdiff_tpu_torch.evaluation import smarts as p_smarts
from decompdiff_tpu_torch.evaluation import smiles as p_smiles
from test_smarts import ALERT_POS_NEG, MATCH_CASES, WRITER_SMILES

EXTRA_SMILES = [
    'C%10CC%10', '[Na+].[Cl-]', 'C/C=C/C', 'C=1CCCCC=1', '[O-]C',
    '[Fe+2]', '[13CH3:1][C@@H](N)O', 'c1ccccc1c1ccccc1', 'CC(C)O', 'CCO',
    'N', 'NC', 'CN(C)C', 'C=O', 'NC(=Cc1ccccc1)C#N',
    'CN(C)C(=Cc1ccccc1)C#N',
    'C1=CC=CC=C1', 'O=C(O)c1ccccc1Cl', 'Brc1ccc(I)cc1', 'OP(=O)(O)O',
    'B(O)O', '[nH]1cccc1', '[NH2-]', '[OH3+]', '[CH2++]', '[2H]O[2H]',
    # lenient inputs both parsers accept alike
    'CC((C))', 'C==C',
]
SMILES = sorted({s for s, _, _ in MATCH_CASES}
                | {s for pair in ALERT_POS_NEG.values() for s in pair}
                | set(WRITER_SMILES) | set(EXTRA_SMILES))
PATTERNS = sorted({p for _, p, _ in MATCH_CASES}
                  | {p for _, p in j_alerts.FIRST_PARTY_ALERTS}
                  | {'cc', 'CC', 'C~C', '[#7](-[#1])-[#1]', '[#7]-[#1]',
                     '[#6](-[#1])(-[#1])=O', '[OX2][H]', '[#1][OX2]',
                     '[#6](=[#6](-[#6]#[#7])-[#7](-[#1])-[#1])(-[#1])'
                     '-[#6]:[#6]', '[$([OH]),$([NH2])]', '[c;!$(c[N,O])]',
                     '[#6;R1;x2]', '[C;h2]', '*', '[a]', '[A;!#1]'})


def assert_same_graph(j, p):
    for f in ('element', 'pos', 'bond_index', 'bond_type', 'aromatic',
              'charges'):
        a, b = getattr(j, f), getattr(p, f)
        if a is None or b is None:
            assert a is b is None, f
            continue
        assert np.asarray(a).dtype == np.asarray(b).dtype, f
        assert np.array_equal(a, b), f
    assert (j.name, j.hybridization, j.props) == (
        p.name, p.hybridization, p.props)


def both(smi):
    return j_smiles.mol_from_smiles(smi), p_smiles.mol_from_smiles(smi)


@pytest.mark.parametrize('smi', SMILES)
def test_mol_from_smiles(smi):
    j, p = both(smi)
    assert_same_graph(j, p)
    assert p_smiles.mol_to_smiles(p) == j_smiles.mol_to_smiles(j)
    jc, pc = j_smarts.MolContext(j), p_smarts.MolContext(p)
    for f in ('z', 'aromatic', 'charge', 'degree', 'h', 'valence',
              'ring_count', 'min_ring', 'ring_degree'):
        assert np.array_equal(getattr(jc, f), getattr(pc, f)), f
    assert (jc.adj, jc.bond_order, jc.ring_bonds) == (
        pc.adj, pc.bond_order, pc.ring_bonds)


@pytest.mark.parametrize('bad', [
    'C(', 'C)', 'C1CC', 'Xx', '', '[Q]', '1CC', 'C[NH2', 'C%', 'C%1C',
    'C=1CCCCC#1'])
def test_smiles_errors(bad):
    errors = []
    for mod in (j_smiles, p_smiles):
        with pytest.raises(mod.SmilesError) as err:
            mod.mol_from_smiles(bad)
        errors.append(str(err.value))
    assert errors[0] == errors[1]


def test_smiles_tables():
    assert p_smiles.SYMBOL_TO_Z == j_smiles.SYMBOL_TO_Z
    assert p_smiles.ORGANIC_SUBSET == j_smiles.ORGANIC_SUBSET
    assert p_smiles.BOND_CHARS == j_smiles.BOND_CHARS
    for s in ('[13CH3+:7]]', '[nH]', '[C@@H2-2]', '[*]', '[Cl-]'):
        assert (p_smiles._parse_bracket(s, 1)
                == j_smiles._parse_bracket(s, 1))


@pytest.mark.parametrize('pattern', PATTERNS)
def test_smarts_match_every_molecule(pattern):
    jp, pp = j_smarts.compile_smarts(pattern), p_smarts.compile_smarts(pattern)
    assert (len(jp.atoms), len(jp.bonds), jp.components) == (
        len(pp.atoms), len(pp.bonds), pp.components)
    hits = 0
    for smi in SMILES:
        j, p = both(smi)
        verdict = jp.match(j)
        assert pp.match(p) == verdict, smi
        assert pp.find(p) == jp.find(j), smi
        hits += verdict
    expected = {(s, e) for s, q, e in MATCH_CASES if q == pattern}
    for smi, exp in expected:
        assert pp.match(p_smiles.mol_from_smiles(smi)) == exp, smi
    assert hits == sum(
        j_smarts.has_substruct(j_smiles.mol_from_smiles(s), pattern)
        for s in SMILES)


@pytest.mark.parametrize('bad', ['[', 'C(', 'C1', '[Zq]', '', '[C', '$(C'])
def test_smarts_errors(bad):
    outcomes = []
    for smiles_mod, smarts_mod in ((j_smiles, j_smarts),
                                   (p_smiles, p_smarts)):
        try:
            smarts_mod.compile_smarts(bad).match(
                smiles_mod.mol_from_smiles('CC'))
            outcomes.append(None)
        except Exception as e:  # the engine's error types, compared below
            outcomes.append((type(e).__name__, str(e)))
    assert outcomes[0] == outcomes[1] and outcomes[0] is not None


@pytest.mark.parametrize('name', sorted(ALERT_POS_NEG))
def test_alert_catalog(name):
    assert p_alerts.FIRST_PARTY_ALERTS == j_alerts.FIRST_PARTY_ALERTS
    for smi in ALERT_POS_NEG[name]:
        j, p = both(smi)
        for first_only in (True, False):
            assert (p_alerts.match_alerts(p, first_only=first_only)
                    == j_alerts.match_alerts(j, first_only=first_only))
        assert p_alerts.is_pains_record(p) == j_alerts.is_pains_record(j)
        assert p_scoring.is_pains(p) is j_scoring.is_pains(j)
    assert name in p_alerts.match_alerts(
        p_smiles.mol_from_smiles(ALERT_POS_NEG[name][0]), first_only=False)


def test_catalog_file(tmp_path, monkeypatch):
    cat = tmp_path / 'pains.txt'
    cat.write_text('# custom corpus\n'
                   '"c1ccccc1","<regId=any_benzene>"\n'
                   'C#N nitrile_alert\n\n[OX2H]\n')
    assert p_alerts.load_catalog(str(cat)) == j_alerts.load_catalog(str(cat))
    monkeypatch.setenv('DD_PAINS_SMARTS', str(cat))
    assert p_alerts.pains_backend() == j_alerts.pains_backend() == (
        'catalog_file')
    for smi in ('c1ccccc1', 'CC#N', 'CCO', 'CCC'):
        j, p = both(smi)
        assert p_scoring.is_pains(p) is j_scoring.is_pains(j)
        assert (p_alerts.match_alerts(p, first_only=False)
                == j_alerts.match_alerts(j, first_only=False))
    monkeypatch.delenv('DD_PAINS_SMARTS')
    assert p_alerts.pains_backend() == 'first_party_subset'


@pytest.mark.parametrize('smi', ['O=C1C=CC(=O)C=C1', 'CCO', 'CC=O',
                                 'CC(=O)Nc1ccc(O)cc1', 'C1CC1CCCC1CC1'])
def test_qed_alert_count(tmp_path, monkeypatch, smi):
    cat = tmp_path / 'brenk.txt'
    cat.write_text('O=C1C=CC(=O)C=C1 quinone\nN=[N+]=[N-] azide\n'
                   '[CX3H1]=O aldehyde\nC1CC1 cyclopropane\n'
                   '[OX2H] hydroxyl\n')
    j, p = both(smi)
    base = p_desc.qed_score(p)
    assert base == j_desc.qed_score(j)
    monkeypatch.setenv('DD_QED_ALERTS_SMARTS', str(cat))
    assert p_desc._qed_alert_count(p) == j_desc._qed_alert_count(j)
    assert p_desc.qed_properties(p) == j_desc.qed_properties(j)
    assert p_desc.qed_score(p) == j_desc.qed_score(j)
    if p_desc._qed_alert_count(p):
        assert p_desc.qed_score(p) < base


# --- the four divergences from RDKit, kept in both packages ----------------

def test_divergence_lone_bracket_h():
    """[H] is an H-count primitive on the query atom itself: '[OX2][H]'
    misses ethanol and matches isopropanol (RDKit: the reverse)."""
    for smi, verdict in (('CCO', False), ('CC(C)O', True)):
        j, p = both(smi)
        assert j_smarts.has_substruct(j, '[OX2][H]') is verdict
        assert p_smarts.has_substruct(p, '[OX2][H]') is verdict


def test_divergence_leading_explicit_h():
    """A top-level pattern starting with [#1] keeps it as a graph atom and
    matches no heavy-atom-only record (RDKit merges it)."""
    for pattern in ('[#1][OX2]', '[#1]-[#6]'):
        j, p = both('CCO')
        assert j_smarts.has_substruct(j, pattern) is False
        assert p_smarts.has_substruct(p, pattern) is False
        assert len(p_smarts.compile_smarts(pattern).atoms) == 2


def test_divergence_brenk_motifs_under_pains():
    """The first-party subset flags Brenk-class motifs (an aldehyde, an
    alkyl halide) as PAINS, which RDKit's PAINS_A does not."""
    for smi in ('CC=O', 'CCCl'):
        j, p = both(smi)
        assert j_scoring.is_pains(j) is True
        assert p_scoring.is_pains(p) is True


def test_divergence_aromatic_bond_between_rings():
    """The unmarked bond between two aromatic rings stays order 4 (RDKit's
    sanitization makes it single)."""
    j, p = both('c1ccccc1c1ccccc1')
    for m in (j, p):
        bonds = {(int(a), int(b)): int(t) for a, b, t in zip(
            m.bond_index[0], m.bond_index[1], m.bond_type)}
        assert bonds[(5, 6)] == 4
    assert_same_graph(j, p)
