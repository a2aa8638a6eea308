"""The port's native host library (csrc/ddnative.cpp, built with g++ by
ops/_build.py) against its numpy plain versions and the JAX package's
routines, with its C library and with its Python fallbacks; the build
itself; and the two callers whose rules depend on the library: the PDB
parser (data/protein.py) and the bond candidates of reconstruct/ligan.py.

Tolerance: none. The routines copy, compare and parse with the same C or
float64 arithmetic on both sides, so every result is bit-equal (values and
dtypes).
"""

import numpy as np
import pytest

from decompdiff_tpu import native as jax_native
from decompdiff_tpu.data import protein as jax_protein
from decompdiff_tpu.reconstruct import ligan as jax_ligan
from decompdiff_tpu_torch import native
from decompdiff_tpu_torch.data import protein
from decompdiff_tpu_torch.ops import _build
from decompdiff_tpu_torch.reconstruct import ligan
from tests.test_data_layer import PDB_BLOCK
from tests.test_torch_host_data import _float32_xyz, assert_same


@pytest.fixture(params=['c', 'fallback'])
def jax_native_lib(request, monkeypatch):
    """The JAX package's native routines with its C library, or with its
    Python fallbacks."""
    if request.param == 'c':
        if not jax_native.available():
            pytest.skip('the JAX package could not build its C library')
    else:
        monkeypatch.setattr(jax_native, 'get_lib', lambda: None)
    return request.param


@pytest.fixture
def jax_c_library():
    if not jax_native.available():
        pytest.skip('the JAX package could not build its C library')


# --------------------------------------------------------------------------
# the build
# --------------------------------------------------------------------------

def _source_copy(tmp_path, text=None):
    csrc = tmp_path / 'csrc'
    csrc.mkdir()
    (csrc / 'ddnative.cpp').write_text(
        text if text is not None
        else (_build.CSRC / 'ddnative.cpp').read_text())
    return csrc


def test_library_is_built_into_build_dir():
    native.length_masks([1], 2)
    path = _build.library_path('ddnative')
    assert path.parent == _build.BUILD_DIR and path.exists()
    name, digest = path.stem.split('-')
    assert name == 'ddnative' and len(digest) == 16
    assert '-march=native' not in _build.GXX_FLAGS
    assert 'ddnative' in _build.SOURCES and 'ddnative' not in _build.KERNELS


def test_changed_source_or_flags_give_a_new_library(tmp_path, monkeypatch):
    csrc = _source_copy(tmp_path)
    monkeypatch.setattr(_build, 'CSRC', csrc)
    first = _build.library_path('ddnative')
    assert first == _build.library_path('ddnative')
    (csrc / 'ddnative.cpp').write_text(
        (csrc / 'ddnative.cpp').read_text() + '// edited\n')
    edited = _build.library_path('ddnative')
    monkeypatch.setattr(_build, 'GXX_FLAGS', _build.GXX_FLAGS + ('-g',))
    flagged = _build.library_path('ddnative')
    assert len({first, edited, flagged}) == 3


def test_host_build_calls_no_nvcc_and_replaces_in_one_step(
        tmp_path, monkeypatch):
    monkeypatch.setattr(_build, 'CSRC', _source_copy(tmp_path))
    monkeypatch.setattr(_build, 'BUILD_DIR', tmp_path / 'build')
    monkeypatch.setattr(_build, '_LIBS', {})

    def no_nvcc():
        raise AssertionError('the host library asked for nvcc')
    monkeypatch.setattr(_build, 'nvcc_path', no_nvcc)
    logs = _build.build(['ddnative'])
    assert set(logs) == {'ddnative'}
    assert [p.name for p in (tmp_path / 'build').iterdir()] == [
        _build.library_path('ddnative').name]        # no temp file left
    assert _build.build(['ddnative']) == {'ddnative': ''}   # reused
    lib = _build.library('ddnative')
    assert hasattr(lib, 'perceive_bonds')


def test_failed_build_raises_with_the_compiler_output(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, 'CSRC', _source_copy(
        tmp_path, 'extern "C" int broken( { return 0; }\n'))
    monkeypatch.setattr(_build, 'BUILD_DIR', tmp_path / 'build')
    monkeypatch.setattr(_build, '_LIBS', {})
    with pytest.raises(RuntimeError, match='(?s)ddnative.*error'):
        _build.library('ddnative')
    assert not any((tmp_path / 'build').iterdir())


def test_missing_compiler_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, 'CSRC', _source_copy(tmp_path))
    monkeypatch.setattr(_build, 'BUILD_DIR', tmp_path / 'build')
    monkeypatch.setattr(_build.shutil, 'which', lambda name: None)
    with pytest.raises(RuntimeError, match='g\\+\\+ not found'):
        _build.build(['ddnative'])


# --------------------------------------------------------------------------
# padding and masks: C = plain = JAX (C) = JAX (Python)
# --------------------------------------------------------------------------

def _arrays(counts, F, seed=0):
    rng = np.random.default_rng(seed)
    if F is None:                                    # 1-D arrays
        return [rng.normal(size=n).astype(np.float32) for n in counts]
    return [rng.normal(size=(n, F)).astype(np.float32) for n in counts]


PAD_CASES = {
    'rows': ((3, 7, 1), 3, 8),
    'empty_member': ((3, 0, 5), 3, 6),
    'all_empty': ((0, 0), 3, 4),
    'count_is_n_pad': ((4, 4), 29, 4),
    'one_d': ((2, 3, 0), None, 5),
    'single': ((1,), 1, 1),
}


@pytest.mark.parametrize('case', sorted(PAD_CASES))
def test_pad_stacks_match_plain_and_jax(case, jax_native_lib):
    counts, F, n_pad = PAD_CASES[case]
    floats = _arrays(counts, F)
    ints = [(a * 100).astype(np.int32) for a in floats]
    for fn, arrays in (('pad_stack_f32', floats), ('pad_stack_i32', ints)):
        got = getattr(native, fn)(arrays, n_pad)
        assert_same(got, getattr(native.plain, fn)(arrays, n_pad), fn)
        assert_same(got, getattr(jax_native, fn)(arrays, n_pad), fn)


MASK_COUNTS = {'none': ([], 4), 'zero': ([0], 3), 'mixed': ([0, 3, 5], 6),
               'full': ([6, 6], 6), 'one': ([1], 1)}


@pytest.mark.parametrize('case', sorted(MASK_COUNTS))
def test_masks_and_square_stack_match_plain_and_jax(case, jax_native_lib):
    counts, n_pad = MASK_COUNTS[case]
    for fn in ('length_masks', 'fc_bond_masks'):
        got = getattr(native, fn)(counts, n_pad)
        assert_same(got, getattr(native.plain, fn)(counts, n_pad), fn)
        assert_same(got, getattr(jax_native, fn)(counts, n_pad), fn)
    if counts:
        rng = np.random.default_rng(len(counts))
        mats = [rng.integers(0, 5, size=(n, n)).astype(np.int32)
                for n in counts]
        got = native.pad_square_stack_i32(mats, n_pad)
        assert_same(got, native.plain.pad_square_stack_i32(mats, n_pad))
        assert_same(got, jax_native.pad_square_stack_i32(mats, n_pad))


@pytest.mark.parametrize('fn', ['pad_stack_f32', 'pad_stack_i32',
                                'length_masks', 'fc_bond_masks',
                                'pad_square_stack_i32'])
def test_oversize_count_raises_before_the_c_call(fn, monkeypatch):
    """The C routines memcpy with no bounds check: a count above n_pad must
    raise before any pointer reaches them."""
    arg = {'pad_stack_f32': _arrays((2, 5), 3),
           'pad_stack_i32': [np.zeros((5, 2), np.int32)],
           'length_masks': [1, 5], 'fc_bond_masks': [5],
           'pad_square_stack_i32': [np.zeros((5, 5), np.int32)]}[fn]

    def no_c_call(name):
        raise AssertionError(f'{name} reached the C library')
    monkeypatch.setattr(native, 'routine', no_c_call)
    for module in (native, native.plain, jax_native):
        with pytest.raises(ValueError, match=f'{fn}: max count 5 exceeds '
                                             'n_pad 4'):
            getattr(module, fn)(arg, 4)


def test_calls_count_each_c_routine():
    before = dict(native.calls)
    native.pad_stack_f32(_arrays((2,), 3), 2)
    native.pad_stack_i32([np.zeros(2, np.int32)], 2)
    native.length_masks([1], 2)
    native.pad_square_stack_i32([np.zeros((1, 1), np.int32)], 2)
    native.fc_bond_masks([1], 2)
    native.parse_pdb_atoms_native(PDB_BLOCK)
    native.perceive_bonds_native(np.zeros((2, 3)), np.ones(2))
    assert {k: native.calls[k] - before[k] for k in native.ROUTINES} == \
        dict.fromkeys(native.ROUTINES, 1)


# --------------------------------------------------------------------------
# the PDB parser
# --------------------------------------------------------------------------

def _edit_lines(block, fn):
    return '\n'.join(fn(line) if line.startswith('ATOM') else line
                     for line in block.split('\n'))


PDB_TEXTS = {
    'block': PDB_BLOCK,
    'crlf': PDB_BLOCK.replace('\n', '\r\n'),
    'endmdl': PDB_BLOCK + 'ENDMDL\n' + PDB_BLOCK,
    'hetatm': PDB_BLOCK + PDB_BLOCK.replace('ATOM  ', 'HETATM'),
    'blank_element': _edit_lines(PDB_BLOCK, lambda l: l[:76] + '  '),
    'short_lines': _edit_lines(PDB_BLOCK, lambda l: l[:60]),
    'no_final_newline': PDB_BLOCK.rstrip('\n'),
    'empty': '',
}
# lines a Python fixed-column parse cannot read: the C parser skips ATOM
# records under 54 columns and reads what the others hold
C_ONLY_TEXTS = {
    'cut_records': PDB_BLOCK + 'ATOM      9  N\nATOM\nATOMS  1\n',
    'bad_numbers': _edit_lines(PDB_BLOCK, lambda l: l[:6] + ' 1x2 ' + l[11:]),
}


@pytest.mark.parametrize('case', sorted(PDB_TEXTS) + sorted(C_ONLY_TEXTS))
def test_pdb_parser_matches_plain_and_jax_c(case, jax_c_library):
    text = {**PDB_TEXTS, **C_ONLY_TEXTS}[case]
    got = native.parse_pdb_atoms_native(text)
    assert_same(got, native.plain.parse_pdb_atoms_native(text))
    assert_same(got, jax_native.parse_pdb_atoms_native(text))


def _protein_fields(p):
    return {'atom': p.to_dict_atom(), 'residue': p.to_dict_residue(),
            'title': p.title, 'residues': p.residues,
            'atom_to_aa_type': p.atom_to_aa_type,
            'xyz': _float32_xyz(p.atoms),
            'lines': [a['line'] for a in p.atoms]}


@pytest.mark.parametrize('case', [c for c in sorted(PDB_TEXTS)
                                  if c != 'empty'])
def test_pdb_protein_matches_jax(case, jax_native_lib):
    text = PDB_TEXTS[case]
    assert_same(_protein_fields(protein.PDBProtein(text, mode='block')),
                _protein_fields(jax_protein.PDBProtein(text, mode='block')))


def _big_block(n):
    """n ATOM records of 4-atom residues; serials and residue numbers wrap
    at their column widths, the chain advances at each residue wrap."""
    names = ('N', 'CA', 'C', 'O')
    rng = np.random.default_rng(5)
    xyz = rng.uniform(-99, 99, size=(n, 3))
    lines = ['HEADER    LARGE ASSEMBLY']
    for i in range(n):
        res = i // 4
        x, y, z = xyz[i]
        lines.append(
            f'ATOM  {(i + 1) % 100000:5d} {names[i % 4]:<4s} '
            f'{("ALA", "GLY", "SER")[res % 3]} '
            f'{"ABCDEFGHIJ"[res // 10000 % 10]}{res % 10000:4d}    '
            f'{x:8.3f}{y:8.3f}{z:8.3f}  1.00  0.00          '
            f'{names[i % 4][0]:>2s}')
    return '\n'.join(lines) + '\nEND\n'


def _columns(records):
    """A list of dicts as one array (or repr, which shows Python types) per
    key, over the records that hold it; each record's keys in order."""
    keys = [tuple(r) for r in records]
    out = {'keys': repr(keys)}
    if len(set(keys)) == 1:              # one layout: transpose at C speed
        columns = dict(zip(keys[0], zip(*(r.values() for r in records))))
    else:
        columns = {k: [r[k] for r in records if k in r]
                   for k in set().union(*keys)}
    for k, values in columns.items():
        out[k] = (np.stack(values) if isinstance(values[0], np.ndarray)
                  else np.array(values, np.float32) if k in 'xyz'
                  else repr(values))
    return out


def test_pdb_protein_beyond_100000_atoms_matches_jax():
    """Beyond the JAX wrapper's 100,000-atom buffer the JAX package parses
    in Python; the port's buffers follow the block's line count. Every
    field compared, column by column (the coordinates as float32)."""
    block = _big_block(100005)
    got = protein.PDBProtein(block, mode='block')
    want = jax_protein.PDBProtein(block, mode='block')
    assert len(got.atoms) == 100005
    for p in (got, want):
        p.fields = {'atom': p.to_dict_atom(), 'residue': p.to_dict_residue(),
                    'title': p.title,
                    'atom_to_aa_type': repr(p.atom_to_aa_type),
                    'atoms': _columns(p.atoms),
                    'residues': _columns(p.residues)}
    assert_same(got.fields, want.fields)


def test_non_ascii_block_takes_the_python_parser():
    text = PDB_BLOCK.replace('HEADER    TEST PROTEIN',
                             'HEADER    TEST PROTÉIN')
    with pytest.raises(ValueError, match='not ASCII'):
        native.parse_pdb_atoms_native(text)
    before = dict(native.plain_calls), native.calls['parse_pdb_atoms']
    got = protein.PDBProtein(text, mode='block')
    assert native.plain_calls['parse_pdb_atoms'] == \
        before[0]['parse_pdb_atoms'] + 1
    assert native.calls['parse_pdb_atoms'] == before[1]
    assert_same(_protein_fields(got),
                _protein_fields(jax_protein.PDBProtein(text, mode='block')))


# --------------------------------------------------------------------------
# bond candidates and connect_the_dots
# --------------------------------------------------------------------------

def _collapsed(gap=1.975999988):
    """39 coincident carbons, whose 741 candidates overflow the 16 n + 16
    = 672 buffer, and one C-C pair `gap` apart: between the float32-radii
    squared rule's cutoff (1.9759999752) and the float64 rule's (1.976)."""
    pos = np.zeros((41, 3))
    pos[1:40] = 50.0
    pos[40, 0] = gap
    return pos, np.full(41, 6)


def _bond_cases():
    rng = np.random.default_rng(1)
    cases = {}
    for n, min_d in ((12, 0.4), (30, 0.0), (1, 0.0), (0, 0.4)):
        pos = (rng.normal(size=(n, 3)) * 1.2).astype(np.float32)
        radii = rng.choice([0.31, 0.76, 0.71, 0.66], size=n).astype(
            np.float32)
        cases[f'n{n}_min{min_d}'] = (pos, radii, min_d)
    pos = np.repeat(rng.normal(size=(4, 3)), 2, axis=0)   # coincident pairs
    radii = np.full(8, 0.76, np.float32)
    cases['coincident_min0'] = (pos, radii, 0.0)
    cases['coincident_min0.4'] = (pos, radii, 0.4)
    pos, z = _collapsed()
    cases['overflow'] = (pos, np.full(41, 0.76, np.float32), 0.0)
    return cases


BOND_CASES = _bond_cases()


@pytest.mark.parametrize('case', sorted(BOND_CASES))
def test_bond_candidates_match_plain_and_jax_c(case, jax_c_library):
    pos, radii, min_d = BOND_CASES[case]
    got = native.perceive_bonds_native(pos, radii, 1.3, min_d)
    assert (got is None) == (case == 'overflow')
    assert_same(got, native.plain.perceive_bonds_native(pos, radii, 1.3,
                                                        min_d))
    assert_same(got, jax_native.perceive_bonds_native(pos, radii, 1.3,
                                                      min_d))


@pytest.mark.parametrize('case', ['overflow', 'fits'])
def test_connect_the_dots_matches_jax_on_both_sides_of_the_buffer(
        case, jax_c_library):
    """While the candidates fit 16 n + 16 both packages take the C rule;
    beyond it both take the JAX package's Python rule (float64 norms,
    unrounded radii), which keeps the pair (0, 40) that the C rule drops."""
    if case == 'overflow':
        pos, element = _collapsed()
    else:
        rng = np.random.default_rng(2)
        pos = rng.normal(size=(14, 3)) * 1.5
        element = rng.choice([6, 7, 8, 16], size=14)
    before = native.plain_calls['perceive_bonds']
    got = ligan.connect_the_dots(pos, element)
    assert got == jax_ligan.connect_the_dots(pos, element)
    assert got
    assert native.plain_calls['perceive_bonds'] - before == (
        case == 'overflow')
    if case == 'overflow':
        assert (0, 40) in got
