"""The plain versions of native.py's routines: numpy bodies that return
what the C library (csrc/ddnative.cpp) returns, bit for bit, so the tests
can hold the library against them. Nothing on the port's paths calls
these; native.py exposes them as `native.plain`.
"""

from __future__ import annotations

import re

import numpy as np

_INT_PREFIX = re.compile(r'\s*[+-]?\d+')


def _check_counts(counts, n_pad: int, fn: str):
    """An oversize count would be a silent truncation: fail loudly, as the
    JAX package's wrappers do."""
    if len(counts) and int(np.max(counts)) > n_pad:
        raise ValueError(
            f'{fn}: max count {int(np.max(counts))} exceeds n_pad {n_pad}')


def _pad_stack(arrays, n_pad: int, dtype, fn: str) -> np.ndarray:
    B = len(arrays)
    F = arrays[0].shape[-1] if arrays[0].ndim > 1 else 1
    _check_counts([len(a) for a in arrays], n_pad, fn)
    out = np.zeros((B, n_pad, F), dtype)
    for b, a in enumerate(arrays):
        out[b, :len(a)] = a.reshape(len(a), F)
    return out


def pad_stack_f32(arrays, n_pad: int) -> np.ndarray:
    """[(n_i, F)] float32 -> [B, n_pad, F] (a 1-D input gives F = 1)."""
    return _pad_stack(arrays, n_pad, np.float32, 'pad_stack_f32')


def pad_stack_i32(arrays, n_pad: int) -> np.ndarray:
    return _pad_stack(arrays, n_pad, np.int32, 'pad_stack_i32')


def length_masks(counts, n_pad: int) -> np.ndarray:
    """[B] counts -> [B, n_pad] bool, True on the first counts[b] rows."""
    counts = np.asarray(counts, np.int64)
    _check_counts(counts, n_pad, 'length_masks')
    return np.arange(n_pad)[None, :] < counts[:, None]


def pad_square_stack_i32(mats, n_pad: int) -> np.ndarray:
    counts = [m.shape[0] for m in mats]
    _check_counts(counts, n_pad, 'pad_square_stack_i32')
    out = np.zeros((len(mats), n_pad, n_pad), np.int32)
    for b, m in enumerate(mats):
        out[b, :len(m), :len(m)] = m
    return out


def fc_bond_masks(counts, n_pad: int) -> np.ndarray:
    """[B] counts -> [B, n_pad, n_pad] bool: both atoms real, i != j."""
    counts = np.asarray(counts, np.int64)
    _check_counts(counts, n_pad, 'fc_bond_masks')
    m = length_masks(counts, n_pad)
    return m[:, :, None] & m[:, None, :] & ~np.eye(n_pad, dtype=bool)


def _atoi(field: str) -> int:
    """C atoi: the leading integer of the field, 0 when there is none."""
    m = _INT_PREFIX.match(field)
    return int(m.group()) if m else 0


def _strtof(field: str) -> float:
    """C strtof on a fixed-width field: 0 when it holds no number."""
    try:
        return float(np.float32(field.strip() or 0.0))
    except ValueError:
        return 0.0


def parse_pdb_atoms_native(text: str):
    """Fixed-column ATOM-record parse up to the first ENDMDL: the fields,
    and each ATOM line's offset and length in `text`."""
    serial, pos, res_id = [], [], []
    names, resnames, chains, inserts, elements, segments = \
        [], [], [], [], [], []
    line_off, line_len = [], []
    start = 0
    n_text = len(text)
    while start < n_text:
        nl = text.find('\n', start)
        stop = n_text if nl < 0 else nl
        line = text[start:stop]
        if line.endswith('\r'):          # CRLF, like splitlines()
            line = line[:-1]
        if (len(line) >= 6 and line.startswith('ATOM')
                and (line[4] == ' ' or line[5] == ' ')):
            if len(line) >= 54:
                serial.append(_atoi(line[6:11]))
                names.append(line[12:16].strip())
                resnames.append(line[17:20].strip())
                chains.append(line[21])
                res_id.append(_atoi(line[22:26]))
                inserts.append(line[26])
                pos.append([_strtof(line[30:38]), _strtof(line[38:46]),
                            _strtof(line[46:54])])
                el = (line[76:78] if len(line) >= 78 and line[76:78] != '  '
                      else ' ' + line[13])
                elements.append(el.strip().capitalize() or names[-1][:1])
                segments.append(line[72:76].strip() if len(line) >= 76
                                else '')
                line_off.append(start)
                line_len.append(len(line))
        elif len(line) >= 6 and line.startswith('ENDMDL'):
            break
        start = n_text if nl < 0 else nl + 1
    return {
        'serial': np.array(serial, np.int32),
        'pos': np.array(pos, np.float32).reshape(-1, 3),
        'res_id': np.array(res_id, np.int32), 'atom_name': names,
        'res_name': resnames, 'chain': chains, 'insert_id': inserts,
        'element': elements, 'segment': segments,
        'line_off': np.array(line_off, np.int64),
        'line_len': np.array(line_len, np.int32),
    }


def max_bonds(n_atoms: int) -> int:
    """The bond-candidate buffer of the JAX package's wrapper."""
    return 16 * n_atoms + 16


def perceive_bonds_native(pos: np.ndarray, radii: np.ndarray,
                          stretch: float = 1.3, min_d: float = 0.4):
    """Candidate bonds i < j, in row-major pair order, with
    min_d^2 <= |p_i - p_j|^2 < ((r_i + r_j) * stretch)^2, all in float64.
    Returns (src, dst) int32 arrays, or None when they outnumber the C
    library's buffer of 16 n + 16."""
    pos = np.asarray(pos, np.float64)
    radii = np.asarray(radii, np.float64)
    delta = pos[:, None, :] - pos[None, :, :]
    d2 = (delta[..., 0] * delta[..., 0] + delta[..., 1] * delta[..., 1]
          + delta[..., 2] * delta[..., 2])
    cut = (radii[:, None] + radii[None, :]) * stretch
    ok = (d2 < cut * cut) & (d2 >= min_d * min_d)
    src, dst = np.nonzero(np.triu(ok, 1))
    if len(src) > max_bonds(len(pos)):
        return None
    return src.astype(np.int32), dst.astype(np.int32)
