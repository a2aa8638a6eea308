"""Host padding, PDB parsing and bond-candidate routines, in C.

csrc/ddnative.cpp (a copy of the JAX package's native library) is built
with g++ at first use by ops/_build.py into build/ddnative-<hash>.so and
called through ctypes; the entry points and their results are those of
decompdiff_tpu/native/__init__.py with its library built. A missing g++ or
a failed build raises with the compiler's output: there is no fallback.
The numpy plain versions, bit-equal to the library, are `native.plain`
(native_plain.py), for the tests.

`calls` counts each C routine's calls; `plain_calls` counts the inputs
that the JAX package's rules send to its Python code instead: a non-ASCII
PDB block (data/protein.py; the C offsets are bytes) and bond candidates
that overflow their 16 n + 16 buffer (reconstruct/ligan.py).
"""

from __future__ import annotations

import ctypes

import numpy as np

from decompdiff_tpu_torch import native_plain as plain  # noqa: F401
from decompdiff_tpu_torch.native_plain import _check_counts, max_bonds
from decompdiff_tpu_torch.ops import _build

ROUTINES = ('pad_f32', 'pad_i32', 'length_mask', 'pad_square_i32',
            'bond_mask', 'parse_pdb_atoms', 'perceive_bonds')
calls = dict.fromkeys(ROUTINES, 0)
plain_calls = {'parse_pdb_atoms': 0, 'perceive_bonds': 0}

_i64p = ctypes.POINTER(ctypes.c_int64)
_i32p = ctypes.POINTER(ctypes.c_int32)
_f32p = ctypes.POINTER(ctypes.c_float)
_f64p = ctypes.POINTER(ctypes.c_double)
_u8p = ctypes.POINTER(ctypes.c_uint8)
_i64 = ctypes.c_int64
_SIGNATURES = {
    'pad_f32': (None, [_f32p, _i64p, _i64, _i64, _i64, _f32p]),
    'pad_i32': (None, [_i32p, _i64p, _i64, _i64, _i64, _i32p]),
    'length_mask': (None, [_i64p, _i64, _i64, _u8p]),
    'pad_square_i32': (None, [_i32p, _i64p, _i64, _i64, _i32p]),
    'bond_mask': (None, [_i64p, _i64, _i64, _u8p]),
    'parse_pdb_atoms': (_i64, [ctypes.c_char_p, _i64, _i64, _i32p, _f32p,
                               _i32p] + [ctypes.c_char_p] * 6
                        + [_i64p, _i32p]),
    'perceive_bonds': (_i64, [_f64p, _f64p, _i64, ctypes.c_double,
                              ctypes.c_double, _i64, _i32p, _i32p]),
}
_FNS = {}


def routine(name: str):
    """The C function `name` of csrc/ddnative.cpp, typed, building the
    library first if it has none; counts the call."""
    fn = _FNS.get(name)
    if fn is None:
        fn = getattr(_build.library('ddnative'), name)
        fn.restype, fn.argtypes = _SIGNATURES[name]
        _FNS[name] = fn
    calls[name] += 1
    return fn


def _ptr(a, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def _pad_stack(arrays, n_pad: int, dtype, ctype, name: str, fn: str):
    B = len(arrays)
    F = arrays[0].shape[-1] if arrays[0].ndim > 1 else 1
    counts = np.array([len(a) for a in arrays], np.int64)
    _check_counts(counts, n_pad, fn)
    out = np.zeros((B, n_pad, F), dtype)
    src = np.ascontiguousarray(
        np.concatenate([a.reshape(-1, F) for a in arrays], 0), dtype)
    routine(name)(_ptr(src, ctype), _ptr(counts, ctypes.c_int64), B, n_pad,
                  F, _ptr(out, ctype))
    return out


def pad_stack_f32(arrays, n_pad: int) -> np.ndarray:
    """[(n_i, F)] float32 -> [B, n_pad, F] (a 1-D input gives F = 1)."""
    return _pad_stack(arrays, n_pad, np.float32, ctypes.c_float, 'pad_f32',
                      'pad_stack_f32')


def pad_stack_i32(arrays, n_pad: int) -> np.ndarray:
    return _pad_stack(arrays, n_pad, np.int32, ctypes.c_int32, 'pad_i32',
                      'pad_stack_i32')


def _masks(counts, n_pad: int, shape, name: str, fn: str) -> np.ndarray:
    counts = np.ascontiguousarray(counts, np.int64)
    _check_counts(counts, n_pad, fn)
    out = np.zeros((len(counts),) + shape, np.uint8)
    routine(name)(_ptr(counts, ctypes.c_int64), len(counts), n_pad,
                  _ptr(out, ctypes.c_uint8))
    return out.astype(bool)


def length_masks(counts, n_pad: int) -> np.ndarray:
    """[B] counts -> [B, n_pad] bool, True on the first counts[b] rows."""
    return _masks(counts, n_pad, (n_pad,), 'length_mask', 'length_masks')


def fc_bond_masks(counts, n_pad: int) -> np.ndarray:
    """[B] counts -> [B, n_pad, n_pad] bool: both atoms real, i != j."""
    return _masks(counts, n_pad, (n_pad, n_pad), 'bond_mask',
                  'fc_bond_masks')


def pad_square_stack_i32(mats, n_pad: int) -> np.ndarray:
    B = len(mats)
    counts = np.array([m.shape[0] for m in mats], np.int64)
    _check_counts(counts, n_pad, 'pad_square_stack_i32')
    out = np.zeros((B, n_pad, n_pad), np.int32)
    src = np.ascontiguousarray(np.concatenate(
        [np.asarray(m, np.int32).reshape(-1) for m in mats]))
    routine('pad_square_i32')(_ptr(src, ctypes.c_int32),
                              _ptr(counts, ctypes.c_int64), B, n_pad,
                              _ptr(out, ctypes.c_int32))
    return out


def parse_pdb_atoms_native(text: str):
    """Fixed-column ATOM-record parse up to the first ENDMDL: the fields,
    and each ATOM line's offset and length in `text`. The buffers hold one
    atom per line of the text, so no block overflows them. ASCII only (the
    offsets are bytes; data/protein.py sends other blocks to its Python
    parser, as the JAX package does)."""
    if not text.isascii():
        raise ValueError('parse_pdb_atoms_native: the block is not ASCII')
    raw = text.encode()
    cap = raw.count(b'\n') + 1
    serial = np.zeros(cap, np.int32)
    pos = np.zeros((cap, 3), np.float32)
    res_id = np.zeros(cap, np.int32)
    atom_name = ctypes.create_string_buffer(cap * 4)
    res_name = ctypes.create_string_buffer(cap * 3)
    chain = ctypes.create_string_buffer(cap)
    insert_id = ctypes.create_string_buffer(cap)
    element = ctypes.create_string_buffer(cap * 2)
    segment = ctypes.create_string_buffer(cap * 4)
    line_off = np.zeros(cap, np.int64)
    line_len = np.zeros(cap, np.int32)
    n = int(routine('parse_pdb_atoms')(
        raw, len(raw), cap, _ptr(serial, ctypes.c_int32),
        _ptr(pos, ctypes.c_float), _ptr(res_id, ctypes.c_int32), atom_name,
        res_name, chain, insert_id, element, segment,
        _ptr(line_off, ctypes.c_int64), _ptr(line_len, ctypes.c_int32)))
    # each .raw is a copy of its whole buffer: take it once
    atom_name, res_name, chain, insert_id, element, segment = (
        b.raw.decode() for b in (atom_name, res_name, chain, insert_id,
                                 element, segment))
    names = [atom_name[i * 4:(i + 1) * 4].strip() for i in range(n)]
    elements = [element[i * 2:(i + 1) * 2].strip().capitalize()
                or names[i][:1] for i in range(n)]
    return {
        'serial': serial[:n].copy(), 'pos': pos[:n].copy(),
        'res_id': res_id[:n].copy(), 'atom_name': names,
        'res_name': [res_name[i * 3:(i + 1) * 3].strip() for i in range(n)],
        'chain': list(chain[:n]), 'insert_id': list(insert_id[:n]),
        'element': elements,
        'segment': [segment[i * 4:(i + 1) * 4].strip() for i in range(n)],
        'line_off': line_off[:n].copy(), 'line_len': line_len[:n].copy(),
    }


def perceive_bonds_native(pos: np.ndarray, radii: np.ndarray,
                          stretch: float = 1.3, min_d: float = 0.4):
    """Candidate bonds i < j, in row-major pair order, with
    min_d^2 <= |p_i - p_j|^2 < ((r_i + r_j) * stretch)^2, all in float64.
    Returns (src, dst) int32 arrays, or None when they outnumber the
    JAX package's buffer of 16 n + 16 (its wrapper returns None there too,
    and reconstruct/ligan.py then takes its Python rule)."""
    pos = np.ascontiguousarray(pos, np.float64)
    radii = np.ascontiguousarray(radii, np.float64)
    n = len(pos)
    cap = max_bonds(n)
    src = np.zeros(cap, np.int32)
    dst = np.zeros(cap, np.int32)
    m = routine('perceive_bonds')(_ptr(pos, ctypes.c_double),
                                  _ptr(radii, ctypes.c_double), n, stretch,
                                  min_d, cap, _ptr(src, ctypes.c_int32),
                                  _ptr(dst, ctypes.c_int32))
    if m < 0:
        return None
    return src[:int(m)].copy(), dst[:int(m)].copy()
