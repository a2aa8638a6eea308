"""Build the CUDA kernels under csrc/ with nvcc and load them with ctypes.

Each `csrc/<name>.cu` has a plain C interface and compiles on its own into
`build/<name>-<hash>.so` at the repository root; the hash covers the source,
every header in csrc/ and the flags, so an edit rebuilds and an unchanged
tree reuses the library. Nothing is built when a module is imported: the
first launch (or an explicit `build()`) compiles.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent.parent / 'csrc'
BUILD_DIR = Path(__file__).resolve().parents[2] / 'build'
KERNELS = ('edge_attention', 'bond_attention', 'triplet_attention')
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
              '-shared', '-Xcompiler', '-fPIC', '-Xptxas=-v')

_LIBS: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    found = shutil.which('nvcc')
    if found:
        return found
    cuda_home = os.environ.get('CUDA_HOME', '/usr/local/cuda')
    path = os.path.join(cuda_home, 'bin', 'nvcc')
    if not os.path.exists(path):
        raise RuntimeError('nvcc not found (looked on PATH and in '
                           f'{cuda_home}/bin); the CUDA kernels cannot build')
    return path


def library_path(name: str) -> Path:
    h = hashlib.sha256(' '.join(NVCC_FLAGS).encode())
    for src in [CSRC / f'{name}.cu'] + sorted(CSRC.glob('*.cuh')):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f'{name}-{h.hexdigest()[:16]}.so'


def build(names: Iterable[str] = KERNELS) -> Dict[str, str]:
    """Compile every named kernel that has no current library, one nvcc per
    source, all started together. Returns each compiler's output ('' for a
    library that was already built); raises if any compile fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f'.{os.getpid()}.tmp')
        cmd = [nvcc_path(), *NVCC_FLAGS, '-o', str(tmp), str(CSRC / f'{name}.cu')]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    logs = {name: '' for name in names}
    failed = []
    for name, (proc, tmp, out) in procs.items():
        logs[name], _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(name)
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError('nvcc failed for ' + ', '.join(failed) + ':\n' +
                           '\n'.join(logs[n] for n in failed))
    return logs


def load(name: str, symbol: str, n_ptrs: int, n_ints: int,
         stream: bool = True):
    """The C function `symbol` of csrc/<name>.cu, typed as n_ptrs pointers,
    n_ints ints and (a launcher) a trailing stream pointer, returning a
    cudaError_t."""
    lib = _LIBS.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build([name])
        lib = _LIBS[name] = ctypes.CDLL(str(path))
    fn = getattr(lib, symbol)
    fn.argtypes = ([ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints
                   + [ctypes.c_void_p] * stream)
    fn.restype = ctypes.c_int
    return fn
