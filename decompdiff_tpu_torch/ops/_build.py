"""Build the libraries under csrc/ and load them with ctypes.

Each `csrc/<name>.cu` (a CUDA kernel) has a plain C interface and compiles
with nvcc on its own into `build/<name>-<hash>.so` at the repository root;
the hash covers the source, every header in csrc/ and the flags, so an edit
rebuilds and an unchanged tree reuses the library. `csrc/ddnative.cpp`, the
host library of native.py, compiles the same way with g++ (its hash: the
source and the g++ flags), so a machine without nvcc builds it too; nothing
on the CPU path calls nvcc. Nothing is built when a module is imported: the
first call (or an explicit `build()`) compiles. Each compiler writes a
pid-suffixed file that replaces the library in one `os.replace`, so
processes that race to build one leave a whole library.
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
KERNELS = ('edge_attention', 'bond_attention', 'triplet_attention',
           'multi_tensor_adam')
HOST_LIBRARIES = ('ddnative',)
SOURCES = KERNELS + HOST_LIBRARIES
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
              '-shared', '-Xcompiler', '-fPIC', '-Xptxas=-v')
# no -march=native: one library serves any host that shares the build/
GXX_FLAGS = ('-O3', '-shared', '-fPIC', '-std=c++17')

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


def gxx_path() -> str:
    found = shutil.which('g++')
    if not found:
        raise RuntimeError('g++ not found on PATH; the host library '
                           'csrc/ddnative.cpp cannot build')
    return found


def _sources(name: str):
    if name in HOST_LIBRARIES:
        return [CSRC / f'{name}.cpp']
    return [CSRC / f'{name}.cu'] + sorted(CSRC.glob('*.cuh'))


def library_path(name: str) -> Path:
    flags = GXX_FLAGS if name in HOST_LIBRARIES else NVCC_FLAGS
    h = hashlib.sha256(' '.join(flags).encode())
    for src in _sources(name):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f'{name}-{h.hexdigest()[:16]}.so'


def _command(name: str, tmp: Path):
    compiler, flags = ((gxx_path(), GXX_FLAGS) if name in HOST_LIBRARIES
                       else (nvcc_path(), NVCC_FLAGS))
    return [compiler, *flags, '-o', str(tmp), str(_sources(name)[0])]


def build(names: Iterable[str] = SOURCES) -> Dict[str, str]:
    """Compile every named library that has no current build, one compiler
    per source (nvcc for a kernel, g++ for a host library), all started
    together. Returns each compiler's output ('' for a library that was
    already built); raises with the output if any compile fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f'.{os.getpid()}.tmp')
        procs[name] = (subprocess.Popen(_command(name, tmp),
                                        stdout=subprocess.PIPE,
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
        raise RuntimeError('the build failed for ' + ', '.join(failed) +
                           ':\n' + '\n'.join(logs[n] for n in failed))
    return logs


def library(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>, built first if it has none."""
    lib = _LIBS.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build([name])
        lib = _LIBS[name] = ctypes.CDLL(str(path))
    return lib


def load(name: str, symbol: str, n_ptrs: int, n_ints: int,
         stream: bool = True):
    """The C function `symbol` of csrc/<name>.cu, typed as n_ptrs pointers,
    n_ints ints and (a launcher) a trailing stream pointer, returning a
    cudaError_t."""
    fn = getattr(library(name), symbol)
    fn.argtypes = ([ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints
                   + [ctypes.c_void_p] * stream)
    fn.restype = ctypes.c_int
    return fn


def build_once(mesh) -> None:
    """Build the kernels and the host library once for the ranks of a
    data-parallel mesh (parallel/mesh.py) on one host: local rank 0
    compiles every source that has no current library while the others
    wait at a barrier; then each rank loads the libraries at its first
    call. A world of one builds at its first call, as ever."""
    if not mesh.distributed or mesh.device.type != 'cuda':
        return
    from decompdiff_tpu_torch.parallel.mesh import barrier
    if mesh.local_rank == 0:
        build()
    barrier(mesh)
