"""The checks a run makes before it prints a result: no JAX in the process
and a card to run on."""

from __future__ import annotations

import sys

# top-level module names that no run may hold: the JAX stack and the JAX
# package the port was made from
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'optax', 'decompdiff_tpu')


def forbidden_modules(modules=None) -> list:
    """The loaded modules whose top-level name (the part before the first
    dot, compared whole) is forbidden: `decompdiff_tpu.x` is,
    `decompdiff_tpu_torch.x` is not."""
    names = sys.modules if modules is None else modules
    return sorted(n for n in names if n.split('.', 1)[0] in FORBIDDEN)


def require_no_jax(when: str) -> None:
    found = forbidden_modules()
    if found:
        print(f'perfbench: {when}, the process holds forbidden modules: '
              f'{", ".join(found)}', file=sys.stderr)
        raise SystemExit(3)


def require_cuda(chips: int) -> None:
    """Exit non-zero without a result unless `chips` CUDA devices are
    visible: a measurement never falls back to the CPU."""
    import torch
    if not torch.cuda.is_available():
        print('perfbench: no CUDA device is available; the benchmark runs '
              'on the card only', file=sys.stderr)
        raise SystemExit(2)
    if torch.cuda.device_count() < chips:
        print(f'perfbench: the cell needs {chips} CUDA devices, '
              f'{torch.cuda.device_count()} visible', file=sys.stderr)
        raise SystemExit(2)
