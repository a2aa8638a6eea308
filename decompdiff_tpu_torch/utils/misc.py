"""Log, seed and run-directory utilities (port of
decompdiff_tpu/utils/misc.py; role parity: ref utils/misc.py)."""

from __future__ import annotations

import logging
import os
import random
import shutil
import subprocess
import sys
import time
from typing import Optional

import numpy as np
import torch


class BlackHole:
    """Absorbs any call/attribute (ref utils/misc.py:17-23)."""

    def __setattr__(self, name, value):
        pass

    def __call__(self, *args, **kwargs):
        return self

    def __getattr__(self, name):
        return self


def get_logger(name: str, log_dir: Optional[str] = None) -> logging.Logger:
    logger = logging.getLogger(name)
    logger.setLevel(logging.DEBUG)
    logger.propagate = False
    if logger.handlers:
        return logger
    formatter = logging.Formatter(
        '[%(asctime)s::%(name)s::%(levelname)s] %(message)s')
    sh = logging.StreamHandler(sys.stdout)
    sh.setLevel(logging.DEBUG)
    sh.setFormatter(formatter)
    logger.addHandler(sh)
    if log_dir is not None:
        fh = logging.FileHandler(os.path.join(log_dir, 'log.txt'))
        fh.setLevel(logging.DEBUG)
        fh.setFormatter(formatter)
        logger.addHandler(fh)
    return logger


def seed_all(seed: int) -> None:
    """Seed Python's, numpy's and torch's global generators (the port's
    device draws take explicit torch.Generators)."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


def get_new_log_dir(root='./logs', prefix='', tag='') -> str:
    fn = time.strftime('%Y_%m_%d__%H_%M_%S', time.localtime())
    if prefix:
        fn = prefix + '_' + fn
    if tag:
        fn = fn + '_' + tag
    log_dir = os.path.join(root, fn)
    os.makedirs(log_dir, exist_ok=True)
    return log_dir


def count_parameters(module: torch.nn.Module) -> int:
    return sum(p.numel() for p in module.parameters())


def snapshot_source(log_dir: str) -> None:
    """Copy the decompdiff_tpu_torch package source into the run directory
    and record the git revision, so every run is reproducible from its own
    log dir (ref scripts/train_diffusion_decomp.py:86-87). `__pycache__` and
    `*.so` are left out, and the kernels' build directory (`build/` at the
    repository root, ops/_build.py) lies outside the copy. Best-effort: a
    read-only or full log target must not abort training."""
    try:
        import decompdiff_tpu_torch
        pkg_dir = os.path.dirname(
            os.path.abspath(decompdiff_tpu_torch.__file__))
        dst = os.path.join(log_dir, 'source', 'decompdiff_tpu_torch')
        shutil.copytree(
            pkg_dir, dst,
            ignore=shutil.ignore_patterns('__pycache__', '*.pyc', '*.so'),
            dirs_exist_ok=True)
        rev = subprocess.run(
            ['git', '-C', pkg_dir, 'rev-parse', 'HEAD'],
            capture_output=True, text=True, timeout=10)
        if rev.returncode == 0:
            with open(os.path.join(log_dir, 'source', 'GIT_REVISION'),
                      'w') as f:
                f.write(rev.stdout)
    except Exception:
        logging.getLogger('train_torch').warning(
            'source snapshot failed (continuing)', exc_info=True)


# error taxonomy for the preprocessing fail buckets (ref utils/misc.py:88-105)
class AlphaSpaceError(Exception):
    pass


class SDFParsingError(Exception):
    pass


class ExtractPocketError(Exception):
    pass
