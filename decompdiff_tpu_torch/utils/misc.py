"""Log and seed utilities (port of decompdiff_tpu/utils/misc.py; role
parity: ref utils/misc.py)."""

from __future__ import annotations

import logging
import os
import random
import sys
from typing import Optional

import numpy as np
import torch


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
