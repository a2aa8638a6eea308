"""Device selection shared by every entry point.

Every entry point takes an explicit device here (CUDA unless the caller
names the CPU), so the port has no counterpart of the JAX package's
utils/platform.py: that module only re-applies JAX_PLATFORMS through
jax.config for a TPU plugin that ignores the environment variable, and
PyTorch has no such plugin or variable to repair.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names one.

    With no device given and no GPU present this raises; it never falls
    back to the CPU quietly.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on "
                "the CPU explicitly")
        return torch.device('cuda')
    return torch.device(device)


def set_matmul_precision() -> None:
    """What the entry points set before they build a model: cuBLAS
    accumulates bf16 products in float32 in every reduction, as the TPU's
    MXU accumulates them (and the JAX package's products under
    compute_dtype: bfloat16). PyTorch allows bf16 partial sums by default
    (torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction)."""
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
