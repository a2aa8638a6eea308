"""decompdiff_tpu_torch — the PyTorch/CUDA port of ``decompdiff_tpu``.

The package mirrors the JAX package's module layout (``data.batch``,
``models.uni_transformer_bond``, ``sampling.sampler``, ...) so each module's
counterpart is easy to find; inside each module the code is plain PyTorch:
``nn.Module``s, explicit devices and explicit ``torch.Generator``s.

The three Pallas kernels of the sampling path (kNN edge attention, dense
bond attention, bond-triplet attention) are hand-written CUDA C++ kernels
for Hopper under ``csrc/``, built with ``nvcc`` at first use and bound with
``ctypes`` (``ops/_build.py``). Each kernel's wrapper runs its plain PyTorch
version for CPU tensors and launches the kernel for CUDA tensors.

Entry points run on CUDA unless the caller passes ``device='cpu'``; with no
device given and no GPU present they raise instead of falling back.

This package imports neither JAX nor anything of ``decompdiff_tpu``.
"""

__version__ = "0.1.0"
