"""Sample molecules with the PyTorch port (decompdiff_tpu_torch).

Usage:
    python scripts/sample_torch.py configs/sampling.yml --ckpt CKPT \
        -i DATA_ID [DATA_ID ...] --outdir OUT [--use_pallas] [--device cpu]
    torchrun --standalone --nproc_per_node W scripts/sample_torch.py \
        configs/sampling.yml --ckpt CKPT [...]   # data parallel

Reads a checkpoint in the JAX package's .ckpt format and a pocket store,
samples on CUDA (unless --device names another device) and writes one
result_<id>.pkl per pocket in the layout of scripts/sample.py, which
scripts/evaluate.py scores. The arguments are scripts/sample.py's, plus
--device and --summary; under torchrun each rank samples its rows of
every batch that divides over the ranks and rank 0 writes the pickles
(see decompdiff_tpu_torch/sampling/driver.py).
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from decompdiff_tpu_torch.sampling.driver import main  # noqa: E402

if __name__ == '__main__':
    main()
