"""Sample molecules with the PyTorch port (decompdiff_tpu_torch).

Usage:
    python scripts/sample_torch.py configs/sampling.yml --ckpt CKPT \
        -i DATA_ID [DATA_ID ...] --outdir OUT [--use_pallas] [--device cpu]

Reads a checkpoint in the JAX package's .ckpt format and a pocket store,
samples on CUDA (unless --device names another device) and writes one
result_<id>.pkl per pocket in the layout of scripts/sample.py, which
scripts/evaluate.py scores. The arguments are scripts/sample.py's, plus
--device; see decompdiff_tpu_torch/sampling/driver.py.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from decompdiff_tpu_torch.sampling.driver import main  # noqa: E402

if __name__ == '__main__':
    main()
