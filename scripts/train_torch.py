"""Train with the PyTorch port (decompdiff_tpu_torch).

Usage:
    python scripts/train_torch.py configs/training.yml [--outdir logs] \
        [--resume CKPT] [--max_iters N] [--val_freq N] [--device cpu]
    torchrun --standalone --nproc_per_node W scripts/train_torch.py \
        configs/training.yml [...]     # data parallel, one process a GPU

Reads a config and the pocket store it names, trains on CUDA (unless
--device names another device) and writes checkpoints in the JAX
package's .ckpt layout, which scripts/sample.py, scripts/sample_torch.py
and a resumed run of either trainer read. The arguments are
scripts/train.py's, plus --device and --summary; under torchrun each rank
takes its rows of every batch that divides over the ranks (see
decompdiff_tpu_torch/training/driver.py).
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from decompdiff_tpu_torch.training.driver import main  # noqa: E402

if __name__ == '__main__':
    main()
