"""Score the result pickles of a sampling run with the PyTorch port
(decompdiff_tpu_torch).

Usage:
    python scripts/evaluate_torch.py OUTDIR [--docking_mode {none,
        vina_score,vina_full,vina,qvina}] [--protein_root DIR]
        [--exhaustiveness N] [--ref_vina_pkl PKL]

Reads the result_*.pkl files that scripts/sample_torch.py (or
scripts/sample.py) wrote under OUTDIR and writes OUTDIR/eval_summary.pkl
with the keys of scripts/evaluate.py. The arguments are scripts/evaluate.py's;
see decompdiff_tpu_torch/evaluation/driver.py. Runs on the host: it needs
no GPU and no JAX.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from decompdiff_tpu_torch.evaluation.driver import main  # noqa: E402

if __name__ == '__main__':
    main()
