"""Convert a reference (PyTorch DecompDiff) checkpoint into the .ckpt format
that both the port and the JAX package sample from, without JAX.

Usage:
    python scripts/convert_checkpoint_torch.py REF.pt --out CONVERTED.ckpt

The port of scripts/convert_checkpoint.py, with the same output: a pickle of
{config (the reference config as builtin dicts and lists), params (the flax
tree of decompdiff_tpu_torch/utils/convert_checkpoint.py), opt_state None,
step, scheduler, iteration, extra}. scripts/sample_torch.py and
scripts/sample.py read it with --ckpt. The reference file is read through a
restricted unpickler that runs no pickled code (see load_reference_checkpoint).
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from decompdiff_tpu_torch.utils.checkpoint import write_checkpoint  # noqa: E402
from decompdiff_tpu_torch.utils.convert_checkpoint import (  # noqa: E402
    convert_reference_state_dict, plain_dict, read_reference_checkpoint)


def _count(tree) -> int:
    if isinstance(tree, dict):
        return sum(_count(v) for v in tree.values())
    return int(np.asarray(tree).size)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description='Convert a reference DecompDiff .pt checkpoint into a '
                    '.ckpt for scripts/sample_torch.py and scripts/sample.py.')
    parser.add_argument('ref_ckpt')
    parser.add_argument('--out', required=True)
    args = parser.parse_args(argv)

    ref = read_reference_checkpoint(args.ref_ckpt)
    config = plain_dict(ref['config'])
    sd = {k: v.numpy() for k, v in ref['model'].items()}
    params = convert_reference_state_dict(sd, config['model'])
    iteration = int(ref.get('iteration', 0))
    write_checkpoint(args.out, {
        'config': config,
        'params': params,
        'opt_state': None,
        'step': iteration,
        'scheduler': {},
        'iteration': iteration,
        'extra': {'converted_from': args.ref_ckpt},
    })
    n = _count(params)
    print(f'converted {n / 1e6:.2f}M params -> {args.out}')
    return n


if __name__ == '__main__':
    main()
