"""Generate a synthetic DDStore for smoke tests / CI with the PyTorch port
(decompdiff_tpu_torch): scripts/make_synthetic_data.py's arguments, and the
same store for the same arguments.

Creates chemically-shaped random complexes (pocket point clouds + chain-bonded
ligands with arm/scaffold decompositions and golden priors; see
decompdiff_tpu_torch/data/synthetic.py) so the full train -> sample ->
evaluate loop runs without CrossDocked data.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from decompdiff_tpu_torch.data.synthetic import (  # noqa: E402
    write_synthetic_store)


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument('--out', default='./data/synthetic.ddstore')
    parser.add_argument('--n', type=int, default=64)
    parser.add_argument('--seed', type=int, default=0)
    parser.add_argument('--random-types', action='store_true',
                        help='legacy pure-noise atom types (atom AUROC '
                             'pins at 0.5 by construction)')
    args = parser.parse_args()
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    write_synthetic_store(args.out,
                          [{'random_types': args.random_types}] * args.n,
                          seed=args.seed)
    print(f'wrote {args.n} synthetic complexes to {args.out}')


if __name__ == '__main__':
    main()
