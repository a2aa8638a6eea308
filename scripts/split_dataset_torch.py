"""Dataset split builder with the PyTorch port (decompdiff_tpu_torch):
scripts/split_dataset.py's arguments and output file.

Role parity with ref scripts/data_preparation/split_pl_dataset.py: fixed split
by source filenames (a pickle of {'train': [names], 'test': [names]}) or a
random split with unique-pocket test selection.
"""

import argparse
import os
import pickle
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from decompdiff_tpu_torch.data.store import DDStore  # noqa: E402


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument('store')
    parser.add_argument('--out', default=None)
    parser.add_argument('--mode', choices=['random', 'by_names'],
                        default='random')
    parser.add_argument('--names', default=None,
                        help='pickle of {split: [names]} for by_names mode')
    parser.add_argument('--test_frac', type=float, default=0.1)
    parser.add_argument('--unique_pocket_test', action='store_true',
                        help='keep at most one test sample per protein file')
    parser.add_argument('--seed', type=int, default=2021)
    args = parser.parse_args()

    store = DDStore(args.store)
    out_path = args.out or (os.path.splitext(args.store)[0] + '_split.pkl')

    if args.mode == 'by_names':
        with open(args.names, 'rb') as f:
            split = pickle.load(f)
    else:
        rng = np.random.default_rng(args.seed)
        keys = list(store.keys)
        order = rng.permutation(len(keys))
        n_test = max(1, int(len(keys) * args.test_frac))
        test_ids = list(order[:n_test])
        if args.unique_pocket_test:
            seen, uniq = set(), []
            for i in test_ids:
                rec = store[int(i)]
                pocket = rec.get('src_protein_filename', str(i))
                if pocket not in seen:
                    seen.add(pocket)
                    uniq.append(i)
            test_ids = uniq
        test_set = set(int(i) for i in test_ids)
        split = {
            'train': [keys[int(i)] for i in order if int(i) not in test_set],
            'test': [keys[int(i)] for i in test_ids],
        }

    with open(out_path, 'wb') as f:
        pickle.dump(split, f)
    print(f'wrote split: train={len(split["train"])} test={len(split["test"])}'
          f' -> {out_path}')


if __name__ == '__main__':
    main()
