"""Convert reference-format data into a DDStore with the PyTorch port
(decompdiff_tpu_torch): scripts/import_reference_data.py's arguments and
output files.

Two sources:
  * --lmdb: an already-processed reference LMDB (requires the lmdb package)
  * --index: an index.pkl + per-pair *_meta.pkl tree (the L0 output contract)

Also converts the reference's split_by_name.pt (torch) into the pickle format
scripts/train.py consumes (requires torch, present in this image).
"""

import argparse
import os
import pickle
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    parser = argparse.ArgumentParser()
    src = parser.add_mutually_exclusive_group(required=True)
    src.add_argument('--lmdb', help='reference processed .lmdb file')
    src.add_argument('--index', help='raw dir containing index.pkl')
    parser.add_argument('--out', required=True, help='output .ddstore path')
    parser.add_argument('--split_pt', default=None,
                        help='reference split_by_name.pt to convert')
    parser.add_argument('--limit', type=int, default=None)
    args = parser.parse_args()

    from decompdiff_tpu_torch.data.dataset import (
        build_store_from_index, import_reference_lmdb)

    if args.lmdb:
        store = import_reference_lmdb(args.lmdb, args.out, limit=args.limit)
    else:
        store = build_store_from_index(args.index, args.out, limit=args.limit)
    print(f'wrote {len(store)} records -> {args.out}')

    if args.split_pt:
        import torch
        split = torch.load(args.split_pt)
        out_split = os.path.splitext(args.out)[0] + '_split.pkl'
        with open(out_split, 'wb') as f:
            pickle.dump(split, f)
        print(f'converted split -> {out_split}')


if __name__ == '__main__':
    main()
