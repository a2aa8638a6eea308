"""Offline decomposition driver (L0) with the PyTorch port
(decompdiff_tpu_torch): scripts/preprocess_subcomplex.py's arguments,
output files and error taxonomy.

Role parity with ref scripts/data_preparation/preprocess_subcomplex.py:
multiprocessing over (protein, ligand) pairs with per-item timeout and an
error taxonomy written to fail_index.pkl. Prefers RDKit (BRICS) and
AlphaSpace2/mdtraj (pocket detection) when installed; without them it runs
the first-party fallbacks (preprocess/alphaspace.py alpha-sphere pockets +
decompose.bond_cut_fragments) — see the PARITY.md divergence note.

Usage:
    python scripts/preprocess_subcomplex_torch.py INDEX_PKL --raw_root DIR
        --dest DIR [--num_workers N] [--timeout 60]
"""

import argparse
import multiprocessing as mp
import os
import pickle
import sys
from collections import Counter

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def process_item(item, raw_root, dest, submol_radius):
    from decompdiff_tpu_torch.preprocess.decompose import DecomposeError
    from decompdiff_tpu_torch.preprocess.subcomplex import extract_subcomplex
    protein_fn, ligand_fn = item['protein'], item['ligand']
    name = os.path.splitext(os.path.basename(ligand_fn))[0]
    try:
        meta = extract_subcomplex(
            os.path.join(raw_root, protein_fn),
            os.path.join(raw_root, ligand_fn),
            submol_radius=submol_radius,
            out_dir=os.path.join(dest, name), name=name)
        return ('ok', item, meta)
    except DecomposeError as e:
        return ('decompose_error', item, str(e))
    except FileNotFoundError as e:
        return ('missing_file', item, str(e))
    except Exception as e:
        return ('other_error', item, f'{type(e).__name__}: {e}')


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument('index', help='index input; see --index_format')
    parser.add_argument('--index_format',
                        choices=('pickle', 'pdbbind', 'crossdocked_split'),
                        default='pickle',
                        help="pickle: list of {protein, ligand} (or the "
                             "reference's src_*_filename keys); pdbbind: "
                             "INDEX points at the PDBBind root (ref "
                             "preprocess_subcomplex.py:22-53); "
                             "crossdocked_split: split_by_name.pt "
                             "(ref :56-67)")
    parser.add_argument('--pdbbind_subset', default='refined',
                        choices=('refined', 'general'))
    parser.add_argument('--raw_root', required=True)
    parser.add_argument('--dest', required=True)
    parser.add_argument('--num_workers', type=int, default=16)
    parser.add_argument('--timeout', type=float, default=60.0)
    parser.add_argument('--submol_radius', type=float, default=10.0)
    args = parser.parse_args()

    missing = []
    try:
        import rdkit  # noqa: F401
    except Exception:
        missing.append('rdkit (BRICS decomposition)')
    try:
        import alphaspace2  # noqa: F401
        import mdtraj  # noqa: F401
    except Exception:
        missing.append('alphaspace2 + mdtraj (pocket detection)')
    if missing:
        print('NOTE: optional packages missing, using first-party fallbacks:')
        for m in missing:
            print(' -', m)

    if args.index_format == 'pdbbind':
        from decompdiff_tpu_torch.preprocess.subcomplex import (
            parse_pdbbind_index_file)
        index = parse_pdbbind_index_file(args.index,
                                         subset=args.pdbbind_subset)
    elif args.index_format == 'crossdocked_split':
        from decompdiff_tpu_torch.preprocess.subcomplex import (
            parse_crossdocked_index_file)
        index = parse_crossdocked_index_file(args.index)
    else:
        with open(args.index, 'rb') as f:
            index = pickle.load(f)
    # normalize the reference's key names to the worker contract
    index = [{'protein': it.get('protein', it.get('src_protein_filename')),
              'ligand': it.get('ligand', it.get('src_ligand_filename')),
              **{k: v for k, v in it.items()
                 if k not in ('protein', 'ligand', 'src_protein_filename',
                              'src_ligand_filename')}}
             for it in index]
    os.makedirs(args.dest, exist_ok=True)

    pool = mp.Pool(args.num_workers)
    jobs = [pool.apply_async(process_item,
                             (item, args.raw_root, args.dest,
                              args.submol_radius))
            for item in index]
    results, fails = [], []
    buckets = Counter()
    for i, job in enumerate(jobs):
        try:
            status, item, payload = job.get(timeout=args.timeout)
        except mp.TimeoutError:
            status, item, payload = 'timeout', index[i], ''
        buckets[status] += 1
        if status == 'ok':
            results.append({
                'src_protein_filename': item['protein'],
                'src_ligand_filename': item['ligand'],
                'data': payload,
            })
        else:
            fails.append({'item': item, 'status': status, 'err': payload})
    pool.terminate()

    with open(os.path.join(args.dest, 'index.pkl'), 'wb') as f:
        pickle.dump(results, f)
    with open(os.path.join(args.dest, 'fail_index.pkl'), 'wb') as f:
        pickle.dump(fails, f)
    print('done:', dict(buckets))


if __name__ == '__main__':
    main()
