"""CrossDocked2020 cleaning (L0 stage 0) with the PyTorch port
(decompdiff_tpu_torch): scripts/clean_crossdocked.py's arguments and
output files.

Role parity with ref scripts/data_preparation/clean_crossdocked.py: filter a
CrossDocked types file to poses with RMSD <= threshold, extract the selected
pose from each multi-pose .sdf.gz into its own .sdf, and write index.pkl of
{protein, ligand} pairs. Uses the self-contained SDF parser (no RDKit).

Usage:
    python scripts/clean_crossdocked_torch.py TYPES_FILE --source DIR --dest DIR
        [--rmsd_thr 1.0]
"""

import argparse
import os
import pickle
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from decompdiff_tpu_torch.data.mol import (  # noqa: E402
    mol_to_sdf_block, parse_sdf_file)


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument('types_file')
    parser.add_argument('--source', required=True,
                        help='CrossDocked root with .sdf.gz / receptor pdbs')
    parser.add_argument('--dest', required=True)
    parser.add_argument('--rmsd_thr', type=float, default=1.0)
    args = parser.parse_args()

    os.makedirs(args.dest, exist_ok=True)
    index = []
    n_skipped = 0
    with open(args.types_file) as f:
        for line in f:
            fields = line.strip().split()
            if len(fields) < 5:
                continue
            # types format: label affinity rmsd receptor ligand_pose
            try:
                rmsd = float(fields[2])
            except ValueError:
                continue
            if rmsd > args.rmsd_thr:
                continue
            receptor_fn = fields[3]
            pose_fn = fields[4]  # e.g. path/lig_tt_docked_3.sdf.gz
            base, pose_idx = pose_fn.rsplit('_', 1)
            pose_idx = int(pose_idx.split('.')[0])
            gz_path = os.path.join(args.source, base + '.sdf.gz')
            if not os.path.exists(gz_path):
                n_skipped += 1
                continue
            try:
                mols = parse_sdf_file(gz_path, first_only=False)
                mol = mols[pose_idx]
            except Exception:
                n_skipped += 1
                continue
            out_rel = base + f'_{pose_idx}.sdf'
            out_path = os.path.join(args.dest, out_rel)
            os.makedirs(os.path.dirname(out_path), exist_ok=True)
            with open(out_path, 'w') as g:
                g.write(mol_to_sdf_block(mol))
            # receptor name convention: strip gninatypes suffix -> .pdb
            protein_rel = receptor_fn.replace('.gninatypes', '.pdb')
            index.append({'protein': protein_rel, 'ligand': out_rel,
                          'rmsd': rmsd})

    with open(os.path.join(args.dest, 'index.pkl'), 'wb') as f:
        pickle.dump(index, f)
    print(f'kept {len(index)} poses (skipped {n_skipped}) -> {args.dest}')


if __name__ == '__main__':
    main()
