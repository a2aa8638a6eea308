"""The evaluation entry point (port of scripts/evaluate.py `main`; ref
scripts/evaluate_mol_from_meta_full.py).

    python scripts/evaluate_torch.py OUTDIR [--docking_mode {none,
        vina_score,vina_full,vina,qvina}] [--protein_root DIR]
        [--exhaustiveness N] [--ref_vina_pkl PKL]

Scores the result pickles of a sampling run: reconstruction and
completeness filters, chem properties (RDKit-gated, else the first-party
descriptors), docking per mode over --num_workers threads, Vina Score / Min
/ Dock mean and median, High Affinity, Success Rate (QED > 0.25, SA > 0.59,
Vina Dock < -8.18), bond / pair-distance / atom-type JSDs, ring sizes and
diversity; writes eval_summary.pkl with the JAX script's keys. Each
result_*.pkl is read through sampling/driver.py `load_result`, so the
molecules are the port's MolRecords and the JAX package is never needed.
The evaluation is host work: it launches nothing on a device.

Differences from the JAX script:
  * --tmp_dir defaults to the platform's temporary directory (TMPDIR)
    rather than /tmp.
  * The logger is named evaluate_torch.
  * An outdir without result pickles raises FileNotFoundError (an
    assertion there).
"""

from __future__ import annotations

import argparse
import glob
import os
import pickle
from collections import Counter
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from decompdiff_tpu_torch.constants import atomic_numbers_from_index
from decompdiff_tpu_torch.evaluation import protocol, scoring
from decompdiff_tpu_torch.evaluation.eval_atom_type import (
    eval_atom_type_distribution)
from decompdiff_tpu_torch.evaluation.eval_bond_length import (
    bond_distances_from_mol, eval_bond_length_profile,
    eval_pair_length_profile, get_bond_length_profile,
    get_pair_length_profile, pair_distances_from_pos)
from decompdiff_tpu_torch.evaluation.scoring import get_ring_sizes
from decompdiff_tpu_torch.sampling.driver import load_result
from decompdiff_tpu_torch.utils.misc import get_logger


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description='Score the result pickles of a sampling run with the '
                    'PyTorch port (see decompdiff_tpu_torch/evaluation/'
                    'driver.py).')
    parser.add_argument('outdir')
    parser.add_argument('--docking_mode', default='none',
                        choices=['none', 'vina_score', 'vina_full', 'vina',
                                 'qvina'])
    parser.add_argument('--protein_root', default=None,
                        help='root dir holding the original receptor PDBs; '
                             'combined with each result\'s ligand_filename '
                             '(ref docking_vina.py:154-162)')
    parser.add_argument('--exhaustiveness', type=int, default=32)
    parser.add_argument('--tmp_dir', default=None,
                        help='scratch and receptor-cache dir for '
                             'docking (default: the platform\'s '
                             'temporary directory)')
    parser.add_argument('--ref_vina_pkl', default=None,
                        help='pickle {ligand_filename: reference-ligand Vina '
                             'Dock affinity} enabling the High Affinity '
                             'metric')
    parser.add_argument('-n', '--eval_num_examples', type=int, default=None,
                        help='cap the number of samples evaluated (ref '
                             'evaluate_mol_from_meta_full.py:132)')
    parser.add_argument('--num_workers', type=int, default=4,
                        help='concurrent docking subprocesses (ref '
                             'evaluate_mol_from_meta_full.py:138); docking '
                             'is external-process bound, so threads suffice')
    parser.add_argument('--result_path', default=None,
                        help='where to write eval_summary.pkl (default: '
                             '<outdir>/eval_summary.pkl; ref '
                             'evaluate_mol_from_meta_full.py:139)')
    return parser


def main(argv=None) -> dict:
    """Score the result pickles under the outdir argument; returns the
    summary written to eval_summary.pkl."""
    args = build_parser().parse_args(argv)
    logger = get_logger('evaluate_torch', args.outdir)
    result_files = sorted(glob.glob(os.path.join(args.outdir, 'result_*.pkl')))
    if not result_files:
        raise FileNotFoundError(f'no result_*.pkl under {args.outdir}')

    ref_vina = {}
    if args.ref_vina_pkl:
        with open(args.ref_vina_pkl, 'rb') as f:
            ref_vina = pickle.load(f)

    n_total, n_recon, n_complete, n_dock_success = 0, 0, 0, 0
    all_bond_lengths, all_pair_lengths = [], []
    atom_counter = Counter()
    ring_sizes = Counter()
    per_mol_rings = []
    # aligned per reconstructed sample (for Success Rate / High Affinity)
    chem_list, dock_list, vina_rows, ha_flags = [], [], [], []
    mols_by_pocket = {}

    entries = []
    for rf in result_files:
        payload = load_result(rf)
        entries += [(payload.get('atom_mode', 'basic'), r)
                    for r in payload['results']]
    if args.eval_num_examples is not None:
        # ref evaluate_mol_from_meta_full.py:153 caps the evaluated set
        entries = entries[:args.eval_num_examples]

    # phase 1 — reconstruction/completeness filters + chem scoring (host,
    # cheap). Chem runs BEFORE docking so a sample whose scoring fails
    # contributes nothing (ref :76-108 single try -> continue). On an
    # RDKit-free host MolRecords score through the first-party descriptor
    # stack (evaluation/descriptors.py).
    candidates = []
    for atom_mode, r in entries:
        n_total += 1
        mol = r.get('mol')
        if mol is None:
            continue
        n_recon += 1
        # the reference protocol excludes disconnected molecules from
        # EVERY statistic ('.' in SMILES -> continue, ref
        # evaluate_mol_from_meta_full.py:73-74); 'complete' records the
        # same connectivity check at sampling time
        if not r.get('complete', False):
            continue
        n_complete += 1
        chem = None
        if scoring.can_score(mol):
            try:
                chem = scoring.get_chem(mol)
            except Exception as e:
                logger.info(f'chem scoring failed (sample skipped): {e}')
                continue
        candidates.append((atom_mode, r, mol, chem))

    # phase 2 — docking, fanned over --num_workers threads (each Vina/QVina
    # call is an external subprocess, so threads give real concurrency; ref
    # :138 uses a torch multiprocessing pool for the same reason). Ordered
    # executor.map keeps per-sample alignment deterministic regardless of
    # worker count; a failed dock drops its sample from every statistic,
    # exactly like the sequential protocol.
    if args.docking_mode != 'none':
        def dock_one(cand):
            _, r, mol, _ = cand
            try:
                vina_results = protocol.run_docking(
                    mol, args.docking_mode,
                    ligand_filename=r.get('ligand_filename', ''),
                    protein_root=args.protein_root,
                    protein_path=r.get('protein_path'),
                    exhaustiveness=args.exhaustiveness,
                    tmp_dir=args.tmp_dir)
                # affinity extraction belongs in the same per-sample try:
                # an empty/malformed vina result (zero poses) must skip
                # this sample, not abort the whole evaluation
                return vina_results, protocol.dock_affinity(
                    vina_results, args.docking_mode), None
            except Exception as e:  # noqa: BLE001 — reported per sample
                return None, None, e

        with ThreadPoolExecutor(max(1, args.num_workers)) as pool:
            dock_outcomes = list(pool.map(dock_one, candidates))
    else:
        dock_outcomes = [(None, None, None)] * len(candidates)

    # phase 3 — metric accumulation for the survivors, in original order
    for (atom_mode, r, mol, chem), (vina_results, dock_val, err) in zip(
            candidates, dock_outcomes):
        if err is not None:
            logger.info(f'docking failed (sample skipped): {err}')
            continue
        if args.docking_mode != 'none':
            n_dock_success += 1
            ref_d = ref_vina.get(r.get('ligand_filename', ''))
            if ref_d is not None and dock_val is not None:
                ha_flags.append(dock_val < float(ref_d))

        chem_list.append(chem)
        dock_list.append(dock_val)
        mols_by_pocket.setdefault(r.get('ligand_filename', ''),
                                  []).append(mol)
        if vina_results is not None:
            vina_rows.append(vina_results)

        elements = atomic_numbers_from_index(r['pred_v'], atom_mode)
        atom_counter.update(int(z) for z in elements)
        all_pair_lengths += pair_distances_from_pos(r['pred_pos'],
                                                    elements)
        all_bond_lengths += bond_distances_from_mol(mol)
        try:
            mol_rings = get_ring_sizes(mol)
            ring_sizes.update(mol_rings)
            per_mol_rings.append(mol_rings)
        except Exception:
            pass

    logger.info(f'total {n_total}, reconstructed {n_recon} '
                f'({n_recon / max(n_total, 1):.1%}), complete {n_complete} '
                f'({n_complete / max(n_total, 1):.1%})')

    bond_profile = get_bond_length_profile(all_bond_lengths)
    bond_metrics = eval_bond_length_profile(bond_profile)
    logger.info('bond-length JSD: ' + ' '.join(
        f'{k}={v:.4f}' for k, v in bond_metrics.items() if v is not None))

    pair_profile = get_pair_length_profile(all_pair_lengths)
    pair_metrics = eval_pair_length_profile(pair_profile)
    logger.info('pair-distance JSD: ' + ' '.join(
        f'{k}={v:.4f}' for k, v in pair_metrics.items() if v is not None))

    atom_jsd = eval_atom_type_distribution(atom_counter)
    logger.info(f'atom-type JSD: {atom_jsd:.4f}')
    logger.info(f'ring sizes: {dict(sorted(ring_sizes.items()))}')
    # per-size molecule ratio (ref evaluate_mol_from_meta_full.py:36-42
    # print_ring_ratio: fraction of molecules containing each ring size)
    ring_ratio = {}
    if per_mol_rings:
        for ring_size in range(3, 10):
            n_mol = sum(1 for c in per_mol_rings if ring_size in c)
            ring_ratio[ring_size] = n_mol / len(per_mol_rings)
            logger.info(f'ring size: {ring_size} ratio: '
                        f'{ring_ratio[ring_size]:.3f}')

    chem_rows = [c for c in chem_list if c is not None]
    if chem_rows:
        for key in ('qed', 'sa', 'logp', 'lipinski'):
            vals = [c[key] for c in chem_rows]
            logger.info(f'{key}: mean {np.mean(vals):.4f} '
                        f'median {np.median(vals):.4f}')

    vina_metrics = protocol.aggregate_vina(vina_rows, args.docking_mode)
    for name in ('vina_score', 'vina_min', 'vina_dock'):
        if f'{name}_mean' in vina_metrics:
            logger.info(f'{name}: mean {vina_metrics[f"{name}_mean"]:.4f} '
                        f'median {vina_metrics[f"{name}_median"]:.4f}')

    high_affinity = float(np.mean(ha_flags)) if ha_flags else None
    if high_affinity is not None:
        logger.info(f'high affinity (< reference ligand): {high_affinity:.1%}')
    elif args.docking_mode != 'none' and not args.ref_vina_pkl:
        logger.info('high affinity skipped (no --ref_vina_pkl)')

    sr = protocol.success_rate(chem_list, dock_list)
    if sr is not None:
        logger.info(f'success rate (QED>0.25, SA>0.59, Dock<-8.18): {sr:.1%}')

    # Diversity (paper Table 1; the reference ships no code for it): mean
    # over pockets of 1 - mean pairwise fingerprint Tanimoto
    try:
        div = protocol.diversity(mols_by_pocket)
    except Exception as e:
        logger.info(f'diversity skipped: {e}')
        div = None
    if div is not None:
        logger.info(f'diversity (1 - mean pairwise sim, per pocket): '
                    f'{div:.4f}')

    summary = {
        'n_total': n_total, 'n_recon': n_recon, 'n_complete': n_complete,
        'n_dock_success': n_dock_success,
        'bond_jsd': bond_metrics, 'pair_jsd': pair_metrics,
        'atom_type_jsd': atom_jsd,
        'ring_sizes': dict(ring_sizes),
        'ring_ratio': ring_ratio,
        'chem': chem_rows, 'vina': vina_rows,
        # which stack scored the chem rows (rdkit = reference recipes;
        # first_party = evaluation/descriptors.py — qed/logp/sa exact up
        # to documented caveats, see descriptors.get_chem_record)
        'chem_backend': (chem_rows[0].get('chem_backend')
                         if chem_rows else None),
        'vina_metrics': vina_metrics,
        'high_affinity': high_affinity,
        'success_rate': sr,
        'diversity': div,
    }
    out = args.result_path or os.path.join(args.outdir, 'eval_summary.pkl')
    with open(out, 'wb') as f:
        pickle.dump(summary, f)
    logger.info(f'saved {out}')
    return summary
