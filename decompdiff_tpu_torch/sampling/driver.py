"""The sampling entry point (port of scripts/sample.py `main` and
`run_pocket`; ref scripts/sample_diffusion_decomp.py).

    python scripts/sample_torch.py configs/sampling.yml --ckpt CKPT \\
        -i DATA_ID [DATA_ID ...] --outdir OUT [--device cpu]
    torchrun --standalone --nproc_per_node W scripts/sample_torch.py ...

The model config is re-read from a JAX `.ckpt`; per batch, the generation
records (atom counts, N(mu_k, sigma_k) init positions) and initial types are
drawn on the host from np.random.default_rng(seed), exactly as the JAX
script draws them, then padded into a ComplexBatch on the device; the
reverse diffusion runs with guidance and the CUDA kernels (`use_pallas`);
molecules are reconstructed on the host; one result pickle per pocket is
written in the JAX script's layout.

Differences from the JAX script:
  * Device draws come from a torch.Generator seeded seed + bi where JAX
    uses PRNGKey(seed + bi), so samples differ from the JAX script's for
    the same seed (records and initial types do not).
  * Data parallel over processes, not devices: under torchrun each rank
    is a process with one GPU (parallel/mesh.py; NCCL, or gloo when ranks
    share a GPU or run on the CPU), and the collectives are explicit.
    Every rank builds the same records from the same host generator and
    collates them; when the batch divides by the world size W (as
    scripts/sample.py shards), each rank samples its rows (shard_batch)
    with the global batch's draws (sampling/sampler.py), and the final
    positions, types and bonds (and trajectories) are all-gathered in rank
    order. Otherwise every rank samples the whole batch. Rank 0
    reconstructs and writes the result pickles. Each denoiser call and
    guidance gradient of a rank's rows is the whole batch's to float
    rounding; the pickles equal a world of one's where every operation
    rounds a row alike at B and B/W rows (on the H100, the released config
    at Nl = 32). Elsewhere a library GEMM can round a row's last bit
    differently for fewer rows, and the discrete draws of guided sampling
    can grow that into other, equally valid samples. Local rank 0 builds
    the kernels while the others wait.
  * Batches run one after another, each split into host set-up, device
    sampling (ending in a device synchronize) and reconstruction, and
    timed so.

An `energy_drift` entry of type mmff_min runs the conformer drift on the
host inside its [end_time, start_time) window, as the JAX script does: the
RDKit MMFF94s drift (guidance/mmff.py) where RDKit is installed, else the
first-party force-field relaxation (guidance/ffmin.py). Each pocket's
summary counts its calls and host seconds.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib
import json
import logging
import os
import pickle
import time
from typing import Callable, List, Optional

import numpy as np
import torch

from decompdiff_tpu_torch.config import Config, load_config
from decompdiff_tpu_torch.data import mol as mol_module
from decompdiff_tpu_torch.data.batch import FullProtein
from decompdiff_tpu_torch.data.collate import collate
from decompdiff_tpu_torch.data.dataset import DecompDataset
from decompdiff_tpu_torch.data.mol import MolRecord, mol_to_sdf_block
from decompdiff_tpu_torch.data.protein import PDBProtein
from decompdiff_tpu_torch.data.store import DDStore
from decompdiff_tpu_torch.device import set_matmul_precision
from decompdiff_tpu_torch.evaluation.smiles import mol_to_smiles
from decompdiff_tpu_torch.models.diffusion_model import DecompDiffModel
from decompdiff_tpu_torch.ops import launch_counts, launches_since
from decompdiff_tpu_torch.ops._build import build_once
from decompdiff_tpu_torch.parallel.mesh import (
    Mesh, all_gather_rows, comm_since, destroy_mesh, gather_objects,
    make_mesh, shard_batch)
from decompdiff_tpu_torch.priors.atom_num import (
    NumAtomsSampler, load_num_config)
from decompdiff_tpu_torch.priors.beta import substitute_with_beta_prior
from decompdiff_tpu_torch.reconstruct.builder import (
    MolReconsError, is_connected, mol_record_from_prediction)
from decompdiff_tpu_torch.sampling.init import (
    build_generation_records, init_types_host)
from decompdiff_tpu_torch.sampling.sampler import (
    SampleConfig, sample_diffusion)
from decompdiff_tpu_torch.utils.checkpoint import load_model_from_checkpoint
from decompdiff_tpu_torch.utils.misc import get_logger, seed_all

# The JAX package's name of the molecule class in result pickles: its
# scripts/evaluate.py tells a first-party molecule from an RDKit one by
# isinstance, so result pickles name that class (see save_result).
JAX_MOL_MODULE = 'decompdiff_tpu.data.mol'


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description='Sample molecules for pockets of a store with the '
                    'PyTorch port (see decompdiff_tpu_torch/sampling/'
                    'driver.py).')
    parser.add_argument('config')
    parser.add_argument('--ckpt', required=True,
                        help="a checkpoint in the JAX package's .ckpt format")
    parser.add_argument('-i', '--data_id', type=int, nargs='+', default=[0],
                        help='one or more pocket ids; each pocket is '
                             're-seeded, so its results equal those of a '
                             'run with that id alone')
    parser.add_argument('--outdir', default='./outputs')
    parser.add_argument('--prior_mode', default=None,
                        choices=['subpocket', 'ref_prior', 'beta_prior'])
    parser.add_argument('--num_samples', type=int, default=None)
    parser.add_argument('--batch_size', type=int, default=8)
    parser.add_argument('--save_traj', action='store_true')
    parser.add_argument('--sample_num_atoms', default=None,
                        choices=['prior', 'ref', 'ref_large', 'old', 'v2',
                                 'stat'],
                        help='override the config atom-count mode')
    parser.add_argument('--beta_prior_path', default=None,
                        help='dir/template of per-pocket beta-prior '
                             'pickles, {id:08d}.pkl appended when a '
                             'directory is given')
    parser.add_argument('--natoms_config', default=None,
                        help="pickle for the 'stat' atom-count sampler")
    parser.add_argument('--suffix', default=None,
                        help='appended to result filenames: '
                             'result_<id><suffix>.pkl')
    parser.add_argument('--recon_with_bond', default='auto',
                        choices=['auto', 'true', 'false'],
                        help='use the diffused bond channel for '
                             'reconstruction; auto follows the checkpoint '
                             'bond_diffusion flag')
    parser.add_argument('--use_pallas', action='store_true',
                        help='run the hand-written CUDA kernels')
    parser.add_argument('--no_pallas', action='store_true',
                        help='run the plain PyTorch versions even when the '
                             'checkpoint config enables the kernels')
    parser.add_argument('--protein_path', default=None,
                        help='the original full-protein PDB for clash '
                             'guidance (the pocket store is a crop); also '
                             'recorded into results for docking')
    parser.add_argument('--device', default=None,
                        help='torch device (default: CUDA; without a GPU '
                             'pass cpu explicitly); under torchrun each rank '
                             'takes GPU LOCAL_RANK')
    parser.add_argument('--summary', default=None,
                        help='write the pockets\' summaries as JSON to this '
                             'path (rank 0; every rank\'s kernel launches, '
                             'rows and seconds under "ranks")')
    return parser


@dataclasses.dataclass
class SamplingRun:
    """What every pocket of one invocation shares."""
    args: argparse.Namespace
    sample_cfg_file: Config
    model: DecompDiffModel
    sample_config: SampleConfig
    dataset: DecompDataset
    atom_mode: str
    prior_mode: str
    num_atoms_mode: str
    num_samples: int
    seed: int
    arms_cfg: Optional[dict]
    sca_cfg: Optional[dict]
    natoms_sampler: Optional[NumAtomsSampler]
    logger: logging.Logger
    drift: Optional['DriftMeter'] = None
    mesh: Optional[Mesh] = None


class DriftMeter:
    """Wraps a host drift callback: counts its calls, the molecules (batch
    rows) it gave a non-zero drift, and the host seconds spent inside it."""

    def __init__(self, callback: Callable):
        self.callback = callback
        self.reset()

    def reset(self) -> None:
        self.calls, self.relaxed, self.seconds = 0, 0, 0.0

    def __call__(self, pos, v, mask):
        t0 = time.perf_counter()
        out = self.callback(pos, v, mask)
        self.seconds += time.perf_counter() - t0
        self.calls += 1
        self.relaxed += int(np.any(np.asarray(out) != 0, axis=(1, 2)).sum())
        return out


def _mmff_drift(energy_drift, atom_mode: str, logger: logging.Logger):
    """(DriftMeter or None, SampleConfig keywords) for the mmff_min entry
    of energy_drift, chosen as scripts/sample.py chooses it: RDKit's MMFF94s
    drift, else the first-party force-field relaxation."""
    for d in energy_drift:
        if d['type'] != 'mmff_min':
            continue
        try:
            from decompdiff_tpu_torch.guidance.mmff import make_mmff_callback
            callback = make_mmff_callback(atom_mode)
        except ImportError:
            from decompdiff_tpu_torch.guidance.ffmin import make_ff_callback
            callback = make_ff_callback(atom_mode)
            logger.info('mmff_min: RDKit unavailable, using the first-party '
                        'force-field relaxation (guidance/ffmin.py)')
        meter = DriftMeter(callback)
        return meter, dict(mmff_callback=meter,
                           mmff_start_time=int(d.get('start_time', 0)),
                           mmff_end_time=int(d.get('end_time', 0)))
    return None, {}


def main(argv=None) -> List[dict]:
    args = build_parser().parse_args(argv)
    return run(args, load_config(args.config))


def run(args: argparse.Namespace, sample_cfg_file: Config,
        mesh: Optional[Mesh] = None) -> List[dict]:
    """Sample every pocket of args.data_id on `mesh` (parallel/mesh.py; by
    default the world torchrun's environment describes, a world of one
    without it, started here and ended on return); returns one summary per
    pocket (see run_pocket)."""
    own_mesh = mesh is None
    if own_mesh:
        mesh = make_mesh(device=args.device)
    try:
        counts0, comm0 = launch_counts(), comm_since(mesh, {})
        summaries = _run(args, sample_cfg_file, mesh)
        ranks = gather_objects({
            'rank': mesh.rank, 'launches': launches_since(counts0),
            'rows': [s['rows'] for s in summaries],
            'device_s': [s['device_s'] for s in summaries],
            'comm': comm_since(mesh, comm0)}, mesh)
        if args.summary and mesh.rank == 0:
            with open(args.summary, 'w') as f:
                json.dump({'pockets': summaries,
                           'world_size': mesh.world_size,
                           'backend': mesh.backend, 'ranks': ranks}, f,
                          indent=1)
        return summaries
    finally:
        if own_mesh:
            destroy_mesh(mesh)


def _run(args: argparse.Namespace, sample_cfg_file: Config,
         mesh: Mesh) -> List[dict]:
    scfg = sample_cfg_file.sample
    seed = scfg.get('seed', 2021)
    seed_all(seed)
    if mesh.rank == 0:
        os.makedirs(args.outdir, exist_ok=True)
        logger = get_logger('sample_torch', args.outdir)
    else:
        logger = get_logger(f'sample_torch.rank{mesh.rank}')
        logger.setLevel(logging.WARNING)

    energy_drift = tuple(dict(d) for d in scfg.get('energy_drift', []))

    set_matmul_precision()
    overrides = {}
    if args.use_pallas:
        overrides['use_pallas'] = True
    if args.no_pallas:
        overrides['use_pallas'] = False
    model, ckpt = load_model_from_checkpoint(
        args.ckpt, device=mesh.device, overrides=overrides)
    if model.config.get('use_pallas', False):
        build_once(mesh)
    W = mesh.world_size
    if mesh.distributed and args.batch_size % W == 0:
        logger.info(f'data-parallel over {W} ranks ({mesh.describe()})')
    elif W > 1:
        logger.info(f'{W} ranks but batch_size {args.batch_size} not '
                    'divisible — running unsharded')
    train_config = Config(ckpt['config'])
    atom_mode = train_config.data.transform.get('ligand_atom_mode', 'basic')
    drift, mmff_kwargs = _mmff_drift(energy_drift, atom_mode, logger)

    dataset = DecompDataset(DDStore(sample_cfg_file.data.path),
                            ligand_atom_mode=atom_mode)
    prior_mode = args.prior_mode or scfg.get('prior_mode', 'ref_prior')
    num_atoms_mode = (args.sample_num_atoms
                      or scfg.get('sample_num_atoms', 'ref'))
    if num_atoms_mode == 'prior':
        arms_cfg = load_num_config(
            scfg.get('arms_num_atoms_config', 'arm_num_config'))
        sca_cfg = load_num_config(
            scfg.get('scaffold_num_atoms_config', 'scaffold_num_config'))
    else:
        arms_cfg = sca_cfg = None
    natoms_sampler = (NumAtomsSampler.from_pickle(
                          args.natoms_config or scfg.natoms_config)
                      if num_atoms_mode == 'stat' else None)

    num_steps = scfg.get('num_steps', model.num_timesteps)
    if num_steps > model.num_timesteps:
        logger.warning(f'num_steps {num_steps} > model timesteps '
                       f'{model.num_timesteps}; clamping')
        num_steps = model.num_timesteps
    skip_mode = scfg.get('skip_mode', 'truncate')
    if skip_mode == 'strided' and num_steps < model.num_timesteps:
        logger.info(f'strided fast sampling: {num_steps} denoiser calls '
                    f'spread over the {model.num_timesteps}-step chain')
    sample_config = SampleConfig(
        num_steps=num_steps,
        save_traj=args.save_traj,
        center_pos_mode=scfg.get(
            'center_pos_mode', model.config.get('center_pos_mode',
                                                'protein')),
        skip_mode=skip_mode,
        energy_drift=energy_drift,
        **mmff_kwargs)

    if args.protein_path and len(args.data_id) > 1:
        logger.warning('--protein_path names ONE receptor but %d pocket ids '
                       'were given; clash guidance and docking provenance '
                       'will use it for every pocket', len(args.data_id))
    sampling = SamplingRun(
        args=args, sample_cfg_file=sample_cfg_file, model=model,
        sample_config=sample_config, dataset=dataset, atom_mode=atom_mode,
        prior_mode=prior_mode, num_atoms_mode=num_atoms_mode,
        num_samples=args.num_samples or scfg.get('num_samples', 10),
        seed=seed, arms_cfg=arms_cfg, sca_cfg=sca_cfg,
        natoms_sampler=natoms_sampler, logger=logger, drift=drift,
        mesh=mesh)
    return [run_pocket(sampling, data_id) for data_id in args.data_id]


def _full_protein(sampling: SamplingRun, raw: dict) -> Optional[FullProtein]:
    """The protein clash guidance sees, broadcast over the batch: the
    original full protein of --protein_path (ref
    sample_diffusion_decomp.py:564-565), else the pocket store's crop."""
    args = sampling.args
    if not any(d['type'] == 'clash'
               for d in sampling.sample_config.energy_drift):
        return None
    if args.protein_path:
        pos = PDBProtein(args.protein_path).to_dict_atom()['pos']
    else:
        pos = raw['protein_pos']
        sampling.logger.info('clash guidance uses the pocket store protein; '
                             'pass --protein_path for the original full '
                             'protein')
    dev = sampling.model.device
    pos = torch.as_tensor(np.asarray(pos, np.float32), device=dev)
    B = args.batch_size
    return FullProtein(pos=pos.expand(B, -1, -1),
                       mask=torch.ones((B, len(pos)), dtype=torch.bool,
                                       device=dev))


def run_pocket(sampling: SamplingRun, data_id: int) -> dict:
    """Sample num_samples molecules for one pocket and write its result
    pickle. Re-seeds first, so a pocket's results do not depend on the
    pockets sampled before it in the process. With a data-parallel mesh,
    each rank samples its rows of every batch that divides over the ranks,
    and rank 0 reconstructs and writes.

    Returns {'data_id', 'path', 'n', 'n_recon', 'n_complete', 'shapes'
    (the padded (B, Np, Nl) of each batch), 'rows' (the batch rows this
    rank sampled, per batch), 'host_s', 'device_s', 'recon_s' (wall
    seconds summed over the batches), 'drift_calls', 'drift_relaxed',
    'drift_s'} (the mmff_min drift's calls, batch rows it gave a non-zero
    drift, and host seconds, already within device_s); on a rank other
    than 0, n_recon and n_complete are 0 and nothing is written."""
    args, model, logger = sampling.args, sampling.model, sampling.logger
    mesh = sampling.mesh
    lead = mesh is None or mesh.rank == 0
    scfg = sampling.sample_cfg_file.sample
    seed_all(sampling.seed)
    if sampling.drift is not None:
        sampling.drift.reset()
    recon_with_bond = (model.bond_diffusion
                       if args.recon_with_bond == 'auto'
                       else args.recon_with_bond == 'true')
    raw = sampling.dataset.get_raw(data_id)
    bp_path = args.beta_prior_path or scfg.get('beta_prior_path')
    if sampling.prior_mode == 'beta_prior' and bp_path:
        if os.path.isdir(bp_path):
            bp_path = os.path.join(bp_path, '{id:08d}.pkl')
        raw = substitute_with_beta_prior(raw, bp_path.format(id=data_id))
    full_protein = _full_protein(sampling, raw)

    rng_np = np.random.default_rng(sampling.seed)
    atom_prior_probs = np.exp(
        model.atom_diff.prior_logprobs.cpu().numpy().astype(np.float64))
    bond_prior_probs = np.exp(
        model.bond_diff.prior_logprobs.cpu().numpy().astype(np.float64))
    B, num_samples = args.batch_size, sampling.num_samples
    n_batches = int(np.ceil(num_samples / B))
    # shard as scripts/sample.py does, when the batch divides
    sharded = (mesh is not None and mesh.distributed
               and B % mesh.world_size == 0)
    mesh_kw = {'mesh': mesh} if sharded else {}
    if sharded and full_protein is not None:
        full_protein = shard_batch(full_protein, mesh)
    results, shapes, rows = [], [], []
    times = {'host_s': 0.0, 'device_s': 0.0, 'recon_s': 0.0}
    t_start = time.perf_counter()
    for bi in range(n_batches):
        t0 = time.perf_counter()
        n = min(B, num_samples - bi * B)
        records = build_generation_records(
            raw, n, sampling.prior_mode, sampling.num_atoms_mode, rng_np,
            arms_natoms_config=sampling.arms_cfg,
            scaffold_natoms_config=sampling.sca_cfg,
            natoms_sampler=sampling.natoms_sampler)
        records = init_types_host(
            rng_np, records, model.atom_diff.num_classes,
            model.bond_diff.num_classes, atom_prior_probs=atom_prior_probs,
            bond_prior_probs=bond_prior_probs)
        if len(records) < B:
            # pad the tail batch with copies of the last record, as the JAX
            # script does, so every batch has the same shape; outputs are
            # sliced back to n below
            records = records + [dict(records[-1])] * (B - len(records))
        batch = collate(records, device=model.device)
        shapes.append((B, batch.num_protein_atoms, batch.num_ligand_atoms))
        mine = shard_batch(batch, mesh) if sharded else batch
        rows.append(mine.batch_size)

        t1 = time.perf_counter()
        generator = torch.Generator(device=model.device).manual_seed(
            sampling.seed + bi)
        out = sample_diffusion(
            model, sampling.sample_config, mine, mine.ligand_pos,
            mine.ligand_v, mine.bond_type, full_protein,
            generator=generator, **mesh_kw)
        if sharded:
            traj = out.pop('traj', None)
            out = {k: all_gather_rows(t, mesh) for k, t in out.items()}
            if traj is not None:    # stacked steps [S, B, ...]
                out['traj'] = {k: all_gather_rows(t, mesh, dim=1)
                               for k, t in traj.items()}
        if model.device.type == 'cuda':
            torch.cuda.synchronize(model.device)

        t2 = time.perf_counter()
        if not lead:
            times['host_s'] += t1 - t0
            times['device_s'] += t2 - t1
            continue
        pos, v, bond = (out[k].cpu().numpy() for k in ('pos', 'v', 'bond'))
        mask = batch.ligand_mask.cpu().numpy()
        decomp = batch.ligand_decomp_idx.cpu().numpy()
        traj = ({k: t.cpu().numpy() for k, t in out['traj'].items()}
                if 'traj' in out else None)
        for s in range(n):
            results.append(_result_entry(
                sampling, raw, pos[s], v[s], bond[s], mask[s], decomp[s],
                traj, s, recon_with_bond))
        t3 = time.perf_counter()
        times['host_s'] += t1 - t0
        times['device_s'] += t2 - t1
        times['recon_s'] += t3 - t2
        logger.info(f'batch {bi + 1}/{n_batches} done '
                    f'({t3 - t_start:.1f}s: host set-up {t1 - t0:.2f} '
                    f'sampling {t2 - t1:.2f} recon {t3 - t2:.2f})')

    n_recon = sum(1 for r in results if r['mol'] is not None)
    n_complete = sum(1 for r in results if r['complete'])
    logger.info(f'reconstructed {n_recon}/{len(results)}, '
                f'complete {n_complete}/{len(results)}')
    suffix = args.suffix or ''
    out_path = os.path.join(args.outdir, f'result_{data_id}{suffix}.pkl')
    if lead:
        save_result(out_path, {'data_id': data_id, 'results': results,
                               'atom_mode': sampling.atom_mode,
                               'config': sampling.sample_cfg_file.to_dict()})
        logger.info(f'saved {out_path}')
    drift = sampling.drift
    return dict(data_id=data_id, path=out_path, n=num_samples,
                n_recon=n_recon, n_complete=n_complete, shapes=shapes,
                rows=rows,
                drift_calls=drift.calls if drift else 0,
                drift_relaxed=drift.relaxed if drift else 0,
                drift_s=drift.seconds if drift else 0.0, **times)


def _result_entry(sampling: SamplingRun, raw, pos, v, bond, mask, decomp,
                  traj, s, recon_with_bond) -> dict:
    """One result row, in the JAX script's layout (scripts/sample.py
    :345-410)."""
    m = mask
    pred_pos, pred_v = pos[m], v[m]
    pred_bond = bond[np.ix_(m, m)]
    entry = {
        'pred_pos': pred_pos, 'pred_v': pred_v, 'pred_bond': pred_bond,
        'decomp_mask': decomp[m],
        'mol': None, 'smiles': None, 'complete': False,
        # provenance for the docking protocol (ref docking_vina.py:154-162)
        'ligand_filename': raw.get('src_ligand_filename', ''),
        'src_protein_filename': raw.get('src_protein_filename', ''),
        'protein_path': sampling.args.protein_path,
    }
    if traj is not None:
        # stacked steps [T, B, ...] -> per-sample trajectories
        entry['pos_traj'] = traj['pos'][:, s][:, m]
        entry['v_traj'] = traj['v'][:, s][:, m]
        if 'bond' in traj:
            entry['bond_traj'] = traj['bond'][:, s][:, m][:, :, m]
    try:
        # without bond diffusion the bond channel is untrained noise:
        # reconstruct geometry-only (ref sample_diffusion_decomp.py:424-431)
        mol = mol_record_from_prediction(
            pred_pos, pred_v, pred_bond if recon_with_bond else None,
            atom_mode=sampling.atom_mode)
        entry['mol'] = mol
        entry['complete'] = is_connected(mol)
        if not hasattr(mol, 'bond_index'):  # rdkit mol
            from rdkit import Chem
            entry['smiles'] = Chem.MolToSmiles(mol)
        else:
            entry['sdf'] = mol_to_sdf_block(mol)
            try:
                entry['smiles'] = mol_to_smiles(mol)
            except Exception:
                entry['smiles'] = None
    except MolReconsError as e:
        entry['recon_error'] = str(e)
    return entry


class _Imported:
    """Pickles as `importlib.import_module(module)`, or with a name as
    `getattr` of it: resolved where the pickle is read."""

    def __init__(self, module: str, name: Optional[str] = None):
        self.module, self.name = module, name

    def __reduce__(self):
        if self.name is None:
            return importlib.import_module, (self.module,)
        return getattr, (_Imported(self.module), self.name)


class _ResultPickler(pickle.Pickler):
    """Writes each MolRecord as an instance of the JAX package's MolRecord
    (same fields), so that the JAX package's scripts/evaluate.py reads the
    result pickles as it reads its own. Nothing is imported on writing."""

    def reducer_override(self, obj):
        if type(obj) is MolRecord:
            return (object.__new__, (_Imported(JAX_MOL_MODULE, 'MolRecord'),),
                    dict(obj.__dict__))
        return NotImplemented


class _ResultUnpickler(pickle.Unpickler):
    """Reads the molecules of a result pickle as the port's MolRecord."""

    def find_class(self, module, name):
        if (module, name) == ('importlib', 'import_module'):
            return _import_as_port
        return super().find_class(module, name)


def _import_as_port(module: str):
    if module == JAX_MOL_MODULE:
        return mol_module
    raise pickle.UnpicklingError(f'unexpected module {module!r}')


def save_result(path: str, payload: dict) -> None:
    with open(path, 'wb') as f:
        _ResultPickler(f, protocol=4).dump(payload)


def load_result(path: str) -> dict:
    """A result pickle of save_result, without the JAX package."""
    with open(path, 'rb') as f:
        return _ResultUnpickler(f).load()
