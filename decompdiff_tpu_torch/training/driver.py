"""The training entry point (port of scripts/train.py; ref
scripts/train_diffusion_decomp.py).

    python scripts/train_torch.py configs/training.yml [--outdir logs] \\
        [--resume CKPT] [--max_iters N] [--val_freq N] [--device cpu]
    torchrun --standalone --nproc_per_node W scripts/train_torch.py ...

The JAX script's protocol: the transform stack from the config, the split
from `data.split` (else the last 10% of the store for validation), an
infinite bucketed loader seeded seed + start_iteration - 1, Adam with
global-norm clipping and a plateau scheduler on the validation loss, input
jitter, `n_acc_batch` gradient accumulation, validation at 10 fixed
timesteps with unit prior stds and the frequency-weighted AUROCs, a
checkpoint at each new best validation loss, resume from a checkpoint of
the port or of the JAX package (its optimizer state included).

Differences from the JAX script:
  * Device draws come from a torch.Generator seeded train.seed (and a fresh
    one per validation (iteration, batch, t)), so losses differ from the
    JAX script's for the same seed; batches do not.
  * Resuming a port checkpoint continues its generator. A JAX `.ckpt`
    carries a JAX key the port cannot continue, so from one the port seeds
    from (seed, start iteration), as the JAX script does for a file that
    holds no key.
  * Data parallel over processes, not devices: under torchrun each rank
    is a process with one GPU (parallel/mesh.py; NCCL, or gloo when ranks
    share a GPU or run on the CPU), and the collectives are explicit. When
    batch_size divides by the world size W, every rank runs the same
    loader (same seed, so the host work is repeated on every rank, as
    under JAX's single controller), takes its rows of each global batch
    (shard_batch) and draws the global batch's numbers from one generator
    state that every rank holds; the gradients are all-reduced
    (train_step.py). Otherwise every rank runs the whole batch unsharded
    and without collectives, with the JAX script's log line. Parameters,
    Adam moments and Lt buffers are broadcast from rank 0 after creating
    or resuming them; validation runs unsharded on every rank, and rank
    0's validation loss drives every rank's scheduler. Only rank 0 writes
    the run directory (config, source snapshot, metrics, log file,
    checkpoints in the unchanged layout, `--summary`); the other ranks
    wait at a barrier after each checkpoint. A rank that runs out of
    memory ends the run: the others could not skip the same step. Local
    rank 0 builds the kernels while the others wait (ops/_build.py
    build_once).
  * Each step ends in a device synchronize, so that the summary splits the
    time into loader wait and step.
  * A step updates the parameters and the Adam moments in place, so a
    checkpoint's snapshot to host numpy is taken on the training thread,
    before the next step; only pickling and writing run on the saver
    thread.
  * The run directory's config.yml is written as JSON, which YAML readers
    read, so a run needs no PyYAML.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import pickle
import sys
import threading
import time
from collections import deque
from typing import Optional

import numpy as np
import torch

from decompdiff_tpu_torch.config import Config, load_config
from decompdiff_tpu_torch.constants import atom_class_count
from decompdiff_tpu_torch.data.dataset import DecompDataset
from decompdiff_tpu_torch.data.store import DDStore
from decompdiff_tpu_torch.device import set_matmul_precision
from decompdiff_tpu_torch.models.diffusion_model import DecompDiffModel
from decompdiff_tpu_torch.ops import launch_counts, launches_since
from decompdiff_tpu_torch.ops._build import build_once
from decompdiff_tpu_torch.parallel.mesh import (
    Mesh, barrier, broadcast_, broadcast_object, comm_seconds, comm_since,
    destroy_mesh, gather_objects, make_mesh, shard_batch)
from decompdiff_tpu_torch.training.loader import BucketedLoader
from decompdiff_tpu_torch.training.metrics import get_auroc, get_bond_auroc
from decompdiff_tpu_torch.training.train_step import (
    PlateauScheduler, create_train_state, make_eval_step, make_train_fns,
    set_learning_rate)
from decompdiff_tpu_torch.utils.checkpoint import (
    checkpoint_payload, read_checkpoint, restore_train_state,
    write_checkpoint)
from decompdiff_tpu_torch.utils.metrics_logger import (
    MetricsLogger, ValidationLossTape)
from decompdiff_tpu_torch.utils.misc import (
    count_parameters, get_logger, get_new_log_dir, seed_all, snapshot_source)
from decompdiff_tpu_torch.utils.profiling import start_trace, stop_trace

LOGGER = 'train_torch'
# a split of at most this many records is featurized and collated once and
# kept on the device; a larger one streams through a loader per validation
VAL_CACHE_MAX_RECORDS = 2048
VAL_TIMESTEPS = 10
# validation results pending on the device before the oldest is read back
VAL_WINDOW = 16


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description='Train DecompDiff with the PyTorch port (see '
                    'decompdiff_tpu_torch/training/driver.py).')
    parser.add_argument('config')
    parser.add_argument('--outdir', default='./logs')
    parser.add_argument('--resume', default=None,
                        help="a checkpoint of the port or of the JAX package")
    parser.add_argument('--max_iters', type=int, default=None)
    parser.add_argument('--val_freq', type=int, default=None)
    parser.add_argument('--report_freq', type=int, default=200)
    parser.add_argument('--tag', default='',
                        help='suffix appended to the auto-named run dir '
                             '(ref train_diffusion_decomp.py:67)')
    parser.add_argument('--profile_steps', type=int, default=0,
                        help='trace N steps (from step 10, or the first after '
                             'a resume) into <run>/profile/trace.json, the '
                             "port's spans with the profiler's events")
    parser.add_argument('--device', default=None,
                        help='torch device (default: CUDA; without a GPU '
                             'pass cpu explicitly); under torchrun each rank '
                             'takes GPU LOCAL_RANK')
    parser.add_argument('--summary', default=None,
                        help='write the run summary as JSON to this path '
                             '(rank 0; every rank\'s step seconds, kernel '
                             'launches and collective seconds under '
                             '"ranks")')
    return parser


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    return run(args, load_config(args.config))


def draw_seed(*keys: int) -> int:
    """A torch.Generator seed from non-negative integer keys."""
    return int(np.random.SeedSequence(list(keys)).generate_state(
        1, np.uint64)[0])


def batch_shape(batch) -> tuple:
    """The padded (B, Np, Nl, A) of a batch."""
    return (batch.batch_size, batch.num_protein_atoms,
            batch.num_ligand_atoms, batch.num_groups)


def _save_config(config: Config, path: str) -> None:
    with open(path, 'w') as f:
        json.dump(config.to_dict(), f, indent=2)


def _split(config: Config, dataset: DecompDataset) -> dict:
    split_path = config.data.get('split')
    if split_path and os.path.exists(split_path):
        with open(split_path, 'rb') as f:
            return dataset.split_by_names(pickle.load(f))
    ids = list(range(len(dataset)))
    n_test = max(1, len(ids) // 10)
    return {'train': ids[:-n_test], 'test': ids[-n_test:]}


class _AsyncSaver:
    """Writes checkpoints on a thread, one at a time. `save` joins the
    previous write first; `join` re-raises a write's failure, so a run
    cannot end pointing at a checkpoint that was never written."""

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self._errors: list = []

    def _write(self, path, payload):
        try:
            write_checkpoint(path, payload)
        except Exception as e:      # raised again at the join
            self._errors.append(e)

    def join(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._errors:
            raise RuntimeError(
                'async checkpoint save failed') from self._errors[0]

    def save(self, path: str, payload: dict) -> None:
        self.join()
        self._thread = threading.Thread(target=self._write,
                                        args=(path, payload), daemon=False)
        self._thread.start()


def run(args: argparse.Namespace, config: Config,
        mesh: Optional[Mesh] = None) -> dict:
    """Train as scripts/train.py does, on `mesh` (parallel/mesh.py; by
    default the world torchrun's environment describes, a world of one
    without it, started here and ended on return); returns a summary:

    'log_dir', 'start_iter', 'resumed' (None, or what the resume restored:
    the checkpoint's path and iteration, the step count, the learning rate,
    the distinct Adam step counts and the scheduler state),
    'iterations' (those that ran a step),
    'train_loss', 'lr' and 'step_seconds' (the step's wall time without
    its loader wait, ending in a device synchronize; per iteration in
    'iterations'), 'batch_shapes'
    (the padded (B, Np, Nl, A) of every batch trained, n_acc_batch per
    step), 'eval_shapes' (that of every validation call), 'val' (per
    validation: iteration, losses, AUROCs, the learning rate after the
    scheduler), 'scheduler' (its final state), 'checkpoints' (paths),
    'oom_skips', 'seconds' (first step, with the device's lazy set-up;
    then the other steps' loader wait and step; validation; checkpoint
    snapshots and waits for their writes), 'max_memory_allocated'
    (bytes, on CUDA), 'grad_norm' and 'comm_seconds' (per iteration: the
    seconds of the step's collectives, within its step seconds),
    'world_size', 'backend', 'sharded' and 'ranks' (per rank: the batch
    rows its steps take, its step and collective seconds per iteration,
    kernel launches, and its collectives' calls, seconds and bytes by
    kind)."""
    own_mesh = mesh is None
    if own_mesh:
        mesh = make_mesh(device=args.device)
    try:
        set_matmul_precision()
        seed = int(config.train.seed)
        seed_all(seed)
        log_dir = broadcast_object(
            get_new_log_dir(args.outdir, prefix='train', tag=args.tag)
            if mesh.rank == 0 else None, mesh)
        logger = _rank_logger(LOGGER, log_dir, mesh)
        try:
            summary = _run(args, config, mesh, seed, log_dir, logger)
        finally:
            for handler in list(logger.handlers):
                logger.removeHandler(handler)
                handler.close()
        if args.summary and mesh.rank == 0:
            with open(args.summary, 'w') as f:
                json.dump(summary, f, indent=1)
        return summary
    finally:
        if own_mesh:
            destroy_mesh(mesh)


def _rank_logger(name: str, log_dir: str, mesh: Mesh) -> logging.Logger:
    """Rank 0 logs as a world of one does; another rank prints its
    warnings only, under a name of its own."""
    if mesh.rank == 0:
        return get_logger(name, log_dir)
    logger = get_logger(f'{name}.rank{mesh.rank}')
    logger.setLevel(logging.WARNING)
    return logger


def _run(args, config: Config, mesh: Mesh, seed: int,
         log_dir: str, logger: logging.Logger) -> dict:
    device, lead = mesh.device, mesh.rank == 0
    ckpt_dir = os.path.join(log_dir, 'checkpoints')
    if lead:
        os.makedirs(ckpt_dir, exist_ok=True)
        _save_config(config, os.path.join(log_dir, 'config.yml'))
        snapshot_source(log_dir)     # ref train_diffusion_decomp.py:86-87
    cuda = device.type == 'cuda'
    counts0, comm0 = launch_counts(), comm_since(mesh, {})
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)

    # --- data ---
    transform = config.data.transform
    dataset = DecompDataset(
        DDStore(config.data.path),
        prior_mode=config.data.get('prior_mode', 'ref_prior'),
        ligand_atom_mode=transform.get('ligand_atom_mode', 'basic'),
        ligand_bond_mode=transform.get('ligand_bond_mode', 'fc'),
        add_ord_feat=transform.get('add_ord_feat', False),
        max_num_arms=transform.get('max_num_arms', 10),
        random_rot=transform.get('random_rot', False))
    split = _split(config, dataset)
    logger.info(f'train: {len(split["train"])}, test: {len(split["test"])}')

    batch_size = config.train.batch_size
    # ref configs/training.yml:67
    num_workers = int(config.train.get('num_workers', 4))
    # the resume checkpoint is read before the loader is built: a resumed
    # run reseeds its shuffle by the resume iteration rather than replay
    # the first epoch's order
    resume_ckpt, start_iter = None, 1
    if args.resume:
        resume_ckpt = read_checkpoint(args.resume)
        start_iter = resume_ckpt['iteration'] + 1
    train_loader = BucketedLoader(dataset, split['train'], batch_size,
                                  shuffle=True, seed=seed + start_iter - 1,
                                  num_threads=num_workers, device=device)
    train_iter = iter(train_loader)

    # --- model ---
    num_classes = atom_class_count(transform.get('ligand_atom_mode', 'basic'))
    model = DecompDiffModel.create(config.model.to_dict(), num_classes,
                                   device=device, seed=seed)
    if model.config.get('use_pallas', False):
        build_once(mesh)
    # the JAX script draws one batch to initialize its parameters; the
    # port draws it too and sets it aside, so that iteration i trains on
    # the same batch in both
    next(train_iter)
    train_cfg = dict(config.train.to_dict())
    # sample_time_method lives in the model section (ref configs/training.yml)
    train_cfg.setdefault('sample_time_method',
                         config.model.get('sample_time_method', 'symmetric'))
    state = create_train_state(model, train_cfg)
    logger.info('# parameters: '
                f'{count_parameters(model.denoiser) / 1e6:.4f} M')

    sched_cfg = config.train.get('scheduler', {})
    scheduler = PlateauScheduler(
        factor=sched_cfg.get('factor', 0.6),
        patience=sched_cfg.get('patience', 10),
        min_lr=sched_cfg.get('min_lr', 1e-6),
        threshold=sched_cfg.get('threshold', 1e-4))
    generator = torch.Generator(device=device).manual_seed(seed)
    best_loss = best_iter = resumed = None
    if resume_ckpt is not None:
        state = restore_train_state(resume_ckpt, model, state)
        scheduler.load_state_dict(resume_ckpt['scheduler'])
        extra = resume_ckpt['extra']
        saved = extra.get('torch_generator')
        if saved is not None and saved['device'] == device.type:
            generator.set_state(torch.from_numpy(
                np.asarray(saved['state'], np.uint8)))
        elif start_iter > 1:
            # a JAX file's key (or another device's generator) cannot be
            # continued: at least do not replay iteration 1's draws
            generator.manual_seed(draw_seed(seed, start_iter))
        best_loss, best_iter = extra.get('best_loss'), extra.get('best_iter')
        resumed = {'path': args.resume, 'iteration': start_iter - 1,
                   'step': state.step, 'lr': state.optimizer.lr,
                   'adam_steps': sorted({
                       float(s['step'])
                       for s in state.optimizer.adam.state.values()}),
                   'scheduler': scheduler.state_dict()}
        logger.info(f'resumed from {args.resume} at iteration {start_iter}'
                    + (f' (best val {best_loss:.6f} @ {best_iter})'
                       if best_loss is not None else ''))
    # the replicated state: rank 0's, on every rank
    adam_state = [state.optimizer.adam.state[p]
                  for p in state.optimizer.params.values()
                  if p in state.optimizer.adam.state]
    broadcast_(list(model.denoiser.parameters())
               + [v for s in adam_state for _, v in sorted(s.items())
                  if torch.is_tensor(v)]
               + [state.lt_history, state.lt_count], mesh)

    # dp over the ranks when the batch divides by their number
    # (scripts/train.py:147-155)
    W = mesh.world_size
    sharded = mesh.distributed and batch_size % W == 0
    if sharded:
        logger.info(f'data-parallel over {W} ranks ({mesh.describe()})')
    elif W > 1:
        logger.info(f'{W} ranks but batch_size {batch_size} not divisible '
                    '— running unsharded')
    # a world of one builds the step functions as before the mesh existed
    mesh_kw = {'mesh': mesh} if sharded else {}
    train_step, grad_step, apply_grads = make_train_fns(model, train_cfg,
                                                        **mesh_kw)
    n_acc = int(config.train.get('n_acc_batch', 1))
    eval_step = make_eval_step(model, config.train)
    metrics_logger = MetricsLogger(log_dir) if lead else _NoMetrics()
    max_iters = args.max_iters or config.train.max_iters
    val_freq = args.val_freq or config.train.val_freq
    val_steps = np.linspace(0, model.num_timesteps - 1,
                            VAL_TIMESTEPS).astype(int)

    summary = {'log_dir': log_dir, 'start_iter': start_iter,
               'resumed': resumed,
               'iterations': [], 'train_loss': [], 'grad_norm': [], 'lr': [],
               'step_seconds': [], 'comm_seconds': [],
               'batch_shapes': [], 'eval_shapes': [], 'val': [],
               'checkpoints': [], 'oom_skips': 0}
    seconds = dict.fromkeys(('first_step', 'loader_wait', 'steps',
                             'validation', 'checkpoint'), 0.0)
    losses = torch.full((2, max(0, max_iters - start_iter + 1)),
                        float('nan'), device=device)
    val_batches: list = []
    cache_val = len(split['test']) <= VAL_CACHE_MAX_RECORDS

    def val_batch_stream():
        if cache_val and val_batches:
            yield from val_batches
            return
        val_loader = BucketedLoader(dataset, split['test'], batch_size,
                                    shuffle=False, infinite=False,
                                    num_threads=num_workers, device=device)
        try:    # an abandoned or failed validation still stops the producer
            for b in val_loader:
                if cache_val:
                    val_batches.append(b)
                yield b
        finally:
            val_loader.close()

    def validate(it: int) -> float:
        """ref utils/train.py:97-124 and train_diffusion_decomp.py:212-260;
        results are read back VAL_WINDOW calls behind the dispatches."""
        tape = ValidationLossTape()
        pred_v, true_v, pred_b, true_b = [], [], [], []
        window: deque = deque()

        def drain_one():
            batch, (metrics, v_recon, b_recon) = window.popleft()
            tape.update(metrics, weight=1)
            lm = batch.ligand_mask
            pred_v.append(v_recon[lm].cpu().numpy())
            true_v.append(batch.ligand_v[lm].cpu().numpy())
            if b_recon is not None:
                bm = batch.bond_mask
                pred_b.append(b_recon[bm].cpu().numpy())
                true_b.append(batch.bond_type[bm].cpu().numpy())

        for bi, batch in enumerate(val_batch_stream()):
            for t in val_steps:
                # fresh draws per (batch, t), as the reference draws from
                # its global generator per call (ref :223-250)
                g = torch.Generator(device=device).manual_seed(
                    draw_seed(it, bi, int(t)))
                window.append((batch, eval_step(batch, int(t), g)))
                summary['eval_shapes'].append(batch_shape(batch))
                if len(window) > VAL_WINDOW:
                    drain_one()
        while window:
            drain_one()
        # every rank validates the whole split; rank 0's loss moves every
        # rank's scheduler
        losses_v = broadcast_object(tape.averages(), mesh)
        atom_auroc = get_auroc(np.concatenate(true_v), np.concatenate(pred_v))
        bond_auroc = (get_bond_auroc(np.concatenate(true_b),
                                     np.concatenate(pred_b))
                      if pred_b else 0.0)
        logger.info(f'[val {it}] ' + ' '.join(
            f'{k}={v:.4f}' for k, v in losses_v.items())
            + f' atom_auroc={atom_auroc:.4f} bond_auroc={bond_auroc:.4f}')
        record = {**losses_v, 'atom_auroc': atom_auroc,
                  'bond_auroc': bond_auroc}
        metrics_logger.log(it, 'val', record)
        summary['val'].append({'iteration': it, **record})
        return losses_v['loss']

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    saver = _AsyncSaver()
    waited = 0.0

    def next_batch():
        nonlocal waited
        t0 = time.perf_counter()
        batch = next(train_iter)
        waited += time.perf_counter() - t0
        summary['batch_shapes'].append(batch_shape(batch))
        return shard_batch(batch, mesh) if sharded else batch

    # the trace window starts from this run's start, so that a resumed run
    # (start_iter > 10) traces too
    profile_start = max(10, start_iter + 1)
    trace_dir = os.path.join(log_dir, 'profile')
    prof = None
    try:
        for it in range(start_iter, max_iters + 1):
            if args.profile_steps and it == profile_start and lead:
                prof = start_trace()
            t_start, waited = time.perf_counter(), 0.0
            comm_start = comm_seconds(mesh)
            n_shapes = len(summary['batch_shapes'])
            try:
                if n_acc <= 1:
                    metrics = train_step(state, next_batch(), generator)
                else:
                    # n_acc micro-batches: gradients summed, one clip and
                    # update on their mean (ref :159-196); the metrics are
                    # the last micro-batch's, like the reference's
                    grads_sum, t_parts, pg_parts = None, [], []
                    for _ in range(n_acc):
                        g, metrics, t_u, pg = grad_step(state, next_batch(),
                                                        generator)
                        grads_sum = g if grads_sum is None else {
                            k: grads_sum[k] + v for k, v in g.items()}
                        t_parts.append(t_u)
                        pg_parts.append(pg)
                    metrics['grad_norm'] = apply_grads(
                        state, grads_sum, torch.cat(t_parts),
                        torch.cat(pg_parts), metrics)
                    del grads_sum, g, t_parts, pg_parts
                sync()
            except torch.cuda.OutOfMemoryError:
                if mesh.distributed:
                    raise
                # ref train_diffusion_decomp.py:202-210: drop the step and
                # go on with the next batch
                logger.warning('| WARNING: ran out of memory, skipping batch')
                metrics = grads_sum = g = t_parts = pg_parts = None
                for p in model.denoiser.parameters():
                    p.grad = None
                if cuda:
                    torch.cuda.empty_cache()
                del summary['batch_shapes'][n_shapes:]
                summary['oom_skips'] += 1
                continue
            elapsed = time.perf_counter() - t_start
            summary['step_seconds'].append(elapsed - waited)
            summary['comm_seconds'].append(comm_seconds(mesh) - comm_start)
            if not summary['iterations']:
                seconds['first_step'] = elapsed
            else:
                seconds['loader_wait'] += waited
                seconds['steps'] += elapsed - waited
            losses[0, it - start_iter] = metrics['loss']
            losses[1, it - start_iter] = metrics['grad_norm']
            summary['iterations'].append(it)
            summary['lr'].append(state.optimizer.lr)
            if prof is not None and it == profile_start + args.profile_steps:
                path = stop_trace(prof, trace_dir)
                logger.info(f'trace written to {path}')
                prof = None
            if it % args.report_freq == 0 or it == 1:
                values = {k: float(v) for k, v in metrics.items()}
                lr = state.optimizer.lr
                logger.info(f'[train {it}] ' + ' '.join(
                    f'{k}={v:.4f}' for k, v in values.items())
                    + f' lr={lr:.2e}')
                metrics_logger.log(it, 'train', {**values, 'lr': lr})
            if it % val_freq == 0 or it == max_iters:
                if train_loader.skip_counts:
                    logger.warning('loader skipped samples so far: '
                                   f'{dict(train_loader.skip_counts)}')
                t0 = time.perf_counter()
                val_loss = validate(it)
                lr = state.optimizer.lr
                new_lr = scheduler.step(val_loss, lr)
                if new_lr != lr:
                    set_learning_rate(state.optimizer, new_lr)
                    logger.info(f'lr reduced to {new_lr:.2e}')
                summary['val'][-1]['lr'] = new_lr
                t1 = time.perf_counter()
                seconds['validation'] += t1 - t0
                if best_loss is None or val_loss < best_loss:
                    best_loss, best_iter = val_loss, it
                    path = os.path.join(ckpt_dir, f'{it}.ckpt')
                    extra = {'best_loss': best_loss, 'best_iter': best_iter,
                             'torch_generator': {
                                 'device': device.type,
                                 'state': generator.get_state().numpy()}}
                    if lead:
                        saver.save(path, checkpoint_payload(
                            config.to_dict(), model, state,
                            scheduler.state_dict(), it, extra))
                    summary['checkpoints'].append(path)
                    logger.info(f'[val] best val loss {val_loss:.6f}, '
                                f'saving {path} (async)')
                else:
                    logger.info(f'[val] not improved; best {best_loss:.6f} '
                                f'at iter {best_iter}')
                barrier(mesh)
                seconds['checkpoint'] += time.perf_counter() - t1
    except KeyboardInterrupt:
        logger.info('Terminating...')
    finally:
        if prof is not None:
            # the window outlasted the run (or an error cut it): keep what
            # was captured
            try:
                path = stop_trace(prof, trace_dir)
                logger.info(f'trace written to {path}')
            except Exception:
                logger.exception('failed to stop the profiler trace')
        train_loader.close()
        metrics_logger.close()
        t0 = time.perf_counter()
        if sys.exc_info()[1] is not None:
            # an exception is already propagating: a failed save must not
            # replace it
            try:
                saver.join()
            except Exception:
                logger.exception(
                    'async checkpoint save also failed during shutdown')
        else:
            saver.join()
            # every written checkpoint is on disk before any rank returns
            barrier(mesh)
        seconds['checkpoint'] += time.perf_counter() - t0

    done = torch.tensor([i - start_iter for i in summary['iterations']],
                        dtype=torch.long)
    summary['train_loss'], summary['grad_norm'] = (
        losses.cpu()[:, done].tolist())
    summary['scheduler'] = scheduler.state_dict()
    summary['seconds'] = seconds
    summary['max_memory_allocated'] = (
        torch.cuda.max_memory_allocated(device) if cuda else None)
    summary.update(world_size=mesh.world_size, backend=mesh.backend,
                   sharded=sharded, ranks=gather_objects({
                       'rank': mesh.rank,
                       'rows': batch_size // W if sharded else batch_size,
                       'step_seconds': summary['step_seconds'],
                       'comm_seconds': summary['comm_seconds'],
                       'launches': launches_since(counts0),
                       'comm': comm_since(mesh, comm0)}, mesh))
    return summary


class _NoMetrics:
    """The metrics log of a rank other than 0: nothing is written."""

    def log(self, step, tag, values):
        pass

    def close(self):
        pass
