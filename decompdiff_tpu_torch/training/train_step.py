"""The training step (port of decompdiff_tpu/training/train_step.py).

Protocol parity with ref scripts/train_diffusion_decomp.py:155-210 and
utils/train.py:34-56:
  * protein position jitter (pos_noise_std) and prior-center jitter
    (prior_noise_std) per step (ref :160-164)
  * global-norm gradient clipping at 8.0 (ref :195), then Adam(b1=0.95,
    b2=0.999), lr 5e-4 (ref configs/training.yml:75-80)
  * weighted loss sum pos*1 + v*100 + bond*100 (ref utils/train.py:58-70)
  * plateau LR scheduler on validation loss (factor 0.6, patience 10,
    min_lr 1e-6; ref utils/train.py:46-56)
  * symmetric or importance time sampling, with a rolling Lt history

The state is mutable: a step updates the model's parameters in place. All
randomness comes from the torch.Generator a caller passes, on the model's
device.

Data parallel (make_train_fns' `mesh`, parallel/mesh.py): a step takes
this rank's rows of the global batch and draws as one process draws for
the whole batch. Gradients come from torch.autograd.grad, so the
gradient all-reduce is explicit: the mean over ranks of each rank's
gradient, which is the gradient of the global loss because every loss
term is a mean over graphs of per-graph means and the shards are equal.
train_step reduces before the clip, apply_grads once per optimizer step
after the n_acc_batch micro-gradients are summed; the losses to log ride
in the same bucket, so they are the global means. t and the per-graph
losses reach lt_update all-gathered in global row order (one gather a
grad_step), so the Lt buffers are the same on every rank and equal a
world of one's.

Gradients are dicts {parameter name: tensor} in the order of
`denoiser.named_parameters()`; utils.params.state_dict_to_flax turns one
into the JAX package's layout.

Spans (utils/profiling.py): `train.step` (train_step, apply_grads; it
carries state.step), `train.loss` (jitter and the loss), `train.backward`
(torch.autograd.grad), `train.optimizer` (global norm, clip, Adam, the Lt
history) and, under a mesh, `train.reduce` (the collectives).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from decompdiff_tpu_torch.data.batch import ComplexBatch
from decompdiff_tpu_torch.models.diffusion_model import (
    DecompDiffModel, sample_time)
from decompdiff_tpu_torch.parallel.mesh import (
    Mesh, all_gather_rows, all_reduce_mean, draw_rows)
from decompdiff_tpu_torch.utils.profiling import span

Grads = Dict[str, torch.Tensor]
DEFAULT_LOSS_WEIGHTS = {'pos': 1.0, 'v': 100.0, 'bond': 100.0}
# the released `train` section (ref configs/training.yml)
DEFAULT_TRAIN_CONFIG = {
    'loss_weights': DEFAULT_LOSS_WEIGHTS,
    'n_acc_batch': 1,
    'pos_noise_std': 0.1,
    'prior_noise_std': 0.5,
    'max_grad_norm': 8.0,
    'optimizer': {'type': 'adam', 'lr': 5e-4, 'weight_decay': 0.0,
                  'beta1': 0.95, 'beta2': 0.999},
}
LT_DECAY = 0.9   # of the rolling Lt history


def global_norm(grads: Grads) -> torch.Tensor:
    """sqrt of the sum of squares of every gradient (optax.global_norm)."""
    return torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))


class Optimizer:
    """Global-norm clipping, then torch Adam (ref utils/train.py:34-43).

    The clip is optax's clip_by_global_norm rule: gradients pass unchanged
    below max_grad_norm and are scaled to (g / norm) * max_grad_norm at or
    above it (not torch's clip_grad_norm_, which adds 1e-6 to the norm).
    torch Adam's weight_decay is L2 added to the clipped gradient before the
    moments, like optax's add_decayed_weights placed before adam.
    """

    def __init__(self, params: Dict[str, torch.nn.Parameter], optimizer_cfg,
                 max_grad_norm: float = 8.0):
        opt_type = optimizer_cfg.get('type', 'adam')
        if opt_type != 'adam':
            raise NotImplementedError(f'Optimizer not supported: {opt_type}')
        self.params = dict(params)
        self.max_grad_norm = float(max_grad_norm)
        self.adam = torch.optim.Adam(
            list(self.params.values()), lr=optimizer_cfg.get('lr', 5e-4),
            betas=(optimizer_cfg.get('beta1', 0.95),
                   optimizer_cfg.get('beta2', 0.999)),
            eps=1e-8, weight_decay=float(optimizer_cfg.get('weight_decay', 0.0)))

    def step(self, grads: Grads) -> None:
        """Clip `grads` by their global norm and take one Adam step."""
        norm = global_norm(grads)
        clip = norm >= self.max_grad_norm
        for name, p in self.params.items():
            g = grads[name]
            p.grad = torch.where(clip, g / norm * self.max_grad_norm, g)
        self.adam.step()
        for p in self.params.values():
            p.grad = None

    @property
    def lr(self) -> float:
        return float(self.adam.param_groups[0]['lr'])

    @lr.setter
    def lr(self, value: float) -> None:
        for group in self.adam.param_groups:
            group['lr'] = float(value)


def make_optimizer(model: DecompDiffModel, optimizer_cfg,
                   max_grad_norm: float = 8.0) -> Optimizer:
    return Optimizer(dict(model.denoiser.named_parameters()), optimizer_cfg,
                     max_grad_norm)


def get_learning_rate(optimizer: Optimizer) -> float:
    return optimizer.lr


def set_learning_rate(optimizer: Optimizer, lr: float) -> None:
    optimizer.lr = lr


@dataclasses.dataclass
class TrainState:
    """The optimizer (over the model's parameters, which a step updates in
    place), the step count and the importance-sampling buffers: a rolling
    E[L_t^2] per timestep and the number of losses recorded there (ref
    models/decompdiff.py:146-147 registers them; here the step maintains
    them)."""
    optimizer: Optimizer
    step: int
    lt_history: torch.Tensor    # [T]
    lt_count: torch.Tensor      # [T]


def create_train_state(model: DecompDiffModel, train_cfg) -> TrainState:
    opt = make_optimizer(model, train_cfg.get('optimizer', {}),
                         train_cfg.get('max_grad_norm', 8.0))
    T = model.num_timesteps
    return TrainState(optimizer=opt, step=0,
                      lt_history=torch.zeros(T, device=model.device),
                      lt_count=torch.zeros(T, device=model.device))


def weighted_loss(losses: dict, weights: dict) -> torch.Tensor:
    """ref utils/train.py:58-70."""
    total = 0.0
    for k, v in losses.items():
        total = total + float(weights.get(k, 1.0)) * v
    return total


def lt_update(state: TrainState, t_used: torch.Tensor,
              per_graph: torch.Tensor) -> None:
    """Rolling EMA of the squared per-graph pos loss at each drawn timestep
    (improved-DDPM importance scheme; the reference registers the buffers
    but never updates them, ref :506-507 commented out)."""
    T = state.lt_history.shape[0]
    sq = per_graph.detach() ** 2
    t = t_used.long()
    sums = torch.zeros(T, device=sq.device).index_add_(0, t, sq)
    cnts = torch.zeros(T, device=sq.device).index_add_(
        0, t, torch.ones_like(sq))
    step_mean = sums / torch.clamp(cnts, min=1.0)
    state.lt_history = torch.where(
        cnts > 0, LT_DECAY * state.lt_history + (1 - LT_DECAY) * step_mean,
        state.lt_history)
    state.lt_count = state.lt_count + cnts


def _gather_rows(t_used: torch.Tensor, per_graph: torch.Tensor,
                 mesh: Optional[Mesh]) -> tuple:
    """Every rank's t and per-graph losses in global row order, in one
    gather (t < 2**24 is exact in float32)."""
    if mesh is None or not mesh.distributed:
        return t_used, per_graph
    with span('train.reduce'):
        rows = all_gather_rows(
            torch.stack([t_used.to(per_graph.dtype), per_graph], -1), mesh)
    return rows[:, 0].to(t_used.dtype), rows[:, 1]


def make_train_fns(model: DecompDiffModel, train_cfg,
                   mesh: Optional[Mesh] = None):
    """Build (train_step, grad_step, apply_grads).

    `train_step(state, batch, generator)` is one fused step and returns the
    metrics (losses, 'loss', 'grad_norm'). `grad_step(state, batch,
    generator)` returns (grads, metrics, t_used, per_graph) without updating;
    `apply_grads(state, grads_sum, t_used, per_graph, metrics=None)`
    divides a sum over n_acc_batch micro-batches by n_acc_batch, clips,
    updates and returns the grad norm (ref
    scripts/train_diffusion_decomp.py:159-196: per-micro loss / n_acc, one
    clip and optimizer step on the accumulated gradients).

    With a `mesh` each batch is this rank's rows (parallel/mesh.py
    shard_batch): grad_step's grads and metrics are this rank's and its
    t_used / per_graph the global rows; train_step all-reduces the
    gradients and returns the global metrics, and apply_grads all-reduces
    the gradients and, given the metrics to report (the last micro-batch's
    grad_step metrics), replaces them in place by their global means.
    """
    loss_weights = dict(train_cfg.get('loss_weights', DEFAULT_LOSS_WEIGHTS))
    pos_noise_std = float(train_cfg.get('pos_noise_std', 0.1))
    prior_noise_std = float(train_cfg.get('prior_noise_std', 0.5))
    n_acc = int(train_cfg.get('n_acc_batch', 1))
    method = train_cfg.get('sample_time_method', 'symmetric')
    names = [n for n, _ in model.denoiser.named_parameters()]
    params = [p for _, p in model.denoiser.named_parameters()]

    # a world of one calls the loss as before the mesh existed
    loss_kw = {} if mesh is None else {'mesh': mesh}

    def grad_step(state: TrainState, batch: ComplexBatch,
                  generator: Optional[torch.Generator] = None):
        dev = model.device

        def randn(shape):
            return torch.randn(shape, generator=generator, device=dev)
        with span('train.loss'):
            # input jitter (ref scripts/train_diffusion_decomp.py:160-164)
            batch = batch.replace(
                protein_pos=batch.protein_pos + pos_noise_std * draw_rows(
                    randn, batch.protein_pos.shape, mesh),
                prior_centers=batch.prior_centers
                + prior_noise_std * draw_rows(
                    randn, batch.prior_centers.shape, mesh))
            time_step = None
            if method == 'importance':
                time_step, _ = sample_time(
                    batch.batch_size, model.num_timesteps, method,
                    state.lt_history, state.lt_count, generator, dev, mesh)
            out = model.get_diffusion_loss(batch, generator,
                                           time_step=time_step, **loss_kw)
            loss = weighted_loss(out['losses'], loss_weights)
        with span('train.backward'):
            grads = {n: torch.zeros_like(p) if g is None else g
                     for n, p, g in zip(names, params, torch.autograd.grad(
                         loss, params, allow_unused=True))}
        metrics = {f'loss_{k}': v.detach() for k, v in out['losses'].items()}
        metrics['loss'] = loss.detach()
        t_used, per_graph = _gather_rows(
            out['time_step'], out['per_graph_pos_loss'].detach(), mesh)
        return grads, metrics, t_used, per_graph

    def reduce(grads, metrics):
        """The means over ranks of a rank's gradients and metrics, in one
        all-reduce."""
        if mesh is None:
            return grads, metrics
        with span('train.reduce'):
            both = all_reduce_mean(
                {**grads, **{f'metric:{k}': v for k, v in metrics.items()}},
                mesh)
        return ({k: both[k] for k in grads},
                {k: both[f'metric:{k}'] for k in metrics})

    def _update(state, grads, t_used, per_graph):
        """The global norm to report, the clip, Adam and the Lt history."""
        with span('train.optimizer'):
            grad_norm = global_norm(grads)
            state.optimizer.step(grads)
            lt_update(state, t_used, per_graph)
        state.step += 1
        return grad_norm

    def train_step(state: TrainState, batch: ComplexBatch,
                   generator: Optional[torch.Generator] = None) -> dict:
        with span('train.step', step=state.step):
            grads, metrics, t_used, per_graph = grad_step(state, batch,
                                                          generator)
            grads, metrics = reduce(grads, metrics)
            metrics['grad_norm'] = _update(state, grads, t_used, per_graph)
        return metrics

    def apply_grads(state: TrainState, grads_sum: Grads,
                    t_used: torch.Tensor,
                    per_graph: torch.Tensor,
                    metrics: Optional[dict] = None) -> torch.Tensor:
        with span('train.step', step=state.step):
            grads_sum, reduced = reduce(grads_sum, metrics or {})
            if metrics is not None:
                metrics.update(reduced)
            grads = {k: g / n_acc for k, g in grads_sum.items()}
            return _update(state, grads, t_used, per_graph)

    return train_step, grad_step, apply_grads


def make_eval_step(model: DecompDiffModel, train_cfg):
    """Validation loss at a fixed timestep with unit prior stds
    (ref scripts/train_diffusion_decomp.py:212-260: prior_stds=ones).
    Returns eval_step(batch, time_value, generator) -> (metrics, v_recon,
    b_recon)."""
    loss_weights = dict(train_cfg.get('loss_weights', DEFAULT_LOSS_WEIGHTS))

    @torch.no_grad()
    def eval_step(batch: ComplexBatch, time_value: int,
                  generator: Optional[torch.Generator] = None):
        batch = batch.replace(prior_stds=torch.ones_like(batch.prior_stds))
        t = torch.full((batch.batch_size,), int(time_value),
                       dtype=torch.long, device=model.device)
        out = model.get_diffusion_loss(batch, generator, time_step=t)
        metrics = {f'loss_{k}': v for k, v in out['losses'].items()}
        metrics['loss'] = weighted_loss(out['losses'], loss_weights)
        return metrics, out['ligand_v_recon'], out.get('ligand_b_recon')

    return eval_step


class PlateauScheduler:
    """Host-side reduce-on-plateau (ref utils/train.py:46-56, torch's
    ReduceLROnPlateau defaults: mode 'min', relative threshold 1e-4): an
    improvement counts only when val < best * (1 - threshold)."""

    def __init__(self, factor=0.6, patience=10, min_lr=1e-6,
                 threshold=1e-4):
        self.factor = factor
        self.patience = patience
        self.min_lr = min_lr
        self.threshold = threshold
        self.best: Optional[float] = None
        self.num_bad = 0

    def _is_better(self, val_loss: float) -> bool:
        if self.best is None:
            return True
        return val_loss < self.best * (1.0 - self.threshold)

    def step(self, val_loss: float, current_lr: float) -> float:
        if self._is_better(val_loss):
            self.best = val_loss
            self.num_bad = 0
            return current_lr
        self.num_bad += 1
        if self.num_bad > self.patience:
            self.num_bad = 0
            return max(current_lr * self.factor, self.min_lr)
        return current_lr

    def state_dict(self):
        return {'best': self.best, 'num_bad': self.num_bad,
                'factor': self.factor, 'patience': self.patience,
                'min_lr': self.min_lr, 'threshold': self.threshold}

    def load_state_dict(self, d):
        self.best = d['best']
        self.num_bad = d['num_bad']
        self.factor = d.get('factor', self.factor)
        self.patience = d.get('patience', self.patience)
        self.min_lr = d.get('min_lr', self.min_lr)
        self.threshold = d.get('threshold', self.threshold)
