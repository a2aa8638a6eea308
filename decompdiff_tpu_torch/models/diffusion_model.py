"""Top-level diffusion model: transitions + denoiser + training loss (port
of decompdiff_tpu/models/diffusion_model.py; ref DecompScorePosNet3D,
models/decompdiff.py:75-550):

  * symmetric or importance time sampling (ref :374-396)
  * decomposed-prior forward perturbation (ref :437-457)
  * protein-centroid centering (ref :20-32,459-462)
  * sigma^2-normalized positional MSE + categorical KL losses (ref :487-550)

All loss terms are masked per-graph means over padded tensors. Randomness
comes from an explicit torch.Generator on the model's device. Given a
data-parallel mesh (parallel/mesh.py) and this rank's rows of a batch,
every draw is made at the global batch's size and this rank's rows kept,
so that W ranks draw what one process draws for the whole batch (the
symmetric sampler pairs t with T - 1 - t across the global batch).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

from decompdiff_tpu_torch.constants import (
    ATOM_TYPES_PROB_BASIC, BOND_TYPES_PROB, PROTEIN_FEATURE_DIM)
from decompdiff_tpu_torch.data.batch import ComplexBatch
from decompdiff_tpu_torch.device import DeviceLike, resolve_device
from decompdiff_tpu_torch.diffusion.categorical import (
    CategoricalDiffusion, categorical_kl, index_to_log_onehot,
    log_categorical)
from decompdiff_tpu_torch.diffusion.gaussian import GaussianDiffusion
from decompdiff_tpu_torch.models.denoiser import DecompDenoiser
from decompdiff_tpu_torch.parallel.mesh import Mesh, draw_rows, take_rows
from decompdiff_tpu_torch.utils.params import init_params_


def masked_mean(x: torch.Tensor, mask: torch.Tensor, dim) -> torch.Tensor:
    m = mask.to(x.dtype)
    return (x * m).sum(dim) / torch.clamp(m.sum(dim), min=1.0)


def rowwise_sum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """x summed over `dim` by pairwise halving (elementwise adds, after
    zero padding to a power of two), so that each sum depends on its own
    row alone: a data-parallel rank's rows sum as they do in the whole
    batch. The order of a CUDA reduction can change with the number of
    rows it reduces, which moves a sampling trajectory."""
    dim = dim % x.ndim
    n = x.shape[dim]
    size = 1 << max(0, (n - 1).bit_length())
    if size != n:
        x = F.pad(x, [0, 0] * (x.ndim - dim - 1) + [0, size - n])
    while x.shape[dim] > 1:
        half = x.shape[dim] // 2
        x = x.narrow(dim, 0, half) + x.narrow(dim, half, half)
    return x.squeeze(dim)


def center_by_protein(batch: ComplexBatch, ligand_pos, mode: str = 'protein'):
    """Translate each complex to its protein centroid; returns (centered
    protein pos, centered ligand pos, offset [B, 3])
    (ref models/decompdiff.py:20-32, mode 'protein' or 'none'). The
    centroid's sum is rowwise_sum's, the same in any batch."""
    if mode == 'none':
        return batch.protein_pos, ligand_pos, torch.zeros(
            (batch.batch_size, 3), dtype=batch.protein_pos.dtype,
            device=batch.device)
    if mode != 'protein':
        raise NotImplementedError(f'center_pos_mode={mode!r}')
    m = batch.protein_mask[..., None].to(batch.protein_pos.dtype)
    offset = rowwise_sum(batch.protein_pos * m, 1) / torch.clamp(
        m.sum(1), min=1.0)
    return (batch.protein_pos - offset[:, None, :],
            ligand_pos - offset[:, None, :], offset)


def sample_time_symmetric(num_graphs: int, num_timesteps: int,
                          generator: Optional[torch.Generator] = None,
                          device: DeviceLike = None,
                          mesh: Optional[Mesh] = None):
    """Antithetic t: a draw and its mirror T - 1 - t
    (ref models/decompdiff.py:387-393). Returns (t [B] long, p(t) [B]);
    with a mesh, num_graphs is this rank's and the pairs are the global
    batch's."""
    device = resolve_device(device)

    def draw(shape):
        n = shape[0]
        half = torch.randint(0, num_timesteps, (n // 2 + 1,),
                             generator=generator, device=device)
        return torch.cat([half, num_timesteps - half - 1])[:n]
    t = draw_rows(draw, (num_graphs,), mesh)
    return t, torch.full((num_graphs,), 1.0 / num_timesteps, device=device)


def sample_time(num_graphs: int, num_timesteps: int, method: str = 'symmetric',
                lt_history=None, lt_count=None,
                generator: Optional[torch.Generator] = None,
                device: DeviceLike = None, mesh: Optional[Mesh] = None):
    """Timestep sampling (ref models/decompdiff.py:374-396). 'importance'
    draws t with probability proportional to sqrt(E[L_t^2]) once every
    timestep has more than 10 recorded losses, and is symmetric before.
    With a mesh, num_graphs is this rank's (see sample_time_symmetric)."""
    if (method == 'symmetric' or lt_history is None or lt_count is None
            or not bool((lt_count > 10).all())):
        return sample_time_symmetric(num_graphs, num_timesteps, generator,
                                     device, mesh)
    if method != 'importance':
        raise ValueError(method)
    lt_sqrt = torch.sqrt(lt_history + 1e-10) + 1e-4
    lt_sqrt[0] = lt_sqrt[1]
    pt_all = lt_sqrt / lt_sqrt.sum()
    t = draw_rows(lambda shape: torch.multinomial(
        pt_all, shape[0], replacement=True, generator=generator),
        (num_graphs,), mesh)
    return t, pt_all[t]


@dataclasses.dataclass(frozen=True, eq=False)
class DecompDiffModel:
    """The denoiser module (which owns the parameters) with the diffusion
    processes, all on one device."""
    denoiser: DecompDenoiser
    pos_diff: GaussianDiffusion
    atom_diff: CategoricalDiffusion
    bond_diff: CategoricalDiffusion
    config: dict
    device: torch.device

    @classmethod
    def create(cls, config, num_classes: int,
               num_bond_classes: Optional[int] = None, *,
               device: DeviceLike = None, seed: int = 0,
               protein_feat_dim: int = PROTEIN_FEATURE_DIM + 2,
               ligand_aux_dim: int = 2) -> "DecompDiffModel":
        """Build the model on `device` (CUDA unless given) with parameters
        drawn from `seed` in the flax initializers' distributions; load
        trained or JAX parameters with utils.params.load_flax_params.
        The parameters take gradients (training); the sampler runs the
        denoiser under torch.no_grad."""
        device = resolve_device(device)
        cfg = dict(config)
        num_bond_classes = num_bond_classes or cfg.get('num_bond_classes', 5)
        # the reference has atom marginals only for the 8-class 'basic'
        # vocabulary (ref utils/transforms.py:141-145)
        prior_atom = (ATOM_TYPES_PROB_BASIC
                      if cfg.get('prior_types', False)
                      and num_classes == len(ATOM_TYPES_PROB_BASIC) else None)
        prior_bond = BOND_TYPES_PROB if cfg.get('prior_types', False) else None
        denoiser = DecompDenoiser(cfg, num_classes, num_bond_classes,
                                  protein_feat_dim, ligand_aux_dim)
        init_params_(denoiser, torch.Generator().manual_seed(seed))
        denoiser.to(device).eval()
        T, s = cfg['num_diffusion_timesteps'], cfg.get('v_beta_s', 0.01)
        return cls(
            denoiser=denoiser,
            pos_diff=GaussianDiffusion.create(cfg, device),
            atom_diff=CategoricalDiffusion.create(
                cfg['v_beta_schedule'], T, s, num_classes, prior_atom, device),
            bond_diff=CategoricalDiffusion.create(
                cfg['v_beta_schedule'], T, s, num_bond_classes, prior_bond,
                device),
            config=cfg,
            device=device,
        )

    @property
    def num_timesteps(self) -> int:
        return self.config['num_diffusion_timesteps']

    @property
    def bond_diffusion(self) -> bool:
        return bool(self.config.get('bond_diffusion', False))

    def apply(self, batch: ComplexBatch, ligand_pos, ligand_v, bond_type,
              time_step):
        return self.denoiser(batch, ligand_pos, ligand_v, bond_type,
                             time_step)

    # ------------------------------------------------------------------
    def get_diffusion_loss(self, batch: ComplexBatch,
                           generator: Optional[torch.Generator] = None,
                           time_step: Optional[torch.Tensor] = None,
                           noise_override: Optional[dict] = None,
                           mesh: Optional[Mesh] = None) -> dict:
        """Training losses (ref models/decompdiff.py:419-550).

        Draws, in order and from `generator` (on the model's device): t
        (unless given), the position noise, the atom-type and the bond-type
        uniforms. `noise_override` replaces the last three with
        'pos_noise' [B, Nl, 3], 'v_perturbed' [B, Nl] and, with bond
        diffusion, 'b_perturbed' [B, Nl, Nl] (tests).

        With a data-parallel `mesh`, `batch` and `time_step` are this
        rank's rows; every draw, and `noise_override`, is the global
        batch's, of which this rank keeps its rows (parallel/mesh.py).

        Returns a dict: 'losses' {pos, v[, bond]}, 'time_step',
        'per_graph_pos_loss' [B], the predictions and the softmaxed type
        reconstructions.
        """
        B = batch.batch_size
        if time_step is None:
            time_step, _ = sample_time_symmetric(B, self.num_timesteps,
                                                 generator, self.device,
                                                 mesh)
        time_step = time_step.long()
        over = {k: take_rows(v, mesh)
                for k, v in (noise_override or {}).items()}

        # perturb pos / v / bond (ref :437-457)
        centers, stds = batch.atom_prior_centers(), batch.atom_prior_stds()
        pos_noise = over.get('pos_noise')
        if pos_noise is None:
            pos_noise = draw_rows(lambda shape: torch.randn(
                shape, generator=generator, device=self.device),
                batch.ligand_pos.shape, mesh)
        ligand_pos_perturbed = self.pos_diff.q_sample(
            batch.ligand_pos, time_step, pos_noise, centers, stds)

        log_v0 = index_to_log_onehot(batch.ligand_v, self.atom_diff.num_classes)
        if 'v_perturbed' in over:
            v_perturbed = over['v_perturbed']
            log_vt = index_to_log_onehot(v_perturbed,
                                         self.atom_diff.num_classes)
        else:
            v_perturbed, log_vt = self.atom_diff.q_v_sample(
                log_v0, time_step, generator, mesh)
        # keep padded atoms harmless
        v_perturbed = torch.where(batch.ligand_mask, v_perturbed, 0)

        if self.bond_diffusion:
            nb = self.bond_diff.num_classes
            log_b0 = index_to_log_onehot(batch.bond_type, nb)
            if 'b_perturbed' in over:
                b_perturbed = over['b_perturbed']
                log_bt = index_to_log_onehot(b_perturbed, nb)
            else:
                b_perturbed, log_bt = self.bond_diff.q_v_sample(
                    log_b0, time_step, generator, mesh)
            b_perturbed = torch.where(batch.bond_mask, b_perturbed, 0)
        else:
            b_perturbed = batch.bond_type

        # center and forward (ref :459-485)
        protein_pos_c, ligand_pos_perturbed_c, offset = center_by_protein(
            batch, ligand_pos_perturbed,
            self.config.get('center_pos_mode', 'protein'))
        ligand_pos_c = batch.ligand_pos - offset[:, None, :]
        batch_c = batch.replace(
            protein_pos=protein_pos_c,
            prior_centers=batch.prior_centers - offset[:, None, :])
        preds = self.apply(batch_c, ligand_pos_perturbed_c, v_perturbed,
                           b_perturbed, time_step)
        pred_pos, pred_v = preds['pred_ligand_pos'], preds['pred_ligand_v']

        # positions: sigma^2-normalized MSE (C0 parameterization; ref :522-531)
        if self.config.get('model_mean_type', 'C0') == 'C0':
            target = ligand_pos_c
        else:  # 'noise'
            target = pos_noise
            pred_pos = pred_pos - ligand_pos_perturbed_c
        per_graph_pos = self.pos_diff.pos_mse_per_graph(
            pred_pos, target, stds, batch.ligand_mask)

        # atom types: categorical KL (ref :501-509)
        log_v_recon = F.log_softmax(pred_v, dim=-1)
        log_v_model = self.atom_diff.q_v_posterior(log_v_recon, log_vt,
                                                   time_step)
        log_v_true = self.atom_diff.q_v_posterior(log_v0, log_vt, time_step)
        losses = {'pos': per_graph_pos.mean(),
                  'v': self._compute_v_lt(log_v_model, log_v0, log_v_true,
                                          time_step, batch.ligand_mask)}
        out = {
            'losses': losses,
            'pred_ligand_pos': pred_pos,
            'pred_ligand_v': pred_v,
            'ligand_v_recon': F.softmax(pred_v, dim=-1),
            'time_step': time_step,
            'per_graph_pos_loss': per_graph_pos,
        }
        if self.bond_diffusion:
            log_b_recon = F.log_softmax(preds['pred_bond'], dim=-1)
            log_b_model = self.bond_diff.q_v_posterior(log_b_recon, log_bt,
                                                       time_step)
            log_b_true = self.bond_diff.q_v_posterior(log_b0, log_bt,
                                                      time_step)
            losses['bond'] = self._compute_v_lt(
                log_b_model, log_b0, log_b_true, time_step, batch.bond_mask)
            out['ligand_b_recon'] = F.softmax(preds['pred_bond'], dim=-1)
        return out

    @staticmethod
    def _compute_v_lt(log_model, log_v0, log_true, t, mask):
        """Per-graph masked mean of the KL (or of the decoder NLL at t=0),
        then the mean over graphs (ref models/decompdiff.py:411-417); mask
        is [B, N] or [B, N, N]."""
        kl = categorical_kl(log_true, log_model)
        nll = -log_categorical(log_v0, log_model)
        t0 = (t == 0).to(kl.dtype).reshape(t.shape + (1,) * (kl.ndim - 1))
        per_elem = t0 * nll + (1.0 - t0) * kl
        per_graph = masked_mean(per_elem, mask, tuple(range(1, kl.ndim)))
        return per_graph.mean()
