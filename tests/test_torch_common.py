"""The port's fixtures, feature blocks, kNN graphs and diffusion processes
against the JAX package, on the same numpy inputs.

Tolerance rtol 1e-5 / atol 1e-6: both sides compute the same float32
formulas, and only the order of a few reductions differs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from decompdiff_tpu.data.batch import make_bond_mask as jax_make_bond_mask
from decompdiff_tpu.diffusion import categorical as jcat
from decompdiff_tpu.diffusion.gaussian import GaussianDiffusion as JGauss
from decompdiff_tpu.models import common as jcommon
from decompdiff_tpu.models.diffusion_model import _AttrView
from decompdiff_tpu.ops import knn as jknn
from decompdiff_tpu.utils.testing import (
    random_complex_batch as jax_random_complex_batch, tiny_model_config)
from decompdiff_tpu_torch.constants import BOND_TYPES_PROB
from decompdiff_tpu_torch.data.batch import make_bond_mask
from decompdiff_tpu_torch.diffusion import categorical as tcat
from decompdiff_tpu_torch.diffusion.gaussian import GaussianDiffusion
from decompdiff_tpu_torch.models import common as tcommon
from decompdiff_tpu_torch.ops import knn as tknn
from decompdiff_tpu_torch.utils.params import load_flax_params
from decompdiff_tpu_torch.utils.testing import random_complex_batch

torch.set_num_threads(2)
TOL = dict(rtol=1e-5, atol=1e-6)


def close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got.detach() if torch.is_tensor(got)
                                          else got),
                               np.asarray(want), **(tol or TOL))


@pytest.mark.parametrize('kw', [
    {}, {'batch_size': 3, 'num_protein': 17, 'num_ligand': 9,
         'num_groups': 6, 'real_protein': 12, 'real_ligand': 7}])
def test_random_complex_batch_is_bit_identical(kw):
    jb = jax_random_complex_batch(np.random.default_rng(5), **kw)
    tb = random_complex_batch(np.random.default_rng(5), device='cpu', **kw)
    for name in ('protein_pos', 'protein_feat', 'protein_mask', 'ligand_pos',
                 'ligand_v', 'ligand_aux', 'ligand_mask', 'ligand_decomp_idx',
                 'bond_type', 'bond_mask', 'prior_centers', 'prior_stds',
                 'prior_num_atoms', 'prior_mask', 'num_arms'):
        np.testing.assert_array_equal(getattr(tb, name).numpy(),
                                      np.asarray(getattr(jb, name)), name)
    close(tb.atom_prior_centers(), jb.atom_prior_centers(), rtol=0, atol=0)
    close(tb.atom_prior_stds(), jb.atom_prior_stds(), rtol=0, atol=0)
    np.testing.assert_array_equal(tb.update_mask().numpy(),
                                  np.asarray(jb.update_mask()))
    upd = np.random.default_rng(1).random(tb.ligand_mask.shape) < 0.5
    np.testing.assert_array_equal(
        tb.replace(ligand_update_mask=torch.as_tensor(upd)).update_mask(),
        np.asarray(jb.replace(ligand_update_mask=jnp.asarray(upd))
                   .update_mask()))
    assert tb.to('cpu').batch_size == jb.batch_size


def test_make_bond_mask():
    m = np.random.default_rng(0).random((3, 7)) < 0.7
    np.testing.assert_array_equal(make_bond_mask(m), jax_make_bond_mask(m))


def test_feature_blocks():
    rng = np.random.default_rng(0)
    d = np.abs(rng.normal(size=(4, 5)) * 4).astype(np.float32)
    a = rng.normal(size=(4, 5, 3)).astype(np.float32)
    b = rng.normal(size=(4, 5, 7)).astype(np.float32)
    x = rng.normal(size=(4, 5, 3)).astype(np.float32)
    x[0, 0] = 0.0
    td, ta, tb, tx = map(torch.as_tensor, (d, a, b, x))
    close(tcommon.fixed_rbf(td), jcommon.fixed_rbf(d))
    close(tcommon.linspace_rbf(td, 0.0, 5.0, 20),
          jcommon.linspace_rbf(d, 0.0, 5.0, 20))
    close(tcommon.angular_encoding(td), jcommon.angular_encoding(d))
    close(tcommon.outer_product(ta, tb), jcommon.outer_product(a, b))
    close(tcommon.shifted_softplus(ta), jcommon.shifted_softplus(a))
    close(tcommon.safe_norm(tx), jcommon.safe_norm(x))
    logits = rng.normal(size=(4, 5, 6)).astype(np.float32)
    mask = rng.random((4, 5, 6)) < 0.5
    mask[0, 0] = False                                  # fully-masked row
    got = tcommon.masked_softmax(torch.as_tensor(logits),
                                 torch.as_tensor(mask), dim=-1)
    close(got, jcommon.masked_softmax(logits, mask, axis=-1))
    assert float(got[0, 0].abs().sum()) == 0.0


def test_mlp_matches_flax():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(3, 4, 16)).astype(np.float32)
    jm = jcommon.MLP(5, 24, num_layer=3)
    params = jm.init(jax.random.PRNGKey(0), x)
    tm = tcommon.MLP(16, 5, 24, num_layer=3)
    load_flax_params(tm, jax.tree.map(np.asarray, params))
    close(tm(torch.as_tensor(x)), jm.apply(params, x))


def _tie_free_points(rng, B, N):
    # distinct pairwise distances with probability 1
    return (rng.normal(size=(B, N, 3)) * 3).astype(np.float32)


def test_knn_matches_jax():
    rng = np.random.default_rng(3)
    B, N, K = 2, 19, 6
    pos = _tie_free_points(rng, B, N)
    mask = np.ones((B, N), bool)
    mask[0, 15:] = False
    idx, m, d2 = tknn.knn_neighbors(torch.as_tensor(pos),
                                    torch.as_tensor(mask), K)
    jidx, jm, jd2 = jknn.knn_neighbors(pos, mask, K, return_d2=True)
    np.testing.assert_array_equal(m.numpy(), np.asarray(jm))
    valid = np.asarray(jm)
    np.testing.assert_array_equal(idx.numpy()[valid], np.asarray(jidx)[valid])
    close(d2.numpy()[valid], np.asarray(jd2)[valid])
    close(tknn.pairwise_sqdist(torch.as_tensor(pos), torch.as_tensor(pos)),
          jknn.pairwise_sqdist(pos, pos))


def test_hybrid_neighbors_matches_jax():
    rng = np.random.default_rng(4)
    B, Np, Nl, K = 2, 11, 6, 4
    pos = _tie_free_points(rng, B, Np + Nl)
    mask = np.ones((B, Np + Nl), bool)
    mask[1, Np + 4:] = False
    mask_lig = (np.arange(Np + Nl)[None] >= Np) & mask
    got = tknn.hybrid_neighbors(torch.as_tensor(pos), torch.as_tensor(mask),
                                torch.as_tensor(mask_lig), K, Np)
    want = jknn.hybrid_neighbors(pos, mask, mask_lig, K, Np, return_d2=True)
    valid = np.asarray(want[1])
    np.testing.assert_array_equal(got[1].numpy(), valid)
    np.testing.assert_array_equal(got[0].numpy()[valid],
                                  np.asarray(want[0])[valid])
    close(got[2].numpy()[valid], np.asarray(want[2])[valid])


def _gaussians():
    cfg = tiny_model_config()
    return GaussianDiffusion.create(cfg, 'cpu'), JGauss.create(_AttrView(cfg))


def test_gaussian_tables_and_posteriors():
    tg, jg = _gaussians()
    for f in ('betas', 'alphas_cumprod', 'posterior_logvar', 'pos_score_coef',
              'posterior_mean_c0_coef', 'one_minus_alphas_cumprod'):
        close(getattr(tg, f), getattr(jg, f), rtol=0, atol=0)
    rng = np.random.default_rng(6)
    x0, xt, eps, c, s = (rng.normal(size=(3, 5, 3)).astype(np.float32)
                         for _ in range(5))
    s = np.abs(s) + 0.5
    t = np.array([49, 10, 1])
    sk = np.array([30, 9, -1])
    T = lambda a: torch.as_tensor(a)  # noqa: E731
    close(tg.q_sample(T(x0), T(t), T(eps), T(c), T(s)),
          jg.q_sample(x0, t, eps, c, s))
    close(tg.predict_x0_from_eps(T(xt), T(eps), T(t)),
          jg.predict_x0_from_eps(xt, eps, t))
    close(tg.q_posterior_mean(T(x0), T(xt), T(t)),
          jg.q_posterior_mean(x0, xt, t))
    close(tg.q_posterior_mean_skip(T(x0), T(xt), T(t), T(sk)),
          jg.q_posterior_mean_skip(x0, xt, t, sk))
    close(tg.posterior_logvar_skip(T(t), T(sk), 3),
          jg.posterior_logvar_skip(t, sk, 3))


@pytest.mark.parametrize('prior', [None, 'bond'])
def test_categorical_posteriors(prior):
    K = 5
    probs = BOND_TYPES_PROB if prior else None
    tc = tcat.CategoricalDiffusion.create('cosine', 50, 0.01, K, probs, 'cpu')
    jc = jcat.CategoricalDiffusion.create('cosine', 50, 0.01, K, probs)
    close(tc.log_alphas_cumprod, jc.log_alphas_cumprod, rtol=0, atol=0)
    close(tc.prior_logprobs, jc.prior_logprobs, rtol=0, atol=0)
    rng = np.random.default_rng(7)
    v0 = rng.integers(0, K, size=(3, 6))
    vt = rng.integers(0, K, size=(3, 6))
    logits = rng.normal(size=(3, 6, K)).astype(np.float32)
    log_v0 = jax.nn.log_softmax(logits, axis=-1)
    t = np.array([49, 12, 0])
    s = np.array([40, 11, -1])
    tlv0 = torch.as_tensor(np.array(log_v0))
    tlvt = tcat.index_to_log_onehot(torch.as_tensor(vt), K)
    jlvt = jcat.index_to_log_onehot(vt, K)
    close(tlvt, jlvt, rtol=0, atol=0)
    close(tc.q_v_pred(tlv0, torch.as_tensor(t)), jc.q_v_pred(log_v0, t))
    close(tc.q_v_posterior(tlv0, tlvt, torch.as_tensor(t)),
          jc.q_v_posterior(log_v0, jlvt, t))
    close(tc.q_v_posterior_skip(tlv0, tlvt, torch.as_tensor(t),
                                torch.as_tensor(s)),
          jc.q_v_posterior_skip(log_v0, jlvt, t, s))
    u = rng.random((3, 6, K)).astype(np.float32)
    np.testing.assert_array_equal(
        tcat.gumbel_argmax(torch.as_tensor(u), torch.as_tensor(logits)).numpy(),
        np.asarray(jnp.argmax(-jnp.log(-jnp.log(u + 1e-30) + 1e-30) + logits,
                              axis=-1)))
    draws = tc.sample_terminal((4, 7), torch.Generator().manual_seed(0))
    assert draws.shape == (4, 7) and int(draws.max()) < K
