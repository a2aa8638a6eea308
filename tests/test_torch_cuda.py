"""The CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device and the CUDA toolkit (`nvcc`); without
a card each one skips with that reason. On a GPU machine run

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

(`--noconftest` because tests/conftest.py sets up JAX, which the port's
machine does not need). The shapes are small and ragged on purpose: K and
Nl are not multiples of the kernels' 16-source chunk, some rows are fully
masked, and the 6-edge-type variant runs, which the released-shape check in
chip_smoke.py does not cover.

Tolerance rtol 1e-3 / atol 1e-4: float32 on both sides, with other
summation orders and the device's expf/sincosf.
"""

import numpy as np
import pytest
import torch

from decompdiff_tpu_torch.models import uni_transformer_bond as tutb
from decompdiff_tpu_torch.models.diffusion_model import DecompDiffModel
from decompdiff_tpu_torch.ops import bond_attention as bond_ops
from decompdiff_tpu_torch.ops import edge_attention as edge_ops
from decompdiff_tpu_torch.ops import triplet_attention as triplet_ops
from decompdiff_tpu_torch.ops.knn import knn_neighbors
from decompdiff_tpu_torch.utils.testing import (
    random_complex_batch, tiny_model_config)

pytestmark = pytest.mark.cuda
TOL = dict(rtol=1e-3, atol=1e-4)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (the kernels have no CPU mode)')
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device('cuda')


def _randomize(module, seed):
    """Non-trivial values for every parameter (LayerNorm scales and biases
    included), so the kernels' use of each one is checked."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in module.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.3)
    return module.requires_grad_(False)


def _to(a, device):
    if torch.is_tensor(a):
        return a.to(device)
    if isinstance(a, tutb.EdgeGraph):
        return tutb.EdgeGraph(*(_to(t, device) for t in a))
    return a


def _compare(module, args, cuda, counter):
    """Plain version on the CPU against the kernel on the card."""
    want = module(*args)
    module.to(cuda)
    before = counter.launches
    got = module(*[_to(a, cuda) for a in args])
    torch.cuda.synchronize()
    assert counter.launches == before + 1
    torch.testing.assert_close(got.cpu(), want, **TOL)
    return got


def _graph(rng, B, N, K, Np, group):
    x = torch.as_tensor(rng.normal(size=(B, N, 3)) * 3, dtype=torch.float32)
    mask = torch.ones(B, N, dtype=torch.bool)
    mask[0, N - 5:] = False
    idx, nbr_mask, _ = knn_neighbors(x, mask, K)
    lig = ((torch.arange(N)[None] >= Np) & mask).float()
    grp = (torch.as_tensor(rng.integers(0, 3, size=(B, N)),
                           dtype=torch.float32) if group else None)
    graph = tutb.EdgeGraph(idx.int().contiguous(), nbr_mask.float(), lig, grp)
    e_w = torch.as_tensor(rng.random((B, N, K)), dtype=torch.float32)
    return x, graph, e_w


@pytest.mark.parametrize('H,heads', [(32, 4), (128, 16)])
@pytest.mark.parametrize('group', [False, True], ids=['4types', '6types'])
@pytest.mark.parametrize('pos_mode', [False, True], ids=['node', 'pos'])
def test_edge_kernel(cuda, pos_mode, group, H, heads):
    rng = np.random.default_rng(1)
    B, N, K, Np = 2, 37, 20, 25
    x, graph, e_w = _graph(rng, B, N, K, Np, group)
    h = torch.as_tensor(rng.normal(size=(B, N, H)), dtype=torch.float32)
    n_et = 6 if group else 4
    cls = tutb.PosEdgeAttention if pos_mode else tutb.NodeEdgeAttention
    kw = {} if pos_mode else {'out_fc': False}
    module = _randomize(cls(H, heads, n_et, use_kernels=True, **kw), 0)
    got = _compare(module, (h, x, graph, e_w), cuda, edge_ops.edge_attention)
    if not pos_mode:
        assert float(got[0, N - 5:].abs().max()) == 0.0


@pytest.mark.parametrize('pos_mode', [False, True], ids=['node', 'pos'])
def test_bond_kernel(cuda, pos_mode):
    rng = np.random.default_rng(2)
    B, Nl, H, heads = 2, 13, 64, 8
    h = torch.as_tensor(rng.normal(size=(B, Nl, H)), dtype=torch.float32)
    hb = torch.as_tensor(rng.normal(size=(B, Nl, Nl, H)), dtype=torch.float32)
    x = torch.as_tensor(rng.normal(size=(B, Nl, 3)) * 2, dtype=torch.float32)
    lm = torch.ones(B, Nl, dtype=torch.bool)
    lm[1, 9:] = False
    bm = (lm[:, :, None] & lm[:, None, :] & ~torch.eye(Nl, dtype=torch.bool)
          ).float()
    if pos_mode:
        module = _randomize(tutb.PosBondAttention(H, heads, use_kernels=True),
                            1)
        args = (h, x, hb, bm)
    else:
        module = _randomize(tutb.NodeBondAttention(
            H, heads, out_fc=False, use_kernels=True), 1)
        args = (h, hb, bm)
    _compare(module, args, cuda, bond_ops.bond_attention)


@pytest.mark.parametrize('include_h_node', [True, False])
def test_triplet_kernel(cuda, include_h_node):
    rng = np.random.default_rng(3)
    B, Nl, H, heads = 2, 13, 32, 4
    h = torch.as_tensor(rng.normal(size=(B, Nl, H)), dtype=torch.float32)
    hb = torch.as_tensor(rng.normal(size=(B, Nl, Nl, H)), dtype=torch.float32)
    x = torch.as_tensor(rng.normal(size=(B, Nl, 3)) * 2, dtype=torch.float32)
    bm = (torch.as_tensor(rng.random((B, Nl, Nl)) < 0.4)
          & ~torch.eye(Nl, dtype=torch.bool)).float()
    bm[0, 4] = 0.0                              # atom 4 of complex 0: no bonds
    module = _randomize(tutb.BondTripletAttention(
        H, heads, include_h_node=include_h_node, use_kernels=True), 2)
    got = _compare(module, (h, hb, x, bm), cuda,
                   triplet_ops.triplet_attention)
    assert float(got[0, 4].abs().max()) == 0.0


@pytest.mark.parametrize('extra', [{}, {'add_prior_node': True}],
                         ids=['released', 'prior_node'])
def test_tiny_denoiser_kernels_on_vs_off(cuda, extra):
    cfg = tiny_model_config(**extra)
    on = DecompDiffModel.create(dict(cfg, use_pallas=True), 8, device=cuda)
    off = DecompDiffModel.create(dict(cfg, use_pallas=False), 8, device=cuda)
    _randomize(on.denoiser, 4)
    off.denoiser.load_state_dict(on.denoiser.state_dict())
    batch = random_complex_batch(np.random.default_rng(0), num_ligand=11,
                                 real_ligand=9, device=cuda)
    t = torch.tensor([3, 40], device=cuda)
    state = (batch.ligand_pos, batch.ligand_v, batch.bond_type, t)
    with torch.no_grad():
        got, want = on.apply(batch, *state), off.apply(batch, *state)
    for key in want:
        torch.testing.assert_close(got[key], want[key], **TOL)


def test_wrapper_rejects_bad_inputs(cuda):
    """A CUDA tensor reaches the kernel or raises: wrong dtype, shape or
    layout are refused before any launch."""
    rng = np.random.default_rng(4)
    B, Nl, H, heads = 1, 5, 32, 4
    module = _randomize(tutb.NodeBondAttention(
        H, heads, out_fc=False, use_kernels=True), 5).to(cuda)
    h = torch.as_tensor(rng.normal(size=(B, Nl, H)), dtype=torch.float32,
                        device=cuda)
    hb = torch.zeros(B, Nl, H, Nl, device=cuda).transpose(2, 3)
    bm = torch.ones(B, Nl, Nl, device=cuda)
    before = bond_ops.bond_attention.launches
    with pytest.raises(ValueError, match='contiguous'):
        module(h, hb, bm)
    with pytest.raises(TypeError, match='dtype'):
        module(h, hb.contiguous(), bm.double())
    assert bond_ops.bond_attention.launches == before
