"""The CUDA kernels (forward and backward) against their plain PyTorch
versions, on the card.

Every test here needs a CUDA device and the CUDA toolkit (`nvcc`); without
a card each one skips with that reason. On a GPU machine run

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

(`--noconftest` because tests/conftest.py sets up JAX, which the port's
machine does not need). The shapes are small and ragged on purpose: K and
Nl are not multiples of the kernels' 16-source chunk, some rows are fully
masked, and the 6-edge-type variant runs, which the released-shape check in
chip_smoke.py does not cover. Nl=20 gives the bond and triplet kernels two
source chunks, the last one ragged, and the triplet backward's shared
d t_src sum across both. The m-gated edge kernels (uni_o2) run at K=20 and
K=32 with a gate bias of 0 and one of +-30, which saturates the sigmoid.
The gather_bf16 edge kernels (sources from x_src) run forward and backward
in both modes with 4 and 6 edge types, and with an x_src far from x on both
forward routes; the edge and triplet forwards run at widths outside the
tensor-core kernels' (H = 96, 256, 1024) on their per-row kernels, and the
bond forward at H = 512 and 1024 (blocks of more than 256 threads) on its
per-row kernel and at H = 32, 64 and 128 on its tensor-core kernel. The
backward kernels run at H = 512 and 1024 (1024-thread builds, row buffers
in device memory) and the triplet backward also at H = 256 with Nl = 48
(per-row) and at H = 96 with Nl = 64 (per-row, the ligand ladder's top); at
H = 32, 64 and 128 the triplet backward is head-factorized, at Nl = 13,
20, 32, 40 and 48 (d t_src summed in shared memory) and 56 and 64 (in
device memory), with a complex without bonds, and two of its launches give
bitwise-equal gradients at Nl = 32 and 64. The edge backward at H = 32,
64 and 128 is head-factorized in every mode (node, pos, gated, gather), at
K = 20, 32 (one 32-source chunk) and 48 (two), and two of its launches give
bitwise-equal parameter gradients; at H = 96 it stays per-row. Its second
chunk of sources (K = 48 and 64, up to its KMAX) is held with 4 and 6 edge
types in node and pos mode and with the m-gate. The bond backward at H =
32, 64 and 128 takes the head route (head-factorized, then a tensor-core
product kernel for d h_bond and d We), at Nl = 13, 20, 32, 40, 48 and 64
in both modes, and two of its launches give bitwise-equal parameter
gradients; above 64 atoms, or with more than 16 heads, it stays per-row.
The released model converted from a reference-layout state dict holds the
float64 reference oracle with the kernels (rtol = atol = 3e-4), and the
sampler's host drift fires at the same steps with the same inputs on the
card as on the CPU. A training step on two data-parallel ranks (spawned
processes; gloo when they share the card) with the kernels on matches the
same step in one process, each rank's kernels taking half the batch. The
port's spans (utils/profiling.py) and CUPTI's records of the kernels they
launch lie on one clock.

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
from decompdiff_tpu_torch.ops.common import Branch
from decompdiff_tpu_torch.ops.knn import knn_neighbors
from decompdiff_tpu_torch.utils.gradcheck import compare_backward
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


@pytest.mark.parametrize('Nl', [13, 20], ids=['Nl13', 'Nl20'])
@pytest.mark.parametrize('pos_mode', [False, True], ids=['node', 'pos'])
def test_bond_kernel(cuda, pos_mode, Nl):
    rng = np.random.default_rng(2)
    B, H, heads = 2, 64, 8
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


@pytest.mark.parametrize('H,heads', [(512, 16), (1024, 32)],
                         ids=['H512', 'H1024'])
@pytest.mark.parametrize('pos_mode', [False, True], ids=['node', 'pos'])
def test_bond_wide_kernel(cuda, pos_mode, H, heads):
    """The bond forward with blocks of more than 256 threads (its 1024-thread
    build); Nl=20, two chunks."""
    args, kw = _bond_case(np.random.default_rng(9), H, heads, pos_mode)
    rows = bond_ops.bond_attention.row_launches
    _forward_on_card(bond_ops.bond_attention,
                     bond_ops.bond_attention_reference, args, kw, cuda,
                     bond_ops.bond_attention, 'launches')
    assert bond_ops.bond_attention.row_launches == rows + 1


@pytest.mark.parametrize('Nl', [13, 20, 32, 40])
@pytest.mark.parametrize('H,heads', [(32, 4), (64, 8), (128, 16)],
                         ids=['H32', 'H64', 'H128'])
@pytest.mark.parametrize('pos_mode', [False, True], ids=['node', 'pos'])
def test_bond_tensor_core_kernel(cuda, pos_mode, H, heads, Nl):
    """The tensor-core bond forward: one 32-source chunk (ragged below
    32), two at Nl = 40; B * Nl odd at Nl = 13, so a tile spans two
    complexes. Atom 3 of complex 0 and atoms 9.. of complex 1 have no bond
    and give exactly 0."""
    rng = np.random.default_rng(80 + Nl)
    args, kw = _bond_case(rng, H, heads, pos_mode, B=3 if Nl == 13 else 2,
                          Nl=Nl)
    args[2][0, 3] = 0.0
    rows = bond_ops.bond_attention.row_launches
    got = _forward_on_card(bond_ops.bond_attention,
                           bond_ops.bond_attention_reference, args, kw, cuda,
                           bond_ops.bond_attention, 'launches')
    assert bond_ops.bond_attention.row_launches == rows
    assert float(got[0, 3].abs().max()) == 0.0
    assert float(got[1, 9:].abs().max()) == 0.0


@pytest.mark.parametrize('Nl', [13, 20], ids=['Nl13', 'Nl20'])
@pytest.mark.parametrize('include_h_node', [True, False])
def test_triplet_kernel(cuda, include_h_node, Nl):
    rng = np.random.default_rng(3)
    B, H, heads = 2, 32, 4
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


# --------------------------------------------------------------------------
# tensor-core forward kernels at the released width, against their plain
# versions on the card
# --------------------------------------------------------------------------
# The triplet forward at Nl below, at and above its 32-atom source chunk
# (80: three chunks, the last ragged), the edge forward at K below, at and
# above it, with an odd number of destination rows (the last 2-row tile
# ragged). bf16: the kernel's one bf16 pass against the bf16 plain version.
# A y within float32 rounding of a bf16 rounding boundary can round the
# other way in the two (a flip), which moves a k or v entry by one bf16 ulp
# of y (up to 2^-7 |y|) times a row of Wo; at these weights (scale 0.3, not
# 1/sqrt(H)) one flip moved an output by 3.3e-3. So at most 0.1% of the
# elements may lie outside rtol / atol 1e-3, and none beyond 1e-2.
BF16_TOL = dict(rtol=1e-3, atol=1e-3)
BF16_FRAC, BF16_CAP = 1e-3, 1e-2


def _assert_bf16_close(got, want):
    diff = (got - want).abs()
    outside = int((diff > BF16_TOL['atol']
                   + BF16_TOL['rtol'] * want.abs()).sum())
    assert outside <= BF16_FRAC * want.numel(), outside
    assert float(diff.max()) <= BF16_CAP


def _forward_on_card(fn, plain, args, kw, cuda, counter, count):
    """The plain version and the kernel, both on the card (kw bf16: at the
    bf16 criterion above, else TOL); the kernel adds one to `count`.
    Returns the kernel's output."""
    dev_args = [_dev(a, cuda) for a in args]
    dev_kw = {k: _dev(v, cuda) for k, v in kw.items()}
    want = plain(*dev_args, **dev_kw)
    before = getattr(counter, count)
    got = fn(*dev_args, **dev_kw)
    torch.cuda.synchronize()
    assert getattr(counter, count) == before + 1
    assert bool(torch.isfinite(got).all())
    if kw.get('bf16'):
        _assert_bf16_close(got, want)
    else:
        torch.testing.assert_close(got, want, **TOL)
    return got


@pytest.mark.parametrize('bf16', [False, True], ids=['f32', 'bf16'])
@pytest.mark.parametrize('Nl', [13, 20, 32, 48, 80])
def test_triplet_tensor_core_kernel(cuda, Nl, bf16):
    args, kw = _triplet_case(np.random.default_rng(10 + Nl), 128, 16, Nl)
    args[1][1, :, 2] = 0.0            # rows (i, 2) of complex 1 as well
    got = _forward_on_card(
        triplet_ops.triplet_attention,
        triplet_ops.triplet_attention_reference, args, dict(kw, bf16=bf16),
        cuda, triplet_ops.triplet_attention,
        'bf16_launches' if bf16 else 'launches')
    assert float(got[0, 4].abs().max()) == 0.0
    assert float(got[1, :, 2].abs().max()) == 0.0


@pytest.mark.parametrize('K', [16, 32, 48], ids=['K16', 'K32', 'K48'])
@pytest.mark.parametrize('mode', ['node', 'pos', 'gated'])
def test_edge_tensor_core_kernel(cuda, mode, K):
    """B * N = 159 destination rows; rows N-5.. of complex 0 have no valid
    source and give exactly 0."""
    rng = np.random.default_rng(20 + K)
    B, N, Np, H, heads = 3, 53, 35, 128, 16
    pos = mode == 'pos'
    x, graph, e_w = _graph(rng, B, N, K, Np, True)
    k = _rand_branch(rng, (B, N, H), (B, N, H), 126, H, H)
    v = _rand_branch(rng, (B, N, H), (B, N, H), 126, H, heads if pos else H)
    q = _rand(rng, B, N, H, scale=1.0)
    kw = dict(n_heads=heads, pos_mode=pos)
    if mode == 'gated':
        kw['gate'] = (_rand(rng, H), torch.tensor([0.5]))
    args = (x, graph.lig, graph.group, graph.idx, graph.mask, e_w, q, k, v)
    got = _forward_on_card(
        edge_ops.edge_attention, edge_ops.edge_attention_reference, args, kw,
        cuda, edge_ops.edge_attention,
        'gated_launches' if mode == 'gated' else 'launches')
    assert float(got[0, N - 5:].abs().max()) == 0.0


def _edge_case(rng, H, heads, mode, K=20, B=2, N=37, Np=25, group=True,
               shift=0.0):
    """(args, kw) of an edge forward or backward launch; mode node, pos,
    gated (node mode with the m-gate, 4 edge types) or gather (node mode
    with x_src: the hi + lo split of x, or with `shift` x plus shift times
    a standard normal); `mode` may end in '_pos' for gather in pos mode.
    Rows N-5.. of complex 0 have no valid source."""
    pos = mode.endswith('pos')
    group = group and mode != 'gated'
    x, graph, e_w = _graph(rng, B, N, K, Np, group)
    n_et = 6 if group else 4
    k = _rand_branch(rng, (B, N, H), (B, N, H), n_et * 21, H, H)
    v = _rand_branch(rng, (B, N, H), (B, N, H), n_et * 21, H,
                     heads if pos else H)
    q = _rand(rng, B, N, H, scale=1.0)
    kw = dict(n_heads=heads, pos_mode=pos)
    if mode == 'gated':
        kw['gate'] = (_rand(rng, H), torch.tensor([0.5]))
    if mode.startswith('gather'):
        kw['x_src'] = (x + _rand(rng, *x.shape, scale=shift) if shift
                       else tutb.gather_table(torch.zeros(1), x)[1])
    return (x, graph.lig, graph.group, graph.idx, graph.mask, e_w, q, k,
            v), kw


EDGE_COUNTS = {'node': 'launches', 'pos': 'launches',
               'gated': 'gated_launches', 'gather': 'gather_launches',
               'gather_pos': 'gather_launches'}


@pytest.mark.parametrize('group', [False, True], ids=['4types', '6types'])
@pytest.mark.parametrize('mode', ['gather', 'gather_pos'])
def test_edge_gather_kernel(cuda, mode, group):
    """gather_bf16: the sources' coordinates from x_src (hi + lo), the
    destinations' from x; the launch counts in gather_launches alone."""
    rng = np.random.default_rng(30 + group)
    args, kw = _edge_case(rng, 128, 16, mode, K=32, group=group)
    assert float((kw['x_src'] - args[0]).abs().max()) > 0.0
    launches = edge_ops.edge_attention.launches
    got = _forward_on_card(
        edge_ops.edge_attention, edge_ops.edge_attention_reference, args, kw,
        cuda, edge_ops.edge_attention, 'gather_launches')
    assert edge_ops.edge_attention.launches == launches
    if mode == 'gather':
        assert float(got[0, -5:].abs().max()) == 0.0


@pytest.mark.parametrize('group', [False, True], ids=['4types', '6types'])
@pytest.mark.parametrize('mode', ['gather', 'gather_pos'])
def test_edge_gather_backward_kernel(cuda, mode, group):
    """Every gradient elementwise, d x (destinations) and d x_src (sources)
    apart."""
    rng = np.random.default_rng(32 + group)
    args, kw = _edge_case(rng, 128, 16, mode, group=group)
    g = _rand(rng, *(args[0].shape if mode == 'gather_pos' else
                     args[-3].shape), scale=1.0)
    _check_backward(edge_ops.edge_attention_backward, g, args, kw, cuda,
                    edge_ops.edge_attention_backward, count='gather_launches',
                    row=0)


# x_src far from x: the hi + lo table lies within about 2^-17 |x| of x, so
# the cases above would pass a kernel that read a source's coordinates from
# x, or scattered their cotangent into d x. Here x_src is x plus 0.5 times
# a standard normal, which moves every output and gradient by far more
# than TOL: the forward on the tensor-core route (H=128) and the per-row
# route (H=96), and the backward (head-factorized at H=128, per-row at
# H=96), node and pos mode, d x and d x_src apart.
@pytest.mark.parametrize('H,heads', [(128, 16), (96, 12)],
                         ids=['H128', 'H96'])
@pytest.mark.parametrize('mode', ['gather', 'gather_pos'],
                         ids=['node', 'pos'])
@pytest.mark.parametrize('direction', ['forward', 'backward'])
def test_edge_shifted_source_kernel(cuda, direction, mode, H, heads):
    rng = np.random.default_rng(60 + H)
    args, kw = _edge_case(rng, H, heads, mode, K=32, shift=0.5)
    assert float((kw['x_src'] - args[0]).abs().max()) > 0.5
    if direction == 'forward':
        rows = edge_ops.edge_attention.row_launches
        _forward_on_card(
            edge_ops.edge_attention, edge_ops.edge_attention_reference, args,
            kw, cuda, edge_ops.edge_attention, 'gather_launches')
        assert edge_ops.edge_attention.row_launches == rows + (H == 96)
        return
    g = _rand(rng, *(args[0].shape if mode == 'gather_pos' else
                     args[-3].shape), scale=1.0)
    _check_backward(edge_ops.edge_attention_backward, g, args, kw, cuda,
                    edge_ops.edge_attention_backward, count='gather_launches',
                    row=int(H == 96))


# The widths outside the tensor-core kernels' run on the per-row kernels:
# 96 and 256 with 12 and 16 heads (head width 8 and 16), and 1024 with 32
# (head width 32, the largest block).
ROW_WIDTHS = [(96, 12), (256, 16), (1024, 32)]
ROW_IDS = [f'H{h}' for h, _ in ROW_WIDTHS]


@pytest.mark.parametrize('H,heads', ROW_WIDTHS, ids=ROW_IDS)
@pytest.mark.parametrize('mode', ['node', 'pos', 'gated', 'gather'])
def test_edge_row_kernel(cuda, mode, H, heads):
    rng = np.random.default_rng(40 + H)
    args, kw = _edge_case(rng, H, heads, mode)
    rows = edge_ops.edge_attention.row_launches
    got = _forward_on_card(
        edge_ops.edge_attention, edge_ops.edge_attention_reference, args, kw,
        cuda, edge_ops.edge_attention, EDGE_COUNTS[mode])
    assert edge_ops.edge_attention.row_launches == rows + 1
    if mode != 'pos':
        assert float(got[0, -5:].abs().max()) == 0.0


@pytest.mark.parametrize('H,heads', ROW_WIDTHS, ids=ROW_IDS)
@pytest.mark.parametrize('bf16', [False, True], ids=['f32', 'bf16'])
def test_triplet_row_kernel(cuda, bf16, H, heads):
    """Nl=20: two 16-atom chunks, the last ragged."""
    args, kw = _triplet_case(np.random.default_rng(50 + H), H, heads, 20)
    rows = triplet_ops.triplet_attention.row_launches
    got = _forward_on_card(
        triplet_ops.triplet_attention,
        triplet_ops.triplet_attention_reference, args, dict(kw, bf16=bf16),
        cuda, triplet_ops.triplet_attention,
        'bf16_launches' if bf16 else 'launches')
    assert triplet_ops.triplet_attention.row_launches == rows + 1
    assert float(got[0, 4].abs().max()) == 0.0


def test_forward_kernels_refuse_what_check_heads_refuses(cuda):
    """The edge and triplet forward wrappers refuse exactly the widths that
    check_heads refuses (here 48, not a multiple of 32), before a launch;
    the tensor-core widths do not run the per-row kernels."""
    rng = np.random.default_rng(11)
    B, Nl, H, heads = 1, 5, 48, 6
    br = _dev(_rand_branch(rng, (B, Nl, Nl, H), (B, Nl, Nl, H), 13, H, H),
              cuda)
    angle = torch.zeros(B, Nl, Nl, Nl, device=cuda)
    bm = torch.ones(B, Nl, Nl, device=cuda)
    q = torch.zeros(B, Nl, Nl, H, device=cuda)
    before = (triplet_ops.triplet_attention.launches,
              triplet_ops.triplet_attention.row_launches)
    with pytest.raises(ValueError, match='hidden width 48'):
        triplet_ops.triplet_attention(angle, bm, q, br, br, n_heads=heads)
    args, kw = _edge_case(rng, H, heads, 'node')
    edge_before = (edge_ops.edge_attention.launches,
                   edge_ops.edge_attention.row_launches)
    with pytest.raises(ValueError, match='hidden width 48'):
        edge_ops.edge_attention(*[_dev(a, cuda) for a in args], **kw)
    assert (triplet_ops.triplet_attention.launches,
            triplet_ops.triplet_attention.row_launches) == before
    assert (edge_ops.edge_attention.launches,
            edge_ops.edge_attention.row_launches) == edge_before
    args, kw = _edge_case(rng, 64, 8, 'pos')
    _forward_on_card(edge_ops.edge_attention,
                     edge_ops.edge_attention_reference, args, kw, cuda,
                     edge_ops.edge_attention, 'launches')
    assert edge_ops.edge_attention.row_launches == edge_before[1]


UNI_O2 = {'model_type': 'uni_o2', 'bond_net_type': 'pre_att'}


@pytest.mark.parametrize('extra', [
    {}, {'add_prior_node': True}, dict(UNI_O2, ew_net_type='m'),
    dict(UNI_O2, ew_net_type='r', num_x2h=2)],
    ids=['released', 'prior_node', 'uni_o2_m', 'uni_o2_r'])
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


# --------------------------------------------------------------------------
# backward kernels against plain autograd
# --------------------------------------------------------------------------
# Gradient tolerance rtol 1e-3 / atol 1e-4 * max(1, max |plain gradient|):
# float32 on both sides, but the kernels sum the source-node cotangents
# (edge, bond) with atomicAdd, whose order changes from run to run, and every
# parameter gradient over rows in another order than autograd.

def _rand(rng, *shape, scale=0.3):
    return torch.as_tensor(rng.normal(size=shape) * scale, dtype=torch.float32)


def _rand_branch(rng, row_shape, src_shape, feat_rows, H, dout):
    return Branch(_rand(rng, *row_shape, scale=1.0),
                  _rand(rng, *src_shape, scale=1.0),
                  _rand(rng, feat_rows, H), _rand(rng, H, dout),
                  _rand(rng, dout), 1.0 + _rand(rng, H), _rand(rng, H))


def _dev(a, cuda):
    if isinstance(a, tuple):
        return type(a)(*(t.to(cuda) for t in a)) if isinstance(a, Branch) \
            else tuple(t.to(cuda) for t in a)
    return _to(a, cuda)


def _check_backward(fn, g, args, kw, cuda, counter, count='launches',
                    scratch=False, row=None, retry=False):
    """The backward wrapper on CPU tensors (plain autograd) against the same
    wrapper on CUDA tensors (the kernel), which adds one to `count`, and to
    `scratch_launches` when `scratch` (its row buffers in device memory);
    with `row` (edge, triplet), row_launches rises by `row` (1: the per-row
    kernel, 0: the head-factorized one).
    At those sizes, or with `retry`, where a gradient lies outside the
    tolerance, the comparison is made again with the cotangent zeroed on the
    few rows whose ambiguous relu gates explain the elements outside, as
    chip_smoke.py makes it (decompdiff_tpu_torch/utils/gradcheck.py
    compare_backward)."""
    dev_args = [_dev(a, cuda) for a in args]
    dev_kw = {k: _dev(v, cuda) for k, v in kw.items()}
    before = getattr(counter, count), counter.scratch_launches
    rows = getattr(counter, 'row_launches', 0)
    fn(g.to(cuda), *dev_args, **dev_kw)
    torch.cuda.synchronize()
    assert (getattr(counter, count), counter.scratch_launches) == (
        before[0] + 1, before[1] + scratch)
    if row is not None:
        assert counter.row_launches == rows + row
    verdict = compare_backward(
        fn.__name__.replace('_backward', ''),
        lambda g: fn(g, *dev_args, **dev_kw),
        lambda g: fn(g.cpu(), *args, **kw), g.to(cuda), dev_args, dev_kw,
        retry=scratch or retry)
    if verdict.live:
        print(f'{fn.__name__}: cotangent zeroed on {verdict.zeroed} of '
              f'{verdict.live} live rows ({verdict.ambiguous} hold an '
              f'ambiguous gate); {verdict.full_outside} elements outside '
              'under the full cotangent')
    assert verdict.ok, verdict.message


@pytest.mark.parametrize('H,heads', [(32, 4), (128, 16)])
@pytest.mark.parametrize('group', [False, True], ids=['4types', '6types'])
@pytest.mark.parametrize('pos_mode', [False, True], ids=['node', 'pos'])
def test_edge_backward_kernel(cuda, pos_mode, group, H, heads):
    rng = np.random.default_rng(5)
    B, N, K, Np = 2, 37, 20, 25
    x, graph, e_w = _graph(rng, B, N, K, Np, group)
    n_et = 6 if group else 4
    dv = heads if pos_mode else H
    k = _rand_branch(rng, (B, N, H), (B, N, H), n_et * 21, H, H)
    v = _rand_branch(rng, (B, N, H), (B, N, H), n_et * 21, H, dv)
    q = _rand(rng, B, N, H, scale=1.0)
    g = _rand(rng, B, N, 3 if pos_mode else H, scale=1.0)
    args = (x, graph.lig, graph.group, graph.idx, graph.mask, e_w, q, k, v)
    _check_backward(edge_ops.edge_attention_backward, g, args,
                    dict(n_heads=heads, pos_mode=pos_mode), cuda,
                    edge_ops.edge_attention_backward, row=0)


# The head-factorized edge backward (H in 32, 64, 128) at K below, at and
# above its 32-source chunk, up to its KMAX (64), with 4 and 6 edge types:
# the sums across chunks (d w_feat, Yd, Ya); rows N-5.. of complex 0 have
# no valid source. Its pre sums run in another order than autograd's, so a
# relu gate within rounding of 0 can flip: compare_backward zeroes only the
# rows whose ambiguous gates explain the elements outside.
@pytest.mark.parametrize('group', [True, False], ids=['6types', '4types'])
@pytest.mark.parametrize('K', [20, 32, 48, 64])
@pytest.mark.parametrize('H,heads', [(64, 8), (128, 16)])
@pytest.mark.parametrize('mode', ['node', 'pos'])
def test_edge_head_backward_kernel(cuda, mode, H, heads, K, group):
    rng = np.random.default_rng(15 + K)
    args, kw = _edge_case(rng, H, heads, mode, K=K, N=max(61, K + 9),
                          group=group)
    g = _rand(rng, *(args[0].shape if mode == 'pos' else args[-3].shape),
              scale=1.0)
    _check_backward(edge_ops.edge_attention_backward, g, args, kw, cuda,
                    edge_ops.edge_attention_backward, row=0, retry=True)


@pytest.mark.parametrize('mode,H,heads', [
    ('node', 128, 16), ('pos', 128, 16), ('gated', 128, 16),
    ('node', 96, 12)], ids=['head-node', 'head-pos', 'head-gated',
                            'per-row'])
def test_edge_backward_deterministic(cuda, mode, H, heads):
    """Two launches on the same inputs give bitwise-equal parameter
    gradients (every sum is owned by one thread or taken over the blocks in
    a fixed order); d t_src and d x are summed by atomics, so they may
    differ within rounding."""
    rng = np.random.default_rng(11)
    args, kw = _edge_case(rng, H, heads, mode, K=32)
    g = _rand(rng, *(args[0].shape if mode == 'pos' else args[-3].shape),
              scale=1.0)
    dev_args = [_dev(a, cuda) for a in args]
    dev_kw = {k: _dev(v, cuda) for k, v in kw.items()}
    rows = edge_ops.edge_attention_backward.row_launches
    first, second = (edge_ops.edge_attention_backward(
        g.to(cuda), *dev_args, **dev_kw) for _ in range(2))
    torch.cuda.synchronize()
    assert edge_ops.edge_attention_backward.row_launches == rows + 2 * (
        H == 96)
    for name, a, b in _edge_grad_pairs(first, second):
        if name in ('x', 'k.t_src', 'v.t_src'):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
        else:
            assert torch.equal(a, b), name


def _edge_grad_pairs(first, second):
    """(name, first, second) of each gradient of two edge backward results."""
    out = []
    for i, name in enumerate(('x', 'e_w', 'q')):
        out.append((name, first[i], second[i]))
    for i, tag in ((3, 'k'), (4, 'v')):
        for f, a, b in zip(Branch._fields, first[i], second[i]):
            out.append((f'{tag}.{f}', a, b))
    for i in range(5, len(first)):
        for j, (a, b) in enumerate(zip(first[i], second[i])):
            out.append((f'extra{i}.{j}', a, b))
    return out


def _gated_case(K, bm, seed):
    """Inputs of a gated (node mode, 4 edge types) edge launch at the
    released width, with 37 nodes (K + 9 for K above 32, so that every
    row has K sources); rows N-5.. of complex 0 have no valid source."""
    rng = np.random.default_rng(seed)
    B, N, Np, H = 2, 37 if K <= 32 else K + 9, 25, 128
    x, graph, e_w = _graph(rng, B, N, K, Np, False)
    k = _rand_branch(rng, (B, N, H), (B, N, H), 84, H, H)
    v = _rand_branch(rng, (B, N, H), (B, N, H), 84, H, H)
    q = _rand(rng, B, N, H, scale=1.0)
    gate = (_rand(rng, H), torch.tensor([bm], dtype=torch.float32))
    args = (x, graph.lig, None, graph.idx, graph.mask, e_w, q, k, v)
    return args, gate, rng


GATE_BIAS = {'bm0': 0.0, 'bm+30': 30.0, 'bm-30': -30.0}


@pytest.mark.parametrize('bm', sorted(GATE_BIAS))
@pytest.mark.parametrize('K', [20, 32], ids=['K20', 'K32'])
def test_edge_gated_kernel(cuda, K, bm):
    args, gate, _ = _gated_case(K, GATE_BIAS[bm], seed=12)
    kw = dict(n_heads=16, pos_mode=False, gate=gate)
    want = edge_ops.edge_attention(*args, **kw)
    counts = (edge_ops.edge_attention.launches,
              edge_ops.edge_attention.gated_launches)
    got = edge_ops.edge_attention(*[_dev(a, cuda) for a in args],
                                  **dict(kw, gate=_dev(gate, cuda)))
    torch.cuda.synchronize()
    assert (edge_ops.edge_attention.launches,
            edge_ops.edge_attention.gated_launches) == (counts[0],
                                                        counts[1] + 1)
    assert bool(torch.isfinite(got).all())
    torch.testing.assert_close(got.cpu(), want, **TOL)
    assert float(got[0, -5:].abs().max()) == 0.0


@pytest.mark.parametrize('bm', sorted(GATE_BIAS))
@pytest.mark.parametrize('K', [20, 32, 48, 64],
                         ids=['K20', 'K32', 'K48', 'K64'])
def test_edge_gated_backward_kernel(cuda, K, bm):
    """Every gradient, d wm and d bm included, elementwise."""
    args, gate, rng = _gated_case(K, GATE_BIAS[bm], seed=13)
    g = _rand(rng, *args[-3].shape, scale=1.0)
    _check_backward(edge_ops.edge_attention_backward, g, args,
                    dict(n_heads=16, pos_mode=False, gate=gate), cuda,
                    edge_ops.edge_attention_backward, count='gated_launches',
                    row=0)


@pytest.mark.parametrize('Nl', [13, 20], ids=['Nl13', 'Nl20'])
@pytest.mark.parametrize('pos_mode', [False, True], ids=['node', 'pos'])
def test_bond_backward_kernel(cuda, pos_mode, Nl):
    rng = np.random.default_rng(6)
    B, H, heads = 2, 64, 8
    lm = torch.ones(B, Nl, dtype=torch.bool)
    lm[1, 9:] = False
    bm = (lm[:, :, None] & lm[:, None, :] & ~torch.eye(Nl, dtype=torch.bool)
          ).float()
    dv = heads if pos_mode else H
    k = _rand_branch(rng, (B, Nl, H), (B, Nl, H), H, H, H)
    v = _rand_branch(rng, (B, Nl, H), (B, Nl, H), H, H, dv)
    hb, q = _rand(rng, B, Nl, Nl, H, scale=1.0), _rand(rng, B, Nl, H, scale=1.0)
    x = _rand(rng, B, Nl, 3, scale=2.0) if pos_mode else None
    g = _rand(rng, B, Nl, 3 if pos_mode else H, scale=1.0)
    _check_backward(bond_ops.bond_attention_backward, g,
                    (hb, x, bm, q, k, v),
                    dict(n_heads=heads, pos_mode=pos_mode), cuda,
                    bond_ops.bond_attention_backward)


# The bond backward's head route (H in 32, 64, 128) at Nl below, at and
# above its 32-source chunk, up to its NLMAX (64); atom 4 of complex 0 has
# no bond and the last complex none at all. Its pre sums run in another
# order than autograd's, so a relu gate within rounding of 0 can flip:
# compare_backward zeroes only the rows whose ambiguous gates explain the
# elements outside.
def _bond_head_case(rng, H, heads, pos_mode, Nl, B=3):
    bm = (torch.as_tensor(rng.random((B, Nl, Nl)) < 0.5)
          & ~torch.eye(Nl, dtype=torch.bool)).float()
    bm[0, 4] = 0.0                              # atom 4 of complex 0: no bonds
    bm[-1] = 0.0                                # the last complex: no bonds
    k = _rand_branch(rng, (B, Nl, H), (B, Nl, H), H, H, H)
    v = _rand_branch(rng, (B, Nl, H), (B, Nl, H), H, H, heads if pos_mode
                     else H)
    hb, q = _rand(rng, B, Nl, Nl, H, scale=1.0), _rand(rng, B, Nl, H,
                                                        scale=1.0)
    x = _rand(rng, B, Nl, 3, scale=2.0) if pos_mode else None
    g = _rand(rng, B, Nl, 3 if pos_mode else H, scale=1.0)
    return g, (hb, x, bm, q, k, v), dict(n_heads=heads, pos_mode=pos_mode)


@pytest.mark.parametrize('Nl', [13, 20, 32, 40, 48, 64])
@pytest.mark.parametrize('H,heads', [(32, 4), (64, 8), (128, 16)])
@pytest.mark.parametrize('pos_mode', [False, True], ids=['node', 'pos'])
def test_bond_backward_head_kernel(cuda, pos_mode, H, heads, Nl):
    g, args, kw = _bond_head_case(np.random.default_rng(8 + Nl), H, heads,
                                  pos_mode, Nl)
    _check_backward(bond_ops.bond_attention_backward, g, args, kw, cuda,
                    bond_ops.bond_attention_backward, row=0, retry=True)


# Outside the head route the bond backward runs the per-row kernel: more
# atoms than its NLMAX, or more than 16 heads.
@pytest.mark.parametrize('H,heads,Nl', [(64, 8, 70), (128, 32, 20)],
                         ids=['Nl70', 'heads32'])
def test_bond_backward_per_row_route(cuda, H, heads, Nl):
    g, args, kw = _bond_head_case(np.random.default_rng(3), H, heads, False,
                                  Nl, B=2)
    _check_backward(bond_ops.bond_attention_backward, g, args, kw, cuda,
                    bond_ops.bond_attention_backward, row=1)


@pytest.mark.parametrize('pos_mode', [False, True], ids=['node', 'pos'])
def test_bond_backward_deterministic(cuda, pos_mode):
    """Two launches of the head route on the same inputs give bitwise-equal
    gradients but d t_src and d x (every other sum is owned by one thread
    or taken over the blocks in a fixed order; those two are atomics, so
    they may differ within rounding)."""
    g, args, kw = _bond_head_case(np.random.default_rng(9), 128, 16,
                                  pos_mode, 32)
    dev_args = [_dev(a, cuda) for a in args]
    rows = bond_ops.bond_attention_backward.row_launches
    first, second = (bond_ops.bond_attention_backward(g.to(cuda), *dev_args,
                                                      **kw)
                     for _ in range(2))
    torch.cuda.synchronize()
    assert bond_ops.bond_attention_backward.row_launches == rows
    pairs = [('h_bond', first[0], second[0]), ('q', first[2], second[2])]
    if pos_mode:
        pairs.append(('x', first[1], second[1]))
    for i, tag in ((3, 'k'), (4, 'v')):
        for f, a, b in zip(Branch._fields, first[i], second[i]):
            pairs.append((f'{tag}.{f}', a, b))
    for name, a, b in pairs:
        if name in ('x', 'k.t_src', 'v.t_src'):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
        else:
            assert torch.equal(a, b), name


# The head-factorized triplet backward (H in 32, 64, 128) at Nl below, at
# and above its 32-source chunk, up to the top of the ligand ladder (64,
# data/collate.py), each launch also counted by Nl; atom 4 of complex 0 has
# no bonds, and complex 2 none at all. Its pre sums run in
# another order than autograd's, so a relu gate within rounding of 0 can flip
# (at H = 128, Nl = 32: one row of 779): compare_backward zeroes only the
# rows whose ambiguous gates explain the elements outside.
@pytest.mark.parametrize('Nl', [13, 20, 32, 40, 48, 56, 64])
@pytest.mark.parametrize('H,heads', [(32, 4), (64, 8), (128, 16)])
def test_triplet_backward_kernel(cuda, H, heads, Nl):
    rng = np.random.default_rng(7)
    B = 3
    bm = (torch.as_tensor(rng.random((B, Nl, Nl)) < 0.4)
          & ~torch.eye(Nl, dtype=torch.bool)).float()
    bm[0, 4] = 0.0                              # atom 4 of complex 0: no bonds
    bm[2] = 0.0                                 # complex 2: no bonds
    k = _rand_branch(rng, (B, Nl, Nl, H), (B, Nl, Nl, H), 13, H, H)
    v = _rand_branch(rng, (B, Nl, Nl, H), (B, Nl, Nl, H), 13, H, H)
    angle = torch.as_tensor(rng.random((B, Nl, Nl, Nl)) * np.pi,
                            dtype=torch.float32)
    q = _rand(rng, B, Nl, Nl, H, scale=1.0)
    g = _rand(rng, B, Nl, Nl, H, scale=1.0)
    counter = triplet_ops.triplet_attention_backward
    before = counter.launches, counter.nl_launches.get(Nl, 0)
    _check_backward(counter, g, (angle, bm, q, k, v), dict(n_heads=heads),
                    cuda, counter, row=0, retry=True)
    assert (counter.nl_launches[Nl] - before[1]
            == counter.launches - before[0])


@pytest.mark.parametrize('H,heads,Nl', [(128, 16, 32), (256, 16, 32),
                                        (128, 16, 64)],
                         ids=['head', 'per-row', 'head-Nl64'])
def test_triplet_backward_deterministic(cuda, H, heads, Nl):
    """Two launches on the same inputs give bitwise-equal gradients (every
    sum is owned by one thread or taken over the blocks in a fixed order;
    the d t_src sums in device memory too)."""
    args, kw = _triplet_case(np.random.default_rng(9), H, heads, Nl)
    g = _rand(np.random.default_rng(10), *args[2].shape, scale=1.0)
    dev_args = [_dev(a, cuda) for a in args]
    first, second = (triplet_ops.triplet_attention_backward(
        g.to(cuda), *dev_args, **kw) for _ in range(2))
    torch.cuda.synchronize()
    flat = [[a[0], a[1], *a[2], *a[3]] for a in (first, second)]
    for x, y in zip(*flat):
        assert torch.equal(x, y)


# The backward kernels at the widths above 256 that check_heads admits:
# 1024-thread builds, with the row buffers in device memory (they exceed a
# block's shared memory at H >= 512 for these sources), so every launch
# counts in scratch_launches. The triplet also at H = 256 with Nl = 48,
# where its d t_src sums and row buffers exceed shared memory in the
# 256-thread build.
WIDE_WIDTHS = [(512, 16), (1024, 32)]
WIDE_IDS = [f'H{h}' for h, _ in WIDE_WIDTHS]


@pytest.mark.parametrize('H,heads', WIDE_WIDTHS, ids=WIDE_IDS)
@pytest.mark.parametrize('mode', ['node', 'pos', 'gated'])
def test_edge_wide_backward_kernel(cuda, mode, H, heads):
    rng = np.random.default_rng(70 + H)
    args, kw = _edge_case(rng, H, heads, mode)
    g = _rand(rng, *(args[0].shape if mode == 'pos' else args[-3].shape),
              scale=1.0)
    _check_backward(edge_ops.edge_attention_backward, g, args, kw, cuda,
                    edge_ops.edge_attention_backward, EDGE_COUNTS[mode],
                    scratch=True, row=1)


def _bond_case(rng, H, heads, pos_mode, B=2, Nl=20):
    """(args, kw) of a bond launch; complex 1 has 9 real atoms."""
    lm = torch.ones(B, Nl, dtype=torch.bool)
    lm[1, 9:] = False
    bm = (lm[:, :, None] & lm[:, None, :] & ~torch.eye(Nl, dtype=torch.bool)
          ).float()
    k = _rand_branch(rng, (B, Nl, H), (B, Nl, H), H, H, H)
    v = _rand_branch(rng, (B, Nl, H), (B, Nl, H), H, H, heads if pos_mode
                     else H)
    hb, q = _rand(rng, B, Nl, Nl, H, scale=1.0), _rand(rng, B, Nl, H,
                                                        scale=1.0)
    x = _rand(rng, B, Nl, 3, scale=2.0) if pos_mode else None
    return (hb, x, bm, q, k, v), dict(n_heads=heads, pos_mode=pos_mode)


@pytest.mark.parametrize('H,heads', WIDE_WIDTHS, ids=WIDE_IDS)
@pytest.mark.parametrize('pos_mode', [False, True], ids=['node', 'pos'])
def test_bond_wide_backward_kernel(cuda, pos_mode, H, heads):
    rng = np.random.default_rng(72 + H)
    args, kw = _bond_case(rng, H, heads, pos_mode)
    g = _rand(rng, *args[3].shape[:2], 3 if pos_mode else H, scale=1.0)
    _check_backward(bond_ops.bond_attention_backward, g, args, kw, cuda,
                    bond_ops.bond_attention_backward, scratch=True)


def _triplet_case(rng, H, heads, Nl, B=2):
    """(args, kw) of a triplet launch; rows (4, j) of complex 0 have no
    bond (j -> 4)."""
    bm = (torch.as_tensor(rng.random((B, Nl, Nl)) < 0.3)
          & ~torch.eye(Nl, dtype=torch.bool)).float()
    bm[0, 4] = 0.0
    k = _rand_branch(rng, (B, Nl, Nl, H), (B, Nl, Nl, H), 13, H, H)
    v = _rand_branch(rng, (B, Nl, Nl, H), (B, Nl, Nl, H), 13, H, H)
    angle = torch.as_tensor(rng.random((B, Nl, Nl, Nl)) * np.pi,
                            dtype=torch.float32)
    q = _rand(rng, B, Nl, Nl, H, scale=1.0)
    return (angle, bm, q, k, v), dict(n_heads=heads)


@pytest.mark.parametrize('H,heads,Nl', [(512, 16, 20), (1024, 32, 20),
                                        (256, 16, 48)],
                         ids=['H512', 'H1024', 'H256-Nl48'])
def test_triplet_wide_backward_kernel(cuda, H, heads, Nl):
    rng = np.random.default_rng(74 + H)
    args, kw = _triplet_case(rng, H, heads, Nl)
    g = _rand(rng, *args[2].shape, scale=1.0)
    _check_backward(triplet_ops.triplet_attention_backward, g, args, kw,
                    cuda, triplet_ops.triplet_attention_backward,
                    scratch=True, row=1)


def test_triplet_row_backward_ladder_top(cuda):
    """The per-row triplet backward at the top of the ligand ladder (Nl =
    64) at a width outside the head route (H = 96, 12 heads): its d t_src
    sums and row buffers still fit shared memory (no scratch)."""
    rng = np.random.default_rng(76)
    args, kw = _triplet_case(rng, 96, 12, 64)
    g = _rand(rng, *args[2].shape, scale=1.0)
    _check_backward(triplet_ops.triplet_attention_backward, g, args, kw,
                    cuda, triplet_ops.triplet_attention_backward,
                    row=1, retry=True)


@pytest.mark.parametrize('which', ['edge_node', 'edge_pos', 'bond_node',
                                   'bond_pos', 'triplet'])
def test_autograd_reaches_backward_kernel(cuda, which):
    """Through a module with kernels on, loss.backward() launches the
    backward kernel once and gives every parameter and input the gradient
    that the plain version gives."""
    rng = np.random.default_rng(8)
    H, heads = 32, 4
    if which.startswith('edge'):
        B, N, K = 2, 23, 12
        x, graph, e_w = _graph(rng, B, N, K, 15, False)
        h = _rand(rng, B, N, H, scale=1.0)
        cls = (tutb.PosEdgeAttention if which == 'edge_pos'
               else tutb.NodeEdgeAttention)
        kw = {} if which == 'edge_pos' else {'out_fc': True}
        module = cls(H, heads, 4, use_kernels=True, **kw)
        args, diff = (h, x, graph, e_w), (0, 1, 3)
        counter = edge_ops.edge_attention_backward
    elif which.startswith('bond'):
        B, Nl = 2, 11
        h = _rand(rng, B, Nl, H, scale=1.0)
        hb = _rand(rng, B, Nl, Nl, H, scale=1.0)
        bm = (torch.ones(B, Nl, Nl) - torch.eye(Nl)).contiguous()
        bm[1, 8:] = 0.0
        bm[1, :, 8:] = 0.0
        if which == 'bond_pos':
            module = tutb.PosBondAttention(H, heads, use_kernels=True)
            args = (h, _rand(rng, B, Nl, 3, scale=2.0), hb, bm)
            diff = (0, 1, 2)
        else:
            module = tutb.NodeBondAttention(H, heads, out_fc=True,
                                            use_kernels=True)
            args, diff = (h, hb, bm), (0, 1)
        counter = bond_ops.bond_attention_backward
    else:
        B, Nl = 2, 9
        h = _rand(rng, B, Nl, H, scale=1.0)
        hb = _rand(rng, B, Nl, Nl, H, scale=1.0)
        x = _rand(rng, B, Nl, 3, scale=2.0)
        bm = (torch.as_tensor(rng.random((B, Nl, Nl)) < 0.5)
              & ~torch.eye(Nl, dtype=torch.bool)).float()
        module = tutb.BondTripletAttention(H, heads, include_h_node=True,
                                           use_kernels=True)
        args, diff = (h, hb, x, bm), (0, 1, 2)
        counter = triplet_ops.triplet_attention_backward
    _randomize(module, 3).requires_grad_(True)

    def grads(mod, inputs):
        leaves = [a.clone().requires_grad_(True) if i in diff else a
                  for i, a in enumerate(inputs)]
        out = mod(*leaves)
        cot = torch.as_tensor(np.random.default_rng(9).normal(size=out.shape),
                              dtype=torch.float32, device=out.device)
        params = [p for _, p in sorted(mod.named_parameters())]
        return torch.autograd.grad((out * cot).sum(),
                                   [leaves[i] for i in diff] + params)

    want = grads(module, args)
    module.to(cuda)
    before = counter.launches
    got = grads(module, [_to(a, cuda) for a in args])
    torch.cuda.synchronize()
    assert counter.launches == before + 1
    for a, b in zip(got, want):
        scale = max(1.0, float(b.abs().max()))
        torch.testing.assert_close(a.cpu(), b, rtol=1e-3, atol=1e-4 * scale)


def _plain_wrappers(monkeypatch):
    """Every kernel wrapper replaced by its plain version, which the modules
    then call on CUDA tensors under autograd: the kernel path's semantics
    (gather_bf16 included) without a kernel."""
    for mod, name in ((edge_ops, 'edge_attention'),
                      (bond_ops, 'bond_attention'),
                      (triplet_ops, 'triplet_attention')):
        monkeypatch.setattr(mod, name, getattr(mod, f'{name}_reference'))


def _train_step_on_vs_off(cuda, cfg, counter, count='launches', per_layer=1,
                          monkeypatch=None):
    """One training step's loss, grad norm and every parameter gradient with
    the kernels on against off (same weights, same draws), at the tolerance
    the JAX package holds its kernel path to (tests/test_train_step.py); and
    the step launches the backward kernel `counter` per_layer times per
    layer. With `monkeypatch`, off is the kernel path's model with every
    wrapper replaced by its plain version (for options the plain path does
    not read)."""
    from decompdiff_tpu_torch.training.train_step import (
        DEFAULT_TRAIN_CONFIG, create_train_state, global_norm, make_train_fns)
    batch = random_complex_batch(np.random.default_rng(0), batch_size=4,
                                 num_ligand=11, real_ligand=9, device=cuda)
    out = {}
    for on in (True, False):
        if not on and monkeypatch is not None:
            _plain_wrappers(monkeypatch)
        model = DecompDiffModel.create(
            dict(cfg, use_pallas=on or monkeypatch is not None), 8,
            device=cuda, seed=3)
        grad_step = make_train_fns(model, DEFAULT_TRAIN_CONFIG)[1]
        before = getattr(counter, count)
        grads, metrics, _, _ = grad_step(
            create_train_state(model, DEFAULT_TRAIN_CONFIG), batch,
            torch.Generator(device=cuda).manual_seed(1))
        torch.cuda.synchronize()
        launched = getattr(counter, count) - before
        assert launched == (per_layer * cfg['num_layers'] if on else 0)
        out[on] = grads, metrics
    (g_on, m_on), (g_off, m_off) = out[True], out[False]
    for key in m_off:
        torch.testing.assert_close(m_on[key], m_off[key], rtol=1e-4,
                                   atol=1e-6)
    torch.testing.assert_close(global_norm(g_on), global_norm(g_off),
                               rtol=2e-3, atol=0.0)
    for name, b in g_off.items():
        scale = max(1.0, float(b.abs().max()))
        torch.testing.assert_close(g_on[name], b, rtol=2e-3,
                                   atol=1e-4 * scale, msg=name)


def _dp_grad_step(mesh, batch_size=4):
    """One importance-free grad step of the tiny kernel model on `mesh`'s
    rows of a seeded batch (mesh None: the whole batch), its gradients and
    metrics all-reduced: (grads, metrics, rows, triplet backward
    launches)."""
    from decompdiff_tpu_torch.ops._build import build_once
    from decompdiff_tpu_torch.parallel.mesh import (
        all_reduce_mean, shard_batch)
    from decompdiff_tpu_torch.training.train_step import (
        DEFAULT_TRAIN_CONFIG, create_train_state, make_train_fns)
    device = torch.device('cuda') if mesh is None else mesh.device
    if mesh is not None:
        build_once(mesh)
    model = DecompDiffModel.create(dict(tiny_model_config(
        num_diffusion_timesteps=20), use_pallas=True), 8, device=device,
        seed=3)
    batch = shard_batch(random_complex_batch(
        np.random.default_rng(0), batch_size=batch_size, num_ligand=11,
        real_ligand=9, device=device), mesh)
    grad_step = make_train_fns(model, DEFAULT_TRAIN_CONFIG,
                               **({} if mesh is None else {'mesh': mesh}))[1]
    before = triplet_ops.triplet_attention_backward.launches
    grads, metrics, _, _ = grad_step(
        create_train_state(model, DEFAULT_TRAIN_CONFIG), batch,
        torch.Generator(device=device).manual_seed(1))
    grads = all_reduce_mean(grads, mesh)
    metrics = all_reduce_mean(metrics, mesh)
    torch.cuda.synchronize()
    return ({k: v.cpu() for k, v in grads.items()},
            {k: v.cpu() for k, v in metrics.items()}, batch.batch_size,
            triplet_ops.triplet_attention_backward.launches - before)


def test_two_rank_train_step_on_one_card(cuda, tmp_path):
    """A grad step on two data-parallel ranks started as processes (gloo
    when they share the card, NCCL on two cards), kernels on, each rank's
    kernels on 2 of the 4 complexes and its draws the whole batch's, against
    the same step in one process: losses, and every all-reduced gradient
    at the tolerance of the kernels-on-vs-off step."""
    from decompdiff_tpu_torch.training.train_step import global_norm
    from decompdiff_tpu_torch.utils.testing import run_ranks
    want, want_metrics, rows, launched = _dp_grad_step(None)
    assert (rows, launched) == (4, 2)
    ranks = run_ranks(_dp_grad_step, 2, str(tmp_path / 'rendezvous'),
                      device='cuda', timeout=600.0)
    for grads, metrics, rows, launched in ranks:
        assert (rows, launched) == (2, 2)
        for key, value in want_metrics.items():
            torch.testing.assert_close(metrics[key], value, rtol=1e-4,
                                       atol=1e-6)
        torch.testing.assert_close(global_norm(grads), global_norm(want),
                                   rtol=2e-3, atol=0.0)
        for name, b in want.items():
            scale = max(1.0, float(b.abs().max()))
            torch.testing.assert_close(grads[name], b, rtol=2e-3,
                                       atol=1e-4 * scale, msg=name)


def _entry_batch(cuda, nl):
    """The sampling entry point's batch shape (B = 8, Np = 320, a
    2048-atom full protein) at Nl = nl, seeded."""
    from decompdiff_tpu_torch.data.batch import FullProtein
    rng = np.random.default_rng(0)
    batch = random_complex_batch(rng, batch_size=8, num_protein=320,
                                 num_ligand=nl, num_groups=6, device=cuda)
    fp = FullProtein(pos=torch.as_tensor(rng.normal(size=(8, 2048, 3)) * 8,
                                         dtype=torch.float32, device=cuda),
                     mask=torch.ones((8, 2048), dtype=torch.bool,
                                     device=cuda))
    return batch, fp


@pytest.mark.parametrize('nl', [16, 32])
@pytest.mark.parametrize('model_name', ['released', 'tiny'])
def test_dp_rows_match_the_whole_batch(cuda, model_name, nl):
    """Each stage of a guided sampling step on the two halves of a batch,
    as two data-parallel ranks compute them (their rows, the whole batch's
    centroid offset), against the whole batch, at the sampling entry
    point's shapes: the protein centroid, the armsca_prox and clash
    guidance gradients, and each prediction of one denoiser call with the
    kernels and with their plain versions, all within rtol = atol = 1e-5.
    Bitwise equality does not hold at every shape: at Nl = 16 a library
    GEMM rounds a row's last bit differently by batch size."""
    from decompdiff_tpu_torch.utils.testing import (
        DEFAULT_MODEL_CONFIG, dp_row_pairs)
    cfg = (dict(DEFAULT_MODEL_CONFIG) if model_name == 'released' else
           tiny_model_config(num_diffusion_timesteps=1000))
    batch, fp = _entry_batch(cuda, nl)
    t = torch.full((8,), 999, dtype=torch.long, device=cuda)
    for on in (True, False):
        model = DecompDiffModel.create(dict(cfg, use_pallas=on), 8,
                                       device=cuda, seed=0)
        before = triplet_ops.triplet_attention.launches
        pairs = dp_row_pairs(model, batch, fp, t)
        assert (triplet_ops.triplet_attention.launches > before) == on
        for stage, (whole, halves) in pairs.items():
            torch.testing.assert_close(halves, whole, rtol=1e-5, atol=1e-5,
                                       msg=f'kernels {on}: {stage}')


def test_dp_sampling_bitwise_at_released_nl32(cuda):
    """Guided strided sampling (20 steps) of a batch's two halves, each as
    a data-parallel rank samples it (the global batch's draws, its rows),
    equals sampling the whole batch bitwise, at the released config and
    the sampling entry point's shapes with Nl = 32 (those of chip_smoke.py
    phase 2e). There every operation on the path computes a row the same
    whatever the batch size (the protein centroid through
    models/diffusion_model.py rowwise_sum). At other shapes a row can part
    in its last bit (test_dp_rows_match_the_whole_batch), and the discrete
    type and bond draws of 20 guided steps can turn that into samples that
    part."""
    from decompdiff_tpu_torch.parallel.mesh import Mesh, shard_batch
    from decompdiff_tpu_torch.sampling.sampler import (
        SampleConfig, sample_diffusion)
    from decompdiff_tpu_torch.utils.testing import (
        DEFAULT_MODEL_CONFIG, DP_ROW_DRIFTS)
    model = DecompDiffModel.create(dict(DEFAULT_MODEL_CONFIG,
                                        use_pallas=True), 8, device=cuda,
                                   seed=0)
    batch, fp = _entry_batch(cuda, 32)
    cfg = SampleConfig(num_steps=20, save_traj=False, skip_mode='strided',
                       energy_drift=DP_ROW_DRIFTS)

    def run(mesh=None):
        b, f = shard_batch(batch, mesh), shard_batch(fp, mesh)
        kw = {} if mesh is None else {'mesh': mesh}
        return sample_diffusion(
            model, cfg, b, b.ligand_pos, b.ligand_v, b.bond_type, f,
            generator=torch.Generator(device=cuda).manual_seed(5), **kw)
    whole = run()
    halves = [run(Mesh(r, 2, r, cuda, None)) for r in range(2)]
    for k in ('pos', 'v', 'bond'):
        assert torch.equal(torch.cat([h[k] for h in halves]), whole[k]), k


def test_tiny_train_step_kernels_on_vs_off(cuda):
    _train_step_on_vs_off(cuda, tiny_model_config(num_diffusion_timesteps=20),
                          triplet_ops.triplet_attention_backward)


def test_tiny_gather_train_step_kernels_on_vs_off(cuda, monkeypatch):
    """pallas_gather_bf16: both edge backward kernels of each layer take
    the x_src table, against the same model with plain versions."""
    cfg = tiny_model_config(num_diffusion_timesteps=20,
                            pallas_gather_bf16=True)
    _train_step_on_vs_off(cuda, cfg, edge_ops.edge_attention_backward,
                          count='gather_launches', per_layer=2,
                          monkeypatch=monkeypatch)


def test_tiny_uni_o2_train_step_kernels_on_vs_off(cuda):
    """The uni_o2 net with the m-gate: its gated backward kernel runs once
    per layer (x2h), through the whole loss."""
    cfg = tiny_model_config(num_diffusion_timesteps=20, **UNI_O2,
                            ew_net_type='m')
    _train_step_on_vs_off(cuda, cfg, edge_ops.edge_attention_backward,
                          count='gated_launches')


def test_converted_released_model_matches_oracle(cuda):
    """The released uni_o2_bond config from a reference-layout state dict
    through the port's converter: one denoiser call with the kernels (B=1,
    Np=64, Nl=16) against the float64 reference oracle at the JAX oracle
    tests' rtol = atol = 3e-4 (tests/test_oracle_parity.py)."""
    from decompdiff_tpu_torch.utils.convert_checkpoint import (
        convert_reference_state_dict)
    from decompdiff_tpu_torch.utils.params import load_flax_params
    from decompdiff_tpu_torch.utils.testing import (
        DEFAULT_MODEL_CONFIG, padded_complex_batch, ragged_arrays,
        ragged_complexes)
    import reference_oracle as oracle       # tests/, on pytest's path
    cfg = dict(DEFAULT_MODEL_CONFIG)
    sd = oracle.make_reference_state_dict(np.random.default_rng(3), cfg, 8,
                                          5, 29, 10)
    model = DecompDiffModel.create(dict(cfg, use_pallas=True), 8,
                                   device=cuda)
    load_flax_params(model.denoiser, convert_reference_state_dict(sd, cfg))
    graphs = ragged_complexes(np.random.default_rng(4), sizes=((64, 16, 2),))
    r = ragged_arrays(graphs)
    batch = padded_complex_batch(graphs, 64, 16, 4, device=cuda)
    before = triplet_ops.triplet_attention.launches
    with torch.no_grad():
        preds = model.apply(batch, batch.ligand_pos, batch.ligand_v,
                            batch.bond_type, torch.tensor([3], device=cuda))
    torch.cuda.synchronize()
    assert triplet_ops.triplet_attention.launches - before == 6
    want = oracle.decomp_forward(
        sd, cfg, 8, 5, r['protein_pos'], r['protein_feat'],
        r['batch_protein'], r['ligand_pos'], r['ligand_v'], r['aux'],
        r['batch_ligand'], r['bond_index'], r['bond_type'])
    got = {k: preds[k][0].double().cpu().numpy() for k in want}
    got['pred_bond'] = np.stack([got['pred_bond'][i, j]
                                 for _, i, j in r['bond_local']])
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=3e-4, atol=3e-4,
                                   err_msg=k)


def test_sampler_drift_on_card_matches_cpu(cuda):
    """The sampler's host drift with the kernels on the card against the
    same tiny model on the CPU, the noise injected: a recording callback
    (a smooth drift of its input) fires at the same steps (strided over
    T = 50: t = 37, 24 and 12 lie in [10, 40)) with the same inputs, and
    the drift it returns is applied alike (TOL; types exactly)."""
    from decompdiff_tpu_torch.data.batch import FullProtein
    from decompdiff_tpu_torch.sampling.sampler import (
        SampleConfig, sample_diffusion)
    cfg = tiny_model_config(num_diffusion_timesteps=50, use_pallas=True)
    steps, B, Nl = 5, 2, 10
    rng = np.random.default_rng(5)
    noise = dict(
        pos_eps=rng.normal(size=(steps, B, Nl, 3)).astype(np.float32),
        v_uniform=rng.random((steps, B, Nl, 8)).astype(np.float32),
        b_uniform=rng.random((steps, B, Nl, Nl, 5)).astype(np.float32))
    full = (rng.normal(size=(B, 30, 3)) * 4).astype(np.float32)
    runs = {}
    for dev in ('cpu', cuda):
        calls = []

        def record(pos, v, mask):
            out = (0.05 * np.sin(pos) * mask[..., None]).astype(np.float32)
            calls.append((pos, v, mask, out))
            return out
        model = DecompDiffModel.create(cfg, 8, device=dev, seed=0)
        batch = random_complex_batch(np.random.default_rng(0), batch_size=B,
                                     num_ligand=Nl, real_ligand=9,
                                     device=dev)
        scfg = SampleConfig(
            num_steps=steps, skip_mode='strided', save_traj=False,
            energy_drift=({'type': 'armsca_prox'},
                          {'type': 'clash', 'sigma': 2.0, 'gamma': 4.0}),
            mmff_callback=record, mmff_start_time=40, mmff_end_time=10)
        out = sample_diffusion(
            model, scfg, batch, batch.ligand_pos, batch.ligand_v,
            batch.bond_type, FullProtein(
                torch.as_tensor(full, device=dev),
                torch.ones((B, 30), dtype=torch.bool, device=dev)),
            noise_override={k: torch.as_tensor(v, device=dev)
                            for k, v in noise.items()})
        runs[str(dev)] = calls, {k: t.cpu() for k, t in out.items()}
    (cpu_calls, cpu_out), (gpu_calls, gpu_out) = runs['cpu'], runs['cuda']
    assert len(cpu_calls) == len(gpu_calls) == 3
    for (p, v, m, o), (gp, gv, gm, go) in zip(cpu_calls, gpu_calls):
        np.testing.assert_allclose(gp, p, **TOL)
        np.testing.assert_array_equal(gv, v)
        np.testing.assert_array_equal(gm, m)
        np.testing.assert_allclose(go, o, **TOL)
    assert torch.equal(gpu_out['v'], cpu_out['v'])
    torch.testing.assert_close(gpu_out['pos'], cpu_out['pos'], **TOL)


def test_spans_on_the_profiler_clock(cuda):
    """Spans and CUPTI's records on one clock: span `a` launches a kernel,
    sleeps 2 ms and launches another; span `b` synchronises. Both kernels
    go to `a`, the idle gap between them is labelled `@ a`, `a`'s first
    CUDA runtime record lies inside it within 1 ms of its start, and the
    synchronisation inside `b`."""
    import time
    from decompdiff_tpu_torch.utils import profiling
    from perfbench.core import spans as attribution
    x = torch.ones(1 << 20, device=cuda)
    x + 1
    torch.cuda.synchronize()
    activities = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities):
        pass                        # the first start initialises CUPTI
    with torch.profiler.profile(activities=activities) as prof:
        profiling.start_recording()
        with profiling.span('a'):
            x + 1
            time.sleep(0.002)
            x + 2
        with profiling.span('b'):
            torch.cuda.synchronize()
        rec = profiling.take()
    kin = attribution.read_kineto(prof)
    att = attribution.Attribution.of(rec, kin, steps=1)
    assert len(kin.ops) == 2
    assert [att.index.name(i) for i in att.owner] == ['a', 'a']
    (label, seconds), = att.idle_gaps()
    assert label.endswith(' @ a') and seconds >= 0.0015, (label, seconds)
    assert [s.name for s in rec.spans] == ['a', 'b']
    a, b = 0, 1
    first = min(kin.host, key=lambda h: h[1])
    lead_ms = (first[1] - att.index.start[a]) / 1e6
    assert 0 <= lead_ms <= 1 and first[2] <= att.index.end[a], lead_ms
    # the profiler synchronises again when it stops, after `b`
    sync = min((h for h in kin.host if 'Synchronize' in h[0]),
               key=lambda h: h[1])
    assert att.index.start[b] <= sync[1] and sync[2] <= att.index.end[b]
    print(f'first runtime record {first[0]} {lead_ms:.4f} ms after a '
          f'opened; gap {label!r} {seconds * 1e3:.4f} ms; {sync[0]} '
          f'{(sync[1] - att.index.start[b]) / 1e6:.4f} ms after b opened')
