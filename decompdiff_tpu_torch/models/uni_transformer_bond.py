"""SE(3)-equivariant graph transformer with a ligand bond stream (port of
decompdiff_tpu/models/uni_transformer_bond.py; ref
models/encoders/uni_transformer_edge.py:290-443).

Layout: the context is [protein | ligand] along one padded node axis
N = Np + Nl, with the ligand at the static slice [Np : Np+Nl]. Each layer
runs three streams: kNN edge attention over all context nodes, dense bond
attention over ligand atoms, and bond-triplet angular attention.

Every attention goes through one of the three kernel modules in ops/:
with `use_kernels` (config key `use_pallas`) the module calls the kernel's
wrapper, otherwise its plain PyTorch version, which follows the JAX dense
path's order of operations. Unlike the JAX kernel path, the context is not
padded to a multiple of 64: the CUDA kernels take any N.

On the kernel path two options follow the JAX kernel path's:
`triplet_bf16` (config key `pallas_bf16`) takes the triplet kernel's bf16
second linears, and `gather_bf16` (config key `pallas_gather_bf16`) gives
the edge attentions their sources from the JAX kernels' bf16 node table
(`gather_table`). The plain path ignores both, as the JAX dense path does.

Parameter names and layouts are the flax ones, so a state_dict key is the
flax parameter path joined with '.'.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch import nn

from decompdiff_tpu_torch.models.common import (
    ANGULAR_DIM, MLP, Dense, fixed_rbf, safe_norm)
from decompdiff_tpu_torch.ops import bond_attention as bond_ops
from decompdiff_tpu_torch.ops import edge_attention as edge_ops
from decompdiff_tpu_torch.ops import triplet_attention as triplet_ops
from decompdiff_tpu_torch.ops.common import Branch
from decompdiff_tpu_torch.ops.knn import (
    hybrid_neighbors, knn_neighbors, pairwise_sqdist)


class EdgeGraph(NamedTuple):
    """The kNN graph of one block, in the form the edge kernel takes."""
    idx: torch.Tensor              # [B, N, K] int32 source nodes
    mask: torch.Tensor             # [B, N, K] float32 valid edges
    lig: torch.Tensor              # [B, N] float32 ligand(+prior) flags
    group: Optional[torch.Tensor]  # [B, N] float32 group ids (6 edge types)


def _param(module: nn.Module, name: str, *shape: int) -> None:
    module.register_parameter(name, nn.Parameter(torch.empty(*shape)))


def _register_branch(module, prefix, feat_dim, hidden, out_dim):
    """Registers one k/v branch's raw parameters under the flax names
    `{prefix}_e_kernel`, `_e_bias`, `_ln_scale`, `_ln_bias`, `_out_kernel`,
    `_out_bias`, `_i_kernel` and `_j_kernel`."""
    _param(module, f'{prefix}_e_kernel', feat_dim, hidden)
    _param(module, f'{prefix}_e_bias', hidden)
    _param(module, f'{prefix}_ln_scale', hidden)
    _param(module, f'{prefix}_ln_bias', hidden)
    _param(module, f'{prefix}_out_kernel', hidden, out_dim)
    _param(module, f'{prefix}_out_bias', out_dim)
    _param(module, f'{prefix}_i_kernel', hidden, hidden)
    _param(module, f'{prefix}_j_kernel', hidden, hidden)


def _branch(module, prefix, h, h_src=None) -> Branch:
    """The Branch of a registered k/v branch, with the per-node projections
    of h [B, n, H] (the first linear's bias folded into t_row); t_src
    projects h_src when given, else h."""
    p = lambda s: getattr(module, f'{prefix}_{s}')  # noqa: E731
    return Branch(t_row=h @ p('i_kernel') + p('e_bias'),
                  t_src=(h if h_src is None else h_src) @ p('j_kernel'),
                  w_feat=p('e_kernel'), wo=p('out_kernel'), bo=p('out_bias'),
                  ln_scale=p('ln_scale'), ln_bias=p('ln_bias'))


def gather_table(h, x):
    """(h_src, x_src): what the sources of an edge attention are read from
    with gather_bf16, as the JAX kernel path packs its node table
    (_pack_hx, uni_transformer_bond.py:176-185) and the kernel unpacks it
    (_split_hjT, edge_kernel.py:132-149): h rounded to bf16, and x as
    bf16 hi + lo summed in float32. In autograd this is JAX's cast chain:
    the cotangent reaching h through h_src is summed over edges and both
    branches, then rounded to bf16 once (the cast back); the one reaching
    x through x_src is the rounded sum of the d x_src terms, since hi's
    two cotangents cancel exactly in bf16."""
    hi = x.to(torch.bfloat16)
    lo = (x - hi.float()).to(torch.bfloat16)
    return h.to(torch.bfloat16).float(), hi.float() + lo.float()


def _edge_call(module, prefixes, h, x, graph: EdgeGraph, e_w, q,
               pos_mode: bool):
    """One edge attention of a module with `use_kernels` and `gather_bf16`
    flags, whose two branches are registered under `prefixes`."""
    h_src, kw = None, {}
    if not module.use_kernels:
        fn = edge_ops.edge_attention_reference
    else:
        fn = edge_ops.edge_attention
        if module.gather_bf16:
            h_src, kw['x_src'] = gather_table(h, x)
    return fn(x, graph.lig, graph.group, graph.idx, graph.mask, e_w, q,
              *(_branch(module, p, h, h_src) for p in prefixes),
              n_heads=module.n_heads, pos_mode=pos_mode, **kw)


class NodeEdgeAttention(nn.Module):
    """Scalar-feature attention over [B, N, K] kNN edges
    (ref NodeUpdateLayer, uni_transformer_edge.py:16-74)."""

    def __init__(self, hidden_dim, n_heads, n_etypes=4, out_fc=True,
                 use_kernels=False, gather_bf16=False):
        super().__init__()
        H = hidden_dim
        self.n_heads, self.use_kernels = n_heads, use_kernels
        self.gather_bf16 = gather_bf16
        for prefix in ('hk', 'hv'):
            _register_branch(self, prefix, n_etypes * 21, H, H)
        self.hq = MLP(H, H, H)
        self.node_output = MLP(2 * H, H, H) if out_fc else None

    def forward(self, h, x, graph: EdgeGraph, e_w):
        out = _edge_call(self, ('hk', 'hv'), h, x, graph, e_w, self.hq(h),
                         pos_mode=False)
        if self.node_output is not None:
            out = self.node_output(torch.cat([out, h], dim=-1))
        return out


class PosEdgeAttention(nn.Module):
    """Equivariant coordinate attention over [B, N, K] kNN edges
    (ref PosUpdateLayer, uni_transformer_edge.py:170-210)."""

    def __init__(self, hidden_dim, n_heads, n_etypes=4, use_kernels=False,
                 gather_bf16=False):
        super().__init__()
        H = hidden_dim
        self.n_heads, self.use_kernels = n_heads, use_kernels
        self.gather_bf16 = gather_bf16
        _register_branch(self, 'xk', n_etypes * 21, H, H)
        _register_branch(self, 'xv', n_etypes * 21, H, n_heads)
        self.xq = MLP(H, H, H)

    def forward(self, h, x, graph: EdgeGraph, e_w):
        return _edge_call(self, ('xk', 'xv'), h, x, graph, e_w, self.xq(h),
                          pos_mode=True)


class NodeBondAttention(nn.Module):
    """Scalar-feature attention over the dense [B, Nl, Nl] bond graph; the
    bond hidden state is the edge feature (ref uni_transformer_edge.py:
    239-243,273). With `h_full` the ligand message is scattered into the full
    context BEFORE node_output, as the reference runs this layer on the
    whole context, and the result is [B, N, H]."""

    def __init__(self, hidden_dim, n_heads, out_fc=True, use_kernels=False):
        super().__init__()
        H = hidden_dim
        self.n_heads, self.use_kernels = n_heads, use_kernels
        for prefix in ('hk', 'hv'):
            _register_branch(self, prefix, H, H, H)
        self.hq = MLP(H, H, H)
        self.node_output = MLP(2 * H, H, H) if out_fc else None

    def forward(self, h_lig, h_bond, bond_mask, h_full=None,
                num_protein: int = 0):
        fn = (bond_ops.bond_attention if self.use_kernels
              else bond_ops.bond_attention_reference)
        out = fn(h_bond, None, bond_mask, self.hq(h_lig),
                 _branch(self, 'hk', h_lig),
                 _branch(self, 'hv', h_lig),
                 n_heads=self.n_heads, pos_mode=False)
        if h_full is not None:
            Nl = h_lig.shape[1]
            out = torch.cat([torch.zeros_like(h_full[:, :num_protein]), out,
                             torch.zeros_like(h_full[:, num_protein + Nl:])],
                            dim=1)
            h_lig = h_full
        if self.node_output is not None:
            out = self.node_output(torch.cat([out, h_lig], dim=-1))
        return out


class PosBondAttention(nn.Module):
    """Equivariant coordinate attention over the dense bond graph
    (ref uni_transformer_edge.py:253-257,280-285). Takes the ligand
    coordinates; rel[i, j] = x_i - x_j is formed by the kernel."""

    def __init__(self, hidden_dim, n_heads, use_kernels=False):
        super().__init__()
        H = hidden_dim
        self.n_heads, self.use_kernels = n_heads, use_kernels
        _register_branch(self, 'xk', H, H, H)
        _register_branch(self, 'xv', H, H, n_heads)
        self.xq = MLP(H, H, H)

    def forward(self, h_lig, x_lig, h_bond, bond_mask):
        fn = (bond_ops.bond_attention if self.use_kernels
              else bond_ops.bond_attention_reference)
        return fn(h_bond, x_lig, bond_mask, self.xq(h_lig),
                  _branch(self, 'xk', h_lig),
                  _branch(self, 'xv', h_lig),
                  n_heads=self.n_heads, pos_mode=True)


def triplet_angles(x_lig: torch.Tensor) -> torch.Tensor:
    """[B, Nl, 3] -> [B, i, j, k] angle at i between (x_j - x_i) and
    (x_k - x_i), as atan2(|cross|, dot)."""
    rel = x_lig[:, None, :, :] - x_lig[:, :, None, :]      # [B, i, t] = x_t - x_i
    dot = torch.einsum('bijc,bikc->bijk', rel, rel)
    cross = torch.linalg.cross(rel[:, :, :, None, :], rel[:, :, None, :, :],
                               dim=-1)
    return torch.atan2(safe_norm(cross, dim=-1), dot)


class BondTripletAttention(nn.Module):
    """Directional triplet (k -> j -> i) message passing updating bond
    features (ref BondUpdateLayer, uni_transformer_edge.py:77-167). The first
    projection of the kv input [h_bond[j,k], r_feat[j,k], r_feat[i,j],
    a_feat, h[k], h[j]] is factorized into (j,k), (i,j), j and angular
    terms; only the 13-wide angular code is projected per triplet. `bf16`
    (config key `pallas_bf16`) takes the kernel's bf16 second linears; like
    the JAX module, only the kernel path reads it."""

    def __init__(self, hidden_dim, n_heads, include_h_node=True,
                 use_kernels=False, bf16=False):
        super().__init__()
        H = hidden_dim
        self.n_heads, self.use_kernels = n_heads, use_kernels
        self.bf16 = bf16
        self.include_h_node = include_h_node
        kj_in = H + 20 + (H if include_h_node else 0)
        for prefix in ('hk', 'hv'):
            _param(self, f'{prefix}_a_kernel', ANGULAR_DIM, H)
            _param(self, f'{prefix}_a_bias', H)
            _param(self, f'{prefix}_ln_scale', H)
            _param(self, f'{prefix}_ln_bias', H)
            _param(self, f'{prefix}_out_kernel', H, H)
            _param(self, f'{prefix}_out_bias', H)
            setattr(self, f'{prefix}_kj', Dense(kj_in, H, use_bias=False))
            setattr(self, f'{prefix}_ij', Dense(20, H, use_bias=False))
            if include_h_node:
                setattr(self, f'{prefix}_j', Dense(H, H, use_bias=False))
        self.hq = MLP(2 * H if include_h_node else H, H, H)

    def _branch(self, prefix, h_lig, h_bond, r_feat) -> Branch:
        B, Nl, H = h_lig.shape
        parts_kj = [h_bond, r_feat]
        if self.include_h_node:
            parts_kj.append(h_lig[:, None, :, :].expand(B, Nl, Nl, H))  # h[k]
        t_kj = getattr(self, f'{prefix}_kj')(torch.cat(parts_kj, dim=-1))
        if self.include_h_node:
            t_kj = t_kj + getattr(self, f'{prefix}_j')(h_lig)[:, :, None, :]
        p = lambda s: getattr(self, f'{prefix}_{s}')  # noqa: E731
        return Branch(t_row=getattr(self, f'{prefix}_ij')(r_feat),
                      t_src=t_kj + p('a_bias'), w_feat=p('a_kernel'),
                      wo=p('out_kernel'), bo=p('out_bias'),
                      ln_scale=p('ln_scale'), ln_bias=p('ln_bias'))

    def forward(self, h_lig, h_bond, x_lig, bond_mask):
        B, Nl, H = h_lig.shape
        d = torch.sqrt(torch.clamp(pairwise_sqdist(x_lig, x_lig), min=1e-12))
        r_feat = fixed_rbf(d)                                   # [B, Nl, Nl, 20]
        q_in = (torch.cat([h_bond, h_lig[:, :, None, :].expand(B, Nl, Nl, H)],
                          dim=-1) if self.include_h_node else h_bond)
        args = (triplet_angles(x_lig), bond_mask, self.hq(q_in),
                self._branch('hk', h_lig, h_bond, r_feat),
                self._branch('hv', h_lig, h_bond, r_feat))
        if self.use_kernels:
            return triplet_ops.triplet_attention(*args, n_heads=self.n_heads,
                                                 bf16=self.bf16)
        return triplet_ops.triplet_attention_reference(*args,
                                                       n_heads=self.n_heads)


class AttentionLayerBond(nn.Module):
    """One x2h + h2x block with bond streams
    (ref AttentionLayerO2TwoUpdateNodeGeneral, uni_transformer_edge.py:213-287)."""

    def __init__(self, hidden_dim, n_heads, x2h_out_fc, include_h_node,
                 n_etypes=4, use_kernels=False, triplet_bf16=False,
                 gather_bf16=False):
        super().__init__()
        H = hidden_dim
        self.node_layer_with_edge = NodeEdgeAttention(
            H, n_heads, n_etypes, out_fc=x2h_out_fc, use_kernels=use_kernels,
            gather_bf16=gather_bf16)
        self.node_layer_with_bond = NodeBondAttention(
            H, n_heads, out_fc=x2h_out_fc, use_kernels=use_kernels)
        self.bond_layer = BondTripletAttention(
            H, n_heads, include_h_node=include_h_node,
            use_kernels=use_kernels, bf16=triplet_bf16)
        self.lin_node = Dense(H, H)
        self.pos_layer_with_edge = PosEdgeAttention(
            H, n_heads, n_etypes, use_kernels=use_kernels,
            gather_bf16=gather_bf16)
        self.pos_layer_with_bond = PosBondAttention(
            H, n_heads, use_kernels=use_kernels)

    def forward(self, h, x, graph: EdgeGraph, h_bond, bond_mask, movable,
                num_protein: int, e_w):
        Np, Nl = num_protein, h_bond.shape[1]
        new_h_edge = self.node_layer_with_edge(h, x, graph, e_w)
        h_lig = h[:, Np:Np + Nl].contiguous()
        x_lig = x[:, Np:Np + Nl].contiguous()
        new_h_bond_full = self.node_layer_with_bond(
            h_lig, h_bond, bond_mask, h_full=h, num_protein=Np)
        new_h_bond = h_bond + self.bond_layer(h_lig, h_bond, x_lig, bond_mask)
        new_h = h + self.lin_node(new_h_edge + new_h_bond_full)

        # coordinate updates use the updated h (ref :280-285)
        dx_edge = self.pos_layer_with_edge(new_h, x, graph, e_w)
        dx_bond = self.pos_layer_with_bond(
            new_h[:, Np:Np + Nl].contiguous(), x_lig, new_h_bond, bond_mask)
        dx = torch.cat([dx_edge[:, :Np], dx_edge[:, Np:Np + Nl] + dx_bond,
                        dx_edge[:, Np + Nl:]], dim=1)
        x = x + dx * movable[..., None].to(x.dtype)
        return new_h, new_h_bond, x


class UniTransformerBond(nn.Module):
    """The full refine net (ref UniTransformerO2TwoUpdateGeneralBond,
    uni_transformer_edge.py:290-443)."""

    def __init__(self, num_blocks, num_layers, hidden_dim, n_heads, k,
                 x2h_out_fc=True, include_h_node=False, use_kernels=False,
                 cutoff_mode='knn', r_max=10.0, n_etypes=4,
                 triplet_bf16=False, gather_bf16=False):
        super().__init__()
        if cutoff_mode not in ('knn', 'radius', 'hybrid'):
            raise NotImplementedError(f'cutoff_mode {cutoff_mode!r}')
        if cutoff_mode == 'hybrid' and use_kernels:
            raise ValueError('hybrid cutoff mode runs the dense path only')
        self.num_blocks, self.k = num_blocks, k
        self.cutoff_mode, self.r_max = cutoff_mode, r_max
        self.n_etypes = n_etypes
        self.edge_pred = MLP(20, 1, hidden_dim)
        for i in range(num_layers):
            setattr(self, f'layer_{i}', AttentionLayerBond(
                hidden_dim, n_heads, x2h_out_fc, include_h_node, n_etypes,
                use_kernels, triplet_bf16, gather_bf16))
        self.num_layers = num_layers

    def forward(self, h, x, h_bond, mask_all, mask_ligand, movable,
                bond_mask, num_protein: int, group_idx=None):
        """
        Args:
            h [B, N, H], x [B, N, 3]: context features and positions
            h_bond [B, Nl, Nl, H]: bond features
            mask_all, mask_ligand, movable [B, N] bool; bond_mask [B, Nl, Nl]
            num_protein: protein slice size
            group_idx: optional [B, N] decomposition group (6 edge types)
        """
        if (group_idx is not None) != (self.n_etypes == 6):
            raise ValueError('group_idx must be given exactly when the net '
                             'was built with 6 edge types')
        lig = mask_ligand.float()
        group = None if group_idx is None else group_idx.float()
        bond_maskf = bond_mask.float()
        for _ in range(self.num_blocks):
            if self.cutoff_mode == 'hybrid':
                nbr_idx, nbr_mask, nbr_d2 = hybrid_neighbors(
                    x, mask_all, mask_ligand, self.k, num_protein)
            else:
                nbr_idx, nbr_mask, nbr_d2 = knn_neighbors(x, mask_all, self.k)
                if self.cutoff_mode == 'radius':
                    # radius graph with an implicit max degree of k
                    nbr_mask = nbr_mask & (nbr_d2 <= self.r_max ** 2)
            graph = EdgeGraph(nbr_idx.int().contiguous(), nbr_mask.float(),
                              lig, group)
            # the global edge weight is always on (ref encoders/__init__.py
            # never forwards use_global_ew); distances come from top-k
            dist = torch.sqrt(torch.clamp(nbr_d2, 1e-12, 1e12))
            e_w = torch.sigmoid(
                self.edge_pred(fixed_rbf(dist)))[..., 0].contiguous()
            for i in range(self.num_layers):
                h, h_bond, x = getattr(self, f'layer_{i}')(
                    h, x, graph, h_bond, bond_maskf, movable, num_protein,
                    e_w)
        return {'x': x, 'h': h, 'h_bond': h_bond}
