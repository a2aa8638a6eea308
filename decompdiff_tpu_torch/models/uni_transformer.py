"""SE(3)-equivariant graph transformer without bond streams, the `uni_o2`
refine net (port of decompdiff_tpu/models/uni_transformer.py; ref
models/encoders/uni_transformer.py:15-332).

Same [protein | ligand] context and kNN edge attention as the bond variant
(uni_transformer_bond.py), with these differences:
  * each x2h layer carries its own residual (out + h; ref :88);
  * the edge weight is chosen by ew_net_type: 'r' gates v by
    sigmoid(Linear(RBF(dist))) of the edge's type, from the current
    geometry; 'm' by sigmoid(v . wm + bm) from v itself, in x2h only (the
    edge kernel's m-gate); 'global' by one block-level MLP over RBF(dist);
    'none' by nothing;
  * num_x2h / num_h2x repetitions, with the geometry taken from the updated
    coordinates after each h2x update (ref :200-212).

Every attention goes through ops/edge_attention.py: with `use_kernels`
(config key `use_pallas`) the module calls the kernel's wrapper, otherwise
its plain PyTorch version. Only 4 edge types exist here (the JAX package
passes no group ids to this net), and unlike the JAX kernel path the context
is not padded to a multiple of 64.

Parameter names and layouts are the flax ones, so a state_dict key is the
flax parameter path joined with '.'.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from decompdiff_tpu_torch.models.common import MLP, fixed_rbf, safe_norm
from decompdiff_tpu_torch.models.uni_transformer_bond import (
    EdgeGraph, _branch, _param, _register_branch)
from decompdiff_tpu_torch.ops import edge_attention as edge_ops
from decompdiff_tpu_torch.ops.knn import hybrid_neighbors, knn_neighbors

EW_NET_TYPES = ('r', 'm', 'global', 'none')
R = 20          # RBF features per edge type
N_ETYPES = 4


def _ew_r(module: nn.Module, prefix: str, x: torch.Tensor,
          graph: EdgeGraph) -> torch.Tensor:
    """ew_net_type 'r': sigmoid(outer(edge_type, RBF(dist)) @ w + b) per
    edge, [B, N, K], from the coordinates x; the RBF is projected by each
    type's block of w and the edge's own type selected, so the [.., 80]
    outer product is never formed."""
    w = getattr(module, f'{prefix}_ew_kernel')             # [4 * 20, 1]
    b = getattr(module, f'{prefix}_ew_bias')
    rel = x[:, :, None, :] - edge_ops.gather_nodes(x, graph.idx)
    proj = fixed_rbf(safe_norm(rel, dim=-1)) @ w.reshape(N_ETYPES, R).t()
    etype = edge_ops.edge_types(graph.lig, None, graph.idx)
    return torch.sigmoid((proj * etype).sum(-1) + b)


class X2HAttention(nn.Module):
    """Scalar-feature attention over the kNN edges, with the residual
    (ref BaseX2HAttLayer, uni_transformer.py:15-88)."""

    def __init__(self, hidden_dim, n_heads, ew_net_type='r', out_fc=True,
                 use_kernels=False):
        super().__init__()
        H = hidden_dim
        self.n_heads, self.use_kernels = n_heads, use_kernels
        self.ew_net_type = ew_net_type
        for prefix in ('hk', 'hv'):
            _register_branch(self, prefix, N_ETYPES * (R + 1), H, H)
        self.hq = MLP(H, H, H)
        if ew_net_type == 'r':
            _param(self, 'hk_ew_kernel', N_ETYPES * R, 1)
            _param(self, 'hk_ew_bias', 1)
        elif ew_net_type == 'm':
            _param(self, 'ew_kernel', H, 1)
            _param(self, 'ew_bias', 1)
        self.node_output = MLP(2 * H, H, H) if out_fc else None

    def forward(self, h, x, graph: EdgeGraph, e_w: Optional[torch.Tensor]):
        gate = None
        if self.ew_net_type == 'r':
            e_w = _ew_r(self, 'hk', x, graph)
        elif self.ew_net_type == 'm':
            gate = (self.ew_kernel.reshape(-1), self.ew_bias)
            e_w = torch.ones_like(graph.mask)
        elif e_w is None:
            e_w = torch.ones_like(graph.mask)
        fn = (edge_ops.edge_attention if self.use_kernels
              else edge_ops.edge_attention_reference)
        out = fn(x, graph.lig, None, graph.idx, graph.mask, e_w, self.hq(h),
                 _branch(self, 'hk', h), _branch(self, 'hv', h),
                 n_heads=self.n_heads, pos_mode=False, gate=gate)
        if self.node_output is not None:
            out = self.node_output(torch.cat([out, h], dim=-1))
        return out + h


class H2XAttention(nn.Module):
    """Equivariant coordinate attention over the kNN edges
    (ref BaseH2XAttLayer, uni_transformer.py:91-144); 'm' is the identity
    here (ref :89)."""

    def __init__(self, hidden_dim, n_heads, ew_net_type='r',
                 use_kernels=False):
        super().__init__()
        H = hidden_dim
        self.n_heads, self.use_kernels = n_heads, use_kernels
        self.ew_net_type = ew_net_type
        _register_branch(self, 'xk', N_ETYPES * (R + 1), H, H)
        _register_branch(self, 'xv', N_ETYPES * (R + 1), H, n_heads)
        self.xq = MLP(H, H, H)
        if ew_net_type == 'r':
            _param(self, 'xk_ew_kernel', N_ETYPES * R, 1)
            _param(self, 'xk_ew_bias', 1)

    def forward(self, h, x, graph: EdgeGraph, e_w: Optional[torch.Tensor]):
        if self.ew_net_type == 'r':
            e_w = _ew_r(self, 'xk', x, graph)
        elif self.ew_net_type != 'global' or e_w is None:
            e_w = torch.ones_like(graph.mask)
        fn = (edge_ops.edge_attention if self.use_kernels
              else edge_ops.edge_attention_reference)
        return fn(x, graph.lig, None, graph.idx, graph.mask, e_w, self.xq(h),
                  _branch(self, 'xk', h), _branch(self, 'xv', h),
                  n_heads=self.n_heads, pos_mode=True)


class AttentionLayerO2(nn.Module):
    """num_x2h feature updates, then num_h2x coordinate updates
    (ref AttentionLayerO2TwoUpdateNodeGeneral, uni_transformer.py:147-214)."""

    def __init__(self, hidden_dim, n_heads, num_x2h=1, num_h2x=1,
                 ew_net_type='r', x2h_out_fc=True, sync_twoup=False,
                 use_kernels=False):
        super().__init__()
        self.num_x2h, self.num_h2x = num_x2h, num_h2x
        self.sync_twoup = sync_twoup
        for i in range(num_x2h):
            setattr(self, f'x2h_{i}', X2HAttention(
                hidden_dim, n_heads, ew_net_type, x2h_out_fc, use_kernels))
        for i in range(num_h2x):
            setattr(self, f'h2x_{i}', H2XAttention(
                hidden_dim, n_heads, ew_net_type, use_kernels))

    def forward(self, h, x, graph: EdgeGraph, movable, e_w):
        h_in = h
        for i in range(self.num_x2h):
            h_in = getattr(self, f'x2h_{i}')(h_in, x, graph, e_w)
        new_h = h if self.sync_twoup else h_in
        for i in range(self.num_h2x):
            dx = getattr(self, f'h2x_{i}')(new_h, x, graph, e_w)
            x = x + dx * movable[..., None].to(x.dtype)
        return h_in, x


class UniTransformerO2(nn.Module):
    """The full refine net (ref UniTransformerO2TwoUpdateGeneral,
    uni_transformer.py:217-332)."""

    def __init__(self, num_blocks, num_layers, hidden_dim, n_heads, k,
                 ew_net_type='global', num_x2h=1, num_h2x=1, x2h_out_fc=True,
                 sync_twoup=False, cutoff_mode='knn', r_max=10.0,
                 use_kernels=False):
        super().__init__()
        if ew_net_type not in EW_NET_TYPES:
            raise ValueError(f'ew_net_type {ew_net_type!r}, expected one of '
                             f'{EW_NET_TYPES}')
        if cutoff_mode not in ('knn', 'radius', 'hybrid'):
            raise NotImplementedError(f'cutoff_mode {cutoff_mode!r}')
        if cutoff_mode == 'hybrid' and use_kernels:
            raise ValueError('hybrid cutoff mode runs the dense path only')
        self.num_blocks, self.num_layers, self.k = num_blocks, num_layers, k
        self.cutoff_mode, self.r_max = cutoff_mode, r_max
        if ew_net_type == 'global':
            self.edge_pred = MLP(R, 1, hidden_dim)
        for i in range(num_layers):
            setattr(self, f'layer_{i}', AttentionLayerO2(
                hidden_dim, n_heads, num_x2h, num_h2x, ew_net_type,
                x2h_out_fc, sync_twoup, use_kernels))

    def forward(self, h, x, mask_all, mask_ligand, movable,
                num_protein: int):
        """
        Args:
            h [B, N, H], x [B, N, 3]: context features and positions
            mask_all, mask_ligand, movable [B, N] bool
            num_protein: protein slice size (the hybrid cutoff's split)
        """
        lig = mask_ligand.float()
        for _ in range(self.num_blocks):
            if self.cutoff_mode == 'hybrid':
                nbr_idx, nbr_mask, nbr_d2 = hybrid_neighbors(
                    x, mask_all, mask_ligand, self.k, num_protein)
            else:
                nbr_idx, nbr_mask, nbr_d2 = knn_neighbors(x, mask_all, self.k)
                if self.cutoff_mode == 'radius':
                    nbr_mask = nbr_mask & (nbr_d2 <= self.r_max ** 2)
            graph = EdgeGraph(nbr_idx.int().contiguous(), nbr_mask.float(),
                              lig, None)
            e_w = None
            if hasattr(self, 'edge_pred'):
                # block-level weight from the block's distances (ref :430-435)
                dist = torch.sqrt(torch.clamp(nbr_d2, 1e-12, 1e12))
                e_w = torch.sigmoid(
                    self.edge_pred(fixed_rbf(dist)))[..., 0].contiguous()
            for i in range(self.num_layers):
                h, x = getattr(self, f'layer_{i}')(h, x, graph, movable, e_w)
        return {'x': x, 'h': h}
