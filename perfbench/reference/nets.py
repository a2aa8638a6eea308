"""The DecompDiff denoiser in plain PyTorch, float32, from a state dict.

Written from the published description of the two refine nets and their
heads (bytedance/DecompDiff models/decompdiff.py DecompScorePosNet3D,
models/encoders/uni_transformer_edge.py for `uni_o2_bond`, and
guanjq/targetdiff models/uni_transformer.py for `uni_o2`), on the padded
dense layout of the port's batches: the context is [protein | ligand] along
one node axis, kNN edges are a [B, N, K] neighbour table, the bond graph is
the dense [B, Nl, Nl] matrix, and every attention materialises its
per-edge, per-pair or per-triplet tensors. No kernel, cache or fused path:
each attention is its equations, in the order the reference code writes
them. It imports nothing of the program; the parameter names are the
port's state-dict keys, so one drawn state dict loads into both.

The only departure from the reference implementations is the padding:
masked rows and pairs are computed and then masked, as the port's padded
layout requires.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

RBF_OFFSETS = (0, 1, 1.25, 1.5, 1.75, 2, 2.25, 2.5, 2.75, 3, 3.5, 4, 4.5,
               5, 5.5, 6, 7, 8, 9, 10)          # fix_offset=True
ANGULAR_FREQS = (1.0, 2.0, 3.0, 1.0, 1.0 / 2, 1.0 / 3)


def dense(P, name, x):
    y = x @ P[f'{name}.kernel']
    bias = P.get(f'{name}.bias')
    return y if bias is None else y + bias


def layer_norm(x, scale, bias):
    return F.layer_norm(x, x.shape[-1:], scale, bias, eps=1e-5)


def mlp(P, name, x):
    """Linear -> LayerNorm -> ReLU -> Linear (ref models/common.py MLP)."""
    h = dense(P, f'{name}.Dense_0', x)
    h = torch.relu(layer_norm(h, P[f'{name}.LayerNorm_0.scale'],
                              P[f'{name}.LayerNorm_0.bias']))
    return dense(P, f'{name}.Dense_1', h)


def rbf(d):
    offsets = torch.tensor(RBF_OFFSETS, dtype=d.dtype, device=d.device)
    return torch.exp(-0.5 * (d[..., None] - offsets) ** 2)


def norm(v):
    """|v| with a zero-safe gradient."""
    return torch.sqrt(torch.clamp((v * v).sum(-1), min=1e-12))


def shifted_softplus(x):
    return F.softplus(x) - math.log(2.0)


def gather(t, idx):
    """t [B, N, F], idx [B, N, K] -> [B, N, K, F]."""
    B, N, K = idx.shape
    flat = idx.reshape(B, N * K, 1).long().expand(-1, -1, t.shape[-1])
    return torch.gather(t, 1, flat).reshape(B, N, K, t.shape[-1])


def attend(q, k, v, valid, n_heads, rel=None):
    """Multi-head attention of each query row over its M sources, softmax
    masked by `valid`. q [..., H], k [..., M, H]. Without `rel`, v
    [..., M, H] gives sum alpha v; with it, v [..., M, heads] and rel
    [..., M, 3] give the mean over heads of sum alpha v rel."""
    H = q.shape[-1]
    hd = H // n_heads
    logits = (q.reshape(q.shape[:-1] + (1, n_heads, hd))
              * k.reshape(k.shape[:-1] + (n_heads, hd))).sum(-1)
    logits = logits / math.sqrt(hd)
    m = valid[..., None]
    z = torch.where(m, logits, torch.finfo(logits.dtype).min)
    top = z.amax(-2, keepdim=True)
    top = torch.where(torch.isfinite(top), top, 0.0)
    e = torch.where(m, torch.exp(z - top), 0.0)
    alpha = e / torch.clamp(e.sum(-2, keepdim=True), min=1e-16)
    if rel is None:
        out = (alpha[..., None]
               * v.reshape(v.shape[:-1] + (n_heads, hd))).sum(-3)
        return out.reshape(q.shape)
    return (alpha[..., None] * v[..., None] * rel[..., None, :]
            ).sum(-3).mean(-2)


def kv_branch(P, name, pre):
    """relu(LayerNorm(pre)) @ Wo + bo of one k or v branch."""
    y = torch.relu(layer_norm(pre, P[f'{name}_ln_scale'],
                              P[f'{name}_ln_bias']))
    return y @ P[f'{name}_out_kernel'] + P[f'{name}_out_bias']


def knn_graph(x, mask, k):
    """(idx [B, N, K], valid [B, N, K], squared distance [B, N, K]): each
    real node's k nearest real nodes other than itself."""
    n = x.shape[1]
    d2 = ((x[:, :, None, :] - x[:, None, :, :]) ** 2).sum(-1)
    big = torch.finfo(d2.dtype).max
    eye = torch.eye(n, dtype=torch.bool, device=x.device)
    d2 = torch.where(eye[None] | ~mask[:, None, :], big, d2)
    neg, idx = torch.topk(-d2, k, dim=-1)
    return idx, (neg > -big) & mask[:, :, None], -neg


def knn_margin(b: dict, ligand_pos, k: int):
    """[B]: over each molecule's real nodes whose last kNN edge involves a
    ligand atom (the node, its k-th or its (k+1)-th nearest real node), the
    narrowest gap between the squared distances of the k-th and the
    (k+1)-th, as a share of the k-th (inf where there is none). Where it is
    at rounding level the graph's last edge is a tie, which the program's
    rounding of the same state may decide the other way. Ties among
    protein atoms alone are the same in every molecule and every step."""
    x = torch.cat([b['protein_pos'], ligand_pos], 1)
    mask = torch.cat([b['protein_mask'], b['ligand_mask']], 1)
    lig = torch.cat([torch.zeros_like(b['protein_mask']), b['ligand_mask']],
                    1)
    n = x.shape[1]
    if n <= k:
        return torch.full(x.shape[:1], math.inf, device=x.device)
    d2 = ((x[:, :, None, :] - x[:, None, :, :]) ** 2).sum(-1)
    big = torch.finfo(d2.dtype).max
    eye = torch.eye(n, dtype=torch.bool, device=x.device)
    d2 = torch.where(eye[None] | ~mask[:, None, :], big, d2)
    neg, idx = torch.topk(-d2, k + 1, dim=-1)
    a, c = -neg[..., k - 1], -neg[..., k]
    involved = (lig | torch.gather(lig, 1, idx[..., k - 1])
                | torch.gather(lig, 1, idx[..., k]))
    rel = (c - a) / torch.clamp(a, min=1e-30)
    return torch.where((c < big) & mask & involved, rel,
                       math.inf).amin(-1)


def edge_attention(P, name, prefixes, h, x, lig, idx, valid, e_w, n_heads,
                   pos_mode):
    """Attention over the kNN edges (ref NodeUpdateLayer / PosUpdateLayer,
    uni_transformer_edge.py; TargetDiff BaseX2HAttLayer / BaseH2XAttLayer):
    edge features outer(edge type, RBF(d)) ++ edge type, the branch input
    W_e f + W_i h_dst + W_j h_src + b, the value weighted by e_w."""
    rel = x[:, :, None, :] - gather(x, idx)                # x_dst - x_src
    src_lig = gather(lig[..., None], idx)[..., 0] > 0.5
    dst_lig = (lig > 0.5)[:, :, None]
    etype = torch.where(src_lig & dst_lig, 0, torch.where(
        src_lig, 1, torch.where(dst_lig, 2, 3)))
    onehot = F.one_hot(etype, 4).to(x.dtype)
    r = rbf(norm(rel))
    feat = torch.cat([(onehot[..., :, None] * r[..., None, :]).flatten(-2),
                      onehot], -1)
    q = mlp(P, f'{name}.{"xq" if pos_mode else "hq"}', h)
    kv = []
    for p in prefixes:
        b = f'{name}.{p}'
        pre = (feat @ P[f'{b}_e_kernel'] + (h @ P[f'{b}_i_kernel']
                                            + P[f'{b}_e_bias'])[:, :, None]
               + gather(h @ P[f'{b}_j_kernel'], idx))
        kv.append(kv_branch(P, b, pre))
    k, v = kv
    v = v * e_w[..., None]
    return attend(q, k, v, valid, n_heads, rel if pos_mode else None)


def bond_attention(P, name, prefixes, h_lig, x_lig, h_bond, bond_mask,
                   n_heads, pos_mode):
    """Attention over the dense bond graph with the bond hidden state as the
    edge feature (ref uni_transformer_edge.py:239-285)."""
    q = mlp(P, f'{name}.{"xq" if pos_mode else "hq"}', h_lig)
    kv = []
    for p in prefixes:
        b = f'{name}.{p}'
        pre = (h_bond @ P[f'{b}_e_kernel']
               + (h_lig @ P[f'{b}_i_kernel'] + P[f'{b}_e_bias'])[:, :, None]
               + (h_lig @ P[f'{b}_j_kernel'])[:, None, :, :])
        kv.append(kv_branch(P, b, pre))
    rel = (x_lig[:, :, None, :] - x_lig[:, None, :, :]) if pos_mode else None
    return attend(q, kv[0], kv[1], bond_mask, n_heads, rel)


def triplet_attention(P, name, h_lig, h_bond, x_lig, bond_mask, n_heads):
    """Directional triplet (k -> j -> i) attention updating the bond state
    (ref BondUpdateLayer, uni_transformer_edge.py:77-167): the k/v input of
    triplet (i, j, k) is [h_bond[j, k], rbf(d_jk), rbf(d_ij), angle code at
    i, h[k], h[j]] through one linear layer, written as its blocks."""
    B, Nl, H = h_lig.shape
    rel = x_lig[:, None, :, :] - x_lig[:, :, None, :]       # [b, i, t]
    dot = torch.einsum('bijc,bikc->bijk', rel, rel)
    cross = torch.linalg.cross(rel[:, :, :, None, :], rel[:, :, None, :, :],
                               dim=-1)
    angle = torch.atan2(norm(cross), dot)                   # at i, (j, k)
    f = torch.tensor(ANGULAR_FREQS, dtype=x_lig.dtype, device=x_lig.device)
    a = angle[..., None] * f
    a_feat = torch.cat([angle[..., None], torch.sin(a), torch.cos(a)], -1)
    d = torch.sqrt(torch.clamp(((x_lig[:, :, None] - x_lig[:, None]) ** 2
                                ).sum(-1), min=1e-12))
    r = rbf(d)                                              # [b, j, k, 20]
    hk = h_lig[:, None, :, :].expand(B, Nl, Nl, H)          # h[k] at [j, k]
    q = mlp(P, f'{name}.hq', torch.cat(
        [h_bond, h_lig[:, :, None, :].expand(B, Nl, Nl, H)], -1))
    kv = []
    for p in ('hk', 'hv'):
        b = f'{name}.{p}'
        t_src = (torch.cat([h_bond, r, hk], -1) @ P[f'{b}_kj.kernel']
                 + (h_lig @ P[f'{b}_j.kernel'])[:, :, None, :]
                 + P[f'{b}_a_bias'])                         # [b, j, k]
        t_row = r @ P[f'{b}_ij.kernel']                      # [b, i, j]
        pre = (a_feat @ P[f'{b}_a_kernel'] + t_src[:, None]
               + t_row[:, :, :, None])
        kv.append(kv_branch(P, b, pre))
    eye = torch.eye(Nl, dtype=torch.bool, device=x_lig.device)
    valid = (bond_mask[:, :, :, None] & bond_mask[:, None, :, :]
             & ~eye[None, :, None, :])
    return attend(q, kv[0], kv[1], valid, n_heads)


def refine_bond(P, cfg, h, x, h_bond, mask_all, mask_lig, movable,
                bond_mask, Np):
    """The uni_o2_bond refine net (ref UniTransformerO2TwoUpdateGeneralBond):
    per layer the kNN and bond feature updates and the triplet bond update,
    then the coordinate updates from the updated features."""
    Nl, nh = h_bond.shape[1], cfg['n_heads']
    lig = mask_lig.to(x.dtype)
    idx, valid, d2 = knn_graph(x, mask_all, cfg['knn'])
    e_w = torch.sigmoid(mlp(P, 'refine_net.edge_pred', rbf(
        torch.sqrt(torch.clamp(d2, 1e-12, 1e12)))))[..., 0]
    for i in range(cfg['num_layers']):
        L = f'refine_net.layer_{i}'
        h_edge = edge_attention(P, f'{L}.node_layer_with_edge', ('hk', 'hv'),
                                h, x, lig, idx, valid, e_w, nh, False)
        h_lig, x_lig = h[:, Np:Np + Nl], x[:, Np:Np + Nl]
        m_bond = bond_attention(P, f'{L}.node_layer_with_bond', ('hk', 'hv'),
                                h_lig, None, h_bond, bond_mask, nh, False)
        m_bond = F.pad(m_bond, (0, 0, Np, h.shape[1] - Np - Nl))
        new_bond = h_bond + triplet_attention(P, f'{L}.bond_layer', h_lig,
                                              h_bond, x_lig, bond_mask, nh)
        new_h = h + dense(P, f'{L}.lin_node', h_edge + m_bond)
        dx = edge_attention(P, f'{L}.pos_layer_with_edge', ('xk', 'xv'),
                            new_h, x, lig, idx, valid, e_w, nh, True)
        dx_bond = bond_attention(P, f'{L}.pos_layer_with_bond', ('xk', 'xv'),
                                 new_h[:, Np:Np + Nl], x_lig, new_bond,
                                 bond_mask, nh, True)
        dx = dx + F.pad(dx_bond, (0, 0, Np, h.shape[1] - Np - Nl))
        x = x + dx * movable[..., None].to(x.dtype)
        h, h_bond = new_h, new_bond
    return h, x, h_bond


def refine_o2(P, cfg, h, x, mask_all, mask_lig, movable, Np):
    """The uni_o2 refine net (TargetDiff UniTransformerO2TwoUpdateGeneral)
    with ew_net_type 'global', one x2h and one h2x per layer, no x2h output
    layer, and the h2x update reading the updated features."""
    nh = cfg['n_heads']
    lig = mask_lig.to(x.dtype)
    idx, valid, d2 = knn_graph(x, mask_all, cfg['knn'])
    e_w = torch.sigmoid(mlp(P, 'refine_net.edge_pred', rbf(
        torch.sqrt(torch.clamp(d2, 1e-12, 1e12)))))[..., 0]
    for i in range(cfg['num_layers']):
        L = f'refine_net.layer_{i}'
        h = h + edge_attention(P, f'{L}.x2h_0', ('hk', 'hv'), h, x, lig,
                               idx, valid, e_w, nh, False)
        dx = edge_attention(P, f'{L}.h2x_0', ('xk', 'xv'), h, x, lig, idx,
                            valid, e_w, nh, True)
        x = x + dx * movable[..., None].to(x.dtype)
    return h, x


def check_config(cfg: dict) -> None:
    """The settings this reference implements; anything else is refused."""
    want = {'node_indicator': True, 'add_prior_node': False,
            'time_emb_dim': 0, 'num_blocks': 1, 'cutoff_mode': 'knn',
            'model_mean_type': 'C0', 'x2h_out_fc': False}
    if cfg['model_type'] == 'uni_o2_bond':
        want.update(bond_diffusion=True, bond_net_type='lin',
                    h_node_in_bond_net=True)
    else:
        want.update(model_type='uni_o2', ew_net_type='global', num_x2h=1,
                    num_h2x=1, sync_twoup=False)
    bad = {k: cfg.get(k) for k, v in want.items() if cfg.get(k) != v}
    if bad:
        raise ValueError(f'the reference does not implement {bad}')


def denoise(P, cfg, b, ligand_pos, ligand_v, bond_type):
    """One denoiser call on a batch dict `b` (the ComplexBatch field names;
    protein and priors already centred). Returns pred_ligand_pos [B, Nl, 3],
    pred_ligand_v [B, Nl, K] and, with bond diffusion, pred_bond
    [B, Nl, Nl, Kb] (ref DecompScorePosNet3D.forward)."""
    Np, Nl = b['protein_pos'].shape[1], ligand_pos.shape[1]
    K = P['v_inf_1.kernel'].shape[1]
    lig_in = torch.cat([F.one_hot(ligand_v.long(), K).float(),
                        b['ligand_aux']], -1)
    h_p = dense(P, 'protein_atom_emb', b['protein_feat'])
    h_l = dense(P, 'ligand_atom_emb', lig_in)
    h = torch.cat([F.pad(h_p, (0, 1)), F.pad(h_l, (0, 1), value=1.0)], 1)
    x = torch.cat([b['protein_pos'], ligand_pos], 1)
    no = torch.zeros_like(b['protein_mask'])
    mask_all = torch.cat([b['protein_mask'], b['ligand_mask']], 1)
    mask_lig = torch.cat([no, b['ligand_mask']], 1)
    movable = mask_lig
    if cfg['model_type'] == 'uni_o2_bond':
        Kb = P['ligand_bond_emb.kernel'].shape[0]
        h_bond = dense(P, 'ligand_bond_emb',
                       F.one_hot(bond_type.long(), Kb).float())
        h, x, h_bond = refine_bond(P, cfg, h, x, h_bond, mask_all, mask_lig,
                                   movable, b['bond_mask'], Np)
    else:
        h, x = refine_o2(P, cfg, h, x, mask_all, mask_lig, movable, Np)
    h_lig = h[:, Np:Np + Nl]
    out = {'pred_ligand_pos': x[:, Np:Np + Nl],
           'pred_ligand_v': dense(P, 'v_inf_1', shifted_softplus(
               dense(P, 'v_inf_0', h_lig)))}
    if cfg.get('bond_diffusion', False):
        out['pred_bond'] = dense(P, 'bond_inf_1', shifted_softplus(
            dense(P, 'bond_inf_0', h_bond)))
    return out


def param_count(P) -> int:
    return int(sum(np.prod(t.shape) for t in P.values()))
