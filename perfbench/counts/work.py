"""The operations and bytes of the cells' work, from their shapes and masks
alone: the yardstick of the roofline and MFU metrics.

The attention counts are a frozen copy of chip_smoke.py's `work` (forward)
and `{triplet,edge,bond}_backward_work` (the head-factorized least work of
each backward), recounted at one peak: every operation, on any unit and at
any precision, is held to the dense bf16 tensor-core rate and every byte to
the HBM bandwidth (peaks.json), so no implementation reads above 100%.
Counts are over valid rows and pairs only (padding is not work); bytes are
each input read once and each output written once, at the padded shapes
the calls take.

FLOPs are 2 per multiply-add of the matrix products of the algorithm: the
attentions' first and second linears, q.k and alpha.v, and for the model
(MFU) also every node MLP, embedding, per-node projection and head.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

PEAKS = json.loads((Path(__file__).with_name('peaks.json')).read_text())
F32 = 4


@dataclasses.dataclass(frozen=True)
class Shapes:
    """One batch as the counts see it: padded sizes and the real atom
    counts of each row."""
    Np: int
    Nl: int
    protein: tuple          # real pocket atoms per row
    ligand: tuple           # real ligand atoms per row
    H: int
    heads: int
    K: int                  # kNN neighbours
    layers: int
    model_type: str
    classes: int
    bond_classes: int

    @property
    def B(self) -> int:
        return len(self.protein)


def _valid(s: Shapes):
    """(kNN edges, live kNN rows, bond pairs, triplets, live triplet rows,
    real nodes, real ligand atoms) summed over the batch."""
    e = rows = pairs = trip = trows = nodes = lig = 0
    for p, l in zip(s.protein, s.ligand):
        n = p + l
        e += n * min(s.K, n - 1)
        rows += n if n > 1 else 0
        pairs += l * (l - 1)
        trip += l * (l - 1) * (l - 2)
        trows += l * (l - 1) if l > 2 else 0
        nodes += n
        lig += l
    return e, rows, pairs, trip, trows, nodes, lig


def _attn(H, nh, pos):
    v_out = 2 * H * nh + 2 * H + 6 * nh if pos else 2 * H * H + 2 * H
    return 2 * H * H + 2 * H + v_out


def _branch_bytes(rows_src, feat, H, dout):
    return F32 * (2 * rows_src * H + feat * H + H * dout + dout + 2 * H)


def forward_calls(s: Shapes) -> list:
    """[(name, FLOPs, bytes)] of one denoiser call's attention kernels."""
    e, _, pairs, trip, _, _, _ = _valid(s)
    H, nh, B, Nl = s.H, s.heads, s.B, s.Nl
    N = s.Np + Nl
    calls = []
    for pos in (False, True):
        dv = nh if pos else H
        out = B * N * (3 if pos else H)
        nbytes = F32 * (B * N * 3 + B * N + 3 * B * N * s.K + B * N * H
                        + out) + _branch_bytes(B * N, 84, H, H) \
            + _branch_bytes(B * N, 84, H, dv)
        calls.append(('edge_attention', e * (2 * 2 * 21 * H
                                             + _attn(H, nh, pos)), nbytes))
    if s.model_type != 'uni_o2_bond':
        return calls * s.layers
    for pos in (False, True):
        dv = nh if pos else H
        out = B * Nl * (3 if pos else H)
        nbytes = F32 * (B * Nl * Nl * H + (B * Nl * 3 if pos else 0)
                        + B * Nl * Nl + B * Nl * H + out) \
            + _branch_bytes(B * Nl, H, H, H) + _branch_bytes(B * Nl, H, H, dv)
        calls.append(('bond_attention', pairs * (2 * 2 * H * H
                                                 + _attn(H, nh, pos)), nbytes))
    P = B * Nl * Nl
    nbytes = F32 * (B * Nl ** 3 + B * Nl * Nl + P * H + P * H) \
        + 2 * _branch_bytes(P, 13, H, H)
    calls.append(('triplet_attention',
                  trip * (2 * 2 * 13 * H + _attn(H, nh, False)), nbytes))
    return calls * s.layers


def backward_calls(s: Shapes) -> list:
    """[(name, FLOPs, bytes)] of the attention backward kernels of one
    training step: the head-factorized least work; bytes are the forward
    call's inputs and the cotangent read once and every gradient written
    once (counted as the inputs again)."""
    e, rows, pairs, trip, trows, _, _ = _valid(s)
    H, nh = s.H, s.heads
    out = []
    for name, _, nbytes in forward_calls(s):
        if name == 'edge_attention':
            pos = len([c for c in out if c[0] == name]) % 2 == 1
            sq = e * 2 * 6 * nh * H + rows * 2 * (3 if pos else 5) * H * H
            flops = e * (3 * 2 * 2 * 21 * H + 2 * (6 + 8) * H) + sq
        elif name == 'bond_attention':
            pos = len([c for c in out if c[0] == name]) % 2 == 1
            sq = (pairs * 2 * (3 * 2 * H + 6 * nh) * H
                  + rows_bond(s) * 2 * (3 if pos else 5) * H * H)
            flops = pairs * 2 * (6 + 8) * H + sq
        else:
            flops = (trip * (3 * 2 * 2 * 13 * H + 2 * (6 + 8) * H)
                     + trip * 2 * 6 * nh * H + trows * 2 * 5 * H * H)
        out.append((name, flops, 2 * nbytes))
    return out


def rows_bond(s: Shapes) -> int:
    return sum(l for l in s.ligand if l > 1)


def model_flops(s: Shapes) -> float:
    """Matrix-product FLOPs of one denoiser call: embeddings, the kNN edge
    weight MLP, every layer's node MLPs, per-node projections and linears,
    the attentions, and the heads."""
    e, _, pairs, _, _, nodes, lig = _valid(s)
    H = s.H
    prot = sum(s.protein)
    f = 2 * (prot * 29 * (H - 1) + lig * (s.classes + 2) * (H - 1))
    f += 2 * e * (20 * H + H)                       # edge weight MLP
    q_mlp = 2 * 2 * H * H                           # two [H, H] linears
    proj = 4 * 2 * H * H                            # Wi, Wj of both branches
    per_layer = 2 * nodes * (q_mlp + proj)         # edge node and pos
    if s.model_type == 'uni_o2_bond':
        f += 2 * pairs * s.bond_classes * H         # bond embedding
        per_layer += 2 * lig * (q_mlp + proj)       # bond node and pos
        per_layer += pairs * 2 * (2 * H * H + H * H)            # triplet q
        per_layer += 2 * pairs * 2 * ((2 * H + 20) * H + 20 * H)  # kj, ij
        per_layer += 2 * lig * 2 * H * H            # j of both branches
        per_layer += nodes * 2 * H * H              # lin_node
        f += 2 * pairs * (H * H + H * s.bond_classes)   # bond head
    f += s.layers * per_layer
    f += sum(c[1] for c in forward_calls(s))
    f += 2 * lig * (H * H + H * s.classes)          # atom-type head
    return float(f)


def least_seconds(flops: float, nbytes: float) -> float:
    return max(flops / PEAKS['flops_per_s'], nbytes / PEAKS['bytes_per_s'])
